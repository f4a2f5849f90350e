#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gstreamer_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N] [--batch N]

Builds the port's CUDA kernels from csrc/ (one nvcc per source, in
parallel), holds each kernel against its plain PyTorch version on the card
at the main paths' shapes (bit for bit; the two-pass and the
horizontal-only scale kernels also at batch 64, at a width that is no
multiple of 16 and on views that start off a 16-byte boundary), times kernel, plain version, a library call or
yardstick and the byte/operation bound (the operations at the rate of the
unit that does them; a time under its bound fails the run), then drives the
port's main paths at full width, each with the launch counts zeroed just
before it and read just after:

1. the VideoConverter -- a batch of 1920x1080 I420 frames, made from the
   seed, to RGB 224x224 -- in four configurations:

  linear2      method=linear, 2 taps (videoscale's default): yscale kernel
               + 2-tap gather chroma
  cubic        the converter's default cubic: yscale kernel + chroma420
               kernel
  add_borders  linear/2 with the 16:9 -> 1:1 dest rect (dest-y=49,
               dest-height=126): phase-split path + rect embed, no kernel
  fused_ingest linear/2 with GTPU_PALLAS=1 set for this phase only: the
               fused-ingest kernel (unpack + chroma up2 + h-scale), then the
               plain v-scale; the same bytes as linear2

2. the two standalone scale ops, hscale_u8 and scale_hv_u8, called as a user
   would on the batch's luma plane (the package has no other caller);

3. launch strings through the port's parse_launch on CUDA, 1920x1080 I420
   frames pushed into appsrc as CUDA tensors and read from appsink:

  deint_chain                deinterlace method=linear ! videobalance
                             (BASELINE config 4 as bench_all.py drives it):
                             deint kernel, 3 launches per tick
  deint_rate_chain           deinterlace method=scalerbob ! videorate !
                             30/1 ! videobalance: deint kernel
  headline_launch            videoconvertscale ! RGB 224x224 (add-borders
                             route: no kernel)
  headline_launch_noborders  the same with add-borders=false: yscale kernel
  quickstart                 the README quick-start string at 1080p:
                             videotestsrc pattern=snow ! I420 1920x1080 !
                             videoconvertscale add-borders=false ! RGB
                             224x224 ! appsink (snow generated on the card)
  quickstart_fused           the same with GTPU_PALLAS=1: fused-ingest kernel

4. generic_routes: the converter's other routes at full width (GENERIC
   below): NV12 ingest with and without the fused-ingest kernel, an SD -> HD
   upscale, a same-size I420 -> BGRA, RGB -> I420 for an encoder, 10-bit
   P010 -> 8-bit RGB, RGB16 out with the default bayer dither and with a
   serial one (floyd-steinberg: the scale kernels still launch), gamma remap
   with a primaries change, interlaced scaling, and the launched
   videoconvertscale with element defaults over an NV12 videotestsrc.  The
   card's bytes must equal the numpy gold and the port's CPU path on the
   first 2 frames;

5. the switches: linear2 and cubic again at batch 64 under
   GTPU_PALLAS_YSCALE=0 and GTPU_PALLAS_CHROMA=0: the same bytes, and no
   launch of the kernel switched off;

6. the audio front-end (BASELINE config 2; no kernel of the port on its
   path, every launch count must stay 0), each with a rate line and its
   device idle share:

  asr_resample_f32  bench_all.py's config: AudioResampler("kaiser", 48000,
                    16000).resample_fn("f32", 131072, 2) over 128 seeded
                    chunks / 32768, channel mean after; per sample within 1
                    ULP of the port's CPU path and the float64 gold, also
                    with TF32 allowed process-wide
  asr_resample_s16  the same shape on the s16 path: bit for bit against the
                    CPU path and resample_ref
  asr_launch        appsrc (48 kHz stereo S16, 10 s a tick as CUDA tensors)
                    ! audioconvert ! mono ! audioresample ! 16 kHz !
                    audioconvert ! F32 ! appsink: bytes equal a numpy gold of
                    the chain on the first 2 ticks
  asr_quickstart    tests/test_audio.py's string with audiotestsrc (host
                    samples) at samplesperbuffer=48000
  volume_s16/_f32   volume volume=0.5, bit for bit against numpy.

7. N-to-1 aggregators through parse_launch, several appsrcs fed CUDA tensors
   (AGGREGATORS), each with an e2e line and its device idle share:

  compositor_4k     BASELINE config 3 as bench_all.py:90-132 builds it: four
                    1920x1080 I420 pads placed 2x2 into a 3840x2160 mosaic,
                    batch 32, 4 ticks; every quadrant must equal its input,
                    no kernel; its byte bound printed beside it
  compositor_wall   a monitoring wall: four 1080p I420 pads scaled to
                    960x540 by their own converters (4 yscale and 8 chroma420
                    launches a tick), OVER a checker in BGRA 1080p, one at
                    alpha 0.5 and a picture-in-picture at alpha 0.6 on top;
                    held to a numpy gold of the converters and the blend
  audiomixer_s16/_f32  two 48 kHz stereo inputs, 10 s a tick, one near full
                    scale: the int64 sum saturated / the float64 sum cast.

8. stateful and controlled elements (stateful_phase), each with an e2e line,
   its device idle share and peak memory:

  deint_<method>    BASELINE config 4 with each of the nine methods that have
                    no kernel (tomsmocomp, greedyh, greedyl, vfir,
                    linearblend, weave, weave-tff, weave-bff, yadif) at
                    1920x1080 I420, batch 64, 3 ticks: output frames per tick
                    (latency held back on the first), and the card's bytes
                    equal the port's CPU path over ticks of 2, 1 and 2 frames
  deint_chain_controlled  deint_chain with contrast and brightness keyframed
                    (a new value every tick): 3 deint launches a tick, each
                    tick equal to the plain deinterlace and videobalance's
                    float32 tables at that tick's values
  effectv_chain     bench_all.py:177-209's edgetv ! vertigotv scan at 640x480
                    RGB, batch 128, 3 ticks; it and each of the twelve effects
                    alone equal the port's CPU path over two ticks of 4 frames
  volume_controlled_s16/_f32  a volume ramp, 10 s of 48 kHz stereo a tick,
                    equal to the port's CPU path on every tick.

9. ingest from disk (ingest_phase; the files are written under a temporary
   directory and removed):

  ingest_y4m        bench_e2e.py's path: 96 seeded random 1080p I420 frames
                    in a y4m (about 300 MB) through filesrc !
                    videoconvertscale add-borders=false ! RGB 224x224 !
                    appsink at batch 16 and 64, prefetch off and on, three
                    passes with seek(0) between them: bytes equal the
                    port's VideoConverter on the frames read with numpy,
                    prefetch equal to no prefetch, duration and position
                    queries, the native reader and yscale_hv once a tick;
                    frames/s per pass, the H2D ceiling (pinned and pageable
                    probes around each pass) and its fraction, busy ms and
                    idle share, peak memory; then once under GTPU_PALLAS=1
                    (fused_i420_up_hscale once a tick, same bytes)
  ingest_jpeg       BASELINE config 5: 64 1080p 4:2:0 JPEGs at quality 85
                    (videotestsrc pattern=smpte plus seeded noise, written
                    by the port's jpegenc) and 8 each of 500x375 4:4:4 and
                    gray through multifilesrc ! jpegdec ! videoconvertscale
                    add-borders=false ! RGB 224x224: the card's planes equal
                    the port's CPU decode, the RGB the converter on them,
                    every scan decoded natively; frames/s, host entropy ms
                    and device IDCT ms an image against its byte bound
  ml_ingest         examples/ml_ingest_torch.py's train loop: a finite loss.

10. the common filters and fittings (fittings_phase, FITTINGS), each with
   an e2e line, its device idle share and peak memory:

  filters_tee       seeded 1080p I420 frames, batch 64, 4 ticks, through
                    videocrop top=60 bottom=60 ! videoflip method=clockwise
                    ! videomedian ! gamma ! tee into two RGB 224x224
                    branches (bilinear and catrom: the plan scales v before
                    h, the generic route, no kernel), a portrait RGB 112x224
                    branch (catrom: yscale once and chroma420 twice a tick
                    on the 960x1920 plane, each also held to its plain
                    version there) and a closed valve whose fakesink must
                    get nothing; run again under GTPU_TRACERS="stats;latency"
                    and GTPU_DEBUG_DUMP_DOT_DIR: the same bytes, a dot file,
                    every buffer counted
  selector_box      two 1080p I420 appsrcs, batch 32, 3 ticks, through
                    input-selector active-pad=sink_1 ! videobox left=-64
                    right=-64 ! alpha method=green ! AYUV: the active pad's
                    luma inside black borders.

11. overlays and the device video effects (overlays_phase, OVERLAY_PATHS),
   each with an e2e line, its device idle share and peak memory:

  burnin            seeded 1080p I420, batch 64, 3 ticks, through
                    timeoverlay ! qroverlay pixel-size=4 ! gdkpixbufoverlay
                    (a seeded PNG written by the port's PNG encoder) !
                    videoconvertscale method=catrom add-borders=false ! RGB
                    224x224: yscale once and chroma420 twice a tick; the
                    overlays are host elements, so the graph runs per
                    element
  camera_raw_rggb / _rggb16le  a seeded 1080p Bayer mosaic at 8 and 16
                    bits, batch 64, 3 ticks, through bayer2rgb !
                    videoconvertscale add-borders=false ! RGB 224x224 (the
                    generic route, no kernel); the 8-bit mosaic also through
                    bayer2rgb ! ARGB ! rgb2bayer, equal to itself
  augment           seeded 1080p I420, batch 32, 3 ticks, through
                    videoconvertscale ! AYUV ! rotate angle=0.3 !
                    gaussianblur sigma=1.2 ! coloreffects preset=sepia !
                    videoconvertscale method=catrom add-borders=false ! RGB
                    224x224 (no kernel)

   Each tick's first 2 frames equal the port's CPU path.  Then each of the
   27 effect and 13 overlay factories alone (OVL_FACTORIES) over two ticks
   of 4 1080p frames (texts, a PNG and an SVG for the renderers and
   decoders): the card's samples equal the CPU path's, no kernel launched.

12. the audio DSP family (dsp_phase, DSP_PATHS): freeverb's and the VAD's
   kernels (two per-sample recursions; the JAX package ran each as a jitted
   lax.scan) against their plain versions bit for bit (freeverb at 1 Hz to
   768 kHz, mono and stereo, two pushes with the state carried, every
   block schedule the layout derives, every ring in shared memory to 48
   kHz, the allpasses to 384 kHz, none at 768 kHz; the main path's push in
   one launch against 100 launches and on its first frames against the plain
   version; the VAD from six carried powers, 2^62 among them, at four
   lengths), timed beside their roofline and latency bounds and the
   previous kernels' times, then:

  music_master      a mastering chain before encoding: 48 kHz stereo F32,
                    3 pushes of 10 s, through equalizer-10bands !
                    audiodynamic ! freeverb ! audiopanorama ! rgvolume !
                    rglimiter ! spectrum ! level: freeverb once a push
  voice_chain       a call-centre or ASR ingest: 48 kHz mono S16, 250
                    pushes of 20 ms (1 s of speech-band tones, 1 s near
                    silence in turns), through removesilence remove=true
                    squash=true ! audioamplify ! audiowsincband ! 8 kHz !
                    mulawenc ! mulawdec: the VAD once a push

   each with frames/s, busy ms, idle share, top device items and peak
   memory, and again on short pushes on the card and the CPU (samples and
   bus messages equal); then each of the 31 factories alone over two
   pushes, the card equal to the CPU.

13. the OpenCV family (cv_phase): the kernels of segmentation's per-pixel
   Gaussian mixture (gmm) and of disparity's cost volume and semi-global
   pass in one (disparity; the JAX package ran a jitted expression and
   lax.scans) against their plain versions bit for bit at odd heights,
   widths that are no multiple of 32, with the mixture's carry continued
   over ticks, tied and five-mode scenes and weights at backgroundRatio,
   and disparity from H < 9 and W < 16 to 1280x720; each timed beside its
   roofline and latency bounds, then:

  cv_segment        seeded RGBA 1920x1080, batch 64, 4 ticks, through
                    segmentation (mog2): the mixture's kernel once a tick,
                    every tick's masks and carry equal to the plain
                    version's and, on a crop, the CPU path's; mog and
                    test-mode once each
  cv_stereo         a seeded 1280x720 stereo pair, batch 8, 3 ticks,
                    through disparity (sgbm): the fused kernel once a tick,
                    the output equal to the plain versions' and, on a band,
                    the CPU path's; sbm once
  cv_edges          seeded RGB 1920x1080, batch 32, 3 ticks, through
                    cvsmooth type=gaussian kernel-width=5 ! edgedetect (no
                    kernel): the hysteresis' grows and host tests a tick

   each with frames/s, busy ms, idle share, top device items and peak
   memory; then each of the 23 factories alone on 2 small frames (the
   face elements on a synthetic cascade written to a temporary file), the
   card equal to the CPU.

14. the analytics path and the last elements that compute on the device
   (analytics_phase; none of the ten kernels is on these paths):

  ml_detect         seeded 1920x1080 I420, batch 16, 3 ticks, through
                    videoconvertscale (the letterbox) ! RGB 640x640 !
                    jaxinference (a seeded stand-in with the YOLOv8 head's
                    output, float32 (16, 84, 8400) a tick) !
                    yolov8tensordec ! ioutracker: every frame's detections
                    equal a numpy decode of its host tensor, the first 2
                    frames' metas and track ids the CPU run's; the host's
                    share (decoder and tracker)
  smooth            seeded 1080p I420, batch 16, 3 ticks: the luma byte for
                    byte the CPU run's on 2 frames
  audiomixmatrix_s16 / _f32 (8 -> 2 channels) and audiochannelmix_f32, 10 s
                    pushes of 48 kHz: every push the CPU run's

   each with frames/s, busy ms, idle share, top device items and peak
   memory; then each of the slice's 53 factories alone or in a short chain
   on small inputs, the card equal to the CPU.

15. captions, subtitles, scopes and audio files (broadcast_phase; host
   modules, none of the ten kernels on these paths):

  captions_sd       NTSC SD line 21: seeded 720x486 I420 at 30000/1001,
                    batch 30, 3 ticks, through timecodestamper ! cccombiner
                    (a seeded CEA-608 pair a frame from appsrc, host bytes)
                    ! line21encoder ! line21decoder ! ccextractor, the
                    caption branch through ccconverter to CDP and back:
                    every frame's pair decoded, timecodes and every frame
                    the CPU run's
  subtitles_hd      seeded 1920x1080 I420, batch 16, 3 ticks, under
                    assrender (two ASS events a tick, one moving) and under
                    dvbsubenc ! dvbsuboverlay (a seeded AYUV subpicture):
                    the first 2 frames of each tick the CPU run's; a tick's
                    copy to the host and back timed
  scopes_hd         48 kHz stereo S16, 3 pushes of 1 s, through wavescope,
                    spectrascope, spacescope and synaescope at 1920x1080
                    30/1, then videoconvertscale to I420, and monoscope and
                    goom2k1 at their defaults: the first push's frames the
                    CPU run's
  wav_asr           BASELINE config 2 from a file: wavenc writes 10 s of
                    48 kHz stereo S16LE, wavparse ! the ASR chain gives
                    appsrc's samples and the CPU run's; the same round trip
                    through AU, AIFF and IMA ADPCM

   each with frames/s, device busy ms and idle share a tick, the host
   elements' share, the bytes copied D2H and H2D a tick and peak memory;
   then each of the slice's 68 factories alone or in a short chain, the
   card equal to the CPU (samples, metas, messages, files).

16. containers and multi-stream sources (container_phase; the files are
   written under a temporary directory and removed):

  mkv_ingest        matroskamux writes 48 seeded 1920x1080 I420 frames at
                    25/1 and 48 kHz stereo S16LE pushed as card tensors
                    (the file equals the CPU run's); matroskademux d.video_0
                    ! videoconvertscale add-borders=false ! RGB 224x224 and
                    d.audio_0 ! audioconvert ! audioresample ! F32LE 16 kHz
                    mono, batch 16, 3 ticks: one parse, yscale_hv once a
                    tick, the audio deselected at tick 2 (staged as zeros),
                    every output the CPU run's
  mkv_uridecodebin  the same file through uridecodebin's video_0 / audio_0
                    (its internal pipeline runs at batch 1: yscale_hv once a
                    frame): mkv_ingest's RGB bytes and the CPU run's audio;
                    then playbin's A/V build: the frames and samples written
  mov_ingest        qtmux writes 32 1080p UYVY frames with 'sowt' audio;
                    qtdemux's two streams to RGB 224x224 and F32LE 16 kHz
                    (UYVY takes the converter's generic route: no kernel)
  mxf_proxy         mxfmux writes 32 1080p UYVY frames at 25/1 with S16LE
                    (seeded instance ids); mxfdemux to an I420 640x360 proxy
                    and the audio chain (no kernel)

   each with frames/s, the muxer's write frames/s, device busy ms and idle
   share a tick, the host's share (the demuxer's create with from_bytes,
   the staging, the host elements), the set-up with the parse, bytes copied
   D2H and H2D a tick, peak memory and the launch counts; then each of the
   19 container factories alone or as a writer and its reader (rmdemux,
   rademux and pnmsrc on a hand-packed RealMedia file), the card equal to
   the CPU (files, samples, messages).

17. coded files to the card (codec_phase; the FLAC files are written under a
   temporary directory, the others are the committed vectors under
   tests/data/torch_codecs/ with the JAX package's digests):

  flac_asr          flacenc and oggmux write 10 s of seeded 48 kHz stereo
                    S16 pushed as card tensors (the files the CPU run's);
                    flacdec, oggdemux and uridecodebin read them back: the
                    samples written, and through audioconvert !
                    audioresample ! F32LE 16 kHz mono the port's CPU run
  vorbis_asr        vorbis_10s.ogg through vorbisdec, oggdemux and
                    uridecodebin to the same ASR chain: the PCM within 1e-6
                    of the JAX digests, the ASR output the CPU run's
  mp3_asr           mp3_10s.mp3 through filesrc ! mpegaudioparse !
                    mpg123audiodec and uridecodebin: as vorbis_asr
  theora_ingest     theora_1080p.ogv (8 frames of 1920x1080 I420) through
                    theoradec ! videoconvertscale add-borders=false ! RGB
                    224x224 at batch 8, and oggdemux stream=video: the
                    planes equal libtheoradec's sha256 (and the JAX
                    package's where its decoder keeps sync), the RGB the
                    port's CPU converter over the same frames, yscale_hv
                    once a tick
  theora_mkv_ingest theora_vorbis_1080p.mkv through matroskademux d.video_0
                    (as theora_ingest) and d.audio_0 (the Vorbis PCM within
                    1e-6 of the JAX digests, the ASR chain the CPU run's)

   each with frames/s or audio frames/s, the host's decode time, device
   busy ms and idle share a tick, bytes copied H2D and D2H a tick, peak
   memory and the launch counts; then each of the 16 codec factories alone
   or in a short chain, the card equal to the CPU (files, samples,
   messages).

18. Opus and AAC to the card, and the device monitor (opus_aac_phase; the
   committed vectors under tests/data/torch_codecs/ with the JAX package's
   digests; the A/V files are written under a temporary directory):

  opus_asr          opus_10s.opus (CELT) through opusdec, oggdemux and
                    uridecodebin ! audioconvert ! audioresample ! F32LE
                    16 kHz mono: the PCM within 1e-6 of the JAX digests and
                    equal between the paths, each ASR output the port's CPU
                    run over the same blocks, the packets by decoder route
                    (celt / silk / hybrid / libopus) the digests'
  opus_voice_asr    opus_voice_10s.opus (SILK, then hybrid): as opus_asr
  aac_asr           aac_10s.aac (ADTS AAC-LC) through filesrc ! aacparse !
                    faad (a tick's frames decoded on the host, uploaded once)
  heaac_asr         heaac_10s.aac (HE-AAC v1): as aac_asr, at twice the
                    core rate
  aac_m4a_asr       aac_10s.m4a through qtdemux stream=audio
  webm_av_ingest    matroskamux writes 48 seeded 1920x1080 I420 frames from
                    card tensors and opus_10s.opus's packets (the file the
                    CPU run's); matroskademux d.video_0 ! RGB 224x224
                    (yscale_hv once a video tick) and d.audio_0 ! the ASR
                    chain: the PCM the Ogg decode's after its pre-skip
  mp4_av_ingest     qtmux writes 32 1080p UYVY frames and aac_10s.aac's
                    access units; qtdemux's two pads (UYVY takes the
                    converter's generic route: no kernel)
  device_monitor    DeviceMonitor lists gpu:0 with its memory statistics;
                    each test device's element runs a tick on the card

   each with its e2e line (as phase 17); then opusdec, opusenc, faad and
   aacparse alone, the card equal to the CPU (opusenc raises alike on both
   where the system libopus is absent).

19. VP8/VP9 and the transport containers (vpx_transport_phase): ASF with
   MJPEG, MPEG-TS / PS audio, HLS segments, FLV, VPx where the system
   libvpx is there, alphacolor with y4mdec, then the 38 factories alone.

20. RTP, UDP/TCP, RTSP and pcapparse (rtp_rtsp_phase; host code, the card
   decoding; the JPEG files and the capture are written under a temporary
   directory).  Its first line is a loopback probe (one UDP datagram to
   itself on 127.0.0.1, one TCP pair); the socket items run only where it
   found both:

  rtsp_mjpeg_ingest  32 1080p panning frames through jpegenc on the card
                    into JPEG files; the port's RTSPServer mounts
                    multifilesrc ! rtpjpegpay (host only) and rtspsrc
                    protocols=tcp ! rtpjpegdepay ! jpegdec ! RGB 224x224 at
                    batch 16 reads it: yscale_hv once a tick that gives
                    frames, the RGB multifilesrc ! jpegdec's of the files
                    (itself the port's CPU run's)
  rtsp_mjpeg_udp    the same camera over UDP with the server's rate
                    control at 25/1 (imagesequencesrc): packets received
                    and lost and the frames whole printed, every whole frame
                    equal to its frame of the TCP run
  rtcp_session      the server's SRs at rtspsrc, rtspsrc's RRs at the server
  pcap_mjpeg_replay the JPEGs through rtpjpegpay into Ethernet/IPv4/UDP
                    records of a .pcap file, read back by filesrc !
                    pcapparse dst-port=5004 caps=<RTP/JPEG> ! rtpjpegdepay !
                    jpegdec: yscale_hv once a tick that gives frames, the
                    same RGB
  rtp_l16_asr       10 s of 48 kHz stereo through rtpL16pay ! udpsink and
                    udpsrc ! rtpL16depay ! the ASR chain, sender and
                    receiver alternated: the samples those sent, the ASR
                    output the port's CPU run's; rtpL24pay ! rtpL24depay of
                    the same in one process
  rtp_vraw_uyvy     16 1080p frames to UYVY on the card, rtpvrawpay
                    mtu=1400 ! rtpvrawdepay (the frames back whole), RGB
                    224x224 by the generic route (no kernel)
  rtp_coded_passthrough  vp8_1080p.ivf through ivfparse ! rtpvp8pay !
                    rtpvp8depay (ivfparse's frames back); opus_10s.opus's
                    packets through rtpopuspay ! udpsink and udpsrc !
                    rtpopusdepay, decoded to opusdec's PCM of the file, the
                    ASR chain over it the port's CPU run's

   then each of the 60 factories alone, the card equal to the CPU.

21. The rest of RTP: FEC, RED, the generic and codec payloaders and Siren
   (rtp_fec_phase; host code, the card decoding and converting):

  rtp_fec_camera    phase 20's camera, its 32 1080p JPEGs through rtpjpegpay
                    and, in turn, rtpst2022_1_fecenc rows=5, rtpulpfecenc
                    group-size=4 and rtpredenc distance=1 (payloader mtu 700
                    under RED); drop pattern (a), one media packet in each
                    of 16 rows the pushed buffers recover alone (the first
                    packet of 6 frames among them), into appsrc ! the
                    decoder (rtpst2022_1_fecdec; rtpstorage ! rtpulpfecdec !
                    rtpjitterbuffer; rtpreddec) ! rtpjpegdepay ! jpegdec !
                    RGB 224x224 at batch 16: every packet back in order,
                    every frame multifilesrc ! jpegdec's and the CPU run's,
                    yscale_hv once a tick that gives frames; pattern (b),
                    the same drops with no decoder, ends at the first
                    headless frame (a reference fault, ROADMAP.md section 3)
  rtp_fec_udp       the camera with SMPTE 2022-1 over udpsink / udpsrc on
                    loopback (where the probe found UDP): packets lost and
                    recovered, frames whole, each equal to its TCP frame
  rtp_gst_raw       16 1080p I420 frames through rtpgstpay ! rtpgstdepay to
                    RGB 224x224: the direct conversion's bytes, yscale_hv
                    once
  rtp_mp2t_line     mpegtsmux's TS of the committed AAC and MP3 through
                    rtpmp2tpay ! rtpst2022_1_fecenc, seeded drops, then
                    rtpst2022_1_fecdec ! rtpmp2tdepay ! filesink: the TS
                    bytes sent; tsdemux ! aacparse ! faad of it the plain
                    file's PCM, the ASR chain's output the sent TS's
  rtp_coded_audio   MP3 through rtpmpapay ! rtpmpadepay ! mpegaudioparse !
                    mpg123audiodec and AAC through rtpmp4gpay ! rtpmp4gdepay
                    ! faad: the plain files' PCM; the Vorbis and Theora
                    packets of the committed Ogg files back from their
                    payloaders
  siren_rtp         10 s of 16 kHz mono through sirenenc ! rtpsirenpay !
                    rtpsirendepay ! sirendec: the card's PCM the CPU run's

   then each of the 76 factories alone, the card equal to the CPU.

22. The rest of net/: RIST, WebRTC, SRT, RTMP, HLS/DASH, shm, AVTP
   (net_tail_phase; host code, the card decoding and converting).  Its
   first line is a probe: libssl / libcrypto, libsrt, an AF_PACKET socket
   on lo, UDP and TCP on loopback.  An item whose library or permission is
   missing prints the error both packages raise, as a difference of
   installation, and is no pass:

  rist_camera       phase 20's 32 1080p JPEGs through rtpjpegpay mtu=1400 !
                    ristsink (a frame a tick at 25/1), a relay on 127.0.0.1
                    (a process of its own, with 4 MiB socket buffers asked)
                    that drops the first copy of 16 seeded packets (the
                    first packet of 4 frames among them), ristsrc !
                    rtpjpegdepay ! jpegdec ! RGB 224x224 at batch 16, with
                    generic and with range NACKs: every drop recovered, none
                    lost, 32 of 32 frames whole and each multifilesrc !
                    jpegdec's (the CPU run's), yscale_hv once a tick that
                    gives frames
  rist_camera_live  the same with no relay, beside rtp_fec_udp's figures
  webrtc_camera     two webrtcbins (ICE on 127.0.0.1, DTLS-SRTP) carry
                    rtpjpegpay mtu=1200's packets of 16 frames; the
                    receiver's packets through appsrc ! rtpjpegdepay !
                    jpegdec ! RGB 224x224: no datagram holds a sent JPEG
                    payload, every frame its reference's
  srt_ts_link       rtp_mp2t_line's TS through srtsink mode=listener to
                    srtsrc mode=caller, plain and with a passphrase: the
                    bytes sent; tsdemux ! aacparse ! faad of them the plain
                    file's PCM
  rtmp_audio        the committed AAC's units through flvmux, filesrc !
                    rtmp2sink, RtmpRelayServer and rtmp2src ! filesink: the
                    tags sent; flvdemux of them within the JAX digest
  hls_dash_pull     hlsdemux and dashdemux over hlssink2's and dashsink's
                    segments of the AAC (file:// URIs): the plain decode
  shm_camera        the JPEGs through jpegparse ! shmsink, shmsrc ! jpegdec
                    ! RGB 224x224: the reference, yscale_hv once a tick
  avtp_raw_video    16 seeded 1080p I420 frames as GRAY8 rows through
                    avtprvfpay ! avtprvfdepay, then RGB 224x224: the direct
                    conversion's bytes, yscale_hv once; AAF and CVF pay /
                    depay; avtpsink / avtpsrc on lo where AF_PACKET is
                    allowed

   then each of the 55 factories alone, the card equal to the CPU.

23. The libav family and the numpy codecs LC3, Smoke and FLIC
   (codec_tail_phase; host codecs, the card decoding and converting).  Its
   first line is a probe: what native/av.py finds of libavcodec
   (``missing()``, ``available()``, ``have_codec`` of every codec the
   tables name).  Where libavcodec is absent, the libav items print the
   error both packages raise, as a difference of installation, and are no
   pass; the vectors are committed under tests/data/torch_codecs/:

  h264_ingest       h264_1080p.ts through tsdemux ! h264parse ! avdec_h264:
                    every plane the JAX package's sha256; then ! I420
                    1920x1080 (the decoder's caps carry no size) !
                    videoconvertscale ! RGB 640x360 at batch 4, yscale_hv
                    once a decoded buffer, equal to the plain route
                    (GTPU_PALLAS_YSCALE=0); speex_16k.spx through oggdemux
                    within the JAX digest.  Without libavcodec: decodebin on
                    the TS and oggdemux on the Speex file, each the error
                    both packages raise
  smoke_camera      8 integer-made 1080p I420 frames (ct_frames) through
                    smokeenc (the packets' sha256 the CPU box's), smokeenc !
                    smokedec (every plane's), and on to videoconvertscale !
                    RGB 640x360 at batch 4: yscale_hv once a tick, equal to
                    the plain route
  flic_anim         anim_320x200.flc through flxdec (the RGB planes the JAX
                    package's sha256) and flxdec ! videoconvertscale ! I420
                    640x400 (every plane's)
  lc3_stereo        0.5 s of integer-made 48 kHz stereo S16 through lc3enc
                    (10 ms frames; the bytes' sha256) and lc3enc ! lc3dec
                    (the PCM's), both the CPU box's

24. Subtitles, tags and the last parsers (tags_subs_phase; host modules,
   the card converting).  Its first line names Pillow's version (text
   bitmaps are compared within one machine) and whether x264enc, dvdec and
   av1dec registered (libavcodec):

  subtitle_burnin   64 1080p videotestsrc frames into subtitleoverlay, an
                    .srt of 8 cues through filesrc ! subparse on its text
                    pad, then videoconvertscale ! RGB 224x224 at batch 16:
                    yscale_hv once a tick, every frame equal to the port's
                    CPU run of the same string, the text drawn
  ttml_burnin       the same with ttmlrender, a TTML document a tick (32)
  mjpeg_multipart_camera
                    phase 20's 32 1080p JPEGs written by multipartmux, then
                    multipartdemux ! jpegdec ! RGB 224x224 at batch 16:
                    yscale_hv twice, equal to multifilesrc's reference; the
                    parts stay host bytes
  tags_roundtrip    id3v2mux / id3demux and apev2mux / apedemux on
                    mp3_10s.mp3, flactag on tags_1s.flac (flacdec's PCM
                    unchanged), vorbistag / vorbisparse on vorbis_10s.ogg's
                    packets, the discoverer on every committed vector: the
                    CPU box's digests; the tagged MP3's PCM within the JAX
                    package's digest
  transcode_raw     a raw 1080p Matroska through uritranscodebin to raw:
                    the CPU's file, read back equal to the input; an x264enc
                    profile where libavcodec has libx264, else the error
                    both packages raise, as no pass
  bpm_click         bpmdetect on a 10 s seeded click track: the CPU's bpm
  alone             each factory of the slice on small inputs, the card
                    equal to the CPU, no launch

25. The last factories (leaves_phase): camerabin into msesrc, a splitmux
   MJPEG camera, fakevideodec, a unixfd camera and libde265dec, each 1080p
   to RGB 224x224 (yscale_hv once a tick that gave frames), then each
   factory alone against the CPU box's digests.

26. The last host modules (tail_modules_phase; the inputs from TM_SEED,
   whose digests the JAX package wrote: make_vectors.py's tail group):

  convert_sample_1080p
                    16 integer-made 1080p I420 frames through
                    video/hdr.py's convert_sample to RGB 224x224 on the
                    card in one call (the converter's default cubic):
                    yscale_hv once, chroma420_scale twice; equal to the
                    port's CPU run and to the JAX package's digest
  harness_1080p     Harness("videoconvertscale add-borders=false") on the
                    card, 1080p I420 to RGB 224x224: 4 pushes of 16 snow
                    frames made on the card (yscale_hv once a push), then
                    push_from_src of a videotestsrc sub-harness; each equal
                    to the direct conversion of the same frames
  monitored_headline
                    PipelineMonitor over 64 frames of 1080p snow to RGB
                    224x224 at batch 16 under a Scenario (a forward seek, a
                    property set, EOS injected): no violation, the report,
                    timestamps and frames equal to the CPU run's; yscale_hv
                    once a tick that gave frames
  timeline_crossfade_1080p
                    two 24-frame 1080p I420 Matroska files (matroskamux on
                    the card) as UriClips overlapping by 8 frames under a
                    4-frame TitleClip, timelinevideosrc into a 384x216 RGB
                    track at 25/1 (each clip's sub-pipeline at batch 1,
                    yscale_hv a frame; the crossfade and the stack on the
                    card), and timelineaudiosrc of two overlapping square
                    waves at 48 kHz stereo S16LE: equal to the CPU run and
                    to the JAX package's digests
  alone             the host items (timecode, ANC, multiview, DMA, IEC
                    61937, stream align, a codec base subclass, and
                    tools.typefind, tools.stats on the card, dotsviewer on
                    monitored_headline's dot dump, logviewer on a log the
                    phase writes), the card equal to the CPU and to the
                    JAX package's digests, no launch

Outputs are checked against the port's own CPU path (first frames), the
converter's numpy gold and videobalance's float64 tables.  Any failure
raises.  The last line of standard output is one JSON object {"ok": true,
"device": ...}; the line before it holds the kernels' JSON, and the line
before that the card's name and power limit.  Needs one CUDA card; exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
# H100 SXM int32: 64 of an SM's 128 lanes per clock take int32 (half the
# 67e12 non-tensor fp32 rate), a multiply-add counted as 2 operations
INT32_OPS_PER_S = 33.5e12
# dp4a: one int32-lane instruction makes four 8-bit products and adds them,
# so the same lanes do four times the operations.  The two-pass scale
# kernels run every product there, an S16 tap as two 8-bit limbs: 2
# multiply-adds, 4 operations, per tap and sample.
DP4A_OPS_PER_S = 4 * INT32_OPS_PER_S
W, H, OW, OH = 1920, 1080, 224, 224
CONFIGS = {
    "linear2": {"resampler-method": "linear", "resampler-taps": 2},
    "cubic": None,
    "add_borders": {"resampler-method": "linear", "resampler-taps": 2,
                    "dest-x": 0, "dest-y": 49, "dest-width": 224,
                    "dest-height": 126},
    # linear2's plan; convert() runs under opt_in() (FUSED_CONFIGS)
    "fused_ingest": {"resampler-method": "linear", "resampler-taps": 2},
}
FUSED_CONFIGS = ("fused_ingest",)
SMALL = (3, 46, 70, 20, 33)     # B, H, W, OH, OW: an awkward small shape


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


@contextlib.contextmanager
def switches(**env):
    """The converter's GTPU_PALLAS* switches set inside the block only (a
    value of None unsets one); they are read at every convert()."""
    old = {k: os.environ.pop(k, None) for k in env}
    os.environ.update({k: v for k, v in env.items() if v is not None})
    try:
        yield
    finally:
        for k, v in old.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def opt_in(on: bool = True):
    """GTPU_PALLAS=1 (the converter's fused-ingest route) inside the block
    only."""
    return switches(GTPU_PALLAS="1" if on else None)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Device ms a call of fn: `iters` calls captured in one CUDA graph and
    replayed, so no host time falls between the launches."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def touched(res, limit: int) -> int:
    """Distinct source samples a resampler's taps read."""
    import numpy as np
    idx = res.offset[:, None] + np.arange(res.max_taps)[None, :]
    return int(np.unique(np.clip(idx, 0, limit - 1)).size)


def bound(bytes_moved: float, ops: float, dp4a_ops: float = 0.0):
    """(ms, "bytes" or "operations", unit): the larger of the bytes over the
    card's memory rate and the operations over the peak rate of the unit
    that does them: `ops` on the int32 lanes, `dp4a_ops` at dp4a's rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = (ops / INT32_OPS_PER_S + dp4a_ops / DP4A_OPS_PER_S) * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s"
    unit = (f"dp4a {DP4A_OPS_PER_S / 1e12:.0f} T 8-bit ops/s" if dp4a_ops
            else f"int32 {INT32_OPS_PER_S / 1e12:.1f} T ops/s")
    return t_ops, "operations", unit


def two_pass_ops(b, rows, h_res, v_res):
    """dp4a operations of a two-pass scale: 4 per tap and sample (two 8-bit
    limb multiply-adds), over the `rows` source rows the vertical taps read
    and over every output."""
    return 4.0 * b * (rows * h_res.out_size * h_res.max_taps
                      + v_res.out_size * h_res.out_size * v_res.max_taps)


def dense_pair(x_f32, h_res, v_res):
    """The library yardstick: two dense fp32 tap-matrix products (no TF32)."""
    import torch
    from gstreamer_tpu_torch.video.scaler import tap_matrix
    mh = torch.as_tensor(tap_matrix(h_res).T.astype("float32"),
                         device=x_f32.device)
    mv = torch.as_tensor(tap_matrix(v_res).astype("float32"),
                         device=x_f32.device)
    return lambda: torch.matmul(mv, torch.matmul(x_f32, mh))


def dense_h(x_f32, h_res):
    """The library yardstick of an h-only scale: one dense fp32 product."""
    import torch
    from gstreamer_tpu_torch.video.scaler import tap_matrix
    mh = torch.as_tensor(tap_matrix(h_res).T.astype("float32"),
                         device=x_f32.device)
    return lambda: torch.matmul(x_f32, mh)


# -- the h-only, int32 and fused-ingest kernels: kernel vs plain, timings -----

def max_err(ks, ps, what):
    """Largest difference between a kernel's outputs and its plain
    version's; dtypes and shapes must agree."""
    err = 0
    for k, p in zip(ks, ps):
        require(k.dtype == p.dtype and k.shape == p.shape,
                f"{what}: kernel gives {k.dtype} {tuple(k.shape)}, plain "
                f"{p.dtype} {tuple(p.shape)}")
        err = max(err, int((k.int() - p.int()).abs().max()))
    return err


ODD_WIDTH = (2, 270, 484, 112, 112)   # B, H, W, OH, OW: W % 16 == 4
SKEWED = 2                            # 1080p frames of the misaligned view


def check_two_pass(planes, plans, rng):
    """yscale_hv, scale_hv_u8 and chroma420_scale (all four sitings)
    against their plain versions, bit for bit, where the staging differs:
    the launch paths' batch of 64 at the main path's shape (bulk copies),
    a width that is no multiple of 16, the awkward small shape on a view
    that starts off a 16-byte boundary, and full-width frames on a view
    that starts one byte in (word-by-word staging).  Returns {kernel:
    largest difference (0)}."""
    import torch
    from gstreamer_tpu_torch.ops import chroma420_kernel as ck
    from gstreamer_tpu_torch.ops import scale2d_kernel as s2k
    from gstreamer_tpu_torch.ops import yscale_kernel as ysk
    from gstreamer_tpu_torch.video.scaler import make_resampler
    dev = planes[0].device

    def view(n, h, w, skip):
        """(n, h, w) random bytes starting `skip` bytes into a tensor."""
        flat = torch.as_tensor(rng.integers(0, 256, skip + n * h * w + 16,
                                            dtype="uint8")).to(dev)
        return flat[skip:skip + n * h * w].view(n, h, w)

    cases = [(planes[0][:DEINT_BATCH], planes[1][:DEINT_BATCH], p["h_res"],
              p["v_res"]) for p in plans]
    ob, oh_, ow_, ooh, oow = ODD_WIDTH
    cases.append((view(ob, oh_, ow_, 0), view(ob, oh_ // 2, ow_ // 2, 0),
                  make_resampler("linear", ow_, oow, 0, max_taps_opt=2),
                  make_resampler("linear", oh_, ooh, 0, max_taps_opt=2)))
    sb, sh, sw, soh, sow = SMALL
    cases.append((view(sb, sh, sw, sh * sw), view(sb, sh // 2, sw // 2,
                                                  (sh // 2) * (sw // 2)),
                  make_resampler("lanczos", sw, sow),
                  make_resampler("lanczos", sh, soh)))
    cases.append((view(SKEWED, H, W, 1), view(SKEWED, H // 2, W // 2, 1),
                  plans[1]["h_res"], plans[1]["v_res"]))
    err = {"yscale_hv": 0, "scale_hv_u8": 0, "chroma420_scale": 0}
    for y, c, hr, vr in cases:
        w, h = hr.in_size, vr.in_size
        err["yscale_hv"] = max(err["yscale_hv"], max_err(
            [ysk.yscale_hv(y, hr, vr)], [ysk.yscale_hv_plain(y, hr, vr)],
            "yscale_hv"))
        err["scale_hv_u8"] = max(err["scale_hv_u8"], max_err(
            [s2k.scale_hv_u8(y, hr, vr)], [s2k.scale_hv_u8_plain(y, hr, vr)],
            "scale_hv_u8"))
        for h_cos in (False, True):
            for v_cos in (False, True):
                err["chroma420_scale"] = max(err["chroma420_scale"], max_err(
                    [ck.chroma420_scale(c, hr, vr, h_cos, v_cos, w, h)],
                    [ck.chroma420_scale_plain(c, hr, vr, h_cos, v_cos)],
                    "chroma420_scale"))
        torch.cuda.synchronize()
    for kname, e in err.items():
        require(e == 0, f"{kname}: kernel differs from its plain version "
                f"by up to {e}")
    return err


def check_new_kernels(planes, plans, rng):
    """hscale_u8, scale_hv_u8 and fused_i420_up_hscale against their plain
    versions, bit for bit, at the main path's shape under both plans
    (linear/2 and cubic taps) and at one awkward small shape (lanczos; a
    view that starts off a 16-byte boundary included).  Returns
    {kernel: largest difference (0)}."""
    import torch
    from gstreamer_tpu_torch.ops import convert_kernel as fk
    from gstreamer_tpu_torch.ops import hscale_kernel as hk
    from gstreamer_tpu_torch.ops import scale2d_kernel as s2k
    from gstreamer_tpu_torch.video.scaler import make_resampler
    sb, sh, sw, soh, sow = SMALL
    small = tuple(torch.as_tensor(rng.integers(0, 256, shp, dtype="uint8")
                                  ).to(planes[0].device)[1:]
                  for shp in ((sb + 1, sh, sw), (sb + 1, sh // 2, sw // 2),
                              (sb + 1, sh // 2, sw // 2)))
    cases = [(planes, p["h_res"], p["v_res"]) for p in plans]
    cases.append((small, make_resampler("lanczos", sw, sow),
                  make_resampler("lanczos", sh, soh)))
    err = {"hscale_u8": 0, "scale_hv_u8": 0, "fused_i420_up_hscale": 0}
    for (y, u, v), hr, vr in cases:
        err["hscale_u8"] = max(err["hscale_u8"], max_err(
            [hk.hscale_u8(y, hr)], [hk.hscale_u8_plain(y, hr)], "hscale_u8"))
        err["scale_hv_u8"] = max(err["scale_hv_u8"], max_err(
            [s2k.scale_hv_u8(y, hr, vr)], [s2k.scale_hv_u8_plain(y, hr, vr)],
            "scale_hv_u8"))
        for cosited in (False, True):
            err["fused_i420_up_hscale"] = max(
                err["fused_i420_up_hscale"], max_err(
                    fk.fused_i420_up_hscale(y, u, v, hr, cosited),
                    fk.fused_i420_up_hscale_plain(y, u, v, hr, cosited),
                    "fused_i420_up_hscale"))
        torch.cuda.synchronize()
    for kname, e in err.items():
        require(e == 0, f"{kname}: kernel differs from its plain version "
                f"by up to {e}")
    return err


def check_h_only(planes, plans, rng):
    """hscale_u8 and fused_i420_up_hscale (both sitings) against their plain
    versions, bit for bit, where the staging or the partition into blocks
    differs from the batch's: the launch paths' batch of 64 at the main
    path's shape under both plans (bulk copies, shorter runs), a width that
    is no multiple of 16, the awkward small shape (23 chroma rows, lanczos)
    on a view that starts off a 16-byte boundary, and full-width frames on
    a view that starts one byte in (word-by-word staging).  Returns
    {kernel: largest difference (0)}."""
    import torch
    from gstreamer_tpu_torch.ops import convert_kernel as fk
    from gstreamer_tpu_torch.ops import hscale_kernel as hk
    from gstreamer_tpu_torch.video.scaler import make_resampler
    dev = planes[0].device

    def i420(n, h, w, skip):
        """(y, u, v) of random bytes, each starting `skip` bytes into a
        tensor."""
        out = []
        for hh, ww in ((h, w), (h // 2, w // 2), (h // 2, w // 2)):
            flat = torch.as_tensor(rng.integers(
                0, 256, skip + n * hh * ww + 16, dtype="uint8")).to(dev)
            out.append(flat[skip:skip + n * hh * ww].view(n, hh, ww))
        return tuple(out)

    cases = [(tuple(p[:DEINT_BATCH] for p in planes), plan["h_res"])
             for plan in plans]
    ob, oh_, ow_, _, oow = ODD_WIDTH
    cases.append((i420(ob, oh_, ow_, 0),
                  make_resampler("linear", ow_, oow, 0, max_taps_opt=2)))
    sb, sh, sw, _, sow = SMALL
    cases.append((i420(sb, sh, sw, 3), make_resampler("lanczos", sw, sow)))
    cases += [(i420(SKEWED, H, W, 1), plan["h_res"]) for plan in plans]
    err = {"hscale_u8": 0, "fused_i420_up_hscale": 0}
    for (y, u, v), hr in cases:
        err["hscale_u8"] = max(err["hscale_u8"], max_err(
            [hk.hscale_u8(y, hr)], [hk.hscale_u8_plain(y, hr)], "hscale_u8"))
        for cosited in (False, True):
            err["fused_i420_up_hscale"] = max(
                err["fused_i420_up_hscale"], max_err(
                    fk.fused_i420_up_hscale(y, u, v, hr, cosited),
                    fk.fused_i420_up_hscale_plain(y, u, v, hr, cosited),
                    "fused_i420_up_hscale"))
        torch.cuda.synchronize()
    for kname, e in err.items():
        require(e == 0, f"{kname}: kernel differs from its plain version "
                f"by up to {e}")
    return err


def time_new_kernels(planes, plans):
    """{(kernel, tag): times and bound} at the batch's shape.  Bytes: each
    input read once, each output written once (scale_hv_u8: the rows its
    vertical taps read, as for yscale_hv).  Operations: every product runs
    on dp4a, 4 operations per tap and sample at that rate (scale_hv_u8:
    two_pass_ops), plus the up2 filters of the fused kernel (about 4 per
    sample they produce, on packed words, four samples to an int32 lane)."""
    import torch
    from gstreamer_tpu_torch.ops import convert_kernel as fk
    from gstreamer_tpu_torch.ops import hscale_kernel as hk
    from gstreamer_tpu_torch.ops import scale2d_kernel as s2k
    y, u, v = planes
    b = y.shape[0]
    y_f32 = y.float()
    up_f32 = torch.repeat_interleave(torch.repeat_interleave(u, 2, -1),
                                     2, -2).float()
    out = {}
    for tag, plan in plans.items():
        hr, vr = plan["h_res"], plan["v_res"]
        th, tv = hr.max_taps, vr.max_taps
        cos = plan["up_h_cosited"]
        lib_h = dense_h(y_f32, hr)
        lib_c = dense_h(up_f32, hr)
        out[("hscale_u8", tag)] = dict(
            ms=cuda_ms(lambda: hk.hscale_u8(y, hr), 20),
            plain_ms=cuda_ms(lambda: hk.hscale_u8_plain(y, hr), 3, 1),
            library_ms=cuda_ms(lib_h, 5, 1), library="1 dense fp32 matmul",
            bound=bound(b * H * W + b * H * OW * 4, 0.0,
                        4.0 * b * H * OW * th),
            taps=(th,))
        rows = touched(vr, H)
        out[("scale_hv_u8", tag)] = dict(
            ms=cuda_ms(lambda: s2k.scale_hv_u8(y, hr, vr), 20),
            plain_ms=cuda_ms(lambda: s2k.scale_hv_u8_plain(y, hr, vr), 3, 1),
            library_ms=cuda_ms(dense_pair(y_f32, hr, vr), 5, 1),
            library="2 dense fp32 matmuls",
            bound=bound(b * rows * W + b * OH * OW * 4, 0.0,
                        two_pass_ops(b, rows, hr, vr)),
            taps=(th, tv))
        out[("fused_i420_up_hscale", tag)] = dict(
            ms=cuda_ms(lambda: fk.fused_i420_up_hscale(y, u, v, hr, cos), 20),
            plain_ms=cuda_ms(
                lambda: fk.fused_i420_up_hscale_plain(y, u, v, hr, cos),
                3, 1),
            library_ms=None,
            # no single call computes it; three dense h products (Y and two
            # nearest-upsampled chroma planes) move comparable data
            yardstick_ms=cuda_ms(lambda: (lib_h(), lib_c(), lib_c()), 5, 1),
            bound=bound(b * H * W * 3 // 2 + b * 3 * H * OW * 2, 0.0,
                        4.0 * b * 3 * H * OW * th
                        + b * 2 * 4.0 * (W * H // 2 + W * H)),
            taps=(th,))
    return out


def standalone_ops(planes, host, plan):
    """The two standalone scale ops as a user calls them, at full width on
    the batch's luma plane; outputs checked for shape and type, and against
    the port's CPU path on the first frames."""
    import torch
    from gstreamer_tpu_torch.ops import hscale_kernel as hk
    from gstreamer_tpu_torch.ops import scale2d_kernel as s2k
    hr, vr = plan["h_res"], plan["v_res"]
    y = planes[0]
    require(hk.applicable(hr, y.shape) and s2k.applicable(hr, vr, y.shape),
            "standalone ops: the headline shape fails their own gates")
    out_h = hk.hscale_u8(y, hr)
    out_hv = s2k.scale_hv_u8(y, hr, vr)
    torch.cuda.synchronize()
    b = y.shape[0]
    require(out_h.dtype == out_hv.dtype == torch.int32
            and tuple(out_h.shape) == (b, H, OW)
            and tuple(out_hv.shape) == (b, OH, OW),
            "standalone ops: bad output")
    cpu = torch.as_tensor(host[0][:CPU_FRAMES])
    require(torch.equal(out_h[:CPU_FRAMES].cpu(), hk.hscale_u8(cpu, hr))
            and torch.equal(out_hv[:CPU_FRAMES].cpu(),
                            s2k.scale_hv_u8(cpu, hr, vr)),
            "standalone ops: CUDA output differs from the port's CPU path")
    require(int(out_h.min()) >= 0 and int(out_h.max()) <= 255
            and int(out_hv.min()) >= 0 and int(out_hv.max()) <= 255,
            "standalone ops: output outside 0..255")


# -- deinterlace: kernel vs plain, timings ----------------------------------

DEINT_BATCH = 64                # bench_all.py's batch per tick at 1080i
DEINT_ODD = (3, 45, 301)        # odd height and width: the byte path


def check_deint(planes, rng):
    """deint_both_parities against its plain version, bit for bit, at the
    chain's Y and U/V shapes and one odd shape, both methods, both
    parities.  Returns the largest difference (0)."""
    import torch
    from gstreamer_tpu_torch.ops import deint_kernel as dk
    odd = torch.as_tensor(rng.integers(0, 256, DEINT_ODD, dtype="uint8")
                          ).to(planes[0].device)
    err = 0
    for plane in (planes[0][:DEINT_BATCH], planes[1][:DEINT_BATCH], odd):
        for method in dk.METHODS:
            for parity0 in (0, 1):
                k = dk.deint_both_parities(plane, method, parity0)
                p = dk.deint_both_parities_plain(plane, method, parity0)
                torch.cuda.synchronize()
                require(k.dtype == torch.uint8 and k.shape == p.shape,
                        f"deint {tuple(plane.shape)}: bad output")
                err = max(err, int((k.int() - p.int()).abs().max()))
    require(err == 0, f"deint_both_parities: kernel differs from its plain "
            f"version by up to {err}")
    return err


def time_deint(planes):
    """Per tick of the chain (Y + U + V at batch 64, method linear): the
    kernel, the plain version, the byte bound and a copy_ yardstick that
    moves the same bytes (one read, two writes; the port never calls
    it)."""
    import torch
    from gstreamer_tpu_torch.ops import deint_kernel as dk
    t = dict(ms=0.0, plain_ms=0.0, copy_ms=0.0, bytes=0, ops=0)
    for i, reps in ((0, 1), (1, 2)):                # Y once, U and V alike
        plane = planes[i][:DEINT_BATCH]
        nf, h, w = plane.shape
        dst = torch.empty((nf, 2, h, w), dtype=torch.uint8,
                          device=plane.device)
        both = plane.unsqueeze(1).expand(nf, 2, h, w)
        t["ms"] += reps * cuda_ms(
            lambda: dk.deint_both_parities(plane, "linear", 0), 20)
        t["plain_ms"] += reps * cuda_ms(
            lambda: dk.deint_both_parities_plain(plane, "linear", 0), 3, 1)
        t["copy_ms"] += reps * cuda_ms(lambda: dst.copy_(both), 20)
        t["bytes"] += reps * 3 * plane.numel()
        t["ops"] += reps * 3 * plane.numel()       # (a + b + 1) >> 1
        del dst
    t["bound"] = bound(t["bytes"], t["ops"])
    return t


# -- launch strings through parse_launch -------------------------------------

SRC = ("appsrc name=in caps=video/x-raw,format=I420,width={w},height={h},"
       "framerate=30/1 ! ")
# the README quick-start string, with the source pinned to 1080p I420 and n
# frames (videotestsrc has no appsrc to feed: it makes its frames on the card)
QUICKSTART = ("videotestsrc pattern=snow num-buffers={n} ! video/x-raw,"
              "format=I420,width={w},height={h},framerate=30/1 ! "
              "videoconvertscale add-borders=false ! video/x-raw,format=RGB,"
              "width=224,height=224 ! appsink name=out")
LAUNCH = {       # name: (launch string, batch, ticks, GTPU_PALLAS=1)
    "deint_chain": (SRC + "deinterlace method=linear ! videobalance "
                    "contrast=1.1 brightness=0.05 ! appsink name=out",
                    DEINT_BATCH, 3, False),
    "deint_rate_chain": (SRC + "deinterlace method=scalerbob ! videorate ! "
                         "video/x-raw,framerate=30/1 ! videobalance "
                         "saturation=1.2 ! appsink name=out", 16, 2, False),
    "headline_launch": (SRC + "videoconvertscale ! video/x-raw,format=RGB,"
                        "width=224,height=224 ! appsink name=out", 64, 3,
                        False),
    "headline_launch_noborders": (
        SRC + "videoconvertscale add-borders=false ! video/x-raw,format=RGB,"
        "width=224,height=224 ! appsink name=out", 64, 3, False),
    "quickstart": (QUICKSTART, 64, 3, False),
    "quickstart_fused": (QUICKSTART, 64, 3, True),
}
DUR = 33333333                  # ns per input frame at 30/1
CPU_FRAMES = 2                  # input frames the CPU reference runs


def drive(desc, batch, ticks, planes, device=None):
    """Push `ticks` buffers of `planes` (the same frames each tick) into
    appsrc, where the string has one (a videotestsrc makes batch * ticks
    frames itself), and tick the pipeline to EOS, each tick timed on the
    host clock between two synchronises.  Returns (pipeline, first sample,
    output frames per tick, seconds per tick)."""
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.pipeline import State
    cuda = device is None
    pipe = parse_launch(desc.format(w=W, h=H, n=batch * ticks), batch=batch,
                        device=device)
    src, sink = pipe.get_by_name("in"), pipe.get_by_name("out")
    if src is not None:
        for t in range(ticks):
            src.push_buffer(Buffer(data=planes, pts=t * batch * DUR,
                                   duration=DUR, batch=batch))
        src.end_of_stream()
    pipe.set_state(State.PLAYING)
    first, frames, secs = None, [], []
    while True:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        more = pipe.tick()
        if cuda:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not more:
            break
        n = 0
        while (s := sink.pull_sample()) is not None:
            if first is None:
                first = s
            n += s.buffer.batch
        frames.append(n)
        secs.append(dt)
    pipe.set_state(State.NULL)
    return pipe, first, frames, secs


def balance_gold(pipe, deinterlaced):
    """videobalance's float64 tables looked up on the host."""
    import numpy as np
    bal = next(e for e in pipe.iterate_elements()
               if e.FACTORY == "videobalance")
    ty, tu, tv = bal._tables()
    y, u, v = (np.asarray(p, np.int64) for p in deinterlaced)
    return ty[y], tu[u, v], tv[u, v]


def launch_paths(planes, host, counters, table=None):
    """Drive every launch path on the card with the counts zeroed just
    before it and read just after; check its outputs against the same
    launch string run by the port on the CPU over the first input frames,
    and the deint chain against the plain deinterlace and videobalance's
    float64 tables.  Returns {name: dict of counts, frames/s, ...}."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch.ops import deint_kernel as dk
    res = {}
    for name, (desc, batch, ticks, fused) in (table or LAUNCH).items():
        ins = tuple(p[:batch] for p in planes)
        with opt_in(fused):
            torch.cuda.reset_peak_memory_stats()
            for c in counters.values():
                c.launches = 0
            pipe, first, frames, secs = drive(desc, batch, ticks, ins)
            counts = {k: c.launches for k, c in counters.items()}
            peak = torch.cuda.max_memory_allocated()
            require(len(frames) == ticks and all(frames),
                    f"{name}: {frames} output frames per tick")
            _, ref, _, _ = drive(desc, CPU_FRAMES, 1,
                                 tuple(p[:CPU_FRAMES] for p in host), "cpu")
        n = ref.buffer.batch
        require(first.buffer.pts == ref.buffer.pts
                and str(first.caps) == str(ref.caps),
                f"{name}: first sample's pts/caps differ from the CPU run")
        for o, r in zip(first.buffer.data, ref.buffer.data):
            require(o.device.type == "cuda", f"{name}: output on {o.device}")
            require(torch.equal(o[:n].cpu(), r),
                    f"{name}: CUDA output differs from the port's CPU path")
        if name == "deint_chain":
            fields = tuple(dk.deint_both_parities_plain(
                torch.as_tensor(p[:CPU_FRAMES]), "linear", 0).flatten(0, 1)
                for p in host)
            for o, g in zip(first.buffer.data, balance_gold(pipe, fields)):
                require(np.array_equal(
                    o[:2 * CPU_FRAMES].cpu().numpy().astype(np.int64), g),
                    "deint_chain: output differs from deint plain + "
                    "videobalance float64 tables")
            require(counts["deint_both_parities"] == 3 * ticks,
                    f"deint_chain: {counts} launches, want 3 deint per tick")
        elif name == "deint_rate_chain":
            require(counts["deint_both_parities"] >= 1,
                    f"deint_rate_chain: deint kernel not launched {counts}")
        elif name in ("headline_launch_noborders", "quickstart"):
            require(counts["yscale_hv"] >= 1
                    and counts["fused_i420_up_hscale"] == 0,
                    f"{name}: want the yscale kernel and no fused-ingest "
                    f"launch, got {counts}")
        elif name == "launch_small_default":
            require(not any(counts.values()) and pipe._fused,
                    f"{name}: want the phase-split route in one fused "
                    f"program and no kernel, got {counts}")
        elif name == "quickstart_fused":
            require(counts["fused_i420_up_hscale"] == ticks
                    and counts["yscale_hv"] == 0,
                    f"{name}: want one fused-ingest launch per tick and no "
                    f"yscale launch, got {counts}")
        timed_f, timed_s = sum(frames[1:]), sum(secs[1:])
        res[name] = dict(counts=counts, batch=batch, ticks=ticks,
                         frames=frames, secs=secs, fused=pipe._fused,
                         fps=timed_f / timed_s, ref_frames=n, peak=peak)
        del first
        print(f"path {name}: batch {batch}, {ticks} ticks, "
              f"{'fused' if pipe._fused else 'per-element'}; launches "
              f"{counts}; output frames per tick {frames}; peak device "
              f"memory {peak / 2**30:.2f} GiB; CUDA == port CPU ({n} "
              f"frames)")
    return res


# -- the converter's other routes, at full width --------------------------------

BT709 = ("16-235", "bt709", "bt709", "bt709")
LINEAR2 = {"resampler-method": "linear", "resampler-taps": 2}
# name: input (format, size, VideoInfo arguments), output, batch, config,
# whether GTPU_PALLAS=1 is set, and the plan entries the route must show
GENERIC = {
    "nv12_ingest": dict(
        src=("NV12", (W, H), {}), dst=("RGB", (OW, OH), {}), batch=256,
        cfg=LINEAR2, want={"scale_order": "hv", "scale_before_matrix": True},
        launches={}),
    "nv12_fused": dict(
        src=("NV12", (W, H), {}), dst=("RGB", (OW, OH), {}), batch=256,
        cfg=LINEAR2, fused=True, want={"pallas_ok": True},
        launches={"fused_i420_up_hscale": 1}),
    "upscale": dict(
        src=("I420", (640, 360), {}), dst=("RGB", (W, H), {}), batch=32,
        cfg=None, want={"scale_before_matrix": False, "upsample": True},
        launches={}),
    "same_size": dict(
        src=("I420", (W, H), {}), dst=("BGRA", (W, H), {}), batch=32,
        cfg=None, want={"h_res": None, "v_res": None, "upsample": True},
        launches={}),
    "encode_side": dict(
        src=("RGB", (W, H), {}), dst=("I420", (1280, 720), {}), batch=32,
        cfg=None, want={"scale_before_matrix": True, "upsample": False,
                        "downsample": True}, launches={}),
    "hdr_ingest": dict(
        src=("P010_10LE", (W, H), {}), dst=("RGB", (OW, OH), {}), batch=64,
        cfg=LINEAR2, want={"unpack_bits": 16, "pack_bits": 8, "dither": None},
        launches={}),
    "rgb16_out": dict(
        src=("I420", (W, H), {}), dst=("RGB16", (640, 360), {}), batch=32,
        cfg=None, want={"pack_bits": 8},
        launches={"yscale_hv": 1, "chroma420_scale": 2}),
    # a serial dither: only the planes at the dither step visit the host, so
    # the route's kernels launch as they do for rgb16_out (timed once: the
    # dither is a Python loop over pixels)
    "rgb16_serial": dict(
        src=("I420", (W, H), {}), dst=("RGB16", (640, 360), {}),
        batch=CPU_FRAMES, cfg={"dither-method": "floyd-steinberg"},
        want={"pack_bits": 8}, timing=(1, 0),
        launches={"yscale_hv": 1, "chroma420_scale": 2}),
    "gamma_remap": dict(
        src=("I420", (W, H), {"colorimetry": BT709}),
        dst=("RGB", (640, 360),
             {"colorimetry": ("0-255", "rgb", "srgb", "bt2020")}),
        batch=16, cfg={"gamma-mode": "remap", "primaries-mode": "fast"},
        want={"do_gamma": True}, launches={}),
    "interlaced": dict(
        src=("I420", (W, H), {"interlace_mode": "interleaved"}),
        dst=("I420", (1280, 720), {"interlace_mode": "interleaved"}),
        batch=16, cfg=None, want={"interlaced": True, "downsample": True},
        launches={}),
}
GENERIC_LAUNCH = {
    "launch_small_default": (
        "videotestsrc num-buffers={n} ! video/x-raw,format=NV12,width={w},"
        "height={h},framerate=30/1 ! videoconvertscale ! video/x-raw,"
        "format=RGB,width=224,height=224 ! appsink name=out", 64, 3, False),
}


def generic_converter(name, device=None):
    from gstreamer_tpu_torch import VideoConverter, VideoInfo
    from gstreamer_tpu_torch.video.info import Colorimetry
    g = GENERIC[name]

    def info(fmt, size, kw):
        kw = dict(kw)
        if "colorimetry" in kw:
            kw["colorimetry"] = Colorimetry(*kw["colorimetry"])
        return VideoInfo(format=fmt, width=size[0], height=size[1], **kw)
    return VideoConverter(info(*g["src"]), info(*g["dst"]), g["cfg"],
                          device=device)


def generic_inputs(name, host, batch):
    """Host planes of `batch` input frames of a GENERIC configuration, cut
    from the seeded 1080p I420 batch `host`: NV12's component planes are
    I420's; a smaller I420 frame is the top-left corner; RGB takes three
    runs of luma frames; P010 builds 10-bit samples from two frames' bytes,
    left-justified in their 16-bit words."""
    import numpy as np
    fmt, (w, h), _ = GENERIC[name]["src"]
    y, u, v = host
    if fmt in ("I420", "NV12"):
        cw, ch = (w + 1) // 2, (h + 1) // 2
        out = (y[:batch, :h, :w], u[:batch, :ch, :cw], v[:batch, :ch, :cw])
    elif fmt == "RGB":
        out = tuple(y[i * batch:(i + 1) * batch] for i in range(3))
    elif fmt == "P010_10LE":
        out = tuple(((p[:batch].astype(np.uint16) << 2
                      | (p[batch:2 * batch] & 3)) << 6) for p in host)
    else:
        raise ValueError(fmt)
    require(all(len(p) == batch for p in out),
            f"{name}: the seeded batch is too small for {batch} frames")
    return tuple(np.ascontiguousarray(p) for p in out)


def generic_routes(host, counters):
    """Drive every GENERIC configuration on the card through
    VideoConverter.convert, with the launch counts zeroed just before and
    read just after; require the route the plan must take, the launches it
    must make, and the card's bytes equal to the numpy gold and to the
    port's CPU path on the first frames; then time it.  A batch that does
    not fit the card's memory is halved, and the printed line says so.
    Returns {name: launch counts}."""
    import numpy as np
    import torch
    res, outs = {}, {}
    for name, g in GENERIC.items():
        conv = generic_converter(name)
        for key, val in g["want"].items():
            require(conv.plan[key] == val if val is not None
                    else conv.plan[key] is None,
                    f"{name}: plan[{key!r}] is {conv.plan[key]!r}")
        batch, note = g["batch"], ""
        while True:
            ins = generic_inputs(name, host, batch)
            dev = tuple(torch.as_tensor(p).to(conv.device) for p in ins)
            try:
                with opt_in(g.get("fused", False)):
                    for c in counters.values():
                        c.launches = 0
                    out = conv.convert(dev)
                    torch.cuda.synchronize()
                    counts = {k: c.launches for k, c in counters.items()
                              if c.launches}
                    ms = cuda_ms(lambda: conv.convert(dev),
                                 *g.get("timing", (3, 1)))
                break
            except torch.cuda.OutOfMemoryError:
                require(batch > CPU_FRAMES, f"{name}: out of device memory "
                        f"at batch {batch}")
                del dev
                torch.cuda.empty_cache()
                batch //= 2
                note = f" (batch halved from {g['batch']}: out of memory)"
        require(counts == g["launches"],
                f"{name}: launches {counts}, want {g['launches']}")
        first = tuple(p[:CPU_FRAMES] for p in ins)
        with opt_in(g.get("fused", False)):
            cpu = generic_converter(name, "cpu").convert(first)
        gold = conv.convert_ref(first)
        shapes = conv.out_info.plane_shapes()
        want = torch.uint16 if conv.out_info.finfo.bits == 16 else torch.uint8
        require(len(out) == len(shapes), f"{name}: {len(out)} planes")
        for o, c, gd, shape in zip(out, cpu, gold, shapes):
            require(o.device.type == "cuda" and o.dtype == want
                    and tuple(o.shape) == (batch,) + shape,
                    f"{name}: bad output {o.dtype} {tuple(o.shape)}")
            require(torch.equal(o[:CPU_FRAMES].cpu(), c),
                    f"{name}: CUDA output differs from the port's CPU path")
            require(np.array_equal(o[:CPU_FRAMES].cpu().numpy(), gd),
                    f"{name}: CUDA output differs from the numpy gold")
        if name == "same_size":
            require(int(out[3].min()) == 255, "same_size: alpha not opaque")
        if name == "rgb16_out":
            require(conv.plan["dither"].method == "bayer"
                    and all(int(o.max()) <= m
                            for o, m in zip(out, (31, 63, 31))),
                    "rgb16_out: not dithered and stored at 5/6/5 bits")
        if name == "rgb16_serial":
            require(conv.plan["dither"].method == "floyd-steinberg"
                    and any(not torch.equal(o, b[:batch]) for o, b
                            in zip(outs["rgb16_out"], out)),
                    "rgb16_serial: the bytes of the bayer dither")
        outs[name] = tuple(o[:CPU_FRAMES].clone() for o in out)
        res[name] = counts
        print(f"generic {name}: {g['src'][0]} {g['src'][1]} -> {g['dst'][0]} "
              f"{g['dst'][1]}, launches {counts}; CUDA == port CPU path == "
              f"numpy gold ({CPU_FRAMES} frames)")
        print(f"e2e {name}: {ms:.3f} ms per batch of {batch}{note}, "
              f"{batch / ms * 1e3:.1f} frames/s")
        del out, dev
        torch.cuda.empty_cache()
    for a, b in zip(outs["nv12_fused"], outs["nv12_ingest"]):
        require(torch.equal(a, b),
                "nv12_fused: output differs from nv12_ingest's bytes")
    return res


def switched_off(convs, planes, counters):
    """linear2 and cubic at the launch paths' batch under
    GTPU_PALLAS_YSCALE=0 and under GTPU_PALLAS_CHROMA=0: the bytes of the
    run with no switch set, and no launch of the kernel switched off.
    Returns the launch counts summed over the runs."""
    import torch
    ins = tuple(p[:DEINT_BATCH] for p in planes)
    total = {k: 0 for k in counters}
    for cfg in ("linear2", "cubic"):
        base = convs[cfg].convert(ins)
        for var, off in (("GTPU_PALLAS_YSCALE", "yscale_hv"),
                         ("GTPU_PALLAS_CHROMA", "chroma420_scale")):
            with switches(**{var: "0"}):
                for c in counters.values():
                    c.launches = 0
                out = convs[cfg].convert(ins)
                torch.cuda.synchronize()
            counts = {k: c.launches for k, c in counters.items()}
            require(counts[off] == 0,
                    f"{cfg} under {var}=0: {off} launched {counts[off]} times")
            for o, r in zip(out, base):
                require(torch.equal(o, r),
                        f"{cfg} under {var}=0: bytes differ from the run "
                        f"with no switch set")
            for k, n in counts.items():
                total[k] += n
            print(f"switch {var}=0, {cfg}, batch {DEINT_BATCH}: launches "
                  f"{ {k: n for k, n in counts.items() if n} }; the same "
                  f"bytes as with no switch set")
    return total


# -- the audio front-end (BASELINE config 2) ------------------------------------

ASR_CHUNKS, ASR_FRAMES = 128, 1 << 17     # bench_all.py:47-69: 128 x 2.7 s
AUDIO_CHECK = 2                           # chunks / ticks held to the gold
F32_ULPS = 1.0      # card vs the port's CPU path and the float64 gold
ASR_SRC = ("appsrc name=in caps=audio/x-raw,format=S16LE,rate=48000,"
           "channels=2,layout=interleaved ! ")
ASR_CHAIN = ("audioconvert ! audio/x-raw,channels=1 ! audioresample ! "
             "audio/x-raw,rate=16000 ! audioconvert ! "
             "audio/x-raw,format=F32LE ! appsink name=out")
# name: (launch string, input frames a tick, ticks); tests/test_audio.py:180
# launches the ASR front-end; asr_launch feeds it 10 s a tick through
# appsrc, asr_quickstart keeps its audiotestsrc (samples made on the host)
AUDIO_LAUNCH = {
    "asr_launch": (ASR_SRC + ASR_CHAIN, 480000, 4),
    "asr_quickstart": ("audiotestsrc num-buffers={n} samplesperbuffer=48000 "
                       "! audio/x-raw,format=S16LE,rate=48000,channels=2 ! "
                       + ASR_CHAIN, 48000, 4),
    "volume_s16": (ASR_SRC + "volume volume=0.5 ! appsink name=out",
                   480000, 4),
    "volume_f32": (ASR_SRC.replace("S16LE", "F32LE")
                   + "volume volume=0.5 ! appsink name=out", 480000, 4),
}


def device_time(step, iters: int):
    """Run `step` twice, then `iters` times under torch.profiler; returns
    (wall ms, device busy ms, device idle share, profiler) per step; busy
    is the union of the kernels' device intervals."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / iters * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, reach = 0.0, float("-inf")
    for start, end in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    busy = busy_us / iters / 1e3
    return wall, busy, max(0.0, 1.0 - busy / wall), prof


def asr_inputs(seed: int):
    """bench_all.py's input: 128 chunks of 2^17 frames of 48 kHz stereo
    S16, seeded."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return rng.integers(-32768, 32767, (ASR_CHUNKS, ASR_FRAMES, 2),
                        dtype=np.int16)


def ulps32(a, b):
    """|a - b| in ULPs of float32 at b (a float32, b float64)."""
    import numpy as np
    a = np.asarray(a, np.float64)
    return np.abs(a - b) / np.spacing(np.abs(b).astype(np.float32))


def audio_resample(host, dev):
    """asr_resample_f32 and asr_resample_s16: bench_all.py's config through
    the port's AudioResampler("kaiser", 48000, 16000) on the card.  f32: the
    chunks / 32768, resampled, the channel mean after; the first chunks are
    held per output sample to the port's CPU path and to the float64 gold
    (resample_ref from the same float32 inputs) within F32_ULPS, once with
    TF32 allowed process-wide (the route sums in float64, so TF32, whose
    10-bit mantissa is 2^13 ULPs of float32, cannot reach it).  s16: bit for
    bit against the CPU path on the first chunks and resample_ref on a
    prefix.  Returns {name: ms per call, ...}."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch import AudioResampler
    res = AudioResampler("kaiser", 48000, 16000, device=dev)
    cpu_res = AudioResampler("kaiser", 48000, 16000, device="cpu")
    x = torch.as_tensor(host).to(dev)
    n_out = res.out_frames_for(ASR_FRAMES)
    out = {}
    rf = res.resample_fn("f32", ASR_FRAMES, 2)
    xf = x.float() / 32768.0
    first = xf[:AUDIO_CHECK].cpu()
    want = cpu_res.resample_fn("f32", ASR_FRAMES, 2)(first).numpy()
    for tf32 in (False, True):
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            got = rf(xf[:AUDIO_CHECK])
            torch.cuda.synchronize()
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old
        require(got.dtype == torch.float32 and tuple(got.shape) == (
            AUDIO_CHECK, n_out, 2), f"asr_resample_f32: bad output "
            f"{got.dtype} {tuple(got.shape)}")
        d = ulps32(got.cpu().numpy(), want.astype(np.float64)).max()
        require(d <= F32_ULPS, f"asr_resample_f32 (TF32 allowed: {tf32}): "
                f"{d} ULPs from the port's CPU path")
    gold_ulps = 0.0
    for c in range(AUDIO_CHECK):
        gold = cpu_res.resample_ref(first[c].numpy().astype(np.float64),
                                    "f32")
        gold_ulps = max(gold_ulps, float(ulps32(got[c].cpu().numpy(),
                                                gold).max()))
    require(gold_ulps <= F32_ULPS, f"asr_resample_f32: {gold_ulps} ULPs "
            f"from the float64 gold")
    mean = rf(xf).mean(dim=-1)
    require(tuple(mean.shape) == (ASR_CHUNKS, n_out)
            and bool(torch.isfinite(mean).all()), "asr_resample_f32: output")
    out["asr_resample_f32"] = dict(
        ms=cuda_ms(lambda: rf(x.float() / 32768.0).mean(dim=-1), 10),
        check=f"CUDA vs port CPU path and vs float64 gold <= {F32_ULPS} ULP "
              f"(gold: {gold_ulps:.3f}), also with TF32 allowed",
        step=lambda: rf(x.float() / 32768.0).mean(dim=-1))
    rs = res.resample_fn("s16", ASR_FRAMES, 2)
    got = rs(x)
    torch.cuda.synchronize()
    require(got.dtype == torch.int16 and tuple(got.shape) == (
        ASR_CHUNKS, n_out, 2), "asr_resample_s16: bad output")
    cpu = cpu_res.resample_fn("s16", ASR_FRAMES, 2)(
        torch.as_tensor(host[:AUDIO_CHECK]))
    require(torch.equal(got[:AUDIO_CHECK].cpu(), cpu),
            "asr_resample_s16: CUDA output differs from the port's CPU path")
    prefix = 30000
    gold = cpu_res.resample_ref(host[0, :prefix].astype(np.int64), "s16")
    require(np.array_equal(got[0, :len(gold)].cpu().numpy(), gold),
            "asr_resample_s16: CUDA output differs from resample_ref")
    out["asr_resample_s16"] = dict(
        ms=cuda_ms(lambda: rs(x), 10),
        check=f"CUDA == port CPU path ({AUDIO_CHECK} chunks) == resample_ref "
              f"({len(gold)} outputs), bit for bit", step=lambda: rs(x))
    return out


def asr_gold(ticks, res):
    """A numpy gold of the ASR chain over S16 stereo ticks: unpack, the Q10
    mix to mono with rounding, the quantizer (dither none) and pack to S16,
    resample_ref carried across ticks as audioresample carries its history
    and phase, then S16 -> F32 by the replicated S32 canon."""
    import numpy as np
    from gstreamer_tpu_torch.audio.channel_mixer import build_matrix, matrix_int

    def canon(s):
        w = s.astype(np.int64) & 0xFFFF
        v = (w << 16) | (w ^ 0x8000)
        return np.where(v >= 1 << 31, v - (1 << 32), v)

    mint = matrix_int(build_matrix(("front-left", "front-right"),
                                   ("mono",))).astype(np.int64)
    hist, ph, outs = None, 0, []
    up, down = res.out_red, res.in_red
    for x in ticks:
        m = np.clip((canon(x) @ mint + 512) >> 10, -(1 << 31), (1 << 31) - 1)
        q = np.clip(m + (1 << 15), -(1 << 31), (1 << 31) - 1) & ~0xFFFF
        s16 = (q >> 16).astype(np.int16)
        x = s16 if hist is None else np.concatenate([hist, s16])
        n_out = ((len(x) - res.n_taps) * up - (up - 1)) // down + 1
        r = res.resample_ref(x.astype(np.int64), "s16", samp_phase=ph,
                             n_out=n_out)
        total = ph + n_out * down
        hist, ph = x[total // up:], total % up
        outs.append((canon(r) / 2147483648.0).astype(np.float32))
    return outs


def audio_drive(desc, frames, ticks, pushes, device):
    """Push `pushes` (one array a tick) into appsrc where the string has one,
    tick to EOS on `device`, each tick timed on the host clock between two
    synchronises.  Returns (output arrays per tick, seconds per tick)."""
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.pipeline import State
    cuda = torch.device(device).type == "cuda"
    pipe = parse_launch(desc.format(n=ticks), device=device)
    src, sink = pipe.get_by_name("in"), pipe.get_by_name("out")
    if src is not None:
        for t, x in enumerate(pushes[:ticks]):
            src.push_buffer(Buffer(data=x, pts=t * frames * 10**9 // 48000,
                                   duration=frames * 10**9 // 48000))
        src.end_of_stream()
    pipe.set_state(State.PLAYING)
    outs, secs = [], []
    while True:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        more = pipe.tick()
        if cuda:
            torch.cuda.synchronize()
        if not more:
            break
        secs.append(time.perf_counter() - t0)
        got = []
        while (s := sink.pull_sample()) is not None:
            got.append(s.buffer.data)
        outs.append(torch.cat(got) if got else None)
    pipe.set_state(State.NULL)
    return outs, secs


def audio_launch(seed, dev):
    """Drive every AUDIO_LAUNCH path on the card; hold its outputs to a
    numpy gold (asr_launch: asr_gold; volume: the Q27 product and the
    float32 product) and to the same string on the port's CPU path on the
    first AUDIO_CHECK ticks.  Returns {name: rates, ...}."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch import AudioResampler
    rng = np.random.default_rng(seed + 1)
    res = {}
    for name, (desc, frames, ticks) in AUDIO_LAUNCH.items():
        host = [rng.integers(-32768, 32767, (frames, 2), dtype=np.int16)
                for _ in range(ticks)]
        if name == "volume_f32":
            host = [(h / 32768.0).astype(np.float32) for h in host]
        pushes = [torch.as_tensor(h).to(dev) for h in host]
        outs, secs = audio_drive(desc, frames, ticks, pushes, dev)
        require(len(outs) == ticks and all(o is not None for o in outs),
                f"{name}: {len(outs)} ticks of output, want {ticks}")
        cpu, _ = audio_drive(desc, frames, AUDIO_CHECK,
                                host[:AUDIO_CHECK], "cpu")
        for o, c in zip(outs, cpu):
            require(o.device.type == dev.type and torch.equal(o.cpu(), c),
                    f"{name}: CUDA output differs from the port's CPU path")
        if name == "asr_launch":
            gold = asr_gold(host[:AUDIO_CHECK], AudioResampler(
                "kaiser", 48000, 16000, device="cpu"))
        elif name == "volume_s16":
            gold = [np.clip((h.astype(np.int64) * (1 << 26)) >> 27,
                            -32768, 32767).astype(np.int16)
                    for h in host[:AUDIO_CHECK]]
        elif name == "volume_f32":
            gold = [h * np.float32(0.5) for h in host[:AUDIO_CHECK]]
        else:
            gold = None
        if gold is not None:
            for o, g in zip(outs, gold):
                o = o.cpu().numpy()
                require(o.dtype == g.dtype and o.shape == g.shape
                        and np.array_equal(o.view(np.uint8),
                                           g.view(np.uint8)),
                        f"{name}: output differs from the numpy gold")
        timed = sum(secs[1:])
        res[name] = dict(
            frames=frames, ticks=ticks, secs=secs,
            msps=frames * (ticks - 1) / timed / 1e6,
            out_frames=[len(o) for o in outs],
            check=f"CUDA == port CPU path ({AUDIO_CHECK} ticks)"
                  + (" == numpy gold" if gold is not None else ""))
    return res


def audio_phase(seed, counters, dev):
    """The audio front-end on the card with the launch counts zeroed just
    before each configuration and read just after (no kernel of the
    port's runs on this path: every count must stay 0); a rate line and
    the device idle share for each."""
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.pipeline import State
    host = asr_inputs(seed)
    for c in counters.values():
        c.launches = 0
    rs = audio_resample(host, dev)
    counts = {k: c.launches for k, c in counters.items() if c.launches}
    require(not counts, f"audio resample: kernels launched {counts}")
    for name, r in rs.items():
        _, busy, idle, _ = device_time(r["step"], 3)
        print(f"audio {name}: {r['check']}; launches {counts}")
        print(f"e2e {name}: {r['ms']:.3f} ms per call of {ASR_CHUNKS} x "
              f"{ASR_FRAMES} frames, {ASR_CHUNKS * ASR_FRAMES / r['ms'] / 1e3:.1f}"
              f" Msamples/s (input frames, as bench_all.py counts); device "
              f"busy {busy:.3f} ms a call, idle share {idle:.3f}")
    for c in counters.values():
        c.launches = 0
    paths = audio_launch(seed, dev)
    counts = {k: c.launches for k, c in counters.items() if c.launches}
    require(not counts, f"audio launch paths: kernels launched {counts}")
    for name, r in paths.items():
        desc, frames, _ = AUDIO_LAUNCH[name]
        print(f"audio {name}: {r['check']}; output frames per tick "
              f"{r['out_frames']}; launches {counts}")
        prof_pipe = parse_launch(desc.format(n=10 ** 6), device=dev)
        src = prof_pipe.get_by_name("in")
        sink = prof_pipe.get_by_name("out")
        x = torch.zeros((frames, 2), device=dev,
                        dtype=torch.float32 if "f32" in name else torch.int16)
        prof_pipe.set_state(State.PLAYING)

        def tick():
            if src is not None:
                src.push_buffer(Buffer(data=x))
            prof_pipe.tick()
            while sink.pull_sample() is not None:
                pass
        _, busy, idle, _ = device_time(tick, 3)
        prof_pipe.set_state(State.NULL)
        print(f"e2e {name}: {r['msps']:.3f} Msamples/s of 48 kHz stereo "
              f"input frames over ticks 2..{r['ticks']} ({r['frames']} a "
              f"tick; {[round(s * 1e3, 3) for s in r['secs']]} ms per tick, "
              f"host clock between synchronises); device busy {busy:.3f} ms "
              f"a tick, idle share {idle:.3f}")


# -- BASELINE config 3 and the audio mixer: N-to-1 aggregators -----------------

def comp_src(k, w, h):
    return (f"appsrc name=in{k} caps=video/x-raw,format=I420,width={w},"
            f"height={h},framerate=30/1 ! c.sink_{k}")


def mosaic_desc(w, h):
    """bench_all.py:90-132's compositor string (BASELINE config 3), appsink
    in place of fakesink: four I420 w x h pads placed 2x2 into a mosaic of
    twice their size."""
    return (f"compositor name=c sink_1::xpos={w} sink_2::ypos={h} "
            f"sink_3::xpos={w} sink_3::ypos={h} ! video/x-raw,width={2 * w},"
            f"height={2 * h} ! appsink name=out "
            + " ".join(comp_src(k, w, h) for k in range(4)))


def wall_pads(w, h):
    """The monitoring wall's pads: (xpos, ypos, alpha, zorder), each an
    I420 w x h stream scaled to w/2 x h/2; the fourth is a
    picture-in-picture over the middle of the other three."""
    return [(0, 0, 1.0, 0), (w // 2, 0, 0.5, 0), (0, h // 2, 1.0, 0),
            (w // 4, h // 4, 0.6, 1)]


def wall_desc(w, h):
    props = " ".join(
        f"sink_{k}::xpos={x} sink_{k}::ypos={y} sink_{k}::width={w // 2} "
        f"sink_{k}::height={h // 2} sink_{k}::alpha={a} sink_{k}::zorder={z}"
        for k, (x, y, a, z) in enumerate(wall_pads(w, h)))
    return (f"compositor name=c background=checker {props} ! video/x-raw,"
            f"format=BGRA,width={w},height={h} ! appsink name=out "
            + " ".join(comp_src(k, w, h) for k in range(4)))


def mixer_desc(fmt):
    return ("audiomixer name=c ! appsink name=out "
            + " ".join(f"appsrc name=in{k} caps=audio/x-raw,format={fmt},"
                       f"rate=48000,channels=2,layout=interleaved ! c.sink_{k}"
                       for k in range(2)))


AGG_FRAMES = 480000           # audio frames a tick: 10 s of 48 kHz stereo
# name: (launch string of (w, h), batch or audio frames a tick, ticks,
# kernel launches per tick: tests/test_torch_compositor.py's CPU spy sees
# one yscale and two chroma420 calls per scaled pad and tick)
AGGREGATORS = {
    "compositor_4k": (mosaic_desc, 32, 4, {}),
    "compositor_wall": (wall_desc, 16, 4,
                        {"yscale_hv": 4, "chroma420_scale": 8}),
    "audiomixer_s16": (lambda w, h: mixer_desc("S16LE"), AGG_FRAMES, 4, {}),
    "audiomixer_f32": (lambda w, h: mixer_desc("F32LE"), AGG_FRAMES, 4, {}),
}


def drive_multi(desc, batch, ticks, ins, device):
    """Push `ticks` buffers into every appsrc of `ins` ({name: data}, the
    same data each tick: a tuple of planes of `batch` frames, or one
    (frames, 2) audio tensor at 48 kHz) and tick the pipeline to EOS, each
    tick timed on the host clock between two synchronises.  Returns
    (pipeline, samples per tick, seconds per tick)."""
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.pipeline import State
    cuda = torch.device(device).type == "cuda"
    pipe = parse_launch(desc, batch=batch, device=device)
    for name, data in ins.items():
        src = pipe.get_by_name(name)
        for t in range(ticks):
            if isinstance(data, tuple):
                src.push_buffer(Buffer(data=data, pts=t * batch * DUR,
                                       duration=DUR, batch=batch))
            else:
                n = data.shape[0]
                src.push_buffer(Buffer(data=data, pts=t * n * 10**9 // 48000,
                                       duration=n * 10**9 // 48000))
        src.end_of_stream()
    sink = pipe.get_by_name("out")
    pipe.set_state(State.PLAYING)
    outs, secs = [], []
    while True:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        more = pipe.tick()
        if cuda:
            torch.cuda.synchronize()
        if not more:
            break
        secs.append(time.perf_counter() - t0)
        got = []
        while (s := sink.pull_sample()) is not None:
            got.append(s)
        outs.append(got)
    pipe.set_state(State.NULL)
    return pipe, outs, secs


def over_gold(dst, src, alpha_u8):
    """compositor_orc_overlay_argb in numpy int64 on canonical (..., 4)
    (A, c0, c1, c2) arrays: an independent gold of the OVER blend."""
    import numpy as np
    a_s = (((src[..., 0] * alpha_u8) & 0xFFFF) * 0x8081) >> 23
    a_d = (((dst[..., 0] * (255 - a_s)) & 0xFFFF) * 0x8081) >> 23
    a_out = (a_s + a_d) & 0xFF
    acc = (src * a_s[..., None] + dst * a_d[..., None]) & 0xFFFF
    out = np.where(a_out[..., None] == 0, 255, np.clip(
        acc // np.maximum(a_out, 1)[..., None], 0, 255))
    out[..., 0] = a_out
    return out


def wall_gold(pipe, host_ins, w, h):
    """The wall's first frames in numpy: each pad through its converter's
    numpy gold (convert_ref), OVER the checker in zorder, then pack."""
    import numpy as np
    from gstreamer_tpu_torch.video.format import format_info, pack, unpack
    f = format_info("BGRA")
    yy, xx = np.mgrid[0:h, 0:w]
    val = np.array([80, 160, 80, 160])[((yy & 8) >> 3) + ((xx & 8) >> 3)]
    n = len(next(iter(host_ins.values()))[0])
    out = np.broadcast_to(np.stack([np.full_like(val, 255), val, val, val],
                                   -1), (n, h, w, 4)).astype(np.int64)
    comp = pipe.get_by_name("c")
    pads = sorted(enumerate(wall_pads(w, h)), key=lambda kp: kp[1][3])
    for k, (x0, y0, alpha, _z) in pads:
        conv = comp._converters[f"sink_{k}"]
        pw, ph = w // 2, h // 2
        src = unpack(np, f, conv.convert_ref(host_ins[f"in{k}"]), pw, ph)
        x1, y1 = min(x0 + pw, w), min(y0 + ph, h)
        out[:, y0:y1, x0:x1] = over_gold(
            out[:, y0:y1, x0:x1], src[:, :y1 - y0, :x1 - x0].astype(np.int64),
            max(0, min(255, int(alpha * 255))))
    return pack(np, f, out, w, h)


def aggregator_inputs(name, host, rng, w, h, batch):
    """{appsrc name: host data}: video pads take frames k*batch.. of the
    seeded 1080p batch (cut to w x h); the mixers' first input is near full
    scale so that S16 saturates, the second spans the range."""
    import numpy as np
    if name.startswith("audiomixer"):
        lo = rng.integers(20000, 32767, (batch, 2), dtype=np.int16)
        full = rng.integers(-32768, 32767, (batch, 2), dtype=np.int16)
        if name.endswith("f32"):
            return {"in0": (lo / 32768.0).astype(np.float32),
                    "in1": (full / 40000.0).astype(np.float32)}
        return {"in0": lo, "in1": full}
    cw, ch = (w + 1) // 2, (h + 1) // 2
    out = {}
    for k in range(4):
        sl = slice(k * batch, (k + 1) * batch)
        if len(host[0][sl]) < batch:          # a small batch: reuse frames
            sl = slice(0, batch)
        out[f"in{k}"] = tuple(np.ascontiguousarray(p[sl, :hh, :ww]) for p, hh, ww
                              in zip(host, (h, ch, ch), (w, cw, cw)))
    return out


def mixer_gold(ins):
    """int64 sum clipped to S16, or the float64 sum in pad order cast."""
    import numpy as np
    a, b = ins["in0"], ins["in1"]
    if a.dtype == np.float32:
        return (a.astype(np.float64) + b).astype(np.float32)
    return np.clip(a.astype(np.int64) + b, -32768, 32767).astype(np.int16)


def aggregator_phase(seed, counters, dev, host, w=W, h=H):
    """BASELINE config 3 (compositor_4k: bench_all.py's 4 x 1080p I420 -> 4K
    mosaic), a monitoring wall whose scaled pads run the yscale and
    chroma420 kernels, and the audio mixer at S16 and F32, each through the
    port's parse_launch on the card with the launch counts zeroed just
    before it and read just after.  Outputs equal the port's CPU path on
    the first frames (ticks) and a numpy gold; launches per tick equal the
    table's; the wall's converter holds yscale_hv and chroma420_scale to
    their plain versions at its shapes.  Returns ({kernel: launches} summed
    over the four, {kernel: largest difference from its plain version})."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.pipeline import State
    from gstreamer_tpu_torch.ops import chroma420_kernel as ck
    from gstreamer_tpu_torch.ops import yscale_kernel as ysk
    rng = np.random.default_rng(seed + 2)
    total = {k: 0 for k in counters}
    err = {}
    for name, (make, batch, ticks, per_tick) in AGGREGATORS.items():
        desc = make(w, h)
        audio = name.startswith("audiomixer")
        host_ins = aggregator_inputs(name, host, rng, w, h, batch)
        ins = {k: (torch.as_tensor(v).to(dev) if audio else
                   tuple(torch.as_tensor(p).to(dev) for p in v))
               for k, v in host_ins.items()}
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        pipe, outs, secs = drive_multi(desc, batch, ticks, ins, dev)
        counts = {k: c.launches for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        want = {k: per_tick.get(k, 0) * ticks for k in counters}
        require(counts == want, f"{name}: launches {counts}, want {want}")
        for k, n in counts.items():
            total[k] += n
        require(len(outs) == ticks and all(len(o) == 1 for o in outs),
                f"{name}: {[len(o) for o in outs]} samples per tick")
        if audio:
            _, cpu, _ = drive_multi(desc, batch, AUDIO_CHECK, host_ins, "cpu")
            gold = mixer_gold(host_ins)
            for t, o in enumerate(outs):
                o = o[0].buffer.data
                require(o.device.type == dev.type and o.dtype == torch.as_tensor(
                    gold).dtype and tuple(o.shape) == gold.shape,
                    f"{name}: bad output {o.dtype} {tuple(o.shape)}")
                require(np.array_equal(o.cpu().numpy(), gold),
                        f"{name}: tick {t} differs from the numpy gold")
                if t < AUDIO_CHECK:
                    require(torch.equal(o.cpu(), cpu[t][0].buffer.data),
                            f"{name}: CUDA output differs from the port's "
                            f"CPU path")
            if name.endswith("s16"):
                require(int(outs[0][0].buffer.data.max()) == 32767,
                        f"{name}: the near-full-scale input did not saturate")
            check = (f"CUDA == port CPU path ({AUDIO_CHECK} ticks) == numpy "
                     f"gold ({ticks} ticks)")
        else:
            first = outs[0][0]
            n = CPU_FRAMES
            cpu_ins = {k: tuple(p[:n] for p in v)
                       for k, v in host_ins.items()}
            _, cpu, _ = drive_multi(desc, n, 1, cpu_ins, "cpu")
            ref = cpu[0][0]
            require(first.buffer.pts == ref.buffer.pts
                    and str(first.caps) == str(ref.caps),
                    f"{name}: first sample's pts/caps differ from the CPU run")
            for o, r in zip(first.buffer.data, ref.buffer.data):
                require(o.device.type == dev.type and o.dtype == torch.uint8,
                        f"{name}: output {o.dtype} on {o.device}")
                require(torch.equal(o[:n].cpu(), r),
                        f"{name}: CUDA output differs from the port's CPU path")
            if name == "compositor_4k":
                # every quadrant of every plane is its input plane, on the
                # whole first tick: no background shows
                for ci, o in enumerate(first.buffer.data):
                    ph, pw = o.shape[-2] // 2, o.shape[-1] // 2
                    for k, (qy, qx) in enumerate([(0, 0), (0, 1), (1, 0),
                                                  (1, 1)]):
                        require(torch.equal(
                            o[:, qy * ph:(qy + 1) * ph, qx * pw:(qx + 1) * pw],
                            ins[f"in{k}"][ci]),
                            f"{name}: plane {ci} quadrant {k} is not its input")
                gold_what = "every quadrant == its input (whole tick)"
            else:
                # the kernels at the wall's shapes: a pad's batch of 1080p
                # scaled to 960x540 under the converter's cubic plan
                plan = pipe.get_by_name("c")._converters["sink_0"].plan
                y, u, v = ins["in0"]
                hr, vr = plan["h_res"], plan["v_res"]
                err["yscale_hv"] = max_err([ysk.yscale_hv(y, hr, vr)],
                                           [ysk.yscale_hv_plain(y, hr, vr)],
                                           "yscale_hv")
                cargs = (hr, vr, plan["up_h_cosited"], plan["up_v_cosited"])
                err["chroma420_scale"] = max_err(
                    [ck.chroma420_scale(c, *cargs, w, h) for c in (u, v)],
                    [ck.chroma420_scale_plain(c, *cargs) for c in (u, v)],
                    "chroma420_scale")
                for kname, e in err.items():
                    require(e == 0, f"{name}: {kname} differs from its plain "
                            f"version by up to {e} at the wall's shapes")
                gold = wall_gold(pipe, cpu_ins, w, h)
                for o, g in zip(first.buffer.data, gold):
                    require(np.array_equal(o[:n].cpu().numpy(), g),
                            f"{name}: CUDA output differs from the numpy gold")
                gold_what = (f"numpy gold ({n} frames); yscale_hv and "
                             f"chroma420_scale == plain at {tuple(y.shape)} "
                             f"-> {(vr.out_size, hr.out_size)}")
            check = f"CUDA == port CPU path ({n} frames), {gold_what}"
        print(f"aggregate {name}: batch {batch}, {ticks} ticks, "
              f"{'fused' if pipe._fused else 'per-element'}; launches "
              f"{ {k: v for k, v in counts.items() if v} }; {check}; peak "
              f"device memory {peak / 2**30:.2f} GiB")
        del outs

        prof = parse_launch(desc, batch=batch, device=dev)
        sink = prof.get_by_name("out")
        prof.set_state(State.PLAYING)

        def tick():
            for k, v in ins.items():
                prof.get_by_name(k).push_buffer(
                    Buffer(data=v, batch=1 if audio else batch))
            prof.tick()
            while sink.pull_sample() is not None:
                pass
        _, busy, idle, _ = device_time(tick, 3)
        prof.set_state(State.NULL)
        timed = sum(secs[1:])
        tick_ms = [round(s * 1e3, 3) for s in secs]
        if audio:
            rate = (f"{batch * (ticks - 1) / timed / 1e6:.3f} Msamples/s of "
                    f"48 kHz stereo input frames")
        else:
            rate = f"{batch * (ticks - 1) / timed:.1f} output frames/s"
        extra = ""
        if name == "compositor_4k":
            # compulsory traffic: each input plane read once, each output
            # plane written once
            nbytes = sum(p.numel() for p in next(iter(ins.values()))) * 4 * 2
            bms, by, unit = bound(nbytes, 0.0)
            extra = (f"; bound {bms:.4f} ms a tick ({by}, {unit}, "
                     f"{nbytes / batch / 1e6:.1f} MB an output frame), "
                     f"{batch / bms * 1e3:.0f} frames/s")
        print(f"e2e {name}: {rate} over ticks 2..{ticks} ({tick_ms} ms per "
              f"tick, host clock between synchronises); device busy "
              f"{busy:.3f} ms a tick, idle share {idle:.3f}{extra}")
        del ins, prof
        torch.cuda.empty_cache()
    return total, err


# -- stateful and controlled elements: BASELINE config 4 in full, effectv ---

# the deinterlace methods with no kernel (plain torch); the fields each
# holds back at the stream's start (gstdeinterlacemethod.h latency)
DEINT_NEW = ("tomsmocomp", "greedyh", "greedyl", "vfir", "linearblend",
             "weave", "weave-tff", "weave-bff", "yadif")
DEINT_HELD = {"greedyh": 1, "greedyl": 1, "yadif": 2}
DEINT_TICKS = 3
DEINT_CHECK = (2, 1, 2)     # input frames a tick of the CPU check
BALANCE = "videobalance contrast=1.1 brightness=0.05 ! appsink name=out"
# a fade: contrast and brightness keyframed, a new value every tick
FADE = {"vb": {"contrast": [(0, 1.3), (DEINT_TICKS * DEINT_BATCH * DUR,
                                       0.7)],
               "brightness": [(0, -0.1), (DEINT_TICKS * DEINT_BATCH * DUR,
                                          0.2)]}}
EW, EH = 640, 480           # bench_all.py:177-209's 480p camera feed
ESRC = (f"appsrc name=in caps=video/x-raw,format=RGB,width={EW},"
        f"height={EH},framerate=30/1 ! ")
EFFECT_CHAIN = ("edgetv ! vertigotv", 128, 3)      # string, batch, ticks
EFFECTS = ("edgetv", "streaktv", "shagadelictv", "vertigotv", "quarktv",
           "revtv", "dicetv", "warptv", "rippletv", "agingtv", "optv",
           "radioactv")
EFFECT_CHECK = (4, 4)       # frames a tick, card and CPU
VOLUME_RAMP = {"v": {"volume": [(0, 0.2), (4 * 10**10, 1.4)]}}


def controlled(desc, device, batch, controls=None):
    """parse_launch(desc) with `controls` ({element: {prop: [(ts, value),
    ...]}}) bound as linear InterpolationControlSources."""
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.controller import \
        InterpolationControlSource
    pipe = parse_launch(desc, batch=batch, device=device)
    for name, props in (controls or {}).items():
        for prop, points in props.items():
            cs = InterpolationControlSource("linear")
            for ts, v in points:
                cs.set(ts, v)
            pipe.get_by_name(name).set_control_source(prop, cs)
    return pipe


def push_tick(src, data, pts):
    """Push one tick's data (a tuple of planes, or one (frames, 2) audio
    tensor at 48 kHz) at `pts`; returns the next tick's pts."""
    from gstreamer_tpu_torch.core.buffer import Buffer
    if isinstance(data, tuple):
        n = data[0].shape[0]
        src.push_buffer(Buffer(data=data, pts=pts, duration=DUR, batch=n))
        return pts + n * DUR
    n = data.shape[0] * 10**9 // 48000
    src.push_buffer(Buffer(data=data, pts=pts, duration=n))
    return pts + n


def drive_seq(desc, pushes, device, batch, controls=None):
    """Push `pushes` into appsrc ``in``, one a tick (push_tick), under
    `controls` (controlled), and tick the pipeline to EOS, each tick timed
    on the host clock between two synchronises.  Returns (pipeline,
    samples per tick, seconds per tick)."""
    import torch
    from gstreamer_tpu_torch.core.pipeline import State
    cuda = torch.device(device).type == "cuda"
    pipe = controlled(desc, device, batch, controls)
    src = pipe.get_by_name("in")
    pts = 0
    for data in pushes:
        pts = push_tick(src, data, pts)
    src.end_of_stream()
    sink = pipe.get_by_name("out")
    pipe.set_state(State.PLAYING)
    outs, secs = [], []
    while True:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        more = pipe.tick()
        if cuda:
            torch.cuda.synchronize()
        if not more:
            break
        secs.append(time.perf_counter() - t0)
        got = []
        while (s := sink.pull_sample()) is not None:
            got.append(s)
        outs.append(got)
    pipe.set_state(State.NULL)
    return pipe, outs, secs


def same_samples(a, b, what, dev):
    """Samples per tick of a run on `dev` equal a CPU run's: data bytes,
    pts, batch, caps."""
    import torch
    require(len(a) == len(b) and all(len(x) == len(y) for x, y in
                                     zip(a, b)),
            f"{what}: {[len(x) for x in a]} samples per tick on the card, "
            f"{[len(y) for y in b]} on the CPU")
    for x, y in zip(a, b):
        for s, r in zip(x, y):
            require((s.buffer.pts, s.buffer.batch, str(s.caps))
                    == (r.buffer.pts, r.buffer.batch, str(r.caps)),
                    f"{what}: sample metadata differs from the CPU run")
            sd, rd = s.buffer.data, r.buffer.data
            sd = sd if isinstance(sd, (tuple, list)) else (sd,)
            rd = rd if isinstance(rd, (tuple, list)) else (rd,)
            for o, c in zip(sd, rd):
                require(o.device.type == dev.type and torch.equal(o.cpu(), c),
                        f"{what}: CUDA output differs from the port's CPU "
                        f"path")


def profile_ticks(desc, push, dev, batch, controls=None):
    """Device busy ms and idle share a tick (device_time: 3 ticks traced
    after 2), the pipeline fed `push` every tick."""
    from gstreamer_tpu_torch.core.pipeline import State
    pipe = controlled(desc, dev, batch, controls)
    src, sink = pipe.get_by_name("in"), pipe.get_by_name("out")
    pipe.set_state(State.PLAYING)
    pts = [0]

    def tick():
        pts[0] = push_tick(src, push, pts[0])
        pipe.tick()
        while sink.pull_sample() is not None:
            pass
    _, busy, idle, _ = device_time(tick, 3)
    pipe.set_state(State.NULL)
    return busy, idle


def fade_gold(host, ticks):
    """deint_chain_controlled's gold: the plain linear deinterlace of the
    first CPU_FRAMES frames, then videobalance's float32 tables (one
    rounding a step, cos / sin correctly rounded) at each tick's values."""
    import math
    import numpy as np
    import torch
    from gstreamer_tpu_torch.core.controller import \
        InterpolationControlSource
    from gstreamer_tpu_torch.ops import deint_kernel as dk
    fields = [dk.deint_both_parities_plain(torch.as_tensor(p[:CPU_FRAMES]),
                                           "linear", 0).flatten(0, 1).numpy()
              for p in host]
    f32 = np.float32
    golds = []
    for t in range(ticks):
        vals = {}
        for prop, points in FADE["vb"].items():
            cs = InterpolationControlSource("linear")
            for ts, v in points:
                cs.set(ts, v)
            vals[prop] = f32(cs.value_at(t * DEINT_BATCH * DUR))
        c, b = vals["contrast"], vals["brightness"]
        i = np.arange(256, dtype=np.float32)
        ty = np.clip(np.rint(f32(16) + (i - f32(16)) * c + b * f32(255)),
                     0, 255).astype(np.int64)
        arg = f32(np.pi) * f32(0.0)
        hc, hs = f32(math.cos(float(arg))), f32(math.sin(float(arg)))
        ii, jj = (i - f32(128))[:, None], (i - f32(128))[None, :]
        tu = np.clip(np.rint(f32(128) + (ii * hc + jj * hs) * f32(1.0)),
                     0, 255).astype(np.int64)
        tv = np.clip(np.rint(f32(128) + (-ii * hs + jj * hc) * f32(1.0)),
                     0, 255).astype(np.int64)
        y, u, v = (f.astype(np.int64) for f in fields)
        golds.append((ty[y], tu[u, v], tv[u, v], (float(c), float(b))))
    return golds


def stateful_phase(seed, counters, dev, host):
    """The stateful and controlled paths on the card, each with the
    launch counts zeroed just before it and read just after: every
    deinterlace method of BASELINE config 4 (deint_<method>), the linear
    chain under a keyframed fade (deint_chain_controlled, 3 deint launches
    a tick), bench_all.py's edgetv ! vertigotv scan chain and each effectv
    effect alone, and a volume ramp.  Outputs equal the port's CPU path
    across tick boundaries (and the fade a host gold).  Returns
    {kernel: launches}."""
    import numpy as np
    import torch
    total = {k: 0 for k in counters}
    b = DEINT_BATCH
    ins = tuple(torch.as_tensor(p[:b]).to(dev) for p in host)
    src = SRC.format(w=W, h=H)
    chk = []
    off = 0
    for n in DEINT_CHECK:
        chk.append(tuple(p[off:off + n] for p in host))
        off += n

    def counted(fn):
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        res = fn()
        counts = {k: c.launches for k, c in counters.items()}
        for k, v in counts.items():
            total[k] += v
        return res, counts, torch.cuda.max_memory_allocated()

    # -- every other deinterlace method, BASELINE config 4's chain -------
    for m in DEINT_NEW:
        name = f"deint_{m}"
        desc = src + f"deinterlace method={m} ! " + BALANCE
        (pipe, outs, secs), counts, peak = counted(
            lambda: drive_seq(desc, [ins] * DEINT_TICKS, dev, b))
        require(not any(counts.values()),
                f"{name}: kernels launched {counts} (no kernel on its path)")
        frames = [sum(s.buffer.batch for s in o) for o in outs]
        want = [2 * b - DEINT_HELD.get(m, 0)] + [2 * b] * (DEINT_TICKS - 1)
        require(frames == want, f"{name}: output frames per tick {frames}, "
                f"want {want}")
        del outs
        _, on_card, _ = drive_seq(desc, [tuple(torch.as_tensor(x).to(dev)
                                               for x in c) for c in chk],
                                  dev, max(DEINT_CHECK))
        _, on_cpu, _ = drive_seq(desc, [tuple(torch.as_tensor(x) for x in c)
                                        for c in chk], "cpu",
                                 max(DEINT_CHECK))
        same_samples(on_card, on_cpu, name, dev)
        busy, idle = profile_ticks(desc, ins, dev, b)
        fps = sum(frames[1:]) / sum(secs[1:])
        print(f"path {name}: batch {b}, {DEINT_TICKS} ticks, per-element; "
              f"launches none; output frames per tick {frames}; CUDA == "
              f"port CPU path over ticks of {DEINT_CHECK} frames; peak "
              f"device memory {peak / 2**30:.2f} GiB")
        print(f"e2e {name}: {fps:.1f} output frames/s over ticks 2.."
              f"{DEINT_TICKS} ({[round(s * 1e3, 3) for s in secs]} ms per "
              f"tick, host clock between synchronises); device busy "
              f"{busy:.3f} ms a tick, idle share {idle:.3f}; peak "
              f"{peak / 2**30:.2f} GiB")
        del on_card, on_cpu
        torch.cuda.empty_cache()

    # -- the linear chain under a keyframed fade ---------------------------
    name = "deint_chain_controlled"
    desc = src + "deinterlace method=linear ! videobalance name=vb ! " \
        "appsink name=out"
    (pipe, outs, secs), counts, peak = counted(
        lambda: drive_seq(desc, [ins] * DEINT_TICKS, dev, b, FADE))
    require(counts["deint_both_parities"] == 3 * DEINT_TICKS
            and sum(counts.values()) == 3 * DEINT_TICKS,
            f"{name}: launches {counts}, want 3 deint_both_parities a tick")
    golds = fade_gold(host, DEINT_TICKS)
    for t, (o, g) in enumerate(zip(outs, golds)):
        require(len(o) == 1 and o[0].buffer.batch == 2 * b,
                f"{name}: tick {t} gave {[s.buffer.batch for s in o]}")
        for p, gp in zip(o[0].buffer.data, g[:3]):
            require(np.array_equal(p[:2 * CPU_FRAMES].cpu().numpy()
                                   .astype(np.int64), gp),
                    f"{name}: tick {t} differs from the plain deinterlace "
                    f"and the float32 tables at {g[3]}")
    require(not torch.equal(outs[0][0].buffer.data[0],
                            outs[-1][0].buffer.data[0]),
            f"{name}: the fade did not change the output")
    busy, idle = profile_ticks(desc, ins, dev, b, FADE)
    fps = 2 * b * (DEINT_TICKS - 1) / sum(secs[1:])
    print(f"path {name}: batch {b}, {DEINT_TICKS} ticks, per-element; "
          f"launches { {k: v for k, v in counts.items() if v} }; each tick "
          f"== plain deinterlace + float32 tables at its values "
          f"{[g[3] for g in golds]} ({CPU_FRAMES} frames); peak device "
          f"memory {peak / 2**30:.2f} GiB")
    print(f"e2e {name}: {fps:.1f} output frames/s over ticks 2.."
          f"{DEINT_TICKS} ({[round(s * 1e3, 3) for s in secs]} ms per tick, "
          f"host clock between synchronises); device busy {busy:.3f} ms a "
          f"tick, idle share {idle:.3f}")
    del outs, ins
    torch.cuda.empty_cache()

    # -- effectv: bench_all.py's scan chain, then every effect alone -------
    rng = np.random.default_rng(seed + 3)
    chain, eb, eticks = EFFECT_CHAIN
    rgb = tuple(rng.integers(0, 256, (eb, EH, EW), dtype=np.uint8)
                for _ in range(3))
    rgb_dev = tuple(torch.as_tensor(p).to(dev) for p in rgb)
    name = "effectv_chain"
    desc = ESRC + chain + " ! appsink name=out"
    (pipe, outs, secs), counts, peak = counted(
        lambda: drive_seq(desc, [rgb_dev] * eticks, dev, eb))
    require(not any(counts.values()) and pipe._fused,
            f"{name}: want one fused step and no kernel, got {counts}")
    require([sum(s.buffer.batch for s in o) for o in outs] == [eb] * eticks,
            f"{name}: output frames per tick")
    del outs
    busy, idle = profile_ticks(desc, rgb_dev, dev, eb)
    fps = eb * (eticks - 1) / sum(secs[1:])
    checked = []
    for effect in (chain,) + EFFECTS:
        d = ESRC + effect + " ! appsink name=out"
        pushes = []
        off = 0
        for n in EFFECT_CHECK:
            pushes.append(tuple(p[off:off + n] for p in rgb))
            off += n
        (_, on_card, _), counts, _ = counted(lambda: drive_seq(
            d, [tuple(torch.as_tensor(x).to(dev) for x in c)
                for c in pushes], dev, EFFECT_CHECK[0]))
        require(not any(counts.values()), f"{effect}: kernels {counts}")
        _, on_cpu, _ = drive_seq(d, [tuple(torch.as_tensor(x) for x in c)
                                     for c in pushes], "cpu",
                                 EFFECT_CHECK[0])
        same_samples(on_card, on_cpu, effect, dev)
        checked.append(effect.split()[0] if effect in EFFECTS else "chain")
    print(f"path {name}: batch {eb}, {eticks} ticks, fused scan; launches "
          f"none; CUDA == port CPU path over ticks of {EFFECT_CHECK} frames "
          f"at {EW}x{EH} for {checked}; peak device memory "
          f"{peak / 2**30:.2f} GiB")
    print(f"e2e {name}: {fps:.1f} output frames/s over ticks 2..{eticks} "
          f"({[round(s * 1e3, 3) for s in secs]} ms per tick, host clock "
          f"between synchronises; {2 * eb} scan steps a tick); device busy "
          f"{busy:.3f} ms a tick, idle share {idle:.3f}")
    del rgb_dev
    torch.cuda.empty_cache()

    # -- a volume ramp, S16 and F32, 10 s a tick ---------------------------
    arng = np.random.default_rng(seed + 4)
    for fmt in ("S16LE", "F32LE"):
        name = f"volume_controlled_{fmt[:3].lower()}"
        desc = (ASR_SRC.replace("S16LE", fmt)
                + "volume name=v ! appsink name=out")
        host_a = [arng.integers(-32768, 32767, (AGG_FRAMES, 2),
                                dtype=np.int16) for _ in range(4)]
        if fmt == "F32LE":
            host_a = [(h / 32768.0).astype(np.float32) for h in host_a]
        (_, outs, secs), counts, _ = counted(lambda: drive_seq(
            desc, [torch.as_tensor(h).to(dev) for h in host_a], dev, 1,
            VOLUME_RAMP))
        require(not any(counts.values()), f"{name}: kernels {counts}")
        _, cpu, _ = drive_seq(desc, [torch.as_tensor(h) for h in host_a],
                              "cpu", 1, VOLUME_RAMP)
        same_samples(outs, cpu, name, dev)
        busy, idle = profile_ticks(desc, torch.as_tensor(host_a[0]).to(dev),
                                   dev, 1, VOLUME_RAMP)
        msps = AGG_FRAMES * (len(secs) - 1) / sum(secs[1:]) / 1e6
        print(f"audio {name}: CUDA == port CPU path on every tick "
              f"({len(outs)} ticks of {AGG_FRAMES} frames, a new gain each "
              f"tick); launches none")
        print(f"e2e {name}: {msps:.3f} Msamples/s of 48 kHz stereo input "
              f"frames over ticks 2..{len(secs)} "
              f"({[round(s * 1e3, 3) for s in secs]} ms per tick); device "
              f"busy {busy:.3f} ms a tick, idle share {idle:.3f}")
    return total


# -- ingest from disk: BASELINE config 5 and bench_e2e.py's path -------------
INGEST_FRAMES = 96                # bench_e2e.py:23-31's clip, about 300 MB
INGEST_BATCHES = (16, 64)
INGEST_PASSES = 3
INGEST = ("filesrc name=src location={path} ! videoconvertscale name=conv "
          "add-borders=false ! video/x-raw,format=RGB,width=224,height=224 "
          "! appsink name=out")
FRAME_BYTES = W * H * 3 // 2      # one 1080p I420 frame
JPEG_FILES, JPEG_BATCH, JPEG_QUALITY = 64, 16, 85
JPEG_SMALL = (500, 375, 8)        # width, height, files of 4:4:4 and of gray
JPEG_DECODE = ("multifilesrc location={pat} ! jpegdec name=dec ! "
               "videoconvertscale name=conv add-borders=false ! "
               "video/x-raw,format=RGB,width=224,height=224 ! appsink "
               "name=out")
ML_FRAMES, ML_BATCH = 64, 16


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def write_y4m(path, frames, seed):
    """bench_e2e.py:23-31's input: seeded random 1080p I420 frames; returns
    the frames as one (frames, FRAME_BYTES) uint8 array."""
    import numpy as np
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (frames, FRAME_BYTES), dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{W} H{H} F30:1 Ip A1:1 C420mpeg2\n".encode())
        for k in range(frames):
            f.write(b"FRAME\n")
            f.write(raw[k].tobytes())
    return raw


def h2d_ceiling(dev):
    """Host-to-device rate of 16 1080p luma planes (bench_e2e.py:141-167's
    probe), page-locked and pageable: (pinned GB/s, pageable GB/s), median
    of 5 warm copies on the host clock between synchronises; None off the
    card."""
    import numpy as np
    import torch
    if dev.type != "cuda":
        return None
    x = np.random.default_rng(1).integers(0, 256, (16, H, W),
                                          dtype=np.uint8)
    pinned = torch.from_numpy(x).pin_memory()
    rates = []
    for src, kw in ((pinned, {"non_blocking": True}),
                    (torch.from_numpy(x), {})):
        src.to(dev, **kw)
        torch.cuda.synchronize()
        r = []
        for _ in range(5):
            t0 = time.perf_counter()
            src.to(dev, **kw)
            torch.cuda.synchronize()
            r.append(x.nbytes / (time.perf_counter() - t0) / 1e9)
        rates.append(float(np.median(r)))
    return tuple(rates)


def traced(step, dev):
    """(wall ms, device busy ms, idle share) of ONE call of `step` under
    torch.profiler, no warm-up call (a pass ends at EOS): the union of the
    device's kernel and copy intervals, as device_time counts them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if dev.type != "cuda":
        t0 = time.perf_counter()
        step()
        return (time.perf_counter() - t0) * 1e3, 0.0, 1.0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, reach = 0.0, float("-inf")
    for start, end in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    busy = busy_us / 1e3
    return wall, busy, max(0.0, 1.0 - busy / wall)


def drain(sink):
    out = []
    while (s := sink.pull_sample()) is not None:
        out.append(s)
    return out


def ingest_pass(pipe, sink, dev):
    """Tick `pipe` to EOS; (samples, ticks, seconds on the host clock, the
    last sync included)."""
    samples, ticks = [], 0
    sync(dev)
    t0 = time.perf_counter()
    while pipe.tick():
        ticks += 1
        samples += drain(sink)
    sync(dev)
    return samples, ticks, time.perf_counter() - t0


def same_rgb(samples, gold, what):
    """The samples' RGB planes, in order, equal `gold` (three (n, 224, 224)
    tensors); returns (pts list, batch list)."""
    import torch
    got = [torch.cat([s.buffer.data[c] for s in samples]) for c in range(3)]
    require(all(tuple(g.shape) == tuple(r.shape) and torch.equal(g, r)
                for g, r in zip(got, gold)),
            f"{what}: RGB differs from the converter on the same frames")
    return ([s.buffer.pts for s in samples],
            [s.buffer.batch for s in samples])


def ingest_y4m(seed, counters, dev, tmp):
    """filesrc ! videoconvertscale add-borders=false ! RGB 224 ! appsink over
    bench_e2e.py's clip at batch 16 and 64, prefetch off and on, three passes
    with seek(0) between them; then once under GTPU_PALLAS=1.  Returns the
    kernels' launches."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch import VideoConverter, parse_launch
    from gstreamer_tpu_torch.core.pipeline import State
    path = os.path.join(tmp, "ingest.y4m")
    raw = write_y4m(path, INGEST_FRAMES, seed)
    ys = W * H
    host = (raw[:, :ys].reshape(-1, H, W),
            raw[:, ys:ys + ys // 4].reshape(-1, H // 2, W // 2),
            raw[:, ys + ys // 4:].reshape(-1, H // 2, W // 2))
    del raw
    dur_ns = INGEST_FRAMES * 10**9 // 30
    launches = {k: 0 for k in counters}
    runs, gold = {}, None
    for batch in INGEST_BATCHES:
        for prefetch in (False, True):
            tag = f"batch {batch}, prefetch {'on' if prefetch else 'off'}"
            pipe = parse_launch(INGEST.format(path=path), device=dev)
            pipe.compile(batch=batch, donate_inputs=True, prefetch=prefetch)
            src, sink = pipe.get_by_name("src"), pipe.get_by_name("out")
            pipe.set_state(State.PLAYING)
            if gold is None:
                # the port's VideoConverter, built from the element's
                # config, on the same frames read with numpy
                conv = pipe.get_by_name("conv")._converter
                ref = VideoConverter(conv.in_info, conv.out_info, conv.config,
                                     device=dev)
                gold = ref.convert(tuple(torch.as_tensor(p).to(dev)
                                         for p in host))
                del ref
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            fps, ceil, frac, meta = [], [], [], None
            for k in range(INGEST_PASSES):
                if k:
                    require(pipe.seek(0), f"ingest_y4m [{tag}]: seek(0) "
                            "refused")
                pre = h2d_ceiling(dev)
                for c in counters.values():
                    c.launches = 0
                before = src.native_batches
                samples, ticks, secs = ingest_pass(pipe, sink, dev)
                counts = {n: c.launches for n, c in counters.items()}
                post = h2d_ceiling(dev)
                for n, v in counts.items():
                    launches[n] += v
                want = -(-INGEST_FRAMES // batch)
                require(ticks == want, f"ingest_y4m [{tag}]: {ticks} ticks, "
                        f"want {want}")
                require(counts["yscale_hv"] == ticks
                        and sum(counts.values()) == ticks,
                        f"ingest_y4m [{tag}]: launches {counts}, want "
                        f"yscale_hv once a tick ({ticks})")
                require(src.native_batches - before == ticks,
                        f"ingest_y4m [{tag}]: the native reader delivered "
                        f"{src.native_batches - before} of {ticks} ticks")
                m = same_rgb(samples, gold, f"ingest_y4m [{tag}] pass {k}")
                require(m[0] == [i * batch * 10**9 // 30
                                 for i in range(ticks)],
                        f"ingest_y4m [{tag}]: pts {m[0]}")
                require(meta in (None, m), f"ingest_y4m [{tag}]: pass {k} "
                        "timestamps differ from pass 0")
                meta = m
                require(pipe.query_duration() == dur_ns,
                        f"ingest_y4m [{tag}]: duration "
                        f"{pipe.query_duration()}, want {dur_ns}")
                last = (ticks - 1) * batch      # the last tick's first frame
                want_pos = (last * 10**9 // 30
                            + (INGEST_FRAMES - last) * (10**9 // 30))
                require(pipe.query_position() == want_pos,
                        f"ingest_y4m [{tag}]: position "
                        f"{pipe.query_position()}, want {want_pos} (the "
                        "last buffer's pts + its frames' durations)")
                fps.append(INGEST_FRAMES / secs)
                if pre is not None:
                    ceil.append((pre, post))
                    frac.append(fps[-1] / float(
                        np.median([pre[0], post[0]]) * 1e9 / FRAME_BYTES))
            require(pipe.seek(0), f"ingest_y4m [{tag}]: seek(0) refused")
            wall, busy, idle = traced(lambda: ingest_pass(pipe, sink, dev),
                                      dev)
            peak = (torch.cuda.max_memory_allocated() / 2**30
                    if dev.type == "cuda" else 0.0)
            pipe.set_state(State.NULL)
            runs[(batch, prefetch)] = meta
            ticks = -(-INGEST_FRAMES // batch)
            probes = [[round(v, 2) for v in pair] for pc in ceil
                      for pair in pc]
            as_fps = [[round(pc[0][k] * 1e9 / FRAME_BYTES, 1) for pc in ceil]
                      for k in (0, 1)]
            print(f"e2e ingest_y4m [{tag}]: "
                  f"{[round(f, 1) for f in fps]} frames/s per pass; H2D "
                  f"ceiling (pinned, pageable) GB/s before / after each "
                  f"pass {probes} = pinned {as_fps[0]}, pageable "
                  f"{as_fps[1]} 1080p-frames/s (before each pass); fraction "
                  f"of the pinned ceiling {[round(f, 4) for f in frac]}; "
                  f"traced pass: {wall:.2f} ms wall, {busy:.3f} busy ms = "
                  f"{busy / ticks:.3f} a tick, idle {idle:.1%}; peak device "
                  f"memory {peak:.2f} GiB")
        require(runs[(batch, True)] == runs[(batch, False)],
                f"ingest_y4m [batch {batch}]: prefetch changed the ticks or "
                "pts")
    # the fused-ingest route: same bytes, its kernel once a tick
    with opt_in():
        pipe = parse_launch(INGEST.format(path=path), device=dev)
        pipe.compile(batch=64, prefetch=True)
        pipe.set_state(State.PLAYING)
        for c in counters.values():
            c.launches = 0
        samples, ticks, secs = ingest_pass(pipe, pipe.get_by_name("out"), dev)
        counts = {n: c.launches for n, c in counters.items()}
        pipe.set_state(State.NULL)
    for n, v in counts.items():
        launches[n] += v
    require(counts["fused_i420_up_hscale"] == ticks
            and sum(counts.values()) == ticks,
            f"ingest_y4m [GTPU_PALLAS=1]: launches {counts}")
    same_rgb(samples, gold, "ingest_y4m [GTPU_PALLAS=1]")
    print(f"e2e ingest_y4m [batch 64, prefetch on, GTPU_PALLAS=1]: "
          f"{INGEST_FRAMES / secs:.1f} frames/s, same bytes, "
          f"fused_i420_up_hscale once a tick")
    return launches


def jpeg_set(dev, pattern, fmt, w, h, files, batch, seed):
    """`files` JPEGs at quality JPEG_QUALITY written by the port's jpegenc
    from videotestsrc pattern=smpte plus seeded noise (drawn on `dev`), at
    `pattern` % index."""
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    caps = f"video/x-raw,format={fmt},width={w},height={h},framerate=30/1"
    bars = parse_launch(f"videotestsrc pattern=smpte num-buffers=1 ! {caps} "
                        "! appsink name=out", device=dev)
    bars.set_state("playing")
    bars.tick()
    frame = bars.get_by_name("out").pull_sample().buffer.data
    bars.set_state("null")
    gen = torch.Generator(device=dev).manual_seed(seed)
    enc = parse_launch(f"appsrc name=in caps={caps} ! jpegenc quality="
                       f"{JPEG_QUALITY} ! multifilesink location={pattern}",
                       batch=batch, device=dev)
    src = enc.get_by_name("in")
    for k in range(0, files, batch):
        n = min(batch, files - k)
        planes = tuple(
            (p.expand((n,) + tuple(p.shape[1:])).to(torch.int16)
             + torch.randint(-12, 13, (n,) + tuple(p.shape[1:]),
                             generator=gen, device=dev, dtype=torch.int16)
             ).clamp_(0, 255).to(torch.uint8) for p in frame)
        src.push_buffer(Buffer(data=planes, pts=k * DUR, duration=DUR,
                               batch=n))
    src.end_of_stream()
    enc.run()


def decode_planes(pattern, files, batch, dev):
    """multifilesrc ! jpegdec ! appsink on `dev`: the decoded planes of every
    file, one tuple a file."""
    from gstreamer_tpu_torch import parse_launch
    pipe = parse_launch(f"multifilesrc location={pattern} ! jpegdec ! "
                        "appsink name=out", batch=batch, device=dev)
    pipe.set_state("playing")
    out = []
    while pipe.tick():
        for s in drain(pipe.get_by_name("out")):
            out += [tuple(p[k] for p in s.buffer.data)
                    for k in range(s.buffer.batch)]
    pipe.set_state("null")
    require(len(out) == files, f"jpegdec: {len(out)} images of {files}")
    return out


def ingest_jpeg(seed, counters, dev, tmp):
    """BASELINE config 5: multifilesrc ! jpegdec ! videoconvertscale
    add-borders=false ! RGB 224 ! appsink over 64 1080p 4:2:0 JPEGs, and 16
    small 4:4:4 / gray ones.  Returns the kernels' launches."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch import VideoConverter, parse_launch
    from gstreamer_tpu_torch.codecs import jpeg as cj
    from gstreamer_tpu_torch.native import jpeg as njpeg
    require(njpeg.available(), "ingest_jpeg: the native entropy coder did "
            "not build")
    sets = {"1080p_420": ("I420", W, H, JPEG_FILES, JPEG_BATCH),
            "small_444": ("Y444",) + JPEG_SMALL[:2] + (JPEG_SMALL[2],) * 2,
            "small_gray": ("GRAY8",) + JPEG_SMALL[:2] + (JPEG_SMALL[2],) * 2}
    launches = {k: 0 for k in counters}
    for i, (sname, (fmt, w, h, files, batch)) in enumerate(sets.items()):
        pattern = os.path.join(tmp, f"{sname}_%05d.jpg")
        t0 = time.perf_counter()
        jpeg_set(dev, pattern, fmt, w, h, files, batch, seed + i)
        enc_s = time.perf_counter() - t0
        blobs = []
        for k in range(files):
            with open(pattern % k, "rb") as f:
                blobs.append(f.read())
        # the card's decoded planes against the port's CPU decode
        card = decode_planes(pattern, files, batch, dev)
        for k, (planes, blob) in enumerate(zip(card, blobs)):
            cpu, _, _, _ = cj.jpeg_decode(blob, device="cpu")
            if fmt == "I420":
                cw, ch = -(-w // 2), -(-h // 2)
                cpu = (cpu[0],) + tuple(p[:ch, :cw] for p in cpu[1:])
            require(len(planes) == len(cpu) and all(
                p.device.type == dev.type and torch.equal(p.cpu(), c)
                for p, c in zip(planes, cpu)),
                f"ingest_jpeg [{sname}]: file {k}: the card's planes differ "
                "from the CPU decode")
        # the launched string: counts zeroed just before, read just after
        pipe = parse_launch(JPEG_DECODE.format(pat=pattern), batch=batch,
                            device=dev)
        pipe.set_state("playing")
        dec, sink = pipe.get_by_name("dec"), pipe.get_by_name("out")
        for c in counters.values():
            c.launches = 0
        samples, ticks, secs = ingest_pass(pipe, sink, dev)
        counts = {n: c.launches for n, c in counters.items()}
        for n, v in counts.items():
            launches[n] += v
        require(dec.native_decodes == files,
                f"ingest_jpeg [{sname}]: {dec.native_decodes} of {files} "
                "scans decoded natively")
        if fmt == "I420":
            require(counts["yscale_hv"] == ticks
                    and sum(counts.values()) == ticks,
                    f"ingest_jpeg [{sname}]: launches {counts}, want "
                    f"yscale_hv once a tick ({ticks})")
        conv = pipe.get_by_name("conv")._converter
        ref = VideoConverter(conv.in_info, conv.out_info, conv.config,
                             device=dev)
        gold = ref.convert(tuple(torch.stack([p[c] for p in card])
                                 for c in range(len(card[0]))))
        same_rgb(samples, gold, f"ingest_jpeg [{sname}]")
        pipe.set_state("null")
        # where the time goes: host entropy decode, device IDCT, idle share
        t0 = time.perf_counter()
        coded = [cj.decode_entropy(b) for b in blobs[:batch]]
        entropy_ms = (time.perf_counter() - t0) * 1e3 / len(coded)
        zz = torch.as_tensor(np.concatenate(
            [c["coef"] for img in coded for c in img.comps]), device=dev)
        zz = zz[:, torch.as_tensor(cj.UNZIGZAG, device=dev)].reshape(
            -1, 8, 8).contiguous()
        counts_ = [c["coef"].shape[0] for img in coded for c in img.comps]
        q = torch.as_tensor(np.stack(
            [img.qtabs[c["tq"]] for img in coded for c in img.comps]
        ).astype(np.float32), device=dev)
        qb = q[torch.repeat_interleave(
            torch.arange(len(counts_), device=dev),
            torch.as_tensor(counts_, device=dev))].contiguous()
        nblk = zz.shape[0]
        idct_ms = (cuda_ms(lambda: cj._idct(zz, qb), 5, 1)
                   if dev.type == "cuda" else 0.0) / len(coded)
        bound_ms = (nblk * 64 * (4 + 1) / HBM_BYTES_PER_S * 1e3
                    / len(coded))
        transform_ms = (cuda_ms(lambda: cj.decode_transform(coded, dev), 3, 1)
                        if dev.type == "cuda" else 0.0) / len(coded)
        del zz, qb
        pipe = parse_launch(JPEG_DECODE.format(pat=pattern), batch=batch,
                            device=dev)
        pipe.set_state("playing")
        wall, busy, idle = traced(
            lambda: ingest_pass(pipe, pipe.get_by_name("out"), dev), dev)
        pipe.set_state("null")
        print(f"e2e ingest_jpeg [{sname}: {files} {w}x{h} {fmt} JPEGs, "
              f"quality {JPEG_QUALITY}, batch {batch}]: "
              f"{files / secs:.1f} frames/s ({ticks} ticks); written by "
              f"jpegenc in {enc_s:.2f} s; host entropy decode "
              f"{entropy_ms:.3f} ms an image; IDCT on the device "
              f"{idct_ms:.4f} ms an image against a byte bound of "
              f"{bound_ms:.4f} ms (int32 coefficients in, uint8 out), the "
              f"device half with its copies {transform_ms:.4f} ms an image; "
              f"traced pass {wall:.1f} ms wall, {busy:.3f} busy ms, idle "
              f"{idle:.1%}; kernel launches {counts}")
    return launches


def ml_ingest(dev, tmp):
    """examples/ml_ingest_torch.py's loop on `dev`: a finite loss."""
    import importlib.util
    import math
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "ml_ingest_torch", os.path.join(here, "examples",
                                        "ml_ingest_torch.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    clip = os.path.join(tmp, "train.y4m")
    ex.make_dataset(clip, ML_FRAMES, dev)
    t0 = time.perf_counter()
    frames, steps, loss = ex.train(clip, ML_BATCH, dev, seed=0)
    sync(dev)
    secs = time.perf_counter() - t0
    require(frames == ML_FRAMES and steps == ML_FRAMES // ML_BATCH
            and math.isfinite(loss),
            f"ml_ingest: {frames} frames, {steps} steps, loss {loss}")
    print(f"e2e ml_ingest: {frames} frames in {steps} train steps, "
          f"{frames / secs:.1f} frames/s including the steps (first calls "
          f"included), final loss {loss:.6f}")


def ingest_phase(seed, counters, dev):
    """ingest_y4m, ingest_jpeg and ml_ingest in one temporary directory;
    returns the kernels' launches."""
    import tempfile
    launches = {k: 0 for k in counters}
    with tempfile.TemporaryDirectory() as tmp:
        for part in (ingest_y4m, ingest_jpeg):
            for k, n in part(seed, counters, dev, tmp).items():
                launches[k] += n
        ml_ingest(dev, tmp)
    return launches


# -- the common filters and fittings ------------------------------------------

FIT_CROP = 60                    # videocrop top and bottom: 1080 -> 960 rows
FIT_BOX = 64                     # videobox's border left and right
FIT_SQUARE = (224, 224)          # the tee's two square branches
FIT_PORTRAIT = (112, 224)        # its portrait branch: the input's aspect
FIT_TEE = (SRC + "videocrop top={c} bottom={c} ! videoflip method=clockwise "
           "! videomedian ! gamma gamma=1.2 ! tee name=t "
           "t. ! queue ! videoconvertscale add-borders=false ! video/x-raw,"
           "format=RGB,width={sw},height={sh} ! appsink name=out "
           "t. ! queue2 ! videoconvertscale method=catrom add-borders=false ! "
           "video/x-raw,format=RGB,width={sw},height={sh} ! appsink "
           "name=out_cubic "
           "t. ! queue ! videoconvertscale method=catrom add-borders=false ! "
           "video/x-raw,format=RGB,width={pw},height={ph} ! appsink "
           "name=out_portrait "
           "t. ! queue ! valve drop=true ! fakesink name=drop")
FIT_SELECTOR = ("input-selector name=s active-pad=sink_1 ! videobox "
                "left=-{b} right=-{b} ! alpha method=green ! "
                "video/x-raw,format=AYUV ! appsink name=out "
                + " ".join(SRC.replace("name=in", f"name=in{k}")[:-2]
                           + f"! s.sink_{k}" for k in range(2)))
# name: (launch string, appsrc names, appsinks, batch, ticks, the route each
# converter branch takes (the plan's scale_order), launches a tick)
FITTINGS = {
    "filters_tee": (FIT_TEE, ("in",), ("out", "out_cubic", "out_portrait"),
                    64, 4, {"out": "vh", "out_cubic": "vh",
                            "out_portrait": "hv"},
                    {"yscale_hv": 1, "chroma420_scale": 2}),
    "selector_box": (FIT_SELECTOR, ("in0", "in1"), ("out",), 32, 3, {}, {}),
}


def fit_desc(name, w, h):
    c, b = FIT_CROP, FIT_BOX
    return FITTINGS[name][0].format(
        w=w, h=h, c=c, b=b, sw=FIT_SQUARE[0], sh=FIT_SQUARE[1],
        pw=FIT_PORTRAIT[0], ph=FIT_PORTRAIT[1])


def drive_sinks(desc, batch, ticks, ins, sinks, device):
    """Push `ticks` buffers of the same data into every appsrc of `ins`
    ({name: tuple of planes}) and tick the pipeline to EOS, each tick timed
    on the host clock between two synchronises.  The EOS tick flushes the
    queues that a host element (here the closed valve) makes one-tick
    double buffers, so its samples are the last entry.  Returns (pipeline,
    {sink: [samples of each tick and of the EOS tick]}, seconds per tick
    before the EOS tick)."""
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.pipeline import State
    dev = torch.device(device)
    pipe = parse_launch(desc, batch=batch, device=dev)
    for name, data in ins.items():
        src = pipe.get_by_name(name)
        for t in range(ticks):
            src.push_buffer(Buffer(data=data, pts=t * batch * DUR,
                                   duration=DUR, batch=batch))
        src.end_of_stream()
    pipe.set_state(State.PLAYING)
    outs, secs = {s: [] for s in sinks}, []
    while True:
        sync(dev)
        t0 = time.perf_counter()
        more = pipe.tick()
        sync(dev)
        if more:
            secs.append(time.perf_counter() - t0)
        for s in sinks:
            outs[s].append(drain(pipe.get_by_name(s)))
        if not more:
            break
    pipe.set_state(State.NULL)
    return pipe, outs, secs


def converter_of(pipe, sink):
    """The videoconvertscale feeding `sink` through its capsfilter."""
    up = pipe.get_by_name(sink).sink_pads()[0].peer.element
    return up.sink_pads()[0].peer.element._converter


def fittings_inputs(name, host, rng, batch):
    """{appsrc: host planes}: the tee takes the seed's 1080p frames, the
    selector two sets of seeded frames (sink_1's the active one)."""
    import numpy as np
    if name == "filters_tee":
        return {"in": tuple(p[:batch] for p in host)}
    return {f"in{k}": tuple(rng.integers(0, 256, p[:batch].shape,
                                         dtype=np.uint8) for p in host)
            for k in range(2)}


def smi_line():
    """nvidia-smi's name and power limit of the card as one line, or None
    when it prints nothing."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return out[0] if out else None


def fittings_phase(seed, counters, dev, host, w=W, h=H):
    """The slice's path at full width, through the port's parse_launch on
    the card with the launch counts zeroed just before each path and read
    just after (FITTINGS): filters_tee (videocrop, videoflip, videomedian,
    gamma and a four-way tee at batch 64; its portrait branch runs yscale
    and chroma420 on the cropped, rotated plane, each also held to its plain
    version at that shape; the closed valve's sink gets nothing) and
    selector_box (input-selector, videobox's borders and alpha's green key
    into AYUV at batch 32).  Every branch's first frames equal the port's
    CPU path; the tee runs once more under GTPU_TRACERS="stats;latency" and
    GTPU_DEBUG_DUMP_DOT_DIR with the same bytes, the dot file written and
    every buffer counted.  Prints frames/s, device busy ms and idle share
    and peak memory beside the card's name and power limit; returns
    ({kernel: launches}, {kernel: largest difference from its plain
    version})."""
    import tempfile

    import numpy as np
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.pipeline import State
    from gstreamer_tpu_torch.core.tracer import hooks
    from gstreamer_tpu_torch.ops import chroma420_kernel as ck
    from gstreamer_tpu_torch.ops import yscale_kernel as ysk
    rng = np.random.default_rng(seed + 5)
    total = {k: 0 for k in counters}
    err = {}
    card = (smi_line() or "nvidia-smi printed nothing") \
        if dev.type == "cuda" else "CPU rehearsal"
    for name, (_, srcs, sinks, batch, ticks, order, per_tick) in \
            FITTINGS.items():
        desc = fit_desc(name, w, h)
        host_ins = fittings_inputs(name, host, rng, batch)
        ins = {k: tuple(torch.as_tensor(p).to(dev) for p in v)
               for k, v in host_ins.items()}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        pipe, outs, secs = drive_sinks(desc, batch, ticks, ins, sinks, dev)
        counts = {k: c.launches for k, c in counters.items()}
        peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
                else 0)
        want = {k: per_tick.get(k, 0) * ticks for k in counters}
        require(counts == want, f"{name}: launches {counts}, want {want}")
        for k, n in counts.items():
            total[k] += n
        got_order = {s: converter_of(pipe, s).plan["scale_order"]
                     for s in order}
        require(got_order == order, f"{name}: routes {got_order}, want "
                f"{order}")
        for s in sinks:
            frames = sum(x.buffer.batch for tick in outs[s] for x in tick)
            require(frames == batch * ticks,
                    f"{name}: {s} got {frames} frames, want {batch * ticks}")
        if name == "filters_tee":
            require(pipe.get_by_name("drop").n_rendered == 0,
                    "filters_tee: the closed valve let buffers through")
        firsts = {s: next(x for tick in outs[s] for x in tick)
                  for s in sinks}
        n = CPU_FRAMES
        cpu_ins = {k: tuple(p[:n] for p in v) for k, v in host_ins.items()}
        _, cpu, _ = drive_sinks(desc, n, 1, cpu_ins, sinks, "cpu")
        for s in sinks:
            ref = next(x for tick in cpu[s] for x in tick)
            first = firsts[s]
            require(first.buffer.pts == ref.buffer.pts
                    and str(first.caps) == str(ref.caps),
                    f"{name}: {s}'s first sample's pts/caps differ from the "
                    f"CPU run")
            for o, r in zip(first.buffer.data, ref.buffer.data):
                require(o.device.type == dev.type and o.dtype == torch.uint8,
                        f"{name}: {s} output {o.dtype} on {o.device}")
                require(torch.equal(o[:n].cpu(), r),
                        f"{name}: {s} differs from the port's CPU path")
        if name == "filters_tee":
            # the kernels at the portrait branch's shapes, on the cropped
            # and rotated input planes
            plan = converter_of(pipe, "out_portrait").plan
            hr, vr = plan["h_res"], plan["v_res"]
            crops = (FIT_CROP, FIT_CROP // 2, FIT_CROP // 2)
            y, u, v = (p[:, c:p.shape[1] - c].flip(-2).transpose(-1, -2)
                       .contiguous() for c, p in zip(crops, ins["in"]))
            err["yscale_hv"] = max_err([ysk.yscale_hv(y, hr, vr)],
                                       [ysk.yscale_hv_plain(y, hr, vr)],
                                       "yscale_hv")
            cargs = (hr, vr, plan["up_h_cosited"], plan["up_v_cosited"])
            err["chroma420_scale"] = max_err(
                [ck.chroma420_scale(c, *cargs, y.shape[-1], y.shape[-2])
                 for c in (u, v)],
                [ck.chroma420_scale_plain(c, *cargs) for c in (u, v)],
                "chroma420_scale")
            for kname, e in err.items():
                require(e == 0, f"{name}: {kname} differs from its plain "
                        f"version by up to {e} at the portrait shape")
            check = (f"yscale_hv and chroma420_scale == plain at "
                     f"{tuple(y.shape)} -> {(vr.out_size, hr.out_size)}")
            del y, u, v
            # once more with two tracers and the dot dump: the same bytes
            with tempfile.TemporaryDirectory() as tmp, switches(
                    GTPU_TRACERS="stats;latency",
                    GTPU_DEBUG_DUMP_DOT_DIR=tmp):
                hooks.reset()
                try:
                    tpipe, touts, tsecs = drive_sinks(desc, batch, ticks,
                                                      ins, sinks, dev)
                    rep = hooks.reports()
                finally:
                    hooks.reset()
                dot = os.path.join(tmp, f"{tpipe.name}.dot")
                require(os.path.exists(dot) and "valve" in open(dot).read(),
                        f"{name}: no dot file {dot}")
            stats = rep.get("stats", {})
            require(stats.get("ticks") == ticks and all(
                stats["frames"].get(s) == batch * ticks for s in sinks)
                and "drop" not in stats["frames"]
                and set(rep.get("latency", {})) == set(sinks),
                f"{name}: tracer reports {rep}")
            for s in sinks:
                again = next(x for tick in touts[s] for x in tick)
                require(all(torch.equal(a, b) for a, b in zip(
                    again.buffer.data, firsts[s].buffer.data)),
                    f"{name}: {s} changed under the tracers")
            del touts
            check += (f"; traced run: same bytes, dot written, stats "
                      f"frames { {s: stats['frames'][s] for s in sinks} }, "
                      f"{[round(t * 1e3, 3) for t in tsecs]} ms per tick "
                      f"(untraced {[round(t * 1e3, 3) for t in secs]})")
        else:
            # the active pad's frames inside videobox's borders
            b = FIT_BOX
            y = firsts["out"].buffer.data[0]
            require(torch.equal(y[:, :, b:-b], ins["in1"][0])
                    and bool((y[:, :, :b] == 16).all()),
                    f"{name}: luma is not sink_1's frames in black borders")
            check = "luma == sink_1's frames inside the borders"
        print(f"fittings {name}: batch {batch}, {ticks} ticks, "
              f"{'fused' if pipe._fused else 'per-element'}; routes "
              f"{got_order}; launches "
              f"{ {k: v for k, v in counts.items() if v} }; CUDA == port "
              f"CPU path ({n} frames) on {list(sinks)}; {check}")
        pipe_order = pipe._order
        del outs, firsts, pipe

        prof = parse_launch(desc, batch=batch, device=dev)
        prof.set_state(State.PLAYING)

        def tick():
            for k, v in ins.items():
                prof.get_by_name(k).push_buffer(Buffer(data=v, batch=batch))
            prof.tick()
            for s in sinks:
                drain(prof.get_by_name(s))
        if dev.type == "cuda":
            _, busy, idle, _ = device_time(tick, 3)
        else:
            busy, idle = 0.0, 1.0
        prof.set_state(State.NULL)
        # the first tick makes first calls; where a host element turns the
        # queues into one-tick double buffers, the elements after them make
        # theirs in the second
        warm = 2 if any(getattr(e, "_decouple", False)
                        for e in pipe_order) else 1
        timed = sum(secs[warm:])
        print(f"e2e {name}: {batch * (ticks - warm) / timed:.1f} input "
              f"frames/s over ticks {warm + 1}..{ticks} "
              f"({[round(s * 1e3, 3) for s in secs]} ms per tick, host "
              f"clock between synchronises); device busy {busy:.3f} ms a "
              f"tick, idle share {idle:.3f}; peak device memory "
              f"{peak / 2**30:.2f} GiB; {card}")
        del ins, prof
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return total, err


# -- overlays and the device video effects ------------------------------------

OVL_QR = "tpu-media burn-in 0001"      # qroverlay's payload
OVL_LOGO = (96, 160)                     # the logo PNG: height, width (RGBA)
OVL_SVG = ("<svg width='320' height='120'><rect x='8' y='8' width='150' "
           "height='60' fill='#ff0000' stroke='blue' stroke-width='4'/>"
           "<circle cx='240' cy='60' r='40' fill='#00ff00'/>"
           "<text x='20' y='100' fill='white'>tpu-media</text></svg>")
BURNIN = (SRC + "timeoverlay name=stamp ! qroverlay data=\"{qr}\" pixel-size=4 ! "
          "gdkpixbufoverlay location={png} offset-x=-32 offset-y=-32 ! "
          "videoconvertscale method=catrom add-borders=false ! video/x-raw,"
          "format=RGB,width={ow},height={oh} ! appsink name=out")
RAW = ("appsrc name=in caps=video/x-bayer,format={fmt},width={w},height={h},"
       "framerate=30/1 ! bayer2rgb ! videoconvertscale add-borders=false ! "
       "video/x-raw,format=RGB,width={ow},height={oh} ! appsink name=out")
RAW_ROUND = ("appsrc name=in caps=video/x-bayer,format={fmt},width={w},"
             "height={h},framerate=30/1 ! bayer2rgb ! video/x-raw,format=ARGB "
             "! rgb2bayer ! video/x-bayer,format={fmt} ! appsink name=out")
AUGMENT = (SRC + "videoconvertscale ! video/x-raw,format=AYUV ! rotate "
           "angle=0.3 ! gaussianblur sigma=1.2 ! coloreffects preset=sepia ! "
           "videoconvertscale method=catrom add-borders=false ! video/x-raw,"
           "format=RGB,width={ow},height={oh} ! appsink name=out")
# name: (launch string, bayer format or None, batch, ticks, launches a tick)
OVERLAY_PATHS = {
    "burnin": (BURNIN, None, 64, 3, {"yscale_hv": 1, "chroma420_scale": 2}),
    "camera_raw_rggb": (RAW, "rggb", 64, 3, {}),
    "camera_raw_rggb16le": (RAW, "rggb16le", 64, 3, {}),
    "augment": (AUGMENT, None, 32, 3, {}),
}
OVL_ALONE = (2, 4)               # ticks and frames a tick of each factory
GEOMETRIC = ("bulge", "circle", "diffuse", "fisheye", "kaleidoscope",
             "marble", "mirror", "perspective", "pinch", "rotate", "sphere",
             "square", "stretch", "tunnel", "twirl", "waterripple")
# each factory alone: (its string, the input: a video format, "bayer",
# "text", "png" or "svg")
OVL_FACTORIES = (
    [("coloreffects preset=xpro", "AYUV"), ("chromahold", "AYUV"),
     ("burn", "RGBx"), ("chromium", "BGRA"), ("dilate", "BGRx"),
     ("dodge", "RGBA"), ("exclusion", "RGBx"), ("gaussianblur", "AYUV"),
     ("solarize", "RGBx")]
    + [(f"{g} off-edge-pixels={('ignore', 'clamp', 'wrap')[k % 3]}",
        ("AYUV", "ARGB", "BGRA", "ABGR", "RGBA")[k % 5])
       for k, g in enumerate(GEOMETRIC)]
    + [("bayer2rgb", "bayer"), ("rgb2bayer", "ARGB")]
    + [("overlaycomposition name=e", "I420"),
       ("textoverlay text=\"tpu-media\" shaded-background=true", "NV12"),
       ("timeoverlay halignment=right", "I420"),
       ("clockoverlay", "AYUV"), ("textrender", "text"),
       ("gdkpixbufdec", "png"),
       ("gdkpixbufoverlay location={png} alpha=0.7", "RGBA"),
       ("cairooverlay name=e", "RGB"),
       ("qroverlay data=\"{qr}\" x=10 y=90", "Y444"),
       ("debugqroverlay name=e span-buffer=3", "I420"),
       ("gdkpixbufsink name=out", "RGB"), ("rsvgdec", "svg"),
       ("rsvgoverlay location={svg} fit-to-frame=true", "BGRx")])


def drive_bufs(desc, bufs, device, batch, setup=None):
    """parse_launch(desc) on `device`, `setup(pipeline)` where given, push
    `bufs` (Buffer keyword dicts) into appsrc "in" and tick to EOS, each
    tick timed on the host clock between two synchronises.  Returns
    (pipeline, the samples of each tick from appsink "out", seconds per
    tick)."""
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.pipeline import State
    dev = torch.device(device)
    pipe = parse_launch(desc, batch=batch, device=dev)
    if setup is not None:
        setup(pipe)
    src = pipe.get_by_name("in")
    for b in bufs:
        src.push_buffer(Buffer(**b))
    src.end_of_stream()
    sink = pipe.get_by_name("out")
    pipe.set_state(State.PLAYING)
    outs, secs = [], []
    while True:
        sync(dev)
        t0 = time.perf_counter()
        more = pipe.tick()
        sync(dev)
        if not more:
            break
        secs.append(time.perf_counter() - t0)
        outs.append(drain(sink) if hasattr(sink, "pull_sample") else [])
    pipe.set_state(State.NULL)
    return pipe, outs, secs


@contextlib.contextmanager
def fixed_localtime():
    """time.localtime pinned inside the block, so that clockoverlay draws
    the same text on the card and on the CPU."""
    real = time.localtime
    stamp = real(1_700_000_000)
    time.localtime = lambda *a: stamp
    try:
        yield
    finally:
        time.localtime = real


def overlay_setup(factory):
    """The callbacks overlaycomposition and cairooverlay take from an
    application, or None: a composition a buffer (a scaled, clipped,
    translucent rectangle, a premultiplied one every other buffer) and a
    drawing a frame."""
    import numpy as np
    from gstreamer_tpu_torch.video.overlay import (VideoOverlayComposition,
                                                   VideoOverlayRectangle)
    px = np.random.default_rng(7).integers(0, 256, (120, 200, 4),
                                           dtype=np.uint8)
    if factory == "overlaycomposition":
        def setup(pipe):
            e = pipe.get_by_name("e")
            e.composition = VideoOverlayComposition([VideoOverlayRectangle(
                px, render_x=-50, render_y=900, render_width=400,
                render_height=240, global_alpha=0.7)])
            e.draw = lambda buf: (VideoOverlayComposition([
                VideoOverlayRectangle(px, render_x=1800, render_y=20,
                                      premultiplied=True)])
                if buf.pts % 2 else None)
        return setup
    if factory == "cairooverlay":
        def draw(surface, pts, dur):
            k = pts // DUR
            surface[100 + 10 * k:300, 200:600 + 20 * k] = (255, 40, 0, 160)
        return lambda pipe: setattr(pipe.get_by_name("e"), "draw", draw)
    return None


def alone_inputs(kind, rng, w, h, frame_png):
    """Host buffers for one factory alone: OVL_ALONE's ticks of frames of a
    video format (seeded), of a bayer mosaic, or of texts / encoded w x h
    images (each a frame)."""
    import numpy as np
    from gstreamer_tpu_torch.video.info import VideoInfo
    ticks, n = OVL_ALONE
    if kind in ("text", "png", "svg"):
        blob = {"png": lambda: frame_png,
                "svg": lambda: OVL_SVG.replace(
                    "width='320' height='120'",
                    f"width='{w}' height='{h}'").encode(),
                "text": lambda: None}[kind]()
        return [dict(data=[blob or f"frame {t * n + k}".encode()
                           for k in range(n)], pts=t * n * DUR,
                     duration=DUR, batch=n) for t in range(ticks)]
    if kind == "bayer":
        data = [rng.integers(0, 256, (n, h, w), dtype=np.uint8)
                for _ in range(ticks)]
    else:
        info = VideoInfo(format=kind, width=w, height=h)
        data = [tuple(rng.integers(0, 256, (n,) + s, dtype=np.uint8)
                      for s in info.plane_shapes()) for _ in range(ticks)]
    return [dict(data=d, pts=t * n * DUR, duration=DUR, batch=n)
            for t, d in enumerate(data)]


def alone_desc(factory, kind, w, h, png, svg):
    if kind == "bayer":
        head = (f"appsrc name=in caps=video/x-bayer,format=rggb,width={w},"
                f"height={h},framerate=30/1 ! ")
    elif kind == "text":
        head = "appsrc name=in ! text/x-raw,format=utf8 ! "
    elif kind == "png":
        head = "appsrc name=in ! image/png ! "
    elif kind == "svg":
        head = "appsrc name=in ! image/svg+xml ! "
    else:
        head = (f"appsrc name=in caps=video/x-raw,format={kind},width={w},"
                f"height={h},framerate=30/1 ! ")
    tail = {"textrender": f" ! video/x-raw,format=ARGB,width={w},"
                          f"height={h} ! appsink name=out",
            "gdkpixbufsink": ""}.get(factory.split()[0],
                                     " ! appsink name=out")
    return head + factory.format(png=png, svg=svg, qr=OVL_QR) + tail


def on_device(bufs, dev):
    import torch

    def put(x):
        return torch.as_tensor(x).to(dev) if hasattr(x, "dtype") else x
    out = []
    for b in bufs:
        d = b["data"]
        d = tuple(put(x) for x in d) if isinstance(d, tuple) else (
            d if isinstance(d, list) else put(d))
        out.append(dict(b, data=d))
    return out


def write_logo(tmp, rng):
    """The burn-in logo: a seeded RGBA PNG of OVL_LOGO's size in `tmp`,
    written by the port's PNG encoder; returns its path."""
    import numpy as np
    from gstreamer_tpu_torch.codecs.png import png_encode
    png = os.path.join(tmp, "logo.png")
    with open(png, "wb") as f:
        f.write(png_encode(rng.integers(0, 256, OVL_LOGO + (4,),
                                        dtype=np.uint8)))
    return png


def overlay_path(name, png, host, rng, w=W, h=H):
    """OVERLAY_PATHS' `name` at w x h: (launch string, host data of one
    tick: I420 planes or a Bayer mosaic)."""
    import numpy as np
    tmpl, fmt, batch, _, _ = OVERLAY_PATHS[name]
    desc = tmpl.format(w=w, h=h, ow=OW, oh=OH, png=png, qr=OVL_QR, fmt=fmt)
    if fmt is None:
        return desc, tuple(p[:batch] for p in host)
    top = 256 if fmt == "rggb" else 65536
    return desc, rng.integers(0, top, (batch, h, w)).astype(
        np.uint8 if top == 256 else np.uint16)


def overlays_phase(seed, counters, dev, host, w=W, h=H):
    """The overlays and the device video effects at full width, each path
    with the launch counts zeroed just before it and read just after
    (OVERLAY_PATHS): burnin (timeoverlay ! qroverlay ! gdkpixbufoverlay
    on 1080p I420, then the catrom converter to RGB 224x224: yscale once
    and chroma420 twice a tick), camera_raw (bayer2rgb at 8 and 16 bits,
    then the converter's generic route; the 8-bit mosaic also through
    bayer2rgb ! ARGB ! rgb2bayer, equal to itself at every site) and
    augment (rotate ! gaussianblur ! coloreffects on AYUV between two
    converters).  Each tick's first frames equal the port's CPU path (for
    burnin with the buffer's duration scaled, so each frame's stamp is the
    same).  Then each of the 27 effect and 13 overlay factories alone on
    OVL_ALONE's ticks of 1080p frames (texts, a PNG, an SVG for the
    renderers and decoders): the card's samples equal the CPU path's, no
    kernel launched.  Prints frames/s, device busy ms and idle share and
    peak memory beside the card's name and power limit; returns {kernel:
    launches}."""
    import tempfile

    import numpy as np
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.codecs.png import png_encode
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.pipeline import State
    rng = np.random.default_rng(seed + 6)
    total = {k: 0 for k in counters}
    card = (smi_line() or "nvidia-smi printed nothing") \
        if dev.type == "cuda" else "CPU rehearsal"
    n = CPU_FRAMES
    with tempfile.TemporaryDirectory() as tmp:
        png = write_logo(tmp, rng)
        svg = os.path.join(tmp, "logo.svg")
        with open(svg, "w") as f:
            f.write(OVL_SVG)
        # the decoders' w x h image: seeded colour stripes, one a column,
        # which the PNG "Up" filter makes cheap to decode on the host
        frame_png = png_encode(np.broadcast_to(
            rng.integers(0, 256, (1, w, 3), dtype=np.uint8), (h, w, 3)))
        for name, (_, fmt, batch, ticks, per_tick) in OVERLAY_PATHS.items():
            desc, data = overlay_path(name, png, host, rng, w, h)
            ins = on_device([dict(data=data)], dev)[0]["data"]
            bufs = [dict(data=ins, pts=t * batch * DUR, duration=DUR,
                         batch=batch) for t in range(ticks)]
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            for c in counters.values():
                c.launches = 0
            pipe, outs, secs = drive_bufs(desc, bufs, dev, batch)
            counts = {k: c.launches for k, c in counters.items()}
            peak = (torch.cuda.max_memory_allocated()
                    if dev.type == "cuda" else 0)
            want = {k: per_tick.get(k, 0) * ticks for k in counters}
            require(counts == want, f"{name}: launches {counts}, want {want}")
            for k, v in counts.items():
                total[k] += v
            require([[s.buffer.batch for s in o] for o in outs]
                     == [[batch]] * ticks, f"{name}: samples per tick")
            # the CPU path on each tick's first frames, at the same pts;
            # timeoverlay stamps frame k at pts + k * duration // batch
            cut = (tuple(p[:n] for p in data) if fmt is None
                   else data[:n])
            dur = n * (DUR // batch) if "timeoverlay" in desc else DUR
            _, cpu, _ = drive_bufs(desc, [dict(b, data=cut, duration=dur,
                                               batch=n) for b in bufs],
                                   "cpu", n)
            for t, (o, c) in enumerate(zip(outs, cpu)):
                require(o[0].buffer.pts == c[0].buffer.pts
                        and str(o[0].caps) == str(c[0].caps),
                        f"{name}: tick {t} pts/caps differ from the CPU run")
                for x, y in zip(o[0].buffer.data, c[0].buffer.data):
                    require(x.device.type == dev.type
                            and torch.equal(x[:n].cpu(), y),
                            f"{name}: tick {t} differs from the port's CPU "
                            f"path")
            check = f"CUDA == port CPU path ({n} frames of each tick)"
            if name == "burnin":
                first = Buffer(**bufs[0])
                stamps = {pipe.get_by_name("stamp")._text_for_frame(first, k)
                          for k in range(batch)}
                check += f"; {len(stamps)} distinct time stamps a tick"
            if fmt == "rggb":
                rdesc = RAW_ROUND.format(w=w, h=h, fmt=fmt)
                _, rt, _ = drive_bufs(rdesc, bufs[:1], dev, batch)
                require(torch.equal(rt[0][0].buffer.data, ins),
                        f"{name}: rgb2bayer(bayer2rgb(x)) != x")
                check += "; bayer2rgb ! ARGB ! rgb2bayer == the mosaic"
                del rt
            print(f"overlays {name}: batch {batch}, {ticks} ticks, "
                  f"{'fused' if pipe._fused else 'per-element'}; launches "
                  f"{ {k: v for k, v in counts.items() if v} or 'none'}; "
                  f"{check}")
            del outs, cpu, pipe

            prof = parse_launch(desc, batch=batch, device=dev)
            prof.set_state(State.PLAYING)
            tick_no = [0]

            def tick():
                prof.get_by_name("in").push_buffer(Buffer(
                    data=ins, pts=tick_no[0] * batch * DUR, duration=DUR,
                    batch=batch))
                tick_no[0] += 1
                prof.tick()
                drain(prof.get_by_name("out"))
            if dev.type == "cuda":
                _, busy, idle, _ = device_time(tick, 3)
            else:
                busy, idle = 0.0, 1.0
            prof.set_state(State.NULL)
            print(f"e2e {name}: {batch * (ticks - 1) / sum(secs[1:]):.1f} "
                  f"input frames/s over ticks 2..{ticks} "
                  f"({[round(s * 1e3, 3) for s in secs]} ms per tick, host "
                  f"clock between synchronises); device busy {busy:.3f} ms "
                  f"a tick, idle share {idle:.3f}; peak device memory "
                  f"{peak / 2**30:.2f} GiB; {card}")
            del ins, bufs, prof
            if dev.type == "cuda":
                torch.cuda.empty_cache()

        # -- each factory alone: the card's samples equal the CPU path's ---
        checked = []
        for factory, kind in OVL_FACTORIES:
            fname = factory.split()[0]
            desc = alone_desc(factory, kind, w, h, png, svg)
            host_bufs = alone_inputs(kind, rng, w, h, frame_png)
            setup = overlay_setup(fname)
            for c in counters.values():
                c.launches = 0
            with fixed_localtime():
                pipe, on_card, _ = drive_bufs(desc, on_device(host_bufs, dev),
                                              dev, OVL_ALONE[1], setup)
                counts = {k: c.launches for k, c in counters.items()}
                cpipe, on_cpu, _ = drive_bufs(desc, host_bufs, "cpu",
                                              OVL_ALONE[1], setup)
            require(not any(counts.values()), f"{fname}: kernels {counts}")
            if fname == "gdkpixbufsink":
                got = [m.data["pixbuf"] for p in (pipe, cpipe)
                       for m in iter(p.bus.pop, None)
                       if m.type == "element"
                       and m.data.get("name") == "pixbuf"]
                half = len(got) // 2
                require(half == OVL_ALONE[0] * OVL_ALONE[1] and all(
                    np.array_equal(a, b) for a, b in zip(got[:half],
                                                         got[half:])),
                        f"{fname}: pixbuf messages differ from the CPU run")
            else:
                require(sum(len(o) for o in on_card) == OVL_ALONE[0],
                        f"{fname}: samples per tick "
                        f"{[len(o) for o in on_card]}")
                same_samples(on_card, on_cpu, fname, dev)
            checked.append(fname)
            del pipe, cpipe, on_card, on_cpu
        require(len(checked) == 40, f"{len(checked)} factories checked")
        print(f"overlays each factory alone: CUDA == port CPU path over "
              f"{OVL_ALONE[0]} ticks of {OVL_ALONE[1]} frames at {w}x{h} "
              f"(texts, a PNG and an SVG for the renderers and decoders), no "
              f"kernel launched, for {checked}")
    return total


# -- 12. the audio DSP family ---------------------------------------------------

FP32_OPS_PER_S = 67e12          # H100 SXM data sheet, float32 outside the
#                                 tensor cores
# the latency of one dependent float32 or 32-bit integer operation on
# Hopper, in cycles (published microbenchmarks): the unit of the two
# recursions' latency bounds
DEP_CYCLES = 4
# float32 operations a frame of freeverb: 16 combs x 5, 16 sums, 8
# allpasses x 3, 4 for the input, 2 for DC, 2 x 5 for the mix
FV_FLOPS = 136
# int32-lane operations a sample of the VAD: 11 integer operations, 64-bit
# ones as two
VAD_OPS = 22
# dependent operations a sample on the VAD's chain: one multiply-high-add
VAD_CHAIN = 1
DSP_SRC = ("appsrc name=in caps=audio/x-raw,format={fmt},rate=48000,"
           "channels={ch},layout=interleaved ! ")
MUSIC_CHAIN = ("equalizer-10bands band0=3.0 band9=-3.0 ! audiodynamic "
               "ratio=0.5 threshold=0.3 ! freeverb room-size=0.6 ! "
               "audiopanorama panorama=0.3 ! rgvolume fallback-gain=-3.0 ! "
               "rglimiter ! spectrum ! level")
VOICE_CHAIN = ("removesilence remove=true squash=true ! audioamplify "
               "amplification=1.5 ! audiowsincband lower-frequency=300 "
               "upper-frequency=3400 ! audioresample ! audio/x-raw,rate=8000 "
               "! mulawenc ! mulawdec")
DSP_PATHS = {
    # name: (format, channels, chain, frames a push, pushes, its kernel,
    #        frames a push and pushes of the card-against-CPU check)
    "music_master": ("F32LE", 2, MUSIC_CHAIN, 480000, 3, "freeverb", 4800, 3),
    "voice_chain": ("S16LE", 1, VOICE_CHAIN, 960, 250, "vad_power", 960,
                    100),
}
FV_RATES = (1, 1000, 8000, 44100, 48000, 96000, 192000, 384000, 768000)
FV_CHECK = 4800                 # frames of freeverb's check's first push
FV_ODD = 777                    # and of its second: no multiple of a block
VAD_CHECK = (4, 24000)          # streams, samples a push of the VAD's, 2
VAD_P0 = (0, 5, 2**32, 2**33 - 1, 2**40, 2**62)   # carried powers
VAD_LENGTHS = (1, 7, 960, 24000)
# the times of the kernels these versions replace (freeverb one warp a
# stream, the VAD one thread a stream, the mixture with ranks and gathers,
# the pass over a volume in device memory; a call back to back on an H100
# 80GB HBM3, 700 W): {(kernel, frames a push or shape): ms}
PREVIOUS_MS = {("freeverb", "4800"): 0.9478,
               ("freeverb", "480000"): 92.9153, ("vad_power", "960"): 0.0337,
               # the mixture's first kernel, and the semi-global pass alone
               # on a volume made in plain torch (about 30 ms more)
               ("gmm", "1080p64"): 2.3962, ("disparity", "720p8"): 0.5909}
DSP_ALONE = 4800                # frames a push of each factory alone, 2
DSP_FACTORIES = (               # (chain, format, channels)
    ("mulawenc", "S16LE", 2), ("mulawdec", "mulaw", 2),
    ("alawenc", "S16LE", 2), ("alawdec", "alaw", 2),
    ("audioamplify amplification=1.5 clipping-method=none", "S16LE", 2),
    ("audioinvert degree=0.3", "S16LE", 2),
    ("audiokaraoke level=0.7", "F32LE", 2),
    ("audioecho delay=5000000 intensity=0.5 feedback=0.3", "F32LE", 2),
    ("audiodynamic ratio=0.5 threshold=0.3", "S16LE", 2),
    ("spectrum bands=64 interval=20000000", "F32LE", 2),
    ("level interval=20000000", "S16LE", 2),
    ("equalizer-3bands band0=6.0", "F32LE", 2),
    ("equalizer-10bands band0=3.0 band9=-3.0", "S16LE", 2),
    ("equalizer-nbands num-bands=5", "F32LE", 2),
    ("audiopanorama panorama=-0.4", "S16LE", 1),
    ("audiowsinclimit cutoff=4000", "F32LE", 2),
    ("audiowsincband lower-frequency=300 upper-frequency=3400", "S16LE", 1),
    ("audiofirfilter", "F32LE", 2), ("audioiirfilter", "F32LE", 2),
    ("audiocheblimit cutoff=4000", "F32LE", 2),
    ("audiochebband lower-frequency=500 upper-frequency=3000", "F32LE", 2),
    ("stereo stereo=0.5", "S16LE", 2), ("rganalysis", "S16LE", 2),
    ("rgvolume fallback-gain=-3.0", "F32LE", 2), ("rglimiter", "F32LE", 2),
    ("removesilence remove=true silent=false", "S16LE", 1),
    ("freeverb", "F32LE", 2), ("cutter", "S16LE", 2),
    ("scaletempo rate=1.5", "F32LE", 2), ("pitch pitch=1.2", "F32LE", 2),
    ("bs2b", "F32LE", 2))


def dsp_signal(fmt, ch, frames, pushes, rng):
    """A path's pushes, seeded: F32 two detuned tones under noise (peaks
    above -6 dBFS, so the limiter works); S16 mono one second of
    speech-band tones and noise and one second near silence in turns, so
    the VAD drops and squashes buffers; a coded format random bytes."""
    import numpy as np
    n = frames * pushes
    t = np.arange(n) / 48000.0
    if fmt in ("mulaw", "alaw"):
        x = rng.integers(0, 256, (n, ch), dtype=np.uint8)
    elif fmt == "F32LE":
        x = (0.25 * rng.standard_normal((n, ch)) + 0.3 * np.sin(
            2 * np.pi * np.array([220.0, 331.0])[:ch] * t[:, None])
             ).astype(np.float32)
    else:
        speech = sum(np.sin(2 * np.pi * f * t) for f in (310, 870, 2400)) \
            * 5000 + rng.standard_normal(n) * 800
        quiet = rng.standard_normal(n) * 3
        x = np.where((np.arange(n) // 48000) % 2 == 0, speech, quiet)
        x = np.repeat(x[:, None], ch, axis=1).astype(np.int16)
    return np.split(x, pushes)


def dsp_desc(fmt, ch, chain):
    src = (DSP_SRC.format(fmt=fmt, ch=ch) if fmt not in ("mulaw", "alaw")
           else f"appsrc name=in caps=audio/x-{fmt},rate=48000,"
                f"channels={ch} ! ")
    return src + chain + " ! appsink name=out"


def dsp_bufs(arrays, frames):
    dur = frames * 10**9 // 48000
    return [dict(data=a, pts=t * dur, duration=dur)
            for t, a in enumerate(arrays)]


def bus_messages(pipe):
    """The element and tag messages a run posted: (type, data)."""
    return [(m.type, m.data) for m in iter(pipe.bus.pop, None)
            if m.type in ("element", "tag")]


def sm_clock_hz():
    """The card's maximum SM clock from nvidia-smi, in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()
    require(bool(out), "nvidia-smi printed no SM clock")
    return float(out[0]) * 1e6


def check_dsp_kernels(rng, dev):
    """Each recursion's kernel against its plain version on the same inputs
    (the plain version on CPU copies), bit for bit: freeverb at FV_RATES,
    mono and stereo, a push of FV_CHECK frames and one of FV_ODD with the
    state carried (outputs and the final rings, indices and filterstores;
    every schedule the layout derives: blocks of 1 frame at lag 1 and 2,
    blocks of 12 to 512, all rings in shared memory to 48 kHz, the
    allpasses to 384 kHz, none at 768 kHz); the main path's push (480 000
    frames of 48 kHz stereo) in one launch against 100 launches of 4800
    frames with the state carried (outputs and state), and on its first
    FV_CHECK frames against the plain version; the kernel's own schedule
    (gst_freeverb_schedule) equal to its Python mirror at every rate; the
    VAD from VAD_P0 at VAD_LENGTHS, and on VAD_CHECK's streams over two
    pushes.  Returns {kernel: max abs error}."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch.ops import freeverb_kernel as fvk
    from gstreamer_tpu_torch.ops import vad_kernel as vk
    prm = fvk.params(0.6, 0.2, 1.0, 0.5)
    err = {"freeverb": 0.0, "vad_power": 0}

    def same(k, p, what):
        require(k.shape == p.shape and torch.equal(
            k.view(torch.int32), p.view(torch.int32)),
                f"freeverb: {what}: the kernel differs from its plain version")
        err["freeverb"] = max(err["freeverb"], float((k - p).abs().max()))

    paths = {}
    for rate in FV_RATES:
        sizes = fvk.ring_sizes(rate)
        for ch in (1, 2):
            kst = fvk.fresh_state(1, sizes, dev)
            pst = fvk.fresh_state(1, sizes, "cpu")
            for frames in (FV_CHECK, FV_ODD):
                x = torch.from_numpy((rng.standard_normal((1, frames, ch))
                                      * 0.3).astype(np.float32))
                same(fvk.freeverb(x.to(dev), kst, sizes, prm).cpu(),
                     fvk.freeverb_plain(x, pst, sizes, prm),
                     f"{rate} Hz, {ch} ch, {frames} frames")
            for key in ("rings", "idx", "fs"):
                require(torch.equal(kst[key].cpu(), pst[key]),
                        f"freeverb at {rate} Hz: state {key} differs")
        sc = fvk.schedule(sizes)
        require(fvk.kernel_schedule(sizes) == sc,
                f"freeverb at {rate} Hz: the kernel's schedule "
                f"{fvk.kernel_schedule(sizes)} differs from its mirror {sc}")
        paths[rate] = (f"block {sc['block']} lag {sc['lag']} chunk "
                       f"{sc['chunk']}, rings in shared memory: "
                       + ("all", "the allpasses", "none")[2 - sc["shared"]])
    sizes = fvk.ring_sizes(48000)
    x = torch.from_numpy((rng.standard_normal((1, 480000, 2)) * 0.3)
                         .astype(np.float32)).to(dev)
    one = fvk.fresh_state(1, sizes, dev)
    k = fvk.freeverb(x, one, sizes, prm)
    many = fvk.fresh_state(1, sizes, dev)
    parts = [fvk.freeverb(c.contiguous(), many, sizes, prm)
             for c in x.split(4800, dim=1)]
    bits = {"rings": torch.int32, "idx": torch.int32, "fs": torch.int32}
    require(len(parts) == 100 and torch.equal(
        k.view(torch.int32), torch.cat(parts, dim=1).view(torch.int32))
            and all(torch.equal(one[key].view(t), many[key].view(t))
                    for key, t in bits.items()),
            "freeverb: the main path's push in one launch differs from 100 "
            "launches of 4800 frames")
    p = fvk.freeverb_plain(x[:, :FV_CHECK].cpu(),
                           fvk.fresh_state(1, sizes, "cpu"), sizes, prm)
    same(k[:, :FV_CHECK].cpu(), p, "the main path's push")
    del x, k, parts
    for n in VAD_LENGTHS:
        xv = torch.from_numpy((rng.standard_normal((len(VAD_P0), n)) * 12000)
                              .astype(np.int16))
        xv[0, :3] = -32768
        p0 = torch.tensor(VAD_P0, dtype=torch.int64)
        pk = vk.vad_power(xv.to(dev), p0.to(dev)).cpu()
        err["vad_power"] = max(err["vad_power"], int(
            (pk - vk.vad_power_plain(xv, p0)).abs().max()))
    s, n = VAD_CHECK
    p0 = torch.tensor([0, 7, 123456789, 2**32], dtype=torch.int64)[:s]
    pk, pp = p0.to(dev), p0
    for _ in range(2):
        xv = torch.from_numpy((rng.standard_normal((s, n)) * 9000)
                              .astype(np.int16))
        pk = vk.vad_power(xv.to(dev), pk)
        pp = vk.vad_power_plain(xv, pp)
        torch.cuda.synchronize()
        err["vad_power"] = max(err["vad_power"],
                               int((pk.cpu() - pp).abs().max()))
    require(err["vad_power"] == 0, "vad_power: the kernel differs from its "
            "plain version")
    print(f"dsp kernel vs plain (bit for bit): {err}; freeverb at {FV_RATES} "
          f"Hz, mono and stereo, pushes of {FV_CHECK} and {FV_ODD} frames "
          f"(schedules: {paths}); the main path's 480000-frame push in one "
          f"launch == 100 launches of 4800 (outputs and state), == plain on "
          f"its first {FV_CHECK} frames; vad_power from {VAD_P0} at "
          f"{VAD_LENGTHS} samples, and on {s} streams, 2 pushes of {n} "
          f"samples")
    return err


def time_dsp_kernels(rng, dev):
    """Kernel, plain version (on the card) and bounds: a call's time back
    to back (``ms``: CUDA events, as every other kernel and the previous
    kernels are timed; the wrapper's host cost where it is longer) and the
    kernel's device time (``device_ms``: graph_ms); freeverb on one
    FV_CHECK-frame push of 48 kHz stereo (the check's shape; the plain
    version's loop makes the main path's push too long to time it) and on
    the main path's 480 000-frame push; the VAD on the voice path's
    960-sample push.  The roofline bound counts the samples in and out and
    the state read and written once; the latency bound the recursion's
    dependent chain at the card's maximum SM clock."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch.ops import freeverb_kernel as fvk
    from gstreamer_tpu_torch.ops import vad_kernel as vk
    clock = sm_clock_hz()
    prm = fvk.params(0.6, 0.2, 1.0, 0.5)
    sizes = fvk.ring_sizes(48000)
    state_bytes = (sum(sizes) + fvk.N_RINGS + fvk.N_COMBS) * 4
    out = {}
    for tag, frames, iters in (("4800", FV_CHECK, 20),
                               ("480000", 480000, 3)):
        x = torch.from_numpy((rng.standard_normal((1, frames, 2)) * 0.3)
                             .astype(np.float32)).to(dev)
        st = fvk.fresh_state(1, sizes, dev)
        ms = cuda_ms(lambda: fvk.freeverb(x, st, sizes, prm), iters, 1)
        device = graph_ms(lambda: fvk.freeverb(x, st, sizes, prm), iters)
        plain = None
        if frames == FV_CHECK:
            pst = fvk.fresh_state(1, sizes, dev)
            plain = cuda_ms(lambda: fvk.freeverb_plain(x, pst, sizes, prm),
                            1, 0)
        nbytes = frames * 2 * 4 * 2 + 2 * state_bytes
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = frames * FV_FLOPS / FP32_OPS_PER_S * 1e3
        out[("freeverb", tag)] = dict(
            ms=ms, device_ms=device, plain_ms=plain, library_ms=None,
            bound=((t_bytes, "bytes", f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")
                   if t_bytes >= t_ops else
                   (t_ops, "operations", "fp32 67 T ops/s")),
            latency_ms=frames * 2 * DEP_CYCLES / clock * 1e3)
    xv = torch.from_numpy((rng.standard_normal((1, 960)) * 9000)
                          .astype(np.int16)).to(dev)
    p0 = torch.zeros(1, dtype=torch.int64, device=dev)
    t_bytes = (960 * 2 + 16) / HBM_BYTES_PER_S * 1e3
    t_ops = 960 * VAD_OPS / INT32_OPS_PER_S * 1e3
    out[("vad_power", "960")] = dict(
        ms=cuda_ms(lambda: vk.vad_power(xv, p0), 50),
        device_ms=graph_ms(lambda: vk.vad_power(xv, p0), 50),
        plain_ms=cuda_ms(lambda: vk.vad_power_plain(xv, p0), 3, 1),
        library_ms=None,
        bound=((t_bytes, "bytes", f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")
               if t_bytes >= t_ops else
               (t_ops, "operations", "int32 33.5 T ops/s")),
        latency_ms=960 * VAD_CHAIN * DEP_CYCLES / clock * 1e3)
    for (kname, tag), t in out.items():
        plain = ("plain not timed at this shape" if t["plain_ms"] is None
                 else f"plain {t['plain_ms']:.4f} ms")
        print(f"time {kname} [{tag} frames a push]: kernel {t['ms']:.4f} ms "
              f"a call back to back (CUDA events; the previous kernel, so "
              f"timed: {PREVIOUS_MS[(kname, tag)]:.4f} ms), "
              f"{t['device_ms']:.4f} ms on the device (a CUDA graph of the "
              f"calls), {plain}, "
              f"bound {t['bound'][0]:.6f} ms ({t['bound'][1]}, "
              f"{t['bound'][2]}), latency bound {t['latency_ms']:.4f} ms (the "
              f"dependent chain, {DEP_CYCLES} cycles an operation at "
              f"{clock / 1e6:.0f} MHz; binds: "
              f"{'latency' if t['latency_ms'] > t['bound'][0] else 'roofline'}"
              f"); library: none (no single PyTorch call)")
        require(t["device_ms"] >= max(t["bound"][0], t["latency_ms"]),
                f"{kname}: {t['device_ms']:.4f} ms reads under its bound")
    return out


def top_device_items(prof, iters, n=6):
    """The n kernels with the most device time a step: (name, ms, calls a
    step)."""
    import torch
    per: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us, c = per.get(e.name, (0.0, 0))
            per[e.name] = (us + e.time_range.elapsed_us(), c + 1)
    ranked = sorted(per.items(), key=lambda kv: -kv[1][0])[:n]
    return [(k[:60], round(us / iters / 1e3, 4), round(c / iters, 2))
            for k, (us, c) in ranked]


def dsp_phase(seed, counters, dev):
    """The audio DSP family on the card.  Checks each recursion's kernel
    against its plain version (check_dsp_kernels) and times both
    (time_dsp_kernels); drives each of DSP_PATHS at full width with the
    launch counts zeroed just before it and read just after (music_master:
    48 kHz stereo F32, 3 pushes of 10 s, freeverb once a push; voice_chain:
    48 kHz mono S16, 250 pushes of 20 ms, the VAD once a push), printing
    frames/s on the host clock, device busy ms and idle share with the top
    device items, and peak memory; runs each path again with its check's
    short pushes on the card and the CPU (samples and bus messages equal);
    then each of the 31 factories alone over two pushes of DSP_ALONE frames
    (card equal to the CPU, freeverb's and the VAD's kernels launched once
    a push where they run, none elsewhere).  Returns ({kernel: launches},
    {kernel: max abs error}, {(kernel, shape): timings})."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.pipeline import State
    rng = np.random.default_rng(seed + 7)
    cuda = dev.type == "cuda"
    card = (smi_line() or "nvidia-smi printed nothing") if cuda \
        else "CPU rehearsal"
    err = check_dsp_kernels(rng, dev) if cuda else {}
    timings = time_dsp_kernels(rng, dev) if cuda else {}
    total = {k: 0 for k in counters}
    for name, (fmt, ch, chain, frames, pushes, kname, cframes,
               cpushes) in DSP_PATHS.items():
        desc = dsp_desc(fmt, ch, chain)
        arrays = dsp_signal(fmt, ch, frames, pushes, rng)
        bufs = on_device(dsp_bufs(arrays, frames), dev)
        base = 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        for c in counters.values():
            c.launches = 0
        pipe, outs, secs = drive_bufs(desc, bufs, dev, 1)
        counts = {k: c.launches for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated() - base if cuda else 0
        want = {k: pushes if k == kname else 0 for k in counters}
        require(counts == want, f"{name}: launches {counts}, want {want}")
        for k, v in counts.items():
            total[k] += v
        got = [s for o in outs for s in o]
        require(all(torch.isfinite(s.buffer.data.float()).all()
                    for s in got), f"{name}: non-finite output")
        out_frames = sum(int(s.buffer.data.shape[0]) for s in got)
        msgs = bus_messages(pipe)
        del outs, got, bufs, pipe
        # the card against the port's CPU path on short pushes
        short = dsp_bufs(dsp_signal(fmt, ch, cframes, cpushes, rng), cframes)
        cpipe, on_card, _ = drive_bufs(desc, on_device(short, dev), dev, 1)
        hpipe, on_cpu, _ = drive_bufs(desc, short, "cpu", 1)
        same_samples(on_card, on_cpu, name, dev)
        cmsgs, hmsgs = bus_messages(cpipe), bus_messages(hpipe)
        require(cmsgs == hmsgs, f"{name}: bus messages differ from the CPU "
                f"run")
        kept = sum(len(o) for o in on_card)
        print(f"dsp {name}: {pushes} pushes of {frames} frames, "
              f"{'fused' if cpipe._fused else 'per-element'}; launches "
              f"{ {k: v for k, v in counts.items() if v} }; {out_frames} "
              f"output frames, {len(msgs)} bus messages; CUDA == port CPU "
              f"path over {cpushes} pushes of {cframes} frames ({kept} "
              f"buffers kept, {len(cmsgs)} bus messages equal)")
        del on_card, on_cpu, cpipe, hpipe

        prof = parse_launch(desc, device=dev)
        prof.set_state(State.PLAYING)
        x = on_device(dsp_bufs(arrays[:1], frames), dev)[0]["data"]
        tick_no = [0]

        def tick():
            dur = frames * 10**9 // 48000
            prof.get_by_name("in").push_buffer(Buffer(
                data=x, pts=tick_no[0] * dur, duration=dur))
            tick_no[0] += 1
            prof.tick()
            drain(prof.get_by_name("out"))
        iters = 2 if frames > 10000 else 20
        if cuda:
            _, busy, idle, tr = device_time(tick, iters)
            top = top_device_items(tr, iters)
        else:
            busy, idle, top = 0.0, 1.0, []
        prof.set_state(State.NULL)
        timed = sum(secs[1:])
        print(f"e2e {name}: {frames * (pushes - 1) / timed:.1f} input "
              f"frames/s over pushes 2..{pushes} ({frames} frames a push, "
              f"{timed / (pushes - 1) * 1e3:.3f} ms a push on average, host "
              f"clock between synchronises); device busy {busy:.3f} ms a "
              f"push, idle share {idle:.3f}; top device items {top}; peak "
              f"device memory {peak / 2**20:.1f} MiB above the path's start "
              f"(its inputs included); {card}")
        del x, prof
        if cuda:
            torch.cuda.empty_cache()

    # -- each factory alone: the card's samples equal the CPU path's -------
    checked = []
    for chain, fmt, ch in DSP_FACTORIES:
        fname = chain.split()[0]
        desc = dsp_desc(fmt, ch, chain)
        arrays = dsp_signal(fmt, ch, DSP_ALONE, 2, rng)
        if fname == "rglimiter":
            arrays = [a * np.float32(2.0) for a in arrays]
        bufs = dsp_bufs(arrays, DSP_ALONE)
        for c in counters.values():
            c.launches = 0
        pipe, on_card, _ = drive_bufs(desc, on_device(bufs, dev), dev, 1)
        counts = {k: c.launches for k, c in counters.items() if c.launches}
        want = ({"freeverb": 2} if fname == "freeverb" else
                {"vad_power": 2} if fname == "removesilence" else {})
        require(counts == want or not cuda,
                f"{fname}: launches {counts}, want {want}")
        cpipe, on_cpu, _ = drive_bufs(desc, bufs, "cpu", 1)
        same_samples(on_card, on_cpu, fname, dev)
        require(bus_messages(pipe) == bus_messages(cpipe),
                f"{fname}: bus messages differ from the CPU run")
        checked.append(fname)
        del pipe, cpipe, on_card, on_cpu
    require(len(set(checked)) == 31, f"{len(set(checked))} factories checked")
    print(f"dsp each factory alone: CUDA == port CPU path (samples and bus "
          f"messages) over 2 pushes of {DSP_ALONE} frames, freeverb and "
          f"removesilence 2 launches of their kernel, none elsewhere, for "
          f"{checked}")
    return total, err, timings


# -- 13. the OpenCV family ------------------------------------------------------

CV_SEGMENT = (1920, 1080, 64, 4)        # width, height, batch, ticks
CV_STEREO = (1280, 720, 8, 3)
CV_BAND = 64                            # rows of the stereo CPU check
CV_CROP = 64                            # side of the segmentation CPU check
CV_EDGES = (1920, 1080, 32, 3)
CV_EDGE_CHAIN = "cvsmooth type=gaussian kernel-width=5 ! edgedetect"
CV_CHECK_FRAMES = 2                     # frames of the CPU checks
CV_ALONE = (96, 64, 2)                  # width, height, frames a factory
# awkward shapes of the kernel checks: (frames, H, W) with odd heights and
# widths that are no multiple of 32; (pairs, H, W) of the disparity
# kernel: H < 9, W < 16, one pixel, 257 columns (two levels of its W-scan),
# 4100 (three, a short H), heights that are no multiple of its 23-row
# strips, 640x480 and 1280x720 (the order of the integral image's adds
# decides the sums there)
CV_GMM_SHAPES = ((3, 37, 45), (5, 17, 33), (4, 1, 1), (2, 64, 96))
CV_DISP_SHAPES = ((2, 5, 20), (1, 1, 1), (2, 30, 7), (1, 12, 257),
                  (1, 3, 4100), (2, 50, 33), (1, 47, 70), (1, 480, 640),
                  (1, 720, 1280))
# float operations the mixture needs a pixel and frame, counted from
# csrc/gmm.cu, a fused multiply-add as two, a comparison or a division as
# one: for each of the five modes the distance 8, ownership 2, the match
# within Tb 2, the weight 4 and its liveness 1; the owned mode's update 13
# (one mode); the total 5, the normalisation 5, the heaviest mode's search
# 4 and its test 1.  The sorting network's 10 comparisons and the running
# sum's 14 run only where the heaviest mode holds less than 0.9001 of the
# weight and are not counted: a lower bound.
GMM_OPS = 5 * 17 + 13 + 5 + 5 + 5
# and the shadow test's, on a pixel-frame that matches no background mode
# (mog2 only), for each background mode; the heaviest live mode always is
# one, so at least once: three dot products 15, the ratio 2, the shadowed
# colour 6, the tests 6
GMM_SHADOW_OPS = 29
# dependent operations a frame on one pixel's chain through its carry (the
# distance, ownership, weight update, total, division, rank, running sum,
# background and shadow tests), counted from the source
GMM_CHAIN = 48
# operations a pixel and disparity of the fused disparity kernel: |L - R|
# 2, the column's sum 1, the W-scan's running sum and base 2, the box 3;
# then the semi-global pass 12 (the minimum's share, two neighbours, three
# minima, an add, a subtract, the argmin's share); and dependent operations
# a column on the pass's chain through prev (the warp minimum's redux, its
# key back to a float, m + P2, three minima, an add and a subtract), each
# counted at DEP_CYCLES (the redux takes longer: a lower bound)
DISP_OPS = 2 + 1 + 2 + 3 + 12
DISP_CHAIN = 9
CV_K = ((90.0, 0.0, 48.0), (0.0, 90.0, 32.0), (0.0, 0.0, 1.0))
CV_DIST = (-0.25, 0.08, 0.0, 0.0, 0.0)
CV_FACTORIES = (                 # (launch, input format; {t}: temp dir)
    ("cvdilate iterations=2", "RGB"), ("cverode", "GRAY8"),
    ("cvequalizehist", "GRAY8"), ("cvsobel", "RGB"), ("cvlaplace", "RGB"),
    ("cvsmooth type=bilateral color=30", "RGB"),
    ("edgedetect", "RGB"), ("skindetect", "RGB"),
    ("retinex method=multiscale", "RGB"),
    ("opencvtextoverlay text=tpu-media xpos=4 ypos=30", "RGB"),
    ("segmentation", "RGBA"), ("segmentation method=codebook", "RGBA"),
    ("motioncells gridx=4 gridy=4", "RGB"),
    ("templatematch template={t}/templ.png", "BGR"),
    ("cvtracker object-initial-x=30 object-initial-y=20 "
     "object-initial-width=16 object-initial-height=16", "RGB"),
    ("grabcut", "RGBA"), ("disparity", "RGB"),
    ("dewarp inner-radius=0.1 outer-radius=0.4", "RGBA"),
    ("cameraundistort settings=\"{settings}\"", "RGB"),
    ("cameracalibrate frame-count=1", "RGB"),
    ("facedetect profile={t}/cascade.xml min-neighbors=1 min-size-width=8 "
     "min-size-height=8", "RGB"),
    ("faceblur profile={t}/cascade.xml min-neighbors=1 min-size-width=8 "
     "min-size-height=8", "RGB"),
    ("handdetect profile-fist={t}/cascade.xml", "RGB"),
    ("faceoverlay profile={t}/cascade.xml min-neighbors=1 "
     "location={t}/overlay.png", "RGB"))
# an 8x8 Haar cascade of one stage that fires on bright square blobs (the
# one tests/test_opencv_camera.py writes): no published cascade is in the
# repository
CV_CASCADE = """<?xml version="1.0"?>
<opencv_storage><cascade type_id="opencv-cascade-classifier">
<stageType>BOOST</stageType><featureType>HAAR</featureType>
<height>8</height><width>8</width>
<stageParams><maxWeakCount>2</maxWeakCount></stageParams>
<featureParams><maxCatCount>0</maxCatCount></featureParams>
<stageNum>1</stageNum><stages><_><maxWeakCount>2</maxWeakCount>
<stageThreshold>1.5</stageThreshold><weakClassifiers>
<_><internalNodes>0 -1 0 2.0000000000000000e-01</internalNodes>
<leafValues>0. 1.</leafValues></_>
<_><internalNodes>0 -1 1 2.0000000000000000e-01</internalNodes>
<leafValues>0. 1.</leafValues></_></weakClassifiers></_></stages>
<features><_><rects><_>0 0 8 8 -1.</_><_>2 2 4 4 4.</_></rects>
<tilted>0</tilted></_><_><rects><_>0 2 8 4 -1.</_><_>2 2 4 4 2.</_></rects>
<tilted>0</tilted></_></features></cascade></opencv_storage>
"""


def cv_bits_equal(a, b) -> bool:
    """The same shape and bits (float32 compared as int32), on a's device."""
    import torch
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b.to(a.device))


def cv_scene(kind, n, h, w, rng):
    """Seeded (N, H, W) uint8 R, G, B planes for the mixture's checks:
    "noisy" (a background, noise, 10% outliers), "flat" (two levels in
    turns: spawned modes tie at alpha), "five" (seven colours at random:
    every pixel fills its five modes)."""
    import numpy as np
    import torch
    if kind == "flat":
        x = np.full((3, n, h, w), 100)
        x[:, ::3, :, : w // 2] = 180
    elif kind == "five":
        cols = rng.integers(0, 256, (7, 3))
        x = cols[rng.integers(0, 7, (n, h, w))].transpose(3, 0, 1, 2)
    else:
        x = (rng.integers(30, 220, (3, 1, h, w))
             + rng.normal(0, 8, (3, n, h, w))
             + (rng.random((3, n, h, w)) < 0.1)
             * rng.integers(0, 128, (3, n, h, w)))
    return [torch.from_numpy(np.clip(p, 0, 255).astype(np.uint8)) for p in x]


def cv_straddle(dev):
    """A 100x100 carry of five far-apart modes whose sorted weights' running
    sum reaches backgroundRatio within a few ulps after one update, and the
    frame that owns the fourth mode: the order of the sum's adds decides
    the mask."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    h = w = 100
    wt = np.empty((h, w, 5), np.float32)
    wt[..., 0] = 0.5 + rng.uniform(-1e-3, 1e-3, (h, w))
    wt[..., 1] = 0.25 + rng.uniform(-1e-3, 1e-3, (h, w))
    wt[..., 2] = (0.9 - wt[..., 0].astype(np.float64) - wt[..., 1]
                  + rng.uniform(-3e-6, 3e-6, (h, w)))
    wt[..., 3] = 0.06
    wt[..., 4] = 1 - wt[..., :4].sum(-1)
    means = np.array([[0, 0, 0], [250, 0, 0], [0, 250, 0], [0, 0, 250],
                      [250, 250, 0]], np.float32)
    carry = {"weight": wt, "mean": np.broadcast_to(means, (h, w, 5, 3)).copy(),
             "var": np.full((h, w, 5), 15.0, np.float32),
             "nmodes": np.full((h, w), 5, np.int32)}
    planes = [torch.full((1, h, w), v, dtype=torch.uint8, device=dev)
              for v in (0, 0, 250)]
    return {k: torch.from_numpy(v).to(dev) for k, v in carry.items()}, planes


def check_cv_kernels(rng, dev):
    """The two kernels against their plain versions on the same inputs (the
    plain version on the card too), bit for bit: the mixture at
    CV_GMM_SHAPES, both methods, the noisy, flat and five-mode scenes, the
    carry continued over three ticks, and the straddling carry; the fused
    disparity kernel from gray planes at CV_DISP_SHAPES, sgbm and sbm (the
    cost volume, the aggregated volume and the disparities it gives on
    request, and the disparities alone), and on a stereo image against
    the CPU path.  Returns {kernel: max abs error}."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch.ops import gmm_kernel as gk
    from gstreamer_tpu_torch.ops import sgbm_kernel as sk
    err = {"gmm": 0, "disparity": 0}
    cases = 0
    for n, h, w in CV_GMM_SHAPES:
        for method in ("mog2", "mog"):
            for kind in ("noisy", "flat", "five"):
                on = method == "mog2"
                alpha, act = gk.rates(0.05 if kind == "noisy" else 0.2, on)
                kc = {k: torch.from_numpy(v).to(dev)
                      for k, v in gk.init_carry(h, w).items()}
                pc = {k: v.clone() for k, v in kc.items()}
                for _ in range(3):
                    planes = [p.to(dev) for p in cv_scene(kind, n, h, w, rng)]
                    kc, km = gk.gmm(kc, *planes, alpha, act, on)
                    pc, pm = gk.gmm_plain(pc, *planes, alpha, act, on)
                    err["gmm"] = max(err["gmm"], int(
                        (km.int() - pm.int()).abs().max()))
                    require(cv_bits_equal(km, pm) and all(
                        cv_bits_equal(kc[k], pc[k]) for k in kc),
                            f"gmm: the kernel differs from its plain version "
                            f"({method}, {kind}, {(n, h, w)})")
                cases += 1
    carry, planes = cv_straddle(dev)
    alpha, act = gk.rates(1e-6, True)
    kc, km = gk.gmm(carry, *planes, alpha, act, True)
    pc, pm = gk.gmm_plain(carry, *planes, alpha, act, True)
    require(cv_bits_equal(km, pm) and all(cv_bits_equal(kc[k], pc[k])
                                          for k in kc)
            and bool((pm == 0).any()) and bool((pm != 0).any()),
            "gmm: the kernel differs at backgroundRatio")
    for pairs, h, w in CV_DISP_SHAPES:
        gl = torch.from_numpy(rng.integers(0, 256, (pairs, h, w),
                                           dtype=np.uint8))
        gr = torch.roll(gl, -5, -1) ^ torch.from_numpy(
            (rng.random((pairs, h, w)) < 0.1).astype(np.uint8))
        gl, gr = gl.to(dev), gr.to(dev)
        cost = sk.cost_volume(gl.float(), gr.float())
        for method in ("sgbm", "sbm"):
            disp, kc, ka = sk.disparity(gl, gr, method, want_volumes=True)
            vol = sk.sgbm_plain(cost) if method == "sgbm" else cost
            want = sk.first_argmin(vol)
            err["disparity"] = max(err["disparity"], int(
                (disp.int() - want.int()).abs().max()))
            require(cv_bits_equal(kc, cost)
                    and (ka is None) == (method == "sbm")
                    and (ka is None or cv_bits_equal(ka, vol))
                    and cv_bits_equal(disp, want)
                    and cv_bits_equal(sk.disparity(gl, gr, method)[0], want),
                    f"disparity: the kernel differs from its plain versions "
                    f"({method}, {(pairs, h, w)})")
    gl = torch.from_numpy(rng.integers(0, 256, (2, 37, 70), dtype=np.uint8))
    gr = torch.roll(gl, 3, -1)
    for method in ("sgbm", "sbm"):
        card = sk.disparity(gl.to(dev), gr.to(dev), method, want_volumes=True)
        cpu = sk.disparity(gl, gr, method, want_volumes=True)
        require(all((a is None and b is None) or cv_bits_equal(a, b)
                    for a, b in zip(card, cpu)),
                f"disparity ({method}): the card differs from the CPU path")
    print(f"cv kernel vs plain (bit for bit): {err}; gmm at {CV_GMM_SHAPES} "
          f"(frames, H, W), mog2 and mog, noisy / flat (tied spawns) / "
          f"five-mode scenes, the carry over 3 ticks ({cases} cases), and "
          f"at backgroundRatio; disparity at {CV_DISP_SHAPES} (pairs, H, W), "
          f"sgbm and sbm, cost volume, aggregated volume and disparities, "
          f"and on a 2x37x70 stereo image (== the CPU path)")
    return err


def cv_segment_frames(n, h, w, ticks, seed, dev):
    """Seeded RGBA ticks made on the device: a static textured background
    with sensor noise, a 240x240 box of its own colour moving 24 pixels a
    frame, and every other frame a shadow (0.7x) over a quarter of the
    picture."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    base = torch.randint(30, 220, (3, 1, h, w), generator=g, device=dev,
                         dtype=torch.int16).float()
    alpha = torch.full((n, h, w), 255, dtype=torch.uint8, device=dev)
    out = []
    for t in range(ticks):
        x = base + torch.randn((3, n, h, w), generator=g, device=dev) * 4
        for k in range(n):
            f = t * n + k
            x0 = (24 * f) % max(w - 240, 1)
            y0 = (7 * f) % max(h - 240, 1)
            x[:, k, y0:y0 + 240, x0:x0 + 240] = \
                torch.tensor([200.0, 40.0, 90.0], device=dev)[:, None, None]
        x[:, 1::2, h // 2:, w // 2:] *= 0.7
        p = x.round().clamp(0, 255).to(torch.uint8)
        out.append((p[0], p[1], p[2], alpha))
    return out


def cv_edge_frames(n, h, w, seed, dev):
    """Seeded RGB frames of a structured scene, made on the device: smooth
    colour ramps with a slow ripple, 48 discs and rectangles of their own
    colours (24 to 320 pixels across, a third of them thin bars) drifting
    up to 3 pixels a frame, a 3x3 blur for a lens' softness, and sensor
    noise of sigma 2."""
    import math

    import torch
    g = torch.Generator(device=dev).manual_seed(seed)

    def u(*shape):
        return torch.rand(shape, generator=g, device=dev)
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None] / h
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :] / w
    c = u(3, 4)[..., None, None]
    bg = (50 + 80 * c[:, 0] * xx + 80 * c[:, 1] * yy
          + 20 * torch.sin(2 * math.pi * (2 * c[:, 2] * xx
                                          + 2 * c[:, 3] * yy)))
    x = bg[:, None].repeat(1, n, 1, 1)
    shapes = []
    for i in range(48):
        size, aspect = 24 + 296 * float(u(1)) ** 2, float(u(1))
        sw, sh = ((size, max(3.0, 6 * aspect)) if i % 3 == 2
                  else (size, size * (0.5 + aspect)))
        shapes.append((i % 3 == 0, float(u(1)) * w, float(u(1)) * h, sw,
                       sh, (u(3) * 255)[:, None, None],
                       *(float(v) * 6 - 3 for v in u(2))))
    for k in range(n):
        for disc, cx, cy, sw, sh, col, vx, vy in shapes:
            cx, cy = cx + vx * k, cy + vy * k
            x0, x1 = max(int(cx - sw / 2), 0), min(int(cx + sw / 2) + 1, w)
            y0, y1 = max(int(cy - sh / 2), 0), min(int(cy + sh / 2) + 1, h)
            if x0 >= x1 or y0 >= y1:
                continue
            box = x[:, k, y0:y1, x0:x1]
            if disc:
                inside = (((yy[y0:y1] * h - cy) / (sh / 2)) ** 2
                          + ((xx[:, x0:x1] * w - cx) / (sw / 2)) ** 2) <= 1
                box.copy_(torch.where(inside, col, box))
            else:
                box.copy_(col.expand_as(box))
    x = torch.nn.functional.avg_pool2d(x.reshape(3 * n, 1, h, w), 3, 1, 1,
                                       count_include_pad=False)
    x = x.reshape(3, n, h, w) + torch.randn((3, n, h, w), generator=g,
                                           device=dev) * 2
    return tuple(x.round().clamp(0, 255).to(torch.uint8))


def stereo_frames(n, h, w, seed, dev):
    """A seeded stereo pair made on the device: a textured left view (a
    blurred noise field) and the right view shifted by a disparity that
    steps from 4 to 20 pixels down the frame, plus sensor noise."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    tex = torch.rand((3, n, 1, h, w + 48), generator=g, device=dev) * 255
    tex = torch.nn.functional.avg_pool2d(tex.flatten(0, 2), 5, 1, 2) \
        .reshape(3, n, h, w + 48)
    left = tex[..., 16:16 + w]
    right = torch.empty_like(left)
    for band in range(5):
        r0, r1 = band * h // 5, (band + 1) * h // 5
        d = 4 + 4 * band
        right[..., r0:r1, :] = tex[..., r0:r1, 16 + d:16 + d + w]
    right = right + torch.randn(right.shape, generator=g, device=dev) * 2
    u8 = [v.round().clamp(0, 255).to(torch.uint8) for v in (left, right)]
    return tuple(u8[0]), tuple(u8[1])


def disparity_plain(left, right, method):
    """disparity's output plane on the plain versions: the gray planes, the
    cost volume, the semi-global pass where sgbm, the first minimum, the
    reference's scale to 0..255."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch.ops import cv_kernels as cvk
    from gstreamer_tpu_torch.ops import sgbm_kernel as sk
    gl = cvk.rgb2gray_u8(torch, *left).to(torch.float32)
    gr = cvk.rgb2gray_u8(torch, *right).to(torch.float32)
    cost = sk.cost_volume(gl, gr)
    disp = sk.first_argmin(sk.sgbm_plain(cost) if method == "sgbm" else cost)
    step = float(np.float32(255.0 / (sk.NUM_DISP - 1)))
    return torch.clamp(disp.to(torch.float32) * step, 0, 255).to(torch.uint8)


def time_cv_kernels(carry, frames, gray, dev):
    """Each kernel at its main path's shape: a call back to back (CUDA
    events), the device time of a CUDA graph of calls, the plain version on
    the card, the roofline bound (inputs read once, outputs written once,
    at 3.35 TB/s, against the operations at the fp32 peak) and the latency
    bound (the dependent chain at DEP_CYCLES an operation and the card's
    maximum SM clock).  The mixture's operations count its shadow test on
    the share of pixel-frames that the timed call finds foreground; the
    disparity kernel's plain version is the cost volume, the pass and the
    argmin, and the plain cost volume alone (the part that ran in plain
    torch before the fusion) is timed too."""
    from gstreamer_tpu_torch.ops import gmm_kernel as gk
    from gstreamer_tpu_torch.ops import sgbm_kernel as sk
    clock = sm_clock_hz()
    alpha, act = gk.rates(0.01, True)
    r, g, b = frames[:3]
    n, h, w = r.shape
    px = h * w
    out = {}

    def gmm_call():
        return gk.gmm(carry, r, g, b, alpha, act, True)
    fg = float((gmm_call()[1] != 0).float().mean())
    nbytes = 4 * n * px + 2 * px * (gk.K * 5 * 4 + 4)
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = n * px * (GMM_OPS + GMM_SHADOW_OPS * fg) / FP32_OPS_PER_S * 1e3
    out[("gmm", "1080p64")] = dict(
        ms=cuda_ms(gmm_call, 5, 1), device_ms=graph_ms(gmm_call, 3),
        plain_ms=cuda_ms(lambda: gk.gmm_plain(carry, r, g, b, alpha, act,
                                              True), 1, 0),
        library_ms=None,
        bound=((t_b, "bytes", "3.35 TB/s") if t_b >= t_o
               else (t_o, "operations", "fp32 67 T ops/s")),
        terms=(f"bytes {t_b:.4f}, operations {t_o:.4f}: {GMM_OPS} + "
               f"{GMM_SHADOW_OPS} x foreground share {fg:.4f} a "
               "pixel-frame"),
        latency_ms=n * GMM_CHAIN * DEP_CYCLES / clock * 1e3)
    gl, gr = gray
    pairs, h, w = gl.shape

    def disp_call():
        return sk.disparity(gl, gr, "sgbm")

    def disp_plain():
        return sk.first_argmin(sk.sgbm_plain(sk.cost_volume(gl.float(),
                                                            gr.float())))
    nbytes = 3 * pairs * h * w
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = pairs * h * w * sk.NUM_DISP * DISP_OPS / FP32_OPS_PER_S * 1e3
    out[("disparity", "720p8")] = dict(
        ms=cuda_ms(disp_call, 10, 1), device_ms=graph_ms(disp_call, 5),
        plain_ms=cuda_ms(disp_plain, 1, 0),
        volume_plain_ms=cuda_ms(lambda: sk.cost_volume(gl.float(),
                                                       gr.float()), 3, 1),
        library_ms=None,
        bound=((t_b, "bytes", "3.35 TB/s") if t_b >= t_o
               else (t_o, "operations", "fp32 67 T ops/s")),
        terms=(f"bytes {t_b:.4f}, operations {t_o:.4f}: {DISP_OPS} a "
               f"pixel-disparity"),
        latency_ms=w * DISP_CHAIN * DEP_CYCLES / clock * 1e3)
    for (kname, tag), t in out.items():
        extra = (f"; the plain cost volume alone {t['volume_plain_ms']:.4f} "
                 f"ms" if "volume_plain_ms" in t else "")
        print(f"time {kname} [{tag}]: kernel {t['ms']:.4f} ms a call back to "
              f"back (CUDA events; the previous kernel, so timed: "
              f"{PREVIOUS_MS[(kname, tag)]:.4f} ms), {t['device_ms']:.4f} ms "
              f"on the device (a CUDA graph of the calls), plain "
              f"{t['plain_ms']:.4f} ms{extra}, bound "
              f"{t['bound'][0]:.4f} ms ({t['bound'][1]}, {t['bound'][2]}; "
              f"{t['terms']}), latency bound {t['latency_ms']:.4f} ms "
              f"({DEP_CYCLES} cycles an operation at {clock / 1e6:.0f} MHz; "
              f"binds: "
              f"{'latency' if t['latency_ms'] > t['bound'][0] else 'roofline'}"
              f"); library: none (no single PyTorch call)")
        require(t["device_ms"] >= max(t["bound"][0], t["latency_ms"]),
                f"{kname}: {t['device_ms']:.4f} ms reads under its bound")
    return out


def cv_step(pipe, pushes):
    """A tick of a started pipeline: one buffer into each appsrc of
    `pushes` ({name: planes}), the tick, the sink drained."""
    from gstreamer_tpu_torch.core.buffer import Buffer
    for name, planes in pushes.items():
        src = pipe.get_by_name(name)
        n = planes[0].shape[0]
        pts = getattr(src, "_cv_pts", 0)
        src.push_buffer(Buffer(data=planes, pts=pts, duration=DUR, batch=n))
        src._cv_pts = pts + n * DUR
    pipe.tick()
    return drain(pipe.get_by_name("out"))


@contextlib.contextmanager
def launch_spans(symbol, spans):
    """While the block runs, record a pair of CUDA events on the current
    stream around each call of the C entry point `symbol` (one kernel
    launch, ops/_build.py's `function`), into `spans`: a span is the
    kernel's device time and its launch's latency."""
    import torch
    from gstreamer_tpu_torch.ops import _build
    function = _build.function

    def timed_function(name, sym, signature):
        lib, fn = function(name, sym, signature)
        if sym != symbol:
            return lib, fn

        def timed(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            status = fn(*args)
            end.record()
            spans.append((start, end))
            return status
        return lib, timed

    _build.function = timed_function
    try:
        yield
    finally:
        _build.function = function


def cv_profile(desc, pushes, batch, dev, iters=2, kernel=None):
    """(wall ms, device busy ms, idle share, top items, kernel events,
    kernel ms) a tick (device_time) of a fresh pipeline fed `pushes` every
    tick.  With `kernel` = (C entry point, kernel symbol), the trace's
    events of that kernel are counted, and CUDA events around the entry
    point's calls in the traced ticks give its device ms a tick; the
    traced ticks must launch it once each."""
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.pipeline import State
    if dev.type != "cuda":
        return 0.0, 0.0, 1.0, [], 0, 0.0
    pipe = parse_launch(desc, batch=batch, device=dev)
    pipe.set_state(State.PLAYING)
    spans = []
    with (launch_spans(kernel[0], spans) if kernel
          else contextlib.nullcontext()):
        wall, busy, idle, tr = device_time(lambda: cv_step(pipe, pushes),
                                           iters)
    top = top_device_items(tr, iters)
    events, kernel_ms = 0, 0.0
    if kernel:
        require(len(spans) == 2 + iters,
                f"{kernel[0]}: {len(spans)} launches in 2 + {iters} ticks")
        events = sum(e.device_type == torch.autograd.DeviceType.CUDA
                     and kernel[1] in e.name for e in tr.events())
        kernel_ms = sum(a.elapsed_time(b) for a, b in spans[2:]) / iters
    pipe.set_state(State.NULL)
    return wall, busy, idle, top, events, kernel_ms


def traced_busy(wall, busy, idle, events, kernel_ms, symbol, cuda):
    """(busy ms, idle share, note) of a traced tick whose kernel is a ctypes
    launch of `symbol` (cv_profile's `kernel`): where the trace holds the
    kernel's events, its own union; where it holds none, the union of the
    trace's other device events plus the kernel's device time from the CUDA
    events around its launches (one stream: nothing overlaps; a span adds
    the launch's latency), so every path's busy counts the same work."""
    note = (f" (the trace's kernel events: {events}; CUDA events around the "
            f"traced ticks' launches of {symbol}: {kernel_ms:.3f} ms a tick)")
    if cuda and events == 0:
        require(kernel_ms > 0, f"{symbol}: no device time in a traced tick")
        busy += kernel_ms
        idle = max(0.0, 1.0 - busy / wall)
        note = (f" (the trace held no event of the kernel: busy is the "
                f"trace's other device time plus the CUDA events around the "
                f"traced ticks' launches of {symbol}, {kernel_ms:.3f} ms, "
                f"against the traced tick's {wall:.3f} ms)")
    return busy, idle, note


def cv_alone_inputs(fmt, w, h, n, rng):
    """Seeded frames for one factory alone: a noisy dark background with a
    bright 12x12 square moving 2 pixels a frame (what the synthetic cascade
    fires on, what the tracker follows, what moves for motioncells); an
    alpha plane of grabcut's seeds (background, probable foreground)."""
    import numpy as np
    planes = 1 if fmt == "GRAY8" else 4 if fmt == "RGBA" else 3
    x = np.clip(40 + rng.normal(0, 6, (planes, n, h, w)), 0, 255)
    for k in range(n):
        x[:3, k, 20:32, 30 + 2 * k:42 + 2 * k] = 250
    x = x.astype(np.uint8)
    if fmt == "RGBA":
        x[3] = 0
        x[3, :, 16:36, 26:50] = 3
    return tuple(x)


def cv_board(w, h, n):
    """n RGB frames of a fronto-parallel 9x6-corner chessboard."""
    import numpy as np
    sq = min(w // 12, h // 9)
    img = np.full((h, w), 255, np.uint8)
    for i in range(7):
        for j in range(10):
            if (i + j) % 2 == 0:
                img[sq + i * sq:sq + (i + 1) * sq,
                    sq + j * sq:sq + (j + 1) * sq] = 0
    return tuple(np.repeat(img[None, None], n, 1).repeat(3, 0))


def cv_factories_alone(counters, dev, rng, tmp):
    """Each of the 24 launch rows of CV_FACTORIES (the 23 factories,
    segmentation with two methods) on 2 frames at CV_ALONE's size on the card
    and on the CPU: samples and bus messages equal; the mixture's kernel
    launched once where segmentation runs mog2, the disparity kernel once
    where disparity runs, none elsewhere."""
    import numpy as np
    from gstreamer_tpu_torch.codecs.png import png_encode
    from gstreamer_tpu_torch.elements.opencv_camera import \
        serialize_undistort_settings
    w, h, n = CV_ALONE
    with open(os.path.join(tmp, "cascade.xml"), "w") as f:
        f.write(CV_CASCADE)
    ov = np.zeros((8, 8, 4), np.uint8)
    ov[..., 1] = ov[..., 3] = 255
    with open(os.path.join(tmp, "overlay.png"), "wb") as f:
        f.write(png_encode(ov, "RGBA"))
    templ = cv_alone_inputs("RGB", w, h, 1, np.random.default_rng(3))
    templ = np.stack([p[0, 16:36, 26:46] for p in templ], -1)
    with open(os.path.join(tmp, "templ.png"), "wb") as f:
        f.write(png_encode(np.ascontiguousarray(templ), "RGB"))
    settings = serialize_undistort_settings(
        np.asarray(CV_K), np.asarray(CV_DIST)).replace('"', '\\"')
    checked = []
    for chain, fmt in CV_FACTORIES:
        desc = chain.format(t=tmp, settings=settings)
        fname = desc.split()[0]
        caps = (f"video/x-raw,format={fmt},width={w},height={h},"
                "framerate=30/1")
        if fname == "disparity":
            full = (f"{desc} name=d ! appsink name=out appsrc name=l "
                    f"caps={caps} ! d.sink_left appsrc name=r caps={caps} "
                    "! d.sink_right")
            left = cv_alone_inputs(fmt, w, h, n, rng)
            ins = {"l": left, "r": tuple(np.roll(p, -3, -1) for p in left)}
        else:
            full = f"appsrc name=in caps={caps} ! {desc} ! appsink name=out"
            ins = {"in": (cv_board(w, h, n) if fname == "cameracalibrate"
                          else cv_alone_inputs(fmt, w, h, n, rng))}
        for c in counters.values():
            c.launches = 0
        card = {k: tuple(torch_to(p, dev) for p in v) for k, v in ins.items()}
        cpipe, on_card, _ = drive_multi(full, n, 1, card, dev)
        counts = {k: c.launches for k, c in counters.items() if c.launches}
        want = ({"gmm": 1} if desc.startswith("segmentation") and "codebook"
                not in desc else {"disparity": 1} if fname == "disparity"
                else {})
        require(counts == want or dev.type != "cuda",
                f"{fname}: launches {counts}, want {want}")
        hpipe, on_cpu, _ = drive_multi(full, n, 1, {
            k: tuple(torch_to(p, "cpu") for p in v) for k, v in ins.items()},
            "cpu")
        same_samples(on_card, on_cpu, fname, dev)
        require(bus_messages(cpipe) == bus_messages(hpipe),
                f"{fname}: bus messages differ from the CPU run")
        checked.append(fname)
    require(len(set(checked)) == 23, f"{len(set(checked))} factories checked")
    print(f"cv each factory alone: CUDA == port CPU path (samples and bus "
          f"messages) on {n} frames of {w}x{h}, gmm once for segmentation "
          f"(mog2), the disparity kernel once for disparity, no kernel "
          f"elsewhere, for "
          f"{checked}")


def torch_to(p, dev):
    import torch
    return torch.as_tensor(p).to(dev)


def cv_phase(seed, counters, dev):
    """The OpenCV family on the card.  Checks the mixture's and the fused
    disparity kernels against their plain versions (check_cv_kernels),
    then drives, each with the launch counts zeroed just before it and read
    just after:

    cv_segment  seeded RGBA 1920x1080 at batch 64, 4 ticks, through
                segmentation (mog2): the mixture's kernel once a tick; every
                tick's masks and carry equal the plain version's and, on a
                CV_CROP square, the CPU path's; mog and test-mode once each
    cv_stereo   a seeded 1280x720 stereo pair at batch 8, 3 ticks, through
                disparity (sgbm): the disparity kernel (cost volume, pass
                and argmin) once a tick; every tick's output equals the
                plain versions' and, on the first pair's top rows, the CPU
                path's; sbm once; the cost volume of a frame equals the
                CPU's
    cv_edges    seeded RGB 1920x1080 at batch 32 of a structured scene
                (cv_edge_frames), 3 ticks, through cvsmooth type=gaussian
                kernel-width=5 ! edgedetect: no kernel; the hysteresis'
                grows and host tests a tick and the share of edge pixels;
                the first 2 frames equal the CPU path's

    each with input frames/s on the host clock, device busy ms, idle share,
    top device items and peak memory; times both kernels
    (time_cv_kernels); then each factory alone (cv_factories_alone).
    Returns ({kernel: launches}, {kernel: max abs error}, {(kernel, shape):
    timings})."""
    import tempfile

    import numpy as np
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.pipeline import State
    from gstreamer_tpu_torch.ops import cv_kernels as cvk
    from gstreamer_tpu_torch.ops import gmm_kernel as gk
    from gstreamer_tpu_torch.ops import sgbm_kernel as sk
    rng = np.random.default_rng(seed + 15)
    cuda = dev.type == "cuda"
    card = (smi_line() or "nvidia-smi printed nothing") if cuda \
        else "CPU rehearsal"
    err = check_cv_kernels(rng, dev) if cuda else {}
    total = {k: 0 for k in counters}

    def start(what):
        for c in counters.values():
            c.launches = 0
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            return torch.cuda.memory_allocated()
        return 0

    def finish(what, want):
        counts = {k: c.launches for k, c in counters.items()}
        require(counts == {k: want.get(k, 0) for k in counters},
                f"{what}: launches {counts}, want {want}")
        for k, v in counts.items():
            total[k] += v
        return {k: v for k, v in counts.items() if v}

    def peak(base):
        return (torch.cuda.max_memory_allocated() - base) / 2**20 if cuda \
            else 0.0

    # -- cv_segment ------------------------------------------------------------
    w, h, n, ticks = CV_SEGMENT
    frames = cv_segment_frames(n, h, w, ticks, seed, dev)
    seg = (f"appsrc name=in caps=video/x-raw,format=RGBA,width={w},"
           f"height={h},framerate=30/1 ! segmentation name=seg {{}} ! "
           "appsink name=out")
    base = start("cv_segment")
    pipe = parse_launch(seg.format(""), batch=n, device=dev)
    pipe.set_state(State.PLAYING)
    outs, carries, secs = [], [], []
    for planes in frames:
        sync(dev)
        t0 = time.perf_counter()
        got = cv_step(pipe, {"in": planes})
        sync(dev)
        secs.append(time.perf_counter() - t0)
        outs.append(got)
        carries.append(pipe._elem_states["seg"])
    counts = finish("cv_segment", {"gmm": ticks})
    mem = peak(base)
    pipe.set_state(State.NULL)
    alpha, act = gk.rates(0.01, True)
    pc = {k: torch.from_numpy(v).to(dev)
          for k, v in gk.init_carry(h, w).items()}
    # the CPU path on a CV_CROP square across the shadowed quarter's corner
    # (each pixel's mixture is its own), its carry continued tick to tick
    ys = slice(h // 2 - CV_CROP // 2, h // 2 + CV_CROP // 2)
    xs = slice(w // 2 - CV_CROP // 2, w // 2 + CV_CROP // 2)
    cc = {k: torch.from_numpy(v)
          for k, v in gk.init_carry(CV_CROP, CV_CROP).items()}
    fg = []
    for t, planes in enumerate(frames):
        pc, pm = gk.gmm_plain(pc, *planes[:3], alpha, act, True)
        data = outs[t][0].buffer.data
        require(len(outs[t]) == 1 and cv_bits_equal(data[3], pm) and all(
            torch.equal(a, b) for a, b in zip(data[:3], planes[:3])),
                f"cv_segment: tick {t + 1}'s output differs from the plain "
                f"version")
        require(all(cv_bits_equal(carries[t][k], pc[k]) for k in pc),
                f"cv_segment: tick {t + 1}'s carry differs from the plain "
                f"version")
        cc, cm = gk.gmm_plain(cc, *(p[:, ys, xs].cpu() for p in planes[:3]),
                              alpha, act, True)
        require(torch.equal(data[3][:, ys, xs].cpu(), cm) and all(
            cv_bits_equal(carries[t][k][ys, xs].cpu(), cc[k]) for k in cc),
                f"cv_segment: tick {t + 1} differs from the CPU path")
        fg.append(round(float((pm != 0).float().mean()), 4))
    once = []
    for props, on in (("method=mog", False), ("test-mode=true", True)):
        _, o2, _ = drive_multi(seg.format(props), n, 1, {"in": frames[0]},
                               dev)
        init = {k: torch.from_numpy(v).to(dev)
                for k, v in gk.init_carry(h, w).items()}
        _, pm = gk.gmm_plain(init, *frames[0][:3], *gk.rates(0.01, on), on)
        want = (pm,) * 4 if props == "test-mode=true" \
            else tuple(frames[0][:3]) + (pm,)
        require(all(cv_bits_equal(a, b) for a, b in
                    zip(o2[0][0].buffer.data, want)),
                f"cv_segment {props}: differs from the plain version")
        once.append(props)
    seg_prof = cv_profile(seg.format(""), {"in": frames[0]}, n, dev,
                          kernel=("gst_gmm", "gmm_kernel"))
    seg_rate = (n * (ticks - 1) / sum(secs[1:]),
                sum(secs[1:]) / (ticks - 1) * 1e3, mem, counts, fg, once)
    carry, seg_frames = carries[-1], frames[0]
    del frames, outs, carries, pc, pipe

    # -- cv_stereo -------------------------------------------------------------
    w, h, n, ticks = CV_STEREO
    left, right = stereo_frames(n, h, w, seed, dev)
    caps = f"video/x-raw,format=RGB,width={w},height={h},framerate=30/1"
    stereo = (f"disparity name=d method={{}} ! appsink name=out appsrc name=l "
              f"caps={caps} ! d.sink_left appsrc name=r caps={caps} ! "
              "d.sink_right")
    base = start("cv_stereo")
    _, outs, secs = drive_multi(stereo.format("sgbm"), n, ticks,
                                {"l": left, "r": right}, dev)
    counts = finish("cv_stereo", {"disparity": ticks})
    mem = peak(base)
    gold = disparity_plain(left, right, "sgbm")
    # the CPU path on a band of the first pair: a row's output depends on
    # the rows within 4 of it, so the band's top CV_BAND - 4 rows are whole
    band = tuple(p[:1, :CV_BAND].cpu() for p in left), \
        tuple(p[:1, :CV_BAND].cpu() for p in right)
    cpu = disparity_plain(*band, "sgbm")[:, :CV_BAND - 4]
    require(len(outs) == ticks and all(
        len(o) == 1 and all(torch.equal(x, gold) for x in o[0].buffer.data)
        and torch.equal(o[0].buffer.data[0][:1, :CV_BAND - 4].cpu(), cpu)
        for o in outs), "cv_stereo: the output differs from the plain "
            "versions or the CPU path")
    _, o2, _ = drive_multi(stereo.format("sbm"), n, 1,
                           {"l": left, "r": right}, dev)
    require(all(torch.equal(x, disparity_plain(left, right, "sbm"))
                for x in o2[0][0].buffer.data),
            "cv_stereo sbm: differs from the plain version")
    gl = cvk.rgb2gray_u8(torch, *left)
    gr = cvk.rgb2gray_u8(torch, *right)
    require(cv_bits_equal(sk.cost_volume(gl[:1].float(), gr[:1].float()),
                          sk.cost_volume(gl[:1].cpu().float(),
                                         gr[:1].cpu().float())),
            "cv_stereo: the cost volume on the card differs from the CPU's")
    wall, busy, idle, top, events, kernel_ms = cv_profile(
        stereo.format("sgbm"), {"l": left, "r": right}, n, dev,
        kernel=("gst_disparity", "disparity_kernel"))
    busy, idle, note = traced_busy(wall, busy, idle, events, kernel_ms,
                                   "gst_disparity", cuda)
    timed = sum(secs[1:])
    hist = torch.bincount(gold.flatten().long(), minlength=256)
    print(f"cv_stereo: {ticks} ticks of {n} RGB {w}x{h} pairs, launches "
          f"{counts}; output == plain versions on every tick, and == the "
          f"CPU path on the first pair's top {CV_BAND - 4} rows (disparity "
          f"levels most used: {hist.topk(3).indices.tolist()}); sbm once == "
          f"plain; the cost volume of a frame == the CPU's")
    print(f"e2e cv_stereo: {n * (ticks - 1) / timed:.1f} input pairs/s over "
          f"ticks 2..{ticks} ({timed / (ticks - 1) * 1e3:.3f} ms a tick on "
          f"average); device busy {busy:.3f} ms a tick, idle share "
          f"{idle:.3f}{note}; top device items {top}; peak device memory "
          f"{mem:.1f} MiB above the path's start; {card}")
    stereo_gray = (gl, gr)
    del outs, gold

    # -- cv_edges --------------------------------------------------------------
    w, h, n, ticks = CV_EDGES
    planes = cv_edge_frames(n, h, w, seed + 1, dev)
    edges = (f"appsrc name=in caps=video/x-raw,format=RGB,width={w},"
             f"height={h},framerate=30/1 ! {CV_EDGE_CHAIN} ! appsink "
             "name=out")
    base = start("cv_edges")
    cvk.hysteresis_stats.update(grows=0, syncs=0)
    _, outs, secs = drive_multi(edges, n, ticks, {"in": planes}, dev)
    stats = dict(cvk.hysteresis_stats)
    finish("cv_edges", {})
    mem = peak(base)
    k = CV_CHECK_FRAMES
    _, cpu, _ = drive_multi(edges, k, 1, {"in": tuple(p[:k].cpu()
                                                      for p in planes)},
                            "cpu")
    require(all(torch.equal(a[:k].cpu(), b) for a, b in
                zip(outs[0][0].buffer.data, cpu[0][0].buffer.data)),
            "cv_edges: the card differs from the CPU path")
    _, busy, idle, top, _, _ = cv_profile(edges, {"in": planes}, n, dev)
    timed = sum(secs[1:])
    edge_share = float(torch.stack(outs[0][0].buffer.data).ne(0).any(0)
                       .float().mean())
    print(f"cv_edges: {ticks} ticks of {n} RGB {w}x{h} frames of a "
          f"structured scene, no kernel; hysteresis {stats['grows'] / ticks:.0f}"
          f" grows and {stats['syncs'] / ticks:.1f} host tests a tick "
          f"(batches of {cvk.HYSTERESIS_BATCH}); edge pixels (edgedetect's "
          f"masked output not 0) {edge_share:.4f} of the first tick's; the first {k} frames == "
          f"the CPU path")
    print(f"e2e cv_edges: {n * (ticks - 1) / timed:.1f} input frames/s over "
          f"ticks 2..{ticks} ({timed / (ticks - 1) * 1e3:.3f} ms a tick on "
          f"average); device busy {busy:.3f} ms a tick, idle share "
          f"{idle:.3f}; top device items {top}; peak device memory "
          f"{mem:.1f} MiB above the path's start; {card}")
    del outs, planes

    timings = (time_cv_kernels(carry, seg_frames, stereo_gray, dev) if cuda
               else {})
    del carry, seg_frames, stereo_gray
    w, h, n, ticks = CV_SEGMENT
    rate, tick_ms, mem, counts, fg, once = seg_rate
    wall, busy, idle, top, events, kernel_ms = seg_prof
    busy, idle, note = traced_busy(wall, busy, idle, events, kernel_ms,
                                   "gst_gmm", cuda)
    print(f"cv_segment: {ticks} ticks of {n} RGBA {w}x{h} frames, launches "
          f"{counts}; masks and carry == plain version on every tick, and "
          f"== the CPU path on a {CV_CROP}x{CV_CROP} crop (foreground share "
          f"{fg}); {once} once each == plain")
    print(f"e2e cv_segment: {rate:.1f} input frames/s over ticks 2..{ticks} "
          f"({tick_ms:.3f} ms a tick on average, host clock between "
          f"synchronises); device busy {busy:.3f} ms a tick, idle share "
          f"{idle:.3f}{note}; top device items {top}; peak device memory "
          f"{mem:.1f} MiB above the path's start (its inputs included); "
          f"{card}")
    with tempfile.TemporaryDirectory() as tmp:
        cv_factories_alone(counters, dev, rng, tmp)
    if cuda:
        torch.cuda.empty_cache()
    return total, err, timings


ML_DETECT = (1920, 1080, 16, 3)     # input width, height, batch, ticks
ML_SIDE = 640                       # the model's RGB input, letterboxed
ML_STRIDES = (8, 16, 32)            # 80^2 + 40^2 + 20^2 = 8400 cells
ML_CLASSES = 80                     # COCO's
ML_OBJECTS = 8                      # bright squares moving over a dark scene
ML_CHECK = 2                        # frames of the CPU check
ML_DESC = ("appsrc name=in caps=video/x-raw,format=I420,width={w},"
           "height={h},framerate=30/1 ! videoconvertscale ! video/x-raw,"
           "format=RGB,width={s},height={s} ! jaxinference model={m} ! "
           "yolov8tensordec name=dec ! ioutracker name=trk ! appsink name=out")
SMOOTH_RUN = (1920, 1080, 16, 3)
MIX_FRAMES = 480000                 # 10 s of 48 kHz a push
MIX_TICKS = 3
MIX_IN, MIX_OUT = 8, 2
ALONE_VIDEO = (64, 48, 2)           # width, height, frames of a factory alone
ALONE_AUDIO = 4800                  # frames a push of an audio factory alone
SLICE_FACTORIES = (
    "jaxinference", "yolov8tensordec", "ssdobjectdetector",
    "classifiertensordecoder", "ioutracker", "tensordecodebin",
    "objectdetectionoverlay", "yolo26tensordec", "yolosegv8tensordec",
    "yoloobbv8tensordec", "ultralightfacedetectortensordec",
    "segmentationoverlay", "insertbin", "testsrcbin", "rtponviftimestamp",
    "rtponvifparse", "facedetectortensordecoder", "smooth", "speed",
    "autovideosrc", "autoaudiosrc", "videoanalyse", "audiomixmatrix",
    "audiobuffersplit", "videoframe_audiolevel", "spanplc", "srtenc",
    "webvttenc", "audiochannelmix", "checksumsink", "videocodectestsink",
    "chopmydata", "errorignore", "debugspy", "fpsdisplaysink", "clockselect",
    "roundrobin", "videoparse", "audioparse", "autovideoflip",
    "videoframe-audiolevel", "simplevideomark", "simplevideomarkdetect",
    "iqa", "fieldanalysis", "interlace", "zebrastripe", "scenechange",
    "videodiff", "accurip", "imagefreeze", "webrtcechoprobe", "webrtcdsp")


def yolo_stand_in(seed):
    """A seeded stand-in for a YOLOv8 detector with COCO's 80 classes at
    ML_SIDE^2: frames (three uint8 planes R, G, B of (B, side, side)) ->
    float32 (B, 84, 8400), the published head's layout (xc, yc, w, h in
    pixels, then 80 class scores in [0, 1]; the stride-8 cells first).
    Each cell's mean colour (an exact integer sum, then one rounding)
    through a seeded 3 -> 84 map of multiplies and adds in separate ops, so
    the card and the CPU give the same bits.  The class scores are biased
    so that only bright stride-32 cells pass 0.25: a few dozen a frame."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    wc = rng.normal(0, 0.6, (ML_CLASSES, 3)).astype(np.float32)
    wb = rng.normal(0, 0.3, (4, 3)).astype(np.float32)
    consts = {}

    def level(x, s, dev):
        b, n = x.shape[0], ML_SIDE // s
        if (dev, s) not in consts:
            iy, ix = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
            consts[(dev, s)] = (
                torch.from_numpy(((ix.ravel() + 0.5) * s).astype(
                    np.float32)).to(dev),
                torch.from_numpy(((iy.ravel() + 0.5) * s).astype(
                    np.float32)).to(dev),
                torch.from_numpy(wc).to(dev)[None, :, :, None],
                torch.from_numpy(wb).to(dev)[None, :, :, None])
        cx, cy, wcd, wbd = consts[(dev, s)]
        c = x.view(b, 3, n, s, n, s).sum((3, 5), dtype=torch.int32)
        c = c.reshape(b, 3, 1, n * n).float() * (1.0 / (255 * s * s))
        bright = (c[:, 0] + c[:, 1] + c[:, 2]) * (1.0 / 3)      # (b, 1, n²)
        cls = wcd[:, :, 0] * c[:, 0] + wcd[:, :, 1] * c[:, 1]
        cls = cls + wcd[:, :, 2] * c[:, 2]                       # (b, 80, n²)
        z = cls * 2.0 + (bright - 0.3) * 10.0
        score = torch.clamp(z * 0.25 + (0.5 if s == 32 else -3.0), 0.0, 1.0)
        bx = wbd[:, :, 0] * c[:, 0] + wbd[:, :, 1] * c[:, 1]
        bx = bx + wbd[:, :, 2] * c[:, 2]                          # (b, 4, n²)
        box = torch.stack([cx + bx[:, 0] * (0.5 * s),
                           cy + bx[:, 1] * (0.5 * s),
                           (bx[:, 2] + 3.0) * s, (bx[:, 3] + 3.0) * s], 1)
        return torch.cat([box, score], 1)

    def model(frames):
        x = torch.stack(tuple(frames), 1)           # (B, 3, side, side)
        return torch.cat([level(x, s, x.device) for s in ML_STRIDES], 2)
    return model


def ml_frames(n, h, w, ticks, seed):
    """Host I420 ticks of n frames: a dark noisy scene (Y 16, the colour of
    the letterbox's borders after conversion) with ML_OBJECTS bright
    coloured squares of h/9 to h/5.4 (120 to 200 px at 1080p) moving 6 px a
    frame."""
    import numpy as np
    rng = np.random.default_rng(seed)
    side = rng.integers(h // 9, h * 5 // 27, ML_OBJECTS)
    room = np.array([w, h]) - side.max()
    pos = rng.uniform([0, 0], room, (ML_OBJECTS, 2))
    vel = rng.choice([-6, 6], (ML_OBJECTS, 2))
    col = rng.integers([120, 40, 40], [236, 216, 216], (ML_OBJECTS, 3))
    out = []
    for t in range(ticks):
        y = (16 + rng.integers(0, 4, (n, h, w))).astype(np.uint8)
        u = np.full((n, h // 2, w // 2), 128, np.uint8)
        v = u.copy()
        for k in range(n):
            f = t * n + k
            for o in range(ML_OBJECTS):
                x0, y0 = (pos[o] + vel[o] * f).astype(int) % room
                s, c0, c1 = side[o], x0 // 2, y0 // 2
                y[k, y0:y0 + s, x0:x0 + s] = col[o, 0]
                u[k, c1:c1 + s // 2, c0:c0 + s // 2] = col[o, 1]
                v[k, c1:c1 + s // 2, c0:c0 + s // 2] = col[o, 2]
        out.append((y, u, v))
    return out


def yolo_gold(t, thr=0.25, iou_thr=0.45, max_det=100):
    """A numpy decode of one frame's (84, N) tensor, written apart from the
    port's decoder: candidates whose best class passes `thr` (box from
    centre and size, in float32 as the tensor holds it), greedy IoU NMS in
    order of falling confidence (a stable sort: equal scores keep the
    cells' order).  Returns [(cls, x, y, w, h, conf)]."""
    import numpy as np
    scores = t[4:]
    conf, cls = scores.max(0), scores.argmax(0)
    idx = np.nonzero(conf >= thr)[0]
    idx = idx[np.argsort(-conf[idx], kind="stable")]
    x = t[0, idx] - t[2, idx] / 2
    y = t[1, idx] - t[3, idx] / 2
    w, h = t[2, idx], t[3, idx]
    kept = []
    for j in range(len(idx)):
        if len(kept) >= max_det:
            break
        ok = True
        for i in kept:
            ix = max(0.0, min(float(x[j]) + float(w[j]),
                              float(x[i]) + float(w[i]))
                     - max(float(x[j]), float(x[i])))
            iy = max(0.0, min(float(y[j]) + float(h[j]),
                              float(y[i]) + float(h[i]))
                     - max(float(y[j]), float(y[i])))
            inter = ix * iy
            union = (float(w[j]) * float(h[j]) + float(w[i]) * float(h[i])
                     - inter)
            if (inter / union if union > 0 else 0.0) >= iou_thr:
                ok = False
                break
        if ok:
            kept.append(j)
    return [(str(int(cls[idx[j]])), float(x[j]), float(y[j]), float(w[j]),
             float(h[j]), float(conf[idx[j]])) for j in kept]


def meta_rows(buf):
    """A buffer's analytics metas as plain data, by batch entry: each
    Mtd's kind and fields (a tensor by id and bytes, a mask by bytes), and
    the relation matrix."""
    import numpy as np
    from gstreamer_tpu_torch.analytics import relation_meta_of
    out = {}
    for k, rm in relation_meta_of(buf).items():
        rows = []
        for m in rm.iter_mtds():
            d = dict(vars(m))
            if d.get("tensor") is not None:
                t = d.pop("tensor")
                d["tensor"] = (t.id, t.numpy().tobytes())
            if d.get("mask") is not None:
                d["mask"] = np.asarray(d.pop("mask")).tobytes()
            rows.append((type(m).__name__, sorted(d.items())))
        out[k] = (rows, dict(rm._rel))
    return out


@contextlib.contextmanager
def host_clock(pipe, names, spent):
    """While the block runs, add the host seconds of each named element's
    host_process to `spent` ({name: seconds})."""
    saved = {}
    for name in names:
        e = pipe.get_by_name(name)
        saved[name] = e.host_process

        def timed(buf, fn=e.host_process, name=name):
            t0 = time.perf_counter()
            try:
                return fn(buf)
            finally:
                spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
        e.host_process = timed
    try:
        yield
    finally:
        for name, fn in saved.items():
            pipe.get_by_name(name).host_process = fn


def ml_detect(seed, dev, start, finish, peak):
    """The detection path at full width (ML_DESC): seeded 1080p I420 at
    batch 16 through the letterboxing converter to RGB 640x640, the
    stand-in model, yolov8tensordec and ioutracker.  Checks every frame's
    detections against yolo_gold on the model's host tensors, and the first
    ML_CHECK frames' metas (detections, order, track ids, relations,
    tensors) against the port's CPU run of the same string."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.analytics import (ObjectDetectionMtd, TensorMtd,
                                               TrackingMtd, relation_meta_of)
    from gstreamer_tpu_torch.core.pipeline import State
    from gstreamer_tpu_torch.elements.analytics_elements import \
        register_model
    w, h, n, ticks = ML_DETECT
    register_model("chip-yolo", yolo_stand_in(seed))
    desc = ML_DESC.format(w=w, h=h, s=ML_SIDE, m="chip-yolo")
    host = ml_frames(n, h, w, ticks, seed)
    frames = [tuple(torch_to(p, dev) for p in t) for t in host]
    base = start("ml_detect")
    pipe = parse_launch(desc, batch=n, device=dev)
    pipe.set_state(State.PLAYING)
    outs, secs, spent = [], [], {}
    with host_clock(pipe, ("dec", "trk"), spent):
        for planes in frames:
            sync(dev)
            t0 = time.perf_counter()
            outs.append(cv_step(pipe, {"in": planes}))
            sync(dev)
            secs.append(time.perf_counter() - t0)
    counts = finish("ml_detect", {})
    mem = peak(base)
    pipe.set_state(State.NULL)
    require([len(o) for o in outs] == [1] * ticks,
            f"ml_detect: samples per tick {[len(o) for o in outs]}")
    dets, ids = [], set()
    for tick in outs:
        buf = tick[0].buffer
        require(all(p.device.type == dev.type for p in buf.data)
                and [tuple(p.shape) for p in buf.data]
                == [(n, ML_SIDE, ML_SIDE)] * 3,
                "ml_detect: frames not on the card at 640x640")
        metas = relation_meta_of(buf)
        require(sorted(metas) == list(range(n)), "ml_detect: metas missing")
        for k in range(n):
            rm = metas[k]
            t = rm.iter_mtds(TensorMtd)[0].tensor.numpy()
            require(t.dtype == np.float32 and t.shape == (84, 8400)
                    and np.isfinite(t).all(), f"ml_detect: tensor {t.shape}")
            ods = rm.iter_mtds(ObjectDetectionMtd)
            got = [(o.label, o.x, o.y, o.w, o.h, o.confidence) for o in ods]
            require(got == yolo_gold(t),
                    "ml_detect: detections differ from the numpy decode of "
                    "the model's host tensor")
            trks = rm.iter_mtds(TrackingMtd)
            require(len(trks) == len(ods), "ml_detect: a detection untracked")
            ids.update(tr.track_id for tr in trks)
            dets.append(len(ods))
    cands = [int((t.max(0) >= 0.25).sum()) for t in (
        relation_meta_of(outs[0][0].buffer)[k].iter_mtds(TensorMtd)[0]
        .tensor.numpy()[4:] for k in range(n))]
    require(min(dets) >= 1 and 1 <= len(ids) <= sum(dets),
            f"ml_detect: detections a frame {dets}, track ids {sorted(ids)}")
    cpu = parse_launch(desc, batch=ML_CHECK, device="cpu")
    cpu.set_state(State.PLAYING)
    ref = cv_step(cpu, {"in": tuple(torch.from_numpy(p[:ML_CHECK])
                                    for p in host[0])})
    cpu.set_state(State.NULL)
    card = meta_rows(outs[0][0].buffer)
    require(meta_rows(ref[0].buffer) == {k: card[k] for k in range(ML_CHECK)},
            "ml_detect: the first frames' metas differ from the CPU run")
    for a, b in zip(outs[0][0].buffer.data, ref[0].buffer.data):
        require(torch.equal(a[:ML_CHECK].cpu(), b),
                "ml_detect: converted frames differ from the CPU run")
    wall = sum(secs[1:]) / max(1, ticks - 1)
    host_s = {k: v / ticks for k, v in spent.items()}
    # device time: a fresh pipeline, the first tick's frames every tick
    dpipe = parse_launch(desc, batch=n, device=dev)
    dpipe.set_state(State.PLAYING)
    if dev.type == "cuda":
        dwall, busy, idle, tr = device_time(
            lambda: cv_step(dpipe, {"in": frames[0]}), 2)
        top = top_device_items(tr, 2)
    else:
        dwall, busy, idle, top = 0.0, 0.0, 1.0, []
    dpipe.set_state(State.NULL)
    print(f"e2e ml_detect: {n / wall:.1f} input frames/s over ticks 2.."
          f"{ticks} ({w}x{h} I420, batch {n}; "
          f"{[round(s * 1e3, 3) for s in secs]} ms per tick, host clock "
          f"between synchronises); detections a frame {dets}; candidates "
          f"over 0.25 in the first tick's frames {cands}; track ids "
          f"{len(ids)}; first {ML_CHECK} frames' metas and converted planes "
          f"== the CPU run, every frame's detections == the numpy decode of "
          f"its host tensor; the host's share: decoder "
          f"{host_s.get('dec', 0.0) * 1e3:.3f} ms + tracker "
          f"{host_s.get('trk', 0.0) * 1e3:.3f} ms a tick, "
          f"{(host_s.get('dec', 0.0) + host_s.get('trk', 0.0)) / wall:.3f} "
          f"of the tick; traced tick {dwall:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {idle:.3f}; top device items {top}; "
          f"peak memory {mem:.1f} MiB; kernel launches {counts} (the "
          f"letterbox's converter route has no kernel)")
    return busy


def mix_run(desc, data, ticks, dev, matrix=None):
    """Push `ticks` copies of `data` ((frames, channels) at 48 kHz) through
    `desc` (appsrc in ... appsink out), audiomixmatrix 'mm' given `matrix`;
    returns (samples, seconds per tick)."""
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.pipeline import State
    pipe = parse_launch(desc, device=dev)
    if matrix is not None:
        pipe.get_by_name("mm").set_property("matrix", matrix)
    src, sink = pipe.get_by_name("in"), pipe.get_by_name("out")
    m = data.shape[0]
    for t in range(ticks):
        src.push_buffer(Buffer(data=data, pts=t * m * 10**9 // 48000,
                               duration=m * 10**9 // 48000))
    src.end_of_stream()
    pipe.set_state(State.PLAYING)
    outs, secs = [], []
    while True:
        sync(torch.device(dev))
        t0 = time.perf_counter()
        more = pipe.tick()
        sync(torch.device(dev))
        if not more:
            break
        secs.append(time.perf_counter() - t0)
        outs.extend(drain(sink))
    pipe.set_state(State.NULL)
    return outs, secs


def mix_paths(seed, dev, start, finish, peak):
    """audiomixmatrix (8 -> 2 channels, S16LE and F32LE) and
    audiochannelmix (F32LE stereo), MIX_TICKS pushes of 10 s of 48 kHz:
    every push equal to the port's CPU run, no kernel; frames/s, busy ms,
    idle share."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed + 17)
    matrix = rng.uniform(-1, 1, (MIX_OUT, MIX_IN)).tolist()
    src = ("appsrc name=in caps=audio/x-raw,format={fmt},rate=48000,"
           "channels={ch},layout=interleaved ! {chain} ! appsink name=out")
    rows = {
        "audiomixmatrix_s16": ("S16LE", MIX_IN, "audiomixmatrix name=mm "
                               f"in-channels={MIX_IN} "
                               f"out-channels={MIX_OUT}", matrix),
        "audiomixmatrix_f32": ("F32LE", MIX_IN, "audiomixmatrix name=mm "
                               f"in-channels={MIX_IN} "
                               f"out-channels={MIX_OUT}", matrix),
        "audiochannelmix_f32": ("F32LE", 2, "audiochannelmix "
                                "left-to-left=0.8 left-to-right=-0.35 "
                                "right-to-left=0.45 right-to-right=0.7",
                                None)}
    busy_of = {}
    for name, (fmt, ch, chain, mat) in rows.items():
        if fmt == "S16LE":
            x = rng.integers(-32768, 32768, (MIX_FRAMES, ch)).astype(np.int16)
        else:
            x = (rng.standard_normal((MIX_FRAMES, ch)) * 0.4).astype(
                np.float32)
        desc = src.format(fmt=fmt, ch=ch, chain=chain)
        base = start(name)
        outs, secs = mix_run(desc, torch_to(x, dev), MIX_TICKS, dev, mat)
        counts = finish(name, {})
        mem = peak(base)
        ref, _ = mix_run(desc, torch.from_numpy(x), MIX_TICKS, "cpu", mat)
        require(len(outs) == len(ref) == MIX_TICKS, f"{name}: samples")
        for o, r in zip(outs, ref):
            d = o.buffer.data
            require(d.device.type == dev.type and d.dtype == r.buffer.data.dtype
                    and tuple(d.shape) == (MIX_FRAMES, 2)
                    and torch.equal(d.cpu(), r.buffer.data),
                    f"{name}: the card's samples differ from the CPU run")
        if dev.type == "cuda":
            from gstreamer_tpu_torch import parse_launch
            from gstreamer_tpu_torch.core.buffer import Buffer
            from gstreamer_tpu_torch.core.pipeline import State
            pipe = parse_launch(desc, device=dev)
            if mat is not None:
                pipe.get_by_name("mm").set_property("matrix", mat)
            pipe.set_state(State.PLAYING)
            xs = torch_to(x, dev)
            pts = [0]

            def tick():
                pipe.get_by_name("in").push_buffer(Buffer(
                    data=xs, pts=pts[0], duration=10**10))
                pts[0] += 10**10
                pipe.tick()
                drain(pipe.get_by_name("out"))
            dwall, busy, idle, tr = device_time(tick, 3)
            top = top_device_items(tr, 3, 4)
            pipe.set_state(State.NULL)
        else:
            dwall, busy, idle, top = 0.0, 0.0, 1.0, []
        busy_of[name] = busy
        rate = MIX_FRAMES * (len(secs) - 1) / sum(secs[1:])
        print(f"e2e {name}: {rate:.1f} frames/s over pushes 2..{MIX_TICKS} "
              f"({ch} -> 2 channels, {fmt}, pushes of {MIX_FRAMES} frames, "
              f"{[round(s * 1e3, 3) for s in secs]} ms per push, host clock "
              f"between synchronises); == the CPU run on every push "
              f"(tolerance 0); "
              f"traced push {dwall:.3f} ms, device busy {busy:.3f} ms, idle "
              f"share {idle:.3f}; top device items {top}; peak memory "
              f"{mem:.1f} MiB; kernel launches {counts}")
    return busy_of


def smooth_path(seed, dev, start, finish, peak):
    """smooth (tolerance 8, filter-size 3: 63 offsets) on seeded 1080p I420
    at batch 16, 3 ticks: the luma byte for byte against the CPU run on
    ML_CHECK frames, the chroma unchanged; busy ms a tick and its top
    device items."""
    import numpy as np
    import torch
    w, h, n, ticks = SMOOTH_RUN
    rng = np.random.default_rng(seed + 16)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 60 * np.sin(xx / 37.0) * np.cos(yy / 23.0)
    y = np.clip(base[None] + rng.normal(0, 4, (n, h, w)), 0, 255).astype(
        np.uint8)
    host = (y, rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8),
            rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8))
    planes = tuple(torch_to(p, dev) for p in host)
    desc = (f"appsrc name=in caps=video/x-raw,format=I420,width={w},"
            f"height={h},framerate=30/1 ! smooth ! appsink name=out")
    base_mem = start("smooth")
    _, outs, secs = drive_multi(desc, n, ticks, {"in": planes}, dev)
    counts = finish("smooth", {})
    mem = peak(base_mem)
    _, ref, _ = drive_multi(desc, ML_CHECK, 1, {"in": tuple(
        torch.from_numpy(p[:ML_CHECK]) for p in host)}, "cpu")
    changed = 0
    for tick in outs:
        d = tick[0].buffer.data
        require(all(torch.equal(a[:ML_CHECK].cpu(), b) for a, b in
                    zip(d, ref[0][0].buffer.data)),
                "smooth: the card's planes differ from the CPU run")
        require(torch.equal(d[1], planes[1]) and torch.equal(d[2], planes[2]),
                "smooth: chroma changed")
        changed = int((d[0] != planes[0]).sum())
    if dev.type == "cuda":
        wall, busy, idle, top, _, _ = cv_profile(desc, {"in": planes}, n, dev)
    else:
        wall, busy, idle, top = 0.0, 0.0, 1.0, []
    print(f"e2e smooth: {n / (sum(secs[1:]) / max(1, ticks - 1)):.1f} input "
          f"frames/s over ticks 2..{ticks} ({w}x{h} I420, batch {n}; "
          f"{[round(s * 1e3, 3) for s in secs]} ms per tick); luma == the "
          f"CPU run on {ML_CHECK} frames (byte for byte), chroma unchanged, "
          f"{changed} luma bytes changed a tick; traced tick {wall:.3f} ms, "
          f"device busy {busy:.3f} ms, idle share {idle:.3f}; top device "
          f"items {top}; peak memory {mem:.1f} MiB; kernel launches {counts}")
    return busy


def alone_models(seed):
    """Seeded fixed tensors for the decoders alone, as models that put them
    beside the frames: {model name: fn(frames) -> tensor or dict}."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    w, h, n = ALONE_VIDEO

    def boxes_xywh(k, ncls, extra=0):
        t = np.concatenate([rng.uniform([0, 0, 4, 4], [w, h, 20, 20],
                                        (k, 4)).T,
                            rng.uniform(0, 0.8, (ncls + extra, k))])
        return t.astype(np.float32)
    fixed = {
        "alone-yolo": boxes_xywh(40, 3),
        "alone-cls": rng.normal(0, 2, 10).astype(np.float32),
        "alone-ssd": {"boxes": rng.uniform(0, 1, (20, 4)).astype(np.float32),
                      "scores": rng.uniform(0, 1, (20, 3)).astype(
                          np.float32)},
        "alone-y26": np.concatenate([
            rng.uniform(0, 40, (30, 2)), rng.uniform(40, 60, (30, 2)),
            rng.uniform(0, 1, (30, 1)), rng.integers(0, 4, (30, 1))],
            1).astype(np.float32),
        "alone-seg": {"output": boxes_xywh(20, 2, 3),
                      "protos": rng.normal(0, 1, (3, 12, 16)).astype(
                          np.float32)},
        "alone-obb": np.concatenate([boxes_xywh(20, 2), rng.uniform(
            -3, 3, (1, 20))]).astype(np.float32),
        "alone-face": {"boxes": rng.uniform(0, 1, (20, 4)).astype(
            np.float32), "scores": rng.uniform(0, 1, (20, 2)).astype(
                np.float32)},
        "alone-face2": {"boxes": rng.uniform(0, 1, (12, 4)).astype(
            np.float32), "scores": rng.uniform(0, 1, 12).astype(np.float32)}}

    def on(v, dev):
        if isinstance(v, dict):
            return {k: torch.from_numpy(a).to(dev) for k, a in v.items()}
        return torch.from_numpy(v).to(dev)
    return {k: (lambda frames, v=v: on(v, frames[0].device))
            for k, v in fixed.items()}


def alone_rows(tmp):
    """The launch strings that drive each factory of the slice alone or in
    a short chain, with their appsrcs' inputs: [(launch, {appsrc: kind})];
    `tmp` takes the files the subtitle encoders write."""
    w, h, _ = ALONE_VIDEO
    caps = {"I420": f"video/x-raw,format=I420,width={w},height={h},"
                    "framerate=30/1",
            "GRAY8": f"video/x-raw,format=GRAY8,width={w},height={h},"
                     "framerate=30/1",
            "S16LE": "audio/x-raw,format=S16LE,rate=48000,channels=2,"
                     "layout=interleaved",
            "F32LE": "audio/x-raw,format=F32LE,rate=48000,channels=2,"
                     "layout=interleaved",
            "S16LE44100": "audio/x-raw,format=S16LE,rate=44100,channels=2,"
                          "layout=interleaved",
            "S16LE16000": "audio/x-raw,format=S16LE,rate=16000,channels=1,"
                          "layout=interleaved",
            "bytes": "application/octet-stream", "rtp": "application/x-rtp",
            "text": "text/x-raw"}

    def src(kind, name="in"):
        return f"appsrc name={name} caps={caps[kind]}"

    def one(kind, chain):
        return (f"{src(kind)} ! {chain}", {"in": kind})
    return [
        one("I420", "jaxinference model=alone-yolo ! yolov8tensordec ! "
            "ioutracker ! objectdetectionoverlay ! appsink name=out"),
        one("I420", "jaxinference model=alone-cls ! classifiertensordecoder "
            "top-k=3 ! appsink name=out"),
        one("GRAY8", "jaxinference model=alone-yolo ! tensordecodebin ! "
            "appsink name=out"),
        one("I420", "jaxinference model=alone-ssd ! ssdobjectdetector ! "
            "appsink name=out"),
        one("I420", "jaxinference model=alone-y26 ! yolo26tensordec ! "
            "appsink name=out"),
        one("I420", "jaxinference model=alone-seg ! yolosegv8tensordec "
            "logits-tensor-id=protos ! segmentationoverlay ! "
            "appsink name=out"),
        one("I420", "jaxinference model=alone-obb ! yoloobbv8tensordec ! "
            "appsink name=out"),
        one("I420", "jaxinference model=alone-face ! "
            "ultralightfacedetectortensordec score-threshold=0.5 ! "
            "appsink name=out"),
        one("I420", "jaxinference model=alone-face2 ! "
            "facedetectortensordecoder ! appsink name=out"),
        one("I420", "insertbin ! smooth ! appsink name=out"),
        one("I420", "videoanalyse ! simplevideomark ! simplevideomarkdetect "
            "! appsink name=out"),
        one("I420", "fieldanalysis ! interlace ! appsink name=out"),
        one("I420", "zebrastripe threshold=40 ! scenechange ! videodiff ! "
            "appsink name=out"),
        one("I420", "imagefreeze ! autovideoflip ! errorignore ! "
            "clockselect ! debugspy ! appsink name=out"),
        one("I420", "fpsdisplaysink name=s"),
        one("I420", "videocodectestsink name=s"),
        (f"iqa name=q ! appsink name=out {src('I420', 'i0')} ! q.sink_0 "
         f"{src('I420', 'i1')} ! q.sink_1", {"i0": "I420", "i1": "I420"}),
        (f"videoframe_audiolevel name=q ! appsink name=out "
         f"{src('I420', 'i0')} ! q.video {src('S16LE', 'i1')} ! q.audio",
         {"i0": "I420", "i1": "S16LE"}),
        (f"autovideosrc num-buffers=2 ! video/x-raw,format=I420,width={w},"
         f"height={h} ! appsink name=out", {}),
        (f"testsrcbin stream=video num-buffers=2 ! video/x-raw,format=RGB,"
         f"width={w},height={h} ! appsink name=out", {}),
        ("autoaudiosrc num-buffers=2 samplesperbuffer=480 ! audio/x-raw,"
         "format=S16LE,rate=48000,channels=2 ! appsink name=out", {}),
        ("testsrcbin stream=audio num-buffers=2 ! audio/x-raw,format=F32LE,"
         "rate=48000,channels=1 ! appsink name=out", {}),
        one("S16LE", "speed speed=1.5 ! audiobuffersplit ! "
            "videoframe-audiolevel ! chopmydata ! checksumsink name=s"),
        one("S16LE", "audiomixmatrix mode=first-channels ! "
            "audio/x-raw,channels=1 ! spanplc ! appsink name=out"),
        one("F32LE", "audiochannelmix left-to-right=0.5 ! roundrobin name=r "
            "r.src_0 ! appsink name=out r.src_1 ! appsink name=out1"),
        one("S16LE44100", "accurip first-track=true last-track=true ! "
            "appsink name=out"),
        one("S16LE16000", "webrtcechoprobe ! webrtcdsp echo-cancel=false "
            "voice-detection=true ! appsink name=out"),
        one("bytes", "videoparse width=8 height=8 format=GRAY8 ! "
            "appsink name=out"),
        one("bytes", "audioparse num-channels=1 ! appsink name=out"),
        one("rtp", "rtponviftimestamp ntp-offset=1000 ! rtponvifparse ! "
            "appsink name=out"),
        one("text", f"srtenc location={tmp}/s.srt"),
        one("text", f"webvttenc location={tmp}/s.vtt"),
    ]


def analytics_inputs(kind, rng):
    """One source's pushes for a factory of the analytics slice alone: a list of Buffer kwargs
    (host data; the card run moves arrays to the card)."""
    import struct

    import numpy as np
    w, h, n = ALONE_VIDEO
    if kind in ("I420", "GRAY8"):
        shapes = [(n, h, w)] + ([(n, h // 2, w // 2)] * 2
                                if kind == "I420" else [])
        return [dict(data=tuple(rng.integers(0, 256, s, dtype=np.uint8)
                                for s in shapes), pts=t * n * DUR,
                     duration=DUR, batch=n) for t in range(2)]
    if kind.startswith(("S16LE", "F32LE")):
        rate = int(kind[5:] or 48000)
        ch = 1 if rate == 16000 else 2
        m = ALONE_AUDIO * rate // 48000
        out = []
        for t in range(2):
            x = (rng.standard_normal((m, ch)) * 0.3)
            x = (x * 32767).astype(np.int16) if kind.startswith("S16") \
                else x.astype(np.float32)
            out.append(dict(data=x, pts=t * m * 10**9 // rate,
                            duration=m * 10**9 // rate))
        return out
    if kind == "bytes":
        return [dict(data=rng.integers(0, 256, 4 * 64 + 12, dtype=np.uint8),
                     pts=0)]
    if kind == "rtp":
        return [dict(data=[struct.pack(">BBHII", 0x80, 0, k, 160 * k, 1)
                           + rng.bytes(32) for k in range(3)],
                     pts=t * 10**9) for t in range(2)]
    return [dict(data=f"cue {t}", pts=t * 10**9, duration=5 * 10**8)
            for t in range(2)]


def alone_run(desc, ins, dev, tmp):
    """Run a launch string on `dev`, each appsrc of `ins` ({name: Buffer
    kwargs}) fed its buffers (arrays on `dev`), to EOS.  Returns what can be
    compared between two runs: every appsink's samples (pts, batch, caps,
    data on the host, metas), the bus's element and tag messages, a sink's
    checksums and frame count, the files the sink wrote."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer, map_leaves
    from gstreamer_tpu_torch.core.pipeline import State
    w, h, n = ALONE_VIDEO
    pipe = parse_launch(desc, batch=n, device=dev)
    for name, bufs in ins.items():
        src = pipe.get_by_name(name)
        for b in bufs:
            src.push_buffer(Buffer(**dict(b, data=map_leaves(
                lambda x: torch_to(x, dev) if isinstance(x, np.ndarray)
                else x, b["data"]))))
        src.end_of_stream()
    pipe.set_state(State.PLAYING)
    got = {}
    while pipe.tick():
        for s in ("out", "out1"):
            sink = pipe.get_by_name(s)
            for x in drain(sink) if sink is not None else ():
                leaves = []
                map_leaves(leaves.append, x.buffer.data)
                require(all(not isinstance(v, torch.Tensor)
                            or v.device.type == torch.device(dev).type
                            for v in leaves), f"{desc}: data left {dev}")
                got.setdefault(s, []).append((
                    x.buffer.pts, x.buffer.batch, str(x.caps),
                    [v.cpu().numpy().tobytes() if isinstance(v, torch.Tensor)
                     else v for v in leaves], meta_rows(x.buffer)))
    pipe.set_state(State.NULL)
    sink = pipe.get_by_name("s")
    state = (getattr(sink, "checksums", None),
             getattr(sink, "frames_rendered", None)) if sink else None
    files = {}
    for f in sorted(os.listdir(tmp)):
        with open(os.path.join(tmp, f), "rb") as fh:
            files[f] = fh.read()
        os.remove(os.path.join(tmp, f))
    msgs = [(m.type, m.data) for m in iter(pipe.bus.pop, None)
            if m.type in ("element", "tag")]
    return got, msgs, state, files


def analytics_alone(seed, counters, dev):
    """Each of the 53 factories of the slice, alone or in a short chain, on
    small inputs (alone_rows) on the card and on the CPU: the samples,
    metas, bus messages, sink state and written files equal; no kernel
    launched on the card."""
    import re
    import tempfile

    import numpy as np
    from gstreamer_tpu_torch.core.element import list_factories
    from gstreamer_tpu_torch.elements.analytics_elements import \
        register_model
    for name, fn in alone_models(seed).items():
        register_model(name, fn)
    seen = set()
    with tempfile.TemporaryDirectory() as tmp:
        rows = alone_rows(tmp)
        for k, (desc, kinds) in enumerate(rows):
            rng = np.random.default_rng(seed + k)
            ins = {name: analytics_inputs(kind, rng)
                   for name, kind in kinds.items()}
            for c in counters.values():
                c.launches = 0
            card = alone_run(desc, ins, dev, tmp)
            counts = {k2: c.launches for k2, c in counters.items()
                      if c.launches}
            require(counts == {} or dev.type != "cuda",
                    f"{desc}: launches {counts}")
            cpu = alone_run(desc, ins, "cpu", tmp)
            require(card == cpu, f"{desc}: the card's run differs from the "
                    "CPU's")
            require(any(card[0].values()) or card[2] or card[3],
                    f"{desc}: nothing came out")
            seen.update(re.findall(r"(?:^|! )([a-z0-9_-]+)", desc))
            seen.update(re.findall(r"^(\w+) name=", desc))
    mine = set(SLICE_FACTORIES)
    require(len(mine) == 53 and mine <= set(list_factories()),
            "the slice's factory list")
    require(mine <= seen, f"factories not driven alone: {mine - seen}")
    w, h, n = ALONE_VIDEO
    print(f"analytics each factory alone: CUDA == port CPU path (samples, "
          f"metas, bus messages, sink state, written files) for the "
          f"{len(mine)} factories in {len(rows)} launch strings on {n} "
          f"frames of {w}x{h} or pushes of {ALONE_AUDIO} frames; no kernel "
          f"launched")


def analytics_phase(seed, counters, dev):
    """The analytics path and the last device elements on the card, each
    with the launch counts zeroed just before it and read just after (none
    of the ten kernels is on these paths):

    ml_detect        seeded 1920x1080 I420 at batch 16, 3 ticks, through
                     videoconvertscale (letterbox) ! RGB 640x640 !
                     jaxinference (yolo_stand_in: float32 (16, 84, 8400) a
                     tick on the card) ! yolov8tensordec ! ioutracker: every
                     frame's detections equal a numpy decode of its host
                     tensor, the first 2 frames' metas the CPU run's
    smooth           seeded 1080p I420 at batch 16, 3 ticks: the luma byte
                     for byte the CPU run's on 2 frames
    audiomixmatrix_s16 / _f32, audiochannelmix_f32  10 s pushes of 48 kHz:
                     every push the CPU run's, tolerance 0

    each with frames/s, device busy ms, idle share, top device items and
    peak memory; then each factory alone (analytics_alone).  Returns
    {kernel: launches}."""
    import torch
    cuda = dev.type == "cuda"
    total = {k: 0 for k in counters}

    def start(what):
        for c in counters.values():
            c.launches = 0
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            return torch.cuda.memory_allocated()
        return 0

    def finish(what, want):
        counts = {k: c.launches for k, c in counters.items()}
        require(counts == {k: want.get(k, 0) for k in counters},
                f"{what}: launches {counts}, want {want}")
        for k, v in counts.items():
            total[k] += v
        return {k: v for k, v in counts.items() if v}

    def peak(base):
        return (torch.cuda.max_memory_allocated() - base) / 2**20 if cuda \
            else 0.0

    ml_detect(seed, dev, start, finish, peak)
    smooth_path(seed, dev, start, finish, peak)
    mix_paths(seed, dev, start, finish, peak)
    analytics_alone(seed, counters, dev)
    return total


# -- the broadcast, subtitle, scope and file host modules -----------------

CAPTIONS_SD = (720, 486, 30, 3)     # NTSC SD: width, height, batch, ticks
CAPTIONS_DESC = (
    "cccombiner name=c appsrc name=in caps=video/x-raw,format=I420,"
    "width={w},height={h},framerate=30000/1001 ! timecodestamper ! c.sink "
    "appsrc name=cap caps=closedcaption/x-cea-608,format=raw,"
    "framerate=30000/1001 ! c.caption c. ! line21encoder ! line21decoder ! "
    "ccextractor name=x x.src ! appsink name=out x.caption_0 ! ccconverter "
    "! closedcaption/x-cea-708,format=cdp ! ccconverter ! "
    "closedcaption/x-cea-608,format=raw ! appsink name=cc")
SUBTITLES_HD = (1920, 1080, 16, 3)
SUB_CHECK = 2                       # frames a tick held to the CPU run
DVB_REGION = (320, 64, 800, 960)    # the AYUV subpicture: w, h, x, y
SUB_DESC = {
    "assrender": ("assrender name=ov ! appsink name=out appsrc name=v "
                  "caps=video/x-raw,format=I420,width={w},height={h},"
                  "framerate=30/1 ! ov.video appsrc name=t "
                  "caps=application/x-ass ! ov.text"),
    "dvbsub": ("dvbsuboverlay name=ov ! appsink name=out appsrc name=v "
               "caps=video/x-raw,format=I420,width={w},height={h},"
               "framerate=30/1 ! ov.video appsrc name=t caps=video/x-raw,"
               "format=AYUV,width={sw},height={sh},framerate=30/1 ! "
               "dvbsubenc x={sx} y={sy} ! ov.text")}
ASS_HEADER = """[Script Info]
PlayResX: 1920
PlayResY: 1080

[V4+ Styles]
Format: Name, Fontname, Fontsize, PrimaryColour, Bold, Italic, Underline, Alignment, MarginL, MarginR, MarginV
Style: Default,DejaVu Sans,48,&H00FFFFFF,0,0,0,2,10,10,40
Style: Sign,DejaVu Sans,40,&H0000FFFF,1,1,0,8,10,10,30

[Events]
Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV, Effect, Text
"""
SCOPES_HD = (1920, 1080, 30)        # the scopes' frames: w, h, framerate
SCOPE_RATE, SCOPE_PUSHES = 48000, 3  # pushes of 1 s of 48 kHz stereo S16
SCOPES = ("wavescope", "spectrascope", "spacescope", "synaescope")
SCOPE_DESC = ("appsrc name=in caps=audio/x-raw,format=S16LE,rate={rate},"
              "channels=2,layout=interleaved ! {scope} ! {caps}tee name=t "
              "t. ! videoconvertscale ! video/x-raw,format=I420 ! appsink "
              "name=out t. ! appsink name=raw")
WAV_SECONDS = 10                    # the ASR file: 48 kHz stereo S16LE
ASR_CHAIN = ("audioconvert ! audio/x-raw,channels=1 ! audioresample ! "
             "audio/x-raw,rate=16000 ! audioconvert ! "
             "audio/x-raw,format=F32LE ! appsink name=out")
BC_ALONE = (64, 48, 2)              # width, height, frames of a factory alone
BROADCAST_FACTORIES = (
    "ccconverter", "cccombiner", "ccextractor", "cea608mux", "line21encoder",
    "line21decoder", "h264ccinserter", "h264ccextractor", "h265ccinserter",
    "h265ccextractor", "alpha_combine", "alphacombine", "h264seiinserter",
    "h265seiinserter", "timecodestamper", "avwait", "h264timestamper",
    "h265timestamper", "combdetect", "ivtc", "compare", "audiolatency",
    "assrender", "dvbsubenc", "dvbsuboverlay", "dvdlpcmdec", "dvdsubdec",
    "dvdspu", "dvdsubparse", "wavescope", "spectrascope", "spacescope",
    "synaescope", "monoscope", "goom2k1", "intervideosink", "intervideosrc",
    "interaudiosink", "interaudiosrc", "intersubsink", "intersubsrc", "netsim",
    "videosegmentclip", "audiosegmentclip", "wavparse", "wavenc", "pnmenc",
    "pnmdec", "auparse", "auenc", "aiffmux", "aiffparse", "adpcmenc",
    "adpcmdec", "gdppay", "gdpdepay", "ipcpipelinesink", "ipcpipelinesrc",
    "ipcslavepipeline", "aspectratiocrop", "imagesequencesrc", "pushfilesrc",
    "splitfilesrc", "rndbuffersize", "capsdebug", "testsink", "navseek",
    "navigationtest")


@contextlib.contextmanager
def copy_meter(counts):
    """While the block runs, add to counts["d2h"] the bytes of every card
    tensor copied to the host (Tensor.cpu) and to counts["h2d"] those of
    every host tensor copied to the card (Tensor.to: the staging of source
    arrays and the host elements' uploads)."""
    import torch
    cpu, to = torch.Tensor.cpu, torch.Tensor.to

    def metered_cpu(self, *a, **k):
        if self.is_cuda:
            counts["d2h"] += self.numel() * self.element_size()
        return cpu(self, *a, **k)

    def metered_to(self, *a, **k):
        out = to(self, *a, **k)
        if not self.is_cuda and out.is_cuda:
            counts["h2d"] += out.numel() * out.element_size()
        return out
    torch.Tensor.cpu, torch.Tensor.to = metered_cpu, metered_to
    try:
        yield counts
    finally:
        torch.Tensor.cpu, torch.Tensor.to = cpu, to


@contextlib.contextmanager
def host_spent(pipe, spent):
    """While the block runs, add to spent[name] the host seconds of each
    host element's host_process / host_aggregate and each sink's render."""
    from gstreamer_tpu_torch.core.element import SinkElement
    saved = []
    for e in pipe.iterate_elements():
        for attr in ("host_process", "host_aggregate", "render"):
            if attr == "render" and not isinstance(e, SinkElement):
                continue
            if attr != "render" and e not in pipe._host_elems:
                continue
            fn = getattr(e, attr, None)
            if fn is None:
                continue

            def timed(*a, fn=fn, name=(e.FACTORY if e.name.startswith(
                      e.FACTORY) else e.name)):
                t0 = time.perf_counter()
                try:
                    return fn(*a)
                finally:
                    spent[name] = spent.get(name, 0.0) \
                        + time.perf_counter() - t0
            saved.append((e, attr, fn))
            setattr(e, attr, timed)
    try:
        yield spent
    finally:
        for e, attr, fn in saved:
            setattr(e, attr, fn)


def union_busy(prof):
    """The union of a profiler's device intervals, in ms."""
    import torch
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, reach = 0.0, float("-inf")
    for start, end in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return busy_us / 1e3


def bc_path(name, pipe, ticks, dev, start, finish, peak, frames_of,
            sinks=("out",)):
    """Drive a started pipeline tick by tick (`ticks`: a callable per tick
    that pushes its inputs), the launch counts zeroed just before and read
    just after, under torch.profiler on a card.  Returns the sinks' samples
    and the path's numbers: frames/s over ticks 2.. (all when one), device
    busy ms and idle share a tick, the host elements' share of the tick,
    bytes copied D2H and H2D a tick, peak memory."""
    import contextlib as cl

    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = dev.type == "cuda"
    base = start(name)
    samples = {s: [] for s in sinks}
    secs, spent, counts = [], {}, {"d2h": 0, "h2d": 0}
    prof_cm = (profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
               if cuda else cl.nullcontext())
    with prof_cm as prof, host_spent(pipe, spent), copy_meter(counts):
        for push in ticks:
            sync(dev)
            t0 = time.perf_counter()
            push()
            pipe.tick()
            for s in sinks:
                samples[s] += drain(pipe.get_by_name(s))
            sync(dev)
            secs.append(time.perf_counter() - t0)
    launches = finish(name, {})
    mem = peak(base)
    n = len(secs)
    timed = secs[1:] if n > 1 else secs
    frames = frames_of(samples)
    fps = (frames * (len(timed) / n)) / sum(timed) if sum(timed) else 0.0
    busy = union_busy(prof) / n if cuda else 0.0
    wall = sum(secs) / n * 1e3
    host = sum(spent.values()) / n * 1e3
    numbers = dict(fps=fps, wall=wall, busy=busy,
                   idle=max(0.0, 1.0 - busy / wall) if wall else 1.0,
                   host=host, host_share=host / wall if wall else 0.0,
                   d2h=counts["d2h"] / n, h2d=counts["h2d"] / n, mem=mem,
                   secs=[round(s * 1e3, 3) for s in secs],
                   spent={k: round(v / n * 1e3, 3) for k, v in spent.items()},
                   launches=launches)
    return samples, numbers


def bc_report(name, what, r):
    print(f"e2e {name}: {r['fps']:.1f} {what} over ticks 2..{len(r['secs'])}"
          f" ({r['secs']} ms per tick, host clock between synchronises); "
          f"device busy {r['busy']:.3f} ms and idle share {r['idle']:.3f} of "
          f"a {r['wall']:.3f} ms tick (traced); the host elements "
          f"{r['host']:.3f} ms a tick ({r['host_share']:.3f} of it: "
          f"{r['spent']}); copied {r['d2h'] / 2**20:.3f} MiB D2H and "
          f"{r['h2d'] / 2**20:.3f} MiB H2D a tick; peak memory "
          f"{r['mem']:.1f} MiB; kernel launches {r['launches']}")


def bc_frames(n, h, w, seed, dev=None):
    """Seeded I420 planes of n frames (on `dev` when given)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    host = tuple(rng.integers(0, 256, (n,) + s, dtype=np.uint8)
                 for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
    return host if dev is None else tuple(torch.from_numpy(p).to(dev)
                                          for p in host)


def captions_sd(seed, dev, start, finish, peak):
    """captions_sd: NTSC SD line 21 with timecodes (CAPTIONS_DESC): seeded
    720x486 I420 at 30000/1001, batch 30, 3 ticks, one seeded CEA-608 pair
    a frame from its appsrc (host bytes, unstaged).  Every frame's decoded
    pair equals the pushed one, the caption branch through CDP and back
    too; the timecodes, the caption samples and every frame's bytes equal
    the CPU run's; the rows under line 21 are the input's."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.pipeline import State
    w, h, n, ticks = CAPTIONS_SD
    desc = CAPTIONS_DESC.format(w=w, h=h)
    rng = np.random.default_rng(seed)
    dur = 1_000_000_000 * 1001 // 30000
    host = [bc_frames(n, h, w, seed + t) for t in range(ticks)]
    pairs = [[bytes(rng.integers(0, 128, 2, dtype=np.uint8) | 0x80)
              for _ in range(n)] for _ in range(ticks)]

    def run(d, cut=None):
        pipe = parse_launch(desc, batch=n, device=d)
        pipe.set_state(State.PLAYING)
        require(pipe.get_by_name("cap") in pipe._host_fed
                and pipe.get_by_name("in") not in pipe._host_fed,
                "captions_sd: the caption bytes were staged or the video "
                "was not")
        # the frames on the device before the timed ticks, as a camera's
        # decoder would leave them
        on = [tuple(torch.from_numpy(p[:cut]).to(d) for p in host[t])
              for t in range(ticks)]
        sync(d)

        def tick(t):
            def push():
                planes = on[t]
                m = planes[0].shape[0]
                pipe.get_by_name("in").push_buffer(Buffer(
                    data=planes, pts=t * n * dur, duration=dur, batch=m))
                pipe.get_by_name("cap").push_buffer(Buffer(
                    data=[np.frombuffer(b, np.uint8) for b in pairs[t][:m]],
                    pts=t * n * dur, duration=dur, batch=m))
            return push
        return pipe, [tick(t) for t in range(ticks)]
    pipe, pushes = run(dev)
    out, r = bc_path("captions_sd", pipe, pushes, dev, start, finish, peak,
                     lambda s: sum(x.buffer.batch for x in s["out"]),
                     sinks=("out", "cc"))
    pipe.set_state(State.NULL)
    cpu, cpushes = run(torch.device("cpu"))
    ref = {"out": [], "cc": []}
    for push in cpushes:
        push()
        cpu.tick()
        for s in ref:
            ref[s] += drain(cpu.get_by_name(s))
    cpu.set_state(State.NULL)
    require(len(out["out"]) == len(ref["out"]) == ticks
            and len(out["cc"]) == ticks, "captions_sd: samples per tick")
    for t in range(ticks):
        o, c = out["out"][t].buffer, ref["out"][t].buffer
        require(o.meta["closedcaption"] == ("raw", pairs[t]),
                f"captions_sd: tick {t}'s decoded pairs differ from the "
                f"pushed ones")
        require(o.meta["timecode"] == c.meta["timecode"] and len(
            o.meta["timecode"]) == n, "captions_sd: timecodes differ")
        for a, b, src in zip(o.data, c.data, host[t]):
            require(a.is_cuda == (dev.type == "cuda")
                    and torch.equal(a.cpu(), b),
                    "captions_sd: frames differ from the CPU run")
        require(np.array_equal(o.data[0][:, 1:].cpu().numpy(),
                               host[t][0][:, 1:])
                and all(np.array_equal(a.cpu().numpy(), s)
                        for a, s in zip(o.data[1:], host[t][1:])),
                "captions_sd: line21encoder touched more than row 0")
        cc = [bytes(np.asarray(x)) for x in out["cc"][t].buffer.data]
        cr = [bytes(np.asarray(x)) for x in ref["cc"][t].buffer.data]
        require(cc == cr == pairs[t], "captions_sd: the CDP round trip "
                "differs from the pushed pairs")
    first = out["out"][0].buffer.meta["timecode"]
    bc_report("captions_sd", "frames/s", r)
    print(f"  captions_sd: {ticks} ticks of {n} frames of {w}x{h}, every "
          f"frame's decoded pair == the pushed pair (and through CDP and "
          f"back); timecodes {first[0]}.."
          f"{out['out'][-1].buffer.meta['timecode'][-1]} "
          f"== the CPU run's; every frame == the CPU run's, rows 1.. and "
          f"chroma == the input")


def ass_doc(t, w, h):
    """A tick's ASS text: two events, the second moving across the frame."""
    x = 200 + 500 * t
    return (ASS_HEADER
            + f"Dialogue: 0,0:00:00.00,0:00:05.00,Default,,0,0,0,,"
              f"Subtitle line {t}: {{\\i1}}the quick brown fox{{\\i0}}\n"
            + f"Dialogue: 0,0:00:00.00,0:00:05.00,Sign,,0,0,0,,"
              f"{{\\pos({x},{h // 4})}}{{\\c&H00FF00&}}SIGN {t}\n")


def dvb_sub(t, sw, sh, seed):
    """A tick's seeded AYUV subpicture planes, one frame: a transparent
    field with opaque text-like bars of three colours."""
    import numpy as np
    rng = np.random.default_rng(seed + t)
    img = np.zeros((4, sh, sw), np.uint8)
    img[1], img[2:] = 16, 128
    for k in range(12):
        y0, x0 = int(rng.integers(0, sh - 10)), int(rng.integers(0, sw - 30))
        img[:, y0:y0 + 10, x0:x0 + 30] = np.array(
            [255, (235, 16, 180)[k % 3], 128, (128, 128, 200)[k % 3]],
            np.uint8)[:, None, None]
    return tuple(p[None] for p in img)


def subtitles_hd(seed, dev, start, finish, peak):
    """subtitles_hd: seeded 1920x1080 I420, batch 16, 3 ticks, under
    assrender (a seeded ASS document a tick: two events, one moving) and
    under dvbsubenc ! dvbsuboverlay (a seeded AYUV subpicture a tick,
    DVB_REGION).  The first SUB_CHECK frames of each tick equal the CPU
    run's; the copy of a tick's planes to the host and back is timed."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import (Buffer, device_planes,
                                                 host_array)
    from gstreamer_tpu_torch.core.pipeline import State
    w, h, n, ticks = SUBTITLES_HD
    sw, sh, sx, sy = DVB_REGION
    host = [bc_frames(n, h, w, seed + 20 + t) for t in range(ticks)]
    for kind, fmt in SUB_DESC.items():
        desc = fmt.format(w=w, h=h, sw=sw, sh=sh, sx=sx, sy=sy)

        def run(d, cut=None):
            pipe = parse_launch(desc, batch=n, device=d)
            pipe.set_state(State.PLAYING)
            on = [tuple(torch.from_numpy(p[:cut]).to(d) for p in host[t])
                  for t in range(ticks)]
            subs = [tuple(torch.from_numpy(p).to(d)
                          for p in dvb_sub(t, sw, sh, seed))
                    for t in range(ticks)]
            sync(d)

            def tick(t):
                def push():
                    planes = on[t]
                    m = planes[0].shape[0]
                    pipe.get_by_name("v").push_buffer(Buffer(
                        data=planes, pts=t * n * DUR, duration=DUR, batch=m))
                    if kind == "assrender":
                        txt = np.frombuffer(ass_doc(t, w, h).encode(),
                                            np.uint8)
                        pipe.get_by_name("t").push_buffer(Buffer(
                            data=txt, pts=t * n * DUR))
                    else:
                        pipe.get_by_name("t").push_buffer(Buffer(
                            data=subs[t], pts=t * n * DUR, duration=DUR,
                            batch=1))
                return push
            return pipe, [tick(t) for t in range(ticks)]
        name = f"subtitles_hd_{kind}"
        pipe, pushes = run(dev)
        if kind == "assrender":
            require(pipe.get_by_name("t") in pipe._host_fed,
                    f"{name}: the subtitle text was staged")
        out, r = bc_path(name, pipe, pushes, dev, start, finish, peak,
                         lambda s: sum(x.buffer.batch for x in s["out"]))
        pipe.set_state(State.NULL)
        cpu, cpushes = run(torch.device("cpu"), SUB_CHECK)
        ref = []
        for push in cpushes:
            push()
            cpu.tick()
            ref += drain(cpu.get_by_name("out"))
        cpu.set_state(State.NULL)
        require(len(out["out"]) == len(ref) == ticks,
                f"{name}: samples per tick")
        drawn = 0
        for t in range(ticks):
            for a, b, src in zip(out["out"][t].buffer.data, ref[t].buffer.data,
                                 host[t]):
                require(a.is_cuda == (dev.type == "cuda")
                        and tuple(a.shape) == src.shape
                        and torch.equal(a[:SUB_CHECK].cpu(), b),
                        f"{name}: the first frames differ from the CPU run")
            drawn += int((out["out"][t].buffer.data[0].cpu().numpy()
                          != host[t][0]).sum())
        require(drawn > 0, f"{name}: nothing was drawn")
        bc_report(name, "frames/s", r)
        print(f"  {name}: {ticks} ticks of {n} frames of {w}x{h}; the first "
              f"{SUB_CHECK} frames of every tick == the CPU run's; "
              f"{drawn} luma bytes drawn")
    # what a device blend would save: a tick's planes to the host and back
    planes = bc_frames(n, h, w, seed, dev)
    if dev.type == "cuda":
        d2h = cuda_ms(lambda: [host_array(p) for p in planes], 5, 1)
        back = [host_array(p) for p in planes]
        h2d = cuda_ms(lambda: device_planes(back, planes), 5, 1)
        print(f"  subtitles_hd copies: a {w}x{h} I420 tick of {n} frames "
              f"({sum(p.numel() for p in planes) / 2**20:.1f} MiB) to the "
              f"host {d2h:.3f} ms (host_array: pageable memory), back to the "
              f"card {h2d:.3f} ms (device_planes: one copy through "
              f"page-locked memory); CUDA events")


def scope_audio(seed, pushes, rate):
    """Seeded 48 kHz stereo S16 pushes of 1 s: a chord with a moving
    stereo image under noise."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for t in range(pushes):
        i = np.arange(t * rate, (t + 1) * rate) / rate
        left = 0.4 * np.sin(2 * np.pi * 220 * i) + 0.2 * np.sin(
            2 * np.pi * 1760 * i)
        right = 0.4 * np.sin(2 * np.pi * 330 * i + i) + 0.1 * np.sin(
            2 * np.pi * 5000 * i)
        x = np.stack([left, right], -1) + rng.normal(0, 0.05, (rate, 2))
        out.append((np.clip(x, -1, 1) * 32767).astype(np.int16))
    return out


def scopes_hd(seed, dev, start, finish, peak):
    """scopes_hd: 48 kHz stereo S16, SCOPE_PUSHES pushes of 1 s, through
    each of wavescope, spectrascope, spacescope and synaescope at
    1920x1080 30/1, then videoconvertscale to I420 (SCOPE_DESC: a tee keeps
    the scope's own frames too), and monoscope (256x128) and goom2k1 at
    their defaults.  The card's frames, the scope's and the converted
    ones, equal the CPU run's over the first push."""
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.pipeline import State
    w, h, fps = SCOPES_HD
    rate = SCOPE_RATE
    audio = scope_audio(seed, SCOPE_PUSHES, rate)
    caps = f"video/x-raw,width={w},height={h},framerate={fps}/1 ! "
    for scope in SCOPES + ("monoscope", "goom2k1"):
        desc = SCOPE_DESC.format(
            rate=rate, scope=scope,
            caps=caps if scope in SCOPES else "")

        def run(d, pushes):
            pipe = parse_launch(desc, device=d)
            pipe.set_state(State.PLAYING)
            on = [torch.from_numpy(a).to(d) for a in audio[:pushes]]
            sync(d)

            def tick(t):
                def push():
                    pipe.get_by_name("in").push_buffer(Buffer(
                        data=on[t], pts=t * 1_000_000_000,
                        duration=1_000_000_000))
                return push
            return pipe, [tick(t) for t in range(pushes)]
        pipe, pushes = run(dev, SCOPE_PUSHES)
        out, r = bc_path(scope, pipe, pushes, dev, start, finish, peak,
                         lambda s: sum(x.buffer.batch for x in s["out"]),
                         sinks=("out", "raw"))
        pipe.set_state(State.NULL)
        cpu, cpushes = run(torch.device("cpu"), 1)
        ref = {"out": [], "raw": []}
        for push in cpushes:
            push()
            cpu.tick()
            for s in ref:
                ref[s] += drain(cpu.get_by_name(s))
        cpu.set_state(State.NULL)
        frames = [x.buffer.batch for x in out["out"]]
        require(len(frames) == SCOPE_PUSHES and min(frames) >= 1,
                f"{scope}: frames a push {frames}")
        for s in ("out", "raw"):
            require(len(ref[s]) == 1 and str(ref[s][0].caps)
                    == str(out[s][0].caps), f"{scope}: caps of {s}")
            for a, b in zip(out[s][0].buffer.data, ref[s][0].buffer.data):
                require(a.is_cuda == (dev.type == "cuda")
                        and torch.equal(a.cpu(), b),
                        f"{scope}: the {s} frames differ from the CPU run")
        lit = sum(int(p.count_nonzero()) for x in out["raw"]
                  for p in x.buffer.data)
        require(lit > 0, f"{scope}: every frame is black")
        caps0 = out["raw"][0].caps[0]
        bc_report(f"scopes_hd_{scope}", "frames/s", r)
        print(f"  scopes_hd_{scope}: {SCOPE_PUSHES} pushes of 1 s of {rate} "
              f"Hz stereo S16 -> {sum(frames)} frames of "
              f"{caps0['width']}x{caps0['height']} BGRx, then I420; the "
              f"first push's frames (scope and I420) == the CPU run's; "
              f"{lit} lit samples")


def asr_run(desc, d, pushes=None):
    """A launch string ending in appsink "out" to EOS on `d`, `pushes`
    (host arrays) into appsrc "in"; returns the samples joined, and the
    pipeline."""
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    pipe = parse_launch(desc, batch=1, device=d)
    if pushes is not None:
        src = pipe.get_by_name("in")
        pos = 0
        for x in pushes:
            src.push_buffer(Buffer(data=torch.from_numpy(x).to(d),
                                   pts=pos * 10**9 // 48000,
                                   duration=len(x) * 10**9 // 48000))
            pos += len(x)
        src.end_of_stream()
    pipe.run()
    sink = pipe.get_by_name("out")
    got = [s.buffer.data for s in drain(sink)] if sink is not None else []
    return (torch.cat([g.cpu() for g in got]) if got else None), pipe


def wav_asr(seed, dev, start, finish, peak):
    """wav_asr: BASELINE config 2 from a file.  wavenc writes WAV_SECONDS
    of seeded 48 kHz stereo S16LE (from the card; the file equals the CPU
    run's); wavparse location=... ! audioconvert ! mono ! audioresample !
    16 kHz ! audioconvert ! F32LE ! appsink runs on the card (timed) and
    gives the samples that appsrc carrying the file's samples in the same
    blocks gives, and the CPU run's.  The same round trip through auenc /
    auparse (S16BE), aiffmux / aiffparse (S16BE) and adpcmenc ! wavenc /
    wavparse ! adpcmdec: files and samples equal the CPU run's, the
    lossless ones the samples written."""
    import tempfile

    import numpy as np
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.pipeline import State
    rng = np.random.default_rng(seed)
    rate = 48000
    i = np.arange(WAV_SECONDS * rate)[:, None] / rate
    x = 0.5 * np.sin(2 * np.pi * np.array([300, 450]) * i) \
        + rng.normal(0, 0.05, (len(i), 2))
    samples = (np.clip(x, -1, 1) * 32767).astype(np.int16)
    pushes = list(samples.reshape(WAV_SECONDS, rate, 2))
    src = ("appsrc name=in caps=audio/x-raw,format=S16LE,rate=48000,"
           "channels=2,layout=interleaved")
    with tempfile.TemporaryDirectory() as tmp:
        files = {}
        writers = {
            "wav": f"{src} ! wavenc location={{p}}",
            "au": f"{src} ! audioconvert ! audio/x-raw,format=S16BE ! "
                  f"auenc location={{p}}",
            "aiff": f"{src} ! audioconvert ! audio/x-raw,format=S16BE ! "
                    f"aiffmux location={{p}}",
            "adpcm.wav": f"{src} ! adpcmenc ! wavenc location={{p}}"}
        for ext, fmt in writers.items():
            for d in (dev, torch.device("cpu")):
                path = os.path.join(tmp, f"{d.type}.{ext}")
                asr_run(fmt.format(p=path), d, pushes)
                with open(path, "rb") as f:
                    files[(ext, d.type)] = f.read()
            require(files[(ext, dev.type)] == files[(ext, "cpu")],
                    f"wav_asr: the {ext} file differs from the CPU run's")
        big, _ = asr_run(f"{src} ! audioconvert ! audio/x-raw,format=S16BE "
                         f"! appsink name=out", dev, pushes)
        big = big.numpy()
        readers = {"wav": "wavparse location={p} blocksize=48000",
                   "au": "auparse location={p}",
                   "aiff": "aiffparse location={p} blocksize=48000",
                   "adpcm.wav": "wavparse location={p} ! adpcmdec"}
        for ext, fmt in readers.items():
            path = os.path.join(tmp, f"{dev.type}.{ext}")
            parsed, _ = asr_run(fmt.format(p=path) + " ! appsink name=out",
                                dev)
            if ext != "adpcm.wav":
                # audioconvert's S16LE -> S16BE moves samples by an LSB (the
                # 16-bit unpack fills the low half, the quantizer rounds;
                # ROADMAP.md section 3): AU and AIFF hold what it gave
                want = samples if ext == "wav" else big
                require(np.array_equal(parsed.numpy().astype(np.int16),
                                       want),
                        f"wav_asr: {ext}'s samples differ from those written")
            desc = f"{fmt.format(p=path)} ! {ASR_CHAIN}"
            if ext == "wav":
                pipe = parse_launch(desc, batch=1, device=dev)
                pipe.set_state(State.PLAYING)
                ticks = [lambda: None] * WAV_SECONDS
                out, r = bc_path("wav_asr", pipe, ticks, dev, start, finish,
                                 peak, lambda s: sum(
                                     x.buffer.data.shape[0] for x in s["out"]))
                while pipe.tick():         # to EOS: the resampler's tail
                    out["out"] += drain(pipe.get_by_name("out"))
                out["out"] += drain(pipe.get_by_name("out"))
                pipe.set_state(State.NULL)
                card = torch.cat([s.buffer.data.cpu() for s in out["out"]])
                fed, _ = asr_run(f"{src} ! {ASR_CHAIN}", dev, pushes)
                require(torch.equal(card, fed),
                        "wav_asr: wavparse's samples through the chain differ "
                        "from appsrc's")
            else:
                card, _ = asr_run(desc, dev)
            cpu, _ = asr_run(desc, torch.device("cpu"))
            require(card.dtype == torch.float32 and card.numel() > 0
                    and bool(torch.isfinite(card).all()),
                    f"wav_asr: {ext} gave {tuple(card.shape)}")
            require(torch.equal(card, cpu),
                    f"wav_asr: {ext}'s chain differs from the CPU run")
        sizes = {k[0]: len(v) for k, v in files.items() if k[1] == "cpu"}
    bc_report("wav_asr", "16 kHz output samples/s", r)
    print(f"  wav_asr: {WAV_SECONDS} s of 48 kHz stereo S16 written and read "
          f"back as {sizes} bytes; the WAV chain == appsrc with the same "
          f"samples == the CPU run; AU, AIFF and IMA ADPCM WAV round trips "
          f"== the CPU run, the lossless ones == the pushed samples")


def bc_plain(x):
    """A value of a sample, meta, message or element as plain comparable
    data: tensors and arrays by dtype, shape and bytes (wherever they
    lie), caps by their string, containers walked."""
    import numpy as np
    import torch
    if isinstance(x, dict):
        return {k: bc_plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, [bc_plain(v) for v in x])
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.shape, x.tobytes())
    if type(x).__name__ == "Caps":
        return ("caps", str(x))
    return x


def annexb_aus(h265, n, rng):
    """n access units of stand-in NALs (a parameter set, a slice)."""
    import numpy as np
    aus = []
    for k in range(n):
        if h265:
            ps, vcl = bytes([32 << 1, 1]), bytes([(19 if k == 0 else 1) << 1,
                                                  1])
        else:
            ps, vcl = b"\x67", bytes([0x65 if k == 0 else 0x41])
        aus.append(b"\x00\x00\x00\x01" + ps + b"\x42\x11\x22"
                   + b"\x00\x00\x00\x01" + vcl
                   + rng.integers(1, 256, 24, dtype=np.uint8).tobytes())
    return aus


def spu_packet(w, h, sx, sy):
    """A DVD subpicture unit: a solid rectangle of colour 1, displayed."""
    import struct
    line = bytes([0x00, 0x01])
    top = line * ((h + 1) // 2)
    bot = line * (h // 2)
    ctrl_off = 4 + len(top) + len(bot)
    ex, ey = sx + w - 1, sy + h - 1
    ctrl = struct.pack(">HH", 0, ctrl_off) + bytes([
        0x01, 0x03, 0x32, 0x10, 0x04, 0xFF, 0xFF, 0x05, sx >> 4,
        ((sx & 0xF) << 4) | (ex >> 8), ex & 0xFF, sy >> 4,
        ((sy & 0xF) << 4) | (ey >> 8), ey & 0xFF, 0x06]) + struct.pack(
        ">HH", 4, 4 + len(top)) + b"\xff"
    body = top + bot + ctrl
    return struct.pack(">HH", 4 + len(body), ctrl_off) + body


def bc_inputs(kind, rng):
    """One source's pushes for a factory of the slice alone: Buffer kwargs
    with host data (the card run moves arrays to the card)."""
    import struct

    import numpy as np
    w, h, n = BC_ALONE
    if kind in ("I420", "GRAY8", "S16LE", "F32LE", "text", "bytes"):
        return analytics_inputs(kind, rng)
    if kind == "RGB":
        return [dict(data=tuple(rng.integers(0, 256, (n, h, w),
                                             dtype=np.uint8)
                                for _ in range(3)), pts=t * n * DUR,
                     duration=DUR, batch=n) for t in range(2)]
    if kind == "AYUV":
        img = np.zeros((4, 1, 16, 32), np.uint8)
        img[1], img[2:] = 16, 128
        img[:, :, 4:12, 6:26] = np.array([255, 200, 90, 160],
                                         np.uint8)[:, None, None, None]
        return [dict(data=tuple(img), pts=t * n * DUR, duration=DUR,
                     batch=1) for t in range(2)]
    if kind == "S16BE":
        return [dict(data=(rng.standard_normal((4800, 2)) * 5000).astype(
            np.int16), pts=t * 10**8, duration=10**8) for t in range(2)]
    if kind == "cc":
        return [dict(data=[np.frombuffer(bytes(rng.integers(
            0, 128, 2, dtype=np.uint8) | 0x80), np.uint8) for _ in range(n)],
            pts=t * n * DUR, duration=DUR, batch=n) for t in range(2)]
    if kind in ("h264", "h265"):
        return [dict(data=[np.frombuffer(a, np.uint8)
                           for a in annexb_aus(kind == "h265", n, rng)],
                     pts=t * n * DUR, batch=n,
                     meta={"closedcaption": ("cc_data", [
                         b"\xfc" + rng.bytes(2) for _ in range(n)]),
                         "sei-user-data": (b"0123456789abcdef", b"hi")})
                for t in range(2)]
    if kind == "ass":
        return [dict(data=np.frombuffer((
            ASS_HEADER + f"Dialogue: 0,0:00:00.00,0:00:01.00,Default,,0,0,"
            f"0,,{{\\pos(30,20)}}x{t}\n").encode(), np.uint8),
            pts=t * n * DUR) for t in range(2)]
    if kind == "lpcm":
        return [dict(data=np.frombuffer(bytes([1, 0, 4, 0x01, 0x80])
                                        + rng.integers(-9000, 9000, (240, 2))
                                        .astype(">i2").tobytes(), np.uint8),
                     pts=t * 5 * 10**6) for t in range(2)]
    if kind == "spu":
        pkt = spu_packet(20, 8, 10, 30)
        return [dict(data=np.frombuffer(pkt[:9], np.uint8), pts=0),
                dict(data=np.frombuffer(pkt[9:] + pkt, np.uint8),
                     pts=n * DUR)]
    raise ValueError(kind)


def bc_rows():
    """The launch strings that drive each factory of the slice alone or in
    a short chain: [(launch, {appsrc: kind}, before)], where `before` is a
    launch string run first on the same device (the writer or the sink
    pipeline its reader needs) or a dict of files to write first.  {t} is
    the temporary directory, {r} / {w} the ends of a pipe."""
    import numpy as np
    w, h, n = BC_ALONE
    caps = {"I420": f"video/x-raw,format=I420,width={w},height={h},"
                    "framerate=30/1",
            "RGB": f"video/x-raw,format=RGB,width={w},height={h},"
                   "framerate=30/1",
            "GRAY8": f"video/x-raw,format=GRAY8,width={w},height={h},"
                     "framerate=30/1",
            "AYUV": "video/x-raw,format=AYUV,width=32,height=16,"
                    "framerate=30/1",
            "S16LE": "audio/x-raw,format=S16LE,rate=48000,channels=2,"
                     "layout=interleaved",
            "S16BE": "audio/x-raw,format=S16BE,rate=48000,channels=2,"
                     "layout=interleaved",
            "F32LE": "audio/x-raw,format=F32LE,rate=48000,channels=2,"
                     "layout=interleaved",
            "cc": "closedcaption/x-cea-608,format=raw,framerate=30/1",
            "h264": "video/x-h264,stream-format=byte-stream,alignment=au",
            "h265": "video/x-h265,stream-format=byte-stream,alignment=au",
            "ass": "application/x-ass", "lpcm": "audio/x-private1-lpcm",
            "spu": "subpicture/x-dvd", "text": "text/x-raw",
            "bytes": "application/octet-stream"}

    def src(kind, name="in"):
        return f"appsrc name={name} caps={caps[kind]}"

    def one(kind, chain, before=None):
        return (f"{src(kind)} ! {chain}", {"in": kind}, before)
    from gstreamer_tpu_torch.elements.simple_formats import pnm_encode
    rng = np.random.default_rng(1)
    pnms = {f"img_{k}.pnm": pnm_encode([rng.integers(0, 256, (h, w),
                                                     dtype=np.uint8)
                                        for _ in range(3)], "RGB")
            for k in range(1, 4)}
    parts = {f"part{k}.bin": rng.bytes(700 * (k + 1)) for k in range(3)}
    return [
        (f"cccombiner name=c ! line21encoder ! line21decoder ! ccextractor "
         f"name=x x.src ! appsink name=out x.caption_0 ! ccconverter ! "
         f"closedcaption/x-cea-708,format=cdp ! appsink name=out1 "
         f"{src('I420')} ! timecodestamper post-messages=true ! avwait "
         f"target-running-time=30000000 ! c.sink {src('cc', 'cap')} ! "
         f"c.caption", {"in": "I420", "cap": "cc"}, None),
        (f"cea608mux name=m ! appsink name=out {src('cc', 'f1')} ! m.sink_0 "
         f"{src('cc', 'f2')} ! m.sink_1", {"f1": "cc", "f2": "cc"}, None),
        one("h264", "h264ccinserter ! h264ccextractor ! h264seiinserter ! "
            "h264timestamper ! appsink name=out"),
        one("h265", "h265ccinserter ! h265ccextractor ! h265seiinserter "
            "remove-caption-meta=true ! h265timestamper ! appsink name=out"),
        one("I420", "alpha_combine ! appsink name=out"),
        one("I420", "alphacombine ! appsink name=out"),
        one("I420", "combdetect ! ivtc ! videosegmentclip start=30000000 ! "
            "appsink name=out"),
        (f"compare name=c method=mse ! appsink name=out {src('I420', 'i0')} "
         f"! c.sink {src('I420', 'i1')} ! c.check", {"i0": "I420",
                                                    "i1": "I420"}, None),
        one("F32LE", "audiolatency ! audiosegmentclip start=50000000 ! "
            "netsim duplicate-probability=0.5 seed=3 ! appsink name=out"),
        (f"assrender name=ov ! appsink name=out {src('I420', 'v')} ! "
         f"ov.video {src('ass', 't')} ! ov.text", {"v": "I420", "t": "ass"},
         None),
        (f"dvbsuboverlay name=ov ! appsink name=out {src('I420', 'v')} ! "
         f"ov.video {src('AYUV', 't')} ! dvbsubenc x=8 y=4 ! ov.text",
         {"v": "I420", "t": "AYUV"}, None),
        one("lpcm", "dvdlpcmdec ! appsink name=out"),
        (f"dvdspu name=ov ! appsink name=out {src('I420', 'v')} ! ov.video "
         f"{src('spu', 's')} ! dvdsubparse ! dvdsubdec ! ov.subpicture",
         {"v": "I420", "s": "spu"}, None),
        one("S16LE", "wavescope ! video/x-raw,width=64,height=48 ! "
            "appsink name=out"),
        one("S16LE", "spectrascope ! video/x-raw,width=64,height=48 ! "
            "appsink name=out"),
        one("S16LE", "spacescope style=lines ! video/x-raw,width=64,"
            "height=48 ! appsink name=out"),
        one("S16LE", "synaescope ! video/x-raw,width=64,height=48 ! "
            "appsink name=out"),
        one("S16LE", "monoscope ! appsink name=out"),
        one("S16LE", "goom2k1 ! video/x-raw,width=64,height=48 ! "
            "appsink name=out"),
        ("intervideosrc channel=bcv ! appsink name=out", {},
         (f"{src('I420')} ! intervideosink channel=bcv", {"in": "I420"})),
        ("interaudiosrc channel=bca ! appsink name=out", {},
         (f"{src('S16LE')} ! interaudiosink channel=bca", {"in": "S16LE"})),
        ("intersubsrc channel=bcs ! appsink name=out", {},
         (f"{src('text')} ! intersubsink channel=bcs", {"in": "text"})),
        ("wavparse location={t}/a.wav blocksize=1000 ! appsink name=out", {},
         (f"{src('S16LE')} ! wavenc location={{t}}/a.wav",
          {"in": "S16LE"})),
        ("auparse location={t}/a.au ! appsink name=out", {},
         (f"{src('S16BE')} ! auenc location={{t}}/a.au", {"in": "S16BE"})),
        ("aiffparse location={t}/a.aiff ! appsink name=out", {},
         (f"{src('S16BE')} ! aiffmux location={{t}}/a.aiff",
          {"in": "S16BE"})),
        one("RGB", "pnmenc ! pnmdec ! appsink name=out"),
        one("S16LE", "adpcmenc blockalign=256 ! adpcmdec ! appsink "
            "name=out"),
        ("gdpdepay location={t}/v.gdp ! appsink name=out", {},
         (f"{src('I420')} ! gdppay ! filesink location={{t}}/v.gdp",
          {"in": "I420"})),
        ("ipcpipelinesrc fdin={r} ! appsink name=out", {},
         (f"{src('I420')} ! ipcpipelinesink fdout={{w}}", {"in": "I420"})),
        ("ipcslavepipeline fdin={r} ! appsink name=out", {},
         (f"{src('S16LE')} ! ipcpipelinesink fdout={{w}}",
          {"in": "S16LE"})),
        one("I420", "aspectratiocrop aspect-ratio=1/1 ! capsdebug name=cd ! "
            "navigationtest ! navseek ! testsink name=s"),
        ("imagesequencesrc location={t}/img_%d.pnm start-index=1 "
         "framerate=5/1 ! pnmdec ! appsink name=out", {}, pnms),
        ("splitfilesrc location={t}/part*.bin blocksize=500 ! "
         "application/octet-stream ! rndbuffersize seed=3 min=100 max=300 ! "
         "appsink name=out", {}, parts),
        ("pushfilesrc location={t}/part1.bin initial-timestamp=5 ! "
         "application/octet-stream ! appsink name=out", {}, parts),
    ]


def bc_alone_run(desc, ins, before, d, tmp):
    """A row of bc_rows on `d` to EOS (its `before` first): every appsink's
    samples, the bus's element and tag messages, the named debug elements'
    state and the files written, as plain data."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer, map_leaves
    from gstreamer_tpu_torch.elements import inter_netsim
    w, h, n = BC_ALONE
    inter_netsim._SURFACES.clear()
    r, wfd = os.pipe()

    def fill(s):
        return s.replace("{t}", tmp).replace("{r}", str(r)).replace(
            "{w}", str(wfd))

    def start_run(text, feeds):
        pipe = parse_launch(fill(text), batch=n, device=d)
        for name, bufs in feeds.items():
            src = pipe.get_by_name(name)
            for b in bufs:
                src.push_buffer(Buffer(**dict(b, data=map_leaves(
                    lambda x: torch_to(x, d) if isinstance(x, np.ndarray)
                    and (x.dtype != np.uint8 or x.ndim > 1) else x,
                    b["data"]))))
            src.end_of_stream()
        pipe.run()
        return pipe
    try:
        if isinstance(before, dict):
            for f, blob in before.items():
                with open(os.path.join(tmp, f), "wb") as fh:
                    fh.write(blob)
        elif before is not None:
            bdesc, bkinds = before
            start_run(bdesc, {k: bc_inputs(v, np.random.default_rng(7))
                              for k, v in bkinds.items()})
            os.close(wfd)
            wfd = -1
        pipe = start_run(desc, ins)
    finally:
        for fd in (r, wfd):
            if fd >= 0:
                os.close(fd)
        inter_netsim._SURFACES.clear()
    got = {}
    for s in ("out", "out1"):
        sink = pipe.get_by_name(s)
        for x in drain(sink) if sink is not None else ():
            leaves = []
            map_leaves(leaves.append, x.buffer.data)
            media = str(x.caps).startswith(("video/x-raw", "audio/x-raw"))
            require(all(isinstance(v, torch.Tensor)
                        and v.device.type == torch.device(d).type
                        for v in leaves) or not media
                    or "rndbuffersize" in desc,
                    f"{desc}: media left {d}")
            got.setdefault(s, []).append((
                x.buffer.pts, x.buffer.dts, x.buffer.duration, x.buffer.batch,
                str(x.caps), bc_plain(x.buffer.data),
                bc_plain(x.buffer.meta)))
    state = {}
    for name in ("s", "cd"):
        e = pipe.get_by_name(name)
        if e is not None:
            state[name] = {a: bc_plain(getattr(e, a)) for a in (
                "md5", "byte_count", "buffer_count", "seen_caps")
                if hasattr(e, a)}
    files = {}
    for f in sorted(os.listdir(tmp)):
        with open(os.path.join(tmp, f), "rb") as fh:
            files[f] = fh.read()
        os.remove(os.path.join(tmp, f))
    msgs = [(m.type, bc_plain(m.data))
            for m in iter(pipe.bus.pop, None) if m.type in ("element", "tag")]
    return got, msgs, state, files


def broadcast_alone(seed, counters, dev):
    """Each of the slice's 68 factories alone or in a short chain on small
    inputs (bc_rows), on the card and on the CPU: the samples, metas, bus
    messages, the debug sinks' state and the written files equal; no
    kernel launched on the card."""
    import re
    import tempfile

    import numpy as np
    import torch
    from gstreamer_tpu_torch.core.element import list_factories
    seen = set()
    with tempfile.TemporaryDirectory() as tmp:
        rows = bc_rows()
        for k, (desc, kinds, before) in enumerate(rows):
            rng = np.random.default_rng(seed + k)
            ins = {name: bc_inputs(kind, rng) for name, kind in kinds.items()}
            for c in counters.values():
                c.launches = 0
            card = bc_alone_run(desc, ins, before, dev, tmp)
            counts = {k2: c.launches for k2, c in counters.items()
                      if c.launches}
            require(counts == {} or dev.type != "cuda",
                    f"{desc}: launches {counts}")
            cpu = bc_alone_run(desc, ins, before, torch.device("cpu"), tmp)
            require(card == cpu, f"{desc}: the card's run differs from the "
                    "CPU's")
            require(any(card[0].values()) or card[2],
                    f"{desc}: nothing came out")
            texts = [desc] + ([before[0]] if isinstance(before, tuple)
                              else [])
            for text in texts:
                seen.update(re.findall(r"(?:^|! )([a-z0-9_-]+)", text))
                seen.update(re.findall(r"^(\w+) name=", text))
    mine = set(BROADCAST_FACTORIES)
    require(len(mine) == 68 and mine <= set(list_factories()),
            "the slice's factory list")
    require(mine <= seen, f"factories not driven alone: {mine - seen}")
    w, h, n = BC_ALONE
    print(f"broadcast each factory alone: CUDA == port CPU path (samples, "
          f"metas, bus messages, debug sinks' state, written files) for the "
          f"{len(mine)} factories in {len(rows)} launch strings on {n} "
          f"frames of {w}x{h} or short pushes; no kernel launched")


def broadcast_phase(seed, counters, dev):
    """The broadcast, subtitle, scope and file host modules on the card,
    each path with the launch counts zeroed just before it and read just
    after (none of the ten kernels is on these paths): captions_sd,
    subtitles_hd (assrender, dvbsub), scopes_hd (the four scopes, monoscope,
    goom2k1), wav_asr, each with frames/s, device busy ms and idle share a
    tick, the host's share, bytes copied D2H and H2D a tick and peak
    memory; then each factory alone (broadcast_alone).  Returns {kernel:
    launches}."""
    import torch
    cuda = dev.type == "cuda"
    total = {k: 0 for k in counters}

    def start(what):
        for c in counters.values():
            c.launches = 0
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            return torch.cuda.memory_allocated()
        return 0

    def finish(what, want):
        counts = {k: c.launches for k, c in counters.items()}
        require(counts == {k: want.get(k, 0) for k in counters},
                f"{what}: launches {counts}, want {want}")
        for k, v in counts.items():
            total[k] += v
        return {k: v for k, v in counts.items() if v}

    def peak(base):
        return (torch.cuda.max_memory_allocated() - base) / 2**20 if cuda \
            else 0.0

    t0 = time.perf_counter()
    captions_sd(seed, dev, start, finish, peak)
    subtitles_hd(seed, dev, start, finish, peak)
    scopes_hd(seed, dev, start, finish, peak)
    wav_asr(seed, dev, start, finish, peak)
    broadcast_alone(seed, counters, dev)
    print(f"broadcast phase: {time.perf_counter() - t0:.1f} s")
    return total


# -- 16. containers and multi-stream sources ---------------------------------

CONT_MKV = (1920, 1080, 48, 16)     # mkv_ingest: width, height, frames, batch
CONT_MOV = (1920, 1080, 32, 16)     # mov_ingest
CONT_MXF = (1920, 1080, 32, 16, 640, 360)   # mxf_proxy, then the proxy size
CONT_RATE = 48000                   # the tracks' audio: 48 kHz stereo S16LE
CONT_FPS = 25
CONT_DESELECT = 1                   # mkv_ingest's tick (from 0) without audio
CONT_ALONE = (64, 48, 4, 2)         # width, height, frames, batch
CONT_RGB = ("videoconvertscale add-borders=false ! video/x-raw,format=RGB,"
            "width=224,height=224 ! appsink name=v")
CONT_ASR = ("audioconvert ! audioresample ! audio/x-raw,format=F32LE,"
            "rate=16000,channels=1 ! appsink name=a")
CONTAINER_FACTORIES = (
    "avimux", "avidemux", "matroskamux", "webmmux", "matroskademux",
    "mxfmux", "mxfdemux", "qtmux", "qtdemux", "cmafmux", "fmp4mux",
    "qtmoovrecover", "rmdemux", "rademux", "pnmsrc", "typefind",
    "uridecodebin", "decodebin", "playbin")


def cont_video(fmt, n, w, h, seed):
    """n seeded frames of `fmt` as host component planes (seeded bytes of
    the format's layout through the port's from_bytes)."""
    import numpy as np
    from gstreamer_tpu_torch.video import format as vf
    fi = vf.format_info(fmt)
    raw = np.random.default_rng(seed).integers(
        0, 256, (n, vf.frame_size(fi, w, h)), np.uint8)
    return tuple(np.ascontiguousarray(p) for p in vf.from_bytes(fi, raw, w, h))


def cont_audio(frames, seed):
    """Seeded 48 kHz stereo S16LE: two tones and noise."""
    import numpy as np
    rng = np.random.default_rng(seed)
    i = np.arange(frames)[:, None] / CONT_RATE
    x = 0.5 * np.sin(2 * np.pi * np.array([300, 450]) * i) \
        + rng.normal(0, 0.05, (frames, 2))
    return (np.clip(x, -1, 1) * 32767).astype(np.int16)


def cont_write(mux, path, fmt, planes, samples, batch, d):
    """`mux` writes the planes (video_0) and the samples (audio_0) pushed
    into appsrcs as tensors on `d`, `batch` frames and their audio a tick;
    returns the seconds the run took (host clock, synchronised)."""
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    n, h, w = planes[0].shape[:3]
    per = CONT_RATE // CONT_FPS * batch
    dur = 10**9 // CONT_FPS
    pipe = parse_launch(
        f"{mux} name=m location={path} ! fakesink appsrc name=v caps=video/"
        f"x-raw,format={fmt},width={w},height={h},framerate={CONT_FPS}/1 ! "
        f"m.video_0 appsrc name=a caps=audio/x-raw,format=S16LE,rate="
        f"{CONT_RATE},channels=2,layout=interleaved ! m.audio_0",
        batch=batch, device=d)
    sync(d)
    t0 = time.perf_counter()
    for k in range(0, n, batch):
        pipe.get_by_name("v").push_buffer(Buffer(
            data=tuple(torch.from_numpy(p[k:k + batch]).to(d)
                       for p in planes), batch=batch, pts=k * dur,
            duration=dur))
        a = samples[k // batch * per:(k // batch + 1) * per]
        pipe.get_by_name("a").push_buffer(Buffer(
            data=torch.from_numpy(a).to(d), pts=k * dur,
            duration=len(a) * 10**9 // CONT_RATE))
    for s in ("v", "a"):
        pipe.get_by_name(s).end_of_stream()
    pipe.run()
    sync(d)
    return time.perf_counter() - t0


def cont_sinks(pipe, out):
    for s in out:
        sink = pipe.get_by_name(s)
        if sink is not None:
            out[s] += drain(sink)


def cont_run(desc, d, batch, at=None):
    """A launch string to EOS on `d` at `batch` (`at(pipe, k)` before tick
    k); returns the samples of its sinks "v" and "a"."""
    from gstreamer_tpu_torch import parse_launch
    pipe = parse_launch(desc, batch=batch, device=d)
    pipe.set_state("playing")
    out, k = {"v": [], "a": []}, 0
    while True:
        if at is not None:
            at(pipe, k)
        more = pipe.tick()
        cont_sinks(pipe, out)
        if not more:
            break
        k += 1
    pipe.set_state("null")
    return out


def cont_joined(samples):
    """A sink's samples on the host, joined along frames (each plane of
    video; the samples of audio)."""
    import torch
    if not samples:
        return None
    first = samples[0].buffer.data
    if isinstance(first, (tuple, list)):
        return tuple(torch.cat([s.buffer.data[i].cpu() for s in samples])
                     for i in range(len(first)))
    return torch.cat([s.buffer.data.cpu() for s in samples])


def cont_equal(a, b) -> bool:
    import torch
    if isinstance(a, tuple) or isinstance(b, tuple):
        return (isinstance(a, tuple) and isinstance(b, tuple)
                and len(a) == len(b)
                and all(torch.equal(x, y) for x, y in zip(a, b)))
    return a is not None and b is not None and torch.equal(a, b)


@contextlib.contextmanager
def cont_counted(module, name, calls):
    """While the block runs, append to `calls` once per call of
    module.name (a container parse)."""
    orig = getattr(module, name)

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    setattr(module, name, counting)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def cont_timed(obj, attr, spent, key, count=None):
    """While the block runs, add to spent[key] the host seconds of each
    call of obj.attr (in whichever thread calls it); with `count(args,
    result)`, add its value to spent[key + " packets"] too."""
    import threading
    fn = getattr(obj, attr)
    lock = threading.Lock()

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = None
        try:
            out = fn(*a, **k)
            return out
        finally:
            dt = time.perf_counter() - t0
            with lock:
                spent[key] = spent.get(key, 0.0) + dt
                if count is not None:
                    spent[key + " packets"] = spent.get(
                        key + " packets", 0) + count(a, out)
    setattr(obj, attr, timed)
    try:
        yield spent
    finally:
        setattr(obj, attr, fn)


def cont_path(name, desc, demux, batch, dev, start, finish, peak, want,
              at=None):
    """One read path on the card ticked to EOS, the launch counts zeroed
    just before it and read just after (`want`), its container parsed
    once; ticks 2.. under torch.profiler (the first, with the path's
    first-call costs, only counted and checked).  Returns the sinks'
    samples and, over ticks 2.. (the EOS tick not counted): frames/s,
    device busy ms and idle share a tick, the host's share of the tick (the
    demuxer's
    create with from_bytes, the staging, the host elements),
    bytes copied D2H and H2D a tick, peak memory, the set-up (compile:
    negotiation and the parse; uridecodebin runs its internal pipeline
    there); and which staged pads
    held any non-zero byte, tick by tick."""
    import contextlib as cl

    import torch
    from torch.profiler import ProfilerActivity, profile
    from gstreamer_tpu_torch import parse_launch
    module, fn = demux
    cuda = dev.type == "cuda"
    parses, spent, counts = [], {}, {"d2h": 0, "h2d": 0}
    base = start(name)
    with cont_counted(module, fn, parses):
        pipe = parse_launch(desc, batch=batch, device=dev)
        t0 = time.perf_counter()
        pipe.set_state("playing")
        setup_ms = (time.perf_counter() - t0) * 1e3
    require(len(parses) == 1, f"{name}: {len(parses)} parses, want one")
    d = pipe.get_by_name("d")
    staged, pull = [], pipe._pull_sources

    def pulled(sources):
        got = pull(sources)
        if got is not None:
            staged.append({k: all(bool(x.any()) for x in (
                v if isinstance(v, (tuple, list)) else (v,)))
                for k, v in got[0].items() if k.startswith("d:")})
        return got
    pipe._pull_sources = pulled
    out, secs = {"v": [], "a": []}, []

    def tick(k):
        if at is not None:
            at(pipe, k)
        sync(dev)
        t0 = time.perf_counter()
        more = pipe.tick()
        cont_sinks(pipe, out)
        sync(dev)
        return more, time.perf_counter() - t0
    with cont_counted(module, fn, parses):
        more, _ = tick(0)
    require(more, f"{name}: EOS at the first tick")
    first = len(out["v"])
    prof_cm = (profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
               if cuda else cl.nullcontext())
    with prof_cm as prof, host_spent(pipe, spent), copy_meter(counts), \
            cont_timed(d, "create_multi", spent, "demux create"), \
            cont_timed(pipe._stager, "stage", spent, "staging"), \
            cont_counted(module, fn, parses):
        while True:
            more, sec = tick(len(secs) + 1)
            if not more:
                break
            secs.append(sec)
    pipe.set_state("null")
    launches = finish(name, want)
    mem = peak(base)
    require(len(parses) == 1, f"{name}: parsed again while ticking")
    n = len(secs)
    require(n > 0, f"{name}: one tick only")
    fps = sum(s.buffer.batch for s in out["v"][first:]) / sum(secs)
    busy = union_busy(prof) / n if cuda else 0.0
    wall = sum(secs) / n * 1e3
    host = sum(spent.values()) / n * 1e3
    return out, dict(fps=fps, wall=wall, busy=busy,
                     idle=max(0.0, 1.0 - busy / wall), host=host,
                     host_share=host / wall, setup_ms=setup_ms,
                     d2h=counts["d2h"] / n, h2d=counts["h2d"] / n, mem=mem,
                     secs=[round(s * 1e3, 3) for s in secs],
                     spent={k2: round(v / n * 1e3, 3)
                            for k2, v in spent.items()},
                     launches=launches, staged=staged)


def cont_report(name, r, write_fps=None):
    wrote = (f"; the muxer wrote {write_fps:.1f} frames/s"
             if write_fps is not None else "")
    print(f"e2e {name}: {r['fps']:.1f} frames/s over ticks 2.."
          f"{len(r['secs']) + 1}"
          f" ({r['secs']} ms per tick, host clock between synchronises)"
          f"{wrote}; device busy {r['busy']:.3f} ms and idle share "
          f"{r['idle']:.3f} of a {r['wall']:.3f} ms tick (traced); the host "
          f"{r['host']:.3f} ms a tick ({r['host_share']:.3f} of it: "
          f"{r['spent']}); set-up with the parse {r['setup_ms']:.3f} ms once; "
          f"copied "
          f"{r['d2h'] / 2**20:.3f} MiB D2H and {r['h2d'] / 2**20:.3f} MiB H2D "
          f"a tick; peak memory {r['mem']:.1f} MiB; kernel launches "
          f"{r['launches']}")


def mkv_paths(seed, dev, tmp, start, finish, peak):
    """mkv_ingest, mkv_uridecodebin and playbin's A/V build over one file
    matroskamux writes on the card (CONT_MKV)."""
    import torch
    from gstreamer_tpu_torch.core.element import element_factory_make
    from gstreamer_tpu_torch.elements import container_elements as ce
    cpu = torch.device("cpu")
    w, h, n, batch = CONT_MKV
    planes = cont_video("I420", n, w, h, seed)
    samples = cont_audio(n * CONT_RATE // CONT_FPS, seed + 1)
    path = os.path.join(tmp, "card.mkv")
    start("mkv_write")
    secs = cont_write("matroskamux", path, "I420", planes, samples, batch,
                      dev)
    finish("mkv_write", {})
    cont_write("matroskamux", os.path.join(tmp, "cpu.mkv"), "I420", planes,
               samples, batch, cpu)
    with open(path, "rb") as f, open(os.path.join(tmp, "cpu.mkv"), "rb") as g:
        require(f.read() == g.read(),
                "mkv_ingest: matroskamux's file differs from the CPU run's")
    os.remove(os.path.join(tmp, "cpu.mkv"))
    write_fps = n / secs

    def deselect(pipe, k):
        d = pipe.get_by_name("d")
        d.select_streams(["video_0"] if k == CONT_DESELECT else None)
    desc = (f"matroskademux name=d location={path} d.video_0 ! {CONT_RGB} "
            f"d.audio_0 ! {CONT_ASR}")
    ticks = -(-n // batch)
    out, r = cont_path("mkv_ingest", desc, (ce, "_parse_matroska"), batch,
                       dev, start, finish, peak, {"yscale_hv": ticks},
                       deselect)
    ref = cont_run(desc, cpu, batch, deselect)
    for s in ("v", "a"):
        require(cont_equal(cont_joined(out[s]), cont_joined(ref[s])),
                f"mkv_ingest: {s} differs from the CPU run")
    require([x.buffer.batch for x in out["v"]] == [batch] * ticks,
            f"mkv_ingest: {[x.buffer.batch for x in out['v']]} frames a tick")
    want = [{"d:video_0": True, "d:audio_0": k != CONT_DESELECT}
            for k in range(ticks)]
    require(r["staged"] == want,
            f"mkv_ingest: staged pads {r['staged']}, want {want}")
    rgb = cont_joined(out["v"])
    require(all(p.shape == (n, 224, 224) and p.dtype == torch.uint8
                for p in rgb), "mkv_ingest: RGB planes' shape")
    cont_report("mkv_ingest", r, write_fps)
    print(f"  mkv_ingest: one parse; yscale_hv once a tick; every output == "
          f"the CPU run; audio deselected at tick {CONT_DESELECT + 1} staged "
          f"as zeros")

    # the same file through uridecodebin (its internal pipeline runs at
    # batch 1) and through playbin's A/V build
    full = cont_run(f"matroskademux location={path} stream=audio ! "
                    f"{CONT_ASR}", cpu, batch)
    udesc = (f"uridecodebin name=d uri=file://{path} d.video_0 ! {CONT_RGB} "
             f"d.audio_0 ! {CONT_ASR}")
    out, r = cont_path("mkv_uridecodebin", udesc, (ce, "_parse_matroska"),
                       batch, dev, start, finish, peak, {"yscale_hv": n})
    require(cont_equal(cont_joined(out["v"]), rgb),
            "mkv_uridecodebin: the RGB frames differ from mkv_ingest's")
    require(cont_equal(cont_joined(out["a"]), cont_joined(full["a"])),
            "mkv_uridecodebin: the audio differs from the CPU run's")
    cont_report("mkv_uridecodebin", r)
    base = start("mkv_playbin")
    with cont_counted(ce, "_parse_matroska", []) as parses:
        pb = element_factory_make("playbin", uri=f"file://{path}")
        pb.device = dev
        sync(dev)
        t0 = time.perf_counter()
        pipe, sinks = pb.build_pipeline_av()
        got = {k: cont_joined(drain(s)) for k, s in sinks.items()}
        sync(dev)
        secs = time.perf_counter() - t0
    finish("mkv_playbin", {})
    mem = peak(base)
    require(len(parses) == 2, f"mkv_playbin: {len(parses)} parses, want 2 "
            "(the probe and the decode graph)")
    require(cont_equal(got["video"], tuple(torch.from_numpy(p)
                                           for p in planes)),
            "mkv_playbin: the video differs from the frames written")
    require(cont_equal(got["audio"], torch.from_numpy(samples)),
            "mkv_playbin: the audio differs from the samples written")
    print(f"e2e mkv_playbin: {n / secs:.1f} frames/s ({secs * 1e3:.3f} ms "
          f"for {n} frames and {len(samples)} samples, build and run); peak "
          f"memory {mem:.1f} MiB; the tracks == the frames and samples "
          f"written; two parses (probe, decode graph)")


def mov_mxf_paths(seed, dev, tmp, start, finish, peak):
    """mov_ingest (qtmux, then qtdemux's two streams to RGB 224) and
    mxf_proxy (mxfmux, then mxfdemux to an I420 640x360 proxy) on UYVY
    1080p: both converters take the generic route, no kernel."""
    import torch
    from gstreamer_tpu_torch.elements import isomp4, mxf
    cpu = torch.device("cpu")
    for name, mux, demux, parse, ext, (w, h, n, batch), vdesc in (
            ("mov_ingest", "qtmux", "qtdemux", (isomp4, "_parse_qt"), "mov",
             CONT_MOV, CONT_RGB),
            ("mxf_proxy", "mxfmux", "mxfdemux", (mxf, "_parse_mxf"), "mxf",
             CONT_MXF[:4], f"videoconvertscale ! video/x-raw,format=I420,"
             f"width={CONT_MXF[4]},height={CONT_MXF[5]} ! appsink name=v")):
        planes = cont_video("UYVY", n, w, h, seed + 2)
        samples = cont_audio(n * CONT_RATE // CONT_FPS, seed + 3)
        files, saved = {}, mxf._uuid
        for d in (dev, cpu):
            files[d.type] = os.path.join(tmp, f"{d.type}.{ext}")
            mxf._uuid = cont_uuids(seed)
            start(name + "_write")
            try:
                secs = cont_write(mux, files[d.type], "UYVY", planes,
                                  samples, batch, d)
            finally:
                mxf._uuid = saved
            finish(name + "_write", {})
            if d is dev:
                write_fps = n / secs
        with open(files[dev.type], "rb") as f, open(files["cpu"], "rb") as g:
            require(f.read() == g.read(),
                    f"{name}: {mux}'s file differs from the CPU run's")
        desc = (f"{demux} name=d location={files[dev.type]} d.video_0 ! "
                f"{vdesc} d.audio_0 ! {CONT_ASR}")
        out, r = cont_path(name, desc, parse, batch, dev, start, finish,
                           peak, {})
        ref = cont_run(desc, cpu, batch)
        for s in ("v", "a"):
            require(cont_equal(cont_joined(out[s]), cont_joined(ref[s])),
                    f"{name}: {s} differs from the CPU run")
        require(sum(x.buffer.batch for x in out["v"]) == n,
                f"{name}: frames out")
        cont_report(name, r, write_fps)
        for f in files.values():
            os.remove(f)


def cont_uuids(seed):
    """A seeded stand-in for mxf._uuid, so two runs write the same ids."""
    import numpy as np
    rng = np.random.default_rng(seed + 99)
    return lambda: rng.integers(0, 256, 16, np.uint8).tobytes()


def rm_file_bytes(seed):
    """A hand-packed RealMedia file: .RMF, PROP, an MDPR each for RV20
    video and RealAudio 14.4 (a v4 header), and DATA with whole-frame
    video packets, one frame split over two packets and audio packets."""
    import struct

    import numpy as np
    rng = np.random.default_rng(seed)

    def chunk(fcc, body):
        return fcc + struct.pack(">IH", 10 + len(body), 0) + body

    def mdpr(snum, mime, ts):
        body = (struct.pack(">H", snum) + b"\0" * 28 + bytes([4]) + b"name"
                + bytes([len(mime)]) + mime)
        return chunk(b"MDPR", body + struct.pack(">I", len(ts)) + ts)
    vido = (struct.pack(">I", 34) + b"VIDO" + b"RV20"
            + struct.pack(">HHHHHH", 32, 24, 12, 0, 0, 0) + b"\0" * 2
            + bytes(range(1, 9)))
    pkts = []

    def pkt(snum, ts, payload, flags=2):
        pkts.append(struct.pack(">HHHIBB", 0, 12 + len(payload), snum, ts, 0,
                                flags) + payload)
    for k in range(4):
        pkt(0, k * 80, bytes([0x40, k])
            + rng.integers(0, 256, 30 + k, np.uint8).tobytes())
        pkt(1, k * 80, rng.integers(0, 256, 20, np.uint8).tobytes(), 0)
    big = rng.integers(0, 256, 50, np.uint8).tobytes()
    for typ, pos, part in ((0, 0, big[:30]), (2, 20, big[30:])):
        pkt(0, 400, bytes([typ << 6, 9]) + struct.pack(
            ">HH", 0x4000 + len(big), 0x4000 + pos) + bytes([7]) + part)
    data = chunk(b"DATA", struct.pack(">II", len(pkts), 0) + b"".join(pkts))
    return (chunk(b".RMF", struct.pack(">II", 0, 4))
            + chunk(b"PROP", b"\0" * 40)
            + mdpr(0, b"video/x-pn-realvideo", vido)
            + mdpr(1, b"audio/x-pn-realaudio", ra4_header()) + data)


def ra4_header(frame=20):
    """A RealAudio v4 header (lpcJ, 8 kHz mono) as rademux and rmdemux
    parse it."""
    import struct
    return (b".ra\xfd" + struct.pack(">H", 4) + b"\0\0" + b".ra4"
            + struct.pack(">IHIH", 0, 4, 0, 0) + struct.pack(">I", frame)
            + b"\0" * 12 + struct.pack(">HHHH", 1, frame, frame, 0)
            + struct.pack(">HHHH", 8000, 0, 16, 1)
            + bytes([4]) + b"Int0" + bytes([4]) + b"lpcJ" + b"\0\0\0")


def push_all(pipe, pushes):
    """Push each appsrc of `pushes` ({name: [Buffer]}) its buffers, then
    end of stream."""
    for name, bufs in (pushes or {}).items():
        src = pipe.get_by_name(name)
        for b in bufs:
            src.push_buffer(b)
        src.end_of_stream()


def cont_launch(desc, d, batch, pushes=None):
    """A launch string to EOS on `d` with seeded pushes (host arrays of
    media go to `d` as tensors, byte blobs stay host arrays): its sinks'
    samples and its element messages as plain data."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer, map_leaves
    pipe = parse_launch(desc, batch=batch, device=d)
    push_all(pipe, {name: [Buffer(**dict(b, data=map_leaves(
        lambda x: torch.from_numpy(x).to(d)
        if isinstance(x, np.ndarray) and (x.dtype != np.uint8
                                          or x.ndim > 1) else x,
        b["data"]))) for b in bufs] for name, bufs in (pushes or {}).items()})
    pipe.run()
    got = {}
    for s in ("out", "out1", "out2"):
        sink = pipe.get_by_name(s)
        for x in drain(sink) if sink is not None else ():
            got.setdefault(s, []).append((
                x.buffer.pts, x.buffer.duration, x.buffer.batch, str(x.caps),
                bc_plain(x.buffer.data), bc_plain(x.buffer.meta)))
    msgs = [(m.type, bc_plain(m.data)) for m in iter(pipe.bus.pop, None)
            if m.type == "element"]
    return got, msgs


def cont_alone_rows():
    """The runs that drive each of the 19 factories alone or as a writer
    and its reader: [(name, fn(d, tmp, seed) -> plain data)]."""
    import numpy as np
    import torch
    w, h, n, batch = CONT_ALONE
    vcaps = (f"video/x-raw,format={{f}},width={w},height={h},"
             f"framerate={CONT_FPS}/1")
    acaps = (f"audio/x-raw,format=S16LE,rate={CONT_RATE},channels=2,"
             "layout=interleaved")
    dur = 10**9 // CONT_FPS

    def video(fmt, seed):
        return [dict(data=tuple(p[k:k + batch] for p in cont_video(
            fmt, n, w, h, seed)), batch=batch, pts=k * dur, duration=dur)
            for k in range(0, n, batch)]

    def audio(seed):
        x = cont_audio(n * 1920, seed)
        return [dict(data=x[k * 1920:(k + batch) * 1920], pts=k * dur,
                     duration=batch * dur) for k in range(0, n, batch)]

    def blobs(seed, kinds):
        rng = np.random.default_rng(seed)
        aus = []
        for k in range(n):
            au = b""
            for head in (kinds if k == 0 else kinds[-1:]):
                au += (b"\0\0\0\1" + head
                       + rng.integers(1, 256, 24, np.uint8).tobytes())
            aus.append(np.frombuffer(au, np.uint8).copy())
        return [dict(data=aus[k:k + batch], batch=batch, pts=k * dur,
                     duration=dur) for k in range(0, n, batch)]
    h264 = (b"\x67\x42\x00\x1e", b"\x68", b"\x65")
    aac = [dict(data=[np.random.default_rng(k).integers(0, 256, 30 + k,
                                                        np.uint8)
                      for k in range(j, j + batch)], batch=batch,
                pts=j * dur, duration=dur) for j in range(0, n, batch)]

    def files(tmp):
        out = {}
        for f in sorted(os.listdir(tmp)):
            with open(os.path.join(tmp, f), "rb") as fh:
                out[f] = fh.read()
        return out

    def mux_demux(mux, ext, srcs, readers):
        """A writer from appsrcs, then each reader of its file."""
        def run(d, tmp, seed):
            from gstreamer_tpu_torch.elements import mxf
            path = os.path.join(tmp, f"f.{ext}")
            desc = f"{mux} name=m location={path} ! fakesink"
            pushes = {}
            for k, (pad, caps, make) in enumerate(srcs):
                desc += f" appsrc name=s{k} caps={caps} ! m.{pad}"
                pushes[f"s{k}"] = make(seed + k)
            saved = mxf._uuid
            mxf._uuid = cont_uuids(seed)
            try:
                cont_launch(desc, d, batch, pushes)
            finally:
                mxf._uuid = saved
            got = [cont_launch(r.format(p=path), d, batch) for r in readers]
            return files(tmp), got
        return run

    v_i420 = ("video_0", vcaps.format(f="I420"), lambda s: video("I420", s))
    v_uyvy = ("video_0", vcaps.format(f="UYVY"), lambda s: video("UYVY", s))
    a_s16 = ("audio_0", acaps, audio)
    v_h264 = ("video_0", "video/x-h264,stream-format=byte-stream,alignment="
              f"au,width={w},height={h},framerate={CONT_FPS}/1",
              lambda s: blobs(s, h264))
    a_aac = ("audio_0", "audio/mpeg,mpegversion=4,stream-format=raw,"
             f"rate={CONT_RATE},channels=2", lambda s: aac)
    text = ("subtitle_0", "text/x-raw,format=utf8", lambda s: [
        dict(data=[t], batch=1, pts=k * dur, duration=dur)
        for k, t in enumerate(("one", "two"))])
    av = "d.video_0 ! appsink name=out d.audio_0 ! appsink name=out1"

    def recover(d, tmp, seed):
        path = os.path.join(tmp, "r.mov")
        desc = (f"qtmux name=m location={path} moov-recovery-file={path}.rec"
                f" ! fakesink appsrc name=s0 caps={vcaps.format(f='UYVY')} "
                f"! m.video_0 appsrc name=s1 caps={acaps} ! m.audio_0")
        cont_launch(desc, d, batch, {"s0": video("UYVY", seed),
                                     "s1": audio(seed + 1)})
        with open(path, "rb") as f:
            raw = f.read()
        with open(os.path.join(tmp, "broken.mov"), "wb") as f:
            f.write(raw[:raw.index(b"moov") - 4])
        from gstreamer_tpu_torch import parse_launch
        pipe = parse_launch(
            f"qtmoovrecover broken-input={tmp}/broken.mov recovery-input="
            f"{path}.rec fixed-output={tmp}/fixed.mov", device=d)
        pipe.set_state("playing")
        msgs = [(m.type, m.data["name"], m.data["samples"])
                for m in iter(pipe.bus.pop, None) if m.type == "element"]
        require(msgs and msgs[0][1] == "qtmoovrecover-done",
                f"qtmoovrecover: {msgs}")
        return files(tmp), msgs, cont_launch(
            f"qtdemux location={tmp}/fixed.mov ! appsink name=out", d, batch)

    def realmedia(d, tmp, seed):
        rm, ra = os.path.join(tmp, "a.rm"), os.path.join(tmp, "a.ra")
        with open(rm, "wb") as f:
            f.write(rm_file_bytes(seed))
        with open(ra, "wb") as f:
            f.write(ra4_header() + np.random.default_rng(seed).integers(
                0, 256, 205, np.uint8).tobytes())
        return [cont_launch(desc, d, batch) for desc in (
            f"rmdemux name=d location={rm} {av}",
            f"rmdemux location={rm} stream=video ! appsink name=out",
            f"rademux location={ra} ! appsink name=out",
            "pnmsrc location=pnm://example.org/a.rm ! appsink name=out")]

    def typefind(d, tmp, seed):
        from gstreamer_tpu_torch import parse_launch
        from gstreamer_tpu_torch.core.buffer import Buffer
        head = np.frombuffer(b"\x1a\x45\xdf\xa3 matroska" + bytes(40),
                             np.uint8)
        found = []
        pipe = parse_launch("appsrc name=in caps=application/x-raw ! "
                            "typefind name=t ! appsink name=out", device=d)
        pipe.get_by_name("t").have_type_cb = lambda c, p: found.append((c, p))
        pipe.get_by_name("in").push_buffer(
            Buffer(data=torch.from_numpy(head.copy()).to(d), batch=1))
        pipe.get_by_name("in").end_of_stream()
        pipe.run()
        require(found == [("video/x-matroska", 100)], f"typefind: {found}")
        return found

    def playback(d, tmp, seed):
        from gstreamer_tpu_torch.core.element import element_factory_make
        mkv, avi = os.path.join(tmp, "p.mkv"), os.path.join(tmp, "p.avi")
        for mux, path in (("matroskamux", mkv), ("avimux", avi)):
            cont_launch(f"{mux} name=m location={path} ! fakesink appsrc "
                        f"name=s0 caps={vcaps.format(f='I420')} ! m.video_0 "
                        f"appsrc name=s1 caps={acaps} ! m.audio_0", d, batch,
                        {"s0": video("I420", seed), "s1": audio(seed + 1)})
        got = [cont_launch(desc, d, batch) for desc in (
            f"uridecodebin uri=file://{avi} ! appsink name=out",
            f"decodebin name=d uri=file://{mkv} {av}")]
        pb = element_factory_make("playbin", uri=f"file://{avi}")
        pb.device = d
        pipe, sink = pb.build_pipeline()
        pipe.run()
        got.append([bc_plain(s.buffer.data) for s in drain(sink)])
        return files(tmp), got
    return [
        ("avimux/avidemux", mux_demux("avimux", "avi", [v_i420, a_s16], [
            "avidemux location={p} ! appsink name=out",
            "avidemux location={p} stream=audio ! appsink name=out"])),
        ("avimux h264", mux_demux("avimux", "avi", [v_h264], [
            "avidemux location={p} ! appsink name=out"])),
        ("matroskamux/matroskademux", mux_demux(
            "matroskamux", "mkv", [v_i420, a_s16, text],
            ["matroskademux name=d location={p} " + av,
             "matroskademux name=d location={p} d.subtitle_0 ! "
             "appsink name=out2 " + av])),
        ("webmmux", mux_demux("webmmux", "webm", [v_i420, a_s16], [
            "matroskademux location={p} stream=audio ! appsink name=out"])),
        ("mxfmux/mxfdemux", mux_demux("mxfmux", "mxf", [v_uyvy, a_s16], [
            "mxfdemux name=d location={p} " + av])),
        ("qtmux/qtdemux", mux_demux("qtmux", "mov", [v_uyvy, a_s16], [
            "qtdemux name=d location={p} " + av])),
        ("cmafmux", mux_demux("cmafmux", "mp4", [v_h264, a_aac], [
            "qtdemux location={p} ! appsink name=out"])),
        ("fmp4mux", mux_demux("fmp4mux", "mp4", [v_h264, a_aac], [
            "qtdemux location={p} ! appsink name=out"])),
        ("qtmoovrecover", recover),
        ("rmdemux/rademux/pnmsrc", realmedia),
        ("typefind", typefind),
        ("uridecodebin/decodebin/playbin", playback)]


def container_alone(seed, counters, dev):
    """Each of the 19 container factories alone or as a writer and its
    reader on small inputs (cont_alone_rows), on the card and on the CPU:
    files, samples and element messages equal; no kernel launched."""
    import tempfile

    import torch
    from gstreamer_tpu_torch.core.element import list_factories
    rows = cont_alone_rows()
    for name, run in rows:
        res = {}
        for d in (dev, torch.device("cpu")):
            for c in counters.values():
                c.launches = 0
            with tempfile.TemporaryDirectory() as tmp:
                res[d.type] = run(d, tmp, seed)
            counts = {k: c.launches for k, c in counters.items()
                      if c.launches}
            require(not counts, f"{name}: launches {counts}")
        require(res[dev.type] == res["cpu"],
                f"{name}: the card's run differs from the CPU's")
    names = " ".join(n for n, _ in rows)
    mine = set(CONTAINER_FACTORIES)
    require(len(mine) == 19 and mine <= set(list_factories()),
            "the container factory list")
    missing = {f for f in mine if f not in names}
    require(not missing, f"factories not driven alone: {missing}")
    w, h, n, batch = CONT_ALONE
    print(f"containers each factory alone: CUDA == port CPU path (files, "
          f"samples, element messages) for the {len(mine)} factories in "
          f"{len(rows)} runs on {n} frames of {w}x{h} at batch {batch}; no "
          f"kernel launched")


def container_phase(seed, counters, dev):
    """Containers and multi-stream sources on the card, each path with the
    launch counts zeroed just before it and read just after: mkv_ingest
    (yscale_hv once a tick), mkv_uridecodebin (once a frame: the internal
    pipeline runs at batch 1), playbin's A/V build, mov_ingest and
    mxf_proxy (UYVY: the generic route, no kernel), then each factory
    alone (container_alone).  Files are written under a temporary
    directory and removed.  Returns {kernel: launches}."""
    import tempfile

    import torch
    cuda = dev.type == "cuda"
    total = {k: 0 for k in counters}

    def start(what):
        for c in counters.values():
            c.launches = 0
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            return torch.cuda.memory_allocated()
        return 0

    def finish(what, want):
        counts = {k: c.launches for k, c in counters.items()}
        require(counts == {k: want.get(k, 0) for k in counters},
                f"{what}: launches {counts}, want {want}")
        for k, v in counts.items():
            total[k] += v
        return {k: v for k, v in counts.items() if v}

    def peak(base):
        return (torch.cuda.max_memory_allocated() - base) / 2**20 if cuda \
            else 0.0

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mkv_paths(seed, dev, tmp, start, finish, peak)
        mov_mxf_paths(seed, dev, tmp, start, finish, peak)
    container_alone(seed, counters, dev)
    print(f"container phase: {time.perf_counter() - t0:.1f} s")
    return total


# -- 17. coded files: FLAC, Vorbis, MP3 and Theora -----------------------------

CODEC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                         "data", "torch_codecs")
CODEC_FILES = ("theora_1080p.ogv", "theora_vorbis_1080p.mkv",
               "vorbis_10s.ogg", "mp3_10s.mp3", "digests.json")
CODEC_BATCH = 8                     # theora_ingest's batch: the clip a tick
CODEC_FLAC_SECONDS = 10             # flac_asr: 48 kHz stereo S16
CODEC_PCM_TOL = 1e-6                # decoded PCM against the JAX digests
CODEC_ALONE = (64, 48, 4)           # width, height, frames of a factory alone
CODEC_FACTORIES = (
    "flacenc", "flacdec", "mpegaudioparse", "ac3parse", "flacparse",
    "sbcparse", "wavpackparse", "oggmux", "oggdemux", "vorbisdec",
    "vorbisenc", "theoradec", "theoraenc", "theoraparse", "opusparse",
    "mpg123audiodec")


def codec_vectors(names=CODEC_FILES):
    """The committed vectors' paths and their digests; a missing file
    fails the run."""
    missing = [f for f in names
               if not os.path.exists(os.path.join(CODEC_DIR, f))]
    require(not missing, f"codec vectors missing under {CODEC_DIR}: "
            f"{missing}")
    with open(os.path.join(CODEC_DIR, "digests.json")) as f:
        digests = json.load(f)
    return {f: os.path.join(CODEC_DIR, f) for f in names}, digests


def codec_pcm_check(name, pcm, dig):
    """Decoded float32 PCM (n, ch) against the JAX package's digest: the
    length exactly, the samples at the seeded positions and the RMS of each
    second within CODEC_PCM_TOL.  Returns the largest difference."""
    import numpy as np
    pcm = np.asarray(pcm, np.float32)
    require(pcm.shape == (dig["frames"], dig["channels"]),
            f"{name}: PCM {pcm.shape}, the JAX package's "
            f"({dig['frames']}, {dig['channels']})")
    want = np.frombuffer(bytes.fromhex(dig["values"]), "<f4").reshape(
        -1, dig["channels"])
    err = float(np.abs(pcm[dig["positions"]] - want).max())
    rate = dig["rate"]
    rms = [float(np.sqrt(np.mean(pcm[s:s + rate].astype(np.float64) ** 2)))
           for s in range(0, len(pcm), rate)]
    err = max(err, float(np.abs(np.array(rms) - dig["rms"]).max()))
    require(err <= CODEC_PCM_TOL, f"{name}: PCM differs from the JAX "
            f"package's by {err} (> {CODEC_PCM_TOL})")
    return err


def codec_planes_check(name, frames, dig):
    """Decoded Theora planes against libtheoradec's sha256 for every frame
    and the JAX package's for the frames its decoder gives (it loses sync
    at the first run of 30 in the coded-block flags; ROADMAP.md section
    3): exactly."""
    import hashlib

    import numpy as np
    got = [[hashlib.sha256(np.ascontiguousarray(p).tobytes()).hexdigest()
            for p in f] for f in frames]
    require(got == dig["libtheoradec"],
            f"{name}: decoded planes differ from libtheoradec's")
    require(got[:len(dig["jax"])] == dig["jax"],
            f"{name}: decoded planes differ from the JAX package's")
    return len(dig["jax"])


@contextlib.contextmanager
def codec_timed(targets, spent):
    """While the block runs, add to spent["decode"] the host seconds of
    every call of each (object, attribute) in `targets` (the decoders'
    entry points, wherever the elements call them: at negotiation or a
    tick)."""
    with contextlib.ExitStack() as stack:
        for obj, attr in targets:
            stack.enter_context(cont_timed(obj, attr, spent, "decode"))
        yield spent


def codec_path(name, desc, batch, dev, start, finish, peak, want, decoders,
               pushes=None, out=None, prepare=None):
    """One read path on the card: parse it, call `prepare(pipe)` if given,
    push `pushes` ({appsrc name: [Buffer]}, then end of stream) and start it (the decode of a collapsed
    decoder happens there, timed), then tick to EOS under
    torch.profiler, the launch counts zeroed just before and read just
    after (`want`, or `want(fed)` of the frames each tick gave).  Returns
    the sinks' samples ("v", "a": into `out` as each tick gives them, so
    that a caller keeps those before a fault) and its numbers: ticks, host
    seconds of decoding, set-up, device busy ms and idle share a tick,
    bytes copied H2D and D2H a tick, peak memory, launches, and each
    tick's host seconds and frames given (`tick_secs`, `fed`)."""
    import contextlib as cl

    from torch.profiler import ProfilerActivity, profile
    from gstreamer_tpu_torch import parse_launch
    cuda = dev.type == "cuda"
    spent, counts = {}, {"d2h": 0, "h2d": 0}
    base = start(name)
    with codec_timed(decoders, spent):
        sync(dev)
        t0 = time.perf_counter()
        pipe = parse_launch(desc, batch=batch, device=dev)
        if prepare is not None:
            prepare(pipe)
        push_all(pipe, pushes)
        pipe.set_state("playing")
        setup = time.perf_counter() - t0
    out = {"v": [], "a": []} if out is None else out
    secs, fed = [], []
    prof_cm = (profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
               if cuda else cl.nullcontext())
    try:
        with prof_cm as prof, codec_timed(decoders, spent), \
                copy_meter(counts):
            while True:
                sync(dev)
                t0 = time.perf_counter()
                more = pipe.tick()
                had = {k: len(v) for k, v in out.items()}
                cont_sinks(pipe, out)
                sync(dev)
                secs.append(time.perf_counter() - t0)
                fed.append(sum(x.buffer.batch for k, v in out.items()
                               for x in v[had[k]:]))
                if not more:
                    break
    finally:
        cont_sinks(pipe, out)
        pipe.set_state("null")
    launches = finish(name, want(fed) if callable(want) else want)
    n = len(secs)
    wall = sum(secs) / n * 1e3
    busy = union_busy(prof) / n if cuda else 0.0
    return pipe, out, dict(
        ticks=n, secs=sum(secs), setup=setup, decode=spent.get("decode", 0.0),
        wall=wall, busy=busy, idle=max(0.0, 1.0 - busy / wall),
        h2d=counts["h2d"] / n, d2h=counts["d2h"] / n, mem=peak(base),
        launches=launches, tick_secs=secs, fed=fed)


def codec_report(name, r, units, what):
    """One e2e line: `units` output units (frames, or input audio frames)
    over the ticks and over set-up and ticks together."""
    e2e = units / (r["setup"] + r["secs"])
    print(f"e2e {name}: {units / r['secs']:.1f} {what}/s over {r['ticks']} "
          f"ticks, {e2e:.1f} {what}/s with the set-up "
          f"({r['setup'] * 1e3:.3f} ms, parse and negotiation); host decode "
          f"{r['decode']:.3f} s; device busy {r['busy']:.3f} ms and idle "
          f"share {r['idle']:.3f} of a {r['wall']:.3f} ms tick (traced); "
          f"copied {r['h2d'] / 2**20:.3f} MiB H2D and {r['d2h'] / 2**20:.3f} "
          f"MiB D2H a tick; peak memory {r['mem']:.1f} MiB; kernel launches "
          f"{r['launches']}")


def codec_asr_ref(pcm_blocks, rate, ch, fmt="F32LE"):
    """The port's CPU run of the ASR chain (CONT_ASR) over host sample
    blocks: the same blocks a decoder gives, pushed into appsrc."""
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    pipe = parse_launch(
        f"appsrc name=in caps=audio/x-raw,format={fmt},rate={rate},"
        f"channels={ch},layout=interleaved ! {CONT_ASR}", batch=1,
        device="cpu")
    src, pos = pipe.get_by_name("in"), 0
    for x in pcm_blocks:
        src.push_buffer(Buffer(data=torch.from_numpy(x),
                               pts=pos * 10**9 // rate,
                               duration=len(x) * 10**9 // rate))
        pos += len(x)
    src.end_of_stream()
    pipe.run()
    return cont_joined(drain(pipe.get_by_name("a")))


def codec_audio_item(name, paths, dev, start, finish, peak, decoders, dig,
                     fmt="F32LE"):
    """An audio item: `paths` (launch strings before the ASR chain; the
    first is timed and gives the PCM) each ! CONT_ASR on the card.  The
    first path's PCM (read again by `paths[0] ! appsink`) is held to `dig`
    (the JAX digests, or the written samples), its ASR output to the port's
    CPU run over the same blocks, and every other path's ASR output to the
    first's."""
    import numpy as np
    import torch
    blocks = [s.buffer.data.cpu().numpy()
              for s in codec_run(f"{paths[0]} ! appsink name=a", dev)]
    pcm = np.concatenate(blocks)
    if isinstance(dig, dict):
        err = codec_pcm_check(name, pcm, dig)
        held = f"within {CODEC_PCM_TOL} of the JAX digests (max {err})"
    else:
        require(np.array_equal(pcm, dig),
                f"{name}: decoded samples differ from those written")
        held = "== the samples written"
    _, out, r = codec_path(name, f"{paths[0]} ! {CONT_ASR}", 1, dev, start,
                           finish, peak, {}, decoders)
    card = cont_joined(out["a"])
    cpu = codec_asr_ref(blocks, 48000, pcm.shape[1], fmt)
    require(card.dtype == torch.float32 and card.numel() > 0
            and bool(torch.isfinite(card).all()),
            f"{name}: ASR output {tuple(card.shape)}")
    require(torch.equal(card, cpu),
            f"{name}: the ASR output differs from the port's CPU run")
    for desc in paths[1:]:
        start(name)
        got = cont_joined(codec_run(f"{desc} ! {CONT_ASR}", dev))
        finish(name, {})
        require(got is not None and torch.equal(got, card),
                f"{name}: {desc.split()[0]}'s ASR output differs from "
                f"{paths[0].split()[0]}'s")
    codec_report(name, r, len(pcm), "audio frames")
    print(f"  {name}: {len(pcm) / 48000:.2f} s of {pcm.shape[1]}-channel "
          f"PCM {held}; host decode {r['decode'] * 1e3 / (len(pcm) / 48000):.3f} ms a "
          f"second of audio; the ASR output == the port's CPU run over the "
          f"same blocks; {', '.join(p.split()[0] for p in paths[1:])} == "
          f"{paths[0].split()[0]}'s")
    return pcm


def codec_run(desc, dev, batch=1, sink="a", pushes=None, got=None,
              prepare=None):
    """A launch string ending in appsink `sink` run to EOS on `dev` (its
    appsrcs given `pushes`: {name: [Buffer]}, then end of stream; after
    `prepare(pipe)` if given): its samples, added to `got` too, also those
    given before a fault."""
    from gstreamer_tpu_torch import parse_launch
    got = [] if got is None else got
    pipe = parse_launch(desc, batch=batch, device=dev)
    if prepare is not None:
        prepare(pipe)
    push_all(pipe, pushes)
    try:
        pipe.run()
    finally:
        got += drain(pipe.get_by_name(sink))
    return got


def flac_asr(seed, dev, tmp, start, finish, peak):
    """flacenc and oggmux write CODEC_FLAC_SECONDS of seeded 48 kHz stereo
    S16 pushed as card tensors (the files equal the CPU run's); flacdec,
    oggdemux and uridecodebin read them back to the ASR chain."""
    import torch
    from gstreamer_tpu_torch.codecs import flac as pyflac
    from gstreamer_tpu_torch.native import flac as nflac
    samples = cont_audio(CODEC_FLAC_SECONDS * 48000, seed)
    pushes = list(samples.reshape(CODEC_FLAC_SECONDS, 48000, 2))
    src = ("appsrc name=in caps=audio/x-raw,format=S16LE,rate=48000,"
           "channels=2,layout=interleaved")
    files = {}
    for mux, ext in (("flacenc", "flac"), ("oggmux", "ogg")):
        for d in (dev, torch.device("cpu")):
            path = os.path.join(tmp, f"{d.type}.{ext}")
            start("flac_write")
            asr_run(f"{src} ! {mux} location={path}", d, pushes)
            finish("flac_write", {})
            with open(path, "rb") as f:
                files[(ext, d.type)] = f.read()
        require(files[(ext, dev.type)] == files[(ext, "cpu")],
                f"flac_asr: {mux}'s file differs from the CPU run's")
    flac, ogg = (os.path.join(tmp, f"{dev.type}.{e}") for e in ("flac", "ogg"))
    codec_audio_item("flac_asr", [f"flacdec location={flac}",
                                  f"uridecodebin uri=file://{flac}"],
                     dev, start, finish, peak,
                     [(nflac, "decode"), (pyflac, "decode")], samples,
                     fmt="S16LE")
    codec_audio_item("flac_ogg_asr", [f"oggdemux location={ogg}",
                                      f"uridecodebin uri=file://{ogg}"],
                     dev, start, finish, peak,
                     [(nflac, "decode"), (pyflac, "decode")], samples,
                     fmt="S16LE")
    print(f"  flac_asr: {CODEC_FLAC_SECONDS} s written by flacenc "
          f"({len(files[('flac', 'cpu')])} bytes) and oggmux "
          f"({len(files[('ogg', 'cpu')])} bytes) from card tensors == the "
          f"CPU run's files")


def theora_item(name, desc, frames_of, dig, dev, start, finish, peak,
                decoders, also=()):
    """A Theora item at CODEC_BATCH: `desc` (a source giving I420 1080p,
    then CONT_RGB on "v"; CONT_ASR on "a" where the file has audio) on the
    card; the decoded planes (`frames_of(pipe)`) against the digests, the
    RGB against the port's CPU converter over the same decoded frames, and
    each launch string of `also` (video only) to the same RGB."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    ticks = -(-len(dig["libtheoradec"]) // CODEC_BATCH)
    pipe, out, r = codec_path(name, desc, CODEC_BATCH, dev, start, finish,
                              peak, {"yscale_hv": ticks}, decoders)
    frames = frames_of(pipe)
    jax_frames = codec_planes_check(name, frames, dig)
    w, h = dig["width"], dig["height"]
    n, d = dig["fps"]
    ref = parse_launch(
        f"appsrc name=in caps=video/x-raw,format=I420,width={w},height={h},"
        f"framerate={n}/{d} ! {CONT_RGB}", batch=CODEC_BATCH, device="cpu")
    for k in range(0, len(frames), CODEC_BATCH):
        take = frames[k:k + CODEC_BATCH]
        ref.get_by_name("in").push_buffer(Buffer(
            data=tuple(torch.from_numpy(np.stack([f[c] for f in take]))
                       for c in range(3)),
            batch=len(take), pts=k * 10**9 * d // n, duration=10**9 * d // n))
    ref.get_by_name("in").end_of_stream()
    ref.run()
    rgb = cont_joined(out["v"])
    require(cont_equal(rgb, cont_joined(drain(ref.get_by_name("v")))),
            f"{name}: RGB differs from the port's CPU converter over the "
            f"same decoded frames")
    require(all(p.shape == (len(frames), 224, 224) and p.dtype == torch.uint8
                for p in rgb), f"{name}: RGB planes' shape")
    for desc2 in also:
        start(name)
        got = cont_joined(codec_run(desc2, dev, CODEC_BATCH, "v"))
        finish(name, {"yscale_hv": ticks})
        require(cont_equal(got, rgb), f"{name}: {desc2.split()[0]}'s RGB "
                f"differs")
    codec_report(name, r, len(frames), "frames")
    print(f"  {name}: {len(frames)} {w}x{h} frames, planes == libtheoradec's "
          f"sha256 (all) and the JAX package's (the {jax_frames} before its "
          f"decoder loses sync); host decode {r['decode'] * 1e3 / len(frames):.1f} "
          f"ms a frame; RGB 224x224 == the port's CPU converter over the same "
          f"frames; yscale_hv {r['launches'].get('yscale_hv', 0)} launches in "
          f"{ticks} video ticks"
          + (f"; {', '.join(a.split()[0] for a in also)} == the same RGB"
             if also else ""))
    return pipe, out, r


def codec_paths(seed, dev, tmp, start, finish, peak):
    """flac_asr, vorbis_asr, mp3_asr, theora_ingest, theora_mkv_ingest."""
    import numpy as np
    from gstreamer_tpu_torch.codecs import mp3 as pmp3
    from gstreamer_tpu_torch.codecs import theora as ptheora
    from gstreamer_tpu_torch.codecs import vorbis as pvorbis
    files, dig = codec_vectors()
    flac_asr(seed, dev, tmp, start, finish, peak)
    ogg, mp3 = files["vorbis_10s.ogg"], files["mp3_10s.mp3"]
    codec_audio_item("vorbis_asr", [f"vorbisdec location={ogg}",
                                    f"oggdemux location={ogg}",
                                    f"uridecodebin uri=file://{ogg}"],
                     dev, start, finish, peak,
                     [(pvorbis, "decode_ogg")], dig["vorbis_ogg"])
    codec_audio_item("mp3_asr", [f"filesrc location={mp3} ! mpegaudioparse "
                                 f"! mpg123audiodec",
                                 f"uridecodebin uri=file://{mp3}"],
                     dev, start, finish, peak,
                     [(pmp3.MP3Decoder, "decode_frame")], dig["mp3"])
    ogv, mkv = files["theora_1080p.ogv"], files["theora_vorbis_1080p.mkv"]
    theora_item("theora_ingest", f"theoradec name=dec location={ogv} ! "
                f"{CONT_RGB}", lambda p: p.get_by_name("dec")._frames,
                dig["theora_ogv"], dev, start, finish, peak,
                [(ptheora.TheoraDecoder, "decode_packet")],
                also=(f"oggdemux location={ogv} stream=video ! {CONT_RGB}",))
    pipe, out, r = theora_item(
        "theora_mkv_ingest", f"matroskademux name=d location={mkv} "
        f"d.video_0 ! {CONT_RGB} d.audio_0 ! {CONT_ASR}",
        lambda p: p.get_by_name("d")._children["video_0"]._frames,
        dig["theora_mkv"], dev, start, finish, peak,
        [(ptheora.TheoraDecoder, "decode_packet")])
    import torch
    pcm = pipe.get_by_name("d")._children["audio_0"]._adata
    err = codec_pcm_check("theora_mkv_ingest", pcm, dig["vorbis_mkv"])
    cpu = codec_asr_ref([pcm[k:k + 4096] for k in range(0, len(pcm), 4096)],
                        48000, pcm.shape[1])
    require(torch.equal(cont_joined(out["a"]), cpu),
            "theora_mkv_ingest: the audio pad's ASR output differs from the "
            "port's CPU run over the same PCM")
    print(f"  theora_mkv_ingest: the audio pad's Vorbis PCM within "
          f"{CODEC_PCM_TOL} of the JAX digests (max {err}), its ASR output =="
          f" the port's CPU run over the same blocks; "
          f"{np.asarray(pcm).shape[0]} frames (its decode is in the "
          f"set-up)")


def codec_alone_rows():
    """The runs that drive each of the 16 codec factories alone or in a
    short chain on small inputs: [(name, fn(d, tmp, seed) -> plain data)].
    An encoder whose system library is absent raises the same
    RuntimeError on both devices (its message is the run's result)."""
    import struct

    import numpy as np
    from gstreamer_tpu_torch.elements import audioparsers as ap
    from gstreamer_tpu_torch.elements.ogg import parse_ogg_pages
    w, h, n = CODEC_ALONE
    files, _ = codec_vectors()
    acaps = ("appsrc name=in caps=audio/x-raw,format={f},rate=48000,"
             "channels=2,layout=interleaved")
    vcaps = (f"appsrc name=in caps=video/x-raw,format=I420,width={w},"
             f"height={h},framerate=25/1")

    def pcm(seed, fmt):
        x = cont_audio(9600, seed)
        if fmt == "F32LE":
            x = (x / 32768.0).astype(np.float32)
        return [dict(data=x[:4800], pts=0, duration=10**8),
                dict(data=x[4800:], pts=10**8, duration=10**8)]

    def frames(seed):
        planes = cont_video("I420", n, w, h, seed)
        return [dict(data=tuple(p[k:k + 2] for p in planes), batch=2,
                     pts=k * 40_000_000, duration=40_000_000)
                for k in range(0, n, 2)]

    def blobs(data, caps):
        return (f"appsrc name=in caps={caps}",
                [dict(data=np.frombuffer(data, np.uint8).copy(), pts=0)])

    def read(path):
        with open(path, "rb") as f:
            return f.read()

    def writer(enc, src, make, readers):
        def run(d, tmp, seed):
            path = os.path.join(tmp, "f.bin")
            try:
                cont_launch(f"{src} ! {enc} location={path}", d, 2,
                            {"in": make(seed)})
            except RuntimeError as e:       # the encoder's library absent
                return str(e)
            return read(path), [cont_launch(r.format(p=path), d, 2)
                                for r in readers]
        return run

    def parser(desc, data_of):
        def run(d, tmp, seed):
            src, bufs = data_of(seed)
            return cont_launch(f"{src} ! {desc} ! appsink name=out", d, 1,
                               {"in": bufs})
        return run

    def ac3(seed):
        size, _ = ap.ac3_frame_info(bytes([0x0B, 0x77, 0, 0, 16]))
        frame = bytes([0x0B, 0x77, 0, 0, 16]) + bytes([seed % 256]) * (
            size - 5)
        return blobs(b"\x00\x01" + frame * 4, "application/octet-stream")

    def sbc(seed):
        out = b"garbage"
        for k in range(6):
            f = bytearray(ap.sbc_calc_framelen(8, 0, 8, 32))
            f[0], f[1], f[2] = 0x9C, (2 << 6) | (1 << 4) | 1, 32
            for i in range(4, len(f)):
                f[i] = (seed + k) % 256
            crc = bytearray(11)
            crc[0], crc[1] = f[1], f[2]
            for i in range(16, 48, 8):
                crc[i // 8] = f[1 + i // 8 + 1]
            f[3] = ap.sbc_crc8(bytes(crc), 48)
            out += bytes(f)
        return blobs(out, "audio/x-sbc")

    def wavpack(seed):
        out = b"xx"
        for k in range(4):
            out += b"wvpk" + struct.pack(
                "<IHBBIIIII", 24 + 64, 0x410, 0, 0, 12000, k * 3000, 3000,
                (9 << 23) | 0x1000, seed) + bytes(64)
        return blobs(out, "audio/x-wavpack")

    def theora_packets(seed):
        with open(files["theora_1080p.ogv"], "rb") as f:
            pkts = [p for _, _, ps in parse_ogg_pages(f.read()) for p in ps]
        return ("appsrc name=in caps=video/x-theora",
                [dict(data=[np.frombuffer(p, np.uint8).copy()], batch=1,
                      pts=k) for k, p in enumerate(pkts[:5])])

    def opus_packets(seed):
        tocs = [bytes([c << 3 | code, 3]) for c in (0, 3, 13, 17, 31)
                for code in range(4)]
        return ("appsrc name=in caps=audio/x-opus",
                [dict(data=[np.frombuffer(p, np.uint8).copy()], batch=1,
                      pts=k, duration=1) for k, p in enumerate(tocs)])

    def flac_bytes(seed):
        from gstreamer_tpu_torch.codecs import flac as pyflac
        x = cont_audio(5000, seed).astype(np.int64)
        return blobs(pyflac.encode(x, 48000, blocksize=1152),
                     "application/octet-stream")

    mp3 = files["mp3_10s.mp3"]
    return [
        ("flacenc/flacdec", writer("flacenc", acaps.format(f="S16LE"),
                                   lambda s: pcm(s, "S16LE"),
                                   ["flacdec location={p} ! appsink name=out"])),
        ("oggmux/oggdemux", writer("oggmux", acaps.format(f="S16LE"),
                                   lambda s: pcm(s, "S16LE"),
                                   ["oggdemux location={p} ! appsink name=out"])),
        ("vorbisenc/vorbisdec", writer(
            "vorbisenc", acaps.format(f="F32LE"), lambda s: pcm(s, "F32LE"),
            ["vorbisdec location={p} ! appsink name=out"])),
        ("theoraenc/theoradec", writer(
            "theoraenc", vcaps, frames,
            ["theoradec location={p} ! appsink name=out"])),
        ("flacparse", parser("flacparse", flac_bytes)),
        ("ac3parse", parser("ac3parse", ac3)),
        ("sbcparse", parser("sbcparse", sbc)),
        ("wavpackparse", parser("wavpackparse", wavpack)),
        ("theoraparse", parser("theoraparse", theora_packets)),
        ("opusparse", parser("opusparse", opus_packets)),
        ("mpegaudioparse/mpg123audiodec", lambda d, tmp, seed: [
            cont_launch(f"filesrc location={mp3} blocksize=20000 ! "
                        f"mpegaudioparse ! appsink name=out", d, 1),
            cont_launch(f"filesrc location={mp3} ! mpegaudioparse ! "
                        f"mpg123audiodec ! appsink name=out", d, 1)])]


def codec_alone(seed, counters, dev):
    """Each of the 16 codec factories alone or in a short chain on small
    inputs, on the card and on the CPU: files, samples and element messages
    equal; no kernel launched."""
    import tempfile

    import torch
    from gstreamer_tpu_torch.codecs import theora_enc, vorbis_enc
    from gstreamer_tpu_torch.core.element import list_factories
    rows = codec_alone_rows()
    for name, run in rows:
        res = {}
        for d in (dev, torch.device("cpu")):
            for c in counters.values():
                c.launches = 0
            with tempfile.TemporaryDirectory() as tmp:
                res[d.type] = run(d, tmp, seed)
            counts = {k: c.launches for k, c in counters.items()
                      if c.launches}
            require(not counts, f"{name}: launches {counts}")
        require(res[dev.type] == res["cpu"],
                f"{name}: the card's run differs from the CPU's")
    names = " ".join(n for n, _ in rows)
    mine = set(CODEC_FACTORIES)
    require(len(mine) == 16 and mine <= set(list_factories()),
            "the codec factory list")
    missing = {f for f in mine if f not in names}
    require(not missing, f"factories not driven alone: {missing}")
    libs = {"libvorbisenc": vorbis_enc.available(),
            "libtheoraenc": theora_enc.available()}
    print(f"codecs each factory alone: CUDA == port CPU path (files, "
          f"samples, element messages) for the {len(mine)} factories in "
          f"{len(rows)} runs; no kernel launched; system encoders present "
          f"(an absent one raises alike on both devices): {libs}")


def codec_phase(seed, counters, dev):
    """Coded files to the card, each path with the launch counts zeroed
    just before it and read just after: flac_asr (and FLAC in Ogg),
    vorbis_asr, mp3_asr (no kernel), theora_ingest and theora_mkv_ingest
    (yscale_hv once a video tick), then each factory alone (codec_alone).
    The FLAC files are written under a temporary directory and removed; the
    other vectors are the committed files under tests/data/torch_codecs/.
    Returns {kernel: launches}."""
    import tempfile

    import torch
    cuda = dev.type == "cuda"
    total = {k: 0 for k in counters}

    def start(what):
        for c in counters.values():
            c.launches = 0
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            return torch.cuda.memory_allocated()
        return 0

    def finish(what, want):
        counts = {k: c.launches for k, c in counters.items()}
        require(counts == {k: want.get(k, 0) for k in counters},
                f"{what}: launches {counts}, want {want}")
        for k, v in counts.items():
            total[k] += v
        return {k: v for k, v in counts.items() if v}

    def peak(base):
        return (torch.cuda.max_memory_allocated() - base) / 2**20 if cuda \
            else 0.0

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        codec_paths(seed, dev, tmp, start, finish, peak)
    codec_alone(seed, counters, dev)
    print(f"codec phase: {time.perf_counter() - t0:.1f} s")
    return total


# -- 18. Opus and AAC, and the device monitor ----------------------------------

OA_FILES = ("opus_10s.opus", "opus_voice_10s.opus", "aac_10s.aac",
            "heaac_10s.aac", "aac_10s.m4a", "digests.json")
OA_WEBM = (1920, 1080, 48, 16)      # webm_av_ingest: width, height, frames, batch
OA_MP4 = (1920, 1080, 32, 16)       # mp4_av_ingest: UYVY frames
OA_ALONE = (25, 20)                 # Opus packets, ADTS frames of a factory alone
OA_FACTORIES = ("opusdec", "opusenc", "faad", "aacparse")


def oa_routes(name, want):
    """The Opus packets by HybridOpusDecoder route since the last zeroing
    against `want` ({route: packets}); zeroes them again."""
    from gstreamer_tpu_torch.codecs import opus as popus
    got = {k: v for k, v in popus.ROUTES.items() if v}
    require(got == want, f"{name}: Opus packets by route {got}, want {want}")
    for k in popus.ROUTES:
        popus.ROUTES[k] = 0
    return got


@contextlib.contextmanager
def oa_uploads(blocks):
    """While the block runs, append to `blocks` every host array faad
    uploads (its decoded PCM, a tick at a time)."""
    from gstreamer_tpu_torch.elements import aacdec
    upload = aacdec.device_array

    def recorded(a, like):
        blocks.append(a)
        return upload(a, like)
    aacdec.device_array = recorded
    try:
        yield blocks
    finally:
        aacdec.device_array = upload


def oa_chunks(pcm, size=4096):
    return [pcm[k:k + size] for k in range(0, len(pcm), size)]


def oa_audio_item(name, paths, dig, dev, start, finish, peak, decoders):
    """An audio item: each of `paths` (a launch string before the ASR
    chain, with `blocks(pipe, uploads)` giving the PCM blocks its decoder
    handed on, None where the decoder runs inside uridecodebin) !
    CONT_ASR on the card, the launch counts zeroed just before each and
    read just after.  The first path's PCM is held to the JAX digests
    `dig` (within CODEC_PCM_TOL), every other path's PCM to the first's
    (tolerance 0: the same host decode run again); each path's ASR output
    to the port's CPU run of the chain over the same blocks, or, with no
    blocks, to the first path's.  Opus paths' packets are counted by route
    (dig["routes"] a decode).  Returns the first path's PCM."""
    import numpy as np
    import torch
    first, card0 = None, None
    for k, (desc, blocks_of) in enumerate(paths):
        uploads = []
        with oa_uploads(uploads):
            pipe, out, r = codec_path(name, f"{desc} ! {CONT_ASR}", 1, dev,
                                      start, finish, peak, {}, decoders)
        card = cont_joined(out["a"])
        require(card is not None and card.dtype == torch.float32
                and card.numel() > 0 and bool(torch.isfinite(card).all()),
                f"{name}: {desc.split()[0]}'s ASR output")
        routes = (oa_routes(f"{name} ({desc.split()[0]})", dig["routes"])
                  if "routes" in dig else None)
        blocks = blocks_of(pipe, uploads)
        if blocks is None:
            require(torch.equal(card, card0), f"{name}: "
                    f"{desc.split()[0]}'s ASR output differs from "
                    f"{paths[0][0].split()[0]}'s")
            held = f"ASR output == {paths[0][0].split()[0]}'s"
        else:
            pcm = np.concatenate(blocks)
            if first is None:
                first = pcm
                err = codec_pcm_check(name, pcm, dig)
                held = (f"PCM within {CODEC_PCM_TOL} of the JAX digests "
                        f"(max {err})")
            else:
                require(np.array_equal(pcm, first), f"{name}: "
                        f"{desc.split()[0]}'s PCM differs from "
                        f"{paths[0][0].split()[0]}'s")
                held = f"PCM == {paths[0][0].split()[0]}'s"
            cpu = codec_asr_ref(blocks, dig["rate"], pcm.shape[1])
            require(torch.equal(card, cpu), f"{name}: {desc.split()[0]}'s "
                    f"ASR output differs from the port's CPU run over the "
                    f"same blocks")
            held += "; ASR output == the port's CPU run over the same blocks"
        if k == 0:
            card0 = card
        label = name if k == 0 else f"{name}[{desc.split()[0]}]"
        codec_report(label, r, len(first), "audio frames")
        print(f"  {label}: {len(first) / dig['rate']:.2f} s of "
              f"{first.shape[1]}-channel PCM; {held}; host decode "
              f"{r['decode'] / (len(first) / dig['rate']):.4f} s a second "
              f"of audio"
              + (f"; Opus packets by route {routes}" if routes else ""))
    return first


def oa_collapsed(pipe, uploads):
    """A collapsed decoder's (opusdec, oggdemux: element d) blocks."""
    d = pipe.get_by_name("d")
    return oa_chunks(d._samples, d.props["blocksize"])


def oa_asr(dev, start, finish, peak, files, dig):
    """opus_asr, opus_voice_asr, aac_asr, heaac_asr; returns the PCM of
    opus_asr and of aac_asr's MP4 path."""
    from gstreamer_tpu_torch.codecs import aac as paac
    from gstreamer_tpu_torch.codecs import opus as popus
    for k in popus.ROUTES:
        popus.ROUTES[k] = 0
    opus_dec = [(popus.HybridOpusDecoder, "decode")]
    aac_dec = [(paac.AACDecoder, "decode_frame")]
    pcm = {}
    for name, f, key in (("opus_asr", "opus_10s.opus", "opus_ogg"),
                         ("opus_voice_asr", "opus_voice_10s.opus",
                          "opus_voice")):
        path = files[f]
        pcm[name] = oa_audio_item(name, [
            (f"opusdec name=d location={path}", oa_collapsed),
            (f"oggdemux name=d location={path}", oa_collapsed),
            (f"uridecodebin uri=file://{path}", lambda p, u: None)],
            dig[key], dev, start, finish, peak, opus_dec)
    for name, f, key in (("aac_asr", "aac_10s.aac", "aac_adts"),
                         ("heaac_asr", "heaac_10s.aac", "heaac_adts")):
        pcm[name] = oa_audio_item(name, [
            (f"filesrc location={files[f]} ! aacparse ! faad",
             lambda p, u: u)], dig[key], dev, start, finish, peak, aac_dec)
    pcm["aac_m4a"] = oa_audio_item("aac_m4a_asr", [
        (f"qtdemux name=d location={files['aac_10s.m4a']} stream=audio",
         lambda p, u: [p.get_by_name("d")._adata])], dig["aac_m4a"], dev,
        start, finish, peak, aac_dec)
    return pcm


def oa_write(mux, path, fmt, planes, acaps, blobs, batch, d):
    """`mux` writes the planes (video_0, tensors on `d`, `batch` frames a
    tick) and the coded audio blobs (audio_0, host bytes, spread evenly
    over the ticks); returns the seconds it took."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    n, h, w = planes[0].shape[:3]
    ticks = -(-n // batch)
    per = -(-len(blobs) // ticks)
    dur = 10**9 // CONT_FPS
    pipe = parse_launch(
        f"{mux} name=m location={path} ! fakesink appsrc name=v caps=video/"
        f"x-raw,format={fmt},width={w},height={h},framerate={CONT_FPS}/1 ! "
        f"m.video_0 appsrc name=a caps={acaps} ! m.audio_0", batch=batch,
        device=d)
    sync(d)
    t0 = time.perf_counter()
    for t in range(ticks):
        k = t * batch
        pipe.get_by_name("v").push_buffer(Buffer(
            data=tuple(torch.from_numpy(p[k:k + batch]).to(d)
                       for p in planes), batch=batch, pts=k * dur,
            duration=dur))
        part = blobs[t * per:(t + 1) * per]
        if part:
            pipe.get_by_name("a").push_buffer(Buffer(
                data=[np.frombuffer(b, np.uint8).copy() for b in part],
                batch=len(part), pts=k * dur, duration=batch * dur))
    for s in ("v", "a"):
        pipe.get_by_name(s).end_of_stream()
    pipe.run()
    sync(d)
    return time.perf_counter() - t0


def oa_av_item(name, mux, demux, fmt, size, acaps, blobs, dig, pcm_of,
               want_pcm, decoders, want, dev, tmp, seed, start, finish,
               peak):
    """`mux` writes seeded 1080p `fmt` frames from card tensors and the
    coded audio blobs (the file equals the CPU run's); `demux` reads both
    pads: video to RGB 224x224 (the port's CPU converter over the same
    frames), audio into the ASR chain (its PCM, `pcm_of(pcm)`, within
    CODEC_PCM_TOL of the JAX digests and equal to `want_pcm`, the same
    decode from the audio item; the chain the port's CPU run over the same
    blocks).  `want`: the launches of the read."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    w, h, n, batch = size
    planes = cont_video(fmt, n, w, h, seed)
    paths = {}
    for d in (dev, torch.device("cpu")):
        paths[d.type] = os.path.join(tmp, f"{name}.{d.type}")
        start(name + "_write")
        secs = oa_write(mux, paths[d.type], fmt, planes, acaps, blobs,
                        batch, d)
        finish(name + "_write", {})
        if d is dev:
            write_fps = n / secs
    with open(paths[dev.type], "rb") as f, open(paths["cpu"], "rb") as g:
        require(f.read() == g.read(),
                f"{name}: {mux}'s file differs from the CPU run's")
    pipe, out, r = codec_path(
        name, f"{demux} name=d location={paths[dev.type]} d.video_0 ! "
        f"{CONT_RGB} d.audio_0 ! {CONT_ASR}", batch, dev, start, finish,
        peak, want, decoders)
    adata = np.asarray(pipe.get_by_name("d")._children["audio_0"]._adata)
    pcm = pcm_of(adata)
    err = codec_pcm_check(name, pcm, dig)
    require(np.array_equal(pcm, want_pcm),
            f"{name}: the demuxed PCM differs from the file's decode")
    blocks = ([adata] if demux == "qtdemux" else oa_chunks(adata))
    require(torch.equal(cont_joined(out["a"]),
                        codec_asr_ref(blocks, dig["rate"], adata.shape[1])),
            f"{name}: the audio pad's ASR output differs from the port's "
            f"CPU run over the same blocks")
    ref = parse_launch(
        f"appsrc name=in caps=video/x-raw,format={fmt},width={w},height={h},"
        f"framerate={CONT_FPS}/1 ! {CONT_RGB}", batch=batch, device="cpu")
    for k in range(0, n, batch):
        ref.get_by_name("in").push_buffer(Buffer(
            data=tuple(torch.from_numpy(p[k:k + batch]) for p in planes),
            batch=batch, pts=k * 10**9 // CONT_FPS,
            duration=10**9 // CONT_FPS))
    ref.get_by_name("in").end_of_stream()
    ref.run()
    rgb = cont_joined(out["v"])
    require(cont_equal(rgb, cont_joined(drain(ref.get_by_name("v")))),
            f"{name}: RGB differs from the port's CPU converter over the "
            f"same frames")
    require(all(p.shape == (n, 224, 224) and p.dtype == torch.uint8
                for p in rgb), f"{name}: RGB planes' shape")
    codec_report(name, r, n, "frames")
    print(f"  {name}: {mux} wrote {n} {w}x{h} {fmt} frames from card tensors "
          f"and {len(blobs)} coded audio packets at {write_fps:.1f} frames/s "
          f"(the file == the CPU run's); the audio pad's PCM "
          f"({len(adata)} frames) within {CODEC_PCM_TOL} of the JAX digests "
          f"(max {err}) and == the file's own decode, its ASR output == the "
          f"port's CPU run; RGB 224x224 == the port's CPU converter; "
          f"launches {r['launches']} in {-(-n // batch)} video ticks")


def oa_av(seed, dev, tmp, start, finish, peak, files, dig, pcm):
    """webm_av_ingest (I420 + Opus in Matroska: yscale_hv once a video
    tick) and mp4_av_ingest (UYVY + AAC in MP4: the generic route, no
    kernel)."""
    from gstreamer_tpu_torch.codecs import aac as paac
    from gstreamer_tpu_torch.codecs import opus as popus
    from gstreamer_tpu_torch.elements.ogg import parse_ogg_pages
    with open(files["opus_10s.opus"], "rb") as f:
        pkts = [p for _, _, ps in parse_ogg_pages(f.read()) for p in ps]
    _ch, pre_skip, _rate, _gain = popus.parse_opus_head(pkts[0])
    opus = pkts[2:]
    n_pcm = dig["opus_ogg"]["frames"]
    oa_av_item("webm_av_ingest", "matroskamux", "matroskademux", "I420",
               OA_WEBM, "audio/x-opus,rate=48000,channels=2", opus,
               dig["opus_ogg"], lambda a: a[pre_skip:pre_skip + n_pcm],
               pcm["opus_asr"], [(popus.HybridOpusDecoder, "decode")],
               {"yscale_hv": -(-OA_WEBM[2] // OA_WEBM[3])}, dev, tmp, seed,
               start, finish, peak)
    oa_routes("webm_av_ingest", {"celt": len(opus)})
    units = aac_units(files["aac_10s.aac"])
    oa_av_item("mp4_av_ingest", "qtmux", "qtdemux", "UYVY", OA_MP4,
               "audio/mpeg,mpegversion=4,stream-format=raw,rate=48000,"
               "channels=2", units, dig["aac_m4a"], lambda a: a,
               pcm["aac_m4a"], [(paac.AACDecoder, "decode_frame")], {}, dev,
               tmp, seed + 1, start, finish, peak)


def device_monitor(dev, start, finish):
    """The port's DeviceMonitor on the card: gpu:0 with its memory
    statistics (cpu:0 without a card), and each test device's element run
    for a tick on the card (the same sample as on the CPU)."""
    import torch
    from gstreamer_tpu_torch.core.device import DeviceMonitor
    from gstreamer_tpu_torch.core.element import element_factory_make
    from gstreamer_tpu_torch.core.pipeline import Pipeline, link
    start("device_monitor")
    mon = DeviceMonitor()
    mon.start()
    devs = mon.get_devices()
    mon.stop()
    rows = [(d.name, d.device_class) for d in devs]
    accel = [d for d in devs if d.device_class.startswith("Compute/")]
    want = ([(f"gpu:{i}", "Compute/GPU", torch.device("cuda", i))
             for i in range(torch.cuda.device_count())]
            if dev.type == "cuda" else
            [("cpu:0", "Compute/CPU", torch.device("cpu"))])
    require([(d.name, d.device_class, d.properties["device"])
             for d in accel] == want, f"device_monitor: {rows}")
    stats = accel[0].properties["memory_stats"]()
    require(dev.type != "cuda" or "allocated_bytes.all.current" in stats,
            f"device_monitor: {accel[0].name}'s memory statistics")
    mon = DeviceMonitor()
    mon.add_filter(classes="Source")
    ran = []
    for device in mon.get_devices():
        got = {}
        for d in (dev, torch.device("cpu")):
            el = device.create_element(name="src")
            el.set_property("num-buffers", 1)
            pipe = Pipeline(device=d)
            sink = element_factory_make("appsink", name="out")
            pipe.add(el, sink)
            link(el, sink)
            pipe.run()
            sample = sink.pull_sample()
            require(sample is not None, f"device_monitor: {device.name} "
                    f"gave no sample on {d.type}")
            got[d.type] = (str(sample.caps), bc_plain(sample.buffer.data))
            leaves = (sample.buffer.data if isinstance(
                sample.buffer.data, (tuple, list)) else [sample.buffer.data])
            require(all(x.device.type == d.type for x in leaves),
                    f"device_monitor: {device.name}'s sample is not on "
                    f"{d.type}")
        require(got[dev.type] == got["cpu"], f"device_monitor: "
                f"{device.name}'s tick on the card differs from the CPU's")
        ran.append(el.FACTORY)
    finish("device_monitor", {})
    require(sorted(ran) == ["audiotestsrc", "videotestsrc"],
            f"device_monitor: the test devices made {ran}")
    print(f"device_monitor: {rows}; {accel[0].name} memory statistics "
          f"({len(stats)} keys, "
          f"{stats.get('allocated_bytes.all.current', 0) / 2**20:.1f} MiB "
          f"allocated); {', '.join(ran)} from the test devices each ran a "
          f"tick on the card == the CPU's")


def oa_alone_rows(files):
    """The runs that drive opusdec, opusenc, faad and aacparse alone on
    short inputs cut from the committed vectors: [(name, fn(d, tmp, seed)
    -> plain data)].  opusenc raises the same RuntimeError on both devices
    where the system libopus is absent."""
    import numpy as np
    from gstreamer_tpu_torch.codecs import aac as paac
    from gstreamer_tpu_torch.elements.ogg import ogg_page, parse_ogg_pages
    n_opus, n_aac = OA_ALONE

    def short_opus(tmp):
        with open(files["opus_10s.opus"], "rb") as f:
            pkts = [p for _, _, ps in parse_ogg_pages(f.read()) for p in ps]
        pages = [ogg_page([pkts[0]], 7, 0, 0, bos=True),
                 ogg_page([pkts[1]], 7, 1, 0)]
        for k, p in enumerate(pkts[2:2 + n_opus]):
            pages.append(ogg_page([p], 7, k + 2, (k + 1) * 960,
                                  eos=k == n_opus - 1))
        path = os.path.join(tmp, "short.opus")
        with open(path, "wb") as f:
            f.write(b"".join(pages))
        return path

    def short_aac(tmp):
        with open(files["aac_10s.aac"], "rb") as f:
            data = f.read()
        pos = 0
        for _ in range(n_aac):
            pos += paac.parse_adts_header(data, pos)[0]
        path = os.path.join(tmp, "short.aac")
        with open(path, "wb") as f:
            f.write(data[:pos])
        return path

    def opusenc(d, tmp, seed):
        x = cont_audio(4800, seed)
        try:
            return cont_launch(
                "appsrc name=in caps=audio/x-raw,format=S16LE,rate=48000,"
                "channels=2,layout=interleaved ! opusenc ! appsink name=out",
                d, 1, {"in": [dict(data=x[:2400], pts=0, duration=5 * 10**7),
                              dict(data=x[2400:], pts=5 * 10**7,
                                   duration=5 * 10**7)]})
        except RuntimeError as e:           # the system libopus absent
            return str(e)

    return [
        ("opusdec", lambda d, tmp, seed: cont_launch(
            f"opusdec location={short_opus(tmp)} ! appsink name=out", d, 1)),
        ("opusenc", opusenc),
        ("aacparse/faad", lambda d, tmp, seed: [
            cont_launch(f"filesrc location={short_aac(tmp)} blocksize=1500 "
                        f"! aacparse ! appsink name=out", d, 1),
            cont_launch(f"filesrc location={short_aac(tmp)} ! aacparse ! "
                        f"faad ! appsink name=out", d, 1)])]


def oa_alone(seed, counters, dev, files):
    """Each of the slice's four factories alone on short inputs, on the
    card and on the CPU: samples, packets and messages equal; no kernel
    launched."""
    import tempfile

    import torch
    from gstreamer_tpu_torch.codecs import opus as popus
    from gstreamer_tpu_torch.core.element import list_factories
    rows = oa_alone_rows(files)
    for name, run in rows:
        res = {}
        for d in (dev, torch.device("cpu")):
            for c in counters.values():
                c.launches = 0
            with tempfile.TemporaryDirectory() as tmp:
                res[d.type] = run(d, tmp, seed)
            counts = {k: c.launches for k, c in counters.items()
                      if c.launches}
            require(not counts, f"{name}: launches {counts}")
        require(res[dev.type] == res["cpu"],
                f"{name}: the card's run differs from the CPU's")
    for k in popus.ROUTES:
        popus.ROUTES[k] = 0
    mine = set(OA_FACTORIES)
    require(mine <= set(list_factories()), "the Opus/AAC factory list")
    names = " ".join(n for n, _ in rows)
    require(all(f in names for f in mine),
            f"factories not driven alone: {mine}")
    print(f"opus/aac each factory alone: CUDA == port CPU path (samples, "
          f"packets, element messages) for {sorted(mine)} in {len(rows)} "
          f"runs; no kernel launched; system libopus present: "
          f"{popus.available()} (opusenc without it raises alike on both "
          f"devices)")


def opus_aac_phase(seed, counters, dev):
    """Opus and AAC to the card, each path with the launch counts zeroed
    just before it and read just after: opus_asr and opus_voice_asr
    (opusdec, oggdemux, uridecodebin), aac_asr and heaac_asr (filesrc !
    aacparse ! faad), aac_m4a_asr (qtdemux), webm_av_ingest and
    mp4_av_ingest (written in the phase under a temporary directory), the
    device monitor, then each factory alone.  Returns {kernel: launches}."""
    import ctypes.util
    import tempfile

    import torch
    cuda = dev.type == "cuda"
    total = {k: 0 for k in counters}

    def start(what):
        for c in counters.values():
            c.launches = 0
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            return torch.cuda.memory_allocated()
        return 0

    def finish(what, want):
        counts = {k: c.launches for k, c in counters.items()}
        require(counts == {k: want.get(k, 0) for k in counters},
                f"{what}: launches {counts}, want {want}")
        for k, v in counts.items():
            total[k] += v
        return {k: v for k, v in counts.items() if v}

    def peak(base):
        return (torch.cuda.max_memory_allocated() - base) / 2**20 if cuda \
            else 0.0

    t0 = time.perf_counter()
    files, dig = codec_vectors(OA_FILES)
    from gstreamer_tpu_torch.native import celt as ncelt
    from gstreamer_tpu_torch.native import silk as nsilk
    t1 = time.perf_counter()
    shims = {"gtpu_celt": ncelt.get_lib() is not None,
             "gtpu_silk": nsilk.get_lib() is not None}
    print(f"opus/aac phase: the CELT and SILK shims built by g++ (outside "
          f"the decode times): {shims} in {time.perf_counter() - t1:.1f} s")
    print(f"opus/aac phase: ctypes.util.find_library('opus') = "
          f"{ctypes.util.find_library('opus')!r}; streams: opus_10s.opus "
          f"(Opus packets by route {dig['opus_ogg']['routes']}), "
          f"opus_voice_10s.opus ({dig['opus_voice']['routes']}) through "
          f"opusdec, oggdemux, uridecodebin and matroskamux/matroskademux; "
          f"aac_10s.aac and heaac_10s.aac through aacparse ! faad; "
          f"aac_10s.m4a through qtdemux; AAC-LC units through "
          f"qtmux/qtdemux")
    pcm = oa_asr(dev, start, finish, peak, files, dig)
    with tempfile.TemporaryDirectory() as tmp:
        oa_av(seed, dev, tmp, start, finish, peak, files, dig, pcm)
    device_monitor(dev, start, finish)
    oa_alone(seed, counters, dev, files)
    print(f"opus/aac phase: {time.perf_counter() - t0:.1f} s")
    return total


# -- 19. VP8/VP9, the transport containers, FLV, ASF, playback_extra -------------

VT_FILES = ("vp8_1080p.ivf", "vp9_1080p.webm", "aac_10s.aac", "mp3_10s.mp3",
            "aac_10s.m4a", "digests.json")
VT_ASF = (1920, 1080, 32, 16)       # asf_mjpeg_ingest: width, height, frames, batch
VT_Y4M = (1920, 1080, 32, 16)       # alphacolor_y4mdec's y4m file
VT_ALPHA = (1920, 1080, 16)         # alphacolor's RGBA batch
VT_VPX_BATCH = 8                    # vpx_ingest: the 8-frame clip a tick
VT_HLS_TARGET = 2                   # hls_segments: seconds a segment
VT_ALONE = (64, 48, 4)              # width, height, frames of a factory alone
VT_FACTORIES = (
    "h264parse", "mpegvideoparse", "ivfparse", "h265parse", "mpeg4videoparse",
    "av1parse", "vp9parse", "pngparse", "vp8dec", "vp9dec", "vp8enc",
    "vp9enc", "codecalphademux", "vp8alphadecodebin", "vp9alphadecodebin",
    "mpegtsmux", "tsdemux", "atscmux", "mpegpsmux", "mpegpsdemux", "mplex",
    "hlssink2", "hlssink", "dashsink", "flvmux", "flvdemux", "jpegparse",
    "jifmux", "asfmux", "asfparse", "asfdemux", "decodebin3", "parsebin",
    "playbin3", "playsink", "y4mdec", "alphacolor", "dtmfdetect")
VT_RGBA = ("RGBA", "BGRA", "ARGB", "ABGR")


def vt_panning(n, w, h, seed):
    """n seeded I420 frames of w x h panning over a scene (a gradient, a
    sine pattern, a coarse texture, flat boxes and light noise, as the
    committed codec vectors), as host planes (n, h, w), (n, h/2, w/2) x 2."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ph, pw = h + 2 * n + 2, w + 4 * n + 4
    yy, xx = np.mgrid[0:ph, 0:pw].astype(np.float32)
    y = (60 + 100 * xx / pw + 40 * yy / ph
         + 30 * np.sin(xx / 37.0) * np.cos(yy / 53.0))
    tex = rng.normal(0, 1, (ph // 16 + 1, pw // 16 + 1)).astype(np.float32)
    y += np.kron(tex, np.ones((16, 16), np.float32))[:ph, :pw] * 5
    for j in range(5):
        cx, cy = w * (1 + 3 * j) // 20, h * (1 + 3 * j) // 18
        y[cy:cy + h // 7, cx:cx + w // 9] = 40 + 35 * j
    y = np.clip(y + rng.normal(0, 1.0, y.shape), 0, 255).astype(np.uint8)
    u = np.clip(128 + 40 * np.sin(xx[::2, ::2] / 90.0), 0, 255
                ).astype(np.uint8)
    v = np.clip(128 + 40 * np.cos(yy[::2, ::2] / 70.0), 0, 255
                ).astype(np.uint8)
    out = ([], [], [])
    for k in range(n):
        dx, dy = 4 * k, 2 * k
        out[0].append(y[dy:dy + h, dx:dx + w])
        out[1].append(u[dy // 2:dy // 2 + h // 2, dx // 2:dx // 2 + w // 2])
        out[2].append(v[dy // 2:dy // 2 + h // 2, dx // 2:dx // 2 + w // 2])
    return tuple(np.ascontiguousarray(np.stack(p)) for p in out)


def vt_pushes(planes, batch, fps=25):
    dur = 10**9 // fps
    return [dict(data=tuple(p[k:k + batch] for p in planes), batch=batch,
                 pts=k * dur, duration=dur)
            for k in range(0, len(planes[0]), batch)]


def vt_timed(desc, d, batch, pushes=None):
    """cont_launch on `d`, synchronised: (its result, host seconds)."""
    sync(d)
    t0 = time.perf_counter()
    got = cont_launch(desc, d, batch, pushes)
    sync(d)
    return got, time.perf_counter() - t0


def vt_files(directory):
    """Every file a writer left in `directory`: {name: bytes}."""
    out = {}
    for n in sorted(os.listdir(directory)):
        with open(os.path.join(directory, n), "rb") as f:
            out[n] = f.read()
    return out


def vt_write_both(name, desc, batch, pushes, dev, tmp, start, finish):
    """`desc` with {dir} writes files on the card and on the CPU (each
    into a directory of its own, `pushes` as tensors on each device, the
    launch counts zeroed just before each and none wanted); the files must
    be the same bytes (ASF's random file ID masked).  Returns (the card's
    directory, its files, its host seconds)."""
    import torch
    got = []
    for k, d in enumerate((dev, torch.device("cpu"))):
        out = os.path.join(tmp, f"{name}.{k}")
        os.makedirs(out)
        start(f"{name}_write")
        _, secs = vt_timed(desc.format(dir=out), d, batch, pushes)
        finish(f"{name}_write", {})
        got.append((out, vt_files(out), secs))
    a, b = got[0][1], got[1][1]
    require(sorted(a) == sorted(b) and a, f"{name}: the writers' files "
            f"{sorted(a)} against the CPU run's {sorted(b)}")
    for n in a:
        require(vt_asf_masked(a[n]) == vt_asf_masked(b[n]),
                f"{name}: {n} differs from the CPU run's")
    return got[0]


def vt_asf_masked(blob):
    """An ASF file with its own 16-byte file ID (uuid4, at the File
    Properties object) zeroed wherever it occurs; other bytes as they are."""
    from gstreamer_tpu_torch.elements import asf
    i = blob.find(asf.GUID_FILE_PROPS)
    if not blob.startswith(asf.GUID_HEADER) or i < 0:
        return blob
    fid = blob[i + 24:i + 40]
    return blob.replace(fid, bytes(16))


@contextlib.contextmanager
def vt_uploads(module, blocks):
    """While the block runs, append to `blocks` every host array the
    elements of `module` upload with device_array (a decoder's PCM)."""
    upload = module.device_array

    def recorded(a, like):
        blocks.append(a)
        return upload(a, like)
    module.device_array = recorded
    try:
        yield blocks
    finally:
        module.device_array = upload


def vt_pcm(desc, dev):
    """The F32 PCM blocks a decode chain gives on `dev`, on the host."""
    return [s.buffer.data.cpu().numpy()
            for s in codec_run(f"{desc} ! appsink name=a", dev)]


def vt_path(name, desc, batch, dev, start, finish, peak, want, decoders,
            demux):
    """codec_path with the demuxer's create (`demux`: (class, "create"))
    timed apart: its numbers gain "create", host ms a tick."""
    spent = {}
    with cont_timed(*demux, spent, "create") if demux else \
            contextlib.nullcontext():
        pipe, out, r = codec_path(name, desc, batch, dev, start, finish,
                                  peak, want, decoders)
    r["create"] = spent.get("create", 0.0) * 1e3 / r["ticks"]
    return pipe, out, r


def vt_asr_item(name, desc, dev, start, finish, peak, decoders, want_pcm,
                upload_module, fmt="F32LE", held="", demux=None):
    """`desc` ! CONT_ASR on the card (no kernel wanted): the PCM the
    decoder handed on (recorded at its upload, or `desc` ! appsink again)
    equals `want_pcm` (the same decoder on the plain file; tolerance 0)
    and the ASR output equals the port's CPU run of the chain over the
    same blocks.  Returns (ASR output, numbers, pipeline)."""
    import numpy as np
    import torch
    blocks = []
    with vt_uploads(upload_module, blocks) if upload_module else \
            contextlib.nullcontext():
        pipe, out, r = vt_path(name, f"{desc} ! {CONT_ASR}", 1, dev, start,
                               finish, peak, {}, decoders, demux)
    if upload_module is None:
        blocks = vt_pcm(desc, dev)
    pcm = np.concatenate(blocks)
    require(np.array_equal(pcm, want_pcm), f"{name}: the decoded PCM "
            f"{pcm.shape} differs from the decoder's on the plain file "
            f"{np.shape(want_pcm)}")
    card = cont_joined(out["a"])
    require(card is not None and card.dtype == torch.float32
            and bool(torch.isfinite(card).all()), f"{name}: ASR output")
    require(torch.equal(card, codec_asr_ref(blocks, 48000, pcm.shape[1],
                                            fmt)),
            f"{name}: the ASR output differs from the port's CPU run over "
            f"the same blocks")
    codec_report(name, r, len(pcm), "audio frames")
    print(f"  {name}: {len(pcm) / 48000:.2f} s of {pcm.shape[1]}-channel "
          f"{fmt} PCM == the decoder's on the plain file{held}; the ASR "
          f"output == the port's CPU run over the same blocks; host decode "
          f"{r['decode'] / (len(pcm) / 48000) * 1e3:.3f} ms a second of "
          f"audio" + (f"; the demuxer's create {r['create']:.3f} ms a tick"
                      if demux else ""))
    return card, r, pipe


def vt_video_item(name, desc, batch, dev, start, finish, peak, decoders,
                  want, demux=None):
    """`desc` ! CONT_RGB on the card (`want` launches) and on the CPU: the
    RGB equals at tolerance 0.  Returns (RGB planes, numbers)."""
    import torch
    _, out, r = vt_path(name, f"{desc} ! {CONT_RGB}", batch, dev, start,
                        finish, peak, want, decoders, demux)
    rgb = cont_joined(out["v"])
    cpu = cont_joined(codec_run(f"{desc} ! {CONT_RGB}", torch.device("cpu"),
                                batch, "v"))
    require(rgb is not None and cont_equal(rgb, cpu),
            f"{name}: RGB differs from the port's CPU run")
    n = rgb[0].shape[0]
    require(all(p.shape == (n, 224, 224) and p.dtype == torch.uint8
                for p in rgb), f"{name}: RGB planes' shape")
    codec_report(name, r, n, "frames")
    if demux:
        print(f"  {name}: the demuxer's create {r['create']:.3f} ms a tick")
    return rgb, r


def asf_mjpeg_ingest(seed, dev, tmp, start, finish, peak):
    """32 seeded 1080p frames from card tensors through jpegenc and 10 s of
    48 kHz stereo S16LE into asfmux; asfdemux and asfparse read each stream
    (video through jpegdec to RGB 224x224 at batch 16, audio into the ASR
    chain); multifilesrc of the same JPEGs gives the same RGB; one JPEG
    through jpegparse ! jifmux."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch.elements import asf, image_codecs
    w, h, n, batch = VT_ASF
    planes = vt_panning(n, w, h, seed)
    audio = cont_audio(CONT_RATE * 10, seed)
    ticks = n // batch
    per = len(audio) // ticks
    vp = vt_pushes(planes, batch)
    ap = [dict(data=audio[t * per:(t + 1) * per], pts=vp[t]["pts"],
               duration=per * 10**9 // CONT_RATE) for t in range(ticks)]
    out, files, secs = vt_write_both(
        "asf_mjpeg_ingest",
        f"asfmux name=m location={{dir}}/av.asf appsrc name=v caps=video/"
        f"x-raw,format=I420,width={w},height={h},framerate={CONT_FPS}/1 ! "
        f"jpegenc ! m.video_0 appsrc name=a caps=audio/x-raw,format=S16LE,"
        f"rate={CONT_RATE},channels=2,layout=interleaved ! m.audio_0",
        batch, {"v": vp, "a": ap}, dev, tmp, start, finish)
    path = os.path.join(out, "av.asf")
    print(f"  asf_mjpeg_ingest: jpegenc ! asfmux wrote {n} {w}x{h} frames "
          f"and 10 s of audio from card tensors at {n / secs:.1f} frames/s "
          f"({len(files['av.asf']) / 2**20:.1f} MiB; the file == the CPU "
          f"run's but for its random file ID)")
    jdec = [(image_codecs.JpegDec, "_decode_all")]
    rgb = {}
    for f in ("asfdemux", "asfparse"):
        rgb[f], r = vt_video_item(
            f"asf_mjpeg_ingest[{f}]", f"{f} name=d location={path} "
            f"stream=video ! jpegdec", batch, dev, start, finish, peak, jdec,
            {"yscale_hv": ticks}, demux=(asf.AsfParse, "create"))
        print(f"  asf_mjpeg_ingest[{f}]: RGB 224x224 == the port's CPU run; "
              f"yscale_hv {r['launches']} in {ticks} video ticks; host "
              f"decode {r['decode'] / n * 1e3:.3f} ms a frame")
    require(cont_equal(rgb["asfdemux"], rgb["asfparse"]),
            "asf_mjpeg_ingest: asfparse's RGB differs from asfdemux's")
    blobs = [s.buffer.data for s in codec_run(
        f"asfdemux location={path} stream=video ! appsink name=a",
        torch.device("cpu"), batch)]
    blobs = [b for x in blobs for b in (x if isinstance(x, list) else [x])]
    jdir = os.path.join(tmp, "asf_jpegs")
    os.makedirs(jdir)
    for k, b in enumerate(blobs):
        with open(os.path.join(jdir, f"f_{k}.jpg"), "wb") as fh:
            fh.write(np.asarray(b).tobytes())
    start("asf_mjpeg_ingest[multifilesrc]")
    ref = cont_joined(codec_run(
        f"multifilesrc location={jdir}/f_%d.jpg caps=image/jpeg,framerate="
        f"{CONT_FPS}/1 ! jpegdec ! {CONT_RGB}", dev, batch, "v"))
    finish("asf_mjpeg_ingest[multifilesrc]", {"yscale_hv": ticks})
    require(len(blobs) == n and cont_equal(ref, rgb["asfdemux"]),
            "asf_mjpeg_ingest: multifilesrc of the same JPEGs gives other RGB")
    for f in ("asfdemux", "asfparse"):
        vt_asr_item(f"asf_mjpeg_ingest[{f} audio]", f"{f} name=d location="
                    f"{path} stream=audio", dev, start, finish, peak, [],
                    audio, None, fmt="S16LE", held=" (the samples written)",
                    demux=(asf.AsfParse, "create"))
    jpg = os.path.join(jdir, "f_0.jpg")
    res = {}
    for d in (dev, torch.device("cpu")):
        start("jpegparse ! jifmux")
        res[d.type] = cont_launch(f"filesrc location={jpg} ! jpegparse ! "
                                  f"jifmux ! appsink name=out", d, 1)
        finish("jpegparse ! jifmux", {})
    require(res[dev.type] == res["cpu"] and res["cpu"][0],
            "asf_mjpeg_ingest: jpegparse ! jifmux differs from the CPU run")
    print(f"  asf_mjpeg_ingest: multifilesrc of the {n} JPEGs gives the "
          f"same RGB (yscale_hv {ticks}); jpegparse ! jifmux of one frame "
          f"== the CPU run's")


def vt_ts_stats(path, demux):
    """The PCRs written in a transport stream, and tsdemux's section,
    continuity and PCR-discontinuity results."""
    with open(path, "rb") as f:
        data = f.read()
    pcrs = sum(1 for i in range(0, len(data) - 187, 188)
               if data[i + 3] & 0x20 and data[i + 4] > 0
               and data[i + 5] & 0x10)
    return dict(packets=len(data) // 188, pcrs=pcrs,
                sections=[s.section_type for _, s in demux.sections],
                cc_gaps=len(demux.cc_gaps),
                pcr_discontinuities=demux.pcr_discontinuities)


def ts_audio_ingest(seed, dev, tmp, start, finish, peak, files, dig):
    """mpegtsmux muxes the committed AAC (aacparse) and MP3
    (mpegaudioparse); tsdemux stream=0 ! aacparse ! faad, tsdemux stream=1
    ! mpegaudioparse ! mpg123audiodec and uridecodebin of the .ts each
    into the ASR chain.  Returns the plain files' PCM."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch.codecs import aac as paac
    from gstreamer_tpu_torch.codecs import mp3 as pmp3
    from gstreamer_tpu_torch.elements import aacdec, mpegaudio, mpegts
    aac, mp3 = files["aac_10s.aac"], files["mp3_10s.mp3"]
    plain = {"aac": np.concatenate(vt_pcm(
        f"filesrc location={aac} ! aacparse ! faad", dev)),
        "mp3": np.concatenate(vt_pcm(
            f"filesrc location={mp3} ! mpegaudioparse ! mpg123audiodec",
            dev))}
    err = max(codec_pcm_check("ts_audio_ingest", plain["aac"],
                              dig["aac_adts"]),
              codec_pcm_check("ts_audio_ingest", plain["mp3"], dig["mp3"]))
    out, written, secs = vt_write_both(
        "ts_audio_ingest",
        f"mpegtsmux name=m location={{dir}}/a.ts ! fakesink filesrc "
        f"location={aac} ! aacparse ! m.sink_0 filesrc location={mp3} ! "
        f"mpegaudioparse ! m.sink_1", 8, None, dev, tmp, start, finish)
    path = os.path.join(out, "a.ts")
    print(f"  ts_audio_ingest: mpegtsmux wrote 10 s of AAC and 10 s of MP3 "
          f"at {20 / secs:.1f} audio seconds/s ({len(written['a.ts'])} "
          f"bytes; the file == the CPU run's); the plain files' PCM within "
          f"{CODEC_PCM_TOL} of the JAX digests (max {err})")
    aac_dec = [(paac.AACDecoder, "decode_frame")]
    mp3_dec = [(pmp3.MP3Decoder, "decode_frame")]
    card, _, pipe = vt_asr_item(
        "ts_audio_ingest", f"tsdemux name=d location={path} stream=0 ! "
        f"aacparse ! faad", dev, start, finish, peak, aac_dec, plain["aac"],
        aacdec, demux=(mpegts.TsDemux, "create"))
    stats = vt_ts_stats(path, pipe.get_by_name("d"))
    require(stats["cc_gaps"] == 0 and stats["pcr_discontinuities"] == 0
            and stats["sections"] == ["pat", "pmt"],
            f"ts_audio_ingest: tsdemux's results {stats}")
    print(f"  ts_audio_ingest: {stats}")
    vt_asr_item("ts_audio_ingest[mp3]", f"tsdemux name=d location={path} "
                f"stream=1 ! mpegaudioparse ! mpg123audiodec", dev, start,
                finish, peak, mp3_dec, plain["mp3"], mpegaudio,
                demux=(mpegts.TsDemux, "create"))
    start("ts_audio_ingest[uridecodebin]")
    got = cont_joined(codec_run(f"uridecodebin uri=file://{path} ! "
                                f"{CONT_ASR}", dev))
    finish("ts_audio_ingest[uridecodebin]", {})
    require(got is not None and torch.equal(got, card),
            "ts_audio_ingest: uridecodebin's ASR output differs from "
            "tsdemux ! aacparse ! faad's")
    print("  ts_audio_ingest[uridecodebin]: the ASR output == tsdemux ! "
          "aacparse ! faad's")
    return plain, card


def ps_mp3_ingest(dev, tmp, start, finish, peak, files, plain):
    """mpegpsmux of the committed MP3, then mpegpsdemux stream=audio !
    mpegaudioparse ! mpg123audiodec into the ASR chain."""
    from gstreamer_tpu_torch.codecs import mp3 as pmp3
    from gstreamer_tpu_torch.elements import mpegaudio, mpegps
    out, written, secs = vt_write_both(
        "ps_mp3_ingest", f"filesrc location={files['mp3_10s.mp3']} ! "
        f"mpegaudioparse ! mpegpsmux location={{dir}}/a.mpg", 8, None, dev,
        tmp, start, finish)
    print(f"  ps_mp3_ingest: mpegpsmux wrote 10 s of MP3 at "
          f"{10 / secs:.1f} audio seconds/s ({len(written['a.mpg'])} bytes; "
          f"the file == the CPU run's)")
    vt_asr_item("ps_mp3_ingest", f"mpegpsdemux name=d location="
                f"{os.path.join(out, 'a.mpg')} stream=audio ! mpegaudioparse "
                f"! mpg123audiodec", dev, start, finish, peak,
                [(pmp3.MP3Decoder, "decode_frame")], plain["mp3"], mpegaudio,
                demux=(mpegps.MpegPsDemux, "create"))


def hls_segments(dev, tmp, start, finish, peak, files, plain, card_asr):
    """hlssink2 writes the committed AAC into VT_HLS_TARGET-second segments
    and a playlist (the files equal the CPU run's); tsdemux of the
    segments one after another gives the stream's bytes, whose decode is
    the whole stream's PCM and ASR output."""
    import torch
    from gstreamer_tpu_torch.codecs import aac as paac
    from gstreamer_tpu_torch.elements import aacdec
    aac = files["aac_10s.aac"]
    out, written, secs = vt_write_both(
        "hls_segments", f"filesrc location={aac} ! aacparse ! hlssink2 "
        f"location={{dir}}/seg%05d.ts playlist-location={{dir}}/p.m3u8 "
        f"target-duration={VT_HLS_TARGET}", 8, None, dev, tmp, start,
        finish)
    segs = sorted(n for n in written if n.endswith(".ts"))
    text = written["p.m3u8"].decode()
    require(len(segs) >= 10 // VT_HLS_TARGET and text.count("#EXTINF")
            == len(segs) and "#EXT-X-ENDLIST" in text,
            f"hls_segments: {segs} and the playlist {text!r}")
    start("hls_segments[read]")
    t0 = time.perf_counter()
    joined = b"".join(
        bytes(s.buffer.data.cpu().numpy().tobytes())
        for seg in segs for s in codec_run(
            f"tsdemux location={os.path.join(out, seg)} ! appsink name=a",
            dev))
    demux_s = time.perf_counter() - t0
    finish("hls_segments[read]", {})
    with open(aac, "rb") as f:
        require(joined == f.read(), "hls_segments: the segments' streams "
                "joined differ from the AAC file")
    path = os.path.join(tmp, "hls_joined.aac")
    with open(path, "wb") as f:
        f.write(joined)
    card, _, _ = vt_asr_item(
        "hls_segments", f"filesrc location={path} ! aacparse ! faad", dev,
        start, finish, peak, [(paac.AACDecoder, "decode_frame")],
        plain["aac"], aacdec, held=" (the segments demuxed in order)")
    require(torch.equal(card, card_asr), "hls_segments: the ASR output "
            "differs from ts_audio_ingest's")
    print(f"  hls_segments: hlssink2 wrote {len(segs)} segments and the "
          f"playlist at {10 / secs:.1f} audio seconds/s (== the CPU run's "
          f"files); tsdemux of the {len(segs)} segments in "
          f"{demux_s * 1e3:.1f} ms gives the file's {len(joined)} bytes")


def aac_units(path):
    """The access units of an ADTS file, without their headers (the units
    of aac_10s.m4a for the committed vector)."""
    from gstreamer_tpu_torch.codecs import aac as paac
    with open(path, "rb") as f:
        adts = f.read()
    units, pos = [], 0
    while pos + 7 <= len(adts):
        flen, _s, _c, _p, hlen = paac.parse_adts_header(adts, pos)
        units.append(adts[pos + hlen:pos + flen])
        pos += flen
    return units


AAC_FLVMUX = ("appsrc name=a caps=audio/mpeg,mpegversion=4,stream-format=raw,"
              "rate=48000,channels=2 ! flvmux location={path}")


def aac_flv_pushes(units, per=16):
    """appsrc a's buffers of AAC_FLVMUX: `per` units a buffer, stamped at
    1024 frames a unit of 48 kHz."""
    import numpy as np
    return {"a": [dict(data=[np.frombuffer(u, np.uint8).copy()
                             for u in units[k:k + per]],
                       batch=len(units[k:k + per]),
                       pts=k * 1024 * 10**9 // 48000,
                       duration=1024 * 10**9 // 48000)
                  for k in range(0, len(units), per)]}


def flv_aac_ingest(dev, tmp, start, finish, peak, files, dig):
    """The AAC access units (aac_10s.aac without its ADTS headers: the
    units of aac_10s.m4a) through flvmux, then flvdemux into the ASR
    chain; its PCM equals qtdemux's decode of aac_10s.m4a."""
    import numpy as np
    from gstreamer_tpu_torch.codecs import aac as paac
    from gstreamer_tpu_torch.core.element import element_factory_make
    from gstreamer_tpu_torch.elements import flv
    units = aac_units(files["aac_10s.aac"])
    out, _, secs = vt_write_both(
        "flv_aac_ingest", AAC_FLVMUX.format(path="{dir}/a.flv"), 1,
        aac_flv_pushes(units), dev, tmp, start, finish)
    print(f"  flv_aac_ingest: flvmux wrote {len(units)} AAC units at "
          f"{len(units) * 1024 / 48000 / secs:.1f} audio seconds/s (the "
          f"file == the CPU run's)")
    qt = element_factory_make("qtdemux", location=files["aac_10s.m4a"],
                              stream="audio")
    qt._load()
    want = np.asarray(qt._adata, np.float32)
    err = codec_pcm_check("flv_aac_ingest", want, dig["aac_m4a"])
    vt_asr_item("flv_aac_ingest", f"flvdemux name=d location="
                f"{os.path.join(out, 'a.flv')}", dev, start, finish, peak,
                [(paac.AACDecoder, "decode_frame")], want, None,
                held=f" (qtdemux of aac_10s.m4a, within {CODEC_PCM_TOL} of "
                f"the JAX digests: max {err})",
                demux=(flv.FlvDemux, "create"))


def vpx_ingest(dev, start, finish, peak, files, dig):
    """vp8dec of vp8_1080p.ivf and matroskademux of vp9_1080p.webm, each to
    RGB 224x224 (yscale_hv once a tick); the decoded planes against the
    JAX package's sha256."""
    import hashlib

    import numpy as np
    from gstreamer_tpu_torch.codecs import vpx
    b = VT_VPX_BATCH
    for name, desc, key in (
            ("vpx_ingest[vp8]", f"vp8dec location={files['vp8_1080p.ivf']}",
             "vpx_ivf"),
            ("vpx_ingest[vp9]", f"matroskademux name=d location="
             f"{files['vp9_1080p.webm']} stream=video", "vpx_webm")):
        start(name + "[planes]")
        samples = codec_run(f"{desc} ! appsink name=v", dev, b, "v")
        finish(name + "[planes]", {})
        frames = [tuple(p[k].cpu().numpy() for p in s.buffer.data)
                  for s in samples for k in range(s.buffer.batch)]
        got = [[hashlib.sha256(np.ascontiguousarray(p).tobytes()).hexdigest()
                for p in f] for f in frames]
        require(got == dig[key], f"{name}: decoded planes differ from the "
                f"JAX package's sha256")
        _, r = vt_video_item(name, desc, b, dev, start, finish, peak,
                             [(vpx.VpxDecoder, "decode")],
                             {"yscale_hv": -(-len(frames) // b)})
        print(f"  {name}: {len(frames)} planes sets == the JAX package's "
              f"sha256; RGB 224x224 == the port's CPU run; host decode "
              f"(libvpx and the row memmoves) {r['decode'] / len(frames) * 1e3:.3f}"
              f" ms a 1080p frame; yscale_hv {r['launches']}")


def alphacolor_y4mdec(seed, dev, tmp, start, finish, peak):
    """alphacolor on a batch of seeded 1080p RGBA frames to AYUV and back
    to each RGB order, on the card and the CPU (the same bytes); a y4m
    file through y4mdec to RGB 224x224 (yscale_hv once a tick)."""
    import numpy as np
    import torch
    w, h, n = VT_ALPHA
    rng = np.random.default_rng(seed)
    rgba = tuple(rng.integers(0, 256, (n, h, w), np.uint8) for _ in range(4))
    caps = (f"appsrc name=in caps=video/x-raw,format={{f}},width={w},"
            f"height={h},framerate={CONT_FPS}/1")
    res, ms = {}, {}
    for d in (dev, torch.device("cpu")):
        start("alphacolor")
        (got, _), secs = vt_timed(
            f"{caps.format(f='RGBA')} ! alphacolor ! appsink name=out", d, n,
            {"in": [dict(data=rgba, batch=n, pts=0, duration=40_000_000)]})
        finish("alphacolor", {})
        ayuv = got["out"][0]
        require("format=AYUV" in ayuv[3], f"alphacolor: caps {ayuv[3]}")
        res[d.type] = [ayuv]
        ms[d.type] = {"RGBA->AYUV": secs * 1e3}
        planes = tuple(np.frombuffer(x[3], np.uint8).reshape(x[2]).copy()
                       for x in ayuv[4][1])
        for f in VT_RGBA:
            (got, _), secs = vt_timed(
                f"{caps.format(f='AYUV')} ! alphacolor ! video/x-raw,"
                f"format={f} ! appsink name=out", d, n,
                {"in": [dict(data=planes, batch=n, pts=0,
                             duration=40_000_000)]})
            res[d.type].append(got["out"][0])
            ms[d.type][f"AYUV->{f}"] = secs * 1e3
    require(res[dev.type] == res["cpu"],
            "alphacolor: the card's bytes differ from the CPU's")
    print(f"e2e alphacolor: {n} {w}x{h} frames RGBA -> AYUV -> each of "
          f"{VT_RGBA} on the card == the CPU's bytes; frames/s with the "
          f"set-up, a launch string each (card) "
          f"{ {k: round(n / v * 1e3, 1) for k, v in ms[dev.type].items()} }"
          f", (CPU) "
          f"{ {k: round(n / v * 1e3, 1) for k, v in ms['cpu'].items()} }")
    w, h, n, b = VT_Y4M
    path = os.path.join(tmp, "a.y4m")
    write_y4m(path, n, seed)
    _, r = vt_video_item("alphacolor_y4mdec[y4mdec]", f"y4mdec location="
                         f"{path}", b, dev, start, finish, peak, [],
                         {"yscale_hv": n // b})
    print(f"  alphacolor_y4mdec[y4mdec]: {n} {w}x{h} frames; RGB 224x224 == "
          f"the port's CPU run; yscale_hv {r['launches']} in {n // b} ticks")


def vt_alone_rows(files):
    """The runs that drive each of the 38 factories alone or as a writer
    and its reader on small inputs: [(name, fn(d, tmp, seed) -> plain
    data)].  Without the system libvpx the VPx runs give the error both
    devices raise (the phase's first line says whether it is there)."""
    import struct

    import numpy as np
    import torch
    from gstreamer_tpu_torch.codecs import vpx
    from gstreamer_tpu_torch.codecs.png import png_encode
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.element import element_factory_make
    w, h, n = VT_ALONE
    vcaps = (f"appsrc name=in caps=video/x-raw,format=I420,width={w},"
             f"height={h},framerate=25/1")

    def frames(seed):
        return vt_pushes(cont_video("I420", n, w, h, seed), 2)

    def blob(data, pts=0):
        return [dict(data=np.frombuffer(data, np.uint8).copy(), pts=pts)]

    def head(path, k, size_of):
        with open(path, "rb") as f:
            data = f.read()
        pos = 0
        for _ in range(k):
            pos += size_of(data, pos)
        return data[:pos]

    def mp3_head(k=12):
        from gstreamer_tpu_torch.elements.audioparsers import mp3_frame_info
        return head(files["mp3_10s.mp3"], k,
                    lambda d, p: mp3_frame_info(d[p:p + 4])[0])

    def aac_head(k=60):
        from gstreamer_tpu_torch.codecs.aac import parse_adts_header
        return head(files["aac_10s.aac"], k,
                    lambda d, p: parse_adts_header(d, p)[0])

    def write(tmp, name, data):
        path = os.path.join(tmp, name)
        with open(path, "wb") as f:
            f.write(data)
        return path

    def read_all(directory):
        return {k: vt_asf_masked(v) for k, v in vt_files(directory).items()}

    def vpx_guard(fn):
        """A VPx run; without libvpx, the error both devices raise."""
        def run(d, tmp, seed):
            try:
                return fn(d, tmp, seed)
            except (RuntimeError, ValueError) as e:
                if vpx.available():
                    raise
                return f"{type(e).__name__}: {e}"
        return run

    sc = b"\x00\x00\x01"
    h264 = b"".join(sc + bytes([0x67, 66, 0, 31, 0xF4, 0x05, 0x01, 0xEC, 0x80])
                    + sc + bytes([0x65 if k == 0 else 0x41, 0x88, 0x84, k])
                    for k in range(4))
    h265 = b"".join(sc + bytes([0x40, 1, 0x0C, 1]) + sc
                    + bytes([0x26 if k == 0 else 0x02, 1, 0xAF, k])
                    for k in range(4))
    mpeg2 = (sc + b"\xb3" + bytes([w >> 4, ((w & 15) << 4) | (h >> 8),
                                   h & 255, 0x13]) + bytes(4)
             + b"".join(sc + b"\x00" + bytes([k]) * 16 for k in range(3)))
    mpeg4 = b"".join(sc + b"\xb6" + bytes([k << 6]) + bytes([k]) * 12
                     for k in range(4))
    av1 = b"".join(b"\x12\x00" + b"\x32\x05" + bytes([k]) * 5
                   for k in range(4))
    rng = np.random.default_rng(7)
    png = b"".join(png_encode(rng.integers(0, 256, (12, 16, 3), np.uint8))
                   for _ in range(3))
    ivf = (vpx.ivf_header("vp8", 32, 24, (30, 1), 3) + b"".join(
        struct.pack("<IQ", 23, k) + bytes([1, 2, 3]) + bytes(range(20))
        for k in range(3)))
    superframe = (b"\x11" * 10 + b"\x22" * 20 + bytes([0xC9]) + b"\x0a\x00"
                  + b"\x14\x00" + bytes([0xC9]))

    def parse(factory, data, caps="application/octet-stream", batch=1):
        return lambda d, tmp, seed: cont_launch(
            f"appsrc name=in ! {caps} ! {factory} ! appsink name=out", d,
            batch, {"in": blob(data)})

    def vpx_write(codec):
        def run(d, tmp, seed):
            path = os.path.join(tmp, "v.ivf")
            pk = cont_launch(f"{vcaps} ! {codec}enc location={path} ! "
                             f"appsink name=out", d, 2, {"in": frames(seed)})
            return pk, read_all(tmp), cont_launch(
                f"{codec}dec location={path} ! appsink name=out", d, 2)
        return run

    def alpha_bin(codec):
        def run(d, tmp, seed):
            y, u, v = (p[0] for p in cont_video("I420", 1, w, h, seed))
            pk = vpx.encode_frames(codec, [(y, u, v)], w, h)[0][0]
            apk = vpx.encode_frames(
                codec, [(np.full_like(y, 200), u, v)], w, h)[0][0]
            outs = []
            for meta in ({"alpha_data": apk}, {}):
                e = element_factory_make(f"{codec}alphadecodebin")
                e.device = d
                e.start()
                out = e.host_process(Buffer(data=np.frombuffer(pk, np.uint8),
                                            meta=dict(meta), batch=1))
                outs.append(bc_plain(out.data))
            e = element_factory_make("codecalphademux")
            e.device = d
            outs.append(bc_plain(e.host_process(Buffer(
                data=np.zeros(4, np.uint8), meta={"alpha_data": apk})).meta))
            return outs
        return run

    def ts(factory):
        def run(d, tmp, seed):
            cont_launch(f"appsrc name=in ! application/octet-stream ! "
                        f"mpegaudioparse ! {factory} location={tmp}/a.ts "
                        f"service-name=Svc", d, 4, {"in": blob(mp3_head())})
            return read_all(tmp), [cont_launch(
                f"tsdemux location={tmp}/a.ts stream={k} ! appsink name=out",
                d, 1) for k in (0,)]
        return run

    def ps(factory):
        def run(d, tmp, seed):
            cont_launch(f"appsrc name=in ! application/octet-stream ! "
                        f"mpegaudioparse ! {factory} location={tmp}/a.mpg",
                        d, 4, {"in": blob(mp3_head())})
            return read_all(tmp), cont_launch(
                f"mpegpsdemux location={tmp}/a.mpg stream=audio ! "
                f"appsink name=out", d, 1)
        return run

    def hls(factory, extra=""):
        def run(d, tmp, seed):
            src = write(tmp, "in.aac", aac_head())
            out = os.path.join(tmp, "out")
            os.makedirs(out)
            cont_launch(f"filesrc location={src} ! aacparse ! {factory} "
                        f"location={out}/s%03d.ts playlist-location="
                        f"{out}/p.m3u8 target-duration=1 "
                        f"{extra.format(out=out)}", d, 4)
            return read_all(out)
        return run

    def flv(d, tmp, seed):
        x = cont_audio(4410, seed)
        cont_launch(f"appsrc name=in caps=audio/x-raw,format=S16LE,rate=44100,"
                    f"channels=2,layout=interleaved ! flvmux location="
                    f"{tmp}/a.flv", d, 1,
                    {"in": [dict(data=x, pts=0, duration=10**8)]})
        return read_all(tmp), cont_launch(
            f"flvdemux location={tmp}/a.flv ! appsink name=out", d, 1)

    def jpegs(d, tmp, seed):
        cont_launch(f"{vcaps} ! jpegenc ! multifilesink location="
                    f"{tmp}/f_%d.jpg", d, 2, {"in": frames(seed)})
        one = os.path.join(tmp, "f_0.jpg")
        return read_all(tmp), cont_launch(
            f"filesrc location={one} ! jpegparse ! jifmux ! appsink "
            f"name=out", d, 1)

    def asf(d, tmp, seed):
        out = os.path.join(tmp, "out")
        os.makedirs(out)
        x = cont_audio(4800, seed)
        cont_launch(f"asfmux name=m location={out}/a.asf {vcaps} ! jpegenc ! "
                    f"m.video_0 appsrc name=a caps=audio/x-raw,format=S16LE,"
                    f"rate=48000,channels=2,layout=interleaved ! m.audio_0",
                    d, 2, {"in": frames(seed), "a": [
                        dict(data=x[:2400], pts=0, duration=5 * 10**7),
                        dict(data=x[2400:], pts=8 * 10**7,
                             duration=5 * 10**7)]})
        return read_all(out), [cont_launch(
            f"{f} location={out}/a.asf stream={s} ! appsink name=out", d, 2)
            for f in ("asfparse", "asfdemux") for s in ("video", "audio")]

    def y4m(d, tmp, seed):
        path = f"{tmp}/a.y4m"
        cont_launch(f"{vcaps} ! y4menc location={path}", d, 2,
                    {"in": frames(seed)})
        rows = [cont_launch(f"{f} location={path} ! appsink name=out", d, 2)
                for f in ("y4mdec",)]
        rows += [cont_launch(f"{f} uri=file://{path} ! appsink name=out", d,
                             2) for f in ("decodebin3", "parsebin")]
        pb = element_factory_make("playbin3", uri=f"file://{path}")
        pb.device = d
        pipe, sink = pb.build_pipeline()
        pipe.run()
        rows.append([bc_plain(s.buffer.data) for s in drain(sink)])
        return rows

    def playsink(d, tmp, seed):
        from gstreamer_tpu_torch import parse_launch
        pipe = parse_launch(f"{vcaps} ! playsink name=ps", batch=2, device=d)
        for b in frames(seed):
            pipe.get_by_name("in").push_buffer(Buffer(**dict(b, data=tuple(
                torch.from_numpy(p).to(d) for p in b["data"]))))
        pipe.get_by_name("in").end_of_stream()
        pipe.run()
        return pipe.get_by_name("ps").rendered

    def alphacolor(d, tmp, seed):
        r = np.random.default_rng(seed)
        x = tuple(r.integers(0, 256, (2, h, w), np.uint8) for _ in range(4))
        return [cont_launch(
            f"appsrc name=in caps=video/x-raw,format={f},width={w},"
            f"height={h},framerate=25/1 ! alphacolor ! appsink name=out", d,
            2, {"in": [dict(data=x, batch=2, pts=0, duration=4 * 10**7)]})
            for f in VT_RGBA + ("AYUV",)]

    def dtmf(d, tmp, seed):
        t = np.arange(800) / 8000
        x = np.concatenate([0.3 * (np.sin(2 * np.pi * 697 * t)
                                   + np.sin(2 * np.pi * 1209 * t)),
                            np.zeros(400)])
        x = np.round(x * 16000).astype(np.int16)[:, None]
        return cont_launch(
            "appsrc name=in caps=audio/x-raw,format=S16LE,rate=8000,"
            "channels=1,layout=interleaved ! dtmfdetect ! appsink name=out",
            d, 1, {"in": [dict(data=x, pts=0, duration=15 * 10**7)]})

    return [
        ("h264parse", parse("h264parse", h264)),
        ("mpegvideoparse", parse("mpegvideoparse", mpeg2)),
        ("h265parse", parse("h265parse", h265)),
        ("mpeg4videoparse", parse("mpeg4videoparse", mpeg4)),
        ("av1parse", parse("av1parse", av1)),
        ("pngparse", parse("pngparse", png)),
        ("ivfparse", parse("ivfparse", ivf, "video/x-ivf")),
        ("vp9parse", lambda d, tmp, seed: cont_launch(
            "appsrc name=in caps=video/x-vp9 ! vp9parse ! appsink name=out",
            d, 1, {"in": [dict(data=[np.frombuffer(superframe,
                                                   np.uint8).copy()],
                               batch=1, pts=0)]})),
        ("vp8enc/vp8dec", vpx_guard(vpx_write("vp8"))),
        ("vp9enc/vp9dec", vpx_guard(vpx_write("vp9"))),
        ("vp8alphadecodebin/codecalphademux", vpx_guard(alpha_bin("vp8"))),
        ("vp9alphadecodebin", vpx_guard(alpha_bin("vp9"))),
        ("mpegtsmux/tsdemux", ts("mpegtsmux")),
        ("atscmux", ts("atscmux")),
        ("mpegpsmux/mpegpsdemux", ps("mpegpsmux")),
        ("mplex", ps("mplex")),
        ("hlssink2", hls("hlssink2")),
        ("hlssink", hls("hlssink")),
        ("dashsink", hls("dashsink", "mpd-filename={out}/m.mpd")),
        ("flvmux/flvdemux", flv),
        ("jpegparse/jifmux", jpegs),
        ("asfmux/asfparse/asfdemux", asf),
        ("y4mdec/decodebin3/parsebin/playbin3", y4m),
        ("playsink", playsink),
        ("alphacolor", alphacolor),
        ("dtmfdetect", dtmf)]


def alone_runs(rows, counters, dev, seed):
    """Each (name, run(d, tmp, seed)) of `rows` on `dev` and on the CPU,
    each in a temporary directory of its own: the same result, and no
    kernel launched."""
    import tempfile

    import torch
    for name, run in rows:
        res = {}
        for d in (dev, torch.device("cpu")):
            for c in counters.values():
                c.launches = 0
            with tempfile.TemporaryDirectory() as tmp:
                res[d.type] = run(d, tmp, seed)
            counts = {k: c.launches for k, c in counters.items()
                      if c.launches}
            require(not counts, f"{name}: launches {counts}")
        require(res[dev.type] == res["cpu"],
                f"{name}: the card's run differs from the CPU's")


def vt_alone(seed, counters, dev, files):
    """Each of the slice's 38 factories alone on small inputs, on the card
    and on the CPU: samples, files and messages equal; no kernel
    launched."""
    from gstreamer_tpu_torch.codecs import vpx
    from gstreamer_tpu_torch.core.element import list_factories
    rows = vt_alone_rows(files)
    alone_runs(rows, counters, dev, seed)
    mine = set(VT_FACTORIES)
    require(len(mine) == 38 and mine <= set(list_factories()),
            "the slice's factory list")
    names = " ".join(n for n, _ in rows)
    missing = {f for f in mine if f not in names}
    require(not missing, f"factories not driven alone: {missing}")
    print(f"vpx/transport each factory alone: CUDA == port CPU path "
          f"(samples, files, element messages) for the {len(mine)} "
          f"factories in {len(rows)} runs; no kernel launched; libvpx "
          f"present: {vpx.available()} (without it the VPx runs raise alike "
          f"on both devices)")


def vpx_transport_phase(seed, counters, dev):
    """VP8/VP9, the transport containers, FLV, ASF and playback_extra on
    the card, each path with the launch counts zeroed just before it and
    read just after: asf_mjpeg_ingest (yscale_hv once a video tick),
    ts_audio_ingest, ps_mp3_ingest, hls_segments, flv_aac_ingest (no
    kernel), vpx_ingest where the system libvpx is there (yscale_hv once a
    tick), alphacolor_y4mdec (yscale_hv once a y4m tick), then each of the
    38 factories alone.  Files are written under a temporary directory and
    removed; the vectors are the committed files under
    tests/data/torch_codecs/.  Returns {kernel: launches}."""
    import ctypes.util
    import tempfile

    import torch
    from gstreamer_tpu_torch.codecs import vpx
    cuda = dev.type == "cuda"
    total = {k: 0 for k in counters}

    def start(what):
        for c in counters.values():
            c.launches = 0
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            return torch.cuda.memory_allocated()
        return 0

    def finish(what, want):
        counts = {k: c.launches for k, c in counters.items()}
        require(counts == {k: want.get(k, 0) for k in counters},
                f"{what}: launches {counts}, want {want}")
        for k, v in counts.items():
            total[k] += v
        return {k: v for k, v in counts.items() if v}

    def peak(base):
        return (torch.cuda.max_memory_allocated() - base) / 2**20 if cuda \
            else 0.0

    t0 = time.perf_counter()
    have_vpx = vpx.available()
    print(f"vpx/transport phase: ctypes.util.find_library('vpx') = "
          f"{ctypes.util.find_library('vpx')!r}; vpx.available() = "
          f"{have_vpx} (the loader tries libvpx.so.7, libvpx.so, "
          f"libvpx.so.6)" + ("" if have_vpx else "; vpx_ingest is not run "
                             "and the VPx factories alone raise alike on "
                             "both devices"))
    files, dig = codec_vectors(VT_FILES)
    with tempfile.TemporaryDirectory() as tmp:
        asf_mjpeg_ingest(seed, dev, tmp, start, finish, peak)
        plain, card = ts_audio_ingest(seed, dev, tmp, start, finish, peak,
                                      files, dig)
        ps_mp3_ingest(dev, tmp, start, finish, peak, files, plain)
        hls_segments(dev, tmp, start, finish, peak, files, plain, card)
        flv_aac_ingest(dev, tmp, start, finish, peak, files, dig)
        if have_vpx:
            vpx_ingest(dev, start, finish, peak, files, dig)
        alphacolor_y4mdec(seed, dev, tmp, start, finish, peak)
    vt_alone(seed, counters, dev, files)
    print(f"vpx/transport phase: {time.perf_counter() - t0:.1f} s")
    return total


RR_CAM = (1920, 1080, 32, 16)       # the camera: width, height, frames, batch
RR_UYVY = 16                        # rtp_vraw_uyvy's 1080p frames
RR_SECONDS = 10                     # rtp_l16_asr's 48 kHz stereo
RR_PUSH = 4800                      # frames a sender tick: 100 ms, 19.2 KB
RR_MTU = 1400
RR_WAIT = "timeout=1.0 eos-timeouts=3"
RR_DPORT = 5004                     # the capture's destination port
RR_RTP_JPEG = ("application/x-rtp,media=video,encoding-name=JPEG,"
               "clock-rate=90000,payload=26")
RR_ALONE = (64, 48, 4)              # width, height, frames of a factory alone
RR_MODULES = tuple(f"gstreamer_tpu_torch.net.{m}" for m in (
    "rtp", "rtcp", "rtp_hdrext", "transport", "rtp_raw_audio", "rtpmanager",
    "rtp_payloaders", "sdp", "rtsp", "rtsp_auth", "rtsp_server")) + (
    "gstreamer_tpu_torch.elements.dtmf_icy",
    "gstreamer_tpu_torch.elements.pcapparse")


def rr_probe():
    """What loopback allows here: one UDP datagram to itself on
    127.0.0.1, and one TCP pair; each OSError is reported, not raised."""
    import socket
    got = {}
    try:
        a = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        a.settimeout(2.0)
        a.bind(("127.0.0.1", 0))
        a.sendto(b"probe", a.getsockname())
        got["udp"] = a.recvfrom(64)[0] == b"probe"
        a.close()
    except OSError as e:
        got["udp"] = False
        got["udp_error"] = repr(e)
    try:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.settimeout(2.0)
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        cli = socket.create_connection(srv.getsockname(), timeout=2.0)
        conn, _ = srv.accept()
        cli.sendall(b"probe")
        got["tcp"] = conn.recv(64) == b"probe"
        for s in (cli, conn, srv):
            s.close()
    except OSError as e:
        got["tcp"] = False
        got["tcp_error"] = repr(e)
    return got


def rr_packets_out(args, out):
    d = None if out is None else out.data
    return len(d) if isinstance(d, list) else 0


def rr_packets_in(args, out):
    """Packets a depayloader took (its buffer, the last argument): a
    list's items, a stacked array's rows (pcapparse stacks packets of one
    size), or one."""
    d = None if not args or args[-1] is None else args[-1].data
    if d is None:
        return 0
    if isinstance(d, list):
        return len(d)
    return d.shape[0] if getattr(d, "ndim", 1) > 1 else 1


def rr_rates(spent):
    """The packets and packets/s of each element cont_timed counted."""
    return "; ".join(
        f"{k} {spent[k + ' packets']} packets, "
        f"{spent[k + ' packets'] / spent[k]:.0f} packets/s" if spent[k] else
        f"{k} {spent[k + ' packets']} packets"
        for k in sorted(spent) if k + " packets" in spent)


def rr_pkt_bytes(x):
    import numpy as np
    import torch
    if isinstance(x, (bytes, bytearray)):
        return bytes(x)
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x).tobytes()


def rr_jpegs(seed, dev, tmp):
    """RR_CAM's panning frames through the port's jpegenc on the card, as
    files cam_%05d.jpg: 4:2:0 baseline (rtpjpegpay's type 1).  Returns
    (their directory, the JPEGs)."""
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.elements.jpegformat import parse_sof, \
        walk_markers
    w, h, n, batch = RR_CAM
    planes = vt_panning(n, w, h, seed)
    pipe = parse_launch(f"appsrc name=in caps=video/x-raw,format=I420,width="
                        f"{w},height={h},framerate={CONT_FPS}/1 ! jpegenc ! "
                        "appsink name=out", batch=batch, device=dev)
    for b in vt_pushes(planes, batch):
        pipe.get_by_name("in").push_buffer(Buffer(**dict(b, data=tuple(
            torch.from_numpy(p).to(dev) for p in b["data"]))))
    pipe.get_by_name("in").end_of_stream()
    t0 = time.perf_counter()
    pipe.run()
    secs = time.perf_counter() - t0
    jpgs = [rr_pkt_bytes(x) for s in drain(pipe.get_by_name("out"))
            for x in (s.buffer.data if isinstance(s.buffer.data, list)
                      else [s.buffer.data])]
    d = os.path.join(tmp, "cam")
    os.makedirs(d)
    for k, b in enumerate(jpgs):
        markers, _scan, complete = walk_markers(b)
        sof = [parse_sof(p) for m, _o, p in markers if m == 0xC0]
        require(complete and sof and sof[0]["width"] == w
                and [(c["h"], c["v"]) for c in sof[0]["components"]]
                == [(2, 2), (1, 1), (1, 1)],
                f"jpegenc's frame {k} is no 4:2:0 baseline JPEG of {w}x{h}")
        with open(os.path.join(d, f"cam_{k:05d}.jpg"), "wb") as f:
            f.write(b)
    require(len(jpgs) == n, f"jpegenc gave {len(jpgs)} of {n} JPEGs")
    print(f"  rtp/rtsp: jpegenc on the card wrote {n} {w}x{h} 4:2:0 "
          f"baseline JPEGs ({sum(map(len, jpgs)) / n / 1024:.1f} KiB a frame "
          f"on average) at {n / secs:.1f} frames/s")
    return d, jpgs


def rr_drive(name, desc, dev, start, finish, peak, timers=(),
             batch=RR_CAM[3], pushes=None, out=None):
    """codec_path of `desc` (its appsrcs given `pushes`, its samples into
    `out`) with `timers` (context managers) entered around it all,
    yscale_hv wanted once in each tick that gave frames.  Its numbers gain
    those of the ticks that gave frames: their count, the
    frames, their host seconds (`work`), device busy ms a tick and idle
    share over them, H2D a tick; `idle_run` is the idle share of the whole
    run, the end-of-stream wait in it.  Returns (the "v" samples,
    numbers)."""
    with contextlib.ExitStack() as stack:
        for t in timers:
            stack.enter_context(t)
        pipe, out, r = codec_path(
            name, desc, batch, dev, start, finish, peak,
            lambda fed: {"yscale_hv": sum(1 for f in fed if f)}, (), pushes,
            out)
    n, fed = r["ticks"], r["fed"]
    fed_ticks = sum(1 for f in fed if f)
    work = sum(t for t, f in zip(r["tick_secs"], fed) if f)
    busy = r["busy"] * n                  # ms over the run
    r.update(pipe=pipe, fed_ticks=fed_ticks, frames=sum(fed), work=work,
             busy=busy / max(fed_ticks, 1), idle_run=r["idle"],
             idle=max(0.0, 1.0 - busy / max(work * 1e3, 1e-9)),
             h2d=r["h2d"] * n / max(fed_ticks, 1))
    return out["v"], r


def rr_report(name, r, what="frames"):
    print(f"e2e {name}: {r['frames'] / r['work']:.1f} {what}/s over the "
          f"{r['fed_ticks']} ticks that gave {what} (of {r['ticks']}), "
          f"{r['frames'] / (r['setup'] + r['secs']):.1f} {what}/s with the "
          f"set-up ({r['setup'] * 1e3:.3f} ms) and the end-of-stream wait "
          f"({(r['secs'] - r['work']) * 1e3:.1f} ms); device busy "
          f"{r['busy']:.3f} ms a tick that gave {what}, idle share "
          f"{r['idle']:.3f} over those ticks and {r['idle_run']:.3f} of the "
          f"whole run (traced); {r['h2d'] / 2**20:.3f} MiB H2D a tick that "
          f"gave {what}; peak memory {r['mem']:.1f} MiB; launches "
          f"{r['launches']}")


def rr_rgb_ref(jdir, dev):
    """multifilesrc ! jpegdec of the camera's files to RGB 224x224 at
    batch RR_CAM[3] on `dev`."""
    w, h, _n, batch = RR_CAM
    return cont_joined(codec_run(
        f"multifilesrc location={jdir}/cam_%05d.jpg caps=image/jpeg,"
        f"framerate={CONT_FPS}/1 ! jpegdec ! {rr_caps(w, h)} ! {CONT_RGB}",
        dev, batch, "v"))


def rr_caps(w, h):
    """jpegdec learns no size from rtpjpegdepay's caps (in either package):
    the camera's caps name it."""
    return f"video/x-raw,format=I420,width={w},height={h},framerate={CONT_FPS}/1"


def rr_server(dev, launch, rate_control):
    from gstreamer_tpu_torch.net.rtsp_server import (RTSPMediaFactory,
                                                     RTSPServer)
    srv = RTSPServer(service=0)
    srv.mount_points.add_factory("/cam", RTSPMediaFactory(
        launch, rate_control=rate_control, device=dev))
    return srv, srv.attach()


def rr_cam_launch(jdir, src="multifilesrc"):
    """The camera's media factory: the JPEG files through rtpjpegpay.
    imagesequencesrc stamps each file with its duration at 25/1, which the
    server's rate control sleeps; multifilesrc gives none."""
    rate = (f"framerate={CONT_FPS}/1" if src == "imagesequencesrc" else
            "")
    return (f"( {src} location={jdir}/cam_%05d.jpg caps=image/jpeg,"
            f"framerate={CONT_FPS}/1 {rate} ! rtpjpegpay name=pay0 pt=26 )")


def rtsp_mjpeg_ingest(dev, jdir, ref, start, finish, peak):
    """The camera over RTSP, TCP interleaved: the server streams the JPEG
    files through rtpjpegpay (host only, no rate control); rtspsrc !
    rtpjpegdepay ! jpegdec ! videoconvertscale to RGB 224x224 at batch 16
    on the card, yscale_hv once a tick that gives frames; the RGB equals
    multifilesrc ! jpegdec of the same files.  Returns the RGB."""
    from gstreamer_tpu_torch.elements import image_codecs
    from gstreamer_tpu_torch.net import rtp_payloaders as rp
    from gstreamer_tpu_torch.net import rtsp_server as rs
    w, h, n, _batch = RR_CAM
    srv, port = rr_server(dev, rr_cam_launch(jdir), False)
    stats, spent = {}, {}
    try:
        out, r = rr_drive(
            "rtsp_mjpeg_ingest",
            f"rtspsrc name=src location=rtsp://127.0.0.1:{port}/cam "
            f"protocols=tcp {RR_WAIT} ! rtpjpegdepay ! jpegdec ! "
            f"{rr_caps(w, h)} ! {CONT_RGB}", dev, start, finish, peak,
            (cont_timed(rp.RtpJpegPay, "host_process", stats,
                        "rtpjpegpay", rr_packets_out),
             cont_timed(rp.RtpJpegDepay, "host_process", stats,
                        "rtpjpegdepay", rr_packets_in),
             cont_timed(rs.RTSPSrc, "start", spent, "rtsp"),
             cont_timed(image_codecs.JpegDec, "_decode_all", spent,
                        "decode")))
    finally:
        srv.shutdown()
    rgb = cont_joined(out)
    require(rgb is not None and rgb[0].shape[0] == n and cont_equal(rgb, ref),
            f"rtsp_mjpeg_ingest: {0 if rgb is None else rgb[0].shape[0]} "
            f"frames, or RGB other than multifilesrc ! jpegdec's")
    src = r["pipe"].get_by_name("src")
    rr_report("rtsp_mjpeg_ingest", r)
    print(f"  rtsp_mjpeg_ingest: {n} frames == multifilesrc ! jpegdec's RGB; "
          f"RTSP set-up (OPTIONS to PLAY) {spent.get('rtsp', 0) * 1e3:.3f} "
          f"ms; yscale_hv {r['launches'].get('yscale_hv', 0)} in the "
          f"{r['fed_ticks']} ticks that gave frames; host decode "
          f"{spent.get('decode', 0) / n * 1e3:.3f} ms a frame; "
          f"{rr_rates(stats)}; SRs interleaved: last_sr "
          f"{'none' if src.last_sr is None else src.last_sr.packet_count} "
          f"packets")
    return rgb


def rr_frames(pkts):
    """RTP/JPEG packets in sequence order cut into frames at the marker
    bits: [packets of a frame]."""
    out, cur = [], []
    for p in pkts:
        cur.append(p)
        if p[1] & 0x80:
            out.append(cur)
            cur = []
    return out + ([cur] if cur else [])


def rr_key(frame):
    return b"".join(p[12:] for p in frame)


def rr_whole_frames(pkts, sent):
    """The frames that arrived whole, as {frame index: packets}: received
    packets in (extended) sequence order cut at the marker bits, a frame
    whole when its payloads are a sent frame's, byte for byte (`sent`: the
    payloader's frames, in order).  Also the packets missing by sequence
    number between the first and the last received."""
    import struct
    ext, last, keyed = 0, None, []
    for p in pkts:
        seq = struct.unpack("!H", p[2:4])[0]
        if last is not None and seq < last and last - seq > 0x8000:
            ext += 1 << 16
        last = seq
        keyed.append((ext + seq, p))
    keyed.sort()
    seqs = [s for s, _p in keyed]
    lost = (seqs[-1] - seqs[0] + 1 - len(set(seqs))) if seqs else 0
    index = {rr_key(f): k for k, f in enumerate(sent)}
    whole = {}
    for f in rr_frames([p for _s, p in keyed]):
        k = index.get(rr_key(f))
        if k is not None:
            whole[k] = f
    return whole, lost


def rr_depay_images(sent):
    """{the image rtpjpegdepay gives for a sent frame alone: its index}."""
    import torch
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.element import element_factory_make
    dep = element_factory_make("rtpjpegdepay")
    dep.device = torch.device("cpu")
    dep.start()
    return {rr_pkt_bytes(dep.host_process(Buffer(data=list(f), pts=0))
                         .data): k for k, f in enumerate(sent)}


@contextlib.contextmanager
def rr_jpeg_fault(fault):
    """While the block runs, record jpegdec's own error in `fault`: the
    exception its decode raised ("error") and the image it raised on
    ("image": the first of the call's images that raises decoded alone, or
    None)."""
    from gstreamer_tpu_torch.elements import image_codecs
    cls = image_codecs.JpegDec
    fn = cls._decode_all

    def spy(self, blobs):
        try:
            return fn(self, blobs)
        except Exception as e:
            fault.update(error=e, image=None)
            for b in blobs:
                try:
                    fn(self, [b])
                except Exception:
                    fault["image"] = rr_pkt_bytes(b)
                    break
            raise
    cls._decode_all = spy
    try:
        yield fault
    finally:
        cls._decode_all = fn


def rr_camera_run(name, desc, dev, start, finish, peak, spent, timers):
    """rr_drive of a receiving camera path (... ! rtpjpegdepay ! jpegdec !
    ... to RGB on the card) with `timers`, rtpjpegdepay timed into `spent`
    and its packets taken and images handed on recorded.  A frame that lost
    packets for good goes to jpegdec as it is (rtpjpegdepay keeps no
    sequence numbers, ROADMAP.md section 3), and jpegdec may raise on it:
    that error (rr_jpeg_fault) ends the run, any other propagates.  Then
    the launch counts are read here, yscale_hv once a tick whose frames
    reached the appsink (a sample each).  Returns (packets taken, images
    handed on, the samples, rr_drive's numbers or None, the fault or
    None)."""
    from gstreamer_tpu_torch.net import rtp_payloaders as rp
    took, images, fault, out = [], [], {}, {"v": [], "a": []}

    def record(args, o):
        if args[-1] is None:
            return 0
        took.extend(rr_pkt_bytes(x) for x in args[-1].data)
        if o is not None:
            images.extend(rr_pkt_bytes(x) for x in (
                o.data if isinstance(o.data, list) else [o.data]))
        return len(args[-1].data)
    try:
        _v, r = rr_drive(name, desc, dev, start, finish, peak, (
            rr_jpeg_fault(fault), cont_timed(rp.RtpJpegDepay, "host_process",
                                             spent, "rtpjpegdepay", record),
            *timers), out=out)
        return took, images, out["v"], r, None
    except Exception as e:
        if e is not fault.get("error"):
            raise
    finish(name, {"yscale_hv": len(out["v"])})
    return took, images, out["v"], None, fault


def rr_camera_check(name, sent, ref, images, v, fault):
    """The frames a receiving camera path handed on, against the TCP run
    (`ref`, the RGB of the sent frames): every image that reached the
    appsink (all of them, or those before jpegdec's fault) that is a sent
    frame's, whole, has its frame's RGB.  After the fault, the image
    jpegdec raised on came after those and is no sent frame's: a frame
    that lost packets for good.  Returns (the frames handed on whole, those
    checked)."""
    index = rr_depay_images(sent)
    rgb = cont_joined(v)
    done = 0 if rgb is None else rgb[0].shape[0]
    require(done <= len(images), f"{name}: {done} frames out of "
            f"{len(images)} images")
    if fault is None:
        require(done == len(images), f"{name}: {done} frames out of "
                f"{len(images)} images")
    else:
        bad = fault["image"]
        require(bad is not None and bad in images[done:] and bad not in index,
                f"{name}: jpegdec raised {fault['error']!r} on an image that "
                f"is not a broken frame handed on after the {done} decoded")
    pairs = [(k, index[x]) for k, x in enumerate(images[:done]) if x in index]
    require(pairs or fault, f"{name}: no frame arrived whole")
    if pairs:
        mine, theirs = [k for k, _ in pairs], [j for _, j in pairs]
        require(cont_equal(tuple(p[mine] for p in rgb),
                           tuple(p[theirs] for p in ref)),
                f"{name}: a whole frame's RGB differs from the TCP run's")
    return sum(1 for x in images if x in index), len(pairs)


def rtsp_mjpeg_udp(dev, jdir, tcp_rgb, sent, start, finish, peak):
    """The same camera with RTSP's default UDP transport and the server's
    rate control at 25/1, twice.  The baseline: rtspsrc ! appsink, a
    receiving loop that only gathers; prints the packets received and lost
    and the frames whole, then rtcp_session's counts (the server's SRs at
    rtspsrc, rtspsrc's RRs at the server).  Then the camera's path in one
    pipeline on the card, rtspsrc ! rtpjpegdepay ! jpegdec ! videoconvertscale
    to RGB 224x224 (rr_drive, yscale_hv once a tick that gives frames):
    prints the packets the server sent and rtpjpegdepay took and the frames
    whole; each whole frame's RGB equals its frame of the TCP run, up to
    jpegdec's fault on a frame that lost packets for good where it raises
    (rr_camera_run, rr_camera_check)."""
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.elements import image_codecs
    from gstreamer_tpu_torch.net import rtsp_server as rs
    w, h, n, _batch = RR_CAM
    launch = rr_cam_launch(jdir, "imagesequencesrc")
    srv, port = rr_server(dev, launch, True)
    try:
        t0 = time.perf_counter()
        pipe = parse_launch(f"rtspsrc name=src location=rtsp://127.0.0.1:"
                            f"{port}/cam {RR_WAIT} ! appsink name=p",
                            device=dev)
        pipe.set_state("playing")
        setup = time.perf_counter() - t0
        sessions = list(srv._sessions.values())
        pkts, t1 = [], time.perf_counter()
        while pipe.tick():
            for s in drain(pipe.get_by_name("p")):
                pkts += [rr_pkt_bytes(x) for x in s.buffer.data]
        recv_secs = time.perf_counter() - t1
        src = pipe.get_by_name("src")
        pipe.set_state("null")
    finally:
        srv.shutdown()
    require(len(sessions) == 1, f"rtsp_mjpeg_udp: {len(sessions)} server "
            "sessions")
    sess = sessions[0]
    whole, lost = rr_whole_frames(pkts, sent)
    print(f"  rtsp_mjpeg_udp[gather]: received {len(pkts)} of the "
          f"{sess.packet_count} packets the server sent "
          f"({sess.packet_count - len(pkts)} lost; {lost} missing by "
          f"sequence number between the first and the last received); "
          f"{len(whole)} of {n} frames whole; set-up {setup * 1e3:.3f} ms; "
          f"{recv_secs:.3f} s receiving (the 25/1 rate control and the "
          f"end-of-stream wait)")
    last_sr = src.last_sr
    require(last_sr is not None and last_sr.packet_count > 0,
            "rtcp_session: no sender report reached rtspsrc")
    require(src.rr_sent >= 1 and sess.last_rr is not None,
            "rtcp_session: no receiver report reached the server")
    rb = sess.last_rr.reports[0] if sess.last_rr.reports else None
    print(f"  rtcp_session: the server sent {sess.sr_sent} SRs; rtspsrc's "
          f"last_sr: ssrc {last_sr.ssrc:#x}, ntp {last_sr.ntp:#x}, rtp_ts "
          f"{last_sr.rtp_ts}, packet_count {last_sr.packet_count}, "
          f"octet_count {last_sr.octet_count}; rtspsrc rr_sent "
          f"{src.rr_sent}; the server's last RR from ssrc "
          f"{sess.last_rr.ssrc:#x}"
          + (f": fraction_lost {rb.fraction_lost}, cumulative_lost "
             f"{rb.cumulative_lost}, extended_seq {rb.extended_seq}, jitter "
             f"{rb.jitter}" if rb is not None else ""))

    # the camera's path in one pipeline
    spent = {}
    srv, port = rr_server(dev, launch, True)
    try:
        took, images, v, r, fault = rr_camera_run(
            "rtsp_mjpeg_udp",
            f"rtspsrc location=rtsp://127.0.0.1:{port}/cam {RR_WAIT} ! "
            f"rtpjpegdepay ! jpegdec ! {rr_caps(w, h)} ! {CONT_RGB}", dev,
            start, finish, peak, spent,
            (cont_timed(rs.RTSPServer, "_send_rtp", spent, "server",
                        lambda a, o: 1),
             cont_timed(image_codecs.JpegDec, "_decode_all", spent,
                        "decode")))
    finally:
        srv.shutdown()
    whole, checked = rr_camera_check("rtsp_mjpeg_udp", sent, tcp_rgb,
                                     images, v, fault)
    sent_n = spent.get("server packets", 0)
    have = {p[12:] for p in took}
    first_lost = [k for k, f in enumerate(sent)
                  if f[0][12:] not in have and any(p[12:] in have
                                                   for p in f[1:])]
    print(f"  rtsp_mjpeg_udp: rtpjpegdepay took {len(took)} of the {sent_n} "
          f"packets the server sent ({sent_n - len(took)} lost) with "
          f"jpegdec in the receiving loop; {len(images)} images handed on, "
          f"{whole} of {n} frames whole; frames that lost their first "
          f"packet: {first_lost}")
    if fault is not None:
        print(f"  rtsp_mjpeg_udp: reference fault (ROADMAP.md section 3): "
              f"rtpjpegdepay handed on a frame that lost packets for good and "
              f"jpegdec raised {fault['error']!r} on it, ending the "
              f"pipeline; the {checked} whole frames before it == their "
              f"frames of the TCP run")
        return
    rr_report("rtsp_mjpeg_udp", r)
    print(f"  rtsp_mjpeg_udp: every whole frame ({checked}) == its frame "
          f"of the TCP run; yscale_hv {r['launches'].get('yscale_hv', 0)} in "
          f"the {r['fed_ticks']} ticks that gave frames; host decode "
          f"{spent.get('decode', 0) / max(len(images), 1) * 1e3:.3f} ms a "
          f"frame; {rr_rates(spent)}")


def rr_pcap(pkts, dport):
    """libpcap bytes: each packet in an Ethernet/IPv4/UDP record (the
    capture's layout in tests/test_pcapparse.py), one foreign datagram
    after the fourth."""
    import struct

    def record(payload, port, k):
        udp = struct.pack(">HHHH", 5004, port, 8 + len(payload), 0) + payload
        ip = struct.pack(">BBHHHBBHII", 0x45, 0, 20 + len(udp), 0, 0, 64, 17,
                         0, 0x0A000001, 0x0A000002) + udp
        frame = b"\xaa" * 6 + b"\xbb" * 6 + struct.pack(">H", 0x800) + ip
        return struct.pack("<IIII", 100 + k // 1000, (k % 1000) * 1000,
                           len(frame), len(frame)) + frame
    out = [struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 0x40000, 1)]
    for k, p in enumerate(pkts):
        out.append(record(p, dport, k))
        if k == 3:
            out.append(record(b"not the camera", dport + 2, k))
    return b"".join(out)


def rr_pay(dev, jdir, stats):
    """The camera's JPEG files through rtpjpegpay on the host (multifilesrc
    ! rtpjpegpay ! appsink): the packets, in order."""
    from gstreamer_tpu_torch.net import rtp_payloaders as rp
    with cont_timed(rp.RtpJpegPay, "host_process", stats,
                    "rtpjpegpay", rr_packets_out):
        pay = codec_run(f"multifilesrc location={jdir}/cam_%05d.jpg caps="
                        f"image/jpeg,framerate={CONT_FPS}/1 ! rtpjpegpay ! "
                        "appsink name=p", dev, 1, "p")
    return [rr_pkt_bytes(x) for s in pay for x in s.buffer.data]


def pcap_mjpeg_replay(dev, jdir, ref, pkts, tmp, start, finish, peak):
    """The camera's JPEGs through rtpjpegpay into a .pcap file (no socket),
    replayed through filesrc ! pcapparse dst-port=5004 caps=<RTP/JPEG> !
    rtpjpegdepay ! jpegdec to RGB 224x224 on the card: yscale_hv once a
    tick that gives frames; the RGB equals multifilesrc ! jpegdec's (which
    the TCP run's equals)."""
    from gstreamer_tpu_torch.elements import image_codecs, pcapparse
    w, h, n, batch = RR_CAM
    from gstreamer_tpu_torch.net import rtp_payloaders as rp
    stats, spent = {}, {}
    path = os.path.join(tmp, "cam.pcap")
    with open(path, "wb") as f:
        f.write(rr_pcap(pkts, RR_DPORT))
    out, r = rr_drive(
        "pcap_mjpeg_replay",
        f"filesrc location={path} ! pcapparse dst-port={RR_DPORT} "
        f"caps={RR_RTP_JPEG} ! rtpjpegdepay ! jpegdec ! {rr_caps(w, h)} ! "
        f"{CONT_RGB}", dev, start, finish, peak,
        (cont_timed(rp.RtpJpegDepay, "host_process", stats,
                    "rtpjpegdepay", rr_packets_in),
         cont_timed(pcapparse.PcapParse, "handle_frame", spent, "pcapparse"),
         cont_timed(image_codecs.JpegDec, "_decode_all", spent, "decode")),
        batch=batch)
    rgb = cont_joined(out)
    require(rgb is not None and cont_equal(rgb, ref),
            "pcap_mjpeg_replay: RGB other than multifilesrc ! jpegdec's")
    rr_report("pcap_mjpeg_replay", r)
    print(f"  pcap_mjpeg_replay: {len(pkts)} packets "
          f"({os.path.getsize(path) / 2**20:.1f} MiB of capture); the {n} "
          f"frames == multifilesrc ! jpegdec's RGB (== the TCP run's); "
          f"yscale_hv "
          f"{r['launches'].get('yscale_hv', 0)} in the {r['fed_ticks']} "
          f"ticks that gave frames; pcapparse {spent.get('pcapparse', 0):.3f}"
          f" s, host decode {spent.get('decode', 0) / n * 1e3:.3f} ms a "
          f"frame; {rr_rates(stats)}")


def rtp_l16_asr(seed, dev, start, finish, peak):
    """RR_SECONDS of 48 kHz stereo through rtpL16pay ! udpsink into udpsrc
    ! rtpL16depay ! the ASR chain on the card, the sender's ticks (100 ms,
    19.2 KB) alternated with the receiver's (a datagram each): the
    depayloaded samples equal those sent and the ASR output equals the
    port's CPU run over the same blocks.  Then the same audio through
    rtpL24pay ! rtpL24depay in one process on the card and the CPU."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.net import rtp as rtp_mod
    audio = cont_audio(CONT_RATE * RR_SECONDS, seed)
    caps = (f"audio/x-raw,format=S16LE,rate={CONT_RATE},channels=2,"
            "layout=interleaved")
    per_pkt = (RR_MTU - 12) // 4
    stats, blocks = {}, []
    base = start("rtp_l16_asr")
    t0 = time.perf_counter()
    with cont_timed(rtp_mod.RtpL16Pay, "host_process", stats,
                    "rtpL16pay", rr_packets_out), \
            cont_timed(rtp_mod.RtpL16Depay, "host_process", stats,
                       "rtpL16depay", rr_packets_in), \
            vt_uploads(rtp_mod, blocks):
        rx = parse_launch(f"udpsrc name=u port=0 timeout=1.0 ! rtpL16depay "
                          f"caps=\"{caps}\" ! {CONT_ASR}", device=dev)
        rx.set_state("playing")
        tx = parse_launch(f"appsrc name=in caps={caps} ! rtpL16pay mtu="
                          f"{RR_MTU} ! udpsink port="
                          f"{rx.get_by_name('u').bound_port}", device=dev)
        src = tx.get_by_name("in")
        for k in range(0, len(audio), RR_PUSH):
            src.push_buffer(Buffer(
                data=torch.from_numpy(audio[k:k + RR_PUSH]).to(dev),
                pts=k * 10**9 // CONT_RATE,
                duration=RR_PUSH * 10**9 // CONT_RATE))
        src.end_of_stream()
        tx.set_state("playing")
        setup = time.perf_counter() - t0
        asr, t1 = [], time.perf_counter()
        while tx.tick():
            for _ in range(-(-RR_PUSH // per_pkt)):
                require(rx.tick(), "rtp_l16_asr: the receiver ended early")
                asr += drain(rx.get_by_name("a"))
        secs = time.perf_counter() - t1
        sync(dev)
        tx.set_state("null")
        rx.set_state("null")
    finish("rtp_l16_asr", {})
    pcm = np.concatenate(blocks)
    require(np.array_equal(pcm, audio), f"rtp_l16_asr: depayloaded samples "
            f"{pcm.shape} differ from those sent {audio.shape}")
    card = cont_joined(asr)
    require(card is not None and torch.equal(
        card, codec_asr_ref(blocks, CONT_RATE, 2, "S16LE")),
        "rtp_l16_asr: the ASR output differs from the port's CPU run over "
        "the same blocks")
    print(f"e2e rtp_l16_asr: {len(audio) / secs:.1f} audio frames/s over "
          f"the alternated ticks, {len(audio) / (secs + setup):.1f} with the "
          f"set-up ({setup * 1e3:.3f} ms); {rr_rates(stats)}; the samples "
          f"== those sent; the ASR output == the port's CPU run over the "
          f"{len(blocks)} depayloaded blocks; peak memory {peak(base):.1f} "
          f"MiB; no launch")
    s24 = (audio.astype(np.int32) << 8)
    want = s24.astype(">i4").view(np.uint8).reshape(-1, 4)[:, 1:] \
        .reshape(len(audio), 6)
    got = {}
    for d in (dev, torch.device("cpu")):
        start("rtp_l24")
        pipe = parse_launch(
            f"appsrc name=in caps=audio/x-raw,format=S24BE,rate={CONT_RATE},"
            f"channels=2 ! rtpL24pay mtu={RR_MTU} ! rtpL24depay caps=\"audio/"
            f"x-raw,format=S24BE,rate={CONT_RATE},channels=2\" ! appsink "
            "name=out", device=d)
        for k in range(0, len(s24), RR_PUSH):
            pipe.get_by_name("in").push_buffer(Buffer(
                data=torch.from_numpy(s24[k:k + RR_PUSH]).to(d),
                pts=k * 10**9 // CONT_RATE))
        pipe.get_by_name("in").end_of_stream()
        t1 = time.perf_counter()
        pipe.run()
        got[d.type] = (cont_joined(drain(pipe.get_by_name("out"))),
                       time.perf_counter() - t1)
        finish("rtp_l24", {})
    card, cpu = got[dev.type][0], got["cpu"][0]
    require(card is not None and torch.equal(card.cpu(), cpu)
            and np.array_equal(cpu.numpy(), want),
            "rtp_l24: the depayloaded bytes differ from the CPU run's or "
            "from the 24-bit samples sent")
    print(f"  rtp_l16_asr[L24]: rtpL24pay ! rtpL24depay of the same "
          f"{RR_SECONDS} s == the 24-bit samples sent == the CPU run's, "
          f"{len(audio) / got[dev.type][1]:.1f} audio frames/s")


def rtp_vraw_uyvy(seed, dev, start, finish, peak):
    """RR_UYVY 1080p panning frames converted to UYVY on the card, through
    rtpvrawpay mtu=1400 ! rtpvrawdepay in one process (the same frames
    back), and on to RGB 224x224 (the converter's generic route: no
    kernel), equal to the port's CPU run."""
    import torch
    from gstreamer_tpu_torch.net import rtp as rtp_mod
    w, h = RR_CAM[:2]
    n = RR_UYVY
    planes = vt_panning(n, w, h, seed)
    uyvy = (f"appsrc name=in caps=video/x-raw,format=I420,width={w},height="
            f"{h},framerate={CONT_FPS}/1 ! videoconvert ! video/x-raw,"
            "format=UYVY")
    rtp = (f"rtpvrawpay mtu={RR_MTU} ! rtpvrawdepay caps=video/x-raw,"
           f"format=UYVY,width={w},height={h},framerate={CONT_FPS}/1")
    pushes = {"in": [dict(b) for b in vt_pushes(planes, n)]}

    def run(desc, d, sink):
        from gstreamer_tpu_torch import parse_launch
        from gstreamer_tpu_torch.core.buffer import Buffer
        pipe = parse_launch(desc, batch=n, device=d)
        for b in pushes["in"]:
            pipe.get_by_name("in").push_buffer(Buffer(**dict(b, data=tuple(
                torch.from_numpy(p).to(d) for p in b["data"]))))
        pipe.get_by_name("in").end_of_stream()
        sync(d)
        t0 = time.perf_counter()
        pipe.run()
        sync(d)
        return cont_joined(drain(pipe.get_by_name(sink))), \
            time.perf_counter() - t0

    stats = {}
    base = start("rtp_vraw_uyvy")
    sent, _ = run(f"{uyvy} ! appsink name=v", dev, "v")
    with cont_timed(rtp_mod.RtpVRawPay, "host_process", stats,
                    "rtpvrawpay", rr_packets_out), \
            cont_timed(rtp_mod.RtpVRawDepay, "host_process", stats,
                       "rtpvrawdepay", rr_packets_in):
        back, secs_back = run(f"{uyvy} ! {rtp} ! appsink name=v", dev, "v")
    rgb, secs = run(f"{uyvy} ! {rtp} ! {CONT_RGB}", dev, "v")
    finish("rtp_vraw_uyvy", {})
    mem = peak(base)
    require(cont_equal(back, sent), "rtp_vraw_uyvy: the UYVY frames differ "
            "after rtpvrawpay ! rtpvrawdepay")
    cpu, _ = run(f"{uyvy} ! {rtp} ! {CONT_RGB}", torch.device("cpu"), "v")
    require(cont_equal(rgb, cpu), "rtp_vraw_uyvy: RGB differs from the "
            "port's CPU run")
    per_frame = stats["rtpvrawpay packets"] // n
    print(f"e2e rtp_vraw_uyvy: {n / secs:.1f} frames/s to RGB 224x224 "
          f"({n / secs_back:.1f} frames/s UYVY round trip alone); "
          f"{per_frame} packets a frame; {rr_rates(stats)}; the UYVY frames "
          f"== those sent; RGB == the port's CPU run; peak memory "
          f"{mem:.1f} MiB; no launch")


def rtp_coded_passthrough(dev, files, start, finish, peak):
    """VP8 from the committed IVF through rtpvp8pay ! rtpvp8depay (no
    libvpx needed): the frames equal ivfparse's.  The Opus packets of
    opus_10s.opus through appsrc ! rtpopuspay ! udpsink and udpsrc !
    rtpopusdepay (alternated, a packet a tick), decoded with opusdec's
    decoder (opusdec is a file source in both packages and takes no
    packets): the PCM equals opusdec's of the file, and the ASR chain on
    the card over it equals the port's CPU run."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.codecs import opus
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.elements.ogg import parse_ogg_pages
    from gstreamer_tpu_torch.net import rtp_payloaders as rp
    ivf = files["vp8_1080p.ivf"]
    stats = {}
    start("rtp_coded_passthrough[vp8]")
    plain = codec_run(f"filesrc location={ivf} ! ivfparse ! appsink name=a",
                      dev)
    with cont_timed(rp.RtpVP8Pay, "host_process", stats,
                    "rtpvp8pay", rr_packets_out), \
            cont_timed(rp.RtpVP8Depay, "host_process", stats,
                       "rtpvp8depay", rr_packets_in):
        back = codec_run(f"filesrc location={ivf} ! ivfparse ! rtpvp8pay "
                         f"mtu={RR_MTU} ! rtpvp8depay ! appsink name=a", dev)
    finish("rtp_coded_passthrough[vp8]", {})

    def frames(samples):
        return [rr_pkt_bytes(x) for s in samples for x in
                (s.buffer.data if isinstance(s.buffer.data, list)
                 else [s.buffer.data])]
    require(frames(back) == frames(plain) and frames(plain),
            "rtp_coded_passthrough: VP8 frames differ after RTP")
    print(f"  rtp_coded_passthrough[vp8]: {len(frames(plain))} 1080p VP8 "
          f"frames == ivfparse's after rtpvp8pay ! rtpvp8depay; "
          f"{rr_rates(stats)}")
    with open(files["opus_10s.opus"], "rb") as f:
        blob = f.read()
    pk = [p for _s, _g, ps in parse_ogg_pages(blob) for p in ps]
    ch, pre_skip, _rate, _gain = opus.parse_opus_head(pk[0])
    pk = [p for p in pk[1:] if not p.startswith(b"OpusTags")]
    stats, got = {}, []
    base = start("rtp_coded_passthrough[opus]")
    t0 = time.perf_counter()
    with cont_timed(rp.RtpOpusPay, "host_process", stats,
                    "rtpopuspay", rr_packets_out), \
            cont_timed(rp.RtpOpusDepay, "host_process", stats,
                       "rtpopusdepay", rr_packets_in):
        rx = parse_launch("udpsrc name=u port=0 timeout=1.0 caps=application/"
                          "x-rtp ! rtpopusdepay ! appsink name=a", device=dev)
        rx.set_state("playing")
        tx = parse_launch("appsrc name=in caps=audio/x-opus ! rtpopuspay ! "
                          f"udpsink port={rx.get_by_name('u').bound_port}",
                          device=dev)
        for k, p in enumerate(pk):
            tx.get_by_name("in").push_buffer(Buffer(
                data=np.frombuffer(p, np.uint8), pts=k * 20_000_000,
                duration=20_000_000))
        tx.get_by_name("in").end_of_stream()
        tx.set_state("playing")
        while tx.tick():
            require(rx.tick(), "rtp_coded_passthrough: the receiver ended "
                    "early")
            got += frames(drain(rx.get_by_name("a")))
        tx.set_state("null")
        rx.set_state("null")
    secs = time.perf_counter() - t0
    require(got == pk, f"rtp_coded_passthrough: {len(got)} Opus packets "
            f"back of {len(pk)}, or other bytes")
    dec = opus.HybridOpusDecoder(ch)
    t1 = time.perf_counter()
    pcm = np.concatenate([dec.decode(p) for p in got])
    dsecs = time.perf_counter() - t1
    whole, _r, _c = opus.decode_ogg(blob)
    pcm = pcm[pre_skip:pre_skip + len(whole)]
    require(np.array_equal(pcm, whole), "rtp_coded_passthrough: the PCM "
            "of the depayloaded packets differs from opusdec's of the file")
    blocks = [np.ascontiguousarray(pcm[k:k + 4800])
              for k in range(0, len(pcm), 4800)]
    asr_in = parse_launch(f"appsrc name=in caps=audio/x-raw,format=F32LE,"
                          f"rate=48000,channels={ch},layout=interleaved ! "
                          f"{CONT_ASR}", device=dev)
    for k, b in enumerate(blocks):
        asr_in.get_by_name("in").push_buffer(Buffer(
            data=torch.from_numpy(b).to(dev), pts=k * 10**8,
            duration=10**8))
    asr_in.get_by_name("in").end_of_stream()
    asr_in.run()
    card = cont_joined(drain(asr_in.get_by_name("a")))
    finish("rtp_coded_passthrough[opus]", {})
    require(card is not None and torch.equal(
        card, codec_asr_ref(blocks, 48000, ch)),
        "rtp_coded_passthrough: the Opus ASR output differs from the "
        "port's CPU run")
    print(f"  rtp_coded_passthrough[opus]: {len(pk)} packets over UDP "
          f"({len(pk) / secs:.1f} packets/s alternated); {rr_rates(stats)}; "
          f"decoded {len(pcm) / 48000:.2f} s in {dsecs:.3f} s == opusdec's "
          f"PCM of the file; the ASR output == the port's CPU run; peak "
          f"memory {peak(base):.1f} MiB; no launch")


def rr_free_port():
    import socket
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def rr_alone_rows(files, tmp):
    """The runs that drive each of the 60 factories alone or with its
    pair: [(factories, uses sockets, fn(d) -> plain data)]."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.element import element_factory_make
    from gstreamer_tpu_torch.net.rtp import rtp_header
    w, h, n = RR_ALONE
    rng = np.random.default_rng(23)
    rgb = cont_video("RGB", n, w, h, 23)
    vraw = f"video/x-raw,format=RGB,width={w},height={h},framerate=25/1"
    a16 = rng.integers(-3000, 3000, (960, 2), dtype=np.int16)
    acaps = "audio/x-raw,format={},rate=48000,channels=2,layout=interleaved"
    pkts = [rtp_header(96 + k % 3, (65530 + k) & 0xFFFF, 3000 * k,
                       0x11 + k % 2, marker=k % 4 == 3) + bytes([k]) * 20
            for k in range(12)]
    shuffled = [pkts[k] for k in (0, 2, 1, 3, 3, 5, 4, 7, 6, 9, 8, 11)]
    blobs = [rng.integers(0, 256, int(rng.integers(50, 3000)),
                          dtype=np.uint8) for _ in range(5)]
    aus = [np.frombuffer(a, np.uint8) for a in annexb_aus(False, 4, rng)]

    def rtp_in(data):
        return {"in": [dict(data=list(data), pts=0)]}

    def frames_in(caps):
        return {"in": [dict(data=b, pts=k * 40_000_000, duration=40_000_000)
                       for k, b in enumerate(blobs)]}, caps

    def launch(desc, pushes=None, batch=1):
        return lambda d: cont_launch(desc, d, batch, pushes)

    def coded(pay, depay, caps):
        pushes, caps = frames_in(caps)
        return launch(f"appsrc name=in caps={caps} ! {pay} mtu=300 ! tee "
                      f"name=t t. ! queue ! appsink name=out t. ! queue ! "
                      f"{depay} ! appsink name=out1", pushes)

    def hdrext(d):
        pipe = parse_launch("appsrc name=in caps=video/x-vp8 ! rtpvp8pay "
                            "name=pay mtu=300 ! appsink name=out", device=d)
        exts = [element_factory_make(f, **kw) for f, kw in (
            ("rtphdrextclientaudiolevel", dict(id=1, level=30, voice=True)),
            ("rtphdrextmid", dict(id=2, value="v0")),
            ("rtphdrextstreamid", dict(id=3, value="hi")),
            ("rtphdrextrepairedstreamid", dict(id=4, value="r0")),
            ("rtphdrextntp64", dict(id=5, ntp=0x0102030405060708)),
            ("rtphdrexttwcc", dict(id=6)),
            ("rtphdrextcolorspace", dict(id=7, primaries=1, transfer=1,
                                         matrix=1, full_range=False)))]
        for e in exts:
            e.device = d
            pipe.get_by_name("pay").add_extension(e)
        for k, b in enumerate(blobs):
            pipe.get_by_name("in").push_buffer(Buffer(data=b, pts=k))
        pipe.get_by_name("in").end_of_stream()
        pipe.run()
        return bc_plain([s.buffer.data for s in drain(pipe.get_by_name(
            "out"))]), [e.read(e.write()) for e in exts]

    def rtx(d):
        got = []
        send = element_factory_make("rtprtxsend", **{"rtx-payload-type": 97})
        recv = element_factory_make("rtprtxreceive", **{
            "rtx-payload-type": 97, "orig-payload-type": 96})
        q = element_factory_make("rtprtxqueue")
        for e in (send, recv, q):
            e.device = d
            e.start()
        got.append(bc_plain(send.host_process(Buffer(data=list(pkts),
                                                     pts=0)).data))
        got.append([send.request_retransmit(s) for s in (65531, 2, 5)])
        resent = send.host_process(Buffer(data=[], pts=0)).data
        got.append(bc_plain(recv.host_process(Buffer(
            data=list(pkts) + list(resent), pts=0)).data))
        q.host_process(Buffer(data=list(pkts), pts=0))
        got.append([q.request_retransmit(1)])
        got.append(bc_plain(q.host_process(Buffer(data=[], pts=0)).data))
        return got

    def jpeg(d):
        pipe = parse_launch(
            f"appsrc name=in caps=video/x-raw,format=I420,width={w},height="
            f"{h},framerate=25/1 ! jpegenc ! rtpjpegpay mtu=300 ! tee name=t "
            f"t. ! queue ! appsink name=out t. ! queue ! rtpjpegdepay ! "
            f"appsink name=out1", batch=n, device="cpu")
        planes = cont_video("I420", n, w, h, 5)
        pipe.get_by_name("in").push_buffer(Buffer(data=tuple(
            torch.from_numpy(p) for p in planes), batch=n,
            pts=0, duration=40_000_000))
        pipe.get_by_name("in").end_of_stream()
        pipe.run()
        jp = [x for s in drain(pipe.get_by_name("out1"))
              for x in (s.buffer.data if isinstance(s.buffer.data, list)
                        else [s.buffer.data])]
        return cont_launch(
            "appsrc name=in caps=image/jpeg ! rtpjpegpay mtu=300 quality=90 "
            "! tee name=t t. ! queue ! appsink name=out t. ! queue ! "
            "rtpjpegdepay ! appsink name=out1", d, 1,
            {"in": [dict(data=np.asarray(x), pts=k * 40_000_000)
                    for k, x in enumerate(jp)]}), bc_plain(jp)

    def socket_pair(send_desc, recv_desc, pushes, ticks=20):
        def run(d):
            rx = parse_launch(recv_desc, device=d)
            rx.set_state("playing")
            port = next(e for e in rx.iterate_elements()
                        if hasattr(e, "bound_port")).bound_port
            tx = parse_launch(send_desc.format(port=port), device=d)
            for b in pushes:
                tx.get_by_name("in").push_buffer(Buffer(**dict(
                    b, data=torch.from_numpy(b["data"]).to(d))))
            tx.get_by_name("in").end_of_stream()
            tx.set_state("playing")
            got = bytearray()
            want = sum(b["data"].nbytes for b in pushes)
            deadline = time.monotonic() + 10.0
            for _ in range(ticks):
                more = tx.tick()
                while len(got) < want and time.monotonic() < deadline:
                    if not rx.tick():
                        break
                    for s in drain(rx.get_by_name("s")):
                        got += rr_pkt_bytes(s.buffer.data)
                if not more:
                    break
            tx.set_state("null")
            rx.set_state("null")
            require(bytes(got) == b"".join(b["data"].tobytes()
                                           for b in pushes),
                    f"{send_desc.split()[4]} to {recv_desc.split()[0]}: "
                    f"{len(got)} bytes back of {want}, or other bytes")
            return bytes(got)
        return run

    def tcp_server_to_client(d, data):
        srv = parse_launch("appsrc name=in caps=application/octet-stream ! "
                           "tcpserversink name=snd port=0", device=d)
        srv.get_by_name("in").push_buffer(Buffer(
            data=torch.from_numpy(data).to(d), batch=1))
        srv.set_state("playing")
        snd = srv.get_by_name("snd")
        cli = parse_launch(f"tcpclientsrc port={snd.bound_port} timeout=2.0 "
                           "! appsink name=s", device=d)
        cli.set_state("playing")
        deadline = time.monotonic() + 10.0
        while not snd._clients and time.monotonic() < deadline:
            time.sleep(0.01)
        srv.tick()
        got = bytearray()
        while len(got) < data.nbytes and cli.tick():
            for s in drain(cli.get_by_name("s")):
                got += rr_pkt_bytes(s.buffer.data)
        srv.set_state("null")
        cli.set_state("null")
        require(bytes(got) == data.tobytes(), f"tcpserversink to "
                f"tcpclientsrc: {len(got)} bytes back of {data.nbytes}, or "
                f"other bytes")
        return bytes(got)

    def rtp_uri(d):
        port = rr_free_port()
        rx = parse_launch(f"rtpsrc uri=rtp://127.0.0.1:{port}?media=audio"
                          "&clock-rate=8000 timeout=1.0 num-buffers=3 ! "
                          "appsink name=out", device=d)
        rx.set_state("playing")
        tx = parse_launch("audiotestsrc num-buffers=3 samplesperbuffer=160 ! "
                          "audio/x-raw,format=S16LE,rate=8000,channels=1 ! "
                          f"mulawenc ! rtppcmupay ! rtpsink uri=rtp://"
                          f"127.0.0.1:{port}", device=d)
        tx.run()
        rx.run()
        got = drain(rx.get_by_name("out"))
        require(sum(s.buffer.batch for s in got) == 3, f"rtpsink to "
                f"rtpsrc: {sum(s.buffer.batch for s in got)} buffers of 3")
        return bc_plain([s.buffer.data for s in got])

    def sdp_elements(d):
        out = []
        for kind in ("sdpdemux", "sdpsrc"):
            port = rr_free_port()
            text = ("v=0\r\no=- 0 0 IN IP4 127.0.0.1\r\ns=x\r\nc=IN IP4 "
                    f"127.0.0.1\r\nt=0 0\r\nm=audio {port} RTP/AVP 0\r\n"
                    "a=rtpmap:0 PCMU/8000\r\n")
            path = os.path.join(tmp, f"{kind}.{d.type}.sdp")
            with open(path, "w") as f:
                f.write(text)
            loc = (f"location={path}" if kind == "sdpdemux" else
                   f"location=sdp://{path}")
            rx = parse_launch(f"{kind} {loc} media=audio timeout=1.0 "
                              "num-buffers=2 ! appsink name=out", device=d)
            rx.set_state("playing")
            tx = parse_launch("audiotestsrc num-buffers=2 samplesperbuffer="
                              "160 ! audio/x-raw,format=S16LE,rate=8000,"
                              "channels=1 ! mulawenc ! rtppcmupay ! udpsink "
                              f"port={port}", device=d)
            tx.run()
            rx.run()
            got = drain(rx.get_by_name("out"))
            require(sum(s.buffer.batch for s in got) == 2, f"udpsink to "
                    f"{kind}: {sum(s.buffer.batch for s in got)} buffers "
                    f"of 2")
            out.append(bc_plain([(str(s.caps), s.buffer.data)
                                 for s in got]))
        return out

    def rtsp_play_record(d):
        from gstreamer_tpu_torch.net.rtsp_server import (RTSPMediaFactory,
                                                         RTSPServer)
        srv = RTSPServer(service=0)
        srv.mount_points.add_factory("/test", RTSPMediaFactory(
            f"( videotestsrc num-buffers=4 pattern=gradient ! {vraw} ! "
            "rtpvrawpay name=pay0 pt=96 )", rate_control=False, device=d))
        rec = os.path.join(tmp, f"rec.{d.type}.rgb")
        srv.mount_points.add_factory("/publish", RTSPMediaFactory(
            "( appsrc name=depay0 caps=application/x-rtp ! rtpvrawdepay "
            f"caps=\"{vraw}\" ! filesink location={rec} )",
            transport_mode="record", device=d))
        port = srv.attach()
        try:
            p = parse_launch(f"rtspsrc location=rtsp://127.0.0.1:{port}/test"
                             f" protocols=tcp {RR_WAIT} ! rtpvrawdepay ! "
                             "appsink name=out", device=d)
            p.run()
            frames = cont_joined(drain(p.get_by_name("out")))
            pub = parse_launch(
                f"videotestsrc num-buffers=4 pattern=gradient ! {vraw} ! "
                "rtpvrawpay pt=96 ! rtspclientsink name=snk location=rtsp://"
                f"127.0.0.1:{port}/publish protocols=tcp", device=d)
            pub.run()
        finally:
            srv.shutdown()
        with open(rec, "rb") as f:
            got = f.read()
        played = 0 if frames is None else (
            frames[0] if isinstance(frames, tuple) else frames).shape[0]
        require(played == n and len(got) == n * w * h * 3,
                f"rtspsrc / rtspclientsink: {played} frames of {n} played, "
                f"{len(got)} bytes recorded of {n * w * h * 3}")
        return bc_plain(frames), got

    def icy(d):
        payload = bytes(range(256)) * 2
        meta = b"StreamTitle='Cam';"
        meta += b"\0" * (-len(meta) % 16)
        blob = bytearray()
        for k in range(0, len(payload), 128):
            blob += payload[k:k + 128]
            blob += bytes([len(meta) // 16]) + meta if k == 0 else b"\0"
        path = os.path.join(tmp, "icy.bin")
        with open(path, "wb") as f:
            f.write(bytes(blob))
        return cont_launch(f"icydemux location={path} metaint=128 ! appsink "
                           "name=out", d, 1)

    def dca(size):
        hdr = bytearray(16)
        hdr[0:4] = b"\x7f\xfe\x80\x01"
        v = size - 1
        hdr[5], hdr[6], hdr[7] = (v >> 12) & 3, (v >> 4) & 0xFF, \
            (v & 0xF) << 4
        return bytes(hdr) + bytes(size - 16)

    amr = b"#!AMR\n" + (bytes([2 << 3]) + b"\x55" * 15) * 4
    pcap = rr_pcap([p for p in pkts], RR_DPORT)
    rows = [
        (("rtpvrawpay", "rtpvrawdepay"), False, launch(
            f"appsrc name=in caps={vraw} ! rtpvrawpay mtu=400 ! "
            f"rtpvrawdepay caps={vraw} ! appsink name=out",
            {"in": [dict(data=rgb, pts=0, duration=40_000_000, batch=n)]},
            n)),
        (("rtpL16pay", "rtpL16depay"), False, launch(
            f"appsrc name=in caps={acaps.format('S16LE')} ! rtpL16pay "
            f"mtu=400 ! rtpL16depay caps=\"{acaps.format('S16LE')}\" ! "
            "appsink name=out", {"in": [dict(data=a16, pts=0)]})),
        (("rtpL8pay", "rtpL8depay"), False, launch(
            f"appsrc name=in caps={acaps.format('U8')} ! rtpL8pay mtu=300 "
            f"! rtpL8depay caps=\"{acaps.format('U8')}\" ! appsink name=out",
            {"in": [dict(data=(a16 >> 8).astype(np.uint8), pts=0)]})),
        (("rtpL24pay", "rtpL24depay"), False, launch(
            f"appsrc name=in caps={acaps.format('S24BE')} ! rtpL24pay "
            f"mtu=300 ! rtpL24depay caps=\"{acaps.format('S24BE')}\" ! "
            "appsink name=out",
            {"in": [dict(data=a16.astype(np.int32) << 8, pts=0)]})),
        (("rtpjitterbuffer",), False, launch(
            "appsrc name=in caps=application/x-rtp,clock-rate=90000 ! "
            "rtpjitterbuffer latency=0 ! appsink name=out",
            rtp_in(shuffled))),
        (("asteriskh263",), False, launch(
            "appsrc name=in caps=application/x-rtp ! asteriskh263 ! appsink "
            "name=out", rtp_in(pkts))),
        (("rtpsession",), False, launch(
            "appsrc name=in caps=application/x-rtp ! rtpsession ! appsink "
            "name=out", rtp_in(pkts))),
        (("rtpbin",), False, launch(
            "appsrc name=in caps=application/x-rtp ! rtpbin latency=0 ! "
            "appsink name=out", rtp_in(shuffled))),
        (("rtppcmupay", "rtppcmudepay", "rtppcmapay", "rtppcmadepay"),
         False, launch(
             "audiotestsrc num-buffers=2 samplesperbuffer=400 ! audio/x-raw,"
             "format=S16LE,rate=8000,channels=1 ! tee name=t t. ! queue ! "
             "mulawenc ! rtppcmupay mtu=200 ! rtppcmudepay ! mulawdec ! "
             "appsink name=out t. ! queue ! alawenc ! rtppcmapay mtu=200 ! "
             "rtppcmadepay ! alawdec ! appsink name=out1")),
        (("rtph264pay", "rtph264depay"), False, launch(
            "appsrc name=in caps=video/x-h264,stream-format=byte-stream,"
            "alignment=au ! rtph264pay mtu=40 ! rtph264depay ! appsink "
            "name=out", {"in": [dict(data=a, pts=k * 40_000_000)
                                for k, a in enumerate(aus)]})),
        (("rtpptdemux", "rtpssrcdemux"), False, launch(
            "appsrc name=in caps=application/x-rtp ! tee name=t t. ! queue ! "
            "rtpptdemux name=p p.src_0 ! appsink name=out p.src_1 ! appsink "
            "name=out1 t. ! queue ! rtpssrcdemux name=s s.src_0 ! appsink "
            "name=out2 s.src_1 ! fakesink", rtp_in(pkts))),
        (("rtpdtmfsrc", "rtpdtmfdepay"), False, launch(
            "rtpdtmfsrc tones=1#9 tone-duration=100 ! tee name=t t. ! queue ! "
            "appsink name=out t. ! queue ! rtpdtmfdepay ! appsink name=out1",
            batch=2)),
        (("rtpjpegpay", "rtpjpegdepay"), False, jpeg),
        (("rtpmux", "rtpdtmfmux", "rtpfunnel"), False, launch(
            "audiotestsrc num-buffers=2 samplesperbuffer=400 ! audio/x-raw,"
            "format=S16LE,rate=8000,channels=1 ! mulawenc ! rtppcmupay ! "
            "tee name=t t. ! queue ! rtpmux ssrc=7 seqnum-offset=9 ! appsink "
            "name=out t. ! queue ! rtpdtmfmux ! appsink name=out1 t. ! queue "
            "! rtpfunnel ! appsink name=out2")),
        (("rtprtxsend", "rtprtxreceive", "rtprtxqueue"), False, rtx),
        (("rtpvp8pay", "rtpvp8depay"), False,
         coded("rtpvp8pay", "rtpvp8depay", "video/x-vp8")),
        (("rtpvp9pay", "rtpvp9depay"), False,
         coded("rtpvp9pay", "rtpvp9depay", "video/x-vp9")),
        (("rtpopuspay", "rtpopusdepay"), False,
         coded("rtpopuspay", "rtpopusdepay", "audio/x-opus")),
        (("rtphdrextclientaudiolevel", "rtphdrextmid", "rtphdrextstreamid",
          "rtphdrextrepairedstreamid", "rtphdrextntp64", "rtphdrexttwcc",
          "rtphdrextcolorspace"), False, hdrext),
        (("dtmfsrc",), False, launch("dtmfsrc tones=159 tone-duration=60 ! "
                                     "appsink name=out")),
        (("icydemux",), False, icy),
        (("amrparse", "dcaparse"), False, launch(
            "appsrc name=in caps=application/octet-stream ! tee name=t t. ! "
            "queue ! amrparse ! appsink name=out t. ! queue ! dcaparse ! "
            "appsink name=out1",
            {"in": [dict(data=np.frombuffer(amr + dca(96) * 2 + dca(128),
                                            np.uint8))]})),
        (("pcapparse",), False, launch(
            "appsrc name=in caps=raw/x-pcap ! pcapparse dst-port=5004 caps="
            "application/x-rtp,media=video,clock-rate=90000 ! appsink "
            "name=out", {"in": [dict(data=np.frombuffer(pcap, np.uint8),
                                     pts=0)]})),
        (("udpsink", "udpsrc"), True, socket_pair(
            "appsrc name=in caps=application/octet-stream ! udpsink "
            "port={port} mtu=1000",
            "udpsrc name=u port=0 timeout=1.0 ! appsink name=s",
            [dict(data=rng.integers(0, 256, 5000, dtype=np.uint8))])),
        (("tcpclientsink", "tcpserversrc"), True, socket_pair(
            "appsrc name=in caps=application/octet-stream ! tcpclientsink "
            "port={port}",
            "tcpserversrc name=r port=0 timeout=2.0 ! appsink name=s",
            [dict(data=rng.integers(0, 256, 9000, dtype=np.uint8))])),
        (("tcpserversink", "tcpclientsrc"), True,
         lambda d, x=rng.integers(0, 256, 30000, dtype=np.uint8):
         tcp_server_to_client(d, x)),
        (("rtpsink", "rtpsrc"), True, rtp_uri),
        (("sdpdemux", "sdpsrc"), True, sdp_elements),
        (("rtspsrc", "rtspclientsink"), True, rtsp_play_record),
    ]
    covered = {f for r in rows for f in r[0]}
    mine = rr_factories()
    require(covered == mine and len(mine) == 60,
            f"rtp/rtsp alone: the rows cover {len(covered)} factories, the "
            f"slice's modules register {len(mine)}; not driven: "
            f"{sorted(mine - covered)}")
    return rows


def rr_factories(modules=RR_MODULES):
    """The factories whose registered class `modules` define (dtmf_icy's
    aacparse is audioparsers' class, not its own; rtp_payloaders2's raw
    rtpsirenpay pair gives way to siren_elements')."""
    from gstreamer_tpu_torch.core.element import (get_factory_class,
                                                  list_factories)
    return {f for f in list_factories()
            if get_factory_class(f).__module__ in modules}


def rr_alone(counters, dev, files, tmp, sockets):
    """Each of the 60 factories alone or with its pair on the card and on
    the CPU (alone_runs): the same plain data, no launch.  The socket
    factories run only where the probe found loopback."""
    rows, skipped = [], []
    for names, uses_sockets, fn in rr_alone_rows(files, tmp):
        if uses_sockets and not sockets:
            skipped.extend(names)
        else:
            rows.append(("/".join(names),
                         lambda d, _tmp, _seed, fn=fn: fn(d)))
    alone_runs(rows, counters, dev, 0)
    print(f"  rtp/rtsp alone: {60 - len(skipped)} factories in {len(rows)} "
          f"runs on the card == the port's CPU run, no launch"
          + (f"; not run (no loopback): {skipped}" if skipped else ""))


def rtp_rtsp_phase(seed, counters, dev):
    """RTP, the socket transports, RTSP and pcapparse on the card, each
    item with the launch counts zeroed just before and read just after:
    the loopback probe line first; rtsp_mjpeg_ingest (TCP interleaved,
    yscale_hv once a tick that gives frames), rtsp_mjpeg_udp with
    rtcp_session, pcap_mjpeg_replay (no socket; yscale_hv once a tick that
    gives frames), rtp_l16_asr, rtp_vraw_uyvy (generic route, no kernel),
    rtp_coded_passthrough; then each of the 60 factories alone.  Only the
    socket items go unrun, and only where the probe found no loopback.
    Returns {kernel: launches}."""
    import tempfile

    import torch
    start, finish, peak, total = phase_meters(counters, dev)
    t0 = time.perf_counter()
    probe = rr_probe()
    sockets = probe["udp"] and probe["tcp"]
    print(f"rtp/rtsp phase: loopback probe on 127.0.0.1: {probe}; "
          + ("the socket items run" if sockets else
             "the socket items (rtsp_mjpeg_ingest, rtsp_mjpeg_udp, "
             "rtcp_session, rtp_l16_asr's UDP leg, the Opus UDP leg and the "
             "socket factories) are not run; the others run"))
    files, _dig = codec_vectors(("vp8_1080p.ivf", "opus_10s.opus",
                                 "digests.json"))
    with tempfile.TemporaryDirectory() as tmp:
        jdir, _jpgs = rr_jpegs(seed, dev, tmp)
        start("multifilesrc ! jpegdec")
        ref = rr_rgb_ref(jdir, dev)
        finish("multifilesrc ! jpegdec",
               {"yscale_hv": -(-RR_CAM[2] // RR_CAM[3])})
        require(cont_equal(ref, rr_rgb_ref(jdir, torch.device("cpu"))),
                "multifilesrc ! jpegdec: the card's RGB differs from the "
                "port's CPU run")
        stats = {}
        start("rtpjpegpay")
        pkts = rr_pay(dev, jdir, stats)
        finish("rtpjpegpay", {})
        sent = rr_frames(pkts)
        require(len(sent) == RR_CAM[2], f"rtpjpegpay: {len(sent)} frames "
                f"of {RR_CAM[2]}")
        print(f"  rtp/rtsp: {rr_rates(stats)}, "
              f"{len(pkts) / len(sent):.1f} packets a frame")
        if sockets:
            tcp_rgb = rtsp_mjpeg_ingest(dev, jdir, ref, start, finish, peak)
            rtsp_mjpeg_udp(dev, jdir, tcp_rgb, sent, start, finish, peak)
        pcap_mjpeg_replay(dev, jdir, ref, pkts, tmp, start, finish, peak)
        if sockets:
            rtp_l16_asr(seed, dev, start, finish, peak)
        rtp_vraw_uyvy(seed, dev, start, finish, peak)
        if sockets:
            rtp_coded_passthrough(dev, files, start, finish, peak)
        rr_alone(counters, dev, files, tmp, sockets)
    print(f"rtp/rtsp phase: {time.perf_counter() - t0:.1f} s")
    return total


RF_MODULES = tuple(f"gstreamer_tpu_torch.{m}" for m in (
    "net.rtp_payloaders2", "net.fec", "net.rtp_tail",
    "elements.siren_elements"))
RF_ROWS = 5                         # SMPTE 2022-1's row length L
RF_GROUP = 4                        # ULPFEC's media packets a FEC packet
RF_RED_MTU = 700                    # RED's payloader: blocks under 1024 bytes
RF_FIRST = (1, 5, 9, 13, 17, 21)    # frames that lose their first packet
RF_MIDDLE = (2, 3, 6, 7, 10, 11, 18, 19, 22, 23)    # ... a middle packet
RF_MIDDLE_AT = 50                   # which one
RF_GST = 16                         # rtp_gst_raw's 1080p frames
RF_TS_BLOCK = 188 * 70              # filesrc's bytes a buffer of the TS
RF_TS_DROPS = 12                    # rtp_mp2t_line's rows that lose a packet
RF_SIREN = 10                       # siren_rtp's seconds of 16 kHz mono
RF_UDP_FIGURES = {}                 # rtp_fec_udp's numbers, when it ran
# name, the payloader's MTU, the encoder, the decoder, the FEC payload type
RF_PROTECT = (
    ("st2022_1", RR_MTU, f"rtpst2022_1_fecenc rows={RF_ROWS}",
     "rtpst2022_1_fecdec", 100),
    ("ulpfec", RR_MTU, f"rtpulpfecenc percentage=100 group-size={RF_GROUP}",
     "rtpstorage ! rtpulpfecdec ! rtpjitterbuffer", 122),
    ("red", RF_RED_MTU, "rtpredenc distance=1", "rtpreddec", None))


def phase_meters(counters, dev):
    """A phase's start(what) (zero the launch counts, reset the peak; the
    memory in use), finish(what, want) (the counts must be `want`; added to
    the phase's totals) and peak(base) (MiB above `base`), and the totals."""
    import torch
    cuda = dev.type == "cuda"
    total = {k: 0 for k in counters}

    def start(what):
        for c in counters.values():
            c.launches = 0
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            return torch.cuda.memory_allocated()
        return 0

    def finish(what, want):
        counts = {k: c.launches for k, c in counters.items()}
        require(counts == {k: want.get(k, 0) for k in counters},
                f"{what}: launches {counts}, want {want}")
        for k, v in counts.items():
            total[k] += v
        return {k: v for k, v in counts.items() if v}

    def peak(base):
        return (torch.cuda.max_memory_allocated() - base) / 2**20 if cuda \
            else 0.0
    return start, finish, peak, total


def rf_seq(p):
    return (p[2] << 8) | p[3]


def rf_pay(dev, jdir, mtu, enc=""):
    """The camera's JPEG files through rtpjpegpay mtu=`mtu` (then `enc`)
    on the host, a buffer a frame: [the packets of frame k, with the FEC
    packets the encoder sent after them]."""
    tail = f"{enc} ! " if enc else ""
    got = [[rr_pkt_bytes(x) for x in s.buffer.data] for s in codec_run(
        f"multifilesrc location={jdir}/cam_%05d.jpg caps=image/jpeg,"
        f"framerate={CONT_FPS}/1 ! rtpjpegpay mtu={mtu} ! {tail}appsink "
        "name=p", dev, 1, "p")]
    require(len(got) == RR_CAM[2], f"rtpjpegpay ! {enc}: {len(got)} buffers "
            f"of {RR_CAM[2]} frames")
    return got


def rf_rows(kind, push, fec_pt):
    """The rows a pushed buffer's own packets can recover: the sequence
    numbers a FEC packet protects when all of them and it are in the buffer
    (SMPTE 2022-1, ULPFEC); for RED, a packet whose neighbours are there
    (the next carries it, the one before shows the gap)."""
    media = {rf_seq(p) for p in push if (p[1] & 0x7F) != fec_pt}
    if kind == "red":
        return [(s,) for s in media
                if (s - 1) & 0xFFFF in media and (s + 1) & 0xFFFF in media]
    return [run for run in (rf_run(kind, p) for p in push
                            if (p[1] & 0x7F) == fec_pt)
            if set(run) <= media]


def rf_run(kind, p):
    """The sequence numbers a FEC packet protects (SMPTE 2022-1 or
    ULPFEC), as each decoder parses them."""
    from gstreamer_tpu_torch.net.fec import parse_fec_packet
    from gstreamer_tpu_torch.net.rtp import parse_rtp_header
    from gstreamer_tpu_torch.net.rtp_payloaders2 import ulpfec_header
    if kind == "ulpfec":
        return tuple(ulpfec_header(parse_rtp_header(p)["payload"])
                     ["protected"])
    f = parse_fec_packet(p)
    return tuple((f["sn_base"] + i * f["offset"]) & 0xFFFF
                 for i in range(f["na"]))


def rf_straddled(a, b, fec_pt):
    """The rows that start in pushed buffer `a` and end, with their FEC
    packets, in `b` (SMPTE 2022-1)."""
    mine = {rf_seq(p) for p in a if (p[1] & 0x7F) != fec_pt}
    return [run for run in (rf_run("st2022_1", p) for p in b
                            if (p[1] & 0x7F) == fec_pt)
            if run[0] in mine and run[-1] not in mine]


def rf_cut_in_row(full, fec_pt):
    """SMPTE 2022-1 pushes whose first cut lies inside a row: where the
    frames' cut falls at a row's end, the next row's first two media
    packets move to the first buffer (rtpjpegdepay joins a frame across
    buffers)."""
    a, b = full[0], full[1]
    if rf_straddled(a, b, fec_pt):
        return full
    k = [i for i, p in enumerate(b) if (p[1] & 0x7F) != fec_pt][1] + 1
    return [a + b[:k], b[k:]] + full[2:]


def rf_straddle(full, fec_pt, drops):
    """SMPTE 2022-1: the first packet of the first row that starts in one
    pushed buffer and ends, with its FEC packet, in the next, and holds no
    other drop; only a decoder that keeps its packets across buffers (the
    port's, not the JAX package's) recovers it.  Returns (the sequence
    number, the row's)."""
    for a, b in zip(full, full[1:]):
        for run in rf_straddled(a, b, fec_pt):
            if not set(run) & drops:
                return run[0], run
    require(False, "st2022_1: no row straddles two pushed buffers")


def rf_pattern(kind, plain, protected, fec_pt):
    """Drop pattern (a): the first packet of each frame of RF_FIRST and
    packet RF_MIDDLE_AT of each of RF_MIDDLE (never a frame's last), one in
    each of 16 rows that the pushed buffer (RR_CAM[3] frames) holding it
    can recover; under SMPTE 2022-1 one more, rf_straddle's, the first
    cut inside a row (rf_cut_in_row).  Returns (the sequence numbers, the
    pushes with them dropped from `protected`, the eligible rows,
    rf_straddle's or None)."""
    batch = RR_CAM[3]
    drops = [rf_seq(plain[k][0]) for k in RF_FIRST]
    for k in RF_MIDDLE:
        require(len(plain[k]) > RF_MIDDLE_AT + 1,
                f"frame {k}: {len(plain[k])} packets")
        drops.append(rf_seq(plain[k][RF_MIDDLE_AT]))
    full = [[p for f in protected[i:i + batch] for p in f]
            for i in range(0, len(protected), batch)]
    if kind == "st2022_1":
        full = rf_cut_in_row(full, fec_pt)
    rows = [r for push in full for r in rf_rows(kind, push, fec_pt)]
    for s in drops:
        mine = [r for r in rows if s in r]
        require(mine and all(len(set(r) & set(drops)) == 1 for r in mine),
                f"{kind}: packet {s} lies in no row its buffer recovers "
                f"alone, or shares one with another drop")
    if kind == "red":
        require(all((s + 1) & 0xFFFF not in drops for s in drops),
                "red: two drops in a row")
    straddle = None
    if kind == "st2022_1":
        straddle = rf_straddle(full, fec_pt, set(drops))
        drops.append(straddle[0])
    pushes = [[p for p in push if (p[1] & 0x7F) == fec_pt
               or rf_seq(p) not in drops] for push in full]
    return set(drops), pushes, len(rows), straddle


def rf_buffers(pushes):
    """Pushed packet lists as buffers, RR_CAM[3] frames of time each."""
    from gstreamer_tpu_torch.core.buffer import Buffer
    dur = RR_CAM[3] * 10**9 // CONT_FPS
    return [Buffer(data=list(p), pts=k * dur, duration=dur)
            for k, p in enumerate(pushes)]


def rf_camera_desc(dec):
    w, h = RR_CAM[:2]
    return (f"appsrc name=in caps={RR_RTP_JPEG} ! {dec + ' ! ' if dec else ''}"
            f"rtpjpegdepay ! jpegdec ! {rr_caps(w, h)} ! {CONT_RGB}")


def rtp_fec_camera(dev, jdir, ref, sent, start, finish, peak):
    """The camera's 32 JPEGs through rtpjpegpay and each protection of
    RF_PROTECT, drop pattern (a) on the host, then appsrc ! the decoder !
    rtpjpegdepay ! jpegdec ! videoconvertscale to RGB 224x224 on the card
    at batch RR_CAM[3] (rr_drive: yscale_hv once a tick that gives
    frames): rtpjpegdepay takes the payloader's packets, every one, in
    order; every frame's RGB equals multifilesrc ! jpegdec's (== the TCP
    run's) and the port's CPU run.  Pattern (b): the same packets dropped
    from the plain stream, no decoder; the frames whole by their packets,
    and the run, which ends at the first headless frame (ROADMAP.md
    section 3), reported as that fault."""
    import torch
    from gstreamer_tpu_torch.net import rtp_payloaders as rp
    n = RR_CAM[2]
    for kind, mtu, enc, dec, fec_pt in RF_PROTECT:
        name = f"rtp_fec_camera[{kind}]"
        stats = {}
        start(name)
        plain = sent if mtu == RR_MTU else rf_pay(dev, jdir, mtu)
        t0 = time.perf_counter()
        with cont_timed(rp.RtpJpegPay, "host_process", stats, "rtpjpegpay",
                        rr_packets_out):
            protected = rf_pay(dev, jdir, mtu, enc)
        enc_s = time.perf_counter() - t0
        finish(name, {})
        drops, pushes, eligible, straddle = rf_pattern(kind, plain,
                                                       protected, fec_pt)
        flat = [p for f in plain for p in f]
        took = []

        def record(args, out):
            if args[-1] is None:
                return 0
            took.extend(rr_pkt_bytes(x) for x in args[-1].data)
            return len(args[-1].data)
        out, r = rr_drive(name, rf_camera_desc(dec), dev, start, finish,
                          peak, (cont_timed(rp.RtpJpegDepay, "host_process",
                                            stats, "rtpjpegdepay", record),),
                          pushes={"in": rf_buffers(pushes)})
        rgb = cont_joined(out)
        got = {rf_seq(p) for p in took} & drops
        require(took == flat, f"{name}: rtpjpegdepay took {len(took)} "
                f"packets, not the payloader's {len(flat)} in order")
        require(rgb is not None and cont_equal(rgb, ref),
                f"{name}: RGB other than multifilesrc ! jpegdec's")
        t0 = time.perf_counter()
        require(cont_equal(cont_joined(codec_run(
            rf_camera_desc(dec), torch.device("cpu"), RR_CAM[3], "v",
            {"in": rf_buffers(pushes)})), rgb),
                f"{name}: the card's RGB differs from the port's CPU run")
        cpu_s = time.perf_counter() - t0
        sent_n = sum(len(f) for f in protected)
        rr_report(name, r)
        print(f"  {name}: rtpjpegpay mtu={mtu} ! {enc}: {sent_n} packets "
              f"({len(flat)} media) in {enc_s:.3f} s; dropped {len(drops)} "
              f"media packets, one in each of {len(drops) - bool(straddle)} "
              f"of the {eligible} rows the pushed buffers recover alone (the "
              f"first packet of frames {list(RF_FIRST)}, packet "
              f"{RF_MIDDLE_AT} of {list(RF_MIDDLE)})"
              + (f" and packet {straddle[0]}, the first of row "
                 f"{straddle[1][0]}..{straddle[1][-1]}, which straddles two "
                 f"pushed buffers (recovered only by the port's decoder, "
                 f"ROADMAP.md section 3)" if straddle else "") + "; "
              f"recovered {len(got)}; {n} of {n} frames whole == multifilesrc "
              f"! jpegdec's RGB (== the TCP run's) == the port's CPU run "
              f"({cpu_s:.1f} s); "
              f"yscale_hv {r['launches'].get('yscale_hv', 0)} in the "
              f"{r['fed_ticks']} ticks that gave frames; {rr_rates(stats)}")
        lossy = [[p for p in f if rf_seq(p) not in drops] for f in plain]
        whole, _lost = rr_whole_frames([p for f in lossy for p in f], plain)
        start(f"{name}[no decoder]")
        got, fault = rf_no_decoder(dev, lossy)
        finish(f"{name}[no decoder]", {"yscale_hv": len(got)})
        frames = sum(x.buffer.batch for x in got)
        headless = rr_depay_images([lossy[RF_FIRST[0]]])
        require(fault and str(fault["error"]) == "not a JPEG"
                and fault["image"] in headless
                and not set(rr_depay_images(plain)) & set(headless),
                f"{name}[no decoder]: {fault} (want jpegdec's 'not a JPEG' "
                f"on frame {RF_FIRST[0]}, which lost its first packet)")
        print(f"  {name}[no decoder]: the same {len(drops)} packets dropped "
              f"from the plain stream: {len(whole)} of {n} frames whole by "
              f"their packets; reference fault (ROADMAP.md section 3): "
              f"rtpjpegdepay handed on frame {RF_FIRST[0]} without its first "
              f"packet and jpegdec raised {fault['error']!r} on it, ending "
              f"the pipeline after {frames} frames")


def rf_no_decoder(dev, lossy):
    """Pattern (b): the lossy plain stream (a list of packets a frame) into
    appsrc ! rtpjpegdepay ! jpegdec ! ... on `dev` with no decoder, a
    pushed buffer RR_CAM[3] frames: (the samples, a tick that gave frames
    each; jpegdec's fault (rr_jpeg_fault) that ended it, or {}).  Any
    other error propagates."""
    batch = RR_CAM[3]
    pushes = [[p for f in lossy[i:i + batch] for p in f]
              for i in range(0, len(lossy), batch)]
    got, fault = [], {}
    try:
        with rr_jpeg_fault(fault):
            codec_run(rf_camera_desc(""), dev, batch, "v",
                      {"in": rf_buffers(pushes)}, got)
    except Exception as e:
        if e is not fault.get("error"):
            raise
    return got, fault


@contextlib.contextmanager
def rf_sender(desc, dev, started, spent, name="rtp_fec_udp"):
    """While the block runs, a thread that waits for `started`, then ticks
    the sender `desc` (batch 1: a frame a tick) at CONT_FPS frames a
    second; its host seconds in spent["sender"] (`name`: the item's, in
    errors)."""
    import threading
    from gstreamer_tpu_torch import parse_launch
    failed = []

    def run():
        try:
            require(started.wait(30.0), f"{name}: the receiver never "
                    "started")
            tx = parse_launch(desc, device=dev)
            tx.set_state("playing")
            t0 = time.perf_counter()
            k = 0
            while tx.tick():
                k += 1
                time.sleep(max(0.0, t0 + k / CONT_FPS - time.perf_counter()))
            spent["sender"] = time.perf_counter() - t0
            tx.set_state("null")
        except Exception as e:        # handed to the main thread
            failed.append(e)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        yield spent
    finally:
        t.join(60.0)
        require(not t.is_alive(), f"{name}: the sender did not end")
        if failed:
            raise failed[0]


def rtp_fec_udp(dev, jdir, ref, sent, start, finish, peak):
    """The camera over UDP on loopback with SMPTE 2022-1: a sender thread
    (multifilesrc ! rtpjpegpay ! rtpst2022_1_fecenc ! udpsink at 25/1) and
    the camera's path in one pipeline on the card, udpsrc (a datagram a
    tick) ! rtpst2022_1_fecdec ! rtpjpegdepay ! jpegdec ! videoconvertscale
    to RGB 224x224 (rr_camera_run: yscale_hv once a tick that gives
    frames).  Prints the packets loopback lost, those recovered and the
    frames whole; each whole frame's RGB equals its frame of multifilesrc !
    jpegdec (== the TCP run's), up to jpegdec's fault on a frame that lost
    packets for good where it raises (rr_camera_check)."""
    import threading
    from gstreamer_tpu_torch.net import fec, transport
    w, h, n, _batch = RR_CAM
    port = rr_free_port()
    started, spent, fed_in, decs = threading.Event(), {}, [], []

    def record_dec(args, out):
        decs[:] = [args[0]]
        if args[-1] is None:
            return 0
        d = args[-1].data
        fed_in.extend(rr_pkt_bytes(x) for x in (d if isinstance(d, list)
                                                else [d]))
        return 1
    sender = (f"multifilesrc location={jdir}/cam_%05d.jpg caps=image/jpeg,"
              f"framerate={CONT_FPS}/1 ! rtpjpegpay ! rtpst2022_1_fecenc "
              f"rows={RF_ROWS} ! udpsink port={port}")
    # the sender last: it is joined first, with the counters still on
    took, images, v, r, fault = rr_camera_run(
        "rtp_fec_udp", f"udpsrc port={port} timeout=1.0 caps="
        f"{RR_RTP_JPEG} ! rtpst2022_1_fecdec name=dec ! rtpjpegdepay ! "
        f"jpegdec ! {rr_caps(w, h)} ! {CONT_RGB}", dev, start, finish, peak,
        spent, (cont_timed(transport.UDPSrc, "start", spent, "udpsrc",
                           lambda a, o: started.set() or 0),
                cont_timed(fec.RtpSt2022FecEnc, "host_process", spent,
                           "fecenc", rr_packets_out),
                cont_timed(fec.RtpSt2022FecDec, "host_process", spent,
                           "fecdec", record_dec),
                rf_sender(sender, dev, started, spent)))
    whole, checked = rr_camera_check("rtp_fec_udp", sent, ref, images, v,
                                     fault)
    media = sum(len(f) for f in sent)
    sent_n = spent.get("fecenc packets", 0)
    # what loopback lost: the media sequence numbers missing up to the last
    # one the receiver read (the stream starts at 0 and does not wrap)
    seqs = {rf_seq(p) for p in fed_in if (p[1] & 0x7F) != 100}
    last = max(seqs, default=-1)
    have = {p[12:] for p in took}
    first_lost = [k for k, f in enumerate(sent)
                  if rf_seq(f[0]) <= last and f[0][12:] not in have]
    RF_UDP_FIGURES.update(read=last + 1, lost=last + 1 - len(seqs),
                          recovered=decs[0].recovered if decs else 0,
                          whole=whole)
    print(f"  rtp_fec_udp: the sender sent {sent_n} packets ({media} media, "
          f"{sent_n - media} FEC) in {spent.get('sender', 0):.3f} s; the "
          f"receiver read media up to sequence number {last} of "
          f"{media - 1}{' (the run ended there)' if fault else ''}: loopback "
          f"lost {last + 1 - len(seqs)} of those {last + 1}; "
          f"rtpst2022_1_fecdec recovered "
          f"{decs[0].recovered if decs else 0}; rtpjpegdepay took "
          f"{len(took)} media packets; {len(images)} images handed on, "
          f"{whole} of {n} frames whole; frames up to there that lost their "
          f"first packet for good: {first_lost}")
    if fault is not None:
        print(f"  rtp_fec_udp: reference fault (ROADMAP.md section 3): "
              f"rtpjpegdepay handed on a frame that lost packets for good and "
              f"jpegdec raised {fault['error']!r} on it, ending the "
              f"pipeline; the {checked} whole frames before it == their "
              f"frames of multifilesrc ! jpegdec (== the TCP run's)")
        return
    rr_report("rtp_fec_udp", r)
    print(f"  rtp_fec_udp: every whole frame ({checked}) == its frame of "
          f"multifilesrc ! jpegdec (== the TCP run's); yscale_hv "
          f"{r['launches'].get('yscale_hv', 0)} in the {r['fed_ticks']} "
          f"ticks that gave frames")


def rtp_gst_raw(seed, dev, start, finish, peak):
    """RF_GST seeded 1080p I420 frames as card tensors through rtpgstpay
    mtu=1400 ! rtpgstdepay (the caps named after it) to RGB 224x224 in one
    tick (yscale_hv once): the same bytes as the direct conversion.
    Prints packets/s each way."""
    import torch
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.net import rtp_payloaders2 as p2
    w, h = RR_CAM[:2]
    n = RF_GST
    planes = vt_panning(n, w, h, seed)
    caps = f"video/x-raw,format=I420,width={w},height={h},framerate=" \
        f"{CONT_FPS}/1"

    def pushes():
        return {"in": [Buffer(**dict(b, data=tuple(
            torch.from_numpy(p).to(dev) for p in b["data"])))
            for b in vt_pushes(planes, n)]}
    _, direct, rd = codec_path(
        "rtp_gst_raw[direct]", f"appsrc name=in caps={caps} ! {CONT_RGB}",
        n, dev, start, finish, peak, {"yscale_hv": 1}, (), pushes())
    stats = {}
    out, r = rr_drive(
        "rtp_gst_raw", f"appsrc name=in caps={caps} ! rtpgstpay mtu={RR_MTU} "
        f"! rtpgstdepay ! {caps} ! {CONT_RGB}", dev, start, finish, peak,
        (cont_timed(p2.RtpGstPay, "host_process", stats, "rtpgstpay",
                    rr_packets_out),
         cont_timed(p2.RtpGstDepay, "host_process", stats, "rtpgstdepay",
                    rr_packets_in)), batch=n, pushes=pushes())
    rgb, want = cont_joined(out), cont_joined(direct["v"])
    require(rgb is not None and rgb[0].shape[0] == n and cont_equal(rgb, want),
            "rtp_gst_raw: RGB other than the direct conversion's")
    rr_report("rtp_gst_raw", r)
    print(f"  rtp_gst_raw: {n} frames of {w}x{h} I420, "
          f"{stats['rtpgstpay packets'] / n:.1f} packets a frame; the RGB "
          f"== the direct conversion's ({rd['secs'] * 1e3:.3f} ms for the "
          f"tick alone); yscale_hv {r['launches'].get('yscale_hv', 0)} in "
          f"{r['fed_ticks']} tick; {rr_rates(stats)}")


def aac_mp3_ts(dev, path, files):
    """mpegtsmux of the committed AAC and MP3 into `path` on `dev`;
    returns its host seconds."""
    return vt_timed(
        f"mpegtsmux name=m location={path} ! fakesink filesrc location="
        f"{files['aac_10s.aac']} ! aacparse ! m.sink_0 filesrc location="
        f"{files['mp3_10s.mp3']} ! mpegaudioparse ! m.sink_1", dev, 8)[1]


def rtp_mp2t_line(seed, dev, tmp, start, finish, peak, files, plain_aac):
    """mpegtsmux's TS of the committed AAC and MP3 (ts_audio_ingest's file)
    through filesrc (whole TS packets a buffer) ! rtpmp2tpay !
    rtpst2022_1_fecenc, seeded drops (one packet in each of RF_TS_DROPS
    rows), then appsrc ! rtpst2022_1_fecdec ! rtpmp2tdepay ! filesink on
    the card: the TS bytes equal those sent.  Then ts_audio_ingest's item
    on the received file: tsdemux ! aacparse ! faad into the ASR chain,
    the PCM the plain file's, the ASR output the port's CPU run's."""
    import numpy as np
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.codecs import aac as paac
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.elements import aacdec, mpegts
    out = os.path.join(tmp, "rtp_mp2t_line")
    os.makedirs(out)
    sent_path = os.path.join(out, "a.ts")
    start("rtp_mp2t_line")
    mux_s = aac_mp3_ts(dev, sent_path, files)
    with open(sent_path, "rb") as f:
        sent_ts = f.read()
    bufs = [[rr_pkt_bytes(x) for x in s.buffer.data] for s in codec_run(
        f"filesrc location={sent_path} blocksize={RF_TS_BLOCK} ! "
        f"video/mpegts,systemstream=true ! rtpmp2tpay ! rtpst2022_1_fecenc "
        f"rows={RF_ROWS} ! appsink name=p", dev, 1, "p")]
    rows = [r for b in bufs for r in rf_rows("st2022_1", b, 100)]
    rng = np.random.default_rng(seed)
    drops = {int(rng.choice(rows[k])) for k in
             rng.choice(len(rows), RF_TS_DROPS, replace=False)}
    got_path = os.path.join(out, "received.ts")
    pipe = parse_launch(
        "appsrc name=in caps=application/x-rtp,media=video,encoding-name="
        "MP2T,clock-rate=90000,payload=33 ! rtpst2022_1_fecdec name=dec ! "
        f"rtpmp2tdepay ! filesink location={got_path}", device=dev)
    push_all(pipe, {"in": [Buffer(data=[p for p in b if (p[1] & 0x7F) == 100
                                        or rf_seq(p) not in drops], pts=k)
                           for k, b in enumerate(bufs)]})
    t0 = time.perf_counter()
    pipe.run()
    secs = time.perf_counter() - t0
    recovered = pipe.get_by_name("dec").recovered
    pipe.set_state("null")
    finish("rtp_mp2t_line", {})
    with open(got_path, "rb") as f:
        require(f.read() == sent_ts, "rtp_mp2t_line: the received TS differs "
                "from the TS sent")
    media = sum(1 for b in bufs for p in b if (p[1] & 0x7F) != 100)
    print(f"e2e rtp_mp2t_line: mpegtsmux wrote {len(sent_ts)} bytes of TS "
          f"in {mux_s:.3f} s, {media} RTP packets (+"
          f"{sum(map(len, bufs)) - media} FEC); dropped {len(drops)} (one in "
          f"each of {len(drops)} of the {len(rows)} rows), "
          f"rtpst2022_1_fecdec recovered {recovered}; the received TS == the "
          f"TS sent, {media / secs:.1f} packets/s through fecdec ! "
          f"rtpmp2tdepay ! filesink; no launch")
    vt_asr_item("rtp_mp2t_line[tsdemux]", f"tsdemux name=d location="
                f"{got_path} stream=0 ! aacparse ! faad", dev, start, finish,
                peak, [(paac.AACDecoder, "decode_frame")], plain_aac, aacdec,
                held=" (the received TS)", demux=(mpegts.TsDemux, "create"))


def rtp_coded_audio(dev, files, dig, start, finish, peak, plain_aac):
    """MP3 through rtpmpapay ! rtpmpadepay ! mpegaudioparse !
    mpg123audiodec and AAC access units through rtpmp4gpay ! rtpmp4gdepay
    ! faad on the card: the PCM equals the plain files' decode (the JAX
    digests).  The Vorbis and Theora packets of the committed Ogg files
    through rtpvorbispay / rtptheorapay and back: the packets Ogg carries,
    byte for byte."""
    import numpy as np
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.elements.ogg import parse_ogg_pages
    from gstreamer_tpu_torch.net import rtp_payloaders2 as p2
    mp3, aac = files["mp3_10s.mp3"], files["aac_10s.aac"]
    stats = {}
    start("rtp_coded_audio")
    with cont_timed(p2.RtpMpaPay, "host_process", stats, "rtpmpapay",
                    rr_packets_out), \
            cont_timed(p2.RtpMpaDepay, "host_process", stats, "rtpmpadepay",
                       rr_packets_in):
        pcm = np.concatenate(vt_pcm(
            f"filesrc location={mp3} ! mpegaudioparse ! rtpmpapay ! "
            "rtpmpadepay ! mpegaudioparse ! mpg123audiodec", dev))
    err = codec_pcm_check("rtp_coded_audio[mp3]", pcm, dig["mp3"])
    require(np.array_equal(pcm, np.concatenate(vt_pcm(
        f"filesrc location={mp3} ! mpegaudioparse ! mpg123audiodec", dev))),
        "rtp_coded_audio[mp3]: PCM other than the plain file's")
    print(f"  rtp_coded_audio[mp3]: {len(pcm) / 48000:.2f} s == the plain "
          f"file's PCM (within {CODEC_PCM_TOL} of the JAX digest, max {err})"
          f"; {rr_rates(stats)}")
    # RFC 3640 carries raw access units: aacparse's ADTS frames without
    # their headers, the AudioSpecificConfig (SDP's config=) in the meta
    frames = [x for s in codec_run(f"filesrc location={aac} ! aacparse ! "
                                   "appsink name=a", dev)
              for x in (s.buffer.data if isinstance(s.buffer.data, list)
                        else [s.buffer.data])]
    frames = [rr_pkt_bytes(x) for x in frames]
    b = frames[0]
    sfi, ch = (b[2] >> 2) & 0xF, ((b[2] & 1) << 2) | (b[3] >> 6)
    asc = bytes([(((b[2] >> 6) + 1) << 3) | (sfi >> 1),
                 ((sfi & 1) << 7) | (ch << 3)])
    units = [Buffer(data=np.frombuffer(f[7 if f[1] & 1 else 9:], np.uint8),
                    pts=k * 21_333_333, duration=21_333_333,
                    meta={"codec_data": asc}) for k, f in enumerate(frames)]
    with cont_timed(p2.RtpMp4gPay, "host_process", stats, "rtpmp4gpay",
                    rr_packets_out):
        pcm = np.concatenate([s.buffer.data.cpu().numpy() for s in codec_run(
            "appsrc name=in caps=\"audio/mpeg, mpegversion=4, stream-format="
            "raw\" ! rtpmp4gpay ! rtpmp4gdepay ! faad ! appsink name=a", dev,
            pushes={"in": units})])
    err = codec_pcm_check("rtp_coded_audio[aac]", pcm, dig["aac_adts"])
    require(np.array_equal(pcm, plain_aac),
            "rtp_coded_audio[aac]: PCM other than the plain file's")
    print(f"  rtp_coded_audio[aac]: {len(frames)} access units, "
          f"{len(pcm) / 48000:.2f} s == the plain file's PCM (within "
          f"{CODEC_PCM_TOL} of the JAX digest, max {err}); rtpmp4gdepay ! "
          f"aacparse does not apply: aacparse frames ADTS only (both "
          f"packages), RFC 3640 carries raw units")
    for fname, kind, caps in (("vorbis_10s.ogg", "vorbis", "audio/x-vorbis"),
                              ("theora_1080p.ogv", "theora",
                               "video/x-theora")):
        with open(files[fname], "rb") as f:
            pk = [p for _s, _g, ps in parse_ogg_pages(f.read()) for p in ps]
        got = codec_run(
            f"appsrc name=in caps={caps} ! rtp{kind}pay ! rtp{kind}depay ! "
            "appsink name=a", dev, pushes={"in": [Buffer(
                data=np.frombuffer(p, np.uint8), pts=k * 20_000_000)
                for k, p in enumerate(pk)]})
        back = [rr_pkt_bytes(x) for s in got for x in (
            s.buffer.data if isinstance(s.buffer.data, list)
            else [s.buffer.data])]
        require(back == pk, f"rtp_coded_audio[{kind}]: {len(back)} packets "
                f"back of {len(pk)}, or other bytes")
        try:
            parse_launch(f"appsrc ! rtp{kind}depay ! {kind}dec ! fakesink",
                         device=dev)
            linked = "links"
        except ValueError as e:
            linked = f"does not link ({e}): {kind}dec reads a file in both " \
                "packages"
        print(f"  rtp_coded_audio[{kind}]: the {len(pk)} packets of {fname} "
              f"== Ogg's after rtp{kind}pay ! rtp{kind}depay; rtp{kind}depay "
              f"! {kind}dec {linked}")
    finish("rtp_coded_audio", {})


def siren_rtp(seed, dev, start, finish, peak):
    """RF_SIREN s of seeded 16 kHz mono through sirenenc ! rtpsirenpay !
    rtpsirendepay ! sirendec on the card and on the CPU: the PCM (on the
    card, one copy a tick) equals the CPU run's.  Prints encode and decode
    host seconds a second of audio."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch.codecs import siren
    from gstreamer_tpu_torch.core.buffer import Buffer
    rng = np.random.default_rng(seed)
    t = np.arange(16000 * RF_SIREN) / 16000.0
    x = (5000 * np.sin(2 * np.pi * 210 * t) * (0.6 + 0.4 * np.sin(
        2 * np.pi * 3 * t)) + 2500 * np.sin(2 * np.pi * 1300 * t)
        + rng.normal(0, 600, t.shape))
    x = np.clip(np.round(x), -32768, 32767).astype(np.int16).reshape(-1, 1)
    got = {}
    for d in (dev, torch.device("cpu")):
        spent = {}
        base = start("siren_rtp")
        with cont_timed(siren.SirenEncoder, "encode_frame", spent, "enc"), \
                cont_timed(siren.SirenDecoder, "decode_frame", spent, "dec"):
            out = codec_run(
                "appsrc name=in caps=audio/x-raw,format=S16LE,rate=16000,"
                "channels=1,layout=interleaved ! sirenenc ! rtpsirenpay ! "
                "rtpsirendepay ! sirendec ! appsink name=a", d,
                pushes={"in": [Buffer(data=torch.from_numpy(
                    x[k:k + 1600]).to(d), pts=k * 62_500,
                    duration=100_000_000) for k in range(0, len(x), 1600)]})
        finish("siren_rtp", {})
        require(all(s.buffer.data.device.type == d.type for s in out),
                f"siren_rtp: sirendec's PCM not on {d}")
        got[d.type] = (cont_joined(out), spent, peak(base))
    card, spent, mem = got[dev.type]
    require(card is not None and card.shape == (len(x), 1)
            and torch.equal(card.cpu(), got["cpu"][0]),
            "siren_rtp: the card's PCM differs from the port's CPU run")
    print(f"e2e siren_rtp: {RF_SIREN} s of 16 kHz mono; encode "
          f"{spent['enc'] / RF_SIREN:.4f} s and decode "
          f"{spent['dec'] / RF_SIREN:.4f} s a second of audio (host numpy); "
          f"the PCM on the card == the port's CPU run; peak memory "
          f"{mem:.1f} MiB; no launch")


def rf_alone_rows():
    """The runs that drive each of RF_MODULES' factories alone or with its
    pair: [(factories, fn(d) -> plain data)]."""
    import numpy as np
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.element import element_factory_make
    from gstreamer_tpu_torch.net.rtp import rtp_header
    rng = np.random.default_rng(24)
    blobs = [rng.integers(0, 256, int(rng.integers(50, 3000)),
                          dtype=np.uint8) for _ in range(5)]
    pkts = [rtp_header(96, (65530 + k) & 0xFFFF, 3000 * k, 0x11,
                       marker=k % 4 == 3)
            + rng.integers(0, 256, 200, dtype=np.uint8).tobytes()
            for k in range(12)]
    h265 = [np.frombuffer(a, np.uint8) for a in annexb_aus(True, 4, rng)]
    ts = [np.concatenate([np.full((k, 1), 0x47, np.uint8), rng.integers(
        0, 256, (k, 187), dtype=np.uint8)], 1).reshape(-1) for k in (1, 9)]
    t = np.arange(6400) / 16000.0
    pcm = (8000 * np.sin(2 * np.pi * 300 * t)).astype(np.int16)

    def frames_in(data):
        return {"in": [dict(data=b, pts=k * 40_000_000, duration=40_000_000)
                       for k, b in enumerate(data)]}

    def launch(desc, pushes=None):
        return lambda d: cont_launch(desc, d, 1, pushes)

    def coded(pay, depay, caps, data=blobs, mtu=300):
        return launch(f"appsrc name=in caps=\"{caps}\" ! {pay} mtu={mtu} ! "
                      f"tee name=t t. ! queue ! appsink name=out t. ! queue ! "
                      f"{depay} ! appsink name=out1", frames_in(data))

    def rtp(desc, data=pkts):
        return launch(f"appsrc name=in caps=application/x-rtp ! {desc} ! "
                      "appsink name=out", {"in": [dict(data=list(data),
                                                       pts=0)]})
    def direct(factory):
        """The element called directly: its src caps stay ANY until a
        payload description names them, which no launch string fixates
        (in either package)."""
        def run(d):
            e = element_factory_make(factory)
            e.device = d
            e.start()
            return [None if o is None else bc_plain(o.data) for o in (
                e.host_process(Buffer(data=list(pkts), pts=0)),
                e.host_process(None))]
        return run
    lossy = pkts[:5] + pkts[6:]
    rows = [((f"rtp{b}pay", f"rtp{b}depay"), coded(f"rtp{b}pay",
                                                   f"rtp{b}depay", c))
            for c, b in (
                ("audio/G722, rate=8000, channels=1", "g722"),
                ("audio/G723, rate=8000, channels=1", "g723"),
                ("audio/x-adpcm, layout=g726", "g726"),
                ("audio/G729, rate=8000, channels=1", "g729"),
                ("audio/x-gsm, rate=8000, channels=1", "gsm"),
                ("audio/x-iLBC", "ilbc"), ("audio/x-speex", "speex"),
                ("audio/x-bv", "bv"),
                ("audio/qcelp, rate=8000, channels=1", "qcelp"),
                ("meta/x-klv", "klv"), ("video/x-dv", "dv"),
                ("video/mpeg, mpegversion=4, systemstream=false", "mp4v"),
                ("audio/mpeg, mpegversion=4, stream-format=loas", "mp4a"),
                ("video/x-h263, variant=itu", "h263p"),
                ("video/x-h263, variant=itu, h263version=h263", "h263"),
                ("video/x-h261", "h261"), ("audio/mpeg, mpegversion=1", "mpa"),
                ("video/mpeg, systemstream=false", "mpv"),
                ("audio/mpeg, mpegversion=4, stream-format=raw", "mp4g"),
                ("audio/x-ac3", "ac3"), ("audio/AMR", "amr"),
                ("audio/x-sbc", "sbc"), ("image/x-jpc", "j2k"),
                ("audio/x-vorbis", "vorbis"), ("video/x-theora", "theora"),
                ("application/x-custom", "gst"),
                ("video/x-ms-asf, parsed=true", "asf"))]
    rows += [
        (("rtph265pay", "rtph265depay"), coded(
            "rtph265pay", "rtph265depay", "video/x-h265, stream-format="
            "byte-stream, alignment=au", h265, 40)),
        (("rtpmp2tpay", "rtpmp2tdepay"), coded(
            "rtpmp2tpay", "rtpmp2tdepay", "video/mpegts, systemstream=true",
            ts)),
        (("rtpmp1sdepay",), rtp("rtpmp1sdepay")),
        (("rtpmparobustdepay",), rtp("rtpmparobustdepay")),
        (("rtpxqtdepay",), direct("rtpxqtdepay")),
        (("rtpsv3vdepay",), rtp("rtpsv3vdepay")),
        (("rtpstreampay", "rtpstreamdepay"),
         rtp("rtpstreampay ! rtpstreamdepay")),
        (("rtppassthroughpay",), rtp("rtppassthroughpay pt=111")),
        (("rtpredenc", "rtpreddec"), rtp("rtpredenc ! rtpreddec")),
        (("rtpulpfecenc", "rtpstorage", "rtpulpfecdec"),
         rtp("rtpulpfecenc group-size=4 ! rtpstorage ! rtpulpfecdec",
             lossy)),
        (("rtpst2022_1_fecenc", "rtpst2022_1_fecdec"),
         rtp("rtpst2022_1_fecenc rows=4 ! rtpst2022_1_fecdec", lossy)),
        (("sirenenc", "rtpsirenpay", "rtpsirendepay", "sirendec"), launch(
            "appsrc name=in caps=audio/x-raw,format=S16LE,rate=16000,"
            "channels=1,layout=interleaved ! sirenenc ! rtpsirenpay mtu=132 "
            "! rtpsirendepay ! sirendec ! appsink name=out",
            {"in": [dict(data=pcm[k:k + 1600].reshape(-1, 1),
                         pts=k * 62_500) for k in range(0, len(pcm), 1600)]}))]
    covered = {f for names, _fn in rows for f in names}
    mine = rr_factories(RF_MODULES)
    require(covered == mine and len(mine) == 76,
            f"rtp fec alone: the rows cover {len(covered)} factories, the "
            f"slice's modules register {len(mine)}; not driven: "
            f"{sorted(mine - covered)}")
    return rows


def rtp_fec_phase(seed, counters, dev):
    """The rest of RTP on the card, each item with the launch counts zeroed
    just before and read just after: rtp_fec_camera (the camera's 32 JPEGs
    under SMPTE 2022-1, ULPFEC and RED, drop patterns (a) and (b);
    yscale_hv once a tick that gives frames), rtp_fec_udp (where the
    loopback probe finds UDP), rtp_gst_raw (yscale_hv once), rtp_mp2t_line,
    rtp_coded_audio, siren_rtp, then each of the 76 factories alone.
    Returns {kernel: launches}."""
    import tempfile

    import numpy as np
    start, finish, peak, total = phase_meters(counters, dev)
    t0 = time.perf_counter()
    probe = rr_probe()
    print(f"rtp fec phase: loopback probe on 127.0.0.1: {probe}; "
          + ("rtp_fec_udp runs" if probe["udp"] else "rtp_fec_udp is not "
             "run; the others run"))
    files, dig = codec_vectors(("mp3_10s.mp3", "aac_10s.aac",
                                "vorbis_10s.ogg", "theora_1080p.ogv",
                                "digests.json"))
    spent = {}

    def item(name, fn, *a):
        t1 = time.perf_counter()
        out = fn(*a)
        spent[name] = time.perf_counter() - t1
        return out
    with tempfile.TemporaryDirectory() as tmp:
        jdir, _jpgs = item("jpegs", rr_jpegs, seed, dev, tmp)
        start("multifilesrc ! jpegdec")
        ref = item("reference", rr_rgb_ref, jdir, dev)
        finish("multifilesrc ! jpegdec",
               {"yscale_hv": -(-RR_CAM[2] // RR_CAM[3])})
        start("rtpjpegpay")
        sent = rr_frames(rr_pay(dev, jdir, {}))
        finish("rtpjpegpay", {})
        item("rtp_fec_camera", rtp_fec_camera, dev, jdir, ref, sent, start,
             finish, peak)
        if probe["udp"]:
            item("rtp_fec_udp", rtp_fec_udp, dev, jdir, ref, sent, start,
                 finish, peak)
        item("rtp_gst_raw", rtp_gst_raw, seed, dev, start, finish, peak)
        start("faad")
        plain_aac = np.concatenate(vt_pcm(f"filesrc location="
                                          f"{files['aac_10s.aac']} ! aacparse "
                                          "! faad", dev))
        finish("faad", {})
        codec_pcm_check("faad", plain_aac, dig["aac_adts"])
        item("rtp_mp2t_line", rtp_mp2t_line, seed, dev, tmp, start, finish,
             peak, files, plain_aac)
        item("rtp_coded_audio", rtp_coded_audio, dev, files, dig, start,
             finish, peak, plain_aac)
        item("siren_rtp", siren_rtp, seed, dev, start, finish, peak)
    rows = rf_alone_rows()
    item("alone", alone_runs, [
        ("/".join(names), lambda d, _tmp, _seed, fn=fn: fn(d))
        for names, fn in rows], counters, dev, 0)
    print(f"  rtp fec alone: the 76 factories in {len(rows)} runs on the "
          f"card == the port's CPU run, no launch")
    print(f"rtp fec phase: {time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in spent.items()) + ")")
    return total



NT_MODULES = tuple(f"gstreamer_tpu_torch.{m}" for m in (
    "net.srtp", "net.dtls_elements", "net.sctp", "net.webrtc", "net.rist",
    "net.srt", "net.rtmp", "net.adaptive", "net.fanout", "net.rfb",
    "net.avtp", "net.websinks", "elements.ipc_misc"))
NT_DROPS = 16                       # rist_camera's first copies the relay drops
NT_FIRST = 4                        # of them, frames' first packets at least
NT_WEBRTC = 16                      # webrtc_camera's 1080p frames
NT_WEBRTC_MTU = 1200
NT_AVTP = 16                        # avtp_raw_video's 1080p I420 frames
NT_AAF_SECONDS = 1                  # avtp AAF's 48 kHz stereo S16BE
NT_SRT_BLOCK = 1316 * 8             # srtsink's bytes a tick of the TS
NT_FACTORIES = 55


def nt_probe():
    """What this machine allows the slice: libssl / libcrypto (ctypes),
    libsrt (net/srt.py's loader), a frame through AF_PACKET sockets on lo,
    and rr_probe's UDP and TCP on loopback.  Nothing raises."""
    import ctypes
    import socket
    from gstreamer_tpu_torch.net import dtls, srt
    got = dict(rr_probe())
    for lib in ("libssl.so.3", "libcrypto.so.3"):
        try:
            ctypes.CDLL(lib)
            got[lib] = True
        except OSError as e:
            got[lib] = False
            got[lib + "_error"] = repr(e)
    got["dtls"] = dtls.available()
    got["libsrt"] = srt.available()
    try:
        # one frame of the AVTP ethertype from a socket to another on lo
        rx = socket.socket(socket.AF_PACKET, socket.SOCK_RAW,
                           socket.htons(0x22F0))
        tx = socket.socket(socket.AF_PACKET, socket.SOCK_RAW,
                           socket.htons(0x22F0))
        try:
            rx.bind(("lo", 0x22F0))
            rx.settimeout(1.0)
            tx.bind(("lo", 0x22F0))
            tag = b"nt_probe" + os.urandom(8)
            tx.send(bytes(6) + tx.getsockname()[4] + b"\x22\xf0" + tag)
            end = time.perf_counter() + 1.0
            got["af_packet"] = False
            while time.perf_counter() < end and not got["af_packet"]:
                got["af_packet"] = tag in rx.recv(256)
        finally:
            rx.close()
            tx.close()
    except (OSError, AttributeError) as e:
        got["af_packet"] = False
        got["af_packet_error"] = repr(e)
    return got


def nt_pair():
    """Two UDP sockets on adjacent ports (p, p + 1) of 127.0.0.1, as RIST
    wants its RTCP beside its media (retried while a pair is taken)."""
    import socket
    for _ in range(64):
        a = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        a.bind(("127.0.0.1", 0))
        b = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            b.bind(("127.0.0.1", a.getsockname()[1] + 1))
            return a, b
        except OSError:
            a.close()
            b.close()
    raise RuntimeError("no adjacent UDP port pair free on 127.0.0.1")


def nt_free_pair():
    a, b = nt_pair()
    port = a.getsockname()[1]
    a.close()
    b.close()
    return port


NT_RELAY_RCVBUF = 4 << 20           # the relay's socket buffers (bytes asked)


class NtRelay:
    """A UDP relay on 127.0.0.1 between ristsink and ristsrc: media (a
    port) and RTCP (the port + 1) both ways; it drops the FIRST copy of
    each media sequence number in `drops` (a retransmission passes) and
    keeps the sequence numbers it received (`seen`).  Its sockets ask for
    NT_RELAY_RCVBUF bytes of buffer (the system caps it): a frame's burst
    of ~105 packets overflows the default one while the relay waits for
    the CPU."""

    def __init__(self, dst_port, drops):
        import socket
        import threading
        self.dst = ("127.0.0.1", dst_port)
        self.drop, self.dropped, self.forwarded = set(drops), [], 0
        self.seen = set()
        self.media, self.rtcp = nt_pair()
        for s in (self.media, self.rtcp):
            s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                         NT_RELAY_RCVBUF)
        self.port = self.media.getsockname()[1]
        self._sender_rtcp, self._run = None, True
        self._threads = [threading.Thread(target=f, daemon=True)
                         for f in (self._media_loop, self._rtcp_loop)]
        for t in self._threads:
            t.start()

    def _media_loop(self):
        import socket
        self.media.settimeout(0.05)
        while self._run:
            try:
                data, _ = self.media.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                return
            seq = rf_seq(data) if len(data) >= 12 else None
            self.seen.add(seq)
            if seq in self.drop:
                self.drop.discard(seq)
                self.dropped.append(seq)
                continue
            self.forwarded += 1
            self.media.sendto(data, self.dst)

    def _rtcp_loop(self):
        import socket
        self.rtcp.settimeout(0.05)
        back = (self.dst[0], self.dst[1] + 1)
        while self._run:
            try:
                data, addr = self.rtcp.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                return
            if addr == back:
                if self._sender_rtcp:
                    self.rtcp.sendto(data, self._sender_rtcp)
            else:
                self._sender_rtcp = addr
                self.rtcp.sendto(data, back)

    def close(self):
        self._run = False
        for t in self._threads:
            t.join(2.0)
        self.media.close()
        self.rtcp.close()


def nt_drops(seed, sent):
    """NT_DROPS sequence numbers of the camera's packets, chosen with numpy
    default_rng(seed): the first packet of NT_FIRST frames, the others
    anywhere.  Never the stream's first packet nor its last: a receiver
    learns the stream from the first packet it sees and cannot ask for one
    before, and no packet after the last shows it missing."""
    import numpy as np
    rng = np.random.default_rng(seed)
    firsts = [rf_seq(f[0]) for f in sent]
    heads = {firsts[int(k)] for k in 1 + rng.choice(len(sent) - 1, NT_FIRST,
                                                    replace=False)}
    rest = [rf_seq(p) for f in sent for p in f if rf_seq(p) not in heads
            and rf_seq(p) not in (firsts[0], rf_seq(sent[-1][-1]))]
    return heads | {int(s) for s in rng.choice(rest, NT_DROPS - NT_FIRST,
                                               replace=False)}


@contextlib.contextmanager
def nt_first_call(cls, attr, event):
    """While the block runs, set `event` as cls.attr is first called,
    before the call: the receiver is reading (its pipeline set up and
    the profiler started), so a sender that waits for it loses nothing
    to a socket nobody drains."""
    fn = getattr(cls, attr)

    def first(*a, **k):
        event.set()
        return fn(*a, **k)
    setattr(cls, attr, first)
    try:
        yield event
    finally:
        setattr(cls, attr, fn)


def nt_relay_proc(jobs, out, stop):
    """NtRelay in a process of its own, so that it shares no interpreter
    with the sender's pipeline (in one process it forwarded a packet a
    switch interval while the pipeline ran, and lost whole bursts): for
    each (port, drops) job until None, an NtRelay to `port`, its media
    port into `out`; once `stop` is set, {"dropped": its drops, "seen":
    the sequence numbers it received} (or {"error": ...}) into `out`."""
    sys.setswitchinterval(0.001)
    for port, drops in iter(jobs.get, None):
        try:
            relay = NtRelay(port, drops)
        except Exception as e:           # handed to the receiver
            out.put({"error": repr(e)})
            continue
        out.put(relay.port)
        stop.wait()
        relay.close()
        out.put({"dropped": list(relay.dropped),
                 "seen": sorted(s for s in relay.seen if s is not None)})


def nt_sender_proc(jdir, jobs, go, done, out):
    """The RIST sender, in a process of its own (as on another host), for
    each port until None: multifilesrc ! rtpjpegpay mtu=1400 ! ristsink
    to 127.0.0.1:port on the CPU (host elements only), started, then
    "ready" into `out`; from `go` on a frame a tick at 25/1; it serves
    NACKs until `done`.  Then {"sink": ristsink's stats, "secs": sending
    seconds} (or {"error": ...}) into `out`."""
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.net import rist
    for port in iter(jobs.get, None):
        try:
            tx = parse_launch(
                f"multifilesrc location={jdir}/cam_%05d.jpg caps=image/jpeg,"
                f"framerate={CONT_FPS}/1 ! rtpjpegpay mtu={RR_MTU} ! ristsink "
                f"address=127.0.0.1 port={port}", device="cpu")
            tx.set_state("playing")
            sink = next(e for e in tx._nodes()
                        if isinstance(e, rist.RistSink))
            out.put("ready")
            require(go.wait(120.0), "the RIST receiver never read")
            t0 = time.perf_counter()
            k = 0
            while tx.tick():
                k += 1
                time.sleep(max(0.0, t0 + k / CONT_FPS - time.perf_counter()))
            secs = time.perf_counter() - t0
            done.wait(120.0)
            stats = dict(sink.stats)
            tx.set_state("null")
            out.put({"sink": stats, "secs": secs})
        except Exception as e:           # handed to the receiver
            out.put({"error": repr(e)})


class NtSender:
    """nt_sender_proc and nt_relay_proc in spawned processes, kept for the
    phase's RIST runs (each process's start, the sender's torch import,
    is paid once)."""

    def __init__(self, jdir):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.jobs, self.out = ctx.Queue(), ctx.Queue()
        self.go, self.done = ctx.Event(), ctx.Event()
        self.rjobs, self.rout, self.stop = ctx.Queue(), ctx.Queue(), \
            ctx.Event()
        self.relaying = False
        self.procs = [ctx.Process(target=nt_sender_proc, args=(
            jdir, self.jobs, self.go, self.done, self.out), daemon=True),
            ctx.Process(target=nt_relay_proc, args=(
                self.rjobs, self.rout, self.stop), daemon=True)]
        for p in self.procs:
            p.start()

    def start(self, port, drops):
        """Hand the sender a job (through a relay to `port` that drops
        `drops`, or, with None, straight to it); returns once it is ready
        to send."""
        self.go.clear()
        self.done.clear()
        self.stop.clear()
        self.relaying = drops is not None
        if self.relaying:
            self.rjobs.put((port, sorted(drops)))
            port = self.rout.get(timeout=120.0)
            require(isinstance(port, int), f"the RIST relay: {port}")
        self.jobs.put(port)
        msg = self.out.get(timeout=120.0)
        require(msg == "ready", f"the RIST sender: {msg}")

    def finish(self):
        """Let the sender stop serving NACKs, then the relay; their
        results: the sender's, with the relay's "dropped" and "seen"
        (None without a relay)."""
        self.go.set()
        self.done.set()
        got = self.out.get(timeout=60.0)
        relay = {"dropped": None, "seen": None}
        if self.relaying:
            self.stop.set()
            relay = self.rout.get(timeout=60.0)
        require("error" not in got, f"the RIST sender: {got.get('error')}")
        return {**got, **relay}

    def close(self):
        self.jobs.put(None)
        self.rjobs.put(None)
        for p in self.procs:
            p.join(30.0)
            if p.is_alive():
                p.terminate()
                p.join(5.0)


@contextlib.contextmanager
def nt_stalls(cls, attr, seen):
    """While the block runs, seen["stall"] is the longest time from one
    call of cls.attr returning to the next starting (the pipeline
    downstream of the source), seen["gc"] the interpreter's longest
    collection (generation, seconds) and seen["full"] how many full
    collections ran."""
    import gc
    fn = getattr(cls, attr)
    mark = {"end": None, "gc": None}
    seen.update(stall=0.0, gc=(None, 0.0), full=0)

    def call(*a, **k):
        if mark["end"] is not None:
            seen["stall"] = max(seen["stall"],
                                time.perf_counter() - mark["end"])
        try:
            return fn(*a, **k)
        finally:
            mark["end"] = time.perf_counter()

    def collected(phase, info):
        if phase == "start":
            mark["gc"] = time.perf_counter()
        elif mark["gc"] is not None:
            dt = time.perf_counter() - mark["gc"]
            if dt > seen["gc"][1]:
                seen["gc"] = (info["generation"], dt)
            seen["full"] += info["generation"] == 2
    setattr(cls, attr, call)
    gc.callbacks.append(collected)
    try:
        yield seen
    finally:
        gc.callbacks.remove(collected)
        setattr(cls, attr, fn)


@contextlib.contextmanager
def nt_frozen_heap(seen):
    """While the block runs, the objects of all the script's earlier work
    are frozen (gc.freeze, after a full collection): the interpreter's
    collections scan only what the block allocates.  A full collection of
    the whole heap holds the GIL for the better part of a second, through
    which no Python thread reads its socket (ristsrc's receive thread
    among them: ROADMAP.md section 3).  seen["frozen"] is (the objects
    frozen, the collection's seconds)."""
    import gc
    t0 = time.perf_counter()
    gc.collect()
    gc.freeze()
    seen["frozen"] = (gc.get_freeze_count(), time.perf_counter() - t0)
    try:
        yield seen
    finally:
        gc.unfreeze()


def nt_stall_line(name, seen):
    """The line nt_stalls' and nt_frozen_heap's figures print as."""
    gen, secs = seen["gc"]
    print(f"  {name}: {seen['frozen'][0]} objects of earlier work frozen "
          f"after a collection of {seen['frozen'][1] * 1e3:.1f} ms; the "
          f"pipeline's longest stall between two reads of ristsrc "
          f"{seen['stall'] * 1e3:.1f} ms; " + (
              "no collection of the interpreter" if gen is None else
              f"the interpreter's longest collection {secs * 1e3:.1f} ms "
              f"(generation {gen}), {seen['full']} full ones"))


@contextlib.contextmanager
def nt_switch_interval(secs):
    """sys.setswitchinterval(secs) while the block runs: a thread that
    waits on a socket takes the interpreter back sooner from a busy one."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(secs)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def nt_rist_run(name, dev, sender, ref, sent, start, finish, peak,
                nack_type, drops):
    """The camera over RIST: the sender's process (NtSender: through
    NtRelay with `drops`, none: straight), from the receiver's first read
    on; the receiver ristsrc ! rtpjpegdepay ! jpegdec ! RGB 224x224 on the
    card (rr_camera_run: yscale_hv once a tick that gives frames), the
    interpreter's switch interval 1 ms, the heap of earlier work frozen
    (nt_frozen_heap).  Returns (ristsink's and
    ristsrc's stats, the relay's drops and the sequence numbers it
    received (None, None without a relay), rr_camera_check's (whole,
    checked), rr_drive's numbers or None, the fault or None, the sender's
    seconds with nt_stalls' and nt_frozen_heap's figures)."""
    from gstreamer_tpu_torch.net import rist
    w, h, _n, _b = RR_CAM
    port = nt_free_pair()
    spent, elems, stalls = {}, {}, {}

    def seen(args, out):
        elems["src"] = args[0]
        return 0
    sender.start(port, drops)
    try:
        took, images, v, r, fault = rr_camera_run(
            name, f"ristsrc address=127.0.0.1 port={port} nack-type="
            f"{nack_type} timeout=1.0 caps={RR_RTP_JPEG} ! rtpjpegdepay ! "
            f"jpegdec ! {rr_caps(w, h)} ! {CONT_RGB}", dev, start, finish,
            peak, spent,
            (cont_timed(rist.RistSrc, "create", spent, "ristsrc", seen),
             nt_first_call(rist.RistSrc, "create", sender.go),
             nt_frozen_heap(stalls),
             nt_stalls(rist.RistSrc, "create", stalls),
             nt_switch_interval(0.001)))
    finally:
        got = sender.finish()
    whole, checked = rr_camera_check(name, sent, ref, images, v, fault)
    return (got["sink"], dict(elems["src"].stats),
            (got["dropped"], got["seen"]), (whole, checked), r, fault,
            {"sender": got["secs"], **stalls})


def rist_camera(seed, dev, sender, ref, sent, start, finish, peak):
    """rist_camera with generic and with range NACKs: the relay drops the
    first copy of NT_DROPS packets (the first packet of NT_FIRST frames
    among them); every drop is recovered, none lost, the 32 frames whole
    and each the reference's RGB (multifilesrc ! jpegdec on the card, ==
    the port's CPU run), yscale_hv once a tick that gives frames."""
    drops = nt_drops(seed, sent)
    heads = sum(1 for f in sent if rf_seq(f[0]) in drops)
    for nack in ("generic", "range"):
        name = f"rist_camera[{nack}]"
        snd, rcv, (dropped, seen), (whole, checked), r, fault, spent = \
            nt_rist_run(name, dev, sender, ref, sent, start, finish, peak,
                        nack, drops)
        nt_stall_line(name, spent)
        print(f"  {name}: ristsink sent {snd['sent']} packets, "
              f"retransmitted {snd['retransmitted']} on {snd['nacks']} NACK "
              f"packets; the relay received {len(seen)} of "
              f"{sum(map(len, sent))} sequence numbers and dropped "
              f"{len(dropped)} first copies "
              f"({heads} of them frames' first packets); ristsrc sent "
              f"{rcv['nacks_sent']} NACK packets, received {rcv['received']}, "
              f"recovered {rcv['recovered']}, lost {rcv['lost']}; "
              f"{whole} of {len(sent)} frames whole")
        require(fault is None and r is not None, f"{name}: jpegdec raised "
                f"{fault and fault['error']!r} on a frame that lost packets")
        require(sorted(dropped) == sorted(drops), f"{name}: the relay "
                f"dropped {sorted(dropped)}, chose {sorted(drops)}; it "
                f"received {len(seen)} of the {sum(map(len, sent))} sequence "
                f"numbers, never {sorted(set(drops) - set(seen))} of those "
                f"it chose (lost on loopback before it)")
        # the relay's drops, and any first copy loopback lost on top
        # (the receiver's socket overflowing while jpegdec runs): every
        # one recovered, none lost, every frame whole
        require(rcv["recovered"] >= len(drops) and rcv["lost"] == 0,
                f"{name}: recovered {rcv['recovered']} of {len(drops)} "
                f"dropped, lost {rcv['lost']}")
        if rcv["recovered"] > len(drops):
            print(f"  {name}: of the {rcv['recovered']} recovered, "
                  f"{rcv['recovered'] - len(drops)} were lost on loopback "
                  f"beside the relay's {len(drops)}")
        require(whole == checked == len(sent), f"{name}: {whole} frames "
                f"whole, {checked} checked, of {len(sent)}")
        rr_report(name, r)
        print(f"  {name}: every frame == its frame of multifilesrc ! jpegdec "
              f"(== the port's CPU run); yscale_hv "
              f"{r['launches'].get('yscale_hv', 0)} in the {r['fed_ticks']} "
              f"ticks that gave frames")


def rist_camera_live(dev, sender, ref, sent, start, finish, peak):
    """The camera over RIST with no relay, paced at 25/1 with jpegdec in
    the loop, as rtp_fec_udp over plain UDP: what loopback lost, what
    RIST recovered and lost, the frames whole, beside rtp_fec_udp's own
    figures from this run.  Every whole frame is its reference frame."""
    name = "rist_camera_live"
    snd, rcv, _d, (whole, checked), r, fault, spent = nt_rist_run(
        name, dev, sender, ref, sent, start, finish, peak, "generic", None)
    missing = rcv["recovered"] + rcv["lost"]
    nt_stall_line(name, spent)
    print(f"  {name}: ristsink sent {snd['sent']} packets in "
          f"{spent.get('sender', 0):.3f} s, retransmitted "
          f"{snd['retransmitted']} on {snd['nacks']} NACK packets; loopback "
          f"lost {missing} (first copies ristsrc found missing), RIST "
          f"recovered {rcv['recovered']} and lost {rcv['lost']}; "
          f"{whole} of {len(sent)} frames whole ({checked} checked)")
    if RF_UDP_FIGURES:
        f = RF_UDP_FIGURES
        print(f"  {name}: beside rtp_fec_udp in this run (plain UDP, SMPTE "
              f"2022-1 rows={RF_ROWS}): loopback lost {f['lost']} of "
              f"{f['read']}, fecdec recovered {f['recovered']}, "
              f"{f['whole']} of {len(sent)} frames whole")
    else:
        print(f"  {name}: rtp_fec_udp did not run in this process")
    if rcv["lost"] or whole < len(sent):
        why = []
        if snd["retransmitted"] < rcv["recovered"] + rcv["lost"]:
            why.append("the sender's history (sender-buffer 1200) had "
                       "evicted packets asked for")
        if rcv["lost"] and rcv["nacks_sent"]:
            why.append("packets still missing past reorder-section's budget "
                       "or receiver-buffer (1000) were skipped as lost")
        print(f"  {name}: frames lost: " + ("; ".join(why) or
              "ristsrc's stats name no cause"))
    if fault is not None:
        print(f"  {name}: reference fault (ROADMAP.md section 3): "
              f"rtpjpegdepay handed on a frame that lost packets for good and "
              f"jpegdec raised {fault['error']!r}; the {checked} whole frames "
              f"before it == their reference frames")
        return
    rr_report(name, r)


def nt_negotiate(a, b, **transceiver):
    """A video transceiver (`transceiver`: add_transceiver's pt, ...) on
    webrtcbin `a`; `a` offers, `b` answers, through SDP text."""
    from gstreamer_tpu_torch.net.sdp import SDPMessage
    from gstreamer_tpu_torch.net.webrtc import WebRTCSessionDescription
    a.add_transceiver("sendrecv", "video", **transceiver)
    offer = a.create_offer()
    a.set_local_description(offer)
    b.set_remote_description(WebRTCSessionDescription(
        "offer", SDPMessage.parse(offer.as_text())))
    answer = b.create_answer()
    b.set_local_description(answer)
    a.set_remote_description(WebRTCSessionDescription(
        "answer", SDPMessage.parse(answer.as_text())))


def webrtc_camera(dev, jdir, ref, start, finish, peak):
    """Two port webrtcbins on 127.0.0.1 (no STUN server, DTLS-SRTP on)
    offer and answer in-process; once both are connected the sender renders
    rtpjpegpay mtu=1200's packets of NT_WEBRTC 1080p frames, a frame a
    push, and the receiver's pull_received() feeds appsrc ! rtpjpegdepay !
    jpegdec ! RGB 224x224 on the card.  The wire is not plaintext, every
    whole frame is its reference frame, yscale_hv once a tick that gives
    frames."""
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.element import element_factory_make
    from gstreamer_tpu_torch.net import ice, srtp
    name = "webrtc_camera"
    w, h, _n, batch = RR_CAM
    frames = rf_pay(dev, jdir, NT_WEBRTC_MTU)[:NT_WEBRTC]
    a, b = element_factory_make("webrtcbin"), element_factory_make(
        "webrtcbin")
    wire, spent = [], {}
    send = ice.IceAgent.send

    def tap(self, data):
        wire.append(bytes(data))
        return send(self, data)
    try:
        t0 = time.perf_counter()
        nt_negotiate(a, b, pt=26, encoding_name="JPEG")
        t_ice = t_dtls = None
        while time.perf_counter() - t0 < 15.0:
            if t_ice is None and a.ice_connection_state == \
                    b.ice_connection_state == "connected":
                t_ice = time.perf_counter() - t0
            if a.connection_state == b.connection_state == "connected":
                t_dtls = time.perf_counter() - t0
                break
            if "failed" in (a.connection_state, b.connection_state):
                break
            time.sleep(0.001)
        require(t_dtls is not None, f"{name}: connection states "
                f"{a.connection_state}, {b.connection_state}")
        t_ice = t_dtls if t_ice is None else t_ice
        ice.IceAgent.send = tap
        got = []
        with cont_timed(srtp.SrtpSession, "protect", spent, "protect",
                        lambda a_, o: 1), \
                cont_timed(srtp.SrtpSession, "unprotect", spent,
                           "unprotect", lambda a_, o: 1):
            t1 = time.perf_counter()
            for k, pkts in enumerate(frames):
                a.render(Buffer(data=list(pkts), pts=k))
                mine = []
                end = time.perf_counter() + 5.0
                while len(mine) < len(pkts) and time.perf_counter() < end:
                    mine += b.pull_received(len(pkts) - len(mine))
                got.append(mine)
            secs = time.perf_counter() - t1
    finally:
        ice.IceAgent.send = send
        a.stop()
        b.stop()
    n_sent = sum(map(len, frames))
    n_got = sum(map(len, got))
    plain = [bytes(p[20:84]) for f in frames for p in f if len(p) > 84]
    require(len(wire) >= n_sent and not any(
        x in d for d in wire for x in plain[::7]), f"{name}: a datagram on "
        f"the wire holds a sent packet's JPEG payload (not encrypted)")
    print(f"  {name}: ICE connected in {t_ice * 1e3:.1f} ms, DTLS-SRTP in "
          f"{t_dtls * 1e3:.1f} ms (both sides); the sender rendered "
          f"{n_sent} packets ({a.stats['sent']} sent, "
          f"{a.stats['dropped_unconnected']} dropped before the connection), "
          f"the receiver pulled {n_got} ({b.stats['auth_failed']} dropped "
          f"for failed authentication, {b.stats['dtls_strays']} stray DTLS "
          f"records); {len(wire)} datagrams on the wire, none holds a sent "
          f"JPEG payload; {n_got / secs:.1f} packets/s from render to pull "
          f"(host), {n_got / (spent['protect'] + spent['unprotect']):.1f} "
          f"packets/s through SRTP's protect and unprotect alone; protect "
          f"{spent['protect'] / max(spent['protect packets'], 1) * 1e6:.1f} "
          f"us and unprotect "
          f"{spent['unprotect'] / max(spent['unprotect packets'], 1) * 1e6:.1f}"
          f" us a packet (host)")
    pushes = {"in": [Buffer(data=g, pts=k * 40_000_000) for k, g in
                     enumerate(got) if g]}
    out, r = {"v": [], "a": []}, None
    _v, r = rr_drive(name, f"appsrc name=in caps={RR_RTP_JPEG} ! "
                     f"rtpjpegdepay ! jpegdec ! {rr_caps(w, h)} ! {CONT_RGB}",
                     dev, start, finish, peak, pushes=pushes, out=out)
    whole = [k for k, g in enumerate(got) if g == list(frames[k])]
    rgb = cont_joined(out["v"])
    require(rgb is not None and rgb[0].shape[0] == len(whole) == NT_WEBRTC,
            f"{name}: {len(whole)} frames whole of {NT_WEBRTC}, "
            f"{0 if rgb is None else rgb[0].shape[0]} decoded")
    require(cont_equal(rgb, tuple(p[:NT_WEBRTC] for p in ref)),
            f"{name}: a frame's RGB differs from its reference frame")
    rr_report(name, r)
    print(f"  {name}: {len(whole)} of {NT_WEBRTC} frames whole, each == its "
          f"frame of multifilesrc ! jpegdec; yscale_hv "
          f"{r['launches'].get('yscale_hv', 0)} in the {r['fed_ticks']} "
          f"ticks that gave frames")


def srt_ts_link(dev, tmp, files, plain_aac, start, finish, peak, have_srt):
    """The TS through filesrc ! srtsink mode=listener to srtsrc mode=caller
    ! filesink on 127.0.0.1, plain and with a passphrase: the bytes those
    sent; tsdemux ! aacparse ! faad of the received file into the ASR
    chain (the plain file's PCM).  Without libsrt: the error both packages
    raise, printed as a difference of installation."""
    import threading
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.codecs import aac as paac
    from gstreamer_tpu_torch.elements import aacdec, mpegts
    from gstreamer_tpu_torch.net import srt
    sent_path = os.path.join(tmp, "srt_sent.ts")
    aac_mp3_ts(dev, sent_path, files)
    with open(sent_path, "rb") as f:
        sent = f.read()
    if not have_srt:
        try:
            parse_launch(f"filesrc location={sent_path} ! srtsink "
                         "mode=listener port=7001", device=dev).set_state(
                             "playing")
        except RuntimeError as e:
            print(f"  srt_ts_link: NOT RUN, a difference of installation "
                  f"(ROADMAP.md section 3): {e!r}, the error both packages "
                  f"raise where net/srt.py's loader finds no libsrt")
            return
        raise AssertionError("srt_ts_link: srtsink started without libsrt")
    for pw in ("", "0123456789abcdef"):
        name = f"srt_ts_link[{'passphrase' if pw else 'plain'}]"
        extra = f" passphrase={pw}" if pw else ""
        got_path = os.path.join(tmp, f"srt_got{len(pw)}.ts")
        start(name)
        port = rr_free_port()
        tx = parse_launch(f"filesrc location={sent_path} blocksize="
                          f"{NT_SRT_BLOCK} ! srtsink mode=listener "
                          f"address=127.0.0.1 port={port}{extra}", device=dev)
        tx.set_state("playing")
        rx = parse_launch(f"srtsrc mode=caller address=127.0.0.1 port={port} "
                          f"timeout=2.0{extra} ! filesink location={got_path}",
                          device=dev)
        failed = []

        def receive():
            try:
                rx.run()
            except Exception as e:          # handed to the main thread
                failed.append(e)
        rx.set_state("playing")
        th = threading.Thread(target=receive, daemon=True)
        th.start()
        sink = next(e for e in tx._nodes() if isinstance(e, srt.SRTSink))
        end = time.perf_counter() + 10.0
        while not sink._peers and time.perf_counter() < end:
            time.sleep(0.01)
        require(sink._peers, f"{name}: no caller reached the listener")
        t0 = time.perf_counter()
        while tx.tick():
            time.sleep(0.001)
        tx.set_state("null")
        secs = time.perf_counter() - t0
        th.join(30.0)
        require(not th.is_alive() and not failed, f"{name}: the receiver "
                f"{'hangs' if th.is_alive() else failed}")
        rx.set_state("null")
        finish(name, {})
        with open(got_path, "rb") as f:
            got = f.read()
        require(got == sent, f"{name}: {len(got)} bytes received, the "
                f"{len(sent)} sent differ")
        print(f"e2e {name}: {len(sent)} bytes of TS over SRT in {secs:.3f} s "
              f"({len(sent) * 8 / secs / 1e6:.1f} Mbit/s, live mode, "
              f"{-(-len(sent) // srt.LIVE_PAYLOAD)} messages); the received "
              f"file == the TS sent; no launch")
    vt_asr_item("srt_ts_link[tsdemux]", f"tsdemux name=d location={got_path} "
                f"stream=0 ! aacparse ! faad", dev, start, finish, peak,
                [(paac.AACDecoder, "decode_frame")], plain_aac, aacdec,
                held=" (the TS received over SRT)",
                demux=(mpegts.TsDemux, "create"))


def rtmp_audio(dev, tmp, files, dig, start, finish, peak):
    """The committed AAC's units through flvmux (a file: flvmux is a
    writer), filesrc ! rtmp2sink publishing through the port's
    RtmpRelayServer to rtmp2src ! filesink (the player connected first):
    the tags received are those sent; flvdemux's PCM of the received file
    within CODEC_PCM_TOL of the JAX digest of the same units
    (aac_10s.m4a)."""
    import threading

    import numpy as np
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.net import rtmp
    name = "rtmp_audio"
    units = aac_units(files["aac_10s.aac"])
    sent_path, got_path = (os.path.join(tmp, f"rtmp_{k}.flv")
                           for k in ("sent", "got"))
    start(name)
    vt_timed(AAC_FLVMUX.format(path=sent_path), dev, 1,
             aac_flv_pushes(units))
    srv = rtmp.RtmpRelayServer()
    url = f"rtmp://127.0.0.1:{srv.port}/live/aac"
    failed = []
    try:
        rx = parse_launch(f"rtmp2src location={url} timeout=2.0 ! filesink "
                          f"location={got_path}", device=dev)
        rx.set_state("playing")           # the player connects first

        def receive():
            try:
                while rx.tick():
                    pass
            except Exception as e:        # handed to the main thread
                failed.append(e)
        th = threading.Thread(target=receive, daemon=True)
        th.start()
        t0 = time.perf_counter()
        tx = parse_launch(f"filesrc location={sent_path} ! rtmp2sink "
                          f"location={url}", device=dev)
        tx.run()
        sent_tags = next(e for e in tx._nodes()
                         if isinstance(e, rtmp.Rtmp2Sink)).sent_tags
        tx.set_state("null")
        th.join(30.0)
        secs = time.perf_counter() - t0
        rx.set_state("null")
    finally:
        srv.close()
    require(not th.is_alive() and not failed, f"{name}: the player "
            f"{'hangs' if th.is_alive() else failed}")
    finish(name, {})
    with open(sent_path, "rb") as f:
        want, _ = rtmp.parse_flv_stream(f.read())
    with open(got_path, "rb") as f:
        got, rest = rtmp.parse_flv_stream(f.read())
    require(got == want and not rest and sent_tags == len(want),
            f"{name}: {len(got)} tags received, {len(want)} in the file, "
            f"{sent_tags} published")
    print(f"e2e {name}: flvmux's {len(want)} tags published through "
          f"RtmpRelayServer and played back in {secs:.3f} s (the tags "
          f"received == the file's); no launch")
    start(f"{name}[flvdemux]")
    t0 = time.perf_counter()
    pcm = np.concatenate(vt_pcm(f"flvdemux location={got_path}", dev))
    secs = time.perf_counter() - t0
    finish(f"{name}[flvdemux]", {})
    err = codec_pcm_check(name, pcm, dig["aac_m4a"])
    print(f"  {name}: flvdemux of the received file decodes "
          f"{len(pcm) / 48000:.2f} s of PCM in {secs:.3f} s on the host, "
          f"within {CODEC_PCM_TOL} of the JAX digest of these units "
          f"(aac_10s.m4a's; max {err})")


def hls_dash_pull(dev, tmp, files, plain_aac, start, finish, peak):
    """hlssink2's segments and playlist and dashsink's MPD of the committed
    AAC, read back by hlsdemux stream=audio and dashdemux stream=0 over
    file:// URIs: the PCM the plain file's decode."""
    import numpy as np
    aac = files["aac_10s.aac"]
    d = os.path.join(tmp, "hls_dash")
    os.makedirs(d)
    start("hls_dash_pull[write]")
    vt_timed(f"filesrc location={aac} ! aacparse ! hlssink2 location={d}/"
             f"seg%05d.ts playlist-location={d}/p.m3u8 target-duration="
             f"{VT_HLS_TARGET}", dev, 8)
    vt_timed(f"filesrc location={aac} ! aacparse ! dashsink location={d}/"
             f"dash%05d.ts mpd-filename={d}/m.mpd target-duration="
             f"{VT_HLS_TARGET}", dev, 8)
    finish("hls_dash_pull[write]", {})
    for name, desc in (
            ("hls_dash_pull[hlsdemux]",
             f"hlsdemux uri=file://{d}/p.m3u8 stream=audio"),
            ("hls_dash_pull[dashdemux]",
             f"dashdemux uri=file://{d}/m.mpd stream=0")):
        start(name)
        t0 = time.perf_counter()
        pcm = np.concatenate(vt_pcm(desc, dev))
        secs = time.perf_counter() - t0
        finish(name, {})
        require(np.array_equal(pcm, plain_aac), f"{name}: the PCM "
                f"{pcm.shape} differs from the plain file's decode")
        print(f"  {name}: {len(pcm) / 48000:.2f} s of PCM == the plain "
              f"file's decode, pulled and decoded in {secs:.3f} s on the "
              f"host")


def shm_camera(dev, jdir, ref, tmp, start, finish, peak):
    """multifilesrc ! jpegparse ! shmsink of the camera's 32 JPEGs, then
    shmsrc ! jpegdec ! RGB 224x224 on the card: the reference RGB,
    yscale_hv once a tick that gives frames."""
    w, h, _n, _b = RR_CAM
    path = os.path.join(tmp, "shm_camera")
    start("shm_camera[write]")
    vt_timed(f"multifilesrc location={jdir}/cam_%05d.jpg caps=image/jpeg,"
             f"framerate={CONT_FPS}/1 ! jpegparse ! shmsink socket-path="
             f"{path}", dev, 1)
    finish("shm_camera[write]", {})
    v, r = rr_drive("shm_camera", f"shmsrc socket-path={path} ! image/jpeg,"
                    f"framerate={CONT_FPS}/1 ! jpegdec ! {rr_caps(w, h)} ! "
                    f"{CONT_RGB}", dev, start, finish, peak)
    require(cont_equal(cont_joined(v), ref), "shm_camera: the RGB differs "
            "from multifilesrc ! jpegdec's")
    rr_report("shm_camera", r)
    print(f"  shm_camera: the {RR_CAM[2]} frames == multifilesrc ! jpegdec's "
          f"(== the port's CPU run); yscale_hv "
          f"{r['launches'].get('yscale_hv', 0)} in the {r['fed_ticks']} ticks "
          f"that gave frames")


def avtp_raw_video(seed, dev, start, finish, peak, af_packet):
    """NT_AVTP seeded 1080p I420 frames through avtprvfpay ! avtprvfdepay.
    RVF carries GRAY formats only (the reference's avtprvfpay, GRAY16_LE),
    so each frame rides as a GRAY8 image of 1620 rows of 1920 (Y, then U
    and V two rows to a row); the depayloaded rows (on the card) are cut
    back into the I420 planes and go through appsrc ! videoconvertscale to
    RGB 224x224: the direct conversion's bytes, yscale_hv once a tick.
    Then AAF (S16BE) and CVF (H.264 access units) pay/depay alike, and
    avtpsink / avtpsrc on lo where the probe's frame came back through
    AF_PACKET (`af_packet`: True, or what the probe saw)."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.net import avtp
    w, h, n, rows = W, H, NT_AVTP, H * 3 // 2
    rng = np.random.default_rng(seed)
    planes = vt_panning(n, w, h, seed)
    gray = np.concatenate([planes[0], planes[1].reshape(n, h // 4, w),
                           planes[2].reshape(n, h // 4, w)], axis=1)
    name = "avtp_raw_video"
    spent = {}
    start(name + "[rvf]")
    t0 = time.perf_counter()
    with cont_timed(avtp.AvtpRvfPay, "host_process", spent, "rvfpay",
                    lambda a, o: 0 if o is None else len(o.data)):
        got = codec_run(f"appsrc name=in caps=video/x-raw,format=GRAY8,"
                        f"width={w},height={rows},framerate={CONT_FPS}/1 ! "
                        "avtprvfpay ! avtprvfdepay ! appsink name=p", dev, n,
                        "p", {"in": [Buffer(data=(torch.from_numpy(gray)
                                                  .to(dev),),
                                            batch=n, pts=0)]})
    secs = time.perf_counter() - t0
    finish(name + "[rvf]", {})
    back = torch.cat([s.buffer.data[0] for s in got])
    require(back.device.type == dev.type and back.shape == (n, rows, w)
            and torch.equal(back.cpu(), torch.from_numpy(gray)),
            f"{name}: the depayloaded rows differ from those sent")
    pdus = spent["rvfpay packets"]
    print(f"  {name}: avtprvfpay ! avtprvfdepay carried {n} {w}x{h} I420 "
          f"frames as GRAY8 {w}x{rows} in {pdus} PDUs in {secs:.3f} s "
          f"({pdus / secs:.0f} PDUs/s; pay {spent['rvfpay']:.3f} s, host); "
          f"the rows back == those sent, on the card")
    i420 = (back[:, :h], back[:, h:h + h // 4].reshape(n, h // 2, w // 2),
            back[:, h + h // 4:].reshape(n, h // 2, w // 2))
    src = (f"appsrc name=in caps=video/x-raw,format=I420,width={w},"
           f"height={h},framerate={CONT_FPS}/1")
    _, out, r = codec_path(name, f"{src} ! {CONT_RGB}", n, dev, start,
                           finish, peak, {"yscale_hv": 1}, (),
                           {"in": [Buffer(data=tuple(p.contiguous()
                                                     for p in i420),
                                          batch=n, pts=0)]})
    direct = cont_joined(codec_run(
        f"{src} ! {CONT_RGB}", torch.device("cpu"), n, "v",
        {"in": [Buffer(data=tuple(torch.from_numpy(p) for p in planes),
                       batch=n, pts=0)]}))
    require(cont_equal(cont_joined(out["v"]), direct),
            f"{name}: the RGB differs from the direct conversion's")
    codec_report(name, r, n, "frames")
    print(f"  {name}: RGB 224x224 == the direct conversion's (the port's "
          f"CPU run of the frames sent); yscale_hv {r['launches']}")
    pcm = rng.integers(-32768, 32768, (48000 * NT_AAF_SECONDS, 2),
                       dtype=np.int16)
    raw = np.frombuffer(pcm.astype(">i2").tobytes(), np.uint8)
    start(name + "[aaf]")
    got = codec_run("appsrc name=in caps=audio/x-raw,format=S16BE,rate=48000,"
                    "channels=2,layout=interleaved ! avtpaafpay ! "
                    "avtpaafdepay ! appsink name=p", dev, 1, "p",
                    {"in": [Buffer(data=raw[k:k + 3840].copy(), pts=k)
                            for k in range(0, len(raw), 3840)]})
    finish(name + "[aaf]", {})
    aaf = torch.cat([s.buffer.data.cpu() for s in got])
    require(torch.equal(aaf, torch.from_numpy(pcm)), f"{name}: AAF's "
            "samples back differ from those sent")
    aus = [b"".join(b"\x00\x00\x00\x01" + bytes([t]) + rng.integers(
        1, 256, size, np.uint8).tobytes() for t, size in (
            (0x67, 12), (0x68, 4), (0x65 if k % 8 == 0 else 0x41,
                                    int(rng.integers(500, 60000)))))
        for k in range(25)]
    start(name + "[cvf]")
    got = codec_run("appsrc name=in caps=video/x-h264,stream-format="
                    "byte-stream ! avtpcvfpay ! avtpcvfdepay ! appsink "
                    "name=p", dev, 1, "p",
                    {"in": [Buffer(data=np.frombuffer(a, np.uint8).copy(),
                                   pts=k * 40_000_000)
                            for k, a in enumerate(aus)]})
    finish(name + "[cvf]", {})
    back_aus = [rr_pkt_bytes(x) for s in got for x in s.buffer.data]
    require(back_aus == aus, f"{name}: CVF's access units back differ")
    print(f"  {name}: AAF {NT_AAF_SECONDS} s of 48 kHz stereo S16BE and CVF "
          f"{len(aus)} H.264 access units (FU-A at mtu 1400) back as sent")
    if af_packet is not True:
        print(f"  {name}: avtpsink / avtpsrc on lo NOT RUN, a difference of "
              f"installation (ROADMAP.md section 3): the probe's frame "
              f"through AF_PACKET on lo did not come back ({af_packet}); "
              f"avtpsink raises there in both packages")
        return
    print(f"  {name}: avtpsink -> avtpsrc on lo: "
          f"{nt_avtp_lo(dev, aus[:4])} PDUs back as sent")


def nt_avtp_lo(dev, aus):
    """CVF PDUs of `aus` through avtpsink on lo to avtpsrc: the PDUs of the
    stream back as sent.  Returns their count."""
    import threading

    import numpy as np
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.element import element_factory_make
    from gstreamer_tpu_torch.net import avtp
    pay = element_factory_make("avtpcvfpay", streamid=0xC0DE)
    pay.device = dev
    pdus = [p for k, a in enumerate(aus) for p in pay.host_process(
        Buffer(data=np.frombuffer(a, np.uint8), pts=k)).data]
    src = element_factory_make("avtpsrc", ifname="lo", timeout=2.0)
    sink = element_factory_make("avtpsink", ifname="lo")
    src.start()
    sink.start()
    got = []

    def rx():
        end = time.perf_counter() + 5.0
        while len(got) < len(pdus) and time.perf_counter() < end:
            b = src.create(1)
            for p in (b.data if b else []):
                if avtp.parse_pdu(bytes(p))["stream_id"] == 0xC0DE:
                    got.append(bytes(p)[:len(pdus[len(got)])])
    th = threading.Thread(target=rx, daemon=True)
    th.start()
    time.sleep(0.1)
    sink.render(Buffer(data=pdus))
    th.join(6.0)
    sink.stop()
    src.stop()
    require(got == pdus, f"avtp on lo: {len(got)} of {len(pdus)} PDUs back "
            "as sent")
    return len(pdus)


class NtServer:
    """A one-client TCP server on 127.0.0.1 (port 0) whose thread runs
    `serve(conn)`; what it returns is `result`."""

    def __init__(self, serve):
        import socket
        import threading
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.sock.settimeout(10.0)
        self.port = self.sock.getsockname()[1]
        self.result = None

        def run():
            try:
                c, _ = self.sock.accept()
                c.settimeout(10.0)
                self.result = serve(c)
                c.close()
            except OSError as e:
                self.result = repr(e)
        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def join(self):
        self._t.join(15.0)
        self.sock.close()
        return self.result


def nt_vnc(c):
    """rfbsrc's peer: RFB 3.8, no security, a 16x8 framebuffer; the first
    update a red 8x8 block (Raw), the next ones copy it right (CopyRect)."""
    import struct
    c.sendall(b"RFB 003.008\n")
    c.recv(12)
    c.sendall(bytes([1, 1]))
    c.recv(1)
    c.sendall(struct.pack(">I", 0))
    c.recv(1)
    pf = struct.pack(">BBBBHHHBBBxxx", 32, 24, 0, 1, 255, 255, 255, 0, 8, 16)
    c.sendall(struct.pack(">HH", 16, 8) + pf + struct.pack(">I", 4) + b"mini")
    updates = 0
    while True:
        msg = c.recv(1)
        if not msg:
            return updates
        if msg[0] == 0:
            c.recv(19)
        elif msg[0] == 2:
            n = struct.unpack(">H", c.recv(3)[1:])[0]
            c.recv(4 * n)
        elif msg[0] == 3:
            c.recv(9)
            if updates == 0:
                c.sendall(struct.pack(">BxHHHHHi", 0, 1, 0, 0, 8, 8, 0)
                          + bytes([255, 0, 0, 0]) * 64)
            else:
                c.sendall(struct.pack(">BxHHHHHi", 0, 1, 8, 0, 8, 8, 1)
                          + struct.pack(">HH", 0, 0))
            updates += 1


def nt_lines(c, handle):
    """A line protocol's server loop: handle(line, send, f) until it
    returns a value (the result)."""
    f = c.makefile("rwb")

    def send(line):
        f.write(line.encode() + b"\r\n")
        f.flush()
    return handle(None, send, f)


def nt_ftp(c):
    """Just enough FTP for one STOR; returns {path: bytes}."""
    import socket

    def handle(_line, send, f):
        send("220 mini ftp")
        data = socket.socket()
        data.bind(("127.0.0.1", 0))
        data.listen(1)
        dport, stored = data.getsockname()[1], {}
        while True:
            line = f.readline().decode().strip()
            if not line:
                return stored
            cmd = line.split()[0].upper()
            if cmd == "PASV":
                send("227 Entering Passive Mode (127,0,0,1,%d,%d)"
                     % (dport >> 8, dport & 0xFF))
            elif cmd == "STOR":
                send("150 go ahead")
                d, _ = data.accept()
                chunks = []
                while (b := d.recv(65536)):
                    chunks.append(b)
                d.close()
                stored[line.split(None, 1)[1]] = b"".join(chunks)
                send("226 done")
            elif cmd == "QUIT":
                send("221 bye")
                return stored
            else:
                send({"USER": "331 pw", "PASS": "230 ok"}.get(cmd, "200 ok"))
    return nt_lines(c, handle)


def nt_smtp(c):
    """Just enough SMTP for one message; returns the attachment's bytes."""
    import email

    def handle(_line, send, f):
        send("220 mini smtp")
        body, in_data = [], False
        while (line := f.readline()):
            if in_data:
                if line.strip() == b".":
                    send("250 queued")
                    in_data = False
                else:
                    body.append(line)
                continue
            cmd = line.decode().strip().upper()
            if cmd.startswith("DATA"):
                send("354 go")
                in_data = True
            elif cmd.startswith("QUIT"):
                send("221 bye")
                break
            else:
                send("250 ok")
        msg = email.message_from_bytes(b"".join(body))
        return [p.get_payload(decode=True) for p in msg.walk()
                if p.get_filename()]
    return nt_lines(c, handle)


def nt_http(root):
    """A local HTTP server for GET of `root`'s files and PUT (bodies kept
    in .puts); serve_forever in a thread.  Returns the server."""
    import http.server
    import socketserver
    import threading
    puts = {}

    class Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=root, **kw)

        def do_PUT(self):
            n = int(self.headers["Content-Length"])
            puts[self.path] = (self.rfile.read(n),
                               self.headers.get("Authorization"))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *a):
            pass
    srv = socketserver.TCPServer(("127.0.0.1", 0), Handler)
    srv.puts = puts
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def nt_alone_rows(tmp):
    """The runs that drive each of NT_MODULES' 55 factories alone or with
    its pair: [(factories, what it needs from the probe, fn(d) -> plain
    data)]."""
    import socket
    import threading

    import numpy as np
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.element import element_factory_make
    from gstreamer_tpu_torch.net import avtp, rtmp
    from gstreamer_tpu_torch.net.rtp import rtp_header
    rng = np.random.default_rng(25)
    pkts = [rtp_header(96, (65530 + k) & 0xFFFF, 3000 * k, 0x22,
                       marker=k % 4 == 3)
            + rng.integers(0, 256, 300, dtype=np.uint8).tobytes()
            for k in range(12)]
    blob = rng.integers(0, 256, 9000, dtype=np.uint8).tobytes()
    key = rng.integers(0, 256, 30, dtype=np.uint8).tobytes().hex()
    counter = iter(range(10**6))

    def make(factory, d, **props):
        e = element_factory_make(factory, **props)
        e.device = d
        return e

    def launch(desc, pushes=None, batch=1):
        return lambda d: cont_launch(desc, d, batch, pushes)

    def rtp(desc):
        return launch(f"appsrc name=in caps=application/x-rtp ! tee name=t "
                      f"t. ! queue ! {desc.split(' ! ')[0]} ! appsink "
                      f"name=out t. ! queue ! {desc} ! appsink name=out1",
                      {"in": [dict(data=list(pkts[:6]), pts=0),
                              dict(data=list(pkts[6:]), pts=1)]})

    def dtls_pair(d):
        out = []
        for enc_f, dec_f, data in (("dtlsenc", "dtlsdec", [blob]),
                                   ("dtlssrtpenc", "dtlssrtpdec", pkts)):
            cid = f"nt{next(counter)}"
            ec = make(enc_f, d, connection_id=cid + "c", is_client=True)
            dc = make(dec_f, d, connection_id=cid + "c", is_client=True)
            es = make(enc_f, d, connection_id=cid + "s", is_client=False)
            ds = make(dec_f, d, connection_id=cid + "s", is_client=False)
            for e in (ec, dc, es, ds):
                e.start()
            for _ in range(10):
                for oe, idc in ((ec, ds), (es, dc)):
                    o = oe.host_process(None)
                    for rec in ([] if o is None else o.data):
                        idc.host_process(Buffer(data=[rr_pkt_bytes(rec)]))
            wire = ec.host_process(Buffer(data=list(data), batch=1))
            got = []
            for rec in wire.data:
                o = ds.host_process(Buffer(data=[rr_pkt_bytes(rec)]))
                got += [] if o is None else [rr_pkt_bytes(x) for x in o.data]
            out.append(b"".join(got) if enc_f == "dtlsenc" else got)
            for e in (ec, dc, es, ds):
                e.stop()
        return out

    def sctp(d):
        enc, dec = make("sctpenc", d), make("sctpdec", d)
        dec.start()
        wire = [enc.host_aggregate({f"sink_{s}": Buffer(
            data=np.frombuffer(blob[100 * k + s:100 * k + s + 50 + k],
                               np.uint8), meta={"ppid": 51 + s})
            for s in range(1 + k % 3)}) for k in range(5)]
        out = [dec.host_process(Buffer(data=list(wire[k].data)))
               for k in (1, 0, 2, 4, 3)]
        return ([bc_plain(o.data) if o else None for o in out],
                [o.meta["sctp_streams"] for o in out if o], len(dec.sacks))

    def webrtc(d):
        a, b = make("webrtcbin", d), make("webrtcbin", d)
        try:
            nt_negotiate(a, b, pt=96)
            end = time.perf_counter() + 10.0
            while time.perf_counter() < end and not (
                    a.connection_state == b.connection_state == "connected"):
                time.sleep(0.01)
            a.render(Buffer(data=list(pkts[:4])))
            got = []
            while len(got) < 4 and time.perf_counter() < end:
                got += b.pull_received()
            return a.connection_state, b.connection_state, got
        finally:
            a.stop()
            b.stop()

    def rist_pair(d):
        port = nt_free_pair()
        src = make("ristsrc", d, address="127.0.0.1", port=port,
                   timeout=1.0)
        sink = make("ristsink", d, address="127.0.0.1", port=port)
        src.start()
        sink.start()
        got = []
        try:
            for k in range(0, 12, 4):
                sink.render(Buffer(data=list(pkts[k:k + 4])))
            while len(got) < 12 and (b := src.create(1)) is not None:
                got += [rr_pkt_bytes(x) for x in b.data]
        finally:
            sink.stop()
            src.stop()
        return got, src.stats["lost"]

    def rtx(d):
        send, recv = make("ristrtxsend", d), make("ristrtxreceive", d)
        send.start()
        o = send.host_process(Buffer(data=list(pkts[:6])))
        send.request_retransmit(rr_pkt_bytes(pkts[2])[3]
                                | (rr_pkt_bytes(pkts[2])[2] << 8))
        o2 = send.host_process(Buffer(data=list(pkts[6:])))
        return [bc_plain(recv.host_process(x).data) for x in (o, o2)]

    def srt_pair(d):
        port = rr_free_port()
        src = make("srtsrc", d, address="127.0.0.1", port=port, timeout=2.0)
        src.start()
        got = []
        th = threading.Thread(target=lambda: got.extend(
            iter(lambda: (lambda b: None if b is None else rr_pkt_bytes(
                b.data))(src.create(1)), None)), daemon=True)
        th.start()
        sink = make("srtsink", d, address="127.0.0.1", port=port,
                    mode="caller")
        sink.start()
        time.sleep(0.1)
        for k in range(4):
            sink.render(Buffer(data=[blob[k * 1316:(k + 1) * 1316]]))
        sink.stop()
        th.join(10.0)
        src.stop()
        return got

    def rtmp_pair(d):
        srv = rtmp.RtmpRelayServer()
        url = f"rtmp://127.0.0.1:{srv.port}/live/x"
        try:
            src = make("rtmp2src", d, location=url, timeout=2.0)
            src.start()
            sink = make("rtmp2sink", d, location=url)
            sink.start()
            tags = [rtmp.build_flv_tag(8, 40 * k, blob[k * 700:(k + 1) * 700])
                    for k in range(5)]
            sink.render(Buffer(data=np.frombuffer(
                rtmp.FLV_HEADER + b"".join(tags), np.uint8)))
            data = b""
            while len(rtmp.parse_flv_stream(data)[0]) < 5:
                b = src.create(1)
                if b is None:
                    break
                data += rr_pkt_bytes(b.data)
            src.stop()
            sink.stop()
        finally:
            srv.close()
        return rtmp.parse_flv_stream(data)[0]

    def adaptive_files():
        d = os.path.join(tmp, "nt_adaptive")
        os.makedirs(os.path.join(d, "QualityLevels(500)"), exist_ok=True)
        for k in range(3):
            with open(os.path.join(d, f"s{k}.bin"), "wb") as f:
                f.write(blob[k * 500:(k + 1) * 500])
            with open(os.path.join(d, "QualityLevels(500)",
                                   f"Fragments(video={k * 100})"), "wb") as f:
                f.write(blob[k * 300:(k + 1) * 300])
        with open(os.path.join(d, "p.m3u8"), "w") as f:
            f.write("#EXTM3U\n" + "".join(f"#EXTINF:1,\ns{k}.bin\n"
                                          for k in range(3))
                    + "#EXT-X-ENDLIST\n")
        with open(os.path.join(d, "m.mpd"), "w") as f:
            f.write('<MPD><Period><AdaptationSet><Representation id="r" '
                    'bandwidth="9"><SegmentList duration="1">'
                    + "".join(f'<SegmentURL media="s{k}.bin"/>'
                              for k in range(3))
                    + "</SegmentList></Representation></AdaptationSet>"
                    "</Period></MPD>")
        with open(os.path.join(d, "Manifest"), "w") as f:
            f.write('<SmoothStreamingMedia><StreamIndex Type="video" '
                    'Url="QualityLevels({bitrate})/Fragments(video={start '
                    'time})"><QualityLevel Bitrate="500" FourCC="H264"/>'
                    '<c t="0" d="100"/><c d="100"/><c d="100"/>'
                    '</StreamIndex></SmoothStreamingMedia>')
        return d

    def udp_fanout(d):
        rxs = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
               for _ in range(3)]
        for r in rxs:
            r.bind(("127.0.0.1", 0))
            r.settimeout(5.0)
        try:
            m = make("multiudpsink", d, clients=",".join(
                f"127.0.0.1:{r.getsockname()[1]}" for r in rxs[:2]), mtu=1000)
            m.start()
            m.render(Buffer(data=np.frombuffer(blob[:2500], np.uint8)))
            dy = make("dynudpsink", d)
            dy.start()
            dy.render(Buffer(data=[b"dyn"], meta={
                "host": "127.0.0.1", "port": rxs[2].getsockname()[1]}))
            got = [[r.recvfrom(2000)[0] for _ in range(3)] for r in rxs[:2]]
            got.append(rxs[2].recvfrom(100)[0])
            m.stop()
            dy.stop()
            return got
        finally:
            for r in rxs:
                r.close()

    def socket_fanout(d):
        a, b = socket.socketpair()
        r, w = os.pipe()
        ms, mf = make("multisocketsink", d), make("multifdsink", d)
        ms.add(a)
        mf.add(w)
        for e in (ms, mf):
            e.render(Buffer(data=np.frombuffer(blob[:3000], np.uint8)))
        a.close()
        os.close(w)
        src = make("socketsrc", d, socket=b, blocksize=1024, timeout=1.0)
        src.start()
        got = []
        while (buf := src.create(1)) is not None:
            got.append(rr_pkt_bytes(buf.data))
        src.stop()
        b.close()
        with os.fdopen(r, "rb") as f:
            piped = f.read()
        return got, piped, ms.bytes_served, mf.bytes_served

    def rfb(d):
        srv = NtServer(nt_vnc)
        got = cont_launch(f"rfbsrc port={srv.port} num-buffers=2 ! appsink "
                          "name=out", d, 1)
        return got, srv.join()

    pcm = rng.integers(-2000, 2000, (960, 2), dtype=np.int16)
    frames = rng.integers(0, 65536, (2, 16, 800), dtype=np.uint16)
    samples = rng.integers(-99, 99, (400, 1), dtype=np.int16)

    def aaf(d):
        return launch("appsrc name=in caps=audio/x-raw,format=S16BE,"
                      "rate=48000,channels=2 ! avtpaafpay ! tee name=t t. ! "
                      "queue ! appsink name=out t. ! queue ! avtpaafdepay ! "
                      "appsink name=out1", {"in": [dict(data=np.frombuffer(
                          pcm.astype(">i2").tobytes(), np.uint8), pts=0)]})(d)

    def cvf(d):
        au = b"".join(b"\x00\x00\x00\x01" + bytes([t]) + blob[:n]
                      for t, n in ((0x67, 8), (0x65, 3000)))
        return launch("appsrc name=in caps=video/x-h264,stream-format="
                      "byte-stream ! avtpcvfpay ! tee name=t t. ! queue ! "
                      "appsink name=out t. ! queue ! avtpcvfdepay ! appsink "
                      "name=out1", {"in": [dict(data=np.frombuffer(
                          au, np.uint8), pts=0)]})(d)

    def rvf(d):
        return launch("appsrc name=in caps=video/x-raw,format=GRAY16_LE,"
                      "width=800,height=16,framerate=25/1 ! avtprvfpay ! tee "
                      "name=t t. ! queue ! appsink name=out t. ! queue ! "
                      "avtprvfdepay ! appsink name=out1",
                      {"in": [dict(data=(frames,), batch=2, pts=0)]}, 2)(d)

    def crf(d):
        pdus = [avtp.build_aaf_pdu(k, 7, 3000 + 100 * k, 48000, 2,
                                   blob[:16]) for k in range(4)]
        crf_pdu = bytearray(40)
        crf_pdu[0] = avtp.SUBTYPE_CRF
        crf_pdu[24:32] = (0x1_0000_5000).to_bytes(8, "big")
        out = []
        for f in ("avtpcrfsync", "avtpcrfcheck"):
            e = make(f, d)
            out.append([bc_plain(e.host_process(Buffer(data=x)).data)
                        for x in (pdus[:2], [bytes(crf_pdu)] + pdus[2:])])
        return out

    def avtp_lo(d):
        return nt_avtp_lo(d, [b"\x00\x00\x00\x01\x67" + blob[:2000]])

    def proxy(d):
        ch = f"nt{next(counter)}"
        cont_launch("appsrc name=in caps=audio/x-raw,format=S16LE,rate=8000,"
                    "channels=1,layout=interleaved ! proxysink channel=" + ch,
                    d, 1, {"in": [dict(data=samples, pts=0)]})
        return cont_launch(f"proxysrc channel={ch} ! appsink name=out", d, 1)

    def shm(d):
        path = os.path.join(tmp, f"nt_shm{next(counter)}")
        cont_launch(f"appsrc name=in ! application/octet-stream ! shmsink "
                    f"socket-path={path}", d, 1,
                    {"in": [dict(data=np.frombuffer(blob[k:k + 700],
                                                    np.uint8), pts=k)
                            for k in range(0, 2800, 700)]})
        return cont_launch(f"shmsrc socket-path={path} ! appsink name=out",
                           d, 1)

    def http_src(d):
        root = os.path.join(tmp, "nt_http")
        os.makedirs(root, exist_ok=True)
        with open(os.path.join(root, "b.bin"), "wb") as f:
            f.write(blob)
        srv = nt_http(root)
        try:
            return [cont_launch(f"{f} location=http://127.0.0.1:"
                                f"{srv.server_address[1]}/b.bin blocksize=4000"
                                " ! appsink name=out", d, 1)
                    for f in ("souphttpsrc", "neonhttpsrc", "curlhttpsrc")]
        finally:
            srv.shutdown()
            srv.server_close()

    def upload(desc_fmt, serve=None):
        def run(d):
            srv = nt_http(tmp) if serve == "http" else (
                NtServer(serve) if serve else None)
            port = (srv.server_address[1] if serve == "http"
                    else srv.port if srv else 0)
            name = os.path.join(tmp, f"nt_up{next(counter)}.bin")
            cont_launch("appsrc name=in ! application/octet-stream ! "
                        + desc_fmt.format(port=port, file=name), d, 1,
                        {"in": [dict(data=np.frombuffer(blob[k:k + 3000],
                                                        np.uint8), pts=k)
                                for k in range(0, 9000, 3000)]})
            if serve == "http":
                srv.shutdown()
                srv.server_close()
                return sorted(srv.puts.items())
            if srv is not None:
                return srv.join()
            with open(name, "rb") as f:
                return f.read()
        return run

    vpushes = {"in": [dict(data=np.frombuffer(blob[:4000], np.uint8),
                           pts=0),
                      dict(data=np.frombuffer(blob[4000:6500], np.uint8),
                           pts=1)]}
    ad = adaptive_files()
    rows = [
        (("srtpenc", "srtpdec"), "dtls",
         rtp(f"srtpenc key={key} ! srtpdec key={key}")),
        (("dtlsenc", "dtlsdec", "dtlssrtpenc", "dtlssrtpdec"), "dtls",
         dtls_pair),
        (("dtlssrtpdemux",), "", launch(
            "appsrc name=in ! application/x-rtp ! dtlssrtpdemux ! appsink "
            "name=out", {"in": [dict(data=[bytes([22, 254, 253]) + bytes(20),
                                           pkts[0]], pts=0)]})),
        (("sctpenc", "sctpdec"), "", sctp),
        (("webrtcbin",), "dtls", webrtc),
        (("ristsink", "ristsrc"), "udp", rist_pair),
        (("ristrtpext", "ristrtpdeext"), "", rtp(
            "ristrtpext drop-null-ts-packets=true sequence-number-extension="
            "true ! ristrtpdeext")),
        (("ristrtxsend", "ristrtxreceive"), "", rtx),
        (("srtsink", "srtsrc"), "libsrt", srt_pair),
        (("rtmp2sink", "rtmp2src"), "tcp", rtmp_pair),
        (("hlsdemux",), "", launch(f"hlsdemux uri={ad}/p.m3u8 ! appsink "
                                   "name=out")),
        (("dashdemux",), "", launch(f"dashdemux uri=file://{ad}/m.mpd ! "
                                    "appsink name=out")),
        (("mssdemux",), "", launch(f"mssdemux uri={ad}/Manifest ! appsink "
                                   "name=out")),
        (("multiudpsink", "dynudpsink"), "udp", udp_fanout),
        (("multisocketsink", "multifdsink", "socketsrc"), "", socket_fanout),
        (("rfbsrc",), "tcp", rfb),
        (("avtpaafpay", "avtpaafdepay"), "", aaf),
        (("avtpcvfpay", "avtpcvfdepay"), "", cvf),
        (("avtprvfpay", "avtprvfdepay"), "", rvf),
        (("avtpcrfsync", "avtpcrfcheck"), "", crf),
        (("avtpsink", "avtpsrc"), "af_packet", avtp_lo),
        (("proxysink", "proxysrc"), "", proxy),
        (("shmsink", "shmsrc"), "", shm),
        (("souphttpsrc", "neonhttpsrc", "curlhttpsrc"), "tcp", http_src),
        (("streamsynchronizer", "tsparse"), "", launch(
            "appsrc name=in ! video/mpegts ! streamsynchronizer ! tsparse ! "
            "appsink name=out", {"in": [dict(data=np.frombuffer(
                b"".join(b"\x47" + blob[k * 187:(k + 1) * 187]
                         for k in range(12)), np.uint8), pts=0)]})),
        (("unalignedvideoparse", "unalignedaudioparse"), "", launch(
            "appsrc name=in ! application/octet-stream ! unalignedvideoparse "
            "format=GRAY8 width=40 height=30 ! appsink name=out "
            "appsrc name=in1 ! application/octet-stream ! unalignedaudioparse "
            "! appsink name=out1", dict(vpushes, in1=vpushes["in"]))),
        (("souphttpclientsink", "curlhttpsink"), "tcp", lambda d: [
            upload(f"{f} location=http://127.0.0.1:{{port}}/up.bin", "http")(d)
            for f in ("souphttpclientsink", "curlhttpsink")]),
        (("curlfilesink",), "", upload("curlfilesink location=file://{file}")),
        (("curlftpsink",), "tcp", upload(
            "curlftpsink user=u passwd=p location=ftp://127.0.0.1:{port}/"
            "up.dat", nt_ftp)),
        (("curlsmtpsink",), "tcp", upload(
            "curlsmtpsink mail-from=a@b.c mail-rcpt=d@e.f location=smtp://"
            "127.0.0.1:{port}", nt_smtp))]
    covered = {f for names, _need, _fn in rows for f in names}
    mine = rr_factories(NT_MODULES)
    require(covered == mine and len(mine) == NT_FACTORIES,
            f"net tail alone: the rows cover {len(covered)} factories, the "
            f"slice's modules register {len(mine)}; not driven: "
            f"{sorted(mine - covered)}")
    return rows


def net_tail_phase(seed, counters, dev):
    """The rest of net/ on the card, each item with the launch counts
    zeroed just before and read just after: the probe line first, then
    rist_camera (generic and range NACKs through a lossy relay; yscale_hv
    once a tick that gives frames), rist_camera_live (where the probe found
    UDP), webrtc_camera (where it found libssl and UDP), srt_ts_link (the
    error both packages raise where it found no libsrt), rtmp_audio,
    hls_dash_pull, shm_camera, avtp_raw_video (AAF and CVF too; avtpsink /
    avtpsrc where AF_PACKET is allowed), then each of the 55 factories
    alone.  Returns {kernel: launches}."""
    import tempfile

    import numpy as np
    import torch
    start, finish, peak, total = phase_meters(counters, dev)
    t0 = time.perf_counter()
    probe = nt_probe()
    have = {"": True, "udp": probe["udp"], "tcp": probe["tcp"],
            "dtls": probe["dtls"] and probe["udp"], "libsrt": probe["libsrt"],
            "af_packet": probe["af_packet"]}
    missing = sorted(k for k, v in have.items() if not v)
    print(f"net tail phase: probe: {probe}; " + (
        "every item runs" if not missing else
        f"items needing {missing} run as the error both packages raise "
        f"(a difference of installation, ROADMAP.md section 3), not as a "
        f"pass"))
    files, dig = codec_vectors(("mp3_10s.mp3", "aac_10s.aac",
                                "digests.json"))
    spent = {}

    def item(name, fn, *a):
        t1 = time.perf_counter()
        out = fn(*a)
        spent[name] = time.perf_counter() - t1
        return out
    with tempfile.TemporaryDirectory() as tmp:
        jdir, _jpgs = item("jpegs", rr_jpegs, seed, dev, tmp)
        start("multifilesrc ! jpegdec")
        ref = item("reference", rr_rgb_ref, jdir, dev)
        finish("multifilesrc ! jpegdec",
               {"yscale_hv": -(-RR_CAM[2] // RR_CAM[3])})
        require(cont_equal(ref, rr_rgb_ref(jdir, torch.device("cpu"))),
                "multifilesrc ! jpegdec: the card's RGB differs from the "
                "port's CPU run")
        start("rtpjpegpay")
        sent = rr_frames(rr_pay(dev, jdir, {}))
        finish("rtpjpegpay", {})
        if have["udp"]:
            sender = item("rist_sender", NtSender, jdir)
            try:
                item("rist_camera", rist_camera, seed, dev, sender, ref,
                     sent, start, finish, peak)
                item("rist_camera_live", rist_camera_live, dev, sender, ref,
                     sent, start, finish, peak)
            finally:
                sender.close()
        else:
            print("  rist_camera, rist_camera_live: NOT RUN (no UDP on "
                  "loopback)")
        if have["dtls"]:
            item("webrtc_camera", webrtc_camera, dev, jdir, ref, start,
                 finish, peak)
        else:
            print("  webrtc_camera: NOT RUN, a difference of installation: "
                  "the probe found no libssl or no UDP; webrtcbin fails "
                  "its connection alike in both packages")
        start("faad")
        plain_aac = np.concatenate(vt_pcm(f"filesrc location="
                                          f"{files['aac_10s.aac']} ! aacparse "
                                          "! faad", dev))
        finish("faad", {})
        codec_pcm_check("faad", plain_aac, dig["aac_adts"])
        item("srt_ts_link", srt_ts_link, dev, tmp, files, plain_aac, start,
             finish, peak, have["libsrt"] and have["udp"])
        if have["tcp"]:
            item("rtmp_audio", rtmp_audio, dev, tmp, files, dig, start,
                 finish, peak)
        item("hls_dash_pull", hls_dash_pull, dev, tmp, files, plain_aac,
             start, finish, peak)
        item("shm_camera", shm_camera, dev, jdir, ref, tmp, start, finish,
             peak)
        item("avtp_raw_video", avtp_raw_video, seed, dev, start, finish,
             peak, True if have["af_packet"] else probe.get(
                 "af_packet_error", "no frame came back"))
        rows = nt_alone_rows(tmp)
        run = [(("/".join(names)), lambda d, _tmp, _seed, fn=fn: fn(d))
               for names, need, fn in rows if have[need]]
        skipped = [f for names, need, _fn in rows if not have[need]
                   for f in names]
        item("alone", alone_runs, run, counters, dev, 0)
    print(f"  net tail alone: {NT_FACTORIES - len(skipped)} factories in "
          f"{len(run)} runs on the card == the port's CPU run, no launch"
          + (f"; NOT RUN, a difference of installation: {skipped}"
             if skipped else ""))
    print(f"net tail phase: {time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in spent.items()) + ")")
    return total


CT_FILES = ("h264_1080p.ts", "speex_16k.spx", "anim_320x200.flc",
            "digests.json")
CT_SMOKE = (1920, 1080, 8, 4)       # smoke_camera: width, height, frames, batch
CT_RGB = "videoconvertscale ! video/x-raw,format=RGB,width=640,height=360"
CT_FLIC_I420 = "video/x-raw,format=I420,width=640,height=400"
# avdec_h264's caps carry no size (h264parse sets none, in both packages):
# the decoded size is named, as jpegdec's after rtpjpegdepay
CT_H264_RAW = "video/x-raw,format=I420,width=1920,height=1080,framerate=25/1"
CT_LC3 = (48000, 2, 24000, 4800)    # rate, channels, frames, frames a push
CT_BATCH = 4
CT_SEED = 2026                      # the inputs whose digests are committed


def ct_frames(n, w, h, seed):
    """n I420 frames of w x h made with integer arithmetic only (the same
    bytes on any machine): tiles under a diagonal ramp, seeded noise, and
    a disc that crosses them; host planes (n, h, w), (n, h/2, w/2) x 2."""
    import numpy as np
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y0 = ((xx // 64 + yy // 48) % 2 * 50 + (xx + yy) * 120 // (w + h) + 40
          + rng.integers(0, 8, (h, w))).astype(np.uint8)
    cy, cx = np.mgrid[0:h // 2, 0:w // 2]
    u0 = (96 + (cx // 32 + cy // 24) % 3 * 24).astype(np.uint8)
    v0 = (160 - (cx * 48) // (w // 2)).astype(np.uint8)
    out = ([], [], [])
    r = h // 8
    for k in range(n):
        ox, oy = w // 8 + k * w // (n + 2), h // 2 + (k % 3 - 1) * h // 10
        disc = (xx - ox) ** 2 + (yy - oy) ** 2 <= r * r
        cdisc = disc[::2, ::2]
        out[0].append(np.where(disc, 220 - 4 * k, y0).astype(np.uint8))
        out[1].append(np.where(cdisc, 60, u0).astype(np.uint8))
        out[2].append(np.where(cdisc, 200, v0).astype(np.uint8))
    return tuple(np.stack(p) for p in out)


def ct_lc3_input(seed):
    """CT_LC3's S16 input made with integer arithmetic only: two triangle
    waves a channel and seeded noise; (frames, channels)."""
    import numpy as np
    rate, ch, n, _per = CT_LC3
    t = np.arange(n)

    def tri(period, amp):
        return (np.abs(t % period - period // 2) * 4 * amp // period - amp)
    x = np.stack([tri(109, 6000) + tri(23, 1500),
                  tri(83, 5000) - tri(31, 2000)][:ch], 1)
    x += np.random.default_rng(seed).integers(-300, 300, x.shape)
    return x.astype(np.int16)


def ct_video_pushes(planes, batch, dev, fps=25):
    """Appsrc buffers of `batch` frames, their planes on `dev`."""
    import torch
    from gstreamer_tpu_torch.core.buffer import Buffer
    dur = 10**9 // fps
    return [Buffer(data=tuple(torch.from_numpy(p[k:k + batch]).to(dev)
                              for p in planes), batch=batch, pts=k * dur,
                   duration=dur) for k in range(0, len(planes[0]), batch)]


def ct_lc3_pushes(x, dev):
    import torch
    from gstreamer_tpu_torch.core.buffer import Buffer
    rate, _ch, _n, per = CT_LC3
    return [Buffer(data=torch.from_numpy(x[k:k + per]).to(dev),
                   pts=k * 10**9 // rate,
                   duration=len(x[k:k + per]) * 10**9 // rate)
            for k in range(0, len(x), per)]


def ct_blobs(samples):
    """Every coded blob of a sink's samples, as bytes."""
    import numpy as np
    out = []
    for smp in samples:
        d = smp.buffer.data
        for b in (d if isinstance(d, (list, tuple)) else [d]):
            out.append(bytes(b) if isinstance(b, (bytes, bytearray))
                       else np.asarray(b).tobytes())
    return out


def ct_planes(samples):
    """Every frame's planes of a sink's samples, on the host."""
    return [[p[k].cpu().numpy() for p in smp.buffer.data]
            for smp in samples for k in range(smp.buffer.batch)]


def ct_sha(chunks):
    import hashlib
    return [hashlib.sha256(c).hexdigest() for c in chunks]


def ct_plain_route(name, desc, dev, start, finish, pushes, batch, want,
                   ref):
    """`desc` again with the yscale kernel switched off (the two plain
    scale passes): no launch, and every output frame equal to `ref`'s
    (the kernel's run on the same frames)."""
    import torch
    with switches(GTPU_PALLAS_YSCALE="0"):
        start(name + "[plain]")
        plain = codec_run(desc, dev, batch, "a", pushes)
        finish(name + "[plain]", {})
    a = [p for s in ref for p in s.buffer.data]
    b = [p for s in plain for p in s.buffer.data]
    require(len(a) == len(b) == want and all(
        torch.equal(x, y) for x, y in zip(a, b)),
        f"{name}: the yscale kernel's frames differ from the plain route's")


def ct_h264_ingest(dev, start, finish, peak, files, dig):
    """The committed 1080p H.264 TS decoded by avdec_h264 (every plane the
    JAX package's), then converted to RGB 640x360 on the card (yscale_hv
    once a tick, equal to the plain route); the Ogg-Speex file within the
    JAX package's digest."""
    import numpy as np
    ts, spx = files["h264_1080p.ts"], files["speex_16k.spx"]
    head = f"tsdemux location={ts} ! h264parse ! avdec_h264"
    start("h264_ingest[planes]")
    t0 = time.perf_counter()
    got = codec_run(f"{head} ! appsink name=a", dev, CT_BATCH, "a")
    secs = time.perf_counter() - t0
    finish("h264_ingest[planes]", {})
    frames = ct_planes(got)
    require([ct_sha([np.ascontiguousarray(p).tobytes() for p in f])
             for f in frames] == dig["h264_ts"],
            "h264_ingest: decoded planes differ from the JAX package's")
    desc = f"{head} ! {CT_H264_RAW} ! {CT_RGB} ! appsink name=a"
    base = start("h264_ingest")
    t0 = time.perf_counter()
    rgb = codec_run(desc, dev, CT_BATCH, "a")
    rsecs = time.perf_counter() - t0
    n = len(frames)
    # one conversion a buffer avdec_h264 gives (tsdemux hands it an access
    # unit a tick)
    counts = finish("h264_ingest", {"yscale_hv": len(got)})
    ct_plain_route("h264_ingest", desc, dev, start, finish, None, CT_BATCH,
                   len(got) * 3, rgb)
    print(f"  h264_ingest: {n} 1080p frames == the JAX package's sha256 "
          f"({secs:.2f} s to decode, {n / secs:.1f} frames/s); RGB "
          f"640x360 at batch {CT_BATCH} == the plain route, {rsecs:.2f} s, "
          f"launches {counts}, peak {peak(base):.1f} MiB")
    start("speex_ogg")
    pcm = np.concatenate([s.buffer.data.cpu().numpy() for s in codec_run(
        f"oggdemux location={spx} ! appsink name=a", dev, 1, "a")])
    finish("speex_ogg", {})
    err = codec_pcm_check("speex_ogg", pcm, dig["speex_ogg"])
    print(f"  speex_ogg: {pcm.shape[0]} frames at 16 kHz within {err} of "
          f"the JAX package's digest")


def ct_av_absent(dev, files):
    """Without libavcodec no av factory registers, in either package: the
    explicit avdec_h264 launch fails to parse and oggdemux on the Speex
    file raises, each with the error both packages raise; decodebin on the
    TS raises the port's error naming the missing codec (the JAX package's
    decodebin passes the coded stream on undecoded instead).  Printed as
    such, not as a pass."""
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.parse import ParseError
    from gstreamer_tpu_torch.native import av
    ts = files["h264_1080p.ts"]
    for name, desc, want, both in (
            ("h264_ingest", f"tsdemux location={ts} ! h264parse ! avdec_h264"
             " ! appsink name=a", "no element factory 'avdec_h264'", True),
            ("h264_ingest[decodebin]", f"decodebin uri=file://{ts} ! appsink "
             "name=a", "avdec_h264 for video/x-h264: the system libavcodec "
             f"is missing ({av.missing()})", False),
            ("speex_ogg", f"oggdemux location={files['speex_16k.spx']} ! "
             "appsink name=a", "av: libavcodec shim unavailable", True)):
        try:
            parse_launch(desc, device=dev).run()
        except (RuntimeError, ParseError) as e:
            require(want in str(e), f"{name}: raised {e!r}, want {want!r}")
            print(f"  {name}: NOT RUN, a difference of installation: "
                  f"{type(e).__name__}({str(e)!r}), " + (
                      "the error both packages raise without libavcodec"
                      if both else "the port's error without libavcodec"))
            continue
        require(False, f"{name}: ran without libavcodec")


def ct_smoke(dev, start, finish, peak, dig):
    """ct_frames through smokeenc, smokeenc ! smokedec and on to RGB
    640x360 on the card: the packets and planes the CPU box's sha256,
    yscale_hv once a tick, equal to the plain route."""
    w, h, n, b = CT_SMOKE
    planes = ct_frames(n, w, h, CT_SEED)
    src = (f"appsrc name=in caps=video/x-raw,format=I420,width={w},"
           f"height={h},framerate=25/1")
    start("smoke_camera[smokeenc]")
    t0 = time.perf_counter()
    pkts = ct_blobs(codec_run(f"{src} ! smokeenc ! appsink name=a", dev, b,
                              "a", {"in": ct_video_pushes(planes, b, dev)}))
    esecs = time.perf_counter() - t0
    finish("smoke_camera[smokeenc]", {})
    require(ct_sha(pkts) == dig["smoke"]["packets"],
            "smoke_camera: the Smoke packets differ from the CPU box's")
    start("smoke_camera[smokedec]")
    t0 = time.perf_counter()
    dec = ct_planes(codec_run(f"{src} ! smokeenc ! smokedec ! appsink "
                              "name=a", dev, b, "a",
                              {"in": ct_video_pushes(planes, b, dev)}))
    dsecs = time.perf_counter() - t0
    finish("smoke_camera[smokedec]", {})
    require([ct_sha([p.tobytes() for p in f]) for f in dec]
            == dig["smoke"]["planes"],
            "smoke_camera: smokedec's planes differ from the CPU box's")
    desc = f"{src} ! smokeenc ! smokedec ! {CT_RGB} ! appsink name=a"
    base = start("smoke_camera")
    t0 = time.perf_counter()
    rgb = codec_run(desc, dev, b, "a", {"in": ct_video_pushes(planes, b,
                                                              dev)})
    rsecs = time.perf_counter() - t0
    counts = finish("smoke_camera", {"yscale_hv": n // b})
    ct_plain_route("smoke_camera", desc, dev, start, finish,
                   {"in": ct_video_pushes(planes, b, dev)}, b, n // b * 3,
                   rgb)
    print(f"  smoke_camera: {n} {w}x{h} frames, {sum(map(len, pkts))} "
          f"bytes of Smoke == the CPU box's sha256 ({esecs:.2f} s to "
          f"encode); smokedec's planes == ({dsecs:.2f} s with the encode); "
          f"RGB 640x360 at batch {b} == the plain route, {rsecs:.2f} s, "
          f"launches {counts}, peak {peak(base):.1f} MiB")


def ct_flic(dev, start, finish, files, dig):
    """The committed FLIC through flxdec (RGB planes the JAX package's
    sha256) and on to I420 640x400 (every plane's)."""
    flc = files["anim_320x200.flc"]
    start("flic_anim[rgb]")
    rgb = ct_planes(codec_run(f"flxdec location={flc} ! appsink name=a", dev,
                              CT_BATCH, "a"))
    finish("flic_anim[rgb]", {})
    require([ct_sha([p.tobytes() for p in f]) for f in rgb]
            == dig["flic"]["rgb"],
            "flic_anim: flxdec's RGB planes differ from the JAX package's")
    require(dig["flic"]["caps"] == CT_FLIC_I420,
            "flic_anim: the digest is of another conversion")
    start("flic_anim")
    t0 = time.perf_counter()
    i420 = ct_planes(codec_run(
        f"flxdec location={flc} ! videoconvertscale ! {CT_FLIC_I420} ! "
        "appsink name=a", dev, CT_BATCH, "a"))
    secs = time.perf_counter() - t0
    counts = finish("flic_anim", {})
    require([ct_sha([p.tobytes() for p in f]) for f in i420]
            == dig["flic"]["i420"],
            "flic_anim: the I420 planes differ from the JAX package's")
    print(f"  flic_anim: {len(rgb)} 320x200 frames, RGB and I420 640x400 "
          f"== the JAX package's sha256, {secs:.2f} s, launches {counts}")


def ct_lc3(dev, start, finish, dig):
    """ct_lc3_input through lc3enc and lc3enc ! lc3dec on the card's host:
    the bytes and the PCM the CPU box's sha256."""
    import numpy as np
    rate, ch, _n, _per = CT_LC3
    x = ct_lc3_input(CT_SEED)
    src = (f"appsrc name=in caps=audio/x-raw,format=S16LE,rate={rate},"
           f"channels={ch},layout=interleaved")
    start("lc3_stereo")
    t0 = time.perf_counter()
    frames = ct_blobs(codec_run(f"{src} ! lc3enc ! appsink name=a", dev, 1,
                                "a", {"in": ct_lc3_pushes(x, dev)}))
    esecs = time.perf_counter() - t0
    pcm = np.concatenate([s.buffer.data.cpu().numpy() for s in codec_run(
        f"{src} ! lc3enc ! lc3dec ! appsink name=a", dev, 1, "a",
        {"in": ct_lc3_pushes(x, dev)})])
    finish("lc3_stereo", {})
    d = dig["lc3"]
    require(len(frames) == d["frames"]
            and ct_sha([b"".join(frames)])[0] == d["bytes"],
            "lc3_stereo: the LC3 frames differ from the CPU box's")
    require(pcm.shape == (d["samples"], ch)
            and ct_sha([pcm.tobytes()])[0] == d["pcm"],
            "lc3_stereo: lc3dec's PCM differs from the CPU box's")
    print(f"  lc3_stereo: {len(frames)} frames of {len(frames[0])} bytes and "
          f"{pcm.shape[0]} frames of PCM == the CPU box's sha256 "
          f"({esecs:.2f} s to encode {len(x) / rate} s)")


def codec_tail_phase(seed, counters, dev):
    """The libav family and LC3, Smoke and FLIC on the card, each item with
    the launch counts zeroed just before and read just after: the probe
    line, h264_ingest (avdec_h264 to RGB 640x360, yscale_hv once a buffer;
    the Speex file) where the system libavcodec is there, else the error
    both packages raise; smoke_camera (yscale_hv once a tick),
    flic_anim, lc3_stereo.  The inputs compared with committed digests are
    made from CT_SEED, not `seed`.  Returns {kernel: launches}."""
    from gstreamer_tpu_torch.elements import libav
    from gstreamer_tpu_torch.native import av
    start, finish, peak, total = phase_meters(counters, dev)
    t0 = time.perf_counter()
    names = sorted({e[1] for t in (libav._DECODERS, libav._AUDIO_DECODERS)
                    for e in t} | {"aptx"})
    encs = sorted({e[1] for t in (libav._ENCODERS, libav._AUDIO_ENCODERS)
                   for e in t})
    have = av.available()
    print(f"codec tail phase: libavcodec: missing() = {av.missing()!r}, "
          f"available() = {have}; decoders "
          f"{ {n: av.have_codec(n) for n in names} }; encoders "
          f"{ {n: av.have_codec(n, encoder=True) for n in encs} }" + (
              "" if have else "; the libav items run as the error both "
              "packages raise (a difference of installation, ROADMAP.md "
              "section 3), not as a pass"))
    files, dig = codec_vectors(CT_FILES)
    spent = {}

    def item(name, fn, *a):
        t1 = time.perf_counter()
        fn(*a)
        spent[name] = time.perf_counter() - t1
    if have and av.have_codec("h264") and av.have_codec("libspeex"):
        item("h264_ingest", ct_h264_ingest, dev, start, finish, peak, files,
             dig)
    else:
        item("av_absent", ct_av_absent, dev, files)
    item("smoke_camera", ct_smoke, dev, start, finish, peak, dig)
    item("flic_anim", ct_flic, dev, start, finish, files, dig)
    item("lc3_stereo", ct_lc3, dev, start, finish, dig)
    print(f"codec tail phase: {time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in spent.items()) + ")")
    return total


TS_FILES = ("mp3_10s.mp3", "vorbis_10s.ogg", "tags_1s.flac", "digests.json")
TS_MODULES = tuple(f"gstreamer_tpu_torch.elements.{m}" for m in (
    "subparse", "subtitles_extra", "tagmux", "multipart", "moreparsers",
    "aliases", "transcode"))
TS_BURNIN = (1920, 1080, 64, 16)    # subtitle_burnin: width, height, frames, batch
TS_TTML = (1920, 1080, 32, 16)      # ttml_burnin
TS_CUES = 8                         # the .srt's cues, 320 ms apart
TS_RAW = (1920, 1080, 8, 4)         # transcode_raw's Matroska: frames, batch
TS_BPM = (16000, 10, 120)           # bpm_click: rate, seconds, beats a minute
TS_ALONE = (64, 48, 4)              # width, height, frames of a factory alone
TS_SEED = 2027                      # the inputs whose digests are committed
TS_ID3_TAGS = "title=Tagged Song,artist=Me,album=Phase 24,track-number=3"
TS_APE_TAGS = "title=Tagged Song,artist=Me"
TS_XIPH_TAGS = "TITLE=Tagged Song;ARTIST=Me"


def ts_ms(ms):
    return (f"{ms // 3_600_000:02d}:{ms // 60_000 % 60:02d}:"
            f"{ms // 1000 % 60:02d},{ms % 1000:03d}")


def ts_srt(path):
    """TS_CUES SubRip cues, one every 320 ms, each on for 300 ms."""
    with open(path, "w") as f:
        for k in range(TS_CUES):
            f.write(f"{k + 1}\n{ts_ms(320 * k)} --> {ts_ms(320 * k + 300)}\n"
                    f"Subtitle {k + 1}: burnt into the training frames\n\n")
    return path


def ts_ttml(k):
    """A TTML document of two cues (the first is drawn)."""
    return (f'<?xml version="1.0" encoding="utf-8"?>\n<tt xmlns="http://www.'
            f'w3.org/ns/ttml"><body><div><p begin="{k}.0s" end="{k}.5s">TTML '
            f'cue {k}: rendered by ttmlrender</p><p begin="{k}.5s" end='
            f'"{k + 1}.0s">second</p></div></body></tt>').encode()


def ts_sha(data):
    """A sink's data, or bytes, as one sha256: tensors and arrays by their
    bytes (wherever they lie), text by its UTF-8, containers in order."""
    import hashlib

    import numpy as np
    import torch
    h = hashlib.sha256()

    def add(x):
        if isinstance(x, (list, tuple)):
            for v in x:
                add(v)
        elif isinstance(x, torch.Tensor):
            h.update(x.cpu().numpy().tobytes())
        elif isinstance(x, np.ndarray):
            h.update(x.tobytes())
        elif isinstance(x, str):
            h.update(x.encode())
        else:
            h.update(bytes(x))
    add(data)
    return h.hexdigest()


def ts_file_sha(path):
    with open(path, "rb") as f:
        return ts_sha(f.read())


def ts_run(desc, d, batch=1, pushes=None, sink="a"):
    """`desc` to EOS on `d`: its sink's samples (none without one) and its
    tag messages."""
    from gstreamer_tpu_torch import parse_launch
    pipe = parse_launch(desc, batch=batch, device=d)
    push_all(pipe, pushes)
    pipe.run()
    s = pipe.get_by_name(sink)
    tags = [(m.src, m.data) for m in iter(pipe.bus.pop, None)
            if m.type == "tag"]
    return (drain(s) if s is not None else []), tags, pipe


def ts_burnin_run(name, desc, size, dev, start, finish, peak, pushes=None):
    """One burn-in path on the card (codec_path: yscale_hv once a tick that
    gave frames), held frame for frame to the port's CPU run of the same
    string; `size` is (width, height, frames, batch).  Returns (the card's
    frames, its pipeline, the numbers)."""
    import torch
    w, h, n, batch = size
    pipe, out, r = codec_path(
        name, desc, batch, dev, start, finish, peak,
        lambda fed: {"yscale_hv": sum(1 for f in fed if f)}, (), pushes)
    got = cont_joined(out["v"])
    ref = cont_joined(ts_run(desc, torch.device("cpu"), batch, pushes,
                             "v")[0])
    require(got is not None and got[0].shape[0] == n,
            f"{name}: {0 if got is None else got[0].shape[0]} of {n} frames")
    require(cont_equal(got, ref), f"{name}: the card's frames differ from "
            "the port's CPU run of the same string")
    fed, secs = r["fed"][1:], r["tick_secs"][1:]
    fps = sum(fed) / max(sum(secs), 1e-9)
    print(f"e2e {name}: {n} {w}x{h} frames to RGB 224x224 == "
          f"the port's CPU run, {fps:.1f} frames/s over ticks 2..{r['ticks']}"
          f"; device busy {r['busy']:.3f} ms and idle share {r['idle']:.3f} "
          f"of a {r['wall']:.3f} ms tick (traced); {r['d2h'] / 2**20:.3f} MiB "
          f"D2H and {r['h2d'] / 2**20:.3f} MiB H2D a tick; peak memory "
          f"{r['mem']:.1f} MiB; launches {r['launches']}")
    return got, pipe, r


def subtitle_burnin(dev, tmp, start, finish, peak):
    """videotestsrc's 1080p I420 into subtitleoverlay with filesrc ! subparse
    of an .srt, then to RGB 224x224 on the card (yscale_hv once a tick):
    equal to the port's CPU run; the text changed the frames."""
    w, h, n, b = TS_BURNIN
    srt = ts_srt(os.path.join(tmp, "burnin.srt"))
    video = (f"videotestsrc num-buffers={n} ! video/x-raw,format=I420,width="
             f"{w},height={h},framerate={CONT_FPS}/1")
    # filesrc reads blocksize bytes a frame: the .srt spans the video's
    # ticks, its cues reaching subparse a few at a time
    block = -(-os.path.getsize(srt) // n)
    desc = (f"{video} ! subtitleoverlay name=o ! {CONT_RGB} filesrc name=s "
            f"location={srt} blocksize={block} ! subparse name=p ! o.")
    got, pipe, _r = ts_burnin_run("subtitle_burnin", desc, TS_BURNIN, dev,
                                  start, finish, peak)
    require(pipe.get_by_name("p")._emitted == TS_CUES,
            f"subtitle_burnin: subparse gave {pipe.get_by_name('p')._emitted}"
            f" of {TS_CUES} cues")
    require(pipe.get_by_name("s") in pipe._host_fed,
            "subtitle_burnin: the .srt was staged on the card")
    bare = cont_joined(ts_run(f"{video} ! {CONT_RGB}", dev, b, sink="v")[0])
    drawn = int((got[0] != bare[0]).flatten(1).any(1).sum())
    require(drawn > 0, "subtitle_burnin: no frame carries text")
    print(f"  subtitle_burnin: {TS_CUES} cues drawn on {drawn} of {n} frames")


def ttml_burnin(dev, tmp, start, finish, peak):
    """The same with ttmlrender, a TTML document pushed a tick."""
    import numpy as np
    from gstreamer_tpu_torch.core.buffer import Buffer
    w, h, n, b = TS_TTML
    dur = 10**9 // CONT_FPS
    pushes = {"txt": [Buffer(data=np.frombuffer(ts_ttml(k), np.uint8),
                             pts=k * b * dur) for k in range(n // b)]}
    desc = (f"videotestsrc num-buffers={n} ! video/x-raw,format=I420,width="
            f"{w},height={h},framerate={CONT_FPS}/1 ! ttmlrender name=o "
            f"font-size=36 ! {CONT_RGB} appsrc name=txt caps=application/"
            "ttml+xml ! o.")
    ts_burnin_run("ttml_burnin", desc, TS_TTML, dev, start, finish, peak,
                  pushes)


def mjpeg_multipart_camera(seed, dev, tmp, start, finish, peak):
    """Phase 20's panning camera (RR_CAM's 1080p JPEGs, jpegenc on the
    card) written by multipartmux, then multipartdemux ! jpegdec ! RGB
    224x224 at batch 16 (yscale_hv once a tick): equal to multifilesrc's
    reference of the same JPEGs; the demuxer's parts stay host bytes."""
    from gstreamer_tpu_torch.elements import image_codecs
    from gstreamer_tpu_torch.elements.multipart import parse_multipart
    w, h, n, b = RR_CAM
    jdir, jpgs = rr_jpegs(seed, dev, tmp)
    mp = os.path.join(tmp, "cam.mjpeg")
    start("multipartmux")
    # multifilesrc negotiates application/octet-stream with a muxer whose
    # pads take ANY caps (in both packages): the capsfilter names the parts'
    ts_run(f"multifilesrc location={jdir}/cam_%05d.jpg caps=image/jpeg,"
           f"framerate={CONT_FPS}/1 ! image/jpeg ! multipartmux "
           f"boundary=camera ! filesink location={mp}", dev)
    finish("multipartmux", {})
    with open(mp, "rb") as f:
        boundary, parts = parse_multipart(f.read())
    require(boundary == "camera" and [p for _m, p in parts] == jpgs
            and {m for m, _p in parts} == {"image/jpeg"},
            "multipartmux: the file's parts are not the camera's JPEGs")
    start("multifilesrc ! jpegdec")
    ref = rr_rgb_ref(jdir, dev)
    finish("multifilesrc ! jpegdec", {"yscale_hv": -(-n // b)})
    desc = (f"multipartdemux name=d location={mp} ! jpegdec ! {rr_caps(w, h)}"
            f" ! {CONT_RGB}")
    pipe, out, r = codec_path(
        "mjpeg_multipart_camera", desc, b, dev, start, finish, peak,
        lambda fed: {"yscale_hv": sum(1 for f in fed if f)},
        [(image_codecs.JpegDec, "_decode_all")])
    require(cont_equal(cont_joined(out["v"]), ref),
            "mjpeg_multipart_camera: the frames differ from multifilesrc's")
    require(pipe.get_by_name("d") in pipe._host_fed,
            "mjpeg_multipart_camera: multipartdemux's parts were staged")
    fed, secs = r["fed"][1:], r["tick_secs"][1:]
    print(f"e2e mjpeg_multipart_camera: {n} {w}x{h} JPEGs ({len(parts)} "
          f"parts) to RGB 224x224 == multifilesrc's, "
          f"{sum(fed) / max(sum(secs), 1e-9):.1f} frames/s over ticks 2.."
          f"{r['ticks']}, jpegdec {r['decode'] / n * 1e3:.2f} host ms a "
          f"frame; device busy {r['busy']:.3f} ms and idle share "
          f"{r['idle']:.3f} of a {r['wall']:.3f} ms tick (traced); "
          f"{r['h2d'] / 2**20:.3f} MiB H2D a tick; launches {r['launches']}")


def ts_flac_pcm(path, d):
    import numpy as np
    samples = ts_run(f"flacdec location={path} ! appsink name=a", d)[0]
    return np.concatenate([s.buffer.data.cpu().numpy() for s in samples])


def ts_vorbis_packets(path):
    from gstreamer_tpu_torch.elements.ogg import parse_ogg_pages
    with open(path, "rb") as f:
        return [p for _s, _g, pkts in parse_ogg_pages(f.read())
                for p in pkts]


def ts_tag_results(files, tmp, d):
    """The tag writers and readers on the committed vectors, on `d`: the
    tagged files' and payloads' sha256 with the tag messages (id3v2mux then
    id3demux on the MP3, apev2mux then apedemux), flactag's file and the
    PCM flacdec gives back, vorbistag's packets with vorbisparse's rate and
    channels, and the discoverer's report of every committed vector (its
    path left out).  Plain data, as ``digests.json`` keeps it."""
    import json

    import numpy as np
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.utils.discoverer import Discoverer
    mp3, ogg, flac = (files[n] for n in TS_FILES[:3])
    out = {}
    id3 = os.path.join(tmp, "tagged.mp3")
    ts_run(f"filesrc location={mp3} ! mpegaudioparse ! taginject tags="
           f"\"{TS_ID3_TAGS}\" ! id3v2mux ! filesink location={id3}", d)
    samples, tags, _ = ts_run(f"id3demux name=d location={id3} ! appsink "
                              "name=a", d)
    out["id3"] = {"file": ts_file_sha(id3), "payload": ts_sha(
        [s.buffer.data for s in samples]), "tags": tags}
    ape = os.path.join(tmp, "tagged.ape.mp3")
    ts_run(f"filesrc location={mp3} ! apev2mux tags=\"{TS_APE_TAGS}\" ! "
           f"filesink location={ape}", d)
    samples, tags, _ = ts_run(f"apedemux name=d location={ape} ! appsink "
                              "name=a", d)
    out["ape"] = {"file": ts_file_sha(ape), "payload": ts_sha(
        [s.buffer.data for s in samples]), "tags": tags}
    require(out["id3"]["payload"] == out["ape"]["payload"]
            == ts_file_sha(mp3), "id3demux / apedemux: the payload is not "
            "the MP3 file")
    tagged = os.path.join(tmp, "tagged.flac")
    ts_run(f"filesrc location={flac} ! audio/x-flac ! flactag tags="
           f"\"{TS_XIPH_TAGS}\" ! filesink location={tagged}", d)
    pcm = ts_flac_pcm(tagged, d)
    require(np.array_equal(pcm, ts_flac_pcm(flac, d)),
            "flactag: flacdec's PCM of the tagged file differs from the "
            "untagged file's")
    out["flac"] = {"file": ts_file_sha(tagged), "pcm": ts_sha(pcm),
                   "frames": int(pcm.shape[0])}
    pkts = ts_vorbis_packets(ogg)
    pushes = {"in": [Buffer(data=[np.frombuffer(p, np.uint8)
                                  for p in pkts[k:k + 16]], pts=k,
                            batch=len(pkts[k:k + 16]))
                     for k in range(0, len(pkts), 16)]}
    samples, _, pipe = ts_run(
        f"appsrc name=in caps=audio/x-vorbis ! vorbisparse name=p ! "
        f"vorbistag tags=\"{TS_XIPH_TAGS}\" ! appsink name=a", d,
        pushes=pushes)
    p = pipe.get_by_name("p")
    out["vorbis"] = {"packets": ts_sha([s.buffer.data for s in samples]),
                     "rate": p.rate, "channels": p.channels,
                     "count": sum(s.buffer.batch for s in samples)}
    disc = {}
    for name in sorted(os.listdir(CODEC_DIR)):
        if name.endswith((".py", ".json")) or not os.path.isfile(
                os.path.join(CODEC_DIR, name)):
            continue
        info = Discoverer().discover(os.path.join(CODEC_DIR, name))
        disc[name] = [info.duration_ns, [
            [s.kind, None if s.caps is None else str(s.caps), s.width,
             s.height, None if s.fps is None else str(s.fps), s.rate,
             s.channels, s.format] for s in info.streams]]
    out["discoverer"] = disc
    return json.loads(json.dumps(out))


def tags_roundtrip(dev, files, tmp, start, finish, dig):
    """ts_tag_results on the card's pipelines equal the CPU box's digests;
    the PCM id3demux ! mpegaudioparse ! mpg123audiodec gives within the JAX
    package's MP3 digest."""
    import numpy as np
    start("tags_roundtrip")
    t0 = time.perf_counter()
    got = ts_tag_results(files, tmp, dev)
    secs = time.perf_counter() - t0
    finish("tags_roundtrip", {})
    want = dig["tags_subs"]
    for k in ("id3", "ape", "flac", "vorbis", "discoverer"):
        require(got[k] == want[k], f"tags_roundtrip: {k} differs from the "
                f"CPU box's digest: {got[k]} != {want[k]}")
    start("tags_roundtrip[mp3]")
    t1 = time.perf_counter()
    pcm = np.concatenate([s.buffer.data.cpu().numpy() for s in ts_run(
        f"id3demux location={os.path.join(tmp, 'tagged.mp3')} ! "
        "mpegaudioparse ! mpg123audiodec ! appsink name=a", dev)[0]])
    msecs = time.perf_counter() - t1
    finish("tags_roundtrip[mp3]", {})
    err = codec_pcm_check("tags_roundtrip[mp3]", pcm, dig["mp3"])
    print(f"  tags_roundtrip: id3v2mux/id3demux, apev2mux/apedemux, flactag "
          f"(flacdec's {got['flac']['frames']} frames of PCM unchanged), "
          f"vorbistag/vorbisparse ({got['vorbis']['count']} packets, "
          f"{got['vorbis']['rate']} Hz) and the discoverer on "
          f"{len(got['discoverer'])} vectors == the CPU box's digests "
          f"({secs:.2f} s); the tagged MP3's PCM within {err} of the JAX "
          f"package's digest ({msecs:.2f} s to decode)")


def transcode_raw(seed, dev, tmp, start, finish, peak):
    """uritranscodebin of a raw 1080p Matroska written by the phase to
    video/x-matroska:video/x-raw:audio/x-raw on the card: the same file as
    the CPU's transcode, read back equal to the input.  An x264enc profile
    where libavcodec has libx264; else the error both packages raise,
    printed as such, not as a pass."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch.core.element import (element_factory_make,
                                                  factory_exists)
    from gstreamer_tpu_torch.core.parse import ParseError
    w, h, n, b = TS_RAW
    planes = ct_frames(n, w, h, TS_SEED)
    samples = cont_audio(n * CONT_RATE // CONT_FPS, seed)
    src = os.path.join(tmp, "raw.mkv")
    cont_write("matroskamux", src, "I420", planes, samples, b, dev)

    def transcode(d, profile, name):
        dst = os.path.join(tmp, name)
        tb = element_factory_make("uritranscodebin", **{
            "source-uri": f"file://{src}", "dest-uri": dst,
            "profile": profile})
        tb.device = d
        return tb.transcode()
    profile = "video/x-matroska:video/x-raw:audio/x-raw"
    start("transcode_raw")
    t0 = time.perf_counter()
    dst = transcode(dev, profile, "card.mkv")
    secs = time.perf_counter() - t0
    finish("transcode_raw", {})
    require(ts_file_sha(dst) == ts_file_sha(transcode(
        torch.device("cpu"), profile, "cpu.mkv")),
        "transcode_raw: the card's file differs from the CPU's")
    v = ts_run(f"matroskademux location={dst} stream=video ! appsink name=a",
               dev)[0]
    a = ts_run(f"matroskademux location={dst} stream=audio ! appsink name=a",
               dev)[0]
    back = [np.concatenate([s.buffer.data[i].cpu().numpy() for s in v])
            for i in range(3)]
    require(all(np.array_equal(x, y) for x, y in zip(back, planes))
            and np.array_equal(np.concatenate(
                [s.buffer.data.cpu().numpy() for s in a]), samples),
            "transcode_raw: the output does not read back as the input")
    print(f"  transcode_raw: {n} {w}x{h} frames and {len(samples)} audio "
          f"frames, Matroska raw to {profile} on the card in {secs:.2f} s "
          f"== the CPU's file, read back == the input")
    coded = "video/x-matroska:video/x-h264:audio/x-raw"
    if factory_exists("x264enc"):
        from gstreamer_tpu_torch.utils.discoverer import Discoverer
        start("transcode_raw[x264enc]")
        out = transcode(dev, coded, "h264.mkv")
        finish("transcode_raw[x264enc]", {})
        kinds = {s.kind: s.format for s in
                 Discoverer().discover(out).streams}
        require(kinds.get("video") == "V_MPEG4/ISO/AVC",
                f"transcode_raw[x264enc]: the discoverer reports {kinds}")
        print(f"  transcode_raw[x264enc]: {coded}, the discoverer reports "
              f"{kinds}")
        return
    try:
        transcode(dev, coded, "h264.mkv")
    except ParseError as e:
        require("x264enc" in str(e), f"transcode_raw[x264enc]: raised {e!r}")
        print(f"  transcode_raw[x264enc]: NOT RUN, a difference of "
              f"installation: {type(e).__name__}({str(e)!r}), the error both "
              "packages raise without libavcodec's libx264")
        return
    require(False, "transcode_raw[x264enc]: ran without x264enc")


def ts_click(seed):
    """TS_BPM's click track: a seeded noise burst of 200 samples a beat."""
    import numpy as np
    rate, seconds, bpm = TS_BPM
    x = np.zeros(rate * seconds, np.float32)
    rng = np.random.default_rng(seed)
    for i in range(0, len(x), rate * 60 // bpm):
        x[i:i + 200] = rng.standard_normal(len(x[i:i + 200]))
    return x


def ts_bpm(x, d):
    import torch
    from gstreamer_tpu_torch.core.buffer import Buffer
    rate = TS_BPM[0]
    pushes = {"in": [Buffer(data=torch.from_numpy(x[k:k + rate, None]).to(d),
                            pts=k * 10**9 // rate, duration=10**9)
                     for k in range(0, len(x), rate)]}
    _, _, pipe = ts_run(
        f"appsrc name=in caps=audio/x-raw,format=F32LE,rate={rate},"
        "channels=1,layout=interleaved ! bpmdetect name=b ! appsink name=a",
        d, pushes=pushes)
    return pipe.get_by_name("b").bpm


def bpm_click(seed, dev, start, finish):
    """bpmdetect on TS_BPM's seeded click track pushed as card tensors, a
    second a push: bpm bit for bit the CPU path's."""
    import torch
    x = ts_click(seed)
    start("bpm_click")
    t0 = time.perf_counter()
    bpm = ts_bpm(x, dev)
    secs = time.perf_counter() - t0
    finish("bpm_click", {})
    ref = ts_bpm(x, torch.device("cpu"))
    require(bpm == ref, f"bpm_click: {bpm!r} on the card, {ref!r} on the CPU")
    print(f"  bpm_click: {TS_BPM[1]} s at {TS_BPM[0]} Hz, {TS_BPM[2]} beats a "
          f"minute played, bpmdetect reads {bpm!r} == the CPU path's "
          f"({secs:.2f} s)")


def ts_streams(seed):
    """Seeded bitstreams of the six framing parsers (no 00 and no FF in the
    fillers, so no start code or marker inside a payload)."""
    import struct

    import numpy as np
    from gstreamer_tpu_torch.elements.ogg import ogg_page
    rng = np.random.default_rng(seed)

    def fill(n):
        return rng.integers(1, 255, n, dtype=np.uint8).tobytes()

    def nal(t, n):
        return b"\x00\x00\x00\x01" + bytes([0, t << 3]) + fill(n)
    dirac = b"".join(b"BBCD" + bytes([c]) + struct.pack(">II", 13 + n, 0)
                     + fill(n) for c, n in ((0, 30), (8, 90), (8, 60)))
    return {
        "h263parse": b"".join(b"\x00\x00\x80" + fill(40 + 30 * k)
                              for k in range(4)),
        "h266parse": b"".join(nal(15, 12) + nal(1, 60 + k) + nal(2, 40)
                              for k in range(3)),
        "vc1parse": b"\x00\x00\x01\x0f" + fill(20) + b"".join(
            b"\x00\x00\x01\x0d" + fill(50 + k) for k in range(3)),
        "diracparse": dirac + b"BBCD\x10" + bytes(8),
        "jpeg2000parse": b"".join(b"\xff\x4f\xff\x51" + fill(60 + k)
                                  + b"\xff\xd9" for k in range(3)),
        "oggparse": b"".join(ogg_page([fill(100 + k)], 9, k, k, bos=k == 0)
                             for k in range(3))}


def ts_alone_rows(files):
    """The runs that drive each factory of the slice alone or with its pair
    on small inputs: [(factories, fn(d, tmp, seed) -> plain data)]."""
    import struct

    import numpy as np
    import torch
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.element import (element_factory_make,
                                                  factory_exists)
    w, h, n = TS_ALONE
    vcaps = (f"video/x-raw,format=I420,width={w},height={h},"
             f"framerate={CONT_FPS}/1")
    vsrc = f"videotestsrc num-buffers={n} pattern=ball ! {vcaps}"
    asrc = ("audiotestsrc num-buffers=2 samplesperbuffer=480 wave=ticks ! "
            "audio/x-raw,format=S16LE,rate=48000,channels=2")

    def blob(b, pts=0):
        return Buffer(data=np.frombuffer(b, np.uint8), pts=pts)

    def launch(desc, d, pushes=None, batch=1):
        samples, tags, _ = ts_run(desc, d, batch, pushes)
        return [(s.buffer.pts, s.buffer.batch, str(s.caps),
                 ts_sha(s.buffer.data)) for s in samples], tags

    def written(desc, d, tmp, pushes=None):
        path = os.path.join(tmp, "out.bin")
        ts_run(desc.format(loc=path), d, pushes=pushes)
        return ts_file_sha(path)

    def built(factory):
        def run(d, _tmp, _seed):
            e = element_factory_make(factory)
            e.device = d
            return {k: str(v) for k, v in e.props.items()}
        return run

    def overlay(el, caps, text):
        def run(d, _tmp, seed):
            pushes = {"t": [blob(text)]}
            return launch(f"{vsrc} ! {el} name=o ! appsink name=a appsrc "
                          f"name=t caps={caps} ! o.", d, pushes, n)
        return run

    srt = ("1\n00:00:00,000 --> 00:00:00,100\nfirst\n\n2\n00:00:00,100 --> "
           "00:00:00,300\nsecond\n").encode()
    ssa = (b"Dialogue: 0,0:00:01.00,0:00:02.00,Default,,0,0,0,,{\\i1}a{\\i0}"
           b" line\\Nbreak\n")
    ape = (b"APETAGEX" + struct.pack("<IIII", 2000, 32 + 10, 1, 0xA0000000)
           + bytes(8) + struct.pack("<II", 2, 0) + b"Title\x00Hi"
           + b"APETAGEX" + struct.pack("<IIII", 2000, 32 + 10, 1, 0x80000000)
           + bytes(8))
    id3 = (b"ID3\x04\x00\x00\x00\x00\x00\x0fTIT2\x00\x00\x00\x05\x00\x00"
           b"\x03Song")
    pkts = ts_vorbis_packets(files["vorbis_10s.ogg"])[:3]

    def tagged(d, tmp, _seed):
        out = {}
        for name, head in (("apedemux", ape), ("id3demux", id3)):
            path = os.path.join(tmp, f"{name}.bin")
            with open(path, "wb") as f:
                f.write(head + b"\xff\xfbpayload" * 8)
            out[name] = launch(f"{name} name=d location={path} ! appsink "
                               "name=a", d)
        return out

    def parsers(d, _tmp, seed):
        return {p: launch(f"appsrc name=in caps=application/octet-stream ! "
                          f"{p} ! appsink name=a", d, {"in": [blob(s)]})
                for p, s in ts_streams(seed).items()}

    def multipart(d, tmp, _seed):
        path = os.path.join(tmp, "m.mjpeg")
        ts_run(f"{vsrc} ! jpegenc ! multipartmux ! filesink location={path}",
               d)
        return ts_file_sha(path), launch(
            f"multipartdemux location={path} ! jpegdec ! {vcaps} ! appsink "
            "name=a", d)

    def uri(factory):
        def run(d, tmp, _seed):
            path = os.path.join(tmp, "in.y4m")
            ts_run(f"{vsrc} ! y4menc location={path}", d)
            return launch(f"{factory} uri=file://{path} ! appsink name=a", d)
        return run

    def transcode(factory):
        def run(d, tmp, _seed):
            src, dst = os.path.join(tmp, "in.mkv"), os.path.join(tmp, "o.mkv")
            ts_run(f"{vsrc} ! matroskamux location={src}", d)
            tb = element_factory_make(factory, **{
                "source-uri": src, "dest-uri": dst,
                "profile": "video/x-matroska:video/x-raw"})
            tb.device = d
            tb.transcode()
            return ts_file_sha(dst)
        return run

    def liveadder(d, _tmp, seed):
        x = np.random.default_rng(seed).integers(-3000, 3000, (2, 480, 2),
                                                 np.int16)
        acaps = ("audio/x-raw,format=S16LE,rate=48000,channels=2,"
                 "layout=interleaved")
        return launch(f"liveadder name=m ! appsink name=a appsrc name=x caps="
                      f"{acaps} ! m. appsrc name=y caps={acaps} ! m.", d, {
                          k: [Buffer(data=torch.from_numpy(x[i]).to(d),
                                     pts=0, duration=10**7)]
                          for i, k in enumerate("xy")})

    rows = [
        (("subparse",), lambda d, tmp, s: launch(
            "appsrc name=in caps=application/octet-stream ! subparse ! "
            "appsink name=a", d, {"in": [blob(srt)]})),
        (("encodebin",), lambda d, tmp, s: written(
            f"{asrc} ! encodebin profile=audio/x-wav location={{loc}}", d,
            tmp)),
        (("encodebin2",), lambda d, tmp, s: written(
            f"{vsrc} ! encodebin2 profile=application/x-yuv4mpeg "
            "location={loc}", d, tmp)),
        (("subtitleoverlay",), overlay("subtitleoverlay",
                                       "text/x-raw,format=utf8", b"Hi there")),
        (("ttmlrender",), overlay("ttmlrender", "application/ttml+xml",
                                  ts_ttml(0))),
        (("ttmlparse",), lambda d, tmp, s: launch(
            "appsrc name=in caps=application/ttml+xml ! ttmlparse ! appsink "
            "name=a", d, {"in": [blob(ts_ttml(1))]})),
        (("avisubtitle",), lambda d, tmp, s: launch(
            "appsrc name=in caps=application/x-subtitle-avi ! avisubtitle ! "
            "appsink name=a", d, {"in": [blob(b"GAB2\x00" + struct.pack(
                "<HI", 4, len(srt)) + srt)]})),
        (("apev2mux", "id3v2mux", "id3mux"), lambda d, tmp, s: [launch(
            f"appsrc name=in caps=audio/mpeg ! {m} tags=title=T ! appsink "
            "name=a", d, {"in": [blob(b"\xff\xfbAUDIO" * 20)]})
            for m in ("apev2mux", "id3v2mux", "id3mux")]),
        (("bpmdetect",), lambda d, tmp, s: ts_bpm(ts_click(s)[:TS_BPM[0] * 4],
                                                  d)),
        (("rtpdec",), built("rtpdec")),
        (("multipartmux", "multipartdemux"), multipart),
        (("apedemux", "id3demux"), tagged),
        (tuple(ts_streams(0)), parsers),
        (("matroskaparse",), lambda d, tmp, s: launch(
            "appsrc name=in caps=video/x-matroska ! matroskaparse ! appsink "
            "name=a", d, {"in": [blob(b"\x1aE\xdf\xa3" + bytes(range(64)))]})),
        (("vorbisparse", "vorbistag"), lambda d, tmp, s: launch(
            f"appsrc name=in caps=audio/x-vorbis ! vorbisparse ! vorbistag "
            f"tags=\"{TS_XIPH_TAGS}\" ! appsink name=a", d, {"in": [Buffer(
                data=[np.frombuffer(p, np.uint8) for p in pkts], batch=3)]})),
        (("flactag",), lambda d, tmp, s: written(
            f"filesrc location={files['tags_1s.flac']} ! audio/x-flac ! "
            f"flactag tags=\"{TS_XIPH_TAGS}\" ! filesink location={{loc}}", d,
            tmp)),
        (("id3metaparse",), lambda d, tmp, s: launch(
            "appsrc name=in caps=application/octet-stream ! id3metaparse ! "
            "appsink name=a", d, {"in": [blob(id3 + b"\xff\xfbREST")]})),
        (("ssaparse",), lambda d, tmp, s: launch(
            "appsrc name=in caps=application/x-ssa ! ssaparse ! appsink "
            "name=a", d, {"in": [blob(ssa)]})),
        (("goom",), lambda d, tmp, s: launch(
            f"{asrc} ! goom seed=3 ! video/x-raw,width={w},height={h} ! "
            "appsink name=a", d)),
        (("liveadder",), liveadder),
        (("uridecodebin3",), uri("uridecodebin3")),
        (("urisourcebin",), uri("urisourcebin")),
        (("uritranscodebin",), transcode("uritranscodebin")),
        (("transcodebin",), transcode("transcodebin"))]
    for f in ("srtclientsrc", "srtserversrc", "srtclientsink",
              "srtserversink", "rtmpsink", "rtmpsrc", "hlsdemux2",
              "dashdemux2", "mssdemux2", "dvdec", "av1dec", "dav1ddec"):
        if factory_exists(f):
            rows.append(((f,), built(f)))
    return rows


def ts_alone(counters, dev, files, seed):
    """Each factory of the slice alone on small inputs, on the card and on
    the CPU (alone_runs): the same result, no launch.  The srt* aliases
    raise at start as srtsrc and srtsink do where libsrt is missing."""
    from gstreamer_tpu_torch.core.element import element_factory_make
    from gstreamer_tpu_torch.net import srt
    rows = ts_alone_rows(files)
    alone_runs([("/".join(names), fn) for names, fn in rows], counters, dev,
               seed)
    mine = rr_factories(TS_MODULES)
    driven = {f for names, _fn in rows for f in names}
    require(not mine - driven, f"factories not driven alone: {mine - driven}")
    if not srt.available():
        for f in ("srtclientsrc", "srtserversrc", "srtclientsink",
                  "srtserversink"):
            kind = "srtsrc" if f.endswith("src") else "srtsink"
            try:
                element_factory_make(f).start()
            except RuntimeError as e:
                require(str(e) == f"{kind}: system libsrt not found",
                        f"{f}: raised {e!r}")
                continue
            require(False, f"{f}: started without libsrt")
    print(f"  tags/subs alone: the {len(mine)} factories in {len(rows)} runs "
          f"on the card == the port's CPU run, no launch; libsrt "
          f"{'present' if srt.available() else 'missing: the four srt* aliases raise at start as srtsrc and srtsink do'}")


def tags_subs_phase(seed, counters, dev):
    """Subtitles, tags and the last parsers on the card, each item with the
    launch counts zeroed just before and read just after: subtitle_burnin
    and ttml_burnin (1080p burn-in to RGB 224x224, yscale_hv once a tick,
    equal to the port's CPU run), mjpeg_multipart_camera (multipartmux /
    multipartdemux ! jpegdec of phase 20's camera, yscale_hv twice, equal to
    multifilesrc's), tags_roundtrip (host; the CPU box's digests),
    transcode_raw, bpm_click, then each factory of the slice alone.  The
    inputs compared with committed digests are the committed vectors.
    Returns {kernel: launches}."""
    import tempfile

    import PIL
    from gstreamer_tpu_torch.core.element import factory_exists
    start, finish, peak, total = phase_meters(counters, dev)
    t0 = time.perf_counter()
    print(f"tags/subs phase: Pillow {PIL.__version__} (text bitmaps: "
          f"compared within this machine); x264enc registered: "
          f"{factory_exists('x264enc')}; dvdec / av1dec registered: "
          f"{factory_exists('dvdec')} / {factory_exists('av1dec')}")
    files, dig = codec_vectors(TS_FILES)
    spent = {}

    def item(name, fn, *a):
        t1 = time.perf_counter()
        fn(*a)
        spent[name] = time.perf_counter() - t1
    with tempfile.TemporaryDirectory() as tmp:
        item("subtitle_burnin", subtitle_burnin, dev, tmp, start, finish,
             peak)
        item("ttml_burnin", ttml_burnin, dev, tmp, start, finish, peak)
        item("mjpeg_multipart_camera", mjpeg_multipart_camera, seed, dev, tmp,
             start, finish, peak)
        item("tags_roundtrip", tags_roundtrip, dev, files, tmp, start, finish,
             dig)
        item("transcode_raw", transcode_raw, seed, dev, tmp, start, finish,
             peak)
        item("bpm_click", bpm_click, seed, dev, start, finish)
        item("alone", ts_alone, counters, dev, files, seed)
    print(f"tags/subs phase: {time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in spent.items()) + ")")
    return total


# -- 25. the leaves: camerabin, msesrc, splitmux, fakevideodec, unixfd, ... --

LV_FILES = ("mp3_10s.mp3", "h265_1080p.hevc", "digests.json")
LV_MODULES = ("gstreamer_tpu_torch.mse",) + tuple(
    f"gstreamer_tpu_torch.elements.{m}" for m in (
        "shout2", "camerabin", "dsd_elements", "midi_irtsp", "splitmux",
        "aes_misc", "chromaprint", "xingmux", "bz2_elements", "ext_music",
        "de265", "gio_dv", "ogm"))
LV_CAM = (1920, 1080, 10)           # camerabin's recording: stop_capture's 10
LV_FRAG = 8                         # splitmux_mjpeg_camera: frames a fragment
LV_FAKE = (1920, 1080, 64, 16)      # fakevideodec_1080p: width, height, frames, batch
LV_UNIXFD = (1920, 1080, 32, 16)    # unixfd_camera
LV_HEVC = (1920, 1080, 8, 4)        # the committed H.265 stream, and its batch
LV_ALONE = (64, 48, 4)              # width, height, frames of a factory alone
LV_DSD = 35280                      # dsdconvert's bytes a channel: 100 ms of DSD64
LV_DEADLINE = 60.0                  # seconds a socket item's peer may take
LV_SEED = 2028                      # the host items' inputs (digests committed)
LV_KEY = "00112233445566778899aabbccddeeff"
LV_IV = "000102030405060708090a0b0c0d0e0f"
# what each library-backed factory raises where its system library is
# missing, in both packages
LV_ABSENT = {"libde265": "libde265dec: libde265 not available",
             "libgme": "gmedec: libgme not available",
             "libopenmpt": "openmptdec: libopenmpt not available",
             "libcrypto": "aes: libcrypto not available",
             "libchromaprint": "no element factory 'chromaprint'"}


def lv_libs():
    """Which of the leaves' system libraries load on this machine."""
    from gstreamer_tpu_torch.elements import aes_misc, chromaprint, de265
    from gstreamer_tpu_torch.elements import ext_music
    return {"libde265": de265.available(),
            "libgme": ext_music._get_gme() is not None,
            "libopenmpt": ext_music._get_mpt() is not None,
            "libcrypto": aes_misc.aes_available(),
            "libchromaprint": chromaprint._LIB is not None}


def lv_digest(x):
    """One sha256 of plain data (as JSON, keys sorted)."""
    import hashlib
    return hashlib.sha256(json.dumps(x, sort_keys=True, default=str)
                          .encode()).hexdigest()


def lv_socket(tmp, name):
    """A unix socket's path under `tmp`: relative to the working directory
    where the absolute one is too long for AF_UNIX."""
    path = os.path.join(tmp, name)
    return path if len(path) < 100 else os.path.relpath(path)


def lv_thread(name, fn):
    """`fn()` on a thread of its own: (thread, errors, join) where join()
    waits LV_DEADLINE and fails the item if it is still running or
    raised."""
    import threading
    errors = []

    def body():
        try:
            fn()
        except BaseException as e:          # handed to join()
            errors.append(e)
    th = threading.Thread(target=body, name=name, daemon=True)
    th.start()

    def join():
        th.join(LV_DEADLINE)
        require(not th.is_alive(), f"{name}: still running after "
                f"{LV_DEADLINE} s")
        if errors:
            raise errors[0]
    return join


def lv_samples(desc, d, pushes=None, batch=1, prepare=None):
    """`desc` to EOS on `d` (its appsrc pushes, `prepare(pipe)` first):
    appsink "a"'s samples as (pts, batch, lv_caps, sha256), with the tag and
    element messages' data."""
    from gstreamer_tpu_torch import parse_launch
    pipe = parse_launch(desc, batch=batch, device=d)
    if prepare is not None:
        prepare(pipe)
    push_all(pipe, pushes)
    pipe.run()
    s = pipe.get_by_name("a")
    msgs = [(m.type, m.data) for m in iter(pipe.bus.pop, None)
            if m.type in ("tag", "element")]
    return [(x.buffer.pts, x.buffer.batch, lv_caps(x.caps),
             ts_sha(x.buffer.data))
            for x in (drain(s) if s is not None else [])], msgs


def lv_caps(caps):
    """Caps as plain data with each structure's fields in sorted order (the
    order of str(caps) may follow a set's, which differs by process)."""
    return None if caps is None else [
        (st.name, sorted((k, str(v)) for k, v in st.fields.items()))
        for st in caps]


def lv_blob(b, pts=0):
    import numpy as np
    from gstreamer_tpu_torch.core.buffer import Buffer
    return Buffer(data=np.frombuffer(b, np.uint8), pts=pts)


def lv_attach(blob, mime="video/x-matroska"):
    """prepare(pipe): a MediaSource with `blob` appended, attached to the
    pipeline's msesrc "m", at end of stream."""
    def prepare(pipe):
        from gstreamer_tpu_torch.mse import MediaSource
        ms = MediaSource()
        ms.attach(pipe.get_by_name("m"))
        ms.add_source_buffer(mime).append_buffer(blob)
        ms.end_of_stream()
    return prepare


def lv_smf(seed):
    """A Standard MIDI File: a tempo, seeded notes, running status."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def vl(n):
        out = [n & 0x7F]
        n >>= 7
        while n:
            out.insert(0, 0x80 | (n & 0x7F))
            n >>= 7
        return bytes(out)
    trk = vl(0) + b"\xff\x51\x03" + (600000).to_bytes(3, "big")
    for k in range(16):
        note = int(rng.integers(40, 90))
        trk += vl(int(rng.integers(0, 500))) + bytes([0x90, note, 100])
        trk += vl(int(rng.integers(1, 500))) + bytes([note, 0])  # running
    trk += vl(0) + b"\xff\x2f\x00"
    return (b"MThd" + (6).to_bytes(4, "big") + (0).to_bytes(2, "big")
            + (1).to_bytes(2, "big") + (480).to_bytes(2, "big") + b"MTrk"
            + len(trk).to_bytes(4, "big") + trk)


def lv_ogm_header(kind, subtype, samples_per_unit, extra):
    import struct
    return (b"\x01" + kind + subtype + struct.pack(
        "<iqqiii", 52, 333667, samples_per_unit, 1, 65536, 16) + extra)


def lv_ogm_packet(payload, samples, keyframe=True):
    nlen = 1 if samples < 256 else 2
    b0 = ((nlen & 3) << 6) | ((nlen >> 2) << 1) | (0x08 if keyframe else 0)
    return bytes([b0]) + samples.to_bytes(nlen, "little") + payload


def lv_vgm(seed, tenths=10):
    """A VGM file for an SN76489: a seeded tone every 100 ms."""
    import struct

    import numpy as np
    rng = np.random.default_rng(seed)
    data = bytearray()
    for _ in range(tenths):
        n = int(rng.integers(100, 1000))
        data += bytes([0x50, 0x80 | (n & 0x0F), 0x50, (n >> 4) & 0x3F,
                       0x50, 0x90, 0x61]) + struct.pack("<H", 4410)
    data += b"\x66"
    hdr = bytearray(0x40)
    hdr[0:4] = b"Vgm "
    struct.pack_into("<III", hdr, 0x04, 0x3C + len(data), 0x150, 3579545)
    struct.pack_into("<I", hdr, 0x18, 4410 * tenths)
    struct.pack_into("<HB", hdr, 0x28, 0x0009, 16)
    struct.pack_into("<I", hdr, 0x34, 0x40 - 0x34)
    return bytes(hdr) + bytes(data)


def lv_mod(seed):
    """A 4-channel ProTracker MOD: one pattern of seeded notes on a square
    sample."""
    import struct

    import numpy as np
    rng = np.random.default_rng(seed)
    smp = (b"square".ljust(22, b"\x00") + struct.pack(">H", 16)
           + bytes([0, 64]) + struct.pack(">HH", 0, 16))
    empty = bytes(22) + struct.pack(">HBBHH", 0, 0, 0, 0, 1)
    head = (b"leaves".ljust(20, b"\x00") + smp + empty * 30 + bytes([1, 127])
            + bytes(128) + b"M.K.")
    pattern = bytearray(1024)
    for row in range(0, 64, 4):
        period = int(rng.choice([214, 240, 254, 285, 320, 360, 428]))
        o = row * 16
        pattern[o:o + 4] = bytes([(1 & 0xF0) | (period >> 8), period & 0xFF,
                                  (1 & 0x0F) << 4, 0])
    sample = bytes((64 if i % 16 < 8 else 192) for i in range(32))
    return head + bytes(pattern) + sample


class LvIcecast:
    """A loopback listener answering one source client as an Icecast
    server does (100 Continue for the right password): the request's
    lines but Host (its port differs by run) and the bytes that follow."""

    def __init__(self, password="hackme"):
        import socket
        self.password = password
        self.srv = socket.socket()
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(1)
        self.srv.settimeout(LV_DEADLINE)
        self.port = self.srv.getsockname()[1]
        self.lines, self.payload = [], b""
        self.join = lv_thread("icecast", self._serve)

    def _serve(self):
        import base64
        conn, _ = self.srv.accept()
        conn.settimeout(LV_DEADLINE)
        data = b""
        while b"\r\n\r\n" not in data:
            part = conn.recv(4096)
            require(part, "icecast: the client closed during its request")
            data += part
        head, _, self.payload = data.partition(b"\r\n\r\n")
        self.lines = [ln.decode() for ln in head.split(b"\r\n")
                      if not ln.startswith(b"Host:")]
        auth = base64.b64encode(f"source:{self.password}".encode()).decode()
        ok = f"Authorization: Basic {auth}" in self.lines
        conn.sendall(b"HTTP/1.1 100 Continue\r\n\r\n" if ok
                     else b"HTTP/1.1 401 Unauthorized\r\n\r\n")
        while ok and (part := conn.recv(65536)):
            self.payload += part
        conn.close()
        self.srv.close()


def lv_rows(files):
    """The runs that drive each of the 28 factories alone or with its pair
    on small inputs made from LV_SEED: [(factories, system library or None,
    fn(d, tmp) -> plain data)].  Their results on the CPU box are the
    committed digests."""
    import glob
    import io
    import struct

    import numpy as np
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.audio.dsd import FORMATS, dsd_rate_44x
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.element import element_factory_make
    w, h, n = LV_ALONE
    rng = np.random.default_rng(LV_SEED)
    vcaps = (f"video/x-raw,format=I420,width={w},height={h},"
             f"framerate={CONT_FPS}/1")
    vsrc = f"videotestsrc num-buffers={n} pattern=ball ! {vcaps}"
    octet = "appsrc name=in caps=application/octet-stream"
    dsd = rng.integers(0, 256, 2 * LV_DSD, dtype=np.uint8)
    data = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
    packed = (b"leaves " * 900)[:6000] + data

    def dsdconvert(d, _tmp):
        out = []
        pairs = [(f, ly) for f in FORMATS
                 for ly in ("interleaved", "non-interleaved")]
        for fi, li in pairs:
            for fo, lo in pairs:
                out.append(lv_samples(
                    f"appsrc name=in ! audio/x-dsd,format={fi},rate="
                    f"{dsd_rate_44x(1)},channels=2,layout={li} ! dsdconvert "
                    f"! audio/x-dsd,format={fo},layout={lo} ! appsink name=a",
                    d, {"in": [Buffer(data=dsd, pts=0)]}))
        return out

    def camerabin(d, tmp):
        out = []
        for mode, loc in ((1, "shot_%d"), (2, "clip_%d")):
            cam = element_factory_make(
                "camerabin", mode=mode, location=os.path.join(tmp, loc),
                **{"camera-source": f"videotestsrc num-buffers=1 "
                   f"pattern=ball ! {vcaps}"})
            cam.device = d
            path = cam.start_capture() if mode == 1 else (
                cam.start_capture(), cam.stop_capture())[1]
            out.append((os.path.basename(path), ts_file_sha(path)))
        return out

    def msesrc(d, tmp):
        path = os.path.join(tmp, "in.mkv")
        ts_run(f"{vsrc} ! matroskamux location={path}", d)
        with open(path, "rb") as f:
            blob = f.read()
        return lv_samples("msesrc name=m ! appsink name=a", d,
                          prepare=lv_attach(blob))

    def splitmux(d, tmp):
        pat = os.path.join(tmp, "f%05d.mov")
        pipe = parse_launch(
            f"videotestsrc num-buffers=10 pattern=gradient ! video/x-raw,"
            f"format=UYVY,width=32,height=24,framerate=5/1 ! splitmuxsink "
            f"location={pat} max-size-time=400000000", device=d)
        pipe.run()
        msgs = [(m.data["name"], os.path.basename(m.data["location"]),
                 m.data["running-time"]) for m in iter(pipe.bus.pop, None)
                if m.type == "element"]
        frags = sorted(glob.glob(os.path.join(tmp, "f*.mov")))
        return msgs, [ts_file_sha(f) for f in frags], lv_samples(
            f"splitmuxsrc location={tmp}/f*.mov ! appsink name=a", d)

    def fakevideodec(d, _tmp):
        dur = 10**9 // CONT_FPS
        return lv_samples(
            f"appsrc name=in caps=video/x-fake,width={w},height={h},"
            f"framerate={CONT_FPS}/1 ! fakevideodec ! appsink name=a", d,
            {"in": [Buffer(data=np.zeros(1, np.uint8), pts=k * 2 * dur,
                           duration=dur, batch=2) for k in range(2)]}, 2)

    def unixfd(d, tmp):
        sock = lv_socket(tmp, "u.sock")
        join = lv_thread("unixfdsink", lambda: parse_launch(
            f"{vsrc} ! unixfdsink socket-path={sock}", device=d).run())
        got = lv_samples(
            f"unixfdsrc socket-path={sock} timeout=10.0 ! rawvideoparse "
            f"format=I420 width={w} height={h} ! appsink name=a", d)
        join()
        return got

    def midiparse(d, tmp):
        path = os.path.join(tmp, "a.mid")
        with open(path, "wb") as f:
            f.write(lv_smf(LV_SEED))
        return lv_samples(f"midiparse location={path} ! appsink name=a", d,
                          batch=4)

    def irtspparse(d, _tmp):
        r = np.random.default_rng(LV_SEED + 1)
        stream = b"junk"
        for k in range(12):
            pkt = bytes([0x80, 96]) + struct.pack(">HII", k, 90 * k, 7) + \
                r.integers(0, 256, int(r.integers(10, 200)),
                           dtype=np.uint8).tobytes()
            stream += bytes([0x24, k % 2]) + struct.pack(">H", len(pkt)) + pkt
        return [lv_samples(f"{octet} ! irtspparse channel-id={c} ! appsink "
                           "name=a", d, {"in": [lv_blob(stream)]})
                for c in (0, 1)]

    def dvdemux(d, _tmp):
        frames = []
        for pal in (False, False, True):
            f = bytearray(r_bytes(144000 if pal else 120000))
            f[0:4] = b"\x1f\x07\x00" + bytes([0x80 if pal else 0x00])
            frames.append(bytes(f))
        return lv_samples(f"{octet} ! dvdemux ! appsink name=a", d,
                          {"in": [lv_blob(b"".join(frames))]})

    def r_bytes(k):
        return np.random.default_rng(LV_SEED + k).integers(
            0, 256, k, dtype=np.uint8).tobytes()

    def giostreams(d, _tmp):
        dst = io.BytesIO()

        def prepare(pipe):
            pipe.get_by_name("s").props["stream"] = io.BytesIO(packed)
            pipe.get_by_name("k").props["stream"] = dst
        lv_samples("giostreamsrc name=s blocksize=1000 ! application/"
                   "octet-stream ! giostreamsink name=k", d, prepare=prepare)
        return ts_sha(dst.getvalue()), len(dst.getvalue())

    def ogm(d, _tmp):
        r = np.random.default_rng(LV_SEED + 2)
        pay = [r.integers(1, 255, int(r.integers(20, 300)),
                          dtype=np.uint8).tobytes() for _ in range(6)]
        video = [lv_ogm_header(b"video\x00\x00\x00", b"XVID", 1,
                               struct.pack("<ii", 320, 240))] + [
            lv_ogm_packet(p, 1, k == 0) for k, p in enumerate(pay)]
        audio = [lv_ogm_header(b"audio\x00\x00\x00", b"0055", 44100,
                               struct.pack("<hhi", 2, 4, 176400))] + [
            lv_ogm_packet(p, 1152) for p in pay]
        text = [lv_ogm_header(b"text\x00\x00\x00\x00", b"\0\0\0\0", 1,
                              bytes(8))] + [
            lv_ogm_packet(b"cue %d\0\0" % k, 100 + k) for k in range(4)]
        # a parser's caps come from its header packet, so neither package
        # negotiates one in a launch string (ROADMAP.md section 3): each is
        # driven a packet at a time
        out = []
        for kind, pk in (("video", video), ("audio", audio), ("text", text)):
            e = element_factory_make(f"ogm{kind}parse")
            e.device = d
            e.start()
            got = [e.host_process(lv_blob(p, k)) for k, p in enumerate(pk)]
            out.append((lv_caps(e._caps), [None if g is None else (
                g.pts, g.batch, int(g.flags), ts_sha(g.data)) for g in got]))
        return out

    def oggaviparse(d, _tmp):
        h1, h2, h3 = b"\x01vorbis" + data[:300], b"\x03vorbis", \
            b"\x05vorbis" + data[300:700]
        first = bytes([2, 255, len(h1) - 255, len(h2)]) + h1 + h2 + h3
        return lv_samples("appsrc name=in caps=application/x-ogg-avi ! "
                          "oggaviparse ! appsink name=a", d, {"in": [
                              lv_blob(first), lv_blob(data[:50], 1)]})

    def xingmux(d, _tmp):
        return lv_samples(f"filesrc location={files['mp3_10s.mp3']} ! "
                          "mpegaudioparse ! xingmux ! appsink name=a", d)

    def aes(d, _tmp):
        key = f"aesenc key={LV_KEY} iv={LV_IV}"
        return [lv_samples(f"{octet} ! {tail} ! appsink name=a", d,
                           {"in": [lv_blob(data)]})
                for tail in (key, f"{key} ! aesdec key={LV_KEY}")]

    def bz2(d, _tmp):
        pushes = [lv_blob(packed[k:k + 2500], k) for k in range(0, 9000, 2500)]
        return [lv_samples(f"{octet} ! {tail} ! appsink name=a", d,
                           {"in": pushes})
                for tail in ("bz2enc", "bz2enc ! bz2dec ! application/"
                             "octet-stream")]

    def tone(d, _tmp):
        return lv_samples("tonegeneratesrc freq=697 freq2=1209 num-buffers=4 "
                          "! appsink name=a", d)

    def shout2send(d, _tmp):
        srv = LvIcecast()
        lv_samples(f"appsrc name=in caps=application/ogg ! shout2send "
                   f"ip=127.0.0.1 port={srv.port} mount=/leaves.ogg "
                   "streamname=Leaves genre=test", d,
                   {"in": [lv_blob(packed[k:k + 3000], k)
                           for k in range(0, 9000, 3000)]})
        srv.join()
        return srv.lines, ts_sha(srv.payload), len(srv.payload)

    def chromaprint(d, _tmp):
        got = lv_samples("audiotestsrc num-buffers=80 samplesperbuffer=4410 "
                         "wave=ticks volume=0.6 ! audio/x-raw,format=S16LE,"
                         "rate=44100,channels=1 ! chromaprint ! appsink "
                         "name=a", d)
        return got[1], len(got[0])

    def gmedec(d, _tmp):
        return lv_samples("appsrc name=in caps=audio/x-vgm ! gmedec "
                          "duration=1.0 ! appsink name=a", d,
                          {"in": [lv_blob(lv_vgm(LV_SEED))]})

    def openmptdec(d, _tmp):
        return lv_samples("appsrc name=in caps=audio/x-mod ! openmptdec ! "
                          "appsink name=a", d, {"in": [lv_blob(lv_mod(
                              LV_SEED))]})

    def libde265dec(d, _tmp):
        return lv_samples(f"filesrc location={files['h265_1080p.hevc']} ! "
                          "video/x-h265,stream-format=byte-stream ! "
                          "libde265dec ! appsink name=a", d, batch=4)

    return [
        (("dsdconvert",), None, dsdconvert),
        (("camerabin",), None, camerabin),
        (("msesrc",), None, msesrc),
        (("splitmuxsink", "splitmuxsrc"), None, splitmux),
        (("fakevideodec",), None, fakevideodec),
        (("unixfdsink", "unixfdsrc"), None, unixfd),
        (("midiparse",), None, midiparse),
        (("irtspparse",), None, irtspparse),
        (("dvdemux",), None, dvdemux),
        (("giostreamsrc", "giostreamsink"), None, giostreams),
        (("ogmvideoparse", "ogmaudioparse", "ogmtextparse"), None, ogm),
        (("oggaviparse",), None, oggaviparse),
        (("xingmux",), None, xingmux),
        (("aesenc", "aesdec"), "libcrypto", aes),
        (("bz2enc", "bz2dec"), None, bz2),
        (("tonegeneratesrc",), None, tone),
        (("shout2send",), None, shout2send),
        (("chromaprint",), "libchromaprint", chromaprint),
        (("gmedec",), "libgme", gmedec),
        (("openmptdec",), "libopenmpt", openmptdec),
        (("libde265dec",), "libde265", libde265dec)]


def lv_row_digests(files, d):
    """{row: lv_digest of its result on `d`} for every row of lv_rows (what
    ``digests.json`` keeps under leaves/rows)."""
    import tempfile
    out = {}
    for names, _lib, fn in lv_rows(files):
        with tempfile.TemporaryDirectory() as tmp:
            out["/".join(names)] = lv_digest(fn(d, tmp))
    return out


def lv_absent(name, lib, run):
    """A run whose system library is missing here: it must raise the error
    both packages raise without it, printed as such, not as a pass."""
    from gstreamer_tpu_torch.core.parse import ParseError
    want = LV_ABSENT[lib]
    try:
        run()
    except (RuntimeError, ParseError) as e:
        require(want in str(e), f"{name}: raised {e!r}, want {want!r}")
        print(f"  {name}: NOT RUN, a difference of installation: "
              f"{type(e).__name__}({str(e)!r}), the error both packages "
              f"raise without {lib}")
        return
    require(False, f"{name}: ran without {lib}")


def camerabin_mse_camera(dev, tmp, start, finish, peak):
    """camerabin mode=2 records LV_CAM's frames of a 1080p I420
    videotestsrc on the card to Matroska (its inner pipelines on the card);
    the file's bytes are appended to a MediaSource and msesrc ! RGB
    224x224 runs on the card (yscale_hv once a tick that gave frames):
    equal to the port's CPU run of the same chain and to matroskademux of
    the same file.  Then image mode writes the JPEG that jpeg_encode makes
    of the source's frame, which decodes to the frame within JPEG's
    loss."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch.codecs.jpeg import jpeg_decode, jpeg_encode
    from gstreamer_tpu_torch.core.element import element_factory_make
    w, h, n = LV_CAM
    src = (f"videotestsrc num-buffers=1 pattern=ball ! video/x-raw,format="
           f"I420,width={w},height={h},framerate=30/1")
    cam = element_factory_make("camerabin", mode=2, location=os.path.join(
        tmp, "clip_%d"), **{"camera-source": src})
    cam.device = dev
    start("camerabin[record]")
    t0 = time.perf_counter()
    cam.start_capture()
    path = cam.stop_capture()
    rec = time.perf_counter() - t0
    finish("camerabin[record]", {})
    with open(path, "rb") as f:
        blob = f.read()
    desc = f"msesrc name=m ! {CONT_RGB}"
    pipe, out, r = codec_path(
        "camerabin_mse_camera", desc, 1, dev, start, finish, peak,
        lambda fed: {"yscale_hv": sum(1 for f in fed if f)}, (),
        prepare=lv_attach(blob))
    got = cont_joined(out["v"])
    require(got is not None and got[0].shape[0] == n,
            f"camerabin_mse_camera: {0 if got is None else got[0].shape[0]}"
            f" of {n} frames")
    cpu = torch.device("cpu")
    ref = cont_joined(codec_run(desc, cpu, 1, "v", prepare=lv_attach(blob)))
    require(cont_equal(got, ref), "camerabin_mse_camera: the card's frames "
            "differ from the port's CPU run of the same chain")
    start("matroskademux")
    demux = cont_joined(codec_run(f"matroskademux location={path} stream="
                                  f"video ! {CONT_RGB}", dev, 16, "v"))
    finish("matroskademux", {"yscale_hv": -(-n // 16)})
    require(cont_equal(got, demux), "camerabin_mse_camera: msesrc's frames "
            "differ from matroskademux's of the same file")
    still = element_factory_make("camerabin", mode=1, location=os.path.join(
        tmp, "shot_%d"), **{"camera-source": src})
    still.device = dev
    start("camerabin[image]")
    jpg = still.start_capture()
    finish("camerabin[image]", {})
    frame = [p[0] for p in codec_run(f"{src} ! appsink name=a", dev)[0]
             .buffer.data]
    with open(jpg, "rb") as f:
        coded = f.read()
    require(coded == jpeg_encode(tuple(frame), w, h),
            "camerabin[image]: the JPEG is not jpeg_encode of the source's "
            "frame")
    planes, jw, jh, _sub = jpeg_decode(coded, device=dev)
    err = (planes[0].float() - frame[0].float())
    psnr = float(10 * torch.log10(255.0**2 / (err * err).mean()))
    require((jw, jh) == (w, h) and psnr > 30.0,
            f"camerabin[image]: decodes to {jw}x{jh} at {psnr:.2f} dB")
    fed = [f for f in r["fed"] if f]
    print(f"e2e camerabin_mse_camera: camerabin recorded {n} {w}x{h} frames "
          f"({len(blob) / 2**20:.1f} MiB of Matroska) in {rec:.2f} s; msesrc "
          f"! RGB 224x224 == the port's CPU run == matroskademux's, "
          f"{sum(fed) / max(r['secs'], 1e-9):.1f} frames/s over "
          f"{r['ticks']} ticks, set-up {r['setup']:.2f} s (the inner demux); "
          f"device busy {r['busy']:.3f} ms and idle share {r['idle']:.3f} of "
          f"a {r['wall']:.3f} ms tick (traced); {r['h2d'] / 2**20:.3f} MiB "
          f"H2D a tick; peak memory {r['mem']:.1f} MiB; launches "
          f"{r['launches']}; image mode: {len(coded)} bytes of JPEG == "
          f"jpeg_encode of the frame, Y at {psnr:.2f} dB")


def splitmux_mjpeg_camera(seed, dev, tmp, start, finish, peak):
    """RR_CAM's 32 camera frames through jpegenc on the card (rr_jpegs),
    read back by imagesequencesrc (a frame's duration a buffer) into
    splitmuxsink (qtmux, max-size-time LV_FRAG frames): 4 fragments with
    their opened / closed messages; then splitmuxsrc ! jpegdec ! RGB
    224x224 at batch 16 on the card (yscale_hv once a tick that gave
    frames): equal to multifilesrc's reference of the same JPEGs, the PTS
    running on across the fragments."""
    import glob

    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.elements import image_codecs
    w, h, n, b = RR_CAM
    dur = 10**9 // CONT_FPS
    jdir, jpgs = rr_jpegs(seed, dev, tmp)
    pat = os.path.join(tmp, "frag%05d.mov")
    start("splitmuxsink")
    t0 = time.perf_counter()
    wr = parse_launch(f"imagesequencesrc location={jdir}/cam_%05d.jpg "
                      f"framerate={CONT_FPS}/1 ! image/jpeg ! splitmuxsink "
                      f"location={pat} max-size-time={LV_FRAG * dur}",
                      device=dev)
    wr.run()
    wsecs = time.perf_counter() - t0
    finish("splitmuxsink", {})
    frags = sorted(glob.glob(os.path.join(tmp, "frag*.mov")))
    msgs = [(m.data["name"], m.data["location"], m.data["running-time"])
            for m in iter(wr.bus.pop, None) if m.type == "element"]
    k = n // LV_FRAG
    require(frags == [pat % i for i in range(k)] and msgs == [
        (f"splitmuxsink-fragment-{e}", pat % i, (i + (e == "closed"))
         * LV_FRAG * dur) for i in range(k) for e in ("opened", "closed")],
        f"splitmuxsink: fragments {frags}, messages {msgs}")
    start("multifilesrc ! jpegdec")
    ref = rr_rgb_ref(jdir, dev)
    finish("multifilesrc ! jpegdec", {"yscale_hv": -(-n // b)})
    desc = (f"splitmuxsrc location={tmp}/frag*.mov ! jpegdec ! "
            f"{rr_caps(w, h)} ! {CONT_RGB}")
    pipe, out, r = codec_path(
        "splitmux_mjpeg_camera", desc, b, dev, start, finish, peak,
        lambda fed: {"yscale_hv": sum(1 for f in fed if f)},
        [(image_codecs.JpegDec, "_decode_all")])
    require(cont_equal(cont_joined(out["v"]), ref),
            "splitmux_mjpeg_camera: the frames differ from multifilesrc's")
    pts = [(s.buffer.pts, s.buffer.batch) for s in out["v"]]
    require(pts[0][0] == 0 and all(
        b2[0] == a[0] + a[1] * dur for a, b2 in zip(pts, pts[1:])),
        f"splitmux_mjpeg_camera: the PTS break across the fragments: {pts}")
    fed = [f for f in r["fed"] if f]
    mib = sum(map(os.path.getsize, frags)) / 2**20
    print(f"e2e splitmux_mjpeg_camera: {n} {w}x{h} JPEGs into {k} "
          f"fragments of {LV_FRAG} ({mib:.1f} MiB, {wsecs:.2f} s to write), "
          f"splitmuxsrc ! jpegdec ! RGB "
          f"224x224 == multifilesrc's, PTS continuous ({pts}), "
          f"{sum(fed) / max(r['secs'], 1e-9):.1f} frames/s over "
          f"{r['ticks']} ticks, jpegdec {r['decode'] / n * 1e3:.2f} host ms a "
          f"frame; device busy {r['busy']:.3f} ms and idle share "
          f"{r['idle']:.3f} of a {r['wall']:.3f} ms tick (traced); "
          f"{r['h2d'] / 2**20:.3f} MiB H2D a tick; launches {r['launches']}")


def fakevideodec_1080p(dev, start, finish, peak):
    """LV_FAKE's video/x-fake buffers through fakevideodec (mid-grey I420
    made on the card) to RGB 224x224: yscale_hv once a tick, equal to the
    port's CPU run."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch.core.buffer import Buffer
    w, h, n, b = LV_FAKE
    dur = 10**9 // 30
    pushes = {"in": [Buffer(data=np.zeros(1, np.uint8), pts=k * dur,
                            duration=dur, batch=b) for k in range(0, n, b)]}
    desc = (f"appsrc name=in caps=video/x-fake,width={w},height={h},"
            f"framerate=30/1 ! fakevideodec ! {CONT_RGB}")
    pipe, out, r = codec_path("fakevideodec_1080p", desc, b, dev, start,
                              finish, peak, {"yscale_hv": n // b}, (), pushes)
    got = cont_joined(out["v"])
    ref = cont_joined(codec_run(desc, torch.device("cpu"), b, "v", pushes))
    require(got is not None and got[0].shape[0] == n and cont_equal(got, ref),
            "fakevideodec_1080p: the card's frames differ from the port's "
            "CPU run")
    require(pipe.get_by_name("in") in pipe._host_fed,
            "fakevideodec_1080p: the fake stream's bytes were staged")
    print(f"e2e fakevideodec_1080p: {n} {w}x{h} frames at batch {b} to RGB "
          f"224x224 == the port's CPU run, {n / max(r['secs'], 1e-9):.1f} "
          f"frames/s over {r['ticks']} ticks; device busy {r['busy']:.3f} ms "
          f"and idle share {r['idle']:.3f} of a {r['wall']:.3f} ms tick "
          f"(traced); {r['h2d'] / 2**20:.3f} MiB H2D a tick; peak memory "
          f"{r['mem']:.1f} MiB; launches {r['launches']}")


def unixfd_camera(dev, tmp, start, finish, peak):
    """A 1080p I420 videotestsrc on the card into unixfdsink at batch 1 (a
    record a plane), on a thread of its own (snow: a frame of its own each
    tick, made on the card, where the ball is drawn on the host frame by
    frame); unixfdsrc ! rawvideoparse !
    RGB 224x224 at batch 16 on the card (yscale_hv once a tick that gave
    frames): equal to the direct conversion of the same frames.  The
    sender is joined under LV_DEADLINE and unixfdsrc times out on a silent
    socket, so a missed accept fails the item."""
    from gstreamer_tpu_torch import parse_launch
    w, h, n, b = LV_UNIXFD
    src = (f"videotestsrc num-buffers={n} pattern=snow ! video/x-raw,format="
           f"I420,width={w},height={h},framerate={CONT_FPS}/1")
    sock = lv_socket(tmp, "camera.sock")
    join = lv_thread("unixfd_camera[sender]", lambda: parse_launch(
        f"{src} ! unixfdsink socket-path={sock}", device=dev).run())
    desc = (f"unixfdsrc socket-path={sock} timeout=10.0 ! rawvideoparse "
            f"format=I420 width={w} height={h} framerate={CONT_FPS}/1 ! "
            f"{CONT_RGB}")
    pipe, out, r = codec_path(
        "unixfd_camera", desc, b, dev, start, finish, peak,
        lambda fed: {"yscale_hv": sum(1 for f in fed if f)}, ())
    join()
    start("unixfd_camera[direct]")
    ref = cont_joined(codec_run(f"{src} ! {CONT_RGB}", dev, b, "v"))
    finish("unixfd_camera[direct]", {"yscale_hv": -(-n // b)})
    require(cont_equal(cont_joined(out["v"]), ref),
            "unixfd_camera: the frames differ from the direct conversion")
    fed = [f for f in r["fed"] if f]
    print(f"e2e unixfd_camera: {n} {w}x{h} frames over a unix socket "
          f"({3 * n} records) to RGB 224x224 == the direct conversion, "
          f"{sum(fed) / max(r['secs'], 1e-9):.1f} frames/s over "
          f"{r['ticks']} ticks ({len(fed)} gave frames); device busy "
          f"{r['busy']:.3f} ms and idle share {r['idle']:.3f} of a "
          f"{r['wall']:.3f} ms tick (traced); {r['h2d'] / 2**20:.3f} MiB H2D "
          f"a tick; launches {r['launches']}")


def hevc_de265_ingest(dev, start, finish, peak, files, dig):
    """The committed 1080p H.265 stream through libde265dec (every plane the
    JAX package's digest), then to RGB 224x224 on the card (yscale_hv once
    a tick that gave frames; the CPU box's digest).  Without libde265 both
    packages' libde265dec raise at start: printed as such."""
    import numpy as np
    from gstreamer_tpu_torch.elements import de265
    w, h, n, b = LV_HEVC
    head = (f"filesrc location={files['h265_1080p.hevc']} ! video/x-h265,"
            "stream-format=byte-stream ! libde265dec")
    desc = (f"{head} ! video/x-raw,format=I420,width={w},height={h},"
            f"framerate={CONT_FPS}/1 ! {CONT_RGB}")
    if not de265.available():
        lv_absent("hevc_de265_ingest", "libde265",
                  lambda: codec_run(desc, dev, b, "v"))
        return
    want = dig["leaves"]
    start("hevc_de265_ingest[planes]")
    t0 = time.perf_counter()
    planes = ct_planes(codec_run(f"{head} ! appsink name=a", dev, b, "a"))
    secs = time.perf_counter() - t0
    finish("hevc_de265_ingest[planes]", {})
    require([ct_sha([np.ascontiguousarray(p).tobytes() for p in f])
             for f in planes] == want["hevc_planes"],
            "hevc_de265_ingest: decoded planes differ from the JAX package's")
    pipe, out, r = codec_path(
        "hevc_de265_ingest", desc, b, dev, start, finish, peak,
        lambda fed: {"yscale_hv": sum(1 for f in fed if f)},
        [(de265.LibDe265Dec, "_drain_pics")])
    rgb = cont_joined(out["v"])
    require(rgb is not None and rgb[0].shape[0] == n
            and ts_sha(rgb) == want["hevc_rgb"],
            "hevc_de265_ingest: the RGB frames differ from the CPU box's")
    print(f"e2e hevc_de265_ingest: {n} {w}x{h} frames == the JAX package's "
          f"planes ({secs:.2f} s to decode, {n / secs:.1f} frames/s); RGB "
          f"224x224 == the CPU box's digest, {r['ticks']} ticks, libde265 "
          f"{r['decode']:.3f} host s; device busy {r['busy']:.3f} ms and idle "
          f"share {r['idle']:.3f} of a {r['wall']:.3f} ms tick (traced); "
          f"launches {r['launches']}")


def lv_alone(counters, dev, files, dig, libs):
    """Each of the 28 factories alone on small inputs (lv_rows), on the card
    and on the CPU (alone_runs): the same result, no launch; and the
    card's results equal the CPU box's digests (the host items: dsdconvert
    across every format and layout pair, xingmux on the committed MP3, the
    OGM parsers, midiparse, irtspparse, dvdemux, the gio streams, the AES
    and bz2 round trips, shout2send to a loopback listener, chromaprint,
    gmedec, openmptdec).  A row whose system library is missing prints the
    error both packages raise."""
    import tempfile
    rows = lv_rows(files)
    card, runs, absent = {}, [], []
    for names, lib, fn in rows:
        name = "/".join(names)
        if lib is not None and not libs[lib]:
            absent.append((name, lib, fn))
            continue

        def run(d, tmp, _seed, name=name, fn=fn):
            res = fn(d, tmp)
            if d == dev:
                card[name] = res
            return res
        runs.append((name, run))
    t0 = time.perf_counter()
    alone_runs(runs, counters, dev, LV_SEED)
    secs = time.perf_counter() - t0
    want = dig["leaves"]["rows"]
    for name, res in card.items():
        require(lv_digest(res) == want[name], f"{name}: the card's result "
                "differs from the CPU box's digest")
    for name, lib, fn in absent:
        with tempfile.TemporaryDirectory() as tmp:
            lv_absent(name, lib, lambda: fn(dev, tmp))
    mine = rr_factories(LV_MODULES)
    driven = {f for names, _lib, _fn in rows for f in names}
    require(not mine - driven, f"factories not driven alone: {mine - driven}")
    ran = {f for name in card for f in name.split("/")}
    print(f"  leaves alone: {len(ran)} of the {len(mine)} registered "
          f"factories in {len(card)} runs on the card == the port's CPU run "
          f"== the CPU box's digests, no launch ({secs:.1f} s)"
          + (f"; not run here: {[n for n, _l, _f in absent]}" if absent
             else ""))


def leaves_phase(seed, counters, dev):
    """The last 28 factories on the card, each item with the launch counts
    zeroed just before and read just after: camerabin_mse_camera,
    splitmux_mjpeg_camera, fakevideodec_1080p, unixfd_camera and
    hevc_de265_ingest (1080p to RGB 224x224, yscale_hv once a tick that
    gave frames), then each factory alone, held to the CPU run and to the
    CPU box's digests.  Returns {kernel: launches}."""
    import tempfile
    start, finish, peak, total = phase_meters(counters, dev)
    t0 = time.perf_counter()
    libs = lv_libs()
    print("leaves phase: system libraries " + ", ".join(
        f"{k} {'loaded' if v else 'missing'}" for k, v in libs.items()))
    files, dig = codec_vectors(LV_FILES)
    spent = {}

    def item(name, fn, *a):
        t1 = time.perf_counter()
        fn(*a)
        spent[name] = time.perf_counter() - t1
    with tempfile.TemporaryDirectory() as tmp:
        item("camerabin_mse_camera", camerabin_mse_camera, dev, tmp, start,
             finish, peak)
        item("splitmux_mjpeg_camera", splitmux_mjpeg_camera, seed, dev, tmp,
             start, finish, peak)
        item("fakevideodec_1080p", fakevideodec_1080p, dev, start, finish,
             peak)
        item("unixfd_camera", unixfd_camera, dev, tmp, start, finish, peak)
        item("hevc_de265_ingest", hevc_de265_ingest, dev, start, finish, peak,
             files, dig)
    item("alone", lv_alone, counters, dev, files, dig, libs)
    print(f"leaves phase: {time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in spent.items()) + ")")
    return total


TM_SAMPLE = (1920, 1080, 16)        # convert_sample_1080p: width, height, frames
TM_HARNESS = (1920, 1080, 4, 16)    # harness_1080p: pushes of a batch
TM_MONITOR = (1920, 1080, 64, 16)   # monitored_headline: frames, batch
TM_CLIPS = (1920, 1080, 24, 8)      # the timeline's files: frames, overlap
TM_TRACK = (384, 216, 4, 16)        # its track, the title's frames, the batch
TM_AUDIO = (48000, 2, 4800)         # timelineaudiosrc: rate, channels, blocksize
TM_FPS = 25
TM_SEED = 2029                      # the inputs whose digests are committed
TM_VECTORS = ("aac_10s.aac", "aac_10s.m4a", "anim_320x200.flc",
              "h264_1080p.ts", "h265_1080p.hevc", "heaac_10s.aac",
              "mp3_10s.mp3", "opus_10s.opus", "opus_voice_10s.opus",
              "speex_16k.spx", "tags_1s.flac", "theora_1080p.ogv",
              "theora_vorbis_1080p.mkv", "vorbis_10s.ogg", "vp8_1080p.ivf",
              "vp9_1080p.webm")
TM_FILES = TM_VECTORS + ("digests.json",)
TM_I420 = "video/x-raw,format=I420,width={w},height={h},framerate={fps}/1"
TM_RGB = "video/x-raw,format=RGB,width=224,height=224"
TM_STATS = ("videotestsrc name=src num-buffers=8 pattern=snow ! "
            "videoconvertscale name=conv ! fakesink name=sink")


def tm_mod(root, name):
    """Module `name` of the package `root` (the port's in this script; the
    vector writer passes the JAX package's, whose modules have the same
    names and signatures)."""
    import importlib
    return importlib.import_module(f"{root}.{name}")


def tm_parse(root, desc, d, batch=1):
    """`desc` through `root`'s parse_launch, on `d` (None: the package's
    own default, the JAX package having no device argument)."""
    kw = {} if d is None else {"device": d}
    return tm_mod(root, "core.parse").parse_launch(desc, batch=batch, **kw)


def tm_headline(w, h, n):
    """monitored_headline's launch string, every element named (the dot
    dump then holds no process-wide counter)."""
    caps = TM_I420.format(w=w, h=h, fps=TM_FPS)
    return (f"videotestsrc name=src pattern=snow num-buffers={n} ! "
            f"capsfilter name=in caps=\"{caps}\" ! videoconvertscale "
            f"name=conv add-borders=false ! capsfilter name=out "
            f"caps=\"{TM_RGB}\" ! appsink name=a")


def tm_stdout(fn, *a):
    """fn(*a)'s return value and what it printed."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*a)
    return rc, buf.getvalue()


def tm_timecode(root, d, tmp):
    """VideoTimeCode from seeded frame counts and the minute edges, at five
    rates, drop-frame where the rate has it: string, frames since the daily
    jam, nanoseconds, validity, the string parsed back, the increment."""
    import numpy as np
    tc = tm_mod(root, "video.timecode")
    frac = tm_mod(root, "core.value").Fraction
    rng = np.random.default_rng(TM_SEED)
    out = []
    for (num, den), drop in (((30, 1), False), ((25, 1), False),
                             ((30000, 1001), True), ((60000, 1001), True),
                             ((24000, 1001), False)):
        fps = frac(num, den)
        flags = tc.TimeCodeFlags.DROP_FRAME if drop else 0
        day = 24 * 3600 * (-(-num // den)) - (
            (num // 1000) // 15 * 24 * 54 if drop else 0)
        counts = [0, 1, 1799, 1800, 1801, 17981, 17982, 17983, day - 1] + [
            int(x) for x in rng.integers(0, day, 24)]
        for n in counts:
            t = tc.VideoTimeCode.from_frames(n, fps, flags)
            s = t.to_string()
            back = tc.VideoTimeCode.from_string(s, fps)
            out.append([n, s, t.frames_since_daily_jam(), t.to_ns(),
                        t.is_valid(), back.frames_since_daily_jam(),
                        t.increment().to_string()])
    return out


def tm_anc(root, d, tmp):
    """Seeded ancillary packets encoded into v210 (10-bit) and UYVY (8-bit)
    lines at SD and HD widths, component and composite, until the line is
    full; each line's bytes and what the parser reads back, also from the
    line with one payload byte flipped."""
    import hashlib

    import numpy as np
    anc = tm_mod(root, "video.anc")
    rng = np.random.default_rng(TM_SEED + 1)
    out = []
    for fmt in ("v210", "UYVY"):
        for width in (720, 1920):
            for composite in (False, True):
                enc = anc.VideoVBIEncoder(fmt, width)
                added = []
                while True:
                    did, sdid = (int(x) for x in rng.integers(1, 255, 2))
                    data = rng.integers(0, 256, int(rng.integers(1, 40)),
                                        dtype=np.uint8).tobytes()
                    if not enc.add_ancillary(composite, did, sdid, data):
                        break
                    added.append([did, sdid, data.hex()])
                line = enc.write_line()
                bad = bytearray(line)
                bad[len(line) // 3] ^= 0x04
                got = []
                for ln in (line, bytes(bad)):
                    par = anc.VideoVBIParser(fmt, width)
                    par.add_line(ln)
                    got.append([[a.DID, a.SDID_block_number, a.data.hex()]
                                for a in par.get_ancillaries()])
                out.append([fmt, width, composite, len(added),
                            hashlib.sha256(line).hexdigest(),
                            got[0] == added, got[1]])
    caps = tm_mod(root, "core.caps").Caps
    out.append([[str(anc.caption_type_to_caps(t)),
                 int(anc.caption_type_from_caps(anc.caption_type_to_caps(t)))]
                for t in (1, 2, 3, 4)])
    out.append(int(anc.caption_type_from_caps(caps.from_string(
        "video/x-raw, format=I420"))))
    return out


def tm_multiview(root, d, tmp):
    """Every mode's caps string and back, the half-aspect guess over a grid
    of sizes and pixel aspects, and the geometry of every change of
    packing with and without HALF_ASPECT."""
    mv = tm_mod(root, "video.multiview")
    modes = list(mv.MultiviewMode)
    out = [[int(m), mv.mode_to_caps_string(m)] for m in modes]
    out.append([int(mv.mode_from_caps_string(s)) for s in (
        "mono", "side-by-side", "checkerboard", "separated", "bogus")])
    out.append([mv.guess_half_aspect(m, w, h, pn, pd) for m in modes
                for w, h in ((1920, 1080), (3840, 1080), (1920, 2160),
                             (1280, 1024), (4096, 858))
                for pn, pd in ((1, 1), (2, 1), (1, 2), (4, 3))])
    half = mv.MultiviewFlags.HALF_ASPECT
    out.append([list(mv.change_mode_geometry(1920, 1080, (1, 1), a, fa, b,
                                             fb))
                for a in modes for b in modes
                for fa in (mv.MultiviewFlags.NONE, half)
                for fb in (mv.MultiviewFlags.NONE, half)])
    return out


def tm_dma(root, d, tmp):
    """The DRM fourcc and modifier of every format the table maps and of
    some it does not, mapped back, and the string forms both ways."""
    dma = tm_mod(root, "video.dma")
    fmts = sorted(dma._FORMAT_MAP) + ["I420A", "AYUV64", "bogus"]
    out = []
    for f in fmts:
        code, mod = dma.dma_drm_fourcc_from_format(f)
        s = dma.dma_drm_fourcc_to_string(code, mod)
        out.append([f, code, mod, dma.dma_drm_fourcc_to_format(code, mod), s,
                    list(dma.dma_drm_fourcc_from_string(s))])
    out.append([list(dma.dma_drm_fourcc_from_string(s)) for s in (
        "NV12", "NV12:0x0100000000000001", "R16:BE", "YU12:0x0",
        "AB24:0x0b00000000010001")])
    return out


def tm_iec61937(root, d, tmp):
    """An IEC 61937 burst of every stream type on seeded payloads (AC-3,
    E-AC-3, DTS types I-III, MPEG-1/2 layers, AAC with 1, 2 and 4 raw data
    blocks), little- and big-endian, with the frame sizes; and the payloads
    each refuses."""
    import hashlib

    import numpy as np
    iec = tm_mod(root, "audio.iec61937")
    rng = np.random.default_rng(TM_SEED + 2)

    def raw(n, byte6=None, byte5=None):
        b = bytearray(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
        if byte5 is not None:
            b[5] = byte5
        if byte6 is not None:
            b[6] = (b[6] & ~3) | byte6
        return bytes(b)
    cases = [("ac3", {}, raw(1792, byte5=3)), ("ac3", {}, raw(5)),
             ("eac3", {}, raw(6001)),
             ("dts", {"frame-size": 1006, "block-size": 512}, raw(1006)),
             ("dts", {"frame-size": 2012, "block-size": 1024}, raw(2012)),
             ("dts", {"frame-size": 4000, "block-size": 512}, raw(4000)),
             ("mpeg", {"mpegaudioversion": 1, "layer": 1}, raw(384)),
             ("mpeg", {"mpegaudioversion": 1, "layer": 3}, raw(417)),
             ("mpeg", {"mpegaudioversion": 2, "layer": 2, "rate": 11025},
              raw(1000)),
             ("mpeg", {"mpegaudioversion": 2, "layer": 3, "rate": 8000},
              raw(144)),
             ("mpeg", {"mpegaudioversion": 3, "layer": 3}, raw(100)),
             ("aac", {}, raw(371, byte6=0)), ("aac", {}, raw(700, byte6=1)),
             ("mpeg4-aac", {}, raw(2001, byte6=3)),
             ("aac", {}, raw(900, byte6=2)), ("aac", {}, raw(5000, byte6=0)),
             ("opus", {}, raw(100))]
    out = []
    for kind, fields, src in cases:
        row = [kind, sorted(fields.items()), iec.frame_size(kind, fields)]
        for be in (False, True):
            burst = iec.payload(src, kind, fields, big_endian_out=be)
            row.append(None if burst is None else
                       [len(burst), hashlib.sha256(burst).hexdigest()])
        out.append(row)
    return out


def tm_streamalign(root, d, tmp):
    """AudioStreamAlign over a seeded timeline at 48 kHz: jitter inside the
    threshold absorbed, a short drift waited out, a long drift and a jump
    resynced, missing timestamps, a discont marked; every (pts, duration,
    discont)."""
    import numpy as np
    al = tm_mod(root, "audio.streamalign")
    rng = np.random.default_rng(TM_SEED + 3)
    a = al.AudioStreamAlign(rate=48000)
    out, t = [], 0
    for k in range(120):
        n = int(rng.integers(256, 4801))
        if k == 40:
            t += 3_000_000_000                  # a jump: resync
        jitter = int(rng.integers(-20_000_000, 20_000_001))
        if 60 <= k < 90:
            jitter += 60_000_000                # drift past the threshold
        pts = None if k % 17 == 5 else t + jitter
        if k == 100:
            a.mark_discont()
        out.append(list(a.process(pts, n)))
        t += n * 1_000_000_000 // 48000
    return out


def tm_codecbase(root, d, tmp):
    """A VideoDecoderBase subclass that holds every second frame for one
    buffer (a reorder) and a VideoEncoderBase that reverses bytes: the
    frames they give, in order, with their numbers and timestamps, and
    what drain() gives at the end."""
    cb = tm_mod(root, "video.codecbase")
    buf_cls = tm_mod(root, "core.buffer").Buffer

    def handle(self, frame):
        frame.output_data = bytes(frame.input_data)[::-1]
        if frame.system_frame_number % 2:
            self._pending.append(frame)
            return None
        held, self._pending = self._pending, []
        return held[0] if held else frame
    dec = type("TmReorder", (cb.VideoDecoderBase,), {
        "FACTORY": "tmreorder", "handle_frame": handle})()
    enc = type("TmReverse", (cb.VideoEncoderBase,), {
        "FACTORY": "tmreverse", "handle_frame": lambda self, f: (
            setattr(f, "output_data", bytes(f.input_data)[::-1]) or f)})()
    out = []
    for el in (dec, enc):
        el.start()
        for k in range(5):
            data = [bytes([k, i, 7]) for i in range(3)]
            b = el.host_process(buf_cls(data=data, pts=k * 3000,
                                        duration=1000, batch=3))
            out.append(None if b is None else
                       [b.pts, b.batch, [x.hex() for x in b.data]])
        out.append([[f.system_frame_number, f.pts, f.output_data.hex()]
                    for f in el.drain()])
    return out


def tm_typefind(root, d, tmp, files):
    """tools.typefind over the committed vectors: its exit code and output,
    the directory left out."""
    tf = tm_mod(root, "tools.typefind")
    paths = [files[n] for n in TM_VECTORS]
    rc, text = tm_stdout(tf.main, paths)
    return [rc, text.replace(os.path.dirname(paths[0]) + os.sep, "")]


def tm_stats_run(root, d):
    """tools.stats on TM_STATS (on `d`; None for the package's default)
    with its three tracers: its exit code and reports' JSON.  The tracers
    are reset before and after, and GTPU_TRACERS set for the run only."""
    st = tm_mod(root, "tools.stats")
    hooks = tm_mod(root, "core.tracer").hooks

    def reset():
        hooks.handlers.clear()
        hooks.tracers.clear()
        hooks._env_loaded = False
    argv = [TM_STATS] + (["--cpu"] if d is not None and d.type == "cpu"
                         else [])
    with switches(GTPU_TRACERS=None):
        reset()
        try:
            rc, text = tm_stdout(st.main, argv)
        finally:
            reset()
    return rc, json.loads(text)


def tm_stats(root, d, tmp):
    """What tm_stats_run reports that a run fixes: the tracers, each
    element's count of buffers and frames, the ticks."""
    rc, rep = tm_stats_run(root, d)
    return [rc, sorted(rep), sorted((k, v["n"]) for k, v in
                                    rep["latency"].items()),
            rep["stats"], rep["rusage"]["ticks"]]


def tm_sort_caps(pipe):
    """Sort the fields of every negotiated caps structure of `pipe`: their
    order may follow a set's, which differs by process, so a dump of the
    sorted caps is the same in any process."""
    for e in pipe.iterate_elements():
        for p in e.pads:
            for st in (p.caps or ()):
                st.fields = dict(sorted(st.fields.items()))


def tm_dotsviewer(root, d, tmp):
    """tools.dotsviewer over the dot dump of monitored_headline's pipeline
    (negotiated at its full size): the dot text, the page and the CLI's
    line."""
    w, h, n, b = TM_MONITOR
    dv = tm_mod(root, "tools.dotsviewer")
    pipe = tm_parse(root, tm_headline(w, h, n), d, b)
    pipe.negotiate()
    tm_sort_caps(pipe)
    text = tm_mod(root, "utils.dot").pipeline_to_dot(pipe)
    dots = os.path.join(tmp, "dots")
    os.makedirs(dots)
    with open(os.path.join(dots, "monitored_headline.dot"), "w") as f:
        f.write(text)
    page = os.path.join(tmp, "page.html")
    rc, said = tm_stdout(dv.main, [dots, "-o", page])
    with open(page) as f:
        html = f.read()
    return [rc, said.replace(page, "page.html"), text, html]


def tm_log_text(seed):
    """A seeded log in both dialects the viewer reads: the framework's
    (``... LEVEL gtpu.<category>: message``) and the reference's
    (GST_DEBUG_FILE), with multi-line messages folded into their entry."""
    import numpy as np
    rng = np.random.default_rng(seed)
    levels = ["ERROR", "WARNING", "Level 29", "INFO", "DEBUG", "Level 9",
              "Level 8", "CRITICAL"]
    gst = ["ERROR", "WARN", "FIXME", "INFO", "DEBUG", "LOG", "TRACE"]
    cats = ["pipeline", "converter", "parse", "tracer.stats", "net.rtp"]
    lines = []
    for k in range(160):
        ms = 100 * k + int(rng.integers(0, 100))
        cat = cats[int(rng.integers(0, len(cats)))]
        word = "".join(chr(97 + int(c)) for c in rng.integers(0, 26, 6))
        if k % 3:
            lines.append(f"2026-01-02 03:04:{ms // 1000 % 60:02d},"
                         f"{ms % 1000:03d} {levels[k % len(levels)]} "
                         f"gtpu.{cat}: tick {k} {word}")
        else:
            lines.append(f"0:00:{ms // 1000:02d}.{ms % 1000:03d}000000 "
                         f"4242 0x7f00dead {gst[k % len(gst)]:<7} "
                         f"{cat.split('.')[0]} gst{cat}.c:{k}:fn_{word}:"
                         f"<elem{k % 4}> buffer {k} {word}")
        if k % 11 == 0:
            lines.append(f"    continued {word}")
    return "\n".join(lines) + "\n"


def tm_logviewer(root, d, tmp):
    """tools.logviewer over a log this phase writes (tm_log_text): the
    terminal view at three filters and the HTML page."""
    lv = tm_mod(root, "tools.logviewer")
    log = os.path.join(tmp, "run.log")
    with open(log, "w") as f:
        f.write(tm_log_text(TM_SEED + 4))
    out = []
    for args in ([], ["--level", "INFO"], ["--category", "net*", "--grep",
                                            "tick"]):
        out.append(list(tm_stdout(lv.main, [log] + args)))
    page = os.path.join(tmp, "view.html")
    rc, said = tm_stdout(lv.main, [log, "-o", page])
    with open(page) as f:
        out.append([rc, said.replace(page, "view.html"), f.read()])
    return out


def tm_rows(files):
    """[(name, fn(root, d, tmp))] of the phase's host items; each result is
    plain data, and ``digests.json`` keeps its lv_digest from the JAX
    package (tail/rows)."""
    return [("timecode", tm_timecode), ("anc", tm_anc),
            ("multiview", tm_multiview), ("dma", tm_dma),
            ("iec61937", tm_iec61937), ("streamalign", tm_streamalign),
            ("codecbase", tm_codecbase),
            ("typefind", lambda root, d, tmp: tm_typefind(root, d, tmp,
                                                          files)),
            ("stats", tm_stats), ("dotsviewer", tm_dotsviewer),
            ("logviewer", tm_logviewer)]


def tm_sample_frames():
    """convert_sample_1080p's seeded I420 frames (ct_frames)."""
    w, h, n = TM_SAMPLE
    return ct_frames(n, w, h, TM_SEED)


def tm_sample_run(root, planes, d):
    """`root`'s convert_sample of the frames, 1080p I420 to RGB 224x224 at
    the converter's default (cubic) configuration, in one call."""
    w, h, _n = TM_SAMPLE
    kw = {} if d is None else {"device": d}
    return tm_mod(root, "video.hdr").convert_sample(
        planes, TM_I420.format(w=w, h=h, fps=TM_FPS), TM_RGB, **kw)


def convert_sample_1080p(dev, start, finish, want):
    """TM_SAMPLE's frames through convert_sample on the card in one call:
    yscale_hv once and chroma420_scale twice (the cubic route), equal to
    the port's CPU run and to the JAX package's digest."""
    import torch
    planes = tm_sample_frames()
    start("convert_sample_1080p")
    t0 = time.perf_counter()
    out = tm_sample_run("gstreamer_tpu_torch", planes, dev)
    sync(dev)
    secs = time.perf_counter() - t0
    counts = finish("convert_sample_1080p",
                    {"yscale_hv": 1, "chroma420_scale": 2})
    cpu = tm_sample_run("gstreamer_tpu_torch", planes, torch.device("cpu"))
    require(len(out) == 3 and all(o.device.type == dev.type for o in out),
            "convert_sample_1080p: the planes are not on the card")
    require(cont_equal(tuple(o.cpu() for o in out), tuple(cpu)),
            "convert_sample_1080p: the card's planes differ from the port's "
            "CPU run")
    require(ts_sha(out) == want,
            "convert_sample_1080p: the planes differ from the JAX package's "
            "convert_sample (digest)")
    n = planes[0].shape[0]
    print(f"e2e convert_sample_1080p: {n} 1080p I420 frames to RGB 224x224 "
          f"in one call == the port's CPU run == the JAX package's digest, "
          f"{secs * 1e3:.1f} ms (host clock, the upload included); launches "
          f"{counts}")


def tm_direct(planes, dev):
    """The direct conversion of 1080p I420 planes to RGB 224x224 with
    videoconvertscale's configuration (linear, 2 taps)."""
    from gstreamer_tpu_torch import VideoConverter, VideoInfo
    w, h = planes[0].shape[-1], planes[0].shape[-2]
    return VideoConverter(VideoInfo(format="I420", width=w, height=h),
                          VideoInfo(format="RGB", width=224, height=224),
                          CONFIGS["linear2"], device=dev).convert(planes)


def harness_1080p(dev, start, finish, peak):
    """Harness("videoconvertscale add-borders=false") on the card, its caps
    1080p I420 to RGB 224x224: TM_HARNESS's pushes of snow frames made on
    the card, then one frame of a videotestsrc src sub-harness
    (push_from_src): yscale_hv once a push, every output on the card and
    equal to the direct conversion of the same frames."""
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.check import Harness
    w, h, pushes, b = TM_HARNESS
    caps = TM_I420.format(w=w, h=h, fps=TM_FPS)
    src = parse_launch(f"videotestsrc pattern=snow num-buffers={pushes * b} "
                       f"! {caps} ! appsink name=a", batch=b, device=dev)
    src.run()
    frames = [s.buffer for s in drain(src.get_by_name("a"))]
    require(len(frames) == pushes and all(
        f.data[0].device.type == dev.type for f in frames),
        "harness_1080p: the snow frames are not on the card")
    hns = Harness("videoconvertscale add-borders=false", device=dev)
    hns.set_caps(caps, TM_RGB)
    base = start("harness_1080p")
    t0 = time.perf_counter()
    outs = [hns.push(f.data, pts=f.pts, duration=f.duration, batch=f.batch)
            for f in frames]
    sync(dev)
    secs = time.perf_counter() - t0
    mem = peak(base)
    counts = finish("harness_1080p", {"yscale_hv": pushes})
    for f, o in zip(frames, outs):
        require(o is not None and o[0].device.type == dev.type
                and tuple(o[0].shape) == (b, 224, 224),
                "harness_1080p: a push gave no output on the card")
        require(cont_equal(tuple(o), tuple(tm_direct(f.data, dev))),
                "harness_1080p: a push differs from the direct conversion")
    hns.add_src(f"videotestsrc pattern=snow ! {caps}")
    start("harness_1080p[src]")
    one = hns.push_from_src()
    finish("harness_1080p[src]", {"yscale_hv": 1})
    require(hns.src_harness.device == hns.device == dev,
            "harness_1080p: the src sub-harness is not on the harness's "
            "device")
    require(one is not None and one.batch == 1, "harness_1080p: "
            "push_from_src gave nothing")
    ref = parse_launch(f"videotestsrc pattern=snow num-buffers=1 ! {caps} ! "
                       "appsink name=a", device=dev)
    ref.run()
    first = drain(ref.get_by_name("a"))[0].buffer.data
    require(cont_equal(tuple(one.data),
                                           tuple(tm_direct(first, dev))),
            "harness_1080p: push_from_src differs from the direct conversion")
    print(f"e2e harness_1080p: {pushes} pushes of {b} 1080p snow frames "
          f"(made on the card) through the harness to RGB 224x224 == the "
          f"direct conversion, {pushes * b / max(secs, 1e-9):.1f} frames/s; "
          f"push_from_src of a videotestsrc sub-harness == the direct "
          f"conversion; peak memory {mem:.1f} MiB; launches {counts} and "
          f"yscale_hv 1 for push_from_src")


def tm_monitored(d, n_ticks=None):
    """monitored_headline's run on `d` under PipelineMonitor and a
    Scenario (a forward seek at tick 1, a property set at tick 2, EOS
    injected at tick 3): (report, [samples' pts], frames, ticks that gave
    frames, pipeline)."""
    from gstreamer_tpu_torch.validate import PipelineMonitor, Scenario
    w, h, n, b = TM_MONITOR
    dur = 10**9 // TM_FPS
    pipe = tm_parse("gstreamer_tpu_torch", tm_headline(w, h, n), d, b)
    mon = PipelineMonitor(pipe)
    fed = []
    sink = pipe.get_by_name("a")
    samples = []

    def take(p):
        got = drain(sink)
        fed.append(sum(s.buffer.batch for s in got))
        samples.extend(got)
    actions = [(1, take), (1, Scenario.seek(2 * b * dur)),
               (2, take), (2, Scenario.set_property("src", "pattern",
                                                    "snow")),
               (3, take), (3, Scenario.eos_injection())]
    Scenario(actions=actions, max_ticks=n_ticks or n).run(pipe, mon)
    take(pipe)
    rep = mon.report()
    return rep, [s.buffer.pts for s in samples], cont_joined(samples), \
        [f for f in fed if f], pipe


def monitored_headline(dev, start, finish, peak):
    """The headline launch (1080p snow to RGB 224x224 at batch 16) on the
    card under PipelineMonitor, driven by a Scenario that seeks forward,
    sets a property and injects EOS: no violation, the report equal to the
    CPU run's, the frames too; yscale_hv once a tick that gave frames."""
    import torch
    base = start("monitored_headline")
    t0 = time.perf_counter()
    rep, pts, frames, fed, pipe = tm_monitored(dev)
    sync(dev)
    secs = time.perf_counter() - t0
    mem = peak(base)
    counts = finish("monitored_headline", {"yscale_hv": len(fed)})
    require(rep == {"violations": []},
            f"monitored_headline: violations {rep}")
    crep, cpts, cframes, cfed, _p = tm_monitored(torch.device("cpu"))
    require(rep == crep and pts == cpts and fed == cfed,
            f"monitored_headline: the report, timestamps or ticks differ from "
            f"the CPU run's ({rep} {pts} {fed} / {crep} {cpts} {cfed})")
    require(cont_equal(frames, cframes), "monitored_headline: the frames "
            "differ from the CPU run's")
    b = TM_MONITOR[3]
    require(fed == [b, b, b] and pts[1] == 2 * b * (10**9 // TM_FPS),
            f"monitored_headline: ticks gave {fed} frames, pts {pts}")
    print(f"e2e monitored_headline: PipelineMonitor over 1080p snow to RGB "
          f"224x224 at batch {b} under a Scenario (seek to frame {2 * b}, "
          f"set-property, EOS at tick 3): {sum(fed)} frames in {len(fed)} "
          f"ticks, report {rep} == the CPU run's, frames and pts equal; "
          f"{secs:.2f} s (host clock); peak memory {mem:.1f} MiB; launches "
          f"{counts}")


def tm_write_clips(tmp, d):
    """The timeline's two seeded 1080p I420 Matroska files (TM_CLIPS' frames
    each, ct_frames of TM_SEED + 10 and + 11), written through matroskamux on
    `d`: their paths."""
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    w, h, n, _ov = TM_CLIPS
    dur = 10**9 // TM_FPS
    paths = []
    for k in range(2):
        planes = ct_frames(n, w, h, TM_SEED + 10 + k)
        path = os.path.join(tmp, f"clip{k}.mkv")
        pipe = parse_launch(
            f"matroskamux name=m location={path} ! fakesink appsrc name=v "
            f"caps={TM_I420.format(w=w, h=h, fps=TM_FPS)} ! m.video_0",
            batch=8, device=d)
        src = pipe.get_by_name("v")
        for j in range(0, n, 8):
            chunk = tuple(torch.from_numpy(p[j:j + 8]).to(d) for p in planes)
            src.push_buffer(Buffer(data=chunk, batch=chunk[0].shape[0],
                                   pts=j * dur, duration=dur))
        src.end_of_stream()
        pipe.run()
        paths.append(path)
    return paths


def tm_timeline(root, paths, d):
    """The timeline of timeline_crossfade_1080p in package `root`: a 16:9 RGB
    track at TM_FPS, the two files as UriClips on layer 0 overlapping by
    TM_CLIPS' overlap (the first starting after the title's frames), a
    TitleClip on layer 1 under the first frames; and an audio timeline of
    two overlapping TestClips (square waves) at 48 kHz stereo S16LE.
    Returns (video timeline, audio timeline)."""
    ed = tm_mod(root, "editing")
    frac = tm_mod(root, "core.value").Fraction
    _w, _h, n, ov = TM_CLIPS
    tw, th, title, _b = TM_TRACK
    f = 10**9 // TM_FPS
    tl = ed.Timeline(video=ed.VideoTrack(width=tw, height=th,
                                         fps=frac(TM_FPS, 1), format="RGB"))
    top, under = tl.append_layer(), tl.append_layer()
    top.add_clip(ed.UriClip(start=title * f, duration=n * f,
                            location=paths[0]))
    top.add_clip(ed.UriClip(start=(title + n - ov) * f, duration=n * f,
                            location=paths[1]))
    under.add_clip(ed.TitleClip(start=0, duration=title * f, text="TAIL",
                                background="black", font_size=20))
    rate, ch, _blk = TM_AUDIO
    atl = ed.Timeline(audio=ed.AudioTrack(rate=rate, channels=ch))
    lay = atl.append_layer()
    lay.add_clip(ed.TestClip(start=0, duration=6 * 10**8, wave="square",
                             freq=500.0, volume=0.5))
    lay.add_clip(ed.TestClip(start=4 * 10**8, duration=6 * 10**8,
                             wave="square", freq=1200.0, volume=0.25))
    return tl, atl


def tm_timeline_run(root, paths, d, kind="video"):
    """`timelinevideosrc ! appsink` (or timelineaudiosrc) over tm_timeline
    in package `root` on `d`: the samples' data joined on the host (numpy),
    and the samples' (pts, batch)."""
    import numpy as np
    import torch
    tl, atl = tm_timeline(root, paths, d)
    _tw, _th, _t, b = TM_TRACK
    blk = TM_AUDIO[2]
    desc = ("timelinevideosrc name=tl ! appsink name=a" if kind == "video"
            else f"timelineaudiosrc name=tl blocksize={blk} ! appsink name=a")
    pipe = tm_parse(root, desc, d, b if kind == "video" else 1)
    pipe.get_by_name("tl").set_property(
        "timeline", tl if kind == "video" else atl)
    pipe.run()
    got = drain(pipe.get_by_name("a"))

    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
    if kind == "video":
        data = tuple(np.concatenate([host(s.buffer.data[c]) for s in got])
                     for c in range(len(got[0].buffer.data)))
    else:
        data = np.concatenate([host(s.buffer.data) for s in got])
    return data, [(s.buffer.pts, s.buffer.batch) for s in got]


def timeline_crossfade_1080p(dev, tmp, start, finish, peak, dig):
    """tm_timeline on the card: each UriClip's sub-pipeline (matroskademux !
    videoconvertscale ! RGB 384x216 at batch 1) converts a 1080p frame
    with yscale_hv a tick, the crossfade and the stack run on the card;
    every frame equal to the port's CPU run and to the JAX package's
    digest; the audio timeline likewise."""
    import torch
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    paths = tm_write_clips(tmp, dev)
    wsecs = time.perf_counter() - t0
    _w, _h, n, ov = TM_CLIPS
    tw, th, title, b = TM_TRACK
    base = start("timeline_crossfade_1080p")
    t0 = time.perf_counter()
    frames, meta = tm_timeline_run("gstreamer_tpu_torch", paths, dev)
    sync(dev)
    secs = time.perf_counter() - t0
    mem = peak(base)
    counts = finish("timeline_crossfade_1080p", {"yscale_hv": 2 * n})
    total = title + 2 * n - ov
    require(frames[0].shape == (total, th, tw) and len(frames) == 3,
            f"timeline_crossfade_1080p: {[f.shape for f in frames]}")
    cframes, cmeta = tm_timeline_run("gstreamer_tpu_torch", paths, cpu)
    require(meta == cmeta and cont_equal(
        tuple(torch.from_numpy(f) for f in frames),
        tuple(torch.from_numpy(f) for f in cframes)),
        "timeline_crossfade_1080p: the card's frames differ from the port's "
        "CPU run")
    require(ts_sha(frames) == dig["timeline_video"],
            "timeline_crossfade_1080p: the frames differ from the JAX "
            "package's timelinevideosrc (digest)")
    start("timeline_crossfade_1080p[audio]")
    t1 = time.perf_counter()
    pcm, ameta = tm_timeline_run("gstreamer_tpu_torch", paths, dev, "audio")
    asecs = time.perf_counter() - t1
    finish("timeline_crossfade_1080p[audio]", {})
    cpcm, cameta = tm_timeline_run("gstreamer_tpu_torch", paths, cpu,
                                   "audio")
    require(ameta == cameta and pcm.dtype == cpcm.dtype
            and (pcm == cpcm).all(), "timeline_crossfade_1080p: the card's "
            "audio differs from the port's CPU run")
    require(ts_sha(pcm) == dig["timeline_audio"],
            "timeline_crossfade_1080p: the audio differs from the JAX "
            "package's timelineaudiosrc (digest)")
    print(f"e2e timeline_crossfade_1080p: two {n}-frame 1080p I420 Matroska "
          f"files ({wsecs:.2f} s to write) as UriClips overlapping by {ov} "
          f"frames under a {title}-frame TitleClip, timelinevideosrc ! RGB "
          f"{tw}x{th} at batch {b}: {total} frames == the port's CPU run == "
          f"the JAX package's digest, {total / max(secs, 1e-9):.1f} frames/s "
          f"({secs:.2f} s); peak memory {mem:.1f} MiB; launches {counts} "
          f"(yscale_hv once a clip frame); timelineaudiosrc of two "
          f"overlapping square waves: {pcm.shape[0]} frames of "
          f"{pcm.shape[1]} channels S16 == the CPU run == the digest "
          f"({asecs:.2f} s)")


def tm_alone(counters, dev, files, dig):
    """Each host item (tm_rows) on the card and on the CPU: the same
    result, no launch; the card's result the CPU box's digest (the JAX
    package's)."""
    card, runs = {}, []
    for name, fn in tm_rows(files):
        def run(d, tmp, _seed, name=name, fn=fn):
            res = fn("gstreamer_tpu_torch", d, tmp)
            if d == dev:
                card[name] = res
            return res
        runs.append((name, run))
    t0 = time.perf_counter()
    alone_runs(runs, counters, dev, TM_SEED)
    secs = time.perf_counter() - t0
    want = dig["tail"]["rows"]
    for name, res in card.items():
        require(lv_digest(res) == want[name], f"{name}: the card's result "
                "differs from the CPU box's digest (the JAX package's)")
    print(f"  tail host items: {sorted(card)} on the card == the port's CPU "
          f"run == the JAX package's digests, no launch ({secs:.1f} s); "
          f"tools.stats on the card: {card['stats']}")


def tail_modules_phase(seed, counters, dev):
    """The last 15 host modules on the card, each item with the launch
    counts zeroed just before and read just after: convert_sample_1080p
    (yscale_hv and chroma420_scale), harness_1080p, monitored_headline and
    timeline_crossfade_1080p (yscale_hv), then the host items, held to the
    CPU run and to the JAX package's digests.  The inputs come from
    TM_SEED, whose digests are committed.  Returns {kernel: launches}."""
    import tempfile
    start, finish, peak, total = phase_meters(counters, dev)
    t0 = time.perf_counter()
    files, dig = codec_vectors(TM_FILES)
    spent = {}

    def item(name, fn, *a):
        t1 = time.perf_counter()
        fn(*a)
        spent[name] = time.perf_counter() - t1
    item("convert_sample_1080p", convert_sample_1080p, dev, start, finish,
         dig["tail"]["convert_sample"])
    item("harness_1080p", harness_1080p, dev, start, finish, peak)
    item("monitored_headline", monitored_headline, dev, start, finish, peak)
    with tempfile.TemporaryDirectory() as tmp:
        item("timeline_crossfade_1080p", timeline_crossfade_1080p, dev, tmp,
             start, finish, peak, dig["tail"])
    item("alone", tm_alone, counters, dev, files, dig)
    print(f"tail modules phase: {time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in spent.items()) + ")")
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args()
    if args.batch < DEINT_BATCH:
        ap.error(f"--batch must be at least {DEINT_BATCH}: the launch paths "
                 "take their frames from the converter's batch")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    import numpy as np

    from gstreamer_tpu_torch import VideoConverter, VideoInfo
    from gstreamer_tpu_torch.device import resolve
    from gstreamer_tpu_torch.ops import _build
    from gstreamer_tpu_torch.ops import chroma420_kernel as ck
    from gstreamer_tpu_torch.ops import convert_kernel as fk
    from gstreamer_tpu_torch.ops import deint_kernel as dk
    from gstreamer_tpu_torch.ops import freeverb_kernel as fvk
    from gstreamer_tpu_torch.ops import gmm_kernel as gk
    from gstreamer_tpu_torch.ops import hscale_kernel as hk
    from gstreamer_tpu_torch.ops import scale2d_kernel as s2k
    from gstreamer_tpu_torch.ops import sgbm_kernel as sk
    from gstreamer_tpu_torch.ops import vad_kernel as vk
    from gstreamer_tpu_torch.ops import yscale_kernel as ysk

    torch.set_float32_matmul_precision("highest")   # yardstick: no TF32
    dev = resolve()
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")

    # -- build --------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {_build.SOURCES}")
    for src in _build.SOURCES:
        for line in (_build.BUILD_DIR / f"{src}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}")

    # -- inputs and converters ------------------------------------------------
    b = args.batch
    ii = VideoInfo(format="I420", width=W, height=H)
    oi = VideoInfo(format="RGB", width=OW, height=OH)
    rng = np.random.default_rng(args.seed)
    host = tuple(rng.integers(0, 256, (b,) + s, dtype=np.uint8)
                 for s in ii.plane_shapes())
    planes = tuple(torch.as_tensor(p).to(dev) for p in host)
    convs = {k: VideoConverter(ii, oi, cfg) for k, cfg in CONFIGS.items()}
    lin, cub = convs["linear2"].plan, convs["cubic"].plan
    torch.cuda.synchronize()

    # -- each kernel against its plain version, at the main path's shapes ----
    err = {"yscale_hv": 0, "chroma420_scale": 0}
    for plan in (lin, cub):
        k = ysk.yscale_hv(planes[0], plan["h_res"], plan["v_res"])
        p = ysk.yscale_hv_plain(planes[0], plan["h_res"], plan["v_res"])
        torch.cuda.synchronize()
        require(k.dtype == p.dtype == torch.int16
                and tuple(k.shape) == (b, OH, OW), "yscale_hv: bad output")
        err["yscale_hv"] = max(err["yscale_hv"], int(
            (k.int() - p.int()).abs().max()))
    for c in planes[1:]:
        args_c = (cub["h_res"], cub["v_res"], cub["up_h_cosited"],
                  cub["up_v_cosited"])
        k = ck.chroma420_scale(c, *args_c, W, H)
        p = ck.chroma420_scale_plain(c, *args_c)
        torch.cuda.synchronize()
        require(k.dtype == p.dtype == torch.int32
                and tuple(k.shape) == (b, OH, OW), "chroma420: bad output")
        err["chroma420_scale"] = max(err["chroma420_scale"], int(
            (k - p).abs().max()))
    for kname, e in err.items():
        require(e == 0, f"{kname}: kernel differs from its plain version "
                f"by up to {e}")
    err["deint_both_parities"] = check_deint(planes, rng)
    err.update(check_new_kernels(planes, (lin, cub), rng))
    for check in (check_two_pass, check_h_only):
        for kname, e in check(planes, (lin, cub), rng).items():
            err[kname] = max(err[kname], e)
    print(f"kernel vs plain (bit for bit): {err}; deint at "
          f"{tuple(planes[0][:DEINT_BATCH].shape)}, "
          f"{tuple(planes[1][:DEINT_BATCH].shape)} and {DEINT_ODD}, both "
          f"methods, both parities; hscale_u8, scale_hv_u8 and "
          f"fused_i420_up_hscale at batch {b} of {W}x{H} (linear/2 and cubic "
          f"taps) and at {SMALL[:3]} -> {SMALL[3:]} (lanczos), both sitings; "
          f"yscale_hv, scale_hv_u8, chroma420_scale (four sitings), "
          f"hscale_u8 and fused_i420_up_hscale (both sitings) also "
          f"at batch {DEINT_BATCH}, at {ODD_WIDTH[:3]} -> {ODD_WIDTH[3:]} (a "
          f"width that is no multiple of 16) and on views that start off a "
          f"16-byte boundary ({SMALL[:3]} and {(SKEWED, H, W)})")

    # -- timings at the headline shapes ---------------------------------------
    timings = {}
    y_f32 = planes[0].float()
    for tag, plan in (("linear2", lin), ("cubic", cub)):
        hr, vr = plan["h_res"], plan["v_res"]
        rows = touched(vr, H)
        nbytes = b * rows * W + b * OH * OW * 2
        timings[("yscale_hv", tag)] = dict(
            ms=cuda_ms(lambda: ysk.yscale_hv(planes[0], hr, vr), 20),
            plain_ms=cuda_ms(lambda: ysk.yscale_hv_plain(planes[0], hr, vr),
                             3, 1),
            library_ms=cuda_ms(dense_pair(y_f32, hr, vr), 5, 1),
            bound=bound(nbytes, 0.0, two_pass_ops(b, rows, hr, vr)),
            taps=(hr.max_taps, vr.max_taps))
        y64 = planes[0][:DEINT_BATCH]
        print(f"time yscale_hv [{tag}] batch {DEINT_BATCH} (the launch "
              f"paths' batch; per call, host side included): "
              f"{cuda_ms(lambda: ysk.yscale_hv(y64, hr, vr), 50):.4f} ms")
    del y_f32
    hr, vr = cub["h_res"], cub["v_res"]
    args_c = (hr, vr, cub["up_h_cosited"], cub["up_v_cosited"])
    vrows = touched(vr, H)
    crow_ids = set()
    for y in np.unique(np.clip(vr.offset[:, None] + np.arange(vr.max_taps),
                               0, H - 1)):
        crow_ids.update({max(y // 2 - 1, 0), y // 2,
                         min(y // 2 + 1, H // 2 - 1)})
    nbytes = b * len(crow_ids) * (W // 2) + b * OH * OW * 4
    # the up2 filters: about 4 operations per sample of the column filter
    # (over the chroma rows read, at full width) and of the row filter (over
    # the rows the vertical taps read), four samples to an int32 lane
    dp4a_ops = (two_pass_ops(b, vrows, hr, vr)
                + 4.0 * b * W * (len(crow_ids) + vrows))
    up = (torch.repeat_interleave(torch.repeat_interleave(
        planes[1], 2, -1), 2, -2)).float()
    timings[("chroma420_scale", "cubic")] = dict(
        ms=cuda_ms(lambda: ck.chroma420_scale(planes[1], *args_c, W, H), 20),
        plain_ms=cuda_ms(lambda: ck.chroma420_scale_plain(planes[1], *args_c),
                         3, 1),
        library_ms=cuda_ms(dense_pair(up, hr, vr), 5, 1),
        bound=bound(nbytes, 0.0, dp4a_ops), taps=(hr.max_taps, vr.max_taps))
    del up
    for (kname, tag), t in timings.items():
        print(f"time {kname} [{tag}, taps {t['taps']}] batch {b}: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
              f"(2 dense fp32 matmuls) {t['library_ms']:.4f} ms, bound "
              f"{t['bound'][0]:.4f} ms ({t['bound'][1]}, {t['bound'][2]})")
    td = time_deint(planes)
    timings[("deint_both_parities", "linear")] = dict(td, library_ms=None)
    print(f"time deint_both_parities [linear, Y+U+V of {DEINT_BATCH} 1080p "
          f"I420 frames]: kernel {td['ms']:.4f} ms, plain "
          f"{td['plain_ms']:.4f} ms, bound {td['bound'][0]:.4f} ms "
          f"({td['bound'][1]}, {td['bound'][2]}, {td['bytes']} bytes); "
          f"library: none (no "
          f"single PyTorch call); copy_ yardstick of the same bytes "
          f"{td['copy_ms']:.4f} ms")

    for (kname, tag), t in time_new_kernels(
            planes, {"linear2": lin, "cubic": cub}).items():
        timings[(kname, tag)] = t
        lib = (f"library ({t['library']}) {t['library_ms']:.4f} ms"
               if t["library_ms"] is not None else
               f"library: none (no single PyTorch call); yardstick of 3 "
               f"dense fp32 h products {t['yardstick_ms']:.4f} ms")
        print(f"time {kname} [{tag}, taps {t['taps']}] batch {b}: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, {lib}, bound "
              f"{t['bound'][0]:.4f} ms ({t['bound'][1]}, {t['bound'][2]})")
    for (kname, tag), t in timings.items():
        require(t["ms"] >= t["bound"][0],
                f"{kname} [{tag}]: {t['ms']:.4f} ms reads under its bound of "
                f"{t['bound'][0]:.4f} ms ({t['bound'][1]}): the bound is no "
                f"bound")
    print(f"bounds: none of the {len(timings)} kernel times reads under its "
          f"bound")

    # -- the main path: counts zeroed just before, read just after ------------
    counters = {"yscale_hv": ysk.yscale_hv,
                "chroma420_scale": ck.chroma420_scale,
                "deint_both_parities": dk.deint_both_parities,
                "fused_i420_up_hscale": fk.fused_i420_up_hscale,
                "scale_hv_u8": s2k.scale_hv_u8,
                "hscale_u8": hk.hscale_u8,
                "freeverb": fvk.freeverb,
                "vad_power": vk.vad_power,
                "gmm": gk.gmm,
                "disparity": sk.disparity}
    for c in counters.values():
        c.launches = 0
    outs, per_cfg = {}, {}
    for k, conv in convs.items():
        before = {n: c.launches for n, c in counters.items()}
        with opt_in(k in FUSED_CONFIGS):
            outs[k] = conv.convert(planes)
        torch.cuda.synchronize()
        per_cfg[k] = {n: c.launches - before[n] for n, c in counters.items()
                      if c.launches - before[n]}
    standalone_ops(planes, host, lin)
    launches = {k: c.launches for k, c in counters.items()}
    print(f"main path launches (converter configs and standalone ops) "
          f"{launches}; per config: {per_cfg}")
    require(per_cfg["linear2"] == {"yscale_hv": 1}
            and per_cfg["cubic"] == {"yscale_hv": 1, "chroma420_scale": 2},
            "yscale / chroma420 kernels not launched as expected on the "
            "main path")
    require(per_cfg["add_borders"] == {}, "add_borders launched a kernel")
    require(per_cfg["fused_ingest"] == {"fused_i420_up_hscale": 1},
            f"fused_ingest: want exactly one fused-ingest launch, got "
            f"{per_cfg['fused_ingest']}")
    require(launches["hscale_u8"] == 1 and launches["scale_hv_u8"] == 1,
            "standalone ops not launched")
    for o, r in zip(outs["fused_ingest"], outs["linear2"]):
        require(torch.equal(o, r),
                "fused_ingest: output differs from linear2's bytes")

    # -- outputs against the port's CPU path and numpy gold -------------------
    for k, cfg in CONFIGS.items():
        out = outs[k]
        require(len(out) == 3 and all(
            o.dtype == torch.uint8 and tuple(o.shape) == (b, OH, OW)
            for o in out), f"{k}: bad output {[o.shape for o in out]}")
        with opt_in(k in FUSED_CONFIGS):
            cpu = VideoConverter(ii, oi, cfg, device="cpu").convert(
                tuple(p[:2] for p in host))
        gold = convs[k].convert_ref(tuple(p[:1] for p in host))
        for o, c, g in zip(out, cpu, gold):
            require(torch.equal(o[:2].cpu(), c),
                    f"{k}: CUDA output differs from the port's CPU path")
            require(np.array_equal(o[:1].cpu().numpy(), g),
                    f"{k}: CUDA output differs from the numpy gold")
    print("outputs: CUDA == port CPU path (2 frames) == numpy gold (1 frame)"
          " for every config")

    # -- end to end: frames/s of convert() on inputs resident on the card -----
    for k, conv in convs.items():
        with opt_in(k in FUSED_CONFIGS):
            ms = cuda_ms(lambda: conv.convert(planes), 5, 1)
        print(f"e2e {k}: {ms:.3f} ms per batch of {b}, "
              f"{b / ms * 1e3:.1f} frames/s")
    del outs

    # -- launch strings: each path with its counts zeroed just before -------
    paths = launch_paths(planes, host, counters)
    for pname, r in paths.items():
        for k in launches:
            launches[k] += r["counts"][k]
        print(f"e2e {pname}: {r['fps']:.1f} output frames/s over ticks 2.."
              f"{r['ticks']} (batch {r['batch']} in, "
              f"{r['frames'][1:]} frames out, "
              f"{[round(s * 1e3, 3) for s in r['secs']]} ms per tick, host "
              f"clock between synchronises; tick 1 includes first calls)")
    del paths

    # -- the generic routes and the switches -----------------------------------
    for counts in generic_routes(host, counters).values():
        for k, n in counts.items():
            launches[k] += n
    for pname, r in launch_paths(planes, host, counters,
                                 GENERIC_LAUNCH).items():
        for k in launches:
            launches[k] += r["counts"][k]
        print(f"e2e {pname}: {r['fps']:.1f} output frames/s over ticks 2.."
              f"{r['ticks']} (batch {r['batch']}, "
              f"{[round(s * 1e3, 3) for s in r['secs']]} ms per tick, host "
              f"clock between synchronises)")
    for k, n in switched_off(convs, planes, counters).items():
        launches[k] += n
    del planes, convs
    torch.cuda.empty_cache()

    # -- the audio front-end: no kernel of the port on its path -----------------
    audio_phase(args.seed, counters, dev)

    # -- aggregators: BASELINE config 3, the wall, the audio mixer -------------
    agg_launches, agg_err = aggregator_phase(args.seed, counters, dev, host)
    for k, n in agg_launches.items():
        launches[k] += n
    for k, e in agg_err.items():
        err[k] = max(err[k], e)

    # -- stateful and controlled elements -------------------------------------
    for k, n in stateful_phase(args.seed, counters, dev, host).items():
        launches[k] += n

    # -- ingest from disk: y4m, JPEG, the example's train loop ----------------
    for k, n in ingest_phase(args.seed, counters, dev).items():
        launches[k] += n

    # -- the common filters and fittings ---------------------------------------
    fit_launches, fit_err = fittings_phase(args.seed, counters, dev, host)
    for k, n in fit_launches.items():
        launches[k] += n
    for k, e in fit_err.items():
        err[k] = max(err[k], e)

    # -- overlays and the device video effects ---------------------------------
    for k, n in overlays_phase(args.seed, counters, dev, host).items():
        launches[k] += n

    # -- the audio DSP family: freeverb's and the VAD's kernels -----------------
    dsp_launches, dsp_err, dsp_timings = dsp_phase(args.seed, counters, dev)
    for k, n in dsp_launches.items():
        launches[k] += n
    err.update(dsp_err)
    timings.update(dsp_timings)

    # -- the OpenCV family: the mixture's and the disparity kernels ----------
    cv_launches, cv_err, cv_timings = cv_phase(args.seed, counters, dev)
    for k, n in cv_launches.items():
        launches[k] += n
    err.update(cv_err)
    timings.update(cv_timings)

    # -- the analytics path and the last device elements (no kernel) --------
    for k, n in analytics_phase(args.seed, counters, dev).items():
        launches[k] += n

    # -- captions, subtitles, scopes and audio files (host modules) ---------
    for k, n in broadcast_phase(args.seed, counters, dev).items():
        launches[k] += n

    # -- containers and multi-stream sources (host modules) ------------------
    for k, n in container_phase(args.seed, counters, dev).items():
        launches[k] += n

    # -- coded files: FLAC, Vorbis, MP3, Theora (host decoders) --------------
    for k, n in codec_phase(args.seed, counters, dev).items():
        launches[k] += n

    # -- Opus and AAC (host decoders) and the device monitor -----------------
    for k, n in opus_aac_phase(args.seed, counters, dev).items():
        launches[k] += n

    # -- VPx, the transport containers, FLV, ASF, playback_extra (host) ------
    for k, n in vpx_transport_phase(args.seed, counters, dev).items():
        launches[k] += n

    # -- RTP, UDP/TCP, RTSP and pcapparse (host code, the card's decode) -----
    for k, n in rtp_rtsp_phase(args.seed, counters, dev).items():
        launches[k] += n

    # -- FEC, RED, the other payloaders and Siren (host code) -----------------
    for k, n in rtp_fec_phase(args.seed, counters, dev).items():
        launches[k] += n

    # -- the rest of net/: WebRTC, RIST, SRT, RTMP, HLS/DASH, AVTP, ... -----
    for k, n in net_tail_phase(args.seed, counters, dev).items():
        launches[k] += n

    # -- the libav family, LC3, Smoke and FLIC (host codecs) ----------------
    for k, n in codec_tail_phase(args.seed, counters, dev).items():
        launches[k] += n

    # -- subtitles, tags and the last parsers (host modules) ----------------
    for k, n in tags_subs_phase(args.seed, counters, dev).items():
        launches[k] += n

    # -- the leaves: camerabin, msesrc, splitmux, unixfd, de265, ... ---------
    for k, n in leaves_phase(args.seed, counters, dev).items():
        launches[k] += n

    # -- the last host modules: convert_sample, Harness, monitor, timeline --
    for k, n in tail_modules_phase(args.seed, counters, dev).items():
        launches[k] += n
    print(f"main path launches, all paths: {launches}")

    smi = smi_line()
    sources = {"yscale_hv": ("gstreamer_tpu_torch/csrc/yscale.cu",
                             "gstreamer_tpu/ops/yscale_kernel.py:109",
                             "linear2"),
               "chroma420_scale": ("gstreamer_tpu_torch/csrc/chroma420.cu",
                                   "gstreamer_tpu/ops/chroma420_kernel.py:159",
                                   "cubic"),
               "deint_both_parities": ("gstreamer_tpu_torch/csrc/deint.cu",
                                       "gstreamer_tpu/ops/deint_kernel.py:85",
                                       "linear"),
               "fused_i420_up_hscale": (
                   "gstreamer_tpu_torch/csrc/fused_ingest.cu",
                   "gstreamer_tpu/ops/convert_kernel.py:185", "linear2"),
               "scale_hv_u8": ("gstreamer_tpu_torch/csrc/scale2d.cu",
                               "gstreamer_tpu/ops/scale2d_kernel.py:88",
                               "linear2"),
               "hscale_u8": ("gstreamer_tpu_torch/csrc/hscale.cu",
                             "gstreamer_tpu/ops/hscale_kernel.py:73",
                             "linear2"),
               # no Pallas counterpart: each replaces a jitted lax.scan
               "freeverb": ("gstreamer_tpu_torch/csrc/freeverb.cu",
                            "gstreamer_tpu/elements/freeverb.py:198",
                            str(FV_CHECK)),
               "vad_power": ("gstreamer_tpu_torch/csrc/vad.cu",
                             "gstreamer_tpu/elements/removesilence.py:76",
                             "960"),
               "gmm": ("gstreamer_tpu_torch/csrc/gmm.cu",
                       "gstreamer_tpu/elements/opencv_analysis.py:313",
                       "1080p64"),
               "disparity": ("gstreamer_tpu_torch/csrc/disparity.cu",
                             "gstreamer_tpu/elements/opencv_analysis.py:964",
                             "720p8")}
    kernels = []
    for kname, (src, repl, tag) in sources.items():
        t = timings[(kname, tag)]
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches[kname], "max_abs_err": err[kname],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"],
            **({"device_ms": t["device_ms"]} if "device_ms" in t else {})})
    require(smi is not None, "nvidia-smi printed nothing")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
