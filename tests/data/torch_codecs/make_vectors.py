"""Write the coded test vectors of ``chip_smoke.py``'s codec phases and
their digests.

Run from the repository root on a machine with the system libtheoraenc,
libvorbisenc, libmp3lame, libopus and libavcodec with its headers (and the
JAX package, which writes the digests):

    JAX_PLATFORMS=cpu python tests/data/torch_codecs/make_vectors.py [GROUP ...]

GROUP is ``codec`` (the FLAC/Vorbis/Theora/MP3 phase's vectors),
``opus_aac`` (the Opus/AAC phase's), ``vpx`` (the VPx/transport phase's;
it needs the system libvpx), ``codec_tail`` (the libav / LC3 / Smoke /
FLIC phase's; it needs libavcodec with libx264 and libspeex) or
``tags_subs`` (the subtitle / tag / parser phase's); without one it
writes all five.  A group
rewrites its files and its entries of ``digests.json`` and keeps the
others'.  It writes, beside itself, with fixed seeds:

* ``theora_1080p.ogv``: 8 frames of 1920x1080 I420 at 25/1 through the
  port's ``theoraenc`` at quality 32 (every packet fits one Ogg page);
* ``theora_vorbis_1080p.mkv``: the same 8 frames at quality 48 and 10 s of
  48 kHz stereo through the port's ``matroskamux video-codec=theora
  audio-codec=vorbis``;
* ``vorbis_10s.ogg``: the same 10 s through the port's ``vorbisenc``;
* ``mp3_10s.mp3``: the same 10 s at 128 kbit/s through libmp3lame
  (``tests/audio_oracle.py::lame_encode``);
* ``digests.json``, from the JAX package's decoders: the Vorbis and MP3
  PCM its elements give at 1024 seeded positions (float32 hex) with the
  RMS of each second, and the sha256 of every Theora plane its decoder
  gives; its decoder loses sync at the first inter frame whose coded-block
  flags hold a run of 30 (ROADMAP.md section 3), so each Theora entry also
  holds the sha256 of every plane libtheoradec decodes (through
  ``tests/theora_oracle.py``, cropped to the picture) and the error the
  JAX package's decoder raised, at which frame;
* ``opus_10s.opus``: the same 10 s through the port's
  ``codecs/opus.py::encode_ogg`` at 64 kbit/s (libopus picks CELT);
* ``opus_voice_10s.opus``: the same 10 s through libopus at
  VOICE_BITRATE, VOIP application, its mode forced: SILK wideband for the
  first half, hybrid fullband for the second (no CELT-only packet, so no
  mode-transition packet, which the clean-room decoder hands to libopus);
* ``aac_10s.aac``: the same 10 s as ADTS AAC-LC at 128 kbit/s from
  libavcodec (``tests/aac_oracle.py``);
* ``heaac_10s.aac``: HE-AAC v1, an LC core at 24 kHz (libavcodec, the
  pairs of samples averaged) with SBR written into every frame by
  ``tests/sbr_writer.py`` (channel-pair payload);
* ``aac_10s.m4a``: the access units of ``aac_10s.aac`` in MP4 through the
  port's ``qtmux``;
* the digests of the PCM the JAX package's elements decode from each
  (``opusdec``, ``aacparse ! faad``, ``qtdemux``), with the Opus
  packets' count by route of ``HybridOpusDecoder``;
* ``vp8_1080p.ivf``: the 8 frames of ``theora_1080p.ogv`` through the
  port's ``vp8enc location=`` (libvpx at its default target bitrate);
* ``vp9_1080p.webm``: the same frames through the port's ``matroskamux
  video-codec=vp9``;
* the sha256 of every plane the JAX package's ``codecs/vpx.py`` decodes
  from each (``vpx_ivf``, ``vpx_webm``);
* ``h264_1080p.ts``: the 8 frames of ``theora_1080p.ogv`` through the
  port's ``x264enc ! mpegtsmux`` (libx264 at its default bitrate), with the
  sha256 of every plane the JAX package's ``tsdemux ! h264parse !
  avdec_h264`` decodes (``h264_ts``);
* ``speex_16k.spx``: the first 3 s of the 10 s, left channel, every third
  sample (16 kHz mono), through libspeex in Ogg (the Speex header from the
  encoder, a comment packet, a frame a page), with the digest of the PCM
  the JAX package's ``oggdemux`` decodes (``speex_ogg``);
* ``anim_320x200.flc``: 8 frames of 320x200 from
  ``tests/test_torch_flx.py::flc_bytes`` (BRUN, SS2, an FLI line delta, a
  palette change, BLACK, COPY), with the sha256 of every RGB plane the JAX
  package's ``flxdec`` gives and of every I420 plane of ``flxdec !
  videoconvertscale ! video/x-raw,format=I420,width=640,height=400``
  (``flic``);
* no file for Smoke and LC3, whose inputs ``chip_smoke.py`` makes at run
  time with integer arithmetic (``ct_frames``, ``ct_lc3_input`` from
  CT_SEED): the sha256 of every packet and decoded plane of its CT_SMOKE
  frames through the port's ``smokeenc`` / ``smokeenc ! smokedec`` on the
  CPU (the JAX package's encoder raises on an inter frame of 1080 lines:
  ROADMAP.md section 3) (``smoke``), and of the frames and PCM of its
  CT_LC3 input through ``lc3enc`` and ``lc3enc ! lc3dec``, the same in both
  packages (``lc3``);
* ``tags_1s.flac``: the first second of the 10 s, left channel, every third
  sample (16 kHz mono), through the port's ``flacenc``;
* ``tags_subs``: what ``chip_smoke.py``'s ``ts_tag_results`` gives on the
  port's CPU path (integer and byte operations only): the sha256 of
  id3v2mux's and apev2mux's files from ``mp3_10s.mp3``, of the payloads
  id3demux and apedemux give back and their tag messages, of flactag's
  file and of the PCM flacdec decodes from it, of vorbistag's packets of
  ``vorbis_10s.ogg`` with vorbisparse's rate and channels, and the
  discoverer's report of every committed vector, which the JAX package's
  discoverer must give too (but for the ADTS files, which it reads as MP3:
  ROADMAP.md section 3).
"""

import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

W, H, FRAMES, FPS = 1920, 1080, 8, 25
RATE, SECONDS = 48000, 10
OGV_QUALITY, MKV_QUALITY = 32, 48
SEED = 2020
POSITIONS = 1024
OPUS_BITRATE, VOICE_BITRATE, AAC_BITRATE, HEAAC_BITRATE = (
    64000, 20000, 128000, 64000)
OPUS_AAC_FILES = ("opus_10s.opus", "opus_voice_10s.opus", "aac_10s.aac",
                  "heaac_10s.aac", "aac_10s.m4a")
VPX_FILES = ("vp8_1080p.ivf", "vp9_1080p.webm")
CODEC_TAIL_FILES = ("h264_1080p.ts", "speex_16k.spx", "anim_320x200.flc")
TAGS_SUBS_FILES = ("tags_1s.flac",)


def frames(w=W, h=H, n=FRAMES):
    """n I420 frames of w x h panning over a seeded scene: a gradient, a
    sine pattern, a coarse texture, five flat boxes and light noise."""
    rng = np.random.default_rng(SEED)
    ph, pw = h + 64, w + 64
    yy, xx = np.mgrid[0:ph, 0:pw].astype(np.float32)
    y = (60 + 100 * xx / pw + 40 * yy / ph
         + 30 * np.sin(xx / 37.0) * np.cos(yy / 53.0))
    tex = rng.normal(0, 1, (ph // 16 + 1, pw // 16 + 1)).astype(np.float32)
    y += np.kron(tex, np.ones((16, 16), np.float32))[:ph, :pw] * 5
    for j in range(5):
        cx, cy = 200 + 300 * j, 200 + 120 * j
        y[cy:cy + 160, cx:cx + 220] = 40 + 35 * j
    y = np.clip(y + rng.normal(0, 1.0, y.shape), 0, 255).astype(np.uint8)
    u = np.clip(128 + 40 * np.sin(xx[::2, ::2] / 90.0), 0, 255
                ).astype(np.uint8)
    v = np.clip(128 + 40 * np.cos(yy[::2, ::2] / 70.0), 0, 255
                ).astype(np.uint8)
    out = []
    for k in range(n):
        dx, dy = 4 * k, 2 * k
        out.append(tuple(np.ascontiguousarray(p) for p in (
            y[dy:dy + h, dx:dx + w],
            u[dy // 2:dy // 2 + h // 2, dx // 2:dx // 2 + w // 2],
            v[dy // 2:dy // 2 + h // 2, dx // 2:dx // 2 + w // 2])))
    return out


def pcm16():
    """SECONDS of 48 kHz stereo S16: two tones under a slow swell, a
    falling chirp and noise."""
    rng = np.random.default_rng(SEED + 1)
    t = np.arange(RATE * SECONDS)[:, None] / RATE
    swell = 0.6 + 0.4 * np.sin(2 * np.pi * 0.3 * t)
    x = swell * 0.35 * np.sin(2 * np.pi * np.array([220.0, 330.0]) * t)
    x += 0.15 * np.sin(2 * np.pi * (2000 - 150 * t) * t)
    x += rng.normal(0, 0.02, x.shape)
    return (np.clip(x, -1, 1) * 32767).astype(np.int16)


def write_codec_vectors():
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    from audio_oracle import lame_encode
    fr, pcm = frames(), pcm16()
    dur = 10**9 // FPS
    vcaps = (f"appsrc name=v caps=video/x-raw,format=I420,width={W},"
             f"height={H},framerate={FPS}/1")
    acaps = (f"appsrc name=a caps=audio/x-raw,format=S16LE,rate={RATE},"
             f"channels=2,layout=interleaved")
    per = len(pcm) // FRAMES                # audio frames a video frame

    def run(desc, video, audio):
        pipe = parse_launch(desc, device="cpu")
        for k in range(FRAMES):
            if video:
                pipe.get_by_name("v").push_buffer(Buffer(
                    data=tuple(torch.from_numpy(p[None]) for p in fr[k]),
                    pts=k * dur, duration=dur))
            if audio:
                pipe.get_by_name("a").push_buffer(Buffer(
                    data=torch.from_numpy(pcm[k * per:(k + 1) * per]),
                    pts=k * per * 10**9 // RATE,
                    duration=per * 10**9 // RATE))
        for name in ("v", "a") if video and audio else \
                ("v",) if video else ("a",):
            pipe.get_by_name(name).end_of_stream()
        pipe.run()

    path = os.path.join(HERE, "theora_1080p.ogv")
    run(f"{vcaps} ! theoraenc quality={OGV_QUALITY} location={path}",
        True, False)
    path = os.path.join(HERE, "theora_vorbis_1080p.mkv")
    run(f"matroskamux name=m location={path} video-codec=theora "
        f"video-quality={MKV_QUALITY} audio-codec=vorbis ! fakesink "
        f"{vcaps} ! m.video_0 {acaps} ! m.audio_0", True, True)
    path = os.path.join(HERE, "vorbis_10s.ogg")
    run(f"{acaps} ! vorbisenc location={path}", False, True)
    with open(os.path.join(HERE, "mp3_10s.mp3"), "wb") as f:
        f.write(lame_encode(pcm, RATE, 128))


def pcm_digest(x, rate):
    """PCM (n, ch) float32: its length, rate, the samples at POSITIONS
    seeded positions (float32 little-endian hex) and the RMS of each
    second."""
    x = np.ascontiguousarray(x, np.float32)
    pos = np.sort(np.random.default_rng(SEED + 2).choice(
        len(x), POSITIONS, replace=False))
    rms = [float(np.sqrt(np.mean(x[s:s + rate].astype(np.float64) ** 2)))
           for s in range(0, len(x), rate)]
    return {"frames": len(x), "channels": x.shape[1], "rate": rate,
            "positions": pos.tolist(),
            "values": x[pos].astype("<f4").tobytes().hex(), "rms": rms}


def plane_digests(frames_):
    return [[hashlib.sha256(np.ascontiguousarray(p).tobytes()).hexdigest()
             for p in f] for f in frames_]


def element_pcm(desc):
    """The F32 samples a JAX launch string ending in appsink gives."""
    from gstreamer_tpu.core.parse import parse_launch
    pipe = parse_launch(desc + " ! appsink name=out")
    pipe.run()
    sink = pipe.get_by_name("out")
    out = []
    while (s := sink.pull_sample()) is not None:
        out.append(np.asarray(s.buffer.data))
    return np.concatenate(out)


def theora_digests(hdrs, packets):
    """The cropped planes' sha256 by libtheoradec for every packet, and by
    the JAX package's decoder up to the packet where it raises."""
    import theora_oracle
    from gstreamer_tpu.codecs.theora import TheoraDecoder
    dec = TheoraDecoder(hdrs[0], hdrs[1], hdrs[2])
    gold = theora_oracle.decode_packets(hdrs, packets)[0]
    jax, error = [], None
    for k, pkt in enumerate(packets):
        try:
            jax.append(dec.crop(dec.decode_packet(pkt)))
        except Exception as e:          # the fault: record where and what
            error = {"frame": k, "error": f"{type(e).__name__}: {e}"}
            break
    return {"width": dec.pic_width, "height": dec.pic_height,
            "fps": [dec.fps_n, dec.fps_d],
            "libtheoradec": plane_digests(dec.crop(tuple(g)) for g in gold),
            "jax": plane_digests(jax), "jax_error": error}


def write_codec_digests(digests):
    from gstreamer_tpu.elements.container_elements import (
        MatroskaDemux, _parse_matroska, _parse_xiph_private)
    from gstreamer_tpu.elements.ogg import parse_ogg_pages
    ogv = os.path.join(HERE, "theora_1080p.ogv")
    mkv = os.path.join(HERE, "theora_vorbis_1080p.mkv")
    ogg = os.path.join(HERE, "vorbis_10s.ogg")
    mp3 = os.path.join(HERE, "mp3_10s.mp3")
    with open(ogv, "rb") as f:
        packets = [p for _, _, pkts in parse_ogg_pages(f.read())
                   for p in pkts]
    tracks, blocks, data = _parse_matroska(mkv)
    video = next(t for t in tracks if t["codec"] == "V_THEORA")
    vpkts = [data[off:off + size] for tno, _, off, size, _ in blocks
             if tno == video["number"]]
    ma = MatroskaDemux(location=mkv, stream="audio")
    ma._load()
    digests.update({
        "theora_ogv": theora_digests(packets[:3], packets[3:]),
        "theora_mkv": theora_digests(
            _parse_xiph_private(video["codec_private"]), vpkts),
        "vorbis_ogg": pcm_digest(element_pcm(f"vorbisdec location={ogg}"),
                                 RATE),
        "vorbis_mkv": pcm_digest(ma._adata, ma._info.rate),
        "mp3": pcm_digest(element_pcm(f"filesrc location={mp3} ! "
                                      f"mpegaudioparse ! mpg123audiodec"),
                          RATE),
    })
    digests.setdefault("sizes", {}).update(
        {n: os.path.getsize(os.path.join(HERE, n)) for n in (
            "theora_1080p.ogv", "theora_vorbis_1080p.mkv", "vorbis_10s.ogg",
            "mp3_10s.mp3")})


def opus_voice_packets(pcm):
    """20 ms packets of `pcm` (48 kHz stereo S16) from libopus at
    VOICE_BITRATE, VOIP application, SILK wideband forced for the first
    half of the packets and hybrid fullband for the rest; and the
    encoder's lookahead."""
    import ctypes
    lib = ctypes.CDLL("libopus.so.0")
    lib.opus_encoder_create.restype = ctypes.c_void_p
    err = ctypes.c_int()
    enc = ctypes.c_void_p(lib.opus_encoder_create(48000, 2, 2048,
                                                  ctypes.byref(err)))
    if err.value:
        raise RuntimeError(f"opus_encoder_create: {err.value}")
    lib.opus_encoder_ctl(enc, 4002, ctypes.c_int(VOICE_BITRATE))
    look = ctypes.c_int()
    lib.opus_encoder_ctl(enc, 4027, ctypes.byref(look))
    n = -(-(len(pcm) + look.value) // 960)
    padded = np.zeros((n * 960, 2), np.int16)
    padded[:len(pcm)] = pcm
    buf, out = ctypes.create_string_buffer(4000), []
    for k in range(n):
        silk = k < n // 2
        # OPUS_SET_FORCE_MODE: SILK only / hybrid; OPUS_SET_BANDWIDTH:
        # wideband / fullband
        lib.opus_encoder_ctl(enc, 11002, ctypes.c_int(1000 if silk else 1001))
        lib.opus_encoder_ctl(enc, 4008, ctypes.c_int(1103 if silk else 1105))
        frame = np.ascontiguousarray(padded[k * 960:(k + 1) * 960])
        got = lib.opus_encode(enc, frame.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int16)), 960, buf, 4000)
        if got < 0:
            raise RuntimeError(f"opus_encode: {got}")
        out.append(bytes(buf.raw[:got]))
    lib.opus_encoder_destroy(enc)
    return out, look.value


def ogg_opus(packets, pre_skip, n_samples, serial=0x766F6963):
    """Opus packets of 960 samples in Ogg (RFC 7845), as the port's
    encode_ogg lays them out: one packet a page, the last page's
    granule trimmed to pre-skip + n_samples."""
    import struct
    from gstreamer_tpu_torch.codecs.opus import opus_head
    from gstreamer_tpu_torch.elements.ogg import ogg_page
    vendor = b"gstreamer_tpu"
    pages = [ogg_page([opus_head(2, pre_skip, RATE)], serial, 0, 0, bos=True),
             ogg_page([b"OpusTags" + struct.pack("<I", len(vendor)) + vendor
                       + struct.pack("<I", 0)], serial, 1, 0)]
    for k, pkt in enumerate(packets):
        last = k == len(packets) - 1
        granule = (k + 1) * 960
        pages.append(ogg_page([pkt], serial, k + 2,
                              min(granule, pre_skip + n_samples) if last
                              else granule, eos=last))
    return b"".join(pages)


def adts_frames(data):
    """The raw access units of an ADTS stream (headers cut off)."""
    from gstreamer_tpu_torch.codecs.aac import parse_adts_header
    out, pos = [], 0
    while pos + 7 <= len(data):
        flen, _sfi, _cc, _p, hlen = parse_adts_header(data, pos)
        out.append(data[pos + hlen:pos + flen])
        pos += flen
    return out


def write_opus_aac_vectors():
    import torch
    import aac_oracle
    import sbr_writer
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.codecs import opus as popus
    from gstreamer_tpu_torch.codecs.sbr import SbrHeader
    from gstreamer_tpu_torch.core.buffer import Buffer
    pcm = pcm16()
    with open(os.path.join(HERE, "opus_10s.opus"), "wb") as f:
        f.write(popus.encode_ogg(pcm, RATE, OPUS_BITRATE))
    packets, look = opus_voice_packets(pcm)
    with open(os.path.join(HERE, "opus_voice_10s.opus"), "wb") as f:
        f.write(ogg_opus(packets, look, len(pcm)))
    adts = aac_oracle.aac_encode_adts(pcm, RATE, AAC_BITRATE)
    if adts is None:
        raise RuntimeError("libavcodec's AAC encoder is unavailable")
    with open(os.path.join(HERE, "aac_10s.aac"), "wb") as f:
        f.write(adts)
    core = ((pcm[0::2].astype(np.int32) + pcm[1::2]) // 2).astype(np.int16)
    lc = aac_oracle.aac_encode_adts(core, RATE // 2, HEAAC_BITRATE,
                                    "aac_pns=0")
    he = sbr_writer.splice_sbr_adts(
        lc, SbrHeader(amp_res=1, start_freq=5, stop_freq=3), env_q=[70],
        noise_q=[25], invf_mode=0, cpe={})
    with open(os.path.join(HERE, "heaac_10s.aac"), "wb") as f:
        f.write(he)
    units = adts_frames(adts)
    pipe = parse_launch(
        f"qtmux name=m location={os.path.join(HERE, 'aac_10s.m4a')} ! "
        f"fakesink appsrc name=a caps=audio/mpeg,mpegversion=4,"
        f"stream-format=raw,rate={RATE},channels=2 ! m.audio_0",
        device="cpu")
    src = pipe.get_by_name("a")
    for k, unit in enumerate(units):
        src.push_buffer(Buffer(
            data=[torch.from_numpy(np.frombuffer(unit, np.uint8).copy())],
            batch=1, pts=k * 1024 * 10**9 // RATE,
            duration=1024 * 10**9 // RATE))
    src.end_of_stream()
    pipe.run()


def opus_routes(path):
    """The packets of an Ogg-Opus file by the route the JAX package's
    HybridOpusDecoder takes (celt, silk, hybrid, libopus)."""
    from gstreamer_tpu.codecs import celt, opus, silk
    from gstreamer_tpu.elements.ogg import parse_ogg_pages
    with open(path, "rb") as f:
        pkts = [p for _, _, ps in parse_ogg_pages(f.read()) for p in ps][2:]
    dec, routes = opus.HybridOpusDecoder(2), {}
    for p in pkts:
        dec.decode(p)
        # the decoder drops its native paths for good at the first packet
        # it hands to libopus
        config = p[0] >> 3
        route = ("libopus" if not (dec._use_native and dec._use_native_silk)
                 else "celt" if config in celt.CELT_CONFIGS
                 else "silk" if config in silk.SILK_CONFIGS else "hybrid")
        routes[route] = routes.get(route, 0) + 1
    return routes


def write_opus_aac_digests(digests):
    def at(name):
        return os.path.join(HERE, name)
    digests.update({
        "opus_ogg": dict(pcm_digest(element_pcm(
            f"opusdec location={at('opus_10s.opus')}"), RATE),
            routes=opus_routes(at("opus_10s.opus"))),
        "opus_voice": dict(pcm_digest(element_pcm(
            f"opusdec location={at('opus_voice_10s.opus')}"), RATE),
            routes=opus_routes(at("opus_voice_10s.opus"))),
        "aac_adts": pcm_digest(element_pcm(
            f"filesrc location={at('aac_10s.aac')} ! aacparse ! faad"), RATE),
        "heaac_adts": pcm_digest(element_pcm(
            f"filesrc location={at('heaac_10s.aac')} ! aacparse ! faad"),
            RATE),
        "aac_m4a": pcm_digest(element_pcm(
            f"qtdemux location={at('aac_10s.m4a')} stream=audio"), RATE),
    })
    digests.setdefault("sizes", {}).update(
        {n: os.path.getsize(at(n)) for n in OPUS_AAC_FILES})


def write_vpx_vectors():
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.codecs import vpx
    from gstreamer_tpu_torch.core.buffer import Buffer
    if not vpx.available():
        raise RuntimeError("the system libvpx is unavailable")
    fr = frames()
    dur = 10**9 // FPS
    vcaps = (f"appsrc name=v caps=video/x-raw,format=I420,width={W},"
             f"height={H},framerate={FPS}/1")
    for desc in (f"{vcaps} ! vp8enc location={os.path.join(HERE, VPX_FILES[0])}"
                 f" ! fakesink",
                 f"matroskamux name=m location="
                 f"{os.path.join(HERE, VPX_FILES[1])} video-codec=vp9 ! "
                 f"fakesink {vcaps} ! m.video_0"):
        pipe = parse_launch(desc, device="cpu")
        for k in range(FRAMES):
            pipe.get_by_name("v").push_buffer(Buffer(
                data=tuple(torch.from_numpy(p[None]) for p in fr[k]),
                pts=k * dur, duration=dur))
        pipe.get_by_name("v").end_of_stream()
        pipe.run()


def write_vpx_digests(digests):
    from gstreamer_tpu.codecs import vpx
    from gstreamer_tpu.elements.container_elements import MatroskaDemux
    with open(os.path.join(HERE, VPX_FILES[0]), "rb") as f:
        codec, _w, _h, _fps, packets = vpx.parse_ivf(f.read())
    mkv = MatroskaDemux(location=os.path.join(HERE, VPX_FILES[1]),
                        stream="video")
    mkv._load()
    digests.update({
        "vpx_ivf": plane_digests(vpx.decode_packets(codec, packets)),
        "vpx_webm": plane_digests(mkv._frames)})
    digests.setdefault("sizes", {}).update(
        {n: os.path.getsize(os.path.join(HERE, n)) for n in VPX_FILES})


def write_codec_tail_vectors():
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.elements.ogg import ogg_page
    from gstreamer_tpu_torch.native import av
    from test_torch_flx import flc_bytes
    if not (av.have_codec("libx264", encoder=True)
            and av.have_codec("libspeex", encoder=True)):
        raise RuntimeError("the system libavcodec lacks libx264 or libspeex")
    fr = frames()
    dur = 10**9 // FPS
    pipe = parse_launch(
        f"appsrc name=v caps=video/x-raw,format=I420,width={W},height={H},"
        f"framerate={FPS}/1 ! x264enc ! mpegtsmux location="
        f"{os.path.join(HERE, CODEC_TAIL_FILES[0])}", device="cpu")
    for k in range(FRAMES):
        pipe.get_by_name("v").push_buffer(Buffer(
            data=tuple(torch.from_numpy(p[None]) for p in fr[k]),
            pts=k * dur, duration=dur))
    pipe.get_by_name("v").end_of_stream()
    pipe.run()
    voice = pcm16()[:3 * RATE:3, :1].astype(np.float32) / 32768.0
    enc = av.AvAudioEncoder("libspeex", RATE // 3, 1)
    pkts = enc.encode_all(voice)
    pages = [ogg_page([enc.extradata()], 7, 0, 0, bos=True),
             ogg_page([b"\x00" * 8], 7, 1, 0)]
    for i, pk in enumerate(pkts):
        pages.append(ogg_page([pk], 7, 2 + i, 320 * (i + 1),
                              eos=i == len(pkts) - 1))
    with open(os.path.join(HERE, CODEC_TAIL_FILES[1]), "wb") as f:
        f.write(b"".join(pages))
    with open(os.path.join(HERE, CODEC_TAIL_FILES[2]), "wb") as f:
        f.write(flc_bytes(320, 200, 8, SEED)[0])


def port_samples(desc, pushes=None, batch=1):
    """The samples of a launch string ending in appsink `out`, run by the
    port on the CPU (its appsrc `in` given the Buffers `pushes`)."""
    from gstreamer_tpu_torch import parse_launch
    pipe = parse_launch(desc + " ! appsink name=out", batch=batch,
                        device="cpu")
    for b in pushes or ():
        pipe.get_by_name("in").push_buffer(b)
    if pushes:
        pipe.get_by_name("in").end_of_stream()
    pipe.run()
    sink = pipe.get_by_name("out")
    return list(iter(sink.pull_sample, None))


def element_planes(desc):
    """Every frame's planes a JAX launch string ending in appsink gives."""
    from gstreamer_tpu.core.parse import parse_launch
    pipe = parse_launch(desc + " ! appsink name=out")
    pipe.run()
    out = []
    for s in iter(pipe.get_by_name("out").pull_sample, None):
        planes = [np.asarray(p) for p in s.buffer.data]
        out += [[p[k] for p in planes] for k in range(planes[0].shape[0])]
    return out


def write_codec_tail_digests(digests):
    import torch
    from chip_smoke import (CT_FLIC_I420, CT_LC3, CT_SEED, CT_SMOKE,
                            ct_blobs, ct_frames, ct_lc3_input,
                            ct_lc3_pushes, ct_planes, ct_video_pushes)
    cpu = torch.device("cpu")
    ts, spx, flc = (os.path.join(HERE, n) for n in CODEC_TAIL_FILES)
    w, h, n, b = CT_SMOKE
    planes = ct_frames(n, w, h, CT_SEED)
    src = (f"appsrc name=in caps=video/x-raw,format=I420,width={w},"
           f"height={h},framerate=25/1")
    smoke = ct_blobs(port_samples(f"{src} ! smokeenc",
                                  ct_video_pushes(planes, b, cpu), b))
    smoke_planes = ct_planes(port_samples(f"{src} ! smokeenc ! smokedec",
                                          ct_video_pushes(planes, b, cpu), b))
    rate, ch, _n, _per = CT_LC3
    x = ct_lc3_input(CT_SEED)
    asrc = (f"appsrc name=in caps=audio/x-raw,format=S16LE,rate={rate},"
            f"channels={ch},layout=interleaved")
    lc3 = ct_blobs(port_samples(f"{asrc} ! lc3enc", ct_lc3_pushes(x, cpu)))
    pcm = np.concatenate([s.buffer.data.numpy() for s in port_samples(
        f"{asrc} ! lc3enc ! lc3dec", ct_lc3_pushes(x, cpu))])
    digests.update({
        "h264_ts": plane_digests(element_planes(
            f"tsdemux location={ts} ! h264parse ! avdec_h264")),
        "speex_ogg": pcm_digest(element_pcm(f"oggdemux location={spx}"),
                                RATE // 3),
        "flic": {"rgb": plane_digests(element_planes(
                     f"flxdec location={flc}")),
                 "i420": plane_digests(element_planes(
                     f"flxdec location={flc} ! videoconvertscale ! "
                     f"{CT_FLIC_I420}")),
                 "caps": CT_FLIC_I420},
        "smoke": {"frames": CT_SMOKE, "seed": CT_SEED,
                  "packets": [hashlib.sha256(p).hexdigest() for p in smoke],
                  "planes": plane_digests(smoke_planes)},
        "lc3": {"input": CT_LC3, "seed": CT_SEED, "frames": len(lc3),
                "bytes": hashlib.sha256(b"".join(lc3)).hexdigest(),
                "pcm": hashlib.sha256(pcm.tobytes()).hexdigest(),
                "samples": len(pcm)},
    })
    digests.setdefault("sizes", {}).update(
        {n: os.path.getsize(os.path.join(HERE, n))
         for n in CODEC_TAIL_FILES})


def write_tags_subs_vectors():
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    x = np.ascontiguousarray(pcm16()[:RATE:3, :1])
    pipe = parse_launch(
        f"appsrc name=in caps=audio/x-raw,format=S16LE,rate={RATE // 3},"
        f"channels=1,layout=interleaved ! flacenc location="
        f"{os.path.join(HERE, TAGS_SUBS_FILES[0])}", device="cpu")
    pipe.get_by_name("in").push_buffer(Buffer(
        data=torch.from_numpy(x), pts=0, duration=10**9))
    pipe.get_by_name("in").end_of_stream()
    pipe.run()


def write_tags_subs_digests(digests):
    import tempfile

    import torch
    from chip_smoke import TS_FILES, ts_tag_results
    from gstreamer_tpu.utils.discoverer import Discoverer
    files = {n: os.path.join(HERE, n) for n in TS_FILES}
    with tempfile.TemporaryDirectory() as tmp:
        got = ts_tag_results(files, tmp, torch.device("cpu"))
    for name, (dur, streams) in got["discoverer"].items():
        if name in ("aac_10s.aac", "heaac_10s.aac"):
            continue
        info = Discoverer().discover(os.path.join(HERE, name))
        ref = [info.duration_ns, [
            [s.kind, None if s.caps is None else str(s.caps), s.width,
             s.height, None if s.fps is None else str(s.fps), s.rate,
             s.channels, s.format] for s in info.streams]]
        if ref != [dur, streams]:
            raise RuntimeError(f"discoverer: {name}: the port's report "
                               f"{[dur, streams]} is not the JAX "
                               f"package's {ref}")
    digests["tags_subs"] = got
    digests.setdefault("sizes", {}).update(
        {n: os.path.getsize(os.path.join(HERE, n)) for n in TAGS_SUBS_FILES})


GROUPS = {"codec": (write_codec_vectors, write_codec_digests),
          "opus_aac": (write_opus_aac_vectors, write_opus_aac_digests),
          "vpx": (write_vpx_vectors, write_vpx_digests),
          "codec_tail": (write_codec_tail_vectors, write_codec_tail_digests),
          "tags_subs": (write_tags_subs_vectors, write_tags_subs_digests)}


if __name__ == "__main__":
    groups = sys.argv[1:] or list(GROUPS)
    unknown = [g for g in groups if g not in GROUPS]
    if unknown:
        sys.exit(f"unknown group(s) {unknown}; choose from {list(GROUPS)}")
    path = os.path.join(HERE, "digests.json")
    digests = {}
    if os.path.exists(path):
        with open(path) as f:
            digests = json.load(f)
    for g in groups:
        write, digest = GROUPS[g]
        write()
        digest(digests)
    with open(path, "w") as f:
        json.dump(digests, f, indent=1)
        f.write("\n")
    for name in sorted(os.listdir(HERE)):
        print(name, os.path.getsize(os.path.join(HERE, name)))
