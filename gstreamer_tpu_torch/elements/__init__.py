"""Element plugins of the port — importing this package registers the
ported factories in ``gstreamer_tpu_torch.core.element._REGISTRY`` (the
registry-scan equivalent of gstregistry.c).  Only these exist; any other
factory name raises ``ValueError`` in ``element_factory_make``."""

from . import util_elements      # noqa: F401  (capsfilter, identity, queue, queue2, downloadbuffer, tee, valve, fakesink, appsink, appsrc, fakesrc, autovideosink, autoaudiosink, watchdog)
from . import videoconvertscale  # noqa: F401  (videoconvert, videoscale, videoconvertscale)
from . import videofilter        # noqa: F401  (videobalance, gamma, videoflip, videocrop, videobox, videomedian, alpha)
from . import videorate          # noqa: F401
from . import deinterlace        # noqa: F401  (deinterlace, autodeinterlace)
from . import videotestsrc      # noqa: F401
from . import audio_elements    # noqa: F401  (audiotestsrc, audioconvert, audioresample, volume)
from . import compositor        # noqa: F401  (compositor, videomixer)
from . import audio_mix         # noqa: F401  (audiomixer, adder, audiointerleave, audiorate)
from . import interleave        # noqa: F401  (interleave, deinterleave)
from . import smpte             # noqa: F401  (smpte, smptealpha)
from . import shapewipe         # noqa: F401
from . import effectv           # noqa: F401  (edgetv, streaktv, shagadelictv, vertigotv, quarktv, revtv, dicetv, warptv, rippletv, agingtv, optv, radioactv)
from . import file_elements     # noqa: F401  (filesrc, filesink, multifilesrc, multifilesink, y4menc, dataurisrc, fdsrc, fdsink, giosrc, giosink)
from . import rawparse          # noqa: F401  (rawvideoparse, rawaudioparse)
from . import image_codecs      # noqa: F401  (jpegenc, jpegdec, pngenc, pngdec)
from . import debug_elements    # noqa: F401  (progressreport, taginject, capssetter, breakmydata, cpureport, fakevideosink)
from . import audio_sinks       # noqa: F401  (fakeaudiosink)
from . import flow_elements     # noqa: F401  (concat, funnel, input-selector, output-selector, streamiddemux, clocksync, multiqueue)
from . import autoconvert       # noqa: F401  (switchbin, autoconvert, autovideoconvert)
from . import overlay           # noqa: F401  (overlaycomposition)
from . import textoverlay       # noqa: F401  (textoverlay, timeoverlay, clockoverlay, textrender)
from . import pixbuf_overlay    # noqa: F401  (gdkpixbufdec, gdkpixbufoverlay, cairooverlay, qroverlay, debugqroverlay, gdkpixbufsink, rsvgdec, rsvgoverlay)
from . import coloreffects      # noqa: F401  (coloreffects, chromahold)
from . import gaudieffects      # noqa: F401  (burn, chromium, dilate, dodge, exclusion, gaussianblur, solarize)
from . import geometrictransform  # noqa: F401  (bulge, circle, diffuse, fisheye, kaleidoscope, marble, mirror, perspective, pinch, rotate, sphere, square, stretch, tunnel, twirl, waterripple)
from . import bayer             # noqa: F401  (bayer2rgb, rgb2bayer)
from . import law_elements      # noqa: F401  (mulawenc, mulawdec, alawenc, alawdec)
from . import audiofx           # noqa: F401  (audioamplify, audioinvert, audiokaraoke, audioecho, audiodynamic, spectrum, level, equalizer-3bands, equalizer-10bands, equalizer-nbands, audiopanorama, audiowsinclimit, audiowsincband, audiofirfilter, audioiirfilter, audiocheblimit, audiochebband, stereo)
from . import replaygain        # noqa: F401  (rganalysis, rgvolume, rglimiter)
from . import removesilence     # noqa: F401
from . import freeverb          # noqa: F401
from . import cutter            # noqa: F401
from . import scaletempo        # noqa: F401
from . import pitch             # noqa: F401
from . import bs2b              # noqa: F401
from . import opencv_filters    # noqa: F401  (cvdilate, cverode, cvequalizehist, cvsobel, cvlaplace, cvsmooth, edgedetect, skindetect, retinex, opencvtextoverlay)
from . import opencv_analysis   # noqa: F401  (segmentation, motioncells, templatematch, cvtracker, grabcut, disparity)
from . import opencv_camera     # noqa: F401  (dewarp, cameraundistort, cameracalibrate, facedetect, faceblur, handdetect)
from . import faceoverlay       # noqa: F401
from . import analytics_elements  # noqa: F401  (jaxinference, yolov8tensordec, ssdobjectdetector, classifiertensordecoder, ioutracker, tensordecodebin, objectdetectionoverlay)
from . import tensor_decoders2  # noqa: F401  (yolo26tensordec, yolosegv8tensordec, yoloobbv8tensordec, ultralightfacedetectortensordec, segmentationoverlay)
from . import bad_bins          # noqa: F401  (insertbin, testsrcbin, rtponviftimestamp, rtponvifparse, facedetectortensordecoder)
from . import smooth_speed      # noqa: F401  (smooth, speed)
from . import misc_elements     # noqa: F401  (autovideosrc, autoaudiosrc, videoanalyse, audiomixmatrix, audiobuffersplit, videoframe_audiolevel, spanplc)
from . import bad_extras        # noqa: F401  (srtenc, webvttenc, audiochannelmix, checksumsink, videocodectestsink, chopmydata, errorignore, debugspy, fpsdisplaysink, clockselect, roundrobin, videoparse, audioparse, autovideoflip, videoframe-audiolevel)
from . import videosignal       # noqa: F401  (simplevideomark, simplevideomarkdetect)
from . import iqa               # noqa: F401
from . import fieldanalysis     # noqa: F401
from . import interlace         # noqa: F401
from . import videofilters_bad  # noqa: F401  (zebrastripe, scenechange, videodiff, accurip)
from . import imagefreeze       # noqa: F401
from . import webrtcdsp         # noqa: F401  (webrtcechoprobe, webrtcdsp)
from . import closedcaption     # noqa: F401  (ccconverter, cccombiner, ccextractor, cea608mux, line21encoder, line21decoder)
from . import cc_sei            # noqa: F401  (h264ccinserter, h264ccextractor, h265ccinserter, h265ccextractor, alpha_combine, alphacombine, h264seiinserter, h265seiinserter)
from . import timecode_misc     # noqa: F401  (timecodestamper, avwait, h264timestamper, h265timestamper, combdetect, ivtc, compare, audiolatency)
from . import assrender         # noqa: F401
from . import dvbsub            # noqa: F401  (dvbsubenc, dvbsuboverlay)
from . import dvd               # noqa: F401  (dvdlpcmdec, dvdsubdec, dvdspu, dvdsubparse)
from . import visualizers       # noqa: F401  (wavescope, spectrascope, spacescope, synaescope)
from . import monoscope         # noqa: F401
from . import goom2k1           # noqa: F401
from . import inter_netsim      # noqa: F401  (intervideosink/src, interaudiosink/src, intersubsink/src, netsim, videosegmentclip, audiosegmentclip)
from . import wav_elements      # noqa: F401  (wavparse, wavenc)
from . import simple_formats    # noqa: F401  (pnmenc, pnmdec, auparse, auenc, aiffmux, aiffparse)
from . import adpcm_elements    # noqa: F401  (adpcmenc, adpcmdec)
from . import gdp               # noqa: F401  (gdppay, gdpdepay)
from . import ipcpipeline       # noqa: F401  (ipcpipelinesink, ipcpipelinesrc, ipcslavepipeline)
from . import good_extras       # noqa: F401  (aspectratiocrop, imagesequencesrc, pushfilesrc, splitfilesrc, rndbuffersize, capsdebug, testsink, navseek, navigationtest)
from . import container_elements  # noqa: F401  (avimux, avidemux, matroskamux, webmmux, matroskademux)
from . import mxf               # noqa: F401  (mxfmux, mxfdemux)
from . import isomp4            # noqa: F401  (qtmux, qtdemux, cmafmux, fmp4mux, qtmoovrecover)
from . import realmedia         # noqa: F401  (rmdemux, rademux, pnmsrc)
from . import playback          # noqa: F401  (typefind, uridecodebin, decodebin, playbin)
from . import flac_elements     # noqa: F401  (flacenc, flacdec)
from . import ogg               # noqa: F401  (oggmux, oggdemux)
from . import xiph              # noqa: F401  (vorbisdec, vorbisenc, opusdec, opusenc, theoradec, theoraenc, theoraparse, opusparse)
from . import mpegaudio         # noqa: F401  (mpg123audiodec)
from . import aacdec            # noqa: F401  (faad)
from . import audioparsers      # noqa: F401  (mpegaudioparse, ac3parse, flacparse, sbcparse, wavpackparse, aacparse)
from . import videoparsers      # noqa: F401  (h264parse, mpegvideoparse, ivfparse, h265parse, mpeg4videoparse, av1parse, vp9parse, pngparse)
from . import vpx_elements      # noqa: F401  (vp8dec, vp9dec, vp8enc, vp9enc)
from . import codecalpha        # noqa: F401  (codecalphademux, vp8alphadecodebin, vp9alphadecodebin)
from . import mpegts            # noqa: F401  (mpegtsmux, tsdemux, atscmux)
from . import mpegps            # noqa: F401  (mpegpsmux, mpegpsdemux, mplex)
from . import hlssink           # noqa: F401  (hlssink2, hlssink, dashsink)
from . import flv               # noqa: F401  (flvmux, flvdemux)
from . import jpegformat        # noqa: F401  (jpegparse, jifmux)
from . import asf               # noqa: F401  (asfmux, asfparse, asfdemux)
from . import playback_extra    # noqa: F401  (decodebin3, parsebin, playbin3, playsink, y4mdec, alphacolor, dtmfdetect)
from ..net import transport     # noqa: F401  (tcpserversink, tcpclientsink, tcpclientsrc, tcpserversrc, udpsink, udpsrc)
from ..net import rtp           # noqa: F401  (rtpvrawpay, rtpvrawdepay, rtpL16pay, rtpL16depay, rtpjitterbuffer)
from ..net import rtp_payloaders  # noqa: F401  (PCMU/PCMA, H.264, JPEG, VP8, VP9, Opus pay/depay, rtpptdemux, rtpssrcdemux, rtpdtmfsrc/depay, rtpmux, rtpdtmfmux, rtpfunnel, rtprtxsend/receive/queue)
from ..net import rtp_raw_audio  # noqa: F401  (rtpL8pay/depay, rtpL24pay/depay, asteriskh263)
from ..net import rtp_hdrext    # noqa: F401  (the seven RFC 8285 extension elements)
from ..net import sdp           # noqa: F401  (sdpdemux, sdpsrc, rtpsink, rtpsrc)
from ..net import rtsp_server   # noqa: F401  (rtspsrc, rtspclientsink)
from ..net import rtpmanager    # noqa: F401  (rtpsession, rtpbin)
from . import dtmf_icy          # noqa: F401  (dtmfsrc, icydemux, amrparse, dcaparse)
from . import pcapparse         # noqa: F401
from ..net import rtp_payloaders2  # noqa: F401  (the raw, H.265, H.263/H.261, MPEG, AAC, AC-3, AMR, SBC, JPEG 2000, Xiph, stream, gst and passthrough pay/depay, RED, ULPFEC, rtpstorage)
from ..net import fec           # noqa: F401  (rtpst2022_1_fecenc, rtpst2022_1_fecdec)
from ..net import rtp_tail      # noqa: F401  (rtpmparobustdepay, rtpxqtdepay, rtpsv3vdepay, rtpasfpay, rtpasfdepay)
from . import siren_elements    # noqa: F401  (sirenenc, sirendec, rtpsirenpay, rtpsirendepay)
