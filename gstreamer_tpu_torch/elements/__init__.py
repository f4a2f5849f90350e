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
