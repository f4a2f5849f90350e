"""PyTorch/CUDA port of gstreamer_tpu for NVIDIA Hopper (H100).

The JAX package ``gstreamer_tpu`` is the reference; this package imports
nothing of it (nor of jax).  It grows slice by slice.  So far it carries:

* the VideoConverter (1080p I420 -> RGB 224x224 headline path) with
  hand-written CUDA kernels for the luma h+v scale, the fused 4:2:0
  chroma scale and the opt-in fused ingest (environment variable
  ``GTPU_PALLAS=1``), and the standalone scale ops ``hscale_u8`` and
  ``scale_hv_u8`` on kernels of their own;
* the launch-string runtime -- caps negotiation, ``parse_launch`` and
  ``Pipeline`` -- with the elements capsfilter, identity, queue, fakesink,
  appsink, appsrc, videoconvert/videoscale/videoconvertscale,
  deinterlace (every method; linear and scalerbob on a CUDA kernel for
  both field parities), videorate, videobalance and videotestsrc;
* the audio front-end (BASELINE config 2, ``audiotestsrc ! audioconvert !
  audioresample``): AudioInfo, the sample formats, the channel mixer, the
  quantizer and the polyphase ``AudioResampler``, and the elements
  audiotestsrc, audioconvert, audioresample and volume;
* the aggregators (compositor, videomixer, audiomixer, adder,
  audiointerleave, audiorate, interleave, deinterleave, smpte, smptealpha,
  shapewipe);
* stateful elements (``make_scan_fn``: a step over the frames of a tick,
  its carry kept on the device across ticks) and controlled properties
  (``core.controller`` sources bound to ``DYNAMIC_PROPS``: keyframed
  videobalance and volume), and the effectv family.

Everything runs on CUDA unless the caller passes ``device="cpu"``; without
a card the default raises.
"""

from .audio.info import AudioInfo
from .audio.resampler import AudioResampler
from .core.parse import parse_launch
from .core.pipeline import Pipeline
from .device import resolve as resolve_device
from .video.converter import VideoConverter
from .video.info import VideoInfo

__all__ = ["AudioInfo", "AudioResampler", "Pipeline", "VideoConverter",
           "VideoInfo", "parse_launch", "resolve_device"]
