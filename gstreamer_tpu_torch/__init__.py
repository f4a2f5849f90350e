"""PyTorch/CUDA port of gstreamer_tpu for NVIDIA Hopper (H100).

The JAX package ``gstreamer_tpu`` is the reference; this package imports
nothing of it (nor of jax).  It grows slice by slice: this slice carries the
VideoConverter (1080p I420 -> RGB 224x224 headline path) with hand-written
CUDA kernels for the luma h+v scale and the fused 4:2:0 chroma scale.
"""

from .device import resolve as resolve_device
from .video.converter import VideoConverter
from .video.info import VideoInfo

__all__ = ["VideoConverter", "VideoInfo", "resolve_device"]
