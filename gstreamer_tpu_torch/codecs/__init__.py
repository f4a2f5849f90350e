"""Image codecs of the port.

PNG over zlib (host; a copy of the JAX package's ``codecs/png.py``) and
baseline JPEG whose DCT / IDCT run as float64 products on torch, on the
caller's device, with the entropy coding on the host (``codecs/jpeg.py``).
Reference capability: gst-plugins-good/ext/libpng (gstpngenc.c/gstpngdec.c)
and ext/jpeg (gstjpegenc.c/gstjpegdec.c) wrap libpng/libjpeg.

The audio and video codecs are host copies of the JAX package's, numpy as
there: ``flac`` (with ``native/flac.py``), ``vorbis`` and ``theora`` (the
clean-room decoders), ``vorbis_enc`` and ``theora_enc`` (ctypes to the
system libvorbisenc / libtheoraenc), ``mp3`` with ``_mp3_tables`` (Layers
I-III), ``celt`` and ``silk`` with their tables (with ``native/celt.py`` /
``silk.py``) under ``opus`` (the stream decoder; libopus through ctypes
for the encoder and a mode-transition packet), ``aac`` and ``sbr`` with
their tables (AAC-LC, HE-AAC v1), ``vpx`` (ctypes to the system libvpx, and
IVF).  Import them as modules; nothing here loads a system library.
"""

from .png import png_decode, png_encode
from .jpeg import jpeg_decode, jpeg_encode

__all__ = ["png_encode", "png_decode", "jpeg_encode", "jpeg_decode"]
