"""Image codecs of the port.

PNG over zlib (host; a copy of the JAX package's ``codecs/png.py``) and
baseline JPEG whose DCT / IDCT run as float64 products on torch, on the
caller's device, with the entropy coding on the host (``codecs/jpeg.py``).
Reference capability: gst-plugins-good/ext/libpng (gstpngenc.c/gstpngdec.c)
and ext/jpeg (gstjpegenc.c/gstjpegdec.c) wrap libpng/libjpeg.
"""

from .png import png_decode, png_encode
from .jpeg import jpeg_decode, jpeg_encode

__all__ = ["png_encode", "png_decode", "jpeg_encode", "jpeg_decode"]
