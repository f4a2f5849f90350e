"""Host native code of the port: ctypes loaders of the repo's C++ sources
(``native/gtpu_io.cpp``, ``native/gtpu_jpeg.cpp``, ``native/gtpu_flac.cpp``,
``native/gtpu_celt.cpp``, ``native/gtpu_silk.cpp``),
built with g++ at first use by ``_build.py``."""
