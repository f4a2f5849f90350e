"""Host-side runtime of the port: caps, elements, pipeline, launch parser,
and the device monitor (``device.py``).

Every module of the JAX package's ``core/`` has its counterpart here except
``core/xla_cache.py``, XLA's persistent compilation cache: the port compiles
no XLA programs, and its CUDA kernels are built once into
``gstreamer_tpu_torch/_build/`` (``ops/_build.py``).
"""
