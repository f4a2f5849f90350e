"""Audio DSP of the port: sample formats, AudioInfo, the channel mixer, the
quantizer and the polyphase resampler.  Integer paths use explicit
``torch.int64`` / ``torch.float64`` where the JAX package relies on jax x64
(its ``audio/__init__.py`` turns x64 on for the whole process)."""
