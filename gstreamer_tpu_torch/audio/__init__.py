"""Audio DSP of the port: sample formats, AudioInfo, the channel mixer, the
quantizer, the polyphase resampler and the G.711 law codecs, with host
copies of the FFT, the equalizer's and Chebyshev filters' designs and the
ReplayGain analysis.  Integer paths use explicit
``torch.int64`` / ``torch.float64`` where the JAX package relies on jax x64
(its ``audio/__init__.py`` turns x64 on for the whole process)."""
