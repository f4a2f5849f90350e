"""Dither planning: the converter's chain_dither decision (host).

A copy of ``make_converter_dither`` of the JAX package's ``video/dither.py``
(video-converter.c:2034).  The dither itself is ported in a later slice:
a plan that would dither raises here, so no output is produced without it.
"""

from __future__ import annotations


def make_converter_dither(method: str, target_quant: int, out_finfo,
                          pack_bits: int) -> None:
    """chain_dither (video-converter.c:2034): build the quant[] array
    from output component depths; None when no dithering is needed."""
    if method == "none":
        return None
    quant = []
    do_dither = False
    # canonical component order (A, c0, c1, c2): depths from the output
    # format; alpha depth = container bits when present else 0
    depths = [out_finfo.depth[out_finfo.n_components - 1]
              if out_finfo.has_alpha else 0]
    depths += [out_finfo.depth[i] if i < out_finfo.n_components else 0
               for i in range(3)]
    for depth in depths:
        if depth == 0:
            quant.append(0)
            continue
        if pack_bits >= depth:
            q = 1 << (pack_bits - depth)
            if target_quant > q:
                q = target_quant
        else:
            q = 0
        quant.append(q)
        if q > 1:
            do_dither = True
    if not do_dither:
        return None
    raise NotImplementedError(
        f"dither {method!r} (quantizers {quant}) is ported in a later slice "
        "of the PyTorch port")
