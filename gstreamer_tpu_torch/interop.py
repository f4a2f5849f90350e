"""Carry state across packages as plain data: converter plans, caps.

A VideoConverter's "weights" are its plan: the resamplers' offsets and S16
taps, the prepared color matrix, the chroma siting and whether the plan is
eligible for the fused-ingest route (``pallas_ok``).  ``plan_arrays``
flattens a plan into a dict of numpy arrays; it reads only attributes, so it
accepts the JAX package's plan as well as this package's.
``plan_from_reference`` rebuilds this package's plan objects from such a
dict, so the port can run on exactly the reference's plan
(``VideoConverter.load_plan``).  ``negotiated_caps`` reads a negotiated
pipeline's per-pad caps as strings, from either package's Pipeline.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .video.color import PreparedMatrix
from .video.scaler import SCALE_U8, Resampler

_FLAGS = ("up_h_cosited", "up_v_cosited", "down_h_cosited", "down_v_cosited",
          "pallas_ok")


def plan_arrays(plan) -> Dict[str, np.ndarray]:
    """A converter plan (either package's) -> {name: numpy array}."""
    out: Dict[str, np.ndarray] = {}
    for key in ("h_res", "v_res"):
        res = plan[key]
        if res is None:
            continue
        out[f"{key}.in_size"] = np.asarray(res.in_size, np.int64)
        out[f"{key}.offset"] = np.asarray(res.offset, np.int64)
        out[f"{key}.taps_s16"] = np.asarray(res.taps_s16(SCALE_U8), np.int16)
    out["matrix.im"] = np.asarray(plan["matrix"].im, np.int64)
    out["matrix.mode"] = np.asarray(plan["matrix"].mode)
    for flag in _FLAGS:
        out[flag] = np.asarray(bool(plan[flag]))
    return out


def plan_from_reference(arrays: Dict[str, np.ndarray]) -> dict:
    """{name: numpy array} (see plan_arrays) -> this package's plan
    entries: Resampler objects, a PreparedMatrix and the flags."""
    plan: dict = {}
    for key in ("h_res", "v_res"):
        if f"{key}.offset" not in arrays:
            plan[key] = None
            continue
        taps = np.asarray(arrays[f"{key}.taps_s16"], np.int16)
        offset = np.asarray(arrays[f"{key}.offset"], np.int64)
        if taps.ndim != 2 or taps.shape[0] != offset.shape[0]:
            raise ValueError(f"{key}: taps {taps.shape} do not match "
                             f"offsets {offset.shape}")
        plan[key] = Resampler(
            in_size=int(arrays[f"{key}.in_size"]), out_size=taps.shape[0],
            max_taps=taps.shape[1], offset=offset,
            taps=taps.astype(np.float64) / (1 << SCALE_U8), _taps_s16=taps)
    plan["matrix"] = PreparedMatrix(str(arrays["matrix.mode"]),
                                    np.asarray(arrays["matrix.im"], np.int64))
    for flag in _FLAGS:
        plan[flag] = bool(arrays[flag])
    return plan


def negotiated_caps(pipeline) -> Dict[str, str]:
    """A negotiated pipeline (either package's) -> {"element:pad": caps
    string}, every pad of every element in topological order; a pad with
    no caps maps to "None"."""
    return {f"{e.name}:{p.name}": str(p.caps)
            for e in pipeline._topo_order() for p in e.pads}
