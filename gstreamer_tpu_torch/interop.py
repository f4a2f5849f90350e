"""Carry state across packages as plain data: converter plans, audio
state, caps.

A VideoConverter's "weights" are its plan: the resamplers' offsets and S16
taps, the prepared color matrices (the main one and the gamma chain's
``to_rgb`` / ``to_yuv``), the gamma LUTs, the dither's parameters, the
chroma siting and the flags that pick the route (``scale_order``,
``interlaced``, ``pallas_ok``, ...).  An entry that is None in the plan has
no key in the dict.  ``plan_arrays``
flattens a plan into a dict of numpy arrays; it reads only attributes, so it
accepts the JAX package's plan as well as this package's.
``plan_from_reference`` rebuilds this package's plan objects from such a
dict, so the port can run on exactly the reference's plan
(``VideoConverter.load_plan``).  ``negotiated_caps`` reads a negotiated
pipeline's per-pad caps as strings, from either package's Pipeline.

The audio side's state: ``resampler_arrays`` reads an AudioResampler's
rates, tap count, filter mode and the taps of every compute dtype
(``AudioResampler.load_taps`` runs the port on them); ``convert_arrays``
reads an audioconvert's mix matrix (float32 and Q10) and its quantizer's
parameters and PRNG state (``quantizer_from_arrays`` rebuilds the port's
Quantizer from them).  Both accept either package's objects.

A pipeline's streaming state: ``element_states`` reads, by element name,
the carries of its stateful (scan) elements (``_elem_states``), a
deinterlacer's carried frames and pending fields, the host counters that
feed a scan's aux rows (vertigotv's phase, warptv's counter), and the
buffers a clocksync holds for its clock (``_held``), a freeverb's rings,
ring indices and filterstores (``freeverb_arrays``) and a removesilence's
VAD and guards (``vad_arrays``), all as numpy or Python numbers;
``load_element_states`` puts them into the port's pipeline (after
``set_state(PLAYING)``), so a tick run by one package can continue in the
other.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .audio.channel_mixer import matrix_int
from .audio.quantize import Quantizer
from .audio.resampler import DTYPES
from .core.buffer import Buffer, map_leaves
from .core.pipeline import _carry_to
from .video.color import PreparedMatrix
from .video.dither import VideoDither
from .video.scaler import SCALE_U8, Resampler

_FLAGS = ("up_h_cosited", "up_v_cosited", "down_h_cosited", "down_v_cosited",
          "pallas_ok", "interlaced", "do_gamma", "scale_before_matrix",
          "upsample", "downsample")
_MATRICES = ("matrix", "to_rgb", "to_yuv")
_TABLES = ("gamma_dec", "gamma_enc")


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
    for key in _MATRICES:
        pm = plan.get(key)
        if pm is not None:
            out[f"{key}.im"] = np.asarray(pm.im, np.int64)
            out[f"{key}.mode"] = np.asarray(pm.mode)
    for key in _TABLES:
        if plan.get(key) is not None:
            out[key] = np.asarray(plan[key])
    for flag in _FLAGS:
        out[flag] = np.asarray(bool(plan[flag]))
    out["scale_order"] = np.asarray(plan["scale_order"])
    d = plan["dither"]
    if d is not None:
        out["dither.method"] = np.asarray(d.method)
        out["dither.flags_quantize"] = np.asarray(bool(d.flags_quantize))
        out["dither.bits"] = np.asarray(d.bits, np.int64)
        out["dither.shift"] = np.asarray(d.shift, np.int64)
    return out


def plan_from_reference(arrays: Dict[str, np.ndarray]) -> dict:
    """{name: numpy array} (see plan_arrays) -> this package's plan
    entries: Resampler, PreparedMatrix and VideoDither objects, the gamma
    tables and the flags."""
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
    for key in _MATRICES:
        plan[key] = (PreparedMatrix(str(arrays[f"{key}.mode"]),
                                    np.asarray(arrays[f"{key}.im"], np.int64))
                     if f"{key}.im" in arrays else None)
    for key in _TABLES:
        plan[key] = np.asarray(arrays[key]) if key in arrays else None
    for flag in _FLAGS:
        plan[flag] = bool(arrays[flag])
    plan["scale_order"] = str(arrays["scale_order"])
    plan["dither"] = None
    if "dither.method" in arrays:
        shift = [int(x) for x in arrays["dither.shift"]]
        # a quantizer of 1 << shift gives the dither back its shift
        plan["dither"] = VideoDither(
            str(arrays["dither.method"]),
            bool(arrays["dither.flags_quantize"]),
            int(arrays["dither.bits"]), [1 << x for x in shift])
    return plan


def negotiated_caps(pipeline) -> Dict[str, str]:
    """A negotiated pipeline (either package's) -> {"element:pad": caps
    string}, every pad of every element in topological order; a pad with
    no caps maps to "None"."""
    return {f"{e.name}:{p.name}": str(p.caps)
            for e in pipeline._topo_order() for p in e.pads}


def resampler_arrays(res) -> Dict[str, np.ndarray]:
    """An AudioResampler (either package's) -> {name: numpy array}."""
    out = {key: np.asarray(getattr(res, key), np.int64)
           for key in ("in_red", "out_red", "n_taps")}
    out["filter_mode"] = np.asarray(res.effective_filter_mode)
    for dt in DTYPES:
        out[f"taps.{dt}"] = np.asarray(res.taps_for(dt))
    return out


def convert_arrays(elem) -> Dict[str, np.ndarray]:
    """A negotiated audioconvert (either package's) -> {name: numpy
    array}: the mix matrix ("mix", float32, and "mix_int", Q10) where it
    mixes, the quantizer's parameters and state where it quantizes.  The
    matrix lives only in the element's function (a closure in both
    packages), so it is read from there."""
    out: Dict[str, np.ndarray] = {}
    fn = elem._fn
    if fn is None:
        return out
    cells = dict(zip(fn.__code__.co_freevars,
                     (c.cell_contents for c in fn.__closure__)))
    if cells.get("mix_m") is not None:
        out["mix"] = np.asarray(cells["mix_m"], np.float32)
        out["mix_int"] = matrix_int(out["mix"])
    q = elem._quant
    if q is not None:
        for key in ("shift", "mask", "bias", "stride"):
            out[f"quant.{key}"] = np.asarray(getattr(q, key), np.int64)
        out["quant.dither"] = np.asarray(q.dither)
        out["quant.ns"] = np.asarray(q.ns)
        out["quant.rng_state"] = np.asarray(q.rng.state, np.uint64)
        out["quant.last"] = np.asarray(q._last, np.int64)
    return out


def quantizer_from_arrays(arrays: Dict[str, np.ndarray]) -> Quantizer:
    """The ``quant.*`` entries of convert_arrays -> this package's
    Quantizer, its PRNG where the other one's stood."""
    q = Quantizer(str(arrays["quant.dither"]), int(arrays["quant.shift"]),
                  int(arrays["quant.stride"]), ns=str(arrays["quant.ns"]))
    q.rng.state = int(arrays["quant.rng_state"])
    q._last = np.array(arrays["quant.last"], np.int64)
    return q


# host attributes that a scan's aux rows or a deinterlacer's output range
# are computed from
_HOST_STATE = ("_phase", "_tval", "_pending")
# a Vad's state, and removesilence's guards and timeline offset
_VAD_STATE = ("power", "ring", "head", "filled", "state", "samples")
_SILENCE_STATE = ("_consec", "_consec_ns", "_ts_offset", "_was_silence")


def _numpy(x) -> np.ndarray:
    if hasattr(x, "cpu"):
        x = x.cpu()
    return np.asarray(x)


def freeverb_arrays(state) -> Dict[str, np.ndarray]:
    """A freeverb's state (either package's ``_state``) -> {"rings": the 24
    rings end to end (combs left, combs right, allpasses left, allpasses
    right), "idx": their 24 indices, "fs": the 16 filterstores}."""
    if "rings" in state:                 # this package's: one stream a row
        return {k: _numpy(state[k])[0] for k in ("rings", "idx", "fs")}
    banks = ("combL", "combR", "apL", "apR")
    return {
        "rings": np.concatenate([np.asarray(b, np.float32) for k in banks
                                 for b in state[k][0]]),
        "idx": np.asarray([int(i) for k in banks for i in state[k][1]],
                          np.int32),
        "fs": np.asarray([float(f) for k in ("combL", "combR")
                          for f in state[k][2]], np.float32),
    }


def vad_arrays(elem) -> Dict[str, Any]:
    """A removesilence (either package's) -> its Vad's state and its
    guards, as numpy arrays and Python numbers."""
    out = {k: getattr(elem._vad, k) for k in _VAD_STATE}
    out["ring"] = np.array(out["ring"], np.int16)
    out.update({k: getattr(elem, k) for k in _SILENCE_STATE})
    return out


def element_states(pipeline) -> Dict[str, Dict[str, Any]]:
    """A pipeline's carried state (either package's) -> {element name:
    {"carry": the scan carry as numpy arrays (0-d for scalars),
    "carry_planes": a deinterlacer's carried frames, the host counters in
    _HOST_STATE, "freeverb": ``freeverb_arrays`` and "vad":
    ``vad_arrays``}}; elements with none of these are left out."""
    states = getattr(pipeline, "_elem_states", None) or {}
    out: Dict[str, Dict[str, Any]] = {}
    for e in pipeline._topo_order():
        entry: Dict[str, Any] = {}
        if e.name in states:
            entry["carry"] = map_leaves(_numpy, states[e.name])
        if getattr(e, "_carry_planes", None) is not None:
            entry["carry_planes"] = tuple(_numpy(p) for p in e._carry_planes)
        for attr in _HOST_STATE:
            if hasattr(e, attr):
                entry[attr] = getattr(e, attr)
        if e.FACTORY == "freeverb" and getattr(e, "_state", None):
            entry["freeverb"] = freeverb_arrays(e._state)
        if e.FACTORY == "removesilence":
            entry["vad"] = vad_arrays(e)
        if getattr(e, "_held", None):
            entry["held"] = [
                dict(data=map_leaves(_numpy, b.data), pts=b.pts, dts=b.dts,
                     duration=b.duration, offset=b.offset, flags=b.flags,
                     batch=b.batch, meta=dict(b.meta)) for b in e._held]
        if entry:
            out[e.name] = entry
    return out


def load_element_states(pipeline, states: Dict[str, Dict[str, Any]]) -> None:
    """Put element_states' dict into this package's pipeline, started
    (``set_state(PLAYING)``): carries on the pipeline's device (the
    carries of stateful elements missing from `states` start from their
    initial values), carried frames as tensors there, host counters as
    they are."""
    dev = pipeline.device
    if pipeline._scan_fns and pipeline._elem_states is None:
        pipeline._elem_states = {
            e.name: _carry_to(init, dev)
            for e, (_, init) in pipeline._scan_fns.items()}
    for name, entry in states.items():
        e = pipeline.get_by_name(name)
        if e is None:
            raise ValueError(f"no element {name!r} in {pipeline.name}")
        if "carry" in entry:
            if name not in (pipeline._elem_states or {}):
                raise ValueError(f"{name}: not a stateful element here")
            pipeline._elem_states[name] = _carry_to(entry["carry"], dev)
        if "carry_planes" in entry:
            e._carry_planes = tuple(torch.from_numpy(np.array(p)).to(dev)
                                    for p in entry["carry_planes"])
        for attr in _HOST_STATE:
            if attr in entry:
                setattr(e, attr, entry[attr])
        if "freeverb" in entry:
            fv = entry["freeverb"]
            e._state = {k: torch.from_numpy(np.array(fv[k]))[None].to(dev)
                        for k in ("rings", "idx", "fs")}
        if "vad" in entry:
            for k, v in entry["vad"].items():
                if k in _VAD_STATE:
                    setattr(e._vad, k, np.array(v, np.int16) if k == "ring"
                            else v)
                else:
                    setattr(e, k, v)
        if "held" in entry:
            e._held = [Buffer(**dict(b, data=map_leaves(
                lambda x: torch.from_numpy(np.array(x)).to(dev), b["data"])))
                for b in entry["held"]]
