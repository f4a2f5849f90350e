"""Typed name→value dictionary used inside Caps (host only).

A copy of the JAX package's ``core/structure.py``: GstStructure (reference:
subprojects/gstreamer/gst/gststructure.c — typed name→GValue dict with
fixation helpers).  Values are the constraint types of :mod:`.value`.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Optional, Tuple

from .value import (
    DoubleRange,
    Fraction,
    FractionRange,
    IntRange,
    ValueList,
    fixate,
    intersect,
    is_fixed,
    serialize_value,
)


class CapsFeatures:
    """Memory/meta capability features attached to a caps structure.

    GstCapsFeatures analog (reference:
    subprojects/gstreamer/gst/gstcapsfeatures.c:1 — caps are pairs of
    (structure, features), intersect honors features at gstcaps.c:2205).
    The reference's own precedent for negotiated accelerator residency
    is ``memory:GLMemory``; the features here are the JAX package's, so
    negotiated caps read the same in both packages:

    * ``memory:HBM`` — frames live as tensors in device memory, between
      two elements that both run on the device;
    * ``memory:SystemMemory`` (alias ``memory:Host``) — across a host
      element's boundary, the default;
    * ``(ANY)`` — matches every feature set.

    Framework deviation from the reference, by design: a structure with
    NO features (None) is *memory-agnostic* and intersects with any
    explicit features — element templates here don't enumerate memory
    residency; the pipeline's negotiation resolution pass assigns the
    concrete feature per link afterwards (memory:HBM inside fused
    device segments, SystemMemory across host boundaries)."""

    SYSMEM = "memory:SystemMemory"
    HBM = "memory:HBM"

    __slots__ = ("items", "is_any")

    def __init__(self, *items: str, any_: bool = False):
        if len(items) == 1 and isinstance(items[0], (list, tuple)):
            items = tuple(items[0])
        self.items = tuple(items)
        self.is_any = any_

    @staticmethod
    def any() -> "CapsFeatures":
        return CapsFeatures(any_=True)

    @staticmethod
    def from_string(text: str) -> "CapsFeatures":
        text = text.strip()
        if text == "ANY":
            return CapsFeatures.any()
        return CapsFeatures(*[t.strip() for t in text.split(",")
                              if t.strip()])

    def normalized(self):
        items = tuple(sorted(
            CapsFeatures.SYSMEM if i == "memory:Host" else i
            for i in self.items))
        return items or (CapsFeatures.SYSMEM,)

    def is_sysmem(self) -> bool:
        return (not self.is_any
                and self.normalized() == (CapsFeatures.SYSMEM,))

    def __contains__(self, item: str) -> bool:
        return (CapsFeatures.SYSMEM if item == "memory:Host"
                else item) in self.normalized()

    def __eq__(self, other):
        if not isinstance(other, CapsFeatures):
            return NotImplemented
        if self.is_any or other.is_any:
            return self.is_any == other.is_any
        return self.normalized() == other.normalized()

    def __hash__(self):
        return hash(("ANY",) if self.is_any else self.normalized())

    def __repr__(self):
        return "ANY" if self.is_any else ", ".join(self.items)


def features_compatible(f1: Optional[CapsFeatures],
                        f2: Optional[CapsFeatures]) -> bool:
    """None = memory-agnostic (matches anything); ANY matches anything;
    otherwise normalized equality (gstcaps.c:2205 semantics)."""
    if f1 is None or f2 is None or f1.is_any or f2.is_any:
        return True
    return f1.normalized() == f2.normalized()


def merge_features(f1: Optional[CapsFeatures],
                   f2: Optional[CapsFeatures]
                   ) -> Optional[CapsFeatures]:
    """Intersection result: the more specific feature set wins."""
    for f in (f1, f2):
        if f is not None and not f.is_any:
            return f
    return f1 if f1 is not None else f2


class Structure:
    def __init__(self, name: str, fields: Optional[Dict[str, Any]] = None,
                 features: Optional[CapsFeatures] = None, **kw):
        self.name = name
        self.features = features
        self.fields: Dict[str, Any] = dict(fields or {})
        self.fields.update(kw)

    # -- mapping protocol -------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self.fields[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self.fields[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self.fields

    def get(self, key: str, default: Any = None) -> Any:
        return self.fields.get(key, default)

    def keys(self):
        return self.fields.keys()

    def items(self) -> Iterator[Tuple[str, Any]]:
        return iter(self.fields.items())

    def copy(self) -> "Structure":
        return Structure(self.name, dict(self.fields),
                         features=self.features)

    def remove(self, *keys: str) -> "Structure":
        s = self.copy()
        for k in keys:
            s.fields.pop(k, None)
        return s

    # -- negotiation ------------------------------------------------------
    def is_fixed(self) -> bool:
        return all(is_fixed(v) for v in self.fields.values())

    def intersect(self, other: "Structure") -> Optional["Structure"]:
        """gst_structure_intersect: same name, common fields intersect,
        fields present on only one side are kept as-is; caps features
        must be compatible (gstcaps.c:2205) and the more specific set
        carries into the result."""
        if self.name != other.name:
            return None
        if not features_compatible(self.features, other.features):
            return None
        out: Dict[str, Any] = {}
        for k in set(self.fields) | set(other.fields):
            if k in self.fields and k in other.fields:
                r = intersect(self.fields[k], other.fields[k])
                if r is None:
                    return None
                out[k] = r
            else:
                out[k] = self.fields.get(k, other.fields.get(k))
        return Structure(self.name, out,
                         features=merge_features(self.features,
                                                 other.features))

    def can_intersect(self, other: "Structure") -> bool:
        return self.intersect(other) is not None

    def is_subset(self, superset: "Structure") -> bool:
        """Every fixed instance of self is admitted by superset.

        Mirrors gst_structure_is_subset: fields present in the superset but
        missing in the subset make it NOT a subset (missing field = ANY on
        our side, which is wider than their constraint)."""
        if self.name != superset.name:
            return False
        if not features_compatible(self.features, superset.features):
            return False
        for k, sv in superset.fields.items():
            if k not in self.fields:
                return False
            r = intersect(self.fields[k], sv)
            if r is None or r != self.fields[k]:
                return False
        return True

    def fixate(self) -> "Structure":
        return Structure(self.name,
                         {k: fixate(v) for k, v in self.fields.items()},
                         features=self.features)

    # -- serialization ----------------------------------------------------
    def __repr__(self):
        inner = ", ".join(
            f"{k}={serialize_value(v)}" for k, v in self.fields.items()
        )
        name = self.name + (f"({self.features!r})"
                            if self.features is not None else "")
        return name + (f", {inner}" if inner else "")

    def __eq__(self, other):
        return (
            isinstance(other, Structure)
            and self.name == other.name
            and self.fields == other.fields
            and (self.features == other.features
                 or features_compatible(self.features, other.features)
                 and (self.features is None or other.features is None))
        )


_TOKEN_RE = re.compile(r"\s*([^=,]+)=\s*")


def _parse_value(text: str) -> Any:
    text = text.strip()
    # typed values: (int)320, (string)foo, (fraction)30/1
    m = re.match(r"^\((int|uint|string|boolean|bool|double|float|fraction)\)(.*)$", text)
    if m:
        typ, rest = m.group(1), m.group(2).strip()
        if typ in ("int", "uint"):
            return int(rest)
        if typ in ("boolean", "bool"):
            return rest.lower() in ("true", "1", "yes")
        if typ in ("double", "float"):
            return float(rest)
        if typ == "fraction":
            return Fraction.parse(rest)
        return rest
    if text.startswith("[") and text.endswith("]"):
        parts = [p.strip() for p in text[1:-1].split(",")]
        vals = [_parse_value(p) for p in parts]
        if all(isinstance(v, int) for v in vals):
            return IntRange(*vals)
        if any(isinstance(v, float) for v in vals):
            return DoubleRange(float(vals[0]), float(vals[1]))
        vals = [Fraction(v) if isinstance(v, int) else v for v in vals]
        return FractionRange(vals[0], vals[1])
    if text.startswith("{") and text.endswith("}"):
        parts = _split_top(text[1:-1], ",")
        return ValueList([_parse_value(p) for p in parts])
    if re.match(r"^-?\d+/\d+$", text):
        return Fraction.parse(text)
    if re.match(r"^-?\d+$", text):
        return int(text)
    if re.match(r"^-?\d*\.\d+$", text):
        return float(text)
    if text.lower() in ("true", "false"):
        return text.lower() == "true"
    return text.strip('"')


def _split_top(s: str, sep: str):
    """Split on sep at depth 0 wrt (), [], {}."""
    out, depth, cur = [], 0, []
    for ch in s:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == sep and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return [p.strip() for p in out if p.strip()]


def parse_structure(text: str) -> Structure:
    """Parse 'video/x-raw, format=I420, width=320' style strings
    (reference: gst_structure_from_string)."""
    parts = _split_top(text, ",")
    if not parts:
        raise ValueError(f"empty structure string: {text!r}")
    name = parts[0].strip()
    features = None
    if "(" in name and name.endswith(")"):
        name, _, feat = name.partition("(")
        name = name.strip()
        features = CapsFeatures.from_string(feat[:-1])
    fields: Dict[str, Any] = {}
    for p in parts[1:]:
        if "=" not in p:
            raise ValueError(f"bad field {p!r} in {text!r}")
        k, v = p.split("=", 1)
        if not v.strip():
            raise ValueError(f"empty value for field {k.strip()!r} in {text!r}")
        fields[k.strip()] = _parse_value(v)
    return Structure(name, fields, features=features)
