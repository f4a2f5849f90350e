"""Constraint value system for caps negotiation (host only).

A copy of the JAX package's ``core/value.py``: GStreamer's GstValue algebra
(reference: subprojects/gstreamer/gst/gstvalue.c — intersect/union/subtract/
compare per type, gstvalue.c:92-94).  Caps negotiation runs once on the host
before a pipeline runs; these values never reach a tensor.  Scalars
(int/str/bool/float), Fraction, IntRange, DoubleRange, FractionRange and
ValueList.

Fixation semantics mirror gstvalue.c: ranges fixate to their minimum, lists
fixate to their first entry; `fixate_nearest_*` helpers mirror
gststructure.c's fixate_field_nearest_int/fraction.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import total_ordering
from typing import Any, Iterable, Optional


def _gcd(a: int, b: int) -> int:
    return math.gcd(a, b)


@total_ordering
class Fraction:
    """Exact rational number (reference: GST_TYPE_FRACTION, gstvalue.c)."""

    __slots__ = ("num", "denom")

    def __init__(self, num: int, denom: int = 1):
        if denom == 0:
            raise ZeroDivisionError("fraction with zero denominator")
        if denom < 0:
            num, denom = -num, -denom
        g = _gcd(abs(num), denom) or 1
        self.num = num // g
        self.denom = denom // g

    def __repr__(self):
        return f"{self.num}/{self.denom}"

    def __eq__(self, other):
        if isinstance(other, int):
            other = Fraction(other)
        if not isinstance(other, Fraction):
            return NotImplemented
        return self.num == other.num and self.denom == other.denom

    def __lt__(self, other):
        if isinstance(other, int):
            other = Fraction(other)
        return self.num * other.denom < other.num * self.denom

    def __hash__(self):
        return hash(("Fraction", self.num, self.denom))

    def __float__(self):
        return self.num / self.denom

    def __mul__(self, other):
        if isinstance(other, int):
            other = Fraction(other)
        return Fraction(self.num * other.num, self.denom * other.denom)

    def __truediv__(self, other):
        if isinstance(other, int):
            other = Fraction(other)
        return Fraction(self.num * other.denom, self.denom * other.num)

    @staticmethod
    def parse(s: str) -> "Fraction":
        if "/" in s:
            n, d = s.split("/")
            return Fraction(int(n), int(d))
        return Fraction(int(s))


@dataclass(frozen=True)
class IntRange:
    """[low, high] inclusive with optional step (GST_TYPE_INT_RANGE)."""

    low: int
    high: int
    step: int = 1

    def __post_init__(self):
        if self.low > self.high:
            raise ValueError(f"bad int range [{self.low},{self.high}]")

    def __repr__(self):
        if self.step != 1:
            return f"[{self.low},{self.high},{self.step}]"
        return f"[{self.low},{self.high}]"

    def contains(self, v: int) -> bool:
        return (
            isinstance(v, int)
            and self.low <= v <= self.high
            and (v - self.low) % self.step == 0
        )


@dataclass(frozen=True)
class DoubleRange:
    low: float
    high: float

    def __repr__(self):
        return f"[{self.low},{self.high}]"

    def contains(self, v) -> bool:
        return isinstance(v, (int, float)) and self.low <= v <= self.high


@dataclass(frozen=True)
class FractionRange:
    low: Fraction
    high: Fraction

    def __repr__(self):
        return f"[{self.low},{self.high}]"

    def contains(self, v) -> bool:
        if isinstance(v, int):
            v = Fraction(v)
        return isinstance(v, Fraction) and self.low <= v <= self.high


class ValueList:
    """Ordered list of alternatives (GST_TYPE_LIST); first entry wins fixation."""

    __slots__ = ("values",)

    def __init__(self, values: Iterable[Any]):
        self.values = tuple(values)
        if not self.values:
            raise ValueError("empty value list")

    def __repr__(self):
        return "{ " + ", ".join(repr(v) for v in self.values) + " }"

    def __eq__(self, other):
        return isinstance(other, ValueList) and self.values == other.values

    def __iter__(self):
        return iter(self.values)

    def __len__(self):
        return len(self.values)


def is_fixed(v: Any) -> bool:
    """A value is fixed when it is a plain scalar / Fraction (gstvalue.c
    gst_value_is_fixed)."""
    return not isinstance(v, (IntRange, DoubleRange, FractionRange, ValueList))


def _values_of(v: Any):
    if isinstance(v, ValueList):
        return list(v.values)
    return [v]


def intersect(v1: Any, v2: Any) -> Optional[Any]:
    """Intersect two constraint values; None when empty
    (reference semantics: gstvalue.c gst_value_intersect)."""
    # list x anything: pairwise
    if isinstance(v1, ValueList) or isinstance(v2, ValueList):
        out = []
        for a in _values_of(v1):
            for b in _values_of(v2):
                r = intersect(a, b)
                if r is not None:
                    for rv in _values_of(r):
                        if rv not in out:
                            out.append(rv)
        if not out:
            return None
        if len(out) == 1:
            return out[0]
        return ValueList(out)

    if isinstance(v1, IntRange) and isinstance(v2, IntRange):
        lo, hi = max(v1.low, v2.low), min(v1.high, v2.high)
        step = (v1.step * v2.step) // _gcd(v1.step, v2.step)
        # align lo up to a value present in both ranges
        lo = v1.low + ((lo - v1.low + v1.step - 1) // v1.step) * v1.step
        while lo <= hi and (lo - v2.low) % v2.step != 0:
            lo += v1.step
        if lo > hi:
            return None
        n = (hi - lo) // step
        hi = lo + n * step
        if lo == hi:
            return lo
        return IntRange(lo, hi, step)

    if isinstance(v1, DoubleRange) and isinstance(v2, DoubleRange):
        lo, hi = max(v1.low, v2.low), min(v1.high, v2.high)
        if lo > hi:
            return None
        if lo == hi:
            return lo
        return DoubleRange(lo, hi)

    if isinstance(v1, FractionRange) and isinstance(v2, FractionRange):
        lo = max(v1.low, v2.low)
        hi = min(v1.high, v2.high)
        if lo > hi:
            return None
        if lo == hi:
            return lo
        return FractionRange(lo, hi)

    # range x scalar
    for a, b in ((v1, v2), (v2, v1)):
        if isinstance(a, (IntRange, DoubleRange, FractionRange)) and is_fixed(b):
            return b if a.contains(b) else None

    # scalar x scalar — normalize int/Fraction comparisons
    if v1 == v2:
        return v1
    return None


def subtract(minuend: Any, subtrahend: Any) -> Optional[Any]:
    """gst_value_subtract (gstvalue.c:92 registered subtract funcs):
    values of `minuend` NOT in `subtrahend`; None when empty."""
    # list minuend: subtract each member
    if isinstance(minuend, ValueList):
        out = []
        for a in minuend.values:
            r = subtract(a, subtrahend)
            if r is not None:
                out.extend(_values_of(r))
        if not out:
            return None
        return out[0] if len(out) == 1 else ValueList(out)
    # list subtrahend: subtract each member in turn
    if isinstance(subtrahend, ValueList):
        cur = minuend
        for b in subtrahend.values:
            cur = subtract(cur, b)
            if cur is None:
                return None
        return cur

    if isinstance(minuend, IntRange):
        step = minuend.step
        if isinstance(subtrahend, int):
            if not minuend.contains(subtrahend):
                return minuend
            pieces = []
            if subtrahend - step >= minuend.low:
                pieces.append(IntRange(minuend.low, subtrahend - step,
                                       step) if subtrahend - step
                              > minuend.low else minuend.low)
            if subtrahend + step <= minuend.high:
                pieces.append(IntRange(subtrahend + step, minuend.high,
                                       step) if subtrahend + step
                              < minuend.high else minuend.high)
            if not pieces:
                return None
            return pieces[0] if len(pieces) == 1 else ValueList(pieces)
        if isinstance(subtrahend, IntRange) and subtrahend.step == step:
            lo, hi = subtrahend.low, subtrahend.high
            if hi < minuend.low or lo > minuend.high:
                return minuend
            pieces = []
            if lo - step >= minuend.low:
                pieces.append(IntRange(minuend.low, lo - step, step)
                              if lo - step > minuend.low else minuend.low)
            if hi + step <= minuend.high:
                pieces.append(IntRange(hi + step, minuend.high, step)
                              if hi + step < minuend.high
                              else minuend.high)
            if not pieces:
                return None
            return pieces[0] if len(pieces) == 1 else ValueList(pieces)
        return minuend if not isinstance(subtrahend, IntRange) else None

    if isinstance(minuend, (DoubleRange, FractionRange)):
        # continuous ranges: removing a point leaves the range
        # (gst_value_subtract_double_range semantics); removing an
        # overlapping range is unrepresentable without open intervals —
        # the reference returns the non-overlapped parts as closed
        # ranges; we approximate with the closed remainder
        if is_fixed(subtrahend):
            return minuend
        if type(subtrahend) is not type(minuend):
            return minuend
        if (subtrahend.high < minuend.low
                or subtrahend.low > minuend.high):
            return minuend
        pieces = []
        if minuend.low < subtrahend.low:
            pieces.append(type(minuend)(minuend.low, subtrahend.low))
        if subtrahend.high < minuend.high:
            pieces.append(type(minuend)(subtrahend.high, minuend.high))
        if not pieces:
            return None
        return pieces[0] if len(pieces) == 1 else ValueList(pieces)

    # fixed minuend
    if is_fixed(minuend):
        if isinstance(subtrahend, (IntRange, DoubleRange, FractionRange)):
            return None if subtrahend.contains(minuend) else minuend
        return None if minuend == subtrahend else minuend
    return None


def can_intersect(v1: Any, v2: Any) -> bool:
    return intersect(v1, v2) is not None


def is_subset(v1: Any, v2: Any) -> bool:
    """True when every value admitted by v1 is admitted by v2."""
    r = intersect(v1, v2)
    if r is None:
        return False
    return r == v1 or (is_fixed(v1) and r == v1)


def fixate(v: Any) -> Any:
    """Collapse a constraint to one concrete value (gst_value_fixate:
    ranges -> min, lists -> first)."""
    if isinstance(v, IntRange):
        return v.low
    if isinstance(v, DoubleRange):
        return v.low
    if isinstance(v, FractionRange):
        return v.low
    if isinstance(v, ValueList):
        return fixate(v.values[0])
    return v


def fixate_nearest_int(v: Any, target: int) -> Optional[int]:
    """gststructure.c gst_structure_fixate_field_nearest_int semantics."""
    if isinstance(v, int) and not isinstance(v, bool):
        return v
    if isinstance(v, IntRange):
        t = max(v.low, min(v.high, target))
        t = v.low + round((t - v.low) / v.step) * v.step
        return int(min(max(t, v.low), v.high))
    if isinstance(v, ValueList):
        best, bestd = None, None
        for x in v.values:
            c = fixate_nearest_int(x, target)
            if c is None:
                continue
            d = abs(c - target)
            if bestd is None or d < bestd:
                best, bestd = c, d
        return best
    return None


def fixate_nearest_fraction(v: Any, target: Fraction) -> Optional[Fraction]:
    if isinstance(v, Fraction):
        return v
    if isinstance(v, int):
        return Fraction(v)
    if isinstance(v, FractionRange):
        if target < v.low:
            return v.low
        if v.high < target:
            return v.high
        return target
    if isinstance(v, ValueList):
        best, bestd = None, None
        for x in v.values:
            c = fixate_nearest_fraction(x, target)
            if c is None:
                continue
            d = abs(float(c) - float(target))
            if bestd is None or d < bestd:
                best, bestd = c, d
        return best
    return None


def serialize_value(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return v
    return repr(v) if isinstance(v, (Fraction, IntRange, DoubleRange,
                                     FractionRange, ValueList)) else str(v)
