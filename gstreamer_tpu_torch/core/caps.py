"""Media-type constraint sets ("caps"), host only.

A copy of the JAX package's ``core/caps.py``: GstCaps (reference:
subprojects/gstreamer/gst/gstcaps.c — array of GstStructure;
gst_caps_intersect gstcaps.c:2205, is_subset :1728, can_intersect :1945,
fixate :2666).

Caps describe an element's configuration space: once the pipeline has
negotiated fixed caps on every pad, each element builds the torch function
it runs for exactly that configuration.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Union

from .structure import Structure, parse_structure, _split_top


class Caps:
    """An ordered list of Structures; empty list = EMPTY; ``Caps.any()`` = ANY."""

    def __init__(self, structures: Union[str, Structure, Iterable[Structure], None] = None,
                 any_: bool = False):
        self._any = any_
        if structures is None:
            self.structures: List[Structure] = []
        elif isinstance(structures, str):
            self.structures = Caps.from_string(structures).structures
        elif isinstance(structures, Structure):
            self.structures = [structures]
        else:
            self.structures = list(structures)

    # -- constructors -----------------------------------------------------
    @staticmethod
    def any() -> "Caps":
        return Caps(any_=True)

    @staticmethod
    def empty() -> "Caps":
        return Caps()

    @staticmethod
    def from_string(text: str) -> "Caps":
        text = text.strip()
        if text == "ANY":
            return Caps.any()
        if text in ("EMPTY", "NONE", ""):
            return Caps.empty()
        return Caps([parse_structure(p) for p in _split_top(text, ";")])

    # -- predicates -------------------------------------------------------
    @property
    def is_any(self) -> bool:
        return self._any

    @property
    def is_empty(self) -> bool:
        return not self._any and not self.structures

    def is_fixed(self) -> bool:
        return (
            not self._any
            and len(self.structures) == 1
            and self.structures[0].is_fixed()
        )

    # -- set algebra ------------------------------------------------------
    def intersect(self, other: "Caps") -> "Caps":
        if self._any:
            return Caps(list(other.structures), any_=other._any)
        if other._any:
            return Caps(list(self.structures))
        out: List[Structure] = []
        # gst_caps_intersect default mode ZIG_ZAG keeps ordering preference of
        # both caps; plain nested order is fine for negotiation correctness.
        for s1 in self.structures:
            for s2 in other.structures:
                r = s1.intersect(s2)
                if r is not None and not any(r == o for o in out):
                    out.append(r)
        return Caps(out)

    def can_intersect(self, other: "Caps") -> bool:
        return not self.intersect(other).is_empty

    def is_subset(self, superset: "Caps") -> bool:
        if superset._any:
            return True
        if self._any:
            return False
        return all(
            any(s.is_subset(sup) for sup in superset.structures)
            for s in self.structures
        )

    def union(self, other: "Caps") -> "Caps":
        if self._any or other._any:
            return Caps.any()
        out = list(self.structures)
        for s in other.structures:
            if not any(s == o for o in out):
                out.append(s)
        return Caps(out)

    # -- fixation ---------------------------------------------------------
    def truncate(self) -> "Caps":
        if self._any or not self.structures:
            return self
        return Caps([self.structures[0]])

    def fixate(self) -> "Caps":
        """gst_caps_fixate: truncate to the first structure and fixate every
        field (ranges -> min, lists -> first)."""
        if self._any:
            raise ValueError("cannot fixate ANY caps")
        if not self.structures:
            raise ValueError("cannot fixate EMPTY caps")
        return Caps([self.structures[0].fixate()])

    def simplify(self) -> "Caps":
        out: List[Structure] = []
        for s in self.structures:
            if not any(s == o for o in out):
                out.append(s)
        return Caps(out, any_=self._any)

    # -- accessors --------------------------------------------------------
    def __len__(self):
        return len(self.structures)

    def __getitem__(self, i: int) -> Structure:
        return self.structures[i]

    def __iter__(self):
        return iter(self.structures)

    def __bool__(self):
        return self._any or bool(self.structures)

    def __eq__(self, other):
        return (
            isinstance(other, Caps)
            and self._any == other._any
            and self.structures == other.structures
        )

    def __repr__(self):
        if self._any:
            return "ANY"
        if not self.structures:
            return "EMPTY"
        return "; ".join(repr(s) for s in self.structures)
