"""gst-launch pipeline-description parser.

A copy of the JAX package's ``core/parse.py``, with the pipeline's device
passed through.  gst_parse_launch (reference:
subprojects/gstreamer/gst/parse/grammar.y.in — element rule :1281,
chain/link rules :1358-1486, properties, caps filters, named refs).

Grammar subset (covers the launch lines in BASELINE.json and the common
idioms):

    pipeline  := chain (chain)*
    chain     := endpoint (! link-target)*
    endpoint  := element | ref
    element   := FACTORY (prop=value)*
    ref       := NAME '.' [PADNAME]
    link-target := element | caps-filter | ref
    caps-filter := MEDIATYPE(,...)    e.g. video/x-raw,format=RGB,width=224

A bare caps string between links becomes a `capsfilter` element, exactly
like the reference grammar does.
"""

from __future__ import annotations

import re
import shlex
from typing import Dict, List, Optional, Tuple

from .caps import Caps
from .element import Element, element_factory_make, factory_exists
from .pipeline import Pipeline, link


class ParseError(Exception):
    pass


def _tokenize(text: str) -> List[str]:
    """Split on whitespace and '!' while keeping quoted values intact."""
    lex = shlex.shlex(text, posix=True)
    lex.whitespace_split = True
    lex.commenters = ""
    toks = []
    for t in lex:
        # split off standalone '!' glued to tokens
        while "!" in t and t != "!":
            i = t.index("!")
            if i > 0:
                toks.append(t[:i])
            toks.append("!")
            t = t[i + 1:]
        if t:
            toks.append(t)
    return toks


_CAPS_RE = re.compile(r"^[a-zA-Z0-9]+/[a-zA-Z0-9+.\-]+")
_REF_RE = re.compile(r"^([A-Za-z_][\w\-]*)\.([\w%\-]*)$")


class _BinRef:
    """Marker unit for a parsed `( ... )` bin: linking INTO the bin goes
    to its first element, linking OUT comes from its last element (the
    parser's auto-ghost-pad behavior, grammar.y.in chain rule)."""

    def __init__(self, bin_, first, last):
        self.bin = bin_
        self.first = first
        self.last = last


def parse_launch(description: str, batch: int = 1,
                 device=None) -> Pipeline:
    """Build and return a Pipeline from a launch-line description.

    The pipeline runs on CUDA unless `device` names another device, and
    raises without a card; pass ``device="cpu"`` to run on the CPU (the
    plain PyTorch version of every kernel)."""
    toks = _tokenize(description)
    if not toks:
        raise ParseError("empty pipeline description")

    if toks[-1] == "!" or toks[0] == "!":
        raise ParseError("dangling '!'")

    pipe = Pipeline(device=device)
    pipe.default_batch = batch
    named: Dict[str, Element] = {}
    _build(toks, pipe, pipe, named)
    return pipe


def _build(toks: List[str], pipe, container, named: Dict[str, Element]):
    """Build elements/links from tokens into `container` (pipeline or
    bin).  Returns (first, last) element of the FIRST chain (for bin
    ghost-pad linking)."""
    from .pipeline import Bin

    # Group tokens into units (element + its properties, a caps filter, a
    # named ref, or a `( ... )` bin) and units into chains; a new chain
    # starts at a token that is neither a property nor preceded by '!'.
    raw_chains: List[List] = []
    chain: List = []
    unit: List[str] = []
    pending_link = False
    i = 0
    toks = toks + ["\n"]
    while i < len(toks):
        t = toks[i]
        if t == "(":
            # collect the balanced paren group (gst-launch bins)
            depth = 1
            j = i + 1
            while j < len(toks) and depth:
                if toks[j] == "(":
                    depth += 1
                elif toks[j] == ")":
                    depth -= 1
                j += 1
            if depth:
                raise ParseError("unbalanced '(' in description")
            inner = toks[i + 1:j - 1]
            bin_ = Bin()
            container.add(bin_)
            first, last = _build(inner, pipe, bin_, named)
            if unit:
                raise ParseError("'(' must start a link target")
            chain.append(_BinRef(bin_, first, last))
            pending_link = False
            i = j
            continue
        if t == "!":
            if not unit and not (chain and isinstance(chain[-1], _BinRef)):
                raise ParseError("dangling '!'")
            if unit:
                chain.append(unit)
            unit = []
            pending_link = True
        elif t == "\n":
            if pending_link and not unit:
                raise ParseError("dangling '!' at end of description")
            if unit:
                chain.append(unit)
            if chain:
                raw_chains.append(chain)
        else:
            pending_link = False
            # a token that starts a new element while the current unit is an
            # element-with-props: decide if it's a property or a new chain
            if unit and "=" not in t and not _is_caps_token_continuation(unit, t):
                # new chain boundary
                chain.append(unit)
                raw_chains.append(chain)
                chain = []
                unit = [t]
            else:
                unit.append(t)
        i += 1

    first_of_first = last_of_first = None
    for ci, chain in enumerate(raw_chains):
        prev: Optional[Tuple[Element, Optional[str]]] = None
        for unit in chain:
            if isinstance(unit, _BinRef):
                if prev is not None:
                    pel, ppad = prev
                    link(pel, unit.first, srcpad=ppad)
                prev = (unit.last, None)
                if ci == 0 and first_of_first is None:
                    first_of_first = unit.first
                if ci == 0:
                    last_of_first = unit.last
                continue
            head = unit[0]
            m = _REF_RE.match(head)
            if m and not factory_exists(head):
                name, padname = m.group(1), m.group(2) or None
                if name not in named:
                    raise ParseError(f"no element named {name!r}")
                cur_elem = (named[name], padname)
            elif _CAPS_RE.match(head) and "/" in head:
                caps = Caps.from_string(" ".join(unit))
                cf = element_factory_make("capsfilter", caps=caps)
                container.add(cf)
                cur_elem = (cf, None)
            else:
                if not factory_exists(head):
                    raise ParseError(f"no element factory {head!r}")
                props = {}
                elem_name = None
                for p in unit[1:]:
                    if "=" not in p:
                        raise ParseError(f"bad property {p!r} for {head}")
                    k, v = p.split("=", 1)
                    if k == "name":
                        elem_name = v
                    elif k == "caps":
                        props["caps"] = Caps.from_string(v)
                    else:
                        props[k] = v
                elem = element_factory_make(head, name=elem_name, **props)
                container.add(elem)
                if elem_name:
                    named[elem_name] = elem
                cur_elem = (elem, None)
            if prev is not None:
                pel, ppad = prev
                cel, cpad = cur_elem
                link(pel, cel, srcpad=ppad, sinkpad=cpad)
            prev = cur_elem
            if ci == 0:
                if first_of_first is None:
                    first_of_first = cur_elem[0]
                last_of_first = cur_elem[0]
    return first_of_first, last_of_first


def _is_caps_token_continuation(unit: List[str], tok: str) -> bool:
    """Caps filters may be written with spaces after commas."""
    return bool(unit) and unit[-1].endswith(",")
