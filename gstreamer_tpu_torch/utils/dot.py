"""Pipeline -> Graphviz dot dumps.

A copy of the JAX package's ``utils/dot.py``: the equivalent of
GST_DEBUG_DUMP_DOT_DIR pipeline graphs
(reference: subprojects/gstreamer/gst/gstdebugutils.c:1085).  Set
GTPU_DEBUG_DUMP_DOT_DIR to write `<name>.dot` on negotiation.
"""

from __future__ import annotations

import os
from typing import Optional


def pipeline_to_dot(pipeline) -> str:
    lines = ["digraph pipeline {", "  rankdir=LR;",
             '  node [shape=record, fontsize=10];']
    for e in pipeline.iterate_elements():
        sink_ports = "|".join(f"<{p.name}> {p.name}" for p in e.sink_pads())
        src_ports = "|".join(f"<{p.name}> {p.name}" for p in e.src_pads())
        label_parts = []
        if sink_ports:
            label_parts.append("{%s}" % sink_ports)
        label_parts.append(f"{e.FACTORY}\\n{e.name}")
        if src_ports:
            label_parts.append("{%s}" % src_ports)
        label = "{" + "|".join(label_parts) + "}"
        lines.append(f'  "{e.name}" [label="{label}"];')
    for e in pipeline.iterate_elements():
        for p in e.src_pads():
            if p.peer is not None:
                caps = str(p.caps) if p.caps else ""
                caps_short = caps[:60].replace('"', "'")
                lines.append(
                    f'  "{e.name}":{p.name} -> '
                    f'"{p.peer.element.name}":{p.peer.name} '
                    f'[label="{caps_short}", fontsize=8];')
    lines.append("}")
    return "\n".join(lines)


def maybe_dump(pipeline, suffix: str = "") -> Optional[str]:
    d = os.environ.get("GTPU_DEBUG_DUMP_DOT_DIR")
    if not d:
        return None
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{pipeline.name}{suffix}.dot")
    with open(path, "w") as f:
        f.write(pipeline_to_dot(pipeline))
    return path
