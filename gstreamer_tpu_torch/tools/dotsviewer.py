"""dots-viewer — browse pipeline dot dumps as standalone HTML/SVG.

The gst-devtools dots-viewer analog (subprojects/gst-devtools/
dots-viewer/ serves GST_DEBUG_DUMP_DOT_DIR graphs in a browser).
This renderer needs no graphviz or server: it parses the dot files
our utils/dot.py writes, lays the element graph out in topological
columns, and emits a self-contained HTML page with inline SVG.

    python -m gstreamer_tpu_torch.tools.dotsviewer [dump-dir] [-o out.html]

A copy of the JAX package's ``tools/dotsviewer.py``, for the dot files the
port's ``utils/dot.py`` writes (the same dialect; host text only).
"""

from __future__ import annotations

import html
import os
import re
import sys
from typing import Dict, List, Tuple


def parse_dot(text: str):
    """Parse the subset of dot that utils/dot.py emits:
    nodes with record labels, edges with caps labels."""
    nodes: Dict[str, str] = {}
    edges: List[Tuple[str, str, str]] = []
    for m in re.finditer(r'"([^"]+)"\s*\[label="([^"]*)"\]', text):
        name, label = m.group(1), m.group(2)
        # record label: pull the factory\nname part
        core = [p for p in re.split(r"[{}|]", label)
                if "\\n" in p or (p and not p.startswith("<"))]
        pretty = core[0].replace("\\n", "\n") if core else name
        nodes[name] = pretty
    for m in re.finditer(
            r'"([^"]+)":\S+\s*->\s*"([^"]+)":\S+\s*'
            r'\[label="([^"]*)"', text):
        edges.append((m.group(1), m.group(2), m.group(3)))
    return nodes, edges


def _layout(nodes, edges):
    """Topological columns, rows by arrival order."""
    indeg = {n: 0 for n in nodes}
    adj = {n: [] for n in nodes}
    for a, b, _ in edges:
        if a in indeg and b in indeg:
            indeg[b] += 1
            adj[a].append(b)
    col = {n: 0 for n in nodes}
    ready = [n for n, d in indeg.items() if d == 0]
    seen = set(ready)
    while ready:
        n = ready.pop(0)
        for m in adj[n]:
            col[m] = max(col[m], col[n] + 1)
            indeg[m] -= 1
            if indeg[m] == 0 and m not in seen:
                seen.add(m)
                ready.append(m)
    rows: Dict[int, int] = {}
    pos = {}
    for n in nodes:
        c = col[n]
        r = rows.get(c, 0)
        rows[c] = r + 1
        pos[n] = (c, r)
    return pos


def dot_to_svg(text: str, title: str = "") -> str:
    nodes, edges = parse_dot(text)
    pos = _layout(nodes, edges)
    BW, BH, GX, GY, PAD = 170, 54, 70, 36, 24
    width = PAD * 2 + max((c for c, _ in pos.values()), default=0) \
        * (BW + GX) + BW
    height = PAD * 2 + max((r for _, r in pos.values()), default=0) \
        * (BH + GY) + BH + 20

    def xy(n):
        c, r = pos[n]
        return PAD + c * (BW + GX), PAD + r * (BH + GY)

    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" '
             f'width="{width}" height="{height}" '
             f'font-family="monospace" font-size="11">']
    if title:
        parts.append(f'<text x="{PAD}" y="{height - 8}" '
                     f'fill="#666">{html.escape(title)}</text>')
    for a, b, caps in edges:
        if a not in pos or b not in pos:
            continue
        x1, y1 = xy(a)
        x2, y2 = xy(b)
        sx, sy = x1 + BW, y1 + BH // 2
        ex, ey = x2, y2 + BH // 2
        mx = (sx + ex) / 2
        parts.append(
            f'<path d="M{sx},{sy} C{mx},{sy} {mx},{ey} {ex},{ey}" '
            f'fill="none" stroke="#4878b0" stroke-width="1.5"/>')
        parts.append(
            f'<polygon points="{ex},{ey} {ex - 7},{ey - 4} '
            f'{ex - 7},{ey + 4}" fill="#4878b0"/>')
        if caps:
            short = html.escape(caps[:40])
            parts.append(
                f'<text x="{mx}" y="{(sy + ey) / 2 - 4}" '
                f'text-anchor="middle" font-size="8" '
                f'fill="#777">{short}</text>')
    for n, label in nodes.items():
        if n not in pos:
            continue
        x, y = xy(n)
        lines = label.split("\n")
        parts.append(
            f'<rect x="{x}" y="{y}" width="{BW}" height="{BH}" '
            f'rx="6" fill="#f2f6fb" stroke="#34506e"/>')
        for i, ln in enumerate(lines[:2]):
            weight = "bold" if i == 0 else "normal"
            parts.append(
                f'<text x="{x + BW / 2}" y="{y + 20 + i * 16}" '
                f'text-anchor="middle" font-weight="{weight}">'
                f'{html.escape(ln)}</text>')
    parts.append("</svg>")
    return "".join(parts)


def render_dir(dump_dir: str, out_path: str) -> int:
    files = sorted(f for f in os.listdir(dump_dir)
                   if f.endswith(".dot"))
    sections = []
    for f in files:
        with open(os.path.join(dump_dir, f)) as fh:
            text = fh.read()
        sections.append(
            f"<h2>{html.escape(f)}</h2>\n" + dot_to_svg(text, f))
    page = ("<!doctype html><html><head><meta charset='utf-8'>"
            "<title>gstreamer_tpu pipeline graphs</title>"
            "<style>body{font-family:sans-serif;margin:24px}"
            "h2{border-bottom:1px solid #ccc}</style></head><body>"
            "<h1>Pipeline graphs</h1>"
            + "\n".join(sections) + "</body></html>")
    with open(out_path, "w") as f:
        f.write(page)
    return len(files)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    out = "pipelines.html"
    if "-o" in argv:
        i = argv.index("-o")
        out = argv[i + 1]
        del argv[i:i + 2]
    dump_dir = argv[0] if argv else \
        os.environ.get("GTPU_DEBUG_DUMP_DOT_DIR", ".")
    n = render_dir(dump_dir, out)
    print(f"rendered {n} graph(s) -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
