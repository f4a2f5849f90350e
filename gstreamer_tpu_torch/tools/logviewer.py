"""debug-viewer — browse framework debug logs as filterable HTML.

The gst-devtools debug-viewer analog (subprojects/gst-devtools/
debug-viewer/GstDebugViewer/ loads GST_DEBUG log files, filters by
level/category, and navigates by timestamp).  This implementation
parses BOTH log dialects —

* the framework's own ``GTPU_DEBUG_FILE`` output
  (``2026-01-02 03:04:05,678 DEBUG gtpu.pipeline: message``), and
* the reference's ``GST_DEBUG_FILE`` format
  (``0:00:00.123456789 12345 0x7f.. DEBUG category file.c:42:fn:<obj>
  message``, gstinfo.c gst_debug_log_default)

— and renders a self-contained HTML page (no server, like
tools/dotsviewer.py) with live level/category/text filters, or prints
a filtered view to the terminal.

    python -m gstreamer_tpu_torch.tools.logviewer LOG [-o out.html]
        [--level LEVEL] [--category GLOB] [--grep TEXT]

A copy of the JAX package's ``tools/logviewer.py`` (host text only).  Its
framework dialect also reads the port's own ``utils/log.py`` lines, whose
loggers live under ``gtpu_torch`` (``... DEBUG gtpu_torch.pipeline:
message``); a line of either package gives the same category.
"""

from __future__ import annotations

import argparse
import fnmatch
import html
import re
import sys
from dataclasses import dataclass
from typing import List, Optional

LEVELS = ["NONE", "ERROR", "WARNING", "FIXME", "INFO", "DEBUG", "LOG",
          "TRACE"]
_LEVEL_NO = {name: i for i, name in enumerate(LEVELS)}
# python logging names that appear in GTPU logs
_ALIASES = {"CRITICAL": "ERROR", "WARN": "WARNING",
            "Level 29": "FIXME", "Level 9": "LOG", "Level 8": "TRACE"}

_GTPU_RE = re.compile(
    r"^(?P<ts>\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}[,.]\d+)\s+"
    r"(?P<level>[A-Za-z ]+?\d*)\s+gtpu(?:_torch)?\.(?P<cat>[\w.-]+):\s"
    r"(?P<msg>.*)$")
_GST_RE = re.compile(
    r"^(?P<ts>\d+:\d{2}:\d{2}\.\d+)\s+(?P<pid>\d+)\s+"
    r"(?P<thread>0x[0-9a-f]+)\s+(?P<level>[A-Z]+)\s+"
    r"(?P<cat>[\w-]+)\s+(?P<loc>\S+:\d+:[^:]*:(?:<[^>]*>)?)\s*"
    r"(?P<msg>.*)$")


@dataclass
class LogLine:
    ts: str
    level: str                 # canonical name from LEVELS
    category: str
    message: str
    raw: str = ""
    location: str = ""         # file:line:func (reference dialect)

    @property
    def level_no(self) -> int:
        return _LEVEL_NO.get(self.level, 5)


def parse_line(line: str) -> Optional[LogLine]:
    line = line.rstrip("\n")
    m = _GTPU_RE.match(line)
    if m:
        lvl = m.group("level").strip()
        lvl = _ALIASES.get(lvl, lvl)
        if lvl not in _LEVEL_NO:
            lvl = "DEBUG"
        return LogLine(ts=m.group("ts"), level=lvl,
                       category=m.group("cat"),
                       message=m.group("msg"), raw=line)
    m = _GST_RE.match(line)
    if m:
        lvl = _ALIASES.get(m.group("level"), m.group("level"))
        if lvl not in _LEVEL_NO:
            lvl = "DEBUG"
        return LogLine(ts=m.group("ts"), level=lvl,
                       category=m.group("cat"),
                       message=m.group("msg"), raw=line,
                       location=m.group("loc"))
    return None


def parse_log(path: str) -> List[LogLine]:
    """Parse a log file; unparseable lines are folded into the
    previous entry (multi-line messages), like the reference viewer's
    lazy line model."""
    out: List[LogLine] = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            ll = parse_line(line)
            if ll is not None:
                out.append(ll)
            elif out and line.strip():
                out[-1].message += "\n" + line.rstrip("\n")
    return out


def filter_lines(lines: List[LogLine], level: Optional[str] = None,
                 category: Optional[str] = None,
                 grep: Optional[str] = None) -> List[LogLine]:
    """Level threshold (shows level and above in severity), category
    glob, substring search — the debug-viewer filter set."""
    out = lines
    if level:
        maxno = _LEVEL_NO[level.upper()]
        out = [l for l in out if l.level_no <= maxno]
    if category:
        out = [l for l in out
               if fnmatch.fnmatch(l.category, category)]
    if grep:
        out = [l for l in out if grep in l.message or grep in l.raw]
    return out


_COLORS = {"ERROR": "#d33", "WARNING": "#b80", "FIXME": "#a6a",
           "INFO": "#283", "DEBUG": "#47c", "LOG": "#888",
           "TRACE": "#aaa"}

_PAGE = """<!doctype html><meta charset="utf-8">
<title>gtpu debug-viewer</title>
<style>
body{{font:13px/1.45 monospace;margin:0;background:#fafafa}}
#bar{{position:sticky;top:0;background:#eee;padding:6px 10px;
border-bottom:1px solid #ccc}}
#bar input,#bar select{{font:inherit;margin-right:8px}}
table{{border-collapse:collapse;width:100%}}
td{{padding:1px 8px;vertical-align:top;white-space:pre-wrap}}
td.ts{{color:#999;white-space:nowrap}}
td.lv{{font-weight:bold;white-space:nowrap}}
td.cat{{color:#559;white-space:nowrap}}
tr:hover{{background:#eef}}
</style>
<div id="bar">
 level <select id="lv" onchange="apply()">{level_opts}</select>
 category <input id="cat" size=14 oninput="apply()" placeholder="glob">
 search <input id="q" size=24 oninput="apply()">
 <span id="count"></span>
</div>
<table id="t">{rows}</table>
<script>
const LV={{{lv_map}}};
function apply(){{
  const maxno=+document.getElementById('lv').value;
  const cat=document.getElementById('cat').value;
  const q=document.getElementById('q').value.toLowerCase();
  const re=cat?new RegExp('^'+cat.replace(/[.+^${{}}()|\\\\]/g,'\\\\$&')
      .replace(/\\*/g,'.*').replace(/\\?/g,'.')+'$'):null;
  let n=0;
  for(const tr of document.getElementById('t').rows){{
    const ok=(LV[tr.dataset.lv]<=maxno)
      &&(!re||re.test(tr.dataset.cat))
      &&(!q||tr.textContent.toLowerCase().includes(q));
    tr.style.display=ok?'':'none'; if(ok)n++;
  }}
  document.getElementById('count').textContent=n+' lines';
}}
apply();
</script>
"""


def render_html(lines: List[LogLine], out_path: str) -> None:
    rows = []
    for l in lines:
        color = _COLORS.get(l.level, "#47c")
        loc = f" <span style='color:#aaa'>{html.escape(l.location)}" \
              f"</span>" if l.location else ""
        rows.append(
            f"<tr data-lv='{l.level}' data-cat='{html.escape(l.category)}'>"
            f"<td class=ts>{html.escape(l.ts)}</td>"
            f"<td class=lv style='color:{color}'>{l.level}</td>"
            f"<td class=cat>{html.escape(l.category)}</td>"
            f"<td>{html.escape(l.message)}{loc}</td></tr>")
    level_opts = "".join(
        f"<option value={i}{' selected' if n == 'TRACE' else ''}>{n}"
        f"</option>" for n, i in _LEVEL_NO.items() if i > 0)
    lv_map = ",".join(f"'{n}':{i}" for n, i in _LEVEL_NO.items())
    with open(out_path, "w") as f:
        f.write(_PAGE.format(rows="\n".join(rows),
                             level_opts=level_opts, lv_map=lv_map))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="browse GTPU_DEBUG / GST_DEBUG log files")
    ap.add_argument("log")
    ap.add_argument("-o", "--output", help="write an HTML view")
    ap.add_argument("--level", help="threshold (ERROR..TRACE)")
    ap.add_argument("--category", help="category glob")
    ap.add_argument("--grep", help="substring filter")
    args = ap.parse_args(argv)
    lines = filter_lines(parse_log(args.log), level=args.level,
                         category=args.category, grep=args.grep)
    if args.output:
        render_html(lines, args.output)
        print(f"{len(lines)} lines -> {args.output}")
    else:
        for l in lines:
            print(f"{l.ts} {l.level:<7} {l.category:<16} {l.message}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
