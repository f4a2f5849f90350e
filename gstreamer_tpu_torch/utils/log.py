"""Category-based debug logging (gstinfo.c equivalent).

A copy of the JAX package's ``utils/log.py``; its loggers live under
``gtpu_torch`` (the JAX package's under ``gtpu``), so the two packages'
handlers never print one record twice.

Env var `GTPU_DEBUG` mirrors GST_DEBUG (gstinfo.c:696): a comma-separated
list of `category:level` patterns, e.g. ``GTPU_DEBUG=pipeline:5,*:2``.
Levels: 0 none, 1 ERROR, 2 WARNING, 3 FIXME, 4 INFO, 5 DEBUG, 6 LOG,
7 TRACE.  `GTPU_DEBUG_FILE` redirects output.
"""

from __future__ import annotations

import fnmatch
import logging
import os
import sys

_LEVELS = {
    0: logging.CRITICAL + 10,
    1: logging.ERROR,
    2: logging.WARNING,
    3: logging.WARNING - 1,
    4: logging.INFO,
    5: logging.DEBUG,
    6: logging.DEBUG - 1,
    7: logging.DEBUG - 2,
}

_configured = False
_patterns = []


def _configure():
    global _configured, _patterns
    if _configured:
        return
    _configured = True
    spec = os.environ.get("GTPU_DEBUG", "")
    dest = os.environ.get("GTPU_DEBUG_FILE")
    handler = (logging.FileHandler(dest) if dest
               else logging.StreamHandler(sys.stderr))
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s"))
    root = logging.getLogger("gtpu_torch")
    root.addHandler(handler)
    root.setLevel(logging.ERROR)
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            pat, lvl = part.rsplit(":", 1)
        else:
            pat, lvl = "*", part
        try:
            level = _LEVELS.get(int(lvl), logging.DEBUG)
        except ValueError:
            continue
        _patterns.append((pat, level))


def get_logger(category: str) -> logging.Logger:
    _configure()
    lg = logging.getLogger(f"gtpu_torch.{category}")
    for pat, level in _patterns:
        if fnmatch.fnmatch(category, pat):
            lg.setLevel(level)
    return lg
