"""gst-stats equivalent: run a pipeline with tracers and print a report.

Reference: subprojects/gstreamer/tools/gst-stats.c (parses tracer logs
into per-element stats).  Here tracers run in-process (core/tracer.py)
and the report prints directly.

    python -m gstreamer_tpu_torch.tools.stats [--cpu] \
        'videotestsrc num-buffers=30 ! fakesink'

A copy of the JAX package's ``tools/stats.py`` over the port's
``parse_launch``: the pipeline runs on the card; ``--cpu`` runs it on the
CPU (``device="cpu"``), as ``tools/launch.py`` does.
"""

from __future__ import annotations

import json
import os
import sys


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    cpu = "--cpu" in argv
    argv = [a for a in argv if a != "--cpu"]
    if not argv:
        print(__doc__)
        return 2
    os.environ.setdefault("GTPU_TRACERS", "latency;stats;rusage")
    from ..core.parse import parse_launch
    from ..core.tracer import hooks

    pipe = parse_launch(" ".join(argv), device="cpu" if cpu else None)
    pipe.run()
    print(json.dumps(hooks.reports(), indent=2, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
