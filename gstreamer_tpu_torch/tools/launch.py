"""gtpu-launch — run a pipeline description (gst-launch-1.0 equivalent,
reference: subprojects/gstreamer/tools/gst-launch.c).

    python -m gstreamer_tpu_torch.tools.launch \
        'videotestsrc num-buffers=100 ! videoconvert ! fakesink'

A copy of the JAX package's ``tools/launch.py`` over the port's
``parse_launch``: the pipeline runs on the card; ``--cpu`` runs it on the
CPU (``device="cpu"``).  A model that ``jaxinference`` names must be
registered in the same process (``analytics_elements.register_model``)
before ``main`` runs.
"""

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="gtpu-launch")
    ap.add_argument("pipeline", nargs="+", help="pipeline description")
    ap.add_argument("--batch", type=int, default=1, help="frames per tick")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    from ..core.parse import parse_launch
    from ..core.tracer import hooks

    desc = " ".join(args.pipeline)
    t0 = time.perf_counter()
    p = parse_launch(desc, batch=args.batch,
                     device="cpu" if args.cpu else None)
    if not args.quiet:
        print(f"Setting pipeline to PLAYING ...", file=sys.stderr)
    p.run()
    dt = time.perf_counter() - t0
    err = p.bus.pop_filtered("error")
    if err:
        print(f"ERROR: {err.data}", file=sys.stderr)
        return 1
    if not args.quiet:
        print(f"Got EOS from pipeline after {dt:.3f}s", file=sys.stderr)
        reports = hooks.reports()
        if reports:
            import json
            print(json.dumps(reports, indent=2), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
