"""gtpu-inspect — list elements / show element details
(gst-inspect-1.0 equivalent, reference: subprojects/gstreamer/tools/
gst-inspect.c).

    python -m gstreamer_tpu_torch.tools.inspect            # list all
    python -m gstreamer_tpu_torch.tools.inspect videoconvert

A copy of the JAX package's ``tools/inspect.py`` over the port's registry:
it lists the ported factories only.
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="gtpu-inspect")
    ap.add_argument("element", nargs="?", help="element factory to inspect")
    args = ap.parse_args(argv)

    from ..core.element import get_factory_class, list_factories

    if not args.element:
        for f in list_factories():
            cls = get_factory_class(f)
            print(f"{f}:  {cls.DESCRIPTION or cls.KLASS}")
        print(f"\nTotal count: {len(list_factories())} elements")
        return 0

    try:
        cls = get_factory_class(args.element)
    except KeyError:
        print(f"No such element '{args.element}'", file=sys.stderr)
        return 1

    print(f"Factory Details:")
    print(f"  Name          {args.element}")
    print(f"  Klass         {cls.KLASS}")
    print(f"  Description   {cls.DESCRIPTION}")
    print()
    print("Pad Templates:")
    for t in cls.PAD_TEMPLATES:
        print(f"  {t.direction.upper()} template: '{t.name}' ({t.presence})")
        caps = str(t.caps)
        for line in caps.split(";"):
            print(f"    {line.strip()[:100]}")
    print()
    print("Element Properties:")
    for name, (typ, default, doc) in sorted(cls.PROPERTIES.items()):
        print(f"  {name:24s} {getattr(typ, '__name__', 'any'):8s} "
              f"default={default!r}  {doc}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
