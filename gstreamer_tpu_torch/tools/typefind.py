"""gst-typefind-1.0 equivalent: sniff the media type of files.

Usage: python -m gstreamer_tpu_torch.tools.typefind FILE [FILE...]

A copy of the JAX package's ``tools/typefind.py`` over the port's
``utils/typefind.py`` (host bytes only).
"""

from __future__ import annotations

import sys

from ..utils.typefind import type_find_file


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    if not args:
        print(__doc__.strip())
        return 2
    status = 0
    for path in args:
        try:
            media, prob = type_find_file(path)
        except OSError as e:
            print(f"{path}: error: {e}", file=sys.stderr)
            status = 1
            continue
        if media:
            print(f"{path} - {media}, probability={prob}")
        else:
            print(f"{path} - No type found")
            status = 3
    return status


if __name__ == "__main__":
    raise SystemExit(main())
