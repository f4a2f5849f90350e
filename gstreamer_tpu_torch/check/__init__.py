"""Test helpers of the port: the single-element ``Harness`` (on the
caller's device) and the deterministic ``TestClock``."""

from .harness import Harness          # noqa: F401
from .testclock import TestClock      # noqa: F401
