"""Test helpers of the port: the deterministic ``TestClock``."""

from .testclock import TestClock      # noqa: F401
