"""Validation monitors and scenarios (gst-validate) of the port."""

from .monitor import PipelineMonitor, Scenario   # noqa: F401
