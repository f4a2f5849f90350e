"""The port's command-line tools: ``launch`` (gst-launch-1.0) and
``inspect`` (gst-inspect-1.0)."""
