"""The port's command-line tools: ``launch`` (gst-launch-1.0), ``inspect``
(gst-inspect-1.0), ``typefind`` (gst-typefind-1.0), ``stats``
(gst-stats), ``dotsviewer`` and ``logviewer`` (gst-devtools'
dots-viewer and debug-viewer)."""
