"""Host-side runtime of the port: caps, elements, pipeline, launch parser."""
