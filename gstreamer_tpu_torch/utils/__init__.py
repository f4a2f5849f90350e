"""Host utilities of the port: category logging, the dot dump, typefind
and the MPEG-TS sections (``mpegts_sections``)."""
