"""Host utilities of the port: category logging, the dot dump, typefind,
the MPEG-TS sections (``mpegts_sections``), the tag readers and writers,
pbutils' descriptions and encoding profiles, and the discoverer."""
