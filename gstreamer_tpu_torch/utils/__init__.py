"""Host utilities of the port: category logging and the dot dump."""
