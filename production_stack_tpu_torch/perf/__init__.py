"""Performance accounting of the port (roofline of the decode step)."""
