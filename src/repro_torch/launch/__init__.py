"""Step functions of the port (the LGC train step)."""
