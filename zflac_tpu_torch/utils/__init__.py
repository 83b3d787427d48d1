"""Host utilities of the port (scoped debug logging)."""
