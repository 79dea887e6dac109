"""Recording and replay files."""
