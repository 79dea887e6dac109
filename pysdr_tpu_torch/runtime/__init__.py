"""Host runtime: the streaming executive."""
