"""Mesh/sharding: channel-axis and stream-axis (time) parallelism."""
