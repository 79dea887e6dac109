"""Composed receivers."""
