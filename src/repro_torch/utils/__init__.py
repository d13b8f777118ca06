"""Statistics helpers."""
