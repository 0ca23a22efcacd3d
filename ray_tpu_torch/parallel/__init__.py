"""Attention backends (the single-device dense one so far)."""
