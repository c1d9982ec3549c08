"""Backbones, heads and wrappers."""
