"""Optimizer and LR schedule."""
