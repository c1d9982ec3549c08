"""Pretraining state and step."""
