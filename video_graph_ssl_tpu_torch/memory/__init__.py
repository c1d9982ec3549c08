"""Contrast memories (MoCo queue, instance-discrimination bank) and losses."""
