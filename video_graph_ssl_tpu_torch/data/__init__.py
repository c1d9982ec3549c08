"""On-device augmentation and synthetic data."""
