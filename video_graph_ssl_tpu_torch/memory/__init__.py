"""MoCo queue and contrastive loss."""
