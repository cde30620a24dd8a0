"""Weakly-supervised segmentation utilities (CAMs, pseudo labels)."""
