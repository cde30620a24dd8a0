"""Inference helpers: test-time augmentation and sliding-window prediction."""
