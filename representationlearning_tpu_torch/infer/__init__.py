"""Inference helpers: test-time augmentation, sliding-window prediction and DRFL's
evaluation."""
