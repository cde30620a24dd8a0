"""Segmentation metrics: the confusion histogram on the card, the scores on the host."""
