"""Data: the on-device augmentation of the RML trainer (the classification chain) and
DRFL's paired medical dataset."""
