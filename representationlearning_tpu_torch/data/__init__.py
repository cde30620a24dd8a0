"""On-device data augmentation: the classification chain of the RML trainer."""
