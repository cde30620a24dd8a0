"""Trainers. Only the inference half of the SCD trainer is ported so far."""
