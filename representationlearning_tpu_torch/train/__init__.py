"""Trainers: the SCD trainer (train step, validation step), optimisers, state, checkpoints."""
