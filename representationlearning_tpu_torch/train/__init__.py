"""Trainers: the SCD trainer (train step, validation step), the RML train step, optimisers,
state, checkpoints."""
