"""Trainers: the SCD trainer (train step, validation step), the RML, RSSFormer and DRFL
train steps, optimisers, state, checkpoints."""
