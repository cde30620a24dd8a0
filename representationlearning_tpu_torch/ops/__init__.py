"""Ops of the port: image ops and the hand-written kernels with their plain versions."""
