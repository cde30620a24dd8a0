"""Losses of the port: the SCD / WSSS losses and the dense energy loss."""
