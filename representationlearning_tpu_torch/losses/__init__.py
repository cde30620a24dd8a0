"""Losses of the port: the SCD / WSSS losses, the dense energy loss and the RML MI losses."""
