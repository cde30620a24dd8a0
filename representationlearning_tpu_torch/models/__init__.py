"""Models of the port (NCHW images, reference state_dict names)."""
