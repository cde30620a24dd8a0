"""Events and visualisation of the command lines: the port's copies of
``representationlearning_tpu/utils/{events,visualize}.py``."""
