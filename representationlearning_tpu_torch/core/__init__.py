"""Config tree, component registry and logging: the port's own copies of
``representationlearning_tpu/core/{config,registry,logging}.py``, which the
command-line entry points (``cli/``) build on."""
