"""PyTorch/CUDA port of ``representationlearning_tpu`` for NVIDIA Hopper (H100).

The JAX package is the reference; this package mirrors its layout (``models/``,
``ops/``, ``convert/``) and keeps the reference PyTorch state_dict names. Kernels
written by hand for sm_90a live under ``csrc/`` and are built at first use
(``ops/_build.py``). Importing this package never imports JAX.
"""
