"""Attention kernels of the port: CUDA C++ for Hopper, dispatched by
``ops`` (``ops.flash_attention``, ``ops.tiered_decode_attention``), with
their plain PyTorch versions in ``ref``."""
