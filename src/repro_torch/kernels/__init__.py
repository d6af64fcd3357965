"""Kernels of the port: CUDA C++ for Hopper, dispatched by ``ops``
(``ops.flash_attention``, ``ops.tiered_decode_attention``,
``ops.rglru_scan``, ``ops.mlstm_chunkwise``), with their plain PyTorch
versions in ``ref``."""
