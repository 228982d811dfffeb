"""Low-bit kernels of the port: bit-plane containers, the registry, the
CUDA GeMM and implicit-im2col conv kernels with their plain PyTorch
versions, and the ``qmm`` / ``qconv`` entry points (``kernels/ops.py``)."""
