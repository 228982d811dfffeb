"""PyTorch/CUDA port of the low-bit GeMM package (``repro``).

The paper's computation — ternarize or binarize, pack LSB-first 32-bit
bit planes, popcount GeMM, eq. (2) scale epilogue — and its CNN use
case, running on an NVIDIA Hopper card through kernels written by hand
in CUDA C++ (``kernels/csrc``).  Module paths and public names mirror
``src/repro`` so each counterpart is found at the same place; the JAX
package stays the reference the port is tested against.

Every entry point that creates tensors takes ``device=`` and defaults to
``"cuda"``; without a card it raises instead of running on the CPU.  A
kernel wrapper handed CPU tensors runs the kernel's plain PyTorch
version (that is how the CPU tests run); handed CUDA tensors it
launches the kernel or raises.
"""
