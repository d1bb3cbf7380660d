"""The storage node's codec seam, on PyTorch/CUDA."""
