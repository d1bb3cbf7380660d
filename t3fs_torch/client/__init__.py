"""The EC client's codec seam, on PyTorch/CUDA."""
