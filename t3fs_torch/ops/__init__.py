"""Codec math of the port: numpy copies of the GF(2^8)/CRC32C/RS builders,
the plain PyTorch codec (`torch_codec`) and the CUDA kernel wrappers
(`cuda_codec`).  Submodules are imported explicitly; importing this package
loads nothing."""
