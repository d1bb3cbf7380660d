"""t3fs_torch: the PyTorch/CUDA port of t3fs's device codec.

The JAX package `t3fs/` is the reference; this package carries the same
codec seams (the storage node's checksum backend and the EC client's stripe
codec) on PyTorch, with the Pallas TPU kernels replaced by hand-written CUDA
kernels for Hopper (`t3fs_torch/csrc/`).  It imports torch, numpy and the
standard library only -- never jax, never `t3fs`.

Every entry point takes `device=`, defaulting to "cuda".  Without a GPU the
default raises; pass device="cpu" to run the plain PyTorch versions of the
kernels (what the CPU tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on (twin of pallas_codec.on_tpu).

    A CUDA device without a GPU present is an error, never a silent fall
    back to the CPU: a storage node configured for the device codec must not
    quietly checksum on the host."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "t3fs_torch: device 'cuda' requested but torch.cuda.is_available() "
            "is false; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"t3fs_torch: unsupported device {dev}")
    return dev
