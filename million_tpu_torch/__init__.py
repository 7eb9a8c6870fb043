"""million_tpu_torch: the PyTorch and CUDA port of million_tpu for NVIDIA
Hopper (H100). It mirrors million_tpu's module tree; the decode-attention
kernel is hand-written CUDA (csrc/), built with nvcc at first use.

Every entry point takes `device`, "cuda" by default, and raises when CUDA is
asked for and absent (see `resolve_device`). Tests pass device="cpu", where
each kernel wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return torch.device(device); raise when CUDA is asked for and no card
    is visible, so that nothing carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev
