"""million_tpu_torch: the PyTorch and CUDA port of million_tpu for NVIDIA
Hopper (H100). It mirrors million_tpu's module tree; the decode-attention
kernel is hand-written CUDA (csrc/), built with nvcc at first use.

Every entry point takes `device`, "cuda" by default, and raises when CUDA is
asked for and absent (see `resolve_device`). Tests pass device="cpu", where
each kernel wrapper runs its plain PyTorch version.

The pipeline CLI: `python -m million_tpu_torch.cli` (or `python -m
million_tpu_torch`, or `main` below) with million_tpu.cli's arguments and
`--device`.
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


def main(argv=None):
    """The pipeline CLI, million_tpu_torch.cli.main (imported on call, so
    that importing the package loads no model code)."""
    from million_tpu_torch.cli import main as cli_main

    return cli_main(argv)
