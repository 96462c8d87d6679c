"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card. Raises when CUDA is asked for and absent:
    an entry point never carries on quietly on the CPU; pass
    ``device="cpu"`` for a CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "odinn_tpu_torch: no CUDA device is available; pass device='cpu' "
            "to run on the CPU"
        )
    return dev
