"""Device-memory accounting on the CUDA card.

- :func:`live_hbm_gib`: the caching allocator's live statistics (bytes in
  use, their peak) and the card's total memory, in GiB.
- :func:`aot_step_memory`: the peak the allocator reached while one call
  of a step ran, measured on that call. The step returned is the one
  measured, unchanged, so the measured program is the audited program.

An XLA executable states its memory budget before it runs
(``Compiled.memory_analysis``); a PyTorch program has no such budget, so
the peak of a real call takes its place.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from odinn_tpu_torch.core.device import resolve_device

__all__ = ["live_hbm_gib", "aot_step_memory"]


def _gib(nbytes: float) -> float:
    return round(nbytes / 2**30, 3)


def live_hbm_gib(device=None) -> Optional[Dict[str, float]]:
    """Allocator statistics of ``device`` (None: the CUDA card) in GiB,
    under the keys ``gib_in_use``, ``peak_gib_in_use`` and ``gib_limit``;
    None on the CPU or where no CUDA device is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(dev)
    return {
        "gib_in_use": _gib(stats["allocated_bytes.all.current"]),
        "peak_gib_in_use": _gib(stats["allocated_bytes.all.peak"]),
        "gib_limit": _gib(torch.cuda.get_device_properties(dev).total_memory),
    }


def aot_step_memory(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once on the CUDA card with the
    allocator's peak reset before it; returns ``(fn, memory)``, where
    memory holds the peak reached during the call (``peak_gib``), what was
    allocated before it (``start_gib``), their difference (``step_gib``)
    and the allocator's statistics after it (``allocator``). Raises
    without a CUDA device."""
    dev = resolve_device(None)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.memory_allocated(dev)
    fn(*args, **kwargs)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    mem: Dict[str, Any] = {"peak_gib": _gib(peak), "start_gib": _gib(start),
                           "step_gib": _gib(peak - start), "peak_bytes": peak}
    live = live_hbm_gib(dev)
    if live:
        mem["allocator"] = live
    return fn, mem
