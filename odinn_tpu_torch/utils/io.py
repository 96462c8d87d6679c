"""Persistence: training results, forward results and checkpoints.

- :class:`TrainingResult` and :func:`save_inversion_file` /
  :func:`load_inversion_file`: the trained θ tree with its loss and
  gradient-norm histories, ``torch.save`` of a dict of CPU tensors (read
  back with ``weights_only=True``), plus a JSON sidecar
  ``<path>.meta.json`` of the run's metadata, the JAX package's sidecar;
- :func:`save_results_file` / :func:`load_results_file`: forward results
  (trajectories, velocities) as a compressed ``.npz``, the JAX package's
  file, so either package reads the other's;
- :func:`save_checkpoint` / :func:`restore_checkpoint`: a train state (θ,
  the optimizer's ``state_dict``, counters) under ``<dir>/step_<n>/``;
  restoring takes the latest step unless one is named.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import numpy as np
import torch

from odinn_tpu_torch.convert import to_numpy
from odinn_tpu_torch.core.device import resolve_device
from odinn_tpu_torch.utils.flatten import tree_map

__all__ = [
    "TrainingResult",
    "save_inversion_file",
    "load_inversion_file",
    "save_results_file",
    "load_results_file",
    "save_checkpoint",
    "restore_checkpoint",
]

_STATE_FILE = "state.pt"


@dataclasses.dataclass
class TrainingResult:
    """A persisted inversion: θ, optionally its history, the gradient-norm
    and loss histories, and the run's metadata (the sidecar)."""

    theta: Any
    theta_hist: Any = None
    grad_norm_hist: Any = None
    losses: Any = None
    params_meta: Any = None


def _to_cpu(x):
    """A tree leaf as saved: tensors and numpy arrays as CPU tensors."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.array(x))
    return x.detach().cpu() if isinstance(x, torch.Tensor) else x


def _to(dev):
    """A tree leaf as restored: tensors on ``dev``."""
    return lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x


def _history(values) -> torch.Tensor:
    return torch.as_tensor(np.asarray([] if values is None else values, np.float64))


def save_inversion_file(path: str, result: TrainingResult) -> None:
    """Write ``result`` to ``path`` (``torch.save``) and its
    ``params_meta``, when set, to ``path + ".meta.json"``."""
    payload = {"theta": tree_map(_to_cpu, result.theta), "losses": _history(result.losses),
               "grad_norm_hist": _history(result.grad_norm_hist)}
    if result.theta_hist:
        payload["theta_hist"] = tree_map(_to_cpu, list(result.theta_hist))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(payload, path)
    if result.params_meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(result.params_meta, f, indent=2, default=str)


def load_inversion_file(path: str, device=None) -> TrainingResult:
    """Read a file of :func:`save_inversion_file`: θ (and its history) on
    ``device`` (None: the CUDA card), the histories as float64 CPU tensors,
    the metadata from the sidecar when there is one."""
    dev = resolve_device(device)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    meta = None
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return TrainingResult(
        theta=tree_map(_to(dev), payload["theta"]),
        theta_hist=tree_map(_to(dev), payload.get("theta_hist")),
        grad_norm_hist=payload.get("grad_norm_hist"),
        losses=payload.get("losses"),
        params_meta=meta,
    )


def save_results_file(path: str, results: dict) -> None:
    """Forward results (trajectories, velocities) as a compressed ``.npz``;
    None, tuple and string entries (e.g. the rgi_ids) are left out."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **{k: to_numpy(v) for k, v in results.items()
                                 if v is not None and not isinstance(v, (tuple, str))})


def load_results_file(path: str) -> dict:
    """The arrays of a results ``.npz``, as numpy."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def save_checkpoint(ckpt_dir: str, step: int, state: Any) -> None:
    """Snapshot a train state (nested dicts, lists and tuples of tensors
    and numbers, e.g. θ with an optimizer's ``state_dict``) under
    ``<ckpt_dir>/step_<step>/``, replacing an older one of that step."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")
    os.makedirs(path, exist_ok=True)
    torch.save(tree_map(_to_cpu, state), os.path.join(path, _STATE_FILE))


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None, device=None) -> Any:
    """The state of :func:`save_checkpoint` at ``step`` (None: the latest)
    with its tensors on ``device`` (None: the CUDA card)."""
    dev = resolve_device(device)
    path = os.path.abspath(ckpt_dir)
    if step is None:
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(path) if d.startswith("step_"))
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {path}")
        step = steps[-1]
    state = torch.load(os.path.join(path, f"step_{step}", _STATE_FILE), map_location="cpu",
                       weights_only=True)
    return tree_map(_to(dev), state)
