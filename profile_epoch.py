"""Profile one Adam epoch of chip_smoke.py's training phase on one CUDA card.

    python3 profile_epoch.py [ROOT [SOLVER [GRAD]]]

ROOT is a checkout of this repository (default: the one that holds this
script). Its ``odinn_tpu_torch`` is imported and its kernels built, so two
commits can be compared on one card in one call, in turns: parent, change,
change, parent. SOLVER is the training's solve, ``RKC`` (default) or
``SI``; GRAD its gradient, ``jax`` (autograd, the default) or ``discrete``
(the hand-written discrete adjoint). The problem and the epoch are this checkout's
(``chip_smoke.training_problem``, ``adam_epoch_fn``). Prints one JSON line:
the root, the card and its power limit, the epoch's time (CUDA events,
median of 5), device busy time, idle share and device launches, all and by
kernel name (profiler, one epoch). Without a CUDA card it exits with code 2
and prints no result.
"""

from __future__ import annotations

import importlib.util
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_epoch: no CUDA device available", file=sys.stderr)
        return 2
    root = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else HERE
    solver = sys.argv[2] if len(sys.argv) > 2 else "RKC"
    grad = sys.argv[3] if len(sys.argv) > 3 else "jax"
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from odinn_tpu_torch.ops.cuda.build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    build_all()
    inv, model, params, tstops, facts = cs.training_problem(solver, grad)
    row = cs.epoch_profile(cs.adam_epoch_fn(inv, model, params, tstops))
    facts.pop("ground_truth_s")
    cs.emit(dict({"phase": "epoch_profile", "root": root, "nvidia_smi": cs.nvidia_smi(),
                  "solver": solver, "grad": grad}, **facts, **row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
