"""Multi-process distribution: one process per device, joined by
``torch.distributed``.

The reference distributes across worker processes (Distributed.jl
``addprocs`` and ``pmap`` over per-glacier batches); the JAX package joins
processes into one global device mesh with ``jax.distributed``. The port
does what PyTorch does: every process drives one device and joins a
``torch.distributed`` job (:func:`init_distributed`, or a ``torchrun``-style
launcher that sets the same rank, world size and address), and the mesh of
:mod:`odinn_tpu_torch.parallel.mesh` spans the job's ranks. Then
``train_ude(inv, mesh=global_mesh())`` splits the glacier axis over the
processes with no change above this layer.

The process group is gloo's, on every device: the glacier axis's
collectives are θ-sized sums and the final gathers, staged through host
buffers, and NCCL refuses two ranks on one card. :func:`launch_local_workers`
starts a local job (the test rig, and two ranks sharing one card), whose
workers run :mod:`odinn_tpu_torch.parallel.mp_worker`;
:func:`dryrun_multichip` drives ``train_ude`` with an Adam and a
Levenberg–Marquardt stage on such a job.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

__all__ = [
    "init_distributed",
    "global_mesh",
    "is_multiprocess",
    "gather_to_host",
    "launch_local_workers",
    "dryrun_multichip",
]

MP_WORKER = "odinn_tpu_torch.parallel.mp_worker"


def init_distributed(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    devices_per_process: Optional[int] = None,
    device: Optional[str] = None,
) -> int:
    """Join this process into a ``torch.distributed`` job over gloo at
    ``coordinator_address`` (``host:port``, or a ``tcp://`` URL) as rank
    ``process_id`` of ``num_processes``; returns the world size.

    Rank r drives ``cuda:(r % device_count)`` (made the current device, so
    the entry points' default ``device=None`` lands there), or the CPU with
    ``device="cpu"``. One process drives one device: a
    ``devices_per_process`` other than None or 1 raises."""
    import torch.distributed as dist

    if devices_per_process not in (None, 1):
        raise ValueError(
            f"devices_per_process={devices_per_process}: the port runs one process per "
            "device (PyTorch's idiom); start one process for each device instead")
    if device is None or torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device is available; pass "
                               "device='cpu' for a CPU job")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    elif torch.device(device).type != "cpu":
        raise ValueError(f"init_distributed: device must be 'cuda' or 'cpu', got {device!r}")
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group("gloo", init_method=url, world_size=int(num_processes),
                            rank=int(process_id))
    return dist.get_world_size()


def is_multiprocess() -> bool:
    """Whether this process belongs to a ``torch.distributed`` job of more
    than one rank."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def global_mesh():
    """The 1-D mesh over every rank of the job (None for a job of one):
    build it after :func:`init_distributed`."""
    from odinn_tpu_torch.parallel.mesh import make_mesh

    return make_mesh()


def gather_to_host(tree):
    """Every leaf of ``tree`` (tensors or arrays) as host numpy of the whole
    glacier axis, on every rank: the ranks' blocks (equal shapes, leading
    glacier axis) concatenated in rank order by an ``all_gather`` of host
    copies (gloo gathers no CUDA tensor). Outside a job, the leaves as
    they are."""
    from odinn_tpu_torch.parallel.mesh import gather_rows
    from odinn_tpu_torch.utils.flatten import tree_map

    def gather(x):
        host = torch.as_tensor(x).detach().to("cpu")
        return (gather_rows(host) if is_multiprocess() else host).numpy()

    return tree_map(gather, tree)


def launch_local_workers(num_processes: int, devices_per_process: int, worker_argv,
                         timeout: float = 600.0, module: str = MP_WORKER):
    """Start ``num_processes`` local processes forming one job, each

        python -m <module> <rank> <num_processes> <port> <devices_per_process> *worker_argv

    on a free localhost port, and wait for them all against one deadline,
    ``timeout`` seconds from the start. Each worker writes to a file of
    its own, so none blocks on a full pipe while another waits for it in a
    collective. Returns each worker's output (stdout and stderr together);
    raises ``RuntimeError`` quoting the worker's output on the timeout or
    as soon as a worker exits non-zero, after killing every worker still
    running."""
    import socket
    import subprocess
    import sys
    import tempfile
    import time

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    pp = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = repo + (os.pathsep + pp if pp else "")
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(num_processes)]
    procs = []
    deadline = time.monotonic() + timeout
    try:
        for pid in range(num_processes):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, str(pid), str(num_processes), str(port),
                 str(devices_per_process), *map(str, worker_argv)],
                env=env, cwd=repo, stdout=logs[pid], stderr=subprocess.STDOUT, text=True))
        while True:
            codes = [p.poll() for p in procs]
            if None not in codes or any(c not in (None, 0) for c in codes):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
    for pid, c in enumerate(codes):
        if c not in (None, 0):
            raise RuntimeError(f"multiprocess worker {pid} failed (rc={c}):\n{outs[pid]}")
    for pid, c in enumerate(codes):
        if c is None:
            raise RuntimeError(f"multiprocess worker {pid} timed out after {timeout} s:\n"
                               f"{outs[pid]}")
    return outs


def dryrun_multichip(n_devices: int, device: str = "cpu", timeout: float = 600.0) -> dict:
    """Launch ``n_devices`` local ranks that train the dry-run problem
    through ``train_ude`` on the mesh (an Adam stage, then a
    Levenberg–Marquardt stage), each checking itself against the
    single-process run (:mod:`odinn_tpu_torch.parallel.mp_worker`); print
    one line and return rank 0's ``MP_OK`` record. ``device="cuda"`` puts
    rank r on ``cuda:(r % device_count)``."""
    import json

    outs = launch_local_workers(n_devices, 1, ["--device", device, "--optimizer", "adam,lm"],
                                timeout=timeout)
    marker = [line for line in outs[0].splitlines() if line.startswith("MP_OK ")]
    if not marker:
        raise RuntimeError(f"dryrun_multichip: no MP_OK line from rank 0:\n{outs[0][-4000:]}")
    record = json.loads(marker[-1][len("MP_OK "):])
    losses = record["losses"]
    if not np.isfinite(losses).all():
        raise FloatingPointError(f"dryrun_multichip: non-finite losses {losses}")
    print(f"[dryrun_multichip] n_devices={n_devices} device={device} train_ude "
          f"loss={losses[0]:.6e}->{record['final_loss']:.6e} niter={len(losses)} OK",
          flush=True)
    return record
