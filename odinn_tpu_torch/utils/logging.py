"""Training observability: console progress, TensorBoard scalars, a JSONL log.

Per iteration: the loss with its improvement, the gradient norm and the
time per iteration, under the scalar names ``train/loss``,
``train/norm_grad`` and ``train/time_per_iter``. The ``train_log.jsonl``
records are the JAX package's (``odinn_tpu.utils.logging``). TensorBoard
is used when ``torch.utils.tensorboard`` imports, and dropped otherwise;
the learned-law plots and the periodic saves import their modules (and
``matplotlib``) only when they run.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

__all__ = ["TrainingLogger", "print_progress_loss", "combine_callbacks"]


def combine_callbacks(*callbacks):
    """One training callback that runs several in sequence (None skipped)."""
    cbs = [c for c in callbacks if c is not None]

    def combined(stats):
        for c in cbs:
            c(stats)

    return combined


def print_progress_loss(it: int, total: int, loss: float, prev: Optional[float]) -> None:
    """Console progress line, with the improvement over the previous loss."""
    if prev is not None and prev != 0:
        impr = 100.0 * (prev - loss) / abs(prev)
        print(f"[odinn_tpu_torch] iter {it}/{total}  loss {loss:.6e}  ({impr:+.2f}%)")
    else:
        print(f"[odinn_tpu_torch] iter {it}/{total}  loss {loss:.6e}")


class TrainingLogger:
    """Scalar logger: TensorBoard (when available) and a JSONL sidecar.

    Pass ``TrainingLogger(logdir).callback`` as the training callback; it
    reads the trainer's ``TrainingStats``. ``plot_law_every`` with
    ``plot_law_cfg = dict(law=, glacier=, input_ranges=, truth_fn=)`` saves
    a plot of the learned law every that many iterations; ``save_every``
    with ``save_path`` saves the training result."""

    def __init__(self, logdir: Optional[str] = None, use_tensorboard: bool = True,
                 print_every: int = 1, total_iters: Optional[int] = None,
                 save_every: Optional[int] = None, save_path: Optional[str] = None,
                 plot_law_every: Optional[int] = None, plot_law_cfg: Optional[dict] = None):
        self.logdir = logdir or os.path.join(".log", time.strftime("%Y%m%d-%H%M%S"))
        self.print_every = print_every
        self.total_iters = total_iters
        self.save_every = save_every
        self.save_path = save_path
        self.plot_law_every = plot_law_every
        self.plot_law_cfg = plot_law_cfg or {}
        os.makedirs(self.logdir, exist_ok=True)
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(self.logdir)
        self._jsonl = open(os.path.join(self.logdir, "train_log.jsonl"), "a")

    def callback(self, stats) -> None:
        it = stats.niter
        loss = float(stats.losses[-1])
        prev = float(stats.losses[-2]) if len(stats.losses) > 1 else None
        gnorm = float(stats.grad_norm_hist[-1]) if stats.grad_norm_hist else float("nan")
        dt = float(stats.time_per_iter[-1]) if stats.time_per_iter else float("nan")
        if it % self.print_every == 0:
            print_progress_loss(it, self.total_iters or -1, loss, prev)
        rec = {"iter": it, "loss": loss, "norm_grad": gnorm, "time_per_iter": dt}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar("train/loss", loss, it)
            self._tb.add_scalar("train/norm_grad", gnorm, it)
            self._tb.add_scalar("train/time_per_iter", dt, it)
        if self.plot_law_every and it % self.plot_law_every == 0 and self.plot_law_cfg:
            from odinn_tpu_torch.utils.plotting import plot_law, save_plot

            cfg = self.plot_law_cfg
            fig = plot_law(cfg["law"], stats.theta, cfg["glacier"], cfg["input_ranges"],
                           truth_fn=cfg.get("truth_fn"))
            save_plot(fig, os.path.join(self.logdir, f"law_epoch_{it:05d}.png"))
        if self.save_every and self.save_path and it % self.save_every == 0:
            from odinn_tpu_torch.utils.io import TrainingResult, save_inversion_file

            save_inversion_file(self.save_path, TrainingResult(
                theta=stats.theta, losses=stats.losses, grad_norm_hist=stats.grad_norm_hist))

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()
