"""Supervised pretraining of the laws' networks.

``pretraining`` fits an MLP to (X, Y) pairs with a mean-squared-log-error
loss and Adam before the UDE training starts, warm-starting the law away
from the sigmoid head's flat regions; ``dense_lm_fit`` is an exact
Levenberg–Marquardt fit of a small MLP (the Jacobian formed densely), and
``pretrain_law_from_A`` fits a ``LawA``-style network to recovered (T, A)
pairs with it, from several starts.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from odinn_tpu_torch.core.device import resolve_device
from odinn_tpu_torch.models.nn import MLP, fourier_feature, init_mlp, mlp_apply, prescale, scale

__all__ = ["msle_loss", "pretraining", "dense_lm_fit", "pretrain_law_from_A"]


def msle_loss(pred, target):
    """Mean squared log error of the positive parts."""
    return torch.mean((torch.log1p(torch.clamp(pred, min=0.0))
                       - torch.log1p(torch.clamp(target, min=0.0))) ** 2)


def _copy_params(params, requires_grad: bool = False) -> List[dict]:
    return [{k: v.detach().clone().requires_grad_(requires_grad) for k, v in layer.items()}
            for layer in params]


def pretraining(arch: MLP, params, X, Y, postprocess: Optional[Callable] = None,
                epochs: int = 1000, lr: float = 1e-2, loss_fn: Callable = msle_loss
                ) -> Tuple[list, list]:
    """Supervised pre-fit of an MLP by ``torch.optim.Adam`` (optax's update:
    bias-corrected, eps outside the square root); returns (trained params,
    loss history, the loss before each update). ``postprocess`` maps the
    network's output to the law's units (e.g. LawA's [minA, maxA] scaling),
    so the fit happens in the law's output space. ``X`` is taken at least
    2-D, (n, n_in); the tensors' device and dtype are the parameters'."""
    p = _copy_params(params, requires_grad=True)
    X = torch.atleast_2d(torch.as_tensor(X, dtype=p[0]["w"].dtype, device=p[0]["w"].device))
    Y = torch.as_tensor(Y, dtype=X.dtype, device=X.device)
    leaves = [v for layer in p for v in layer.values()]
    opt = torch.optim.Adam(leaves, lr=lr)
    history = []
    for _ in range(epochs):
        out = mlp_apply(arch, p, X)[..., 0]
        if postprocess is not None:
            out = postprocess(out)
        val = loss_fn(out, Y)
        grads = torch.autograd.grad(val, leaves)
        for leaf, g in zip(leaves, grads):
            leaf.grad = g
        opt.step()
        history.append(float(val.detach()))
    return _copy_params(p), history


def _flattener(params):
    """(flat vector, unflatten) of an MLP parameter list, each layer's
    entries in sorted key order ("b", then "w")."""
    spec = [[(k, layer[k].shape) for k in sorted(layer)] for layer in params]
    flat = torch.cat([layer[k].reshape(-1) for layer in params for k in sorted(layer)])

    def unflatten(vec):
        out, i = [], 0
        for layer in spec:
            d = {}
            for k, shape in layer:
                n = math.prod(shape)
                d[k] = vec[i:i + n].reshape(shape)
                i += n
            out.append(d)
        return out

    return flat, unflatten


def dense_lm_fit(arch: MLP, params, X, Y, postprocess: Optional[Callable] = None,
                 iters: int = 400, lam0: float = 1e-2, sample_weights=None
                 ) -> Tuple[list, float]:
    """Exact Levenberg–Marquardt fit of a small MLP to (X, Y) pairs; returns
    (trained params, final sum of squares).

    Pretraining problems are tiny (O(100) samples × O(1e3) weights), so the
    Jacobian is formed densely (``torch.func.jacfwd``) and the damped normal
    equations (JᵀJ + λ·diag(JᵀJ)) δ = −Jᵀr solved directly
    (``torch.linalg.solve``); a step is taken when it lowers the sum of
    squares (λ ÷ 3), else λ × 10. Fit in float64; ``sample_weights``
    weight the squared residuals."""
    flat, unflatten = _flattener(_copy_params(params))
    X = torch.atleast_2d(torch.as_tensor(X, dtype=flat.dtype, device=flat.device))
    Y = torch.as_tensor(Y, dtype=flat.dtype, device=flat.device)
    sw = None if sample_weights is None else torch.sqrt(
        torch.as_tensor(sample_weights, dtype=Y.dtype, device=Y.device))

    def resid_flat(f):
        out = mlp_apply(arch, unflatten(f), X)[..., 0]
        if postprocess is not None:
            out = postprocess(out)
        r = out - Y
        if sw is not None:
            r = sw * r
        return r.reshape(-1)

    jac = torch.func.jacfwd(resid_flat)
    lam = float(lam0)
    loss = float(torch.sum(resid_flat(flat) ** 2))
    for _ in range(iters):
        J = jac(flat)
        r = resid_flat(flat)
        JtJ = J.T @ J
        g = J.T @ r
        d = torch.clamp(torch.diagonal(JtJ), min=1e-12)
        step = torch.linalg.solve(JtJ + lam * torch.diag(d), -g)
        cand = flat + step
        ln = float(torch.sum(resid_flat(cand) ** 2))
        if ln < loss:
            flat, loss, lam = cand, ln, max(lam / 3.0, 1e-14)
        else:
            lam = min(lam * 10.0, 1e12)
    return unflatten(flat), loss


def _float64(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=torch.float64)
    return torch.tensor(np.asarray(x, dtype=np.float64), device=device)


def pretrain_law_from_A(nn, params, temps, A_values, head: str = "log", prescale_bounds=None,
                        iters: int = 400, restarts: int = 5, sample_weights=None,
                        init_theta=None, n_fourier=None, fourier_scale: float = 1.0,
                        device=None) -> list:
    """Pretrain a ``LawA``-style network on (T, A) pairs, e.g. the per-glacier
    A of a classical inversion; returns the θ["A"] parameter list (float64,
    on ``device``, None: the CUDA card).

    The fit runs in the law's head space (log A for ``head="log"``, the
    linear [minA, maxA] map otherwise) with :func:`dense_lm_fit`, in float64.
    ``prescale_bounds``, ``n_fourier`` and ``fourier_scale`` must match the
    ``LawA`` the θ will drive. Dense LM is exact but local, so the fit runs
    from ``restarts`` starts, drawn by ``init_mlp`` from
    ``torch.Generator`` seeded ``nn.seed``, ``nn.seed + 1``, …, and from
    ``init_theta`` when given (tried first), and keeps the lowest sum of
    squares. ``sample_weights`` weight the samples' squared residuals."""
    dev = resolve_device(device)
    f64 = torch.float64
    arch = nn.architecture
    min_a, max_a = params.physical.min_A, params.physical.max_A
    T, A = _float64(temps, dev)[:, None], _float64(A_values, dev)
    if prescale_bounds is not None:
        T = prescale(T, prescale_bounds)
    if n_fourier:
        T = fourier_feature(T, n_freq=n_fourier, scale_ff=fourier_scale)
    if head == "log":
        lims, Y = (math.log(min_a), math.log(max_a)), torch.log(A)
    else:
        lims, Y = (min_a, max_a), A
    starts = [init_mlp(arch, torch.Generator().manual_seed(nn.seed + k), f64, dev)
              for k in range(max(restarts, 1))]
    if init_theta is not None:
        starts.insert(0, [{k: torch.as_tensor(v).to(device=dev, dtype=f64)
                           for k, v in layer.items()} for layer in init_theta])
    best, best_ssr = None, math.inf
    for p0 in starts:
        fitted, ssr = dense_lm_fit(arch, p0, T, Y, postprocess=lambda o: scale(o, lims),
                                   iters=iters, sample_weights=sample_weights)
        if ssr < best_ssr:
            best, best_ssr = fitted, ssr
    return best
