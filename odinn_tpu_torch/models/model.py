"""Model container: iceflow law slots, mass balance and target inference.

The model is a static description (laws are pure closures); trainable
numbers live in one θ dict. Law values are resolved for a whole stacked
batch at once: a law returning one value per glacier gives a (n_g,) tensor,
which becomes an (n_g, 1, 1) column broadcasting against the staggered grid.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from odinn_tpu_torch.core.glacier import per_glacier_column
from odinn_tpu_torch.laws import inputs as law_inputs_mod
from odinn_tpu_torch.laws.laws import Law
from odinn_tpu_torch.parallel.spatial import slab_rows
from odinn_tpu_torch.physics import targets as targets_mod
from odinn_tpu_torch.physics.sia2d import SIAValues, ValuesFn, default_values

__all__ = ["SIA2DModel", "Model", "init_theta", "glacier_index", "initial_thickness",
           "make_values_fn", "resolve_law", "resolve_outer_values"]


@dataclass(frozen=True)
class SIA2DModel:
    """Slot-based SIA model description.

    ``n_value`` / ``p_value`` / ``q_value``: when Glen's n (and the sliding
    p, q) are one constant for every glacier, these Python floats make the
    diffusivity powers integer powers (multiplies) and give the fused
    kernels their static exponents. ``n_H`` / ``n_gradS`` decouple the
    hybrid-D target's thickness and slope exponents from n; ``max_D``
    caps the diffusivity smoothly (max_D·tanh(D/max_D)).
    """

    A: Optional[Law] = None
    C: Optional[Law] = None
    n: Optional[Law] = None
    Y: Optional[Law] = None
    U: Optional[Law] = None
    n_H: Optional[float] = None       # decoupled exponents (hybrid target)
    n_gradS: Optional[float] = None
    n_value: Optional[float] = None
    p_value: Optional[float] = None
    q_value: Optional[float] = None
    max_D: Optional[float] = None

    @property
    def laws(self):
        return {s: getattr(self, s) for s in ("A", "C", "n", "Y", "U") if getattr(self, s) is not None}

    @property
    def periodic_laws(self):
        """Laws re-evaluated every callback_freq years at save boundaries."""
        return {
            s: l for s, l in self.laws.items()
            if l.callback_freq is not None and l.callback_freq > 0
        }

    @property
    def Y_is_provided(self) -> bool:
        return self.Y is not None

    @property
    def U_is_provided(self) -> bool:
        return self.U is not None


@dataclass(frozen=True)
class Model:
    """Iceflow + mass balance + trainable components.

    The target is inferred from the laws: a U law gives the pure-D target
    (D = H̄·U), a Y law the hybrid-D target, otherwise the A target; with
    ``iceflow.max_D`` the target is wrapped in the smooth cap
    (``CappedTarget``). U and Y laws are exclusive.
    """

    iceflow: SIA2DModel
    mass_balance: Any = None                 # TImodel1 | CustomMLP (mb_machine) | None
    initial_condition: Any = None
    target: Any = None                       # inferred if None

    def __post_init__(self):
        if self.iceflow.U is not None and self.iceflow.Y is not None:
            raise ValueError("U and Y laws are mutually exclusive (pure-D vs hybrid-D target)")
        for slot, law in self.iceflow.laws.items():
            if law.slot != slot:
                raise ValueError(
                    f"law {law.name!r} was built for slot {law.slot!r} but is "
                    f"assigned to SIA2DModel slot {slot!r}"
                )
        if self.target is None:
            if self.iceflow.U is not None:
                tgt = targets_mod.DPureTarget()
            elif self.iceflow.Y is not None:
                tgt = targets_mod.DHybridTarget()
            else:
                tgt = targets_mod.ATarget()
            if self.iceflow.max_D is not None:
                tgt = targets_mod.CappedTarget(tgt, float(self.iceflow.max_D))
            object.__setattr__(self, "target", tgt)

    @property
    def trainable_laws(self):
        return {s: l for s, l in self.iceflow.laws.items() if l.trainable}


def init_theta(model: Model, glaciers, dtype=torch.float64) -> dict:
    """The trainable θ dict: one entry per trainable law slot, from each
    law's ``init_theta(glaciers, dtype)``, plus "IC" from the model's
    initial condition, on the glaciers' device."""
    theta = {}
    for slot, law in model.trainable_laws.items():
        if law.init_theta is None:
            raise ValueError(f"trainable law {law.name} has no init_theta")
        theta[slot] = law.init_theta(glaciers, dtype)
    if model.initial_condition is not None:
        theta["IC"] = model.initial_condition.init_theta(glaciers, dtype)
    return theta


def glacier_index(glacier):
    """The rows of per-glacier θ entries that belong to ``glacier``: its
    ``glacier_ids`` when it was gathered from a larger batch, else
    0 … n_g − 1 for a batch and 0 for a single glacier."""
    if glacier.glacier_ids is not None:
        return glacier.glacier_ids
    if glacier.is_batched:
        return torch.arange(glacier.H0.shape[0], device=glacier.H0.device)
    return torch.tensor(0, device=glacier.H0.device)


def initial_thickness(model: Model, theta, glacier):
    """H₀ of the solve: σ(θ_IC) of the glacier's rows when θ has a trainable
    initial condition (on a row-sharded batch, whose θ is whole, of its own
    grid rows), else the glacier's own H₀."""
    if model.initial_condition is not None and theta is not None and "IC" in theta:
        H0 = model.initial_condition.evaluate_H0(theta, glacier_index(glacier))
        shard = getattr(glacier, "row_shard", None)
        return H0 if shard is None else shard.rows_of(H0)
    return glacier.H0


def _law_inputs(specs, glacier, t, H) -> dict:
    """The inputs ``specs`` for the glacier or stacked batch at time t and
    state H. On a row-sharded batch every input is taken on the own rows
    (an input that reads a stencil of the static fields, such as
    roughness, reads the static slab's ghost rows and is cropped) and a
    gridded one is gathered over the row group into the whole plane, so
    the law sees the plane it sees in one process (its reductions
    included); the operators then read the values of their slabs
    (:class:`~odinn_tpu_torch.physics.sia2d.ValuesFn`)."""
    shard = getattr(glacier, "row_shard", None)
    inputs = {}
    for spec in specs:
        v = spec.get(glacier, H, t)
        if (shard is not None and isinstance(v, torch.Tensor) and v.ndim >= 2
                and v.shape[-2] == shard.own and v.shape[-1] == glacier.H0.shape[-1]):
            v = shard.whole(v)
        inputs[spec.name] = v
    return inputs


def resolve_law(law: Law, theta, glacier, t, H):
    """One outer law's value for the glacier or stacked batch at time t and
    state H (a per-glacier value as an (n_g, 1, 1) column; on a row-sharded
    batch a gridded value is the whole plane's, see :func:`_law_inputs`)."""
    inputs = {"glacier_idx": glacier_index(glacier)}
    inputs.update(_law_inputs(law.inputs, glacier, t, H))
    return per_glacier_column(glacier, law.apply(theta, inputs))


def resolve_outer_values(model: Model, theta, glacier, t, H=None) -> SIAValues:
    """Evaluate every non-inner law (callback_freq ≥ 0) into an SIAValues
    for the glacier or stacked batch, at time t (state ``H``, default H₀)."""
    vals = default_values(glacier)
    if model.iceflow.n_value is not None:
        nv = float(model.iceflow.n_value)
        pv = float(model.iceflow.p_value) if model.iceflow.p_value is not None else nv
        qv = float(model.iceflow.q_value) if model.iceflow.q_value is not None else 0.0
        vals = vals.replace(n=nv, p=pv, q=qv)
    state = H if H is not None else glacier.H0
    for slot, law in model.iceflow.laws.items():
        if not law.is_inner:
            vals = vals.replace(**{slot: resolve_law(law, theta, glacier, t, state)})
    if model.iceflow.n_H is not None:
        vals = vals.replace(n_H=float(model.iceflow.n_H))
    if model.iceflow.n_gradS is not None:
        vals = vals.replace(n_gradS=float(model.iceflow.n_gradS))
    return vals


def make_values_fn(model: Model, theta, glacier, t, outer_vals: SIAValues) -> ValuesFn:
    """The per-RHS-call law resolver: inner laws (callback_freq None) are
    re-evaluated from the current (H̄, |∇S|); everything else comes from
    ``outer_vals``. With no inner laws the resolver is constant."""
    inner = [(s, l) for s, l in model.iceflow.laws.items() if l.is_inner]
    shard = getattr(glacier, "row_shard", None)
    if not inner:
        return ValuesFn(outer_vals, shard=shard)
    # outer inputs of inner laws are time-constant within a solve
    static_inputs = {}
    for _, law in inner:
        static_inputs.update(_law_inputs(
            [spec for spec in law.inputs if spec.name not in law_inputs_mod.INNER_INPUTS],
            glacier, t, glacier.H0))
    idx = glacier_index(glacier)

    def resolve_inner(vals, hbar, grad_s):
        statics = static_inputs
        if shard is not None:        # the whole-plane inputs on the caller's slab
            statics = {k: slab_rows(v, shard, hbar.shape[-2] + 1)
                       for k, v in static_inputs.items()}
        for slot, law in inner:
            inputs = dict(statics, glacier_idx=idx, Hbar=hbar, gradS=grad_s)
            vals = vals.replace(**{slot: per_glacier_column(glacier, law.apply(theta, inputs))})
        return vals

    return ValuesFn(outer_vals, resolve_inner, shard=shard)
