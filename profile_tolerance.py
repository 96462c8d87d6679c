"""The float32 spread of chip_smoke.py's tolerance checks on one CUDA card.

    python3 profile_tolerance.py

Builds the kernels, then prints one JSON line per start:

- ``replay_gradient``: the replay gradient of chip_smoke.py's
  ``check_replay_gradient`` problem (4 x 128^2, 2 months, A = NN(T),
  reltol 1e-4) at six starts θ (1 + j 2^-16), each with its own schedule
  recorded on the CPU in float64; the card's float64 and float32 and the
  CPU's float32 gradient against the CPU's float64, per θ leaf and over
  the whole θ;
- ``adaptive_counts``: the accepted steps of chip_smoke.py's adaptive row
  (4 x 128^2, 5 years, monthly mass balance, reltol 1e-4) at five starts
  H0 (1 + j 2^-20), on the card and on the CPU, through the fused table
  (the kernel on the card, its plain version on the CPU) and the unfused
  path, in float32 and float64: the total, each glacier's, and the
  rejected trials.

Without a CUDA card it exits with code 2 and prints no result.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def replay_gradient_spread(cs, samples=6):
    from odinn_tpu_torch.simulation.inversion import Inversion, _tree_map
    from odinn_tpu_torch.simulation.prediction import resolve_replay

    f32, f64 = torch.float32, torch.float64
    inv, model, params, tstops, _ = cs.training_problem(
        "RKC", "jax", n_g=cs.N_G, tspan=(5.0, 5.0 + 2.0 / 12.0), dtype=f64)
    glaciers = inv.glaciers.to(dtype=f32)
    for j in range(samples):
        theta = _tree_map(lambda x: (x.double() * (1.0 + j * 2.0 ** -16)).float().cpu(),
                          inv.theta)
        p = resolve_replay(cs._with_solver(params, adaptive="replay", reltol=cs.TOL_RELTOL),
                           glaciers.to("cpu", f64), model, cs._tree_to(theta, "cpu", f64),
                           tstops)

        def gradient(device, dtype):
            on = Inversion(model=model, glaciers=glaciers.to(device, dtype), parameters=p,
                           device=device, theta=cs._tree_to(theta, device, dtype))
            vg, _ = cs.grad_fn(on, p)
            _, grads = vg(cs._tree_to(theta, device, dtype, requires_grad=True), on.glaciers)
            return [g.detach().double().cpu() for g in grads]

        ref = gradient("cpu", f64)
        row = {"phase": "replay_gradient", "start": j}
        for name, device, dtype in (("card64", "cuda", f64), ("card32", "cuda", f32),
                                    ("cpu32", "cpu", f32)):
            g = gradient(device, dtype)
            row[f"{name}_leaf_rel_err"] = [
                float((x - y).abs().max() / y.abs().max()) for x, y in zip(g, ref)]
            row[f"{name}_rel_err"] = cs._whole_err(g, ref)
        cs.emit(row)


def adaptive_count_spread(cs, samples=5):
    from odinn_tpu_torch.core.glacier import stack_glaciers
    from odinn_tpu_torch.laws.laws import CuffeyPaterson
    from odinn_tpu_torch.models.model import Model, SIA2DModel
    from odinn_tpu_torch.physics.mass_balance import TImodel1
    from odinn_tpu_torch.simulation.prediction import forward_glacier
    from odinn_tpu_torch.simulation.solver import build_tstops

    tstops = build_tstops(cs.TSPAN, 1.0 / 12.0)
    params = cs.bench_params(adaptive=True, reltol=cs.TOL_RELTOL)
    paths = {
        "table": Model(iceflow=SIA2DModel(A=CuffeyPaterson(), n_value=3.0),
                       mass_balance=TImodel1()),
        "unfused": Model(iceflow=SIA2DModel(A=dataclasses.replace(CuffeyPaterson(),
                                                                  callback_freq=None),
                                            n_value=3.0), mass_balance=TImodel1())}
    b64 = stack_glaciers(cs.bench_glaciers(torch.float64), device="cuda")
    for device in ("cuda", "cpu"):
        for j in range(samples):
            row = {"phase": "adaptive_counts", "device": device, "start": j}
            base = b64.replace(H0=b64.H0 * (1.0 + j * 2.0 ** -20)).to(device)
            for dtype in (torch.float32, torch.float64):
                for name, model in paths.items():
                    record = {}
                    with torch.no_grad():
                        _, nacc = forward_glacier(None, base.to(dtype=dtype), model, params,
                                                  tstops, _return_stats=True, _record=record)
                    nacc, trials = nacc.cpu(), record["trials"].cpu()
                    row[f"{name}_{str(dtype).split('.')[-1]}"] = {
                        "accepted": int(nacc.sum()), "per_glacier": nacc.sum(1).tolist(),
                        "rejected": int((trials - nacc).sum())}
            cs.emit(row)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_tolerance: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from odinn_tpu_torch.ops.cuda.build import build_all

    cs.emit({"phase": "device", "nvidia_smi": cs.nvidia_smi(),
             "kind": torch.cuda.get_device_name(0)})
    torch.backends.cuda.matmul.allow_tf32 = False
    build_all()
    replay_gradient_spread(cs)
    adaptive_count_spread(cs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
