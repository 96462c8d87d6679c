"""Time the large-plane SI path (``si_assemble``, then ``si_pcg``) and its
pullback (``si_plane_vjp``) beside the floors of their launch shapes, on
one CUDA card.

    python3 profile_plane.py [--reps N] [--pullback]

Float32 throughout, the profiler's device time per call of:

- ``si_assemble`` alone, through its wrapper, at a rows-axis rank's
  16 x 66 x 128 slab and at 1 x 1024^2 (the forward mode, Jacobi), on the
  plan the wrapper picks (``si_kernel.assemble_plan``) and on every other
  instantiated plan (``R=``, rows a thread);
- the whole large-plane ``si_step`` (assembly and PCG) at 2 x 300^2
  PCG-6, 1 x 1024^2 PCG-6 and PCG-12 (and the transpose solve at
  PCG-12) and 1 x 2048^2 PCG-12, each with ``bound_ms`` as
  ``chip_smoke.py`` counts it;
- the floors of each launch shape, from a small kernel built here:
  ``empty`` (the PCG's blocks and threads, no work), ``grid_sync`` (the
  same blocks launched cooperatively, 2 x cg_iters grid barriers and
  nothing else), and ``assemble_empty`` (the assembly's grid of tiles, no
  work);
- ``si_step_vjp`` through its wrapper at chip_smoke.PLANE_VJP_SHAPES (2 x
  300^2, 1 x 1024^2, 1 x 2048^2, 4 x 512^2; H_D = H, as the SI trainings
  and the ice sheet call it) on two routes: ``cluster``, the cluster
  kernel ``csrc/si_step_vjp.cu`` (one cluster of at most 16 blocks a
  glacier, the route of every plane before the large-plane pullback), and
  ``plane``, the large-plane pullback on its plan
  (``si_kernel.plane_vjp_plan``) and on the other instantiated plan
  (``R=``), each with ``bound_ms``; beside them the large-plane pullback's
  ``plane_empty`` floor (its grid of tiles, no work) and its
  ``loads_stores`` variant (the kernel built here with no corner and no
  cell arithmetic: its loads, the ring's staging, the tile's corners
  stored as zeros, its stores and its two sums).

It also prints the plans and the ptxas registers and spills of every
``si_assemble``, ``si_pcg``, ``si_step_vjp_kernel`` and ``si_plane_vjp``
instance. ``--pullback`` times the pullback alone. One JSON line; without a
CUDA card it exits with code 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys

SOURCE = r"""
#include <cooperative_groups.h>

namespace cg = cooperative_groups;

// barriers < 0: nothing; else that many grid barriers
__global__ void plane_floor(int barriers) {
  if (barriers < 0) return;
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < barriers; ++k) grid.sync();
}

extern "C" int floor_launch(int barriers, int blocks, int threads, int cooperative,
                            void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = cooperative ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, plane_floor, barriers);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
"""

# (n_g, nx, ny, PCG iterations, mode): the large-plane steps timed
STEPS = ((2, 300, 300, 6, "forward"), (1, 1024, 1024, 6, "forward"),
         (1, 1024, 1024, 12, "forward"), (1, 1024, 1024, 12, "transpose"),
         (1, 2048, 2048, 12, "forward"))
ASSEMBLIES = ((16, 66, 128), (1, 1024, 1024))
# the large-plane pullback's loads_stores variant: no corner is formed (the
# tile's corners are stored as zeros) and a cell takes w and its first
# corner's values in place of its terms
_NO_CORNERS = ("if (a >= 0 && a <= nx - 2 && c >= 0 && c <= ny - 2) {", "if (false) {")
_NO_CELLS = ("const CellTerms<T> ct = odinn::gather_cell(", "const CellTerms<T> ct = stub_cell(")
_STUB_CELL = """
template <typename T>
__device__ __forceinline__ odinn::CellTerms<T> stub_cell(
    const odinn::Corner<T>& a, const odinn::Corner<T>&, const odinn::Corner<T>&,
    const odinn::Corner<T>&, T wc, T, T, T, T, const odinn::Recip<T>&) {
  return odinn::CellTerms<T>{wc, a.D, a.Q};
}
"""


def _build(name, src, lib_path):
    """``src`` built as csrc/<name>.cu is (ops/cuda/build.py's flags and
    include path) into ``lib_path``; (library, compiler output)."""
    from odinn_tpu_torch.ops.cuda.build import nvcc_command

    cmd = nvcc_command(name, lib_path)
    cmd[-1] = str(src)
    done = subprocess.run(cmd, check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib_path)), done.stdout + done.stderr


@contextlib.contextmanager
def _patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_plane: no CUDA device available", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    reps = int(args[args.index("--reps") + 1]) if "--reps" in args else 50
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from odinn_tpu_torch.core.params import PhysicalParameters
    from odinn_tpu_torch.ops import si_math
    from odinn_tpu_torch.ops.cuda import si_kernel
    from odinn_tpu_torch.ops.cuda.build import BUILD_DIR, SRC_DIR, build_all
    from odinn_tpu_torch.ops.cuda.common import derived_scalars

    built = build_all(["si_plane", "si_step_vjp", "si_plane_vjp"])
    ptxas = {k: v for name in built for k, v in cs.ptxas_summary(built[name][1]).items()
             if k.startswith(("si_assemble", "si_pcg", "si_step_vjp", "si_plane_vjp"))}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / "profile_plane.cu"
    src.write_text(SOURCE)
    floor_lib, _ = _build("profile_plane", src, BUILD_DIR / "libprofile_plane.so")
    floor_lib.floor_launch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    floor_lib.floor_launch.restype = ctypes.c_int
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    phys = PhysicalParameters()
    f32 = torch.float32
    exps = (5.0, 2.0, 4.0, 2.0)
    result = {"nvidia_smi": smi, "source": "odinn_tpu_torch/csrc/si_plane.cu, si_plane_vjp.cu",
              "reps": reps, "ptxas": ptxas, "plans": {}, "ms": {}, "call_ms": {}, "bound_ms": {},
              "floor_ms": {}}

    def floor(name, barriers, blocks, threads, cooperative):
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            err = floor_lib.floor_launch(barriers, blocks, threads, cooperative, stream)
            if err:
                raise RuntimeError(f"plane_floor failed with CUDA error {err}")
        result["floor_ms"][name] = cs.device_ms(launch, reps, ("plane_floor",))

    def inputs(shape, seed):
        H, B, raw = cs.kernel_inputs(*shape, f32, seed=seed)
        return H, B, derived_scalars(*(raw[:, k] for k in range(7)), phys.rho, phys.g)

    if "--pullback" not in args:
        for shape in ASSEMBLIES:
            tag = "x".join(map(str, shape))
            H, B, derived = inputs(shape, 64)
            work = torch.zeros((si_math.ROWS_PLANES,) + shape, dtype=f32, device="cuda")
            call = lambda: si_kernel.si_assemble(work, H, H, B, H, derived, cs.DT, 1.0, 0, True,
                                                 exps)
            name = f"si_assemble {tag}"
            result["ms"][name] = cs.device_ms(call, reps, ("si_assemble",))
            result["call_ms"][name] = cs.cuda_ms(call, reps)
            result["bound_ms"][name] = cs.bound_ms(*cs.assemble_bound(*shape, 4), f32)
            lay = si_kernel.assemble_plan(*shape, f32)
            result["plans"][name] = lay._asdict()
            floor(f"{name} assemble_empty", -1, lay.grid[0] * lay.grid[1] * lay.grid[2],
                  lay.threads, 0)
            # every other instantiated plan of the assembly, on the same call
            for r in si_kernel.ASM_ROWS:
                if r == lay.rows:
                    continue
                other = lay._replace(rows=r, tile_rows=si_kernel.ASM_GROUPS * r,
                                     grid=(lay.grid[0],
                                           -(-shape[1] // (si_kernel.ASM_GROUPS * r)),
                                           lay.grid[2]))
                with _patched(si_kernel, "assemble_plan", lambda *a, other=other, **k: other):
                    result["ms"][f"{name} R={r}"] = cs.device_ms(call, reps, ("si_assemble",))
        for n_g, nx, ny, it, mode in STEPS:
            shape = (n_g, nx, ny)
            tag = "x".join(map(str, shape))
            if si_kernel.si_plan(*shape, f32).layout is not None:
                raise AssertionError(f"{tag} should take the large-plane path")
            H, B, derived = inputs(shape, 13)
            name = f"si_step {mode} {tag} cg_iters={it}"
            if mode == "forward":
                call = lambda: si_kernel.si_step(H, H, B, H, derived, cs.DT, 1.0, it, exps)
                bound = cs.si_bound(*shape, 4, it)
            else:
                g = torch.randn(shape, generator=torch.Generator().manual_seed(16)).to("cuda")
                x = (H - 20.0).contiguous()
                call = lambda: si_kernel.si_step_transpose(g, x, H, B, derived, cs.DT, 1.0, it,
                                                           exps)
                bound = cs.si_transpose_bound(*shape, 4, it)
            result["ms"][name] = cs.device_ms(call, reps, ("si_assemble", "si_pcg"))
            result["call_ms"][name] = cs.cuda_ms(call, reps)
            result["bound_ms"][name] = cs.bound_ms(*bound, f32)
            lay = si_kernel.plane_plan(*shape, f32)
            result["plans"][name] = lay._asdict()
            floor(f"{name} empty", -1, lay.blocks, lay.threads, 0)
            floor(f"{name} grid_sync", 2 * it, lay.blocks, lay.threads, 1)
            del H, B, derived
            torch.cuda.empty_cache()

    # the pullback: the cluster route, the large-plane pullback on each of
    # its plans, and its loads_stores variant, on the same inputs
    text = (SRC_DIR / "si_plane_vjp.cu").read_text()
    for old, new in (_NO_CORNERS, _NO_CELLS):
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    head = '#include "si_vjp_common.cuh"\n'
    text = text.replace(head, head + _STUB_CELL, 1)
    variant_src = BUILD_DIR / "profile_plane_vjp_loads_stores.cu"
    variant_src.write_text(text)
    variant, log = _build("si_plane_vjp", variant_src,
                          BUILD_DIR / "libprofile_plane_vjp_loads_stores.so")
    result["ptxas"].update({f"{k} loads_stores": v for k, v in cs.ptxas_summary(log).items()})
    real = si_kernel._plane_vjp_library()
    for fn in ("si_plane_vjp_f32", "si_plane_vjp_f64"):
        getattr(variant, fn).argtypes = getattr(real, fn).argtypes
        getattr(variant, fn).restype = ctypes.c_int

    def cluster_plan(dtype, nx, ny, n_g, glen, vec, index):
        return si_kernel._vjp_plan(dtype, nx, ny, n_g, glen, vec, index).layout

    for shape in cs.PLANE_VJP_SHAPES:
        tag = "x".join(map(str, shape))
        H, B, derived = inputs(shape, 17)
        lam = torch.randn(shape, generator=torch.Generator().manual_seed(18)).to("cuda")
        x = si_kernel._si_solve_reference(H, H, B, H, derived, cs.DT, 1.0, 12, exps)
        call = lambda: si_kernel.si_step_vjp(lam, H, H, B, x, derived, cs.DT, 1.0, exps)
        name = f"si_step_vjp {tag}"
        bound = cs.bound_ms(*cs.si_vjp_bound(*shape, 4, planes_in=4), f32)
        lay = si_kernel.plane_vjp_plan(*shape, f32)
        with _patched(si_kernel, "_pullback_plan", cluster_plan):
            result["ms"][f"{name} cluster"] = cs.device_ms(call, reps, ("si_step_vjp_kernel",))
            result["call_ms"][f"{name} cluster"] = cs.cuda_ms(call, reps)
            result["plans"][f"{name} cluster"] = si_kernel.si_vjp_plan(*shape, f32)._asdict()
        result["ms"][f"{name} plane"] = cs.device_ms(call, reps, ("si_plane_vjp",))
        result["call_ms"][f"{name} plane"] = cs.cuda_ms(call, reps)
        result["plans"][f"{name} plane"] = lay._asdict()
        result["bound_ms"][name] = bound
        for r in si_kernel.ASM_ROWS:
            if r == lay.rows:
                continue
            other = lay._replace(rows=r, tile_rows=si_kernel.ASM_GROUPS * r,
                                 grid=(lay.grid[0],
                                       -(-shape[1] // (si_kernel.ASM_GROUPS * r)),
                                       lay.grid[2]))
            other = other._replace(slots=other.grid[0] * other.grid[1])
            with _patched(si_kernel, "_pullback_plan", lambda *a, other=other: other):
                result["ms"][f"{name} plane R={r}"] = cs.device_ms(call, reps, ("si_plane_vjp",))
        with _patched(si_kernel, "_plane_vjp_library", lambda: variant):
            result["ms"][f"{name} plane loads_stores"] = cs.device_ms(call, reps,
                                                                      ("si_plane_vjp",))
        floor(f"{name} plane_empty", -1, lay.grid[0] * lay.grid[1] * lay.grid[2], lay.threads, 0)
        del H, B, derived, lam, x
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
