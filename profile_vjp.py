"""Where the si_step_vjp pullback kernel spends its time, on one CUDA card.

    python3 profile_vjp.py [PARENT_ROOT]

Builds ``odinn_tpu_torch/csrc/si_step_vjp.cu`` as it is and in variants
with a phase left out (``-a`` the ring cells' relu(H_D), S, u, w; ``-b`` the
corners; ``-c`` the cells' gathers and stores; ``-abc`` all three;
``-abc-loads`` also the copies, which leaves the cluster launch, the
mbarrier and the blocks' sums) and one that records a globaltimer and
clock64 at each phase boundary of every block. Times each (profiler device
time, float32, Glen exponents, the SI trainings' call: theta = 1 and H_D
the same plane as H) at the SI training's 16 x 128^2 and the main path's
4 x 128^2 with the plan's cluster and at the other cluster size, and
a PyTorch clone of the four distinct input planes (what the card moves
for this many bytes). With PARENT_ROOT, a checkout of the parent commit, its
``si_step_vjp.cu`` (the 32 x 8-tile kernel with a ticket counter) is built
beside it and timed on the same inputs. A variant without a phase computes
a wrong result; only the full kernel's is checked (against the plain
version). Prints one JSON line a measurement, then the card's name and
power limit. Without a CUDA card it exits with code 2.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# text of the kernel's loops and copies, and what a variant puts there
_SKIP = {
    "a": ("for (Walk it(tid, C + 2, C + 2); it.r < (R + 3) / 2; it.next())",
          "for (Walk it(tid, C + 2, C + 2); false; it.next())"),
    "b": ("for (Walk it(tid, C + 1, C + 1); it.r < (R + 2) / 2; it.next())",
          "for (Walk it(tid, C + 1, C + 1); false; it.next())"),
    "c": ("for (Walk it(tid, C, C); it.r < (R + 1) / 2; it.next())",
          "for (Walk it(tid, C, C); false; it.next())"),
    "loads": ("  if (rank < ntiles) issue(rank, 0);\n", "\n"),
}
_TRACE_DECL = r'''
__device__ unsigned long long g_trace[8192 * 8];
__device__ long long g_clk[8192 * 8];
#define TR(k) do { if (threadIdx.x == 0) { unsigned long long t_; \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); g_trace[blockIdx.x * 8 + (k)] = t_; \
  g_clk[blockIdx.x * 8 + (k)] = clock64(); } } while (0)
'''
_TRACE_READ = r'''
extern "C" int vjp_trace_read(unsigned long long* t, long long* c, int n) {
  cudaError_t e = cudaMemcpyFromSymbol(t, g_trace, sizeof(unsigned long long) * n * 8);
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(c, g_clk, sizeof(long long) * n * 8);
  return static_cast<int>(e);
}
'''
# (text, point) -> the mark after it: 0 started, 1 copies issued, 2 data in,
# 3 (a) done, 4 (b) done, 5 (c) done, 6 cluster wait done, 7 end
_MARKS = [
    ("  cluster_arrive_relaxed();   // this block has started; waited on before the stores\n", 0),
    ("  if (rank < ntiles) issue(rank, 0);\n", 1),
    ("    const int r0 = (tile / ntc) * R, c0 = (tile % ntc) * C;\n    T* const sl", 2),
    ("    // (b) corner (lr, lc)", 3),
    ("    // (c) tile cell (li, lj)", 4),
    ("    // the next tile's copies or corners overwrite them\n    __syncthreads();\n", 5),
    ("  cluster_wait();   // every block has started: block 0's mbarrier is armed\n", 6),
]


def _variant(src, skip, trace):
    for ph in skip:
        old, new = _SKIP[ph]
        if old not in src:
            raise RuntimeError(f"profile_vjp: the kernel no longer has {old!r}")
        src = src.replace(old, new)
    if trace:
        src = src.replace("namespace {\n", _TRACE_DECL + "\nnamespace {\n", 1)
        for text, k in _MARKS:
            if text not in src:
                raise RuntimeError(f"profile_vjp: the kernel no longer has {text!r}")
            # marks 2 and 3, 4 go before their text; the others after
            src = (src.replace(text, f"TR({k});\n" + text, 1) if k in (2, 3, 4)
                   else src.replace(text, text + f"TR({k});\n", 1))
        end = "\n}\n\n// Once per instantiation"
        src = src.replace(end, "\nTR(7);" + end, 1) + _TRACE_READ
    return src


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_vjp: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from odinn_tpu_torch.core.params import PhysicalParameters
    from odinn_tpu_torch.ops.cuda import build as bd
    from odinn_tpu_torch.ops.cuda import si_kernel as sk
    from odinn_tpu_torch.ops.cuda.common import derived_scalars

    phys = PhysicalParameters()
    out_dir = bd.BUILD_DIR / "profile_vjp"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (bd.SRC_DIR / "si_step_vjp.cu").read_text()
    variants = {"full": ((), False), "-a": (("a",), False), "-b": (("b",), False),
                "-c": (("c",), False), "-abc": (("a", "b", "c"), False),
                "-abc-loads": (("a", "b", "c", "loads"), False), "trace": ((), True)}
    procs = {}
    for name, (skip, trace) in variants.items():
        cu = out_dir / f"vjp{name}.cu"
        cu.write_text(_variant(src, skip, trace))
        lib = out_dir / f"libvjp{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [bd._nvcc(), *bd._NVCC_FLAGS, "-I", str(bd.SRC_DIR), "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    parent = None
    if len(sys.argv) > 1:
        root = os.path.abspath(sys.argv[1])
        lib = out_dir / "libvjp_parent.so"
        procs["parent"] = (lib, subprocess.Popen(
            [bd._nvcc(), *bd._NVCC_FLAGS, "-I", os.path.join(root, "odinn_tpu_torch", "csrc"),
             "-o", str(lib), os.path.join(root, "odinn_tpu_torch", "csrc", "si_step_vjp.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"profile_vjp: nvcc failed for {name}:\n{log}")
        L = ctypes.CDLL(str(lib))
        if name == "parent":
            for fn in (L.si_step_vjp_f32, L.si_step_vjp_f64):
                fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 3
                               + [ctypes.c_double] * 2 + [ctypes.c_int]
                               + [ctypes.c_double] * 4 + [ctypes.c_void_p])
            L.si_step_vjp_partials.argtypes = [ctypes.c_int, ctypes.c_int]
            parent = L
            continue
        for fn in (L.si_step_vjp_f32, L.si_step_vjp_f64):
            fn.argtypes = sk._vjp_library().si_step_vjp_f32.argtypes
            fn.restype = ctypes.c_int
        if name == "trace":
            L.vjp_trace_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        libs[name] = L

    exps = (5.0, 2.0, 4.0, 2.0)
    for n_g in (cs.N_TRAIN, cs.N_G):
        H, B, raw = cs.kernel_inputs(n_g, cs.NX, cs.NY, torch.float32, seed=7)
        derived = derived_scalars(*(raw[:, k] for k in range(7)), phys.rho, phys.g)
        gen = torch.Generator().manual_seed(8)
        lam = torch.randn(H.shape, generator=gen, dtype=torch.float64).to("cuda", torch.float32)
        # the SI trainings' call: theta = 1, H_D is H
        HD, x = H, 0.99 * H
        args = (lam, H, HD, B, x, derived, cs.DT, 1.0, exps)
        plan = sk.si_vjp_plan(n_g, cs.NX, cs.NY, torch.float32, exps)
        want = sk.si_step_vjp_reference(*args)

        def run(L, lay):
            out = [torch.empty_like(H) for _ in range(3)] + [
                torch.empty(n_g, dtype=H.dtype, device="cuda") for _ in range(2)]
            err = L.si_step_vjp_f32(*(t.data_ptr() for t in (lam, H, HD, B, x)),
                                    derived.data_ptr(), derived.stride(0), 1,
                                    *(t.data_ptr() for t in out), n_g, cs.NX, cs.NY, cs.DT,
                                    1.0, 1, *exps, lay.cluster, lay.rows, lay.cols, lay.smem, 1,
                                    torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"profile_vjp: launch failed with CUDA error {err}")
            return out

        for c in (plan.layout.cluster, 24 - plan.layout.cluster):
            lay = sk.si_vjp_layout(cs.NX, cs.NY, torch.float32, c)
            if plan.max_active.get(c, 0) == 0:
                continue
            row = {"shape": [n_g, cs.NX, cs.NY], "cluster": c, "plan": c == plan.layout.cluster,
                   "rows": lay.rows, "max_active_clusters": plan.max_active[c]}
            got = run(libs["full"], lay)
            torch.cuda.synchronize()
            row["full_rel_err"] = [cs.rel_err(a, b) for a, b in zip(got, want)]
            for name, L in libs.items():
                if name != "trace":
                    row[f"{name}_us"] = cs.device_ms(lambda: run(L, lay), 100,
                                                     ("si_step_vjp_kernel",)) * 1e3
            run(libs["trace"], lay)
            torch.cuda.synchronize()
            nb = n_g * c
            tt = (ctypes.c_ulonglong * (8192 * 8))()
            cc = (ctypes.c_longlong * (8192 * 8))()
            if libs["trace"].vjp_trace_read(ctypes.addressof(tt), ctypes.addressof(cc), 8192):
                raise RuntimeError("profile_vjp: reading the trace failed")
            T = torch.tensor(list(tt[:nb * 8]), dtype=torch.float64).reshape(nb, 8)
            C = torch.tensor(list(cc[:nb * 8]), dtype=torch.float64).reshape(nb, 8)
            row["phase_cycles_median"] = dict(zip(
                ("issue", "wait", "a", "b", "c", "sum", "cluster_tail"),
                [int((C[:, k] - C[:, k - 1]).median()) for k in range(1, 8)]))
            row["mark_ns_max"] = [int(T[:, k].max() - T[:, 0].min()) for k in range(8)]
            cs.emit(row)
        four = torch.stack([lam, H, B, x])
        row = {"shape": [n_g, cs.NX, cs.NY],
               "clone_4_planes_us": cs.device_ms(four.clone, 100) * 1e3}
        if parent is not None:
            table = derived[:, :4].float().contiguous()
            part = torch.empty(2 * n_g * parent.si_step_vjp_partials(cs.NX, cs.NY),
                               device="cuda")
            cnt = torch.zeros(n_g, dtype=torch.int32, device="cuda")

            def run_parent():
                out = [torch.empty_like(H) for _ in range(3)] + [
                    torch.empty(n_g, device="cuda") for _ in range(2)]
                parent.si_step_vjp_f32(*(t.data_ptr() for t in (lam, H, HD, B, x, table)),
                                       *(t.data_ptr() for t in out[:3]), part.data_ptr(),
                                       cnt.data_ptr(), out[3].data_ptr(), out[4].data_ptr(),
                                       n_g, cs.NX, cs.NY, cs.DT, 1.0, 1, *exps,
                                       torch.cuda.current_stream().cuda_stream)
                return out

            got = run_parent()
            torch.cuda.synchronize()
            row["parent_rel_err"] = [cs.rel_err(a, b) for a, b in zip(got, want)]
            row["parent_us"] = cs.device_ms(run_parent, 100, ("si_step_vjp_kernel",)) * 1e3
            row["plan_us_again"] = cs.device_ms(lambda: run(libs["full"], plan.layout), 100,
                                                ("si_step_vjp_kernel",)) * 1e3
        cs.emit(row)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
