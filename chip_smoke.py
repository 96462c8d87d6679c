"""Smoke run of odinn_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device: the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions;
2. build: the CUDA kernels under ``odinn_tpu_torch/csrc``, one ``nvcc`` per
   source (``si_step.cu`` in a float32 and a float64 part), all started
   together;
3. kernel checks: each kernel against its plain PyTorch version on the card,
   at the main path's 4 x 128^2 and at a ragged 3 x 97 x 131 (the RKC and
   pullback kernels also at 2 x 10 x 33; at the training's 16 x 128^2
   ``rkc_interval`` at s = 8, and ``si_step``, its transpose-solve mode and
   ``si_step_vjp`` at PCG-20 on 8-block clusters, the 16th glacier in a
   second wave; at the folded continuous adjoint's 128 x 128^2
   ``sia2d_rhs`` and ``sia2d_rhs_vjp``, each with a bitwise repeat, as at
   every shape), in float64 and float32 (``si_step`` in
   float32 also on its increment out − H, at 6 and, at 4 x 128^2, 30 PCG
   iterations, with two launches on the same inputs bit-identical, and at
   2 x 300^2 on its large-plane path, there also at n = 4, where float32
   is held on its increment to 2x the float32 plain version's own error
   against float64, and on that path at phase 15's 1 x 1024^2, PCG-12,
   and, in float32, its 1 x 2048^2, PCG-12, and the odd 2 x 301 x 333,
   1 x 257 x 301 and 1 x 257 x 300 at PCG-6 (every plan of the large-plane
   pullback); ``rkc_interval`` at s = 8 and 25; the
   pullback also in its fused RKC-backward stage mode); the runtime-exponent
   paths (n = 4 with sliding for ``si_step``, ``sia2d_rhs`` and
   ``rkc_interval``; n = 3, 4 and 2.5 in one batch for ``sia2d_rhs`` and the
   pullback); every ``si_step`` check with the Jacobi preconditioner and
   without it (plain CG, the manual SI adjoints' solves); at each also its
   forward's pre-relu output, its transpose-solve mode, its tangent-solve
   mode (and, preconditioned, the ``si_step_vjp`` pullback kernel: on every
   large plane the large-plane pullback, which its launch count asserts)
   against their plain versions on the same inputs, each with a bitwise
   repeat;
   ``sia2d_rhs_jvp`` at 4 x 128^2 and 16 x 128^2 with n = 3, 4 and 3, 4,
   2.5 in one batch, its stage mode and the whole RKC2 step's tangent at
   16 x 128^2, s = 8, and both modes also at the ragged 3 x 41 x 101 and
   3 x 37 x 128 and the LM gates' 2 x 36^2, each on the wrapper's plan and
   on every other plan of ``jvp_layout`` (float32 within TOL_F32 or 2x the
   float32 plain version's own error against float64). Phase 3's gradient
   checks, which follow here, run beside the LM gates' process (phase 10),
   after phase 11: the three autograd Functions'
   tangents on the card (forward mode) against the CPU's float64 run to
   1e-9, and each tangent's duality with its backward, <u, J v> =
   <J^T u, v>, to 1e-10 (si_step at PCG-40 from a zero guess); the
   three autograd Functions' gradients (kernel forward, kernel backward)
   against their plain backwards in float64 (``si_step`` at PCG-6 and 20,
   theta = 1 and 1/2, on its large-plane path, and at the SI training's
   16 x 128^2, PCG-20, in two waves) and in float32 within
   2x the float32 plain version's own error, with a bitwise repeat of the
   backward; the hand-written adjoints' θ-gradients on the card (4 glaciers,
   128^2, 2 months): the discrete adjoint of Euler, SSPRK3 and RKC against
   the card's autograd gradient, of SI and SI2 and the continuous adjoint
   against the same function on the CPU in float64, float64 to 1e-9 and
   float32 within 2x the float32 plain version's own error; the RKC, SI and
   SI-pullback kernels' cluster size and occupancy at 4 and 16 glaciers (the
   pullback's also at 2 x 300^2, 3 x 97 x 131 and 2 x 10 x 33, with its
   tiles), and the large-plane path's plans (the cooperative PCG's blocks,
   bands and threads beside its resident blocks; the assembly's and the
   large-plane pullback's tiles);
4. main path: the forward prediction of 4 Halfar glaciers, 128^2, float32,
   5 years with monthly saves and monthly mass balance, Cuffey–Paterson A(T),
   n = 3, for the rows SI (PCG-6), SI2 (PCG-6), compensated SSPRK3 at 3
   substeps and RKC at 1 substep of 25 stages. Each row runs through
   ``run_prediction`` with the launch counters set to 0 just before and read
   just after; its final thickness is held against the port's float64 run of
   the row on the unfused path; it is timed with CUDA events, and its
   kernel launches are counted by name by the profiler (a main-path
   ``si_step`` is one ``si_step_cluster`` launch);
5. training, four times: ``run_inversion`` (Adam then LBFGS) of A = NN(T)
   on 16 Halfar glaciers, 128^2, float32, 2 years of monthly
   Cuffey–Paterson ground truth, through the RKC solve and then through the
   SI solve at PCG-20 (``benchmarks/perf_tpu.py``'s UDE epoch), each by
   autograd (``grad="jax"``) and by the discrete adjoint, with the launch
   counters set to 0 just before and read just after each; the time of one
   Adam epoch (forward, gradient, update) by CUDA events, its device idle
   share and its count of device kernel launches from the profiler; then
   one gradient by the continuous adjoint on the SI problem, its time,
   reverse steps per interval, host reads and launches;
6. classical inversion, four times, on the same 16 glaciers, 128^2,
   float32, 2 years: one tanh-bounded A per glacier (``LawA_inversion``)
   with a trainable initial thickness H0 (Zang1980 filter, noisy
   Farinotti start) against the thickness series plus a Tikhonov term on
   H0, through the SI solve at PCG-20, and one A per glacier against the
   mean dh/dt and the annual mean-velocity product (``LossDhdt`` +
   ``LossAvgV``) through the RKC solve, each by autograd and by the
   discrete adjoint, with the launches asserted as in phase 5, and the H0
   gradient nonzero; each prints a ``classical_inversion`` line (Adam
   epoch ms, busy ms, idle share, launches by kernel, losses,
   ``run_inversion`` seconds). Before the main path, the classical
   inversions' adjoint gradients on the card (4 x 128^2, 2 months; the
   discrete adjoint through SI and RKC with θ = {A, IC} and the Tikhonov
   term, through RKC with the aggregate losses, and the continuous adjoint
   with the Tikhonov term) are held to the card's autograd (RKC) or the
   CPU's float64 run (SI, continuous), float64 to 1e-12 per θ leaf and
   float32 within 2x the float32 plain version's own error;
7. laws and targets: the forward rows of phase 4 with a periodic
   per-glacier A law (Cuffey-Paterson A(T) times a factor of the trailing
   year's mean CPDD, refreshed yearly from the evolving surface) through SI
   (PCG-6) and RKC-25, with exactly 60 launches of the row's kernel, 4
   refreshes, the final thickness within 2x the float32 plain run's error
   and different from the row with the law frozen; ``run_inversion`` of
   NN(T) times the same factor as one periodic law through SI at PCG-20 by
   autograd, with the UDE SI training's launches; the hybrid-D (``LawY``)
   and pure-D (``LawU``) targets trained (Adam 3 epochs) through SI at
   PCG-20 by autograd and by the discrete adjoint on the generic path,
   with no kernel launch in the run or the profiled epoch (a
   ``periodic_training`` and four
   ``d_target_training`` lines, losses falling); before the main path,
   their gradients on the card (4 x 128^2, 2 months: Y, U and a capped A
   by autograd and the discrete adjoint through SI and RKC, the periodic
   law by autograd) against the CPU float64 run, float64 to 1e-9 and
   float32 within 2x the float32 plain version's own error, the periodic
   law's fused gradient also equal to its generic route's; and
   ``pretrain_law_from_A`` on the card in float64 (8 Fourier frequencies,
   48 noisy Cuffey-Paterson targets) below 1e-5 max relative error;
8. the ``kernels`` line: per kernel, what it replaces, its launches on the
   main path, its time, its plain version's time and its bound (with
   ``sia2d_rhs_jvp``, which replaces ``jax.jvp`` of the production RHS:
   no TPU kernel has a tangent; ``si_step`` with its transpose and tangent
   launches), with the
   same at the main path's other shapes under ``more`` (``si_step`` at 30
   PCG iterations, at the SI training's 16 x 128^2, PCG-20 beside 15
   glaciers, its transpose-solve mode, both modes there without the
   preconditioner, and on its large-plane path at
   4 x 128^2 and 2 x 300^2; ``rkc_interval`` at 16 x 128^2, s = 8; each
   pullback at its other shape and the fused RKC-backward stage); the
   large-plane path (``csrc/si_plane.cu``) as ``si_plane``: at phase 15's
   1 x 1024^2, PCG-12, its launches phase 15's (counted there alone, not
   again under ``si_step``), and under ``more`` at
   PCG-6, its transpose at PCG-12, 1 x 2048^2 PCG-12, 2 x 300^2 and 4 x
   128^2 PCG-6, and ``si_assemble`` alone at a rank's 16 x 66 x 128 slab
   and at 1 x 1024^2; the large-plane pullback (``csrc/si_plane_vjp.cu``)
   as ``si_plane_vjp``: at 1 x 1024^2, its launches phase 15's (counted
   there alone, not again under ``si_step_vjp``), and under ``more`` at
   2 x 300^2, 1 x 2048^2 and 4 x 512^2. The
   ``kernel_times`` line before it also times a one-element PyTorch fill,
   the card's single-launch floor. It is printed last, after phase 13, and
   its launches are all phases' (phase 13's ranks' too);
9. tolerance (the tolerance contract, float32, reltol 1e-4): the main
   path's scenario through ``run_prediction`` with ``adaptive=True``, whose
   ``sia2d_rhs`` launches must equal the integrator's RHS evaluations,
   with its accepted and rejected steps, host reads, time, busy time and
   idle share, its final H within 2x the float32 unfused replay's error
   against the float64 replay of its own recorded steps, and its accepted
   total within 2 % of the float64 unfused row's; ``run_inversion`` of A = NN(T) on the
   training batch with ``adaptive="replay"`` (``sia2d_rhs`` 3 a sub-step
   column a solve plus the probes, ``sia2d_rhs_vjp`` 3 a column a
   gradient) and with ``substeps="auto"`` through RKC (s = 8) and SI,
   the calibrated substeps (and ``cg_iters``) printed and
   the launches asserted per substep and probe; the phase's seconds.
   Before the main path, the replay gradient on the card (4 x 128^2, 2
   months) against the CPU's float64 run, float64 to 1e-9 per θ leaf and
   float32 within 2x the CPU's float32 error;
10. second order and forward mode: ``run_inversion`` of A = NN(T) on the
   training batch by Adam (2 epochs) then 3 Levenberg-Marquardt iterations
   (gn_cg_iters 8) through SI at PCG-20 and RKC at s = 8, with the LM trace
   monotone and ``si_step_tangent`` (SI) or ``sia2d_rhs_jvp`` (RKC) launched
   24 x (s x) the J·v products, and ``lm_train``'s iteration timed and
   profiled; the gates of tests/test_gauss_newton.py::
   test_lm_collapses_loss_after_adam on the card (2 x 36^2, RK4 at 15
   substeps, float64, Adam 30 then 8 of the test's 15 LM iterations,
   LM_GATE_EPOCHS: a gain of 15x, a monotone trace,
   A within 15 % at both temperatures, every RK4 stage's tangent one
   ``sia2d_rhs_jvp`` launch; host-bound, in a process of their own that
   starts after phase 11, runs beside phase 3's gradient checks, the
   forward-mode checks below (run after phase 11 too) and phases 12-14,
   and is joined after them);
   ``grad="forward"`` of the classical
   per-glacier A through SI and RKC, float64 against the CPU's forward
   mode and the card's autograd to 1e-9, float32 at full
   width within 2x the CPU float32 error, with its launches and Adam epoch;
11. ensembles, EKI and UQ, the member axis folded into the kernels'
   glacier axis (``simulation/ensemble.py``'s ``fold_members``): phase 5's
   SI training problem from 8 restarts (``multistart_train``: 128 planes a
   launch; one folded Adam epoch launching si_step 24 forward and 24
   transpose and si_step_vjp 24, timed and profiled beside phase 5's
   single-start epoch; 4 Adam epochs with restart 0 equal to a
   single-start ``run_inversion`` from θ0 within 1e-5, every restart's
   loss falling; again with ``refine_top_k=2`` and 2 LBFGS iterations;
   ``multistart_mode`` lines: the same fold under the discrete adjoint,
   ``ContinuousAdjoint(DiscreteVJP)`` and the dummy gradient with A =
   NN(T), and forward mode with per-glacier scalar A, 2 Adam epochs each:
   one folded epoch launching what a single-start epoch of the mode does,
   one launch a step for all 128 planes (the discrete adjoint si_step 48,
   transpose and si_step_vjp 24; the continuous one si_step 24, sia2d_rhs
   25 and sia2d_rhs_vjp once a pullback of its reverse steps; forward mode
   si_step and si_step_tangent 24 a θ leaf; the dummy gradient si_step 24),
   with the mode, seconds, epoch ms, busy ms and idle share; restart 0
   equal to a single-start ``run_inversion`` under the mode within 1e-5,
   every restart's loss falling, or under the dummy gradient every
   restart's θ moved by the same update; and ``multistart_mode_cut``
   lines: 2 restarts x 4 glaciers, 128^2, 3 months, PCG-6, float64, the
   folded gradient equal to the single starts' gradients of the mode on
   the card within 1e-10);
   ``eki_train`` on benchmarks/eki_bench.py's section 1 (16 glaciers, 64^2,
   SI PCG-12, 32 members, 15 iterations: si_step 6 a residual batch for
   all 512 planes, and the reference's A gate, max relative error <= 1e-3
   and min <= 1e-4) and section 3 (the adaptive forward, 4 glaciers, 32^2,
   8 members, 10 iterations: sia2d_rhs once an RHS evaluation of the
   folded integrator, the misfit falling); ``laplace_uncertainty`` of the
   classical SI problem per glacier (si_step_tangent 24 a θ leaf, every A
   with its std) and dense of A = NN(T) (p = 83, prior_std 0.5:
   si_step_tangent, si_step_transpose and si_step_vjp 24 x p each, a
   cov_band over 16 temperatures), and both curvature paths on 4 x 128^2,
   2 months, held to the CPU's float64 run (JᵀJ and θ stds to 1e-9; float32
   stds within 2x the CPU float32 error). Each line carries its seconds,
   busy time where profiled, launches and ``max_memory_allocated``. Before
   the main path, si_step (forward, transpose, tangent and si_step_vjp) is
   checked at the folded 128 x 128^2 (PCG-20) and 512 x 64^2 (PCG-12),
   whose plans run many waves of clusters (asserted; ``cluster_report``
   prints them), against its plain versions with a bitwise repeat, in both
   dtypes; ``kernel_times`` times those, the tangent-solve mode and
   sia2d_rhs_vjp at 128 x 128^2, and ``sia2d_rhs`` at 32 x 32^2;
12. data, I/O and the MLP mass balance (``data_io``), in a temporary
   directory: 16 synthetic .npz glaciers of 256^2 (the npz route, which
   needs no h5py) loaded by ``initialize_glaciers`` onto the
   card in float32 at grid_scaling_factor 2 (16 x 128^2), each with a
   2-frame velocity cube on its own 64^2 grid regridded on the card, held
   to the same load on the CPU in float64 (1e-6 of each field's max); an
   MLP mass balance (4-16-16-1) written by ``save_model`` and read back on
   the card by ``load_model``, its ``mb_timestep`` at 16 x 128^2 held to the
   CPU's float64 value (float64 1e-12, float32 within 2x the CPU float32
   error); Cuffey–Paterson ground truth with it through SI at PCG-20 over
   24 months, and a float64 cut (2 x 128^2, 6 months) held to the CPU's
   trajectory to 1e-12; ``run_inversion(path=...)`` of A = NN(T) by
   autograd, Adam 5, with a ``TrainingLogger``, the phase-5 launches
   asserted, the loss falling and one ``train_log.jsonl`` record an
   iteration; ``load_inversion_file`` on the card (θ bitwise), its sidecar's
   retcode, a ``run_prediction`` from the reloaded θ bitwise equal to the
   trained forward, the results file and a checkpoint round-tripped
   exactly; one Adam epoch's peak memory by ``aot_step_memory`` beside
   ``live_hbm_gib``, its time, busy time, idle share and launches;
13. scale-out (``scale_out``): the glacier axis over two gloo ranks that
   share the card (``launch_local_workers`` starts them as ``python -m
   chip_smoke RANK 2 PORT 1 --scale-out-worker DIR`` after the build, so
   they run no nvcc): phase 5's SI training by Adam 3 then one LM
   iteration (λ0 1e6, accepted), a float64 cut (4 x 128^2, 6 months, Adam
   2 then LM 2 from λ0 1e5: one step rejected, one accepted),
   ``multistart_train`` of 4 restarts and EKI on phase 11's section 1, each
   first in this process and then on the ranks, each rank on its 8 of the
   16 glaciers (2 restarts, 16 members); the float64 cut equal to the
   single process to 1e-12 (losses) and 1e-10 (θ per leaf, gathered
   trajectories), float32 Adam losses and trajectories and the multi-start
   curves to 1e-5, both LM stages' losses falling in this process and on
   both ranks, θ bitwise the same on both ranks after every iteration,
   each rank's launches asserted, EKI's A gate on both, one rank's Adam
   epoch timed and profiled on each; before the main path ``si_step`` is
   checked at a rank's 8 x 128^2 (one wave of clusters) and timed there.
14. grid-row sharding (``spatial``): ``launch_local_workers`` starts
   ``python -m chip_smoke RANK N PORT 1 --spatial-worker DIR full|cut``
   twice. "full": phase 5's SI training (16 x 128^2, float32, PCG-20, 24
   months) by Adam 2 on a (1 x 2) ``("glaciers", "rows")`` mesh of two ranks
   sharing the card, each on 16 x 64 rows; its losses and gathered
   trajectories equal to the single process's to 1e-5 and θ bitwise the
   same on both ranks after every iteration; one rank's Adam epoch timed
   and profiled with its row-group collectives and their wall seconds.
   "cut": phase 13's float64 cut (4 x 128^2), cut to 3 months, at PCG-6 on a
   (2 x 2) mesh of four ranks (Adam 2 then LM 2 from λ0 1e5, the discrete
   adjoint's gradient at θ0, and forward RK4 and RKC-25 rows over 12
   months), held to the single process at 1e-10 (the rows at 1e-12). Each
   rank's launches asserted: si_assemble once a step of every forward,
   transpose and tangent solve, si_rows_apply (iterations + 1) and
   si_rows_update (iterations) times each, si_step_vjp once a step of each
   pullback, no si_step; sia2d_rhs and rkc_interval on the RK4 and RKC rows.
   Then, in both jobs, the host-driven controllers on the rows, each held
   to the same run in one process: "full" the float32 adaptive row at
   reltol 1e-3 (accepted and trial counts equal, H to 1e-5, its device
   idle share profiled); "cut" the adaptive forward, calibrate_substeps,
   calibrate_substeps_si (PCG-8 probes), the replay record (1e-11 years),
   train_ude by the replayed schedule, one ContinuousAdjoint(DiscreteVJP)
   gradient (reverse steps equal), the per-glacier Laplace posterior of a
   per-glacier A (Σ to 1e-8), a forward of gridded law values (gridded
   temperature with a plane-mean factor, roughness of a bumpy bed; 1e-12)
   and make_shard_map_value_and_grad (glacier blocks with whole planes),
   the rest to 1e-10; each run's launches asserted (_controller_expected)
   and its collectives and seconds printed.
   Before the main path, si_assemble alone (three modes) and the row PCG's
   kernels are checked at a rank's 16 x 66 x 128 slab against their plain
   versions, with and without the Jacobi preconditioner, in both dtypes,
   both orders of the p planes, bitwise on a repeat (the row PCG also at a
   middle rank's 16 x 68 x 128, the bottom rank's 16 x 66 x 128, a ragged
   3 x 41 x 100, half a 1024^2 plane's 4 x 516 x 1024 and three odd
   widths, 3 x 41 x 101 as a middle and as a bottom rank and 2 x 260 x
   601, each with a rows_layout line and its ghost rows of p equal to
   their owner's), and the row-sharded step with a row group of one
   against si_step at 16 x 128^2, PCG-20; ``time_kernels`` times them
   there (the row PCG also at 4 x 516 x 1024), and sia2d_rhs and
   rkc_interval at the cut's slabs.
15. the ice-sheet domain (``icesheet``), benchmarks/icesheet_scale.py's
   scenario through ``forward_batch`` and the classical inversion's loss
   and gradient, in a process of its own (``python3 chip_smoke.py
   --icesheet-worker DIR``) started with the LM gates' and joined after
   them, so that it runs beside phase 3's gradient checks: one Halfar
   dome (R0 = 800 km, H0 = 3000 m, A = 8e-19, from its intrinsic time
   ~2.5e5 years, dx = 2.56 R0 / N), float32, SI2 (PCG-12, a PCG-6
   predictor, one substep), monthly saves, no mass balance,
   ``ConstantA``. At 1024^2 and at 2048^2 (the large-plane path asserted)
   the 10-year forward, 240 si_step launches, each one si_assemble and one
   si_pcg (the profiler asserts both), timed and profiled, with its peak
   memory (``utils/memory.py::aot_step_memory``, the benchmark's ``hbm``);
   one loss and gradient of the scalar-A inversion against observations
   at the span's ends from the forward at 1.2 A, timed, profiled by
   kernel, with its peak memory, with si_step, its transpose and
   si_step_vjp 240 each, all on the large-plane routes (the pullbacks
   ``si_plane_vjp``, counted on its entry of the kernels line alone); and
   the depth cut: over the first 2 intervals the kernels' gradient against
   the unfused float64 gradient (float64 to 1e-9, float32 within 2x the
   float32 unfused run's error), with the kernels' max |dH| there, where
   the unfused float64 cut fits the card (its peak memory measured
   first). At 1024^2 also the final H against the port's float64 unfused
   run within 2x the float32 unfused run's error. The phase's launches are
   asserted per run. Its times are contended: each line's
   ``times_beside`` says what ran beside them.

Any failed check raises, so the exit code is not 0. A ``done`` line gives
the whole run's seconds, build included, and each phase's. The last line is
``{"ok": true, "device": {...}}``. Without a CUDA card the script exits with
code 2 and prints no result.

    python3 chip_smoke.py --f32-attribution

runs phases 1 and 2 and then only :func:`f32_attribution`, which takes the
float32 gradient check of the hybrid-D target through SI apart, stage by
stage, on the card and on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
PEAK_FP64_OPS_PER_S = 34e12        # H100 SXM float64 outside the tensor cores

NX = NY = 128
N_G = 4
TSPAN = (5.0, 10.0)
DX = 100.0
DT = float(np.float32(1.0 / 12.0))

# float64: the kernel and its plain version do the same arithmetic in
# another order (fused multiply-adds, block-tree dot products) — roundoff.
TOL_F64 = 1e-10
# float32, relative to max|reference|: si_step's CG dot products are summed
# in another order (per-thread partials, a block tree, then the blocks'
# partials in a fixed tree, against torch's pairwise sum), which moves alpha
# and beta at the 1e-7 level in each iteration; sia2d_rhs has no reduction
# but its flux difference cancels digits. Measured on an H100: up to 3.3e-7
# (si_step) and 1.4e-6 (sia2d_rhs).
TOL_F32 = 1e-5
# float32 si_step on its increment, max|out − ref| / max|ref − H|: the step
# changes H by a small fraction of max|H|, so the same roundoff is a larger
# share of the increment. Measured on an H100: 6e-7 to 5.7e-5 (the largest
# at n = 4, 3 x 97 x 131).
TOL_F32_INCREMENT = 1e-4
# float32 rkc_interval, relative to max|reference|: each of the s stages
# rounds in another order (reciprocal spacings, the corner diffusivities
# from shared memory), and the Chebyshev recursion carries every stage's
# roundoff into the next with weights above 1. Measured on an H100: 2.1e-7
# (s = 8) to 2.7e-6 (s = 25); 3.5e-6 to 1.9e-5 when the kernel still
# contracted multiply-adds.
TOL_RKC_F32 = 1e-4
# float64 gradients of the autograd Functions (kernel forward and pullback)
# against autograd through the plain versions: the same derivative, taken
# by another route (the hand-written chain against autograd's), roundoff.
TOL_GRAD_F64 = 1e-9
# float32 gradient of the RKC Function at s = 25 against the float64 plain
# gradient: stage-by-stage roundoff through 25 stages forward (the
# rematerialised stages) and 25 pullbacks backward, which the plain version
# in float32 shows too (measured on an H100: 1.2e-4 of max|dH| and 1.1e-3 of
# max|d(creep)|). The kernels are held to this factor times the float32
# plain version's own error.
GRAD_F32_FACTOR = 2.0
# float64 gradients of the classical inversions' adjoints on the card
# against the card's autograd (RKC) or the CPU's float64 run (SI,
# continuous), each θ leaf relative to its own max|·|: the same arithmetic
# on both sides but for the kernels' roundoff.
TOL_CLASSICAL_F64 = 1e-12
RKC_STAGES = 25                    # the RKC row's stages (benchmarks/perf_tpu.py)
SI_TRAIN_CG = 20                   # the SI training's PCG iterations (benchmarks/perf_tpu.py)
# si_step's device kernels: the cluster kernel, the large-plane path's two
SI_KERNELS = ("si_step_cluster", "si_assemble", "si_pcg")
PROFILES = 3                       # profiles of an SI row or a kernel at most (complete_profile)
N_TRAIN = 16                       # glaciers of the training phase
TRAIN_TSPAN = (5.0, 7.0)           # 24 monthly intervals
PERIODIC_FREQ = 1.0                # the periodic laws' refresh interval, years
# the capped target's max_D, m^2/yr: the training glaciers' D reaches
# 2.8e4 (-25 C) to 1.1e5 (-13 C) at their Cuffey-Paterson A, so the cap bites
CAPPED_MAX_D = 3.0e4
# the tolerance phase's reltol: float32's setting (benchmarks/eki_bench.py);
# below ~1e-5 a float32 error estimate sits under the roundoff floor
TOL_RELTOL = 1e-4
# sia2d_rhs_jvp's ragged shapes (check_rhs_jvp_edges): a width that is no
# multiple of the 16-byte vector, a height that is no multiple of any tile's
# rows, and the LM gates' 2 x 36^2
JVP_EDGE_SHAPES = ((3, 41, 101), (3, 37, 128), (2, 36, 36))
# our kernels' device names: none may run in a D-target or capped solve
KERNEL_NAMES = ("si_step_cluster", "si_assemble", "si_pcg", "si_step_vjp_kernel",
                "si_plane_vjp", "sia2d_rhs_kernel", "sia2d_rhs_vjp_kernel",
                "rkc_interval_kernel", "sia2d_rhs_jvp_kernel", "si_rows_apply", "si_rows_update")
# the LM phase: Adam epochs, LM iterations and CG iterations of the
# training batch's stage; the Hutchinson probes of lm_train's default
LM_EPOCHS = (2, 3)
LM_CG = 8
LM_PROBES = 8
# the LM gates' Adam epochs and LM iterations: the test's 30 Adam epochs,
# then 8 of its 15 LM iterations, the depth cut that keeps the whole run
# inside its time limit (the gates are host-bound: 351-456 s at 15). On the
# card the 15-iteration trace passed the 15x gain at the 7th iteration
# (15.66x) and stood at 1.2e4x after the 8th; the 8 iterations draw the
# first two of the test's three probe sets
LM_GATE_EPOCHS = (30, 8)
LM_GATE_SHAPE = (2, 36, 36)        # the gates' glaciers and grid
LM_GATE_TIMEOUT = 600.0            # the wait for the gates' own process
# the initial θ of tests/test_gauss_newton.py::test_lm_collapses_loss_after_adam:
# the JAX package's NeuralNetwork(default_architecture(1, light=True),
# seed=666) in float64 (its PRNG's draw, which the port's generator does
# not give; the biases start at zero), layers of (w, b)
LM_GATE_THETA = (([[0.04867732064351498, -0.047657616765689574, -0.6919204952137169]],
                  [0.0, 0.0, 0.0]),
                 ([[-0.3170937381565713], [-1.0111563265851793], [-0.9639318097479094]],
                  [0.0]))
# ... and the Rademacher probes of that test's lm_train, the JAX package's
# draw: its three diagonal estimates (PRNGKey(0), then each refresh's
# split), eight probes each, as the signs of θ's entries in the JAX tree's
# leaf order (layer 1's b and w, layer 2's b and w). The estimate from eight
# probes decides the damping of the small leaves, so whether the stage gains
# the test's 15x depends on the draw: the gate is held on the test's own.
LM_GATE_PROBES = (
    ("+----+++--", "++--+--+++", "-+--++--+-", "-++-+-++++", "++++++++++", "---+++---+",
     "+++--+--+-", "-+--++--++"),
    ("-+++-+--+-", "+++---+--+", "+-----+++-", "-+----++--", "-+++++-+++", "-+++-+-+--",
     "++-+++-+--", "--+------+"),
    ("+-+--+---+", "---+--+--+", "++++++----", "+---+-++-+", "-+-+-++--+", "+++++++++-",
     "--++---+--", "+---+-+-++"))


# phase 11: the multistart restarts (128 planes a launch at 16 glaciers),
# Adam epochs and LBFGS iterations of the top 2; EKI's problem
# (benchmarks/eki_bench.py: sections 1 and 3) and the Adam epochs before
# the per-glacier posterior
MS_RESTARTS = 8
MS_EPOCHS = 4
MS_LBFGS = 2
EKI_TSPAN = (5.0, 5.5)             # 6 monthly intervals
EKI_GLACIERS, EKI_NX, EKI_CG, EKI_MEMBERS, EKI_ITERS = 16, 64, 12, 32, 15
EKI_A_GLACIERS, EKI_A_NX, EKI_A_MEMBERS, EKI_A_ITERS = 4, 32, 8, 10
UQ_ADAM = 5
# restart 0 of the folded multistart against the single start, float32
# losses: the same per-glacier arithmetic (each glacier's cluster is
# independent of the launch's other glaciers), summed over the member's
# glaciers in another order
TOL_RESTART0 = 1e-5
# phase 11's runs under the gradient modes other than autograd, each mode
# with its law: Adam epochs at full width; the dummy gradient's shared
# update, against the leaf's largest |θ| (float32 rounds each θ + update
# to ~1e-7 of |θ|; another member's draw would differ by the step, ~0.05);
# the float64 cut: restarts, glaciers, 3 months, PCG iterations, and its
# tolerance on the fold against the single starts (the same per-glacier
# arithmetic, summed in another order)
MS_MODES = (("discrete", "ude"), ("continuous", "ude"), ("forward", "classical"),
            ("dummy", "ude"))
MS_MODE_EPOCHS = 2
MS_MODE_REPS = 2                   # timed folded epochs a mode (phase 5's epochs take 5)
MS_DUMMY_TOL = 1e-6
MS_CUT_RESTARTS, MS_CUT_GLACIERS, MS_CUT_TSPAN, MS_CUT_CG = 2, 4, (5.0, 5.25), 6
TOL_FOLD_F64 = 1e-10
# the folded batches of phase 11 as si_step sees them: (planes, nx, ny,
# PCG iterations)
FOLDED_SI = ((MS_RESTARTS * N_TRAIN, NX, NY, SI_TRAIN_CG),
             (EKI_MEMBERS * EKI_GLACIERS, EKI_NX, EKI_NX, EKI_CG))
FOLDED_SI_SHAPES = [f[:3] for f in FOLDED_SI]
# the posterior's float64 JᵀJ and θ std on the card against the CPU's: the
# kernels' roundoff through 2 steps' tangent solves and pullbacks
TOL_UQ_F64 = 1e-9

# phase 12: the data path. generate_synthetic_rgi_dir's glaciers at 256^2,
# loaded at grid_scaling_factor 2 (the SI training's 16 x 128^2), each
# with a 2-frame velocity cube on its own 64^2 grid; the MLP mass balance's
# widths; 2 years of training; the float64 trajectory cut held to the
# CPU's (2 glaciers, 6 months)
DATA_N, DATA_NX, DATA_K, DATA_CUBE = 16, 256, 2, 64
DATA_TSPAN = (2010.0, 2012.0)
DATA_CUT_G, DATA_CUT_TSPAN = 2, (2010.0, 2010.5)
DATA_EPOCHS = 5
MB_WIDTHS = (4, 16, 16, 1)
MB_ACTIVATIONS = ("softplus", "tanh", "identity")
# the MLP's last layer is scaled by this, so its monthly MB stays within
# MB_LIMIT metres on the loaded glaciers
MB_SCALE, MB_LIMIT = 4.0, 5.0
# the card's float32 load against the CPU's float64 one, relative to each
# field's max|.|: the load runs in float64 and casts last, so float32
# rounding; the float64 MB step and trajectory on the card against the
# CPU's: the kernels' roundoff
TOL_LOAD_F32 = 1e-6
TOL_DATA_F64 = 1e-12

# phase 13: the glacier axis over SCALE_OUT_RANKS gloo ranks sharing the
# card. At full width (phase 5's SI problem) Adam then one LM iteration; the
# float64 cut (SCALE_OUT_CUT_G glaciers, 6 months) Adam 2 then LM 2 with 2
# CG iterations, below CG's convergence (~3 on these problems: A(T) over the
# glaciers' temperatures spans ~3 directions), since iterations past it
# divide roundoff by roundoff and turn the reduction order's last bits into
# ~1e-7 of θ. The LM stages start at a damping whose step is accepted: from
# the Adam iterate the 8-probe Hutchinson estimate of the net's first and
# last weight leaves comes out at its floor (1e-7 of the mean), so λ·diag
# bounds nothing there, the step moves those weights by ~10-20 and the loss
# rises at λ0 up to 1e4 (1e-3 in phases 10 and 11). The full width at 1e6
# accepts its step (23.9 -> 13.1 in a CPU float32 run); the cut at 1e5
# rejects its first and accepts its second at 1e6 (0.832 -> 0.526 in a CPU
# float64 run), so the ranks take both branches of the accept rule.
# multistart_train over SCALE_OUT_RESTARTS restarts (2 a rank)
SCALE_OUT_RANKS = 2
SCALE_OUT_EPOCHS, SCALE_OUT_DAMPING = (3, 1), 1e6
SCALE_OUT_CUT_G, SCALE_OUT_CUT_TSPAN, SCALE_OUT_CUT_EPOCHS = 4, (5.0, 5.5), (2, 2)
SCALE_OUT_CUT_CG, SCALE_OUT_CUT_DAMPING = 2, 1e5
SCALE_OUT_RESTARTS, SCALE_OUT_MS_EPOCHS = 4, 2
SCALE_OUT_TIMEOUT = 420.0
# the ranks' runs against the single process's: the float64 cut's losses
# and θ (per leaf) and trajectories; float32 losses of the Adam stage,
# trajectories and multi-start curves: the same arithmetic per glacier,
# summed over the glaciers in another order
TOL_SCALE_OUT_LOSS_F64, TOL_SCALE_OUT_F64 = 1e-12, 1e-10
TOL_SCALE_OUT_F32 = 1e-5
# phase 14 (spatial), grid-row sharding: the full width on a (1 x 2) mesh,
# two ranks sharing the card, each 16 x 64 rows of the 128^2 planes (Adam
# SPATIAL_EPOCHS by autograd); the float64 cut on a (2 x 2) mesh, four ranks:
# phase 13's cut (4 x 128^2, Adam 2 then LM 2 from λ0 1e5) over
# SPATIAL_CUT_TSPAN at SI PCG-SPATIAL_CUT_CG, the discrete adjoint's gradient
# at θ0, and forward RK4 (SPATIAL_RK4_SUBSTEPS) and RKC-25 rows over
# SPATIAL_ROW_TSPAN, held to the single process at TOL_SPATIAL_F64 and
# TOL_SPATIAL_ROWS_F64 (the full width's Adam losses and trajectories at
# TOL_SCALE_OUT_F32); the row kernels at a rank's slab (SPATIAL_SLAB: 64 own
# rows + 2 ghost rows), and more (ROWS_CHECK_SLABS)
SPATIAL_FULL, SPATIAL_CUT = (1, 2), (2, 2)
# the full width's depth cut: Adam 2, not 3 (a rank's epoch ~3.4 s on a
# card that two ranks share), to make room for the controller runs
SPATIAL_EPOCHS, SPATIAL_CUT_CG = 2, 6
# the float64 cut's depth cut: 3 months, not phase 13's 6, at which the
# cut's job took 35.5 s and the phase 116.5 s on an H100 80GB HBM3
# (PERF.md §6), against the phase's ~60 s
SPATIAL_CUT_TSPAN = (5.0, 5.25)
SPATIAL_ROW_TSPAN, SPATIAL_RK4_SUBSTEPS = (5.0, 6.0), 3
SPATIAL_TIMEOUT = 420.0
SPATIAL_SLAB = (N_TRAIN, NX // 2 + 2, NY)
# the row kernels' checks (check_rows_kernels): the top rank's slab with its
# own rows, a middle rank's (ghost rows on both sides), the bottom rank's
# (its own rows end at the plane's ring row), a ragged one (ny not a
# multiple of 32), half a 1024^2 plane with ghosts on both sides (64 rows
# a block), and three of odd ny (one value a thread a step): a middle
# rank's, a bottom rank's and a wide one
ROWS_LARGE_SLAB, ROWS_LARGE_OWN = (4, 516, 1024), (2, 514)
ROWS_CHECK_SLABS = ((SPATIAL_SLAB, (0, NX // 2)), ((N_TRAIN, NX // 2 + 4, NY), (2, NX // 2 + 2)),
                    ((N_TRAIN, NX // 2 + 2, NY), (2, NX // 2 + 2)),
                    ((3, 41, 100), (2, 39)), (ROWS_LARGE_SLAB, ROWS_LARGE_OWN),
                    ((3, 41, 101), (2, 39)), ((3, 41, 101), (2, 41)), ((2, 260, 601), (2, 258)))
TOL_SPATIAL_F64, TOL_SPATIAL_ROWS_F64 = 1e-10, 1e-12
# phase 14's runs under the host-driven controllers, each held to the
# single process: the full width's adaptive row (float32, at
# CTRL_FULL_RELTOL: at phase 9's 1e-4 the float32 state's own rounding is
# at the tolerance and the step counts are a draw), and on the float64 cut
# the adaptive forward, calibrate_substeps and the replay record at
# CTRL_RELTOL, calibrate_substeps_si at CTRL_SI_RELTOL (probes at PCG-8,
# candidates 4 and 6), train_ude with adaptive="replay" (Adam
# CTRL_REPLAY_EPOCHS), one ContinuousAdjoint(DiscreteVJP) gradient, the
# per-glacier Laplace posterior of a per-glacier A, a forward of gridded law
# values (RK4, SPATIAL_RK4_SUBSTEPS) and the explicit-collective step
CTRL_FULL_RELTOL, CTRL_RELTOL, CTRL_SI_RELTOL = 1e-3, 1e-4, 5e-3
CTRL_SI_PROBE = dict(cg_probe=8, cg_candidates=(4, 6))
CTRL_REPLAY_EPOCHS = 2
CTRL_C_MAX = 1e-17
# phase 15 (icesheet): benchmarks/icesheet_scale.py's ice-sheet domain, a
# Halfar dome of R0 = 800 km and H0 = 3000 m, A = 8e-19, T = -20 C, from its
# intrinsic time halfar_t0, dx = 2.56 R0 / N; float32, SI2 at one substep,
# PCG-12 with a PCG-6 predictor, monthly saves, no mass balance, ConstantA;
# 10 years at 1024^2 and at 2048^2 (the benchmark's span and sizes). The
# scalar-A inversion's gradient is held to the plain versions' float64
# gradient over the first ICE_GRAD_INTERVALS intervals: the depth cut, since
# a plain float64 autograd graph of 240 PCG solves at 1024^2 does not fit
# the card
ICE_R0, ICE_H0, ICE_A, ICE_TEMP = 800_000.0, 3000.0, 8e-19, -20.0
ICE_SIZES = ((1024, 10.0), (2048, 10.0))
ICE_GRAD_INTERVALS = 2
# PyTorch's own kernels named in a gradient's profile: the largest by device ms
ICE_OTHERS = 8
# odd large planes (check_kernels): rows and columns no tile divides; the
# pullback's R = 4 with one-value loads, R = 1 with one-value loads and R = 1
# with 16-byte loads (every other large-plane check takes R = 4 with 16-byte
# loads)
ODD_PLANES = ((2, 301, 333), (1, 257, 301), (1, 257, 300))
# the large-plane pullback's shapes (time_kernels, profile_plane.py): the
# check's 2 x 300^2, the ice sheet's planes, and
# benchmarks/si_pallas_bench.py:177-197's four 512^2 glaciers
PLANE_VJP_SHAPES = ((2, 300, 300), (1, 1024, 1024), (1, 2048, 2048), (4, 512, 512))
# what shares the card and the host with phase 15's timed runs
ICE_TIMES_BESIDE = ("contended: the main process's phase 3 gradient checks (and the phases "
                    "after them) and the LM gates' process run at the same time")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean time per call of ``reps`` back-to-back calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(fn, reps: int, names=None, ms_by_name=False):
    """(device ms, device launches, launches by name) per call of ``fn``
    from the profiler: the summed time and count of the device activities
    (kernels, memsets, copies) it launched, those whose name contains one
    of ``names`` when given, over ``reps`` calls; with ``ms_by_name`` also
    the device ms by name. (0.0, 0, {}) when the profiler saw no device
    time. A name is the kernel's own, without its namespaces and template
    arguments."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms, count, by_name, ms_of = _profile_sums(prof, reps, names)
    return (ms, count, by_name, ms_of) if ms_by_name else (ms, count, by_name)


def _profile_sums(prof, reps=1, names=None):
    """(device ms, device launches, launches by name, device ms by name)
    per call of a profile over ``reps`` calls (:func:`device_profile`)."""
    total_us, count, by_name, ms_of = 0.0, 0, {}, {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0.0 and (names is None or any(n in e.key for n in names)):
            total_us += us
            count += e.count
            short = re.sub(r"\(.*\)$", "", e.key.split("<")[0]).split("::")[-1].strip()
            by_name[short] = by_name.get(short, 0) + e.count / reps
            ms_of[short] = ms_of.get(short, 0.0) + us / reps / 1e3
    return total_us / reps / 1e3, count / reps, by_name, ms_of


def complete_profile(fn, reps: int, names, complete):
    """device_profile of ``fn``, taken again while ``complete`` says its
    launches by name are short, at most PROFILES times in all: the profiler
    can lose a device record (on an H100 it once counted 29 of 50 launches
    of a kernel, and 59 of an SI row's 60 si_step_cluster launches) but
    never adds one. Returns device_profile's three values and the number of
    profiles taken."""
    for attempt in range(1, PROFILES + 1):
        got = device_profile(fn, reps, names)
        if complete(got[2]):
            break
    return got + (attempt,)


def device_ms(fn, reps: int, names=None) -> float:
    return device_profile(fn, reps, names)[0]


def row_ms(fn, reps: int = 5) -> float:
    """Median over ``reps`` timed runs after one warm-up, by CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Kernel inputs and bounds
# ---------------------------------------------------------------------------

def kernel_inputs(n_g, nx, ny, dtype, seed):
    """Domes of varied height and radius on a smooth bed with 1 m of noise,
    and the raw per-glacier table (dx, dy, A, C, n, p, q), from a seed."""
    from odinn_tpu_torch.laws.laws import poly_A_paterson_cuffey

    gen = torch.Generator().manual_seed(seed)
    f64 = torch.float64
    x = (torch.arange(nx, dtype=f64) - nx / 2) * DX
    y = (torch.arange(ny, dtype=f64) - ny / 2) * DX
    r2 = x[:, None] ** 2 + y[None, :] ** 2
    radius = 0.35 * min(nx, ny) * DX * (0.8 + 0.4 * torch.rand(n_g, generator=gen, dtype=f64))
    height = 400.0 * (0.6 + 0.6 * torch.rand(n_g, generator=gen, dtype=f64))
    H = height[:, None, None] * torch.clamp(
        1.0 - r2 / radius[:, None, None] ** 2, min=0.0) ** (3.0 / 7.0)
    B = (50.0 * torch.sin(x / 700.0)[:, None] * torch.cos(y / 900.0)[None, :]
         + torch.rand((n_g, nx, ny), generator=gen, dtype=f64))
    A = poly_A_paterson_cuffey()(torch.linspace(-25.0, -13.0, n_g, dtype=f64))
    C = torch.where(torch.arange(n_g) % 2 == 1, A, torch.zeros_like(A))
    raw = torch.stack([torch.full((n_g,), DX, dtype=f64), torch.full((n_g,), 1.2 * DX, dtype=f64),
                       A, C, torch.full((n_g,), 3.0, dtype=f64),
                       torch.full((n_g,), 3.0, dtype=f64), torch.zeros(n_g, dtype=f64)], dim=1)
    dev = torch.device("cuda")
    return H.to(dev, dtype), B.to(dev, dtype), raw.to(dev)


# Operation counts per cell, from the plain versions' arithmetic: a corner
# diffusivity (slopes, |∇S|, H̄, the n = 3 integer powers, two terms) is 32;
# the fused RHS per interior cell (clamped edge gradients, fluxes,
# divergence) is 54; relu and S per cell 2.
def sia_bound(n_g, nx, ny, itemsize):
    cells, corners, inner = n_g * nx * ny, n_g * (nx - 1) * (ny - 1), n_g * (nx - 2) * (ny - 2)
    nbytes = 3 * cells * itemsize + n_g * 7 * 8
    ops = 2 * cells + 32 * corners + 54 * inner
    return nbytes, ops


# si_step, counted from what the step needs, with each face coefficient
# formed once and scaled by θ·dt/dx² or θ·dt/dy² once: per cell relu(H_D),
# S and the final relu (3); per corner its diffusivity (32); per interior
# cell the four faces and their scaled copies (12), u = B + (1−θ)·H (2), b
# (13) and the inverse Jacobi diagonal (5); per cell the initial residual
# b − A·x0 with z0 and r0·z0 (16); per cell and CG iteration 23: the matvec
# (4 differences, 4 products, 4 sums), two dot products (2 each) and the
# x, r, z and p updates (2, 2, 1, 2). H, H_D, B and x0 read once, the
# output written once. Without the preconditioner neither the inverse
# diagonal (5 an interior cell) nor z = r/diag (1 a cell and iteration,
# and z0) is formed.
def si_bound(n_g, nx, ny, itemsize, cg_iters, precondition=True):
    cells, corners, inner = n_g * nx * ny, n_g * (nx - 1) * (ny - 1), n_g * (nx - 2) * (ny - 2)
    nbytes = 5 * cells * itemsize + n_g * 8 * 8
    pre = 1 if precondition else 0
    ops = (3 * cells + 32 * corners + (27 + 5 * pre) * inner + (15 + pre) * cells
           + (22 + pre) * cells * cg_iters)
    return nbytes, ops


# si_step's transpose-solve mode: si_bound's count with g = gbar*[x > 0]
# (1 a cell) in place of the final relu, and neither u nor b (15 an
# interior cell); gbar, x, H_D and B read once, lambda written once.
def si_transpose_bound(n_g, nx, ny, itemsize, cg_iters, precondition=True):
    nbytes, ops = si_bound(n_g, nx, ny, itemsize, cg_iters, precondition)
    return nbytes, ops - 15 * n_g * (nx - 2) * (ny - 2)


# si_step_vjp: per cell relu(H_D), S, u and w (7); per corner its
# diffusivity (32), the four face products and D-bar (24), the two
# partials, Q, PX, PY and the creep and slide terms (24); per cell the
# four corners' Q, PX and PY (12), the faces and L_D(w) (21) and the three
# outputs (6). Each distinct input plane read once (lambda, H, H_D, B and
# x: 5 planes, 4 where H_D is H, as in the SI trainings), dH, dH_D and dB
# written once, and the two per-glacier sums.
def si_vjp_bound(n_g, nx, ny, itemsize, planes_in=5):
    cells, corners = n_g * nx * ny, n_g * (nx - 1) * (ny - 1)
    nbytes = (planes_in + 3) * cells * itemsize + n_g * 8 * 8 + 2 * n_g * itemsize
    return nbytes, 46 * cells + 80 * corners


# rkc_interval: per stage the fused RHS of every cell (as sia_bound counts
# it) and the stage combination (5 multiplies, 4 adds a cell); H and B are
# read once and H' written once for all s stages.
def rkc_bound(n_g, nx, ny, itemsize, s):
    nbytes, rhs_ops = sia_bound(n_g, nx, ny, itemsize)
    return nbytes, s * (rhs_ops + 9 * n_g * nx * ny)


# sia2d_rhs_vjp: per corner its diffusivity, the two partials and the creep
# factor (58), per edge its clamped slope and flux cotangent with the three
# routes back (19, two edges a cell), and per cell the four corners'
# contributions (12 each); lam, H and B read once, dH written once.
def vjp_bound(n_g, nx, ny, itemsize):
    cells, corners = n_g * nx * ny, n_g * (nx - 1) * (ny - 1)
    nbytes = 4 * cells * itemsize + n_g * 8 * 8 + n_g * itemsize
    return nbytes, 58 * corners + 2 * 19 * cells + 4 * 12 * cells


# the pullback's fused RKC-backward stage: the pullback, plus per cell
# lam = c·μ̃dt and the four carry updates (9 operations); c, the stage
# point and B read, c' written, pend, cot_y and cot_f0 read and written
def stage_bound(n_g, nx, ny, itemsize):
    nbytes, ops = vjp_bound(n_g, nx, ny, itemsize)
    cells = n_g * nx * ny
    return nbytes + 6 * cells * itemsize + n_g * itemsize, ops + 9 * cells


# si_step's tangent-solve mode: the transpose mode's count (the right-hand
# side read as given, the output masked by x > 0 in place of g's mask);
# rdot, x0, H_D, B and the forward's x read once, the tangent written once.
def si_tangent_bound(n_g, nx, ny, itemsize, cg_iters, precondition=True):
    nbytes, ops = si_transpose_bound(n_g, nx, ny, itemsize, cg_iters, precondition)
    return nbytes + n_g * nx * ny * itemsize, ops


# sia2d_rhs_jvp: per cell relu(H), S and dh (3); per corner its diffusivity
# (32) and its tangent (28: the slopes' tangents 8, |∇S|'s 5, H̄'s 4, the
# derivative terms 11); per interior cell the clamped slopes (16) and their
# tangents (24), the fluxes' tangents (24) and the divergence (6); dH, H and
# B read once, fdot written once. The stage mode also reads dH0, dY2 and
# df0 and writes ydot in place of fdot, and combines (9 a cell).
def jvp_bound(n_g, nx, ny, itemsize, stage=False):
    cells, corners, inner = n_g * nx * ny, n_g * (nx - 1) * (ny - 1), n_g * (nx - 2) * (ny - 2)
    planes = 7 if stage else 4
    nbytes = planes * cells * itemsize + n_g * 8 * 8 + n_g * itemsize
    return nbytes, (3 + (9 if stage else 0)) * cells + 60 * corners + 70 * inner


# phase 14's row kernels on a slab of n_g x nx x ny with ``own`` rows:
# si_rows_apply forms p = z + β·p on the slab (2 a cell), then the matvec on
# the own rows with each face coefficient formed from D's corners (8) and
# the matvec of si_bound (12), and the partial p·Ap (2); z, p, D read and p
# written on the slab, Ap written on the own rows. si_rows_update: x, r and
# z updates (2, 2, 1) and the partial r·z (2) a cell; x, r, p, Ap and the
# inverse diagonal read, x, r and z written, on the own rows. si_assemble
# alone: relu(H_D) and S (2 a cell), the corners (32), and per interior cell
# the faces, u, b and the Jacobi diagonal (32, as si_bound counts them); H,
# H_D and B read, D, b and the inverse diagonal written.
def rows_apply_bound(n_g, nx, ny, own, itemsize):
    slab, cells = n_g * nx * ny, n_g * own * ny
    return (4 * slab + cells) * itemsize + 3 * n_g * itemsize, 2 * slab + 22 * cells


def rows_update_bound(n_g, nx, ny, own, itemsize):
    cells = n_g * own * ny
    return 8 * cells * itemsize + 2 * n_g * itemsize, 7 * cells


def assemble_bound(n_g, nx, ny, itemsize):
    cells, corners, inner = n_g * nx * ny, n_g * (nx - 1) * (ny - 1), n_g * (nx - 2) * (ny - 2)
    return 6 * cells * itemsize + n_g * 4 * itemsize, 2 * cells + 32 * corners + 32 * inner


def bound_ms(nbytes, ops, dtype):
    peak = PEAK_FP32_OPS_PER_S if dtype == torch.float32 else PEAK_FP64_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def ptxas_entry(mangled: str) -> str:
    """A kernel instance's name from its mangled symbol, with its template
    arguments as tags: float32/float64, Glen (fixed exponents) or runtime
    exponents, the cells a thread owns (K; the tangent kernel's and the
    assembly's rows a thread, R), the pullback's and the tangent kernel's
    stage mode, the cluster kernel's mode (forward, transpose or tangent
    solve) and Jacobi or plain CG, si_rows_apply's start or iteration
    mode, or si_step_vjp's copy route and the row, tangent and large-plane
    kernels' vector width (16-byte or one value)."""
    i = 3 if mangled.startswith("_ZN") else 2 if mangled.startswith("_Z") else len(mangled)
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    rest, tags = mangled[i:], []
    if rest.startswith("I"):
        tags.append("f64" if rest.startswith("Id") else "f32")
        tags += [t for key, t in (("GlenExps", "Glen"), ("RuntimeExps", "runtime")) if key in rest]
        ints = re.findall(r"Li(\d+)E", rest)
        flags = re.findall(r"Lb(\d)E", rest)
        if name == "si_step_cluster":
            # si_step_cluster<T, E, K, kMode, kJ>
            tags += [f"K={ints[0]}", ("forward", "transpose", "tangent")[int(ints[1])]]
        elif name in ("si_assemble", "si_plane_vjp"):
            # si_assemble<T, E, R, kVec>, si_plane_vjp<T, E, R, kVec>,
            # si_pcg<T, kVec>: modes at run time
            tags.append(f"R={ints[0]}")
        elif ints:
            tags.append(f"K={ints[0]}")
        names = ([("vec16", "scalar")] if name.startswith("si_step_vjp")
                 or name in ("si_assemble", "si_pcg", "si_plane_vjp")
                 # si_rows_apply<T, kJ, kInit, kVec>, si_rows_update<T, kJ, kVec>
                 else [("jacobi", "plain-cg"), ("start", "iteration"), ("vec16", "scalar")]
                 if name == "si_rows_apply"
                 else [("jacobi", "plain-cg"), ("vec16", "scalar")] if name == "si_rows_update"
                 else [("jacobi", "plain-cg")] if name.startswith("si_")
                 # sia2d_rhs_jvp_kernel<T, R, kStage, kVec>
                 else [("stage", "plain"), ("vec16", "scalar")]
                 if name == "sia2d_rhs_jvp_kernel"
                 else [("stage", "pullback")])
        tags += [on if f == "1" else off for f, (on, off) in zip(flags, names)]
    return name + ("<" + ",".join(tags) + ">" if tags else "")


def ptxas_summary(log: str) -> dict:
    """``nvcc -Xptxas -v`` output as {kernel instance: [its register, spill
    and stack lines]}."""
    out, entry = {}, None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            entry = ptxas_entry(found.group(1))
        elif entry and ("registers" in line or "spill" in line):
            out.setdefault(entry, []).append(line.replace("ptxas info    :", "").strip())
    return out


def rel_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def check_kernels():
    """Phase 3: each kernel against its plain version on the card."""
    from odinn_tpu_torch.ops.cuda import si_kernel, sia_kernel
    from odinn_tpu_torch.ops.cuda.common import derived_scalars
    from odinn_tpu_torch.core.params import PhysicalParameters

    PHYS = PhysicalParameters()

    for shape in ((N_G, NX, NY), (3, 97, 131)):
        for dtype in (torch.float64, torch.float32):
            tol = TOL_F64 if dtype == torch.float64 else TOL_F32
            H, B, raw = kernel_inputs(*shape, dtype, seed=sum(shape))
            derived = derived_scalars(*(raw[:, k] for k in range(7)), PHYS.rho, PHYS.g)
            check_si(H, B, derived, shape, dtype, cg_iters=(6, 30) if shape[0] == N_G else (6,))
            check_rhs(H, B, raw, "sia2d_rhs", shape, dtype)
            check_rkc_and_vjp(H, B, derived, shape, dtype, tol)
            if shape[0] == N_G:
                check_rhs_jvp_sets(H, B, raw, shape, dtype)
    # the large-plane path of si_step: a plane that fits no cluster layout
    for dtype in (torch.float64, torch.float32):
        shape = (2, 300, 300)
        H, B, raw = kernel_inputs(*shape, dtype, seed=44)
        derived = derived_scalars(*(raw[:, k] for k in range(7)), PHYS.rho, PHYS.g)
        if si_kernel.si_plan(*shape, dtype).layout is not None:
            raise AssertionError(f"si_step: {shape} {dtype} should take the large-plane path")
        check_si(H, B, derived, shape, dtype, cg_iters=(6,))
    # the large-plane path at n = 4 (2 x 300^2, PCG-6): in float32 its
    # increment is held to GRAD_F32_FACTOR times the float32 plain version's
    # own increment error against float64 (or to TOL_F32_INCREMENT)
    for dtype in (torch.float64, torch.float32):
        shape = (2, 300, 300)
        H, B, raw = kernel_inputs(*shape, dtype, seed=49)
        raw[:, 4] = 4.0
        raw[:, 2:4] /= PHYS.rho * PHYS.g * 400.0   # D of the same size as at n = 3
        derived = derived_scalars(*(raw[:, k] for k in range(7)), PHYS.rho, PHYS.g)
        check_si(H, B, derived, shape, dtype, cg_iters=(6,), tag=" n=4 large-plane",
                 increment_factor=True)
    # phase 15's ice-sheet planes on the large-plane path at PCG-12 (every
    # mode, with and without the preconditioner): 1 x 1024^2 in both dtypes,
    # and 1 x 2048^2 in float32, whose bands and vectors no longer fit in L2
    for n, dtype in ((ICE_SIZES[0][0], torch.float64), (ICE_SIZES[0][0], torch.float32),
                     (ICE_SIZES[1][0], torch.float32)):
        shape = (1, n, n)
        H, B, raw = kernel_inputs(*shape, dtype, seed=70)
        derived = derived_scalars(*(raw[:, k] for k in range(7)), PHYS.rho, PHYS.g)
        if si_kernel.si_plan(*shape, dtype).layout is not None:
            raise AssertionError(f"si_step: {shape} {dtype} should take the large-plane path")
        # at 2048^2 plain CG's float32 increment carries the plain version's
        # own rounding (both 1.3e-4 off float64): held as at n = 4
        check_si(H, B, derived, shape, dtype, cg_iters=(12,),
                 increment_factor=n > ICE_SIZES[0][0])
    # odd large planes: the pullback's other plans (ODD_PLANES)
    for shape in ODD_PLANES:
        for dtype in (torch.float64, torch.float32):
            H, B, raw = kernel_inputs(*shape, dtype, seed=74)
            derived = derived_scalars(*(raw[:, k] for k in range(7)), PHYS.rho, PHYS.g)
            if si_kernel.si_plan(*shape, dtype).layout is not None:
                raise AssertionError(f"si_step: {shape} {dtype} should take the large-plane "
                                     f"path")
            check_si(H, B, derived, shape, dtype, cg_iters=(6,))
    # every instantiated plan of the large-plane pullback ran above, in both
    # dtypes: R = 4 and 1, 16-byte and one-value loads
    for dtype in (torch.float64, torch.float32):
        shapes = ((2, 300, 300), (1, ICE_SIZES[0][0], ICE_SIZES[0][0])) + ODD_PLANES
        plans = {(lay.rows, lay.width > 1)
                 for lay in (si_kernel.plane_vjp_plan(*shape, dtype) for shape in shapes)}
        if plans != {(r, v) for r in si_kernel.ASM_ROWS for v in (True, False)}:
            raise AssertionError(f"si_step_vjp: the large-plane checks ran the plans {plans} "
                                 f"in {dtype}, not every one")
    # 10 rows leave 3 of rkc_interval's and si_step's 8 cluster blocks
    # without rows, or 6 of 16 (97 rows: 2 of 16)
    for dtype in (torch.float64, torch.float32):
        H, B, raw = kernel_inputs(2, 10, 33, dtype, seed=45)
        derived = derived_scalars(*(raw[:, k] for k in range(7)), PHYS.rho, PHYS.g)
        check_rkc_and_vjp(H, B, derived, (2, 10, 33), dtype,
                          TOL_F64 if dtype == torch.float64 else TOL_F32)
        check_si(H, B, derived, (2, 10, 33), dtype, cg_iters=(6,))
    # the training's shape: 16 glaciers, s = 8 for rkc_interval; PCG-20
    # for si_step, its transpose-solve mode and si_step_vjp, where 8-block
    # clusters leave the 16th glacier to a second wave
    for dtype in (torch.float64, torch.float32):
        H, B, raw = kernel_inputs(N_TRAIN, NX, NY, dtype, seed=46)
        derived = derived_scalars(*(raw[:, k] for k in range(7)), PHYS.rho, PHYS.g)
        check_rkc(H, B, derived, (N_TRAIN, NX, NY), dtype, (8,))
        check_second_wave(dtype)
        check_si(H, B, derived, (N_TRAIN, NX, NY), dtype, cg_iters=(SI_TRAIN_CG,))
        # phase 13's share of a rank: the first half of the glaciers, one wave
        n_r = N_TRAIN // SCALE_OUT_RANKS
        check_one_wave(n_r, dtype)
        check_si(H[:n_r].contiguous(), B[:n_r].contiguous(), derived[:n_r].contiguous(),
                 (n_r, NX, NY), dtype, cg_iters=(SI_TRAIN_CG,))
        check_rhs_jvp_sets(H, B, raw, (N_TRAIN, NX, NY), dtype, stage_s=8)
    check_rhs_jvp_edges()
    # phase 11's folded batches: multistart's 8 restarts x 16 glaciers at
    # PCG-20 and EKI's 32 members x 16 glaciers of 64^2 at PCG-12, in many
    # waves of clusters (each glacier's cluster is independent: the bitwise
    # repeat shows that the waves' order changes no glacier's arithmetic)
    for dtype in (torch.float64, torch.float32):
        for n_g, nx, ny, it in FOLDED_SI:
            check_waves(n_g, nx, ny, dtype)
            H, B, raw = kernel_inputs(n_g, nx, ny, dtype, seed=50 + nx)
            derived = derived_scalars(*(raw[:, k] for k in range(7)), PHYS.rho, PHYS.g)
            check_si(H, B, derived, (n_g, nx, ny), dtype, cg_iters=(it,))
        # the folded continuous adjoint's 128 x 128^2: sia2d_rhs (the
        # Hermite slopes of H) and sia2d_rhs_vjp (its reverse pullbacks)
        shape = (MS_RESTARTS * N_TRAIN, NX, NY)
        H, B, raw = kernel_inputs(*shape, dtype, seed=52)
        derived = derived_scalars(*(raw[:, k] for k in range(7)), PHYS.rho, PHYS.g)
        check_rhs(H, B, raw, "sia2d_rhs", shape, dtype)
        check_rhs_vjp(H, B, derived, shape, dtype,
                      TOL_F64 if dtype == torch.float64 else TOL_F32)
    # the runtime-exponent paths: Glen n = 4 for rkc_interval (one set a
    # launch), n = 3, 4 and 2.5 in one batch for the pullback
    for dtype in (torch.float64, torch.float32):
        tol = TOL_F64 if dtype == torch.float64 else TOL_F32
        H, B, raw = kernel_inputs(3, 97, 131, dtype, seed=47)
        raw[:, 4] = 4.0
        raw[:, 2:4] /= PHYS.rho * PHYS.g * 400.0   # D of the same size as at n = 3
        derived = derived_scalars(*(raw[:, k] for k in range(7)), PHYS.rho, PHYS.g)
        check_rkc(H, B, derived, (3, 97, 131), dtype, (8,))
        # glacier 1 slides (C != 0)
        check_si(H, B, derived, (3, 97, 131), dtype, cg_iters=(6,), tag=" n=4")
        check_rhs(H, B, raw, "sia2d_rhs n=4", (3, 97, 131), dtype)
        raw[:, 4] = torch.tensor([3.0, 4.0, 2.5], dtype=raw.dtype, device=raw.device)
        derived = derived_scalars(*(raw[:, k] for k in range(7)), PHYS.rho, PHYS.g)
        check_rhs(H, B, raw, "sia2d_rhs n=3,4,2.5", (3, 97, 131), dtype)
        lam = torch.randn(H.shape, generator=torch.Generator().manual_seed(48),
                          dtype=torch.float64).to("cuda", dtype)
        dH, dcreep = sia_kernel.sia2d_rhs_vjp(lam, H, B, derived, PHYS.eta0)
        rH, rcreep = sia_kernel.sia2d_rhs_vjp_reference(lam, H, B, derived, PHYS.eta0)
        torch.cuda.synchronize()
        row = {"phase": "check", "kernel": "sia2d_rhs_vjp n=3,4,2.5", "shape": [3, 97, 131],
               "dtype": str(dtype), "dH_rel_err": rel_err(dH, rH),
               "dcreep_rel_err": rel_err(dcreep, rcreep), "tol": tol}
        emit(row)
        if not (row["dH_rel_err"] <= tol and row["dcreep_rel_err"] <= tol):
            raise AssertionError(f"sia2d_rhs_vjp disagrees with its plain version: {row}")
    # phase 14's row kernels at a rank's slab, and the row-sharded step
    # with a row group of one against si_step
    check_rows_kernels()
    check_rows_step()


def check_rows_kernels():
    """Phase 14's kernels at rank slabs (ROWS_CHECK_SLABS: the top rank's
    SPATIAL_SLAB, a middle rank's, the bottom rank's, a ragged one, half a
    1024^2 plane and three of odd width),
    float64 and float32, with and without the Jacobi preconditioner, the
    p planes in both orders: si_assemble alone (in its three modes at
    SPATIAL_SLAB, the forward mode elsewhere: D's corners, b and the
    inverse diagonal) against its plain version, then, from the plain
    assembly, the row PCG's start (si_rows_apply, start mode), two
    iterations of si_rows_apply and si_rows_update (the p planes swapped
    between them) against their plain versions (each partial and the x, r,
    z, p and Ap planes on the own rows), and the kernels' sequence run
    twice, bitwise the same; at each slab and dtype the kernels' plan (a
    rows_layout line) and the p invariant (check_rows_ghosts)."""
    from odinn_tpu_torch.core.params import PhysicalParameters
    from odinn_tpu_torch.ops import si_math
    from odinn_tpu_torch.ops.cuda import si_kernel
    from odinn_tpu_torch.ops.cuda.common import derived_scalars, shared_exps

    PHYS = PhysicalParameters()
    P, P2 = si_math.ROWS_P, si_math.ROWS_P2
    for shape, (r0, r1) in ROWS_CHECK_SLABS:
        own = slice(r0, r1)
        modes = (((si_math.FORWARD, "forward"), (si_math.TRANSPOSE, "transpose"),
                  (si_math.TANGENT, "tangent")) if shape == SPATIAL_SLAB
                 else ((si_math.FORWARD, "forward"),))
        for dtype in (torch.float64, torch.float32):
            tol = TOL_F64 if dtype == torch.float64 else TOL_F32
            lay = si_kernel.rows_layout(*shape, r0, r1, dtype)
            resident = si_kernel.rows_occupancy(lay, dtype)
            emit({"phase": "rows_layout", "shape": list(shape), "own_rows": [r0, r1],
                  "dtype": str(dtype), "layout": lay._asdict(),
                  "blocks_per_glacier": lay.cluster, "resident_clusters": resident,
                  "waves": -(-shape[0] // resident) if resident else None})
            H, B, raw = kernel_inputs(*shape, dtype, seed=61)
            derived = derived_scalars(*(raw[:, k] for k in range(7)), PHYS.rho, PHYS.g)
            exps = shared_exps(derived)
            table = derived[:, :4].to(dtype).contiguous()
            gen = torch.Generator().manual_seed(62)
            g = torch.randn(shape, generator=gen, dtype=torch.float64).to("cuda", dtype)
            x_fwd = H - 20.0
            beta = (0.3 + 0.1 * torch.rand(shape[0], generator=gen, dtype=torch.float64)).to(
                "cuda", dtype)
            alpha = (0.2 * torch.rand(shape[0], generator=gen, dtype=torch.float64)).to(
                "cuda", dtype)
            check_rows_ghosts(shape, r0, r1, dtype, table, beta)
            for mode, name in modes:
                rhs_in = H if mode == si_math.FORWARD else g
                for pre in (True, False):
                    def assembled(fn):
                        work = torch.zeros((si_math.ROWS_PLANES,) + shape, dtype=dtype,
                                           device="cuda")
                        fn(work, rhs_in, H, B, x_fwd, derived, DT, 1.0, mode, pre, exps)
                        return work

                    ref_work = assembled(si_kernel.si_assemble_reference)
                    ker_work = assembled(si_kernel.si_assemble)
                    for first, second in ((P2, P), (P, P2)):
                        def pcg(apply, update):
                            work = ref_work.clone()
                            x0 = (1.01 * H).contiguous()
                            parts = [apply(work, x0, None, first, second, r0, r1, table, DT,
                                           True, pre)]
                            parts.append(apply(work, None, beta, first, second, r0, r1, table,
                                               DT, False, pre))
                            parts.append(update(work, alpha, second, r0, r1, pre))
                            parts.append(apply(work, None, 0.5 * beta, second, first, r0, r1,
                                               table, DT, False, pre))
                            parts.append(update(work, 0.5 * alpha, first, r0, r1, pre))
                            return work, parts

                        kw, kp = pcg(si_kernel.si_rows_apply, si_kernel.si_rows_update)
                        kw2, kp2 = pcg(si_kernel.si_rows_apply, si_kernel.si_rows_update)
                        rw, rp = pcg(si_kernel.si_rows_apply_reference,
                                     si_kernel.si_rows_update_reference)
                        torch.cuda.synchronize()
                        errs = {
                            "D": rel_err(ker_work[si_math.ROWS_D][..., :-1, :-1],
                                         ref_work[si_math.ROWS_D][..., :-1, :-1]),
                            "b": rel_err(ker_work[si_math.ROWS_RHS], ref_work[si_math.ROWS_RHS]),
                            "inv_diag": rel_err(ker_work[si_math.ROWS_INV],
                                                ref_work[si_math.ROWS_INV]),
                            "partials": max(rel_err(a, b) for a, b in zip(kp, rp)),
                        }
                        for plane, label in ((si_math.ROWS_X, "x"), (si_math.ROWS_R, "r"),
                                             (si_math.ROWS_Z, "z"), (P, "p"), (P2, "p2"),
                                             (si_math.ROWS_AP, "Ap")):
                            errs[label] = rel_err(kw[plane][..., own, :], rw[plane][..., own, :])
                        row = {"phase": "check", "kernel": f"si_rows {name}"
                               + ("" if pre else " no-precondition"), "shape": list(shape),
                               "own_rows": [r0, r1], "p_planes": [first, second],
                               "dtype": str(dtype), "rel_errs": errs, "tol": tol,
                               "bitwise_repeat": bool(torch.equal(kw, kw2) and all(
                                   torch.equal(a, b) for a, b in zip(kp, kp2)))}
                        emit(row)
                        if not (max(errs.values()) <= tol and row["bitwise_repeat"]
                                and all(torch.isfinite(t).all() for t in kp)):
                            raise AssertionError(f"si_rows disagrees with its plain version or "
                                                 f"with itself: {row}")


def check_rows_ghosts(shape, r0, r1, dtype, table, beta):
    """The p invariant of csrc/si_rows.cu: a plane of own + nx rows cut into
    two slabs of ``shape`` with own rows [r0, r1), the second starting
    own rows below the first, z and p[src] the plane's on both (as the
    exchange leaves them); after si_rows_apply's iteration on each, each
    slab's ghost rows of p[dst] are torch.equal to the other's own rows
    there, in both p directions."""
    from odinn_tpu_torch.ops import si_math
    from odinn_tpu_torch.ops.cuda import si_kernel

    n_g, nx, ny = shape
    n_own = r1 - r0
    gen = torch.Generator().manual_seed(63)
    plane = lambda: torch.randn((n_g, n_own + nx, ny), generator=gen,
                                dtype=torch.float64).to("cuda", dtype)
    z, p_src, d = plane(), plane(), plane().abs()
    same = []
    for src, dst in ((si_math.ROWS_P2, si_math.ROWS_P), (si_math.ROWS_P, si_math.ROWS_P2)):
        slabs = []
        for top in (0, n_own):
            work = torch.zeros((si_math.ROWS_PLANES,) + shape, dtype=dtype, device="cuda")
            work[si_math.ROWS_Z] = z[:, top:top + nx]
            work[src] = p_src[:, top:top + nx]
            work[si_math.ROWS_D] = d[:, top:top + nx]
            si_kernel.si_rows_apply(work, None, beta, src, dst, r0, r1, table, DT, False)
            slabs.append(work[dst])
        first, second = slabs
        # the first slab's rows below r1 are the second's own rows [r0, ...);
        # the second's rows above r0 are the first's own rows [n_own, ...)
        same.append(torch.equal(first[:, r1:], second[:, r0:r0 + nx - r1]))
        if r0:
            same.append(torch.equal(second[:, :r0], first[:, n_own:n_own + r0]))
    torch.cuda.synchronize()
    row = {"phase": "check", "kernel": "si_rows p ghost rows", "shape": list(shape),
           "own_rows": [r0, r1], "dtype": str(dtype), "ghost_rows_equal": all(same),
           "comparisons": len(same)}
    emit(row)
    if not row["ghost_rows_equal"]:
        raise AssertionError(f"si_rows_apply forms a ghost row of p unlike its owner: {row}")


def check_rows_step():
    """The whole row-sharded SI step with a row group of one (the slab is
    the plane: si_assemble, then the row PCG) against si_step's cluster
    kernel at the SI training's 16 x 128^2, PCG-20, θ = 1 and ½: float64
    within TOL_F64; float32 within TOL_F32 of si_step or within
    GRAD_F32_FACTOR times si_step's own error against the float64 plain
    version."""
    from odinn_tpu_torch.core.params import PhysicalParameters
    from odinn_tpu_torch.ops.cuda import si_kernel
    from odinn_tpu_torch.ops.cuda.common import derived_scalars, shared_exps
    from odinn_tpu_torch.parallel.spatial import RowShard

    PHYS = PhysicalParameters()
    shard = RowShard(lo=0, hi=NX, nx=NX, halo=2)
    for dtype in (torch.float64, torch.float32):
        H, B, raw = kernel_inputs(N_TRAIN, NX, NY, dtype, seed=63)
        derived = derived_scalars(*(raw[:, k] for k in range(7)), PHYS.rho, PHYS.g)
        exps = shared_exps(derived)
        for theta in (1.0, 0.5):
            H_D = H if theta == 1.0 else 0.97 * H
            x0 = 0.99 * H
            args = (H, H_D, B, x0, derived, DT, theta, SI_TRAIN_CG, exps)
            rows = si_kernel.si_rows_step(shard, *args)
            again = si_kernel.si_rows_step(shard, *args)
            cluster = si_kernel.si_step(*args)
            plain64 = si_kernel.si_step_reference(
                *(t.double() for t in (H, H_D, B, x0)), derived.double(), DT, theta,
                SI_TRAIN_CG, exps)
            torch.cuda.synchronize()
            row = {"phase": "check", "kernel": f"si_rows_step group of 1 theta={theta}",
                   "shape": [N_TRAIN, NX, NY], "cg_iters": SI_TRAIN_CG, "dtype": str(dtype),
                   "rel_err_vs_si_step": rel_err(rows, cluster),
                   "rows_vs_f64_plain": rel_err(rows, plain64),
                   "si_step_vs_f64_plain": rel_err(cluster, plain64),
                   "bitwise_repeat": bool(torch.equal(rows, again))}
            if dtype == torch.float64:
                ok = row["rel_err_vs_si_step"] <= TOL_F64
            else:
                ok = (row["rel_err_vs_si_step"] <= TOL_F32 or row["rows_vs_f64_plain"]
                      <= GRAD_F32_FACTOR * row["si_step_vs_f64_plain"])
            emit(row)
            if not (ok and row["bitwise_repeat"] and torch.isfinite(rows).all()):
                raise AssertionError(f"the row-sharded step disagrees with si_step: {row}")


def check_rhs_jvp_sets(H, B, raw, shape, dtype, stage_s=None):
    """:func:`check_rhs_jvp` at the exponent sets of check_rhs: n = 3 (the
    kernel's fixed-multiply path), n = 4 (run time) and n = 3, 4, 2.5 in one
    batch; the stage mode at n = 3."""
    from odinn_tpu_torch.core.params import PhysicalParameters

    PHYS = PhysicalParameters()
    check_rhs_jvp(H, B, raw, "sia2d_rhs_jvp", shape, dtype, stage_s)
    raw4 = raw.clone()
    raw4[:, 4] = 4.0
    raw4[:, 2:4] /= PHYS.rho * PHYS.g * 400.0   # D of the same size as at n = 3
    check_rhs_jvp(H, B, raw4, "sia2d_rhs_jvp n=4", shape, dtype)
    raw4[:, 4] = torch.tensor([3.0, 4.0, 2.5], dtype=raw.dtype).repeat(shape[0])[:shape[0]].to(
        raw.device)
    check_rhs_jvp(H, B, raw4, "sia2d_rhs_jvp n=3,4,2.5", shape, dtype)


def check_second_wave(dtype):
    """Raises unless si_step's plan at the SI training's 16 x 128^2 is
    8-block clusters with fewer resident at once than glaciers, so that a
    check there runs the second-wave path."""
    from odinn_tpu_torch.ops.cuda import si_kernel

    plan = si_kernel.si_plan(N_TRAIN, NX, NY, dtype)
    if plan.layout is None or plan.layout.cluster != 8 or plan.max_active[8] >= N_TRAIN:
        raise AssertionError(f"si_step at {N_TRAIN} x {NX}^2 {dtype}: expected 8-block "
                             f"clusters in two waves, got {plan}")


def check_one_wave(n_g, dtype):
    """Raises unless si_step's plan at n_g x 128^2 is 8-block clusters all
    resident at once (one wave)."""
    from odinn_tpu_torch.ops.cuda import si_kernel

    plan = si_kernel.si_plan(n_g, NX, NY, dtype)
    if plan.layout is None or plan.layout.cluster != 8 or plan.max_active[8] < n_g:
        raise AssertionError(f"si_step at {n_g} x {NX}^2 {dtype}: expected 8-block "
                             f"clusters in one wave, got {plan}")


def check_waves(n_g, nx, ny, dtype):
    """Raises unless si_step's and si_step_vjp's plans schedule n_g glaciers
    of (nx, ny) as cluster launches with fewer clusters resident at once
    than glaciers (several waves)."""
    from odinn_tpu_torch.ops.cuda import si_kernel

    for name, plan in (("si_step", si_kernel.si_plan(n_g, nx, ny, dtype)),
                       ("si_step_vjp", si_kernel.si_vjp_plan(n_g, nx, ny, dtype))):
        if plan.layout is None or plan.max_active[plan.layout.cluster] >= n_g:
            raise AssertionError(f"{name} at {n_g} x {nx} x {ny} {dtype}: expected cluster "
                                 f"launches in several waves, got {plan}")


def check_si(H, B, derived, shape, dtype, cg_iters, tag="", increment_factor=False):
    """si_step against its plain version on the card (theta = 1 with
    H_D = H; theta = 0.5 with H_D != H), at each PCG iteration count, with
    the exponent set of the table, with the Jacobi preconditioner and
    without it (plain CG, the manual SI adjoints' solves); float32 also on
    the increment out - H, against TOL_F32_INCREMENT, and with
    ``increment_factor`` alternatively within GRAD_F32_FACTOR times the
    float32 plain version's own increment error against float64. Then two
    launches on the same inputs must agree bit for bit. The backward's two
    kernels likewise (:func:`check_si_backward`)."""
    from odinn_tpu_torch.ops.cuda import si_kernel
    from odinn_tpu_torch.ops.cuda.common import shared_exps

    exps = shared_exps(derived)
    tol = TOL_F64 if dtype == torch.float64 else TOL_F32
    path = si_kernel.si_plan(shape[0], shape[1], shape[2], dtype, exps).path
    for it in cg_iters:
        cases = {
            f"si_step{tag} theta=1 H_D=H cg_iters={it}": (H, H, H, 1.0),
            f"si_step{tag} theta=0.5 H_D!=H cg_iters={it}": (H, 0.97 * H, 0.99 * H, 0.5),
        }
        for case, (Hc, H_D, x0, theta) in cases.items():
            for pre in (True, False):
                name = case + ("" if pre else " no-precondition")
                call = lambda f, *a: f(*a, B, x0, derived, DT, theta, it, exps,
                                       precondition=pre)
                out = call(si_kernel.si_step, Hc, H_D)
                again = call(si_kernel.si_step, Hc, H_D)
                ref = call(si_kernel.si_step_reference, Hc, H_D)
                torch.cuda.synchronize()
                err = rel_err(out, ref)
                row = {"phase": "check", "kernel": name, "shape": list(shape), "path": path,
                       "exps": list(exps), "dtype": str(dtype), "rel_err": err, "tol": tol,
                       "bitwise_repeat": bool(torch.equal(out, again))}
                ok = err <= tol and row["bitwise_repeat"]
                if dtype == torch.float32:
                    h = H.double()
                    ref64 = si_kernel.si_step_reference(
                        h, H_D.double(), B.double(), x0.double(), derived.double(), DT, theta,
                        it, exps, precondition=pre)
                    row["increment_rel_err"] = rel_err(out.double() - h, ref.double() - h)
                    row["increment_tol"] = TOL_F32_INCREMENT
                    row["increment_vs_f64_plain"] = {
                        "kernel": rel_err(out.double() - h, ref64 - h),
                        "f32_plain": rel_err(ref.double() - h, ref64 - h)}
                    inc_ok = row["increment_rel_err"] <= TOL_F32_INCREMENT
                    if increment_factor:
                        v = row["increment_vs_f64_plain"]
                        row["increment_factor"] = GRAD_F32_FACTOR
                        inc_ok = inc_ok or v["kernel"] <= GRAD_F32_FACTOR * v["f32_plain"]
                    ok = ok and inc_ok
                emit(row)
                if not (torch.isfinite(out).all() and ok):
                    raise AssertionError(f"{name} disagrees with its plain version or with "
                                         f"itself: {row}")
                check_si_backward(Hc, H_D, B, x0, derived, DT, theta, it, exps, name, shape,
                                  dtype, pre)


def check_si_backward(H, H_D, B, x0, derived, dt, theta, it, exps, name, shape, dtype,
                      precondition=True):
    """The forward's pre-relu output x (kept under grad), the transpose-solve
    mode and the si_step_vjp pullback kernel against their plain versions
    on the same inputs (the transpose at the plain x, the pullback at the
    plain lambda, so a relu tie cannot differ), each with a bitwise repeat
    of its launch; without the preconditioner x and the transpose solve
    only (the pullback has no such mode). The pullback's launches must take
    the large-plane kernel (si_step_vjp.plane_launches) exactly where the
    step takes the large-plane path. Tolerances as for the forward,
    each relative to max|reference|; in float32 the per-glacier sums
    d(creep) and d(slide), which cancel digits over the corners, pass also
    within GRAD_F32_FACTOR times the float32 plain version's own error
    against float64."""
    from odinn_tpu_torch.ops.cuda import si_kernel

    tol = TOL_F64 if dtype == torch.float64 else TOL_F32
    gbar = torch.randn(shape, generator=torch.Generator().manual_seed(sum(shape) + it),
                       dtype=torch.float64).to("cuda", dtype)
    _, x = si_kernel._forward(H, H_D, B, x0, derived, dt, theta, it, exps, keep_x=True,
                              precondition=precondition)
    x_ref = si_kernel._si_solve_reference(H, H_D, B, x0, derived, dt, theta, it, exps,
                                          precondition)
    check_si_tangent(x_ref, x0, H_D, B, derived, dt, theta, it, exps, name, shape, dtype,
                     precondition)
    lam_args = (gbar, x_ref, H_D, B, derived, dt, theta, it, exps, precondition)
    lam = si_kernel.si_step_transpose(*lam_args)
    lam_again = si_kernel.si_step_transpose(*lam_args)
    lam_ref = si_kernel.si_step_transpose_reference(*lam_args)
    if not precondition:
        torch.cuda.synchronize()
        errs = {"x": rel_err(x, x_ref), "lambda": rel_err(lam, lam_ref)}
        row = {"phase": "check", "kernel": f"{name} backward kernels", "shape": list(shape),
               "dtype": str(dtype), "rel_err": errs, "tol": tol,
               "bitwise_repeat": {"lambda": bool(torch.equal(lam, lam_again))}}
        emit(row)
        if not (all(e <= tol for e in errs.values()) and row["bitwise_repeat"]["lambda"]
                and torch.isfinite(x).all() and torch.isfinite(lam).all()):
            raise AssertionError(f"{name}: the kernels disagree with their plain versions "
                                 f"or with themselves: {row}")
        return
    vjp_args = (lam_ref, H, H_D, B, x_ref, derived, dt, theta, exps)
    plane_before = si_kernel.si_step_vjp.plane_launches
    got = si_kernel.si_step_vjp(*vjp_args)
    again = si_kernel.si_step_vjp(*vjp_args)
    plane_vjp = si_kernel.si_step_vjp.plane_launches - plane_before
    large = si_kernel.si_plan(*shape, dtype, exps).layout is None
    want = si_kernel.si_step_vjp_reference(*vjp_args)
    torch.cuda.synchronize()
    names = ("dH", "dH_D", "dB", "dcreep", "dslide")
    errs = {"x": rel_err(x, x_ref), "lambda": rel_err(lam, lam_ref)}
    errs.update({k: rel_err(a, b) for k, a, b in zip(names, got, want)})
    ok = {k: e <= tol for k, e in errs.items()}
    repeat = {"lambda": bool(torch.equal(lam, lam_again)),
              "vjp": all(torch.equal(a, b) for a, b in zip(got, again))}
    row = {"phase": "check", "kernel": f"{name} backward kernels", "shape": list(shape),
           "dtype": str(dtype), "rel_err": errs, "tol": tol, "bitwise_repeat": repeat,
           "vjp_route": "si_plane_vjp" if plane_vjp else "si_step_vjp",
           "vjp_plane_launches": plane_vjp}
    if plane_vjp != (2 if large else 0):
        raise AssertionError(f"{name}: {plane_vjp} of 2 pullbacks on the large-plane kernel, "
                             f"where the step takes the {'large-plane' if large else 'cluster'} "
                             f"path: {row}")
    if dtype == torch.float32:
        want64 = si_kernel.si_step_vjp_reference(*(t.double() for t in vjp_args[:5]),
                                                 derived.double(), dt, theta, exps)
        row["vs_f64_plain"] = {}
        for k, a, b, c in zip(names[3:], got[3:], want[3:], want64[3:]):
            e_k, e_p = rel_err(a, c), rel_err(b, c)
            row["vs_f64_plain"][k] = {"kernel": e_k, "f32_plain": e_p}
            ok[k] = ok[k] or e_k <= GRAD_F32_FACTOR * e_p
    emit(row)
    finite = all(torch.isfinite(t).all() for t in (x, lam) + tuple(got))
    if not (finite and all(ok.values()) and all(repeat.values())):
        raise AssertionError(f"{name}: the backward's kernels disagree with their plain "
                             f"versions or with themselves: {row}")


def check_si_tangent(x, x0, H_D, B, derived, dt, theta, it, exps, name, shape, dtype,
                     precondition=True):
    """si_step's tangent-solve mode (ẋ = PCG(A, ṙ) from the primal guess
    x0, masked by the forward's x > 0) against its plain version on the
    same inputs, with a bitwise repeat; ṙ a random plane. float32 passes
    within TOL_F32 of max|reference| or within GRAD_F32_FACTOR times the
    float32 plain version's own error against float64: the solve from x0
    carries its own rounding."""
    from odinn_tpu_torch.ops.cuda import si_kernel

    tol = TOL_F64 if dtype == torch.float64 else TOL_F32
    rdot = torch.randn(shape, generator=torch.Generator().manual_seed(sum(shape) + 3 * it),
                       dtype=torch.float64).to("cuda", dtype)
    args = (rdot, x, x0, H_D, B, derived, dt, theta, it, exps, precondition)
    got = si_kernel.si_step_tangent(*args)
    again = si_kernel.si_step_tangent(*args)
    want = si_kernel.si_step_tangent_reference(*args)
    torch.cuda.synchronize()
    row = {"phase": "check", "kernel": f"{name} tangent solve", "shape": list(shape),
           "path": si_kernel.si_plan(*shape, dtype, exps).path, "dtype": str(dtype),
           "rel_err": rel_err(got, want), "tol": tol,
           "bitwise_repeat": bool(torch.equal(got, again))}
    ok = row["rel_err"] <= tol
    if dtype == torch.float32:
        want64 = si_kernel.si_step_tangent_reference(*(t.double() for t in args[:5]),
                                                     derived.double(), *args[6:])
        row["vs_f64_plain"] = {"kernel": rel_err(got, want64), "f32_plain": rel_err(want, want64),
                               "factor": GRAD_F32_FACTOR}
        ok = ok or row["vs_f64_plain"]["kernel"] <= GRAD_F32_FACTOR * row["vs_f64_plain"][
            "f32_plain"]
    emit(row)
    if not (ok and row["bitwise_repeat"] and torch.isfinite(got).all()):
        raise AssertionError(f"{name}: the tangent-solve mode disagrees with its plain "
                             f"version or with itself: {row}")


def check_rhs_jvp(H, B, raw, name, shape, dtype, stage_s=None):
    """sia2d_rhs_jvp against its plain version on the card (dH a random
    plane, d(creep) a tenth of each glacier's creep), with a bitwise repeat,
    on the wrapper's plan and on every other plan of jvp_layout (R = 1, 2,
    4 rows a thread, and the plan's R with loads of one value); with
    ``stage_s`` also its stage mode (stage 5 of ``stage_s``, keeping and not
    keeping fdot) and the whole RKC2 step's tangent (interval_tangent, s + 1
    launches) at the RKC training's step. float32 passes within TOL_F32
    (TOL_RKC_F32 for the step) of max|reference| or within GRAD_F32_FACTOR
    times the float32 plain version's own error against float64."""
    from odinn_tpu_torch.core.params import PhysicalParameters
    from odinn_tpu_torch.ops.cuda import rkc_kernel, sia_kernel

    PHYS = PhysicalParameters()
    gen = torch.Generator().manual_seed(sum(shape) + 5)
    planes = [torch.randn(shape, generator=gen, dtype=torch.float64).to("cuda", dtype)
              for _ in range(4)]
    derived = sia_kernel.derive_table(raw, PHYS.rho, PHYS.g).to(dtype)
    d_creep = 0.1 * derived[:, 2]
    cases = {name: (lambda m, a: m(a[0], a[1], a[2], a[3], a[4], PHYS.eta0),
                    (planes[0], H, B, derived, d_creep))}
    if stage_s is not None:
        dt = DT * (stage_s / RKC_STAGES) ** 2
        weights = rkc_kernel._stage_weights(stage_s, dtype, dt)[1][5]
        for keep in (True, False):
            cases[f"{name} rkc stage keep_f={keep}"] = (
                lambda m, a, k=keep: m(a[0], a[1], a[2], a[3], a[4], PHYS.eta0,
                                       stage=(a[5], a[6], a[7], weights), keep_f=k),
                (planes[0], H, B, derived, d_creep, planes[1], planes[2], planes[3]))
    plan = sia_kernel.jvp_layout(*shape, dtype)
    others = {f"R={r}": sia_kernel.jvp_layout(*shape, dtype, rows=r)
              for r in sia_kernel.JVP_ROWS if r != plan.rows}
    others[f"R={plan.rows} scalar"] = sia_kernel.jvp_layout(*shape, dtype, vec=False,
                                                           rows=plan.rows)
    pick = lambda r: [t for t in (r if isinstance(r, tuple) else (r,)) if t is not None]
    for case, (call, args) in cases.items():
        want = call(sia_kernel.sia2d_rhs_jvp_reference, args)
        want64 = call(sia_kernel.sia2d_rhs_jvp_reference, tuple(a.double() for a in args))
        for tag, layout in [("plan", None)] + list(others.items()):
            kern = sia_kernel.sia2d_rhs_jvp if layout is None else functools.partial(
                sia_kernel._jvp_launch, layout=layout)
            got = call(kern, args)
            again = call(kern, args)
            torch.cuda.synchronize()
            errs = [rel_err(a, b) for a, b in zip(pick(got), pick(want))]
            vs64 = [(rel_err(a, c), rel_err(b, c))
                    for a, b, c in zip(pick(got), pick(want), pick(want64))]
            check_tangent_row(case if layout is None else f"{case} {tag}", shape, dtype, errs,
                              vs64, TOL_F32,
                              all(torch.equal(a, b) for a, b in zip(pick(got), pick(again))),
                              n=sorted(set(raw[:, 4].tolist())),
                              layout=(plan if layout is None else layout)._asdict())
    if stage_s is not None:
        dt = DT * (stage_s / RKC_STAGES) ** 2
        exps = tuple(float(e) for e in derived[0, 4:8].tolist())
        args = (planes[0], d_creep, H, B, derived, dt, stage_s, PHYS.eta0, exps)
        got = rkc_kernel.interval_tangent(*args)
        again = rkc_kernel.interval_tangent(*args)
        want = rkc_kernel.interval_tangent_reference(*args)
        want64 = rkc_kernel.interval_tangent_reference(
            *(a.double() for a in args[:5]), *args[5:])
        torch.cuda.synchronize()
        check_tangent_row(f"rkc_interval tangent s={stage_s}", shape, dtype,
                          [rel_err(got, want)], [(rel_err(got, want64), rel_err(want, want64))],
                          TOL_RKC_F32, bool(torch.equal(got, again)))


def check_rhs_jvp_edges():
    """sia2d_rhs_jvp (check_rhs_jvp_sets: both modes, every plan, the three
    exponent sets) at shapes that put each edge of the plan in play, in
    both dtypes: 3 x 41 x 101 (ny no multiple of the 16-byte vector, so
    loads of one value, and a last tile of 5 of 32 columns), 3 x 37 x 128
    (nx a multiple of no tile's rows) and the LM gates' 2 x 36^2 (a last
    tile of 4 columns)."""
    for dtype in (torch.float64, torch.float32):
        for shape in JVP_EDGE_SHAPES:
            H, B, raw = kernel_inputs(*shape, dtype, seed=sum(shape) + 60)
            check_rhs_jvp_sets(H, B, raw, shape, dtype, stage_s=8)


def check_tangent_row(name, shape, dtype, errs, vs64, tol32, repeat, **extra):
    """Emit a tangent kernel's check row; raise unless each output is within
    TOL_F64 (float64) or tol32 (float32) of max|plain version|, or in
    float32 within GRAD_F32_FACTOR times the plain version's own error
    against float64, and the repeat launch was bit-identical."""
    tol = TOL_F64 if dtype == torch.float64 else tol32
    row = dict({"phase": "check", "kernel": name, "shape": list(shape), "dtype": str(dtype),
                "rel_err": errs, "tol": tol, "bitwise_repeat": repeat}, **extra)
    ok = [e <= tol for e in errs]
    if dtype == torch.float32:
        row["vs_f64_plain"] = [{"kernel": k, "f32_plain": p} for k, p in vs64]
        row["factor"] = GRAD_F32_FACTOR
        ok = [o or k <= GRAD_F32_FACTOR * p for o, (k, p) in zip(ok, vs64)]
    emit(row)
    if not (all(ok) and repeat and all(np.isfinite(errs))):
        raise AssertionError(f"{name}: the tangent kernel disagrees with its plain version "
                             f"or with itself: {row}")


def check_rhs(H, B, raw, name, shape, dtype):
    """sia2d_rhs against its plain version on the card."""
    from odinn_tpu_torch.core.params import PhysicalParameters
    from odinn_tpu_torch.ops.cuda import sia_kernel

    PHYS = PhysicalParameters()
    tol = TOL_F64 if dtype == torch.float64 else TOL_F32
    out = sia_kernel.sia2d_rhs(H, B, raw, PHYS.rho, PHYS.g, PHYS.eta0)
    again = sia_kernel.sia2d_rhs(H, B, raw, PHYS.rho, PHYS.g, PHYS.eta0)
    ref = sia_kernel.sia2d_rhs_reference(H, B, raw, PHYS.rho, PHYS.g, PHYS.eta0)
    torch.cuda.synchronize()
    row = {"phase": "check", "kernel": name, "shape": list(shape), "dtype": str(dtype),
           "n": sorted(set(raw[:, 4].tolist())), "rel_err": rel_err(out, ref), "tol": tol,
           "bitwise_repeat": bool(torch.equal(out, again))}
    emit(row)
    if not (torch.isfinite(out).all() and row["rel_err"] <= tol and row["bitwise_repeat"]):
        raise AssertionError(f"{name} disagrees with its plain version: {row}")


def check_rkc(H, B, derived, shape, dtype, stage_counts):
    """rkc_interval against its plain version on the card, at each s in
    ``stage_counts`` at the stability ratio of the RKC row's monthly step
    at 25 stages."""
    from odinn_tpu_torch.core.params import PhysicalParameters
    from odinn_tpu_torch.ops.cuda import rkc_kernel
    from odinn_tpu_torch.ops.cuda.common import shared_exps

    PHYS = PhysicalParameters()
    exps = shared_exps(derived)
    for s_ in stage_counts:
        dt = DT * (s_ / RKC_STAGES) ** 2
        out = rkc_kernel.rkc_interval(H, B, derived, dt, s_, PHYS.eta0)
        ref = rkc_kernel.rkc_interval_reference(H, B, derived, dt, s_, PHYS.eta0, exps)
        torch.cuda.synchronize()
        tol_r = TOL_F64 if dtype == torch.float64 else TOL_RKC_F32
        row = {"phase": "check", "kernel": f"rkc_interval s={s_}", "shape": list(shape),
               "exps": list(exps), "dtype": str(dtype), "rel_err": rel_err(out, ref), "tol": tol_r,
               "increment_rel_err": rel_err(out.double() - H.double(),
                                            ref.double() - H.double())}
        emit(row)
        if not (torch.isfinite(out).all() and row["rel_err"] <= tol_r):
            raise AssertionError(f"rkc_interval disagrees with its plain version: {row}")


def check_rhs_vjp(H, B, derived, shape, dtype, tol):
    """sia2d_rhs_vjp against its plain version on the card at a random
    cotangent, with a bitwise repeat (each glacier's d(creep) is summed by
    its last block in block order); returns the cotangent."""
    from odinn_tpu_torch.core.params import PhysicalParameters
    from odinn_tpu_torch.ops.cuda import sia_kernel

    PHYS = PhysicalParameters()
    lam = torch.randn(shape, generator=torch.Generator().manual_seed(sum(shape) + 1),
                      dtype=torch.float64).to("cuda", dtype)
    dH, dcreep = sia_kernel.sia2d_rhs_vjp(lam, H, B, derived, PHYS.eta0)
    dH2, dcreep2 = sia_kernel.sia2d_rhs_vjp(lam, H, B, derived, PHYS.eta0)
    rH, rcreep = sia_kernel.sia2d_rhs_vjp_reference(lam, H, B, derived, PHYS.eta0)
    torch.cuda.synchronize()
    row = {"phase": "check", "kernel": "sia2d_rhs_vjp", "shape": list(shape),
           "dtype": str(dtype), "dH_rel_err": rel_err(dH, rH),
           "dcreep_rel_err": rel_err(dcreep, rcreep), "tol": tol,
           "bitwise_repeat": bool(torch.equal(dH, dH2) and torch.equal(dcreep, dcreep2))}
    emit(row)
    if not (torch.isfinite(dH).all() and torch.isfinite(dcreep).all()
            and row["dH_rel_err"] <= tol and row["dcreep_rel_err"] <= tol
            and row["bitwise_repeat"]):
        raise AssertionError(f"sia2d_rhs_vjp disagrees with its plain version: {row}")
    return lam


def check_rkc_and_vjp(H, B, derived, shape, dtype, tol):
    """rkc_interval and sia2d_rhs_vjp against their plain versions on the card."""
    from odinn_tpu_torch.core.params import PhysicalParameters
    from odinn_tpu_torch.ops.cuda import rkc_kernel

    PHYS = PhysicalParameters()
    check_rkc(H, B, derived, shape, dtype, (8, RKC_STAGES))
    lam = check_rhs_vjp(H, B, derived, shape, dtype, tol)
    # the fused RKC-backward stage (stage 5 of 8, at the point H), first
    # with zero carries (j = s), then with carries
    weights = rkc_kernel._stage_weights(8, dtype, DT * (8 / RKC_STAGES) ** 2)[1][5]
    gen = torch.Generator().manual_seed(sum(shape) + 2)
    carry = tuple(torch.randn(shape, generator=gen, dtype=torch.float64).to("cuda", dtype)
                  for _ in range(3)) + (torch.randn(shape[0], generator=gen,
                                                    dtype=torch.float64).to("cuda", dtype),)
    for first in (True, False):
        start = None if first else carry
        got = rkc_kernel.stage_pullback(
            lam, None if first else tuple(t.clone() for t in carry), H, B, derived, PHYS.eta0,
            weights)
        want = rkc_kernel.stage_pullback_reference(lam, start, H, B, derived, PHYS.eta0, weights)
        torch.cuda.synchronize()
        names = ("c", "pend", "cot_y", "cot_f0", "dcreep")
        errs = {n: rel_err(a, b) for n, a, b in zip(names, (got[0],) + tuple(got[1]),
                                                    (want[0],) + tuple(want[1]))}
        row = {"phase": "check", "kernel": "sia2d_rhs_vjp rkc stage", "first": first,
               "shape": list(shape), "dtype": str(dtype), "rel_err": errs, "tol": tol}
        emit(row)
        if not all(e <= tol for e in errs.values()) or not all(
                torch.isfinite(t).all() for t in (got[0],) + tuple(got[1])):
            raise AssertionError(f"the fused RKC-backward stage disagrees with its plain "
                                 f"version: {row}")


def cluster_report():
    """The RKC and SI kernels' plans: cluster size and
    cudaOccupancyMaxActiveClusters at 8 and 16 blocks, for 4 and 16
    glaciers of 128^2 in both dtypes (and si_step's path at the large-plane
    check's 300^2); si_step's and si_step_vjp's also at phase 11's folded
    batches (128 x 128^2, 512 x 64^2), si_step_vjp's at the other check
    shapes, with their tiles; the large-plane path's (a ``plane_plan``
    line): the cooperative PCG's blocks, bands and threads beside its
    resident blocks and the large-plane pullback's tiles
    (``plane_vjp_plan``) at 2 x 300^2, 1 x 1024^2, 1 x 2048^2, 4 x 512^2 and
    the odd plane, and the assembly's tiles there and at a rank's slab."""
    from odinn_tpu_torch.ops.cuda import rkc_kernel, si_kernel

    for phase, make_plan in (("rkc_cluster", rkc_kernel.rkc_plan),
                             ("si_cluster", si_kernel.si_plan),
                             ("si_vjp_cluster", si_kernel.si_vjp_plan)):
        plans = {}
        shapes = [(n_g, NX, NY) for n_g in (N_G, N_TRAIN)]
        if phase != "rkc_cluster":
            shapes += FOLDED_SI_SHAPES
        if phase == "si_vjp_cluster":
            shapes += [(2, 300, 300), (3, 97, 131), (2, 10, 33)]
        for dtype in (torch.float32, torch.float64):
            for shape in shapes:
                plan = make_plan(*shape, dtype)
                key = (f"n_g={shape[0]}" if shape[1:] == (NX, NY)
                       else "x".join(map(str, shape)))
                plans[f"{dtype} {key}"] = {
                    "cluster": plan.layout.cluster,
                    "max_active_clusters": {str(c): n for c, n in plan.max_active.items()},
                    "layout": plan.layout._asdict()}
        line = {"phase": phase, "grid": [NX, NY], "plans": plans}
        if phase == "si_cluster":
            line["path_2x300x300"] = si_kernel.si_plan(2, 300, 300, torch.float32).path
        emit(line)
    # the large-plane path's plans: the cooperative PCG's blocks, bands and
    # threads beside the blocks resident at once, and the assembly's tiles
    plans = {}
    for dtype in (torch.float32, torch.float64):
        for shape in PLANE_VJP_SHAPES + ODD_PLANES + (SPATIAL_SLAB,):
            key = f"{dtype} " + "x".join(map(str, shape))
            plans[key] = {"assemble": si_kernel.assemble_plan(*shape, dtype)._asdict()}
            if shape != SPATIAL_SLAB:
                plans[key].update(pcg=si_kernel.plane_plan(*shape, dtype)._asdict(),
                                  resident_blocks=si_kernel.plane_occupancy(dtype),
                                  pullback=si_kernel.plane_vjp_plan(*shape, dtype)._asdict())
    emit({"phase": "plane_plan", "plans": plans})


def check_gradients():
    """The autograd Functions on the card (kernel forward, pullback kernel
    backward) against autograd through the plain versions, float64, at the
    main path's shape; the RKC Function also in float32; then si_step's
    (:func:`check_si_gradients`)."""
    from odinn_tpu_torch.core.params import PhysicalParameters
    from odinn_tpu_torch.ops.cuda import rkc_kernel, sia_kernel
    from odinn_tpu_torch.ops.cuda.common import derived_scalars

    PHYS = PhysicalParameters()
    H, B, raw = kernel_inputs(N_G, NX, NY, torch.float64, seed=11)
    lam = torch.randn(H.shape, generator=torch.Generator().manual_seed(12),
                      dtype=torch.float64).to("cuda")
    derived = derived_scalars(*(raw[:, k] for k in range(7)), PHYS.rho, PHYS.g)

    def grads(fn, table):
        h, tab = H.clone().requires_grad_(True), table.clone().requires_grad_(True)
        return torch.autograd.grad(fn(h, tab), (h, tab), lam)

    s_ = 8
    dt = DT * (s_ / RKC_STAGES) ** 2
    cases = {
        "sia2d_rhs": (lambda h, t: sia_kernel.sia2d_rhs(h, B, t, PHYS.rho, PHYS.g, PHYS.eta0),
                      lambda h, t: sia_kernel.sia2d_rhs_reference(h, B, t, PHYS.rho, PHYS.g,
                                                                  PHYS.eta0), raw),
        f"rkc_interval s={s_}": (
            lambda h, t: rkc_kernel.rkc_interval(h, B, t, dt, s_, PHYS.eta0),
            lambda h, t: rkc_kernel.rkc_interval_reference(h, B, t, dt, s_, PHYS.eta0), derived),
    }
    for name, (kern, plain, table) in cases.items():
        gk, gp = grads(kern, table), grads(plain, table)
        torch.cuda.synchronize()
        row = {"phase": "check_grad", "function": name, "dtype": "torch.float64",
               "dH_rel_err": rel_err(gk[0], gp[0]),
               "d_table_col2_rel_err": rel_err(gk[1][:, 2], gp[1][:, 2]), "tol": TOL_GRAD_F64}
        emit(row)
        if not (row["dH_rel_err"] <= TOL_GRAD_F64 and row["d_table_col2_rel_err"] <= TOL_GRAD_F64):
            raise AssertionError(f"{name}: gradient disagrees with autograd through its plain "
                                 f"version: {row}")
    # the training dtype: float32 kernels against the float64 plain gradient
    H32, B32, lam32 = H.float(), B.float(), lam.float()

    def grads32(fn, Hx, Bx, lx):
        h, tab = Hx.clone().requires_grad_(True), derived.clone().requires_grad_(True)
        return torch.autograd.grad(fn(h, Bx, tab), (h, tab), lx)

    gk = grads32(lambda h, b, t: rkc_kernel.rkc_interval(h, b, t, DT, RKC_STAGES, PHYS.eta0),
                 H32, B32, lam32)
    gp = grads32(lambda h, b, t: rkc_kernel.rkc_interval_reference(h, b, t, DT, RKC_STAGES,
                                                                   PHYS.eta0), H, B, lam)
    gp32 = grads32(lambda h, b, t: rkc_kernel.rkc_interval_reference(h, b, t, DT, RKC_STAGES,
                                                                     PHYS.eta0), H32, B32, lam32)
    torch.cuda.synchronize()
    row = {"phase": "check_grad", "function": f"rkc_interval s={RKC_STAGES}",
           "dtype": "torch.float32 vs float64 plain", "dH_rel_err": rel_err(gk[0], gp[0]),
           "d_table_col2_rel_err": rel_err(gk[1][:, 2], gp[1][:, 2]),
           "f32_plain_dH_rel_err": rel_err(gp32[0], gp[0]),
           "f32_plain_d_table_col2_rel_err": rel_err(gp32[1][:, 2], gp[1][:, 2]),
           "factor": GRAD_F32_FACTOR}
    emit(row)
    if not (row["dH_rel_err"] <= GRAD_F32_FACTOR * row["f32_plain_dH_rel_err"]
            and row["d_table_col2_rel_err"]
            <= GRAD_F32_FACTOR * row["f32_plain_d_table_col2_rel_err"]):
        raise AssertionError(f"rkc_interval float32 gradient disagrees: {row}")
    check_si_gradients(H, B, derived, lam)


def si_grads(H, H_D, B, x0, table, gbar, theta, it, kernel):
    """(dH, dH_D, dB, d(creep), d(slide)) of si_step at ``gbar``: through
    its autograd Function (kernel forward, transpose mode and pullback
    kernel) or by autograd through its plain version, si_step_reference."""
    from odinn_tpu_torch.ops.cuda import si_kernel

    step = si_kernel.si_step if kernel else si_kernel.si_step_reference
    leaves = [t.clone().requires_grad_(True) for t in (H, H_D, B, table)]
    g = torch.autograd.grad(step(*leaves[:3], x0, leaves[3], DT, theta, it), leaves, gbar)
    return tuple(g[:3]) + (g[3][:, 2], g[3][:, 3])


def check_si_gradients(H, B, derived, gbar):
    """si_step's gradient on the card (the Function: kernel forward,
    transpose-solve mode, pullback kernel) against its plain backward on
    the same card: float64 at 4 x 128^2, PCG-6 and 20, theta = 1 (H_D a
    separate copy of H) and theta = 1/2 with H_D != H, to TOL_GRAD_F64 on
    dH, dH_D, dB and the creep and slide columns, with a bitwise repeat of
    the backward; the same on the large-plane path at 2 x 300^2 and at the
    SI training's 16 x 128^2, PCG-20, theta = 1 (8-block clusters, the 16th
    in a second wave); float32
    (PCG-20, theta = 1/2) within GRAD_F32_FACTOR times the float32 plain
    backward's own error against float64."""
    from odinn_tpu_torch.core.params import PhysicalParameters
    from odinn_tpu_torch.ops.cuda import si_kernel
    from odinn_tpu_torch.ops.cuda.common import derived_scalars

    PHYS = PhysicalParameters()
    names = ("dH", "dH_D", "dB", "d_table_col2", "d_table_col3")
    Hl, Bl, rawl = kernel_inputs(2, 300, 300, torch.float64, seed=14)
    derived_l = derived_scalars(*(rawl[:, k] for k in range(7)), PHYS.rho, PHYS.g)
    gbar_l = torch.randn(Hl.shape, generator=torch.Generator().manual_seed(15),
                         dtype=torch.float64).to("cuda")
    cases = [((N_G, NX, NY), H, B, derived, gbar, it, theta)
             for it in (6, SI_TRAIN_CG) for theta in (1.0, 0.5)]
    cases.append(((2, 300, 300), Hl, Bl, derived_l, gbar_l, 6, 0.5))
    check_second_wave(torch.float64)
    Ht, Bt, rawt = kernel_inputs(N_TRAIN, NX, NY, torch.float64, seed=17)
    derived_t = derived_scalars(*(rawt[:, k] for k in range(7)), PHYS.rho, PHYS.g)
    gbar_t = torch.randn(Ht.shape, generator=torch.Generator().manual_seed(18),
                         dtype=torch.float64).to("cuda")
    cases.append(((N_TRAIN, NX, NY), Ht, Bt, derived_t, gbar_t, SI_TRAIN_CG, 1.0))
    for shape, Hc, Bc, table, gb, it, theta in cases:
        H_D, x0 = (Hc.clone(), Hc) if theta == 1.0 else (0.97 * Hc, 0.99 * Hc)
        gk = si_grads(Hc, H_D, Bc, x0, table, gb, theta, it, True)
        again = si_grads(Hc, H_D, Bc, x0, table, gb, theta, it, True)
        gp = si_grads(Hc, H_D, Bc, x0, table, gb, theta, it, False)
        torch.cuda.synchronize()
        row = {"phase": "check_grad", "function": f"si_step cg_iters={it} theta={theta}",
               "shape": list(shape), "path": si_kernel.si_plan(*shape, torch.float64).path,
               "dtype": "torch.float64",
               "rel_err": {k: rel_err(a, b) for k, a, b in zip(names, gk, gp)},
               "tol": TOL_GRAD_F64,
               "bitwise_repeat": all(torch.equal(a, b) for a, b in zip(gk, again))}
        emit(row)
        if not (all(e <= TOL_GRAD_F64 for e in row["rel_err"].values())
                and row["bitwise_repeat"] and all(torch.isfinite(t).all() for t in gk)):
            raise AssertionError(f"si_step: gradient disagrees with its plain backward or "
                                 f"with itself: {row}")
    # the training dtype: float32 kernels against the float64 plain gradient
    H_D, x0 = 0.97 * H, 0.99 * H
    args = (H, H_D, B, x0, derived, gbar, 0.5, SI_TRAIN_CG)
    as32 = tuple(t.float() for t in args[:4]) + (derived, gbar.float()) + args[6:]
    gk = si_grads(*as32, True)
    again = si_grads(*as32, True)
    gp32 = si_grads(*as32, False)
    gp = si_grads(*args, False)
    torch.cuda.synchronize()
    row = {"phase": "check_grad", "function": f"si_step cg_iters={SI_TRAIN_CG} theta=0.5",
           "dtype": "torch.float32 vs float64 plain",
           "rel_err": {k: rel_err(a, b) for k, a, b in zip(names, gk, gp)},
           "f32_plain_rel_err": {k: rel_err(a, b) for k, a, b in zip(names, gp32, gp)},
           "factor": GRAD_F32_FACTOR,
           "bitwise_repeat": all(torch.equal(a, b) for a, b in zip(gk, again))}
    emit(row)
    if not (row["bitwise_repeat"] and all(
            row["rel_err"][k] <= GRAD_F32_FACTOR * row["f32_plain_rel_err"][k] for k in names)):
        raise AssertionError(f"si_step float32 gradient disagrees: {row}")


TOL_DUALITY = 1e-10


def _jvp(fn, primals, tangents):
    """(output, its tangent) of ``fn`` by forward mode
    (``torch.autograd.forward_ad``)."""
    import torch.autograd.forward_ad as fwAD

    with fwAD.dual_level():
        out = fn(*(fwAD.make_dual(p, t) for p, t in zip(primals, tangents)))
        primal, tangent = fwAD.unpack_dual(out)
    return primal, tangent


def _tangent_functions():
    """(name, shape, function of (H, H_D, B, table), the table's kind,
    the differentiated table columns) of the three autograd Functions'
    tangent checks: si_step at 4 x 128^2 (PCG-6 and 20, theta = 1 with
    H_D = H and 1/2 with H_D != H), on its large-plane path (2 x 300^2,
    PCG-6) and at the SI training's 16 x 128^2 (PCG-20, second wave);
    sia2d_rhs at 4 x 128^2; rkc_interval at 4 x 128^2, s = 8."""
    from odinn_tpu_torch.core.params import PhysicalParameters
    from odinn_tpu_torch.ops.cuda import rkc_kernel, si_kernel, sia_kernel

    PHYS = PhysicalParameters()
    out = []
    for shape, it, theta in (((N_G, NX, NY), 6, 1.0), ((N_G, NX, NY), SI_TRAIN_CG, 1.0),
                             ((N_G, NX, NY), 6, 0.5), ((N_G, NX, NY), SI_TRAIN_CG, 0.5),
                             ((2, 300, 300), 6, 0.5), ((N_TRAIN, NX, NY), SI_TRAIN_CG, 1.0)):
        def si(h, hd, b, t, it=it, theta=theta):
            return si_kernel.si_step(h, hd if theta != 1.0 else h, b, 0.99 * h.detach(), t, DT,
                                     theta, it)
        out.append((f"si_step cg_iters={it} theta={theta}", shape, si, "derived", (2, 3)))
    out.append(("sia2d_rhs", (N_G, NX, NY),
                lambda h, hd, b, t: sia_kernel.sia2d_rhs(h, b, t, PHYS.rho, PHYS.g, PHYS.eta0),
                "raw", (2,)))
    dt = DT * (8 / RKC_STAGES) ** 2
    out.append(("rkc_interval s=8", (N_G, NX, NY),
                lambda h, hd, b, t: rkc_kernel.rkc_interval(h, b, t, dt, 8, PHYS.eta0),
                "derived", (2,)))
    return out


def check_tangents():
    """The three autograd Functions' tangents on the card (kernel forward,
    the tangent kernels: si_step's tangent-solve mode with ṙ formed by
    PyTorch ops, sia2d_rhs_jvp, rkc_interval's kept stages and
    sia2d_rhs_jvp's stage mode) in float64 against the same forward-mode
    derivative on the CPU (the plain versions), to TOL_GRAD_F64, with a
    bitwise repeat; the tangents of H, H_D (si_step, theta = 1/2), B
    (si_step) and the differentiated table columns. Then the duality
    <u, J v> = <J^T u, v> between each Function's tangent and its backward
    on the card, to TOL_DUALITY: sia2d_rhs and rkc_interval at 4 x 128^2,
    si_step at PCG-40 from a zero guess, where the tangent solve and the
    transpose solve have converged (at fewer iterations they are two
    contracts; from the primal guess the tangent solve starts a residual of
    the primal's size, hundreds of times the tangent's, which 40
    iterations do not remove to 1e-10)."""
    from odinn_tpu_torch.core.params import PhysicalParameters
    from odinn_tpu_torch.ops.cuda import si_kernel
    from odinn_tpu_torch.ops.cuda.common import derived_scalars

    PHYS = PhysicalParameters()

    def inputs(shape, kind, seed):
        H, B, raw = kernel_inputs(*shape, torch.float64, seed=seed)
        table = raw if kind == "raw" else derived_scalars(*(raw[:, k] for k in range(7)),
                                                          PHYS.rho, PHYS.g)
        gen = torch.Generator().manual_seed(seed + 1)
        planes = [torch.randn(shape, generator=gen, dtype=torch.float64).to("cuda")
                  for _ in range(4)]
        return (H, 0.97 * H, B, table), planes

    def tangents(shape, table, cols, planes):
        dt = torch.zeros_like(table)
        for c in cols:
            dt[:, c] = 0.1 * table[:, c] * planes[3].flatten()[:shape[0]]
        return (planes[0], planes[1], planes[2], dt)

    for name, shape, fn, kind, cols in _tangent_functions():
        primals, planes = inputs(shape, kind, seed=sum(shape) + len(name))
        tans = tangents(shape, primals[3], cols, planes)
        # the RHS and the RKC step differentiate no bed: its tangent is zero
        if not name.startswith("si_step"):
            tans = tans[:2] + (torch.zeros_like(tans[2]),) + tans[3:]
        _, got = _jvp(fn, primals, tans)
        _, again = _jvp(fn, primals, tans)
        _, want = _jvp(fn, tuple(p.cpu() for p in primals), tuple(t.cpu() for t in tans))
        torch.cuda.synchronize()
        row = {"phase": "check_tangent", "function": name, "shape": list(shape),
               "dtype": "torch.float64", "rel_err_vs_cpu": rel_err(got.cpu(), want),
               "tol": TOL_GRAD_F64, "bitwise_repeat": bool(torch.equal(got, again))}
        if name.startswith("si_step"):
            row["path"] = si_kernel.si_plan(*shape, torch.float64).path
        emit(row)
        if not (row["rel_err_vs_cpu"] <= TOL_GRAD_F64 and row["bitwise_repeat"]
                and torch.isfinite(got).all()):
            raise AssertionError(f"{name}: the card's tangent disagrees with the CPU's or "
                                 f"with itself: {row}")
    for name, shape, fn, kind, cols in _tangent_functions():
        if name.startswith("si_step") and not (shape == (N_G, NX, NY) and "cg_iters=6" in name):
            continue
        if name.startswith("si_step"):
            theta = 1.0 if "theta=1.0" in name else 0.5
            fn = (lambda h, hd, b, t, theta=theta: si_kernel.si_step(
                h, hd if theta != 1.0 else h, b, torch.zeros_like(h.detach()), t, DT, theta,
                40))
            name = name.replace("cg_iters=6", "cg_iters=40")
        primals, planes = inputs(shape, kind, seed=sum(shape) + 7 * len(name))
        tans = tangents(shape, primals[3], cols, planes)
        if not name.startswith("si_step"):
            tans = tans[:2] + (torch.zeros_like(tans[2]),) + tans[3:]
        u = torch.randn(shape, generator=torch.Generator().manual_seed(3),
                        dtype=torch.float64).to("cuda")
        _, jv = _jvp(fn, primals, tans)
        leaves = [p.clone().requires_grad_(True) for p in primals]
        cot = torch.autograd.grad(fn(*leaves), leaves, u, allow_unused=True)
        lhs = float(torch.sum(u * jv))
        rhs = sum(float(torch.sum(c * t)) for c, t in zip(cot, tans) if c is not None)
        row = {"phase": "check_duality", "function": name, "shape": list(shape),
               "dtype": "torch.float64", "u_Jv": lhs, "JTu_v": rhs,
               "rel_err": abs(lhs - rhs) / abs(lhs), "tol": TOL_DUALITY}
        emit(row)
        if not row["rel_err"] <= TOL_DUALITY:
            raise AssertionError(f"{name}: tangent and backward are not each other's "
                                 f"transpose: {row}")


def time_kernels():
    """Kernel and plain-version times at the main path's shapes (float32):
    4 x 128^2 for si_step, sia2d_rhs and rkc_interval (s = 25, the RKC
    row), 16 x 128^2 for sia2d_rhs_vjp and si_step_vjp (the training
    phases); besides, under ``more``, rkc_interval at 16 x 128^2, s = 8
    (the RKC training's launches), the pullback's fused RKC-backward stage
    at 16 x 128^2, si_step and its transpose-solve mode at 4 x 128^2 and at
    the SI training's 16 x 128^2, PCG-20, and at 15 glaciers, which 8-block
    clusters hold resident at once (16 run a second wave), and si_step_vjp
    at 4 x 128^2; si_step, its transpose and si_step_vjp at phase 13's
    per-rank 8 x 128^2, PCG-20; and phase 11's folded batches: si_step, its transpose and
    si_step_vjp at 128 x 128^2 (PCG-20), si_step at 512 x 64^2 (PCG-12),
    sia2d_rhs at 32 x 32^2, and the tangent-solve mode and sia2d_rhs_vjp at
    128 x 128^2 (the folded forward mode and continuous adjoint); phase
    14's: si_rows_apply and si_rows_update (rows of their own; and, under
    ``more``, at half a 1024^2 plane, 4 x 516 x 1024 with 512 own rows),
    si_assemble alone and si_step_vjp at a rank's 16 x 66 x 128 slab, sia2d_rhs at 2 x
    65 x 128 and rkc_interval (s = 25) at 2 x 89 x 128; in float64,
    sia2d_rhs_jvp at the LM gates' 2 x 36^2; and phase 15's large planes:
    the large-plane path ``si_plane`` at 1 x 1024^2, PCG-12 (under ``more``
    PCG-6, the transpose, 1 x 2048^2 and si_assemble alone), and the
    large-plane pullback ``si_plane_vjp`` at 1 x 1024^2 (under ``more`` at
    the other PLANE_VJP_SHAPES), H_D = H as in the SI trainings."""
    from odinn_tpu_torch.ops.cuda import rkc_kernel, si_kernel, sia_kernel
    from odinn_tpu_torch.ops.cuda.common import derived_scalars
    from odinn_tpu_torch.core.params import PhysicalParameters

    PHYS = PhysicalParameters()
    f32 = torch.float32
    H, B, raw = kernel_inputs(N_G, NX, NY, f32, seed=7)
    derived = derived_scalars(*(raw[:, k] for k in range(7)), PHYS.rho, PHYS.g)
    Ht, Bt, rawt = kernel_inputs(N_TRAIN, NX, NY, f32, seed=8)
    derived_t = derived_scalars(*(rawt[:, k] for k in range(7)), PHYS.rho, PHYS.g)
    lam = torch.randn(Ht.shape, generator=torch.Generator().manual_seed(9)).to("cuda")
    exps = (5.0, 2.0, 4.0, 2.0)
    s_t = 8
    dt_t = DT * (s_t / RKC_STAGES) ** 2
    weights = rkc_kernel._stage_weights(s_t, f32, dt_t)[1][5]
    gen = torch.Generator().manual_seed(10)
    carry = tuple(torch.randn(Ht.shape, generator=gen).to("cuda") for _ in range(3)) + (
        torch.zeros(N_TRAIN, device="cuda"),)
    table_t = derived_t.to(f32)
    # name -> (kernel of the kernels line, call, kernel, plain version,
    # bound, device kernel names, plain-version repetitions)
    # (names of their own: the entries' calls read them when the loop runs)
    Hp, Bp, rawp = kernel_inputs(2, 300, 300, f32, seed=13)
    derived_p = derived_scalars(*(rawp[:, k] for k in range(7)), PHYS.rho, PHYS.g)
    # the SI backward's inputs: the forward's pre-relu x and the transpose
    # solve's lambda (plain versions), at 4 and 16 glaciers, theta = 1
    gbar = torch.randn(H.shape, generator=torch.Generator().manual_seed(16)).to("cuda")
    x4 = si_kernel._si_solve_reference(H, H, B, H, derived, DT, 1.0, 6, exps)
    lam4 = si_kernel.si_step_transpose_reference(gbar, x4, H, B, derived, DT, 1.0, 6, exps)
    it_t = SI_TRAIN_CG
    xt = si_kernel._si_solve_reference(Ht, Ht, Bt, Ht, derived_t, DT, 1.0, it_t, exps)
    lamt = si_kernel.si_step_transpose_reference(lam, xt, Ht, Bt, derived_t, DT, 1.0, it_t,
                                                 exps)
    xt_plain = si_kernel._si_solve_reference(Ht, Ht, Bt, Ht, derived_t, DT, 1.0, it_t, exps,
                                             precondition=False)
    # the tangents' inputs: a residual tangent, and the d(creep) of the
    # sia2d_rhs_jvp calls (a tenth of each glacier's creep)
    rdot4 = torch.randn(H.shape, generator=torch.Generator().manual_seed(19)).to("cuda")
    rdott = torch.randn(Ht.shape, generator=torch.Generator().manual_seed(20)).to("cuda")
    d_creep4, d_creept = 0.1 * derived[:, 2].to(f32), 0.1 * table_t[:, 2]
    jgen = torch.Generator().manual_seed(21)
    dY, dH0, dY2, df0 = (torch.randn(Ht.shape, generator=jgen).to("cuda") for _ in range(4))
    n15 = N_TRAIN - 1
    H15, B15, x15, lam15 = (t[:n15].contiguous() for t in (Ht, Bt, xt, lam))
    # phase 13's per-rank share: the first 8 glaciers, one wave of clusters
    n8 = N_TRAIN // SCALE_OUT_RANKS
    H8, B8, x8, lam8, lamt8 = (t[:n8].contiguous() for t in (Ht, Bt, xt, lam, lamt))
    derived_8 = derived_t[:n8].contiguous()
    # phase 11's folded batches: si_step, its transpose and the pullback at
    # multistart's 128 x 128^2, PCG-20; si_step at EKI's 512 x 64^2, PCG-12;
    # sia2d_rhs at the adaptive EKI's 32 x 32^2
    (n_m, _, _, it_m), (n_e, nx_e, _, it_e) = FOLDED_SI
    Hm, Bm, rawm = kernel_inputs(n_m, NX, NY, f32, seed=22)
    derived_m = derived_scalars(*(rawm[:, k] for k in range(7)), PHYS.rho, PHYS.g)
    gm = torch.randn(Hm.shape, generator=torch.Generator().manual_seed(23)).to("cuda")
    xm = si_kernel._si_solve_reference(Hm, Hm, Bm, Hm, derived_m, DT, 1.0, it_m, exps)
    lamm = si_kernel.si_step_transpose_reference(gm, xm, Hm, Bm, derived_m, DT, 1.0, it_m, exps)
    He, Be, rawe = kernel_inputs(n_e, nx_e, nx_e, f32, seed=24)
    derived_e = derived_scalars(*(rawe[:, k] for k in range(7)), PHYS.rho, PHYS.g)
    n_s = EKI_A_MEMBERS * EKI_A_GLACIERS
    Hs, Bs, raws = kernel_inputs(n_s, EKI_A_NX, EKI_A_NX, f32, seed=25)
    # the folded multi-start's forward mode (the tangent-solve mode at 128 x
    # 128^2, PCG-20) and continuous adjoint (the RHS pullback at 128 x
    # 128^2); the LM gates' RHS tangent, float64 at 2 x 36^2
    rdotm = torch.randn(Hm.shape, generator=torch.Generator().manual_seed(26)).to("cuda")
    f64 = torch.float64
    Hj, Bj, rawj = kernel_inputs(*LM_GATE_SHAPE, f64, seed=27)
    table_j = derived_scalars(*(rawj[:, k] for k in range(7)), PHYS.rho, PHYS.g).to(f64)
    dYj = torch.randn(Hj.shape, generator=torch.Generator().manual_seed(28),
                      dtype=f64).to("cuda")
    derived_15 = derived_t[:n15].contiguous()
    entries = {
        "si_step": ("si_step", lambda f: lambda: f(H, H, B, H, derived, DT, 1.0, 6, exps),
                    si_kernel.si_step, si_kernel.si_step_reference,
                    si_bound(N_G, NX, NY, 4, 6), SI_KERNELS, 50),
        f"si_step {N_G}x{NX}x{NY} cg_iters=30": (
            "si_step", lambda f: lambda: f(H, H, B, H, derived, DT, 1.0, 30, exps),
            si_kernel.si_step, si_kernel.si_step_reference,
            si_bound(N_G, NX, NY, 4, 30), SI_KERNELS, 10),
        # the large-plane path (si_assemble + si_pcg) at the main shape, which
        # the plan gives the cluster kernel: the design the cluster kernel
        # replaced there
        f"si_step large-plane path {N_G}x{NX}x{NY}": (
            "si_plane", lambda f: lambda: f(H, H, B, H, derived, DT, 1.0, 6, exps),
            lambda *a: si_kernel._launch(*a, None), si_kernel.si_step_reference,
            si_bound(N_G, NX, NY, 4, 6), SI_KERNELS, 50),
        "si_step large-plane 2x300x300": (
            "si_plane", lambda f: lambda: f(Hp, Hp, Bp, Hp, derived_p, DT, 1.0, 6, exps),
            si_kernel.si_step, si_kernel.si_step_reference,
            si_bound(2, 300, 300, 4, 6), SI_KERNELS, 10),
        f"si_step transpose {N_G}x{NX}x{NY} cg_iters=6": (
            "si_step", lambda f: lambda: f(gbar, x4, H, B, derived, DT, 1.0, 6, exps),
            si_kernel.si_step_transpose, si_kernel.si_step_transpose_reference,
            si_transpose_bound(N_G, NX, NY, 4, 6), SI_KERNELS, 50),
        f"si_step {N_TRAIN}x{NX}x{NY} cg_iters={it_t}": (
            "si_step", lambda f: lambda: f(Ht, Ht, Bt, Ht, derived_t, DT, 1.0, it_t, exps),
            si_kernel.si_step, si_kernel.si_step_reference,
            si_bound(N_TRAIN, NX, NY, 4, it_t), SI_KERNELS, 10),
        f"si_step transpose {N_TRAIN}x{NX}x{NY} cg_iters={it_t}": (
            "si_step", lambda f: lambda: f(lam, xt, Ht, Bt, derived_t, DT, 1.0, it_t, exps),
            si_kernel.si_step_transpose, si_kernel.si_step_transpose_reference,
            si_transpose_bound(N_TRAIN, NX, NY, 4, it_t), SI_KERNELS, 10),
        # without the preconditioner: the discrete adjoint's SI transposes
        f"si_step no-precondition {N_TRAIN}x{NX}x{NY} cg_iters={it_t}": (
            "si_step", lambda f: lambda: f(Ht, Ht, Bt, Ht, derived_t, DT, 1.0, it_t, exps,
                                           precondition=False),
            si_kernel.si_step, si_kernel.si_step_reference,
            si_bound(N_TRAIN, NX, NY, 4, it_t, precondition=False), SI_KERNELS, 10),
        f"si_step transpose no-precondition {N_TRAIN}x{NX}x{NY} cg_iters={it_t}": (
            "si_step", lambda f: lambda: f(lam, xt_plain, Ht, Bt, derived_t, DT, 1.0, it_t, exps,
                                           precondition=False),
            si_kernel.si_step_transpose, si_kernel.si_step_transpose_reference,
            si_transpose_bound(N_TRAIN, NX, NY, 4, it_t, precondition=False), SI_KERNELS, 10),
        f"si_step {n15}x{NX}x{NY} cg_iters={it_t}": (
            "si_step", lambda f: lambda: f(H15, H15, B15, H15, derived_15, DT, 1.0, it_t, exps),
            si_kernel.si_step, si_kernel.si_step_reference,
            si_bound(n15, NX, NY, 4, it_t), SI_KERNELS, 10),
        f"si_step transpose {n15}x{NX}x{NY} cg_iters={it_t}": (
            "si_step", lambda f: lambda: f(lam15, x15, H15, B15, derived_15, DT, 1.0, it_t, exps),
            si_kernel.si_step_transpose, si_kernel.si_step_transpose_reference,
            si_transpose_bound(n15, NX, NY, 4, it_t), SI_KERNELS, 10),
        f"si_step {n8}x{NX}x{NY} cg_iters={it_t}": (
            "si_step", lambda f: lambda: f(H8, H8, B8, H8, derived_8, DT, 1.0, it_t, exps),
            si_kernel.si_step, si_kernel.si_step_reference,
            si_bound(n8, NX, NY, 4, it_t), SI_KERNELS, 10),
        f"si_step transpose {n8}x{NX}x{NY} cg_iters={it_t}": (
            "si_step", lambda f: lambda: f(lam8, x8, H8, B8, derived_8, DT, 1.0, it_t, exps),
            si_kernel.si_step_transpose, si_kernel.si_step_transpose_reference,
            si_transpose_bound(n8, NX, NY, 4, it_t), SI_KERNELS, 10),
        f"si_step_vjp {n8}x{NX}x{NY}": (
            "si_step_vjp", lambda f: lambda: f(lamt8, H8, H8, B8, x8, derived_8, DT, 1.0, exps),
            si_kernel.si_step_vjp, si_kernel.si_step_vjp_reference,
            si_vjp_bound(n8, NX, NY, 4, planes_in=4), ("si_step_vjp_kernel",), 50),
        f"si_step tangent {N_G}x{NX}x{NY} cg_iters=6": (
            "si_step", lambda f: lambda: f(rdot4, x4, H, H, B, derived, DT, 1.0, 6, exps),
            si_kernel.si_step_tangent, si_kernel.si_step_tangent_reference,
            si_tangent_bound(N_G, NX, NY, 4, 6), SI_KERNELS, 50),
        f"si_step tangent {N_TRAIN}x{NX}x{NY} cg_iters={it_t}": (
            "si_step", lambda f: lambda: f(rdott, xt, Ht, Ht, Bt, derived_t, DT, 1.0, it_t, exps),
            si_kernel.si_step_tangent, si_kernel.si_step_tangent_reference,
            si_tangent_bound(N_TRAIN, NX, NY, 4, it_t), SI_KERNELS, 10),
        "sia2d_rhs_jvp": ("sia2d_rhs_jvp",
                          lambda f: lambda: f(dY, Ht, Bt, table_t, d_creept, PHYS.eta0),
                          sia_kernel.sia2d_rhs_jvp, sia_kernel.sia2d_rhs_jvp_reference,
                          jvp_bound(N_TRAIN, NX, NY, 4), ("sia2d_rhs_jvp_kernel",), 50),
        f"sia2d_rhs_jvp {N_G}x{NX}x{NY}": (
            "sia2d_rhs_jvp", lambda f: lambda: f(rdot4, H, B, derived.to(f32), d_creep4,
                                                 PHYS.eta0),
            sia_kernel.sia2d_rhs_jvp, sia_kernel.sia2d_rhs_jvp_reference,
            jvp_bound(N_G, NX, NY, 4), ("sia2d_rhs_jvp_kernel",), 50),
        f"sia2d_rhs_jvp rkc stage {N_TRAIN}x{NX}x{NY}": (
            "sia2d_rhs_jvp",
            lambda f: lambda: f(dY, Ht, Bt, table_t, d_creept, PHYS.eta0,
                                stage=(dH0, dY2, df0, weights), keep_f=False),
            sia_kernel.sia2d_rhs_jvp, sia_kernel.sia2d_rhs_jvp_reference,
            jvp_bound(N_TRAIN, NX, NY, 4, stage=True), ("sia2d_rhs_jvp_kernel",), 50),
        "si_step_vjp": ("si_step_vjp",
                        lambda f: lambda: f(lamt, Ht, Ht, Bt, xt, derived_t, DT, 1.0, exps),
                        si_kernel.si_step_vjp, si_kernel.si_step_vjp_reference,
                        si_vjp_bound(N_TRAIN, NX, NY, 4, planes_in=4), ("si_step_vjp_kernel",),
                        50),
        f"si_step_vjp {N_G}x{NX}x{NY}": (
            "si_step_vjp", lambda f: lambda: f(lam4, H, H, B, x4, derived, DT, 1.0, exps),
            si_kernel.si_step_vjp, si_kernel.si_step_vjp_reference,
            si_vjp_bound(N_G, NX, NY, 4, planes_in=4), ("si_step_vjp_kernel",), 50),
        "sia2d_rhs": ("sia2d_rhs", lambda f: lambda: f(H, B, raw, PHYS.rho, PHYS.g, PHYS.eta0),
                      sia_kernel.sia2d_rhs, sia_kernel.sia2d_rhs_reference,
                      sia_bound(N_G, NX, NY, 4), ("sia2d_rhs_kernel",), 50),
        "rkc_interval": ("rkc_interval",
                         lambda f: lambda: f(H, B, derived, DT, RKC_STAGES, PHYS.eta0, exps),
                         rkc_kernel.rkc_interval, rkc_kernel.rkc_interval_reference,
                         rkc_bound(N_G, NX, NY, 4, RKC_STAGES), ("rkc_interval_kernel",), 5),
        "sia2d_rhs_vjp": ("sia2d_rhs_vjp",
                          lambda f: lambda: f(lam, Ht, Bt, derived_t, PHYS.eta0),
                          sia_kernel.sia2d_rhs_vjp, sia_kernel.sia2d_rhs_vjp_reference,
                          vjp_bound(N_TRAIN, NX, NY, 4), ("sia2d_rhs_vjp_kernel",), 50),
        f"rkc_interval {N_TRAIN}x{NX}x{NY} s={s_t}": (
            "rkc_interval", lambda f: lambda: f(Ht, Bt, derived_t, dt_t, s_t, PHYS.eta0, exps),
            rkc_kernel.rkc_interval, rkc_kernel.rkc_interval_reference,
            rkc_bound(N_TRAIN, NX, NY, 4, s_t), ("rkc_interval_kernel",), 5),
        f"sia2d_rhs_vjp rkc stage {N_TRAIN}x{NX}x{NY}": (
            "sia2d_rhs_vjp",
            lambda f: lambda: f(lam, carry, Ht, Bt, table_t, PHYS.eta0, weights),
            rkc_kernel.stage_pullback, rkc_kernel.stage_pullback_reference,
            stage_bound(N_TRAIN, NX, NY, 4), ("sia2d_rhs_vjp_kernel",), 50),
        f"si_step {n_m}x{NX}x{NY} cg_iters={it_m}": (
            "si_step", lambda f: lambda: f(Hm, Hm, Bm, Hm, derived_m, DT, 1.0, it_m, exps),
            si_kernel.si_step, si_kernel.si_step_reference,
            si_bound(n_m, NX, NY, 4, it_m), SI_KERNELS, 3),
        f"si_step transpose {n_m}x{NX}x{NY} cg_iters={it_m}": (
            "si_step", lambda f: lambda: f(gm, xm, Hm, Bm, derived_m, DT, 1.0, it_m, exps),
            si_kernel.si_step_transpose, si_kernel.si_step_transpose_reference,
            si_transpose_bound(n_m, NX, NY, 4, it_m), SI_KERNELS, 3),
        f"si_step_vjp {n_m}x{NX}x{NY}": (
            "si_step_vjp", lambda f: lambda: f(lamm, Hm, Hm, Bm, xm, derived_m, DT, 1.0, exps),
            si_kernel.si_step_vjp, si_kernel.si_step_vjp_reference,
            si_vjp_bound(n_m, NX, NY, 4, planes_in=4), ("si_step_vjp_kernel",), 5),
        f"si_step {n_e}x{nx_e}x{nx_e} cg_iters={it_e}": (
            "si_step", lambda f: lambda: f(He, He, Be, He, derived_e, DT, 1.0, it_e, exps),
            si_kernel.si_step, si_kernel.si_step_reference,
            si_bound(n_e, nx_e, nx_e, 4, it_e), SI_KERNELS, 3),
        f"sia2d_rhs {n_s}x{EKI_A_NX}x{EKI_A_NX}": (
            "sia2d_rhs", lambda f: lambda: f(Hs, Bs, raws, PHYS.rho, PHYS.g, PHYS.eta0),
            sia_kernel.sia2d_rhs, sia_kernel.sia2d_rhs_reference,
            sia_bound(n_s, EKI_A_NX, EKI_A_NX, 4), ("sia2d_rhs_kernel",), 50),
        f"si_step tangent {n_m}x{NX}x{NY} cg_iters={it_m}": (
            "si_step", lambda f: lambda: f(rdotm, xm, Hm, Hm, Bm, derived_m, DT, 1.0, it_m, exps),
            si_kernel.si_step_tangent, si_kernel.si_step_tangent_reference,
            si_tangent_bound(n_m, NX, NY, 4, it_m), SI_KERNELS, 3),
        f"sia2d_rhs_vjp {n_m}x{NX}x{NY}": (
            "sia2d_rhs_vjp", lambda f: lambda: f(gm, Hm, Bm, derived_m, PHYS.eta0),
            sia_kernel.sia2d_rhs_vjp, sia_kernel.sia2d_rhs_vjp_reference,
            vjp_bound(n_m, NX, NY, 4), ("sia2d_rhs_vjp_kernel",), 10),
        "sia2d_rhs_jvp {}x{}x{} float64".format(*LM_GATE_SHAPE): (
            "sia2d_rhs_jvp", lambda f: lambda: f(dYj, Hj, Bj, table_j, 0.1 * table_j[:, 2],
                                                 PHYS.eta0),
            sia_kernel.sia2d_rhs_jvp, sia_kernel.sia2d_rhs_jvp_reference,
            jvp_bound(*LM_GATE_SHAPE, 8) + (f64,), ("sia2d_rhs_jvp_kernel",), 50),
    }
    # phase 14's kernels at a rank's slab (SPATIAL_SLAB; the top rank's 64
    # own rows), each on its own scratch prepared alike: si_rows_apply (an
    # iteration) and si_rows_update, si_assemble alone, the pullback, the RK4
    # row's RHS at the (2 x 2) cut's 2 x (64 + 1) x 128 and its RKC-25 step
    # at 2 x (64 + 25) x 128
    from odinn_tpu_torch.ops import si_math

    n_r, nx_r, _ = SPATIAL_SLAB
    own_r = NX // 2
    Hr, Br, rawr = kernel_inputs(*SPATIAL_SLAB, f32, seed=64)
    derived_r = derived_scalars(*(rawr[:, k] for k in range(7)), PHYS.rho, PHYS.g)
    table_r = derived_r[:, :4].to(f32).contiguous()
    base = torch.zeros((si_math.ROWS_PLANES,) + SPATIAL_SLAB, dtype=f32, device="cuda")
    si_kernel.si_assemble_reference(base, Hr, Hr, Br, Hr, derived_r, DT, 1.0, 0, True, exps)
    si_kernel.si_rows_apply_reference(base, (1.01 * Hr).contiguous(), None, si_math.ROWS_P2,
                                      si_math.ROWS_P, 0, own_r, table_r, DT, True)
    rgen = torch.Generator().manual_seed(65)
    beta_r = (0.3 * torch.rand(n_r, generator=rgen, dtype=torch.float64)).to("cuda", f32)
    alpha_r = (0.2 * torch.rand(n_r, generator=rgen, dtype=torch.float64)).to("cuda", f32)
    rows_work = {si_kernel.si_rows_apply: base.clone(),
                 si_kernel.si_rows_apply_reference: base.clone(),
                 si_kernel.si_rows_update: base.clone(),
                 si_kernel.si_rows_update_reference: base.clone(),
                 si_kernel.si_assemble: base.clone(),
                 si_kernel.si_assemble_reference: base.clone()}
    lam_r = torch.randn(SPATIAL_SLAB, generator=rgen).to("cuda")
    # and at half a 1024^2 plane with ghosts on both sides (ROWS_LARGE_SLAB)
    n_l, nx_l, ny_l = ROWS_LARGE_SLAB
    r0_l, r1_l = ROWS_LARGE_OWN
    Hl, Bl, rawl = kernel_inputs(*ROWS_LARGE_SLAB, f32, seed=67)
    derived_l = derived_scalars(*(rawl[:, k] for k in range(7)), PHYS.rho, PHYS.g)
    table_l = derived_l[:, :4].to(f32).contiguous()
    base_l = torch.zeros((si_math.ROWS_PLANES,) + ROWS_LARGE_SLAB, dtype=f32, device="cuda")
    si_kernel.si_assemble_reference(base_l, Hl, Hl, Bl, Hl, derived_l, DT, 1.0, 0, True, exps)
    si_kernel.si_rows_apply_reference(base_l, (1.01 * Hl).contiguous(), None, si_math.ROWS_P2,
                                      si_math.ROWS_P, r0_l, r1_l, table_l, DT, True)
    beta_l = (0.3 * torch.rand(n_l, generator=rgen, dtype=torch.float64)).to("cuda", f32)
    alpha_l = (0.2 * torch.rand(n_l, generator=rgen, dtype=torch.float64)).to("cuda", f32)
    large_work = {f: base_l.clone() for f in (
        si_kernel.si_rows_apply, si_kernel.si_rows_apply_reference, si_kernel.si_rows_update,
        si_kernel.si_rows_update_reference)}
    large_tag = "x".join(map(str, ROWS_LARGE_SLAB))
    x_r = si_kernel._si_solve_reference(Hr, Hr, Br, Hr, derived_r, DT, 1.0, it_t, exps)
    H2, B2, raw2 = (t[:2].contiguous() for t in kernel_inputs(2, NX // 2 + 25, NY, f32,
                                                                 seed=66))
    derived2 = derived_scalars(*(raw2[:, k] for k in range(7)), PHYS.rho, PHYS.g)
    H65, B65 = H2[:, :NX // 2 + 1].contiguous(), B2[:, :NX // 2 + 1].contiguous()
    slab_tag = "x".join(map(str, SPATIAL_SLAB))
    # phase 15's planes: 1 x 1024^2 (PCG-6 and 12, the transpose at 12, the
    # assembly alone) and 1 x 2048^2 (PCG-12)
    n_i, n_b = ICE_SIZES[0][0], ICE_SIZES[1][0]
    ice_tag, big_tag = f"1x{n_i}x{n_i}", f"1x{n_b}x{n_b}"
    Hi, Bi, rawi = kernel_inputs(1, n_i, n_i, f32, seed=71)
    derived_i = derived_scalars(*(rawi[:, k] for k in range(7)), PHYS.rho, PHYS.g)
    gi = torch.randn(Hi.shape, generator=torch.Generator().manual_seed(72)).to("cuda")
    xi = si_kernel._si_solve_reference(Hi, Hi, Bi, Hi, derived_i, DT, 1.0, 12, exps)
    ice_work = {f: torch.zeros((si_math.ROWS_PLANES, 1, n_i, n_i), dtype=f32, device="cuda")
                for f in (si_kernel.si_assemble, si_kernel.si_assemble_reference)}
    Hb, Bb, rawb = kernel_inputs(1, n_b, n_b, f32, seed=73)
    derived_b = derived_scalars(*(rawb[:, k] for k in range(7)), PHYS.rho, PHYS.g)
    # the large-plane pullback at its other shapes: lambda, H, B, x and the table
    pullback = {}
    for shape in PLANE_VJP_SHAPES:
        if shape == (1, n_i, n_i):
            continue
        Hv, Bv, rawv = kernel_inputs(*shape, f32, seed=75 + shape[1])
        derived_v = derived_scalars(*(rawv[:, k] for k in range(7)), PHYS.rho, PHYS.g)
        lam_v = torch.randn(shape, generator=torch.Generator().manual_seed(76)).to("cuda")
        x_v = si_kernel._si_solve_reference(Hv, Hv, Bv, Hv, derived_v, DT, 1.0, 12, exps)
        pullback[shape] = (lam_v, Hv, Bv, x_v, derived_v)
    entries.update({
        "si_rows_apply": (
            "si_rows_apply", lambda f: lambda: f(rows_work[f], None, beta_r, si_math.ROWS_P2,
                                                 si_math.ROWS_P, 0, own_r, table_r, DT, False),
            si_kernel.si_rows_apply, si_kernel.si_rows_apply_reference,
            rows_apply_bound(n_r, nx_r, NY, own_r, 4), ("si_rows_apply",), 50),
        "si_rows_update": (
            "si_rows_update", lambda f: lambda: f(rows_work[f], alpha_r, si_math.ROWS_P, 0,
                                                  own_r),
            si_kernel.si_rows_update, si_kernel.si_rows_update_reference,
            rows_update_bound(n_r, nx_r, NY, own_r, 4), ("si_rows_update",), 50),
        f"si_rows_apply {large_tag}": (
            "si_rows_apply", lambda f: lambda: f(large_work[f], None, beta_l, si_math.ROWS_P2,
                                                 si_math.ROWS_P, r0_l, r1_l, table_l, DT, False),
            si_kernel.si_rows_apply, si_kernel.si_rows_apply_reference,
            rows_apply_bound(n_l, nx_l, ny_l, r1_l - r0_l, 4), ("si_rows_apply",), 10),
        f"si_rows_update {large_tag}": (
            "si_rows_update", lambda f: lambda: f(large_work[f], alpha_l, si_math.ROWS_P, r0_l,
                                                  r1_l),
            si_kernel.si_rows_update, si_kernel.si_rows_update_reference,
            rows_update_bound(n_l, nx_l, ny_l, r1_l - r0_l, 4), ("si_rows_update",), 10),
        f"si_assemble {slab_tag}": (
            "si_plane", lambda f: lambda: (f(rows_work[f], Hr, Hr, Br, Hr, derived_r, DT, 1.0, 0,
                                             True, exps), rows_work[f][si_math.ROWS_RHS])[1],
            si_kernel.si_assemble, si_kernel.si_assemble_reference,
            assemble_bound(n_r, nx_r, NY, 4), ("si_assemble",), 50),
        f"si_assemble {ice_tag}": (
            "si_plane", lambda f: lambda: (f(ice_work[f], Hi, Hi, Bi, Hi, derived_i, DT, 1.0, 0,
                                             True, exps), ice_work[f][si_math.ROWS_RHS])[1],
            si_kernel.si_assemble, si_kernel.si_assemble_reference,
            assemble_bound(1, n_i, n_i, 4), ("si_assemble",), 10),
        # the large-plane path at phase 15's ice-sheet planes
        "si_plane": (
            "si_plane", lambda f: lambda: f(Hi, Hi, Bi, Hi, derived_i, DT, 1.0, 12, exps),
            si_kernel.si_step, si_kernel.si_step_reference,
            si_bound(1, n_i, n_i, 4, 12), SI_KERNELS, 3),
        f"si_step {ice_tag} cg_iters=6": (
            "si_plane", lambda f: lambda: f(Hi, Hi, Bi, Hi, derived_i, DT, 1.0, 6, exps),
            si_kernel.si_step, si_kernel.si_step_reference,
            si_bound(1, n_i, n_i, 4, 6), SI_KERNELS, 3),
        f"si_step transpose {ice_tag} cg_iters=12": (
            "si_plane", lambda f: lambda: f(gi, xi, Hi, Bi, derived_i, DT, 1.0, 12, exps),
            si_kernel.si_step_transpose, si_kernel.si_step_transpose_reference,
            si_transpose_bound(1, n_i, n_i, 4, 12), SI_KERNELS, 3),
        # the large-plane pullback at 1 x 1024^2, phase 15's
        "si_plane_vjp": (
            "si_plane_vjp", lambda f: lambda: f(gi, Hi, Hi, Bi, xi, derived_i, DT, 1.0, exps),
            si_kernel.si_step_vjp, si_kernel.si_step_vjp_reference,
            si_vjp_bound(1, n_i, n_i, 4, planes_in=4), ("si_plane_vjp",), 10),
        **{f"si_plane_vjp {'x'.join(map(str, shape))}": (
            "si_plane_vjp", lambda f, a=a: lambda: f(a[0], a[1], a[1], a[2], a[3], a[4], DT, 1.0,
                                                     exps),
            si_kernel.si_step_vjp, si_kernel.si_step_vjp_reference,
            si_vjp_bound(*shape, 4, planes_in=4), ("si_plane_vjp",), 3)
           for shape, a in pullback.items()},
        f"si_step {big_tag} cg_iters=12": (
            "si_plane", lambda f: lambda: f(Hb, Hb, Bb, Hb, derived_b, DT, 1.0, 12, exps),
            si_kernel.si_step, si_kernel.si_step_reference,
            si_bound(1, n_b, n_b, 4, 12), SI_KERNELS, 2),
        f"si_step_vjp {slab_tag}": (
            "si_step_vjp", lambda f: lambda: f(lam_r, Hr, Hr, Br, x_r, derived_r, DT, 1.0, exps),
            si_kernel.si_step_vjp, si_kernel.si_step_vjp_reference,
            si_vjp_bound(n_r, nx_r, NY, 4, planes_in=4), ("si_step_vjp_kernel",), 50),
        f"sia2d_rhs 2x{NX // 2 + 1}x{NY}": (
            "sia2d_rhs", lambda f: lambda: f(H65, B65, raw2, PHYS.rho, PHYS.g, PHYS.eta0),
            sia_kernel.sia2d_rhs, sia_kernel.sia2d_rhs_reference,
            sia_bound(2, NX // 2 + 1, NY, 4), ("sia2d_rhs_kernel",), 50),
        f"rkc_interval 2x{NX // 2 + 25}x{NY} s={RKC_STAGES}": (
            "rkc_interval", lambda f: lambda: f(H2, B2, derived2, DT, RKC_STAGES, PHYS.eta0,
                                                exps),
            rkc_kernel.rkc_interval, rkc_kernel.rkc_interval_reference,
            rkc_bound(2, NX // 2 + 25, NY, 4, RKC_STAGES), ("rkc_interval_kernel",), 5),
    })
    timing = {}
    for name, (kernel, call, kern, plain, bound, kernel_names, plain_reps) in entries.items():
        # the plain version first: the stage kernel updates its carries in place
        ref, out = call(plain)(), call(kern)()
        if isinstance(out, tuple):
            out, ref = out[0], ref[0]
        torch.cuda.synchronize()
        dtype = bound[2] if len(bound) > 2 else f32     # a float64 entry names its dtype
        b_ms, b_by = bound_ms(bound[0], bound[1], dtype)
        # every call launches each of its device kernels once
        k_ms, _, by_name, attempt = complete_profile(
            call(kern), 50, kernel_names,
            lambda seen: bool(seen) and all(n == 1.0 for n in seen.values()))
        t = timing[name] = {
            "kernel": kernel,
            "dtype": str(dtype),
            # the kernel's own device time (and its device launches per call
            # by kernel name), and the wrapper's and the plain version's
            # elapsed time per call on the stream
            "ms": k_ms,
            "device_kernels": by_name,
            "profiles": attempt,
            "ms_source": "profiler device time",
            "call_ms": cuda_ms(call(kern), 200),
            "plain_ms": cuda_ms(call(plain), plain_reps),
            "plain_device_ms": device_ms(call(plain), max(2, plain_reps // 2)),
        }
        if not (by_name and all(n == 1.0 for n in by_name.values())):
            # no complete device record from the profiler
            t.update(ms=t["call_ms"], ms_source="cuda events per call")
        t.update({
            "max_abs_err": float((out.double() - ref.double()).abs().max()),
            "bound_ms": b_ms,
            "bound_by": b_by,
        })
    # the card's single-launch floor: a one-element PyTorch fill
    one = torch.empty(1, device="cuda")
    fill = lambda: one.fill_(1.0)
    floor = {"ms": device_ms(fill, 50), "call_ms": cuda_ms(fill, 200),
             "what": "torch.empty(1).fill_(1.0): device time and elapsed time per call"}
    emit({"phase": "kernel_times", "times": timing,
          "launch_floor": floor})
    return timing


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------

def kernel_counters():
    """Each kernel wrapper by name; its ``launches`` counts its launches."""
    from odinn_tpu_torch.ops.cuda import rkc_kernel, si_kernel, sia_kernel

    return {"si_step": si_kernel.si_step, "si_step_transpose": si_kernel.si_step_transpose,
            "si_step_tangent": si_kernel.si_step_tangent,
            "si_step_vjp": si_kernel.si_step_vjp, "sia2d_rhs": sia_kernel.sia2d_rhs,
            "rkc_interval": rkc_kernel.rkc_interval, "sia2d_rhs_vjp": sia_kernel.sia2d_rhs_vjp,
            "sia2d_rhs_jvp": sia_kernel.sia2d_rhs_jvp, "si_assemble": si_kernel.si_assemble,
            "si_rows_apply": si_kernel.si_rows_apply, "si_rows_update": si_kernel.si_rows_update}


def bench_params(**solver_kw):
    """The main path's parameters: 5 years, monthly saves and mass balance,
    float32, with the row's solver settings."""
    from odinn_tpu_torch.core.params import (
        Parameters, PhysicalParameters, SimulationParameters, SolverParameters)

    return Parameters(
        physical=PhysicalParameters(min_A=8e-21, max_A=8e-18),
        simulation=SimulationParameters(tspan=TSPAN, use_MB=True, step_MB=1.0 / 12.0,
                                        use_velocities=False, float_dtype="float32"),
        solver=SolverParameters(step=1.0 / 12.0, **solver_kw),
    )


def bench_glaciers(dtype, n_g=N_G, tspan=TSPAN, prefix="bench"):
    """The main path's Halfar glaciers (128^2, on the card), each with a
    monthly climate from the span's start and its own long-term
    temperature (-25 to -13 C)."""
    from odinn_tpu_torch.data.synthetic import halfar_glacier, monthly_dummy_climate

    n_months = int(round((tspan[1] - tspan[0]) * 12)) + 2
    return [
        halfar_glacier(nx=NX, ny=NY, dx=DX, dy=DX, temp=float(t), rgi_id=f"{prefix}-{i}",
                       climate=monthly_dummy_climate(tspan[0], n_months, temp_mean=-4.0,
                                                     longterm_temp=float(t), nx=NX, ny=NY,
                                                     device="cuda", dtype=dtype),
                       device="cuda", dtype=dtype)
        for i, t in enumerate(np.linspace(-25.0, -13.0, n_g))
    ]


def main_path_rows():
    """Phase 4: the forward prediction rows, through the kernels. Returns
    each kernel's launches summed over the rows."""
    from odinn_tpu_torch.core.glacier import stack_glaciers
    from odinn_tpu_torch.laws.laws import CuffeyPaterson
    from odinn_tpu_torch.models.model import Model, SIA2DModel
    from odinn_tpu_torch.physics.mass_balance import TImodel1
    from odinn_tpu_torch.simulation.prediction import Prediction, forward_batch, run_prediction
    from odinn_tpu_torch.simulation.solver import build_tstops

    tstops = build_tstops(TSPAN, 1.0 / 12.0)
    n_int = len(tstops) - 1          # 60 monthly intervals
    # launches per row: one si_step per SI step, two per SI2 step, one
    # sia2d_rhs per SSPRK3 stage (3 stages x 3 substeps), one rkc_interval
    # per RKC step: 60, 120, 540 and 60
    none = {name: 0 for name in kernel_counters()}
    rows = {
        "SI": (bench_params(substeps=1, solver="SI", cg_iters=6),
               dict(none, si_step=n_int)),
        "SI2": (bench_params(substeps=1, solver="SI2", cg_iters=6, cg_iters_predictor=6),
                dict(none, si_step=2 * n_int)),
        "SSPRK3@3 compensated": (bench_params(substeps=3, solver="SSPRK3", compensated=True),
                                 dict(none, sia2d_rhs=9 * n_int)),
        f"RKC-{RKC_STAGES}": (bench_params(substeps=1, solver="RKC", rkc_stages=RKC_STAGES),
                             dict(none, rkc_interval=n_int)),
    }
    model = Model(iceflow=SIA2DModel(A=CuffeyPaterson(), n_value=3.0), mass_balance=TImodel1())
    # the same A(T) law evaluated at every RHS call: its values are no longer
    # constant for the solve, so the solve takes the unfused PyTorch path
    plain_model = Model(iceflow=SIA2DModel(A=dataclasses.replace(CuffeyPaterson(), callback_freq=None),
                                           n_value=3.0), mass_balance=TImodel1())
    batch32 = stack_glaciers(bench_glaciers(torch.float32), device="cuda")
    batch64 = stack_glaciers(bench_glaciers(torch.float64), device="cuda")
    counters = kernel_counters()
    launches = {name: 0 for name in counters}
    for name, (params, expected) in rows.items():
        for fn in counters.values():
            fn.launches = 0
        pred = Prediction(model=model, glaciers=bench_glaciers(torch.float32), parameters=params,
                          device="cuda")
        H = run_prediction(pred)["H"]
        torch.cuda.synchronize()
        counted = {k: fn.launches for k, fn in counters.items()}
        if counted != expected:
            raise AssertionError(f"{name}: launches {counted}, expected {expected}")
        for k, v in counted.items():
            launches[k] += v
        if tuple(H.shape) != (N_G, len(tstops), NX, NY) or not torch.isfinite(H).all():
            raise AssertionError(f"{name}: trajectory {tuple(H.shape)} not finite or misshapen")

        plain32 = forward_batch(None, batch32, plain_model, params, tstops, device="cuda")
        plain64 = forward_batch(None, batch64, plain_model, params, tstops, device="cuda")
        torch.cuda.synchronize()
        if {k: fn.launches for k, fn in counters.items()} != counted:
            raise AssertionError(f"{name}: the plain runs launched a kernel")
        err_kernel = rel_err(H[:, -1], plain64[:, -1])
        err_plain = rel_err(plain32[:, -1], plain64[:, -1])
        row = {
            "phase": "main_path", "row": name, "launches": counted,
            "final_H_rel_err_vs_f64_plain": err_kernel,
            "f32_plain_final_H_rel_err_vs_f64_plain": err_plain,
            "kernel_vs_f32_plain_rel_err": rel_err(H[:, -1], plain32[:, -1]),
            "ms": row_ms(lambda: forward_batch(None, batch32, model, params, tstops, device="cuda")),
            "plain_ms": row_ms(lambda: forward_batch(None, batch32, plain_model, params, tstops,
                                                     device="cuda")),
            "device_busy_ms": device_ms(
                lambda: forward_batch(None, batch32, model, params, tstops, device="cuda"), 1),
        }
        # a main-path si_step is one launch of the cluster kernel: a row
        # whose profile shows only si_step_cluster, and fewer of them than
        # steps, has lost records
        want = {"si_step_cluster": expected["si_step"]} if expected["si_step"] else None
        row["kernel_device_ms"], _, row["kernel_launches_by_name"], attempt = complete_profile(
            lambda: forward_batch(None, batch32, model, params, tstops, device="cuda"), 1,
            SI_KERNELS + ("sia2d_rhs_kernel", "rkc_interval_kernel"),
            lambda seen: not (want and set(seen) == set(want)
                              and seen["si_step_cluster"] < want["si_step_cluster"]))
        row["profiles"] = attempt
        row["device_idle_share"] = 1.0 - row["device_busy_ms"] / row["ms"]
        emit(row)
        if want is not None and row["kernel_launches_by_name"] != want:
            raise AssertionError(f"{name}: si_step launched "
                                 f"{row['kernel_launches_by_name']} in profile {attempt} "
                                 f"of at most {PROFILES}, expected only "
                                 f"{expected['si_step']} si_step_cluster")
        if not err_kernel <= 2.0 * err_plain:
            raise AssertionError(f"{name}: kernel path error {err_kernel} exceeds 2x the "
                                 f"float32 plain path's {err_plain}")
    return launches


def periodic_a_law(freq=PERIODIC_FREQ, grid=False, nn_law=None, counter=None):
    """A per-glacier periodic A law, refreshed every ``freq`` years from the
    evolving surface: A_g = A_0(T_g) * (1 + 0.5 sigma(mean_g CPDD / 1000 - 1)),
    CPDD over the trailing year, A_0 the Cuffey-Paterson A(T) or, with
    ``nn_law``, that law's NN(T) (then trainable, its theta the NN's).
    ``grid`` gives the same value on every staggered cell, which is not the
    kernels' table: the generic path's version of the same law.
    ``counter["calls"]``, when given, counts its evaluations."""
    from odinn_tpu_torch.laws import inputs as law_inputs
    from odinn_tpu_torch.laws.laws import Law, poly_A_paterson_cuffey

    a_of_t = poly_A_paterson_cuffey()

    def apply_fn(theta, inp):
        if counter is not None:
            counter["calls"] += 1
        base = nn_law.apply(theta, inp) if nn_law is not None else a_of_t(inp["T"])
        cpdd = inp["CPDD"]
        factor = 1.0 + 0.5 * torch.sigmoid(cpdd.double().mean(dim=(-2, -1)) / 1000.0 - 1.0)
        val = base * factor.to(base.dtype)
        if grid:
            val = val.reshape(-1, 1, 1) * torch.ones(cpdd[..., 1:, 1:].shape, dtype=val.dtype,
                                                     device=val.device)
        return val

    return Law(slot="A", apply_fn=apply_fn,
               inputs=(law_inputs.AvgScalarTemp(), law_inputs.CPDD(window=1.0)),
               callback_freq=freq, trainable=nn_law is not None, name="periodicA",
               init_theta=None if nn_law is None else nn_law.init_theta)


def periodic_rows():
    """Phase 4b: the main path's scenario (4 x 128^2, 5 years, monthly saves
    and mass balance, float32, n = 3) with a periodic per-glacier A law
    (``periodic_a_law``, refreshed yearly) through SI (PCG-6) and RKC-25.
    Each row runs through ``run_prediction`` with the launch counters set
    to 0 just before and read just after: exactly 60 si_step (SI) or 60
    rkc_interval (RKC) and no other kernel, and 4 refreshes (the law's
    evaluations after the first); its final thickness is held to 2x the
    float32 plain run's own error against the float64 plain run (the law on
    the staggered grid, the generic path, which launches no kernel) and
    must differ from the row with the law frozen at the start by more than
    10x that error. Returns each kernel's launches summed over the rows."""
    from odinn_tpu_torch.core.glacier import stack_glaciers
    from odinn_tpu_torch.models.model import Model, SIA2DModel
    from odinn_tpu_torch.physics.mass_balance import TImodel1
    from odinn_tpu_torch.simulation.prediction import Prediction, forward_batch, run_prediction
    from odinn_tpu_torch.simulation.solver import build_tstops

    tstops = build_tstops(TSPAN, 1.0 / 12.0)
    n_int = len(tstops) - 1
    none = {name: 0 for name in kernel_counters()}
    rows = {"SI": (bench_params(substeps=1, solver="SI", cg_iters=6),
                   dict(none, si_step=n_int)),
            f"RKC-{RKC_STAGES}": (bench_params(substeps=1, solver="RKC", rkc_stages=RKC_STAGES),
                                 dict(none, rkc_interval=n_int))}
    n_refresh = int(round((TSPAN[1] - TSPAN[0]) / PERIODIC_FREQ)) - 1

    def model_of(law):
        return Model(iceflow=SIA2DModel(A=law, n_value=3.0), mass_balance=TImodel1())

    batch32 = stack_glaciers(bench_glaciers(torch.float32), device="cuda")
    batch64 = stack_glaciers(bench_glaciers(torch.float64), device="cuda")
    counters = kernel_counters()
    launches = {name: 0 for name in counters}
    for name, (params, expected) in rows.items():
        evaluations = {"calls": 0}
        law = periodic_a_law(counter=evaluations)
        for fn in counters.values():
            fn.launches = 0
        pred = Prediction(model=model_of(law), glaciers=bench_glaciers(torch.float32),
                          parameters=params, device="cuda")
        H = run_prediction(pred)["H"]
        torch.cuda.synchronize()
        counted = {k: fn.launches for k, fn in counters.items()}
        refreshes = evaluations["calls"] - 1
        if counted != expected:
            raise AssertionError(f"periodic {name}: launches {counted}, expected {expected}")
        if refreshes != n_refresh:
            raise AssertionError(f"periodic {name}: {refreshes} refreshes, expected {n_refresh}")
        for k, v in counted.items():
            launches[k] += v
        if tuple(H.shape) != (N_G, len(tstops), NX, NY) or not torch.isfinite(H).all():
            raise AssertionError(f"periodic {name}: trajectory not finite or misshapen")
        plain = model_of(periodic_a_law(grid=True))
        plain32 = forward_batch(None, batch32, plain, params, tstops, device="cuda")
        plain64 = forward_batch(None, batch64, plain, params, tstops, device="cuda")
        frozen = forward_batch(None, batch32, model_of(periodic_a_law(freq=0.0)), params,
                               tstops, device="cuda")
        torch.cuda.synchronize()
        if {k: fn.launches for k, fn in counters.items()} != dict(
                none, **{k: 2 * v for k, v in expected.items() if v}):
            raise AssertionError(f"periodic {name}: the plain runs launched a kernel, or the "
                                 f"frozen row did not run on the kernels")
        model = model_of(periodic_a_law())
        row = {"phase": "periodic_rows", "row": name, "launches": counted,
               "refreshes": refreshes,
               "final_H_rel_err_vs_f64_plain": rel_err(H[:, -1], plain64[:, -1]),
               "f32_plain_final_H_rel_err_vs_f64_plain": rel_err(plain32[:, -1], plain64[:, -1]),
               "frozen_law_final_H_rel_diff": rel_err(frozen[:, -1], H[:, -1]),
               "ms": row_ms(lambda: forward_batch(None, batch32, model, params, tstops,
                                                  device="cuda"))}
        row["device_busy_ms"] = device_ms(
            lambda: forward_batch(None, batch32, model, params, tstops, device="cuda"), 1)
        row["device_idle_share"] = 1.0 - row["device_busy_ms"] / row["ms"]
        emit(row)
        err, err_plain = row["final_H_rel_err_vs_f64_plain"], row[
            "f32_plain_final_H_rel_err_vs_f64_plain"]
        if not err <= 2.0 * err_plain:
            raise AssertionError(f"periodic {name}: kernel path error {err} exceeds 2x the "
                                 f"float32 plain path's {err_plain}")
        if not row["frozen_law_final_H_rel_diff"] > 10.0 * err_plain:
            raise AssertionError(f"periodic {name}: the refresh made no difference: {row}")
    return launches


def training_problem(solver, grad="jax", n_g=N_TRAIN, tspan=TRAIN_TSPAN,
                     dtype=torch.float32, kind="ude", periodic_freq=PERIODIC_FREQ):
    """A training phase's problem at the width of benchmarks/perf_tpu.py's
    UDE epoch: 16 Halfar glaciers, 128^2, float32, 2 years of monthly
    Cuffey–Paterson ground truth, through the RKC solve (s from
    rkc_stages_for) or, as that epoch does, the SI solve at PCG-20 (SI2 at
    PCG-20 with a PCG-6 predictor; an explicit ``solver`` at the substeps
    of suggest_substeps); the ground truth through the same solve. ``kind``:
    "ude" trains A = NN(T) on the thickness series; the classical
    inversions train one tanh-bounded A per glacier (LawA_inversion), "ic"
    with a trainable H0 (InitialCondition: Zang1980 filter, Farinotti2019
    start with correlated noise of 15 m) against the thickness series plus
    a Tikhonov term on H0 (weight 1e-12), "aggregate" against the mean
    dh/dt over the span and the annual mean-velocity product (LossDhdt +
    LossAvgV), "classical" against the thickness series alone. The
    laws-and-targets kinds: "periodic" trains NN(T) times
    the CPDD factor of ``periodic_a_law`` as one periodic per-glacier A law
    (refreshed every ``periodic_freq`` years; the glaciers get the main
    path's monthly climates), "Y" the hybrid-D target (LawY, max_nn 8e-18,
    prescale ((-25, 0), (0, 500))), "U" the pure-D target (LawU, max_nn
    2000, prescale ((0, 500), (0, 0.3))), both with default_architecture(2),
    and "capped" A = NN(T) under the diffusivity cap CAPPED_MAX_D.
    ``grad`` is the gradient (params.UDE.grad); ``n_g``, ``tspan`` and
    ``dtype`` cut the problem for the gradient checks. Returns (inversion,
    model, params, tstops, facts)."""
    from odinn_tpu_torch.core.params import (
        Hyperparameters, Parameters, PhysicalParameters, SimulationParameters,
        SolverParameters, UDEParameters)
    from odinn_tpu_torch.data.synthetic import halfar_glacier
    from odinn_tpu_torch.laws.laws import (
        CuffeyPaterson, LawA, LawA_inversion, LawU, LawY, poly_A_paterson_cuffey)
    from odinn_tpu_torch.losses.losses import LossH, MultiLoss
    from odinn_tpu_torch.losses.regularization import InitialThicknessRegularization
    from odinn_tpu_torch.losses.time_aggregated import LossAvgV, LossDhdt
    from odinn_tpu_torch.models.initial_condition import InitialCondition
    from odinn_tpu_torch.models.model import Model, SIA2DModel
    from odinn_tpu_torch.models.nn import NeuralNetwork, default_architecture
    from odinn_tpu_torch.simulation.inversion import Inversion
    from odinn_tpu_torch.simulation.prediction import generate_ground_truth
    from odinn_tpu_torch.simulation.solver import build_tstops, rkc_stages_for

    from odinn_tpu_torch.simulation.solver import suggest_substeps

    phys = PhysicalParameters(min_A=8e-21, max_A=8e-18)
    temps = np.linspace(-25.0, -13.0, n_g)
    if kind == "periodic":
        glaciers = bench_glaciers(dtype, n_g, tspan, prefix="train")
    else:
        glaciers = [halfar_glacier(nx=NX, ny=NY, dx=DX, dy=DX, temp=float(t),
                                   rgi_id=f"train-{i}", device="cuda", dtype=dtype)
                    for i, t in enumerate(temps)]
    # stages for the largest creep the solve can meet: the law's max_A or
    # the truth's largest A, at the batch's thickest ice
    h_max = max(float(g.H0.max()) for g in glaciers)
    a_truth = float(poly_A_paterson_cuffey()(torch.from_numpy(temps)).max())
    a_max = max(phys.max_A, a_truth)
    stages = rkc_stages_for(DX, DX, h_max, a_max, n=3.0, rho=phys.rho, g=phys.g,
                            step=1.0 / 12.0)
    if solver == "RKC":
        solver_kw = dict(solver="RKC", rkc_stages=stages, substeps=1)
    elif solver in ("SI", "SI2"):
        solver_kw = dict(solver=solver, cg_iters=SI_TRAIN_CG, cg_iters_predictor=6, substeps=1)
    else:
        solver_kw = dict(solver=solver, substeps=suggest_substeps(
            DX, DX, h_max, a_max, n=3.0, rho=phys.rho, g=phys.g, step=1.0 / 12.0))
    loss = {"ic": MultiLoss((LossH(), InitialThicknessRegularization()), (1.0, 1e-12)),
            "aggregate": MultiLoss((LossDhdt(), LossAvgV()), (1.0, 1.0))}.get(kind)
    params = Parameters(
        physical=phys,
        simulation=SimulationParameters(tspan=tspan, use_MB=False,
                                        use_velocities=kind == "aggregate",
                                        float_dtype=str(dtype).split(".")[-1]),
        solver=SolverParameters(step=1.0 / 12.0, **solver_kw),
        # the D targets' generic path is ~10x the kernels' epoch: their
        # trainings take Adam 3, LBFGS 0, so that the run stays near 300 s
        hyper=Hyperparameters(optimizer=("adam", "lbfgs"), learning_rate=(0.05, 1.0),
                              epochs=(3, 0) if kind in ("Y", "U") else (5, 3),
                              batch_size=n_g),
        UDE=UDEParameters(grad=grad, empirical_loss_function=loss),
    )
    tstops = build_tstops(tspan, 1.0 / 12.0)
    t0 = time.perf_counter()
    truth = generate_ground_truth(
        glaciers, params, Model(iceflow=SIA2DModel(A=CuffeyPaterson(), n_value=3.0)), tstops,
        store=("dhdt", "avgV") if kind == "aggregate" else ("H",), device="cuda")
    torch.cuda.synchronize()
    truth_s = time.perf_counter() - t0
    if kind in ("ude", "periodic", "capped"):
        law = LawA(NeuralNetwork(default_architecture(1)), params)
        if kind == "periodic":
            law = periodic_a_law(periodic_freq, nn_law=law)
        model = Model(iceflow=SIA2DModel(A=law, n_value=3.0,
                                         max_D=CAPPED_MAX_D if kind == "capped" else None))
    elif kind == "Y":
        model = Model(iceflow=SIA2DModel(Y=LawY(
            NeuralNetwork(default_architecture(2)), params, max_nn=8e-18,
            prescale_bounds=((-25.0, 0.0), (0.0, 500.0))), n_value=3.0))
    elif kind == "U":
        model = Model(iceflow=SIA2DModel(U=LawU(
            NeuralNetwork(default_architecture(2)), params, max_nn=2000.0,
            prescale_bounds=((0.0, 500.0), (0.0, 0.3))), n_value=3.0))
    else:
        ic = (InitialCondition(filter="Zang1980", init="Farinotti2019Random", noise_sigma=15.0)
              if kind == "ic" else None)   # kinds "ic", "aggregate", "classical"
        model = Model(iceflow=SIA2DModel(A=LawA_inversion(params, scalar=True), n_value=3.0),
                      initial_condition=ic)
    inv = Inversion(model=model, glaciers=truth, parameters=params, device="cuda")
    facts = ({"rkc_stages": stages, "h_max": h_max, "a_for_stages": a_max}
             if solver == "RKC" else {"cg_iters": SI_TRAIN_CG} if solver in ("SI", "SI2")
             else {"substeps": params.solver.substeps})
    facts["ground_truth_s"] = truth_s
    return inv, model, params, tstops, facts


def grad_fn(inv, params, mesh=None):
    """The trainer's ``vg(theta, batch) -> (loss, gradient leaves)`` for
    params.UDE.grad on the inversion's problem (summed over the ranks of
    ``mesh``), and its TrainingStats."""
    from odinn_tpu_torch.simulation.inversion import (
        Inversion, _make_grad_fn, assemble_tstops, batch_transient_loss)
    from odinn_tpu_torch.simulation.results import TrainingStats

    inv2 = Inversion(model=inv.model, glaciers=inv.glaciers, parameters=params,
                     theta=inv.theta, device=inv.device)
    tstops = assemble_tstops(params, inv2.glaciers)
    stats = TrainingStats()
    return _make_grad_fn(inv2, lambda th, b: batch_transient_loss(th, b, inv.model, params,
                                                                   tstops), stats, mesh), stats


def adam_epoch_fn(inv, model, params, tstops, mesh=None):
    """One Adam epoch (forward, gradient by params.UDE.grad, update) on a
    copy of the inversion's θ; on a ``mesh``, over this rank's glaciers
    with the loss and gradient summed over the ranks."""
    from odinn_tpu_torch.parallel.mesh import shard_inversion
    from odinn_tpu_torch.simulation.inversion import _tree_leaves

    theta0, glaciers, _ = shard_inversion(inv.theta, inv.glaciers, mesh)
    theta = _tree_to(theta0, inv.device, None, requires_grad=True)
    leaves = _tree_leaves(theta)
    opt = torch.optim.Adam(leaves, lr=0.05)
    vg, _ = grad_fn(inv, params, mesh)

    def adam_epoch():
        _, grads = vg(theta, glaciers)
        for p, g in zip(leaves, grads):
            p.grad = g
        opt.step()

    adam_epoch.record = vg.record
    return adam_epoch


def epoch_profile(adam_epoch, reps=5):
    """The epoch's time (CUDA events, median of ``reps`` after a warm-up),
    device busy time, idle share and device launches, all and by kernel
    name, and our kernels' device ms (profiler, one epoch)."""
    epoch_ms = row_ms(adam_epoch, reps=reps)
    busy_ms, launches, by_name, ms_of = device_profile(adam_epoch, 1, ms_by_name=True)
    return {"adam_epoch_ms": epoch_ms, "adam_epoch_device_busy_ms": busy_ms,
            "adam_epoch_device_idle_share": 1.0 - busy_ms / epoch_ms,
            "adam_epoch_device_launches": launches,
            "adam_epoch_launches_by_kernel": dict(sorted(by_name.items(),
                                                         key=lambda kv: -kv[1])),
            "adam_epoch_kernel_device_ms": {n: ms for n, ms in ms_of.items()
                                            if n in KERNEL_NAMES}}


def training_phase(solver, grad="jax", kind="ude"):
    """Phases 5 and 6: run_inversion through the RKC or the SI solve on
    :func:`training_problem` (``kind`` "ude", or a classical inversion:
    "ic", "aggregate"), by autograd (``grad="jax"``) or by the discrete
    adjoint, then one Adam epoch profiled. Returns each kernel's launches
    in the run. The discrete adjoint launches what autograd does through
    RKC (its transpose is the fused step's backward), and through SI one
    more si_step per interval and gradient (the plain-CG rematerialisation
    of the pre-relu state), the transpose solve and the pullback without
    the preconditioner. A trainable H0 (the kind "ic") must have trained:
    its gradient is nonzero and TrainingStats.initial_conditions is set.
    The periodic law (the kind "periodic", SI) launches what the UDE SI
    training does; the D targets (kinds "Y", "U") take the generic path:
    no kernel launch in the run or the profiled epoch."""
    from odinn_tpu_torch.simulation.inversion import run_inversion

    inv, model, params, tstops, facts = training_problem(solver, grad, kind=kind)
    n_int = len(tstops) - 1
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    results = run_inversion(inv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    stats = results.stats
    losses = stats.losses
    expected = {name: 0 for name in counters}
    generic = kind in ("Y", "U", "capped")     # no kernel: expected stays 0
    if not generic and solver == "RKC":
        # every forward solve is one rkc_interval per interval, and every
        # backward rematerialises each interval's stages with one more; each
        # backward interval pulls back s - 1 stages and f0: s sia2d_rhs_vjp
        expected.update(rkc_interval=n_int * (stats.solves + stats.gradients),
                        sia2d_rhs_vjp=n_int * facts["rkc_stages"] * stats.gradients)
    elif not generic:
        # every forward solve is one si_step per interval; every backward
        # one transpose solve and one pullback per interval, by autograd
        # nothing rematerialised, by the discrete adjoint the pre-relu
        # state by one si_step without the preconditioner
        remat = stats.gradients if grad == "discrete" else 0
        expected.update(si_step=n_int * (stats.solves + remat),
                        si_step_transpose=n_int * stats.gradients,
                        si_step_vjp=n_int * stats.gradients)
    phase = {"ude": "training", "periodic": "periodic_training", "Y": "d_target_training",
             "U": "d_target_training"}.get(kind, "classical_inversion")
    row = dict({
        "phase": phase, "kind": kind,
        "solver": solver, "grad": grad, "glaciers": N_TRAIN, "grid": [NX, NY],
        "dtype": "torch.float32", "theta_shapes": {k: list(v.shape) for k, v in
                                                   inv.theta.items()
                                                   if kind in ("ic", "aggregate")},
        "intervals": n_int, "run_inversion_s": train_s, "losses": losses,
        "final_loss": stats.final_loss, "solves": stats.solves, "gradients": stats.gradients,
        "launches": launches, "expected_launches": expected,
        "time_per_iter_s": stats.time_per_iter,
    }, **facts, **epoch_profile(adam_epoch_fn(inv, model, params, tstops)))
    if generic:
        # the profiled epoch too: no wrapper count, no kernel on the device
        row["epoch_launches"] = {k: fn.launches for k, fn in counters.items()}
        row["epoch_kernels_seen"] = sorted(k for k in row["adam_epoch_launches_by_kernel"]
                                           if k in KERNEL_NAMES)
    if kind == "ic":
        vg, _ = grad_fn(inv, params)
        _, grads = vg(_tree_to(inv.theta, "cuda", None, requires_grad=True), inv.glaciers)
        row["max_abs_dtheta_IC"] = float(grads[list(inv.theta).index("IC")].abs().max())
        row["initial_conditions_set"] = stats.initial_conditions is not None
    emit(row)
    what = f"{row['phase']} {kind} {solver} {grad}"
    if launches != expected:
        raise AssertionError(f"{what}: launches {launches}, expected {expected}")
    if generic and (any(row["epoch_launches"].values()) or row["epoch_kernels_seen"]):
        raise AssertionError(f"{what}: a kernel ran in the profiled epoch: {row}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{what}: losses not finite or not decreasing: {losses}")
    if kind == "ic" and not (row["max_abs_dtheta_IC"] > 0.0 and row["initial_conditions_set"]):
        raise AssertionError(f"{what}: H0 did not train: {row}")
    return launches


def continuous_gradient_phase():
    """One full-width gradient by ContinuousAdjoint(DiscreteVJP) on the SI
    training's problem (16 x 128^2, float32, 24 intervals): its time (host
    clock to a synchronise), the reverse steps each glacier took per
    interval, the step loop's host reads, and its launches, asserted: the
    forward's si_step per interval, a sia2d_rhs per save (the Hermite
    slopes of H), and a sia2d_rhs_vjp per pullback (the first slope of each
    interval, three a reverse step while any glacier steps, two λ slopes
    per interval, one a quadrature node). Returns the launches."""
    from odinn_tpu_torch.inverse.adjoint_types import ContinuousAdjoint, DiscreteVJP
    from odinn_tpu_torch.inverse.gradient import make_adjoint_value_and_grad

    adjoint = ContinuousAdjoint(VJP_method=DiscreteVJP())
    inv, model, params, tstops, facts = training_problem("SI", adjoint)
    vg = make_adjoint_value_and_grad(inv, flavor="continuous")
    vg(inv.theta)   # warm-up
    torch.cuda.synchronize()
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    loss, grads = vg(inv.theta)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    steps = vg.record["reverse_steps"]           # [interval from the last][glacier]
    n_int = len(tstops) - 1
    expected = {name: 0 for name in counters}
    expected.update(si_step=n_int, sia2d_rhs=n_int + 1,
                    sia2d_rhs_vjp=sum(1 + 3 * max(s) for s in steps) + 2 * n_int
                    + adjoint.n_quadrature)
    flat = torch.cat([g.flatten() for layer in grads["A"] for g in layer.values()])
    row = {"phase": "continuous_gradient", "solver": "SI", "glaciers": N_TRAIN,
           "grid": [NX, NY], "dtype": "torch.float32", "intervals": n_int,
           "adjoint": "ContinuousAdjoint(DiscreteVJP), hermite", "seconds": seconds,
           "loss": float(loss), "reverse_steps_per_interval_max": [max(s) for s in steps],
           "reverse_steps_per_interval_min": [min(s) for s in steps],
           "host_syncs": vg.record["host_syncs"], "launches": launches,
           "expected_launches": expected}
    emit(row)
    if launches != expected:
        raise AssertionError(f"continuous gradient: launches {launches}, expected {expected}")
    if not (torch.isfinite(flat).all() and float(flat.abs().max()) > 0.0):
        raise AssertionError(f"continuous gradient not finite or zero: {row}")
    return launches


def check_adjoint_gradients():
    """The hand-written adjoints' θ-gradient on the card (4 Halfar glaciers,
    128^2, 2 monthly intervals, A = NN(T) at its initial θ). Euler, SSPRK3
    (both at suggest_substeps) and RKC (s of rkc_stages_for): the
    DiscreteAdjoint(DiscreteVJP) gradient is the exact transpose of the
    forward, so it is held to the card's autograd gradient (grad="jax") of
    the same θ, float64 to TOL_GRAD_F64, float32 within GRAD_F32_FACTOR
    times the float32 plain version's (the same adjoint on the CPU, the
    kernels' plain versions) own error against the float64 autograd
    gradient. SI and SI2 (PCG-20) and ContinuousAdjoint(DiscreteVJP) on
    the SI forward: held to the same function run on the CPU in float64,
    the same way."""
    from odinn_tpu_torch.inverse.adjoint_types import (
        ContinuousAdjoint, DiscreteAdjoint, DiscreteVJP)
    from odinn_tpu_torch.core.params import UDEParameters
    from odinn_tpu_torch.simulation.inversion import Inversion

    def gradient(inv, theta, grad, device, dtype):
        params = inv.parameters.replace(UDE=UDEParameters(grad=grad))
        on = Inversion(model=inv.model, glaciers=glaciers.to(device, dtype),
                       parameters=params, device=device,
                       theta=_tree_to(theta, device, dtype))
        vg, _ = grad_fn(on, params)
        th = _tree_to(theta, device, dtype, requires_grad=True)
        _, grads = vg(th, on.glaciers)
        return torch.cat([g.detach().double().flatten().cpu() for g in grads])

    def err(a, b):
        return float((a - b).abs().max() / b.abs().max())

    discrete = DiscreteAdjoint(VJP_method=DiscreteVJP())
    cases = [("Euler", discrete, "jax"), ("SSPRK3", discrete, "jax"), ("RKC", discrete, "jax"),
             ("SI", discrete, "cpu"), ("SI2", discrete, "cpu"),
             ("SI", ContinuousAdjoint(VJP_method=DiscreteVJP()), "cpu")]
    f32, f64 = torch.float32, torch.float64
    for solver, adjoint, against in cases:
        t0 = time.perf_counter()
        inv, _, params, _, facts = training_problem(solver, "jax", n_g=N_G,
                                                    tspan=(5.0, 5.0 + 2.0 / 12.0), dtype=f64)
        # one problem for both dtypes: the float32 data and θ, which float64
        # holds exactly (a cell that rounds to 0 in float32 would otherwise
        # leave the loss's mask in one dtype only)
        glaciers = inv.glaciers.to(dtype=f32)
        theta = _tree_to(inv.theta, "cuda", f32)
        k64 = gradient(inv, theta, adjoint, "cuda", f64)
        k32 = gradient(inv, theta, adjoint, "cuda", f32)
        p32 = gradient(inv, theta, adjoint, "cpu", f32)
        ref = (gradient(inv, theta, "jax", "cuda", f64) if against == "jax"
               else gradient(inv, theta, adjoint, "cpu", f64))
        # the float32 error is mostly the law's and the loss's own float32
        # arithmetic, common to the kernels and their plain versions: the
        # kernels' part shows in the float32 kernel-against-plain gap
        row = {"phase": "check_adjoint_grad", "solver": solver, "adjoint": type(adjoint).__name__,
               "against": "card grad='jax' float64" if against == "jax" else "CPU float64",
               "glaciers": N_G, "grid": [NX, NY], "intervals": 2,
               "float64_rel_err": err(k64, ref), "tol": TOL_GRAD_F64,
               "float32_rel_err": err(k32, ref), "f32_plain_rel_err": err(p32, ref),
               "float32_vs_f32_plain_rel_err": err(k32, p32),
               "factor": GRAD_F32_FACTOR, "seconds": time.perf_counter() - t0}
        row.update({k: v for k, v in facts.items() if k != "ground_truth_s"})
        emit(row)
        if not (row["float64_rel_err"] <= TOL_GRAD_F64 and torch.isfinite(k32).all()
                and row["float32_rel_err"] <= GRAD_F32_FACTOR * row["f32_plain_rel_err"]):
            raise AssertionError(f"{solver} {type(adjoint).__name__}: the adjoint's gradient "
                                 f"on the card disagrees: {row}")


def check_law_target_gradients():
    """The laws-and-targets slice's gradients on the card (4 Halfar
    glaciers, 128^2, 2 monthly intervals, theta at its start): the hybrid-D
    (LawY), pure-D (LawU) and capped A (NN(T), CAPPED_MAX_D) targets by
    autograd and by DiscreteAdjoint(DiscreteVJP), through SI (PCG-20) and
    RKC, on the generic path (no kernel launch, asserted); and the periodic
    A law (NN(T) times the CPDD factor, refreshed monthly so that the
    refresh reaches the second interval) by autograd through SI and RKC, on
    the kernels. Each is held to the same function run on the CPU in
    float64, each theta leaf on its own: float64 to TOL_GRAD_F64, float32
    within GRAD_F32_FACTOR times the float32 plain version's (the same
    function on the CPU) own error. The periodic law's fused gradient also
    equals the generic route's (the law on the staggered grid) on the card,
    float64 to TOL_CLASSICAL_F64."""
    from odinn_tpu_torch.core.params import UDEParameters
    from odinn_tpu_torch.inverse.adjoint_types import DiscreteAdjoint, DiscreteVJP
    from odinn_tpu_torch.laws.laws import LawA
    from odinn_tpu_torch.models.model import Model, SIA2DModel
    from odinn_tpu_torch.models.nn import NeuralNetwork, default_architecture
    from odinn_tpu_torch.simulation.inversion import Inversion

    def gradient(inv, model, theta, grad, device, dtype):
        params = inv.parameters.replace(UDE=UDEParameters(grad=grad))
        on = Inversion(model=model, glaciers=glaciers.to(device, dtype), parameters=params,
                       device=device, theta=_tree_to(theta, device, dtype))
        vg, _ = grad_fn(on, params)
        _, grads = vg(_tree_to(theta, device, dtype, requires_grad=True), on.glaciers)
        return [g.detach().double().cpu() for g in grads]

    def err(a, b):
        return max(float((x - y).abs().max() / y.abs().max().clamp(min=1e-300))
                   for x, y in zip(a, b))

    discrete = DiscreteAdjoint(VJP_method=DiscreteVJP())
    cases = [(kind, solver, grad) for kind in ("Y", "U", "capped") for solver in ("SI", "RKC")
             for grad in ("jax", discrete)]
    cases += [("periodic", solver, "jax") for solver in ("SI", "RKC")]
    f32, f64 = torch.float32, torch.float64
    counters = kernel_counters()
    for kind, solver, grad in cases:
        t0 = time.perf_counter()
        inv, model, _, _, facts = training_problem(solver, "jax", n_g=N_G,
                                                   tspan=(5.0, 5.0 + 2.0 / 12.0), dtype=f64,
                                                   kind=kind, periodic_freq=1.0 / 12.0)
        glaciers = inv.glaciers.to(dtype=f32)
        theta = _tree_to(inv.theta, "cuda", f32)
        for fn in counters.values():
            fn.launches = 0
        k64 = gradient(inv, model, theta, grad, "cuda", f64)
        k32 = gradient(inv, model, theta, grad, "cuda", f32)
        card_launches = {k: fn.launches for k, fn in counters.items()}
        p32 = gradient(inv, model, theta, grad, "cpu", f32)
        ref = gradient(inv, model, theta, grad, "cpu", f64)
        row = {"phase": "check_law_target_grad", "kind": kind, "solver": solver,
               "grad": grad if isinstance(grad, str) else type(grad).__name__,
               "against": "CPU float64", "glaciers": N_G, "grid": [NX, NY], "intervals": 2,
               "float64_rel_err": err(k64, ref), "tol": TOL_GRAD_F64,
               "float32_rel_err": err(k32, ref), "f32_plain_rel_err": err(p32, ref),
               "float32_vs_f32_plain_rel_err": err(k32, p32),
               "factor": GRAD_F32_FACTOR, "card_launches": card_launches}
        fused_ok = True
        if kind == "periodic":
            generic = Model(iceflow=SIA2DModel(A=periodic_a_law(
                1.0 / 12.0, grid=True,
                nn_law=LawA(NeuralNetwork(default_architecture(1)), inv.parameters)),
                n_value=3.0))
            g64 = gradient(inv, generic, theta, grad, "cuda", f64)
            row["fused_vs_generic_float64_rel_err"] = err(k64, g64)
            row["fused_tol"] = TOL_CLASSICAL_F64
            fused_ok = (row["fused_vs_generic_float64_rel_err"] <= TOL_CLASSICAL_F64
                        and any(card_launches.values()))
        elif any(card_launches.values()):
            fused_ok = False
        row["seconds"] = time.perf_counter() - t0
        row.update({k: v for k, v in facts.items() if k != "ground_truth_s"})
        emit(row)
        if not (fused_ok and row["float64_rel_err"] <= TOL_GRAD_F64
                and all(torch.isfinite(g).all() for g in k32)
                and max(float(g.abs().max()) for g in k32) > 0.0
                and row["float32_rel_err"] <= GRAD_F32_FACTOR * row["f32_plain_rel_err"]):
            raise AssertionError(f"{kind} {solver} {row['grad']}: the gradient on the card "
                                 f"disagrees or took the wrong route: {row}")


def pretraining_phase():
    """NN pretraining on the card in float64: pretrain_law_from_A with
    tests/test_features.py's settings (8 Fourier frequencies and one
    32-wide tanh layer, 48 Cuffey-Paterson targets with 3e-5 relative
    noise, 300 LM iterations, 2 restarts), its fit read through the law
    (eval_law) at every 6th target: max relative error < 1e-5."""
    from odinn_tpu_torch.core.params import Parameters, PhysicalParameters
    from odinn_tpu_torch.data.synthetic import halfar_glacier
    from odinn_tpu_torch.laws.laws import LawA, eval_law, poly_A_paterson_cuffey
    from odinn_tpu_torch.models.nn import MLP, NeuralNetwork
    from odinn_tpu_torch.models.nn_utils import pretrain_law_from_A

    params = Parameters(physical=PhysicalParameters(min_A=8e-21, max_A=8e-18))
    temps = np.linspace(-25.0, -14.0, 48)
    noise = 1.0 + 3e-5 * np.random.default_rng(0).standard_normal(48)
    A_tgt = poly_A_paterson_cuffey()(torch.from_numpy(temps)).numpy() * noise
    nf, pb = 8, ((-25.0, 0.0),)
    nn = NeuralNetwork(MLP((2 * nf, 32, 1), ("tanh", "sigmoid")), seed=666)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    theta = pretrain_law_from_A(nn, params, temps, A_tgt, head="log", prescale_bounds=pb,
                                n_fourier=nf, iters=300, restarts=2, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    law = LawA(nn, params, head="log", prescale_bounds=pb, n_fourier=nf)
    g0 = halfar_glacier(nx=16, ny=16, device="cuda")
    rels = []
    for t, a in zip(temps[::6], A_tgt[::6]):
        gi = g0.replace(climate=dataclasses.replace(
            g0.climate, longterm_temps_scalar=torch.tensor(float(t), dtype=torch.float64,
                                                           device="cuda")))
        rels.append(abs(float(eval_law(law, {"A": theta}, gi)) - float(a)) / float(a))
    row = {"phase": "pretraining", "dtype": "torch.float64", "samples": 48,
           "fourier_frequencies": nf, "iters": 300, "restarts": 2, "seconds": seconds,
           "device": str(theta[0]["w"].device), "max_rel_err": max(rels), "tol": 1e-5}
    emit(row)
    if not (row["max_rel_err"] < 1e-5 and theta[0]["w"].is_cuda):
        raise AssertionError(f"pretraining on the card does not interpolate: {row}")


def check_classical_gradients():
    """The hand-written adjoints' θ-gradient of the classical inversions on
    the card (4 Halfar glaciers, 128^2, 2 monthly intervals, θ at its
    start): θ = {A, IC} with the thickness loss and the Tikhonov term on H0
    through SI and RKC by DiscreteAdjoint(DiscreteVJP), θ = A with the
    dh/dt and mean-velocity losses through RKC by the same, and
    ContinuousAdjoint(DiscreteVJP) on the SI forward with θ = {A, IC} and
    the Tikhonov term. RKC is held to the card's autograd gradient of the
    same loss (grad="jax"), SI and the continuous adjoint to the same
    function on the CPU in float64, as check_adjoint_gradients does; each θ
    leaf on its own: float64 to TOL_CLASSICAL_F64, float32 within
    GRAD_F32_FACTOR times the float32 plain version's own error."""
    from odinn_tpu_torch.inverse.adjoint_types import (
        ContinuousAdjoint, DiscreteAdjoint, DiscreteVJP)
    from odinn_tpu_torch.simulation.inversion import Inversion

    def gradient(inv, theta, grad, device, dtype):
        params = inv.parameters.replace(UDE=dataclasses.replace(inv.parameters.UDE, grad=grad))
        on = Inversion(model=inv.model, glaciers=glaciers.to(device, dtype),
                       parameters=params, device=device, theta=_tree_to(theta, device, dtype))
        vg, _ = grad_fn(on, params)
        _, grads = vg(_tree_to(theta, device, dtype, requires_grad=True), on.glaciers)
        return [g.detach().double().cpu() for g in grads]

    def err(a, b):
        return max(float((x - y).abs().max() / y.abs().max()) for x, y in zip(a, b))

    discrete = DiscreteAdjoint(VJP_method=DiscreteVJP())
    cases = [("SI", "ic", discrete, "cpu"), ("RKC", "ic", discrete, "jax"),
             ("RKC", "aggregate", discrete, "jax"),
             ("SI", "ic", ContinuousAdjoint(VJP_method=DiscreteVJP()), "cpu")]
    f32, f64 = torch.float32, torch.float64
    for solver, kind, adjoint, against in cases:
        t0 = time.perf_counter()
        inv, _, _, _, facts = training_problem(solver, "jax", n_g=N_G,
                                               tspan=(5.0, 5.0 + 2.0 / 12.0), dtype=f64,
                                               kind=kind)
        glaciers = inv.glaciers.to(dtype=f32)
        theta = _tree_to(inv.theta, "cuda", f32)
        k64 = gradient(inv, theta, adjoint, "cuda", f64)
        k32 = gradient(inv, theta, adjoint, "cuda", f32)
        p32 = gradient(inv, theta, adjoint, "cpu", f32)
        ref = (gradient(inv, theta, "jax", "cuda", f64) if against == "jax"
               else gradient(inv, theta, adjoint, "cpu", f64))
        row = {"phase": "check_classical_grad", "kind": kind, "solver": solver,
               "adjoint": type(adjoint).__name__, "theta": list(inv.theta),
               "against": "card grad='jax' float64" if against == "jax" else "CPU float64",
               "glaciers": N_G, "grid": [NX, NY], "intervals": 2,
               "float64_rel_err": err(k64, ref), "tol": TOL_CLASSICAL_F64,
               "float32_rel_err": err(k32, ref), "f32_plain_rel_err": err(p32, ref),
               "float32_vs_f32_plain_rel_err": err(k32, p32),
               "factor": GRAD_F32_FACTOR, "seconds": time.perf_counter() - t0}
        row.update({k: v for k, v in facts.items() if k != "ground_truth_s"})
        emit(row)
        if not (row["float64_rel_err"] <= TOL_CLASSICAL_F64
                and all(torch.isfinite(g).all() and g.abs().max() > 0 for g in k32)
                and row["float32_rel_err"] <= GRAD_F32_FACTOR * row["f32_plain_rel_err"]):
            raise AssertionError(f"{kind} {solver} {type(adjoint).__name__}: the classical "
                                 f"inversion's gradient on the card disagrees: {row}")


def f32_attribution(samples=6):
    """``python3 chip_smoke.py --f32-attribution``: the float32 gradient
    check of the hybrid-D target through SI by autograd
    (check_law_target_gradients' Y / SI / jax case: 4 x 128^2, 2 months,
    the data in float32), taken apart on the card and on the CPU. For
    ``samples`` starts theta * (1 + j 2^-16), j = 0, 1, ..., each exact in
    float32, every gradient is held to the CPU float64 gradient at the same
    theta, per theta leaf: the whole solve in float32 on both devices (and
    on the CPU again on one thread, another summation order); then each
    stage in turn in float32 inside a float64 solve ("f32_only"), and in
    float64 inside a float32 solve ("f64_only"). The stages: the MLP, its
    postscale head, the hybrid diffusivity's algebra, the frozen-D geometry
    (H-bar and |grad S| from H), the PCG recursion (its vectors and inner
    products; the operator in the solve's dtype), its inner products alone,
    the operator's div(D grad u), the thickness loss, and (f32_only) all of
    them together. One JSON line per stage and start, then one summary line
    per stage: the card's error over the CPU's, median and range."""
    import contextlib

    from odinn_tpu_torch.core.params import UDEParameters
    from odinn_tpu_torch.losses import losses
    from odinn_tpu_torch.models import nn as nn_mod
    from odinn_tpu_torch.ops import si_math
    from odinn_tpu_torch.ops import stencils as st
    from odinn_tpu_torch.physics.targets import DHybridTarget
    from odinn_tpu_torch.simulation import implicit
    from odinn_tpu_torch.simulation.inversion import Inversion, _tree_map

    f32, f64 = torch.float32, torch.float64

    def caster(dtype):
        return lambda x: (x.to(dtype) if isinstance(x, torch.Tensor) and x.is_floating_point()
                          else x)

    orig = {"mlp": nn_mod.mlp_apply, "post": nn_mod.postscale,
            "diff": DHybridTarget.diffusivity, "cg": si_math.cg, "dot": si_math.dot,
            "div": si_math.div_flux, "loss": losses.simple_loss}

    def stage_patches(inner, outer):
        """Each stage computed in ``inner``'s dtype, its results handed on in
        ``outer``'s."""

        def mlp(arch, params, x):
            return outer(orig["mlp"](arch, _tree_map(inner, params), inner(x)))

        def diffusivity(self, vals, hbar, grad_s, phys):
            v = dataclasses.replace(vals, **{f.name: inner(getattr(vals, f.name))
                                             for f in dataclasses.fields(vals)})
            return outer(orig["diff"](self, v, inner(hbar), inner(grad_s), phys))

        def geometry(H, B, dx, dy, values_fn, target, phys):
            Hc = st.relu_strict(inner(H))
            gsx, gsy = st.grad_slope(inner(B) + Hc, inner(dx), inner(dy))
            hbar, grad_s = outer(st.avg(Hc)), outer(st.safe_norm(gsx, gsy))
            return target.diffusivity(values_fn(hbar, grad_s), hbar, grad_s, phys).to(H.dtype)

        def cg(matvec, b, x0, iters, precond=None):
            pre = None if precond is None else (lambda r: inner(precond(outer(r))))
            return outer(orig["cg"](lambda u: inner(matvec(outer(u))), inner(b), inner(x0),
                                    iters, pre))

        return {
            "mlp": [(nn_mod, "mlp_apply", mlp)],
            "postscale": [(nn_mod, "postscale", lambda y, m: outer(orig["post"](inner(y), m)))],
            "hybrid_diffusivity": [(DHybridTarget, "diffusivity", diffusivity)],
            "frozen_D_geometry": [(implicit, "_frozen_diffusivity", geometry)],
            "pcg": [(si_math, "cg", cg)],
            "pcg_dot": [(si_math, "dot", lambda a, b: outer(orig["dot"](inner(a), inner(b))))],
            "div_flux": [(si_math, "div_flux", lambda u, D, dx, dy: outer(orig["div"](
                inner(u), inner(D), inner(dx), inner(dy))))],
            "loss": [(losses, "simple_loss", lambda cfg, a, b, m, n: outer(orig["loss"](
                cfg, inner(a), inner(b), m, inner(n))))],
        }

    f32_only = stage_patches(caster(f32), caster(f64))
    f32_only["all_listed"] = [p for k, v in f32_only.items() if k != "pcg_dot" for p in v]
    f64_only = stage_patches(caster(f64), caster(f32))

    @contextlib.contextmanager
    def patched(items):
        saved = [(obj, name, getattr(obj, name)) for obj, name, _ in items]
        try:
            for obj, name, fn in items:
                setattr(obj, name, fn)
            yield
        finally:
            for obj, name, fn in saved:
                setattr(obj, name, fn)

    inv, model, _, _, _ = training_problem("SI", "jax", n_g=N_G, tspan=(5.0, 5.0 + 2.0 / 12.0),
                                           dtype=f64, kind="Y")
    params = inv.parameters.replace(UDE=UDEParameters(grad="jax"))
    glaciers = inv.glaciers.to(dtype=f32)   # the data of the check, float32 on both sides
    names = [f"{slot}[{i}].{k}" for slot in inv.theta for i, layer in enumerate(inv.theta[slot])
             for k in layer]

    def gradient(theta, device, dtype):
        on = Inversion(model=model, glaciers=glaciers.to(device, dtype), parameters=params,
                       device=device, theta=_tree_to(theta, device, dtype))
        vg, _ = grad_fn(on, params)
        loss, grads = vg(_tree_to(theta, device, dtype, requires_grad=True), on.glaciers)
        return float(loss), [g.detach().double().cpu() for g in grads]

    def errs(a, b):
        return [float((x - y).abs().max() / y.abs().max().clamp(min=1e-300))
                for x, y in zip(a, b)]

    threads = torch.get_num_threads()
    runs = [("float32", "all", f32, [])]
    runs += [(stage, "f32_only", f64, items) for stage, items in f32_only.items()]
    runs += [(stage, "f64_only", f32, items) for stage, items in f64_only.items()]
    ratios = {}
    for j in range(samples):
        theta = _tree_map(lambda x: (x.double() * (1.0 + j * 2.0 ** -16)).float(), inv.theta)
        ref_loss, ref = gradient(theta, "cpu", f64)
        for stage, how, dtype, items in runs:
            row = {"phase": "f32_attribution", "stage": stage, "how": how, "sample": j,
                   "leaves": names}
            with patched(items):
                for device in ("cuda", "cpu"):
                    loss, g = gradient(theta, device, dtype)
                    row[f"{device}_leaf_rel_err"] = errs(g, ref)
                    row[f"{device}_rel_err"] = max(row[f"{device}_leaf_rel_err"])
                    row[f"{device}_loss_rel_err"] = abs(loss - ref_loss) / abs(ref_loss)
            if how == "all":
                torch.set_num_threads(1)
                try:
                    _, g = gradient(theta, "cpu", dtype)
                finally:
                    torch.set_num_threads(threads)
                row["cpu_1thread_leaf_rel_err"] = errs(g, ref)
                row["cpu_1thread_rel_err"] = max(row["cpu_1thread_leaf_rel_err"])
            row["card_over_cpu"] = row["cuda_rel_err"] / max(row["cpu_rel_err"], 1e-300)
            ratios.setdefault((stage, how), []).append(row)
            emit(row)
    for (stage, how), rows in ratios.items():
        r = [row["card_over_cpu"] for row in rows]
        emit({"phase": "f32_attribution_summary", "stage": stage, "how": how,
              "samples": len(r), "card_over_cpu_median": statistics.median(r),
              "card_over_cpu_min": min(r), "card_over_cpu_max": max(r),
              "cuda_rel_err_median": statistics.median(x["cuda_rel_err"] for x in rows),
              "cpu_rel_err_median": statistics.median(x["cpu_rel_err"] for x in rows),
              "cpu_threads": threads, "allow_tf32": torch.backends.cuda.matmul.allow_tf32})


# ---------------------------------------------------------------------------
# Phase 9: the tolerance contract
# ---------------------------------------------------------------------------

def lm_jvps(iters, cg_iters, probes=LM_PROBES, refresh=5, restarts=1, precond=True):
    """J·v products of ``lm_train``: the probes of each diagonal estimate
    (one at the start, one every ``refresh`` iterations with the Jacobi
    preconditioner) and each iteration's CG matvecs (a round's iterations,
    and one more a restart)."""
    estimates = 1 + (sum(1 for it in range(1, iters) if it % max(refresh, 1) == 0)
                     if precond else 0)
    per_round = max(cg_iters // restarts, 1)
    return probes * estimates + iters * (restarts * per_round + restarts - 1)


def lm_phase(solver):
    """The LM stage on the training batch (16 x 128^2, float32, 24
    intervals): A = NN(T) by Adam (LM_EPOCHS[0] epochs), then LM_EPOCHS[1]
    Levenberg-Marquardt iterations (gn_cg_iters LM_CG, Jacobi-preconditioned,
    LM_PROBES probes) through SI at PCG-20 or RKC at s = 8. Asserts finite
    losses, a monotone LM trace, si_step = 24 x solves (SI), and the tangent
    kernels' launches: si_step_tangent = 24 x J·v products (SI), and
    sia2d_rhs_jvp = 24 x s x J·v products (RKC: s stage launches a step's
    tangent). Then times lm_train alone from the trained θ: one call of one
    iteration (its diagonal estimate, the iteration and the trailing
    evaluation) with its device busy time, idle share and launches, and one
    more iteration (two iterations less one). Returns the run's launches."""
    from odinn_tpu_torch.inverse.gauss_newton import lm_train, make_residual_fn
    from odinn_tpu_torch.simulation.inversion import run_inversion

    inv, model, params, tstops, facts = training_problem(solver, "jax")
    params = params.replace(hyper=dataclasses.replace(
        params.hyper, optimizer=("adam", "lm"), learning_rate=(0.05, 1e-3), epochs=LM_EPOCHS,
        gn_cg_iters=LM_CG))
    inv.parameters = params
    n_int = len(tstops) - 1
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    results = run_inversion(inv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    stats = results.stats
    losses = stats.losses
    jvps = lm_jvps(LM_EPOCHS[1], LM_CG)
    expected = {"si_step_tangent": n_int * jvps if solver == "SI" else 0,
                "sia2d_rhs_jvp": n_int * facts.get("rkc_stages", 0) * jvps}
    if solver == "SI":
        expected["si_step"] = n_int * stats.solves
    lm_trace = losses[LM_EPOCHS[0]:]
    resid = make_residual_fn(model, params, tstops)
    theta = _tree_to(inv.theta, "cuda", None)
    run = lambda iters: lm_train(theta, inv.glaciers, resid, iters=iters, cg_iters=LM_CG)
    one_ms, two_ms = row_ms(lambda: run(1), reps=3), row_ms(lambda: run(2), reps=3)
    busy_ms, dev_launches, by_name = device_profile(lambda: run(1), 1)
    row = dict({"phase": "lm_training", "solver": solver, "glaciers": N_TRAIN,
                "grid": [NX, NY], "dtype": "torch.float32", "intervals": n_int,
                "adam_epochs": LM_EPOCHS[0], "lm_iterations": LM_EPOCHS[1], "gn_cg_iters": LM_CG,
                "jvps": jvps, "run_inversion_s": train_s, "losses": losses,
                "lm_trace": lm_trace, "final_loss": stats.final_loss, "solves": stats.solves,
                "launches": launches, "expected_launches": expected,
                "lm_train_1_iteration_ms": one_ms, "lm_iteration_ms": two_ms - one_ms,
                "lm_train_1_iteration_device_busy_ms": busy_ms,
                "lm_train_1_iteration_device_idle_share": 1.0 - busy_ms / one_ms,
                "lm_train_1_iteration_device_launches": dev_launches,
                "lm_train_1_iteration_launches_by_kernel": {
                    k: v for k, v in by_name.items() if k in KERNEL_NAMES}}, **facts)
    emit(row)
    if any(launches[k] != v for k, v in expected.items()):
        raise AssertionError(f"LM {solver}: launches {launches}, expected {expected}")
    if not (np.isfinite(losses).all()
            and all(b <= a for a, b in zip(lm_trace, lm_trace[1:]))):
        raise AssertionError(f"LM {solver}: losses not finite or LM trace not monotone: "
                             f"{losses}")
    return launches


def lm_gate_phase(device="cuda"):
    """tests/test_gauss_newton.py::test_lm_collapses_loss_after_adam on the
    card: 2 Halfar glaciers of 36^2 (dx 120 m, -15 and -22 C), 12 monthly
    intervals, RK4 at 15 substeps, float64, A = NN(T) (the light net from
    the JAX test's initial θ, LM_GATE_THETA), Adam LM_GATE_EPOCHS[0] epochs
    (lr 0.05), then LM_GATE_EPOCHS[1] LM iterations (λ0 1e-3) on the JAX
    test's Rademacher probes
    (LM_GATE_PROBES, in place of the port's draw for this run). Its
    gates: the LM stage gains at least 15x over its start, its trace is
    monotone, and A is within 15 % of Cuffey-Paterson at both
    temperatures; every RK4 stage's tangent is one sia2d_rhs_jvp launch.
    Returns the run's launches."""
    from odinn_tpu_torch.core.params import (
        Hyperparameters, Parameters, PhysicalParameters, SimulationParameters,
        SolverParameters, UDEParameters)
    from odinn_tpu_torch.data.synthetic import halfar_glacier
    from odinn_tpu_torch.inverse import gauss_newton
    from odinn_tpu_torch.laws.laws import CuffeyPaterson, LawA, eval_law, poly_A_paterson_cuffey
    from odinn_tpu_torch.models.model import Model, SIA2DModel
    from odinn_tpu_torch.models.nn import NeuralNetwork, default_architecture
    from odinn_tpu_torch.simulation.inversion import Inversion, run_inversion
    from odinn_tpu_torch.simulation.prediction import generate_ground_truth
    from odinn_tpu_torch.simulation.solver import build_tstops

    tspan, substeps, epochs = (5.0, 6.0), 15, LM_GATE_EPOCHS
    params = Parameters(
        physical=PhysicalParameters(min_A=8e-21, max_A=8e-18),
        simulation=SimulationParameters(tspan=tspan, use_MB=False, test_mode=True,
                                        float_dtype="float64"),
        solver=SolverParameters(step=1.0 / 12.0, substeps=substeps),
        hyper=Hyperparameters(optimizer=("adam", "lm"), learning_rate=(0.05, 1e-3),
                              epochs=epochs, batch_size=8),
        UDE=UDEParameters(grad="jax", target="A"))
    temps = (-15.0, -22.0)
    glaciers = [halfar_glacier(nx=36, ny=36, dx=120.0, temp=t, rgi_id=f"gn-{i + 1}",
                               device=device, dtype=torch.float64)
                for i, t in enumerate(temps)]
    tstops = build_tstops(tspan, params.solver.step)
    glaciers = generate_ground_truth(glaciers, params, Model(iceflow=SIA2DModel(
        A=CuffeyPaterson())), tstops, store=("H",), device=device)
    model = Model(iceflow=SIA2DModel(A=LawA(NeuralNetwork(default_architecture(1, light=True),
                                                          seed=666), params)))
    theta = {"A": [{"w": torch.tensor(w, dtype=torch.float64, device=device),
                    "b": torch.tensor(b, dtype=torch.float64, device=device)}
                   for w, b in LM_GATE_THETA]}
    inv = Inversion(model=model, glaciers=glaciers, parameters=params, theta=theta,
                    device=device)
    estimates = []

    def jax_probes(gen, th, n):
        """The next diagonal estimate's probes of LM_GATE_PROBES."""
        signs = LM_GATE_PROBES[len(estimates)]
        estimates.append(n)
        out = []
        for probe in signs[:n]:
            it = iter(1.0 if c == "+" else -1.0 for c in probe)
            layers = []
            for layer in th["A"]:
                b = torch.tensor([next(it) for _ in range(layer["b"].numel())])
                w = torch.tensor([next(it) for _ in range(layer["w"].numel())])
                layers.append({"w": w.reshape(layer["w"].shape).to(layer["w"]),
                               "b": b.reshape(layer["b"].shape).to(layer["b"])})
            out.append({"A": layers})
        return out

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    draw = gauss_newton._draw_probes
    gauss_newton._draw_probes = jax_probes
    t0 = time.perf_counter()
    try:
        res = run_inversion(inv)
    finally:
        gauss_newton._draw_probes = draw
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    losses = res.stats.losses
    lm_start, lm_trace = losses[epochs[0]], losses[epochs[0]:]
    n_int = len(tstops) - 1
    jvps = lm_jvps(epochs[1], params.hyper.gn_cg_iters)
    expected_jvp = n_int * substeps * 4 * jvps
    a_true = poly_A_paterson_cuffey()
    a_rel = []
    for g, temp in enumerate(temps):
        a_nn = float(eval_law(model.iceflow.A, inv.theta, glaciers[g], glacier_idx=g))
        a_ref = float(a_true(torch.tensor(temp, dtype=torch.float64)))
        a_rel.append(abs(a_nn - a_ref) / a_ref)
    row = {"phase": "lm_gates", "glaciers": 2, "grid": [36, 36], "solver": "RK4",
           "substeps": substeps, "dtype": "torch.float64", "intervals": n_int,
           "adam_epochs": epochs[0], "lm_iterations": epochs[1], "seconds": seconds,
           "lm_start": lm_start, "final_loss": res.stats.final_loss,
           "gain": lm_start / res.stats.final_loss, "lm_trace": lm_trace,
           "A_rel_err": dict(zip(map(str, temps), a_rel)), "launches": launches,
           "expected_sia2d_rhs_jvp": expected_jvp, "jvps": jvps,
           "diag_estimates": len(estimates)}
    emit(row)
    if not (np.isfinite(losses).all() and res.stats.final_loss < lm_start / 15.0):
        raise AssertionError(f"LM gates: gain below 15x or losses not finite: {row}")
    if not all(b <= a * (1 + 1e-12) for a, b in zip(lm_trace, lm_trace[1:])):
        raise AssertionError(f"LM gates: the LM trace is not monotone: {row}")
    if not all(e < 0.15 for e in a_rel):
        raise AssertionError(f"LM gates: A not within 15 % of the truth: {row}")
    if device == "cuda" and launches["sia2d_rhs_jvp"] != expected_jvp:
        raise AssertionError(f"LM gates: sia2d_rhs_jvp launches {launches['sia2d_rhs_jvp']}, "
                             f"expected {expected_jvp}")
    return launches


def lm_gates_worker(argv) -> int:
    """Phase 10's LM gates in a process of their own (``python3
    chip_smoke.py --lm-gates-worker DIR``, as :func:`start_side` starts
    it): :func:`lm_gate_phase` on the card, its line on stdout and its
    launches in DIR/launches.json."""
    return _side_worker(argv, "--lm-gates-worker", lm_gate_phase)


def icesheet_worker(argv) -> int:
    """Phase 15 in a process of its own (``python3 chip_smoke.py
    --icesheet-worker DIR``): :func:`icesheet_phase` on the card, its lines
    on stdout, its launches in DIR/launches.json (the large-plane path's
    under ``si_plane`` alone, the large-plane pullback's under
    ``si_plane_vjp`` alone)."""
    def phase():
        launches, plane, plane_vjp = icesheet_phase()
        # every si_step launch of the phase ran csrc/si_plane.cu, and every
        # pullback csrc/si_plane_vjp.cu: each counts there alone, not again
        # under si_step (csrc/si_step.cu) or si_step_vjp (csrc/si_step_vjp.cu)
        moved = ("si_step", "si_step_transpose", "si_step_tangent")
        if (sum(launches[k] for k in moved) != plane
                or launches["si_step_vjp"] != plane_vjp):
            raise AssertionError(f"icesheet: {plane} large-plane launches and {plane_vjp} "
                                 f"large-plane pullbacks, but the wrappers counted "
                                 f"{[launches[k] for k in moved + ('si_step_vjp',)]}")
        return dict(launches, si_plane=plane, si_plane_vjp=plane_vjp, si_step_vjp=0,
                    **{k: 0 for k in moved})

    return _side_worker(argv, "--icesheet-worker", phase)


def _side_worker(argv, flag, phase) -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = argv[argv.index(flag) + 1]
    launches = phase()
    with open(os.path.join(out_dir, "launches.json"), "w") as fh:
        json.dump(launches, fh)
    return 0


def start_side(flag):
    """Start ``python3 chip_smoke.py FLAG DIR`` in a process of its own
    (:func:`lm_gates_worker`, :func:`icesheet_worker`); its log and
    launches go to a directory of its own. The LM gates hold one CPU core
    and leave the card idle most of the time (~190-245 s of host-bound LM
    iterations at 2 x 36^2); phase 15 holds the card for ~20 s. Both run
    beside phase 3's gradient checks, forward mode's gradient checks and
    the multi-process phases 12-14, whose ranks are host-bound too, after
    the phases whose device times they would disturb. Returns (process,
    directory)."""
    import tempfile

    out_dir = tempfile.mkdtemp(prefix="side_")
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(out_dir, "log"), "w") as log:
        proc = subprocess.Popen(
            [sys.executable, os.path.join(here, "chip_smoke.py"), flag, out_dir],
            cwd=here, stdout=log, stderr=subprocess.STDOUT, text=True)
    return proc, out_dir


def join_side(side, what) -> dict:
    """Wait for a side process (at most LM_GATE_TIMEOUT seconds from now),
    print its output (the ``lm_gates`` or ``icesheet`` lines) and return its
    launches; raise when it failed or timed out."""
    proc, out_dir = side
    try:
        rc = proc.wait(timeout=LM_GATE_TIMEOUT)
    except subprocess.TimeoutExpired:
        rc = None
    with open(os.path.join(out_dir, "log")) as fh:
        out = fh.read()
    sys.stdout.write(out)
    sys.stdout.flush()
    if rc != 0:
        raise AssertionError(f"{what}: the side process "
                             f"{'timed out' if rc is None else f'exited with {rc}'}")
    with open(os.path.join(out_dir, "launches.json")) as fh:
        return json.load(fh)


def stop_side(side) -> None:
    """End a side process if it still runs, and remove its directory."""
    import shutil

    proc, out_dir = side
    if proc.poll() is None:
        proc.kill()
    proc.wait()
    shutil.rmtree(out_dir, ignore_errors=True)


def forward_grad_phase():
    """grad="forward" of the classical per-glacier A (LawA_inversion, one
    θ entry a glacier) through SI (PCG-20) and RKC: float64 on a cut
    problem (4 x 128^2, 2 months), where the card's gradient equals the
    CPU's forward-mode gradient (plain versions) and the card's grad="jax"
    gradient to TOL_GRAD_F64 (through SI at PCG-20 forward mode takes the
    tangent solve and reverse mode the transpose solve, two contracts that
    meet where PCG has converged, as it has there to well within the
    tolerance); float32 on the training batch (16 x 128^2, 24 intervals),
    within GRAD_F32_FACTOR times the CPU float32 forward gradient's error
    against the card's float64 one at the same data, with the launches
    (a solve of the kernel per interval and its tangent kernels: 24
    si_step_tangent, or 24 x (s + 1) for RKC's rkc_interval and 24 x s
    sia2d_rhs_jvp), and the Adam epoch by forward mode timed and profiled.
    Returns the launches of the float32 gradients."""
    from odinn_tpu_torch.simulation.inversion import Inversion

    counters = kernel_counters()
    total = {k: 0 for k in counters}
    for solver in ("SI", "RKC"):
        inv, model, params, tstops, facts = training_problem(
            solver, "forward", n_g=N_G, tspan=(5.0, 5.0 + 2.0 / 12.0), dtype=torch.float64,
            kind="classical")
        theta = _tree_to(inv.theta, "cuda", None)
        theta["A"] = theta["A"] + 0.3
        g_card = grad_fn(inv, params)[0](theta, inv.glaciers)[1][0]
        cpu_inv = Inversion(model=inv.model, glaciers=inv.glaciers.to("cpu"), parameters=params,
                            theta=_tree_to(theta, "cpu", None), device="cpu")
        g_cpu = grad_fn(cpu_inv, params)[0](cpu_inv.theta, cpu_inv.glaciers)[1][0]
        jparams = params.replace(UDE=dataclasses.replace(params.UDE, grad="jax"))
        g_jax = grad_fn(inv, jparams)[0](_tree_to(theta, "cuda", None, requires_grad=True),
                                         inv.glaciers)[1][0]
        torch.cuda.synchronize()
        row = {"phase": "forward_grad_check", "solver": solver, "glaciers": N_G,
               "grid": [NX, NY], "dtype": "torch.float64", "intervals": len(tstops) - 1,
               "rel_err_vs_cpu_forward": rel_err(g_card.cpu(), g_cpu),
               "rel_err_vs_card_jax": rel_err(g_card, g_jax), "tol": TOL_GRAD_F64}
        emit(row)
        ok = (row["rel_err_vs_cpu_forward"] <= TOL_GRAD_F64
              and row["rel_err_vs_card_jax"] <= TOL_GRAD_F64 and torch.isfinite(g_card).all())
        if not ok:
            raise AssertionError(f"grad='forward' {solver}: {row}")
        # float32 at full width, at the float64 problem's data
        inv64, model, params, tstops, facts = training_problem(
            solver, "forward", dtype=torch.float64, kind="classical")
        theta64 = _tree_to(inv64.theta, "cuda", None)
        theta64["A"] = theta64["A"] + 0.3
        params32 = params.replace(simulation=dataclasses.replace(params.simulation,
                                                                 float_dtype="float32"))
        inv32 = Inversion(model=inv64.model, glaciers=inv64.glaciers.to(dtype=torch.float32),
                    parameters=params32, theta=_tree_to(theta64, "cuda", torch.float32),
                    device="cuda")
        g64 = grad_fn(inv64, params)[0](theta64, inv64.glaciers)[1][0]
        for fn in counters.values():
            fn.launches = 0
        g32 = grad_fn(inv32, params32)[0](inv32.theta, inv32.glaciers)[1][0]
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        cpu32 = Inversion(model=inv64.model, glaciers=inv32.glaciers.to("cpu"), parameters=params32,
                    theta=_tree_to(inv32.theta, "cpu", None), device="cpu")
        g32_cpu = grad_fn(cpu32, params32)[0](cpu32.theta, cpu32.glaciers)[1][0]
        n_int = len(tstops) - 1
        s_ = facts.get("rkc_stages", 0)
        expected = {k: 0 for k in counters}
        if solver == "SI":
            expected.update(si_step=n_int, si_step_tangent=n_int)
        else:
            expected.update(rkc_interval=n_int * 2, sia2d_rhs_jvp=n_int * s_)
        for k, v in launches.items():
            total[k] += v
        prof = epoch_profile(adam_epoch_fn(inv32, inv32.model, params32, tstops))
        row = dict({"phase": "forward_grad", "solver": solver, "glaciers": N_TRAIN,
                    "grid": [NX, NY], "dtype": "torch.float32", "intervals": n_int,
                    "rel_err_vs_card_f64": rel_err(g32, g64),
                    "f32_plain_rel_err_vs_card_f64": rel_err(g32_cpu, g64.cpu()),
                    "factor": GRAD_F32_FACTOR, "launches": launches,
                    "expected_launches": expected}, **facts, **prof)
        emit(row)
        if launches != expected:
            raise AssertionError(f"grad='forward' {solver}: launches {launches}, "
                                 f"expected {expected}")
        if not (torch.isfinite(g32).all() and row["rel_err_vs_card_f64"]
                <= GRAD_F32_FACTOR * row["f32_plain_rel_err_vs_card_f64"]):
            raise AssertionError(f"grad='forward' {solver} float32: {row}")
    return total


def _with_solver(params, **kw):
    return params.replace(solver=dataclasses.replace(params.solver, **kw))


def _adaptive_counts():
    """The adaptive integrator's host counters, set to 0."""
    from odinn_tpu_torch.simulation.solver import integrate_adaptive

    integrate_adaptive.rhs_evals = integrate_adaptive.host_reads = 0
    return integrate_adaptive


def _leaf_errs(a, b):
    """Each θ leaf's max|a − b| / max|b|, the worst of them."""
    return max(float((x - y).abs().max() / y.abs().max().clamp(min=1e-300))
               for x, y in zip(a, b))


def _whole_err(a, b):
    """max|a − b| / max|b| over all θ leaves together."""
    a, b = torch.cat([x.flatten() for x in a]), torch.cat([x.flatten() for x in b])
    return float((a - b).abs().max() / b.abs().max())


def check_replay_gradient():
    """The replay gradient on the card (4 Halfar glaciers, 128^2, 2 monthly
    intervals, A = NN(T) at its initial θ, adaptive="replay" at reltol
    TOL_RELTOL): one schedule, recorded on the CPU in float64, replayed by
    autograd on the card and the CPU in both dtypes; held to the CPU's
    float64 gradient, float64 to TOL_GRAD_F64 in each θ leaf and float32
    within GRAD_F32_FACTOR times the CPU's float32 error over the whole θ,
    as check_adjoint_gradients holds it: here the float32 errors are ~1e-7,
    one rounding, and a single leaf's ratio of two such draws ranged 0.6 to
    2.3 over six starts on an H100 (the whole θ's 0.6 to 1.25)."""
    from odinn_tpu_torch.simulation.inversion import Inversion
    from odinn_tpu_torch.simulation.prediction import resolve_replay

    t0 = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    inv, model, params, tstops, _ = training_problem("RKC", "jax", n_g=N_G,
                                                     tspan=(5.0, 5.0 + 2.0 / 12.0), dtype=f64)
    glaciers = inv.glaciers.to(dtype=f32)   # the check's data, float32 on both sides
    theta = _tree_to(inv.theta, "cpu", f32)
    params = resolve_replay(_with_solver(params, adaptive="replay", reltol=TOL_RELTOL),
                            glaciers.to("cpu", f64), model, _tree_to(theta, "cpu", f64), tstops)

    def gradient(device, dtype):
        on = Inversion(model=model, glaciers=glaciers.to(device, dtype), parameters=params,
                       device=device, theta=_tree_to(theta, device, dtype))
        vg, _ = grad_fn(on, params)
        _, grads = vg(_tree_to(theta, device, dtype, requires_grad=True), on.glaciers)
        return [g.detach().double().cpu() for g in grads]

    ref = gradient("cpu", f64)
    k32, p32 = gradient("cuda", f32), gradient("cpu", f32)
    row = {"phase": "check_replay_grad", "glaciers": N_G, "grid": [NX, NY], "intervals": 2,
           "reltol": TOL_RELTOL, "accepted_steps": int(np.count_nonzero(params.solver.replay_dts)),
           "against": "CPU float64", "float64_rel_err": _leaf_errs(gradient("cuda", f64), ref),
           "tol": TOL_GRAD_F64, "float32_rel_err": _whole_err(k32, ref),
           "f32_plain_rel_err": _whole_err(p32, ref),
           "float32_leaf_rel_err": _leaf_errs(k32, ref),
           "f32_plain_leaf_rel_err": _leaf_errs(p32, ref),
           "factor": GRAD_F32_FACTOR, "seconds": time.perf_counter() - t0}
    emit(row)
    if not (row["float64_rel_err"] <= TOL_GRAD_F64
            and row["float32_rel_err"] <= GRAD_F32_FACTOR * row["f32_plain_rel_err"]):
        raise AssertionError(f"the replay gradient on the card disagrees: {row}")


def tolerance_adaptive_row():
    """Phase 9a: the main path's scenario (4 x 128^2, 5 years, monthly saves
    and mass balance, Cuffey-Paterson A(T), float32) through run_prediction
    with adaptive=True at reltol TOL_RELTOL, on the kernels, with the launch
    counters and the integrator's counters set to 0 just before: the
    sia2d_rhs launches must equal the integrator's RHS evaluations. The
    row's accepted steps, recorded by the same solve run again with its
    statistics (the same trajectory, asserted), replayed in float64 and in
    float32 on the unfused path: the row's final H within 2x the float32
    replay's error against the float64 replay. The row's accepted total
    within 2 % of the float64 unfused adaptive row's: at reltol 1e-4 the
    float32 state's own rounding (~1e-4 of H over the row) is at the
    tolerance, so float32 totals are a draw around the float64 one (on an
    H100, 261 to 271 around 265 for starts H0 (1 + j 2^-20), on either
    path and device; float64 265 at every start); the float32 unfused
    row's total is printed beside it. Returns the launches."""
    from odinn_tpu_torch.core.glacier import stack_glaciers
    from odinn_tpu_torch.laws.laws import CuffeyPaterson
    from odinn_tpu_torch.models.model import Model, SIA2DModel
    from odinn_tpu_torch.physics.mass_balance import TImodel1
    from odinn_tpu_torch.simulation.prediction import (
        Prediction, forward_batch, forward_glacier, run_prediction)
    from odinn_tpu_torch.simulation.solver import build_tstops

    tstops = build_tstops(TSPAN, 1.0 / 12.0)
    params = bench_params(adaptive=True, reltol=TOL_RELTOL)
    model = Model(iceflow=SIA2DModel(A=CuffeyPaterson(), n_value=3.0), mass_balance=TImodel1())
    plain_model = Model(iceflow=SIA2DModel(A=dataclasses.replace(CuffeyPaterson(),
                                                                 callback_freq=None),
                                           n_value=3.0), mass_balance=TImodel1())
    batch32 = stack_glaciers(bench_glaciers(torch.float32), device="cuda")
    batch64 = stack_glaciers(bench_glaciers(torch.float64), device="cuda")
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    counts = _adaptive_counts()
    pred = Prediction(model=model, glaciers=bench_glaciers(torch.float32), parameters=params,
                      device="cuda")
    t0 = time.perf_counter()
    H = run_prediction(pred)["H"]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    rhs_evals, host_reads = counts.rhs_evals, counts.host_reads
    expected = dict({k: 0 for k in counters}, sia2d_rhs=rhs_evals)

    record = {}
    traj, nacc = forward_glacier(None, batch32, model, params, tstops, _return_stats=True,
                                 _record=record)
    _, nacc2, dts = forward_glacier(None, batch32, model, params, tstops, _return_stats=True,
                                    _return_dts=int(nacc.max()))
    same = torch.equal(traj.movedim(0, 1), H) and torch.equal(nacc, nacc2)
    dts = dts.cpu().numpy()
    replay = _with_solver(params, adaptive="replay", replay_dts=dts)
    rp64 = forward_batch(None, batch64, plain_model, replay, tstops, device="cuda")
    rp32 = forward_batch(None, batch32, plain_model, replay, tstops, device="cuda")
    _, plain_nacc = forward_glacier(None, batch32, plain_model, params, tstops,
                                    _return_stats=True)
    _, plain64_nacc = forward_glacier(None, batch64, plain_model, params, tstops,
                                      _return_stats=True)
    nacc, trials = nacc.cpu().numpy(), record["trials"].cpu().numpy()
    total, plain_total, total64 = (int(nacc.sum()), int(plain_nacc.sum()),
                                   int(plain64_nacc.sum()))
    row = {"phase": "tolerance_adaptive_row", "glaciers": N_G, "grid": [NX, NY],
           "dtype": "torch.float32", "reltol": TOL_RELTOL, "intervals": len(tstops) - 1,
           "launches": launches, "expected_launches": expected, "rhs_evals": rhs_evals,
           "host_reads": host_reads, "run_prediction_s": seconds,
           "accepted_total": total, "accepted_per_interval_sum": nacc.sum(axis=0).tolist(),
           "accepted_per_interval_max": nacc.max(axis=0).tolist(),
           "accepted_min_per_glacier_interval": int(nacc.min()),
           "rejected_trials": int((trials - nacc).sum()),
           "batch_trial_steps": int(trials.max(axis=0).sum()),
           "plain_accepted_total": plain_total, "f64_plain_accepted_total": total64,
           "stats_run_is_the_row": same,
           "final_H_rel_err_vs_f64_replay": rel_err(H[:, -1], rp64[:, -1]),
           "f32_plain_replay_rel_err_vs_f64_replay": rel_err(rp32[:, -1], rp64[:, -1])}
    row["ms"] = row_ms(lambda: forward_batch(None, batch32, model, params, tstops,
                                             device="cuda"))
    row["plain_ms"] = row_ms(lambda: forward_batch(None, batch32, plain_model, params, tstops,
                                                   device="cuda"), reps=1)
    busy, dev_launches, by_name = device_profile(
        lambda: forward_batch(None, batch32, model, params, tstops, device="cuda"), 1)
    row.update({"device_busy_ms": busy, "device_idle_share": 1.0 - busy / row["ms"],
                "device_launches": dev_launches,
                "kernel_launches_by_name": {k: v for k, v in by_name.items()
                                            if k in KERNEL_NAMES}})
    emit(row)
    if launches != expected:
        raise AssertionError(f"adaptive row: launches {launches}, expected {expected}")
    if not same or tuple(H.shape) != (N_G, len(tstops), NX, NY) or not torch.isfinite(H).all():
        raise AssertionError(f"adaptive row: trajectory misshapen, not finite or not "
                             f"repeatable: {row}")
    if not row["final_H_rel_err_vs_f64_replay"] <= 2.0 * row[
            "f32_plain_replay_rel_err_vs_f64_replay"]:
        raise AssertionError(f"adaptive row: kernel path error exceeds 2x the float32 "
                             f"replay's: {row}")
    if not abs(total - total64) <= 0.02 * total64:
        raise AssertionError(f"adaptive row: accepted total {total} is more than 2 % from the "
                             f"float64 row's {total64}")
    return launches


def _segments(stats, snapshots, final):
    """(substeps, solves, gradients) of each stretch of a training between
    the stage-end re-sizings of stats.substeps_bumps, from the iteration
    callback's (solves, gradients) ``snapshots``: a re-sizing follows its
    stage's last iteration and the stage-end evaluation of the last
    iterate."""
    out, done_s, done_g = [], 0, 0
    for niter, old, _ in stats.substeps_bumps:
        s, g = snapshots[niter]
        s += 1
        out.append((old, s - done_s, g - done_g))
        done_s, done_g = s, g
    out.append((final, stats.solves - done_s, stats.gradients - done_g))
    return out


def tolerance_training(mode, solver):
    """Phases 9b and 9c: run_inversion of A = NN(T) on the training batch
    (16 x 128^2, float32, 24 intervals; :func:`training_problem`, Adam then
    LBFGS) by autograd, with adaptive="replay" through the BS3 replay, or
    substeps="auto" through RKC (s of rkc_stages_for) or SI, at reltol
    TOL_RELTOL; the launch counters and the integrator's counters set to 0
    just before. Launches asserted from the code: the probes' RHS
    evaluations are sia2d_rhs launches (the adaptive integrator's count,
    and for SI the Richardson probes' si_step: 24 x (2 x substeps - 1) at
    PCG-64, then 24 x substeps a cg_iters candidate tried); replay: 3
    sia2d_rhs per sub-step column run (a column some glacier steps in) a
    solve and 3 sia2d_rhs_vjp a column a gradient; RKC: one rkc_interval a
    substep per solve and gradient, s sia2d_rhs_vjp a substep per gradient;
    SI: one si_step a substep per solve, one si_step_transpose and one
    si_step_vjp a substep per gradient. Losses finite and falling; one
    Adam epoch profiled. Returns the launches."""
    from odinn_tpu_torch.simulation import prediction
    from odinn_tpu_torch.simulation.inversion import run_inversion

    inv, model, params, tstops, facts = training_problem(solver)
    kw = dict(adaptive="replay") if mode == "replay" else dict(substeps="auto")
    inv.parameters = _with_solver(params, reltol=TOL_RELTOL, **kw)
    n_int = len(tstops) - 1
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    counts = _adaptive_counts()
    snapshots = {}
    # the sub-step columns each replay runs (a column some glacier steps
    # in), with and without a gradient: a re-recorded schedule changes them
    columns = {"solves": 0, "gradients": 0}
    replay = prediction.integrate_replay

    def counted_replay(rhs, y0, tstops, dts, callback=None):
        run = int(np.count_nonzero(np.any(np.asarray(dts) != 0, axis=0)))
        columns["solves"] += run
        columns["gradients"] += run if torch.is_grad_enabled() else 0
        return replay(rhs, y0, tstops, dts, callback)

    prediction.integrate_replay = counted_replay
    t0 = time.perf_counter()
    try:
        results = run_inversion(inv, callback=lambda st: snapshots.__setitem__(
            st.niter, (st.solves, st.gradients)))
        torch.cuda.synchronize()
    finally:
        prediction.integrate_replay = replay
    train_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    stats, sp = results.stats, inv.parameters.solver
    expected = dict({k: 0 for k in counters}, sia2d_rhs=counts.rhs_evals)
    row = {"phase": "tolerance_training", "mode": mode, "solver": solver, "grad": "jax",
           "glaciers": N_TRAIN, "grid": [NX, NY], "dtype": "torch.float32", "intervals": n_int,
           "reltol": TOL_RELTOL, "probe_rhs_evals": counts.rhs_evals,
           "probe_host_reads": counts.host_reads, "substeps_bumps": stats.substeps_bumps}
    if mode == "replay":
        dts = sp.replay_dts
        expected["sia2d_rhs"] += 3 * columns["solves"]
        expected["sia2d_rhs_vjp"] = 3 * columns["gradients"]
        row.update({"replay_columns_run": columns, "replay_cap": int(dts.shape[-1]),
                    "replay_columns_per_solve": int(np.count_nonzero(np.any(dts != 0, axis=0))),
                    "accepted_total": int(np.count_nonzero(dts))})
    else:
        s = facts.get("rkc_stages", 0)
        per_solve = {"RKC": {"rkc_interval": 1}, "SI": {"si_step": 1}}[solver]
        per_grad = {"RKC": {"rkc_interval": 1, "sia2d_rhs_vjp": s},
                    "SI": {"si_step_transpose": 1, "si_step_vjp": 1}}[solver]
        for n, solves, grads in _segments(stats, snapshots, sp.substeps):
            for name in set(per_solve) | set(per_grad):
                expected[name] += n_int * n * (solves * per_solve.get(name, 0)
                                               + grads * per_grad.get(name, 0))
        row.update({"substeps": sp.substeps, "rkc_stages": s or None})
        if solver == "SI":
            cands = (4, 6, 8, 12, 16, 24, 32, 48)
            tried = cands.index(sp.cg_iters) + 1 if sp.cg_iters in cands else len(cands)
            expected["si_step"] += n_int * ((2 * sp.substeps - 1) + sp.substeps * tried)
            row.update({"cg_iters": sp.cg_iters, "cg_candidates_tried": tried})
    losses = stats.losses
    row.update({"run_inversion_s": train_s, "losses": losses, "final_loss": stats.final_loss,
                "solves": stats.solves, "gradients": stats.gradients, "launches": launches,
                "expected_launches": expected})
    row.update(epoch_profile(adam_epoch_fn(inv, model, inv.parameters, tstops)))
    emit(row)
    what = f"tolerance training {mode} {solver}"
    if launches != expected:
        raise AssertionError(f"{what}: launches {launches}, expected {expected}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{what}: losses not finite or not decreasing: {losses}")
    return launches


def tolerance_phase():
    """Phase 9: the adaptive row, the replay training and the two
    substeps="auto" trainings; returns their launches and prints the
    phase's seconds."""
    t0 = time.perf_counter()
    launches = tolerance_adaptive_row()
    for mode, solver in (("replay", "RKC"), ("auto", "RKC"), ("auto", "SI")):
        for name, n in tolerance_training(mode, solver).items():
            launches[name] += n
    emit({"phase": "tolerance", "seconds": time.perf_counter() - t0, "launches": launches})
    return launches


# ---------------------------------------------------------------------------
# Phase 11: ensembles, EKI and UQ, the member axis folded into the kernels'
# glacier axis
# ---------------------------------------------------------------------------

def _reset(counters):
    for fn in counters.values():
        fn.launches = 0


def _read(counters):
    return {k: fn.launches for k, fn in counters.items()}


def _add(total, launches):
    for k, v in launches.items():
        total[k] += v


def _peak_reset():
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def run_profile(fn, seconds):
    """The profiler's reading of one more call of ``fn`` (after a warm-up
    call): device busy ms, idle share against ``seconds`` (the counted
    run's time on the host clock, to a synchronise), device launches and
    launches by kernel name."""
    busy, launches, by_name = device_profile(fn, 1)
    return {"device_busy_ms": busy, "device_idle_share": 1.0 - busy / (1e3 * seconds),
            "device_launches": launches,
            "launches_by_kernel": dict(sorted(by_name.items(), key=lambda kv: -kv[1]))}


def multistart_epoch_fn(inv, params, tstops, n):
    """One Adam epoch of ``n`` restarts (init_restarts of the inversion's θ)
    on the folded batch, by params.UDE.grad through multistart_train's
    gradient dispatch: the per-member losses, the stack's gradient (by
    autograd one backward through the kernels over n x G planes; by a
    manual adjoint one reverse sweep; by forward mode one dual solve a θ
    leaf) and the update."""
    from odinn_tpu_torch.simulation.ensemble import (
        _fold_value_and_grad, fold_members, init_restarts)
    from odinn_tpu_torch.simulation.inversion import _tree_leaves
    from odinn_tpu_torch.utils.flatten import tree_map

    stack = tree_map(lambda x: x.detach().clone().requires_grad_(True),
                     init_restarts(inv.theta, n, 0.5, seed=0))
    leaves = _tree_leaves(stack)
    vg = _fold_value_and_grad([fold_members(inv.model, inv.glaciers, params, n)], tstops)
    opt = torch.optim.Adam(leaves, lr=0.05)

    def epoch():
        _, grads = vg(stack)
        for p, g in zip(leaves, grads):
            p.grad = g
        opt.step()

    epoch.record = vg.record
    return epoch


def multistart_phase():
    """Phase 11, multistart: phase 5's SI training problem (A = NN(T), 16 x
    128^2, float32, PCG-20, 24 intervals) trained from MS_RESTARTS restarts
    of init_restarts, all folded into one batch of 128 glaciers: one folded
    Adam epoch with its launches asserted (si_step 24 forward and 24
    transpose, si_step_vjp 24, as phase 5's single-start epoch) and
    profiled beside phase 5's single-start epoch; multistart_train with
    MS_EPOCHS Adam epochs (si_step 24 x (epochs + 1), transpose and
    si_step_vjp 24 x epochs), restart 0's losses held to a single-start
    run_inversion from θ0 to TOL_RESTART0, every restart's loss falling;
    then again with refine_top_k=2 and MS_LBFGS LBFGS iterations, the
    best loss no worse than restart 0's; then each of MS_MODES at full
    width (multistart_mode_run) and on the float64 cut
    (multistart_mode_cut)."""
    from odinn_tpu_torch.simulation.ensemble import multistart_train
    from odinn_tpu_torch.simulation.inversion import Inversion, run_inversion

    counters = kernel_counters()
    total = {k: 0 for k in counters}
    inv, model, params, tstops, facts = training_problem("SI", "jax")
    n_int = len(tstops) - 1
    adam = params.replace(hyper=dataclasses.replace(
        params.hyper, optimizer=("adam",), learning_rate=(0.05,), epochs=(MS_EPOCHS,)))
    refine = params.replace(hyper=dataclasses.replace(
        params.hyper, optimizer=("adam", "lbfgs"), learning_rate=(0.05, 1.0),
        epochs=(MS_EPOCHS, MS_LBFGS)))
    theta0 = _tree_to(inv.theta, "cuda", None)

    # one folded epoch: launches, then time and profile beside a single start
    epoch = multistart_epoch_fn(inv, adam, tstops, MS_RESTARTS)
    _peak_reset()
    _reset(counters)
    epoch()
    torch.cuda.synchronize()
    epoch_launches = _read(counters)
    _add(total, epoch_launches)
    epoch_expected = dict({k: 0 for k in counters}, si_step=n_int, si_step_transpose=n_int,
                          si_step_vjp=n_int)
    folded = epoch_profile(epoch)
    epoch_peak = torch.cuda.max_memory_allocated()
    single = epoch_profile(adam_epoch_fn(inv, model, adam, tstops))

    # the single start from θ0, then the restarts
    ref = Inversion(model=model, glaciers=inv.glaciers, parameters=adam,
                    theta=_tree_to(theta0, "cuda", None), device="cuda")
    ref_losses = run_inversion(ref).stats.losses
    runs = {}
    for name, p, k in (("adam", adam, None), ("refine", refine, 2)):
        def run(p=p, k=k):
            ms_inv = Inversion(model=model, glaciers=inv.glaciers, parameters=p,
                               theta=_tree_to(theta0, "cuda", None), device="cuda")
            return multistart_train(ms_inv, n_restarts=MS_RESTARTS, seed=0, refine_top_k=k)

        _peak_reset()
        _reset(counters)
        t0 = time.perf_counter()
        ms = run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        runs[name] = (ms, seconds, _read(counters), torch.cuda.max_memory_allocated(),
                      run_profile(run, seconds))
        _add(total, runs[name][2])
    ms, seconds, launches, peak, prof = runs["adam"]
    expected = dict({k: 0 for k in counters}, si_step=n_int * (MS_EPOCHS + 1),
                    si_step_transpose=n_int * MS_EPOCHS, si_step_vjp=n_int * MS_EPOCHS)
    r0_err = float(np.max(np.abs(ms.losses[0] - np.asarray(ref_losses)) / np.abs(ref_losses)))
    msr, seconds_r, launches_r, peak_r, prof_r = runs["refine"]
    row = dict({
        "phase": "multistart", "solver": "SI", "cg_iters": SI_TRAIN_CG, "glaciers": N_TRAIN,
        "restarts": MS_RESTARTS, "planes_per_launch": MS_RESTARTS * N_TRAIN, "grid": [NX, NY],
        "dtype": "torch.float32", "intervals": n_int, "adam_epochs": MS_EPOCHS,
        "epoch_launches": epoch_launches, "epoch_expected_launches": epoch_expected,
        "epoch_max_memory_allocated": epoch_peak,
        "single_start": {k: single[k] for k in ("adam_epoch_ms", "adam_epoch_device_busy_ms",
                                                "adam_epoch_device_idle_share",
                                                "adam_epoch_device_launches")},
        "ratio_epoch_ms": folded["adam_epoch_ms"] / single["adam_epoch_ms"],
        "ratio_busy_ms": folded["adam_epoch_device_busy_ms"]
        / single["adam_epoch_device_busy_ms"],
        "multistart_train_s": seconds, "multistart_train_profile": prof,
        "launches": launches, "expected_launches": expected,
        "max_memory_allocated": peak, "losses": ms.losses.tolist(),
        "final_losses": ms.final_losses.tolist(), "best_idx": ms.best_idx,
        "best_loss": ms.best_loss, "single_start_losses": ref_losses,
        "restart0_rel_err": r0_err, "restart0_tol": TOL_RESTART0,
        "refine": {"multistart_train_s": seconds_r, "profile": prof_r, "launches": launches_r,
                   "max_memory_allocated": peak_r, "refined_idxs": list(map(int, msr.refined_idxs)),
                   "refined_losses": msr.refined_losses.tolist(), "best_idx": msr.best_idx,
                   "best_loss": msr.best_loss, "lbfgs_iterations": MS_LBFGS},
    }, **folded)
    emit(row)
    if epoch_launches != epoch_expected or launches != expected:
        raise AssertionError(f"multistart: launches {epoch_launches} / {launches}, expected "
                             f"{epoch_expected} / {expected}")
    if not (np.isfinite(ms.losses).all() and np.all(ms.losses[:, -1] < ms.losses[:, 0])):
        raise AssertionError(f"multistart: a restart's loss did not fall: {ms.losses}")
    if not r0_err <= TOL_RESTART0:
        raise AssertionError(f"multistart: restart 0 is not the single start: {r0_err}")
    if not (ms.best_loss <= ms.final_losses[0] and msr.best_loss <= msr.final_losses[0]
            and np.isfinite(msr.refined_losses).all()
            and launches_r["si_step_transpose"] == launches_r["si_step_vjp"] > 0):
        raise AssertionError(f"multistart with refinement: {row['refine']}")
    for grad, kind in MS_MODES:
        _add(total, multistart_mode_run(grad, kind))
    for grad, kind in MS_MODES:
        _add(total, multistart_mode_cut(grad, kind))
    return total


def ms_mode_grad(grad):
    """params.UDE.grad of a mode line: the continuous adjoint on the
    kernels' route (its pullbacks launch sia2d_rhs_vjp), as phase 5's
    continuous gradient."""
    from odinn_tpu_torch.inverse.adjoint_types import ContinuousAdjoint, DiscreteVJP

    return ContinuousAdjoint(VJP_method=DiscreteVJP()) if grad == "continuous" else grad


def mode_gradient_launches(grad, counters, n_int, n_leaves, record=None, n_quadrature=0):
    """The launches of one SI PCG gradient of a mode, one launch a step for
    every plane of the batch: the discrete adjoint si_step twice an
    interval (the forward and the plain-CG rematerialisation of the
    pre-relu state), the transpose solve and the pullback once; the
    continuous adjoint si_step once an interval, sia2d_rhs once a save (the
    Hermite slopes of H) and sia2d_rhs_vjp once a pullback (the first slope
    of each interval, three a reverse step while any glacier steps, two λ
    slopes an interval, one a quadrature node; ``record``'s reverse
    steps); forward mode one dual solve a θ leaf (si_step and its
    tangent-solve mode); the dummy gradient the forward's si_step."""
    out = {k: 0 for k in counters}
    if grad == "discrete":
        out.update(si_step=2 * n_int, si_step_transpose=n_int, si_step_vjp=n_int)
    elif grad == "continuous":
        steps = record["reverse_steps"]
        out.update(si_step=n_int, sia2d_rhs=n_int + 1,
                   sia2d_rhs_vjp=sum(1 + 3 * max(s) for s in steps) + 2 * n_int + n_quadrature)
    elif grad == "forward":
        out.update(si_step=n_int * n_leaves, si_step_tangent=n_int * n_leaves)
    else:
        out.update(si_step=n_int)
    return out


def multistart_mode_run(grad, kind):
    """Phase 11, multistart under a gradient mode other than autograd, at
    the phase's full width (MS_RESTARTS restarts of the SI training
    problem, 16 x 128^2, float32, PCG-20, 24 intervals; 128 planes a
    launch): A = NN(T) for the discrete and continuous adjoints and the
    dummy gradient, per-glacier scalar A for forward mode (``kind``
    "classical"). One folded Adam epoch with its launches held to the
    mode's gradient (mode_gradient_launches; the continuous adjoint's
    from its own reverse steps) and to a single-start epoch's count,
    timed (median of MS_MODE_REPS) and profiled; multistart_train with
    MS_MODE_EPOCHS Adam epochs,
    its launches held likewise (epochs gradients and the final losses'
    forward), restart 0's losses held to a single-start run_inversion from
    θ0 under the mode to TOL_RESTART0; every restart's loss finite and
    falling, and under the dummy gradient instead every restart's θ moved
    by the same update (MS_DUMMY_TOL of the leaf's largest |θ|: one draw
    of the member's shape, shared). Returns the launches."""
    from odinn_tpu_torch.simulation.ensemble import init_restarts, multistart_train
    from odinn_tpu_torch.simulation.inversion import Inversion, run_inversion
    from odinn_tpu_torch.utils.flatten import tree_leaves

    counters = kernel_counters()
    total = {k: 0 for k in counters}
    marks = [("start", time.perf_counter())]
    inv, model, params, tstops, _ = training_problem("SI", ms_mode_grad(grad), kind=kind)
    marks.append(("problem", time.perf_counter()))
    n_int = len(tstops) - 1
    adam = params.replace(hyper=dataclasses.replace(
        params.hyper, optimizer=("adam",), learning_rate=(0.05,), epochs=(MS_MODE_EPOCHS,)))
    theta0 = _tree_to(inv.theta, "cuda", None)
    n_leaves = len(tree_leaves(theta0))
    n_q = getattr(adam.UDE.grad, "n_quadrature", 0)

    def expected(records, solves=0):
        out = {k: solves * n_int if k == "si_step" else 0 for k in counters}
        for rec in records:
            _add(out, mode_gradient_launches(grad, counters, n_int, n_leaves, rec, n_q))
        return out

    # one folded epoch and one single-start epoch: launches (each gradient's
    # own reverse steps under the continuous adjoint), then the folded one
    # timed and profiled
    epoch = multistart_epoch_fn(inv, adam, tstops, MS_RESTARTS)
    _peak_reset()
    _reset(counters)
    epoch()
    torch.cuda.synchronize()
    epoch_launches = _read(counters)
    _add(total, epoch_launches)
    epoch_record = dict(epoch.record)
    epoch_expected = expected([epoch_record])
    single = adam_epoch_fn(inv, model, adam, tstops)
    _reset(counters)
    single()
    torch.cuda.synchronize()
    single_launches = _read(counters)
    single_expected = expected([dict(single.record)])
    marks.append(("epochs", time.perf_counter()))
    folded = epoch_profile(epoch, reps=MS_MODE_REPS)
    epoch_peak = torch.cuda.max_memory_allocated()
    marks.append(("epoch_profile", time.perf_counter()))

    ref = Inversion(model=model, glaciers=inv.glaciers, parameters=adam,
                    theta=_tree_to(theta0, "cuda", None), device="cuda")
    ref_losses = run_inversion(ref).stats.losses
    marks.append(("single_start", time.perf_counter()))

    ms_inv = Inversion(model=model, glaciers=inv.glaciers, parameters=adam,
                       theta=_tree_to(theta0, "cuda", None), device="cuda")
    _peak_reset()
    _reset(counters)
    t0 = time.perf_counter()
    ms = multistart_train(ms_inv, n_restarts=MS_RESTARTS, seed=0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _read(counters)
    _add(total, launches)
    run_expected = expected(ms.adjoint_records, solves=1)
    peak = torch.cuda.max_memory_allocated()
    marks.append(("multistart_train", time.perf_counter()))
    r0_err = float(np.max(np.abs(ms.losses[0] - np.asarray(ref_losses)) / np.abs(ref_losses)))
    start = init_restarts(theta0, MS_RESTARTS, 0.5, seed=0)
    update_errs = []
    for a, b in zip(tree_leaves(ms.thetas), tree_leaves(start)):
        step = a.double() - b.double()
        update_errs.append(float((step - step[0]).abs().max() / a.abs().max()))
    row = dict({
        "phase": "multistart_mode", "grad": grad, "adjoint": str(adam.UDE.grad),
        "law": "LawA_inversion(scalar)" if kind == "classical" else "NN(T)", "solver": "SI",
        "cg_iters": SI_TRAIN_CG, "glaciers": N_TRAIN, "restarts": MS_RESTARTS,
        "planes_per_launch": MS_RESTARTS * N_TRAIN, "grid": [NX, NY], "dtype": "torch.float32",
        "intervals": n_int, "adam_epochs": MS_MODE_EPOCHS,
        "seconds": marks[-1][1] - marks[0][1],
        "part_seconds": {name: t - prev for (name, t), (_, prev) in zip(marks[1:], marks)},
        "epoch_launches": epoch_launches, "epoch_expected_launches": epoch_expected,
        "single_start_epoch_launches": single_launches,
        "single_start_epoch_expected_launches": single_expected,
        "reverse_steps_per_interval_max": ([max(s) for s in epoch_record["reverse_steps"]]
                                           if grad == "continuous" else None),
        "epoch_max_memory_allocated": epoch_peak, "multistart_train_s": seconds,
        "launches": launches, "expected_launches": run_expected,
        "max_memory_allocated": peak, "losses": ms.losses.tolist(),
        "final_losses": ms.final_losses.tolist(), "best_idx": ms.best_idx,
        "single_start_losses": ref_losses, "restart0_rel_err": r0_err,
        "restart0_tol": TOL_RESTART0, "update_spread": max(update_errs),
    }, **folded)
    emit(row)
    what = f"multistart {grad}"
    if (epoch_launches != epoch_expected or single_launches != single_expected
            or launches != run_expected):
        raise AssertionError(f"{what}: launches {epoch_launches} / {single_launches} / "
                             f"{launches}, expected {epoch_expected} / {single_expected} / "
                             f"{run_expected}")
    if not r0_err <= TOL_RESTART0:
        raise AssertionError(f"{what}: restart 0 is not the single start: {r0_err}")
    if not np.isfinite(ms.losses).all() or not np.isfinite(ms.final_losses).all():
        raise AssertionError(f"{what}: a loss is not finite: {ms.losses}")
    if grad == "dummy":
        if not row["update_spread"] <= MS_DUMMY_TOL:
            raise AssertionError(f"{what}: the restarts' updates differ: {update_errs}")
    elif not np.all(ms.losses[:, -1] < ms.losses[:, 0]):
        raise AssertionError(f"{what}: a restart's loss did not fall: {ms.losses}")
    return total


def multistart_mode_cut(grad, kind):
    """Phase 11's float64 cut of a mode: MS_CUT_RESTARTS restarts of 4 SI
    glaciers, 128^2, 3 months, PCG-6 on the card; the folded gradient (the
    member losses and the stack's gradient through multistart_train's
    dispatch) against the stack of single-start gradients of the same mode
    (the trainer's dispatch) on the card, each member to TOL_FOLD_F64 per θ
    leaf. Returns the launches."""
    from odinn_tpu_torch.simulation.ensemble import (
        _fold_value_and_grad, fold_members, init_restarts, member_theta)
    from odinn_tpu_torch.simulation.inversion import Inversion

    counters = kernel_counters()
    t0 = time.perf_counter()
    inv, model, params, tstops, _ = training_problem(
        "SI", ms_mode_grad(grad), n_g=MS_CUT_GLACIERS, tspan=MS_CUT_TSPAN, dtype=torch.float64,
        kind=kind)
    params = _with_solver(params, cg_iters=MS_CUT_CG)
    stack = init_restarts(inv.theta, MS_CUT_RESTARTS, 0.5, seed=0)
    _reset(counters)
    fold = fold_members(model, inv.glaciers, params, MS_CUT_RESTARTS)
    per, grads = _fold_value_and_grad([fold], tstops)(stack)
    torch.cuda.synchronize()
    launches = _read(counters)
    loss_errs, grad_errs = [], []
    for k in range(MS_CUT_RESTARTS):
        th = member_theta(stack, k)
        one = Inversion(model=model, glaciers=inv.glaciers, parameters=params, theta=th,
                        device="cuda")
        vg, _ = grad_fn(one, params)
        loss, g = vg(_tree_to(th, "cuda", None), inv.glaciers)
        loss_errs.append(abs(float(per[k]) - float(loss)) / abs(float(loss)))
        grad_errs.append(_leaf_errs([x[k] for x in grads], g))
    row = {"phase": "multistart_mode_cut", "grad": grad, "adjoint": str(params.UDE.grad),
           "restarts": MS_CUT_RESTARTS, "glaciers": MS_CUT_GLACIERS, "grid": [NX, NY],
           "dtype": "torch.float64", "intervals": len(tstops) - 1, "cg_iters": MS_CUT_CG,
           "seconds": time.perf_counter() - t0, "launches": launches,
           "loss_rel_errs": loss_errs, "grad_rel_errs": grad_errs, "tol": TOL_FOLD_F64}
    emit(row)
    if not max(loss_errs + grad_errs) <= TOL_FOLD_F64:
        raise AssertionError(f"multistart {grad} float64 cut: the fold is not the single "
                             f"starts: {row}")
    return launches


def eki_problem(n_g, nx, temps, solver_kw, prefix):
    """benchmarks/ensemble_bench.py's problem, float32 on the card: Halfar
    glaciers (dx 100 m) with Cuffey–Paterson ground truth of H over 6
    monthly intervals through the same solve, and one tanh-bounded A per
    glacier (LawA_inversion)."""
    from odinn_tpu_torch.core.params import (
        Parameters, PhysicalParameters, SimulationParameters, SolverParameters)
    from odinn_tpu_torch.data.synthetic import halfar_glacier
    from odinn_tpu_torch.laws.laws import CuffeyPaterson, LawA_inversion
    from odinn_tpu_torch.models.model import Model, SIA2DModel
    from odinn_tpu_torch.simulation.inversion import Inversion
    from odinn_tpu_torch.simulation.prediction import generate_ground_truth
    from odinn_tpu_torch.simulation.solver import build_tstops

    params = Parameters(
        physical=PhysicalParameters(min_A=8e-21, max_A=8e-18),
        simulation=SimulationParameters(tspan=EKI_TSPAN, use_MB=False, use_velocities=False,
                                        float_dtype="float32"),
        solver=SolverParameters(step=1.0 / 12.0, **solver_kw))
    glaciers = [halfar_glacier(nx=nx, ny=nx, dx=100.0, dy=100.0, temp=float(t),
                               rgi_id=f"{prefix}-{i}", device="cuda", dtype=torch.float32)
                for i, t in enumerate(temps)]
    truth = generate_ground_truth(
        glaciers, params, Model(iceflow=SIA2DModel(A=CuffeyPaterson(), n_value=3.0)),
        build_tstops(EKI_TSPAN, 1.0 / 12.0), store=("H",), device="cuda")
    model = Model(iceflow=SIA2DModel(A=LawA_inversion(params, scalar=True), n_value=3.0))
    return Inversion(model=model, glaciers=truth, parameters=params, device="cuda")


def _a_rel_errs(theta, params, temps):
    """Each glacier's recovered A against the Cuffey–Paterson truth."""
    from odinn_tpu_torch.laws.laws import poly_A_paterson_cuffey

    phys = params.physical
    raw = theta["A"].detach().double().cpu()
    a = phys.min_A + (phys.max_A - phys.min_A) * (torch.tanh(raw) + 1.0) / 2.0
    truth = poly_A_paterson_cuffey()(torch.as_tensor(np.asarray(temps, float)))
    return (a - truth).abs() / truth


def eki_phase():
    """Phase 11, EKI: eki_bench.py section 1 (16 glaciers, 64^2, float32,
    SI PCG-12, 6 months, EKI_MEMBERS members, EKI_ITERS iterations,
    init_scale 0.5, seed 0) with si_step launched 6 x (iterations + 1) for
    the residual batches and 6 for the mean member (one launch a step for
    all 512 planes), and the reference's accuracy gate on the recovered A
    (max relative error <= 1e-3, min <= 1e-4); then section 3 (4 glaciers,
    32^2, RK4 at 15 substeps with adaptive=True, reltol 1e-4, 8 members, 10
    iterations, seed 1) with sia2d_rhs launched once per RHS evaluation of
    the folded integrator and the best misfit below the initial ensemble's
    best."""
    from odinn_tpu_torch.ops.cuda import si_kernel
    from odinn_tpu_torch.simulation.eki import eki_train

    counters = kernel_counters()
    total = {k: 0 for k in counters}
    temps = np.linspace(-25.0, -14.0, EKI_GLACIERS)
    inv = eki_problem(EKI_GLACIERS, EKI_NX, temps,
                      dict(solver="SI", cg_iters=EKI_CG, substeps=1), "eki")
    n_int = int(round((EKI_TSPAN[1] - EKI_TSPAN[0]) * 12))
    plan = si_kernel.si_plan(EKI_MEMBERS * EKI_GLACIERS, EKI_NX, EKI_NX, torch.float32)
    theta0 = _tree_to(inv.theta, "cuda", None)

    def run():
        inv.theta = _tree_to(theta0, "cuda", None)
        return eki_train(inv, n_ensemble=EKI_MEMBERS, n_iters=EKI_ITERS, init_scale=0.5,
                         seed=0)

    _peak_reset()
    _reset(counters)
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _read(counters)
    peak = torch.cuda.max_memory_allocated()
    _add(total, launches)
    expected = dict({k: 0 for k in counters}, si_step=n_int * (res.n_iters + 1) + n_int)
    errs = _a_rel_errs(res.best_theta, inv.parameters, temps)
    best = np.nanmin(res.misfits, axis=1)
    row = {"phase": "eki", "solver": "SI", "cg_iters": EKI_CG, "glaciers": EKI_GLACIERS,
           "members": EKI_MEMBERS, "planes_per_launch": EKI_MEMBERS * EKI_GLACIERS,
           "si_plan": plan.path, "grid": [EKI_NX, EKI_NX], "dtype": "torch.float32",
           "intervals": n_int, "iterations": res.n_iters, "seconds": seconds,
           "seconds_per_iteration": seconds / max(res.n_iters, 1),
           "best_misfit_per_iteration": best.tolist(),
           "collapse": float(res.best_loss / best[0]), "best_loss": res.best_loss,
           "mean_loss": res.mean_loss, "A_rel_err_max": float(errs.max()),
           "A_rel_err_min": float(errs.min()), "gate": {"max": 1e-3, "min": 1e-4},
           "max_memory_allocated": peak, "launches": launches, "expected_launches": expected,
           **run_profile(run, seconds)}
    emit(row)
    if launches != expected:
        raise AssertionError(f"eki: launches {launches}, expected {expected}")
    if not (row["A_rel_err_max"] <= 1e-3 and row["A_rel_err_min"] <= 1e-4):
        raise AssertionError(f"eki: the recovered A misses the reference's gate: {row}")

    temps_a = np.linspace(-25.0, -14.0, EKI_A_GLACIERS)
    inv = eki_problem(EKI_A_GLACIERS, EKI_A_NX, temps_a,
                      dict(solver="RK4", substeps=15, adaptive=True, reltol=TOL_RELTOL), "ekia")
    theta0 = _tree_to(inv.theta, "cuda", None)

    def run():
        inv.theta = _tree_to(theta0, "cuda", None)
        return eki_train(inv, n_ensemble=EKI_A_MEMBERS, n_iters=EKI_A_ITERS, seed=1)

    integ = _adaptive_counts()
    _peak_reset()
    _reset(counters)
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _read(counters)
    rhs_evals, host_reads = integ.rhs_evals, integ.host_reads
    peak = torch.cuda.max_memory_allocated()
    _add(total, launches)
    expected = dict({k: 0 for k in counters}, sia2d_rhs=rhs_evals)
    best = np.nanmin(res.misfits, axis=1)
    row = {"phase": "eki_adaptive", "solver": "RK4 adaptive BS3(2)", "reltol": TOL_RELTOL,
           "glaciers": EKI_A_GLACIERS, "members": EKI_A_MEMBERS,
           "controllers": EKI_A_MEMBERS * EKI_A_GLACIERS, "grid": [EKI_A_NX, EKI_A_NX],
           "dtype": "torch.float32", "iterations": res.n_iters, "seconds": seconds,
           "seconds_per_iteration": seconds / max(res.n_iters, 1),
           "best_misfit_per_iteration": best.tolist(),
           "collapse": float(res.best_loss / best[0]),
           "A_rel_err_max": float(_a_rel_errs(res.best_theta, inv.parameters, temps_a).max()),
           "rhs_evals": rhs_evals, "host_reads": host_reads, "max_memory_allocated": peak,
           "launches": launches, "expected_launches": expected, **run_profile(run, seconds)}
    emit(row)
    if launches != expected or rhs_evals == 0:
        raise AssertionError(f"eki_adaptive: launches {launches}, expected {expected}")
    if not (np.isfinite(res.best_loss) and res.best_loss < best[0]):
        raise AssertionError(f"eki_adaptive: the misfit did not fall: {row}")
    return total


def _capture_jtj():
    """Spy on uncertainty._finish_dense: the raw JᵀJ of each posterior."""
    from odinn_tpu_torch.inverse import uncertainty

    seen, real = [], uncertainty._finish_dense

    def spy(theta, p, sigma2, prior_precision, JtJ64):
        seen.append(np.array(JtJ64, np.float64))
        return real(theta, p, sigma2, prior_precision, JtJ64)

    uncertainty._finish_dense = spy
    return seen, lambda: setattr(uncertainty, "_finish_dense", real)


def uq_phase():
    """Phase 11, UQ: (a) the per-glacier posterior of phase 6's classical SI
    problem without H0 (16 x 128^2, float32, PCG-20) after UQ_ADAM Adam
    epochs, si_step_tangent launched 24 x θ leaves, every A and its std
    through the tanh bound; (b) the dense posterior of phase 5's A = NN(T)
    (p = 83) on the same batch, prior_std 0.5, si_step_tangent,
    si_step_transpose and si_step_vjp 24 x p each, its build time and a
    cov_band of A over 16 temperatures; (c) on 4 x 128^2, 2 months, the
    card's dense JᵀJ (the light NN, p = 10) and per-glacier JᵀJ against the
    CPU's float64 run to TOL_UQ_F64, and their float32 θ stds within
    GRAD_F32_FACTOR times the CPU float32 run's error against float64."""
    from odinn_tpu_torch.inverse.uncertainty import laplace_uncertainty
    from odinn_tpu_torch.laws.laws import LawA, eval_law
    from odinn_tpu_torch.models.model import Model, SIA2DModel
    from odinn_tpu_torch.models.nn import NeuralNetwork, default_architecture
    from odinn_tpu_torch.simulation.inversion import Inversion, run_inversion
    from odinn_tpu_torch.inverse import gauss_newton as gn
    from odinn_tpu_torch.utils.flatten import theta_size, theta_to_vector, tree_leaves

    counters = kernel_counters()
    total = {k: 0 for k in counters}
    # (a) per glacier, after Adam
    inv, model, params, tstops, _ = training_problem("SI", "jax", kind="classical")
    n_int = len(tstops) - 1
    inv.parameters = params.replace(hyper=dataclasses.replace(
        params.hyper, optimizer=("adam",), learning_rate=(0.05,), epochs=(UQ_ADAM,)))
    run_inversion(inv)
    _peak_reset()
    _reset(counters)
    t0 = time.perf_counter()
    post = laplace_uncertainty(inv, structure="per_glacier")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _read(counters)
    peak = torch.cuda.max_memory_allocated()
    _add(total, launches)
    law = model.iceflow.A
    a_std = [post.std(lambda th, g=g: eval_law(law, th, None, glacier_idx=g))
             for g in range(N_TRAIN)]
    n_leaves = len(inv.theta)
    expected = dict({k: 0 for k in counters}, si_step=n_int * (1 + n_leaves),
                    si_step_tangent=n_int * n_leaves)
    row = {"phase": "uq_per_glacier", "solver": "SI", "cg_iters": SI_TRAIN_CG,
           "glaciers": N_TRAIN, "grid": [NX, NY], "dtype": "torch.float32",
           "intervals": n_int, "adam_epochs": UQ_ADAM, "theta_leaves": n_leaves,
           "sigma2": post.sigma2, "build_s": seconds, "A": [float(q) for q, _ in a_std],
           "A_std": [s for _, s in a_std], "max_memory_allocated": peak, "launches": launches,
           "expected_launches": expected,
           **run_profile(lambda: laplace_uncertainty(inv, structure="per_glacier"), seconds)}
    emit(row)
    if launches != expected or not all(np.isfinite(s) and s > 0 for _, s in a_std):
        raise AssertionError(f"uq_per_glacier: {row}")

    # (b) dense, the NN law
    inv, model, params, tstops, _ = training_problem("SI", "jax")
    p = theta_size(inv.theta)
    _peak_reset()
    _reset(counters)
    t0 = time.perf_counter()
    post = laplace_uncertainty(inv, prior_std=0.5)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _read(counters)
    peak = torch.cuda.max_memory_allocated()
    _add(total, launches)
    # one column of the build, J e_0 and its pullback, timed and profiled
    resid = gn.make_residual_fn(model, params, tstops)
    _, pull = gn.linearize(resid, inv.theta, inv.glaciers)
    e0 = theta_to_vector(inv.theta)[1](torch.eye(p, dtype=torch.float32, device="cuda")[0])
    column = lambda: pull(gn.jvp(resid, inv.theta, inv.glaciers, e0))  # noqa: E731
    column_ms = row_ms(column, reps=3)
    column_prof = run_profile(column, column_ms / 1e3)
    del pull
    temps = torch.linspace(-25.0, -13.0, 16, dtype=torch.float32, device="cuda")
    law = model.iceflow.A
    vals, C = post.cov_band(lambda th: law.apply(th, {"T": temps,
                                                      "glacier_idx": torch.tensor(0)}))
    expected = dict({k: 0 for k in counters}, si_step=n_int * (2 + p),
                    si_step_tangent=n_int * p, si_step_transpose=n_int * p,
                    si_step_vjp=n_int * p)
    row = {"phase": "uq_dense", "solver": "SI", "cg_iters": SI_TRAIN_CG, "glaciers": N_TRAIN,
           "grid": [NX, NY], "dtype": "torch.float32", "intervals": n_int, "p": p,
           "prior_std": 0.5, "sigma2": post.sigma2, "build_s": seconds,
           "max_memory_allocated": peak, "column_ms": column_ms,
           "column_profile": column_prof,
           "temperatures": temps.tolist(), "A": vals.tolist(),
           "A_std": np.sqrt(np.maximum(np.diag(C), 0.0)).tolist(),
           "A_corr_neighbours": [float(C[i, i + 1] / np.sqrt(C[i, i] * C[i + 1, i + 1]))
                                 for i in range(15)],
           "launches": launches, "expected_launches": expected}
    emit(row)
    if launches != expected or not np.isfinite(C).all():
        raise AssertionError(f"uq_dense: {row}")

    # (c) held against the CPU: float64, then float32, at one σ²
    rows = {}
    for structure in ("dense", "per_glacier"):
        kind = "ude" if structure == "dense" else "classical"
        inv64, model, params, tstops, _ = training_problem(
            "SI", "jax", n_g=N_G, tspan=(5.0, 5.0 + 2.0 / 12.0), dtype=torch.float64, kind=kind)
        if structure == "dense":
            model = Model(iceflow=SIA2DModel(A=LawA(NeuralNetwork(default_architecture(
                1, light=True)), params), n_value=3.0))
            theta = _tree_to(Inversion(model=model, glaciers=inv64.glaciers, parameters=params,
                                       device="cuda").theta, "cuda", None)
            kw = dict(prior_std=0.5)
        else:
            theta = _tree_to(inv64.theta, "cuda", None)
            theta["A"] = theta["A"] + 0.3
            kw = dict(structure="per_glacier")
        out, sigma2 = {}, None
        for where, dtype in (("cpu", torch.float64), ("card", torch.float64),
                             ("card", torch.float32), ("cpu", torch.float32)):
            dev = "cuda" if where == "card" else "cpu"
            p_ = params.replace(simulation=dataclasses.replace(
                params.simulation, float_dtype=str(dtype).split(".")[-1]))
            inv_ = Inversion(model=model, glaciers=inv64.glaciers.to(dev, dtype), parameters=p_,
                             theta=_tree_to(theta, dev, dtype), device=dev)
            seen, restore = _capture_jtj()
            try:
                post = laplace_uncertainty(inv_, sigma2=sigma2, **kw)
            finally:
                restore()
            sigma2 = post.sigma2          # the CPU float64 run's, for all four
            out[f"{where} {dtype}"] = (seen[0], np.concatenate(
                [np.ravel(x) for x in tree_leaves(post.theta_std())]))
        ref_jtj, ref_std = out["cpu torch.float64"]
        jtj_err = float(np.abs(out["card torch.float64"][0] - ref_jtj).max()
                        / np.abs(ref_jtj).max())
        std_err = {k: float(np.abs(v[1] - ref_std).max() / np.abs(ref_std).max())
                   for k, v in out.items() if k != "cpu torch.float64"}
        rows[structure] = {"p": int(ref_jtj.shape[0]), "sigma2": sigma2,
                           "jtj_rel_err_f64": jtj_err, "std_rel_err_vs_cpu_f64": std_err}
    row = {"phase": "uq_check", "glaciers": N_G, "grid": [NX, NY], "intervals": 2,
           "tol_f64": TOL_UQ_F64, "factor_f32": GRAD_F32_FACTOR, "paths": rows}
    emit(row)
    for r in rows.values():
        e = r["std_rel_err_vs_cpu_f64"]
        if not (r["jtj_rel_err_f64"] <= TOL_UQ_F64 and e["card torch.float64"] <= TOL_UQ_F64
                and e["card torch.float32"] <= GRAD_F32_FACTOR * e["cpu torch.float32"]):
            raise AssertionError(f"uq_check: the card's posterior disagrees with the CPU's: "
                                 f"{row}")
    return total


def ensemble_phase():
    """Phase 11: multistart, EKI (fixed step and adaptive) and UQ; returns
    their launches and prints the phase's seconds."""
    t0 = time.perf_counter()
    launches = multistart_phase()
    for part in (eki_phase, uq_phase):
        _add(launches, part())
    emit({"phase": "ensembles", "seconds": time.perf_counter() - t0, "launches": launches})
    return launches


# ---------------------------------------------------------------------------
# Phase 12: data, I/O and the MLP mass balance
# ---------------------------------------------------------------------------

def _container_fields(obj, prefix=""):
    """Every tensor field of a (nested) container dataclass by dotted name."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out[prefix + f.name] = v
        elif dataclasses.is_dataclass(v):
            out.update(_container_fields(v, f"{prefix}{f.name}."))
    return out


def _max_field_err(cards, cpus):
    """The largest max|card - cpu| / max|cpu| over every field of two lists
    of glaciers, with the field it was found in."""
    worst = (0.0, None)
    for g_card, g_cpu in zip(cards, cpus):
        ref = _container_fields(g_cpu)
        got = _container_fields(g_card)
        if set(got) != set(ref):
            raise AssertionError(f"data_io: fields differ: {sorted(set(got) ^ set(ref))}")
        for k, r in ref.items():
            r = r.double()
            scale = float(r.abs().max()) or 1.0
            err = float((got[k].cpu().double() - r).abs().max()) / scale
            worst = max(worst, (err, f"{g_cpu.rgi_id}.{k}"), key=lambda e: e[0])
    return worst


def _data_cube(npz_path):
    """A 2-frame velocity cube on its own DATA_CUBE^2 grid spanning the
    glacier file's full-resolution footprint, with smooth fields (CPU,
    float64, not aligned with the glacier's grid)."""
    from odinn_tpu_torch.core.glacier import SurfaceVelocityData

    with np.load(npz_path) as z:
        cx, cy = z["coords_x"], z["coords_y"]
    x = np.linspace(cx[0], cx[-1], DATA_CUBE)
    y = np.linspace(cy[0], cy[-1], DATA_CUBE)
    X, Y = np.meshgrid((x - x[0]) / (x[-1] - x[0]), (y - y[0]) / (y[-1] - y[0]), indexing="ij")
    vx = np.stack([(20.0 + 5.0 * f) * (1.0 + 0.5 * np.sin(2 * np.pi * X) * np.cos(np.pi * Y))
                   for f in range(2)])
    vy = np.stack([(8.0 + 2.0 * f) * np.cos(2 * np.pi * Y) * (1.0 + X) for f in range(2)])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))   # noqa: E731
    return SurfaceVelocityData(t=t(np.array([2010.5, 2011.5])), vx=t(vx), vy=t(vy),
                               vabs=t(np.sqrt(vx**2 + vy**2)), x=t(x), y=t(y),
                               is_grid_glacier_aligned=False)


def data_params(tspan=DATA_TSPAN, dtype="float32"):
    """Phase 12's parameters: grid_scaling_factor DATA_K, monthly MLP mass
    balance, SI at PCG-20, Adam DATA_EPOCHS epochs (LBFGS none) by
    autograd."""
    from odinn_tpu_torch.core.params import (
        Hyperparameters, Parameters, PhysicalParameters, SimulationParameters,
        SolverParameters, UDEParameters)

    return Parameters(
        physical=PhysicalParameters(min_A=8e-21, max_A=8e-18),
        simulation=SimulationParameters(tspan=tspan, use_MB=True, step_MB=1.0 / 12.0,
                                        use_velocities=False, grid_scaling_factor=DATA_K,
                                        float_dtype=dtype),
        solver=SolverParameters(step=1.0 / 12.0, solver="SI", cg_iters=SI_TRAIN_CG,
                                cg_iters_predictor=6, substeps=1),
        hyper=Hyperparameters(optimizer=("adam",), learning_rate=(0.05,),
                              epochs=(DATA_EPOCHS,), batch_size=DATA_N),
        UDE=UDEParameters(grad="jax"),
    )


def data_io_phase():
    """Phase 12: the real-data path on the card, in a temporary directory.
    Writes DATA_N synthetic .npz glaciers (DATA_NX^2), loads them with
    initialize_glaciers onto the card in float32 at grid_scaling_factor
    DATA_K (16 x 128^2), each with a velocity cube on its own grid
    regridded on the card, held to the same load on the CPU in float64;
    writes an MLP mass balance with save_model and reads it back with
    load_model on the card, its mb_timestep held to the CPU's float64 one
    (float64 to TOL_DATA_F64, float32 within 2x the CPU float32 error);
    makes Cuffey–Paterson ground truth with the MLP mass balance through SI
    at PCG-20 over 24 months (and a float64 cut, DATA_CUT_G glaciers over 6
    months, held to the CPU's trajectory to TOL_DATA_F64); trains A = NN(T)
    by autograd, Adam DATA_EPOCHS epochs, through run_inversion(path=...)
    with a TrainingLogger, its launches asserted as phase 5's; reloads θ
    (bitwise), its sidecar and a run_prediction from it (bitwise equal to
    the trained forward), round-trips the results file and a checkpoint;
    and measures one Adam epoch's peak memory with aot_step_memory beside
    live_hbm_gib and profiles it. Returns each kernel's launches."""
    import tempfile

    from odinn_tpu_torch.core.glacier import stack_glaciers
    from odinn_tpu_torch.data.rgi import generate_synthetic_rgi_dir, initialize_glaciers
    from odinn_tpu_torch.laws.laws import CuffeyPaterson, LawA
    from odinn_tpu_torch.models.mb_machine import CustomMLP, load_model, save_model
    from odinn_tpu_torch.models.model import Model, SIA2DModel
    from odinn_tpu_torch.models.nn import MLP, NeuralNetwork, default_architecture, init_mlp
    from odinn_tpu_torch.physics.mass_balance import mb_timestep
    from odinn_tpu_torch.simulation.inversion import Inversion, _tree_leaves, run_inversion
    from odinn_tpu_torch.simulation.prediction import (
        Prediction, forward_batch, generate_ground_truth, run_prediction)
    from odinn_tpu_torch.simulation.solver import build_tstops
    from odinn_tpu_torch.utils import io
    from odinn_tpu_torch.utils.logging import TrainingLogger
    from odinn_tpu_torch.utils.memory import aot_step_memory, live_hbm_gib

    t_phase = time.perf_counter()
    counters = kernel_counters()
    total = {k: 0 for k in counters}
    seconds = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return out

    def counted(fn):
        _reset(counters)
        out = fn()
        torch.cuda.synchronize()
        launches = _read(counters)
        _add(total, launches)
        return out, launches

    params = data_params()
    with tempfile.TemporaryDirectory() as tmp:
        # 1-2. write the glaciers, load them onto the card and on the CPU
        ids = timed("write", lambda: generate_synthetic_rgi_dir(
            tmp, n=DATA_N, nx=DATA_NX, ny=DATA_NX, seed=0))
        cubes = {rid: _data_cube(os.path.join(tmp, f"{rid}.npz")) for rid in ids}
        glaciers = timed("load", lambda: initialize_glaciers(
            ids, params, prepro_dir=tmp, velocity_datacubes=cubes, device="cuda",
            dtype=torch.float32))
        cpu64 = timed("load_cpu_float64", lambda: initialize_glaciers(
            ids, params, prepro_dir=tmp, velocity_datacubes=cubes, device="cpu"))
        load_err, load_where = _max_field_err(glaciers, cpu64)
        vd = glaciers[0].velocity_data
        cube_ok = (all(g.velocity_data.is_grid_glacier_aligned for g in glaciers)
                   and tuple(vd.vx.shape) == (2, DATA_NX // DATA_K, DATA_NX // DATA_K)
                   and vd.vx.device.type == "cuda" and float(vd.vx.min()) > 0.0)

        # 3. the MLP mass balance: written, read back on the card
        arch = MLP(MB_WIDTHS, MB_ACTIVATIONS)
        layers = init_mlp(arch, torch.Generator().manual_seed(0), dtype=torch.float64)
        layers[-1] = {k: MB_SCALE * v for k, v in layers[-1].items()}
        save_model(os.path.join(tmp, "mlp"), CustomMLP(arch, layers))
        mlp = {(dev, dt): load_model(os.path.join(tmp, "mlp"), device=dev, dtype=dt)
               for dev in ("cuda", "cpu") for dt in (torch.float32, torch.float64)}
        b64 = stack_glaciers(cpu64, device="cpu")
        batches = {("cpu", torch.float64): b64, ("cuda", torch.float64): b64.to("cuda"),
                   ("cpu", torch.float32): b64.to(dtype=torch.float32),
                   ("cuda", torch.float32): stack_glaciers(glaciers, device="cuda")}
        t_mb, step = DATA_TSPAN[0] + 7.0 / 12.0, 1.0 / 12.0
        mb_out = {}
        for key, b in batches.items():
            mb_out[key] = mb_timestep(b.H0, b, mlp[key], t_mb, step).cpu().double()
        ref = mb_out[("cpu", torch.float64)]
        scale = float(ref.abs().max())
        mb_err = {f"{dev}_{str(dt).split('.')[-1]}": float((v - ref).abs().max()) / scale
                  for (dev, dt), v in mb_out.items()}
        mb_field = mlp[("cpu", torch.float64)].compute_mb_field(b64.climate, b64.S, t_mb, step)
        mb_max = float(mb_field.abs().max())
        mb_moved = float((ref - b64.H0).abs().max())

        # 4. ground truth with the MLP mass balance; the float64 cut
        tstops = build_tstops(DATA_TSPAN, 1.0 / 12.0)
        n_int = len(tstops) - 1
        truth_model = Model(iceflow=SIA2DModel(A=CuffeyPaterson(), n_value=3.0),
                            mass_balance=mlp[("cuda", torch.float32)])
        truth, truth_launches = counted(lambda: timed("ground_truth", lambda: generate_ground_truth(
            glaciers, params, truth_model, tstops, store=("H",), device="cuda")))
        p64 = data_params(DATA_CUT_TSPAN, "float64")
        ts64 = build_tstops(DATA_CUT_TSPAN, 1.0 / 12.0)

        def cut(dev):
            m = Model(iceflow=SIA2DModel(A=CuffeyPaterson(), n_value=3.0),
                      mass_balance=mlp[(dev, torch.float64)])
            with torch.no_grad():
                return forward_batch(None, stack_glaciers(cpu64[:DATA_CUT_G], device=dev), m,
                                     p64, ts64, device=dev).cpu()

        traj_card, cut_launches = counted(lambda: timed("cut_float64_card", lambda: cut("cuda")))
        traj_cpu = timed("cut_float64_cpu", lambda: cut("cpu"))
        traj_err = float((traj_card - traj_cpu).abs().max()) / float(traj_cpu.abs().max())

        # 5. train A = NN(T) through the SI kernels, saving the result
        model = Model(iceflow=SIA2DModel(A=LawA(NeuralNetwork(default_architecture(1)), params),
                                         n_value=3.0),
                      mass_balance=mlp[("cuda", torch.float32)])
        inv = Inversion(model=model, glaciers=truth, parameters=params, device="cuda")
        logger = TrainingLogger(os.path.join(tmp, "log"), use_tensorboard=False,
                                print_every=DATA_EPOCHS, total_iters=DATA_EPOCHS)
        results, launches = counted(lambda: timed("run_inversion", lambda: run_inversion(
            inv, callback=logger.callback, path=tmp, file_name="training_result.pt")))
        logger.close()
        stats = results.stats
        expected = dict({k: 0 for k in counters}, si_step=n_int * stats.solves,
                        si_step_transpose=n_int * stats.gradients,
                        si_step_vjp=n_int * stats.gradients)
        with open(os.path.join(tmp, "log", "train_log.jsonl")) as f:
            log_records = [json.loads(line) for line in f]

        # 6. reload and check
        back = timed("reload", lambda: io.load_inversion_file(
            os.path.join(tmp, "training_result.pt"), device="cuda"))
        theta_equal = all(a.device.type == "cuda" and torch.equal(a, b) for a, b in
                          zip(_tree_leaves(back.theta), _tree_leaves(inv.theta)))
        pred = Prediction(model=model, glaciers=inv.glaciers, parameters=inv.parameters,
                          theta=back.theta, device="cuda")
        again, pred_launches = counted(lambda: timed("run_prediction", lambda: run_prediction(
            pred, tstops=results.simulation["t"])))
        prediction_equal = torch.equal(again["H"], results.simulation["H"])
        io.save_results_file(os.path.join(tmp, "results.npz"), results.simulation)
        res_back = io.load_results_file(os.path.join(tmp, "results.npz"))
        results_equal = (np.array_equal(res_back["H"], results.simulation["H"].cpu().numpy())
                         and np.array_equal(res_back["t"],
                                            torch.as_tensor(results.simulation["t"]).numpy()))
        state = {"theta": inv.theta, "losses": stats.losses, "step": stats.niter}
        io.save_checkpoint(os.path.join(tmp, "ckpt"), stats.niter, state)
        restored = io.restore_checkpoint(os.path.join(tmp, "ckpt"), device="cuda")
        checkpoint_equal = (restored["step"] == stats.niter and restored["losses"] == stats.losses
                            and all(torch.equal(a, b) for a, b in
                                    zip(_tree_leaves(restored["theta"]),
                                        _tree_leaves(inv.theta))))

        # 7. one Adam epoch: its peak memory, launches and profile
        epoch = adam_epoch_fn(inv, model, params, results.simulation["t"])
        (_, mem), epoch_launches = counted(lambda: aot_step_memory(epoch))
        live = live_hbm_gib()
        prof = epoch_profile(epoch)
    epoch_expected = dict({k: 0 for k in counters}, si_step=n_int, si_step_transpose=n_int,
                          si_step_vjp=n_int)
    row = dict({
        "phase": "data_io", "glaciers": DATA_N, "file_grid": [DATA_NX, DATA_NX],
        "grid_scaling_factor": DATA_K, "grid": list(glaciers[0].H0.shape),
        "cube_grid": [DATA_CUBE, DATA_CUBE], "dtype": "torch.float32", "intervals": n_int,
        "cg_iters": SI_TRAIN_CG, "mlp_widths": list(MB_WIDTHS),
        "seconds": seconds, "load_max_rel_err": load_err, "load_worst_field": load_where,
        "load_tol": TOL_LOAD_F32, "cube_regridded": cube_ok,
        "mb_step_rel_err": mb_err, "mb_max_abs_m": mb_max, "mb_moved_h_m": mb_moved,
        "cut_float64_rel_err": traj_err, "cut_tol": TOL_DATA_F64,
        "ground_truth_launches": truth_launches, "cut_launches": cut_launches,
        "losses": stats.losses, "final_loss": stats.final_loss, "solves": stats.solves,
        "gradients": stats.gradients, "launches": launches, "expected_launches": expected,
        "log_records": len(log_records), "meta": back.params_meta,
        "theta_reload_bitwise": theta_equal, "prediction_bitwise": prediction_equal,
        "prediction_launches": pred_launches, "results_file_equal": results_equal,
        "checkpoint_equal": checkpoint_equal, "epoch_launches": epoch_launches,
        "epoch_expected_launches": epoch_expected, "epoch_memory": mem,
        "epoch_max_memory_allocated": mem["peak_bytes"], "live_hbm_gib": live,
        "phase_seconds": time.perf_counter() - t_phase,
    }, **prof)
    emit(row)
    fails = []
    if not load_err <= TOL_LOAD_F32:
        fails.append(f"the card's load is {load_err} from the CPU's at {load_where}")
    if not cube_ok:
        fails.append("a velocity cube was not regridded onto the glacier on the card")
    if not (mb_err["cuda_float64"] <= TOL_DATA_F64
            and mb_err["cuda_float32"] <= GRAD_F32_FACTOR * mb_err["cpu_float32"]):
        fails.append(f"mb_timestep: {mb_err}")
    if not (0.0 < mb_max <= MB_LIMIT and mb_moved > 0.0):
        fails.append(f"the MLP mass balance reaches {mb_max} m (moves H by {mb_moved} m)")
    if not traj_err <= TOL_DATA_F64:
        fails.append(f"the float64 trajectory is {traj_err} from the CPU's")
    if truth_launches != dict({k: 0 for k in counters}, si_step=n_int) or cut_launches != dict(
            {k: 0 for k in counters}, si_step=len(ts64) - 1):
        fails.append(f"forward launches {truth_launches} / {cut_launches}")
    if launches != expected or epoch_launches != epoch_expected:
        fails.append(f"launches {launches} / {epoch_launches}, expected {expected} / "
                     f"{epoch_expected}")
    losses = stats.losses
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fails.append(f"losses not finite or not falling: {losses}")
    if not (len(log_records) == stats.niter == DATA_EPOCHS
            and [r["iter"] for r in log_records] == list(range(1, DATA_EPOCHS + 1))):
        fails.append(f"train_log.jsonl holds {len(log_records)} records for {stats.niter}")
    meta = back.params_meta or {}
    if not (meta.get("retcode") == "Success" and meta.get("niter") == stats.niter):
        fails.append(f"the sidecar: {meta}")
    if not (theta_equal and prediction_equal and results_equal and checkpoint_equal):
        fails.append("a reload or round trip is not exact")
    if pred_launches != dict({k: 0 for k in counters}, si_step=n_int):
        fails.append(f"run_prediction launches {pred_launches}")
    if fails:
        raise AssertionError("data_io: " + "; ".join(fails))
    return total

def _leaves_np(tree):
    from odinn_tpu_torch.simulation.inversion import _tree_leaves

    return [x.detach().double().cpu().numpy() for x in _tree_leaves(tree)]


def _np_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-300)


def scale_out_runs(mesh):
    """Phase 13's runs, in one process (``mesh`` None) or as this rank of
    the job's mesh, each with the launch counters set to 0 just before and
    read just after: ``train_ude`` of phase 5's SI problem (A = NN(T),
    16 x 128^2, float32, PCG-20, 24 intervals) by Adam SCALE_OUT_EPOCHS[0]
    then SCALE_OUT_EPOCHS[1] LM iterations (gn_cg_iters LM_CG, λ0
    SCALE_OUT_DAMPING) and of its float64 cut (SCALE_OUT_CUT_G glaciers, 6
    months, Adam 2 then LM 2 at SCALE_OUT_CUT_CG CG iterations, λ0
    SCALE_OUT_CUT_DAMPING), θ compared bitwise with rank 0's after
    every iteration; one Adam epoch of the full width timed and profiled;
    ``multistart_train`` of the full width from SCALE_OUT_RESTARTS restarts
    (SCALE_OUT_MS_EPOCHS Adam epochs); ``eki_train`` on phase 11's section
    1. Returns numpy and numbers only."""
    from odinn_tpu_torch.parallel.mesh import mesh_size, replicate, shard_inversion
    from odinn_tpu_torch.simulation.eki import eki_train
    from odinn_tpu_torch.simulation.ensemble import multistart_train
    from odinn_tpu_torch.simulation.inversion import Inversion, _tree_leaves, train_ude

    counters = kernel_counters()
    out = {"ranks": mesh_size(mesh)}
    same = []

    def same_on_every_rank(stats):
        if mesh is not None:
            from0 = _tree_leaves(replicate(stats.theta, mesh))
            same.append(all(torch.equal(a, b) for a, b in zip(_tree_leaves(stats.theta), from0)))

    for name, kw, epochs, cg, damping in (
            ("full", {}, SCALE_OUT_EPOCHS, LM_CG, SCALE_OUT_DAMPING),
            ("cut", dict(n_g=SCALE_OUT_CUT_G, tspan=SCALE_OUT_CUT_TSPAN, dtype=torch.float64),
             SCALE_OUT_CUT_EPOCHS, SCALE_OUT_CUT_CG, SCALE_OUT_CUT_DAMPING)):
        inv, model, params, tstops, _ = training_problem("SI", "jax", **kw)
        params = params.replace(hyper=dataclasses.replace(
            params.hyper, optimizer=("adam", "lm"), learning_rate=(0.05, damping), epochs=epochs,
            gn_cg_iters=cg))
        inv.parameters = params
        theta0 = _tree_to(inv.theta, "cuda", None)
        local = shard_inversion(inv.theta, inv.glaciers, mesh)[1]
        torch.cuda.synchronize()
        _reset(counters)
        t0 = time.perf_counter()
        res = train_ude(inv, callback=same_on_every_rank, mesh=mesh)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        stats = res.stats
        out[name] = {"seconds": seconds, "launches": _read(counters), "solves": stats.solves,
                     "gradients": stats.gradients, "jvps": lm_jvps(epochs[1], cg),
                     "lm_iterations": epochs[1],
                     "intervals": len(tstops) - 1, "glaciers_per_rank": local.H0.shape[0],
                     "losses": list(stats.losses), "adam_epochs": epochs[0],
                     "theta": _leaves_np(inv.theta),
                     "H": res.simulation["H"].detach().double().cpu().numpy()}
        if name == "full":
            full = (inv, model, params, tstops, theta0)
    out["theta_same_every_iteration"] = bool(all(same)) if mesh is not None else None
    out["bitwise_checks"] = len(same)

    inv, model, params, tstops, theta0 = full
    inv.theta = _tree_to(theta0, "cuda", None)
    out["epoch"] = epoch_profile(adam_epoch_fn(inv, model, params, tstops, mesh))

    adam = params.replace(hyper=dataclasses.replace(
        params.hyper, optimizer=("adam",), learning_rate=(0.05,),
        epochs=(SCALE_OUT_MS_EPOCHS,)))
    ms_inv = Inversion(model=model, glaciers=inv.glaciers, parameters=adam,
                       theta=_tree_to(theta0, "cuda", None), device="cuda")
    _reset(counters)
    t0 = time.perf_counter()
    ms = multistart_train(ms_inv, n_restarts=SCALE_OUT_RESTARTS, seed=0, mesh=mesh)
    torch.cuda.synchronize()
    out["multistart"] = {"seconds": time.perf_counter() - t0, "launches": _read(counters),
                         "losses": ms.losses, "final_losses": ms.final_losses,
                         "best_idx": ms.best_idx, "intervals": len(tstops) - 1}

    temps = np.linspace(-25.0, -14.0, EKI_GLACIERS)
    eki_inv = eki_problem(EKI_GLACIERS, EKI_NX, temps,
                          dict(solver="SI", cg_iters=EKI_CG, substeps=1), "eki")
    _reset(counters)
    t0 = time.perf_counter()
    er = eki_train(eki_inv, n_ensemble=EKI_MEMBERS, n_iters=EKI_ITERS, init_scale=0.5, seed=0,
                   mesh=mesh)
    torch.cuda.synchronize()
    errs = _a_rel_errs(er.best_theta, eki_inv.parameters, temps)
    out["eki"] = {"seconds": time.perf_counter() - t0, "launches": _read(counters),
                  "iterations": er.n_iters, "misfits": er.misfits,
                  "A_rel_err_max": float(errs.max()), "A_rel_err_min": float(errs.min()),
                  "intervals": int(round((EKI_TSPAN[1] - EKI_TSPAN[0]) * 12))}
    return out


def scale_out_worker(argv) -> int:
    """One rank of phase 13 (``python -m chip_smoke RANK N PORT 1
    --scale-out-worker DIR``, as ``launch_local_workers`` starts it): joins
    the gloo job on the card, runs :func:`scale_out_runs` on the job's mesh
    and writes what it measured to DIR/rank<RANK>.pkl."""
    import pickle

    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from odinn_tpu_torch.parallel.multiprocess import global_mesh, init_distributed

    rank, n, port, devs = int(argv[0]), int(argv[1]), argv[2], int(argv[3])
    out_dir = argv[argv.index("--scale-out-worker") + 1]
    init_distributed(f"localhost:{port}", n, rank, devices_per_process=devs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = scale_out_runs(global_mesh())
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()
    return 0


def _lm_falls(losses, adam_epochs) -> bool:
    """Finite losses whose LM stage (the records after the Adam epochs)
    never rises and ends below its start."""
    trace = losses[adam_epochs:]
    return bool(np.isfinite(losses).all() and trace[-1] < trace[0]
                and all(b <= a for a, b in zip(trace, trace[1:])))


def scale_out_phase():
    """Phase 13: the glacier axis split over SCALE_OUT_RANKS gloo ranks
    that share the card. The kernels are built (phase 2), so the ranks load
    them and run no nvcc. The single-process runs of
    :func:`scale_out_runs` in this process, then the same runs in the job
    (``launch_local_workers``, its own timeout; a rank's failure fails the
    run). Checks: the float64 cut's losses and θ (per leaf) and gathered
    trajectories equal to the single process's to
    TOL_SCALE_OUT_LOSS_F64 and TOL_SCALE_OUT_F64 (the cut's LM stage
    rejects one step and accepts one, so θ after it holds the all-reduced
    Jᵀr, JᵀJ·v and Σr²); the float32 Adam losses and trajectories to
    TOL_SCALE_OUT_F32; both runs' LM stages falling, in the single process
    and on every rank; θ bitwise the same on every rank after every
    iteration and at the end;
    per rank, si_step = 24 x solves, si_step_transpose = si_step_vjp = 24 x
    (Adam gradients + LM pullbacks: one an LM iteration and one a J·v
    product) and si_step_tangent = 24 x J·v products, on 8 of the 16
    glaciers; multistart_train's loss curves and final losses (2 restarts
    a rank, 32 planes a launch) to TOL_SCALE_OUT_F32 of the single
    process's fold, with its launches; eki_train (16 members a rank) meeting
    phase 11's A gate, with its launches. Prints one ``scale_out`` line.
    Returns the launches of the single-process runs and of every rank."""
    import pickle
    import tempfile

    from odinn_tpu_torch.parallel.multiprocess import launch_local_workers

    counters = kernel_counters()
    total = {k: 0 for k in counters}
    t0 = time.perf_counter()
    ref = scale_out_runs(None)
    single_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        t1 = time.perf_counter()
        launch_local_workers(SCALE_OUT_RANKS, 1, ["--scale-out-worker", d],
                             timeout=SCALE_OUT_TIMEOUT, module="chip_smoke")
        job_s = time.perf_counter() - t1
        ranks = []
        for r in range(SCALE_OUT_RANKS):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as fh:
                ranks.append(pickle.load(fh))
    for run in (ref, *ranks):
        for key in ("full", "cut", "multistart", "eki"):
            _add(total, run[key]["launches"])

    fails, per_rank = [], []
    for run, adam in (("full", SCALE_OUT_EPOCHS[0]), ("cut", SCALE_OUT_CUT_EPOCHS[0])):
        if not _lm_falls(ref[run]["losses"], adam):
            fails.append(f"the single process's {run} LM stage did not fall: "
                         f"{ref[run]['losses']}")
    for r, out in enumerate(ranks):
        errs = {
            "cut_losses": _np_rel(out["cut"]["losses"], ref["cut"]["losses"]),
            "cut_theta": max(_np_rel(a, b) for a, b in zip(out["cut"]["theta"],
                                                           ref["cut"]["theta"])),
            "cut_trajectories": _np_rel(out["cut"]["H"], ref["cut"]["H"]),
            "full_adam_losses": _np_rel(out["full"]["losses"][:SCALE_OUT_EPOCHS[0]],
                                        ref["full"]["losses"][:SCALE_OUT_EPOCHS[0]]),
            "full_losses": _np_rel(out["full"]["losses"], ref["full"]["losses"]),
            "full_theta": max(_np_rel(a, b) for a, b in zip(out["full"]["theta"],
                                                            ref["full"]["theta"])),
            "full_trajectories": _np_rel(out["full"]["H"], ref["full"]["H"]),
            "multistart_losses": _np_rel(out["multistart"]["losses"],
                                         ref["multistart"]["losses"]),
            "multistart_final": _np_rel(out["multistart"]["final_losses"],
                                        ref["multistart"]["final_losses"]),
            "eki_misfits": _np_rel(out["eki"]["misfits"], ref["eki"]["misfits"]),
        }
        theta_equal = all(np.array_equal(a, b) for run in ("full", "cut")
                          for a, b in zip(out[run]["theta"], ranks[0][run]["theta"]))
        expected = {}
        for run in ("full", "cut"):
            # LM pulls back through the same backward: Jᵀr once an
            # iteration and Jᵀ(J·v) once a J·v product
            o, n_int = out[run], out[run]["intervals"]
            pullbacks = o["gradients"] + o["jvps"] + o["lm_iterations"]
            expected[run] = dict({k: 0 for k in counters}, si_step=n_int * o["solves"],
                                 si_step_transpose=n_int * pullbacks,
                                 si_step_vjp=n_int * pullbacks,
                                 si_step_tangent=n_int * o["jvps"])
        n_int = out["multistart"]["intervals"]
        expected["multistart"] = dict(
            {k: 0 for k in counters}, si_step=n_int * (SCALE_OUT_MS_EPOCHS + 1),
            si_step_transpose=n_int * SCALE_OUT_MS_EPOCHS, si_step_vjp=n_int * SCALE_OUT_MS_EPOCHS)
        n_int = out["eki"]["intervals"]
        expected["eki"] = dict({k: 0 for k in counters},
                               si_step=n_int * (out["eki"]["iterations"] + 1) + n_int)
        lm_trace = out["full"]["losses"][SCALE_OUT_EPOCHS[0]:]
        row = {"rank": r, "errors": errs, "theta_equal_to_rank0": theta_equal,
               "theta_same_every_iteration": out["theta_same_every_iteration"],
               "bitwise_checks": out["bitwise_checks"],
               "glaciers_per_rank": out["full"]["glaciers_per_rank"],
               "launches": {k: out[k]["launches"] for k in expected},
               "expected_launches": expected,
               "seconds": {k: out[k]["seconds"] for k in ("full", "cut", "multistart", "eki")},
               "full_losses": out["full"]["losses"], "lm_trace": lm_trace,
               "cut_losses": out["cut"]["losses"],
               "eki_A_rel_err": [out["eki"]["A_rel_err_max"], out["eki"]["A_rel_err_min"]],
               **out["epoch"]}
        per_rank.append(row)
        if not (errs["cut_losses"] <= TOL_SCALE_OUT_LOSS_F64
                and errs["cut_theta"] <= TOL_SCALE_OUT_F64
                and errs["cut_trajectories"] <= TOL_SCALE_OUT_F64
                and errs["full_adam_losses"] <= TOL_SCALE_OUT_F32
                and errs["full_trajectories"] <= TOL_SCALE_OUT_F32
                and errs["multistart_losses"] <= TOL_SCALE_OUT_F32
                and errs["multistart_final"] <= TOL_SCALE_OUT_F32):
            fails.append(f"rank {r} disagrees with the single process: {errs}")
        if not (theta_equal and out["theta_same_every_iteration"] and out["bitwise_checks"] > 0):
            fails.append(f"rank {r}: θ differs between the ranks")
        if row["launches"] != expected:
            fails.append(f"rank {r}: launches {row['launches']}, expected {expected}")
        if row["glaciers_per_rank"] != N_TRAIN // SCALE_OUT_RANKS:
            fails.append(f"rank {r}: {row['glaciers_per_rank']} glaciers")
        for run, adam in (("full", SCALE_OUT_EPOCHS[0]), ("cut", SCALE_OUT_CUT_EPOCHS[0])):
            if not _lm_falls(out[run]["losses"], adam):
                fails.append(f"rank {r}: the {run} run's LM stage did not fall: "
                             f"{out[run]['losses']}")
        if not (row["eki_A_rel_err"][0] <= 1e-3 and row["eki_A_rel_err"][1] <= 1e-4):
            fails.append(f"rank {r}: EKI misses the A gate: {row['eki_A_rel_err']}")
    row = {"phase": "scale_out", "backend": "gloo", "ranks": SCALE_OUT_RANKS,
           "device": torch.cuda.get_device_name(0), "seconds": time.perf_counter() - t0,
           "single_process_s": single_s, "job_s": job_s,
           "single_process": {"seconds": {k: ref[k]["seconds"] for k in
                                          ("full", "cut", "multistart", "eki")},
                              "launches": {k: ref[k]["launches"] for k in
                                           ("full", "cut", "multistart", "eki")},
                              "full_losses": ref["full"]["losses"],
                              "cut_losses": ref["cut"]["losses"],
                              "eki_A_rel_err": [ref["eki"]["A_rel_err_max"],
                                                ref["eki"]["A_rel_err_min"]],
                              **ref["epoch"]},
           "per_rank": per_rank,
           "tolerances": {"f64_losses": TOL_SCALE_OUT_LOSS_F64, "f64": TOL_SCALE_OUT_F64,
                          "f32": TOL_SCALE_OUT_F32}}
    emit(row)
    if fails:
        raise AssertionError("scale_out: " + "; ".join(fails))
    return total


# ---------------------------------------------------------------------------
# Phase 14: grid-row sharding
# ---------------------------------------------------------------------------

def spatial_epoch_profile(adam_epoch):
    """One rank's Adam epoch, right after the training it repeats (so no
    warm-up): its time by CUDA events with the row-group collectives it
    makes and their wall seconds, then one more epoch under the profiler
    for its device busy time, idle share and our kernels' device ms. Two
    epochs: at ~3.7 s an epoch on a card that two ranks share, the phase
    affords no more."""
    from odinn_tpu_torch.parallel import spatial

    spatial.EXCHANGES.update(calls=0, seconds=0.0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    adam_epoch()
    end.record()
    end.synchronize()
    epoch_ms = start.elapsed_time(end)
    exchanges = dict(spatial.EXCHANGES)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        adam_epoch()
        torch.cuda.synchronize()
    busy_ms, launches, _, ms_of = _profile_sums(prof)
    return {"adam_epoch_ms": epoch_ms, "adam_epoch_device_busy_ms": busy_ms,
            "adam_epoch_device_idle_share": 1.0 - busy_ms / epoch_ms,
            "adam_epoch_collectives": exchanges["calls"],
            "adam_epoch_collective_s": exchanges["seconds"],
            "adam_epoch_device_launches": launches,
            "adam_epoch_kernel_device_ms": {n: ms for n, ms in ms_of.items()
                                            if n in KERNEL_NAMES}}


def spatial_runs(mesh, which):
    """Phase 14's runs of ``which``, in one process (``mesh`` None) or as
    this rank of the job's 2-D mesh, each with the launch counters and the
    collective count set to 0 just before and read just after. "full":
    ``train_ude`` of phase 5's SI problem (A = NN(T), 16 x 128^2, float32,
    PCG-20, 24 intervals) by Adam SPATIAL_EPOCHS, θ compared bitwise with
    rank 0's after every iteration, and one Adam epoch profiled. "cut":
    phase 13's float64 cut over SPATIAL_CUT_TSPAN at PCG-SPATIAL_CUT_CG (Adam
    2 then LM 2 from λ0 1e5, by autograd), the discrete adjoint's loss and
    gradient at θ0, and
    forward RK4 and RKC-25 rows of its glaciers over SPATIAL_ROW_TSPAN
    (Cuffey–Paterson A). Both then run :func:`controller_runs`. Returns
    numpy and numbers only."""
    from odinn_tpu_torch.laws.laws import CuffeyPaterson
    from odinn_tpu_torch.models.model import Model, SIA2DModel
    from odinn_tpu_torch.parallel import spatial
    from odinn_tpu_torch.parallel.mesh import gather_rows, replicate, shard_inversion
    from odinn_tpu_torch.simulation.inversion import _tree_leaves, train_ude
    from odinn_tpu_torch.simulation.prediction import forward_batch
    from odinn_tpu_torch.simulation.solver import build_tstops

    counters = kernel_counters()
    out = {}
    same = []

    def same_on_every_rank(stats):
        if mesh is not None:
            from0 = _tree_leaves(replicate(stats.theta, mesh))
            same.append(all(torch.equal(a, b) for a, b in zip(_tree_leaves(stats.theta), from0)))

    def start():
        torch.cuda.synchronize()
        _reset(counters)
        spatial.EXCHANGES.update(calls=0, seconds=0.0)
        return time.perf_counter()

    def finish(t0, **rec):
        torch.cuda.synchronize()
        return dict(rec, seconds=time.perf_counter() - t0, launches=_read(counters),
                    collectives=spatial.EXCHANGES["calls"],
                    collective_s=spatial.EXCHANGES["seconds"])

    if which == "full":
        inv, model, params, tstops, _ = training_problem("SI", "jax")
        params = params.replace(hyper=dataclasses.replace(
            params.hyper, optimizer=("adam",), learning_rate=(0.05,), epochs=(SPATIAL_EPOCHS,)))
        cg, lm_iters, jvps = SI_TRAIN_CG, 0, 0
    else:
        inv, model, params, tstops, _ = training_problem(
            "SI", "jax", n_g=SCALE_OUT_CUT_G, tspan=SPATIAL_CUT_TSPAN, dtype=torch.float64)
        params = params.replace(
            solver=dataclasses.replace(params.solver, cg_iters=SPATIAL_CUT_CG),
            hyper=dataclasses.replace(params.hyper, optimizer=("adam", "lm"),
                                      learning_rate=(0.05, SCALE_OUT_CUT_DAMPING),
                                      epochs=SCALE_OUT_CUT_EPOCHS, gn_cg_iters=SCALE_OUT_CUT_CG))
        cg, lm_iters = SPATIAL_CUT_CG, SCALE_OUT_CUT_EPOCHS[1]
        jvps = lm_jvps(lm_iters, SCALE_OUT_CUT_CG)
    inv.parameters = params
    theta0 = _tree_to(inv.theta, "cuda", None)
    local = shard_inversion(inv.theta, inv.glaciers, mesh)[1]
    t0 = start()
    res = train_ude(inv, callback=same_on_every_rank, mesh=mesh)
    stats = res.stats
    out["train"] = finish(t0, solves=stats.solves, gradients=stats.gradients, jvps=jvps,
                          lm_iterations=lm_iters, cg_iters=cg, intervals=len(tstops) - 1,
                          glaciers_per_rank=local.H0.shape[0], rows_per_rank=local.H0.shape[-2],
                          losses=list(stats.losses), theta=_leaves_np(inv.theta),
                          H=res.simulation["H"].detach().double().cpu().numpy())
    out["theta_same_every_iteration"] = bool(all(same)) if mesh is not None else None
    out["bitwise_checks"] = len(same)
    if which == "full":
        inv.theta = _tree_to(theta0, "cuda", None)
        out["epoch"] = spatial_epoch_profile(adam_epoch_fn(inv, model, params, tstops, mesh))
        out["controllers"] = controller_runs(mesh, which, inv, model, params, tstops, theta0,
                                             start, finish)
        return out

    # the discrete adjoint's loss and gradient at θ0
    pd = params.replace(UDE=dataclasses.replace(params.UDE, grad="discrete"))
    inv.theta = _tree_to(theta0, "cuda", None)
    vg, gstats = grad_fn(inv, pd, mesh)
    theta = _tree_to(theta0, "cuda", None)
    t0 = start()
    val, grads = vg(theta, local)
    out["discrete"] = finish(t0, loss=float(val), solves=gstats.solves,
                             gradients=gstats.gradients, cg_iters=cg,
                             intervals=len(tstops) - 1,
                             grads=[g.detach().double().cpu().numpy() for g in grads])

    # forward rows through the explicit and RKC kernels on the row slabs
    truth = Model(iceflow=SIA2DModel(A=CuffeyPaterson(), n_value=3.0))
    ts = build_tstops(SPATIAL_ROW_TSPAN, 1.0 / 12.0)
    batch = inv.glaciers
    rows_local = batch if mesh is None else spatial.shard_spatial(batch, mesh, halo=RKC_STAGES)
    for name, solver_kw in (("RK4", dict(solver="RK4", substeps=SPATIAL_RK4_SUBSTEPS)),
                            (f"RKC-{RKC_STAGES}", dict(solver="RKC", rkc_stages=RKC_STAGES,
                                                       substeps=1))):
        p = params.replace(
            simulation=dataclasses.replace(params.simulation, tspan=SPATIAL_ROW_TSPAN),
            solver=dataclasses.replace(params.solver, **solver_kw))
        t0 = start()
        with torch.no_grad():
            H = forward_batch(None, rows_local, truth, p, ts, device="cuda")
            if mesh is not None:
                H = gather_rows(H, mesh, nx=NX)
        out[name] = finish(t0, intervals=len(ts) - 1, substeps=p.solver.substeps,
                           H=H.detach().double().cpu().numpy())
    out["controllers"] = controller_runs(mesh, which, inv, model, params, tstops, theta0,
                                         start, finish)
    return out


def _gather_glaciers(x, mesh):
    """A per-glacier tensor of this rank's glacier block, joined over the
    mesh's glacier groups in glacier order (row rank 0's of each group); as
    it is without a mesh."""
    if mesh is None:
        return x.detach().cpu()
    import torch.distributed as dist

    host = x.detach().to("cpu").contiguous()
    parts = [torch.empty_like(host) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, host)
    return torch.cat(parts[::mesh.size(1)])


def _si_calibration_runs(n, cg, cg_probe, cg_candidates):
    """The (substeps, PCG iterations) of each probe solve that
    calibrate_substeps_si makes to return ``n`` substeps at ``cg``: the
    doubling 1, 2, … n at ``cg_probe``, then the candidates below it up to
    the one taken."""
    runs, k = [], 1
    while k <= n:
        runs.append((k, cg_probe))
        k *= 2
    for c in cg_candidates:
        if c >= cg_probe:
            break
        runs.append((n, c))
        if c == cg:
            break
    return runs


def _gridded_problem(batch, params):
    """The cut's glaciers on a bumpy bed with gridded temperatures that vary
    over the rows, and a model whose laws read grids: A from the gridded
    temperature (Cuffey–Paterson on each cell times a factor of the plane's
    mean, on the staggered grid) and C from the bed's roughness
    (``SyntheticC`` at CTRL_C_MAX)."""
    from odinn_tpu_torch.laws import inputs as I
    from odinn_tpu_torch.laws.laws import Law, SyntheticC, poly_A_paterson_cuffey
    from odinn_tpu_torch.models.model import Model, SIA2DModel
    from odinn_tpu_torch.ops.stencils import avg

    a_of_t = poly_A_paterson_cuffey()

    def apply_a(theta, inp):
        T = inp["T_grid"]
        mean = torch.mean(T, dim=(-2, -1), keepdim=True)
        return avg(a_of_t(T) * (1.0 + 0.1 * torch.tanh(mean / 10.0)))

    x = torch.arange(NX, dtype=torch.float64, device=batch.B.device)
    y = torch.arange(NY, dtype=torch.float64, device=batch.B.device)
    bump = 3.0 * torch.sin(0.3 * x)[:, None] * torch.cos(0.2 * y)[None, :]
    clim = batch.climate
    temps = clim.longterm_temps_gridded + 0.02 * x[:, None] - 0.01 * y[None, :]
    gbatch = batch.replace(B=batch.B + bump.to(batch.B.dtype),
                           climate=dataclasses.replace(clim, longterm_temps_gridded=temps))
    law_a = Law(slot="A", apply_fn=apply_a, inputs=(I.AvgGriddedTemp(),), callback_freq=0.0,
                trainable=False, name="gridA")
    law_c = SyntheticC(params, inputs=(I.TopoRough(),), c_max=CTRL_C_MAX)
    return gbatch, Model(iceflow=SIA2DModel(A=law_a, C=law_c, n_value=3.0))


def _busy(fn, seconds):
    """``fn`` once more, under the profiler: its device busy ms, and the idle
    share of the first (unprofiled) run's ``seconds``."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        with torch.no_grad():
            fn()
        torch.cuda.synchronize()
    busy_ms = _profile_sums(prof)[0]
    return {"device_busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / (1e3 * seconds)}


def controller_runs(mesh, which, inv, model, params, tstops, theta0, start, finish):
    """Phase 14's runs under the host-driven controllers (the constants'
    comment), in one process (``mesh`` None) or as this rank of the job's
    2-D mesh, on the inversion's glaciers at θ0, each between ``start`` and
    ``finish`` (launch counters and collectives from 0). "full": the
    adaptive row. "cut": every run. Trajectories and per-glacier counts are
    gathered over the mesh after each run; losses and gradients summed
    over it. Returns numpy and numbers only."""
    from odinn_tpu_torch.inverse.adjoint_types import ContinuousAdjoint, DiscreteVJP
    from odinn_tpu_torch.inverse.gauss_newton import make_residual_fn
    from odinn_tpu_torch.inverse.gradient import make_adjoint_value_and_grad
    from odinn_tpu_torch.inverse.uncertainty import laplace_posterior
    from odinn_tpu_torch.laws.laws import LawA_inversion
    from odinn_tpu_torch.models.model import Model, SIA2DModel, glacier_index, init_theta
    from odinn_tpu_torch.parallel import spatial
    from odinn_tpu_torch.parallel.mesh import (
        allreduce_sum, gather_rows, make_shard_map_value_and_grad, shard_inversion)
    from odinn_tpu_torch.simulation.inversion import Inversion, _tree_leaves, train_ude
    from odinn_tpu_torch.simulation.prediction import (
        calibrate_substeps, calibrate_substeps_si, forward_glacier, resolve_replay)
    from odinn_tpu_torch.simulation.solver import integrate_adaptive as integ

    out = {}
    batch = inv.glaciers
    local = batch if mesh is None else shard_inversion(theta0, batch, mesh)[1]
    theta = _tree_to(theta0, "cuda", None)
    n_int = len(tstops) - 1

    def gathered(traj):
        H = traj.movedim(0, 1)
        H = H if mesh is None else gather_rows(H, mesh, nx=NX)
        return H.detach().double().cpu().numpy()

    def summed(val, leaves):
        vals = [val] + list(leaves)
        vals = vals if mesh is None else allreduce_sum(vals, mesh)
        return float(vals[0]), [x.detach().double().cpu().numpy() for x in vals[1:]]

    def with_solver(**kw):
        return params.replace(solver=dataclasses.replace(params.solver, **kw))

    def adaptive(key, reltol, model=model, b=local, th=theta):
        rec = {}
        t0 = start()
        integ.rhs_evals = 0
        with torch.no_grad():
            traj, naccs = forward_glacier(th, b, model, with_solver(adaptive=True, reltol=reltol),
                                          tstops, _return_stats=True, _record=rec)
        out[key] = finish(t0, rhs_evals=integ.rhs_evals, reltol=reltol)
        out[key].update(H=gathered(traj), naccs=_gather_glaciers(naccs, mesh).numpy(),
                        trials=_gather_glaciers(rec["trials"], mesh).numpy())

    if which == "full":
        adaptive("adaptive", CTRL_FULL_RELTOL)
        p_ad = with_solver(adaptive=True, reltol=CTRL_FULL_RELTOL)
        out["adaptive"].update(_busy(lambda: forward_glacier(theta, local, model, p_ad, tstops),
                                     out["adaptive"]["seconds"]))
        return out
    adaptive("adaptive", CTRL_RELTOL)

    t0 = start()
    integ.rhs_evals = 0
    n = calibrate_substeps(theta, local, model, with_solver(reltol=CTRL_RELTOL), tstops)
    out["calibrate"] = finish(t0, substeps=n, rhs_evals=integ.rhs_evals)

    t0 = start()
    res = calibrate_substeps_si(theta, local, model, with_solver(reltol=CTRL_SI_RELTOL), tstops,
                                **CTRL_SI_PROBE)
    out["calibrate_si"] = finish(t0, result=list(res), intervals=n_int,
                                 runs=_si_calibration_runs(res[0], res[1], **CTRL_SI_PROBE))

    p_rp = with_solver(adaptive="replay", reltol=CTRL_RELTOL)
    t0 = start()
    integ.rhs_evals = 0
    dts = resolve_replay(p_rp, local, model, theta, tstops).solver.replay_dts
    out["replay_record"] = finish(t0, rhs_evals=integ.rhs_evals, dts=np.asarray(dts))

    # train_ude by the replayed schedule (recorded on the whole batch, as
    # the JAX package records it, then solved on the rows)
    p_tr = p_rp.replace(hyper=dataclasses.replace(
        params.hyper, optimizer=("adam",), learning_rate=(0.05,), epochs=(CTRL_REPLAY_EPOCHS,)))
    inv_r = Inversion(model=model, glaciers=batch, parameters=p_tr,
                      theta=_tree_to(theta0, "cuda", None), device="cuda")
    t0 = start()
    integ.rhs_evals = 0
    res = train_ude(inv_r, mesh=mesh)
    record = np.asarray(inv_r.parameters.solver.replay_dts)[glacier_index(local).cpu().numpy()]
    columns = int(sum(np.any(record[:, i, :] != 0, axis=0).sum()
                      for i in range(record.shape[1])))
    out["train_replay"] = finish(t0, rhs_evals=integ.rhs_evals, solves=res.stats.solves,
                                 gradients=res.stats.gradients, columns=columns,
                                 losses=list(res.stats.losses), theta=_leaves_np(inv_r.theta))
    out["train_replay"]["H"] = res.simulation["H"].detach().double().cpu().numpy()

    # one continuous-adjoint gradient through the rows' SI forward
    adj = ContinuousAdjoint(VJP_method=DiscreteVJP())
    inv_c = Inversion(model=model, glaciers=batch,
                      parameters=params.replace(UDE=dataclasses.replace(params.UDE, grad=adj)),
                      theta=_tree_to(theta0, "cuda", None), device="cuda")
    vg = make_adjoint_value_and_grad(inv_c, "continuous")
    t0 = start()
    val, g = vg(theta, local)
    out["continuous"] = finish(t0, reverse_steps=vg.record["reverse_steps"],
                               host_syncs=vg.record["host_syncs"],
                               n_quadrature=adj.n_quadrature, intervals=n_int,
                               cg_iters=params.solver.cg_iters)
    out["continuous"]["loss"], out["continuous"]["grads"] = summed(val, _tree_leaves(g))
    out["continuous"]["ids"] = glacier_index(local).tolist()
    out["continuous"].update(_busy(lambda: vg(theta, local), out["continuous"]["seconds"]))

    # the per-glacier Laplace posterior of a per-glacier A: the residual's
    # forward, and one J·v (its primal and tangent solves)
    model_a = Model(iceflow=SIA2DModel(A=LawA_inversion(params), n_value=3.0))
    theta_a = init_theta(model_a, batch)
    resid = make_residual_fn(model_a, params, tstops)
    t0 = start()
    post = laplace_posterior(theta_a, local, resid, structure="per_glacier")
    out["laplace"] = finish(t0, cov=post._cov, sigma2=post.sigma2, intervals=n_int,
                            cg_iters=params.solver.cg_iters)

    # gridded law values through an RK4 forward on the rows (the tensor
    # code: no kernel takes gridded values, in either package)
    gbatch, gmodel = _gridded_problem(batch, params)
    glocal = gbatch if mesh is None else spatial.shard_spatial(gbatch, mesh)
    t0 = start()
    with torch.no_grad():
        traj = forward_glacier(None, glocal, gmodel,
                               with_solver(solver="RK4", substeps=SPATIAL_RK4_SUBSTEPS), tstops)
    out["gridded"] = finish(t0, intervals=n_int)
    out["gridded"]["H"] = gathered(traj)

    # the explicit-collective step: glacier blocks with whole planes
    step = make_shard_map_value_and_grad(model, params, tstops, mesh)
    t0 = start()
    val, g = step(theta, batch)
    out["shard_map"] = finish(t0, intervals=n_int)
    out["shard_map"]["loss"] = float(val)
    out["shard_map"]["grads"] = [x.detach().double().cpu().numpy() for x in _tree_leaves(g)]
    return out


def spatial_worker(argv) -> int:
    """One rank of phase 14 (``python -m chip_smoke RANK N PORT 1
    --spatial-worker DIR full|cut``, as ``launch_local_workers`` starts
    it): joins the gloo job on the card, builds the run's 2-D mesh
    (SPATIAL_FULL or SPATIAL_CUT), runs :func:`spatial_runs` on it and
    writes what it measured to DIR/rank<RANK>.pkl."""
    import pickle

    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from odinn_tpu_torch.parallel.multiprocess import init_distributed
    from odinn_tpu_torch.parallel.spatial import make_mesh_2d

    rank, n, port, devs = int(argv[0]), int(argv[1]), argv[2], int(argv[3])
    i = argv.index("--spatial-worker")
    out_dir, which = argv[i + 1], argv[i + 2]
    init_distributed(f"localhost:{port}", n, rank, devices_per_process=devs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh_2d(*(SPATIAL_FULL if which == "full" else SPATIAL_CUT))
    out = spatial_runs(mesh, which)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()
    return 0


def _rows_expected(counters, n_int, cg, solves, pullbacks, tangents):
    """A rank's launches: one si_assemble a step of each forward, transpose
    and tangent solve, then the row PCG (si_rows_apply once more than its
    iterations, si_rows_update once an iteration), and si_step_vjp once a
    step of each pullback; no si_step_cluster."""
    assemble = n_int * (solves + pullbacks + tangents)
    return dict({k: 0 for k in counters}, si_assemble=assemble,
                si_rows_apply=(cg + 1) * assemble, si_rows_update=cg * assemble,
                si_step_vjp=n_int * pullbacks)


def _controller_expected(counters, key, run):
    """A rank's launches of the controller run ``key`` (:func:`controller_runs`):
    the adaptive forwards and probes one sia2d_rhs an RHS evaluation; the
    SI calibration's probe solves on the row PCG; the replay training 3
    sia2d_rhs a recorded column a solve (after the whole-batch recording's
    probes) and 3 sia2d_rhs_vjp one a gradient; the continuous gradient
    the forward on the row PCG, a sia2d_rhs a save (the Hermite slopes)
    and a sia2d_rhs_vjp a pullback (the first slope of each interval,
    three a reverse step while any of the rank's glaciers steps, two λ
    slopes an interval, one a quadrature node); the posterior its
    residual's and its J·v's primal solves and one tangent solve on the
    row PCG; the gridded forward none (the tensor code); the
    explicit-collective step whole planes: si_step, its transpose and
    si_step_vjp once a step."""
    zero = {k: 0 for k in counters}
    if key in ("adaptive", "calibrate", "replay_record"):
        return dict(zero, sia2d_rhs=run["rhs_evals"])
    if key == "calibrate_si":
        steps = [run["intervals"] * n for n, _ in run["runs"]]
        return dict(zero, si_assemble=sum(steps),
                    si_rows_apply=sum(k * (c + 1) for k, (_, c) in zip(steps, run["runs"])),
                    si_rows_update=sum(k * c for k, (_, c) in zip(steps, run["runs"])))
    if key == "train_replay":
        return dict(zero, sia2d_rhs=run["rhs_evals"] + 3 * run["columns"] * run["solves"],
                    sia2d_rhs_vjp=3 * run["columns"] * run["gradients"])
    if key == "continuous":
        n_int = run["intervals"]
        exp = _rows_expected(counters, n_int, run["cg_iters"], 1, 0, 0)
        exp.update(sia2d_rhs=n_int + 1,
                   sia2d_rhs_vjp=sum(1 + 3 * max(s) for s in run["reverse_steps"]) + 2 * n_int
                   + run["n_quadrature"])
        return exp
    if key == "laplace":
        return _rows_expected(counters, run["intervals"], run["cg_iters"], 2, 0, 1)
    if key == "gridded":
        return zero
    if key == "shard_map":
        n_int = run["intervals"]
        return dict(zero, si_step=n_int, si_step_transpose=n_int, si_step_vjp=n_int)
    raise KeyError(key)


def _controller_errors(which, c, cref):
    """The controller runs of one rank (``c``) against the single process's
    (``cref``): relative errors, and the quantities that must be equal."""
    errs, equal = {}, {}
    for key, run in c.items():
        ref = cref[key]
        if key == "adaptive":
            errs[key] = _np_rel(run["H"], ref["H"])
            equal[key] = (np.array_equal(run["naccs"], ref["naccs"])
                          and np.array_equal(run["trials"], ref["trials"]))
        elif key == "calibrate":
            equal[key] = run["substeps"] == ref["substeps"]
        elif key == "calibrate_si":
            equal[key] = run["result"] == ref["result"]
        elif key == "replay_record":
            errs[key] = float(np.abs(run["dts"] - ref["dts"]).max())
            equal[key] = run["dts"].shape == ref["dts"].shape
        elif key == "train_replay":
            errs[key] = max(_np_rel(run["losses"], ref["losses"]), _np_rel(run["H"], ref["H"]),
                            max(_np_rel(a, b) for a, b in zip(run["theta"], ref["theta"])))
        elif key in ("continuous", "shard_map"):
            errs[key] = max(_np_rel(run["loss"], ref["loss"]),
                            max(_np_rel(a, b) for a, b in zip(run["grads"], ref["grads"])))
            if key == "continuous":
                steps = np.asarray(ref["reverse_steps"])[:, run["ids"]]
                equal[key] = np.array_equal(np.asarray(run["reverse_steps"]), steps)
        elif key == "laplace":
            errs[key] = max(_np_rel(run["cov"], ref["cov"]),
                            _np_rel(run["sigma2"], ref["sigma2"]))
        elif key == "gridded":
            errs[key] = _np_rel(run["H"], ref["H"])
            equal[key] = bool(np.isfinite(run["H"]).all())
    return errs, equal


def _controller_ok(which, errs):
    """Each error within its tolerance: float32 trajectories at
    TOL_SCALE_OUT_F32, the replay record at 1e-11 years, the posterior at
    1e-8 (it inverts the Gauss–Newton matrix), the gridded forward at
    TOL_SPATIAL_ROWS_F64, the rest at TOL_SPATIAL_F64."""
    tol = {"replay_record": 1e-11, "laplace": 1e-8, "gridded": TOL_SPATIAL_ROWS_F64}
    default = TOL_SCALE_OUT_F32 if which == "full" else TOL_SPATIAL_F64
    return all(e <= tol.get(k, default) for k, e in errs.items())


def spatial_phase():
    """Phase 14: grid-row sharding on gloo ranks that share the card. The
    single-process runs of :func:`spatial_runs` in this process, then the
    full width on a SPATIAL_FULL mesh (two ranks, 16 x 64 rows each) and the
    float64 cut on a SPATIAL_CUT mesh (four ranks, 2 glaciers x 64 rows
    each), each a job of its own (``launch_local_workers``). Checks: the
    full width's Adam losses and gathered trajectories equal to the single
    process's to TOL_SCALE_OUT_F32; the cut's losses, θ (per leaf) and
    trajectories, and the discrete adjoint's loss and gradient (per leaf),
    to TOL_SPATIAL_F64; the RK4 and RKC-25 rows' gathered trajectories to
    TOL_SPATIAL_ROWS_F64; the controller runs (:func:`controller_runs`)
    to :func:`_controller_ok`'s tolerances with their counts equal and
    their launches :func:`_controller_expected`'s; θ bitwise the same on
    every rank after every
    iteration and at the end; per rank the launches of
    :func:`_rows_expected` for the trainings and the discrete gradient (its
    rematerialising and transpose solves by plain CG: three solves a step),
    sia2d_rhs = 4 x substeps x intervals for RK4 and rkc_interval = one a
    step for RKC; none of si_step. Prints one ``spatial`` line. Returns the
    launches of the single-process runs and of every rank."""
    import pickle
    import tempfile

    from odinn_tpu_torch.parallel.multiprocess import launch_local_workers

    counters = kernel_counters()
    total = {k: 0 for k in counters}
    t0 = time.perf_counter()
    ref = {which: spatial_runs(None, which) for which in ("full", "cut")}
    single_s = time.perf_counter() - t0
    ranks, job_s = {}, {}
    for which, shape in (("full", SPATIAL_FULL), ("cut", SPATIAL_CUT)):
        with tempfile.TemporaryDirectory() as d:
            t1 = time.perf_counter()
            n = shape[0] * shape[1]
            launch_local_workers(n, 1, ["--spatial-worker", d, which], timeout=SPATIAL_TIMEOUT,
                                 module="chip_smoke")
            job_s[which] = time.perf_counter() - t1
            ranks[which] = []
            for r in range(n):
                with open(os.path.join(d, f"rank{r}.pkl"), "rb") as fh:
                    ranks[which].append(pickle.load(fh))
    runs_of = {"full": ("train",), "cut": ("train", "discrete", "RK4", f"RKC-{RKC_STAGES}")}
    for which, keys in runs_of.items():
        for run in [ref[which]] + ranks[which]:
            for key in keys:
                _add(total, run[key]["launches"])
            for c in run["controllers"].values():
                _add(total, c["launches"])

    fails, per_rank = [], []
    for which, keys in runs_of.items():
        for r, out in enumerate(ranks[which]):
            rf = ref[which]
            tr, tref = out["train"], rf["train"]
            if which == "full":
                errs = {"losses": _np_rel(tr["losses"], tref["losses"]),
                        "trajectories": _np_rel(tr["H"], tref["H"]),
                        "theta_vs_single": max(_np_rel(a, b) for a, b in zip(tr["theta"],
                                                                             tref["theta"]))}
                ok = (errs["losses"] <= TOL_SCALE_OUT_F32
                      and errs["trajectories"] <= TOL_SCALE_OUT_F32)
            else:
                dis, dref = out["discrete"], rf["discrete"]
                errs = {"losses": _np_rel(tr["losses"], tref["losses"]),
                        "theta": max(_np_rel(a, b) for a, b in zip(tr["theta"], tref["theta"])),
                        "trajectories": _np_rel(tr["H"], tref["H"]),
                        "discrete_loss": _np_rel(dis["loss"], dref["loss"]),
                        "discrete_grad": max(_np_rel(a, b) for a, b in zip(dis["grads"],
                                                                           dref["grads"]))}
                for row_name in keys[2:]:
                    errs[row_name] = _np_rel(out[row_name]["H"], rf[row_name]["H"])
                ok = (max(errs[k] for k in ("losses", "theta", "trajectories", "discrete_loss",
                                            "discrete_grad")) <= TOL_SPATIAL_F64
                      and max(errs[k] for k in keys[2:]) <= TOL_SPATIAL_ROWS_F64)
            if not ok:
                fails.append(f"{which} rank {r} disagrees with the single process: {errs}")
            theta_equal = all(np.array_equal(a, b) for a, b in
                              zip(tr["theta"], ranks[which][0]["train"]["theta"]))
            if not (theta_equal and out["theta_same_every_iteration"]
                    and out["bitwise_checks"] > 0):
                fails.append(f"{which} rank {r}: θ differs between the ranks")
            n_int = tr["intervals"]
            pullbacks = tr["gradients"] + tr["jvps"] + tr["lm_iterations"]
            expected = {"train": _rows_expected(counters, n_int, tr["cg_iters"], tr["solves"],
                                                pullbacks, tr["jvps"])}
            if which == "cut":
                dis = out["discrete"]
                # the forward solve and each step's rematerialising solve,
                # and each step's transpose solve and pullback
                expected["discrete"] = _rows_expected(counters, n_int, dis["cg_iters"],
                                                      2 * dis["solves"], dis["gradients"], 0)
                rk4 = out["RK4"]
                expected["RK4"] = dict({k: 0 for k in counters},
                                       sia2d_rhs=4 * rk4["substeps"] * rk4["intervals"])
                expected[keys[3]] = dict({k: 0 for k in counters},
                                         rkc_interval=out[keys[3]]["intervals"])
            launches = {k: out[k]["launches"] for k in expected}
            if launches != expected:
                fails.append(f"{which} rank {r}: launches {launches}, expected {expected}")
            ctl = out["controllers"]
            ctl_errs, ctl_equal = _controller_errors(which, ctl, rf["controllers"])
            if not (_controller_ok(which, ctl_errs) and all(ctl_equal.values())):
                fails.append(f"{which} rank {r}: controllers disagree with the single process: "
                             f"{ctl_errs}, equal {ctl_equal}")
            ctl_launches = {k: v["launches"] for k, v in ctl.items()}
            ctl_expected = {k: _controller_expected(counters, k, v) for k, v in ctl.items()}
            if ctl_launches != ctl_expected:
                fails.append(f"{which} rank {r}: controller launches {ctl_launches}, "
                             f"expected {ctl_expected}")
            row = {"mesh": list(SPATIAL_FULL if which == "full" else SPATIAL_CUT), "rank": r,
                   "errors": errs, "theta_equal_to_rank0": theta_equal,
                   "theta_same_every_iteration": out["theta_same_every_iteration"],
                   "bitwise_checks": out["bitwise_checks"],
                   "glaciers_per_rank": tr["glaciers_per_rank"],
                   "rows_per_rank": tr["rows_per_rank"],
                   "launches": launches, "expected_launches": expected,
                   "seconds": {k: out[k]["seconds"] for k in keys},
                   "collectives": {k: out[k]["collectives"] for k in keys},
                   "collective_s": {k: out[k]["collective_s"] for k in keys},
                   "losses": tr["losses"], **out.get("epoch", {}),
                   "controllers": {k: {"seconds": v["seconds"], "collectives": v["collectives"],
                                       "collective_s": v["collective_s"],
                                       "error": ctl_errs.get(k), "equal": ctl_equal.get(k),
                                       "launches": v["launches"],
                                       **{q: v[q] for q in ("device_busy_ms", "device_idle_share",
                                                            "rhs_evals", "substeps", "result")
                                          if q in v}}
                                   for k, v in ctl.items()}}
            per_rank.append(row)
    line = {"phase": "spatial", "backend": "gloo", "device": torch.cuda.get_device_name(0),
            "seconds": time.perf_counter() - t0, "single_process_s": single_s, "job_s": job_s,
            "single_process": {w: {"seconds": {k: ref[w][k]["seconds"] for k in keys},
                                   "losses": ref[w]["train"]["losses"],
                                   "launches": {k: ref[w][k]["launches"] for k in keys},
                                   **ref[w].get("epoch", {}),
                                   "controllers": {k: {q: v[q] for q in (
                                       "seconds", "launches", "device_busy_ms",
                                       "device_idle_share", "rhs_evals", "substeps", "result")
                                       if q in v} for k, v in ref[w]["controllers"].items()}}
                               for w, keys in runs_of.items()},
            "per_rank": per_rank,
            "tolerances": {"f32": TOL_SCALE_OUT_F32, "f64": TOL_SPATIAL_F64,
                           "f64_rows": TOL_SPATIAL_ROWS_F64, "replay_record_years": 1e-11,
                           "laplace": 1e-8}}
    emit(line)
    if fails:
        raise AssertionError("spatial: " + "; ".join(fails))
    return total


def icesheet_params(t0, years):
    """Phase 15's parameters: benchmarks/icesheet_scale.py's params_for."""
    from odinn_tpu_torch.core.params import (
        Parameters, PhysicalParameters, SimulationParameters, SolverParameters, UDEParameters)

    return Parameters(
        physical=PhysicalParameters(min_A=8e-21, max_A=8e-18),
        simulation=SimulationParameters(tspan=(t0, t0 + years), use_MB=False,
                                        use_velocities=False, float_dtype="float32"),
        solver=SolverParameters(solver="SI2", step=1.0 / 12.0, substeps=1, cg_iters=12,
                                cg_iters_predictor=6),
        UDE=UDEParameters(grad="jax"))


def icesheet_batch(n, t0, dtype):
    """The dome on an n x n grid on the card, every field in ``dtype``
    (halfar_glacier builds in float64 and casts): the benchmark's float32
    on a TPU, where JAX runs without x64. (Cast H0 and B alone, the batch
    keeps float64 spacings, which promote the unfused path's stencils to
    float64.)"""
    from odinn_tpu_torch.core.glacier import stack_glaciers
    from odinn_tpu_torch.data.synthetic import halfar_glacier

    dx = 2.56 * ICE_R0 / n
    g = halfar_glacier(nx=n, ny=n, dx=dx, dy=dx, r0=ICE_R0, h0=ICE_H0, A=ICE_A, temp=ICE_TEMP,
                       t_ic=t0, rgi_id=f"icesheet-{n}", device="cuda", dtype=dtype)
    return stack_glaciers([g], device="cuda")


def icesheet_phase():
    """Phase 15: the ice-sheet domain through the public entry points
    (``forward_batch``, the classical inversion's ``batch_transient_loss``
    and its autograd gradient) on the large-plane path, at each of
    ICE_SIZES (1024^2 and 2048^2, 10 years): the forward (240 si_step
    launches, asserted, each one launch of the large-plane path), timed,
    profiled, with its peak memory; one loss and gradient of the scalar-A
    inversion against observations at the span's ends from the forward at
    1.2 A (si_step, its transpose and si_step_vjp 240 each, every one on
    the large-plane routes: si_pcg and si_plane_vjp), timed, profiled by
    kernel, with its peak memory; and over the first ICE_GRAD_INTERVALS the
    same gradient by the kernels against the unfused path's float64
    gradient (float64 to TOL_GRAD_F64, float32 within GRAD_F32_FACTOR times
    the float32 unfused run's error), with the kernels' max |dH| there,
    where the unfused float64 cut fits the card (its peak is measured
    first; a cut that does not fit is recorded with its peak). At 1024^2
    also the final H against the port's float64 run on the unfused path
    (within 2x the float32 unfused run's error, as main_path_rows holds a
    row). Returns the launches of the runs the phase asserts, by wrapper,
    those of the large-plane path and those of the large-plane pullback."""
    from odinn_tpu_torch.core.glacier import ThicknessData
    from odinn_tpu_torch.data.halfar import HalfarParameters, halfar_t0
    from odinn_tpu_torch.laws.laws import ConstantA, LawA_inversion
    from odinn_tpu_torch.models.model import Model, SIA2DModel
    from odinn_tpu_torch.ops.cuda import si_kernel
    from odinn_tpu_torch.simulation.inversion import batch_transient_loss
    from odinn_tpu_torch.simulation.prediction import forward_batch
    from odinn_tpu_torch.simulation.solver import build_tstops
    from odinn_tpu_torch.utils.memory import aot_step_memory

    t_phase = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    counters = kernel_counters()
    none = {k: 0 for k in counters}
    total, plane, plane_vjp = dict(none), 0, 0
    t0 = halfar_t0(HalfarParameters(R0=ICE_R0, H0=ICE_H0, A=ICE_A, n=3.0))

    def unfused(law):
        # evaluated at every RHS call: the solve takes the plain PyTorch path
        return dataclasses.replace(law, callback_freq=None)

    def counted(fn, expected, what):
        # every si_step launch of the phase (forward, transpose, tangent)
        # runs the large-plane path, and every pullback the large-plane one
        nonlocal plane, plane_vjp
        _reset(counters)
        si_kernel.si_step.plane_launches = si_kernel.si_step_vjp.plane_launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = _read(counters)
        got_plane = si_kernel.si_step.plane_launches
        got_vjp = si_kernel.si_step_vjp.plane_launches
        want = dict(none, **expected)
        want_plane = want["si_step"] + want["si_step_transpose"] + want["si_step_tangent"]
        if got != want or got_plane != want_plane or got_vjp != want["si_step_vjp"]:
            raise AssertionError(f"icesheet {what}: launches {got} ({got_plane} on the "
                                 f"large-plane path, {got_vjp} on the large-plane pullback), "
                                 f"expected {want} ({want_plane}, {want['si_step_vjp']})")
        _add(total, got)
        plane += got_plane
        plane_vjp += got_vjp
        return out

    def loss_and_grad(batch, model, params, tstops, dtype):
        theta = {"A": torch.zeros(1, dtype=dtype, device="cuda", requires_grad=True)}
        val = batch_transient_loss(theta, batch, model, params, tstops)
        (g,) = torch.autograd.grad(val, [theta["A"]])
        return val.detach(), g

    def observed(batch, truth, tstops):
        obs = ThicknessData(t=torch.stack([tstops[0], tstops[-1]]).to("cuda", f64).reshape(1, 2),
                            H=torch.stack([truth[:, 0], truth[:, -1]], dim=1))
        return dataclasses.replace(batch, thickness_data=obs)

    def truth_at(batch, params, tstops):
        return forward_batch(None, batch, Model(iceflow=SIA2DModel(A=ConstantA(1.2 * ICE_A))),
                             params, tstops, device="cuda")

    model = Model(iceflow=SIA2DModel(A=ConstantA(ICE_A)))
    for n, years in ICE_SIZES:
        t_row = time.perf_counter()
        path = si_kernel.si_plan(1, n, n, f32).path
        if path != "large-plane":
            raise AssertionError(f"icesheet {n}^2: si_step takes {path}, not the large-plane path")
        params = icesheet_params(t0, years)
        tstops = build_tstops((t0, t0 + years), 1.0 / 12.0)
        n_int = len(tstops) - 1
        batch = icesheet_batch(n, t0, f32)
        fwd = lambda: forward_batch(None, batch, model, params, tstops, device="cuda")
        H = counted(fwd, {"si_step": 2 * n_int}, f"{n}^2 forward")
        if tuple(H.shape) != (1, n_int + 1, n, n) or not torch.isfinite(H).all():
            raise AssertionError(f"icesheet {n}^2: trajectory {tuple(H.shape)} not finite")
        # the profiler can lose a device record, never add one (complete_profile)
        want = {"si_assemble": 2 * n_int, "si_pcg": 2 * n_int}
        busy_ms, _, by_name, profiles = complete_profile(fwd, 1, SI_KERNELS,
                                                         lambda seen: seen == want)
        row = {"phase": "icesheet", "n": n, "years": years, "dx_m": 2.56 * ICE_R0 / n,
               "t0_years": t0, "dtype": str(f32), "path": path,
               "plan": si_kernel.plane_plan(1, n, n, f32)._asdict(),
               "assemble_plan": si_kernel.assemble_plan(1, n, n, f32)._asdict(),
               "vjp_plan": si_kernel.plane_vjp_plan(1, n, n, f32)._asdict(),
               "launches": {"si_step": 2 * n_int}, "plane_launches": 2 * n_int,
               "times_beside": ICE_TIMES_BESIDE,
               "ms": row_ms(fwd, reps=3), "kernel_device_ms": busy_ms,
               "kernel_launches_by_name": by_name, "profiles": profiles,
               "device_busy_ms": device_ms(fwd, 1),
               "max_H_end_m": float(H[0, -1].max())}
        row["device_idle_share"] = 1.0 - row["device_busy_ms"] / row["ms"]
        # peak device memory of each run, as benchmarks/icesheet_scale.py's
        # "hbm" fields hold it
        row["hbm"] = {"si2_forward": aot_step_memory(fwd)[1]}
        if set(by_name) != set(want) or any(not 0 < by_name[k] <= want[k] for k in want):
            raise AssertionError(f"icesheet {n}^2: device kernels {by_name} in profile "
                                 f"{profiles} of at most {PROFILES}, expected {want}")
        if row["max_H_end_m"] <= 0.5 * ICE_H0:
            raise AssertionError(f"icesheet {n}^2: the dome collapsed: {row}")
        batch64 = icesheet_batch(n, t0, f64)
        ok = True
        if n == ICE_SIZES[0][0]:
            plain = Model(iceflow=SIA2DModel(A=unfused(ConstantA(ICE_A))))
            plain32 = counted(lambda: forward_batch(None, batch, plain, params, tstops,
                                                    device="cuda"), {}, "plain forward")
            plain64 = counted(lambda: forward_batch(None, batch64, plain, params, tstops,
                                                    device="cuda"), {}, "plain forward")
            row["final_H_rel_err_vs_f64_plain"] = rel_err(H[:, -1], plain64[:, -1])
            row["f32_plain_final_H_rel_err_vs_f64_plain"] = rel_err(plain32[:, -1],
                                                                    plain64[:, -1])
            row["kernel_vs_f32_plain_rel_err"] = rel_err(H[:, -1], plain32[:, -1])
            ok = (row["final_H_rel_err_vs_f64_plain"]
                  <= 2.0 * row["f32_plain_final_H_rel_err_vs_f64_plain"])
            del plain32, plain64
        del H
        # the scalar-A inversion against the forward at 1.2 A, whole span
        obs = observed(batch, truth_at(batch, params, tstops), tstops)
        inv = Model(iceflow=SIA2DModel(A=LawA_inversion(params, scalar=True)))
        vg = lambda: loss_and_grad(obs, inv, params, tstops, f32)
        loss, grad = counted(vg, {"si_step": 2 * n_int, "si_step_transpose": 2 * n_int,
                                  "si_step_vjp": 2 * n_int}, f"{n}^2 loss and gradient")
        row["loss"], row["grad_A"] = float(loss), float(grad[0])
        row["loss_grad_ms"] = row_ms(vg, reps=3)
        # the gradient's device time by kernel, from one profile: ours (the
        # large-plane forward and transpose solves, si_assemble and si_pcg,
        # and the large-plane pullback) and the largest of PyTorch's own
        busy, _, by_name, ms_of = device_profile(vg, 1, ms_by_name=True)
        ours = SI_KERNELS + ("si_step_vjp_kernel", "si_plane_vjp")
        mine = [k for k in ms_of if any(name in k for name in ours)]
        others = sorted((k for k in ms_of if k not in mine), key=ms_of.get, reverse=True)
        row.update(loss_grad_busy_ms=busy, loss_grad_device_ms=sum(ms_of[k] for k in mine),
                   loss_grad_kernel_ms={k: ms_of[k] for k in mine},
                   loss_grad_launches_by_name={k: by_name[k] for k in mine},
                   loss_grad_other_ms={k: [ms_of[k], by_name[k]] for k in others[:ICE_OTHERS]})
        row["loss_grad_idle_share"] = 1.0 - row["loss_grad_busy_ms"] / row["loss_grad_ms"]
        row["hbm"]["si2_loss_grad"] = aot_step_memory(vg)[1]
        seen = row["loss_grad_launches_by_name"]
        if "si_step_vjp_kernel" in seen or not 0 < seen.get("si_plane_vjp", 0) <= 2 * n_int:
            raise AssertionError(f"icesheet {n}^2: the pullbacks ran as {seen}, expected "
                                 f"{2 * n_int} of si_plane_vjp")
        del obs
        # the depth cut: the first ICE_GRAD_INTERVALS intervals; the unfused
        # float64 gradient's peak memory first, on the run the check reads
        cut = tstops[:ICE_GRAD_INTERVALS + 1]
        c_int = len(cut) - 1
        truth = truth_at(batch, params, cut)
        obs32, obs64 = observed(batch, truth, cut), observed(batch64, truth.double(), cut)
        inv_plain = Model(iceflow=SIA2DModel(A=unfused(LawA_inversion(params, scalar=True))))
        grads = {}
        try:
            _, row["cut_plain_f64_hbm"] = aot_step_memory(lambda: grads.update(plain_f64=counted(
                lambda: loss_and_grad(obs64, inv_plain, params, cut, f64), {},
                "cut plain gradient")[1]))
        except torch.cuda.OutOfMemoryError as exc:
            row["cut_plain_f64_hbm"] = {"error": str(exc).splitlines()[0],
                                        "peak_bytes": torch.cuda.max_memory_allocated()}
            torch.cuda.empty_cache()
        if "plain_f64" in grads:
            grad_launches = {"si_step": 2 * c_int, "si_step_transpose": 2 * c_int,
                             "si_step_vjp": 2 * c_int}
            grads.update(
                kernel_f32=counted(lambda: loss_and_grad(obs32, inv, params, cut, f32),
                                   grad_launches, "cut gradient")[1],
                kernel_f64=counted(lambda: loss_and_grad(obs64, inv, params, cut, f64),
                                   grad_launches, "cut gradient")[1],
                plain_f32=counted(lambda: loss_and_grad(obs32, inv_plain, params, cut, f32),
                                  {}, "cut plain gradient")[1])
            ref = grads["plain_f64"]
            h_cut = forward_batch(None, batch, model, params, cut, device="cuda")
            h_ref = forward_batch(None, batch64, Model(iceflow=SIA2DModel(
                A=unfused(ConstantA(ICE_A)))), params, cut, device="cuda")
            row["cut"] = {
                "intervals": c_int, "grad_A": {k: float(v[0]) for k, v in grads.items()},
                "float64_rel_err": rel_err(grads["kernel_f64"], ref), "tol": TOL_GRAD_F64,
                "float32_rel_err": rel_err(grads["kernel_f32"], ref),
                "f32_plain_rel_err": rel_err(grads["plain_f32"], ref),
                "factor": GRAD_F32_FACTOR,
                "max_abs_dH_m_vs_f64_plain": float((h_cut.double() - h_ref).abs().max())}
            c = row["cut"]
            ok = (ok and c["float64_rel_err"] <= TOL_GRAD_F64
                  and c["float32_rel_err"] <= GRAD_F32_FACTOR * c["f32_plain_rel_err"]
                  and all(torch.isfinite(g).all() and g.abs().max() > 0
                          for g in grads.values()))
            del h_cut, h_ref
        elif n == ICE_SIZES[0][0]:
            raise AssertionError(f"icesheet {n}^2: the unfused float64 cut does not fit: {row}")
        ok = ok and math.isfinite(row["loss"]) and math.isfinite(row["grad_A"])
        if not ok:
            emit(row)
            raise AssertionError(f"icesheet {n}^2 disagrees with the plain path: {row}")
        del batch, batch64, obs32, obs64, truth, grads
        row["seconds"] = time.perf_counter() - t_row
        emit(row)
        torch.cuda.empty_cache()
    emit({"phase": "icesheet_done", "seconds": time.perf_counter() - t_phase,
          "launches": total, "plane_launches": plane, "plane_vjp_launches": plane_vjp})
    return total, plane, plane_vjp


def _tree_to(tree, device, dtype, requires_grad=False):
    """θ on ``device`` in ``dtype`` (None: its own), a copy (leaves
    requiring grad when asked)."""
    from odinn_tpu_torch.simulation.inversion import _tree_map

    return _tree_map(lambda x: x.detach().to(device=device, dtype=dtype or x.dtype).clone()
                     .requires_grad_(requires_grad), tree)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if "--scale-out-worker" in sys.argv:
        return scale_out_worker(sys.argv[1:])
    if "--spatial-worker" in sys.argv:
        return spatial_worker(sys.argv[1:])
    if "--lm-gates-worker" in sys.argv:
        return lm_gates_worker(sys.argv[1:])
    if "--icesheet-worker" in sys.argv:
        return icesheet_worker(sys.argv[1:])
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from odinn_tpu_torch.ops.cuda.build import build_all

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = t0 = time.perf_counter()
    built = build_all()
    # each phase's wall seconds, for the run's time limit (the done line)
    marks = [("build", time.perf_counter())]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": {k: v[0] for k, v in built.items()},
          "ptxas": {k: ptxas_summary(v[1]) for k, v in built.items()}})
    if "--f32-attribution" in sys.argv[1:]:
        f32_attribution()
        return 0

    check_kernels()
    cluster_report()
    marks.append(("checks", time.perf_counter()))
    timing = time_kernels()
    marks.append(("kernel_times", time.perf_counter()))
    launches = main_path_rows()
    for name, n in periodic_rows().items():
        launches[name] += n
    marks.append(("rows", time.perf_counter()))
    for solver in ("RKC", "SI"):
        for grad in ("jax", "discrete"):
            for name, n in training_phase(solver, grad).items():
                launches[name] += n
    for name, n in continuous_gradient_phase().items():
        launches[name] += n
    for solver, problem in (("SI", "ic"), ("RKC", "aggregate")):
        for grad in ("jax", "discrete"):
            for name, n in training_phase(solver, grad, problem).items():
                launches[name] += n
    for name, n in training_phase("SI", "jax", "periodic").items():
        launches[name] += n
    for target in ("Y", "U"):
        for grad in ("jax", "discrete"):
            for name, n in training_phase("SI", grad, target).items():
                launches[name] += n
    pretraining_phase()
    marks.append(("trainings", time.perf_counter()))
    for name, n in tolerance_phase().items():
        launches[name] += n
    marks.append(("tolerance", time.perf_counter()))
    for solver in ("SI", "RKC"):
        for name, n in lm_phase(solver).items():
            launches[name] += n
    marks.append(("lm", time.perf_counter()))
    for name, n in ensemble_phase().items():
        launches[name] += n
    marks.append(("ensembles", time.perf_counter()))
    gates = start_side("--lm-gates-worker")
    ice = start_side("--icesheet-worker")
    launches["si_plane"] = launches["si_plane_vjp"] = 0
    try:
        # phase 3's gradient checks: correctness only, so beside the gates
        check_gradients()
        check_tangents()
        check_adjoint_gradients()
        check_classical_gradients()
        check_law_target_gradients()
        check_replay_gradient()
        marks.append(("gradient_checks", time.perf_counter()))
        for name, n in forward_grad_phase().items():
            launches[name] += n
        marks.append(("forward_grad", time.perf_counter()))
        for name, n in data_io_phase().items():
            launches[name] += n
        marks.append(("data_io", time.perf_counter()))
        for name, n in scale_out_phase().items():
            launches[name] += n
        marks.append(("scale_out", time.perf_counter()))
        for name, n in spatial_phase().items():
            launches[name] += n
        marks.append(("spatial", time.perf_counter()))
        for name, n in join_side(gates, "LM gates").items():
            launches[name] += n
        marks.append(("lm_gates_wait", time.perf_counter()))
        for name, n in join_side(ice, "icesheet").items():
            launches[name] += n
        marks.append(("icesheet_wait", time.perf_counter()))
    finally:
        stop_side(gates)
        stop_side(ice)
    meta = {
        "si_step": ("odinn_tpu_torch/csrc/si_step.cu", "odinn_tpu/ops/pallas/si_kernel.py:174"),
        "sia2d_rhs": ("odinn_tpu_torch/csrc/sia2d_rhs.cu", "odinn_tpu/ops/pallas/sia_kernel.py:137"),
        "rkc_interval": ("odinn_tpu_torch/csrc/rkc_interval.cu",
                         "odinn_tpu/ops/pallas/rkc_kernel.py:166"),
        # the backward of sia2d_rhs_pallas, and the per-stage pullback of
        # rkc_interval_pallas's backward
        "sia2d_rhs_vjp": ("odinn_tpu_torch/csrc/sia2d_rhs_vjp.cu",
                          "odinn_tpu/ops/pallas/sia_kernel.py:195"),
        # the backward of si_step_pallas (_fwd/_bwd), under the production
        # step's implicit-function contract; its transpose solve is
        # si_step.cu's transpose mode, under si_step's "more"
        "si_step_vjp": ("odinn_tpu_torch/csrc/si_step_vjp.cu",
                        "odinn_tpu/ops/pallas/si_kernel.py:222"),
        # no TPU kernel has a tangent: the JAX package takes this one by
        # jax.jvp of its production RHS (and of make_rkc2_step's stages)
        "sia2d_rhs_jvp": ("odinn_tpu_torch/csrc/sia2d_rhs_jvp.cu",
                          "jax.jvp of odinn_tpu/physics/sia2d.py:63 (sia2d_rhs)"),
        # si_step_pallas at the planes no cluster holds: the large-plane
        # path (si_assemble, then the cooperative si_pcg), its launches
        # those of phase 15, where every si_step takes it; the rows axis's
        # si_assemble launches alone are under si_step's assemble_launches
        "si_plane": ("odinn_tpu_torch/csrc/si_plane.cu", "odinn_tpu/ops/pallas/si_kernel.py:174"),
        # the backward of si_step_pallas at those planes: the large-plane
        # pullback, its launches those of phase 15, where every pullback
        # takes it (the checks' launches of it are not counted)
        "si_plane_vjp": ("odinn_tpu_torch/csrc/si_plane_vjp.cu",
                         "odinn_tpu/ops/pallas/si_kernel.py:222"),
        # the PCG of si_step_pallas, split at its two reductions for the
        # rows axis (its assembly is si_plane.cu's si_assemble)
        "si_rows_apply": ("odinn_tpu_torch/csrc/si_rows.cu",
                          "odinn_tpu/ops/pallas/si_kernel.py:174"),
        "si_rows_update": ("odinn_tpu_torch/csrc/si_rows.cu",
                           "odinn_tpu/ops/pallas/si_kernel.py:174"),
    }
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "ms_source", "call_ms",
            "plain_device_ms", "dtype")
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": meta[name][0], "replaces": meta[name][1],
         "launches": launches[name], "max_abs_err": t["max_abs_err"], "ms": t["ms"],
         "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
         "library_ms": None, "ms_source": t["ms_source"], "call_ms": t["call_ms"],
         "plain_device_ms": t["plain_device_ms"],
         "more": [dict({"at": other}, **{k: o[k] for k in keys})
                  for other, o in timing.items() if other != name and o["kernel"] == name],
         **({"transpose_launches": launches["si_step_transpose"],
             "tangent_launches": launches["si_step_tangent"],
             "assemble_launches": launches["si_assemble"]} if name == "si_step" else {})}
        for name, t in timing.items() if name == t["kernel"]
    ]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "phase_seconds": dict([("build", marks[0][1] - t_start)] + [
              (name, t - prev) for (name, t), (_, prev) in zip(marks[1:], marks)])})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
