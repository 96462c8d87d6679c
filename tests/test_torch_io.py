"""odinn_tpu_torch's persistence, logging, plotting and memory utilities
against odinn_tpu: the training-result, results-file and checkpoint round
trips, ``run_inversion(path, file_name)`` beside the JAX package's on the
same problem, the logger's records, the plots' values, and the modules that
must import and run on a host without ``h5py``, ``matplotlib`` and
``msgpack``. Float64 on the CPU; tolerances per test.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odinn_tpu.core.params as JP
import odinn_tpu_torch.core.params as TP
from odinn_tpu_torch.utils import io as tio
from tests.torch_parity import CPU, assert_rel, carry_glacier, tree_to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_training_result_roundtrip(tmp_path):
    """tests/test_aux.py's round trip: θ (float64 and float32 leaves, a
    history of numpy trees as the trainer keeps it), the histories and the
    sidecar come back as saved."""
    theta = {"A": [{"w": torch.ones((2, 3)), "b": torch.zeros((3,), dtype=torch.float64)}],
             "IC": torch.linspace(0.0, 1.0, 5, dtype=torch.float64)}
    res = tio.TrainingResult(theta=theta, losses=[3.0, 2.0, 1.0], grad_norm_hist=[0.5, 0.4],
                             theta_hist=[{"A": np.full((2,), 1.5)}],
                             params_meta={"target": "A", "niter": 3})
    path = str(tmp_path / "out" / "inv.pt")
    tio.save_inversion_file(path, res)
    back = tio.load_inversion_file(path, device=CPU)
    assert torch.equal(back.theta["A"][0]["w"], theta["A"][0]["w"])
    assert back.theta["A"][0]["w"].dtype == torch.float32
    assert torch.equal(back.theta["IC"], theta["IC"])
    np.testing.assert_array_equal(back.losses.numpy(), [3.0, 2.0, 1.0])
    np.testing.assert_array_equal(back.grad_norm_hist.numpy(), [0.5, 0.4])
    np.testing.assert_array_equal(back.theta_hist[0]["A"].numpy(), [1.5, 1.5])
    assert back.params_meta == {"target": "A", "niter": 3}
    # no sidecar without metadata, and no history when none was kept
    tio.save_inversion_file(str(tmp_path / "bare.pt"), tio.TrainingResult(theta=theta))
    bare = tio.load_inversion_file(str(tmp_path / "bare.pt"), device=CPU)
    assert bare.params_meta is None and bare.theta_hist is None and len(bare.losses) == 0


def test_results_file_roundtrip_both_packages(tmp_path):
    """The results .npz: the port's file read by the JAX package and the
    JAX package's by the port, tuples and strings left out."""
    from odinn_tpu.utils import io as jio

    res_t = {"t": torch.arange(4.0, dtype=torch.float64), "H": torch.ones((2, 4, 8, 8)),
             "rgi_ids": ("a", "b"), "name": "x", "none": None}
    res_j = {"t": jnp.arange(4.0), "H": jnp.ones((2, 4, 8, 8)), "rgi_ids": ("a", "b")}
    tio.save_results_file(str(tmp_path / "t.npz"), res_t)
    jio.save_results_file(str(tmp_path / "j.npz"), res_j)
    for name in ("t.npz", "j.npz"):
        a, b = tio.load_results_file(str(tmp_path / name)), jio.load_results_file(
            str(tmp_path / name))
        assert sorted(a) == sorted(b) == ["H", "t"]
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert tio.load_results_file(str(tmp_path / "t.npz"))["H"].shape == (2, 4, 8, 8)


def test_checkpoint_roundtrip(tmp_path):
    """A train state with an Adam state_dict: the latest step by default,
    a named step on request, the tensors on the device asked for."""
    p = torch.nn.Parameter(torch.full((3,), 2.5, dtype=torch.float64))
    opt = torch.optim.Adam([p], lr=0.1)
    p.grad = torch.ones(3, dtype=torch.float64)
    opt.step()
    ckpt = str(tmp_path / "ckpt")
    tio.save_checkpoint(ckpt, 3, {"theta": {"A": torch.zeros(3)}, "step": 3})
    state = {"theta": {"A": p.detach()}, "opt": opt.state_dict(), "step": 7}
    tio.save_checkpoint(ckpt, 7, state)
    back = tio.restore_checkpoint(ckpt, device=CPU)
    assert back["step"] == 7 and torch.equal(back["theta"]["A"], p.detach())
    opt2 = torch.optim.Adam([torch.nn.Parameter(torch.zeros(3, dtype=torch.float64))], lr=0.1)
    opt2.load_state_dict(back["opt"])
    assert torch.equal(opt2.state_dict()["state"][0]["exp_avg"], opt.state_dict()["state"][0][
        "exp_avg"])
    assert tio.restore_checkpoint(ckpt, step=3, device=CPU)["step"] == 3
    with pytest.raises(FileNotFoundError):
        os.makedirs(tmp_path / "empty")
        tio.restore_checkpoint(str(tmp_path / "empty"), device=CPU)


def _inversion_problem(pkg):
    """tests/test_aux.py::test_run_inversion_autosaves's problem, cut to
    3 months and 2 Adam epochs, in either package (``pkg`` "jax" or
    "torch")."""
    P = JP if pkg == "jax" else TP
    params = P.Parameters(
        physical=P.PhysicalParameters(min_A=8e-21, max_A=8e-18),
        simulation=P.SimulationParameters(tspan=(5.0, 5.25), use_MB=False,
                                          use_velocities=False),
        solver=P.SolverParameters(step=1.0 / 12.0, solver="SI", cg_iters=15),
        hyper=P.Hyperparameters(optimizer=("adam",), learning_rate=(0.05,), epochs=(2,)),
        UDE=P.UDEParameters(grad="jax", target="A"),
    )
    if pkg == "jax":
        from odinn_tpu.data.synthetic import halfar_glacier
        from odinn_tpu.laws.laws import ConstantA, LawA_inversion
        from odinn_tpu.models.model import Model, SIA2DModel
        from odinn_tpu.simulation.inversion import Inversion
        from odinn_tpu.simulation.prediction import generate_ground_truth
        from odinn_tpu.simulation.solver import build_tstops

        kw = {}
    else:
        from odinn_tpu_torch.data.synthetic import halfar_glacier
        from odinn_tpu_torch.laws.laws import ConstantA, LawA_inversion
        from odinn_tpu_torch.models.model import Model, SIA2DModel
        from odinn_tpu_torch.simulation.inversion import Inversion
        from odinn_tpu_torch.simulation.prediction import generate_ground_truth
        from odinn_tpu_torch.simulation.solver import build_tstops

        kw = {"device": CPU}
    glaciers = [halfar_glacier(nx=24, ny=24, dx=150.0, temp=-15.0, rgi_id="p1", **kw)]
    glaciers = generate_ground_truth(glaciers, params, Model(iceflow=SIA2DModel(A=ConstantA(4e-18))),
                                     build_tstops((5.0, 5.25), 1.0 / 12.0), store=("H",), **kw)
    model = Model(iceflow=SIA2DModel(A=LawA_inversion(params, scalar=True)))
    return Inversion(model=model, glaciers=glaciers, parameters=params, **kw)


def test_run_inversion_saves_like_jax(tmp_path):
    """run_inversion(path, file_name) in both packages on the same problem:
    the port's file reloads to θ exactly, its sidecar has the JAX package's
    keys, niter and retcode, and its losses match JAX's (1e-8)."""
    from odinn_tpu.simulation.inversion import run_inversion as j_run
    from odinn_tpu.utils.io import load_inversion_file as j_load
    from odinn_tpu_torch.simulation.inversion import run_inversion

    j_inv = _inversion_problem("jax")
    j_run(j_inv, path=str(tmp_path), file_name="jax.msgpack")
    j_back = j_load(str(tmp_path / "jax.msgpack"))
    inv = _inversion_problem("torch")
    res = run_inversion(inv, path=str(tmp_path), file_name="port.pt")
    back = tio.load_inversion_file(str(tmp_path / "port.pt"), device=CPU)
    assert set(back.theta) == set(inv.theta) == {"A"}
    assert torch.equal(back.theta["A"], inv.theta["A"])
    assert back.params_meta.keys() == j_back.params_meta.keys()
    for k in ("niter", "retcode"):
        assert back.params_meta[k] == j_back.params_meta[k] == {"niter": 2,
                                                                "retcode": "Success"}[k]
    assert_rel(back.losses, np.asarray(j_back.losses), 1e-8, "losses")
    assert len(back.grad_norm_hist) == res.stats.niter == 2
    # the default file name
    run_inversion(_inversion_problem("torch"), path=str(tmp_path / "default"))
    assert os.path.exists(tmp_path / "default" / "training_result.pt")
    assert os.path.exists(tmp_path / "default" / "training_result.pt.meta.json")


def _stats_pair():
    from odinn_tpu.simulation.results import TrainingStats as JStats
    from odinn_tpu_torch.simulation.results import TrainingStats

    return JStats(), TrainingStats()


def test_training_logger_records_match_jax(tmp_path, capsys):
    """The same stats through both loggers give the same train_log.jsonl
    records; combine_callbacks runs each callback; the periodic save and
    law plot run."""
    from odinn_tpu.utils.logging import TrainingLogger as JLogger
    from odinn_tpu_torch.laws.laws import CuffeyPaterson
    from odinn_tpu_torch.data.synthetic import halfar_glacier
    from odinn_tpu_torch.utils.logging import TrainingLogger, combine_callbacks

    g = halfar_glacier(nx=16, ny=16, dx=120.0, temp=-15.0, device=CPU)
    j_log = JLogger(str(tmp_path / "j"), use_tensorboard=False)
    t_log = TrainingLogger(str(tmp_path / "t"), use_tensorboard=False, print_every=2,
                           save_every=2, save_path=str(tmp_path / "t" / "res.pt"),
                           plot_law_every=2, plot_law_cfg=dict(
                               law=CuffeyPaterson(), glacier=g, input_ranges={"T": (-25.0, 0.0)}))
    seen = []
    cb = combine_callbacks(t_log.callback, None, lambda s: seen.append(s.niter))
    js, ts = _stats_pair()
    for it, (loss, gn, dt) in enumerate([(10.0, 1.0, 0.1), (5.0, 0.5, 0.2), (0.0, 0.25, 0.3),
                                         (1e-3, 0.1, 0.05)], start=1):
        for s in (js, ts):
            s.niter = it
            s.losses.append(loss)
            s.grad_norm_hist.append(gn)
            s.time_per_iter.append(dt)
            s.theta = {"A": np.zeros(1)}
        ts.theta = {"A": torch.zeros(1)}
        j_log.callback(js)
        cb(ts)
    j_log.close()
    t_log.close()
    recs = [(tmp_path / d / "train_log.jsonl").read_text().strip().split("\n") for d in "jt"]
    assert len(recs[1]) == 4
    assert [json.loads(r) for r in recs[0]] == [json.loads(r) for r in recs[1]]
    assert seen == [1, 2, 3, 4]
    out = capsys.readouterr().out
    assert "iter 2/-1" in out and "(+50.00%)" in out and "iter 1/-1" not in out.split(
        "[odinn_tpu_torch]")[1]
    assert (tmp_path / "t" / "law_epoch_00004.png").exists()
    saved = tio.load_inversion_file(str(tmp_path / "t" / "res.pt"), device=CPU)
    np.testing.assert_array_equal(saved.losses.numpy(), [10.0, 5.0, 0.0, 1e-3])


def test_plots_write_files_and_law_values_match_jax(tmp_path):
    """Every plot writes its file (tests/test_aux.py::test_plotting's set);
    plot_law's plotted values, a line and a heatmap, equal the JAX
    package's (1e-12)."""
    from odinn_tpu.data.synthetic import halfar_glacier as j_halfar, monthly_dummy_climate
    from odinn_tpu.laws.laws import CuffeyPaterson as JCP, LawU as JLawU
    from odinn_tpu.models.model import Model as JModel, SIA2DModel as JSIA2D, init_theta
    from odinn_tpu.models.nn import NeuralNetwork as JNN, default_architecture as j_arch
    from odinn_tpu.utils import plotting as jpl
    from odinn_tpu_torch.laws.laws import CuffeyPaterson, LawU
    from odinn_tpu_torch.models.nn import NeuralNetwork, default_architecture
    from odinn_tpu_torch.physics.mass_balance import TImodel1
    from odinn_tpu_torch.utils import plotting as tpl

    jg = j_halfar(nx=24, ny=24, dx=120.0, temp=-15.0, climate=monthly_dummy_climate(
        5.0, 24, nx=24, ny=24))
    g = carry_glacier(jg)
    tpl.save_plot(tpl.plot_glacier(g, ("H0", "B"), title="g"), str(tmp_path / "glacier.png"))
    tpl.save_plot(tpl.plot_gridded_data(g.H0, "H0", mask=g.H0 > 0), str(tmp_path / "grid.png"))
    tpl.save_plot(tpl.plot_cumulative_mb(g, TImodel1(), (5.0, 6.0)), str(tmp_path / "mb.png"))
    traj = torch.stack([g.H0, g.H0 * 0.9, g.H0 * 0.8])
    tpl.plot_glacier_vid(str(tmp_path / "vid.gif"), traj, g)

    fig = tpl.plot_law(CuffeyPaterson(), None, g, {"T": (-25.0, 0.0)}, n=9,
                       truth_fn=lambda t: 0.0)
    jfig = jpl.plot_law(JCP(), None, jg, {"T": (-25.0, 0.0)}, n=9)
    assert_rel(fig.axes[0].lines[0].get_ydata(), jfig.axes[0].lines[0].get_ydata(), 1e-12,
               "line")
    tpl.save_plot(fig, str(tmp_path / "law.png"))
    jpl.save_plot(jfig, str(tmp_path / "jlaw.png"))

    kw = dict(max_nn=2000.0, prescale_bounds=((0.0, 500.0), (0.0, 0.3)))
    j_law = JLawU(JNN(j_arch(2, light=True), seed=2), JP.Parameters(), **kw)
    jtheta = init_theta(JModel(iceflow=JSIA2D(U=j_law)), [jg])
    t_law = LawU(NeuralNetwork(default_architecture(2, light=True)), TP.Parameters(), **kw)
    ranges = {"Hbar": (0.0, 500.0), "gradS": (0.0, 0.3)}
    heat = tpl.plot_law(t_law, tree_to_port(jtheta), g, ranges, n=4)
    jheat = jpl.plot_law(j_law, jtheta, jg, ranges, n=4)
    z, jz = heat.axes[0].collections[0].get_array(), jheat.axes[0].collections[0].get_array()
    assert_rel(np.asarray(z), np.asarray(jz), 1e-12, "heatmap")
    tpl.save_plot(heat, str(tmp_path / "heat.png"))
    tpl.save_plot(tpl.plot_law(t_law, tree_to_port(jtheta), g, ranges, n=3, surface=True,
                               truth_fn=lambda h, s: 1e-2 * h * s),
                  str(tmp_path / "law_surface.png"))
    for f in ("glacier.png", "grid.png", "law.png", "mb.png", "vid.gif", "heat.png",
              "law_surface.png"):
        assert (tmp_path / f).stat().st_size > 0, f
    with pytest.raises(ValueError):
        tpl.plot_law(CuffeyPaterson(), None, g, {}, n=2)


def test_memory_utilities_on_the_cpu():
    """The allocator statistics are the card's: None for the CPU, and the
    step measurement refuses to run without a CUDA device."""
    from odinn_tpu_torch.utils.memory import aot_step_memory, live_hbm_gib

    assert live_hbm_gib("cpu") is None
    if not torch.cuda.is_available():
        assert live_hbm_gib() is None
        with pytest.raises(RuntimeError, match="no CUDA device"):
            aot_step_memory(lambda: None)


_WITHOUT_OPTIONAL = r"""
import os, sys, tempfile
for name in ("h5py", "matplotlib", "msgpack", "tensorboard", "jax", "flax", "orbax",
             "odinn_tpu"):
    sys.modules[name] = None
import numpy as np
import torch
from odinn_tpu_torch.core.params import Parameters, SimulationParameters
from odinn_tpu_torch.data import netcdf, rgi
from odinn_tpu_torch.models import mb_machine
from odinn_tpu_torch.utils import io, logging, memory, plotting, time_utils

d = tempfile.mkdtemp()
ids = rgi.generate_synthetic_rgi_dir(d, n=2, nx=16, ny=16, seed=0)
p = Parameters(simulation=SimulationParameters(grid_scaling_factor=2, tspan=(2010.0, 2011.0)))
gl = rgi.initialize_glaciers(ids, p, prepro_dir=d, device="cpu", dtype=torch.float32)
assert gl[1].H0.shape == (8, 8) and gl[1].H0.dtype == torch.float32
io.save_inversion_file(os.path.join(d, "r.pt"), io.TrainingResult(
    theta={"A": gl[0].H0}, losses=[1.0], params_meta={"niter": 1}))
assert torch.equal(io.load_inversion_file(os.path.join(d, "r.pt"), device="cpu").theta["A"],
                   gl[0].H0)
io.save_checkpoint(os.path.join(d, "c"), 1, {"x": gl[0].B})
assert torch.equal(io.restore_checkpoint(os.path.join(d, "c"), device="cpu")["x"], gl[0].B)
io.save_results_file(os.path.join(d, "res.npz"), {"H": gl[0].H0})
assert io.load_results_file(os.path.join(d, "res.npz"))["H"].shape == (8, 8)
log = logging.TrainingLogger(os.path.join(d, "log"), use_tensorboard=True)
assert log._tb is None
log.close()
assert time_utils.floatyear_to_datetime(2010.5).month == 7
try:
    netcdf.read_netcdf(os.path.join(d, "none.nc"))
except ImportError:
    pass
else:
    raise AssertionError("read_netcdf ran without h5py")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("h5py", "matplotlib", "msgpack", "tensorboard")
             and sys.modules[m] is not None)
assert not bad, bad
print("ok")
"""


def test_port_data_path_runs_without_h5py_matplotlib_msgpack():
    """A GPU host may have no h5py, matplotlib, msgpack or tensorboard:
    with them (and JAX) blocked in sys.modules, a fresh interpreter imports
    the port's data, I/O, logging, memory, time and plotting modules, loads
    .npz glaciers and round-trips results and checkpoints; reading a .nc
    file is what needs h5py."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _WITHOUT_OPTIONAL], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
