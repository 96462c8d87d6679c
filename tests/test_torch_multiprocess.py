"""odinn_tpu_torch's multi-process axis (``parallel/multiprocess.py``,
``parallel/mp_worker.py``) on the CPU: the port of tests/test_multiprocess.py.

The JAX package joins 2 processes of 4 virtual devices each; the port runs
one process per device, so its job is 2 ranks over gloo on localhost. Each
rank (``mp_worker``) trains the dry-run problem in one process and then on
the mesh over both, asserts the loss curves, θ and trajectories equal and
θ bitwise the same on both ranks, and rank 0 prints ``MP_OK``. The two
jobs run side by side.
"""

import concurrent.futures
import json

import numpy as np
import pytest


@pytest.fixture(scope="module")
def jobs():
    from odinn_tpu_torch.parallel.multiprocess import dryrun_multichip, launch_local_workers

    pool = concurrent.futures.ThreadPoolExecutor(2)
    futures = {
        # 5 glaciers: the mesh pads them to 6
        "workers": pool.submit(launch_local_workers, 2, 1,
                               ["--device", "cpu", "--glaciers", "5"], timeout=120.0),
        "dryrun": pool.submit(dryrun_multichip, 2, device="cpu", timeout=120.0),
    }
    yield futures
    pool.shutdown(wait=True)


def test_two_process_train_matches_single_process(jobs):
    outs = jobs["workers"].result(timeout=150.0)
    marker = [line for line in outs[0].splitlines() if line.startswith("MP_OK")]
    assert marker, f"no MP_OK marker in worker 0 output:\n{outs[0][-2000:]}"
    payload = json.loads(marker[0][len("MP_OK "):])
    assert payload["processes"] == payload["global_devices"] == 2
    assert payload["devices_per_process"] == 1 and payload["device"] == "cpu"
    assert payload["glaciers"] == 5
    np.testing.assert_allclose(payload["losses"], payload["single_process_losses"], rtol=1e-10)
    assert payload["losses"][-1] < payload["losses"][0]
    assert not any(line.startswith("MP_OK") for line in outs[1].splitlines())


def test_dryrun_multichip(jobs):
    """``dryrun_multichip(2)``: Adam then Levenberg–Marquardt through
    ``train_ude`` on a 2-rank mesh, equal to the single process."""
    record = jobs["dryrun"].result(timeout=150.0)
    assert record["optimizer"] == ["adam", "lm"]
    assert np.isfinite(record["losses"]).all()
    assert record["final_loss"] < record["losses"][0]
    assert record["errors"]["losses"] <= 1e-10 and record["errors"]["theta"] <= 1e-9


def test_one_process_per_device():
    """A process drives one device: ``devices_per_process`` above 1 is
    refused before any job is joined; a CUDA rank without a card raises."""
    import torch

    from odinn_tpu_torch.parallel.multiprocess import init_distributed, is_multiprocess

    with pytest.raises(ValueError, match="one process per device"):
        init_distributed("localhost:1", 2, 0, devices_per_process=4, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_distributed("localhost:1", 2, 0)
    assert not is_multiprocess()


def test_launch_fails_fast_and_times_out():
    """A worker that exits non-zero fails the job at once, quoting its
    output; workers still running at the job's one deadline are killed
    and the job raises."""
    from odinn_tpu_torch.parallel.multiprocess import launch_local_workers

    with pytest.raises(RuntimeError, match=r"worker [01] failed \(rc=1\)"):
        launch_local_workers(2, 1, [], timeout=60.0, module="odinn_tpu_torch.no_such_module")
    with pytest.raises(RuntimeError, match="timed out after 0.5 s"):
        launch_local_workers(2, 1, ["--device", "cpu"], timeout=0.5)
