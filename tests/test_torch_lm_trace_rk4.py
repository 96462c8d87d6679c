"""The RK4 row of ``test_torch_lm_trace.py``: three Levenberg–Marquardt
iterations of odinn_tpu_torch against the JAX package's on JAX's probes,
through RK4 at 8 substeps (each RHS the fused kernel's wrapper, its plain
version on the CPU, and its tangent ``sia2d_rhs_jvp``'s). Float64, 2
glaciers on 16² planes, 3 monthly intervals.
"""

import pytest

from tests.test_torch_gauss_newton import truth  # noqa: F401  (the module fixture)
from tests.test_torch_lm_trace import lm_trace_case


@pytest.mark.parametrize("solver,damping", [("RK4", 1e-3)])
def test_lm_trace_matches_jax(truth, solver, damping, monkeypatch):
    """The loss trace of :func:`~tests.test_torch_lm_trace.lm_trace_case`
    through RK4."""
    lm_trace_case(truth, solver, damping, monkeypatch)
