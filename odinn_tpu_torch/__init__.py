"""odinn_tpu_torch: the PyTorch/CUDA port of odinn_tpu.

The same glacier SIA2D physics, laws and solvers on PyTorch tensors, with
hand-written CUDA kernels (``csrc/``, built at first use into
``build/odinn_tpu_torch``) as the card's path of the solve. Modules mirror
``odinn_tpu`` under the same names. Entry points run on the CUDA card unless
they are given ``device="cpu"``.
"""

from odinn_tpu_torch.core.glacier import (
    Climate2D,
    DhdtData,
    DummyClimate2D,
    Glacier,
    SurfaceVelocityData,
    ThicknessData,
    is_in_glacier,
    stack_glaciers,
)
from odinn_tpu_torch.core.params import (
    Hyperparameters,
    InversionParameters,
    Parameters,
    PhysicalParameters,
    SimulationParameters,
    SolverParameters,
    UDEParameters,
)

__version__ = "0.1.0"
