"""pinc_tpu_torch — the PyTorch/CUDA port of pinc_tpu, an electrostatic
Particle-in-Cell framework, for NVIDIA Hopper cards.

The package keeps pinc_tpu's module names and layout.  Plain tensor code is
PyTorch; the Pallas TPU kernels of pinc_tpu's tiled step are CUDA C++
kernels written for Hopper (``csrc/``, built from source at first use by
``ops/_cuda_build.py``), each with a plain PyTorch version beside it
(``ops/tiled_kernels.py``).  It imports neither jax nor pinc_tpu.
"""

__version__ = "0.1.0"

from .config import PincConfig, required_np
from .grid import BndType, GridSpec
from .population import Particles, SpeciesParams, initialize
from .simulation import Simulation
from .units import Units, alloc_and_normalize

__all__ = [
    "PincConfig", "required_np", "GridSpec", "BndType", "Particles",
    "SpeciesParams", "initialize", "Simulation", "Units",
    "alloc_and_normalize",
]
