"""meters_lv2_torch: the PyTorch / CUDA port of meters_lv2_tpu.

The same meters with the same ``init/update/read`` contracts, for NVIDIA
Hopper cards.  Plain tensor code is PyTorch; each Pallas TPU kernel of the
JAX package becomes a CUDA kernel written by hand (``csrc/``), built with
nvcc at first use.  On CPU tensors every kernel's plain PyTorch version
runs instead.  Importing this package imports neither jax nor
meters_lv2_tpu.
"""

__version__ = "0.1.0"

from . import models, ops  # noqa: F401,E402
from .models import available, create  # noqa: F401,E402
