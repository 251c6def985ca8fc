from . import base  # noqa: F401
from .base import available, create, register  # noqa: F401
from . import (  # noqa: F401
    bitmeter, cor, dr14, ebur128, goniometer, kmeter, needle, phasewheel, sigdist, spectrum,
    surround, truepeak)
