from . import base  # noqa: F401
from .base import available, create, register  # noqa: F401
from . import bitmeter, cor, dr14, ebur128, kmeter, needle, sigdist, spectrum, surround, truepeak  # noqa: F401
