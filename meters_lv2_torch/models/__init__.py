from . import base  # noqa: F401
from .base import available, create, register  # noqa: F401
from . import cor, ebur128, kmeter, needle, truepeak  # noqa: F401
