from . import base  # noqa: F401
from .base import available, create, register  # noqa: F401
from . import ebur128  # noqa: F401
