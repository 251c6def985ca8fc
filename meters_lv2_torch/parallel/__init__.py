"""Batch pipelines over the port's meters."""

from . import pipeline  # noqa: F401
from .pipeline import MeterPipeline  # noqa: F401
