"""Batch pipelines and whole-file analyses over a ('dp', 'sp') mesh of
ranks (torch.distributed)."""

from . import (  # noqa: F401
    mesh,
    meters_sharded,
    pipeline,
    r128_sharded,
    spectrum_sharded,
    timepar,
)
from .mesh import gather_outputs, launch, make_mesh, shard_batch, shard_time  # noqa: F401
from .pipeline import MeterPipeline  # noqa: F401
