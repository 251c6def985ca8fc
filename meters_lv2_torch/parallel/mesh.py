"""A ('dp', 'sp') process mesh on torch.distributed, and the launcher that
starts one process per rank.  Counterpart of
``meters_lv2_tpu/parallel/mesh.py``.

The metering workload is parallel over streams (the reference's "one
plugin instance per track"), so the first axis is data-parallel ('dp').
The second, sequence-parallel axis ('sp') splits time within a stream:
linear-recurrence state composes across ranks (parallel.timepar), fragment
histograms add (psum), peaks combine with pmax, so one long file can ride
every rank.

Rank r sits at (dp_index, sp_index) = divmod(r, sp), the JAX package's
``devices.reshape(dp, sp)``.  Each rank holds only its own block of a
global tensor (``shard_batch`` / ``shard_time``), and the analyses return
this rank's block of each readout; ``gather_outputs`` rebuilds the whole
readout on every rank when a caller wants it.

The collectives keep the JAX names on an axis object (``mesh.sp`` /
``mesh.dp``): ``index``, ``size``, ``all_gather`` (stacked on a new dim 0),
``psum``, ``pmax``, ``pmin``, ``shift`` (the ppermute i -> i+1, zeros on
index 0) and ``select(i, v)`` (index i's value on every rank).  Every
collective of the analyses moves O(state) values; the audio never crosses
ranks.

The backend is chosen by one rule (``choose_backend``) before the world
starts, never by catching an error: NCCL when every rank has a card of its
own (rank r on ``cuda:r``), gloo when the ranks run on the CPU or share
cards.  NCCL refuses two ranks on one card, and gloo has no collectives
for CUDA tensors, so with gloo and CUDA tensors each collective copies its
small tensor to the host, runs there and copies the result back to the
rank's card ("host-staged").  Nothing falls back: NCCL asked for on a
shared card raises, and a rank that asks for a card where there is none
raises.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

# a collective that waits longer than this fails (a rank died or hung)
_TIMEOUT = datetime.timedelta(seconds=600)
def choose_backend(device_type: str, world_size: int, n_cards: int,
                   backend: str | None = None) -> str:
    """The process-group backend for ``world_size`` ranks on ``device_type``
    ("cpu" or "cuda") with ``n_cards`` cards on the machine.

    NCCL when every rank has a card of its own (``world_size <= n_cards``),
    gloo on the CPU or when ranks share cards.  An explicit ``backend`` is
    checked against what the layout allows: NCCL on the CPU or on a shared
    card raises ValueError; gloo is allowed anywhere (on cards it is
    host-staged).  CUDA with no card raises RuntimeError."""
    if backend not in (None, "gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    if device_type == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL runs on CUDA devices only; CPU ranks use gloo")
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device_type!r}")
    if n_cards < 1:
        raise RuntimeError("a rank asked for a CUDA device and the machine has none")
    own = world_size <= n_cards
    if backend == "nccl" and not own:
        raise ValueError(
            f"NCCL cannot put {world_size} ranks on {n_cards} card(s): it refuses two ranks "
            "on one card; use gloo (host-staged collectives) or fewer ranks")
    return backend or ("nccl" if own else "gloo")


def rank_device(rank: int, world_size: int, device_type: str, n_cards: int) -> torch.device:
    """The device of ``rank``: the CPU, ``cuda:rank`` when every rank has a
    card of its own, else ``cuda:(rank % n_cards)`` (shared cards)."""
    if device_type == "cpu":
        return torch.device("cpu")
    choose_backend(device_type, world_size, n_cards)  # raises without a card
    return torch.device("cuda", rank if world_size <= n_cards else rank % n_cards)


class Axis:
    """One mesh axis seen from one rank: its process group, this rank's
    index along it and its size, and the collectives over it.  Every
    collective is called by all ranks of the group, with tensors of the
    same shape and dtype on each."""

    def __init__(self, group, index: int, size: int, device: torch.device, staged: bool):
        self.group = group
        self.index = index
        self.size = size
        self.device = device
        self.staged = staged  # gloo with CUDA tensors: collectives on host copies

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        t = t.detach()
        if t.dtype == torch.bool:
            t = t.to(torch.uint8)
        return (t.cpu() if self.staged else t).contiguous()

    def _back(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return t.to(device=self.device, dtype=dtype)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[size, *t.shape]: every index's t, in index order."""
        if self.size == 1:
            return t[None]
        w = self._wire(t)
        parts = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(parts, w, group=self.group)
        return self._back(torch.stack(parts), t.dtype)

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if self.size == 1:
            return t
        w = self._wire(t).clone()
        dist.all_reduce(w, op=op, group=self.group)
        return self._back(w, t.dtype)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.SUM)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MAX)

    def pmin(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MIN)

    def shift(self, t: torch.Tensor) -> torch.Tensor:
        """Index i-1's t on index i, zeros on index 0: the JAX package's
        ``ppermute(t, [(i, i + 1) for i in range(size - 1)])`` followed by
        its zeroing of shard 0 (an all_gather: t is a few tens of samples
        or fragments)."""
        g = self.all_gather(t)
        return g[self.index - 1] if self.index > 0 else torch.zeros_like(t)

    def select(self, i: int, v: torch.Tensor) -> torch.Tensor:
        """Index i's v on every rank: the psum of v on index i and zeros
        elsewhere (``meters_sharded.py``'s psum-select)."""
        return self.psum(v if self.index == i else torch.zeros_like(v))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a ('dp', 'sp') mesh."""

    dp: Axis
    sp: Axis
    rank: int
    world_size: int
    device: torch.device
    backend: str

    @property
    def shape(self) -> tuple[int, int]:
        return (self.dp.size, self.sp.size)

    @property
    def staged(self) -> bool:
        return self.sp.staged

    def barrier(self) -> None:
        if self.world_size > 1:
            dist.barrier()


def make_mesh(dp: int | None = None, sp: int = 1, *, backend: str | None = None,
              device="cuda") -> Mesh:
    """Build a ('dp', 'sp') mesh over the ranks of an initialised world
    (``launch``, or ``torch.distributed.init_process_group``); called by
    every rank.  ``dp`` defaults to world_size // sp.  ``device`` is "cpu"
    or "cuda" (the rank's card by ``rank_device``, or a given CUDA device).

    Raises ValueError where dp * sp is not the world size, or where the
    world's backend is not the one ``choose_backend`` gives for this layout
    (or the requested ``backend`` is not allowed); RuntimeError without an
    initialised world or, for "cuda", without a card."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised world: start the ranks with "
                           "launch() or torch.distributed.init_process_group")
    world, rank = dist.get_world_size(), dist.get_rank()
    if dp is None:
        dp = world // sp
    if dp < 1 or sp < 1 or dp * sp != world:
        raise ValueError(f"dp={dp} x sp={sp} does not cover the {world} ranks")
    device = torch.device(device)
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
    want = choose_backend(device.type, world, n_cards, backend)
    have = dist.get_backend()
    if have != want:
        raise ValueError(f"the world runs {have}, but {world} rank(s) on {device.type} "
                         f"({n_cards} card(s)) take {want}")
    if device.type == "cuda" and device.index is None:
        device = rank_device(rank, world, "cuda", n_cards)
    staged = have == "gloo" and device.type == "cuda"
    dp_i, sp_i = divmod(rank, sp)
    # every rank creates every group, in the same order (torch.distributed's rule)
    sp_groups = [dist.new_group([i * sp + j for j in range(sp)]) for i in range(dp)]
    dp_groups = [dist.new_group([i * sp + j for i in range(dp)]) for j in range(sp)]
    return Mesh(
        dp=Axis(dp_groups[sp_i], dp_i, dp, device, staged),
        sp=Axis(sp_groups[dp_i], sp_i, sp, device, staged),
        rank=rank, world_size=world, device=device, backend=have,
    )


def _block(mesh: Mesh, x: torch.Tensor, axis: int, name: str) -> torch.Tensor:
    ax = getattr(mesh, name)
    n = x.shape[axis]
    if n % ax.size:
        raise ValueError(f"axis {axis} of length {n} is not divisible by the {name} size "
                         f"{ax.size}")
    step = n // ax.size
    return x.narrow(axis, ax.index * step, step)


def shard_batch(mesh: Mesh, x: torch.Tensor, batch_axis: int = 0) -> torch.Tensor:
    """This rank's block of a global tensor with streams split over 'dp'
    (replicated over 'sp'), on the rank's device."""
    return _block(mesh, x, batch_axis % x.ndim, "dp").to(mesh.device).contiguous()


def shard_time(mesh: Mesh, x: torch.Tensor, batch_axis: int = 0,
               time_axis: int = -1) -> torch.Tensor:
    """This rank's block of a global tensor with streams over 'dp' and time
    over 'sp', on the rank's device."""
    x = _block(mesh, x, batch_axis % x.ndim, "dp")
    return _block(mesh, x, time_axis % x.ndim, "sp").to(mesh.device).contiguous()


def gather_outputs(out: dict, mesh: Mesh, specs=None) -> dict:
    """The whole readout, on every rank, from each rank's blocks.

    ``out`` is a dict of tensors (an ``analyze_*`` result); ``specs`` maps a
    key to its JAX ``out_specs`` axes, a tuple naming "dp", "sp" or None
    per tensor axis (``r128_sharded.OUT_SPECS``).  A key with no spec is
    ("dp",): streams over 'dp' on axis 0, the same block on every 'sp'
    rank.  One world all_gather a key: it moves the readout, never the
    audio."""
    specs = specs or {}
    world = Axis(None, mesh.rank, mesh.world_size, mesh.device, mesh.staged)
    dp, sp = mesh.shape

    def whole(t, spec):
        g = world.all_gather(t).reshape(dp, sp, *t.shape)
        if "sp" in spec:
            rows = [torch.cat(list(g[i]), dim=spec.index("sp")) for i in range(dp)]
        else:
            rows = [g[i, 0] for i in range(dp)]
        return torch.cat(rows, dim=spec.index("dp"))

    return {k: whole(v, specs.get(k, ("dp",))) for k, v in out.items()}


def _rank_main(rank, world_size, fn, device_type, backend, tmp):
    if device_type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank_device(rank, world_size, "cuda", torch.cuda.device_count()))
    args = torch.load(os.path.join(tmp, "args.pt"), weights_only=False)
    store = dist.FileStore(os.path.join(tmp, "store"), world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=_TIMEOUT)
    try:
        result = fn(rank, *args)
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn, world_size: int, *args, device="cuda") -> list:
    """Run ``fn(rank, *args)`` on ``world_size`` ranks, one spawned process
    each, in an initialised world, and return each rank's result in rank
    order (tensors come back on the CPU).

    The world's backend follows ``choose_backend`` for ``device`` ("cpu" or
    "cuda"), decided here, before any rank starts.  The ranks meet through
    a FileStore in a fresh temporary directory (no TCP port); each CPU rank
    runs one intra-op thread; a CUDA rank has its card set as current.
    ``fn`` must be importable by name (a module-level function), its args
    and result picklable.  A rank's exception ends the others and is raised
    here; a collective that waits longer than 600 s fails."""
    import torch.multiprocessing as mp

    device_type = torch.device(device).type
    n_cards = torch.cuda.device_count() if device_type == "cuda" else 0
    backend = choose_backend(device_type, world_size, n_cards)
    tmp = tempfile.mkdtemp(prefix="meters_torch_mesh_")
    try:
        # the arguments go through a file: a spawned child reads its start-up
        # pickle only after its imports, so large ones would start the ranks
        # one after another
        torch.save(args, os.path.join(tmp, "args.pt"))
        mp.spawn(_rank_main, nprocs=world_size, join=True,
                 args=(world_size, fn, device_type, backend, tmp))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), map_location="cpu",
                           weights_only=False) for r in range(world_size)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
