"""The check's control and faults come out as not correct.

The control is the reference in float32 with TF32 products standing in
the program's place.  The faults break the timed path underneath a run
that is otherwise whole: an update that returns its state unchanged, half
of the batch left out of each update, and an answer altered where read()
produces it.  On CPU tensors at a test size, with the cells' limits."""


import pytest
import torch

from meters_lv2_torch.parallel.pipeline import freeze
from portbench import harness
from portbench.reference.lti import CONTROL

TINY = {
    # a programme of 10 s gates integrated loudness and LRA in; a window
    # finishes one
    "r128_batch": ({"batch": 8, "block": 4800, "pool_blocks": 100, "programme_blocks": 100}, 0.5),
    "qc_batch": ({"batch": 4, "block": 4800, "pool_blocks": 3, "programme_blocks": 3}, 3.0),
}
SEED = 2**31 + 23


def _run(cell, **kw):
    ov, seconds = TINY[cell]
    return harness.run_cell(harness.load_cell(cell, ov), SEED, seconds, False, device="cpu", **kw)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_is_not_correct(cell):
    r = _run(cell, control=CONTROL)
    assert r["correct"] is True, r["checks"]
    assert r["control_correct"] is False, r["control"]


def _unchanged(ctx):
    ctx.system.update = lambda state, x: state


def _half(ctx):
    update = ctx.system.update

    def half(state, x):
        alive = torch.arange(x.shape[0], device=x.device) < x.shape[0] // 2
        return freeze(state, update(state, x), alive)

    ctx.system.update = half


def _altered(ctx):
    read = ctx.system.read

    def altered(state):
        outs, st = read(state)
        name, o = next(iter(outs.items()))
        if isinstance(o, dict):
            key = next(iter(o))
            o = dict(o, **{key: o[key] + 0.01})
        else:
            o = o + 0.01
        return dict(outs, **{name: o}), st

    ctx.system.read = altered


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered], ids=lambda f: f.__name__[1:])
@pytest.mark.parametrize("cell", sorted(TINY))
def test_fault_is_not_correct(cell, fault):
    r = _run(cell, fault=fault)
    assert r["correct"] is False
    assert r["failed"] > 0
