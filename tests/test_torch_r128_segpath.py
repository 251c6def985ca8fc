"""Which blocks EbuR128Meter.update sends through r128_fused's seg mode, and
that on CPU tensors the meter's state and readouts are bit-identical to
the full-rate composition seg mode replaces.

A block of T >= 128 samples with T % 128 == 0, at a rate whose fragment
(fs / 20) is longer than 128 samples, takes its fragment sums from
``r128_fused.fused_core(..., off=, fragm=, n_slots=)``; any other block
runs the full-rate core and ``segment.shifted_segments``.  The reference
here is that full-rate path for every block: ``fused_core`` replaced by
``fused_core_reference`` in full rate, then ``shifted_segments`` of the
power at the meter's batch shape, as the meter summed it before seg mode.

Every run starts with an unaligned lead block of fs / 20 - 100 samples,
so the aligned blocks after it meet an open fragment (off != 0) and the
first of them completes it.
"""

import numpy as np
import pytest
import torch

from meters_lv2_torch.models.ebur128 import STATE_FIELDS, EbuR128Meter
from meters_lv2_torch.ops import r128_fused, segment

torch.set_num_threads(1)

NBLOCKS = 6
SHAPES = [(), (3,), (2, 3)]
RATES = [(48000, 128), (48000, 2560), (48000, 48000), (44100, 44160)]
# every rate and block with C = 1, 2 and 5; each block length meets every
# batch shape and both layouts
CASES = [(fs, T, C, SHAPES[(i + j) % 3], (i + j) % 2 == 0)
         for i, (fs, T) in enumerate(RATES) for j, C in enumerate((1, 2, 5))]


def _blocks(fs, C, batch, T, seed):
    """The lead block, then NBLOCKS blocks of T samples: Gaussian noise at
    a level drawn per stream and block (-40 to -6 dBFS), so M and S points
    land in many bins; with three streams or more a NaN in the last
    stream's third block."""
    rng = np.random.default_rng(seed)
    out = []
    for n in [fs // 20 - 100] + [T] * NBLOCKS:
        g = 10 ** (rng.uniform(-40, -6, size=(*batch, 1, 1)) / 20)
        x = (g * rng.standard_normal((*batch, C, n))).astype(np.float32)
        out.append(x)
    if int(np.prod(batch)) >= 3:
        out[3].reshape(-1, C, T)[-1, 0, T // 3] = np.nan
    return [torch.from_numpy(x) for x in out]


def _feed(m, batch, blocks, flat):
    st = m.init(batch, device="cpu")
    for x in blocks:
        st = m.update(st, x.reshape(*batch, -1) if flat else x, flat=flat)
    return st, m.read(st)[0]


def _full_rate(batch, fs, T):
    """fused_core as the meter's fragment step used it before seg mode: the
    full-rate plain core, then shifted_segments of p [..., T] at the
    meter's batch shape.  The offset and the slot count are the test's
    own (the lead block, then T a block), not the ones the meter passes."""
    fragm, seen = fs // 20, [0]

    def core(x, z0, hist, gains, op, **seg_kw):
        p, z, h, tpm = r128_fused.fused_core_reference(x, z0, hist, gains, op)
        if seg_kw:
            off = torch.full(batch, (fragm - 100 + seen[0] * T) % fragm, dtype=torch.int32)
            seen[0] += 1
            n = T // fragm + 2
            p = segment.shifted_segments(p.reshape(*batch, -1), off, fragm, n, "sum")
            p = p.reshape(-1, n)
        return p, z, h, tpm
    return core


def _same(a, b):
    """Bit-identical, NaN positions included."""
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


@pytest.mark.parametrize("fs,T,C,batch,flat", CASES)
def test_update_is_bit_identical_to_the_full_rate_path(monkeypatch, fs, T, C, batch, flat):
    m = EbuR128Meter(fs, nchan=C)
    blocks = _blocks(fs, C, batch, T, seed=fs + T + C)
    st, out = _feed(m, batch, blocks, flat)
    assert int(st.off.flatten()[0]) == (fs // 20 - 100 + NBLOCKS * T) % (fs // 20)
    monkeypatch.setattr(r128_fused, "fused_core", _full_rate(batch, fs, T))
    st_ref, out_ref = _feed(m, batch, blocks, flat)
    for f in STATE_FIELDS:
        assert _same(getattr(st, f), getattr(st_ref, f)), f
    assert out.keys() == out_ref.keys()
    for k in out:
        assert _same(out[k], out_ref[k]), k
    if T >= 48000:  # whole fragments completed: the histograms are not empty
        assert int(st.count_m.min()) > 0


@pytest.mark.parametrize("fs,T,seg", [
    (48000, 128, True), (48000, 2560, True), (48000, 48000, True), (44100, 44160, True),
    (48000, 2400, False), (48000, 4800, False), (48000, 100, False),
    (2560, 256, False),  # a fragment of 128 samples: seg mode needs fragm > 128
])
@pytest.mark.parametrize("flat", [False, True])
def test_which_blocks_take_seg_mode(monkeypatch, fs, T, seg, flat):
    """The meter passes off, fragm and n_slots only for an aligned block;
    the unaligned ones call the full-rate core (T = 100, shorter than a
    kernel block, does not call it)."""
    m = EbuR128Meter(fs)
    batch = (2,)
    lead, x = _blocks(fs, 2, batch, T, seed=7)[:2]
    st = m.update(m.init(batch, device="cpu"), lead)
    assert bool((st.off != 0).all())
    calls = []
    real = r128_fused.fused_core

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(r128_fused, "fused_core", spy)
    m.update(st, x.reshape(2, -1) if flat else x, flat=flat)
    if seg:
        (kw,) = calls
        assert sorted(kw) == ["fragm", "n_slots", "off"]
        assert kw["fragm"] == m.fragm and kw["n_slots"] == T // m.fragm + 2
        assert kw["off"].dtype == torch.int32 and torch.equal(kw["off"], st.off)
    else:
        assert calls == ([] if T < 128 else [{}])
