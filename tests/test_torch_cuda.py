"""CUDA kernels of the port against their plain PyTorch versions, on the card.

Marked ``gpu``: on a machine without a CUDA device every test here skips
(a CUDA kernel has no CPU or interpret mode).  On a GPU machine run

    python -m pytest tests/test_torch_cuda.py -m gpu -q

r128_fused: the kernel and the plain version are both IEEE fp32 with
different summation orders; tolerances as in chip_smoke.py: p to 1e-5
relative plus 2e-6 of the call's max p, the K-weighting state to 4e-6 of
each component's scale, the history bit-exact, tpmax to 1e-6 relative.
ballistics: bit-exact (the same fp32 operations in the same order).
truepeak_fused: the history bit-exact, z1/z2/m/p within 1e-5 relative (the
FIR sums its products in another order than the plain version's block
matmul; the chain itself adds nothing).
"""

import numpy as np
import pytest
import torch

import meters_lv2_torch
from meters_lv2_torch.ops import ballistics_core, design, lti, r128_fused, truepeak_fused

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _assert_core_close(got, ref):
    p, z, h, t = (v.cpu().double() for v in got)
    pr, zr, hr, tr = (v.cpu().double() for v in ref)
    for a, b in ((p, pr), (z, zr), (t, tr)):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.isinf(a), torch.isinf(b))
    fin = torch.isfinite(pr)
    pmax = pr[fin].abs().max()
    assert bool(((p - pr).abs()[fin] <= 1e-5 * pr.abs()[fin] + 2e-6 * pmax).all())
    zf = torch.isfinite(zr)
    zscale = torch.where(zf, zr, 0.0).abs().amax(dim=(0, 1))
    assert bool((torch.where(zf, (z - zr).abs(), 0.0) <= 4e-6 * zscale).all())
    assert torch.equal(h, hr)
    tf = torch.isfinite(tr)
    assert bool(((t - tr).abs()[tf] <= 1e-6 * tr.abs()[tf]).all())


@pytest.mark.parametrize("B,C,T,flat,nonfinite", [
    (5, 2, 768, False, False),
    (2, 1, 256, True, False),
    (3, 5, 1280, False, False),
    (4, 2, 1024, True, True),
])
def test_kernel_matches_plain(cuda, B, C, T, flat, nonfinite):
    rng = np.random.default_rng(B * C)
    x = (0.3 * rng.standard_normal((B, C, T))).astype(np.float32)
    if nonfinite:
        x[0, 0, 300], x[1, 1, 700], x[2, 0, 130] = np.nan, np.inf, -np.inf
    z0 = (0.01 * rng.standard_normal((B, C, 4))).astype(np.float32)
    h0 = (0.1 * rng.standard_normal((B, C, 47))).astype(np.float32)
    gains = (2.0,) if C == 1 else r128_fused.gains_f32(design.R128_CHAN_GAIN[:C])
    op = lti.LTISystem(*design.k_weighting_state_space(48000)).op(128)
    xd, zd, hd = (torch.as_tensor(a, device=cuda) for a in (x, z0, h0))
    n0 = r128_fused.launch_count
    got = r128_fused.fused_core(xd.reshape(B, -1) if flat else xd, zd, hd, gains, op)
    ref = r128_fused.fused_core_reference(xd, zd, hd, gains, op)
    torch.cuda.synchronize()
    assert r128_fused.launch_count == n0 + 1
    _assert_core_close(got, ref)


def test_meter_on_card_matches_cpu(cuda):
    """Bulk through the kernel plus a plain tail (T = 2400 = 18*128 + 96)."""
    m = meters_lv2_torch.create("EBUr128", 48000, nchan=2)
    rng = np.random.default_rng(3)
    sg, sc = m.init((2,), device=cuda), m.init((2,))
    n0 = r128_fused.launch_count
    for _ in range(150):
        x = (0.1 * rng.standard_normal((2, 2, 2400))).astype(np.float32)
        sg = m.update(sg, torch.as_tensor(x, device=cuda))
        sc = m.update(sc, torch.from_numpy(x))
    assert r128_fused.launch_count == n0 + 150
    og, _ = m.read(sg)
    oc, _ = m.read(sc)
    for k in ("loudness_M", "loudness_S", "integrated", "lra", "max_M", "max_S"):
        assert (og[k].cpu() - oc[k]).abs().max().item() < 0.01, k
    for k in ("hist_m", "hist_s", "count_m", "count_s"):
        assert torch.equal(getattr(sg, k).cpu(), getattr(sc, k)), k


def _same(a, b):
    """Bit-exact, NaN positions included."""
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


@pytest.mark.parametrize("N,T,track_peak,nonfinite", [
    (5, 1024, False, False),
    (37, 1000, True, True),  # a partial CTA of rows, a partial tile
])
def test_ballistics_kernel_matches_plain(cuda, N, T, track_peak, nonfinite):
    rng = np.random.default_rng(N + T)
    t = np.abs(0.3 * rng.standard_normal((N, T))).astype(np.float32)
    st = [np.abs(0.3 * rng.standard_normal(N)).astype(np.float32) for _ in range(4)]
    if nonfinite:
        t[0, 17], t[1, 300], t[2, 5] = np.nan, np.inf, np.nan
        st[2][3] = np.nan
    c = design.iec2_ppm(48000)
    args = [torch.as_tensor(a, device=cuda) for a in [t] + st]
    w = dict(w1=c.w1, w2=c.w2, w3=c.w3, track_peak=track_peak)
    n0 = ballistics_core.launch_count
    got = ballistics_core.ballistics(*args, **w)
    ref = ballistics_core.ballistics_reference(*args, **w)
    torch.cuda.synchronize()
    assert ballistics_core.launch_count == n0 + 1
    assert all(_same(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("N,T,nonfinite", [(3, 1280, False), (6, 1024, True)])
def test_truepeak_kernel_matches_plain(cuda, N, T, nonfinite):
    rng = np.random.default_rng(N * T)
    x = (0.3 * rng.standard_normal((N, T))).astype(np.float32)
    h = (0.1 * rng.standard_normal((N, 47))).astype(np.float32)
    st = [np.abs(0.2 * rng.standard_normal(N)).astype(np.float32) for _ in range(4)]
    if nonfinite:
        x[0, 300], x[1, 700], x[2, 130] = np.nan, np.inf, -np.inf
        h[3, 10], h[4, 46] = np.nan, np.inf
    c = design.true_peak_ballistics(48000)
    args = [torch.as_tensor(a, device=cuda) for a in [x, h] + st]
    w = dict(w1=c.w1, w2=c.w2, w3=c.w3)
    n0 = truepeak_fused.launch_count
    got = truepeak_fused.truepeak_fused(*args, **w)
    ref = truepeak_fused.truepeak_fused_reference(*args, **w)
    torch.cuda.synchronize()
    assert truepeak_fused.launch_count == n0 + 1
    assert torch.equal(got[4], ref[4])
    for a, b in zip(got[:4], ref[:4]):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.isinf(a), torch.isinf(b))
        f = torch.isfinite(b)
        assert bool(((a - b).abs()[f] <= 1e-5 * b.abs()[f]).all())


def test_ballistics_meters_on_card_match_cpu(cuda):
    """dBTP with a 104-sample tail (truepeak kernel + ballistics kernel),
    BBC M-6 with a per-stream S20 tensor, and the 0-dim reference-level gain
    on card readouts."""
    rng = np.random.default_rng(8)
    tp, m6 = meters_lv2_torch.create("dBTPstereo", 48000), meters_lv2_torch.create("BBCM6", 48000)
    tg, tc = tp.init((2, 2), device=cuda), tp.init((2, 2))
    mg, mc = m6.init((2,), device=cuda), m6.init((2,))
    nt, nb = truepeak_fused.launch_count, ballistics_core.launch_count
    for i in range(6):
        x = (0.2 * rng.standard_normal((2, 2, 1000))).astype(np.float32)
        s20 = np.array([i % 2 == 0, True])
        tg = tp.update(tg, torch.as_tensor(x, device=cuda))
        tc = tp.update(tc, torch.from_numpy(x))
        mg = m6.update(mg, torch.as_tensor(x, device=cuda), torch.as_tensor(s20, device=cuda))
        mc = m6.update(mc, torch.from_numpy(x), torch.from_numpy(s20))
    assert truepeak_fused.launch_count == nt + 6
    assert ballistics_core.launch_count == nb + 12  # dBTP tails + one M-6 launch each
    for (og, _), (oc, _) in ((tp.read(tg), tp.read(tc)), (m6.read(mg), m6.read(mc))):
        for k in oc:
            db = (20 * torch.log10(og[k].cpu() / oc[k])).abs().max().item()
            assert db < 0.01, (k, db)
