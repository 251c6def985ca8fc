"""CUDA kernels of the port against their plain PyTorch versions, on the card.

Marked ``gpu``: on a machine without a CUDA device every test here skips
(a CUDA kernel has no CPU or interpret mode).  On a GPU machine run

    python -m pytest tests/test_torch_cuda.py -m gpu -q

r128_fused: the kernel and the plain version are both IEEE fp32 with
different summation orders; tolerances as in chip_smoke.py: p to 1e-5
relative plus 2e-6 of the call's max p, the K-weighting state to 4e-6 of
each component's scale, the history bit-exact, tpmax to 1e-6 relative.
ballistics: bit-exact (the same fp32 operations in the same order).
truepeak_fused, each body against its own plain version: the history
bit-exact, z1/z2/m/p within 1e-5 relative (the FIR sums its products in
another order than the plain version's block matmul; the chain itself adds
nothing).
bitmeter_stats: every field exact (integer counts, min/max of the same
floats).  The statistics meters, card against CPU: histograms and counters
exact, float leaves within 1e-5 of their scale.
spectrum_fused: val, block peak and zf within 1e-5 of each leaf's scale,
with the same NaN and Inf positions (the kernel's smoother runs sample by
sample, the plain version's as blocked Toeplitz products; as in
chip_smoke.py).  spectr30stereo on the card against the CPU: readouts
within 1e-3 dB.
surround_fused: the block peak bit-exact, km_z within 4e-6 of each
component's scale, zl and pacc within 1e-5 of each leaf's scale, with the
same non-finite values (NaN/Inf alike for km_z and pk).  surround5 and
surround8 on the card against the CPU: level and peak within 1e-4 dB,
correlation within 1e-4.
stft_fused (``stft_close``): two float32 FFTs in another order, so re/im
within 1e-6 of each frame's peak magnitude (raw), powers and levels within
2e-4 relative plus 1e-8 of the frame's peak power, dphi (wrapped) within
4 ulp of its magnitude plus 1e-6 sqrt(peak / P) on bins whose weaker
channel's power P lies above 1e-6 of the peak (a phase error is the FFT's
absolute error, measured at 2.4e-7 of the frame's peak magnitude, over
the bin's magnitude), stereoscope positions within 1e-4 on bins above 1e-6 of the peak, an ok
mask flipping only where a power lies within 1e-3 relative of the
threshold, NaN in one channel marked alike; a stream with an Inf sample is
compared on its other channel only (which bins turn Inf or NaN depends on
the FFT).  The analyzers on the card against the CPU: the same bars.
The variants (the ballistics envelope body, R128 seg mode, the surround
wide layout) have their bars stated above their tests.
"""

import math

import numpy as np
import pytest
import torch

import meters_lv2_torch
from meters_lv2_torch.ops import (
    ballistics_core, bitmeter_stats, design, fft, lti, r128_fused, spectrum_fused, stft_fused,
    surround_fused, truepeak_fused)

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
    sg, sc = m.init((2,), device=cuda), m.init((2,), device="cpu")
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


@pytest.mark.parametrize("body", truepeak_fused.BODIES)
@pytest.mark.parametrize("N,T,nonfinite", [(3, 1280, False), (6, 1024, True),
                                           (9, 2560, False)])
def test_truepeak_kernel_matches_plain(cuda, N, T, nonfinite, body):
    """Each body against its own plain version (N=3 and N=9: a CTA's 4 rows
    partly filled)."""
    rng = np.random.default_rng(N * T)
    x = (0.3 * rng.standard_normal((N, T))).astype(np.float32)
    h = (0.1 * rng.standard_normal((N, 47))).astype(np.float32)
    st = [np.abs(0.2 * rng.standard_normal(N)).astype(np.float32) for _ in range(4)]
    if nonfinite:
        x[0, 300], x[1, 700], x[2, 130] = np.nan, np.inf, -np.inf
        h[3, 10], h[4, 46] = np.nan, np.inf
    c = design.true_peak_ballistics(48000)
    args = [torch.as_tensor(a, device=cuda) for a in [x, h] + st]
    w = dict(w1=c.w1, w2=c.w2, w3=c.w3, body=body)
    count = "launch_count" if body == "envelope" else "serial_launch_count"
    n0 = getattr(truepeak_fused, count)
    got = truepeak_fused.truepeak_fused(*args, **w)
    ref = truepeak_fused.truepeak_fused_reference(*args, **w)
    torch.cuda.synchronize()
    assert getattr(truepeak_fused, count) == n0 + 1
    assert torch.equal(got[4], ref[4])
    for a, b in zip(got[:4], ref[:4]):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.isinf(a), torch.isinf(b))
        f = torch.isfinite(b)
        assert bool(((a - b).abs()[f] <= 1e-5 * b.abs()[f]).all())


def test_ballistics_meters_on_card_match_cpu(cuda):
    """dBTP with a 104-sample tail (truepeak kernel + the serial ballistics
    kernel), BBC M-6 (the envelope kernel) with a per-stream S20 tensor,
    and the 0-dim reference-level gain on card readouts."""
    rng = np.random.default_rng(8)
    tp, m6 = meters_lv2_torch.create("dBTPstereo", 48000), meters_lv2_torch.create("BBCM6", 48000)
    tg, tc = tp.init((2, 2), device=cuda), tp.init((2, 2), device="cpu")
    mg, mc = m6.init((2,), device=cuda), m6.init((2,), device="cpu")
    nt, nb = truepeak_fused.launch_count, ballistics_core.launch_count
    ne = ballistics_core.envelope_launch_count
    for i in range(6):
        x = (0.2 * rng.standard_normal((2, 2, 1000))).astype(np.float32)
        s20 = np.array([i % 2 == 0, True])
        tg = tp.update(tg, torch.as_tensor(x, device=cuda))
        tc = tp.update(tc, torch.from_numpy(x))
        mg = m6.update(mg, torch.as_tensor(x, device=cuda), torch.as_tensor(s20, device=cuda))
        mc = m6.update(mc, torch.from_numpy(x), torch.from_numpy(s20))
    assert truepeak_fused.launch_count == nt + 6
    assert ballistics_core.launch_count == nb + 6  # dBTP's tails: the serial body
    assert ballistics_core.envelope_launch_count == ne + 6  # one M-6 launch each
    for (og, _), (oc, _) in ((tp.read(tg), tp.read(tc)), (m6.read(mg), m6.read(mc))):
        for k in oc:
            db = (20 * torch.log10(og[k].cpu() / oc[k])).abs().max().item()
            assert db < 0.01, (k, db)


def _bit_rows(rng, N, T, weird):
    x = (0.1 * rng.standard_normal((N, T))).astype(np.float32)
    if weird:
        from signals import make_signal

        w = make_signal("weird_floats", 0.2)
        x[:2] = np.resize(w, (2, T))
    return x


@pytest.mark.parametrize("N,T,weird,strided", [
    (3, 2048, True, False), (5, 1000, False, True), (4, 1, False, False),
    (2, 9000, True, True),  # three chunks, the last partial
])
def test_bitmeter_stats_kernel_matches_plain(cuda, N, T, weird, strided):
    """Every field exact: integer counts are order-free, min/max exact."""
    x = _bit_rows(np.random.default_rng(N + T), N, T, weird)
    xd = torch.as_tensor(np.concatenate([x, x], axis=1) if strided else x, device=cuda)[:, :T]
    n0 = bitmeter_stats.launch_count
    got = bitmeter_stats.bitmeter_stats(xd)
    ref = bitmeter_stats.bitmeter_stats_reference(xd)
    torch.cuda.synchronize()
    assert bitmeter_stats.launch_count == n0 + 1
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("name,kw,shape", [
    ("bitmeter", {}, (2,)), ("SigDistHist", {}, (2,)),
    ("SigDistHist", {"reference_oor_count": True}, (2,)),
    ("dr14stereo", {}, (2, 2)), ("dr14mono", {"nchan": 1}, (2, 1)),
    ("TPnRMSstereo", {}, (2, 2)), ("TPnRMSmono", {"nchan": 1}, (2, 1)),
])
def test_statistics_meters_on_card_match_cpu(cuda, name, kw, shape):
    """fs = 2000 (3 s DR windows in a few blocks), blocks of 1000 and 1024
    with a NaN and an Inf: histograms and counters exact, levels within
    1e-5 of their scale."""
    from meters_lv2_torch.utils.interop import state_to_numpy

    m = meters_lv2_torch.create(name, 2000, **kw)
    sg, sc = m.init(shape[:1]), m.init(shape[:1], device="cpu")
    assert sg.time.is_cuda if hasattr(sg, "time") else sg.scnt.is_cuda
    rng = np.random.default_rng(len(name))
    nb = bitmeter_stats.launch_count
    for i in range(20):
        x = (0.3 * rng.standard_normal((*shape, 1000 if i % 2 else 1024))).astype(np.float32)
        if i == 9:
            x[0, ..., 5], x[1, ..., 9] = np.nan, np.inf
        sg = m.update(sg, torch.as_tensor(x, device=cuda))
        sc = m.update(sc, torch.from_numpy(x))
    assert bitmeter_stats.launch_count == nb + (20 if name == "bitmeter" else 0)
    g, c = state_to_numpy(sg), state_to_numpy(sc)

    def walk(a, b, path):
        for k in b:
            if isinstance(b[k], dict):
                walk(a[k], b[k], f"{path}.{k}")
            elif b[k].dtype.kind in "ib":
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{path}.{k}")
            else:
                f = np.isfinite(b[k])
                np.testing.assert_array_equal(a[k][~f], b[k][~f], err_msg=f"{path}.{k}")
                scale = np.abs(b[k][f]).max(initial=0.0)
                assert np.all(np.abs(a[k][f] - b[k][f]) <= 1e-5 * scale + 1e-30), f"{path}.{k}"

    walk(g, c, name)


SPEC_TOL = 1e-5


def _spectrum_inputs(spec, B, T, seed, device):
    """x [B, T] and a filter state / smoother value at a stream's scale
    (0.25 s of noise through the plain bank)."""
    g = np.random.default_rng(seed)
    warm = torch.as_tensor((0.3 * g.standard_normal((B, 12000))).astype(np.float32), device=device)
    yw, z0 = spec.bank.apply(warm, spec.bank.init((B,), device=device))
    x = (0.3 * g.standard_normal((B, T))).astype(np.float32)
    return x, z0.contiguous(), torch.mean(torch.square(yw), dim=-1).contiguous()


def _assert_spectrum_close(got, ref):
    for a, b in zip(got, ref):
        a, b = a.cpu().double(), b.cpu().double()
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.isinf(a), torch.isinf(b))
        f = torch.isfinite(b)
        if bool(f.any()):
            assert torch.equal(a[torch.isinf(b)], b[torch.isinf(b)])
            assert (a - b).abs()[f].max() <= SPEC_TOL * b.abs()[f].max()


@pytest.mark.parametrize("B,T,nonfinite,speed", [
    (8, 1024, False, 3.0), (4, 128, False, 3.0), (13, 768, False, 3.0), (7, 1024, True, 3.0),
    (5, 1024, "card", 3.0), (5, 256, False, float("nan")),
])
def test_spectrum_kernel_matches_plain(cuda, B, T, nonfinite, speed):
    """nonfinite True: NaN/+-Inf in x, z0 and v0; "card": the NaNs the
    card's arithmetic makes, 0x7fffffff (and 0xffffffff), which the TF32
    split turns into zeros."""
    spec = meters_lv2_torch.create("spectr30stereo", 48000)
    x, z0, v0 = _spectrum_inputs(spec, B, T, B + T, cuda)
    if nonfinite == "card":
        u = x.view(np.uint32)
        u[0, 37], u[1, 300], u[2, 0], u[2, 900] = 0x7FFFFFFF, 0xFFFFFFFF, 0x7FFFFFFF, 0xFFFFFFFF
        u[3, 127] = 0x7FFFFFFF
    elif nonfinite:
        x[0, 37], x[1, T - 1], x[2, 0] = np.nan, np.inf, -np.inf
        x[3, 130], x[3, 200], x[4, 128] = np.inf, -np.inf, np.inf
        v0[5, 3], v0[5, 4], v0[5, 5] = np.inf, np.nan, -np.inf
        z0[5, 7, 2] = np.inf
    xd = torch.as_tensor(x, device=cuda)
    om = spec.set_speed(spec.init((), device=cuda), speed).omega
    op = spec.bank.op(128)
    n0 = spectrum_fused.launch_count
    got = spectrum_fused.fused_core(xd, z0, v0, om, op)
    ref = spectrum_fused.fused_core_reference(xd, z0, v0, om, op)
    torch.cuda.synchronize()
    assert spectrum_fused.launch_count == n0 + 1
    _assert_spectrum_close(got, ref)


def test_spectrum_kernel_misaligned_x(cuda):
    """x contiguous but 4 bytes off a 16-byte boundary (a view into a flat
    buffer): the kernel's plain-load path instead of its bulk copies."""
    spec = meters_lv2_torch.create("spectr30stereo", 48000)
    x, z0, v0 = _spectrum_inputs(spec, 5, 512, 3, cuda)
    flat = torch.empty(x.size + 1, device=cuda)
    xd = flat[1:].view(5, 512)
    xd.copy_(torch.as_tensor(x, device=cuda))
    assert xd.is_contiguous() and xd.data_ptr() % 16
    om = spec.set_speed(spec.init((), device=cuda), 3.0).omega
    op = spec.bank.op(128)
    got = spectrum_fused.fused_core(xd, z0, v0, om, op)
    ref = spectrum_fused.fused_core_reference(xd, z0, v0, om, op)
    torch.cuda.synchronize()
    _assert_spectrum_close(got, ref)


@pytest.mark.parametrize("B,seconds", [(8, 60)])
def test_spectrum_kernel_matches_plain_carried(cuda, B, seconds):
    """chip_smoke.py's carried case: 1 s calls, the kernel and the plain
    version each carrying its own state; every call within SPEC_TOL."""
    spec = meters_lv2_torch.create("spectr30stereo", 48000)
    x, z0, v0 = _spectrum_inputs(spec, B, seconds * 48000, 12, cuda)
    xd = torch.as_tensor(x, device=cuda)
    om = spec.set_speed(spec.init((), device=cuda), 3.0).omega
    op = spec.bank.op(128)
    got, ref = (z0, v0), (z0, v0)
    for i in range(seconds):
        xb = xd[:, i * 48000:(i + 1) * 48000].contiguous()
        g = spectrum_fused.fused_core(xb, got[0], got[1], om, op)
        r = spectrum_fused.fused_core_reference(xb, ref[0], ref[1], om, op)
        _assert_spectrum_close(g, r)
        got, ref = (g[2], g[0]), (r[2], r[0])


def test_spectrum_meter_on_card_matches_cpu(cuda):
    """1000-sample blocks (kernel bulk and a plain tail), set_speed on the
    card mid-stream, reset_peaks."""
    m = meters_lv2_torch.create("spectr30stereo", 48000)
    rng = np.random.default_rng(5)
    sg, sc = m.init((3,)), m.init((3,), device="cpu")
    assert sg.zf.is_cuda and sg.omega.is_cuda
    n0 = spectrum_fused.launch_count
    for i in range(30):
        if i == 10:
            sg, sc = m.set_speed(sg, 6.0), m.set_speed(sc, 6.0)
        if i == 20:
            sg, sc = m.reset_peaks(sg), m.reset_peaks(sc)
        x = (0.2 * rng.standard_normal((3, 2, 1000))).astype(np.float32)
        sg = m.update(sg, torch.as_tensor(x, device=cuda), stereo=True)
        sc = m.update(sc, torch.from_numpy(x), stereo=True)
    assert spectrum_fused.launch_count == n0 + 30
    og, _ = m.read(sg)
    oc, _ = m.read(sc)
    for k in ("bands", "peaks"):
        assert (og[k].cpu() - oc[k]).abs().max().item() < 1e-3, k


def test_spectrum_meter_nonfinite_on_card_matches_cpu(cuda):
    """chip_smoke.py's case: a NaN in L (stream 0) and +Inf in L against
    -Inf in R (stream 1) reach the kernel as the card's NaN 0x7fffffff from
    the downmix; the state is flushed as on the CPU, and the readouts agree."""
    m = meters_lv2_torch.create("spectr30stereo", 48000)
    rng = np.random.default_rng(21)
    sg, sc = m.init((3,), device=cuda), m.init((3,), device="cpu")
    for i in range(6):
        x = (0.2 * rng.standard_normal((3, 2, 1000))).astype(np.float32)
        if i == 2:
            x[0, 0, 50] = np.nan
            x[1, 0, 500], x[1, 1, 500] = np.inf, -np.inf
        sg = m.update(sg, torch.as_tensor(x, device=cuda), stereo=True)
        sc = m.update(sc, torch.from_numpy(x), stereo=True)
        if i == 2:
            assert not sc.zf[:2].any()
            for k in ("val", "peak", "zf"):
                assert torch.equal(getattr(sg, k)[:2].cpu(), getattr(sc, k)[:2]), k
    og, _ = m.read(sg)
    oc, _ = m.read(sc)
    for k in ("bands", "peaks"):
        assert (og[k].cpu() - oc[k]).abs().max().item() < 1e-3, k


def test_spectrum_meter_nan_speed_on_card_matches_cpu(cuda):
    """set_speed(NaN) then a clean block flushes val and the peak-hold on
    the card as on the CPU; a finite speed then restores the readouts."""
    m = meters_lv2_torch.create("spectr30stereo", 48000)
    rng = np.random.default_rng(6)
    sg, sc = m.init((3,)), m.init((3,), device="cpu")
    for i in range(8):
        if i == 3:
            sg, sc = m.set_speed(sg, float("nan")), m.set_speed(sc, float("nan"))
        if i == 4:
            for a, b in ((sg.val, sc.val), (sg.peak, sc.peak)):
                assert torch.equal(a.cpu(), b)
            assert not sc.peak.any()
            sg, sc = m.set_speed(sg, 2.0), m.set_speed(sc, 2.0)
        x = (0.2 * rng.standard_normal((3, 2, 1024))).astype(np.float32)
        sg = m.update(sg, torch.as_tensor(x, device=cuda), stereo=True)
        sc = m.update(sc, torch.from_numpy(x), stereo=True)
    og, _ = m.read(sg)
    oc, _ = m.read(sc)
    for k in ("bands", "peaks"):
        assert (og[k].cpu() - oc[k]).abs().max().item() < 1e-3, k


# surround_fused: pk bit-exact, km_z per component within 4e-6 of its scale,
# zl and pacc within 1e-5 of each leaf's scale; km_z and pk NaN/Inf in the
# same places, zl and pacc non-finite in the same places (as chip_smoke.py)
SUR_Z_SCALE, SUR_TOL = 4e-6, 1e-5


def _surround_args(C, B, T, seed, device, pairs=None, nonfinite=False):
    m = meters_lv2_torch.create(f"surround{C}", 48000)
    g = np.random.default_rng(seed)
    x = (0.3 * g.standard_normal((B, C, T))).astype(np.float32)
    if nonfinite:
        x[0, C - 1, 300], x[1, 1, 700], x[2, 0, 130] = np.nan, np.inf, -np.inf
    kz = torch.as_tensor((0.01 * g.random((B, C, 2))).astype(np.float32), device=device)
    zl = torch.as_tensor((0.05 * g.standard_normal((B, C, 1))).astype(np.float32), device=device)
    pr = None if pairs is None else torch.tensor(pairs, dtype=torch.float32, device=device)
    wv, _ = m.cor._ema_weights(T, device)
    return (torch.as_tensor(x, device=device), kz, zl, *m._sel(pr, device), m.km.sys, m.cor.lp,
            m.cor.w1, wv)


def _assert_surround_close(got, ref):
    for n, a, b in zip(("km_z", "zl", "pk", "pacc"), got, ref):
        a, b = a.cpu().double(), b.cpu().double()
        f = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), f), n
        if n in ("km_z", "pk"):
            assert torch.equal(torch.isnan(a), torch.isnan(b)), n
            assert torch.equal(a[torch.isinf(b)], b[torch.isinf(b)]), n
        if n == "pk":
            assert torch.equal(torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0)), n
        elif n == "km_z":
            scale = torch.where(f, b, 0.0).abs().amax(dim=(0, 1))
            assert bool((torch.where(f, (a - b).abs(), 0.0) <= SUR_Z_SCALE * scale).all()), n
        elif bool(f.any()):
            assert (a - b).abs()[f].max() <= SUR_TOL * b.abs()[f].max(), n


@pytest.mark.parametrize("C,B,T,pairs,nonfinite", [
    (5, 5, 1280, [[0, 0], [1, 1], [0, 1], [2, 3]], False),
    (5, 256, 48000, None, False),
    (8, 256, 48000, None, False),
    (5, 5, 1280, None, True),
])
def test_surround_kernel_matches_plain(cuda, C, B, T, pairs, nonfinite):
    args = _surround_args(C, B, T, C + B, cuda, pairs, nonfinite)
    n0 = surround_fused.launch_count
    got = surround_fused.fused_core(*args)
    ref = surround_fused.fused_core_reference(*args)
    torch.cuda.synchronize()
    assert surround_fused.launch_count == n0 + 1
    _assert_surround_close(got, ref)


@pytest.mark.parametrize("name", ["surround5", "surround8"])
def test_surround_meter_on_card_matches_cpu(cuda, name):
    """1000-sample blocks (kernel bulk and a plain tail) with the pairs
    re-routed on the card mid-stream, then 128-aligned blocks."""
    m = meters_lv2_torch.create(name, 48000)
    C = m.nchan
    rng = np.random.default_rng(C)
    sg, sc = m.init((3,)), m.init((3,), device="cpu")
    assert sg.zl.is_cuda and sg.km.z.is_cuda
    pairs = [[0, 0], [1, 1], [0, 1], [2, 3]]
    n0 = surround_fused.launch_count
    for i in range(24):
        T = 1000 if i < 12 else 1024
        x = (0.2 * rng.standard_normal((3, C, T))).astype(np.float32)
        p = pairs if i >= 6 else None
        sg = m.update(sg, torch.as_tensor(x, device=cuda),
                      None if p is None else torch.tensor(p, dtype=torch.float32, device=cuda))
        sc = m.update(sc, torch.from_numpy(x), p)
    assert surround_fused.launch_count == n0 + 24
    og, _ = m.read(sg)
    oc, _ = m.read(sc)
    for k in ("level", "peak"):
        d = (20 * torch.log10(og[k].cpu().double() / oc[k].double())).abs().max().item()
        assert d < 1e-4, (k, d)
    assert (og["correlation"].cpu() - oc["correlation"]).abs().max().item() < 1e-4


STFT_RAW_TOL = 1e-6  # of each frame's peak magnitude
STFT_POW_RTOL, STFT_POW_ATOL = 2e-4, 1e-8  # relative, of the frame's peak power
STFT_PH_FFT = 1e-6  # rad at the frame's peak magnitude, growing as 1/|X|
STFT_POS_TOL = 1e-4
STFT_FLIP_REL = 1e-3


def phase_bar(ref, p, pk):
    """The bar of a phase (difference) ``ref`` whose weakest bin power is
    ``p`` in a frame of peak power ``pk``: 4 ulp of |ref| plus
    STFT_PH_FFT sqrt(pk / p)."""
    ulp = torch.abs(ref.float()).clamp_min(1e-30).double() * 2.0 ** -23
    return 4 * ulp + STFT_PH_FFT * torch.sqrt(pk / p.clamp_min(1e-300))


def stft_close(got, ref, raw, mode, thr, skip=()):
    """One stft_fused call against its plain version on the same inputs.

    ``raw`` is the plain version's raw (re, im) of the same frames: the bars
    are set per frame from its powers.  Streams in ``skip`` (an Inf sample)
    are compared on the channels whose raw bins are all finite, in raw mode
    only.  Returns (max abs error over the finite outputs, breaches)."""
    re, im = (v.double() for v in raw)  # [B, 2, F, D]
    pw = re * re + im * im
    fin = torch.isfinite(pw)
    pk = torch.where(fin, pw, 0.0).amax(-1, keepdim=True)  # [B, 2, F, 1]
    B = re.shape[0]
    keep = torch.ones(B, dtype=torch.bool, device=re.device)
    keep[list(skip)] = False
    a, b = (v.double() for v in got)
    ar, br = (v.double() for v in ref)
    errs = []

    def finite_err(x, y, mask):
        d = (x - y).abs()[mask & torch.isfinite(y)]
        return d.max().item() if d.numel() else 0.0

    if mode == "raw":
        chan_ok = fin.all(-1, keepdim=True) | keep[:, None, None, None]
        both = torch.isfinite(a) & torch.isfinite(b)
        bothr = torch.isfinite(ar) & torch.isfinite(br)
        if not torch.equal((both == bothr) | ~chan_ok, torch.ones_like(both)):
            errs.append("non-finite bins differ")
        m = chan_ok & bothr
        tol = STFT_RAW_TOL * torch.sqrt(pk)
        worst = max(finite_err(a, ar, m), finite_err(b, br, m))
        if bool(((a - ar).abs() > tol)[m].any() or ((b - br).abs() > tol)[m].any()):
            errs.append(f"re/im err {worst:.3g} over {STFT_RAW_TOL} of the frame peak")
        return worst, errs
    pl, pr = pw[:, 0], pw[:, 1]
    pkf = torch.maximum(pk[:, 0], pk[:, 1])  # [B, F, 1]
    kb = keep[:, None, None]
    near = ((pl - thr).abs() <= STFT_FLIP_REL * thr) | ((pr - thr).abs() <= STFT_FLIP_REL * thr)
    ok, okr = (b > -99, br > -99) if mode == "phasewheel" else (b != 0, br != 0)
    if bool(((ok != okr) & ~near & kb).any()):
        errs.append(f"ok masks differ off the threshold ({int(((ok != okr) & kb).sum())} bins)")
    both = ok & okr & kb
    if not torch.equal(torch.isnan(b) & kb, torch.isnan(br) & kb):
        errs.append("NaN levels differ")
    lvl_bad = ((b - br).abs() > STFT_POW_RTOL * br.abs() + STFT_POW_ATOL * pkf) & both
    if bool((lvl_bad & torch.isfinite(br)).any()):
        errs.append("level off the power bar")
    worst = finite_err(b, br, both)
    if mode == "phasewheel":
        if not (bool((a[~ok & kb] == 0).all()) and bool((b[~ok & kb] == -100).all())):
            errs.append("below-threshold bins not marked (0, -100)")
        d = torch.remainder(a - ar + math.pi, 2 * math.pi) - math.pi
        pmin = torch.minimum(pl, pr)
        sig = both & (pmin > 1e-6 * pkf)
        if bool((d.abs() > phase_bar(ar, pmin, pkf))[sig].any()):
            errs.append("dphi off the phase bar")
        worst = max(worst, d.abs()[sig].max().item() if bool(sig.any()) else 0.0)
    else:
        if not torch.equal(torch.isnan(a) & kb, torch.isnan(ar) & kb):
            errs.append("NaN positions differ")
        big = both & torch.isfinite(br) & (br > 1e-6 * pkf)
        if bool(((a - ar).abs() > STFT_POS_TOL)[big].any()):
            errs.append("pos off its bar")
        worst = max(worst, finite_err(a, ar, big))
    return worst, errs


def stft_inputs(B, W, hop, F, seed, dev, nonfinite=False):
    """(ext [B, 2, W + F hop], win [W]) on ``dev``: 0.3 N(0, 1) plus a 997 Hz
    sine; with ``nonfinite`` a NaN in stream 1's left channel and +Inf in
    stream 2's right channel (B >= 3).  Returns (ext, win, streams with an
    Inf sample)."""
    rng = np.random.default_rng(seed)
    L = W + hop * F
    t = np.arange(L) / 48000
    x = (0.3 * rng.standard_normal((B, 2, L)) + 0.5 * np.sin(2 * np.pi * 997 * t)).astype(np.float32)
    if nonfinite:  # NaN in frame 0, Inf in the last frame (and its neighbours)
        x[1, 0, hop + 5] = np.nan
        x[2, 1, hop * F + 7] = np.inf
    win = torch.as_tensor(fft.make_window("hann", W).astype(np.float32), device=dev)
    return torch.as_tensor(x, device=dev), win, ((2,) if nonfinite else ())


@pytest.mark.parametrize("mode", ["raw", "phasewheel", "stereoscope"])
@pytest.mark.parametrize("W,hop,B,F,nonfinite", [
    (8192, 1920, 8, 25, False),
    (256, 1764, 4, 5, False),
    (256, 1920, 3, 1, True),
    (8192, 1920, 3, 3, True),
])
def test_stft_kernel_matches_plain(cuda, mode, W, hop, B, F, nonfinite):
    ext, win, skip = stft_inputs(B, W, hop, F, W + B, cuda, nonfinite)
    thr = 1e-6 if mode == "phasewheel" else 1e-20
    n0 = stft_fused.launch_count
    got = stft_fused.analyzer_frames(ext, win, hop, mode, thr)
    ref = stft_fused.plain_frames(ext, win, hop, mode, thr)
    raw = stft_fused.plain_frames(ext, win, hop, "raw", thr)
    torch.cuda.synchronize()
    assert stft_fused.launch_count == n0 + 1
    _, errs = stft_close(got, ref, raw, mode, thr, skip)
    assert not errs, errs


@pytest.mark.parametrize("name,fs", [("phasewheel", 48000), ("stereoscope", 44100),
                                     ("goniometer", 48000)])
def test_analyzer_on_card_matches_cpu(cuda, name, fs):
    """Three calls at B = 3 (two frames each; 2000-sample blocks for the
    goniometer), state created on the card with no device argument."""
    m = meters_lv2_torch.create(name, fs)
    T = 2 * m.stft.hop if name != "goniometer" else 2000
    rng = np.random.default_rng(5)
    sg, sc = m.init((3,)), m.init((3,), device="cpu")
    n0 = stft_fused.launch_count
    for _ in range(3):
        x = (0.2 * rng.standard_normal((3, 2, T))).astype(np.float32)
        og, sg = m.process(sg, torch.as_tensor(x, device=cuda))
        oc, sc = m.process(sc, torch.from_numpy(x))
    assert stft_fused.launch_count == n0 + (0 if name == "goniometer" else 3)
    if name == "goniometer":
        for k in ("x", "y"):
            a, b = og[k].cpu().double(), oc[k].double()
            assert ((a - b).abs() <= 1e-5 * b.abs().max()).all(), k
        torch.testing.assert_close(og["gain"].cpu(), oc["gain"], rtol=1e-5, atol=0)
        return
    lv, lc = og["level"].cpu().double(), oc["level"].double()
    pk = lc.abs().amax(-1, keepdim=True)
    assert bool(((lv - lc).abs() <= STFT_POW_RTOL * lc.abs() + STFT_POW_ATOL * pk).all())
    if name == "phasewheel":
        ok = (lv > -99) & (lc > -99)
        d = torch.remainder(og["phase"].cpu().double() - oc["phase"].double() + math.pi,
                            2 * math.pi) - math.pi
        # the level is the stronger channel's power: 1e-3 rad holds where
        # it lies above 1e-6 of the peak (the golden bar)
        assert bool((d.abs()[ok & (lc > 1e-6 * pk)] <= 1e-3).all())
        torch.testing.assert_close(og["peak"].cpu(), oc["peak"], rtol=2e-4, atol=0)
        torch.testing.assert_close(og["correlation"].cpu(), oc["correlation"], rtol=0, atol=1e-5)
    else:
        big = lc > 1e-6 * pk
        assert bool(((og["lr"].cpu() - oc["lr"]).abs()[big] <= STFT_POS_TOL).all())


# -- the variants: the ballistics envelope body, R128 seg mode, the surround
# wide layout.  envelope: bit-exact to its plain version, within 2e-6 / 1e-7
# of the serial kernel (p exact); seg mode: seg within 2e-6 (atol 1e-9) of
# its plain version, z / hist / tpmax bit-identical to the same kernel's
# full-rate mode; wide: the narrow kernel's bars against the plain version
# and against the narrow kernel, km_z, zl and pk bit-identical to it.


def test_envelope_body_refuses_outside_its_domain_on_card(cuda):
    """ballistics(envelope=True) raises for w2 > 1 on the card as on the
    CPU, and launches nothing."""
    tp = design.true_peak_ballistics(2000)
    t = torch.full((2, 16), 0.5, device=cuda)
    z = torch.zeros(2, device=cuda)
    n0 = ballistics_core.envelope_launch_count
    with pytest.raises(ValueError, match="envelope body needs"):
        ballistics_core.ballistics(t, z, z, z, z, w1=tp.w1, w2=tp.w2, w3=tp.w3,
                                   track_peak=True, envelope=True)
    assert ballistics_core.envelope_launch_count == n0


def _env_rows(N, T, seed, nonfinite):
    rng = np.random.default_rng(seed)
    t = np.abs(0.3 * rng.standard_normal((N, T))).astype(np.float32)
    st = [np.abs(0.3 * rng.standard_normal(N)).astype(np.float32) for _ in range(4)]
    if nonfinite:
        # (row, sample) taken mod (N, T): NaN, +Inf, a NaN and a +Inf in one
        # group (both orders), a silent run; NaN and +-Inf at the edges of
        # 128-sample blocks (127, 128, 255) and of groups (43, 44), +Inf
        # first and second in its group, the last sample NaN; a NaN carried
        # z2 and max
        marks = [(0, 17, np.nan), (1, 301, np.inf), (2, 5, np.nan), (3, 40, np.nan),
                 (3, 41, np.inf), (4, 40, np.inf), (4, 42, np.nan), (6, 127, np.nan),
                 (6, 128, np.nan), (7, 127, np.inf), (8, 128, -np.inf), (9, 255, np.nan),
                 (10, 43, np.nan), (10, 44, -np.inf), (11, 48, np.inf), (12, 49, np.inf),
                 (13, T - 1, np.nan)]
        t[5 % N, 0:64] = 0.0
        for r, i, v in marks:
            t[r % N, i % T] = v
        st[2][3 % N] = np.nan
        st[1][14 % N] = np.nan
    return t, st


@pytest.mark.parametrize("N,T,track_peak,nonfinite", [
    (5, 1024, False, False),
    (37, 1000, True, True),
    (40, 4096, True, False),
    (1, 4, True, False),       # one group
    (1, 48000, False, True),
    (3, 64, True, True),       # half a block
    (3, 1000, False, False),
    (17, 1000, True, True),    # a CTA's rows partly filled
    (17, 48000, False, False),
    (512, 48000, True, False),  # the main-path shape
    (512, 1000, True, True),
    (529, 1000, True, True),   # past the few-row launch: 16 rows a CTA, the last partial
    (600, 4, False, False),
    (600, 48000, True, True),
])
def test_ballistics_envelope_kernel_matches_plain(cuda, N, T, track_peak, nonfinite):
    """The envelope kernel bit-exact to its plain version, and within the
    envelope's bar of the serial kernel, at the row counts of both launches
    (4 and 16 rows a CTA), with whole and partial CTAs and blocks."""
    t, st = _env_rows(N, T, N + T, nonfinite)
    c = design.iec2_ppm(48000)
    args = [torch.as_tensor(a, device=cuda) for a in [t] + st]
    w = dict(w1=c.w1, w2=c.w2, w3=c.w3, track_peak=track_peak)
    n0, e0 = ballistics_core.launch_count, ballistics_core.envelope_launch_count
    got = ballistics_core.ballistics(*args, **w, envelope=True)
    ref = ballistics_core.ballistics_envelope_reference(*args, **w)
    serial = ballistics_core.ballistics(*args, **w)
    torch.cuda.synchronize()
    assert ballistics_core.envelope_launch_count == e0 + 1
    assert ballistics_core.launch_count == n0 + 1
    assert all(_same(a, b) for a, b in zip(got, ref))
    for k, (a, b) in enumerate(zip(got, serial)):
        a, b = a.cpu().double(), b.cpu().double()
        f = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), f) and torch.equal(a[~f].nan_to_num(), b[~f].nan_to_num())
        bar = 0.0 if k == 3 else 2e-6 * b[f].abs() + 1e-7
        assert bool(((a - b)[f].abs() <= bar).all()), k


@pytest.mark.parametrize("fs,C,T,B", [(48000, 2, 2560, 5), (44100, 5, 2304, 3),
                                      (48000, 1, 48000, 4)])
def test_r128_seg_mode_kernel_matches_plain(cuda, fs, C, T, B):
    fragm = fs // 20
    n_slots = T // fragm + 2
    rng = np.random.default_rng(fs + C)
    x = (0.3 * rng.standard_normal((B, C, T))).astype(np.float32)
    z0 = (0.01 * rng.standard_normal((B, C, 4))).astype(np.float32)
    h0 = (0.1 * rng.standard_normal((B, C, 47))).astype(np.float32)
    off = torch.as_tensor(rng.integers(0, fragm, B).astype(np.int32), device=cuda)
    gains = (2.0,) if C == 1 else r128_fused.gains_f32(design.R128_CHAN_GAIN[:C])
    op = lti.LTISystem(*design.k_weighting_state_space(fs)).op(128)
    xd, zd, hd = (torch.as_tensor(a, device=cuda) for a in (x, z0, h0))
    seg_kw = dict(off=off, fragm=fragm, n_slots=n_slots)
    s0, n0 = r128_fused.seg_launch_count, r128_fused.launch_count
    got = r128_fused.fused_core(xd, zd, hd, gains, op, **seg_kw)
    full = r128_fused.fused_core(xd, zd, hd, gains, op)
    ref = r128_fused.fused_core_reference(xd, zd, hd, gains, op, **seg_kw)
    torch.cuda.synchronize()
    assert (r128_fused.seg_launch_count, r128_fused.launch_count) == (s0 + 1, n0 + 1)
    assert got[0].shape == (B, n_slots)
    for a, b in zip(got[1:], full[1:]):
        assert torch.equal(a, b)
    _assert_core_close(full, r128_fused.fused_core_reference(xd, zd, hd, gains, op))
    seg, segr = got[0].cpu().double(), ref[0].cpu().double()
    assert bool(((seg - segr).abs() <= 2e-6 * segr.abs() + 1e-9).all())


@pytest.mark.parametrize("C,B,T,pairs,nonfinite", [
    (5, 5, 1280, [[0, 0], [1, 1], [0, 1], [2, 3]], False),
    (3, 4, 48000, None, False),
    (5, 256, 48000, None, False),
    (8, 256, 48000, None, False),
    (8, 5, 1280, None, True),
])
def test_surround_wide_kernel_matches_plain_and_narrow(cuda, C, B, T, pairs, nonfinite):
    args = _surround_args(C, B, T, C + B, cuda, pairs, nonfinite)
    n0, w0 = surround_fused.launch_count, surround_fused.wide_launch_count
    got = surround_fused.fused_core_wide(*args)
    narrow = surround_fused.fused_core(*args)
    ref = surround_fused.fused_core_reference(*args)
    torch.cuda.synchronize()
    assert (surround_fused.wide_launch_count, surround_fused.launch_count) == (w0 + 1, n0 + 1)
    _assert_surround_close(got, ref)
    _assert_surround_close(got, narrow)
    for a, b in zip(got[:3], narrow[:3]):  # km_z, zl, pk: the same operations
        assert _same(a, b)


def test_variant_switches_reach_the_meters_on_card(cuda, monkeypatch):
    """BBCstereo's and BBCM6's ballistics run the envelope kernel by
    default, and the serial kernel where ``envelope_ok`` fails (forced
    here), readouts within the envelope's bar of each other;
    METERS_TORCH_SURROUND_WIDE=1 sends surround5's bulk to the wide kernel,
    readouts within its bars of the default."""
    rng = np.random.default_rng(21)
    x = torch.as_tensor((0.2 * rng.standard_normal((3, 2, 4800))).astype(np.float32), device=cuda)
    xs = torch.as_tensor((0.2 * rng.standard_normal((3, 5, 4800))).astype(np.float32), device=cuda)
    for name, count, data in [
        ("BBCstereo", "envelope_launch_count", x),
        ("BBCM6", "envelope_launch_count", x),
        ("surround5", "wide_launch_count", xs),
    ]:
        mod = surround_fused if name.startswith("surround") else ballistics_core
        m = meters_lv2_torch.create(name, 48000)
        outs = []
        for variant in (False, True):
            if mod is surround_fused:
                monkeypatch.setenv("METERS_TORCH_SURROUND_WIDE", "1" if variant else "0")
            else:  # the default is the envelope; outside its domain, serial
                monkeypatch.setattr(ballistics_core, "envelope_ok",
                                    (lambda w1, w2: True) if variant else (lambda w1, w2: False))
            c0 = getattr(mod, count)
            st = m.init((3, 2) if name == "BBCstereo" else (3,), device=cuda)
            for i in range(4):
                st = m.update(st, data[..., i * 1200:(i + 1) * 1200])
            out = m.read(st)[0]
            torch.cuda.synchronize()
            assert getattr(mod, count) == c0 + (4 if variant else 0), name
            outs.append(out if isinstance(out, dict) else {"value": out})
        monkeypatch.undo()
        for k in outs[0]:
            a, b = outs[1][k].cpu().double(), outs[0][k].cpu().double()
            if k == "correlation":
                assert (a - b).abs().max().item() < 1e-5, (name, k)
            else:
                assert bool(((a - b).abs() <= 2e-6 * b.abs() + 1e-7).all()), (name, k)