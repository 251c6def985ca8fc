"""CUDA kernel of the port against its plain PyTorch version, on the card.

Marked ``gpu``: on a machine without a CUDA device every test here skips
(a CUDA kernel has no CPU or interpret mode).  On a GPU machine run

    python -m pytest tests/test_torch_cuda.py -m gpu -q

The kernel and the plain version are both IEEE fp32 with different
summation orders; tolerances as in chip_smoke.py: p to 1e-5 relative plus
2e-6 of the call's max p, the K-weighting state to 4e-6 of each
component's scale, the history bit-exact, tpmax to 1e-6 relative.
"""

import numpy as np
import pytest
import torch

import meters_lv2_torch
from meters_lv2_torch.ops import design, lti, r128_fused

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
