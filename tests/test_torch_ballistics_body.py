"""Which ballistics body the port's meters run, on the CPU.

``ops/ballistics._run_ballistics`` takes the group-envelope body wherever
``ballistics_core.envelope_ok`` holds for the meter's coefficients (DIN,
NOR, BBC, EBU, M-6 at every rate, the unfused true-peak update from
fs = 4,300 Hz on) on batches of up to ``ENVELOPE_MAX_ROWS`` rows, and the
serial body elsewhere; dBTP's tail after the 128-aligned bulk stays serial,
as the JAX package's tail does.  The choice
is the same on the CPU and on the card, so these tests watch
``ballistics_core.ballistics`` and the two plain versions on CPU tensors;
tests/test_torch_cuda.py and chip_smoke.py count the kernels' launches.
The readouts of the two bodies agree within the envelope's bar, rtol 2e-6
and atol 1e-7 (tests/test_ballistics_envelope.py); against the JAX meters
see tests/test_torch_meters_ballistics.py.
"""

import numpy as np
import pytest
import torch

import meters_lv2_torch as mt
from meters_lv2_torch.ops import ballistics as t_bal
from meters_lv2_torch.ops import ballistics_core, design

torch.set_num_threads(1)

ENV_RTOL, ENV_ATOL = 2e-6, 1e-7
PPM_METERS = ["DINmono", "DINstereo", "NORmono", "NORstereo", "BBCmono", "BBCstereo",
              "EBUmono", "EBUstereo", "BBCM6"]


@pytest.fixture
def bodies(monkeypatch):
    """Records (envelope, T) of every ballistics_core.ballistics call."""
    seen = []
    ballistics = ballistics_core.ballistics

    def spy(t_abs, *a, envelope=False, **k):
        seen.append((envelope, t_abs.shape[-1]))
        return ballistics(t_abs, *a, envelope=envelope, **k)

    monkeypatch.setattr(ballistics_core, "ballistics", spy)
    return seen


def _run(m, name, blocks, batch=3):
    shape = (batch, 2) if name == "BBCM6" or name.endswith("stereo") else (batch,)
    rng = np.random.default_rng(len(name))
    st = m.init(shape[:1] if name == "BBCM6" else shape, device="cpu")
    for T in blocks:
        x = (0.3 * rng.standard_normal((*shape, T))).astype(np.float32)
        st = m.update(st, torch.from_numpy(x))
    out, _ = m.read(st)
    return out if isinstance(out, dict) else {"value": out}


@pytest.mark.parametrize("fs", [8000, 44100, 48000, 96000])
@pytest.mark.parametrize("name", PPM_METERS)
def test_ppm_meters_take_the_envelope(bodies, name, fs):
    """Every PPM family's coefficients lie in the envelope's domain at every
    rate, so each update's one ballistics call runs the envelope."""
    m = mt.create(name, fs)
    assert ballistics_core.envelope_ok(m.coeffs.w1, m.coeffs.w2)
    _run(m, name, [64, 100])
    assert bodies == [(True, 64), (True, 100)]


@pytest.mark.parametrize("name", ["BBCstereo", "BBCM6", "DINmono"])
def test_coefficients_outside_the_domain_take_the_serial_body(bodies, name):
    """With true peak's coefficients at fs = 2,000 (w2 = 2.15 > 1, outside
    the envelope's domain) the same meter runs the serial body, on its
    plain version on the CPU."""
    m = mt.create(name, 48000)
    m.coeffs = design.true_peak_ballistics(2000)
    assert not ballistics_core.envelope_ok(m.coeffs.w1, m.coeffs.w2)
    out = _run(m, name, [200, 200])
    assert bodies == [(False, 200), (False, 200)]
    assert all(bool(torch.isfinite(v).all()) for v in out.values())


def test_dbtp_tail_stays_serial(bodies):
    """dBTP in 1000-sample blocks: the 896-sample bulk runs truepeak_fused
    (its envelope body), and the 104-sample tail, 416 oversamples, goes to
    ballistics_core.ballistics with the serial body."""
    m = mt.create("dBTPstereo", 48000)
    _run(m, "dBTPstereo", [1000, 1000], batch=2)
    assert bodies == [(False, 416), (False, 416)]


@pytest.mark.parametrize("fs,envelope", [(2000, False), (4000, False), (4400, True),
                                         (48000, True)])
def test_unfused_true_peak_takes_the_envelope_where_it_holds(bodies, fs, envelope):
    """The unfused true-peak update on the 4x-oversampled stream: the
    envelope from fs = 4,300 Hz on (w2 = 4300 / fs <= 1), else serial; the
    readouts of the two bodies within the envelope's bar."""
    c = design.true_peak_ballistics(fs)
    assert ballistics_core.envelope_ok(c.w1, c.w2) == envelope
    up = torch.from_numpy(np.abs(np.random.default_rng(fs).standard_normal((3, 2048)))
                          .astype(np.float32))
    st = t_bal.true_peak_update(c, t_bal.true_peak_init((3,), device="cpu"), up)
    assert bodies == [(envelope, 2048)]
    z1, z2, m, p = ballistics_core.ballistics_reference(
        up, *[torch.zeros(3)] * 4, w1=c.w1, w2=c.w2, w3=c.w3, track_peak=True)
    ref = t_bal._true_peak_epilogue(c, t_bal.true_peak_init((3,), device="cpu"), z1, z2, m, p)
    for f in ("z1", "z2", "m", "p"):
        np.testing.assert_allclose(getattr(st, f).numpy(), getattr(ref, f).numpy(),
                                   rtol=ENV_RTOL, atol=ENV_ATOL, err_msg=f)


@pytest.mark.parametrize("name,rows", [("BBCmono", t_bal.ENVELOPE_MAX_ROWS),
                                       ("BBCmono", t_bal.ENVELOPE_MAX_ROWS + 1),
                                       ("BBCM6", t_bal.ENVELOPE_MAX_ROWS // 2),
                                       ("BBCM6", t_bal.ENVELOPE_MAX_ROWS // 2 + 1)])
def test_rows_past_the_envelope_limit_take_the_serial_body(bodies, name, rows):
    """Up to ENVELOPE_MAX_ROWS rows a call the envelope, beyond it the
    serial body (BBC M-6 stacks mid and side: two rows a stream)."""
    m = mt.create(name, 48000)
    _run(m, name, [8], batch=rows)
    n = rows * (2 if name == "BBCM6" else 1)
    assert bodies == [(n <= t_bal.ENVELOPE_MAX_ROWS, 8)]
