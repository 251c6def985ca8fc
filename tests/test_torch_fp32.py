"""The port's float32 products run in IEEE float32 whatever the caller set.

A caller's ``torch.set_float32_matmul_precision("high")`` allows TF32 (and,
on CPUs that have it, reduced-precision) matrix products.  The LTI state
chain compounds its rounding across blocks, so the port pins IEEE float32
for every product of its glue (``meters_lv2_torch.ops.lti.ieee_fp32``).
Here a spy on ``torch.matmul`` records the per-backend setting in force at
each product of a K-meter, a COR, a goniometer, a phase wheel and a
surround update under "high"; every product must see "ieee", the caller's
setting must come back, and the readouts must equal a run at "highest".
"""

import numpy as np
import pytest
import torch

import meters_lv2_torch as mt
from meters_lv2_torch.ops import lti

torch.set_num_threads(1)

METERS = [  # name, create kwargs, state batch, input channels, call
    ("K20stereo", {}, (2, 2), 2, "update"),
    ("COR", {}, (2,), 2, "update"),
    ("goniometer", {"oversample": 4}, (2,), 2, "process"),
    ("phasewheel", {}, (2,), 2, "process"),
    ("surround5", {}, (2,), 5, "update"),
]


@pytest.fixture
def precision():
    """Restores the process-wide setting whatever the test does."""
    old = torch.get_float32_matmul_precision()
    yield
    torch.set_float32_matmul_precision(old)


def _readouts(name, kw, batch, C, call, x):
    m = mt.create(name, 48000, **kw)
    st = m.init(batch, device="cpu")
    xin = x[:, :C] if C > 1 else x[:, 0]
    if call == "update":
        for i in range(2):
            st = m.update(st, xin[..., i * 2880:(i + 1) * 2880])
        out = m.read(st)[0]
    else:
        out = m.process(st, xin)[0]
    out = out if isinstance(out, dict) else {"value": out}
    return {k: v.clone() for k, v in out.items()}


def _spy(monkeypatch):
    seen = []
    matmul = torch.matmul

    def spy(a, b):
        seen.append(tuple(b.fp32_precision for b in lti._FP32_BACKENDS)
                    or torch.get_float32_matmul_precision())
        return matmul(a, b)

    monkeypatch.setattr(torch, "matmul", spy)
    return seen


@pytest.mark.parametrize("name,kw,batch,C,call", METERS, ids=[m[0] for m in METERS])
def test_products_run_ieee_under_high(precision, monkeypatch, name, kw, batch, C, call):
    x = torch.from_numpy(
        (0.2 * np.random.default_rng(4).standard_normal((2, 5, 5760))).astype(np.float32))
    torch.set_float32_matmul_precision("highest")
    want = _readouts(name, kw, batch, C, call, x)
    torch.set_float32_matmul_precision("high")
    seen = _spy(monkeypatch)
    got = _readouts(name, kw, batch, C, call, x)
    assert torch.get_float32_matmul_precision() == "high"
    assert seen, f"{name} ran no product"
    ieee = tuple("ieee" for _ in lti._FP32_BACKENDS) or "highest"
    assert all(s == ieee for s in seen), set(seen)
    for k in want:
        assert torch.equal(torch.isnan(got[k]), torch.isnan(want[k])), k
        assert torch.equal(got[k].nan_to_num(), want[k].nan_to_num()), k


def test_ieee_fp32_restores_on_error_and_with_the_global_setting(precision, monkeypatch):
    """The caller's setting comes back when the body raises, and on a
    PyTorch without per-backend settings the global one is pinned instead."""
    torch.set_float32_matmul_precision("medium")
    with pytest.raises(RuntimeError, match="boom"):
        with lti.ieee_fp32():
            raise RuntimeError("boom")
    assert torch.get_float32_matmul_precision() == "medium"
    monkeypatch.setattr(lti, "_FP32_BACKENDS", ())
    with lti.ieee_fp32():
        assert torch.get_float32_matmul_precision() == "highest"
    assert torch.get_float32_matmul_precision() == "medium"
    a = torch.randn(3, 4)
    assert torch.equal(lti.matmul(a, a.T), torch.matmul(a, a.T))
