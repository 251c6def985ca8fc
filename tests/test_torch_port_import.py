"""The PyTorch port imports on its own: no JAX, no meters_lv2_tpu."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import meters_lv2_torch
from meters_lv2_torch.models import base as torch_base

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import meters_lv2_torch as m\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'meters_lv2_tpu')]\n"
        "assert not bad, bad\n"
        "meter = m.create('EBUr128', 48000, nchan=2)\n"
        "st = meter.init((2,))\n"
        "assert tuple(st.z.shape) == (2, 2, 4)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'meters_lv2_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_registry_names_every_jax_meter():
    """Every meter of the JAX package is either available in the port or
    refused by name with NotImplementedError."""
    from meters_lv2_tpu.models import available as jax_available

    assert set(meters_lv2_torch.available()) == {"EBUr128"} | PORTED_BALLISTICS
    assert not set(meters_lv2_torch.available()) & torch_base.NOT_YET_PORTED
    assert set(jax_available()) == (
        set(meters_lv2_torch.available()) | torch_base.NOT_YET_PORTED
    )
    for name in ("dr14mono", "TPnRMSstereo", "spectr30mono", "surround5"):
        with pytest.raises(NotImplementedError, match=name):
            meters_lv2_torch.create(name, 48000)
    with pytest.raises(KeyError):
        meters_lv2_torch.create("no-such-meter", 48000)


PORTED_BALLISTICS = {
    "dBTPmono", "dBTPstereo", "BBCM6", "COR",
    "K12mono", "K12stereo", "K14mono", "K14stereo", "K20mono", "K20stereo",
    "VUmono", "VUstereo", "DINmono", "DINstereo", "NORmono", "NORstereo",
    "BBCmono", "BBCstereo", "EBUmono", "EBUstereo",
}


@pytest.mark.parametrize("name", sorted(PORTED_BALLISTICS))
def test_create_ballistics_meter(name):
    """create() gives the class the JAX package registers under the name;
    one update and read on a small batch run on CPU tensors."""
    from meters_lv2_tpu.models import create as jax_create

    m = meters_lv2_torch.create(name, 44100)
    assert type(m).__name__ == type(jax_create(name, 44100)).__name__
    stereo_in = name in ("BBCM6", "COR")
    st = m.init((2,))
    x = torch.from_numpy(
        (0.1 * np.random.default_rng(0).standard_normal((2, 2, 256) if stereo_in else (2, 256)))
        .astype(np.float32))
    st = m.update(st, x)
    out, _ = m.read(st)
    for v in (out.values() if isinstance(out, dict) else [out]):
        assert v.shape == (2,) and v.dtype == torch.float32 and bool(torch.isfinite(v).all())


def test_ref_level_gain_matches_jax():
    from meters_lv2_tpu.models.base import ref_level_gain as jax_gain

    # f32 pow in two libraries: equal to within an ulp or two
    for db in (-18.0, -20.0, 0.0, 6.5):
        np.testing.assert_allclose(
            float(torch_base.ref_level_gain(db)), float(jax_gain(db)), rtol=3e-7
        )
