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

    assert set(meters_lv2_torch.available()) == {"EBUr128"}
    assert set(jax_available()) == (
        set(meters_lv2_torch.available()) | torch_base.NOT_YET_PORTED
    )
    with pytest.raises(NotImplementedError, match="dBTPmono"):
        meters_lv2_torch.create("dBTPmono", 48000)
    with pytest.raises(KeyError):
        meters_lv2_torch.create("no-such-meter", 48000)


def test_ref_level_gain_matches_jax():
    from meters_lv2_tpu.models.base import ref_level_gain as jax_gain

    # f32 pow in two libraries: equal to within an ulp or two
    for db in (-18.0, -20.0, 0.0, 6.5):
        np.testing.assert_allclose(
            float(torch_base.ref_level_gain(db)), float(jax_gain(db)), rtol=3e-7
        )
