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
        "st = meter.init((2,), device='cpu')\n"
        "assert tuple(st.z.shape) == (2, 2, 4)\n"
        "import meters_lv2_torch.ops.hist, meters_lv2_torch.ops.bitmeter_stats\n"
        "import meters_lv2_torch.models.sigdist, meters_lv2_torch.models.bitmeter\n"
        "import meters_lv2_torch.models.dr14, meters_lv2_torch.utils.interop\n"
        "import meters_lv2_torch.models.spectrum, meters_lv2_torch.ops.spectrum_fused\n"
        "import meters_lv2_torch.models.surround, meters_lv2_torch.ops.surround_fused\n"
        "import meters_lv2_torch.models.phasewheel, meters_lv2_torch.ops.stft_fused\n"
        "import meters_lv2_torch.models.goniometer, meters_lv2_torch.ops.fft\n"
        "for name in ('dr14stereo', 'SigDistHist', 'bitmeter', 'spectr30stereo', 'surround5',\n"
        "             'phasewheel', 'stereoscope', 'goniometer'):\n"
        "    m.create(name, 48000).init((2,), device='cpu')\n"
        "from meters_lv2_torch.ops.surround_fused import fused_core_wide, wide_launch_count\n"
        "from meters_lv2_torch.ops.ballistics_core import ballistics_envelope_reference\n"
        "from meters_lv2_torch.ops import r128_fused\n"
        "import torch\n"
        "x, z, h = torch.zeros(2, 2, 256), torch.zeros(2, 2, 4), torch.zeros(2, 2, 47)\n"
        "try:\n"
        "    r128_fused._fused_core_cuda(x, z, h, (1.0, 1.0), meter.sys.op(128),\n"
        "                                torch.zeros(2, dtype=torch.int32), 100, 4)\n"
        "except ValueError as e:\n"
        "    assert 'fragm > 128' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('seg mode took fragm=100')\n"
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



def test_ingest_pipeline_and_cli_import_no_jax():
    """The slice above the meters (WAV ingest, the native loader, resampling,
    streaming, the pipeline, the vendored schema and render modules and the
    CLI) imports neither jax nor meters_lv2_tpu."""
    code = (
        "import sys\n"
        "import meters_lv2_torch.io.wav, meters_lv2_torch.io.batch, meters_lv2_torch.io.stream\n"
        "import meters_lv2_torch.runtime.native, meters_lv2_torch.parallel.pipeline\n"
        "import meters_lv2_torch.models.schema, meters_lv2_torch.utils.db\n"
        "import meters_lv2_torch.utils.png, meters_lv2_torch.utils.render\n"
        "import meters_lv2_torch.__main__ as cli\n"
        "from meters_lv2_torch.ops.resample import RationalResampler, resample_signal\n"
        "from meters_lv2_torch.parallel import MeterPipeline\n"
        "from meters_lv2_torch.io import read_wav, write_wav\n"
        "assert cli.main(['--list']) == 0\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'meters_lv2_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "ok"


def test_live_shell_and_host_utils_import_no_jax():
    """The live shell and the host utilities it rests on (checkpoints,
    transport following, profiling) import neither jax nor meters_lv2_tpu;
    an engine runs on CPU tensors when asked."""
    code = (
        "import sys\n"
        "import meters_lv2_torch.live as live\n"
        "import meters_lv2_torch.utils.state, meters_lv2_torch.utils.transport\n"
        "import meters_lv2_torch.utils.profiler\n"
        "eng = live.LiveEngine(['k20', 'goniometer'], 48000, 2, device='cpu')\n"
        "import numpy as np\n"
        "eng.feed(np.zeros((2, 1000), np.float32))\n"
        "assert set(eng.snapshot()) == {'k20', 'goniometer'}\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'meters_lv2_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "ok"


def test_sharded_analyses_import_no_jax():
    """The mesh, the sequence-parallel handoff, the sharded analyses and the
    sharded checkpoints import neither jax nor meters_lv2_tpu."""
    code = (
        "import sys\n"
        "import meters_lv2_torch.parallel.mesh, meters_lv2_torch.parallel.timepar\n"
        "import meters_lv2_torch.parallel.r128_sharded\n"
        "import meters_lv2_torch.parallel.spectrum_sharded\n"
        "import meters_lv2_torch.parallel.meters_sharded\n"
        "from meters_lv2_torch.parallel import launch, make_mesh, shard_batch, shard_time\n"
        "from meters_lv2_torch.utils.state import load_state_sharded, save_state_sharded\n"
        "from meters_lv2_torch.parallel.mesh import choose_backend\n"
        "assert choose_backend('cpu', 4, 0) == 'gloo'\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'meters_lv2_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "ok"


def test_registry_names_every_jax_meter():
    """Every meter of the JAX package is available in the port: none is
    left in NOT_YET_PORTED."""
    from meters_lv2_tpu.models import available as jax_available

    assert set(meters_lv2_torch.available()) == (
        {"EBUr128"} | PORTED_BALLISTICS | PORTED_STATS | PORTED_SPECTRUM | PORTED_SURROUND
        | PORTED_ANALYZERS)
    assert not set(meters_lv2_torch.available()) & torch_base.NOT_YET_PORTED
    assert set(jax_available()) == (
        set(meters_lv2_torch.available()) | torch_base.NOT_YET_PORTED
    )
    assert torch_base.NOT_YET_PORTED == set()
    with pytest.raises(KeyError):
        meters_lv2_torch.create("no-such-meter", 48000)


PORTED_ANALYZERS = {"goniometer", "phasewheel", "stereoscope"}
PORTED_SURROUND = {f"surround{n}" for n in range(3, 9)}
PORTED_SPECTRUM = {"spectr30mono", "spectr30stereo"}
PORTED_STATS = {"dr14mono", "dr14stereo", "TPnRMSmono", "TPnRMSstereo", "SigDistHist", "bitmeter"}
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
    st = m.init((2,), device="cpu")
    x = torch.from_numpy(
        (0.1 * np.random.default_rng(0).standard_normal((2, 2, 256) if stereo_in else (2, 256)))
        .astype(np.float32))
    st = m.update(st, x)
    out, _ = m.read(st)
    for v in (out.values() if isinstance(out, dict) else [out]):
        assert v.shape == (2,) and v.dtype == torch.float32 and bool(torch.isfinite(v).all())


@pytest.mark.parametrize("name", sorted(PORTED_SURROUND))
def test_create_surround_meter(name):
    """surround3..8 are available under the JAX package's class names; one
    update (a 128-sample bulk and a 72-sample tail) and read on CPU tensors."""
    from meters_lv2_tpu.models import create as jax_create

    m = meters_lv2_torch.create(name, 48000)
    assert name in meters_lv2_torch.available()
    assert type(m).__name__ == type(jax_create(name, 48000)).__name__
    C = int(name[-1])
    st = m.init((2,), device="cpu")
    x = torch.from_numpy(
        (0.1 * np.random.default_rng(C).standard_normal((2, C, 200))).astype(np.float32))
    out, _ = m.read(m.update(st, x))
    assert out["level"].shape == out["peak"].shape == (2, C)
    assert out["correlation"].shape == (2, 4 if C > 3 else 3)
    for v in out.values():
        assert v.dtype == torch.float32 and bool(torch.isfinite(v).all())


@pytest.mark.parametrize("name", sorted(PORTED_ANALYZERS))
def test_create_analyzer(name):
    """The display analyzers are available under the JAX package's class
    names; init() with no device puts the state on the card (the default
    argument is "cuda"); one process() call on CPU tensors."""
    import dataclasses
    import inspect

    from meters_lv2_tpu.models import create as jax_create

    m = meters_lv2_torch.create(name, 48000)
    assert type(m).__name__ == type(jax_create(name, 48000)).__name__
    assert inspect.signature(m.init).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        def tensors(st):
            vals = (list(st.values()) if isinstance(st, dict)
                    else [getattr(st, f.name) for f in dataclasses.fields(st)])
            return [t for v in vals for t in (tensors(v) if dataclasses.is_dataclass(v) else [v])]

        assert all(t.is_cuda for t in tensors(m.init((2,))))
    st = m.init((2,), device="cpu")
    T = 1920 if name != "goniometer" else 512
    x = torch.from_numpy(
        (0.1 * np.random.default_rng(3).standard_normal((2, 2, T))).astype(np.float32))
    out, _ = m.process(st, x)
    for v in out.values():
        assert v.dtype == torch.float32 and v.shape[0] == 2 and bool(torch.isfinite(v).all())


def test_ref_level_gain_matches_jax():
    from meters_lv2_tpu.models.base import ref_level_gain as jax_gain

    # f32 pow in two libraries: equal to within an ulp or two
    for db in (-18.0, -20.0, 0.0, 6.5):
        np.testing.assert_allclose(
            float(torch_base.ref_level_gain(db)), float(jax_gain(db)), rtol=3e-7
        )
