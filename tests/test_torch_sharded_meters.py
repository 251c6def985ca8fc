"""The port's sharded whole-file analyses of the other meter families
(parallel/meters_sharded.py) on torch.distributed (gloo, CPU ranks): dBTP,
DR-14, TP+RMS, sigdist in both variance modes, the bit meter, VU, DIN,
BBC, BBC M-6 (S20 off and on), K20, COR, surround5 and surround8.

One module fixture ``launch``es a world of 4 CPU ranks once and runs every
family under dp = 2 x sp = 2 and dp = 1 x sp = 4.  Each result is held
against one serial update + read of the port on the whole input, at the
bars of tests/test_meters_sharded.py (exact where that file asserts
exact), and against the JAX package's ``analyze_*`` on the same (dp, sp)
of the conftest's virtual mesh.  Against the JAX package, where
test_meters_sharded.py asserts exact, the port's own bar against the JAX
package applies: 1e-6 relative for the ballistics readouts (the port
rounds each step of the recurrence on its own, XLA fuses the multiply-add;
tests/test_torch_meters_ballistics.py), 1e-5 of each readout's scale for
the DR-14 and TP+RMS levels (tests/test_torch_stats.py); integer readouts
stay exact.

Sizes: the plain ballistics loop (``ops/ballistics_core.py``) runs ~35 us
a group of 4 samples on the CPU, and the chain visits the shards in turn,
so dBTP, DR-14 and TP+RMS run short signals, DR-14 and TP+RMS at
fs = 4800 Hz (a 3 s window is 14,401 samples; 47,616 samples hold three
windows and an open one, and every shard boundary falls inside a window).
The true-peak lengths are multiples of 128 a shard, so that the
oversampler's 128-sample frames fall alike in the serial and the sharded
run (the frame decides a product's summation order) and the serial update
has no tail (its tail runs the serial ballistics body, the bulk the
envelope body): then the sharded dBTP equals the serial bit for bit, as
the JAX tests assert.
"""

import numpy as np
import pytest
import torch

import meters_lv2_torch as mt
from meters_lv2_torch.parallel import gather_outputs, launch, make_mesh, shard_time
from meters_lv2_torch.parallel import mesh as tmesh
from meters_lv2_torch.parallel import meters_sharded as ms

torch.set_num_threads(1)

FS = 48000
FS_LOW = 4800
LAYOUTS = [(2, 2), (1, 4)]
PPM_RTOL = 1e-6

# name: (port meter name, fs, constructor kwargs, analyze_* name, analyze kwargs, input key)
CASES = {
    "dBTP": ("dBTPmono", FS, {}, "analyze_truepeak", {}, "tp"),
    "DR14": ("dr14stereo", FS_LOW, {}, "analyze_dr14", {}, "dr14"),
    "TPnRMS": ("TPnRMSstereo", FS_LOW, {}, "analyze_tpnrms", {}, "tpnrms"),
    "sigdist": ("SigDistHist", FS, {}, "analyze_sigdist", {}, "sigdist"),
    "sigdist_oor": ("SigDistHist", FS, {"reference_oor_count": True}, "analyze_sigdist", {},
                    "sigdist"),
    "bitmeter": ("bitmeter", FS, {}, "analyze_bitmeter", {}, "bit"),
    "VU": ("VUmono", FS, {}, "analyze_needle", {}, "mono"),
    "DIN": ("DINmono", FS, {}, "analyze_needle", {"ref_level_db": -18.0}, "mono"),
    "BBC": ("BBCmono", FS, {}, "analyze_needle", {"ref_level_db": -18.0}, "mono"),
    "BBCM6": ("BBCM6", FS, {}, "analyze_needle", {}, "stereo"),
    "BBCM6_s20": ("BBCM6", FS, {}, "analyze_needle", {"s20": True}, "stereo"),
    "K20": ("K20mono", FS, {}, "analyze_kmeter", {}, "k20"),
    "COR": ("COR", FS, {}, "analyze_stcorr", {}, "cor"),
    "surround5": ("surround5", FS, {}, "analyze_surround", {}, "sur5"),
    "surround8": ("surround8", FS, {}, "analyze_surround", {}, "sur8"),
}


def _signal(shape, seed):
    """0.25 N(0,1) with a loud burst a third of the way in (peaks and
    ballistics get structure), as tests/test_meters_sharded.py makes it."""
    x = 0.25 * np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    T = shape[-1]
    x[..., T // 3:T // 3 + 64] *= 4.0
    return x


def _inputs():
    sig = _signal((4, FS), 4)
    # clip some samples out of the histogram's range (the out-of-range path)
    sig = np.where(np.abs(sig) > 1.1, np.sign(sig) * 1.35, sig).astype(np.float32)
    bit = (0.3 * np.random.default_rng(5).standard_normal((2, FS))).astype(np.float32)
    bit[0, 10], bit[0, 20], bit[1, 30], bit[1, 40] = np.float32(1e-41), 0.0, np.inf, np.nan
    rng = np.random.default_rng(10)
    mono = (0.3 * rng.standard_normal((4, 1, FS))).astype(np.float32)
    cor = np.concatenate(
        [mono, 0.7 * mono + 0.1 * rng.standard_normal((4, 1, FS)).astype(np.float32)], axis=1)
    return {
        "tp": _signal((4, 188 * 128), 1),  # 0.5 s; 47 x 128 a shard at sp = 4
        "dr14": _signal((4, 2, 93 * 512), 2),  # 9.92 s at 4800 Hz
        "tpnrms": _signal((2, 2, 38 * 512), 3),  # 4.05 s at 4800 Hz
        "sigdist": sig,
        "bit": bit,
        "mono": _signal((4, FS), 6),
        "stereo": _signal((2, 2, FS), 8),
        "k20": _signal((4, 2 * FS), 9),
        "cor": cor.astype(np.float32),
        "sur5": _signal((4, 5, FS), 11),
        "sur8": _signal((4, 8, FS), 12),
    }


def _make(name):
    meter, fs, kw, _, _, _ = CASES[name]
    return mt.create(meter, fs, **kw)


def _rank_body(rank, inputs):
    out = {}
    for dp, sp in LAYOUTS:
        mesh = make_mesh(dp, sp, device="cpu")
        for name, (_, _, _, fn, akw, key) in CASES.items():
            res = getattr(ms, fn)(_make(name), shard_time(mesh, torch.from_numpy(inputs[key])),
                                  mesh, **akw)
            res = gather_outputs(res if isinstance(res, dict) else {"value": res}, mesh)
            out[name, dp, sp] = {k: v.numpy() for k, v in res.items()}
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def sharded(inputs):
    return launch(_rank_body, 4, inputs, device="cpu")[0]


def _serial(name, x):
    """One update + read of the port on the whole input."""
    m = _make(name)
    akw = CASES[name][4]
    xt = torch.from_numpy(x)
    batch = x.shape[:1] if name in ("DR14", "TPnRMS", "BBCM6", "BBCM6_s20", "COR",
                                    "surround5", "surround8") else x.shape[:-1]
    st = m.init(batch, device="cpu")
    st = m.update(st, xt, s20=True) if akw.get("s20") else m.update(st, xt)
    out = m.read(st, akw["ref_level_db"])[0] if "ref_level_db" in akw else m.read(st)[0]
    return {k: v.numpy() for k, v in (out if isinstance(out, dict) else {"value": out}).items()}


def _jax(name, x, dp, sp):
    import jax
    import jax.numpy as jnp

    from meters_lv2_tpu.models import create
    from meters_lv2_tpu.parallel import make_mesh as jax_make_mesh
    from meters_lv2_tpu.parallel import meters_sharded as jms

    meter, fs, kw, fn, akw, _ = CASES[name]
    m = create(meter, fs, **kw)
    out = getattr(jms, fn)(m, jnp.asarray(x), jax_make_mesh(dp, sp, devices=jax.devices()[:dp * sp]),
                           **akw)
    return {k: np.asarray(v) for k, v in (out if isinstance(out, dict) else {"value": out}).items()}


def _exact(got, want, keys):
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _close(got, want, keys, rtol=0.0, atol=0.0):
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def _scaled(got, want, keys, tol):
    for k in keys:
        a, b = got[k].astype(np.float64), want[k].astype(np.float64)
        assert np.all(np.abs(a - b) <= tol * np.abs(b).max() + 1e-30), (k, np.abs(a - b).max())


def _check(name, got, want, against_jax):
    """The bars of tests/test_meters_sharded.py; against the JAX package its
    exact ballistics and true-peak readouts take the port's own bar."""
    if name == "dBTP":
        if against_jax:
            _close(got, want, ("level", "peak"), rtol=PPM_RTOL)
        else:
            _exact(got, want, ("level", "peak"))
    elif name == "DR14":
        _exact(got, want, ("block_count",))
        if against_jax:
            _scaled(got, want, ("m_peak", "v_peak"), 1e-5)
        else:
            _exact(got, want, ("m_peak", "v_peak"))
        _close(got, want, ("dr", "dr_total", "m_rms", "v_rms"), atol=2e-3)
    elif name == "TPnRMS":
        if against_jax:
            _scaled(got, want, ("m_peak", "v_peak", "v_rms", "m_rms"), 1e-5)
        else:
            _exact(got, want, ("m_peak", "v_peak"))
            _close(got, want, ("v_rms", "m_rms"), rtol=2e-5)
    elif name.startswith("sigdist"):
        _exact(got, want, ("hist", "hist_max", "hist_peak_bin", "integration_time"))
        _close(got, want, ("hist_avg",), rtol=2e-5, atol=1e-4)
        _close(got, want, ("mean",), rtol=2e-4, atol=1e-7)
        _close(got, want, ("variance",), rtol=2e-4)
    elif name == "bitmeter":
        assert set(got) == set(want)
        _exact(got, want, want)
    elif name == "VU":
        _close(got, want, ("value",), rtol=2e-5, atol=1e-7)
    elif name in ("DIN", "BBC", "BBCM6", "BBCM6_s20"):
        keys = ("value",) if name in ("DIN", "BBC") else ("mid", "side")
        if against_jax:
            _close(got, want, keys, rtol=PPM_RTOL)
        else:
            _exact(got, want, keys)
    elif name == "K20":
        _exact(got, want, ("peak",))
        _close(got, want, ("rms",), rtol=2e-5, atol=1e-7)
    elif name == "COR":
        _close(got, want, ("value",), rtol=1e-4, atol=1e-5)
    else:  # surround5 / surround8
        _exact(got, want, ("peak",))
        _close(got, want, ("level",), rtol=2e-5, atol=1e-7)
        _close(got, want, ("correlation",), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dp,sp", LAYOUTS)
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_matches_serial(sharded, inputs, name, dp, sp):
    got = sharded[name, dp, sp]
    want = _serial(name, inputs[CASES[name][5]])
    assert set(got) == set(want)
    _check(name, got, want, against_jax=False)


@pytest.mark.parametrize("dp,sp", LAYOUTS)
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_matches_jax(sharded, inputs, name, dp, sp):
    got = sharded[name, dp, sp]
    want = _jax(name, inputs[CASES[name][5]], dp, sp)
    assert set(got) == set(want)
    _check(name, got, want, against_jax=True)


def test_length_checks():
    """T / sp must be a multiple of 4; sigdist and the bit meter refuse a
    whole file of 2^31 samples or more (the reference's acquisition cap)."""
    cpu = torch.device("cpu")
    mesh = tmesh.Mesh(dp=tmesh.Axis(None, 0, 1, cpu, False),
                      sp=tmesh.Axis(None, 0, 4, cpu, False),
                      rank=0, world_size=4, device=cpu, backend="gloo")
    with pytest.raises(ValueError, match="multiple of 4"):
        ms.analyze_truepeak(mt.create("dBTPmono", FS), torch.zeros(2, 102), mesh)
    big = torch.zeros(1, 1).expand(1, 2 ** 29)  # x 4 shards = 2^31 samples
    with pytest.raises(ValueError, match="2\\^31"):
        ms.analyze_sigdist(mt.create("SigDistHist", FS), big, mesh)
    with pytest.raises(ValueError, match="2\\^31"):
        ms.analyze_bitmeter(mt.create("bitmeter", FS), big, mesh)
