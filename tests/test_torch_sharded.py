"""The port's sharded whole-file analyses on torch.distributed (gloo, CPU
ranks): the mesh, the sequence-parallel LTI handoff, R128, the spectrum and
the sharded checkpoints, held against the port's own serial update and
against the JAX package on its virtual CPU mesh.

One module fixture ``launch``es a world of 4 CPU ranks once; inside it
every case runs under dp = 2 x sp = 2 and dp = 1 x sp = 4 and the gathered
readouts come back.  The JAX side runs the JAX ``analyze_*`` on the same
(dp, sp) over the first dp * sp devices of the conftest's 8-device mesh.

Bars (those of tests/test_pipeline_and_parallel.py for sharded against
serial; the port's own against the JAX package, tests/test_torch_ebur128.py):
  * R128 histograms, counts and the radar position: exact, against the
    port's serial update and against the JAX sharded run;
  * max M/S and the radar rings: 1e-5 absolute (LUFS) against the port's
    serial update, 1e-4 against the JAX package (the port's bar for its
    loudness-valued leaves, 100x the float32 noise between the packages);
    integrated, integ_thr, LRA and its bounds, loudness M/S, the curves and
    the curve's last point against loudness_M: 1e-4; dbtp: 1e-6 relative
    (the same oversamples in another summation order; the JAX test's 1e-6
    absolute at levels up to ~2);
  * the spectrum: bands and peaks 5e-3 dB absolute, the filter state 1e-3
    absolute plus 1e-3 relative (split-order numerics: A^L composition,
    smoother superposition);
  * lti_apply_sp / banked_lti_apply_sp against the JAX serial ``apply``:
    2e-5 absolute plus 1e-6 relative (the JAX test's bars) for the
    K-weighting, 1e-5 of each output's scale for the 30-band bank (its
    cascaded sections ring to large internal values).
Rank bodies live at module level (spawned ranks import this module by
name); the module imports no JAX at the top, so the ranks do not either.
"""

import os

import numpy as np
import pytest
import torch

import meters_lv2_torch as mt
from meters_lv2_torch.ops import design, lti
from meters_lv2_torch.parallel import (
    gather_outputs, launch, make_mesh, mesh as tmesh, r128_sharded, shard_batch, shard_time,
    spectrum_sharded, timepar)
from meters_lv2_torch.utils.state import load_state_sharded, save_state_sharded

torch.set_num_threads(1)

FS = 48000
FS44 = 44100
LAYOUTS = [(2, 2), (1, 4)]
R128_CASES = {  # name: (fs, radar_seconds)
    "r128_48k": (FS, 120.0),
    "r128_48k_radar42": (FS, 42.0),  # radar_spd 5600: intervals straddle shards
    "r128_44k": (FS44, 120.0),  # fragm 2205: no shard is 128-aligned
}
LOUD_ATOL = 1e-4


def _signal(name, seconds, fs):
    from signals import make_signal

    x = make_signal(name, seconds, fs)
    return np.stack([x, 0.5 * x, 0.25 * x, 2.0 * x]).astype(np.float32)


def _inputs():
    rng = np.random.default_rng(3)
    return {
        "r128_48k": _signal("bursts", 12.0, FS),  # sp = 4: 3 s (60-fragment) shards
        "r128_44k": _signal("mix", 12.0, FS44),
        "spec": _signal("mix", 1.0, FS),
        "lti": (0.3 * rng.standard_normal((2, 8 * 6000))).astype(np.float32),
        "bank": (0.3 * rng.standard_normal((2, 4800))).astype(np.float32),
    }


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_np(v) for v in tree)
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


def _rank_body(rank, inputs, ckpt_dir):
    """Every case under both layouts; rank 0 returns the gathered readouts,
    every rank its checkpoint checks."""
    out = {}
    k_sys = lti.LTISystem(*design.k_weighting_state_space(FS))
    spec_m = mt.create("spectr30stereo", FS)
    for dp, sp in LAYOUTS:
        mesh = make_mesh(dp, sp, device="cpu")
        for name, (fs, radar) in R128_CASES.items():
            x = torch.from_numpy(inputs["r128_44k" if fs == FS44 else "r128_48k"])
            m = mt.create("EBUr128", fs, nchan=2, radar_seconds=radar)
            res = r128_sharded.analyze_r128(m, shard_time(mesh, x), mesh)
            out[name, dp, sp] = gather_outputs(res, mesh, r128_sharded.OUT_SPECS)
        read, st = spectrum_sharded.analyze_spectrum(
            spec_m, shard_time(mesh, torch.from_numpy(inputs["spec"])), mesh)
        out["spec", dp, sp] = (gather_outputs(read, mesh), gather_outputs(
            {"zf": st.zf, "val": st.val, "peak": st.peak}, mesh))
        u = shard_time(mesh, torch.from_numpy(inputs["lti"]))
        y, s = timepar.lti_apply_sp(k_sys, u, torch.zeros(u.shape[0], 4), mesh.sp)
        out["lti", dp, sp] = gather_outputs({"y": y, "s": s}, mesh, {"y": ("dp", "sp")})
        u = shard_time(mesh, torch.from_numpy(inputs["bank"]))
        y, s = timepar.banked_lti_apply_sp(spec_m.bank, u, spec_m.bank.init((u.shape[0],), "cpu"),
                                           mesh.sp)
        out["bank", dp, sp] = gather_outputs({"y": y, "s": s}, mesh, {"y": ("dp", None, "sp")})
    return {"readouts": _np(out) if rank == 0 else None,
            "ckpt": _checkpoint_roundtrip(rank, inputs["r128_48k"], ckpt_dir)}


def _checkpoint_roundtrip(rank, x, path):
    """An R128 state under dp = 2 x sp = 2 saved after 2 s, loaded, and
    carried 1 s further, against the run that never saved; then the same
    checkpoint under dp = 1 x sp = 4, which must be refused."""
    mesh = make_mesh(2, 2, device="cpu")
    m = mt.create("EBUr128", FS, nchan=2)
    xb = shard_batch(mesh, torch.from_numpy(x))
    st = m.update(m.init((xb.shape[0],), device="cpu"), xb[..., :2 * FS])
    save_state_sharded(st, path, mesh)
    files = sorted(os.listdir(path))
    loaded = load_state_sharded(m.init((xb.shape[0],), device="cpu"), path, mesh)
    a = m.update(loaded, xb[..., 2 * FS:3 * FS])
    b = m.update(st, xb[..., 2 * FS:3 * FS])
    same = all(torch.equal(getattr(a, f), getattr(b, f)) for f in a.__dataclass_fields__)
    other = make_mesh(1, 4, device="cpu")
    try:
        load_state_sharded(m.init((x.shape[0],), device="cpu"), path, other)
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"rank": rank, "files": files, "same": same, "refused": refused}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def sharded(inputs, tmp_path_factory):
    res = launch(_rank_body, 4, inputs, str(tmp_path_factory.mktemp("ckpt")), device="cpu")
    return res[0]["readouts"], [r["ckpt"] for r in res]


def _jax_mesh(dp, sp):
    import jax

    from meters_lv2_tpu.parallel import make_mesh as jax_make_mesh

    return jax_make_mesh(dp, sp, devices=jax.devices()[:dp * sp])


# -- the mesh: pure functions and argument checks ----------------------------


@pytest.mark.parametrize("dev,world,cards,asked,want", [
    ("cpu", 4, 0, None, "gloo"),
    ("cpu", 1, 4, None, "gloo"),
    ("cuda", 4, 1, None, "gloo"),  # 4 ranks share one card: host-staged gloo
    ("cuda", 4, 4, None, "nccl"),  # a card each
    ("cuda", 2, 8, None, "nccl"),
    ("cuda", 4, 4, "gloo", "gloo"),  # gloo asked for: allowed, host-staged
    ("cuda", 4, 1, "nccl", ValueError),  # NCCL refuses two ranks on one card
    ("cpu", 2, 0, "nccl", ValueError),
    ("cuda", 2, 0, None, RuntimeError),  # no card: no silent CPU fallback
    ("cuda", 2, 2, "mpi", ValueError),
])
def test_backend_rule(dev, world, cards, asked, want):
    if isinstance(want, type):
        with pytest.raises(want):
            tmesh.choose_backend(dev, world, cards, asked)
    else:
        assert tmesh.choose_backend(dev, world, cards, asked) == want


def test_rank_device():
    assert tmesh.rank_device(3, 4, "cpu", 0) == torch.device("cpu")
    assert tmesh.rank_device(3, 4, "cuda", 4) == torch.device("cuda", 3)
    assert tmesh.rank_device(3, 4, "cuda", 1) == torch.device("cuda", 0)
    with pytest.raises(RuntimeError):
        tmesh.rank_device(0, 1, "cuda", 0)


def _fake_mesh(dp, sp, rank=0):
    """A mesh object for checks that stop before any collective."""
    cpu = torch.device("cpu")
    dp_i, sp_i = divmod(rank, sp)
    return tmesh.Mesh(dp=tmesh.Axis(None, dp_i, dp, cpu, False),
                      sp=tmesh.Axis(None, sp_i, sp, cpu, False),
                      rank=rank, world_size=dp * sp, device=cpu, backend="gloo")


def test_shard_blocks_and_divisibility_errors():
    x = torch.arange(4 * 3 * 12, dtype=torch.float32).reshape(4, 3, 12)
    mesh = _fake_mesh(2, 3, rank=5)  # dp index 1, sp index 2
    assert torch.equal(shard_time(mesh, x), x[2:, :, 8:])
    assert torch.equal(shard_batch(mesh, x), x[2:])
    assert torch.equal(shard_time(mesh, x.transpose(0, 2), batch_axis=2, time_axis=0),
                       x.transpose(0, 2)[8:, :, 2:])
    with pytest.raises(ValueError, match="not divisible by the sp size 3"):
        shard_time(mesh, x[..., :10])
    with pytest.raises(ValueError, match="not divisible by the dp size 2"):
        shard_time(mesh, x[:3])
    with pytest.raises(ValueError, match="not divisible by the dp size 2"):
        shard_batch(mesh, x[:3])


def test_make_mesh_needs_an_initialised_world():
    with pytest.raises(RuntimeError, match="initialised world"):
        make_mesh(1, 1, device="cpu")


@pytest.mark.parametrize("kw,T,err,match", [
    ({}, 2 * FS // 4, ValueError, "59 fragments"),  # 10 fragments a shard
    ({"reference_radar": True}, 3 * FS, NotImplementedError, "default radar"),
    ({"runtime_radar_speed": True}, 3 * FS, NotImplementedError, "default radar"),
])
def test_analyze_r128_rejections(kw, T, err, match):
    m = mt.create("EBUr128", FS, nchan=2, **kw)
    with pytest.raises(err, match=match):
        r128_sharded.analyze_r128(m, torch.zeros(2, 2, T), _fake_mesh(2, 4))


# -- R128 -----------------------------------------------------------------------


def _assert_r128(got, want, peak_atol):
    for k in ("hist_m", "hist_s", "count_m", "count_s", "radar_pos"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    for k in ("max_M", "max_S", "radar_m", "radar_s"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, atol=peak_atol,
                                   err_msg=k)
    for k in ("integrated", "integ_thr", "range_min", "range_max", "range_thr", "lra",
              "loudness_M", "loudness_S"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, atol=LOUD_ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(got["dbtp"], np.asarray(want["dbtp"]), rtol=1e-6, err_msg="dbtp")


@pytest.mark.parametrize("dp,sp", LAYOUTS)
@pytest.mark.parametrize("case", list(R128_CASES))
def test_r128_sharded_matches_serial(sharded, inputs, case, dp, sp):
    """The port's sharded analysis against one serial update + read of the
    port on the whole file, and the curve's shape and last point."""
    fs, radar = R128_CASES[case]
    got = sharded[0][case, dp, sp]
    x = inputs["r128_44k" if fs == FS44 else "r128_48k"]
    m = mt.create("EBUr128", fs, nchan=2, radar_seconds=radar)
    st = m.update(m.init((4,), device="cpu"), torch.from_numpy(x))
    ref = {k: v.numpy() for k, v in m.read(st)[0].items()}
    ref.update(hist_m=st.hist_m.numpy(), hist_s=st.hist_s.numpy(),
               count_m=st.count_m.numpy(), count_s=st.count_s.numpy())
    _assert_r128(got, ref, 1e-5)
    nfrag = x.shape[-1] // (fs // 20)
    assert got["curve_M"].shape == got["curve_S"].shape == (4, nfrag)
    np.testing.assert_allclose(got["curve_M"][:, -1], ref["loudness_M"], atol=LOUD_ATOL)
    np.testing.assert_allclose(got["curve_S"][:, -1], ref["loudness_S"], atol=LOUD_ATOL)


@pytest.mark.parametrize("dp,sp", LAYOUTS)
@pytest.mark.parametrize("case", list(R128_CASES))
def test_r128_sharded_matches_jax(sharded, inputs, case, dp, sp):
    """The port's sharded analysis against the JAX package's on the same
    (dp, sp): every key of the JAX dict, the curves included."""
    import jax.numpy as jnp

    from meters_lv2_tpu.models.ebur128 import EbuR128Meter
    from meters_lv2_tpu.parallel.r128_sharded import analyze_r128

    fs, radar = R128_CASES[case]
    x = inputs["r128_44k" if fs == FS44 else "r128_48k"]
    want = analyze_r128(EbuR128Meter(fs, nchan=2, radar_seconds=radar), jnp.asarray(x),
                        _jax_mesh(dp, sp))
    got = sharded[0][case, dp, sp]
    assert set(got) == set(want)
    _assert_r128(got, want, LOUD_ATOL)
    for k in ("curve_M", "curve_S"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, atol=LOUD_ATOL,
                                   err_msg=k)


# -- spectrum -------------------------------------------------------------------


def _assert_spectrum(got, want_read, want_zf):
    read, st = got
    for k in ("bands", "peaks"):
        np.testing.assert_allclose(read[k], np.asarray(want_read[k]), atol=5e-3, err_msg=k)
    np.testing.assert_allclose(st["zf"], np.asarray(want_zf), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("dp,sp", LAYOUTS)
def test_spectrum_sharded_matches_serial_and_jax(sharded, inputs, dp, sp):
    import jax.numpy as jnp

    from meters_lv2_tpu.models.spectrum import SpectrumAnalyzer
    from meters_lv2_tpu.parallel.spectrum_sharded import analyze_spectrum

    x = inputs["spec"]
    m = mt.create("spectr30stereo", FS)
    st = m.update(m.init((4,), device="cpu"), torch.from_numpy(x), stereo=True)
    got = sharded[0]["spec", dp, sp]
    _assert_spectrum(got, {k: v.numpy() for k, v in m.read(st)[0].items()}, st.zf.numpy())
    jread, jst = analyze_spectrum(SpectrumAnalyzer(FS), jnp.asarray(x), _jax_mesh(dp, sp))
    _assert_spectrum(got, jread, jst.zf)
    np.testing.assert_allclose(got[1]["val"], np.asarray(jst.val), rtol=1e-3, atol=1e-12)
    np.testing.assert_allclose(got[1]["peak"], np.asarray(jst.peak), rtol=1e-3, atol=1e-12)


# -- the LTI handoff alone --------------------------------------------------------


@pytest.mark.parametrize("dp,sp", LAYOUTS)
def test_lti_apply_sp_matches_jax_serial(sharded, inputs, dp, sp):
    """The counterpart of test_timepar_lti_matches_serial: K-weighting over
    time shards against the JAX package's serial apply, outputs and the
    stream-end state."""
    import jax.numpy as jnp

    from meters_lv2_tpu.ops import design as jdesign
    from meters_lv2_tpu.ops import lti as jlti

    jsys = jlti.LTISystem(*jdesign.k_weighting_state_space(FS))
    x = inputs["lti"]
    y_ref, s_ref = jsys.apply(jnp.asarray(x), jsys.init((2,)))
    got = sharded[0]["lti", dp, sp]
    np.testing.assert_allclose(got["y"], np.asarray(y_ref), atol=2e-5, rtol=1e-6)
    np.testing.assert_allclose(got["s"], np.asarray(s_ref), atol=2e-5, rtol=1e-6)


@pytest.mark.parametrize("dp,sp", LAYOUTS)
def test_banked_lti_apply_sp_matches_jax_serial(sharded, inputs, dp, sp):
    import jax.numpy as jnp

    from meters_lv2_tpu.models.spectrum import SpectrumAnalyzer

    bank = SpectrumAnalyzer(FS).bank
    x = inputs["bank"]
    y_ref, s_ref = bank.apply(jnp.asarray(x), bank.init((2,)))
    got = sharded[0]["bank", dp, sp]
    for k, ref in (("y", np.asarray(y_ref)), ("s", np.asarray(s_ref))):
        scale = np.abs(ref).max(axis=-1, keepdims=True)
        assert np.all(np.abs(got[k] - ref) <= 1e-5 * scale), (k, np.abs(got[k] - ref).max())


@pytest.mark.parametrize("system", ["k-weighting", "k-meter", "bank"])
@pytest.mark.parametrize("T", [100, 128, 1000, 12345, 48000])
@pytest.mark.parametrize("entry", ["zero", "state"])
def test_exit_state_matches_apply(system, T, entry):
    """``exit_state``'s pairwise tree (``lti.lti_scan_exit``) against the
    block loop of ``apply``, from a zero state (the zero-state pass of
    timepar) and from the state that 1,000 samples of input leave (a state
    the system can reach: a random one excites the band filters' transient
    growth by up to 1e11): the exit state within 1e-5 of the channel's (the
    band's) state magnitude over the streams: float32 sums of up to 376
    terms in another order (the tree's rounding grows with log2 of the
    blocks, the loop's with their count, 376 x 2^-24 = 2.2e-5 at most)."""
    rng = np.random.default_rng(T)
    if system == "k-weighting":
        sys_ = lti.LTISystem(*design.k_weighting_state_space(FS))
        u, s0 = rng.standard_normal((2, 2, T + 1000)), torch.zeros(2, 2, 4)
    elif system == "k-meter":
        sys_ = mt.create("K20mono", FS).sys
        u, s0 = rng.standard_normal((3, T + 1000, 4)) ** 2, torch.zeros(3, 2)
    else:
        sys_ = mt.create("spectr30mono", FS).bank
        u, s0 = rng.standard_normal((2, T + 1000)), torch.zeros(2, 30, 12)
    u = torch.from_numpy((0.3 * u).astype(np.float32))
    if system == "k-meter":
        u_pre, u = u[:, :1000], u[:, 1000:]
    else:
        u_pre, u = u[..., :1000], u[..., 1000:]
    if entry == "state":
        s0 = sys_.apply(u_pre, s0)[1]
    got = sys_.exit_state(u, s0)
    want = sys_.apply(u, s0)[1]
    assert got.shape == want.shape
    scale = want.abs().amax(dim=(0, -1), keepdim=True)  # a channel's or band's state
    assert bool(((got - want).abs() <= 1e-5 * scale).all()), (got - want).abs().max()


def test_block_powers_are_float64_squares_cached_on_the_op():
    """``LTIBlockOp.at_powers``: (A^T_block)^(2^l) from float64 squaring,
    rounded to float32 once, each within 1e-6 of the float64 matrix power
    of A (relative to the power's largest entry); a second call returns the
    same cached tensors, a longer one extends them, for a single system and
    a bank."""
    k_sys = lti.LTISystem(*design.k_weighting_state_space(FS))
    bank = mt.create("spectr30mono", FS).bank
    for op, As in ((k_sys.op(128), [k_sys.A]), (bank.op(128), [m[0] for m in bank.mats])):
        got = op.at_powers(5, "cpu")
        assert len(got) == 5 and all(p.dtype == torch.float32 for p in got)
        for lev, p in enumerate(got):
            want = np.stack([np.linalg.matrix_power(A, 128 << lev).T for A in As])
            want = want if op.at.ndim == 3 else want[0]
            assert np.abs(p.numpy() - want).max() <= 1e-6 * np.abs(want).max(), lev
        again = op.at_powers(3, "cpu")
        assert all(a is b for a, b in zip(again, got))
        assert len(op.at_powers(7, "cpu")) == 7


# -- sharded checkpoints -------------------------------------------------------


def test_sharded_checkpoint_roundtrip(sharded):
    """One file a rank plus the manifest; a resumed state carries on bit for
    bit; a mesh of another layout is refused."""
    for c in sharded[1]:
        assert c["files"] == ["manifest.json"] + [f"rank{r}.npz" for r in range(4)], c
        assert c["same"], c
        assert c["refused"] and "dp=2 x sp=2" in c["refused"], c
