"""The port's host utilities on CPU tensors: checkpoints (utils/state.py)
against the JAX package's, transport following (utils/transport.py) and
profiling (utils/profiler.py), and the tree walk they rest on
(utils/interop.py).

Bars: a checkpoint moves every leaf bit for bit, in either direction; a
meter continued from a checkpoint equals the same meter run throughout,
exactly in the same package, and, against the other package, at the
pipeline bars (R128's histograms and counters exact, its loudness within
1e-4); the settings word and the transport counts equal JAX's exactly.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from signals import make_signal
from meters_lv2_torch.__main__ import applicable_meters, build_meter
from meters_lv2_torch.models.ebur128 import EbuR128Meter
from meters_lv2_torch.models.kmeter import K20Meter
from meters_lv2_torch.parallel.pipeline import MeterPipeline
from meters_lv2_torch.utils import profiler, state, transport
from meters_lv2_torch.utils.interop import tree_flatten, tree_map, tree_unflatten
from meters_lv2_tpu.__main__ import build_meter as jax_build_meter
from meters_lv2_tpu.models import ebur128 as jebur128
from meters_lv2_tpu.models import kmeter as jkmeter
from meters_lv2_tpu.parallel.pipeline import MeterPipeline as JaxPipeline
from meters_lv2_tpu.utils import state as jstate
from meters_lv2_tpu.utils import transport as jtransport

torch.set_num_threads(1)

FS = 48000


def _np_leaves(tree):
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in tree_flatten(tree)[0]]


# -- checkpoints -------------------------------------------------------------------


def test_state_checkpoint_roundtrip(tmp_path):
    """tests/test_pipeline_and_parallel.py::test_state_checkpoint_roundtrip
    through the port: save after 2 s, load into a fresh state, resume both;
    the readouts and every leaf equal."""
    m = EbuR128Meter(FS, nchan=2)
    x = torch.from_numpy(make_signal("mix", 4.0))
    st = m.update(m.init((), device="cpu"), x[:, : 2 * FS])
    p = str(tmp_path / "ck.npz")
    state.save_state(st, p)
    st2 = state.load_state(m.init((), device="cpu"), p)
    for a, b in zip(_np_leaves(st), _np_leaves(st2), strict=True):
        np.testing.assert_array_equal(a, b)
    a = m.update(st, x[:, 2 * FS:])
    b = m.update(st2, x[:, 2 * FS:])
    oa, _ = m.read(a)
    ob, _ = m.read(b)
    assert float(oa["integrated"]) == float(ob["integrated"])
    for u, v in zip(_np_leaves(a), _np_leaves(b), strict=True):
        np.testing.assert_array_equal(u, v)


def _mismatch(save, load_, saved, like, path):
    save(saved, path)
    with pytest.raises(ValueError) as e:
        load_(like, path)
    return str(e.value)


@pytest.mark.parametrize("case", ["count", "shape", "dtype"])
def test_mismatch_errors_are_the_jax_ones(tmp_path, case):
    """A checkpoint of another tree is refused before anything is built,
    with the JAX package's messages."""
    if case == "count":
        pt = (K20Meter(FS).init((2,), device="cpu"), EbuR128Meter(FS).init((), device="cpu"))
        jt = (jkmeter.K20Meter(FS).init((2,)), jebur128.EbuR128Meter(FS).init(()))
    elif case == "shape":
        pt = (EbuR128Meter(FS).init((2,), device="cpu"), EbuR128Meter(FS).init((3,), device="cpu"))
        jt = (jebur128.EbuR128Meter(FS).init((2,)), jebur128.EbuR128Meter(FS).init((3,)))
    else:
        pt = ({"a": torch.zeros(3, dtype=torch.int32)}, {"a": torch.zeros(3)})
        jt = ({"a": jnp.zeros(3, jnp.int32)}, {"a": jnp.zeros(3, jnp.float32)})
    got = _mismatch(state.save_state, state.load_state, *pt, str(tmp_path / "p.npz"))
    want = _mismatch(jstate.save_state, jstate.load_state, *jt, str(tmp_path / "j.npz"))
    assert got == want
    assert {"count": "leaves, expected", "shape": "leaf 0 is", "dtype": "(3,)/int32"}[case] in got


def test_extensionless_path_and_open_file(tmp_path):
    """A path without a suffix is written at exactly that path; a file
    object works too; the npz is closed once loaded."""
    st = K20Meter(FS).init((2,), device="cpu")
    p = str(tmp_path / "ck")
    state.save_state(st, p)
    assert os.path.exists(p) and not os.path.exists(p + ".npz")
    fds = len(os.listdir("/proc/self/fd")) if os.path.isdir("/proc/self/fd") else None
    got = state.load_state(st, p)
    if fds is not None:
        assert len(os.listdir("/proc/self/fd")) == fds
    assert type(got) is type(st)
    with open(tmp_path / "f.npz", "wb") as f:
        state.save_state(st, f)
    with open(tmp_path / "f.npz", "rb") as f:
        got = state.load_state(st, f)
    for a, b in zip(_np_leaves(st), _np_leaves(got), strict=True):
        np.testing.assert_array_equal(a, b)


def test_leaves_keep_their_kind(tmp_path):
    """A tensor leaf lands on the device of the matching leaf of the like
    tree with its dtype; a numpy array stays a numpy array, a numpy scalar
    a numpy scalar of its type; None holds no leaf, as in JAX."""
    tree = {"t": torch.arange(6, dtype=torch.int32).reshape(2, 3), "b": torch.tensor(True),
            "n": np.full((2,), 0.5, np.float32), "s": np.float64(1.25), "i": np.int64(7),
            "none": None, "z": {"q": torch.tensor(3.0)}}
    p = str(tmp_path / "s.npz")
    state.save_state(tree, p)
    like = tree_map(lambda v: v * 0 if not isinstance(v, torch.Tensor) else torch.zeros_like(v),
                    tree)
    got = state.load_state(like, p)
    assert list(got) == sorted(tree)
    assert got["none"] is None
    assert isinstance(got["t"], torch.Tensor) and got["t"].dtype == torch.int32
    assert got["t"].device == like["t"].device and torch.equal(got["t"], tree["t"])
    assert got["b"].dtype == torch.bool and bool(got["b"])
    assert type(got["n"]) is np.ndarray and got["n"].dtype == np.float32
    assert type(got["s"]) is np.float64 and got["s"] == 1.25
    assert type(got["i"]) is np.int64 and got["i"] == 7
    assert float(got["z"]["q"]) == 3.0
    # the same leaves in JAX's order
    assert len(tree_flatten(tree)[0]) == len(jax.tree_util.tree_leaves(tree)) == 6


def _block(nchan=2, T=3840, seed=0):
    rng = np.random.default_rng(seed)
    return (0.2 * rng.standard_normal((nchan, T))).astype(np.float32)


def _port_run(name, x):
    m = build_meter(name, FS, 2, runtime_ports=True)
    pipe = MeterPipeline({name: m})
    st = pipe.init((), device="cpu")
    xt = torch.from_numpy(x)
    if hasattr(m, "update"):
        return pipe, pipe.update(st, xt)
    return pipe, {name: m.process(st[name], xt)[1]}


def _jax_run(name, x):
    m = jax_build_meter(name, FS, 2, runtime_ports=True)
    pipe = JaxPipeline({name: m})
    st = pipe.init(())
    if hasattr(m, "update"):
        return pipe, pipe.update(st, jnp.asarray(x))
    return pipe, {name: m.process(st[name], jnp.asarray(x))[1]}


@pytest.mark.parametrize("name", applicable_meters(2))
def test_checkpoint_moves_between_packages(tmp_path, name):
    """Every meter of stereo --meters all, after one 3840-sample block: its
    state saved by the JAX package loads into the port and the port's into
    the JAX package, every leaf bit for bit."""
    x = _block(seed=len(name))
    pipe, pst = _port_run(name, x)
    jpipe, jst = _jax_run(name, x)
    pj, pp = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jstate.save_state(jst, pj)
    state.save_state(pst, pp)
    from_jax = state.load_state(pipe.init((), device="cpu"), pj)
    from_port = jstate.load_state(jpipe.init(()), pp)
    for a, b in zip(_np_leaves(from_jax), jax.tree_util.tree_leaves(jst), strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(jax.tree_util.tree_leaves(from_port), _np_leaves(pst), strict=True):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert all(t.device.type == "cpu" for t in tree_flatten(from_jax)[0])


def test_pipeline_state_has_the_jax_leaves():
    """The 17 stereo pipeline meters' state (r128 with its runtime radar
    interval): 138 leaves in both packages, each of the same shape and
    dtype, and the tree walk rebuilds the state from its leaves."""
    names = [n for n in applicable_meters(2) if n not in ("goniometer", "phasewheel", "stereoscope")]
    pst = MeterPipeline({n: build_meter(n, FS, 2, runtime_ports=True) for n in names}).init(
        (), device="cpu")
    jst = JaxPipeline({n: jax_build_meter(n, FS, 2, runtime_ports=True) for n in names}).init(())
    pl, treedef = tree_flatten(pst)
    jl = jax.tree_util.tree_leaves(jst)
    assert len(pl) == len(jl) == 138
    for a, b in zip(pl, jl):
        assert tuple(a.shape) == b.shape and a.numpy().dtype == b.dtype
    back = tree_unflatten(treedef, pl)
    assert sorted(back) == sorted(pst)
    for a, b in zip(tree_flatten(back)[0], pl):
        assert a is b


def test_r128_continues_across_packages(tmp_path):
    """R128 saved after 2 s by one package, continued 2 s by the other:
    against the saving package run throughout, the histograms and counters
    exact and the loudness within 1e-4; both directions."""
    x = make_signal("mix", 4.0)
    tm, jm = EbuR128Meter(FS), jebur128.EbuR128Meter(FS)
    jst = jm.update(jm.init(()), jnp.asarray(x[:, : 2 * FS]))
    pst = tm.update(tm.init((), device="cpu"), torch.from_numpy(x[:, : 2 * FS]))
    jstate.save_state(jst, str(tmp_path / "j.npz"))
    state.save_state(pst, str(tmp_path / "p.npz"))
    p_from_j = tm.update(state.load_state(tm.init((), device="cpu"), str(tmp_path / "j.npz")),
                         torch.from_numpy(x[:, 2 * FS:]))
    j_from_p = jm.update(jstate.load_state(jm.init(()), str(tmp_path / "p.npz")),
                         jnp.asarray(x[:, 2 * FS:]))
    j_all = jm.update(jst, jnp.asarray(x[:, 2 * FS:]))
    p_all = tm.update(pst, torch.from_numpy(x[:, 2 * FS:]))
    for port, jx in ((p_from_j, j_all), (p_all, j_from_p)):
        for f in ("hist_m", "hist_s", "count_m", "count_s", "n_lo", "n_hi"):
            np.testing.assert_array_equal(getattr(port, f).numpy(), np.asarray(getattr(jx, f)))
        po, jo = tm.read(port)[0], jm.read(jx)[0]
        for k in ("loudness_M", "loudness_S", "max_M", "integrated", "dbtp", "lra"):
            assert abs(float(po[k]) - float(jo[k])) < 1e-4, k


def test_pack_settings_matches_jax():
    rng = np.random.default_rng(3)
    for ui, tr, rs in [(0, 0, 0), (255, 255, 65535), (256, 257, 65536), (-1, -2, -3),
                       *rng.integers(-2**20, 2**20, (64, 3)).tolist()]:
        w = state.pack_settings(ui, tr, rs)
        assert w == jstate.pack_settings(ui, tr, rs)
        assert state.unpack_settings(w) == jstate.unpack_settings(w)
    assert state.unpack_settings(state.pack_settings(7, 2, 480)) == {
        "ui_settings": 7, "transport_mode": 2, "radar_speed": 480}


# -- transport ---------------------------------------------------------------------


def test_transport_follow():
    """tests/test_pipeline_and_parallel.py::test_transport_follow through the
    port: the counts equal the JAX package's."""
    x = make_signal("mix", 2.0)
    mode = transport.FOLLOW_START_STOP | transport.FOLLOW_AUTO_RESET
    assert (transport.FOLLOW_OFF, transport.FOLLOW_START_STOP, transport.FOLLOW_AUTO_RESET) == (
        jtransport.FOLLOW_OFF, jtransport.FOLLOW_START_STOP, jtransport.FOLLOW_AUTO_RESET)
    counts = []
    for tr, m, st, xs in ((transport, EbuR128Meter(FS), None, torch.from_numpy(x)),
                          (jtransport, jebur128.EbuR128Meter(FS), None, jnp.asarray(x))):
        st = m.init((), device="cpu") if tr is transport else m.init(())
        st = tr.follow(m, st, rolling=False, was_rolling=True, mode=mode)
        st = m.update(st, xs)
        c0 = int(st.count_m)
        st = tr.follow(m, st, rolling=True, was_rolling=False, mode=mode)
        st = m.update(st, xs)
        counts.append((c0, int(st.count_m), int(st.n_lo)))
    assert counts[0][0] == 0 and counts[0][1] > 0
    assert counts[0] == counts[1]


def test_transport_autoreset_preserves_manual_measurement():
    """tests/test_stream_and_edges.py::test_transport_autoreset_preserves_
    manual_measurement through the port: the ebu_integrate guard, with the
    JAX package's counts."""
    x = make_signal("mix", 2.0)
    mode = transport.FOLLOW_START_STOP | transport.FOLLOW_AUTO_RESET
    got = []
    for tr, m, xs in ((transport, EbuR128Meter(FS), torch.from_numpy(x)),
                      (jtransport, jebur128.EbuR128Meter(FS), jnp.asarray(x))):
        st = m.init((), device="cpu") if tr is transport else m.init(())
        st = m.update(st, xs)
        n1 = int(st.n_lo)
        st = tr.follow(m, st, rolling=True, was_rolling=False, mode=mode)
        n2 = int(st.n_lo)  # not reset: already integrating
        st = m.integr_pause(st)
        st = tr.follow(m, st, rolling=True, was_rolling=False, mode=mode)
        got.append((n1, n2, int(st.n_lo), bool(st.integrating)))
    assert got[0][0] > 0 and got[0][1] == got[0][0] and got[0][2] == 0 and got[0][3]
    assert got[0] == got[1]


def test_transport_reads_the_flag_only_on_a_roll_start_with_auto_reset():
    """The integrating flag is read from the state (one host read of a
    tensor) only on a roll start with FOLLOW_AUTO_RESET; a meter without
    integr_* is driven through reset / integrate."""
    class Unreadable:
        @property
        def integrating(self):
            raise AssertionError("the flag was read")

    class Flags:
        def __init__(self, *v):
            self.integrating = torch.tensor(v)

    class M:
        def __init__(self):
            self.calls = []

        def reset(self, s):
            self.calls.append("reset")
            return s

        def integrate(self, s, on):
            self.calls.append(on)
            return s

    m, s = M(), Unreadable()
    both = transport.FOLLOW_START_STOP | transport.FOLLOW_AUTO_RESET
    transport.follow(m, s, True, False, transport.FOLLOW_START_STOP)
    transport.follow(m, s, False, True, both)
    assert transport.follow(m, s, True, False, transport.FOLLOW_OFF) is s
    assert m.calls == [True, False]
    transport.follow(m, Flags(True, False), True, False, both)  # one stream paused
    assert m.calls[2:] == ["reset", True]
    transport.follow(m, Flags(True, True), True, False, both)  # all integrating
    assert m.calls[4:] == [True]


# -- profiling ---------------------------------------------------------------------


def test_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    m = K20Meter(FS)
    with profiler.trace(d) as prof:
        m.update(m.init((2,), device="cpu"), torch.from_numpy(_block(T=512)))
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    assert os.path.getsize(os.path.join(d, files[0])) > 0
    assert len(prof.key_averages()) > 0


def test_trace_raises_when_the_profiler_cannot_start(tmp_path, monkeypatch):
    import torch.profiler as tp

    class Broken:
        def __init__(self, **kw):
            pass

        def __enter__(self):
            raise RuntimeError("profiler unavailable")

        def __exit__(self, *a):
            return False

    monkeypatch.setattr(tp, "profile", Broken)
    ran = []
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        with profiler.trace(str(tmp_path / "t")):
            ran.append(1)
    assert ran == [] and os.listdir(tmp_path / "t") == []
