"""The port's MeterPipeline: routing modes, controls, per-meter reference
levels, the per-stream freeze over every state shape, run_stream, and
run_stream_ragged against a per-file serial run and against the JAX
package's run_stream_ragged.

Bars (the JAX package's own ragged test,
tests/test_pipeline_and_parallel.py::test_ragged_batch_matches_per_file_serial):
R128's hist_m bin-exact, its loudness keys within 1e-4, K20's rms rtol
1e-5, the correlation atol 1e-6.  A per-file serial run with the same
block sequence (full chunks, then the tail's binary decomposition) is held
to float32 noise for every meter: integer leaves exact, float leaves within
1e-5 relative (a batch of B rows against one row reorders some sums).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meters_lv2_torch.__main__ import DISPLAY_METERS, applicable_meters, build_meter
from meters_lv2_torch.io.stream import to_host
from meters_lv2_torch.models.cor import CorrelationMeter
from meters_lv2_torch.models.dr14 import DR14Meter
from meters_lv2_torch.models.ebur128 import EbuR128Meter
from meters_lv2_torch.models.kmeter import K20Meter
from meters_lv2_torch.models.needle import BBCMidSideMeter, DINMeter, VUMeter
from meters_lv2_torch.models.phasewheel import Stereoscope
from meters_lv2_torch.models.spectrum import SpectrumAnalyzer
from meters_lv2_torch.models.bitmeter import BitMeter
from meters_lv2_torch.parallel.pipeline import MeterPipeline, freeze
from meters_lv2_tpu.models import cor as jcor
from meters_lv2_tpu.models import ebur128 as jebur128
from meters_lv2_tpu.models import kmeter as jkmeter
from meters_lv2_tpu.models import needle as jneedle
from meters_lv2_tpu.parallel.pipeline import MeterPipeline as JaxPipeline

torch.set_num_threads(1)

FS = 48000


def _files(C, lens, seed, noise=0.02):
    """Sines per channel (the JAX package's ragged test's at noise=0, C=2)
    plus seeded noise."""
    rng = np.random.default_rng(seed)
    out = []
    for i, L in enumerate(lens):
        t = np.arange(L) / FS
        amp = 0.2 + 0.15 * i
        rows = [amp * 0.7 ** min(c, 1) * np.sin(2 * np.pi * (300 + 200 * i - (100 * i - 200) * c
                                                             + 70 * c * (c - 1)) * t + 0.3 * c)
                + noise * rng.standard_normal(L) for c in range(C)]
        out.append(np.stack(rows).astype(np.float32))
    return out


def _pad(files, chunk):
    T = max(f.shape[1] for f in files)
    x = np.zeros((len(files), files[0].shape[0], -(-T // chunk) * chunk), np.float32)
    for i, f in enumerate(files):
        x[i, :, : f.shape[1]] = f
    return x


def _serial(pipe, f, chunk):
    """One file through the pipeline with run_stream_ragged's block
    sequence: its full chunks, then its tail's binary decomposition,
    largest level first."""
    st = pipe.init((), device="cpu")
    x = torch.from_numpy(f)
    L = f.shape[1]
    n_full = L // chunk * chunk
    for i in range(0, n_full, chunk):
        st = pipe.update(st, x[:, i : i + chunk])
    pos, tail = n_full, L - n_full
    for k in reversed(range(max(chunk // 4 - 1, 1).bit_length())):
        s = 4 << k
        if (tail // 4) >> k & 1:
            st = pipe.update(st, x[:, pos : pos + s])
            pos += s
    assert pos == L
    return st


def _leaves(o, path=""):
    if isinstance(o, dict):  # by key: jax.tree_util sorts a dict's keys
        for k, v in sorted(o.items()):
            yield from _leaves(v, f"{path}.{k}")
    else:
        yield path, np.asarray(o)


def _assert_rows_match(got, want, i, tag):
    """Row i of a batched host readout against an unbatched one."""
    for (k, a), (k2, b) in zip(_leaves(got), _leaves(want), strict=True):
        assert k == k2
        a = a[i]
        assert a.shape == b.shape, (tag, k)
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b, err_msg=f"{tag}{k} file {i}")
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7, err_msg=f"{tag}{k} file {i}")


LENS = [2 * FS + 2400, FS + 96, 3 * FS]  # %4 == 0; two end mid-chunk
CHUNK = FS // 2


def test_ragged_matches_per_file_serial_and_jax():
    files = _files(2, LENS, 11, noise=0.0)
    x = _pad(files, CHUNK)

    def mk():
        return MeterPipeline({"r128": EbuR128Meter(FS, nchan=2), "k20": K20Meter(FS),
                              "cor": CorrelationMeter(FS)}, nchan=2)

    pipe = mk()
    st = pipe.run_stream_ragged(pipe.init((3,), device="cpu"), torch.from_numpy(x),
                                np.asarray(LENS), CHUNK)
    outs = to_host(pipe.read(st)[0])
    hist = st["r128"].hist_m.numpy()

    jpipe = JaxPipeline({"r128": jebur128.EbuR128Meter(FS, nchan=2), "k20": jkmeter.K20Meter(FS),
                         "cor": jcor.CorrelationMeter(FS)}, nchan=2)
    jst = jpipe.run_stream_ragged(jpipe.init((3,)), jnp.asarray(x), np.asarray(LENS), CHUNK)
    jouts = jax.tree_util.tree_map(np.asarray, jpipe.read(jst)[0])

    def check(o, i, ref, ref_hist, tag):
        np.testing.assert_array_equal(hist[i], ref_hist, err_msg=f"{tag} file {i} hist_m")
        for key in ("loudness_M", "loudness_S", "max_M", "integrated", "dbtp"):
            g, w = float(o["r128"][key][i]), float(np.asarray(ref["r128"][key]))
            assert abs(g - w) < 1e-4, (tag, i, key, g, w)
        np.testing.assert_allclose(o["k20"]["rms"][i], ref["k20"]["rms"], rtol=1e-5,
                                   err_msg=f"{tag} file {i} k20 rms")
        np.testing.assert_allclose(o["cor"][i], ref["cor"], atol=1e-6,
                                   err_msg=f"{tag} file {i} correlation")

    for i, f in enumerate(files):
        # one whole-file update, as the JAX package's test runs it
        ref_pipe = mk()
        rst = ref_pipe.update(ref_pipe.init((), device="cpu"), torch.from_numpy(f))
        check(outs, i, to_host(ref_pipe.read(rst)[0]), rst["r128"].hist_m.numpy(), "serial")
        jref = {k: (v[i] if not isinstance(v, dict) else {kk: vv[i] for kk, vv in v.items()})
                for k, v in jouts.items()}
        check(outs, i, jref, np.asarray(jst["r128"].hist_m)[i], "jax")
        # and the per-file run with the same block sequence, to float noise
        sst = _serial(mk(), f, CHUNK)
        np.testing.assert_array_equal(hist[i], sst["r128"].hist_m.numpy())
        _assert_rows_match(outs, to_host(mk().read(sst)[0]), i, "serial blocks ")


# every non-display meter of the CLI's --meters all for stereo, and the
# surround meter (with R128) on 5-channel files: the port alone, ragged
# against per-file serial runs with the same block sequence
SMALL_LENS = [FS // 2 + 4804, FS // 2 + 12, 3 * FS // 4]
SMALL_CHUNK = FS // 4


@pytest.mark.parametrize("C,names", [
    *[(2, [n]) for n in applicable_meters(2) if n not in DISPLAY_METERS],
    (5, ["r128", "surround"]),
])
def test_every_meter_ragged_matches_per_file_serial(C, names):
    files = _files(C, SMALL_LENS, 5)
    x = _pad(files, SMALL_CHUNK)

    def mk():
        return MeterPipeline({n: build_meter(n, FS, C) for n in names}, nchan=C)

    pipe = mk()
    st = pipe.run_stream_ragged(pipe.init((3,), device="cpu"), torch.from_numpy(x),
                                np.asarray(SMALL_LENS), SMALL_CHUNK)
    outs = to_host(pipe.read(st)[0])
    for i, f in enumerate(files):
        sst = _serial(mk(), f, SMALL_CHUNK)
        _assert_rows_match(outs, to_host(mk().read(sst)[0]), i, f"{names} ")


@pytest.mark.parametrize("C", (1, 2, 3))
def test_modes_route_like_the_jax_pipeline(C):
    """per_channel (K20: a [B, C] state), mono (the bit meter: channel 0)
    and stereo_mix (the spectrum: mono, stereo, or the mean of C > 2)."""
    x = _files(C, [4800, 4800], 2)
    x = np.stack(x)  # [2, C, 4800]
    meters = {"k20": K20Meter(FS), "bit": BitMeter(FS), "spec": SpectrumAnalyzer(FS)}
    pipe = MeterPipeline(meters, nchan=C)
    st = pipe.init((2,), device="cpu")
    assert st["k20"].z.shape[:2] == (2, C) and st["bit"].hit.shape[0] == 2
    xt = torch.from_numpy(x)
    st = pipe.update(st, xt)
    # the same calls made by hand
    k = meters["k20"].update(meters["k20"].init((2, C), device="cpu"), xt)
    b = meters["bit"].update(meters["bit"].init((2,), device="cpu"), xt[:, 0])
    sp0 = meters["spec"].init((2,), device="cpu")
    s = (meters["spec"].update(sp0, xt, stereo=True) if C == 2
         else meters["spec"].update(sp0, xt[:, 0] if C == 1 else xt.mean(dim=-2)))
    for got, want in ((st["k20"], k), (st["bit"], b), (st["spec"], s)):
        for f in dataclasses.fields(got):
            assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name
    # the JAX pipeline's per_channel routing gives the same K20 levels (the
    # spectrum's routing is held to the direct calls above; the port's
    # spectrum against JAX's is tests/test_torch_spectrum.py's)
    jpipe = JaxPipeline({"k20": jkmeter.K20Meter(FS)}, nchan=C)
    jout = jpipe.read(jpipe.update(jpipe.init((2,)), jnp.asarray(x)))[0]
    out = to_host(pipe.read(st)[0])
    np.testing.assert_allclose(out["k20"]["rms"], np.asarray(jout["k20"]["rms"]), rtol=1e-5)


def test_controls_and_per_meter_ref_level():
    """BBC M-6's s20 control reaches its update; a ref_level_db dict sets
    one meter's reference level and leaves the others at their default;
    a scalar sets every reader that takes it."""
    x = np.stack(_files(2, [9600, 9600], 3))
    names = {"bbcms": (BBCMidSideMeter, jneedle.BBCMidSideMeter),
             "vu": (VUMeter, jneedle.VUMeter), "din": (DINMeter, jneedle.DINMeter),
             "k20": (K20Meter, jkmeter.K20Meter)}
    pipe = MeterPipeline({n: c[0](FS) for n, c in names.items()})
    jpipe = JaxPipeline({n: c[1](FS) for n, c in names.items()})
    ctl = {"bbcms": {"s20": True}}
    st = pipe.update(pipe.init((2,), device="cpu"), torch.from_numpy(x), controls=ctl)
    jst = jpipe.update(jpipe.init((2,)), jnp.asarray(x), controls={"bbcms": {"s20": jnp.asarray(True)}})
    m6 = pipe.meters["bbcms"]
    direct = m6.update(m6.init((2,), device="cpu"), torch.from_numpy(x), s20=True)
    plain = m6.update(m6.init((2,), device="cpu"), torch.from_numpy(x))
    assert torch.equal(st["bbcms"].side.z1, direct.side.z1)
    assert not torch.equal(direct.side.z1, plain.side.z1)
    for ref in ({"vu": -18.0, "bbcms": -30.0}, -10.0, None):
        out = to_host(pipe.read(st, ref_level_db=ref)[0])
        jout = jax.tree_util.tree_map(np.asarray, jpipe.read(jst, ref_level_db=ref)[0])
        for n in names:
            for (k, a), (_, b) in zip(_leaves(out[n]), _leaves(jout[n]), strict=True):
                np.testing.assert_allclose(a, b, rtol=2e-5, err_msg=f"{ref} {n}{k}")
    vu = pipe.meters["vu"]
    default = to_host(pipe.read(st)[0])
    with_dict = to_host(pipe.read(st, ref_level_db={"vu": -18.0})[0])
    np.testing.assert_array_equal(with_dict["din"], default["din"])
    np.testing.assert_array_equal(with_dict["vu"], vu.read(st["vu"], ref_level_db=-18.0)[0].numpy())
    assert not np.array_equal(with_dict["vu"], default["vu"])


def test_freeze_nested_dict_and_config_leaves():
    alive = torch.tensor([True, False, True])
    x = torch.from_numpy(np.stack(_files(2, [9600] * 3, 4)))
    cases = []
    m = DR14Meter(FS, nchan=2)  # nested km / tp states
    cases.append((m.init((3,), device="cpu"), lambda s: m.update(s, x)))
    sc = Stereoscope(FS)  # dict state with a nested STFT state
    cases.append((sc.init((3,), device="cpu"), lambda s: sc.process(s, x)[1]))
    sp = SpectrumAnalyzer(FS)  # a scalar config leaf (omega)
    cases.append((sp.init((3,), device="cpu"),
                  lambda s: sp.set_speed(sp.update(s, x, stereo=True), 3.0)))
    k = K20Meter(FS)  # a per_channel state [B, C]
    cases.append((k.init((3, 2), device="cpu"), lambda s: k.update(s, x)))
    m6 = BBCMidSideMeter(FS)  # nested mid / side states
    cases.append((m6.init((3,), device="cpu"), lambda s: m6.update(s, x)))
    for old, step in cases:
        new = step(old)
        fr = freeze(old, new, alive)
        assert type(fr) is type(old)
        for (p, o), (_, n), (_, f) in zip(_leaves_state(old), _leaves_state(new),
                                          _leaves_state(fr), strict=True):
            if o.ndim == 0:  # stream-shared: from new
                assert torch.equal(f, n), p
                continue
            for b in range(3):
                assert torch.equal(f[b], n[b] if alive[b] else o[b]), (p, b)
    # the spectrum's omega changed, so the frozen state carries the new one
    fr = freeze(cases[2][0], cases[2][1](cases[2][0]), alive)
    assert float(fr.omega) != sp.omega


def _leaves_state(s, path=""):
    if dataclasses.is_dataclass(s):
        for f in dataclasses.fields(s):
            yield from _leaves_state(getattr(s, f.name), f"{path}.{f.name}")
    elif isinstance(s, dict):
        for k, v in s.items():
            yield from _leaves_state(v, f"{path}.{k}")
    else:
        yield path, s


def test_run_stream_equals_a_loop_of_updates():
    x = torch.from_numpy(np.stack(_files(2, [4 * 2400] * 2, 6)))

    def mk():
        return MeterPipeline({"r128": EbuR128Meter(FS, nchan=2), "din": DINMeter(FS),
                              "spec": SpectrumAnalyzer(FS)})

    a = mk().run_stream(mk().init((2,), device="cpu"), x, 2400)
    p = mk()
    b = p.init((2,), device="cpu")
    for i in range(4):
        b = p.update(b, x[..., i * 2400 : (i + 1) * 2400])
    for (k, u), (_, v) in zip(_leaves_state(a), _leaves_state(b), strict=True):
        assert torch.equal(u, v), k
    with pytest.raises(ValueError):
        p.run_stream(b, x, 2500)


def test_ragged_argument_checks():
    p = MeterPipeline({"k20": K20Meter(FS)})
    st = p.init((2,), device="cpu")
    x = torch.zeros(2, 2, 4800)
    for lengths, chunk in (([4800, 4802], 2400), ([4800, 4800], 2401), ([4800, 9600], 2400),
                           ([4800], 2400)):
        with pytest.raises(ValueError):
            p.run_stream_ragged(st, x, lengths, chunk)
    # zero-length and whole-length streams
    out = p.run_stream_ragged(st, x + 0.5, [0, 4800], 2400)
    assert torch.equal(out["k20"].z[0], st["k20"].z[0])
    assert not torch.equal(out["k20"].z[1], st["k20"].z[1])
