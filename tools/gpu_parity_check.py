#!/usr/bin/env python3
"""Parity sweep of the PyTorch port on the card, every family: the port's
counterpart of tools/tpu_parity_check.py.

    python3 tools/gpu_parity_check.py [family ...] [--legs golden,native]
                                      [--quick] [--device cuda|cpu]
    families: ebur128 truepeak ballistics spectrum dr14 sigdist bitmeter
              stft stcorr surround goniometer phasewheel stereoscope
              resample    (default: all)

Two legs, each at the bars of the CPU tests:

  golden  streams every committed C-reference fixture of a family whole
          through the port's meters on --device.  It reuses the port's own
          golden functions (tests/test_torch_golden_*.py: run_family,
          run_dr14, run_spectrum, ...; outside pytest), as
          tools/tpu_parity_check.py reuses tests/test_golden_parity.py;
          only R128 (whose port tests import JAX) and the resampler are
          checked here.  np.testing.assert_allclose is instrumented so
          that every tolerance it checks also records its worst share.
          Exact families (histograms, counts, bit-meter counters) assert
          equality and count as 0.
  native  runs seeded signals through the port on --device and through
          one runtime.native.NativeEngine a stream (native/engine.cc, the
          repo's independent C++ engine) in a process pool on the host,
          started before the card's work and collected after it.  Signals
          come from np.random.default_rng([20, kind, stream]): tones plus
          noise between 0 and -40 dBFS, a silent second, stream 0 at full
          scale.  R128 runs B=256 stereo x 10 s at 48 kHz in 1 s blocks
          (flat [B, C*T], the main path's width) and B=8 at 44.1 and
          96 kHz; every other kind B=32 x 10 s in 1000-sample blocks (a
          non-128 tail on every update), the phase wheel and the
          stereoscope one hop (1920 samples) a call, surround at C=5 and
          C=8.  Both sides are read at the same cadence (reads reset the
          needles', true peak's and K-meter's maxima on both).  The bars
          are tests/test_native.py's: needles, K-meter, true peak and
          surround level rtol 2e-4 to 3e-4; R128 0.01 LU (dBTP 1e-4);
          spectrum 0.01 dB; DR-14 0.03 dB with block_count exact; TP+RMS
          2e-3 dB; sigdist and the bit meter exact, avg and var at 1e-3;
          correlation 2e-3; the goniometer and the analyzers as there
          (phase differences compared modulo 2 pi).

Output: one line a family (fixtures and streams run, the worst share of a
bar in each leg), the kernels' launches in each leg from the wrappers'
counters, the card's name and power limit, and as the last line
{"families": {...}, "ok": bool}.  Exit 1 if any bar is missed.  With
--device cuda (the default) and no card it exits 2 and prints no result:
the CPU is used only when asked for.  --quick cuts B and the length (for
the CPU test) and says so on its first line.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import glob
import json
import math
import multiprocessing
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(ROOT, "tests", "fixtures")
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from chip_smoke import gpu_line, launch_counts, reset_counts  # noqa: E402

FAMILIES = ("ebur128", "truepeak", "ballistics", "spectrum", "dr14", "sigdist", "bitmeter",
            "stft", "stcorr", "surround", "goniometer", "phasewheel", "stereoscope", "resample")
TOL_DB = 0.01


def _share(got, want, rtol=0.0, atol=0.0) -> float:
    """max |got - want| / (atol + rtol |want|): the worst share of an
    allclose bar (1 is at the bar).  Equal values, NaN included, are 0; a
    NaN or infinity against anything else is inf."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    g, w = np.broadcast_arrays(g, w)
    same = (g == w) | (np.isnan(g) & np.isnan(w))
    if same.all():
        return 0.0
    g, w = g[~same], w[~same]
    if not (np.isfinite(g).all() and np.isfinite(w).all()):
        return math.inf
    bar = atol + rtol * np.abs(w)
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.abs(g - w) / bar
    return float(np.where(bar > 0, s, math.inf).max())


# -- the golden leg ---------------------------------------------------------


@contextlib.contextmanager
def allclose_shares(sink: list):
    """np.testing.assert_allclose records the share of its bar in ``sink``
    before it asserts (the golden functions' own tolerances)."""
    orig = np.testing.assert_allclose

    def tracking(actual, desired, rtol=1e-7, atol=0, equal_nan=True, err_msg="",
                 verbose=True, **kw):
        sink.append(_share(actual, desired, rtol, atol))
        return orig(actual, desired, rtol=rtol, atol=atol, equal_nan=equal_nan,
                    err_msg=err_msg, verbose=verbose, **kw)

    np.testing.assert_allclose = tracking
    try:
        yield
    finally:
        np.testing.assert_allclose = orig


R128_PREFIXES = ("ebur128", "ebur128mono", "ebur128_aligned", "ebur128_5ch", "ebur128_44k",
                 "ebur128_96k", "ebur128_blk4096")


def golden_r128(prefix, device):
    """Every fixture of an R128 prefix whole, with the asserts of
    tests/test_golden_parity.py as tests/test_torch_ebur128.py applies them
    on the CPU: 0.01 LU on every read key, the 500 ms cadence, histograms
    and counts bin-exact.  Returns (worst share, fixtures)."""
    import torch

    from signals import make_signal, make_surround
    from test_torch_golden_stats import fixtures
    from meters_lv2_torch.models.ebur128 import EbuR128Meter

    worst, fxs = 0.0, fixtures(prefix)
    rates = prefix in ("ebur128_44k", "ebur128_96k", "ebur128_blk4096")
    for fx in fxs:
        m = EbuR128Meter(fx["fs"], nchan=fx["nchan"], track_cadence=not rates)
        if prefix == "ebur128_5ch":
            x = make_surround(fx["signal"], fx["seconds"], fs=fx["fs"])
        else:
            x = make_signal(fx["signal"], fx["seconds"], fs=fx["fs"])[: fx["nchan"]]
        xt = torch.as_tensor(x, device=device)
        st = m.init((), device=device)
        mid = iter([r for r in fx["reads"] if "final" not in r])
        final = [r for r in fx["reads"] if r.get("final")][0]
        keys = [("M", "loudness_M"), ("S", "loudness_S")]
        if prefix not in ("ebur128_5ch",) and not rates:
            keys += [("maxM", "max_M"), ("maxS", "max_S")]
        if prefix in ("ebur128_aligned", "ebur128_5ch"):
            keys += [("I", "integrated")]
        if prefix == "ebur128_aligned":
            keys += [("LRAmin", "range_min"), ("LRAmax", "range_max")]
        blk = fx["block"]
        tag0 = f"{prefix}/{fx['signal']}"

        def check(rec, out, pairs, what=""):
            nonlocal worst
            for key, mine in pairs:
                want, got = rec[key], float(out[mine])
                if want <= -199.0:
                    if rates:
                        continue
                    assert got <= -199.0, f"{tag0} blk {rec['block']} {key}{what}: {got} vs {want}"
                    continue
                d = abs(got - want)
                assert d < TOL_DB, f"{tag0} blk {rec['block']} {key}{what}: {got} vs {want}"
                worst = max(worst, d / TOL_DB)

        for b in range(x.shape[1] // blk):
            st = m.update(st, xt[:, b * blk:(b + 1) * blk])
            if prefix == "ebur128_blk4096" or (b + 1) % fx["read_every"]:
                continue
            out, _ = m.read(st)
            rec = next(mid)
            check(rec, out, keys)
            if prefix == "ebur128":  # the reference's cached I/LRA
                out, _ = m.read(st, cadence_500ms=True)
                check(rec, out, [("I", "integrated"), ("LRAmin", "range_min"),
                                 ("LRAmax", "range_max")], " (500 ms)")
        assert np.array_equal(st.hist_m.cpu().numpy(), final["histM"]), f"{tag0} histM"
        if prefix != "ebur128_44k":
            assert np.array_equal(st.hist_s.cpu().numpy(), final["histS"]), f"{tag0} histS"
        if not rates:
            assert int(st.count_m) == final["countM"] and int(st.count_s) == final["countS"], \
                f"{tag0} counts"
    return worst, len(fxs)


def golden_resample(device):
    """The rational resampler against the zita captures (rresample_*
    fixtures and resample_zita.npz) at tests/test_torch_ingest.py's bar,
    1e-6 absolute.  Returns (worst share, fixtures)."""
    import torch

    from signals import make_signal
    from meters_lv2_torch.ops.resample import RationalResampler

    worst, n = 0.0, 0
    data = np.load(os.path.join(FIXDIR, "resample_zita.npz"))
    for factor in (2, 4, 8):
        rs = RationalResampler(48000, 48000 * factor, 12, frel=1.0)
        y, _ = rs.apply(torch.as_tensor(data["x"], device=device), rs.init((2,), device=device))
        s = _share(y.cpu().numpy(), data[f"up{factor}"], atol=1e-6)
        assert s <= 1, f"resample_zita up{factor}: {s} of the bar"
        worst, n = max(worst, s), n + 1
    for p in sorted(glob.glob(os.path.join(FIXDIR, "rresample_*.json"))):
        with open(p) as f:
            fx = json.load(f)
        rec = fx["reads"][0]
        x = make_signal(fx["signal"], fx["seconds"], fs=fx["fs"])
        g = np.array(rec["data"], np.float64).reshape(-1, 2).T
        rs = RationalResampler(fx["fs"], rec["fs_out"], rec["hlen"])
        xp = np.concatenate([x, np.zeros((2, (-x.shape[1]) % rs.s), np.float32)], -1)
        y, _ = rs.apply(torch.as_tensor(xp, device=device), rs.init((2,), device=device))
        k = min(g.shape[1], y.shape[1])
        s = _share(y.cpu().numpy()[:, :k], g[:, :k], atol=1e-6)
        assert s <= 1, f"{fx['meter']}/{fx['signal']}: {s} of the bar"
        worst, n = max(worst, s), n + 1
    return worst, n


def golden_family(fam, device):
    """(worst share, fixtures) of one family's golden leg; raises
    AssertionError on a missed bar."""
    from signals import make_signal
    import test_torch_golden_analyzers as gana
    import test_torch_golden_ballistics as gbal
    import test_torch_golden_spectrum as gspec
    import test_torch_golden_stats as gstats
    import test_torch_golden_surround as gsur

    def ballistics(prefixes):
        worst, n = 0.0, 0
        for p in prefixes:
            w, _ = gbal.run_family(p, make_signal, device=device)
            bar = gbal.COR_TOL if gbal.FAMILIES[p][1] == "cor" else gbal.TOL_DB
            worst, n = max(worst, w / bar), n + len(gbal.fixtures(p))
        return worst, n

    if fam == "ebur128":
        res = [golden_r128(p, device) for p in R128_PREFIXES]
        return max(w for w, _ in res), sum(n for _, n in res)
    if fam == "truepeak":
        return ballistics([p for p in gbal.FAMILIES if p.startswith("truepeak")])
    if fam == "ballistics":
        return ballistics([p for p, (_, kind) in gbal.FAMILIES.items()
                           if kind in ("needle", "ms", "km")])
    if fam == "stcorr":
        return ballistics(["stcorr"])
    if fam == "spectrum":
        worst = 0.0
        for name in gspec.FIXTURES:
            strict, _, _ = gspec.run_spectrum(name, make_signal, device=device)
            worst = max(worst, strict / gspec.TOL_DB)
        return worst, len(gspec.FIXTURES)
    if fam == "dr14":
        worst, n = 0.0, 0
        for p in gstats.DR_PREFIXES:
            w, _ = gstats.run_dr14(p, make_signal, device=device)
            worst, n = max(worst, w / gstats.TOL_DB), n + len(gstats.fixtures(p))
        w, _ = gstats.run_tpnrms(make_signal, device=device)
        return max(worst, w / gstats.TOL_DB), n + len(gstats.fixtures("tpnrms"))
    if fam == "sigdist":
        var = gstats.run_sigdist("sigdist", make_signal, device=device)
        quirk = gstats.run_sigdist("sigdist_oor", make_signal, device=device,
                                   reference_oor_count=True)
        # hist_var: 1e-3 relative; the out-of-range quirk fixtures 1e-5
        worst = max(max(var) / 1e-3, max(quirk) / 1e-5)
        assert worst <= 1, f"sigdist hist_var {var}, oor quirk {quirk}"
        return worst, len(var) + len(quirk)
    if fam == "bitmeter":
        return 0.0, gstats.run_bitmeter(make_signal, device=device)
    if fam == "surround":
        worst = 0.0
        for p in gsur.PREFIXES:
            w_db, w_cor, _ = gsur.run_surround(p, device=device)
            worst = max(worst, w_db / gsur.TOL_DB, w_cor / gsur.COR_TOL)
        return worst, len(gsur.PREFIXES)
    names = [n for n in gana.FIXTURES if n.startswith(fam)]
    worst = 0.0
    for name in names:
        fx = gana._load(name)
        if fam == "phasewheel":
            _, ph, mism, tot = gana.run_phasewheel(fx, device)
            worst = max(worst, ph / 2e-3, mism / (0.01 * tot))
        elif fam == "stereoscope":
            lr, _, _ = gana.run_stereoscope(fx, device)
            worst = max(worst, lr / 1e-4)
        elif fam == "goniometer":
            w = gana.run_goniometer(fx, device)
            worst = max(worst, *(v / r for v, r in zip(w, (1e-4, 1e-5, 1e-5, 1e-4))))
        else:
            gana.run_stft(fx, device)
    return worst, len(names)


def golden_leg(fam, device):
    sink = []
    with allclose_shares(sink):
        if fam == "resample":
            worst, n = golden_resample(device)
        else:
            worst, n = golden_family(fam, device)
    return max([worst, *sink]), n


# -- the native leg ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Case:
    """One kind of the native engine against the port's meter."""

    name: str
    kind: str  # runtime.native.METER_KINDS key
    fs: int
    C: int  # the stream's channels
    B: int
    seconds: int
    block: int
    every: int  # blocks between reads
    arg: int = 0  # the engine's nchan argument when it is not C (gonio: oversample)

    @property
    def reads(self) -> int:
        return (self.fs * self.seconds // self.block) // self.every


def native_cases(quick: bool) -> dict:
    """The family -> [Case] table of the native leg."""
    B, S = (2, 2) if quick else (32, 10)
    R = (4, 6) if quick else (256, 10)  # R128 needs >= 5 s for a gated I
    r8 = 2 if quick else 8
    hop = 1920

    def blocks(name, kind, C=2, **kw):
        return Case(name, kind, 48000, C, B, S, 1000, 48, **kw)

    return {
        "ebur128": [Case("r128", "r128", 48000, 2, R[0], R[1], 48000, 1),
                     Case("r128_44k", "r128", 44100, 2, r8, R[1], 44100, 1),
                     Case("r128_96k", "r128", 96000, 2, r8, R[1], 96000, 1)],
        "truepeak": [blocks("truepeak", "truepeak")],
        "ballistics": [blocks(k, k) for k in ("vu", "iec1", "iec2", "kmeter", "msppm")],
        "spectrum": [blocks("spectrum", "spectrum")],
        "dr14": [blocks("dr14", "dr14"), blocks("tpnrms", "tpnrms")],
        "sigdist": [blocks("sigdist", "sigdist", C=1)],
        "bitmeter": [blocks("bitmeter", "bitmeter", C=1)],
        "stft": [],
        "stcorr": [blocks("stcorr", "stcorr")],
        "surround": [blocks("surround5", "surround", C=5), blocks("surround8", "surround", C=8)],
        "goniometer": [blocks("gonio", "gonio", arg=4)],
        "phasewheel": [Case("phasewheel", "phasewheel", 48000, 2, B, S, hop, 25)],
        "stereoscope": [Case("stereoscope", "stereoscope", 48000, 2, B, S, hop, 25)],
        "resample": [],
    }


def signal(case: Case, stream: int) -> np.ndarray:
    """[C, T] float32 of one stream: two to four tones and noise at a level
    between 0 and -40 dBFS, silence over one second, stream 0 at full
    scale.  np.random.default_rng([20, kind, stream]).  The tones have
    whole-hertz frequencies, so one second of them repeats exactly."""
    from meters_lv2_torch.runtime.native import METER_KINDS

    rng = np.random.default_rng([20, METER_KINDS[case.kind], stream])
    fs, T = case.fs, case.fs * case.seconds
    t = np.arange(fs) / fs
    x = np.empty((case.C, T), np.float32)
    for c in range(case.C):
        tones = np.zeros(fs)
        for _ in range(int(rng.integers(2, 5))):
            f = round(float(np.exp(rng.uniform(np.log(40.0), np.log(0.4 * fs)))))
            tones += rng.uniform(0.1, 1.0) * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
        x[c] = np.tile(tones.astype(np.float32), case.seconds)
        x[c] += np.float32(rng.uniform(0.02, 0.5)) * rng.standard_normal(T, dtype=np.float32)
    if case.C >= 2:  # correlated channels: a shared part
        x[1:] += np.float32(rng.uniform(0.0, 1.0)) * x[:1]
    start = int(rng.integers(0, T - fs)) if T > fs else 0
    x[:, start:start + fs] = 0.0
    level = 1.0 if stream == 0 else 10 ** (rng.uniform(-40.0, 0.0) / 20)
    x *= np.float32(level / np.abs(x).max())
    return x


def engine_streams(case: Case, streams) -> list:
    """The engine's readouts [reads, L] for each stream (a pool task).  The
    goniometer's extrema are read and reset at every block; the port's
    side takes its trace's extrema over the same span."""
    from meters_lv2_torch.runtime.native import NativeEngine

    out = []
    for s in streams:
        x = signal(case, s)
        eng = NativeEngine(case.kind, case.fs, case.arg or case.C)
        reads = []
        lo = hi = None
        for b in range(x.shape[1] // case.block):
            eng.process(x[:, b * case.block:(b + 1) * case.block])
            if case.kind == "gonio":
                v = eng.read()
                lo = v[[1, 3]] if lo is None else np.minimum(lo, v[[1, 3]])
                hi = v[[2, 4]] if hi is None else np.maximum(hi, v[[2, 4]])
                if (b + 1) % case.every == 0:
                    reads.append(np.array([v[0], lo[0], hi[0], lo[1], hi[1], v[5], v[6]]))
                    lo = hi = None
            elif (b + 1) % case.every == 0:
                reads.append(eng.read())
        eng.close()
        out.append(np.stack(reads))
    return out


class PortSide:
    """The port's meter for a case: its update and its readout in the
    engine's layout, [B, L] float64."""

    def __init__(self, case: Case, device):
        import torch

        import meters_lv2_torch as mt
        from meters_lv2_torch.models.sigdist import SigDistMeter

        self.case, self.torch, self.device = case, torch, device
        k, fs, C = case.kind, case.fs, case.C
        make = {
            "r128": lambda: mt.create("EBUr128", fs, nchan=C),
            "vu": lambda: mt.create("VUstereo", fs), "iec1": lambda: mt.create("DINstereo", fs),
            "iec2": lambda: mt.create("BBCstereo", fs), "kmeter": lambda: mt.create("K20stereo", fs),
            "truepeak": lambda: mt.create("dBTPstereo", fs),
            "msppm": lambda: mt.create("BBCM6", fs), "stcorr": lambda: mt.create("COR", fs),
            "spectrum": lambda: mt.create("spectr30stereo", fs),
            "sigdist": lambda: SigDistMeter(fs, reference_oor_count=True),
            "bitmeter": lambda: mt.create("bitmeter", fs),
            "dr14": lambda: mt.create("dr14stereo", fs, nchan=C),
            "tpnrms": lambda: mt.create("TPnRMSstereo", fs, nchan=C),
            "surround": lambda: mt.create(f"surround{C}", fs),
            "gonio": lambda: mt.create("goniometer", fs, oversample=case.arg),
            "phasewheel": lambda: mt.create("phasewheel", fs),
            "stereoscope": lambda: mt.create("stereoscope", fs),
        }[k]
        self.m = make()
        per_channel = k in ("vu", "iec1", "iec2", "kmeter", "truepeak")
        self.st = self.m.init((case.B, C) if per_channel else (case.B,), device=device)
        self.out = None
        self.lo = self.hi = None

    def update(self, xb):
        """xb: [B, C, n] on the device."""
        k, m = self.case.kind, self.m
        if k == "r128":  # flat [B, C*n], channel-major, as bench.py feeds it
            self.st = m.update(self.st, xb.reshape(xb.shape[0], -1), flat=True)
        elif k == "spectrum":
            self.st = m.update(self.st, xb, stereo=True)
        elif k in ("sigdist", "bitmeter"):
            self.st = m.update(self.st, xb[:, 0])
        elif k in ("gonio", "phasewheel", "stereoscope"):
            self.out, self.st = m.process(self.st, xb)
            if k == "gonio":
                ext = self.torch.stack([self.out["x"].amin(-1), self.out["y"].amin(-1)], -1)
                ext2 = self.torch.stack([self.out["x"].amax(-1), self.out["y"].amax(-1)], -1)
                self.lo = ext if self.lo is None else self.torch.minimum(self.lo, ext)
                self.hi = ext2 if self.hi is None else self.torch.maximum(self.hi, ext2)
        else:
            self.st = m.update(self.st, xb)

    def read(self) -> dict:
        """The readout, as numpy float64 arrays by name."""
        k, m, torch = self.case.kind, self.m, self.torch

        def np64(d):
            return {key: v.detach().cpu().double().numpy() for key, v in d.items()}

        if k in ("vu", "iec1", "iec2"):
            v, self.st = m.read(self.st, ref_level_db=-18.0)  # gain 1, as the engine's
            return {"v": v.detach().cpu().double().numpy()}
        if k == "msppm":
            out, self.st = m.read(self.st, ref_level_db=-18.0)
            return np64(out)
        if k == "stcorr":
            v, self.st = m.read(self.st)
            return {"v": v.detach().cpu().double().numpy()[:, None]}
        if k == "gonio":
            out = {"gain": self.out["gain"], "lo": self.lo, "hi": self.hi,
                   "last_x": self.out["x"][:, -1], "last_y": self.out["y"][:, -1]}
            self.lo = self.hi = None
            return np64(out)
        if k == "phasewheel":
            return np64({"peak": self.out["peak"], "phase": self.out["phase"][:, -1],
                         "level": self.out["level"][:, -1]})
        if k == "stereoscope":
            return np64({"lr": self.out["lr"], "level": self.out["level"]})
        out, self.st = m.read(self.st)
        out = np64(out)
        if k == "sigdist":
            out["n"] = self.st.n.detach().cpu().double().numpy()
        return out


def compare(case: Case, got: dict, nv: np.ndarray) -> np.ndarray:
    """The worst share of a bar per stream: got is PortSide.read()'s dict
    for every stream, nv the engines' readouts [B, L] in the kind's layout
    (native/meters_native.h).  The bars are tests/test_native.py's."""
    k, C = case.kind, case.C
    B = nv.shape[0]
    res = np.zeros(B)

    def per(fn):
        for b in range(B):
            res[b] = max(res[b], fn(b))

    def exact(a, b_):
        return 0.0 if np.array_equal(np.asarray(a, np.float64), np.asarray(b_, np.float64),
                                     equal_nan=True) else math.inf

    def floor_lu(b, g, n, bar):
        # readouts at the -200 floor (no gated points) must agree exactly
        gf, nf = g <= -199.0, n <= -199.0
        if (gf != nf).any():
            return math.inf
        return _share(g[~gf], n[~gf], atol=bar)

    if k in ("vu", "iec1", "iec2"):
        per(lambda b: _share(got["v"][b], nv[b], rtol=2e-4))
    elif k == "kmeter":
        per(lambda b: _share(np.stack([got["rms"][b], got["peak"][b]], -1).ravel(), nv[b],
                             rtol=2e-4))
    elif k == "truepeak":
        per(lambda b: _share(np.stack([got["level"][b], got["peak"][b]], -1).ravel(), nv[b],
                             rtol=3e-4))
    elif k == "r128":
        keys = ("loudness_M", "loudness_S", "max_M", "max_S", "integrated", "range_min",
                "range_max")
        per(lambda b: max(floor_lu(b, np.array([got[key][b] for key in keys]), nv[b, :7], 0.01),
                          _share(got["dbtp"][b], nv[b, 7], atol=1e-4)))
    elif k == "spectrum":
        per(lambda b: _share(np.concatenate([got["bands"][b], got["peaks"][b]]), nv[b],
                             atol=0.01))
    elif k == "msppm":
        per(lambda b: _share([got["mid"][b], got["side"][b]], nv[b], rtol=3e-4))
    elif k == "stcorr":
        per(lambda b: _share(got["v"][b], nv[b], atol=2e-3))
    elif k == "sigdist":
        # the peak bin's tie-breaking differs (first max against first to
        # reach it): the peak count and that bin's count are exact
        per(lambda b: max(
            exact(got["hist_max"][b], nv[b, 1]),
            exact(got["hist"][b][int(nv[b, 0])], nv[b, 1]),
            _share(got["hist_avg"][b], nv[b, 2], rtol=1e-3),
            _share(got["hist_var"][b], nv[b, 3], rtol=1e-3),
            exact(got["n"][b], nv[b, 4])))
    elif k == "bitmeter":
        per(lambda b: max(exact([got[key][b] for key in ("zero", "pos", "nan", "inf", "den")],
                                nv[b, :5]),
                          _share([got["min"][b], got["max"][b]], nv[b, 5:7], rtol=1e-6)))
    elif k == "dr14":
        per(lambda b: max(
            _share(np.stack([got[key][b] for key in ("v_rms", "v_peak", "m_peak", "m_rms", "dr")],
                            -1).ravel(), nv[b, :5 * C], atol=0.03),
            _share(got["dr_total"][b], nv[b, 5 * C], atol=0.03),
            exact(got["block_count"][b], nv[b, 5 * C + 1])))
    elif k == "tpnrms":
        per(lambda b: _share(np.stack([got[key][b] for key in ("v_rms", "v_peak", "m_peak",
                                                                "m_rms")], -1).ravel(),
                             nv[b], atol=2e-3))
    elif k == "surround":
        per(lambda b: max(
            _share(np.stack([got["level"][b], got["peak"][b]], -1).ravel(), nv[b, :2 * C],
                   rtol=3e-4),
            _share(got["correlation"][b], nv[b, 2 * C:], atol=2e-3)))
    elif k == "gonio":
        per(lambda b: max(
            _share(got["gain"][b], nv[b, 0], rtol=1e-4),
            _share([got["lo"][b, 0], got["hi"][b, 0], got["lo"][b, 1], got["hi"][b, 1]],
                   nv[b, 1:5], rtol=2e-4, atol=1e-6),
            _share([got["last_x"][b], got["last_y"][b]], nv[b, 5:7], rtol=1e-3, atol=1e-6)))
    elif k == "phasewheel":
        D = (nv.shape[1] - 1) // 2

        def pw(b):
            lv, n_lv = got["level"][b], nv[b, 1 + D:]
            ok, n_ok = lv > -99, n_lv > -99
            both = ok & n_ok
            agree = float(np.mean(ok == n_ok))
            dphi = got["phase"][b][both] - nv[b, 1:1 + D][both]
            dphi = (dphi + np.pi) % (2 * np.pi) - np.pi  # modulo 2 pi
            return max(_share(got["peak"][b], nv[b, 0], rtol=1e-3),
                       (1.0 - agree) / 0.05,
                       _share(lv[both], n_lv[both], rtol=1e-4),
                       _share(dphi, 0.0, atol=1e-3))

        per(pw)
    elif k == "stereoscope":
        D = nv.shape[1] // 2

        def sc(b):
            big = got["level"][b] > 1e-12  # levels resolvable in float32
            return max(_share(got["level"][b][big], nv[b, D:][big], rtol=2e-3),
                       _share(got["lr"][b][big], nv[b, :D][big], atol=2e-3))

        per(sc)
    else:
        raise ValueError(k)
    return res


def port_case(case: Case, device) -> tuple:
    """The port's side of a case on ``device``: (list of read dicts,
    launches, seconds with the signals' making)."""
    import torch

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(4) as ex:  # numpy releases the GIL
        x = np.stack(list(ex.map(lambda s: signal(case, s), range(case.B))))
    xd = torch.as_tensor(x, device=device)
    del x
    side = PortSide(case, device)
    reset_counts()
    reads = []
    for b in range(xd.shape[-1] // case.block):
        side.update(xd[..., b * case.block:(b + 1) * case.block])
        if (b + 1) % case.every == 0:
            reads.append(side.read())
    if xd.is_cuda:
        torch.cuda.synchronize()
    return reads, launch_counts(), time.perf_counter() - t0


def native_leg(cases, device, workers):
    """Every case's engines in a pool, the port's runs on ``device``
    meanwhile; {case name: (worst share, streams, launches, seconds)}."""
    ctx = multiprocessing.get_context("spawn")
    chunk = 8
    jobs = {}
    with ctx.Pool(workers) as pool:
        for case in cases:  # largest first, so the pool stays busy
            jobs[case] = [pool.apply_async(engine_streams, (case, range(i, min(i + chunk, case.B))))
                          for i in range(0, case.B, chunk)]
        ports = {case: port_case(case, device) for case in cases}
        out = {}
        for case in cases:
            nv = np.stack([r for j in jobs[case] for r in j.get()])  # [B, reads, L]
            reads, launches, secs = ports[case]
            assert len(reads) == nv.shape[1] == case.reads, (case.name, len(reads), nv.shape)
            worst = 0.0
            for i, got in enumerate(reads):
                worst = max(worst, float(compare(case, got, nv[:, i]).max()))
            out[case.name] = (worst, case.B, launches, secs)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("families", nargs="*", help=" ".join(FAMILIES))
    ap.add_argument("--legs", default="golden,native")
    ap.add_argument("--quick", action="store_true",
                    help="B=2 (R128 4) and 2 s (R128 6 s) in the native leg, for the CPU test")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1,
                    help="engine processes of the native leg")
    args = ap.parse_args(argv)
    fams = args.families or list(FAMILIES)
    legs = [g for g in args.legs.split(",") if g]
    bad = [f for f in fams if f not in FAMILIES] + [g for g in legs if g not in ("golden", "native")]
    if bad:
        ap.error(f"unknown families or legs: {bad}")
    if args.quick:
        print("gpu_parity_check: --quick: native leg at B=2 (R128 4) x 2 s (R128 6 s); "
              "not the card's sizes")

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("gpu_parity_check: no CUDA device (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    card = gpu_line() if args.device == "cuda" else "cpu (no card asked for)"
    print(f"device: {torch.cuda.get_device_name(0) if args.device == 'cuda' else 'cpu'}; "
          f"torch {torch.__version__}; legs {','.join(legs)}")
    if args.device == "cuda":
        from meters_lv2_torch.runtime import build

        build.kernels()

    results = {f: {} for f in fams}
    ok = True
    launches = {leg: dict.fromkeys(launch_counts(), 0) for leg in legs}
    if "golden" in legs:
        for f in fams:
            t0 = time.perf_counter()
            reset_counts()
            try:
                worst, n = golden_leg(f, device)
                results[f]["golden"] = {"fixtures": n, "share": float(worst),
                                        "ok": bool(worst <= 1)}
            except AssertionError as e:
                results[f]["golden"] = {"share": None, "ok": False, "error": str(e)[:500]}
            for key, v in launch_counts().items():
                launches["golden"][key] += v
            results[f]["golden"]["seconds"] = round(time.perf_counter() - t0, 3)
    if "native" in legs:
        table = native_cases(args.quick)
        cases = [c for f in fams for c in table[f]]
        cases.sort(key=lambda c: -c.B * c.seconds * c.fs * c.C)
        done = native_leg(cases, device, args.workers) if cases else {}
        for f in fams:
            rows = {c.name: done[c.name] for c in table[f]}
            if not rows:
                results[f]["native"] = None
                continue
            share = max(r[0] for r in rows.values())
            results[f]["native"] = {
                "share": float(share), "ok": bool(share <= 1),
                "cases": {name: {"streams": r[1], "share": r[0], "launches": r[2],
                                 "seconds": round(r[3], 3)} for name, r in rows.items()}}
            for r in rows.values():
                for key, v in r[2].items():
                    launches["native"][key] += v
    for f in fams:
        parts = []
        for leg in legs:
            r = results[f].get(leg)
            if r is None:
                parts.append(f"{leg}: none")
                continue
            ok &= r["ok"]
            if leg == "golden":
                parts.append(f"golden: {r.get('fixtures', '?')} fixtures worst "
                             + (f"{r['share']:.4f}" if r["share"] is not None else "FAIL")
                             + f" of a bar ({r['seconds']:.1f} s)"
                             + ("" if r["ok"] else f" [{r.get('error', 'over the bar')}]"))
            else:
                runs = ", ".join(f"{n} {c['streams']}" for n, c in r["cases"].items())
                parts.append(f"native: {runs} streams worst {r['share']:.4f} of a bar")
        fam_ok = all(results[f].get(g) is None or results[f][g]["ok"] for g in legs)
        print(f"[{f:11s}] {'OK  ' if fam_ok else 'FAIL'} " + " | ".join(parts))
    for leg in legs:
        print(f"launches ({leg} leg): " + ", ".join(f"{k} {v}" for k, v in launches[leg].items()))
    print(card)
    print(json.dumps({"families": results, "launches": launches, "device": args.device,
                      "quick": args.quick, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
