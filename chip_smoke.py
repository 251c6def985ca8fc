#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (meters_lv2_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:

  1. device   the card, its power limit, fp32 matmul precision settings;
  2. build    nvcc builds every kernel from meters_lv2_torch/csrc;
  3. kernels  each kernel (r128_fused, ballistics, truepeak_fused,
              bitmeter_stats, spectrum_fused, surround_fused, stft_fused)
              against its plain PyTorch version on the same card tensors
              (truepeak_fused's default envelope body against its own and
              the serial body's plain version, its serial body against
              its own, at N=512 T=48000 and on rows with NaN and +-Inf at
              block edges, in the history and side by side; stft_fused
              in all three modes at [256, 2, 56192] and at W=256 hop
              1764, raw mode also against torch.fft.rfft, and with a NaN
              and a +Inf sample); the ballistics envelope body (the PPM
              meters' default) against its plain version and the serial
              kernel (N=512 T=48000 with and without track_peak,
              adversarial rows, and 600 rows of T=1000 with NaN and +-Inf
              at the edges of blocks and groups); then the two variants:
              r128_fused's seg mode at [256, 2,
              48000] with random offsets at fragm 2400 and 2205 against
              its plain version and the kernel's full-rate mode, and the
              surround wide layout against the narrow kernel and the plain
              version at C=5 and C=8, B=256, and with NaN/Inf samples;
  4. main     at the bench operating point (B=256 streams of 48 kHz
              stereo, 12 flat 1 s blocks): EbuR128Meter, then dBTPstereo,
              BBCstereo, DINstereo, BBCM6, VUstereo, K20stereo and COR,
              each with the kernel launch counts checked (the PPM meters
              on the ballistics envelope kernel) and streams 0-3 held
              against the same meter on CPU tensors; dBTPstereo also in
              1000-sample blocks (a 104-sample tail per update, on the
              serial ballistics kernel); then
              the statistics meters dr14stereo, TPnRMSstereo, SigDistHist
              (both modes) and bitmeter (channel 0) over 60 blocks (20 DR
              windows), created and initialised with no device argument,
              streams 0-3 after 12 blocks held against CPU runs, and a
              NaN/+-Inf stream through sigdist and DR-14 on both; then
              spectr30stereo, created and initialised with no device
              argument, over the 12 blocks with set_speed mid-stream, and
              in 1000-sample blocks (a 104-sample tail per update through
              the plain ops), streams 0-3 held against CPU runs; then
              surround5 and surround8, created and initialised with no
              device argument, over the 12 blocks with the surround beds
              of tests/signals.py derived on the card, and in 1000-sample
              blocks with runtime pairs set mid-stream, streams 0-3 held
              against CPU runs; then phasewheel, stereoscope and
              goniometer (oversample 4), created and initialised with no
              device argument, over the 12 blocks, stft_fused launched once
              per phase wheel and stereoscope update, streams 0-3 of every
              update held against CPU runs; then the variants: R128's
              fragment sums through r128_fused's seg mode over the 12
              blocks (carried state and offsets) against the full-rate
              kernel + shifted_segments, and surround5 and surround8 with
              METERS_TORCH_SURROUND_WIDE=1 against the narrow run, each
              variant's launches counted; then 60 x 1 s carried through
              both truepeak_fused bodies and both ballistics bodies at
              N=512 (the largest relative difference of z1, z2 and m), 60 x
              1 s at B=8 carried through spectrum_fused and its plain
              version (each its own state; val, peak and zf of every call
              within SPEC_TOL), and
              K20stereo, COR, goniometer, phasewheel and surround5 under a
              caller's torch.set_float32_matmul_precision("high") against
              the "highest" run, bit for bit;
  5. golden   committed C-reference fixtures streamed on the card: two
              R128 ones, every fixture of the ballistics families, the 14
              statistics fixtures (DR-14, TP+RMS, sigdist, bit meter) and
              the five spectrum fixtures (strict and in-band worst), the
              four surround fixtures and the 14 analyzer fixtures (STFT,
              phase wheel, stereoscope, goniometer), the DIN, BBC and BBC
              M-6 fixtures on the envelope body (its launches counted);
              then the surround fixtures through the wide layout;
  6. times    each kernel vs its plain version, truepeak_fused's envelope
              and serial bodies alternated at N=512 and N=8,192, the
              ballistics kernel's envelope and serial bodies alternated at
              N=512 and at 4,224 to 33,792 rows, and main-path x-realtime
              (R128 over 120 blocks, down from 240 to keep the whole run
              well inside its time limit; dBTP, BBC, DIN, BBC M-6, the
              statistics meters and
              spectr30stereo, surround5 and surround8 over 60; for the
              surround meters also the host's enqueue time and the device
              time of an update under torch.profiler); stft_fused also
              against torch.fft.rfft of the windowed frames, and the three
              analyzers' x-realtime over 60 blocks with their enqueue and
              device time per update; each variant against its default,
              and surround5 and surround8 x-realtime with the wide layout
              on.

The CPU runs of DR-14 and TP+RMS (their true peak is a Python loop per
sample on the CPU) go to worker processes at the start and are collected in
phase 4, so they overlap the card's work.  The last lines are a JSON
summary of the kernels, the nvidia-smi name and power limit, and
{"ok": true, "device": {...}}.  Without CUDA, or outside a checkout, it
exits non-zero and prints no result.  It imports no JAX.
"""

import contextlib
import dataclasses
import json
import math
import multiprocessing
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FS = 48000
B_MAIN = 256  # streams at the bench operating point (bench.py)
TOL_DB = 0.01  # parity budget of every level readout (BASELINE.json)

# Kernel vs plain version on the same card.  Both are IEEE fp32 with
# different summation orders (cuBLAS matmuls vs the kernel's FMA chains).
#   p:     rtol 1e-5, plus an absolute floor of 2e-6 x max|p| of the call:
#          the K-weighting state error feeds y through s @ Sy, so the error
#          scales with the stream's power, not with each sample's p (a
#          float64 run of the plain version drifts 9.4e-7 from fp32 at
#          max p 5.1 over 375 blocks, one card run measured 9.5e-7).
#   z:     per state component, 4e-6 x max|z_k|: the fp32 state chain
#          carries rounding across blocks in proportion to each
#          component's scale (the integrator state reaches ~840 while the
#          others stay ~3; fp32-vs-float64 drift is 1.3e-7 of that scale).
#   hist:  bit-exact (a copy of the last 47 inputs).
#   tpmax: rtol 1e-6 (48-tap FIR vs 175-row block matmul: a few ulp).
P_RTOL, P_FLOOR = 1e-5, 2e-6
Z_SCALE = 4e-6
TP_RTOL = 1e-6
# ballistics: bit-exact (the kernel does the plain version's fp32
# operations in its order, none contracted).
# truepeak_fused: hist' bit-exact; z1, z2, m, p within 1e-5 relative, with
# the same NaN/Inf positions.  The kernel's FIR sums the 48 tap products in
# tap order, the plain version's block matmul in cuBLAS's order, so each
# oversample differs by a few ulp of its terms; the chain is contractive
# and m, p are maxima of z1 + z2 and |up|, so they inherit a few ulp.
# Against the plain version of its own body that FIR order is the only
# difference (each body's chain does the plain version's operations);
# against the other body's, the envelope's own 2e-6 bar
# (tests/test_torch_variants.py) adds to it, within the same 1e-5.
TPK_RTOL = 1e-5
COR_TOL = 1e-4  # card vs CPU correlation readout, absolute
# statistics meters, card vs CPU: histograms, counters, window counts,
# bit-meter min/max and DR top-2 peaks exact (integer sums, maxima of the
# same floats); every other float state leaf (sigdist mean / M2 / sum, the
# DR-14 / TP+RMS K-meter, true-peak and RMS-sum leaves) within 1e-5 of the
# leaf's scale plus 1e-6 (float32 sums in another order, the truepeak
# kernel's FIR in tap order); DR-14 / TP+RMS readouts within STATS_TOL_DB,
# the dB image of that 1e-5 (20 log10(1 + 1e-5) = 8.7e-5 dB; an H100 run
# measured 1.91e-6 dB).
SD_SCALE, SD_FLOOR = 1e-5, 1e-6
STATS_TOL_DB = 1e-4
N_STATS = 60  # main-path blocks of the statistics meters (20 DR windows)
# spectrum_fused, kernel vs plain version: val, block peak and zf each
# within SPEC_TOL of the leaf's scale (max |x| over the leaf's finite
# values), with the same NaN and Inf positions.  The kernel runs the
# display smoother sample by sample, the plain version as blocked Toeplitz
# products, and the filter products in 3xTF32 on the tensor cores; the numpy
# emulation of the kernel's arithmetic (tests/test_torch_spectrum_body.py)
# differs from the plain version by 1.2e-6 of the val scale over 1 s at B=4
# (a single TF32 pass: 1.7e-4).  spectr30stereo on the card against the CPU:
# the state of streams 0-3 within SPEC_TOL of each band's scale, the
# readouts within STATS_TOL_DB (an H100 run measured 1.14e-5 dB over 1 s
# blocks and 1.91e-5 dB over 1000-sample blocks).
SPEC_TOL = 1e-5
# fp32 operations per (sample, band) of the spectrum function: six biquads
# of 5 MACs, square, smoother (a subtraction and an FMA) and max
SPEC_OPS = 6 * 5 * 2 + 1 + 3 + 1
# fp32 operations per channel-sample of the R128 function: the true-peak
# FIR (4 phases of 48 taps: 192 MACs, 384), the K-weighting recursion of
# the C reference (x' = p - b1 z1 - b2 z2: 4; y = a0 x' + a1 z1 + a2 z2 -
# c3 z3 - c4 z4: 9; z3 += y, z4 += z3: 2), the power (square, gain, channel
# sum: 3) and the peak (max of the 4 phases' |.|: 4).  The blocked form the
# kernel computes does the 128-term Toeplitz row (256) and the state maps
# (16) in place of the recursion: R128_BLOCKED_OPS
R128_OPS = 384 + 15 + 3 + 4
R128_BLOCKED_OPS = 384 + 256 + 16 + 3 + 4
# surround_fused, kernel vs plain version: pk bit-exact (fmaxf skips NaN as
# the plain version's where(isnan, 0, q) max does), km_z per component
# within SUR_Z_SCALE of its scale (the state chain, as Z_SCALE), zl and
# pacc within SUR_TOL of each leaf's scale (the kernel runs the lowpass
# sample by sample and composes the carried state into the pair sums, the
# plain version as blocked products; an H100 run of this script measured
# 5.4e-7 of the pacc scale at B=256 C=8 T=48000).
# surround5/8 on the card against the CPU: level and peak within
# STATS_TOL_DB, correlation within COR_TOL.
SUR_Z_SCALE, SUR_TOL = 4e-6, 1e-5
# fp32 operations of the surround function: per channel-sample the square
# (1), the peak max (1), x^2 into the smoother's two states (2 MACs: 4),
# the lowpass (x + eps, then (1 - w) z + w x: 4); per pair-sample the two
# selections over C channels (2C MACs: 4C), three products (3) and three
# weighted sums (6)
SUR_OPS_CHAN = 1 + 1 + 4 + 4


def sur_ops_pair(C):
    return 4 * C + 9


# H100 SXM datasheet peaks: HBM bytes/s, fp32 FLOP/s
HBM_BPS, FP32_FLOPS = 3.35e12, 67e12


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    stop_workers()
    sys.exit(1)


def gpu_line():
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0].strip()


def same_nonfinite(a, b):
    """Same NaN positions and the same infinities in the same places."""
    import torch

    inf = torch.isinf(b)
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(torch.isinf(a), inf) and torch.equal(a[inf], b[inf]))


def compare_core(got, ref, tag):
    """Print the errors of one fused_core call against the plain version;
    return (max abs error of p, list of tolerance breaches)."""
    import torch

    p, z, h, t = got
    pr, zr, hr, tr = ref
    errs = []
    if not all(same_nonfinite(a, b) for a, b in zip(got, ref)):
        errs.append("non-finite values differ")
    fin = torch.isfinite(pr)
    pmax = pr[fin].abs().max().item() if fin.any() else 0.0
    dp = (p - pr).abs()[fin]
    p_err = dp.max().item() if dp.numel() else 0.0
    if dp.numel() and bool((dp > P_RTOL * pr.abs()[fin] + P_FLOOR * pmax).any()):
        errs.append(f"p max abs err {p_err:.3g} (max p {pmax:.3g})")
    zf = torch.isfinite(zr)
    zscale = torch.where(zf, zr, 0.0).abs().amax(dim=(0, 1))  # per component
    dz = torch.where(zf, (z - zr).abs(), 0.0)
    z_err = dz.max().item()
    if bool((dz > Z_SCALE * zscale).any()):
        errs.append(f"z max abs err {z_err:.3g} (scale {zscale.tolist()})")
    if not torch.equal(h, hr):
        errs.append("hist not bit-exact")
    tf = torch.isfinite(tr)
    dt = (t - tr).abs()[tf]
    t_err = dt.max().item() if dt.numel() else 0.0
    if dt.numel() and bool((dt > TP_RTOL * tr.abs()[tf]).any()):
        errs.append(f"tpmax max abs err {t_err:.3g}")
    status = "ok" if not errs else "FAIL " + "; ".join(errs)
    print(f"  {tag}: p err {p_err:.3g}, z err {z_err:.3g}, tpmax err {t_err:.3g}: {status}")
    return p_err, errs


def run_golden(create, fx, device):
    """Stream one ebur128 fixture with the test cadence and asserts of
    tests/test_golden_parity.py::test_ebur128_parity."""
    import torch
    from signals import make_signal

    m = create("EBUr128", fx["fs"], nchan=fx["nchan"])
    x = make_signal(fx["signal"], fx["seconds"], fs=fx["fs"])[: fx["nchan"]]
    st = m.init((), device=device)
    xd = torch.as_tensor(x, device=device)
    mid = iter([r for r in fx["reads"] if "final" not in r])
    final = [r for r in fx["reads"] if r.get("final")][0]
    aligned = fx["meter"] == "ebur128_aligned"
    keys = [("M", "loudness_M"), ("S", "loudness_S"), ("maxM", "max_M"), ("maxS", "max_S")]
    if aligned:
        keys += [("I", "integrated"), ("LRAmin", "range_min"), ("LRAmax", "range_max")]
    worst = 0.0
    blk = fx["block"]
    for b in range(x.shape[1] // blk):
        st = m.update(st, xd[:, b * blk:(b + 1) * blk])
        if (b + 1) % fx["read_every"] == 0:
            out, _ = m.read(st)
            rec = next(mid)
            for key, mine in keys:
                g, o = rec[key], float(out[mine])
                if g <= -199.0:
                    if o > -199.0:
                        fail(f"golden {fx['meter']}/{fx['signal']} {key} blk {rec['block']}: {o} vs {g}")
                else:
                    worst = max(worst, abs(o - g))
                    if abs(o - g) >= TOL_DB:
                        fail(f"golden {fx['meter']}/{fx['signal']} {key} blk {rec['block']}: {o} vs {g}")
    for key, fk in (("hist_m", "histM"), ("hist_s", "histS")):
        if not np.array_equal(getattr(st, key).cpu().numpy(), np.asarray(final[fk])):
            fail(f"golden {fx['meter']}/{fx['signal']} {key} not bin-exact")
    if int(st.count_m) != final["countM"] or int(st.count_s) != final["countS"]:
        fail(f"golden {fx['meter']}/{fx['signal']} counts differ")
    return worst


def cuda_ms(fn, reps, warmup=2):
    """Median over reps of CUDA-event times of fn(), after warmup calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def timed_call(fn):
    """(fn(), the CUDA-event ms of that one call)."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def same_bits(a, b):
    """Bit-exact, NaN positions included."""
    import torch

    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


def finite_err(a, b):
    """Max |a - b| where b is finite (0.0 if nowhere)."""
    import torch

    f = torch.isfinite(b)
    return (a - b).abs()[f].max().item() if bool(f.any()) else 0.0


def compare_ballistics(got, ref, tag):
    """One ballistics call against the plain version: every output
    bit-exact.  Returns (max abs error, breaches)."""
    errs = [f"{n} not bit-exact" for n, a, b in zip(("z1", "z2", "m", "p"), got, ref)
            if not same_bits(a, b)]
    err = max(finite_err(a, b) for a, b in zip(got, ref))
    print(f"  ballistics {tag}: max abs err {err:.3g}: "
          f"{'ok, bit-exact' if not errs else 'FAIL ' + '; '.join(errs)}")
    return err, errs


def compare_truepeak(got, ref, tag):
    """One truepeak_fused call against the plain version: hist' bit-exact,
    the states within TPK_RTOL with the same non-finite values."""
    import torch

    hist_exact = same_bits(got[4], ref[4])
    errs = [] if hist_exact else ["hist not bit-exact"]
    err = 0.0
    for n, a, b in zip(("z1", "z2", "m", "p"), got[:4], ref[:4]):
        if not same_nonfinite(a, b):
            errs.append(f"{n} non-finite values differ")
        f = torch.isfinite(b)
        d = (a - b).abs()[f]
        if d.numel():
            err = max(err, d.max().item())
            if bool((d > TPK_RTOL * b.abs()[f]).any()):
                errs.append(f"{n} max abs err {d.max().item():.3g}")
    print(f"  truepeak_fused {tag}: max abs err {err:.3g}, hist exact {hist_exact}: "
          f"{'ok' if not errs else 'FAIL ' + '; '.join(errs)}")
    return err, errs


def level_db_diff(a, b):
    """Max |dB(a) - dB(b)| over the elements, 0 where both are below 1e-6
    (tests/test_golden_parity.py::assert_level)."""
    import torch

    a, b = a.double(), b.double()
    tiny = (a.abs() < 1e-6) & (b.abs() < 1e-6)
    d = (20 * torch.log10(a.abs().clamp_min(1e-12))
         - 20 * torch.log10(b.abs().clamp_min(1e-12))).abs()
    d = torch.where(tiny, 0.0, d)
    return d.max().item()


def readouts(out):
    return out if isinstance(out, dict) else {"value": out}


def main_blocks():
    """The 12 flat 1 s blocks [B_MAIN, 2*FS] of the main path."""
    rng = np.random.default_rng(0)
    return [rng.standard_normal((B_MAIN, 2 * FS), dtype=np.float32) * np.float32(0.1)
            for _ in range(12)]


def nan_blocks():
    """Four 1 s stereo blocks of 4 streams with NaN and +-Inf samples."""
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal((4, 2, FS), dtype=np.float32) * np.float32(0.2)
          for _ in range(4)]
    xs[0][3, 0, 50] = np.nan
    xs[1][0, 1, 100] = np.nan
    xs[2][1, 0, 200] = np.inf
    xs[2][2, 1, 300] = -np.inf
    return xs


# (meter, constructor arguments, input layout): "stereo" feeds [.., 2, T],
# "ch0" channel 0 as [.., T]
STATS = [
    ("dr14stereo", {}, "stereo"),
    ("TPnRMSstereo", {}, "stereo"),
    ("SigDistHist", {}, "ch0"),
    ("SigDistHist", {"reference_oor_count": True}, "ch0"),
    ("bitmeter", {}, "ch0"),
]


def state_tensors(state):
    """Every tensor of a meter state: a dataclass or a dict of tensors and
    nested states."""
    vals = (list(state.values()) if isinstance(state, dict)
            else [getattr(state, f.name) for f in dataclasses.fields(state)])
    return [t for v in vals
            for t in (state_tensors(v) if dataclasses.is_dataclass(v) else [v])]


def stats_input(x, layout):
    return x if layout == "stereo" else x[..., 0, :]


def cpu_stats_run(name, kw, layout, which):
    """A statistics meter on CPU tensors over streams 0-3 of the first 12
    main-path blocks (which="main") or over nan_blocks(); returns (state,
    readouts) as numpy.  Runs in a worker process for DR-14 and TP+RMS."""
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    import meters_lv2_torch
    from meters_lv2_torch.utils.interop import state_to_numpy

    if which == "main":
        xs = [b.reshape(B_MAIN, 2, FS)[:4].copy() for b in main_blocks()]
    else:
        xs = nan_blocks()
    m = meters_lv2_torch.create(name, FS, **kw)
    st = m.init((4,), device="cpu")
    for xb in xs:
        st = m.update(st, stats_input(torch.from_numpy(xb), layout))
    out, st = m.read(st)
    return state_to_numpy(st), {k: v.numpy() for k, v in out.items()}


def compare_stats(name, got_state, got_out, ref_state, ref_out):
    """Card state and readouts (numpy, streams 0-3) against the CPU run's;
    returns (worst readout difference, list of breaches)."""
    errs = []

    def walk(a, b, path):
        for k in b:
            if isinstance(b[k], dict):
                walk(a[k], b[k], f"{path}.{k}")
                continue
            x, y = a[k], b[k]
            if y.dtype.kind in "ib" or name == "bitmeter" or k == "peak_top2":
                if not np.array_equal(x, y, equal_nan=y.dtype.kind == "f"):
                    errs.append(f"{path}.{k} not exact")
            else:
                f = np.isfinite(y)
                if not np.array_equal(x[~f], y[~f], equal_nan=True):
                    errs.append(f"{path}.{k} non-finite values differ")
                tol = SD_SCALE * np.abs(y[f]).max(initial=0.0) + SD_FLOOR
                if np.any(np.abs(x[f] - y[f]) > tol):
                    errs.append(f"{path}.{k} differs by {np.abs(x[f] - y[f]).max():.3g}")

    walk(got_state, ref_state, name)
    worst = 0.0
    for k, y in ref_out.items():
        x = got_out[k]
        f = np.isfinite(y)
        if not np.array_equal(x[~f], y[~f], equal_nan=True):
            errs.append(f"readout {k} non-finite values differ")
        if y.dtype.kind in "ib":
            if not np.array_equal(x, y):
                errs.append(f"readout {k} not exact")
            continue
        d = np.abs(x[f].astype(np.float64) - y[f]).max(initial=0.0)
        if name.startswith(("dr14", "TPnRMS")):
            worst = max(worst, d)
            if d > STATS_TOL_DB:
                errs.append(f"readout {k} differs by {d:.3g} dB")
        elif name == "bitmeter" and d != 0.0:
            errs.append(f"readout {k} not exact")
    return worst, errs


def compare_bitstats(got, ref, tag):
    """One bitmeter_stats call against the plain version: every field
    exact.  Returns (max abs difference, breaches)."""
    import torch

    errs = [f"{k} not exact" for k in ref
            if not (same_bits(got[k], ref[k]) if ref[k].is_floating_point()
                    else torch.equal(got[k], ref[k]))]
    err = max(finite_err(got[k].double(), ref[k].double()) for k in ref)
    print(f"  bitmeter_stats {tag}: max abs err {err:.3g}: "
          f"{'ok, exact' if not errs else 'FAIL ' + '; '.join(errs)}")
    return err, errs


def leaf_err(a, b):
    """(max |a - b| over b's finite values, b's scale there)."""
    import torch

    f = torch.isfinite(b)
    if not bool(f.any()):
        return 0.0, 0.0
    return (a - b).abs()[f].max().item(), b.abs()[f].max().item()


def compare_spectrum(got, ref, tag):
    """One spectrum_fused call against the plain version: val, block peak
    and zf within SPEC_TOL of each leaf's scale, the same non-finite values.
    Returns (max abs error over the leaves, breaches)."""
    import torch

    errs, parts, worst = [], [], 0.0
    for n, a, b in zip(("val", "peak", "zf"), got, ref):
        if not same_nonfinite(a, b):
            errs.append(f"{n} non-finite values differ")
        err, scale = leaf_err(a, b)
        worst = max(worst, err)
        f = torch.isfinite(b) & (b != 0)
        rel = ((a - b).abs()[f] / b.abs()[f]).max().item() if bool(f.any()) else 0.0
        parts.append(f"{n} err {err:.3g} = {err / scale if scale else 0.0:.3g} of scale, "
                     f"elementwise rel {rel:.3g}")
        if err > SPEC_TOL * scale:
            errs.append(f"{n} err {err:.3g} over {SPEC_TOL} x scale {scale:.3g}")
    print(f"  spectrum_fused {tag}: {'; '.join(parts)}: "
          f"{'ok' if not errs else 'FAIL ' + '; '.join(errs)}")
    return worst, errs


def spec_inputs(spec, B, T, seed, dev):
    """x [B, T] (numpy), and a filter state [B, 30, 12] and smoother value
    [B, 30] on ``dev`` at a stream's real scale: 0.25 s of noise through
    the plain banked LTI."""
    import torch

    g = np.random.default_rng(seed)
    warm = torch.as_tensor((0.3 * g.standard_normal((B, FS // 4))).astype(np.float32), device=dev)
    yw, z0 = spec.bank.apply(warm, spec.bank.init((B,), device=dev))
    v0 = torch.mean(torch.square(yw), dim=-1)
    x = (0.3 * g.standard_normal((B, T))).astype(np.float32)
    return x, z0.contiguous(), v0.contiguous()


def spec_omega(spec, speed, dev):
    """The smoother coefficient of ``speed`` as a 0-d tensor on ``dev``."""
    return spec.set_speed(spec.init((), device=dev), speed).omega


def spectrum_kernel_cases(dev):
    """spectrum_fused against its plain version: the main-path shape, one
    block, a partial tile of streams, NaN/+-Inf rows, the NaNs the card's
    own arithmetic makes (0x7fffffff, and 0xffffffff), which the kernel's
    TF32 split turns into zeros, a NaN omega (set_speed(NaN)) and an omega
    changed between two chained calls.
    Returns (max abs error at the main-path shape, breaches)."""
    import torch

    import meters_lv2_torch
    from meters_lv2_torch.ops import spectrum_fused

    spec = meters_lv2_torch.create("spectr30stereo", FS)
    sop = spec.bank.op(128)
    failures, spec_err = [], None
    for tag, B, T, inject, speed in [
        (f"main-path shape B={B_MAIN} T={FS}", B_MAIN, FS, False, 3.0),
        ("one block B=4 T=128", 4, 128, False, 3.0),
        ("B=13 T=1024, a partial tile of streams", 13, 1024, False, 3.0),
        ("NaN/+-Inf in x, z0 and v0, B=7 T=1024", 7, 1024, True, 3.0),
        ("NaNs 0x7fffffff and 0xffffffff in x, B=5 T=1024", 5, 1024, "card", 3.0),
        ("NaN omega (set_speed(NaN)), B=5 T=256", 5, 256, False, float("nan")),
    ]:
        x, z0, v0 = spec_inputs(spec, B, T, B + T, dev)
        if inject == "card":
            u = x.view(np.uint32)
            u[0, 37], u[1, 300], u[2, 0], u[2, 900] = 0x7FFFFFFF, 0xFFFFFFFF, 0x7FFFFFFF, 0xFFFFFFFF
            u[3, 127] = 0x7FFFFFFF
        elif inject:
            x[0, 37], x[1, T - 1], x[2, 0] = np.nan, np.inf, -np.inf
            x[3, 130], x[3, 200], x[4, 128] = np.inf, -np.inf, np.inf
            v0[5, 3], v0[5, 4], v0[5, 5] = np.inf, np.nan, -np.inf
            z0[5, 7, 2] = np.inf
        xd = torch.as_tensor(x, device=dev)
        om = spec_omega(spec, speed, dev)
        got = spectrum_fused.fused_core(xd, z0, v0, om, sop)
        ref = spectrum_fused.fused_core_reference(xd, z0, v0, om, sop)
        torch.cuda.synchronize()
        err, errs = compare_spectrum(got, ref, tag)
        failures += [f"spectrum_fused {tag}: {e}" for e in errs]
        if spec_err is None:
            spec_err = err
        del got, ref
    # omega changed between two chained calls (set on the card, no sync)
    x, z0, v0 = spec_inputs(spec, 8, 1024, 11, dev)
    x1 = torch.as_tensor(x[:, :512], device=dev)
    x2 = torch.as_tensor(x[:, 512:], device=dev)
    om1, om8 = spec_omega(spec, 1.0, dev), spec_omega(spec, 8.0, dev)
    got = spectrum_fused.fused_core(x1, z0, v0, om1, sop)
    ref = spectrum_fused.fused_core_reference(x1, z0, v0, om1, sop)
    got = spectrum_fused.fused_core(x2, got[2], got[0], om8, sop)
    ref = spectrum_fused.fused_core_reference(x2, ref[2], ref[0], om8, sop)
    torch.cuda.synchronize()
    _, errs = compare_spectrum(got, ref, "omega 1 -> 8 between chained calls B=8 T=2x512")
    failures += [f"spectrum_fused omega change: {e}" for e in errs]
    return spec_err, failures


def spectrum_main(dev, blocks_dev, blocks3, reset_counts):
    """spectr30stereo, created and initialised with no device argument,
    over the main-path blocks with set_speed(4) after 6 of them, then on
    streams 0-3 in 1000-sample blocks with set_speed(NaN) for one block;
    each run's kernel launches checked and streams 0-3 held against a CPU
    run.  Returns the two launch counts."""
    import torch

    import meters_lv2_torch
    from meters_lv2_torch.ops import (
        ballistics_core, bitmeter_stats, r128_fused, spectrum_fused, truepeak_fused)

    def state_diff(a, b):
        """Worst error of the card state's streams 0-3 against the CPU
        state over SPEC_TOL x each band's scale (the max over streams of
        val and peak, over streams and components of zf), the same
        non-finite values required."""
        r = 0.0
        for k in ("val", "peak", "zf"):
            x, y = getattr(a, k)[:4].cpu().double(), getattr(b, k).double()
            if not same_nonfinite(x, y):
                return float("inf")
            f = torch.isfinite(y)
            x, y = torch.where(f, x, 0.0), torch.where(f, y, 0.0)
            dims = (0, 2) if k == "zf" else (0,)
            scale = y.abs().amax(dim=dims, keepdim=True)
            err = (x - y).abs().amax(dim=dims, keepdim=True)
            ratio = torch.where(scale > 0, err / (SPEC_TOL * scale), 0.0)
            r = max(r, ratio.max().item())
        return r

    def db_diff(o, oc):
        return max((o[k][:4].cpu() - oc[k]).abs().max().item() for k in ("bands", "peaks"))

    spec = meters_lv2_torch.create("spectr30stereo", FS)
    st = spec.init((B_MAIN,))
    if not all(getattr(st, f.name).device.type == dev.type for f in dataclasses.fields(st)):
        fail("main path spectr30stereo: init() without a device did not put the state on the card")
    st_c = spec.init((4,), device="cpu")
    reset_counts()
    for i, xb in enumerate(blocks_dev):
        if i == 6:
            st = spec.set_speed(st, 4.0)
        st = spec.update(st, xb, stereo=True)
    out, st = spec.read(st)
    torch.cuda.synchronize()
    n_main = spectrum_fused.launch_count
    others = (r128_fused.launch_count, ballistics_core.launch_count,
              truepeak_fused.launch_count, bitmeter_stats.launch_count)
    if n_main != len(blocks_dev) or any(others):
        fail(f"main path spectr30stereo: spectrum_fused launches {n_main} (expected "
             f"{len(blocks_dev)}), other kernels {others}")
    for k, v in out.items():
        if v.shape != (B_MAIN, 30) or not bool(torch.isfinite(v).all()):
            fail(f"main path spectr30stereo readout {k} not finite of shape ({B_MAIN}, 30)")
    for i, xb in enumerate(blocks3):
        if i == 6:
            st_c = spec.set_speed(st_c, 4.0)
        st_c = spec.update(st_c, torch.as_tensor(xb[:4]), stereo=True)
    out_c, st_c = spec.read(st_c)
    d_db, r_st = db_diff(out, out_c), state_diff(st, st_c)
    if not (d_db < STATS_TOL_DB and r_st <= 1.0):
        fail(f"main path spectr30stereo: card vs CPU readouts {d_db} dB, state at "
             f"{r_st:.3g} x tolerance")
    print(f"phase main: ok: spectr30stereo {len(blocks_dev)} x 1 s blocks at B={B_MAIN}, state "
          f"on {st.val.device}, set_speed(4) after 6 blocks, spectrum_fused launches {n_main}; "
          f"bands[0, 16] {out['bands'][0, 16].item():.4f} dB, peaks[0, 16] "
          f"{out['peaks'][0, 16].item():.4f} dB; streams 0-3 vs CPU: readouts {d_db:.3g} dB, "
          f"state {r_st:.3g} x tolerance")

    # 1000-sample blocks: 896 samples through the kernel and a 104-sample
    # tail through the plain banked LTI and one-pole per update; block
    # n_nan runs at set_speed(NaN), which must flush val and the peak-hold
    # on the card as on the CPU, and set_speed(4) then restores the meter
    n_nan = 36
    x4 = blocks3[0][:4]
    x4_dev = torch.as_tensor(x4, device=dev)
    st, st_c = spec.init((4,), device=dev), spec.init((4,), device="cpu")
    reset_counts()
    for i in range(FS // 1000):
        if i in (n_nan, n_nan + 1):
            speed = float("nan") if i == n_nan else 4.0
            st, st_c = spec.set_speed(st, speed), spec.set_speed(st_c, speed)
        st = spec.update(st, x4_dev[..., i * 1000:(i + 1) * 1000], stereo=True)
        st_c = spec.update(st_c, torch.as_tensor(x4[..., i * 1000:(i + 1) * 1000]), stereo=True)
        if i == n_nan:
            flushed = (bool((st_c.peak == 0).all()) and bool((st_c.val == 1e-20).all())
                       and torch.equal(st.peak.cpu(), st_c.peak)
                       and torch.equal(st.val.cpu(), st_c.val))
            r_nan = state_diff(st, st_c)
            if not (flushed and r_nan <= 1.0):
                fail(f"spectr30stereo after set_speed(NaN): val/peak flushed alike {flushed}, "
                     f"state at {r_nan:.3g} x tolerance")
    out, st = spec.read(st)
    torch.cuda.synchronize()
    n_tail = spectrum_fused.launch_count
    if n_tail != FS // 1000:
        fail(f"spectr30stereo 1000-sample blocks: spectrum_fused launches {n_tail}")
    out_c, st_c = spec.read(st_c)
    d_db, r_st = db_diff(out, out_c), state_diff(st, st_c)
    if not (d_db < STATS_TOL_DB and r_st <= 1.0):
        fail(f"spectr30stereo 1000-sample blocks: card vs CPU readouts {d_db} dB, state at "
             f"{r_st:.3g} x tolerance")
    print(f"phase main: ok: spectr30stereo {FS // 1000} x 1000-sample blocks (104-sample tail) "
          f"on streams 0-3, set_speed(NaN) for block {n_nan} (val and peak-hold flushed alike, "
          f"filter state {r_nan:.3g} x tolerance), then set_speed(4); spectrum_fused launches "
          f"{n_tail}; vs CPU: readouts {d_db:.3g} dB, state {r_st:.3g} x tolerance")
    return n_main, n_tail


def spectrum_carried(dev):
    """N_CARRIED x 1 s at B=8 through spectrum_fused and through its plain
    version, each path carrying its own state (zf and val) as the meter
    does: val, block peak and zf of every call within SPEC_TOL of each
    leaf's scale, with the same non-finite values.  The kernel's 3xTF32
    products must not drift from the plain version's fp32 over a minute
    (the state chain carries them; band 0's poles are the nearest to the
    unit circle)."""
    import torch

    import meters_lv2_torch
    from meters_lv2_torch.ops import spectrum_fused

    spec = meters_lv2_torch.create("spectr30stereo", FS)
    sop = spec.bank.op(128)
    x, z0, v0 = spec_inputs(spec, 8, N_CARRIED * FS, 12, dev)
    xd = torch.as_tensor(x, device=dev)
    om = spec_omega(spec, 3.0, dev)
    got, ref = (z0, v0), (z0, v0)
    worst = {"val": 0.0, "peak": 0.0, "zf": 0.0}
    for i in range(N_CARRIED):
        xb = xd[:, i * FS:(i + 1) * FS].contiguous()
        g = spectrum_fused.fused_core(xb, got[0], got[1], om, sop)
        r = spectrum_fused.fused_core_reference(xb, ref[0], ref[1], om, sop)
        for n, a, b in zip(worst, g, r):
            if not same_nonfinite(a, b):
                fail(f"spectrum_fused carried, call {i}: {n} non-finite values differ")
            err, scale = leaf_err(a, b)
            worst[n] = max(worst[n], err / scale if scale else 0.0)
        got, ref = (g[2], g[0]), (r[2], r[0])
    torch.cuda.synchronize()
    if not all(v <= SPEC_TOL for v in worst.values()):
        fail(f"spectrum_fused carried {N_CARRIED} s at B=8: kernel vs plain version {worst} of "
             f"each leaf's scale, bar {SPEC_TOL}")
    print(f"phase main: ok: spectrum_fused {N_CARRIED} x 1 s carried at B=8 T={FS}, kernel and "
          f"plain version each on its own state: worst over the calls " + ", ".join(
              f"{k} {v:.3g}" for k, v in worst.items()) + f" of each leaf's scale (bar {SPEC_TOL})")


def spectrum_nonfinite_meter(dev):
    """spectr30stereo on the card against the CPU with non-finite samples:
    3 streams in 1000-sample blocks, stream 0 with a NaN in L and stream 1
    with +Inf in L against -Inf in R in block 2 (both reach the kernel as
    the card's NaN 0x7fffffff from the downmix 0.5 (L + R)), stream 2
    clean.  After block 2 the state of streams 0-1 is flushed on both alike
    and equal; after 6 blocks the readouts are within STATS_TOL_DB."""
    import torch

    import meters_lv2_torch
    from meters_lv2_torch.ops import spectrum_fused

    m = meters_lv2_torch.create("spectr30stereo", FS)
    rng = np.random.default_rng(21)
    sg, sc = m.init((3,), device=dev), m.init((3,), device="cpu")
    n0 = spectrum_fused.launch_count
    for i in range(6):
        x = (0.2 * rng.standard_normal((3, 2, 1000))).astype(np.float32)
        if i == 2:
            x[0, 0, 50] = np.nan
            x[1, 0, 500], x[1, 1, 500] = np.inf, -np.inf
        sg = m.update(sg, torch.as_tensor(x, device=dev), stereo=True)
        sc = m.update(sc, torch.from_numpy(x), stereo=True)
        if i == 2:
            flushed = [torch.equal(getattr(sg, k)[:2].cpu(), getattr(sc, k)[:2])
                       for k in ("val", "peak", "zf")]
            if not all(flushed) or bool((sc.zf[:2] != 0).any()):
                fail("spectr30stereo with NaN / +Inf against -Inf on the card: streams 0-1's "
                     f"val, peak, zf after the block equal to the CPU's flushed state {flushed}")
    og, _ = m.read(sg)
    oc, _ = m.read(sc)
    torch.cuda.synchronize()
    if spectrum_fused.launch_count != n0 + 6:
        fail(f"spectr30stereo non-finite: spectrum_fused launches {spectrum_fused.launch_count - n0}")
    d_db = max((og[k].cpu() - oc[k]).abs().max().item() for k in ("bands", "peaks"))
    if not d_db < STATS_TOL_DB:
        fail(f"spectr30stereo with NaN / +Inf against -Inf: card vs CPU readouts {d_db} dB")
    print(f"phase main: ok: spectr30stereo on the card with a NaN in L and +Inf in L against -Inf "
          f"in R (block 2 of 6 x 1000 samples, B=3): streams 0-1 flushed as on the CPU, "
          f"readouts {d_db:.3g} dB from the CPU's")


def spectrum_golden(dev):
    """The five spectrum fixtures streamed whole on ``dev``."""
    import test_torch_golden_spectrum as gspec
    from signals import make_signal

    gw = []
    for name in gspec.FIXTURES:
        try:
            strict, in_band, n = gspec.run_spectrum(name, make_signal, device=dev)
        except AssertionError as e:
            fail(f"golden {name}: {e}")
        gw.append(f"{name} {n} values strict worst {strict:.3g} dB, in-band (> -60 dBFS) "
                  f"worst {in_band:.3g} dB")
    print(f"phase golden: ok: spectrum fixtures, whole: {'; '.join(gw)}")


def spectrum_times(dev, blocks_dev, gpu):
    """spectrum_fused against its plain version at the main-path shape
    (plain, kernel, kernel, plain), and spectr30stereo's x-realtime over 60
    blocks at B=256.  Returns (kernel ms, plain ms)."""
    import torch

    import meters_lv2_torch
    from meters_lv2_torch.ops import spectrum_fused

    spec = meters_lv2_torch.create("spectr30stereo", FS)
    sop = spec.bank.op(128)
    x, z0, v0 = spec_inputs(spec, B_MAIN, FS, 3, dev)
    xd = torch.as_tensor(x, device=dev)
    om = spec_omega(spec, 1.0, dev)
    ms_k, ms_p = [], []
    for w in "pkkp":
        if w == "k":
            ms_k.append(cuda_ms(lambda: spectrum_fused.fused_core(xd, z0, v0, om, sop), 10))
        else:
            ms_p.append(cuda_ms(lambda: spectrum_fused.fused_core_reference(xd, z0, v0, om, sop), 3))
    ms = (statistics.mean(ms_k), statistics.mean(ms_p))
    print(f"phase times: spectrum_fused kernel {ms[0]:.4f} ms (medians {ms_k}), plain version "
          f"{ms[1]:.4f} ms (medians {ms_p}) at B={B_MAIN} T={FS} [{gpu}]")
    del xd, z0, v0
    runs = []
    for _ in range(2):
        st = spec.update(spec.init((B_MAIN,)), blocks_dev[0], stereo=True)  # warm
        st = spec.init((B_MAIN,))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(N_STATS):
            st = spec.update(st, blocks_dev[i % len(blocks_dev)], stereo=True)
        out, _ = spec.read(st)
        torch.cuda.synchronize()
        [v.cpu() for v in out.values()]
        runs.append(time.perf_counter() - t0)
    print(f"phase times: spectr30stereo {B_MAIN * N_STATS / min(runs):.1f} x-realtime (best of "
          f"{len(runs)}: {[round(r, 4) for r in runs]} s for {N_STATS} x 1 s blocks at "
          f"B={B_MAIN}, {min(runs) / N_STATS * 1e3:.3f} ms per update) [{gpu}]")
    return ms


def surround_blocks(C, blocks):
    """The C-channel beds of tests/signals.py::make_surround derived on the
    card from stereo blocks [B, 2, T]: [B, C, T] each."""
    import torch

    out = []
    for xb in blocks:
        l, r = xb[..., 0, :], xb[..., 1, :]
        chans = [l, r, 0.5 * (l + r), 0.7 * l, 0.6 * r, 0.5 * (l - r), 0.8 * r, 0.65 * l + 0.2 * r]
        out.append(torch.stack(chans[:C], dim=-2).contiguous())
    return out


def surround_args(C, B, T, seed, dev, pairs=None, inject=False):
    """Arguments of surround_fused.fused_core on ``dev``: x [B, C, T] of
    0.3 N(0, 1), carried non-zero K-meter and lowpass states, the routing of
    ``pairs`` (default: the meter's adjacent pairs), the meter's weights."""
    import torch

    import meters_lv2_torch

    m = meters_lv2_torch.create(f"surround{C}", FS)
    g = np.random.default_rng(seed)
    x = (0.3 * g.standard_normal((B, C, T))).astype(np.float32)
    if inject:
        x[0, C - 1, 300], x[1, 1, 700], x[2, 0, 130] = np.nan, np.inf, -np.inf
    kz = torch.as_tensor((0.01 * g.random((B, C, 2))).astype(np.float32), device=dev)
    zl = torch.as_tensor((0.05 * g.standard_normal((B, C, 1))).astype(np.float32), device=dev)
    pr = None if pairs is None else torch.tensor(pairs, dtype=torch.float32, device=dev)
    wv, _ = m.cor._ema_weights(T, dev)
    return (torch.as_tensor(x, device=dev), kz, zl, *m._sel(pr, dev), m.km.sys, m.cor.lp,
            m.cor.w1, wv)


def compare_surround(got, ref, tag):
    """One surround_fused call against the plain version: pk bit-exact,
    km_z per component within SUR_Z_SCALE of its scale, zl and pacc within
    SUR_TOL of each leaf's scale; km_z and pk NaN/Inf in the same places,
    zl and pacc non-finite in the same places.  Returns (max abs error over
    the leaves, breaches)."""
    import torch

    errs, parts, worst = [], [], 0.0
    for n, a, b in zip(("km_z", "zl", "pk", "pacc"), got, ref):
        a, b = a.double(), b.double()
        f = torch.isfinite(b)
        if n in ("km_z", "pk") and not same_nonfinite(a, b):
            errs.append(f"{n} NaN/Inf values differ")
        if not torch.equal(torch.isfinite(a), f):
            errs.append(f"{n} non-finite in other places")
        err, scale = leaf_err(a, b)
        worst = max(worst, err)
        if n == "pk":
            if not same_bits(a, b):
                errs.append("pk not bit-exact")
        elif n == "km_z":
            zs = torch.where(f, b, 0.0).abs().amax(dim=(0, 1))
            if bool((torch.where(f, (a - b).abs(), 0.0) > SUR_Z_SCALE * zs).any()):
                errs.append(f"km_z err {err:.3g} over {SUR_Z_SCALE} x scale {zs.tolist()}")
        elif err > SUR_TOL * scale:
            errs.append(f"{n} err {err:.3g} over {SUR_TOL} x scale {scale:.3g}")
        parts.append(f"{n} err {err:.3g} = {err / scale if scale else 0.0:.3g} of scale")
    print(f"  surround_fused {tag}: {'; '.join(parts)}: "
          f"{'ok' if not errs else 'FAIL ' + '; '.join(errs)}")
    return worst, errs


def surround_kernel_cases(dev):
    """surround_fused against its plain version: B=5 C=5 T=1280 with
    carried states and runtime pairs, C=5 and C=8 at the main-path shape
    (surround5's and surround8's), and NaN / +Inf / -Inf samples.  Returns
    (max abs error at the main-path shapes, breaches)."""
    import torch

    from meters_lv2_torch.ops import surround_fused

    failures, main_err = [], 0.0
    for tag, C, B, T, pairs, inject in [
        ("B=5 C=5 T=1280, pairs 0:0 1:1 0:1 2:3", 5, 5, 1280, [[0, 0], [1, 1], [0, 1], [2, 3]],
         False),
        (f"main-path shape B={B_MAIN} C=5 T={FS}", 5, B_MAIN, FS, None, False),
        (f"main-path shape B={B_MAIN} C=8 T={FS}", 8, B_MAIN, FS, None, False),
        ("NaN/+Inf/-Inf in x, B=5 C=5 T=1280", 5, 5, 1280, None, True),
    ]:
        args = surround_args(C, B, T, B + C, dev, pairs, inject)
        got = surround_fused.fused_core(*args)
        ref = surround_fused.fused_core_reference(*args)
        torch.cuda.synchronize()
        err, errs = compare_surround(got, ref, tag)
        failures += [f"surround_fused {tag}: {e}" for e in errs]
        if B == B_MAIN:
            main_err = max(main_err, err)
        del args, got, ref
    return main_err, failures


def surround_readout_diff(out, out_c):
    """(level/peak dB difference, correlation difference) of the card's
    streams 0-3 against the CPU run."""
    d_db = max(level_db_diff(out[k][:4].cpu(), out_c[k]) for k in ("level", "peak"))
    d_cor = (out["correlation"][:4].cpu() - out_c["correlation"]).abs().max().item()
    return d_db, d_cor


def surround_main(dev, blocks3, reset_counts):
    """surround5 and surround8, created and initialised with no device
    argument, over the 12 main-path blocks (channels derived on the card)
    at B=256, then on streams 0-3 in 1000-sample blocks with the pairs
    re-routed on the card mid-stream; launches checked, streams 0-3 held
    against CPU runs.  Returns the launches of the runs."""
    import torch

    import meters_lv2_torch
    from meters_lv2_torch.ops import (
        ballistics_core, bitmeter_stats, r128_fused, spectrum_fused, surround_fused,
        truepeak_fused)

    def others():
        return (r128_fused.launch_count, ballistics_core.launch_count,
                truepeak_fused.launch_count, bitmeter_stats.launch_count,
                spectrum_fused.launch_count)

    pairs = [[0, 0], [1, 1], [0, 1], [2, 3]]
    launches = 0
    for name in ("surround5", "surround8"):
        m = meters_lv2_torch.create(name, FS)
        C, P = m.nchan, m.npairs
        st = m.init((B_MAIN,))
        if not (st.zl.device.type == dev.type and st.km.z.device.type == dev.type):
            fail(f"main path {name}: init() without a device did not put the state on the card")
        xs = surround_blocks(C, [torch.as_tensor(b, device=dev) for b in blocks3])
        reset_counts()
        for xb in xs:
            st = m.update(st, xb)
        out, st = m.read(st)
        torch.cuda.synchronize()
        n = surround_fused.launch_count
        if n != len(xs) or any(others()):
            fail(f"main path {name}: surround_fused launches {n} (expected {len(xs)}), "
                 f"other kernels {others()}")
        launches += n
        for k, shape in (("level", (B_MAIN, C)), ("peak", (B_MAIN, C)),
                         ("correlation", (B_MAIN, P))):
            if out[k].shape != shape or not bool(torch.isfinite(out[k]).all()):
                fail(f"main path {name} readout {k} not finite of shape {shape}")
        st_c = m.init((4,), device="cpu")
        for xb in xs:
            st_c = m.update(st_c, xb[:4].cpu())
        out_c, _ = m.read(st_c)
        d_db, d_cor = surround_readout_diff(out, out_c)
        if not (d_db < STATS_TOL_DB and d_cor < COR_TOL):
            fail(f"main path {name}: card vs CPU level/peak {d_db} dB, correlation {d_cor}")
        print(f"phase main: ok: {name} {len(xs)} x 1 s blocks at B={B_MAIN} (channels derived "
              f"on the card), state on {st.zl.device}, surround_fused launches {n}; level[0, 0] "
              f"{out['level'][0, 0].item():.6f}, correlation[0] "
              f"{[round(v, 6) for v in out['correlation'][0].tolist()]}; streams 0-3 vs CPU: "
              f"level/peak {d_db:.3g} dB, correlation {d_cor:.3g}")

        # 1000-sample blocks: an 896-sample bulk through the kernel and a
        # 104-sample tail through the plain ops per update; runtime pairs
        # on the card from block 20, back to the default pairs from 36
        x4 = xs[0][:4]
        x4_c = x4.cpu()
        st, st_c = m.init((4,)), m.init((4,), device="cpu")
        pr = torch.tensor(pairs, dtype=torch.float32, device=dev)
        reset_counts()
        for i in range(FS // 1000):
            p = 20 <= i < 36
            sl = slice(i * 1000, (i + 1) * 1000)
            st = m.update(st, x4[..., sl], pr if p else None)
            st_c = m.update(st_c, x4_c[..., sl], pairs if p else None)
            if i == 35:
                out, _ = m.read(st)
                out_c, _ = m.read(st_c)
                d_mid = surround_readout_diff(out, out_c)
        out, _ = m.read(st)
        torch.cuda.synchronize()
        n = surround_fused.launch_count
        if n != FS // 1000 or any(others()):
            fail(f"{name} 1000-sample blocks: surround_fused launches {n}, others {others()}")
        launches += n
        out_c, _ = m.read(st_c)
        d_db, d_cor = surround_readout_diff(out, out_c)
        if not (max(d_db, d_mid[0]) < STATS_TOL_DB and max(d_cor, d_mid[1]) < COR_TOL):
            fail(f"{name} 1000-sample blocks: card vs CPU level/peak {d_db} / {d_mid[0]} dB, "
                 f"correlation {d_cor} / {d_mid[1]}")
        print(f"phase main: ok: {name} {FS // 1000} x 1000-sample blocks (104-sample tail) on "
              f"streams 0-3, pairs 0:0 1:1 0:1 2:3 for blocks 20-35; surround_fused launches {n}; "
              f"vs CPU after block 35: {d_mid[0]:.3g} dB, correlation {d_mid[1]:.3g}; at the "
              f"end: {d_db:.3g} dB, correlation {d_cor:.3g}")
        del xs
    return launches


def surround_golden(dev):
    """The four surround fixtures streamed whole on ``dev``."""
    import test_torch_golden_surround as gsur

    gw = []
    for prefix in gsur.PREFIXES:
        try:
            worst_db, worst_cor, n = gsur.run_surround(prefix, device=dev)
        except AssertionError as e:
            fail(f"golden {prefix}: {e}")
        gw.append(f"{prefix}_mix {n} values, level/peak worst {worst_db:.3g} dB, correlation "
                  f"worst {worst_cor:.3g}")
    print(f"phase golden: ok: surround fixtures, whole: {'; '.join(gw)}")


# the __global__ functions of meters_lv2_torch/csrc, as the profiler names them
PORT_KERNELS = ("r128_fused_kernel", "ballistics_kernel", "ballistics_env_kernel",
                "truepeak_fused_kernel", "bitmeter_stats_kernel", "spectrum_fused_kernel",
                "surround_fused_kernel", "stft_fused_kernel")


def device_us_per_update(m, st, xs, n=10):
    """torch.profiler over n updates of meter m: (device µs per update, of
    it the hand-written kernels' µs).  Device-side events only: an aten
    op's own row repeats its kernels' time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            st = m.update(st, xs[i % len(xs)])
        torch.cuda.synchronize()
    dev_us = [(e.key, e.self_device_time_total) for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    total = sum(t for _, t in dev_us)
    kern = sum(t for k, t in dev_us if any(name in k for name in PORT_KERNELS))
    return total / n, kern / n


def stats_profile(m, st, xs, enqueue, n, profiled):
    """The host's enqueue ms per update of the timed runs and, when
    ``profiled``, torch.profiler's device time per update and the
    hand-written kernels' share of it: the text for a phase times line."""
    text = f"host enqueue {[round(e / n * 1e3, 3) for e in enqueue]} ms per update"
    if profiled:
        dev_us, kern_us = device_us_per_update(m, st, xs)
        text += (f"; torch.profiler: device time {dev_us:.1f} us per update, hand-written "
                 f"kernels {kern_us:.1f} us ({100 * kern_us / dev_us:.1f} %)")
    return text


def surround_times(dev, blocks3, gpu):
    """surround_fused against its plain version at B=256 T=48000 for C=5
    and C=8 (plain, kernel, kernel, plain; one call at a time, as the other
    kernels are timed), and for surround5 and surround8 the x-realtime over
    60 blocks at B=256, the host's time to enqueue an update and the device
    time of one (torch.profiler).  Returns {C: (kernel ms, plain ms)}."""
    import torch

    import meters_lv2_torch
    from meters_lv2_torch.ops import surround_fused

    ms = {}
    for C in (5, 8):
        args = surround_args(C, B_MAIN, FS, 7, dev)
        ms_k, ms_p = [], []
        for w in "pkkp":
            if w == "k":
                ms_k.append(cuda_ms(lambda: surround_fused.fused_core(*args), 10))
            else:
                ms_p.append(cuda_ms(lambda: surround_fused.fused_core_reference(*args), 3))
        ms[C] = (statistics.mean(ms_k), statistics.mean(ms_p))
        print(f"phase times: surround_fused kernel {ms[C][0]:.4f} ms (medians {ms_k}), plain "
              f"version {ms[C][1]:.4f} ms (medians {ms_p}) at B={B_MAIN} C={C} P=4 T={FS} [{gpu}]")
        del args
    for name in ("surround5", "surround8"):
        m = meters_lv2_torch.create(name, FS)
        xs = surround_blocks(m.nchan, [torch.as_tensor(b, device=dev) for b in blocks3])
        runs, enqueue = [], []
        for _ in range(2):
            st = m.update(m.init((B_MAIN,)), xs[0])  # warm
            st = m.init((B_MAIN,))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(N_STATS):
                st = m.update(st, xs[i % len(xs)])
            enqueue.append(time.perf_counter() - t0)
            out, _ = m.read(st)
            torch.cuda.synchronize()
            [v.cpu() for v in out.values()]
            runs.append(time.perf_counter() - t0)
        dev_us, kern_us = device_us_per_update(m, st, xs)
        print(f"phase times: {name} {B_MAIN * N_STATS / min(runs):.1f} x-realtime (best of "
              f"{len(runs)}: {[round(r, 4) for r in runs]} s for {N_STATS} x 1 s blocks at "
              f"B={B_MAIN}, {min(runs) / N_STATS * 1e3:.3f} ms per update); host enqueue "
              f"{[round(e / N_STATS * 1e3, 3) for e in enqueue]} ms per update; torch.profiler: "
              f"device time {dev_us:.1f} us per update, surround_fused {kern_us:.1f} us "
              f"({100 * kern_us / dev_us:.1f} %) [{gpu}]")
        del xs
    return ms


ANA_W, ANA_HOP = 8192, 1920  # the analyzers' native window and hop at 48 kHz
ANA_F = FS // ANA_HOP  # frames per 1 s update (25)
ANA_THR = 1e-6  # the phase wheel's -60 dB power threshold
N_ANA = 60  # blocks of the analyzers' x-realtime


def stft_bound(B, W, F, hop):
    """(bytes, fp32 operations) of the stft_fused function in the phase
    wheel's mode: the (F - 1) hop + W samples of ext that the frames cover
    read once (frame f starts at hop (f + 1), so the first hop of ext is
    never read), the window and twiddles once, dphi and level written once;
    per channel-frame the window multiply (W) and a real FFT (2.5 W log2 W,
    the usual count), per bin and channel the power (3), and per output bin the analysis (2 atan2 of ~20 operations, 2
    compares, a subtraction, a max and 2 selects: 46)."""
    D = W // 2
    nbytes = 4 * (B * 2 * ((F - 1) * hop + W) + W + 2 * D + 2 * B * F * D)
    flops = B * F * (2 * (W + 2.5 * W * math.log2(W) + 3 * D) + 46 * D)
    return nbytes, flops


def stft_kernel_cases(dev):
    """stft_fused against its plain version: all three modes at the main-path
    shape [256, 2, 56192] (W=8192, hop 1920, F=25), and at W=256 hop 1764
    (the 44.1 kHz golden geometry), raw mode also against torch.fft.rfft of
    the windowed frames, and a NaN in one stream's left channel with +Inf in
    another stream's right channel.  Returns (max abs re/im error of the
    raw mode at the main-path shape, breaches)."""
    import torch

    from meters_lv2_torch.ops import fft, stft_fused
    from test_torch_cuda import stft_close, stft_inputs

    failures, main_err = [], 0.0
    for tag, W, hop, B, F, nonfinite in [
        (f"main-path shape B={B_MAIN} W={ANA_W} hop {ANA_HOP} F={ANA_F}", ANA_W, ANA_HOP,
         B_MAIN, ANA_F, False),
        ("W=256 hop 1764 B=4 F=5", 256, 1764, 4, 5, False),
        ("NaN (stream 1 left) and +Inf (stream 2 right) W=8192 B=3 F=3", ANA_W, ANA_HOP, 3, 3,
         True),
    ]:
        ext, win, skip = stft_inputs(B, W, hop, F, W + B, dev, nonfinite)
        raw = stft_fused.plain_frames(ext, win, hop, "raw", 0.0)
        parts = []
        for mode in ("raw", "phasewheel", "stereoscope"):
            thr = ANA_THR if mode == "phasewheel" else 1e-20
            got = stft_fused.analyzer_frames(ext, win, hop, mode, thr)
            ref = raw if mode == "raw" else stft_fused.plain_frames(ext, win, hop, mode, thr)
            torch.cuda.synchronize()
            err, errs = stft_close(got, ref, raw, mode, thr, skip)
            failures += [f"stft_fused {tag} {mode}: {e}" for e in errs]
            parts.append(f"{mode} err {err:.3g}")
            if mode == "raw":
                # the library transform itself, with no epilogue in between
                X = torch.fft.rfft(fft.frames_of(ext, W, hop) * win, dim=-1)[..., : W // 2]
                lib = (X.real.contiguous(), X.imag.contiguous())
                lerr, errs = stft_close(got, lib, lib, "raw", thr, skip)
                failures += [f"stft_fused {tag} raw vs torch.fft.rfft: {e}" for e in errs]
                parts.append(f"raw vs torch.fft.rfft err {lerr:.3g}")
                if B == B_MAIN:
                    main_err = err
            del got, ref
        print(f"  stft_fused {tag}: {'; '.join(parts)}: "
              f"{'ok' if not any(tag in f for f in failures) else 'FAIL'}")
        del ext, raw
    return main_err, failures


def analyzer_diff(name, out, out_c, raw_c=None):
    """Card streams 0-3 against the CPU run: the phase wheel's per-frame
    (dphi, level) as tests/test_torch_cuda.py::stft_close holds stft_fused
    (``raw_c``: the CPU run's raw transform of those frames, for the bars),
    its peak within 2e-4 relative and its correlation within 1e-5; the
    stereoscope's smoothed level within 2e-4 relative plus 1e-8 of its
    peak and lr within 1e-4 on bins above 1e-6 of it; the goniometer's x
    and y within 1e-5 of their peak and its gain within 1e-5 relative.
    Returns ({readout: worst error}, breaches)."""
    import torch
    from test_torch_cuda import stft_close

    def mx(t):
        return t.max().item() if t.numel() else 0.0

    w, errs = {}, []
    if name == "goniometer":
        for k in ("x", "y"):
            a, b = out[k][:4].cpu().double(), out_c[k].double()
            w[k] = mx((a - b).abs()) / b.abs().max().item()
        w["gain"] = mx((out["gain"][:4].cpu() - out_c["gain"]).abs() / out_c["gain"].abs())
        errs += [f"{k} {v:.3g} relative" for k, v in w.items() if v > 1e-5]
    elif name == "phasewheel":
        got = (out["phase"][:4].cpu(), out["level"][:4].cpu())
        w["frames"], e = stft_close(got, (out_c["phase"], out_c["level"]), raw_c, "phasewheel",
                                    ANA_THR)
        errs += e
        w["peak"] = mx((out["peak"][:4].cpu() - out_c["peak"]).abs() / out_c["peak"])
        w["correlation"] = mx((out["correlation"][:4].cpu() - out_c["correlation"]).abs())
        errs += [f"{k} {w[k]:.3g}" for k, tol in (("peak", 2e-4), ("correlation", 1e-5))
                 if w[k] > tol]
    else:
        lv, lc = out["level"][:4].cpu().double(), out_c["level"].double()
        pk = torch.where(torch.isfinite(lc), lc, 0.0).abs().amax(-1, keepdim=True)
        if bool(((lv - lc).abs() > 2e-4 * lc.abs() + 1e-8 * pk).any()):
            errs.append("level off the power bar")
        w["level"] = mx((lv - lc).abs() / lc.abs().clamp_min(1e-30))
        big = lc > 1e-6 * pk
        w["lr"] = mx((out["lr"][:4].cpu() - out_c["lr"]).abs()[big])
        if w["lr"] > 1e-4:
            errs.append(f"lr {w['lr']:.3g}")
    return w, errs


def analyzers_main(dev, blocks3, reset_counts, launches_of):
    """phasewheel, stereoscope and goniometer, created and initialised with
    no device argument, over the 12 main-path blocks at B=256: stft_fused
    launched once per phase wheel and stereoscope update and no other kernel,
    every readout finite of its shape, streams 0-3 of every update held
    against the same meter on CPU tensors.  Returns the stft_fused launches."""
    import torch

    import meters_lv2_torch
    from meters_lv2_torch.ops import stft_fused

    D = ANA_W // 2
    shapes = {
        "phasewheel": {"phase": (B_MAIN, ANA_F, D), "level": (B_MAIN, ANA_F, D),
                       "peak": (B_MAIN,), "correlation": (B_MAIN,)},
        "stereoscope": {"lr": (B_MAIN, D), "level": (B_MAIN, D)},
        "goniometer": {"x": (B_MAIN, 4 * FS), "y": (B_MAIN, 4 * FS), "gain": (B_MAIN,)},
    }
    launches = 0
    for name in ("phasewheel", "stereoscope", "goniometer"):
        m = meters_lv2_torch.create(name, FS)
        st = m.init((B_MAIN,))
        if not all(t.is_cuda for t in state_tensors(st)):
            fail(f"main path {name}: init() without a device did not put the state on the card")
        st_c = m.init((4,), device="cpu")
        xs = [torch.as_tensor(b, device=dev) for b in blocks3]
        worst = {}
        n = others = 0
        for i, (xb, xc) in enumerate(zip(xs, blocks3)):
            reset_counts()
            out, st = m.process(st, xb)
            torch.cuda.synchronize()
            n += stft_fused.launch_count
            others += sum(launches_of()) - stft_fused.launch_count
            for k, shape in shapes[name].items():
                v = out[k]
                if tuple(v.shape) != shape or not bool(torch.isfinite(v).all()):
                    fail(f"main path {name} readout {k} not finite of shape {shape}")
            x4 = torch.as_tensor(xc[:4])
            raw_c = None
            if name == "phasewheel":
                raw_c = stft_fused.plain_frames(torch.cat([st_c.stft.tail, x4], -1),
                                                m.stft.win("cpu"), ANA_HOP, "raw", 0.0)
            out_c, st_c = m.process(st_c, x4)
            diffs, errs = analyzer_diff(name, out, out_c, raw_c)
            if errs:
                fail(f"main path {name} block {i}: card vs CPU: {'; '.join(errs)}")
            for k, v in diffs.items():
                worst[k] = max(worst.get(k, 0.0), v)
        want = 0 if name == "goniometer" else len(xs)
        if n != want or others:
            fail(f"main path {name}: stft_fused launches {n} (expected {want}), other kernels "
                 f"{others}")
        launches += n
        first = ", ".join(f"{k}[0] {out[k].reshape(B_MAIN, -1)[0, -1].item():.6g}"
                          for k in shapes[name])
        print(f"phase main: ok: {name} {len(xs)} x 1 s blocks at B={B_MAIN}, state on the card, "
              f"stft_fused launches {n}; {first}; streams 0-3 of every update vs CPU within "
              f"the bars, worst: " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
        del xs, out, st
    return launches


def analyzers_golden(dev):
    """The 14 analyzer fixtures streamed whole on ``dev``."""
    import test_torch_golden_analyzers as gana

    gw = []
    for name in gana.FIXTURES:
        try:
            gw.append(gana.run_fixture(name, device=dev))
        except AssertionError as e:
            fail(f"golden {name}: {e}")
    print(f"phase golden: ok: analyzer fixtures (STFT on torch.fft.rfft, the phase wheel and "
          f"stereoscope through stft_fused at W=256), whole: {'; '.join(gw)}")


def analyzers_times(dev, blocks3, gpu):
    """stft_fused against its plain version at the main-path shape in the
    phase wheel's mode (plain, kernel, kernel, plain, one call at a time),
    the stereoscope and raw modes once each, the library call
    torch.fft.rfft on the windowed frames (the transform alone: no
    framing, window or epilogue), and each analyzer's x-realtime over
    N_ANA blocks at B=256, with its host enqueue time and device time per
    update (torch.profiler).  Returns (kernel ms, plain
    ms, library ms)."""
    import torch

    import meters_lv2_torch
    from meters_lv2_torch.ops import fft, stft_fused
    from test_torch_cuda import stft_inputs

    ext, win, _ = stft_inputs(B_MAIN, ANA_W, ANA_HOP, ANA_F, 17, dev)
    ms_k, ms_p = [], []
    for w in "pkkp":
        if w == "k":
            ms_k.append(cuda_ms(lambda: stft_fused.analyzer_frames(
                ext, win, ANA_HOP, "phasewheel", ANA_THR), 10))
        else:
            ms_p.append(cuda_ms(lambda: stft_fused.plain_frames(
                ext, win, ANA_HOP, "phasewheel", ANA_THR), 5))
    other = {mode: cuda_ms(lambda: stft_fused.analyzer_frames(ext, win, ANA_HOP, mode, 1e-20), 10)
             for mode in ("stereoscope", "raw")}
    frames = (fft.frames_of(ext, ANA_W, ANA_HOP) * win).contiguous()
    ms_lib = cuda_ms(lambda: torch.fft.rfft(frames, dim=-1), 10)
    del frames
    ms = (statistics.mean(ms_k), statistics.mean(ms_p), ms_lib)
    print(f"phase times: stft_fused kernel {ms[0]:.4f} ms (phasewheel mode; medians {ms_k}), "
          f"stereoscope mode {other['stereoscope']:.4f} ms, raw mode {other['raw']:.4f} ms; plain "
          f"version {ms[1]:.4f} ms (medians {ms_p}); torch.fft.rfft of the windowed frames alone "
          f"{ms_lib:.4f} ms, at B={B_MAIN} W={ANA_W} hop {ANA_HOP} F={ANA_F} [{gpu}]")
    del ext
    for name in ("phasewheel", "stereoscope", "goniometer"):
        m = meters_lv2_torch.create(name, FS)
        xs = [torch.as_tensor(b, device=dev) for b in blocks3]
        runs, enqueue = [], []
        for _ in range(2):
            _, st = m.process(m.init((B_MAIN,)), xs[0])  # warm
            st = m.init((B_MAIN,))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(N_ANA):
                out, st = m.process(st, xs[i % len(xs)])
            enqueue.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            [v.cpu() for v in out.values()]
            runs.append(time.perf_counter() - t0)
        line = (f"phase times: {name} {B_MAIN * N_ANA / min(runs):.1f} x-realtime (best of "
                f"{len(runs)}: {[round(r, 4) for r in runs]} s for {N_ANA} x 1 s blocks at "
                f"B={B_MAIN}, {min(runs) / N_ANA * 1e3:.3f} ms per update)")
        dev_us, kern_us = device_us_per_update(ProcessAsUpdate(m), st, xs)
        line += (f"; host enqueue {[round(e / N_ANA * 1e3, 3) for e in enqueue]} ms per "
                 f"update; torch.profiler: device time {dev_us:.1f} us per update, "
                 f"hand-written kernels {kern_us:.1f} us ({100 * kern_us / dev_us:.1f} %)")
        print(f"{line} [{gpu}]")
        del xs
    return ms


# -- the ballistics envelope body (the PPM meters' default) and the
# variants: R128 seg mode and the surround wide layout.  The wide switch is
# unset for every default path; env_set turns it on for a phase.
WIDE_VAR = "METERS_TORCH_SURROUND_WIDE"
# envelope: bit-exact to its plain version (the same fp32 operations in its
# order, none contracted); against the serial kernel z1, z2 and m within
# ENV_RTOL relative plus ENV_ATOL (tests/test_ballistics_envelope.py), p
# exact, the same NaN and Inf values (a NaN and a +Inf in one group give
# the serial body's +Inf)
ENV_RTOL, ENV_ATOL = 2e-6, 1e-7
# seg mode: seg within SEG_RTOL relative plus SEG_ATOL of its plain version
# (the full-rate plain version, then segment.shifted_segments) and of the
# same kernel's full-rate p through shifted_segments (tests/
# test_pallas_r128_fused.py:262); z, hist and tpmax bit-identical to the
# full-rate mode.  The slot sums add 128-sample block sums in another order
# than torch.sum over a fragment: a few ulp of the sum.
SEG_RTOL, SEG_ATOL = 2e-6, 1e-9
# the R128 meter's fragment at 48 kHz and its slots for a 1 s block
FRAGM = FS // 20
N_SLOTS = FS // FRAGM + 2


@contextlib.contextmanager
def env_set(name, value="1"):
    """Set the environment variable ``name`` for the body of the block."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def compare_envelope(got, ref, serial, tag):
    """One envelope call: bit-exact to its plain version ``ref``, within
    ENV_RTOL / ENV_ATOL of the serial kernel (p exact, the same non-finite
    values).  Prints the max abs error vs the serial kernel; returns the
    breaches."""
    import torch

    names = ("z1", "z2", "m", "p")
    errs = [f"{n} not bit-exact to the plain version"
            for n, a, b in zip(names, got, ref) if not same_bits(a, b)]
    err = 0.0
    for k, (n, a, b) in enumerate(zip(names, got, serial)):
        if not same_nonfinite(a, b):
            errs.append(f"{n} non-finite values differ from the serial kernel's")
        f = torch.isfinite(b)
        d = (a - b).abs()[f]
        if d.numel():
            err = max(err, d.max().item())
            bar = 0.0 if k == 3 else ENV_RTOL * b.abs()[f] + ENV_ATOL
            if bool((d > bar).any()):
                errs.append(f"{n} vs the serial kernel: err {d.max().item():.3g}")
    print(f"  ballistics envelope {tag}: bit-exact to the plain version "
          f"{not any('bit-exact' in e for e in errs)}, max abs err vs the serial kernel "
          f"{err:.3g}: {'ok' if not errs else 'FAIL ' + '; '.join(errs)}")
    return errs


def envelope_kernel_cases(dev, w):
    """The envelope kernel against its plain version and the serial kernel:
    the main-path shape N=512 T=48000 with and without track_peak (4 rows a
    CTA), adversarial rows (silence, a spike, NaN, +Inf first and second in
    its group, a NaN and a +Inf in one group in both orders, a NaN carried
    max), and 600 rows (16 rows a CTA, the last CTA partial) of T=1000 (a
    partial last block) with NaN and +-Inf at the edges of blocks and
    groups and a NaN carried z1.  Returns (max abs error vs the plain
    version at the main-path shape (0.0: bit-exact), the plain version's ms
    of one main-path call, breaches)."""
    import torch

    from meters_lv2_torch.ops import ballistics_core

    rng = np.random.default_rng(9)
    N, T = 2 * B_MAIN, FS
    t = np.abs(0.3 * rng.standard_normal((N, T))).astype(np.float32)
    st = [np.abs(0.3 * rng.standard_normal(N)).astype(np.float32) for _ in range(4)]
    ta = np.abs(rng.standard_normal((8, 1024))).astype(np.float32)
    ta[0, 32:512] = 0.0
    ta[1, 77] = 50.0
    ta[2, 10] = np.nan
    ta[3, ::7] = np.nan
    ta[4, 100], ta[5, 101] = np.inf, np.inf
    ta[6, 40], ta[6, 41] = np.nan, np.inf
    ta[7, 40], ta[7, 42] = np.inf, np.nan
    sta = [np.abs(0.3 * rng.standard_normal(8)).astype(np.float32) for _ in range(4)]
    sta[2][0] = np.nan
    te = np.abs(0.3 * rng.standard_normal((600, 1000))).astype(np.float32)
    for r, i, v in [(0, 127, np.nan), (1, 128, np.inf), (2, 255, -np.inf), (3, 256, np.nan),
                    (4, 43, np.inf), (5, 44, np.nan), (6, 996, np.inf), (7, 999, np.nan),
                    (599, 0, np.inf), (598, 1, np.inf)]:
        te[r, i] = v
    ste = [np.abs(0.3 * rng.standard_normal(600)).astype(np.float32) for _ in range(4)]
    ste[0][9] = np.nan
    failures, main_err, plain_ms = [], 0.0, None
    for tag, tt, s, tp in [
        (f"main-path shape N={N} T={T} track_peak=False", t, st, False),
        (f"main-path shape N={N} T={T} track_peak=True", t, st, True),
        ("adversarial rows N=8 T=1024 track_peak=True", ta, sta, True),
        ("edges of blocks and groups N=600 T=1000 track_peak=True", te, ste, True),
    ]:
        args = [torch.as_tensor(a, device=dev) for a in [tt, *s]]
        got = ballistics_core.ballistics(*args, **w, track_peak=tp, envelope=True)
        serial = ballistics_core.ballistics(*args, **w, track_peak=tp)
        ref, ms = timed_call(lambda: ballistics_core.ballistics_envelope_reference(
            *args, **w, track_peak=tp))
        errs = compare_envelope(got, ref, serial, tag)
        failures += [f"ballistics envelope {tag}: {e}" for e in errs]
        if tt is t:
            main_err = max([main_err] + [finite_err(a, b) for a, b in zip(got, ref)])
            if not tp:
                plain_ms = ms
        elif tt is ta and not all(bool(torch.isposinf(v[5:]).all()) for v in got[:3]):
            failures.append("ballistics envelope: rows 5-7 (+Inf, NaN with +Inf) not +Inf")
    return main_err, plain_ms, failures


def seg_kernel_cases(dev):
    """r128_fused in seg mode at [256, 2, 48000] with random offsets, at
    48 kHz (fragm 2400) and 44.1 kHz (fragm 2205, the 44.1 kHz K-weighting),
    and with NaN / +Inf samples at B=4 T=2560: against its plain version and
    against the same kernel's full-rate mode.  Returns (max abs error of seg
    vs the plain version at 48 kHz, the plain version's ms there, breaches)."""
    import torch

    from meters_lv2_torch.ops import design, lti, r128_fused, segment

    rng = np.random.default_rng(12)
    failures, main_err, plain_ms = [], 0.0, None
    for tag, fs, B, T, inject in [
        (f"main-path shape B={B_MAIN} C=2 T={FS} fragm 2400", 48000, B_MAIN, FS, False),
        (f"B={B_MAIN} C=2 T={FS} fragm 2205 (44.1 kHz)", 44100, B_MAIN, FS, False),
        ("NaN/+Inf in x, B=4 C=2 T=2560 fragm 2400", 48000, 4, 2560, True),
    ]:
        x = (0.3 * rng.standard_normal((B, 2, T))).astype(np.float32)
        if inject:
            x[0, 0, 300], x[1, 1, 2500] = np.nan, np.inf
        z0 = (0.01 * rng.standard_normal((B, 2, 4))).astype(np.float32)
        h0 = (0.1 * rng.standard_normal((B, 2, 47))).astype(np.float32)
        xd, zd, hd = (torch.as_tensor(a, device=dev) for a in (x, z0, h0))
        fragm = fs // 20
        off = torch.as_tensor(rng.integers(0, fragm, B).astype(np.int32), device=dev)
        kw = dict(off=off, fragm=fragm, n_slots=T // fragm + 2)
        op = lti.LTISystem(*design.k_weighting_state_space(fs)).op(128)
        gains = (1.0, 1.0)
        got = r128_fused.fused_core(xd, zd, hd, gains, op, **kw)
        full = r128_fused.fused_core(xd, zd, hd, gains, op)
        ref, ms = timed_call(lambda: r128_fused.fused_core_reference(xd, zd, hd, gains, op, **kw))
        via_full = segment.shifted_segments(full[0], off, fragm, kw["n_slots"], "sum")
        errs = [f"{n} not bit-identical to the full-rate mode"
                for n, a, b in zip(("z", "hist", "tpmax"), got[1:], full[1:]) if not same_bits(a, b)]
        seg = got[0].double()
        parts = []
        for what, b in (("plain version", ref[0]), ("full-rate kernel + shifted_segments", via_full)):
            b = b.double()
            if not same_nonfinite(seg, b):
                errs.append(f"seg non-finite values differ from the {what}'s")
            f = torch.isfinite(b)
            d = (seg - b).abs()[f]
            e = d.max().item() if d.numel() else 0.0
            if d.numel() and bool((d > SEG_RTOL * b.abs()[f] + SEG_ATOL).any()):
                errs.append(f"seg vs the {what}: err {e:.3g}")
            parts.append(f"vs the {what} {e:.3g} (max seg {b.abs()[f].max().item():.4g})")
            if what == "plain version" and B == B_MAIN and fs == 48000:
                main_err, plain_ms = e, ms
        print(f"  r128_fused seg mode {tag}: seg max abs err {', '.join(parts)}; z, hist, tpmax "
              f"bit-identical to full rate {not any('full-rate' in e for e in errs)}: "
              f"{'ok' if not errs else 'FAIL ' + '; '.join(errs)}")
        failures += [f"r128_fused seg mode {tag}: {e}" for e in errs]
    return main_err, plain_ms, failures


def wide_kernel_cases(dev):
    """surround_fused's wide layout against its plain version and against the
    narrow kernel at the narrow kernel's bars (km_z, zl and pk bit-identical to
    the narrow kernel: the same operations), at C=5 and C=8 with B=256
    T=48000, with runtime pairs, and with NaN / +Inf / -Inf samples.
    Returns (max abs error vs the plain version at C=8, B=256, breaches)."""
    from meters_lv2_torch.ops import surround_fused

    failures, main_err = [], 0.0
    for tag, C, B, T, pairs, inject in [
        (f"main-path shape B={B_MAIN} C=5 T={FS}", 5, B_MAIN, FS, None, False),
        (f"main-path shape B={B_MAIN} C=8 T={FS}", 8, B_MAIN, FS, None, False),
        ("B=5 C=5 T=1280, pairs 0:0 1:1 0:1 2:3", 5, 5, 1280, [[0, 0], [1, 1], [0, 1], [2, 3]],
         False),
        ("NaN/+Inf/-Inf in x, B=5 C=5 T=1280", 5, 5, 1280, None, True),
        ("NaN/+Inf/-Inf in x, B=5 C=8 T=1280", 8, 5, 1280, None, True),
    ]:
        args = surround_args(C, B, T, B + C + 1, dev, pairs, inject)
        got = surround_fused.fused_core_wide(*args)
        narrow = surround_fused.fused_core(*args)
        ref = surround_fused.fused_core_reference(*args)
        err, errs = compare_surround(got, ref, f"wide vs plain version, {tag}")
        _, errs_n = compare_surround(got, narrow, f"wide vs narrow kernel, {tag}")
        errs += errs_n
        if not all(same_bits(a, b) for a, b in zip(got[:3], narrow[:3])):
            errs.append("km_z, zl, pk not bit-identical to the narrow kernel")
        failures += [f"surround_fused wide {tag}: {e}" for e in errs]
        if B == B_MAIN and C == 8:
            main_err = err
        del args, got, narrow, ref
    return main_err, failures


def variants_main(dev, blocks_dev, reset_counts, all_counts):
    """The main path with each variant on: R128's fragment sums in seg mode
    (fused_core with the carried state and offset over the 12 blocks), held
    against the full-rate kernel and shifted_segments; surround5 and
    surround8 over the 12 blocks in the wide layout, held against the
    narrow run.  Launch counts checked.  Returns (seg, wide) launches."""
    import torch

    import meters_lv2_torch
    from meters_lv2_torch.ops import r128_fused, segment, surround_fused

    def run(m, init, xs, var, flag):
        with env_set(var, flag):
            st = init()
            reset_counts()
            for xb in xs:
                st = m.update(st, xb)
            out = readouts(m.read(st)[0])
            torch.cuda.synchronize()
        return out, all_counts()

    wide_launches = 0
    # R128's fragment sums in seg mode, the stream's state carried block to block
    meter = meters_lv2_torch.create("EBUr128", FS, nchan=2)
    op, gains = meter.sys.op(128), meter.gains
    off0 = torch.as_tensor(np.random.default_rng(5).integers(0, FRAGM, B_MAIN).astype(np.int32),
                           device=dev)
    z0 = torch.zeros((B_MAIN, 2, 4), device=dev)
    h0 = torch.zeros((B_MAIN, 2, 47), device=dev)
    reset_counts()
    off, z, h, segs = off0, z0, h0, []
    for xb in blocks_dev:
        seg, z, h, tpm = r128_fused.fused_core(xb, z, h, gains, op, off=off, fragm=FRAGM,
                                               n_slots=N_SLOTS)
        segs.append((seg, z, h, tpm))
        off = (off + FS) % FRAGM
    torch.cuda.synchronize()
    seg_launches, cnt = r128_fused.seg_launch_count, all_counts()
    if seg_launches != len(blocks_dev) or sum(cnt) != seg_launches:
        fail(f"main path R128 seg mode: seg launches {seg_launches}, other counts {cnt}")
    off, z, h, worst = off0, z0, h0, 0.0
    for xb, (seg, zs, hs, ts) in zip(blocks_dev, segs):
        p, z, h, tpm = r128_fused.fused_core(xb, z, h, gains, op)
        ref = segment.shifted_segments(p, off, FRAGM, N_SLOTS, "sum")
        off = (off + FS) % FRAGM
        if not (same_bits(zs, z) and same_bits(hs, h) and same_bits(ts, tpm)):
            fail("main path R128 seg mode: z, hist or tpmax not bit-identical to full rate")
        d = (seg - ref).abs()
        worst = max(worst, d.max().item())
        if not bool(torch.isfinite(seg).all()) or bool((d > SEG_RTOL * ref.abs() + SEG_ATOL).any()):
            fail(f"main path R128 seg mode: seg vs full rate + shifted_segments off by "
                 f"{d.max().item()}")
    print(f"phase main: ok: R128 fragment sums in seg mode, {len(blocks_dev)} x 1 s blocks at "
          f"B={B_MAIN} (fragm {FRAGM}, {N_SLOTS} slots, random offsets carried), seg launches "
          f"{seg_launches}; vs the full-rate kernel + shifted_segments: max abs err {worst:.3g}, "
          f"z / hist / tpmax bit-identical")

    for name in ("surround5", "surround8"):
        m = meters_lv2_torch.create(name, FS)
        xs = surround_blocks(m.nchan, blocks_dev)
        init = lambda: m.init((B_MAIN,))  # noqa: E731
        out_n, _ = run(m, init, xs, WIDE_VAR, "0")
        out_w, cnt = run(m, init, xs, WIDE_VAR, "1")
        n = surround_fused.wide_launch_count
        if n != len(xs) or sum(cnt) != n:
            fail(f"main path {name} wide: wide launches {n}, counts {cnt}")
        wide_launches += n
        for k, v in out_w.items():
            if not bool(torch.isfinite(v).all()):
                fail(f"main path {name} wide: readout {k} not finite")
        d_db = max(level_db_diff(out_w[k], out_n[k]) for k in ("level", "peak"))
        d_cor = (out_w["correlation"] - out_n["correlation"]).abs().max().item()
        if not (d_db < STATS_TOL_DB and d_cor < COR_TOL):
            fail(f"main path {name} wide vs narrow: {d_db} dB, correlation {d_cor}")
        print(f"phase main: ok: {name} {len(xs)} x 1 s blocks with {WIDE_VAR}=1, wide launches "
              f"{n} (narrow 0); vs the narrow run on the card: level/peak {d_db:.3g} dB, "
              f"correlation {d_cor:.3g}")
        del xs
    return seg_launches, wide_launches


def variants_golden(dev):
    """The four surround fixtures through the wide layout, on the card."""
    import test_torch_golden_surround as gsur

    from meters_lv2_torch.ops import surround_fused

    gw = []
    surround_fused.launch_count = surround_fused.wide_launch_count = 0
    with env_set(WIDE_VAR):
        for prefix in gsur.PREFIXES:
            try:
                worst_db, worst_cor, n = gsur.run_surround(prefix, device=dev)
            except AssertionError as e:
                fail(f"golden {prefix} wide: {e}")
            gw.append(f"{prefix}_mix {n} values, level/peak worst {worst_db:.3g} dB, "
                      f"correlation worst {worst_cor:.3g}")
    n_w, n_n = surround_fused.wide_launch_count, surround_fused.launch_count
    if not n_w or n_n:
        fail(f"golden surround wide: wide launches {n_w}, narrow {n_n}")
    print(f"phase golden: ok: surround fixtures, whole, with {WIDE_VAR}=1 ({n_w} wide launches, "
          f"0 narrow): {'; '.join(gw)}")


N_CARRIED = 60  # 1 s blocks carried through both bodies of ballistics and truepeak_fused,
# and through spectrum_fused
# the ballistics row sweep of phase times on 132 SMs: 4,224 rows (32 an SM),
# 8,448 (one wave of the envelope's 16-row CTAs, 4 an SM), 12,672 (one wave
# of the serial body's 32-row CTAs, 3 an SM) and 33,792 (waves of both)
BALLISTICS_ROWS = (4224, 8448, 12672, 33792)


def truepeak_carried(dev, blocks_dev, w_tp):
    """N_CARRIED x 1 s of the main-path blocks at N=512 rows through both
    truepeak_fused kernels, z1, z2 and the history carried and m, p
    restarted each call (as the meter runs it): the largest relative
    difference between the bodies of z1 and z2 after every call and of
    each call's m must stay within TPK_RTOL, with the same non-finite
    values and hist' bit-identical.  The envelope's rounding must not
    drift away from the serial chain's over a minute."""
    import torch

    from meters_lv2_torch.ops import truepeak_fused

    N = 2 * B_MAIN
    zero = torch.zeros(N, device=dev)
    carry = {b: (zero, zero, torch.zeros((N, 47), device=dev)) for b in truepeak_fused.BODIES}
    worst = {"z1": 0.0, "z2": 0.0, "m": 0.0}
    for i in range(N_CARRIED):
        x = blocks_dev[i % len(blocks_dev)].reshape(N, FS)
        out = {}
        for b in truepeak_fused.BODIES:
            z1, z2, h = carry[b]
            out[b] = truepeak_fused.truepeak_fused(x, h, z1, z2, zero, zero, **w_tp, body=b)
            carry[b] = (out[b][0], out[b][1], out[b][4])
        env, ser = out["envelope"], out["serial"]
        if not same_bits(env[4], ser[4]):
            fail(f"truepeak_fused carried, call {i}: hist' differs between the bodies")
        for name, a, b in zip(worst, env, ser):
            if not same_nonfinite(a, b):
                fail(f"truepeak_fused carried, call {i}: {name} non-finite values differ")
            f = torch.isfinite(b)
            d = (a - b).abs()[f]
            if d.numel():
                worst[name] = max(worst[name], (d / b.abs()[f].clamp_min(1e-30)).max().item())
    torch.cuda.synchronize()
    if not all(v <= TPK_RTOL for v in worst.values()):
        fail(f"truepeak_fused carried {N_CARRIED} s: envelope vs serial relative {worst}, "
             f"bar {TPK_RTOL}")
    print(f"phase main: ok: truepeak_fused {N_CARRIED} x 1 s carried through both bodies at "
          f"N={N} T={FS}: largest relative difference envelope vs serial " + ", ".join(
              f"{k} {v:.3g}" for k, v in worst.items()) + f" (bar {TPK_RTOL}); hist' identical")


def ballistics_carried(dev, blocks_dev, w_ppm):
    """N_CARRIED x 1 s of the main path's rectified blocks at N=512 rows
    through both ballistics kernels, z1 and z2 carried and m restarted each
    call (as the meter runs them): the largest relative difference between
    the envelope and the serial body of z1 and z2 after every call and of
    each call's m must stay within ENV_RTOL relative plus ENV_ATOL, with the
    same non-finite values.  The envelope's rounding must not drift away
    from the serial chain's over a minute."""
    import torch

    from meters_lv2_torch.ops import ballistics_core

    N = 2 * B_MAIN
    zero = torch.zeros(N, device=dev)
    carry = {env: (zero, zero) for env in (False, True)}
    worst = {"z1": 0.0, "z2": 0.0, "m": 0.0}
    breaches = []
    for i in range(N_CARRIED):
        t = blocks_dev[i % len(blocks_dev)].reshape(N, FS).abs()
        out = {}
        for env in (False, True):
            out[env] = ballistics_core.ballistics(t, *carry[env], zero, zero, **w_ppm,
                                                  track_peak=False, envelope=env)
            carry[env] = out[env][:2]
        for name, a, b in zip(worst, out[True], out[False]):
            if not same_nonfinite(a, b):
                fail(f"ballistics carried, call {i}: {name} non-finite values differ")
            f = torch.isfinite(b)
            d, ref = (a - b).abs()[f], b.abs()[f]
            if d.numel():
                worst[name] = max(worst[name], (d / ref.clamp_min(1e-30)).max().item())
                if bool((d > ENV_RTOL * ref + ENV_ATOL).any()):
                    breaches.append(f"call {i} {name} {d.max().item():.3g}")
    torch.cuda.synchronize()
    if breaches:
        fail(f"ballistics carried {N_CARRIED} s: envelope vs serial off the bar: {breaches[:5]}")
    print(f"phase main: ok: ballistics {N_CARRIED} x 1 s carried through both bodies at N={N} "
          f"T={FS}: largest relative difference envelope vs serial " + ", ".join(
              f"{k} {v:.3g}" for k, v in worst.items()) + f" (bar {ENV_RTOL} + {ENV_ATOL})")
    return worst


def fp32_pinned(dev, blocks3):
    """A caller's torch.set_float32_matmul_precision("high") reaches none of
    the port's products: K20stereo (LTI), COR, goniometer, phasewheel and
    surround5 over two 1 s blocks of 16 streams on the card equal the run at
    "highest" bit for bit, and the caller's setting comes back."""
    import torch

    import meters_lv2_torch

    xs = [torch.as_tensor(b[:16], device=dev) for b in blocks3[:2]]

    def run(name, kw, batch, call):
        m = meters_lv2_torch.create(name, FS, **kw)
        st = m.init(batch, device=dev)
        data = surround_blocks(m.nchan, xs) if name == "surround5" else xs
        out = None
        for xb in data:
            if call == "update":
                st = m.update(st, xb)
            else:
                out, st = m.process(st, xb)
        if call == "update":
            out = m.read(st)[0]
        out = readouts(out)
        torch.cuda.synchronize()
        return out

    meters = [("K20stereo", {}, (16, 2), "update"), ("COR", {}, (16,), "update"),
              ("goniometer", {"oversample": 4}, (16,), "process"),
              ("phasewheel", {}, (16,), "process"), ("surround5", {}, (16,), "update")]
    old = torch.get_float32_matmul_precision()
    try:
        want = [run(*m) for m in meters]
        torch.set_float32_matmul_precision("high")
        got = [run(*m) for m in meters]
        restored = torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(old)
    bad = [f"{m[0]} {k}" for m, g, w in zip(meters, got, want) for k in w
           if not same_bits(g[k], w[k])]
    if bad or not restored:
        fail(f"fp32 pinning: under 'high' not bit-identical to 'highest': {bad}; the caller's "
             f"setting restored {restored}")
    print("phase main: ok: under torch.set_float32_matmul_precision('high') "
          + ", ".join(m[0] for m in meters) + " (2 x 1 s, 16 streams) equal the 'highest' run "
          "bit for bit; the caller's setting restored")


def ballistics_body_times(dev, gpu, w_ppm, t_main):
    """The ballistics kernel's two bodies at T=48000 on t_main (the main
    path's N=512 rectified rows, 10 launches a median) and on 4,224 to
    33,792 rows of 0.3 U(0, 1) samples (5 a median), timed serial, envelope,
    envelope, serial; returns {N: (envelope ms, serial ms)}."""
    import torch

    from meters_lv2_torch.ops import ballistics_core

    gen = torch.Generator(device=dev).manual_seed(0)
    t_big = torch.rand((max(BALLISTICS_ROWS), FS), generator=gen, device=dev) * 0.3
    res = {}
    for N in (t_main.shape[0], *BALLISTICS_ROWS):
        t = t_main if N == t_main.shape[0] else t_big[:N]
        zs = [torch.zeros(N, device=dev) for _ in range(4)]
        ms = {False: [], True: []}
        for env in (False, True, True, False):
            ms[env].append(cuda_ms(lambda: ballistics_core.ballistics(
                t, *zs, **w_ppm, track_peak=False, envelope=env), 10 if t is t_main else 5))
        res[N] = (statistics.mean(ms[True]), statistics.mean(ms[False]))
        print(f"phase times: ballistics at N={N} T={FS}: envelope {res[N][0]:.4f} ms (medians "
              f"{ms[True]}), serial {res[N][1]:.4f} ms (medians {ms[False]}), alternated [{gpu}]")
    del t_big
    return res


def truepeak_body_times(dev, gpu, w_tp, x_main):
    """truepeak_fused's two bodies at T=48000 on x_main (the main path's
    N=512 rows) and on 8,192 rows of 0.1 N(0, 1) samples, timed serial,
    envelope, envelope, serial; returns {N: (envelope ms, serial ms)}."""
    import torch

    from meters_lv2_torch.ops import truepeak_fused

    gen = torch.Generator(device=dev).manual_seed(1)
    res = {}
    for N in (x_main.shape[0], 8192):
        x = x_main if N == x_main.shape[0] else torch.randn((N, FS), generator=gen, device=dev) * 0.1
        h = torch.zeros((N, 47), device=dev)
        zs = [torch.zeros(N, device=dev) for _ in range(4)]
        ms = {b: [] for b in truepeak_fused.BODIES}
        for body in ("serial", "envelope", "envelope", "serial"):
            ms[body].append(cuda_ms(lambda: truepeak_fused.truepeak_fused(
                x, h, *zs, **w_tp, body=body), 10))
        res[N] = (statistics.mean(ms["envelope"]), statistics.mean(ms["serial"]))
        print(f"phase times: truepeak_fused at N={N} T={FS}: envelope {res[N][0]:.4f} ms "
              f"(medians {ms['envelope']}), serial {res[N][1]:.4f} ms (medians {ms['serial']}), "
              f"alternated [{gpu}]")
        del x
    return res


def x_realtime(m, init, xs, n):
    """(x-realtime, per-update ms, run seconds) of n updates of meter m at
    B_MAIN streams over the blocks xs, best of two runs after a warm update;
    each run ends in a host copy of the readouts."""
    import torch

    runs = []
    for _ in range(2):
        st = m.update(init(), xs[0])  # warm
        st = init()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            st = m.update(st, xs[i % len(xs)])
        out, _ = m.read(st)
        torch.cuda.synchronize()
        [v.cpu() for v in readouts(out).values()]
        runs.append(time.perf_counter() - t0)
    return B_MAIN * n / min(runs), min(runs) / n * 1e3, [round(r, 4) for r in runs]


def variants_times(dev, blocks_dev, gpu, sur_plain):
    """The variants against their defaults in this call, alternating
    (default, variant, variant, default): seg mode against the full-rate
    kernel followed by shifted_segments, and its plain version, at [256, 2,
    48000]; the wide layout against the narrow one at C=5 and C=8 (the
    plain version's ms are the narrow phase's, the same function);
    surround5 and surround8 x-realtime with the wide layout on.  Returns
    {name: (ms, plain ms)} for the kernels JSON line."""
    import torch

    import meters_lv2_torch
    from meters_lv2_torch.ops import design, lti, r128_fused, segment, surround_fused

    out = {}
    rng = np.random.default_rng(13)
    x = torch.as_tensor((0.3 * rng.standard_normal((B_MAIN, 2, FS))).astype(np.float32),
                        device=dev)
    z0 = torch.zeros((B_MAIN, 2, 4), device=dev)
    h0 = torch.zeros((B_MAIN, 2, 47), device=dev)
    off = torch.as_tensor(rng.integers(0, FRAGM, B_MAIN).astype(np.int32), device=dev)
    op = lti.LTISystem(*design.k_weighting_state_space(FS)).op(128)
    kw = dict(off=off, fragm=FRAGM, n_slots=N_SLOTS)
    gains = (1.0, 1.0)

    def full_then_segments():
        p = r128_fused.fused_core(x, z0, h0, gains, op)[0]
        return segment.shifted_segments(p, off, FRAGM, N_SLOTS, "sum")

    seg_k, full_k, seg_p = [], [], []
    for w in "fssf":
        if w == "s":
            seg_k.append(cuda_ms(lambda: r128_fused.fused_core(x, z0, h0, gains, op, **kw), 10))
        else:
            full_k.append(cuda_ms(full_then_segments, 10))
    for _ in range(2):
        seg_p.append(cuda_ms(lambda: r128_fused.fused_core_reference(x, z0, h0, gains, op, **kw),
                             3))
    out["seg"] = (statistics.mean(seg_k), statistics.mean(seg_p))
    print(f"phase times: r128_fused seg mode {out['seg'][0]:.4f} ms (medians {seg_k}), full-rate "
          f"kernel + shifted_segments {statistics.mean(full_k):.4f} ms (medians {full_k}), plain "
          f"version {out['seg'][1]:.4f} ms (medians {seg_p}) at B={B_MAIN} C=2 T={FS} fragm "
          f"{FRAGM} [{gpu}]")
    del x

    for C in (5, 8):
        args = surround_args(C, B_MAIN, FS, 7, dev)
        wide, narrow = [], []
        for w in "nwwn":
            fn = surround_fused.fused_core_wide if w == "w" else surround_fused.fused_core
            (wide if w == "w" else narrow).append(cuda_ms(lambda: fn(*args), 10))
        out[f"wide C={C}"] = (statistics.mean(wide), sur_plain[C])
        print(f"phase times: surround_fused wide layout {statistics.mean(wide):.4f} ms (medians "
              f"{wide}), narrow {statistics.mean(narrow):.4f} ms (medians {narrow}), plain "
              f"version {sur_plain[C]:.4f} ms (phase times above) at B={B_MAIN} C={C} P=4 "
              f"T={FS} [{gpu}]")
        del args

    for name in ("surround5", "surround8"):
        m = meters_lv2_torch.create(name, FS)
        xs = surround_blocks(m.nchan, blocks_dev)
        for flag in ("0", "1"):
            with env_set(WIDE_VAR, flag):
                xrt, ms, runs = x_realtime(m, lambda: m.init((B_MAIN,)), xs, N_STATS)
            print(f"phase times: {name} {WIDE_VAR}={flag} {xrt:.1f} x-realtime ({ms:.3f} ms per "
                  f"update; runs {runs} s for {N_STATS} x 1 s blocks at B={B_MAIN}) [{gpu}]")
        del xs
    return out


class ProcessAsUpdate:
    """An analyzer seen through the update(state, x) -> state protocol of
    device_us_per_update."""

    def __init__(self, m):
        self.m = m

    def update(self, st, x):
        return self.m.process(st, x)[1]


POOL = None  # worker processes of the CPU runs


def stop_workers():
    global POOL
    if POOL is not None:
        POOL.terminate()
        POOL.join()
        POOL = None


def main():
    try:
        import torch
    except ImportError as e:
        fail(f"cannot import torch ({e})")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test runs the "
             "port on an NVIDIA GPU and does not run on the CPU")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    if os.environ.pop(WIDE_VAR, None) is not None:  # the default paths run without it
        print(f"chip_smoke: {WIDE_VAR} unset for the default paths")
    try:
        import meters_lv2_torch
        from meters_lv2_torch.ops import (
            ballistics_core, bitmeter_stats, design, lti, r128_fused, spectrum_fused,
            stft_fused, surround_fused, truepeak_fused)
        from meters_lv2_torch.runtime import build
        from meters_lv2_torch.utils.interop import state_to_numpy
    except ImportError as e:
        fail(f"cannot import meters_lv2_torch ({e}): run from the root of a checkout")

    # -- 1. device ----------------------------------------------------------
    marks = [("start", time.perf_counter())]
    gpu = gpu_line()
    kind = torch.cuda.get_device_name(0)
    if torch.backends.cuda.matmul.allow_tf32:
        fail("torch.backends.cuda.matmul.allow_tf32 is True: fp32 matmuls would run in TF32")
    if torch.get_float32_matmul_precision() != "highest":
        fail(f"float32 matmul precision is {torch.get_float32_matmul_precision()!r}, not 'highest'")
    print(f"phase device: ok: {kind}; nvidia-smi: {gpu}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; fp32 matmul precision highest, TF32 off")
    dev = torch.device("cuda", 0)

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    build.build()
    build.kernels()
    build_s = time.perf_counter() - t0
    log = (build.BUILD_DIR / "build.log").read_text().splitlines()
    regs = sorted({ln.split("ptxas info    : ")[-1] for ln in log if "registers" in ln})
    print(f"phase build: ok in {build_s:.2f} s; ptxas: {' | '.join(regs)}")

    # the CPU runs of the statistics meters, in worker processes (spawned:
    # they touch no CUDA) while the card works
    global POOL
    POOL = multiprocessing.get_context("spawn").Pool(4)
    cpu_runs = {}
    for name, kw, layout in STATS:
        cpu_runs[name, tuple(kw.items()), "main"] = POOL.apply_async(
            cpu_stats_run, (name, kw, layout, "main"))
    for name, kw, layout in STATS:
        if name in ("dr14stereo", "SigDistHist"):
            cpu_runs[name, tuple(kw.items()), "nan"] = POOL.apply_async(
                cpu_stats_run, (name, kw, layout, "nan"))
    POOL.close()

    # -- 3. kernels vs plain version ----------------------------------------
    sysm = lti.LTISystem(*design.k_weighting_state_space(FS))
    op = sysm.op(128)
    rng = np.random.default_rng(0)

    def inputs(B, C, T, state_scale):
        x = rng.standard_normal((B, C, T), dtype=np.float32) * np.float32(0.3)
        z0 = rng.standard_normal((B, C, 4), dtype=np.float32) * np.float32(0.01 * state_scale)
        h0 = rng.standard_normal((B, C, 47), dtype=np.float32) * np.float32(0.1 * state_scale)
        return x, z0, h0

    def on_card(*arrs):
        return [torch.as_tensor(a, device=dev) for a in arrs]

    cases = []
    cases.append(("B=5 C=2 T=768 3-D", *inputs(5, 2, 768, 1.0), (1.0, 1.41), False))
    cases.append(("mono B=2 T=256", *inputs(2, 1, 256, 0.0), (2.0,), False))
    cases.append(("B=3 C=5 T=1280", *inputs(3, 5, 1280, 1.0),
                  r128_fused.gains_f32(design.R128_CHAN_GAIN[:5]), False))
    x, z0, h0 = inputs(4, 2, 1024, 1.0)
    x[0, 0, 300] = np.nan  # NaN in one frame
    x[1, 1, 700] = np.inf
    x[2, 0, 130] = -np.inf
    x[3, 0, 5] = np.nan
    x[3, 1, 900] = np.inf
    h0[3, 1, 10] = -np.inf  # non-finite carried history
    cases.append(("NaN/+-Inf injected B=4 T=1024", x, z0, h0, (1.0, 1.0), False))
    cases.append((f"main-path shape B={B_MAIN} C=2 T={FS} flat",
                  *inputs(B_MAIN, 2, FS, 1.0), (1.0, 1.0), True))
    failures = []
    main_err = None
    print("phase kernels:")
    for tag, x, z0, h0, gains, flat in cases:
        xd, zd, hd = on_card(x, z0, h0)
        B, C, T = x.shape
        got = r128_fused.fused_core(xd.reshape(B, C * T) if flat else xd, zd, hd, gains, op)
        ref = r128_fused.fused_core_reference(xd, zd, hd, gains, op)
        torch.cuda.synchronize()
        p_err, errs = compare_core(got, ref, tag)
        failures += [f"{tag}: {e}" for e in errs]
        if flat:
            main_err = p_err

    c_ppm = design.iec2_ppm(FS)
    c_tp = design.true_peak_ballistics(FS)
    w_ppm = dict(w1=c_ppm.w1, w2=c_ppm.w2, w3=c_ppm.w3)
    w_tp = dict(w1=c_tp.w1, w2=c_tp.w2, w3=c_tp.w3)

    def states(N):
        return [np.abs(0.3 * rng.standard_normal(N)).astype(np.float32) for _ in range(4)]

    # the plain versions of ballistics and truepeak_fused loop in Python
    # over 12,000 / 48,000 groups at the main-path shape (seconds a call):
    # that comparison's one call, timed, is also their time in phase times
    ball_err = tp_err = None
    plain_ms = {}
    for tag, N, T, track_peak, inject in [
        ("N=5 T=1024 track_peak=False", 5, 1024, False, False),
        ("N=5 T=1024 track_peak=True", 5, 1024, True, False),
        ("NaN/+-Inf injected N=5 T=1024 track_peak=True", 5, 1024, True, True),
        (f"main-path shape N={2 * B_MAIN} T={FS}", 2 * B_MAIN, FS, False, False),
    ]:
        t = np.abs(0.3 * rng.standard_normal((N, T))).astype(np.float32)
        st = states(N)
        if inject:
            t[0, 17], t[1, 300], t[2, 5], t[3, T - 3], t[4, 64] = (
                np.nan, np.inf, np.nan, np.inf, -np.inf)
            st[2][1] = np.nan  # a NaN carried max propagates
        args = on_card(t, *st)
        got = ballistics_core.ballistics(*args, **w_ppm, track_peak=track_peak)
        ref, plain_ms["ballistics"] = timed_call(lambda: ballistics_core.ballistics_reference(
            *args, **w_ppm, track_peak=track_peak))
        err, errs = compare_ballistics(got, ref, tag)
        failures += [f"ballistics {tag}: {e}" for e in errs]
        ball_err = err
    # truepeak_fused: the default (envelope) body against its own plain
    # version and against the serial plain version, the serial body against
    # its plain version; all at TPK_RTOL, hist' bit-exact
    for tag, N, T, inject in [
        ("N=3 T=1280", 3, 1280, False),
        ("NaN/+-Inf in x and hist N=8 T=1024", 8, 1024, True),
        (f"main-path shape N={2 * B_MAIN} T={FS}", 2 * B_MAIN, FS, False),
    ]:
        x = (0.3 * rng.standard_normal((N, T))).astype(np.float32)
        h = (0.1 * rng.standard_normal((N, 47))).astype(np.float32)
        st = [0.5 * v for v in states(N)]
        if inject:  # block edges, the history, and +Inf beside -Inf (NaN and
            # Inf oversamples in one group)
            x[0, 300], x[1, 700], x[2, 130] = np.nan, np.inf, -np.inf
            x[6, 256], x[6, 383], x[7, 600], x[7, 601] = np.nan, np.inf, np.inf, -np.inf
            h[3, 10], h[4, 46], h[5, 0] = np.nan, np.inf, -np.inf
        args = on_card(x, h, *st)
        got = truepeak_fused.truepeak_fused(*args, **w_tp)
        got_s = truepeak_fused.truepeak_fused(*args, **w_tp, body="serial")
        ref, ms = timed_call(lambda: truepeak_fused.truepeak_fused_reference(*args, **w_tp))
        ref_s = truepeak_fused.truepeak_fused_reference(*args, **w_tp, body="serial")
        for t, g, r in ((f"{tag}, envelope vs its plain version", got, ref),
                        (f"{tag}, envelope vs the serial plain version", got, ref_s),
                        (f"{tag}, serial body vs its plain version", got_s, ref_s)):
            err, errs = compare_truepeak(g, r, t)
            failures += [f"truepeak_fused {t}: {e}" for e in errs]
            if g is got and r is ref:
                tp_err, plain_ms["truepeak_fused"] = err, ms
    from signals import make_signal

    w = make_signal("weird_floats", 1.0)
    xw = np.stack([w[0], w[1], -w[0]])
    xr = rng.standard_normal((B_MAIN, FS), dtype=np.float32) * np.float32(0.1)
    bit_err = None
    for tag, x, strided in [
        (f"main-path shape N={B_MAIN} T={FS}", np.random.default_rng(0).standard_normal(
            (B_MAIN, FS), dtype=np.float32) * np.float32(0.1), False),
        ("weird_floats N=3 T=48000", xw, False),
        ("N=5 T=1000", xr[:5, :1000], False),
        ("N=5 T=1", xr[:5, :1], False),
        ("strided rows N=7 T=10000", xr[:7, :10000], True),
        ("weird_floats strided rows N=3 T=48000", xw, True),
    ]:
        if strided:
            xd = torch.as_tensor(np.concatenate([x, x], axis=1), device=dev)[:, :x.shape[1]]
        else:
            xd = torch.as_tensor(np.ascontiguousarray(x), device=dev)
        got = bitmeter_stats.bitmeter_stats(xd)
        ref = bitmeter_stats.bitmeter_stats_reference(xd)
        torch.cuda.synchronize()
        err, errs = compare_bitstats(got, ref, tag)
        failures += [f"bitmeter_stats {tag}: {e}" for e in errs]
        if bit_err is None:
            bit_err = err
    spec_err, errs = spectrum_kernel_cases(dev)
    failures += errs
    sur_err, errs = surround_kernel_cases(dev)
    failures += errs
    stft_err, errs = stft_kernel_cases(dev)
    failures += errs
    env_err, env_plain_ms, errs = envelope_kernel_cases(dev, w_ppm)
    failures += errs
    seg_err, seg_plain_ms, errs = seg_kernel_cases(dev)
    failures += errs
    wide_err, errs = wide_kernel_cases(dev)
    failures += errs
    if failures:
        fail("kernel vs plain: " + " | ".join(failures))
    print("phase kernels: ok")
    marks.append(("device, build and kernels", time.perf_counter()))

    # -- 4. main path -------------------------------------------------------
    meter = meters_lv2_torch.create("EBUr128", FS, nchan=2)
    blocks = main_blocks()
    st = meter.init((B_MAIN,), device=dev)
    r128_fused.launch_count = 0
    for xb in blocks:
        st = meter.update(st, torch.as_tensor(xb, device=dev), flat=True)
    out, st = meter.read(st)
    torch.cuda.synchronize()
    launches = r128_fused.launch_count
    if launches != len(blocks):
        fail(f"main path launched the kernel {launches} times for {len(blocks)} blocks")
    for k in ("integrated", "lra", "dbtp"):
        v = out[k]
        if v.shape != (B_MAIN,) or not bool(torch.isfinite(v).all()):
            fail(f"main path readout {k} not finite of shape ({B_MAIN},)")
    st_c = meter.init((4,), device="cpu")
    for xb in blocks:
        st_c = meter.update(st_c, torch.as_tensor(xb[:4]), flat=True)
    out_c, st_c = meter.read(st_c)
    worst = 0.0
    for k in ("loudness_M", "loudness_S", "max_M", "max_S", "integrated", "integ_thr",
              "range_min", "range_max", "range_thr", "lra"):
        d = (out[k][:4].cpu() - out_c[k]).abs().max().item()
        worst = max(worst, d)
        if not d < TOL_DB:
            fail(f"main path {k}: card vs CPU differ by {d} dB")
    tp_db = (20 * torch.log10(out["dbtp"][:4].cpu() / out_c["dbtp"])).abs().max().item()
    if not tp_db < TOL_DB:
        fail(f"main path dbtp: card vs CPU differ by {tp_db} dB")
    for k in ("hist_m", "hist_s", "count_m", "count_s"):
        if not torch.equal(getattr(st, k)[:4].cpu(), getattr(st_c, k)):
            fail(f"main path {k}: card vs CPU not exact")
    print(f"phase main: ok: {len(blocks)} x 1 s flat blocks at B={B_MAIN}, kernel launches "
          f"{launches}; integrated[0] {out['integrated'][0].item():.4f} LUFS, lra[0] "
          f"{out['lra'][0].item():.4f} LU, dbtp[0] {out['dbtp'][0].item():.6f}; streams 0-3 "
          f"vs CPU: worst readout diff {worst:.3g} dB, dbtp {tp_db:.3g} dB, histograms exact")

    def reset_counts():
        r128_fused.launch_count = r128_fused.seg_launch_count = 0
        ballistics_core.launch_count = ballistics_core.envelope_launch_count = 0
        truepeak_fused.launch_count = truepeak_fused.serial_launch_count = 0
        bitmeter_stats.launch_count = 0
        spectrum_fused.launch_count = 0
        surround_fused.launch_count = surround_fused.wide_launch_count = 0
        stft_fused.launch_count = 0

    def all_counts():
        return (r128_fused.launch_count, ballistics_core.launch_count,
                truepeak_fused.launch_count, bitmeter_stats.launch_count,
                spectrum_fused.launch_count, surround_fused.launch_count,
                stft_fused.launch_count, ballistics_core.envelope_launch_count,
                r128_fused.seg_launch_count, surround_fused.wide_launch_count,
                truepeak_fused.serial_launch_count)

    def counts():
        return (ballistics_core.launch_count, ballistics_core.envelope_launch_count,
                truepeak_fused.launch_count)

    blocks3 = [b.reshape(B_MAIN, 2, FS) for b in blocks]  # [B, C, T] views
    blocks_dev = [torch.as_tensor(b, device=dev) for b in blocks3]
    ball_launches = env_launches = tp_launches = 0
    # meter, state batch, expected (ballistics serial, ballistics envelope,
    # truepeak) launches per update: the PPM meters run the envelope body
    for name, batch, per_update in [
        ("dBTPstereo", (B_MAIN, 2), (0, 0, 1)),
        ("BBCstereo", (B_MAIN, 2), (0, 1, 0)),
        ("DINstereo", (B_MAIN, 2), (0, 1, 0)),
        ("BBCM6", (B_MAIN,), (0, 1, 0)),  # mid and side in one stacked launch
        ("VUstereo", (B_MAIN, 2), (0, 0, 0)),
        ("K20stereo", (B_MAIN, 2), (0, 0, 0)),
        ("COR", (B_MAIN,), (0, 0, 0)),
    ]:
        m = meters_lv2_torch.create(name, FS)
        st = m.init(batch, device=dev)
        reset_counts()
        for xb in blocks_dev:
            st = m.update(st, xb)
        out, st = m.read(st)
        torch.cuda.synchronize()
        got = counts()
        want = tuple(n * len(blocks) for n in per_update)
        if got != want or r128_fused.launch_count or truepeak_fused.serial_launch_count:
            fail(f"main path {name}: (ballistics serial, ballistics envelope, truepeak) launches "
                 f"{got}, expected {want}; serial truepeak {truepeak_fused.serial_launch_count}")
        ball_launches += got[0]
        env_launches += got[1]
        tp_launches += got[2]
        out = readouts(out)
        for k, v in out.items():
            if v.shape != batch or not bool(torch.isfinite(v).all()):
                fail(f"main path {name} readout {k} not finite of shape {batch}")
        st_c = m.init((4, *batch[1:]), device="cpu")
        for xb in blocks3:
            st_c = m.update(st_c, torch.as_tensor(xb[:4]))
        out_c = readouts(m.read(st_c)[0])
        diffs = {}
        for k in out:
            a, b = out[k][:4].cpu(), out_c[k]
            diffs[k] = ((a - b).abs().max().item() if name == "COR"
                        else level_db_diff(a, b))
            if not diffs[k] < (COR_TOL if name == "COR" else TOL_DB):
                fail(f"main path {name} {k}: card vs CPU differ by {diffs[k]}")
        first = ", ".join(f"{k}[0] {v.reshape(-1)[0].item():.6f}" for k, v in out.items())
        print(f"phase main: ok: {name} {len(blocks)} x 1 s blocks at state batch {batch}, "
              f"(ballistics serial, ballistics envelope, truepeak) launches {got}; {first}; "
              f"streams 0-3 vs CPU: "
              + ", ".join(f"{k} {d:.3g}" for k, d in diffs.items())
              + (" abs" if name == "COR" else " dB"))

    # dBTP in 1000-sample blocks: 896 samples through truepeak_fused and a
    # 104-sample tail through upsample4 + the serial ballistics kernel per
    # update (the JAX package's tail is its serial scan)
    m = meters_lv2_torch.create("dBTPstereo", FS)
    x4 = blocks3[0][:4]
    st, st_c = m.init((4, 2), device=dev), m.init((4, 2), device="cpu")
    x4_dev = torch.as_tensor(x4, device=dev)
    reset_counts()
    for i in range(FS // 1000):
        st = m.update(st, x4_dev[..., i * 1000:(i + 1) * 1000])
    out, _ = m.read(st)
    torch.cuda.synchronize()
    got = counts()
    for i in range(FS // 1000):
        st_c = m.update(st_c, torch.as_tensor(x4[..., i * 1000:(i + 1) * 1000]))
    if got != (FS // 1000, 0, FS // 1000) or truepeak_fused.serial_launch_count:
        fail(f"dBTP 1000-sample blocks: (ballistics serial, ballistics envelope, truepeak) "
             f"launches {got}")
    ball_launches += got[0]
    tp_launches += got[2]
    out_c, _ = m.read(st_c)
    d = max(level_db_diff(out[k].cpu(), out_c[k]) for k in out_c)
    if not d < TOL_DB:
        fail(f"dBTP 1000-sample blocks: card vs CPU differ by {d} dB")
    print(f"phase main: ok: dBTPstereo {FS // 1000} x 1000-sample blocks (104-sample tail) "
          f"on streams 0-3, (ballistics serial, ballistics envelope, truepeak) launches {got}; "
          f"vs CPU {d:.3g} dB")

    # the statistics meters, created and initialised with no device
    # argument: their state must land on the card
    def first4(d):
        return {k: (first4(v) if isinstance(v, dict) else v[:4]) for k, v in d.items()}

    bit_launches = 0
    for name, kw, layout in STATS:
        m = meters_lv2_torch.create(name, FS, **kw)
        st = m.init((B_MAIN,))
        if not all(t.is_cuda for t in state_tensors(st)):
            fail(f"main path {name}: init() without a device did not put the state on CUDA")
        reset_counts()
        for i in range(N_STATS):
            st = m.update(st, stats_input(blocks_dev[i % len(blocks_dev)], layout))
            if i == len(blocks) - 1:
                st12 = st
        out, st = m.read(st)
        torch.cuda.synchronize()
        got = (ballistics_core.launch_count + ballistics_core.envelope_launch_count,
               truepeak_fused.launch_count, bitmeter_stats.launch_count,
               r128_fused.launch_count, truepeak_fused.serial_launch_count)
        want = (0, N_STATS if layout == "stereo" else 0, N_STATS if name == "bitmeter" else 0, 0, 0)
        if got != want:
            fail(f"main path {name}: (ballistics, truepeak, bitmeter, r128, serial truepeak) "
                 f"launches {got}, expected {want}")
        tp_launches += got[1]
        bit_launches += got[2]
        for k, v in out.items():
            if v.shape[0] != B_MAIN or (v.is_floating_point() and not bool(torch.isfinite(v).all())):
                fail(f"main path {name} readout {k} not finite or not of {B_MAIN} streams")
        out12, st12 = m.read(st12)
        ref_state, ref_out = cpu_runs[name, tuple(kw.items()), "main"].get(timeout=900)
        worst, errs = compare_stats(
            name, first4(state_to_numpy(st12)), {k: v[:4].cpu().numpy() for k, v in out12.items()},
            ref_state, ref_out)
        if errs:
            fail(f"main path {name} {kw}: card vs CPU: {'; '.join(errs)}")
        tag = name + ("(reference_oor_count)" if kw else "")
        first = ", ".join(f"{k}[0] {v.reshape(-1)[0].item():.6g}" for k, v in out.items()
                          if v[0].numel() == 1 or v.ndim == 2 and v.shape[1] <= 2)
        print(f"phase main: ok: {tag} {N_STATS} x 1 s blocks at B={B_MAIN}, state on "
              f"{state_tensors(st)[0].device}, (ballistics, "
              f"truepeak, bitmeter, r128, serial truepeak) launches {got}; {first}; streams 0-3 after "
              f"{len(blocks)} blocks vs CPU: exact where exact, worst readout {worst:.3g} dB")

    # NaN / +-Inf samples: the card must bin and count them as the CPU does
    xs_nan = [torch.as_tensor(b, device=dev) for b in nan_blocks()]
    for name, kw, layout in STATS:
        if name not in ("dr14stereo", "SigDistHist"):
            continue
        m = meters_lv2_torch.create(name, FS, **kw)
        st = m.init((4,))
        for xb in xs_nan:
            st = m.update(st, stats_input(xb, layout))
        out, st = m.read(st)
        ref_state, ref_out = cpu_runs[name, tuple(kw.items()), "nan"].get(timeout=900)
        worst, errs = compare_stats(name, state_to_numpy(st),
                                    {k: v.cpu().numpy() for k, v in out.items()},
                                    ref_state, ref_out)
        if errs:
            fail(f"NaN/Inf stream {name} {kw}: card vs CPU: {'; '.join(errs)}")
        print(f"phase main: ok: NaN/+-Inf stream through {name}"
              f"{'(reference_oor_count)' if kw else ''}: card equals CPU "
              f"(worst readout {worst:.3g} dB)")
    stop_workers()
    spec_main, spec_tail = spectrum_main(dev, blocks_dev, blocks3, reset_counts)
    marks.append(("main before surround", time.perf_counter()))
    sur_launches = surround_main(dev, blocks3, reset_counts)
    marks.append(("main surround", time.perf_counter()))
    stft_launches = analyzers_main(dev, blocks3, reset_counts, all_counts)
    marks.append(("main analyzers", time.perf_counter()))
    seg_launches, wide_launches = variants_main(dev, blocks_dev, reset_counts, all_counts)
    marks.append(("main variants", time.perf_counter()))
    truepeak_carried(dev, blocks_dev, w_tp)
    ballistics_carried(dev, blocks_dev, w_ppm)
    spectrum_carried(dev)
    spectrum_nonfinite_meter(dev)
    fp32_pinned(dev, blocks3)
    marks.append(("main truepeak carried and fp32", time.perf_counter()))

    # -- 5. golden fixtures -------------------------------------------------
    gw = []
    for name in ("ebur128_aligned_mix.json", "ebur128_mix.json"):
        with open(os.path.join(ROOT, "tests", "fixtures", name)) as f:
            fx = json.load(f)
        gw.append(f"{name} worst {run_golden(meters_lv2_torch.create, fx, dev):.3g} dB")
    print(f"phase golden: ok: {'; '.join(gw)}; histograms and counts exact")
    from signals import make_signal
    from test_torch_golden_ballistics import FAMILIES, run_family

    gw = []
    ballistics_core.launch_count = ballistics_core.envelope_launch_count = 0
    for prefix in FAMILIES:
        try:
            worst, n = run_family(prefix, make_signal, device=dev)
        except AssertionError as e:
            fail(f"golden {prefix}: {e}")
        gw.append(f"{prefix} {n} values worst {worst:.3g}")
    n_env = ballistics_core.envelope_launch_count
    if not n_env:  # DIN, BBC and BBC M-6 (iec1*, iec2*, msppm*) run the envelope
        fail("golden ballistics families: no envelope launch")
    print(f"phase golden: ok: ballistics families, whole fixtures (dB; stcorr absolute; "
          f"{n_env} envelope launches, {ballistics_core.launch_count} serial): {'; '.join(gw)}")
    import test_torch_golden_stats as gs

    gw = []
    try:
        for prefix in gs.DR_PREFIXES:
            worst, n = gs.run_dr14(prefix, make_signal, device=dev)
            gw.append(f"{prefix} {n} values worst {worst:.3g} dB")
        worst, n = gs.run_tpnrms(make_signal, device=dev)
        gw.append(f"tpnrms {n} values worst {worst:.3g} dB")
        var = max(gs.run_sigdist("sigdist", make_signal, device=dev))
        quirk = gs.run_sigdist("sigdist_oor", make_signal, device=dev, reference_oor_count=True)
        plain = gs.run_sigdist("sigdist_oor", make_signal, device=dev)
        if not (var <= 1e-3 and all(q <= 1e-5 and p > 30 * q for q, p in zip(quirk, plain))):
            fail(f"golden sigdist: hist_var rel {var}, oor quirk {quirk}, plain {plain}")
        gw.append(f"sigdist hist_var rel {var:.3g}; sigdist_oor quirk {max(quirk):.3g}, "
                  f"plain {min(plain):.3g}")
        gw.append(f"bitmeter {gs.run_bitmeter(make_signal, device=dev)} fixtures exact")
    except AssertionError as e:
        fail(f"golden statistics: {e}")
    print(f"phase golden: ok: statistics fixtures, whole, true peak included: {'; '.join(gw)}")
    spectrum_golden(dev)
    marks.append(("golden before surround", time.perf_counter()))
    surround_golden(dev)
    marks.append(("golden surround", time.perf_counter()))
    analyzers_golden(dev)
    marks.append(("golden analyzers", time.perf_counter()))
    variants_golden(dev)
    marks.append(("golden variants", time.perf_counter()))

    # -- 6. times -----------------------------------------------------------
    x, z0, h0 = inputs(B_MAIN, 2, FS, 1.0)
    xd, zd, hd = on_card(x, z0, h0)
    xf = xd.reshape(B_MAIN, -1)
    gains = (1.0, 1.0)
    ms_k, ms_p = [], []
    for order in ("pk", "kp"):  # plain, kernel, kernel, plain
        for w in order:
            if w == "k":
                ms_k.append(cuda_ms(lambda: r128_fused.fused_core(xf, zd, hd, gains, op), 10))
            else:
                ms_p.append(cuda_ms(lambda: r128_fused.fused_core_reference(xd, zd, hd, gains, op), 5))
    ms_kernel, ms_plain = statistics.mean(ms_k), statistics.mean(ms_p)
    print(f"phase times: r128_fused kernel {ms_kernel:.4f} ms (medians {ms_k}), plain "
          f"version {ms_plain:.4f} ms (medians {ms_p}) at B={B_MAIN} C=2 T={FS} [{gpu}]")
    xb = torch.as_tensor(blocks[0], device=dev)
    n_chunks = 120  # 240 in bench.py; halved to keep the run short
    runs = []
    for _ in range(3):
        st = meter.init((B_MAIN,), device=dev)
        st = meter.update(st, xb, flat=True)  # warm caches and allocator
        st = meter.init((B_MAIN,), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            st = meter.update(st, xb, flat=True)
        out, _ = meter.read(st)
        torch.cuda.synchronize()
        out["integrated"].cpu()
        runs.append(time.perf_counter() - t0)
    xrt = B_MAIN * n_chunks / min(runs)
    print(f"phase times: main path {xrt:.1f} x-realtime (best of {len(runs)}: "
          f"{[round(r, 4) for r in runs]} s for {n_chunks} x 1 s blocks at B={B_MAIN}, "
          f"{min(runs) / n_chunks * 1e3:.3f} ms per update) [{gpu}]")

    # ballistics and truepeak_fused at the main-path shape; the plain
    # versions' one call was timed in phase kernels
    t_abs = torch.abs(blocks_dev[0]).reshape(2 * B_MAIN, FS)
    x_tp = blocks_dev[0].reshape(2 * B_MAIN, FS)
    times = {}
    ball_body_ms = ballistics_body_times(dev, gpu, w_ppm, t_abs)
    times["ballistics"] = (ball_body_ms[2 * B_MAIN][1], plain_ms["ballistics"])
    times["ballistics_envelope"] = (ball_body_ms[2 * B_MAIN][0], env_plain_ms)
    tp_body_ms = truepeak_body_times(dev, gpu, w_tp, x_tp)
    times["truepeak_fused"] = (tp_body_ms[2 * B_MAIN][0], plain_ms["truepeak_fused"])
    for name in ("ballistics", "ballistics_envelope", "truepeak_fused"):
        print(f"phase times: {name} kernel {times[name][0]:.4f} ms, plain version "
              f"{times[name][1]:.1f} ms (one call, in phase kernels) at "
              f"N={2 * B_MAIN} T={FS} [{gpu}]")
    # bitmeter_stats at the main-path shape: plain, kernel, kernel, plain
    x_bit = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (B_MAIN, FS), dtype=np.float32) * np.float32(0.1), device=dev)
    ms_k, ms_p = [], []
    for w in "pkkp":
        if w == "k":
            ms_k.append(cuda_ms(lambda: bitmeter_stats.bitmeter_stats(x_bit), 20))
        else:
            ms_p.append(cuda_ms(lambda: bitmeter_stats.bitmeter_stats_reference(x_bit), 3))
    times["bitmeter_stats"] = (statistics.mean(ms_k), statistics.mean(ms_p))
    print(f"phase times: bitmeter_stats kernel {times['bitmeter_stats'][0]:.4f} ms (medians "
          f"{ms_k}), plain version {times['bitmeter_stats'][1]:.4f} ms (medians {ms_p}) at "
          f"N={B_MAIN} T={FS} [{gpu}]")
    n_chunks = 60
    for name, batch in [("dBTPstereo", (B_MAIN, 2)), ("BBCstereo", (B_MAIN, 2)),
                        ("DINstereo", (B_MAIN, 2)), ("BBCM6", (B_MAIN,))]:
        m = meters_lv2_torch.create(name, FS)
        runs, enqueue = [], []
        for _ in range(2):
            st = m.update(m.init(batch, device=dev), blocks_dev[0])  # warm
            st = m.init(batch, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(n_chunks):
                st = m.update(st, blocks_dev[i % len(blocks_dev)])
            enqueue.append(time.perf_counter() - t0)
            out, _ = m.read(st)
            torch.cuda.synchronize()
            [v.cpu() for v in readouts(out).values()]
            runs.append(time.perf_counter() - t0)
        print(f"phase times: {name} {B_MAIN * n_chunks / min(runs):.1f} x-realtime (best of "
              f"{len(runs)}: {[round(r, 4) for r in runs]} s for {n_chunks} x 1 s blocks at "
              f"B={B_MAIN}, {min(runs) / n_chunks * 1e3:.3f} ms per update); "
              + stats_profile(m, st, blocks_dev, enqueue, n_chunks,
                              name in ("dBTPstereo", "BBCstereo"))
              + f" [{gpu}]")
    for name, kw, layout in STATS:
        m = meters_lv2_torch.create(name, FS, **kw)
        xs = [stats_input(b, layout) for b in blocks_dev]
        runs, enqueue = [], []
        for _ in range(2):
            st = m.update(m.init((B_MAIN,)), xs[0])  # warm
            st = m.init((B_MAIN,))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(N_STATS):
                st = m.update(st, xs[i % len(xs)])
            enqueue.append(time.perf_counter() - t0)
            out, _ = m.read(st)
            torch.cuda.synchronize()
            [v.cpu() for v in out.values()]
            runs.append(time.perf_counter() - t0)
        tag = name + ("(reference_oor_count)" if kw else "")
        print(f"phase times: {tag} {B_MAIN * N_STATS / min(runs):.1f} x-realtime (best of "
              f"{len(runs)}: {[round(r, 4) for r in runs]} s for {N_STATS} x 1 s blocks at "
              f"B={B_MAIN}, {min(runs) / N_STATS * 1e3:.3f} ms per update); "
              + stats_profile(m, st, xs, enqueue, N_STATS, layout == "stereo") + f" [{gpu}]")

    times["spectrum_fused"] = spectrum_times(dev, blocks_dev, gpu)
    marks.append(("times before surround", time.perf_counter()))
    sur_ms = surround_times(dev, blocks3, gpu)
    times["surround_fused"] = sur_ms[8]
    marks.append(("times surround", time.perf_counter()))
    times["stft_fused"] = analyzers_times(dev, blocks3, gpu)
    marks.append(("times analyzers", time.perf_counter()))
    var_times = variants_times(dev, blocks_dev, gpu, {C: sur_ms[C][1] for C in sur_ms})
    marks.append(("times variants", time.perf_counter()))
    print("phase times: seconds per phase: " + ", ".join(
        f"{name} {t - t0:.1f}" for (_, t0), (name, t) in zip(marks, marks[1:])))

    # least times on the card (H100 SXM peaks), from this run's shapes:
    # bytes = each input read once and each output written once; FLOPs per
    # sample as counted in PERF.md
    def bound(nbytes, flops):
        b, f = nbytes / HBM_BPS * 1e3, flops / FP32_FLOPS * 1e3
        return (b, "bytes") if b >= f else (f, "operations")

    n_r128 = B_MAIN * 2 * FS  # samples at the main-path shape
    n_rows = 2 * B_MAIN * FS  # ballistics / truepeak_fused samples
    bounds = {
        # x in, p out; the function's R128_OPS a channel-sample
        "r128_fused": bound(4 * n_r128 + 4 * B_MAIN * FS, R128_OPS * n_r128),
        # t in; 9 fp32 operations a sample (two attacks of 4, release, max)
        "ballistics": bound(4 * n_rows, 9 * n_rows),
        # x in; FIR 2*4*48, |.|, and 4 ballistics steps of 9
        "truepeak_fused": bound(4 * n_rows, (2 * 4 * 48 + 4 + 4 * 9) * n_rows),
        # x in, the counters out; the work is integer, which the peak
        # table does not rate, so the bound is the bytes
        "bitmeter_stats": bound(4 * B_MAIN * FS + 4 * B_MAIN * (2 * 280 + 23 + 5 + 2), 0),
        # x in, z0/v0 in and zf/val/peak out; per (sample, band) the
        # function's own work: six biquads of 5 MACs (60 operations), the
        # square (1), the smoother v + w (q - v) (3) and the max (1)
        "spectrum_fused": bound(4 * B_MAIN * FS + 4 * B_MAIN * 30 * (2 * 12 + 3),
                                SPEC_OPS * B_MAIN * FS * 30),
    }
    # x in, the K-meter / lowpass states in and out, pk and pacc out; the
    # function's own work per channel-sample and per pair-sample
    for C in (5, 8):
        bounds[f"surround_fused C={C}"] = bound(
            4 * B_MAIN * C * FS + 4 * B_MAIN * C * (2 * 3 + 1) + 4 * B_MAIN * 4 * 3,
            B_MAIN * FS * (SUR_OPS_CHAN * C + 4 * sur_ops_pair(C)))
    bounds["surround_fused"] = bounds["surround_fused C=8"]
    # the envelope body and the variants compute the same functions: the
    # envelope the ballistics function, the wide layout the surround
    # function; seg mode writes
    # n_slots sums a stream instead of p and adds each p sample into one
    bounds["ballistics envelope"] = bounds["ballistics"]
    bounds["r128_fused seg mode"] = bound(4 * n_r128 + 4 * B_MAIN * N_SLOTS,
                                          R128_OPS * n_r128 + B_MAIN * FS)
    for C in (5, 8):
        bounds[f"surround_fused wide C={C}"] = bounds[f"surround_fused C={C}"]
    # the frames' samples of ext in, dphi and level out, at the phase wheel's
    # main-path shape
    bounds["stft_fused"] = bound(*stft_bound(B_MAIN, ANA_W, ANA_F, ANA_HOP))
    for name, (b, by) in bounds.items():
        print(f"phase times: {name} bound {b:.4f} ms ({by}) [{gpu}]")
    # the blocked form the kernel computes costs more than the function:
    # the triangular K (8256 MACs per 128 samples: 129 operations a
    # sample), Sy and G (12 MACs each: 48) and the smoother and max (4)
    print(f"phase times: spectrum_fused blocked form {181 * B_MAIN * FS * 30 / 1e9:.1f} GFLOP, "
          f"{181 * B_MAIN * FS * 30 / FP32_FLOPS * 1e3:.4f} ms at peak, {181 / SPEC_OPS:.2f}x "
          f"the function's {SPEC_OPS} operations a band-sample [{gpu}]")
    print(f"phase times: r128_fused blocked form {R128_BLOCKED_OPS * n_r128 / 1e9:.1f} GFLOP, "
          f"{R128_BLOCKED_OPS * n_r128 / FP32_FLOPS * 1e3:.4f} ms at peak, "
          f"{R128_BLOCKED_OPS / R128_OPS:.2f}x the function's {R128_OPS} operations a "
          f"channel-sample [{gpu}]")

    for mod in ("jax", "meters_lv2_tpu"):
        if mod in sys.modules:
            fail(f"{mod} was imported")
    print(json.dumps({"kernels": [{
        "name": "r128_fused",
        "route": "cuda",
        "source": "meters_lv2_torch/csrc/r128_fused.cu",
        "replaces": "meters_lv2_tpu/ops/pallas_r128.py:287",
        "launches": launches,
        "max_abs_err": main_err,  # p at the main-path shape, vs plain version
        "ms": ms_kernel,
        "plain_ms": ms_plain,
        "bound_ms": bounds["r128_fused"][0],
        "bound_by": bounds["r128_fused"][1],
        "library_ms": None,
    }, {
        "name": "ballistics",
        "route": "cuda",
        "source": "meters_lv2_torch/csrc/ballistics.cu",  # the serial body
        "replaces": "meters_lv2_tpu/ops/pallas_ballistics.py:133",
        "launches": ball_launches,  # dBTP's tails
        "max_abs_err": ball_err,  # all outputs at the main-path shape
        "ms": times["ballistics"][0],  # alternated with the envelope body
        "plain_ms": times["ballistics"][1],
        "bound_ms": bounds["ballistics"][0],
        "bound_by": bounds["ballistics"][1],
        "library_ms": None,
    }, {
        "name": "truepeak_fused",
        "route": "cuda",
        "source": "meters_lv2_torch/csrc/truepeak_fused.cu",
        "replaces": "meters_lv2_tpu/ops/pallas_truepeak.py:161",
        "launches": tp_launches,
        "max_abs_err": tp_err,  # z1, z2, m, p at the main-path shape
        "ms": times["truepeak_fused"][0],  # the default (envelope) body
        "plain_ms": times["truepeak_fused"][1],  # its plain version, one call
        "bound_ms": bounds["truepeak_fused"][0],
        "bound_by": bounds["truepeak_fused"][1],
        "library_ms": None,
        "serial_ms": tp_body_ms[2 * B_MAIN][1],  # body="serial", alternated with it
        "ms_n8192": tp_body_ms[8192][0],
        "serial_ms_n8192": tp_body_ms[8192][1],
    }, {
        "name": "bitmeter_stats",
        "route": "cuda",
        "source": "meters_lv2_torch/csrc/bitmeter_stats.cu",
        "replaces": "meters_lv2_tpu/ops/pallas_bitmeter.py:179",
        "launches": bit_launches,
        "max_abs_err": bit_err,  # every field at the main-path shape
        "ms": times["bitmeter_stats"][0],
        "plain_ms": times["bitmeter_stats"][1],
        "bound_ms": bounds["bitmeter_stats"][0],
        "bound_by": bounds["bitmeter_stats"][1],
        "library_ms": None,
    }, {
        "name": "spectrum_fused",
        "route": "cuda",
        "source": "meters_lv2_torch/csrc/spectrum_fused.cu",
        "replaces": "meters_lv2_tpu/ops/pallas_spectrum.py:357",
        "launches": spec_main + spec_tail,
        "max_abs_err": spec_err,  # val, peak and zf at the main-path shape
        "ms": times["spectrum_fused"][0],
        "plain_ms": times["spectrum_fused"][1],
        "bound_ms": bounds["spectrum_fused"][0],
        "bound_by": bounds["spectrum_fused"][1],
        "library_ms": None,
    }, {
        "name": "surround_fused",
        "route": "cuda",
        "source": "meters_lv2_torch/csrc/surround_fused.cu",
        "replaces": "meters_lv2_tpu/ops/pallas_surround.py:371",
        "launches": sur_launches,
        "max_abs_err": sur_err,  # km_z, zl, pk and pacc at B=256 C=8 T=48000
        "ms": times["surround_fused"][0],  # C=8; C=5 is printed in phase times
        "plain_ms": times["surround_fused"][1],
        "bound_ms": bounds["surround_fused"][0],
        "bound_by": bounds["surround_fused"][1],
        "library_ms": None,
    }, {
        "name": "stft_fused",
        "route": "cuda",
        "source": "meters_lv2_torch/csrc/stft_fused.cu",
        "replaces": "meters_lv2_tpu/ops/pallas_stft.py:216",
        "launches": stft_launches,
        "max_abs_err": stft_err,  # raw re/im at the main-path shape, vs plain version
        "ms": times["stft_fused"][0],  # phasewheel mode, the main path's
        "plain_ms": times["stft_fused"][1],
        "bound_ms": bounds["stft_fused"][0],
        "bound_by": bounds["stft_fused"][1],
        # torch.fft.rfft of the windowed frames: the transform only, without
        # framing, window or the per-bin analysis
        "library_ms": times["stft_fused"][2],
    }, {
        "name": "ballistics_envelope",
        "route": "cuda",
        "source": "meters_lv2_torch/csrc/ballistics.cu",  # the envelope body, the PPM default
        "replaces": "meters_lv2_tpu/ops/pallas_ballistics.py:61",
        "launches": env_launches,  # BBCstereo, DINstereo and BBCM6 on the default path
        "max_abs_err": env_err,  # at N=512 vs plain version (bit-exact); vs serial in phase kernels
        "ms": times["ballistics_envelope"][0],  # alternated with the serial body
        "plain_ms": times["ballistics_envelope"][1],
        "bound_ms": bounds["ballistics envelope"][0],
        "bound_by": bounds["ballistics envelope"][1],
        "library_ms": None,
        # {rows: [envelope ms, serial ms]}, alternated
        "ms_by_rows": {str(N): list(v) for N, v in ball_body_ms.items()},
    }, {
        "name": "r128_fused_seg",
        "route": "cuda",
        "source": "meters_lv2_torch/csrc/r128_fused.cu",
        "replaces": "meters_lv2_tpu/ops/pallas_r128.py:298",
        "launches": seg_launches,  # the 12 main-path blocks through fused_core(off=...)
        "max_abs_err": seg_err,  # seg at the main-path shape, vs plain version
        "ms": var_times["seg"][0],
        "plain_ms": var_times["seg"][1],
        "bound_ms": bounds["r128_fused seg mode"][0],
        "bound_by": bounds["r128_fused seg mode"][1],
        "library_ms": None,
    }, {
        "name": "surround_fused_wide",
        "route": "cuda",
        "source": "meters_lv2_torch/csrc/surround_wide.cu",
        "replaces": "meters_lv2_tpu/ops/pallas_surround.py:252",
        "launches": wide_launches,  # surround5 and surround8 with METERS_TORCH_SURROUND_WIDE=1
        "max_abs_err": wide_err,  # km_z, zl, pk and pacc at B=256 C=8 T=48000, vs plain
        "ms": var_times["wide C=8"][0],  # C=5 is printed in phase times
        "plain_ms": var_times["wide C=8"][1],
        "bound_ms": bounds["surround_fused wide C=8"][0],
        "bound_by": bounds["surround_fused wide C=8"][1],
        "library_ms": None,
    }]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
