#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (meters_lv2_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:

  1. device   the card, its power limit, fp32 matmul precision settings;
  2. build    nvcc builds every kernel from meters_lv2_torch/csrc;
  3. kernels  each kernel (r128_fused, ballistics, truepeak_fused,
              bitmeter_stats, spectrum_fused, surround_fused, stft_fused,
              sigdist_fused) against its plain PyTorch version on the same
              card tensors
              (truepeak_fused's default envelope body against its own and
              the serial body's plain version, its serial body against
              its own, at N=512 T=48000 and on rows with NaN and +-Inf at
              block edges, in the history and side by side; stft_fused
              in all three modes at [256, 2, 56192] (its Hopper body) and
              at W=256 hop 1764 (its generic body), raw mode also against
              torch.fft.rfft, with a NaN and a +Inf sample, and at an odd
              hop); bitmeter_stats exact in every field at the main-path
              shape, at N=1 and 8, on one-exponent, silent, denormal,
              exponent-diverse and every-exponent rows, at its block and
              cluster-slice edges +-1, at T=3, and on rows not 16-byte
              aligned; surround_fused at B=256, 8 and 1 (C=5 and 8,
              T=48000) with and without NaN/+-Inf samples, stream 0's NaN
              reaching every pair; the ballistics envelope body (the PPM
              meters' default) against its plain version and the serial
              kernel (N=512 T=48000 with and without track_peak,
              adversarial rows, and 600 rows of T=1000 with NaN and +-Inf
              at the edges of blocks and groups); then the two variants:
              r128_fused's seg mode at [256, 2,
              48000] with random offsets at fragm 2400 and 2205 against
              its plain version and the kernel's full-rate mode, and the
              surround wide layout against the narrow kernel and the plain
              version at C=5 and C=8, B=256, 8 and 1, and with NaN/Inf
              samples; sigdist_fused against SigDistMeter's plain update
              on channel 0 of [256, 2, 48000] and of a [4, 2, 4800] block
              with NaN, +-Inf and the bin edges, a row not integrating and
              one at the time cap;
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
              NaN/+-Inf stream through sigdist and DR-14 on both
              (sigdist_fused launched once an update in sigdist's default
              mode, never in the out-of-range mode); then
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
              r128_fused and its plain version at B=256 in both modes
              (every call at the bars of phase kernels), through
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
  6. ingest   the slice above the meters: 256 stereo WAVs of 4-12 s (a
              quarter at 44.1 kHz; PCM16, PCM24 and float32; most lengths
              not multiples of 4) and 64 five-channel ones written from a
              seed, decoded by the native library (which must load) and
              load_files(target_rate=48000) with its resampling on the
              card (and once on CPU tensors, timed and compared); every
              non-display meter of the CLI's --meters all for stereo
              through MeterPipeline.run_stream_ragged at chunk 48000 (the
              host-to-device copy, both phases on the device timeline and
              the host's enqueue and the collection's x-realtime in the
              meters' first use, as the CLI runs them; a warm pass with
              its x-realtime and each meter's host time; then one
              torch.profiler pass of the same collection for each meter's
              device time and the device's busy share of that pass),
              every kernel's launches equal to
              the counts predicted from the lengths, and R128 with
              surround over the 5-channel files (held the same way);
              files 0-3, the shortest and the longest held
              against each file alone on the card and against CPU runs (in
              worker processes); stream_pipelined against stream bit for
              bit; _run_display_meters launching stft_fused once for the
              phase wheel and once for the stereoscope; and
              python -m meters_lv2_torch --meters all --json on 8 files
              against the same with --cpu;
  7. live     the live shell (meters_lv2_torch.live) at B=1: a card
              LiveEngine at stereo --meters all (20 meters) over 8 s of
              seeded tones and noise by feed_file(speed=0) at the shell's
              0.5 s chunk (24,000 samples, not a multiple of 128), with a
              readout and the 20 PNG frames after every feed, timed (per
              feed, per readout generation, the frames, the unpaced
              x-realtime and the realtime headroom at --fps 10 --speed 1);
              a second stereo engine (a meter or more of every kernel)
              fed from an os.pipe with ragged writes through feed_stream;
              --stdin at stereo --meters all: a third engine fed through
              feed_stream by a producer in real time, timed as the first
              (its realtime headroom); --meters all on 5 channels over
              4 s; every kernel's launches equal to the counts predicted
              from the feeds; each engine against the same engine on CPU
              tensors (worker processes replaying its feeds and readouts)
              at the ingest bars; then the dashboard server on the card
              engine: every endpoint, the transport controls, three port
              writes, a NaN write refused with 500, /save then /load then
              1 s more against the run that never loaded, every state
              tensor still on the card after each control and load;
  8. sharded  the whole-file analyses (parallel/*_sharded.py) on 4 ranks
              launched on the one card (gloo, host-staged collectives; the
              backend, world size, card count and each rank's device
              printed): R128 at B=16 x 600 s stereo (T = 28,800,000) and
              the spectrum (30 s), dBTP, DR-14, TP+RMS, sigdist (both
              modes), the bit meter, VU, DIN, BBC, BBC M-6, K20, COR,
              surround5 and surround8 at B=8 x 61 s, under dp x sp = 2 x 2
              and 1 x 4, each rank making only its own blocks of the
              seeded signal; every result against one serial update on the
              card; each rank's launches of r128_fused (1 an R128
              analysis), the ballistics envelope body (sp a chain, 2 sp for
              M-6) and bitmeter_stats (1) held to the prediction; on the
              rank at sp index 1 (a non-zero entry state) r128_fused on its
              shard, a chain step's ballistics call and bitmeter_stats
              against their plain versions; an R128 state over dp = 4 saved
              with save_state_sharded, loaded on the card and carried one
              more second bit for bit; the wall time of each analysis per
              layout and of the serial update as x-realtime;
  9. tools    the native leg of tools/gpu_parity_check.py on the card (a
              subprocess): R128 at B=256 x 10 s stereo in flat 1 s blocks
              and at 44.1 and 96 kHz (B=8), every other kind of the native
              engine at B=32 x 10 s in 1000-sample blocks (the analyzers a
              hop a call; surround at C=5 and 8), each against one
              runtime.native.NativeEngine a stream on the host at the bars
              of tests/test_native.py, every worst share of a bar <= 1 and
              every kernel's launches equal to the counts predicted from B,
              T and the block; beside it the three examples
              (examples/torch_*.py) on the card, their lines checked as
              tests/test_torch_examples.py checks them on the CPU;
 10. times    each kernel vs its plain version, truepeak_fused's envelope
              and serial bodies alternated at N=512 and N=8,192, the
              ballistics kernel's envelope and serial bodies alternated at
              N=512 and at 4,224 to 33,792 rows, and main-path x-realtime
              (R128 over 120 blocks, down from 240 to keep the whole run
              well inside its time limit, with the update's host
              enqueue and torch.profiler device time; dBTP, BBC, DIN, BBC M-6, the
              statistics meters and
              spectr30stereo, surround5 and surround8 over 60; for the
              surround meters also the host's enqueue time and the device
              time of an update under torch.profiler); stft_fused also
              against torch.fft.rfft of the windowed frames and at B = 1
              and 8, bitmeter_stats and surround_fused also at B = 1 and
              8, sigdist_fused against the plain update at B = 256 with the
              launches queued, and the three
              analyzers' x-realtime over 60 blocks with their enqueue and
              device time per update; each variant against its default
              (the surround wide layout against the narrow one at B = 1,
              8 and 256, C = 5 and 8, each beside its bound), and
              surround5 and surround8 x-realtime with the wide layout
              on.

The CPU runs of DR-14 and TP+RMS (their true peak is a Python loop per
sample on the CPU) go to worker processes at the start and are collected in
phase 4, so they overlap the card's work; phase ingest's CPU runs and CLI
runs overlap its checks on the card the same way, after its timed runs.
Phase live's CPU engines of its stereo and 5-channel runs, whose feeds are
known in advance, start with phase main and run through phases main and
golden, which time nothing; those of its pipe-fed run, after its timed run.  The last lines are a JSON
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
import struct
import subprocess
import sys
import time
import types

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


def surround_bound(B, C, T):
    """The surround function's least time on the card in ms, and what
    bounds it: x in, the K-meter and lowpass states in and out, pk and the
    P = 4 pair sums out, over the memory rate, against SUR_OPS_CHAN a
    channel-sample and sur_ops_pair(C) a pair-sample over the fp32 rate."""
    b = (4 * B * C * T + 4 * B * C * (2 * 3 + 1) + 4 * B * 4 * 3) / HBM_BPS * 1e3
    f = B * T * (SUR_OPS_CHAN * C + 4 * sur_ops_pair(C)) / FP32_FLOPS * 1e3
    return (b, "bytes") if b >= f else (f, "operations")


# H100 SXM datasheet peaks: HBM bytes/s, fp32 FLOP/s
HBM_BPS, FP32_FLOPS = 3.35e12, 67e12


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    stop_workers()
    stop_live_workers()
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


def queued_ms(fn, reps, tries=5):
    """The median over tries of the CUDA-event ms a call of fn, reps calls
    queued behind a ~1 ms sleep kernel: the device's time, the host's
    launch time hidden."""
    import torch

    fn()  # warm
    times = []
    for _ in range(tries):
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
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
    0.3 N(0, 1) (with ``inject``, NaN, +Inf and -Inf samples: stream 0 has
    a NaN), carried non-zero K-meter and lowpass states, the routing of
    ``pairs`` (default: the meter's adjacent pairs), the meter's weights."""
    import torch

    import meters_lv2_torch

    m = meters_lv2_torch.create(f"surround{C}", FS)
    g = np.random.default_rng(seed)
    x = (0.3 * g.standard_normal((B, C, T))).astype(np.float32)
    if inject:
        x[0, C - 1, 300], x[min(1, B - 1), 1, 700], x[min(2, B - 1), 0, 130] = (
            np.nan, np.inf, -np.inf)
        if T >= FS:  # a stream's last block, and the middle of a stream
            x[B - 1, 2, T - 200], x[B // 2, C - 2, T // 2 + 77] = np.inf, np.nan
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
    (surround5's and surround8's) and at a live meter's B=1 and B=8, and
    NaN / +Inf / -Inf samples at B=1, 5, 8 and 256, where stream 0's NaN
    must reach every pair.  Returns (max abs error at the main-path
    shapes, breaches)."""
    import torch

    from meters_lv2_torch.ops import surround_fused

    failures, main_err = [], 0.0
    cases = [("B=5 C=5 T=1280, pairs 0:0 1:1 0:1 2:3", 5, 5, 1280,
              [[0, 0], [1, 1], [0, 1], [2, 3]], False),
             ("NaN/+Inf/-Inf in x, B=5 C=5 T=1280", 5, 5, 1280, None, True)]
    for B in (B_MAIN, 8, 1):
        for C in (5, 8):
            tag = "main-path shape" if B == B_MAIN else "a live meter's streams"
            cases.append((f"{tag} B={B} C={C} T={FS}", C, B, FS, None, False))
            cases.append((f"NaN/+Inf/-Inf in x, B={B} C={C} T={FS}", C, B, FS, None, True))
    for tag, C, B, T, pairs, inject in cases:
        args = surround_args(C, B, T, B + C, dev, pairs, inject)
        got = surround_fused.fused_core(*args)
        ref = surround_fused.fused_core_reference(*args)
        torch.cuda.synchronize()
        err, errs = compare_surround(got, ref, tag)
        if inject and bool(torch.isfinite(got[3][0]).any()):
            errs.append("stream 0's NaN did not reach every pair")
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
                "surround_fused_kernel", "stft_hopper_kernel", "stft_generic_kernel")


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
    """surround_fused against its plain version at T=48000 for C=5 and C=8
    at B=256, 8 and 1 (plain, kernel, kernel, plain; one call at a time, as
    the other kernels are timed), and for surround5 and surround8 the
    x-realtime over 60 blocks at B=256, the host's time to enqueue an update
    and the device time of one (torch.profiler).  Returns {C: (kernel ms,
    plain ms)} at B=256."""
    import torch

    import meters_lv2_torch
    from meters_lv2_torch.ops import surround_fused

    ms = {}
    for B, C in ((B_MAIN, 5), (B_MAIN, 8), (8, 5), (8, 8), (1, 5), (1, 8)):
        args = surround_args(C, B, FS, 7, dev)
        ms_k, ms_p = [], []
        for w in "pkkp":
            if w == "k":
                ms_k.append(cuda_ms(lambda: surround_fused.fused_core(*args), 10))
            else:
                ms_p.append(cuda_ms(lambda: surround_fused.fused_core_reference(*args), 3))
        if B == B_MAIN:
            ms[C] = (statistics.mean(ms_k), statistics.mean(ms_p))
        print(f"phase times: surround_fused kernel {statistics.mean(ms_k):.4f} ms (medians "
              f"{ms_k}), plain version {statistics.mean(ms_p):.4f} ms (medians {ms_p}) at B={B} "
              f"C={C} P=4 T={FS} [{gpu}]")
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
    shape [256, 2, 56192] (W=8192, hop 1920, F=25: the Hopper body), and at
    W=256 hop 1764 (the 44.1 kHz golden geometry: the generic body), raw
    mode also against torch.fft.rfft of the windowed frames, a NaN in one
    stream's left channel with +Inf in another stream's right channel, and
    an odd hop (the first pass's scalar loads).  Returns (max abs re/im
    error of the raw mode at the main-path shape, breaches)."""
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
        ("odd hop 1001 (frames off 8-byte alignment) W=8192 B=3 F=3", ANA_W, 1001, 3, 3, False),
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
    framing, window or epilogue), the kernel at B = 1 and 8 (a live
    meter's few streams), and each analyzer's x-realtime over
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
    few = {}
    for B in (1, 8):  # a live meter's few streams: B F CTAs, under one a SM
        e, w, _ = stft_inputs(B, ANA_W, ANA_HOP, ANA_F, 17 + B, dev)
        few[B] = cuda_ms(lambda: stft_fused.analyzer_frames(e, w, ANA_HOP, "phasewheel", ANA_THR),
                         10)
    print(f"phase times: stft_fused kernel at B=1 {few[1]:.4f} ms, B=8 {few[8]:.4f} ms (phasewheel "
          f"mode, W={ANA_W} hop {ANA_HOP} F={ANA_F}) [{gpu}]")
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


def sigdist_kernel_cases(dev):
    """sigdist_fused against SigDistMeter._plain_update on the same state
    (one plain update of history) and block: channel 0 of [256, 2, 48000]
    (the main-path shape, rows strided), and B=4 T=4800 with NaN, +-Inf
    and half-integer bin edges, one row not integrating and one at the
    2^31 time cap.  hist, n and time exact; mean, m2 and total within 1e-5
    of each leaf's scale with NaN alike (float32 sums in another order).
    Returns (the largest of those differences over its scale at the
    main-path shape, breaches)."""
    import torch

    from meters_lv2_torch.models.sigdist import SigDistMeter
    from meters_lv2_torch.ops import sigdist_fused

    rng = np.random.default_rng(28)
    m = SigDistMeter(FS)
    failures, main_err = [], 0.0
    for tag, B, T, odd in [(f"main-path shape channel 0 of [{B_MAIN}, 2, {FS}]", B_MAIN, FS, False),
                           ("NaN/+-Inf, bin edges, cap: channel 0 of [4, 2, 4800]", 4, 4800, True)]:
        x = (0.05 * rng.standard_normal((2, B, 2, T))).astype(np.float32)
        if odd:
            edges = ((np.arange(-1, 362) + 0.5 - 180.0) / 150.0).astype(np.float32)
            x[1, 0, 0, :edges.size] = edges
            x[1, 0, 0, 500:503] = (np.nan, np.inf, -np.inf)
        hd, xd = (torch.as_tensor(a, device=dev)[:, 0] for a in x)
        st = m._plain_update(m.init((B,), device=dev), hd)
        if odd:
            st.integrating[1] = False
            st.time[2] = 2**31 - 1 - T
        n0 = sigdist_fused.launch_count
        got = sigdist_fused.sigdist_fused(st.hist, st.n, st.mean, st.m2, st.total, st.time,
                                          st.integrating, xd)
        ref = m._plain_update(st, xd)
        errs = [] if sigdist_fused.launch_count == n0 + 1 else ["not one launch"]
        errs += [f"{k} not exact" for k, g in zip(("hist", "n"), got[:2]) if not torch.equal(
            g, getattr(ref, k))]
        if not torch.equal(got[5], ref.time):
            errs.append("time not exact")
        worst = 0.0
        for k, g in zip(("mean", "m2", "total"), got[2:5]):
            r = getattr(ref, k)
            if not torch.equal(torch.isnan(g), torch.isnan(r)):
                errs.append(f"{k} NaN positions differ")
            f = torch.isfinite(r)
            scale = r[f].abs().max().item() if bool(f.any()) else 0.0
            e = (g[f] - r[f]).abs().max().item() / scale if scale else 0.0
            worst = max(worst, e)
            if e > 1e-5:
                errs.append(f"{k} {e:.3g} of its scale")
        if B == B_MAIN:
            main_err = worst
        print(f"  sigdist_fused {tag}: hist, n, time exact {not any('exact' in e for e in errs)}; "
              f"mean, m2, total worst {worst:.3g} of scale: "
              f"{'ok' if not errs else 'FAIL ' + '; '.join(errs)}")
        failures += [f"sigdist_fused {tag}: {e}" for e in errs]
    return main_err, failures


def wide_kernel_cases(dev):
    """surround_fused's wide layout against its plain version and against the
    narrow kernel at the narrow kernel's bars (km_z, zl and pk bit-identical to
    the narrow kernel: the same operations), at C=5 and C=8 with B=256, 8
    (a cluster of CTAs a stream) and 1 at T=48000, with runtime pairs, and
    with NaN / +Inf / -Inf samples.
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
        (f"B=8 C=5 T={FS}, pairs 0:4 1:1 4:0 2:1, NaN/+Inf/-Inf", 5, 8, FS,
         [[0, 4], [1, 1], [4, 0], [2, 1]], True),
        (f"B=8 C=8 T={FS}", 8, 8, FS, None, False),
        (f"B=1 C=5 T={FS}", 5, 1, FS, None, False),
        (f"B=1 C=8 T={FS}, NaN/+Inf/-Inf", 8, 1, FS, None, True),
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
# and through spectrum_fused and r128_fused
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


def r128_carried(dev, blocks_dev):
    """N_CARRIED x 1 s of the main-path blocks at B=256 C=2 through
    r128_fused and its plain version, each carrying its own K-weighting
    state and history: p, z, hist and tpmax of every call held at the bars
    of phase kernels (P_RTOL + P_FLOOR, Z_SCALE, bit-exact, TP_RTOL), and
    seg mode on the same carried inputs, its fragment offset advancing by
    a block a call, at the seg bar (2e-6 relative), with z, hist and tpmax
    bit-identical to the full-rate call.  The kernel's summation order must
    not drift away from the plain version's over a minute."""
    import torch

    from meters_lv2_torch.ops import design, lti, r128_fused

    op = lti.LTISystem(*design.k_weighting_state_space(FS)).op(128)
    gains = r128_fused.gains_f32(design.R128_CHAN_GAIN[:2])
    zero = (torch.zeros((B_MAIN, 2, 4), device=dev), torch.zeros((B_MAIN, 2, 47), device=dev))
    carry = {"kernel": zero, "plain": zero}
    off0 = np.random.default_rng(5).integers(0, FRAGM, B_MAIN)
    worst = {"p": 0.0, "z": 0.0, "tpmax": 0.0, "seg": 0.0}
    for i in range(N_CARRIED):
        x = blocks_dev[i % len(blocks_dev)]
        off = torch.as_tensor(((off0 + i * FS) % FRAGM).astype(np.int32), device=dev)
        seg_kw = dict(off=off, fragm=FRAGM, n_slots=N_SLOTS)
        out, seg = {}, {}
        for name, fn in (("kernel", r128_fused.fused_core),
                         ("plain", r128_fused.fused_core_reference)):
            z, h = carry[name]
            out[name] = fn(x, z, h, gains, op)
            seg[name] = fn(x, z, h, gains, op, **seg_kw)
            carry[name] = out[name][1], out[name][2]
        got, ref = out["kernel"], out["plain"]
        if not all(same_nonfinite(a, b) for a, b in zip(got, ref)):
            fail(f"r128_fused carried, call {i}: non-finite values differ")
        if not torch.equal(got[2], ref[2]):
            fail(f"r128_fused carried, call {i}: hist not bit-exact")
        if not all(same_bits(a, b) for a, b in zip(seg["kernel"][1:], got[1:])):
            fail(f"r128_fused carried, call {i}: seg mode's z, hist, tpmax differ from full rate")
        p, pr = got[0].double(), ref[0].double()
        z, zr = got[1].double(), ref[1].double()
        t, tr = got[3].double(), ref[3].double()
        sg, sr = seg["kernel"][0].double(), seg["plain"][0].double()
        ratios = {
            "p": ((p - pr).abs() / (P_RTOL * pr.abs() + P_FLOOR * pr.abs().max())).max().item(),
            "z": ((z - zr).abs() / (Z_SCALE * zr.abs().amax(dim=(0, 1)))).max().item(),
            "tpmax": ((t - tr).abs() / (TP_RTOL * tr.abs())).max().item(),
            "seg": ((sg - sr).abs() / (2e-6 * sr.abs() + 1e-9)).max().item(),
        }
        for k, v in ratios.items():
            worst[k] = max(worst[k], v)
        if not all(v <= 1.0 for v in ratios.values()):
            fail(f"r128_fused carried, call {i}: error over its bar {ratios}")
    print(f"phase main: ok: r128_fused {N_CARRIED} x 1 s carried through the kernel and its "
          f"plain version at B={B_MAIN} C=2 T={FS}, both modes: worst error over its bar "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + " (<= 1 passes); hist bit-exact; seg mode's z, hist, tpmax identical to full rate")


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
              f"{ms[True]}), serial {res[N][1]:.4f} ms (medians {ms[False]}), alternated; byte "
              f"bound {4 * N * FS / HBM_BPS * 1e3:.4f} ms [{gpu}]")
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
    plain version's ms are the narrow phase's, the same function), each
    at B = 1, 8 and 256 beside its bound; surround5 and surround8
    x-realtime with the wide layout on.  Returns {name: (ms, plain ms)} for
    the kernels JSON line, and under "wide by shape" {"B=.. C=..": [wide
    ms, narrow ms, bound ms]}."""
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

    out["wide by shape"] = {}
    for B in (1, 8, B_MAIN):
        for C in (5, 8):
            args = surround_args(C, B, FS, 7, dev)
            wide, narrow = [], []
            for w in "nwwn":
                fn = surround_fused.fused_core_wide if w == "w" else surround_fused.fused_core
                (wide if w == "w" else narrow).append(cuda_ms(lambda: fn(*args), 10))
            bnd, by = surround_bound(B, C, FS)
            out["wide by shape"][f"B={B} C={C}"] = [statistics.mean(wide),
                                                    statistics.mean(narrow), bnd]
            if B == B_MAIN:
                out[f"wide C={C}"] = (statistics.mean(wide), sur_plain[C])
            print(f"phase times: surround_fused wide layout {statistics.mean(wide):.4f} ms "
                  f"(medians {wide}), narrow {statistics.mean(narrow):.4f} ms (medians "
                  f"{narrow}), bound {bnd:.4f} ms ({by})"
                  + (f", plain version {sur_plain[C]:.4f} ms (phase times above)"
                     if B == B_MAIN else "") + f" at B={B} C={C} P=4 T={FS} [{gpu}]")
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


# -- phase ingest: WAV files through load_files, the pipeline and the CLI --
INGEST_N, INGEST_N5 = 256, 64  # stereo and 5-channel files
INGEST_SECONDS, INGEST_SECONDS5 = (4.0, 12.0), (4.0, 8.0)  # their lengths
INGEST_CHUNK = FS  # run_stream_ragged's step, 1 s
INGEST_CHECK = (0, 1, 2, 3)  # files held per file and against CPU runs, with
# the shortest and the longest
# ingest bars (the port's ragged test, tests/test_torch_pipeline.py): R128's
# hist_m bin-exact and its loudness within 1e-4; K20's rms rtol 1e-5; the
# correlation atol 1e-6; every other readout: integer leaves exact, float
# leaves within 1e-4 + 1e-4 |value| (0.001 dB of a linear level, 1e-4 of a
# dB one; the card against the CPU reads ~2e-6 dB in phase main), with the
# same non-finite entries.  The CLI's JSON, card against --cpu, at the same
# bar, but the phase wheel's and the stereoscope's maxima over every bin
# within INGEST_DISPLAY_TOL: they range over bins near the threshold, where
# the analyzers' bars (tests/test_torch_cuda.py::stft_close) hold no phase
# or position, and a phase at +-pi may land on the other side of the wrap.
INGEST_DISPLAY_TOL = 1e-2
INGEST_R128_KEYS = ("loudness_M", "loudness_S", "max_M", "integrated", "dbtp")


def write_pcm(path, data, rate, bits):
    """Planar float [C, T] as a WAV of PCM16, PCM24 or float32 (bits 16, 24,
    32), written with numpy: the native codec writes a sample at a time and
    no 24-bit."""
    inter = np.ascontiguousarray(np.asarray(data, np.float32).T)
    if bits == 32:
        payload, fmt = inter.astype("<f4").tobytes(), 3
    else:
        scale = np.float32(32767 if bits == 16 else 8388607)
        v = np.round(np.clip(inter, -1, 1) * scale).astype("<i4")
        payload = v.view(np.uint8).reshape(-1, 4)[:, : bits // 8].tobytes()
        fmt = 1
    c = inter.shape[1]
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, fmt, c, rate, rate * c * bits // 8, c * bits // 8,
                            bits))
        f.write(b"data" + struct.pack("<I", len(payload)) + payload)


def ingest_write(tmp, tag, n, C, lo_s, hi_s, seed):
    """n C-channel WAVs of lo_s..hi_s seconds (lengths drawn per sample, so
    most are not multiples of 4), a quarter at 44.1 kHz, PCM16, PCM24 and
    float32 in turn: a tone per channel, at a level and frequency drawn per
    file and channel, over 0.05 N(0,1) noise taken at a random offset of
    one seeded noise track, with a quieter first eighth.  Returns the
    paths."""
    rng = np.random.default_rng(seed)
    noise = np.float32(0.05) * rng.standard_normal((C, int(hi_s * FS) + FS), dtype=np.float32)
    paths = []
    for i in range(n):
        fs = 44100 if i % 4 == 3 else FS
        L = int(rng.integers(int(lo_s * fs), int(hi_s * fs) + 1))
        off = int(rng.integers(0, FS))
        t = np.arange(L, dtype=np.float32) / np.float32(fs)
        amp = rng.uniform(0.05, 0.5, (C, 1)).astype(np.float32)
        f0 = rng.uniform(60.0, 5000.0, (C, 1)).astype(np.float32)
        x = amp * np.sin(np.float32(2 * np.pi) * f0 * t) + noise[:, off : off + L]
        x[:, : L // 8] *= np.float32(0.1)
        p = os.path.join(tmp, f"{tag}{i:03d}.wav")
        write_pcm(p, x, fs, (16, 24, 32)[i % 3])
        paths.append(p)
    return paths


def ingest_pipeline(names, C, fs):
    from meters_lv2_torch.__main__ import build_meter
    from meters_lv2_torch.parallel.pipeline import MeterPipeline

    return MeterPipeline({n: build_meter(n, fs, C) for n in names}, nchan=C)


def ingest_cpu_run(npy, lengths, names, C, fs, chunk):
    """The pipeline of `names` over the files in `npy` ([B, C, T]) on CPU
    tensors, ragged; (host readouts, R128's hist_m or None).  Runs in a
    worker process."""
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    from meters_lv2_torch.io.stream import to_host

    pipe = ingest_pipeline(names, C, fs)
    st = pipe.run_stream_ragged(pipe.init((len(lengths),), device="cpu"),
                                torch.from_numpy(np.load(npy)), np.asarray(lengths), chunk)
    hist = st["r128"].hist_m.numpy() if "r128" in st else None
    return to_host(pipe.read(st)[0]), hist


def readout_leaves(o, path=""):
    if isinstance(o, dict):
        for k, v in sorted(o.items()):
            yield from readout_leaves(v, f"{path}.{k}")
    else:
        yield path, np.asarray(o)


def ingest_compare(got, i, want, j, tag):
    """Row i of batched host readouts `got` against row j of `want`, meter
    by meter, at the ingest bars; (the largest share of its bar that a
    float difference takes, errors)."""
    errs, worst = [], 0.0
    for name in want:
        lg, lw = list(readout_leaves(got[name])), list(readout_leaves(want[name]))
        if len(lg) != len(lw):
            errs.append(f"{tag} {name}: readouts differ")
        for (k, a), (k2, b) in zip(lg, lw):
            a, b = a[i], b[j]
            key = f"{tag} {name}{k}"
            if k != k2 or a.shape != b.shape:
                errs.append(f"{key}: leaves differ")
            elif a.dtype.kind in "iub":
                if not np.array_equal(a, b):
                    errs.append(f"{key}: integer leaf differs")
            elif not np.array_equal(np.isfinite(a), np.isfinite(b)) or not np.array_equal(
                    a[~np.isfinite(a)], b[~np.isfinite(b)]):
                errs.append(f"{key}: non-finite entries differ")
            else:
                fin = np.isfinite(b)
                d = np.abs(a[fin].astype(np.float64) - b[fin])
                if name == "r128" and k.lstrip(".") in INGEST_R128_KEYS:
                    bar = np.full(d.shape, 1e-4)
                elif name == "k20" and k == ".rms":
                    bar = 1e-5 * np.abs(b[fin])
                elif name == "cor":
                    bar = np.full(d.shape, 1e-6)
                else:
                    bar = 1e-4 + 1e-4 * np.abs(b[fin])
                if d.size:
                    worst = max(worst, float((d / np.maximum(bar, 1e-30)).max()))
                    if not (d <= bar).all():
                        errs.append(f"{key}: {float((d - bar).max()):.3g} over its bar")
    return worst, errs


def json_compare(a, b, path, errs):
    """The CLI's JSON, card against --cpu (ingest bars)."""
    if isinstance(b, dict):
        if set(a) != set(b):
            errs.append(f"{path}: keys differ")
            return
        for k in b:
            json_compare(a[k], b[k], f"{path}.{k}", errs)
    elif isinstance(b, list):
        if not isinstance(a, list) or len(a) != len(b):
            errs.append(f"{path}: lengths differ")
            return
        for n, (u, v) in enumerate(zip(a, b)):
            json_compare(u, v, f"{path}[{n}]", errs)
    elif isinstance(b, float) and a is not None:
        display = (".phasewheel." in path or ".stereoscope." in path) and path.endswith(".max")
        bar = INGEST_DISPLAY_TOL if display else 1e-4 + 1e-4 * abs(b)
        if not abs(a - b) <= bar:
            errs.append(f"{path}: {a} vs {b}")
    elif a != b:
        errs.append(f"{path}: {a} vs {b}")


def wrap_meters(pipe, host, annotate):
    """Wrap each meter's update in `pipe` to add its host ms to host[name]
    (the launches are asynchronous, so this is the enqueue) and, with
    `annotate`, to run inside a torch.profiler range "meter/<name>".
    Returns the function that takes the wrappers off."""
    from torch.profiler import record_function

    for name, m in pipe.meters.items():
        def upd(*a, _f=m.update, _n=name, **kw):
            t0 = time.perf_counter()
            with record_function(f"meter/{_n}") if annotate else contextlib.nullcontext():
                r = _f(*a, **kw)
            host[_n] += (time.perf_counter() - t0) * 1e3
            return r

        m.update = upd

    def undo():
        for m in pipe.meters.values():
            del m.update

    return undo


def collection_profile(pipe, st, x, lengths, chunk, trace_path):
    """One torch.profiler pass of the collection `pipe` (already run once)
    from state `st`, each meter's updates in a range of its own.  A device
    event goes to the meter whose range holds the runtime call that
    launched it, by the trace's correlation ids (which kernels launched
    through ctypes have too: no CPU op owns them).  Returns ({meter: host
    ms under the profiler}, {meter: device ms}, device ms of no meter's
    range, device busy ms (the union of the device events' intervals), the
    pass's wall ms)."""
    import bisect

    import torch
    from torch.profiler import ProfilerActivity, profile

    host = dict.fromkeys(pipe.meters, 0.0)
    undo = wrap_meters(pipe, host, annotate=True)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pipe.run_stream_ragged(st, x, lengths, chunk)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        undo()
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"][6:]) for e in events
                    if e.get("cat") == "user_annotation" and e["name"].startswith("meter/"))
    starts = [r[0] for r in ranges]
    dev = dict.fromkeys(pipe.meters, 0.0)
    outside = 0.0
    spans = []
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        spans.append((e["ts"], e["ts"] + e["dur"]))
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        k = bisect.bisect_right(starts, ts) - 1 if ts is not None else -1
        if k >= 0 and ts <= ranges[k][1]:
            dev[ranges[k][2]] += e["dur"] / 1e3
        else:
            outside += e["dur"] / 1e3
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return host, dev, outside, busy / 1e3, wall_ms


def r128_launches(s):
    """r128_fused's launches in one EbuR128Meter update of s samples: seg
    mode for a whole number of 128-sample blocks (the fragment, fs / 20, is
    longer than 128 samples at every rate here), the full-rate mode for a
    block with a tail, none for a block shorter than 128."""
    return {"r128_fused": s >= 128 and s % 128 != 0, "r128_fused_seg": s >= 128 and s % 128 == 0}


def predicted_launches(lengths, chunk, per_update):
    """Each kernel's launches in run_stream_ragged over streams of
    `lengths` (multiples of 4) at `chunk`: phase 1 takes the longest
    stream's whole chunks, phase 2 one tail level 4 << k for each bit
    that some stream's tail has.  per_update(s) gives the launches of one
    update of s samples by kernel; returns (counts, steps, levels)."""
    lengths = np.asarray(lengths)
    n_steps = int((lengths // chunk).max())
    q = (lengths % chunk) // 4
    levels = [4 << k for k in range(max(chunk // 4 - 1, 1).bit_length()) if (q >> k & 1).any()]
    want = {}
    for s, n in [(chunk, n_steps)] + [(s, 1) for s in levels]:
        for k, c in per_update(s).items():
            want[k] = want.get(k, 0) + n * c
    return want, n_steps, levels


def ingest_phase(dev, gpu, reset_counts, launch_counts):
    """The phase ingest (see the module docstring); returns the launches of
    each kernel in its pipeline runs, by kernels-line name."""
    import tempfile

    import torch

    from meters_lv2_torch.__main__ import DISPLAY_METERS, _run_display_meters, applicable_meters
    from meters_lv2_torch.io import batch as io_batch
    from meters_lv2_torch.io.stream import chunk_array, stream, stream_pipelined, to_host
    from meters_lv2_torch.runtime import native
    from meters_lv2_torch.utils.interop import state_to_numpy

    names = [n for n in applicable_meters(2) if n not in DISPLAY_METERS]
    pool = None
    procs = []
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ingest_") as tmp:
            t0 = time.perf_counter()
            paths = ingest_write(tmp, "s", INGEST_N, 2, *INGEST_SECONDS, 17)
            paths5 = ingest_write(tmp, "m", INGEST_N5, 5, *INGEST_SECONDS5, 18)
            cli_paths = ingest_write(tmp, "c", 8, 2, 1.0, 2.0, 19)
            write_s = time.perf_counter() - t0
            if native.load() is None:
                fail("ingest: the native WAV library did not load: "
                     + (native.BUILD_DIR / "build.log").read_text()[-2000:])
            t0 = time.perf_counter()
            decoded = native.wav_read_batch(paths)
            decode_s = time.perf_counter() - t0
            n44 = sum(r == 44100 for _, r in decoded)
            del decoded
            t0 = time.perf_counter()
            batch = io_batch.load_files(paths, target_rate=FS, device=dev)
            load_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            batch_cpu = io_batch.load_files(paths, target_rate=FS, device="cpu")
            load_cpu_s = time.perf_counter() - t0
            load_err = float(np.abs(batch.data - batch_cpu.data).max())
            if batch.data.shape != batch_cpu.data.shape or not load_err <= 1e-6:
                fail(f"ingest: load_files resampling on the card differs from the CPU by {load_err}")
            del batch_cpu
            B, C, T = batch.data.shape
            chunk = INGEST_CHUNK
            Tpad = -(-T // chunk) * chunk
            x = np.zeros((B, C, Tpad), np.float32)
            x[:, :, :T] = batch.data
            lengths = batch.lengths // 4 * 4
            seconds = float(lengths.sum()) / FS
            print(f"phase ingest: wrote {B} stereo files ({n44} at 44.1 kHz; PCM16, PCM24, "
                  f"float32), {INGEST_N5} 5-channel and 8 short ones in {write_s:.1f} s; native "
                  f"decode {decode_s:.3f} s, load_files(target_rate=48000) {load_s:.3f} s "
                  f"(decode, resample on the card, assemble; with the resampling on CPU "
                  f"tensors {load_cpu_s:.3f} s, max |difference| {load_err:.3g}) for "
                  f"{seconds:.1f} stream-seconds; batch "
                  f"[{B}, {C}, {T}], lengths {int(lengths.min())}..{int(lengths.max())} "
                  f"[{gpu}]")

            # the collection, timed: host-to-device copy, then both phases
            pipe = ingest_pipeline(names, C, FS)
            st0 = pipe.init((B,), device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            xd = torch.as_tensor(x).to(dev)
            torch.cuda.synchronize()
            h2d_ms = (time.perf_counter() - t0) * 1e3
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            marks = {}
            update = pipe.update

            def timed_update(state, xb, controls=None):
                if xb.shape[-1] != chunk and "mid" not in marks:
                    ev[1].record()
                    marks["mid"] = time.perf_counter()
                return update(state, xb, controls)

            pipe.update = timed_update
            reset_counts()
            t0 = time.perf_counter()
            ev[0].record()
            st = pipe.run_stream_ragged(st0, xd, lengths, chunk)
            if "mid" not in marks:
                ev[1].record()
                marks["mid"] = time.perf_counter()
            t_enq = time.perf_counter()
            out, _ = pipe.read(st)
            out = to_host(out)
            ev[2].record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            del pipe.update
            counts = launch_counts()
            p1_ms, p2_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])

            def stereo_update(s):
                # an update of s samples: the kernels take a block that is a
                # multiple of 128 (the truepeak_fused of dBTP, DR-14 and
                # TP+RMS), the plain tail ops a shorter one, where dBTP, DR-14
                # and TP+RMS run the serial ballistics body; DIN, NOR, BBC, EBU
                # and M-6 run the envelope body, and the bit meter and sigdist
                # their kernels, at every length
                big = s % 128 == 0
                return {**r128_launches(s), "truepeak_fused": 3 * big, "spectrum_fused": big,
                        "ballistics": 3 * (not big), "ballistics_envelope": 5,
                        "bitmeter_stats": 1, "sigdist_fused": 1}

            want, n_steps, levels = predicted_launches(lengths, chunk, stereo_update)
            n_small = sum(s % 128 != 0 for s in levels)
            want = {k: want.get(k, 0) for k in counts}
            if counts != want:
                fail(f"ingest: the collection's launches {counts} are not the {want} "
                     f"predicted from the lengths")
            for name, key in (("r128", "integrated"), ("r128", "dbtp"), ("k20", "rms"),
                              ("spectrum", "bands"), ("dr14", "dr_total"), ("truepeak", "peak")):
                v = out[name][key]
                if v.shape[0] != B or not np.isfinite(v).all():
                    fail(f"ingest: {name} {key} not finite of {B} files")
            xrt = seconds / wall
            print(f"phase ingest: ok: {len(names)} meters ({','.join(names)}) over {B} files by "
                  f"run_stream_ragged at chunk {chunk}: {n_steps} steps, {len(levels)} tail levels "
                  f"({n_small} below 128: {[s for s in levels if s < 128]}); launches {counts}, "
                  f"each as predicted from the lengths; host-to-device copy {h2d_ms:.1f} ms "
                  f"({x.nbytes / 1e6:.1f} MB); device timeline phase 1 {p1_ms:.1f} ms, phase 2 "
                  f"and read {p2_ms:.1f} ms; host enqueue phase 1 "
                  f"{(marks['mid'] - t0) * 1e3:.1f} ms, phase 2 {(t_enq - marks['mid']) * 1e3:.1f} "
                  f"ms; wall {wall:.3f} s (the meters' first use): {xrt:.1f} x-realtime ({seconds:.1f} stream-seconds; "
                  f"with the copy {seconds / (wall + h2d_ms / 1e3):.1f}, with load_files too "
                  f"{seconds / (wall + h2d_ms / 1e3 + load_s):.1f}) [{gpu}]")
            # the timed run was the meters' first use, as in the CLI; a second
            # pass, warm, gives each meter's host time, and a third under the
            # profiler its device time
            host_ms = dict.fromkeys(names, 0.0)
            undo = wrap_meters(pipe, host_ms, annotate=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.run_stream_ragged(st0, xd, lengths, chunk)
            torch.cuda.synchronize()
            warm = time.perf_counter() - t0
            undo()
            t0 = time.perf_counter()
            prof_host, dev_ms, outside_ms, busy_ms, prof_wall_ms = collection_profile(
                pipe, st0, xd, lengths, chunk, os.path.join(tmp, "collection_trace.json"))
            print(f"phase ingest: a warm pass of the collection {warm:.3f} s: "
                  f"{seconds / warm:.1f} x-realtime; by meter, host ms in its updates in that pass "
                  f"/ device ms in one torch.profiler pass of the same collection: "
                  + ", ".join(f"{n} {host_ms[n]:.1f} / {dev_ms[n]:.1f}" for n in names)
                  + f"; sums {sum(host_ms.values()):.1f} / {sum(dev_ms.values()):.1f} ms "
                  f"({outside_ms:.1f} ms of device time in no meter's range); the profiled "
                  f"pass: wall {prof_wall_ms:.1f} ms (the warm pass's {warm * 1e3:.1f}), host "
                  f"ms in the meters' updates {sum(prof_host.values()):.1f}, the device busy "
                  f"{busy_ms:.1f} ms, {100 * busy_ms / prof_wall_ms:.1f} % of its wall; "
                  f"{time.perf_counter() - t0:.1f} s [{gpu}]")

            # the checks: CPU runs in worker processes and the CLI in two
            # subprocesses, while the card runs the per-file and other checks
            order = np.argsort(lengths, kind="stable")
            check = list(dict.fromkeys([*INGEST_CHECK, int(order[0]), int(order[-1])]))
            T6 = int(max(lengths[check]))
            x6 = np.ascontiguousarray(x[check, :, : -(-T6 // chunk) * chunk])
            npy = os.path.join(tmp, "check.npy")
            np.save(npy, x6)
            t_checks = time.perf_counter()
            pool = multiprocessing.get_context("spawn").Pool(5)
            jobs = {n: pool.apply_async(ingest_cpu_run, (npy, lengths[check], [n], C, FS, chunk))
                    for n in names}
            pool.close()
            cli = [sys.executable, "-m", "meters_lv2_torch", *cli_paths, "--meters", "all",
                   "--json", "--target-rate", str(FS), "--chunk-seconds", "0.5"]
            for extra in ([], ["--cpu"]):  # one intra-op thread each: the cores are shared
                procs.append(subprocess.Popen(cli + extra, cwd=ROOT, stdout=subprocess.PIPE,
                                              stderr=subprocess.PIPE, text=True,
                                              env={**os.environ, "OMP_NUM_THREADS": "1"}))

            # per file on the card, each file alone through the same pipeline
            worst_pf, errs = 0.0, []
            for i in check:
                p1 = ingest_pipeline(names, C, FS)
                Ti = -(-int(lengths[i]) // chunk) * chunk
                s1 = p1.run_stream_ragged(p1.init((1,), device=dev), xd[i : i + 1, :, :Ti],
                                          lengths[i : i + 1], chunk)
                o1 = to_host(p1.read(s1)[0])
                if not torch.equal(st["r128"].hist_m[i].cpu(), s1["r128"].hist_m[0].cpu()):
                    errs.append(f"file {i}: hist_m differs")
                w, e = ingest_compare(out, i, o1, 0, f"file {i} alone on the card")
                worst_pf, errs = max(worst_pf, w), errs + e
            if errs:
                fail("ingest: batch against per-file runs: " + " | ".join(errs[:10]))

            # stream_pipelined against stream, bit for bit: the collection
            # over the first 64 files' padded 1 s blocks
            n64 = min(64, B)
            blocks = list(chunk_array(x[:n64, :, :T], chunk))
            pipe64 = ingest_pipeline(names, C, FS)
            t0 = time.perf_counter()
            sa = stream(pipe64, pipe64.init((n64,), device=dev), blocks)
            torch.cuda.synchronize()
            ta = time.perf_counter() - t0
            t0 = time.perf_counter()
            sb = stream_pipelined(pipe64, pipe64.init((n64,), device=dev), blocks, depth=2)
            torch.cuda.synchronize()
            tb = time.perf_counter() - t0
            la = list(readout_leaves(state_to_numpy(sa)))
            lb = list(readout_leaves(state_to_numpy(sb)))
            if len(la) != len(lb) or not all(
                    k == k2 and np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
                    for (k, a), (k2, b) in zip(la, lb)):
                fail("ingest: stream_pipelined differs from stream on the card")

            # 5-channel files: R128 and surround
            b5 = io_batch.load_files(paths5, target_rate=FS, device=dev)
            len5 = b5.lengths // 4 * 4
            T5 = -(-b5.data.shape[-1] // chunk) * chunk
            x5 = torch.zeros((INGEST_N5, 5, T5), device=dev)
            x5[..., : b5.data.shape[-1]] = torch.as_tensor(b5.data, device=dev)
            p5 = ingest_pipeline(["r128", "surround"], 5, FS)
            reset_counts()
            s5 = p5.run_stream_ragged(p5.init((INGEST_N5,), device=dev), x5, len5, chunk)
            o5 = to_host(p5.read(s5)[0])
            c5 = launch_counts()
            want5, _, _ = predicted_launches(len5, chunk, lambda s: {
                **r128_launches(s), "surround_fused": s % 128 == 0})
            want5 = {k: want5.get(k, 0) for k in c5}
            if c5 != want5:
                fail(f"ingest: the 5-channel collection's launches {c5} are not the {want5} "
                     f"predicted from the lengths")
            if not np.isfinite(o5["surround"]["level"]).all() or o5["surround"]["level"].shape != (
                    INGEST_N5, 5):
                fail("ingest: surround levels not finite of shape (64, 5)")
            w5, e5 = 0.0, []
            for i in (0, int(np.argmin(len5)), int(np.argmax(len5))):
                Ti = -(-int(len5[i]) // chunk) * chunk
                q5 = ingest_pipeline(["r128", "surround"], 5, FS)
                r5 = to_host(q5.read(q5.run_stream_ragged(q5.init((1,), device=dev),
                                                          x5[i : i + 1, :, :Ti], len5[i : i + 1],
                                                          chunk))[0])
                w, e = ingest_compare(o5, i, r5, 0, f"5-channel file {i} alone")
                w5, e5 = max(w5, w), e5 + e
            if e5:
                fail("ingest: " + " | ".join(e5[:10]))

            # the display meters on the trailing window, as the CLI runs them
            reset_counts()
            disp = _run_display_meters(["phasewheel", "stereoscope"], x, lengths, FS, dev)
            torch.cuda.synchronize()
            n_stft = launch_counts()["stft_fused"]
            if n_stft != 2:
                fail(f"ingest: _run_display_meters launched stft_fused {n_stft} times, not 2")
            if disp["phasewheel"]["phase"].shape[0] != B:
                fail("ingest: display readouts not of the batch")

            # the CPU runs and the CLI
            t_card = time.perf_counter() - t_checks
            worst_cpu, errs = 0.0, []
            for n, job in jobs.items():
                cpu_out, cpu_hist = job.get(timeout=600)
                if cpu_hist is not None and not np.array_equal(
                        st["r128"].hist_m[check].cpu().numpy(), cpu_hist):
                    errs.append("R128 hist_m differs from the CPU run")
                for j, i in enumerate(check):
                    w, e = ingest_compare({n: out[n]}, i, cpu_out, j, f"file {i} vs CPU")
                    worst_cpu, errs = max(worst_cpu, w), errs + e
            if errs:
                fail("ingest: card against CPU runs: " + " | ".join(errs[:10]))
            t_cpu = time.perf_counter() - t_checks
            res = []
            for pr in procs:
                so, se = pr.communicate(timeout=600)
                if pr.returncode != 0:
                    fail(f"ingest: CLI {' '.join(pr.args[3:])} exited {pr.returncode}: {se[-2000:]}")
                res.append(json.loads(so))
            errs = []
            json_compare(res[0], res[1], "rows", errs)
            if errs:
                fail("ingest: the CLI on the card against --cpu: " + " | ".join(errs[:10]))
            print(f"phase ingest: ok: files {check} in the batch against each alone on the card "
                  f"(the worst float difference at {worst_pf:.3g} of its bar) and against CPU "
                  f"runs ({worst_cpu:.3g} of its bar), hist_m exact; 5-channel: r128 and surround "
                  f"over {INGEST_N5} files, launches {c5} as predicted from the lengths, 3 files "
                  f"alone at {w5:.3g} of the bar; "
                  f"the checks took {time.perf_counter() - t_checks:.1f} s (the card's "
                  f"{t_card:.1f} s of it, CPU runs collected at {t_cpu:.1f} s); "
                  f"stream_pipelined equals stream bit for bit "
                  f"over {n64} files x {len(blocks)} blocks ({tb:.3f} s against {ta:.3f} s); "
                  f"_run_display_meters: stft_fused {n_stft} launches; python -m meters_lv2_torch "
                  f"--meters all --json on 8 files equals --cpu at the bars [{gpu}]")
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
        if pool is not None:
            pool.terminate()
            pool.join()
    return {k: counts[k] + c5[k] + (n_stft if k == "stft_fused" else 0) for k in counts}


# -- phase live: the live shell (meters_lv2_torch.live) at B=1 -----------------
# Three card engines against the same engines on CPU tensors (in worker
# processes), each replaying the card engine's feeds and readouts: stereo
# --meters all (20 meters) over LIVE_SECONDS of seeded tones and noise by
# feed_file(speed=0) at the shell's 0.5 s chunk with a dashboard readout and
# the 20 PNG frames after every feed; a second stereo engine (one or more
# meters of every kernel) fed from an os.pipe with ragged writes through
# feed_stream; --stdin at --meters all, fed through feed_stream by a writer
# in real time and timed as the first (not replayed on the CPU: its kernels
# run at the same shapes in the other engines); and --meters all on 5
# channels over LIVE_SECONDS5.  Readouts at ingest_compare's bars (the
# display meters at analyzer_diff's), R128's hist_m exact.
LIVE_SECONDS, LIVE_SECONDS5, LIVE_PIPE_SECONDS = 8.0, 4.0, 2.0
LIVE_CHUNK = FS // 2  # the shell's default --chunk-seconds 0.5: 187 x 128 + 64
LIVE_WRITES = (997 * 8, 1531 * 8 + 4, 61, 4099 * 8 + 12)  # the pipe writer's pieces, bytes
LIVE_WORKERS = 8  # the CPU engines' worker processes
LIVE_POOL = None  # their pool, from phase main to the end of phase live
LIVE_SIG2, LIVE_SIG5, LIVE_SIGP = (2, LIVE_SECONDS, 31), (5, LIVE_SECONDS5, 33), (2, LIVE_PIPE_SECONDS, 32)
LIVE_SIGS = (2, 4.0, 35)  # the --stdin run's signal, written in real time
LIVE_PIPE_PACE = 2.0  # the writer's pace in x realtime: slower than the reader, so reads are ragged
# the pipe-fed engine's meters: one or more of every kernel's meters (DR-14
# and TP+RMS add only truepeak_fused launches, and their CPU runs are long)
LIVE_PIPE_METERS = ("r128", "truepeak", "vu", "din", "bbcms", "k20", "cor", "spectrum",
                    "sigdist", "bitmeter", "goniometer", "phasewheel", "stereoscope")


def live_signal(C, seconds, seed):
    """[C, T] float32: a tone per channel at a level and frequency drawn from
    the seed, over 0.05 N(0, 1), the first eighth 20 dB down."""
    rng = np.random.default_rng(seed)
    T = int(seconds * FS)
    t = np.arange(T, dtype=np.float32) / np.float32(FS)
    amp = rng.uniform(0.05, 0.5, (C, 1)).astype(np.float32)
    f0 = rng.uniform(60.0, 5000.0, (C, 1)).astype(np.float32)
    x = amp * np.sin(np.float32(2 * np.pi) * f0 * t) + np.float32(0.05) * rng.standard_normal(
        (C, T), dtype=np.float32)
    x[:, : T // 8] *= np.float32(0.1)
    return x


def live_groups(names):
    """The meters split for the CPU workers, the longest runs first: the
    true-peak meters alone (their plain version is a Python loop), the PPM
    needles in pairs, the rest together."""
    heavy = [n for n in names if n in ("truepeak", "dr14", "tpnrms")]
    ppm = [n for n in names if n in ("din", "nor", "bbc", "ebu", "bbcms")]
    rest = [n for n in names if n not in heavy and n not in ppm]
    return [[n] for n in heavy] + [ppm[i:i + 2] for i in range(0, len(ppm), 2)] + [rest]


def live_worker_init():
    """A phase live worker: torch and the live shell imported once, one
    intra-op thread (the cores are shared)."""
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    import meters_lv2_torch.live  # noqa: F401


def live_script(seconds, reads):
    """feed_file's blocks of `seconds` at LIVE_CHUNK, each followed by a
    readout when `reads`: a card engine's script, known before it runs."""
    T = int(seconds * FS)
    script = []
    for i in range(0, T, LIVE_CHUNK):
        script += [min(LIVE_CHUNK, T - i)] + (["read"] if reads else [])
    return script


def live_cpu_start():
    """Start the CPU engines of phase live's stereo and 5-channel runs,
    whose feeds and readouts are known in advance, in LIVE_WORKERS worker
    processes; phase main starts them, and they run through phases main
    and golden, which time nothing.  Returns {(run, group): result}."""
    global LIVE_POOL
    from meters_lv2_torch.__main__ import applicable_meters

    LIVE_POOL = multiprocessing.get_context("spawn").Pool(LIVE_WORKERS, initializer=live_worker_init)
    jobs = {}
    for run, names, C, sig, script in (
            ("stereo", applicable_meters(2), 2, LIVE_SIG2, live_script(LIVE_SECONDS, True)),
            ("5ch", applicable_meters(5), 5, LIVE_SIG5, live_script(LIVE_SECONDS5, False))):
        for g in live_groups(names):
            jobs[run, tuple(g)] = LIVE_POOL.apply_async(live_cpu_run, (g, C, sig, script))
    return jobs


def stop_live_workers():
    global LIVE_POOL
    if LIVE_POOL is not None:
        LIVE_POOL.terminate()
        LIVE_POOL.join()
        LIVE_POOL = None


def live_cpu_run(names, C, sig, script):
    """A LiveEngine of `names` on CPU tensors replaying `script` (a feed's
    length, or "read" for a readout) over live_signal(*sig); (the final
    snapshot, R128's hist_m or None, the ring).  Runs in a worker process
    started by live_worker_init."""
    from meters_lv2_torch.live import LiveEngine

    x = live_signal(*sig)
    eng = LiveEngine(names, FS, C, device="cpu")
    off = 0
    for act in script:
        if act == "read":
            eng.snapshot()
        else:
            eng.feed(x[:, off: off + act])
            off += act
    snap = eng.snapshot()
    hist = eng._state["r128"].hist_m.numpy() if "r128" in names else None
    return snap, hist, eng._ring


def live_update(names):
    """The kernels' launches in one pipeline update of s samples through
    `names`: the 128-aligned bulk runs r128_fused (r128_launches),
    truepeak_fused (dBTP, DR-14, TP+RMS), spectrum_fused and
    surround_fused; a tail of s % 128 samples the plain ops, where dBTP,
    DR-14 and TP+RMS run the serial ballistics body; the PPM needles and
    BBC M-6 run the envelope body, and the bit meter and sigdist their
    kernels, at every length."""
    n_tp = sum(n in names for n in ("truepeak", "dr14", "tpnrms"))
    n_env = sum(n in names for n in ("din", "nor", "bbc", "ebu", "bbcms"))

    def per(s):
        big, tail = s >= 128, s % 128 != 0
        r128 = {k: v * ("r128" in names) for k, v in r128_launches(s).items()}
        return {**r128, "truepeak_fused": n_tp * big,
                "spectrum_fused": big * ("spectrum" in names),
                "surround_fused": big * ("surround" in names), "ballistics": n_tp * tail,
                "ballistics_envelope": n_env, "bitmeter_stats": int("bitmeter" in names),
                "sigdist_fused": int("sigdist" in names)}
    return per


def live_predict(script, per_update, n_display):
    """Launches predicted for a script: each feed's 4-aligned prefix through
    per_update, and stft_fused once per display analyzer at each readout
    (and the final one when the script does not end with a readout)."""
    want = {}
    for act in script:
        if act == "read":
            want["stft_fused"] = want.get("stft_fused", 0) + n_display
        elif act // 4:
            for k, c in per_update(act // 4 * 4).items():
                want[k] = want.get(k, 0) + int(c)
    if script and script[-1] != "read":
        want["stft_fused"] = want.get("stft_fused", 0) + n_display
    return want


def live_phase(dev, gpu, reset_counts, launch_counts, jobs):
    """The phase live (see the module docstring), with `jobs` from
    live_cpu_start; returns each kernel's launches in its four engine
    runs, by kernels-line name."""
    import tempfile
    import threading
    import urllib.error
    import urllib.request

    import torch

    from meters_lv2_torch.__main__ import DISPLAY_METERS, applicable_meters
    from meters_lv2_torch.live import LiveEngine, feed_file, feed_stream, make_server
    from meters_lv2_torch.ops import stft_fused
    from meters_lv2_torch.utils.interop import tree_flatten

    t_phase = time.perf_counter()
    names = applicable_meters(2)
    names5 = applicable_meters(5)
    pipe_names = [n for n in names if n not in DISPLAY_METERS]

    def on_card(eng, what):
        leaves = [t for t in tree_flatten(eng._state)[0] if isinstance(t, torch.Tensor)]
        if not leaves or not all(t.is_cuda for t in leaves):
            fail(f"live: a state tensor left the card after {what}")

    def check_counts(counts, want, what):
        want = {k: want.get(k, 0) for k in counts}
        if counts != want:
            fail(f"live: {what}: launches {counts} are not the {want} predicted from the feeds")

    def dashboard(e):
        """Wrap e.feed with a readout and the 20 PNG frames after each feed,
        as a browser at any --fps sees each generation; returns the lists
        the wrapper fills: each feed's ms with and without its card work
        (enqueue), the generation's and the frames' ms, and the script of
        feeds and readouts."""
        t = {"feed": [], "enq": [], "gen": [], "png": [], "script": []}
        feed = e.feed

        def wrapped(block):
            t0 = time.perf_counter()
            feed(block)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            e.snapshot()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            for n in e.names:
                if e.frame(n)[:8] != b"\x89PNG\r\n\x1a\n":
                    fail(f"live: frame({n}) is not a PNG")
            t4 = time.perf_counter()
            t["enq"].append((t1 - t0) * 1e3)
            t["feed"].append((t2 - t0) * 1e3)
            t["gen"].append((t3 - t2) * 1e3)
            t["png"].append((t4 - t3) * 1e3)
            t["script"].extend([block.shape[-1], "read"])

        e.feed = wrapped
        return t

    def through_pipe(e, x, pace):
        """x written down an os.pipe in LIVE_WRITES pieces at `pace` x
        realtime by a thread, read by feed_stream at the shell's chunk;
        (frames fed, seconds from the first write to the end of the
        card's work)."""
        payload = np.ascontiguousarray(x.T, "<f4").tobytes()
        rfd, wfd = os.pipe()

        def writer():
            off = i = 0
            t_w = time.perf_counter()
            try:
                while off < len(payload):
                    n = LIVE_WRITES[i % len(LIVE_WRITES)]
                    os.write(wfd, payload[off: off + n])
                    off, i = off + n, i + 1
                    lag = off / (8 * FS * pace) - (time.perf_counter() - t_w)
                    if lag > 0:
                        time.sleep(lag)
            finally:
                os.close(wfd)

        wt = threading.Thread(target=writer)
        t0 = time.perf_counter()
        wt.start()
        with os.fdopen(rfd, "rb") as fh:
            fed = feed_stream(e, fh, 2, fmt="f32", chunk=LIVE_CHUNK)
        wt.join()
        torch.cuda.synchronize()
        return fed, time.perf_counter() - t0

    t_wait = time.perf_counter()
    for job in jobs.values():  # the stereo and 5-channel CPU engines: nothing else loads the host
        job.wait()
    t_wait = time.perf_counter() - t_wait
    try:
        # -- the stereo engine, timed: a dashboard readout and the 20 frames
        # after every feed, as a browser at any --fps sees each generation
        x2 = live_signal(*LIVE_SIG2)
        eng = LiveEngine(names, FS, 2, device=dev)
        if eng.device.type != "cuda":
            fail("live: LiveEngine did not take the card")
        on_card(eng, "init")
        td = dashboard(eng)
        t_feed, script = td["feed"], td["script"]
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feed_file(eng, x2, FS, LIVE_CHUNK, speed=0.0)
        wall = time.perf_counter() - t0
        del eng.feed
        counts = launch_counts()
        check_counts(counts, live_predict(script, live_update(names), 2), "stereo --meters all")
        live_counts = dict(counts)
        if eng.fed_samples != x2.shape[-1]:
            fail(f"live: fed {eng.fed_samples} of {x2.shape[-1]} samples")
        snap = eng.snapshot()
        hist = eng._state["r128"].hist_m.cpu().numpy()
        ring = eng._ring.copy()
        med = {k: statistics.median(td[k]) for k in ("feed", "enq", "gen", "png")}
        per_s = 2 * (med["feed"] + med["gen"] + med["png"])  # 2 feeds a second at 0.5 s
        print(f"phase live: stereo --meters all ({len(names)} meters, {len(pipe_names)} in the "
              f"pipeline) at B=1 over {LIVE_SECONDS:.0f} s by feed_file(speed=0) in "
              f"{len(t_feed)} feeds of {LIVE_CHUNK} samples, a readout and the {len(names)} PNG "
              f"frames after each: per feed {med['feed']:.2f} ms (median; enqueue "
              f"{med['enq']:.2f} ms; min {min(t_feed):.2f}, max {max(t_feed):.2f}, the first "
              f"{t_feed[0]:.2f}, the meters' first use); unpaced x-realtime feeding alone "
              f"{LIVE_CHUNK / FS / (med['feed'] / 1e3):.2f} warm (the median feed), "
              f"{LIVE_SECONDS / (sum(t_feed) / 1e3):.2f} over the run with the first use, "
              f"{LIVE_SECONDS / wall:.2f} with the readouts and frames; per "
              f"generation _outs (read + 3 display process) {med['gen']:.2f} ms, the {len(names)} "
              f"frames {med['png']:.2f} ms; launches {counts}, as predicted [{gpu}]")
        print(f"phase live: realtime headroom at --meters all --fps 10 --speed 1: per second of "
              f"audio 2 feeds + 2 generations + 2 x {len(names)} PNG frames = {per_s:.1f} ms of "
              f"1000 ({per_s / 10:.1f} % of realtime, headroom {1000 / per_s:.2f}x) [{gpu}]")

        # -- the 5-channel engine: --meters all, r128 at C=5 and surround5
        x5 = live_signal(*LIVE_SIG5)
        e5 = LiveEngine(names5, FS, 5, device=dev)
        reset_counts()
        feed_file(e5, x5, FS, LIVE_CHUNK, speed=0.0)
        snap5 = e5.snapshot()
        torch.cuda.synchronize()
        script5 = live_script(LIVE_SECONDS5, False)
        c5 = launch_counts()
        check_counts(c5, live_predict(script5, live_update(names5), 0), "5-channel --meters all")
        if snap5["surround"]["level"].shape != (5,) or not np.isfinite(snap5["surround"]["level"]).all():
            fail("live: surround5 levels not finite of shape (5,)")

        # -- the pipe-fed engine: ragged writes, gathered into feeds of a chunk
        xp = live_signal(*LIVE_SIGP)
        ep = LiveEngine(list(LIVE_PIPE_METERS), FS, 2, device=dev)
        sizes = []
        pfeed = ep.feed

        def rec(block):
            sizes.append(block.shape[-1])
            pfeed(block)

        ep.feed = rec
        reset_counts()
        fed, t_pipe = through_pipe(ep, xp, LIVE_PIPE_PACE)
        del ep.feed
        snapp = ep.snapshot()
        torch.cuda.synchronize()
        cp = launch_counts()
        check_counts(cp, live_predict(sizes, live_update(LIVE_PIPE_METERS), 2), "pipe-fed")
        if fed != xp.shape[-1] or ep.fed_samples != fed or sum(sizes) != fed:
            fail(f"live: feed_stream fed {fed} of {xp.shape[-1]} frames")
        odd = sorted({s % 128 for s in sizes} - {0})

        # -- --stdin at --meters all: a producer in real time, each feed with
        # a readout and the 20 frames after it, as the stereo engine's
        xs = live_signal(*LIVE_SIGS)
        es = LiveEngine(names, FS, 2, device=dev)
        ts = dashboard(es)
        reset_counts()
        fed_s, wall_s = through_pipe(es, xs, 1.0)
        del es.feed
        cs = launch_counts()
        check_counts(cs, live_predict(ts["script"], live_update(names), 2), "--stdin")
        if fed_s != xs.shape[-1] or es.fed_samples != fed_s:
            fail(f"live: --stdin fed {fed_s} of {xs.shape[-1]} frames")
        if not np.array_equal(es._ring, xs[:, -es._ring.shape[-1]:]):
            fail("live: --stdin's ring is not the signal's last window")
        on_card(es, "--stdin")
        ssz = ts["script"][::2]
        if len(ssz) < 3:
            fail(f"live: --stdin fed {len(ssz)} blocks, too few to time")
        ms = {k: statistics.median(ts[k]) for k in ("feed", "enq", "gen", "png")}
        busy = [f + g + p for f, g, p in zip(ts["feed"], ts["gen"], ts["png"])]
        busy_s = sum(busy)
        per_s_first = busy_s / LIVE_SIGS[1]
        # past the engine's first feed (its meters' first use), as the file
        # path's headroom counts from the median feed
        per_s_stdin = sum(busy[1:]) / (sum(ssz[1:]) / FS)
        print(f"phase live: --stdin at stereo --meters all ({len(names)} meters): "
              f"{LIVE_SIGS[1]:.0f} s written down an os.pipe in real time in pieces of "
              f"{min(LIVE_WRITES) // 8}..{max(LIVE_WRITES) // 8} frames, read by feed_stream at "
              f"chunk {LIVE_CHUNK}: {len(ssz)} feeds of {min(ssz)}..{max(ssz)} frames in "
              f"{wall_s:.3f} s, a readout and the {len(names)} PNG frames after each: per feed "
              f"{ms['feed']:.2f} ms (median; enqueue {ms['enq']:.2f}; the first {ts['feed'][0]:.2f}, "
              f"the engine's first use), per generation {ms['gen']:.2f} ms, the frames "
              f"{ms['png']:.2f} ms; busy past the first feed {per_s_stdin:.1f} ms a second of "
              f"audio ({per_s_stdin / 10:.1f} % of realtime, headroom {1000 / per_s_stdin:.2f}x), "
              f"with it {busy_s:.1f} ms in all, {per_s_first:.1f} ms a second (headroom "
              f"{1000 / per_s_first:.2f}x); launches {cs}, as predicted [{gpu}]")

        if script != live_script(LIVE_SECONDS, True):
            fail("live: the stereo engine's feeds are not the script its CPU engines replayed")
        for g in live_groups(list(LIVE_PIPE_METERS)):
            jobs["pipe", tuple(g)] = LIVE_POOL.apply_async(live_cpu_run, (g, 2, LIVE_SIGP, sizes))
        LIVE_POOL.close()
        for k in live_counts:
            live_counts[k] += c5[k] + cp[k] + cs[k]
        print(f"phase live: 5 channels --meters all ({len(names5)} meters) over "
              f"{LIVE_SECONDS5:.0f} s: launches {c5}; pipe-fed stereo ({len(LIVE_PIPE_METERS)} "
              f"meters) over {LIVE_PIPE_SECONDS:.0f} s written at {LIVE_PIPE_PACE:.0f}x "
              f"realtime: {len(sizes)} feeds of {min(sizes)}..{max(sizes)} "
              f"frames ({len(odd)} distinct remainders mod 128) in {t_pipe:.3f} s, launches {cp}; "
              f"each as predicted from the feeds [{gpu}]")

        # -- the dashboard server on the stereo engine: every endpoint
        with tempfile.TemporaryDirectory(prefix="chip_smoke_live_") as tmp:
            sfile = os.path.join(tmp, "session")
            srv = make_server(eng, port=0, fps=10.0, state_file=sfile)
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            base = f"http://127.0.0.1:{srv.server_address[1]}"

            def get(path, code=200):
                try:
                    with urllib.request.urlopen(base + path, timeout=120) as r:
                        got, body = r.status, r.read()
                except urllib.error.HTTPError as e:
                    got, body = e.code, e.read()
                if got != code:
                    fail(f"live: GET {path} answered {got}, not {code}: {body[:300]!r}")
                return body

            try:
                page = get("/").decode()
                if "meters_lv2_torch live" not in page or "%PORTVALS%" in page:
                    fail("live: the dashboard page is not the port's")
                for n in names:
                    if get(f"/view/{n}.png?t=1")[:8] != b"\x89PNG\r\n\x1a\n":
                        fail(f"live: /view/{n}.png is not a PNG")
                get("/view/nope.png", 404)
                st = json.loads(get("/state.json"))
                if set(st) != set(names) | {"_fed_samples", "_fs"} or st["_fed_samples"] != eng.fed_samples:
                    fail("live: /state.json keys or sample count wrong")
                ports = json.loads(get("/ports"))
                for action in ("pause", "reset", "reset_radar", "reset_peak", "start"):
                    get(f"/ctl?action={action}")
                    on_card(eng, action)
                for m, p, v in (("spectrum", "speed", 4.0), ("r128", "radar_seconds", 240.0),
                                ("bbcms", "s20", 1.0)):
                    get(f"/ctl?action=set&meter={m}&param={p}&value={v}")
                    on_card(eng, f"set {m}.{p}")
                    if json.loads(get("/ports"))[f"{m}.{p}"] != v:
                        fail(f"live: /ports does not read {m}.{p}={v}")
                if int(eng._state["r128"].radar_spd) != 240 * FS // 360:
                    fail("live: r128.radar_seconds did not reach the state")
                body = get("/ctl?action=set&meter=spectrum&param=speed&value=nan", 500)
                if b"non-finite" not in body or json.loads(get("/ports"))["spectrum.speed"] != 4.0:
                    fail("live: a NaN port value was not refused")
                # save, 1 s more; load, the same 1 s: the same readouts
                x1 = live_signal(2, 1.0, 34)
                get("/save")
                reset_counts()
                feed_file(eng, x1, FS, LIVE_CHUNK, speed=0.0)
                a = eng.snapshot()
                get("/load")
                on_card(eng, "load")
                get("/ctl?action=reset")
                on_card(eng, "reset after load")
                get("/load")
                feed_file(eng, x1, FS, LIVE_CHUNK, speed=0.0)
                b = eng.snapshot()
                torch.cuda.synchronize()
                on_card(eng, "feeds after load")
                same_bits = all(np.array_equal(u, v, equal_nan=True) for (_, u), (_, v) in zip(
                    readout_leaves(a), readout_leaves(b), strict=True))
                w_sl, errs = ingest_compare({n: batch1(a[n]) for n in pipe_names}, 0,
                                            {n: batch1(b[n]) for n in pipe_names}, 0, "save/load")
                if errs:
                    fail("live: the session after /save and /load differs: " + " | ".join(errs[:5]))
            finally:
                srv.shutdown()
                srv.server_close()
            srv2 = make_server(eng, port=0)
            threading.Thread(target=srv2.serve_forever, daemon=True).start()
            try:
                base = f"http://127.0.0.1:{srv2.server_address[1]}"
                get("/save", 400)
            finally:
                srv2.shutdown()
                srv2.server_close()
        print(f"phase live: the server on the card engine: /, the {len(names)} /view PNGs, 404 "
              f"for an unknown meter, /state.json, /ports ({len(ports)} ports), pause, reset, "
              f"reset_radar, reset_peak, set spectrum.speed, r128.radar_seconds and bbcms.s20, "
              f"500 for a NaN set, /save then /load then 1 s more equal to the run that never "
              f"loaded ({'bit for bit' if same_bits else f'{w_sl:.3g} of the bar'}), 400 for "
              f"/save without a state file; every state tensor on the card after each control, "
              f"set, reset and load [{gpu}]")

        # -- the CPU runs
        t_cpu0 = time.perf_counter()
        worst, errs = {}, []
        runs = {"stereo": (snap, hist, ring),
                "5ch": (snap5, e5._state["r128"].hist_m.cpu().numpy(), e5._ring),
                "pipe": (snapp, ep._state["r128"].hist_m.cpu().numpy(), ep._ring)}
        for (run, group), job in jobs.items():
            got, ghist, gring = runs[run]
            cpu_snap, cpu_hist, cpu_ring = job.get(timeout=600)
            if not np.array_equal(gring[:, -cpu_ring.shape[-1]:], cpu_ring):
                errs.append(f"{run}: the rings differ")
            if cpu_hist is not None and not np.array_equal(ghist, cpu_hist):
                errs.append(f"{run}: R128 hist_m differs from the CPU run")
            for n in group:
                if n in DISPLAY_METERS:
                    w, e = live_display_diff(n, got[n], cpu_snap[n], cpu_ring)
                else:
                    w, e = ingest_compare({n: batch1(got[n])}, 0, {n: batch1(cpu_snap[n])}, 0,
                                          f"{run}")
                    w = {"bar share": w}
                errs += [f"{run} {n}: {x}" for x in e]
                for k, v in w.items():
                    worst[(run, k)] = max(worst.get((run, k), 0.0), v)
        if errs:
            fail("live: card against CPU engines: " + " | ".join(errs[:10]))
        print(f"phase live: ok: the stereo, 5-channel and pipe-fed card engines against the same "
              f"engines on CPU tensors ({len(jobs)} worker runs; the stereo and 5-channel ones, "
              f"started in phase main, waited for {t_wait:.1f} s at the phase's start, the "
              f"pipe-fed ones {time.perf_counter() - t_cpu0:.1f} s at its end): rings and R128 "
              f"hist_m exact, worst: " + ", ".join(
                  f"{r} {k} {v:.3g}" for (r, k), v in sorted(worst.items()))
              + f"; the phase {time.perf_counter() - t_phase:.1f} s [{gpu}]")
    finally:
        stop_live_workers()
    return live_counts


def batch1(o):
    """A host readout with a leading batch axis of 1 (ingest_compare's form)."""
    if isinstance(o, dict):
        return {k: batch1(v) for k, v in o.items()}
    return np.asarray(o)[None]


def live_display_diff(name, out, out_c, ring):
    """A display meter's readout on the card against the CPU engine's, at
    analyzer_diff's bars (the phase wheel's against the plain transform of
    the ring window's frames)."""
    import torch

    import meters_lv2_torch
    from meters_lv2_torch.ops import stft_fused

    t = {k: torch.as_tensor(np.asarray(v))[None] for k, v in out.items()}
    c = {k: torch.as_tensor(np.asarray(v))[None] for k, v in out_c.items()}
    raw_c = None
    if name == "phasewheel":
        m = meters_lv2_torch.create(name, FS)
        w = m.stft.hop * max(1, round(FS / m.stft.hop))
        tail = m.init((1,), device="cpu").stft.tail
        x = torch.as_tensor(np.ascontiguousarray(ring[:, -w:]))[None]
        raw_c = stft_fused.plain_frames(torch.cat([tail, x], -1), m.stft.win("cpu"), m.stft.hop,
                                        "raw", 0.0)
    return analyzer_diff(name, t, c, raw_c)


def stop_workers():
    global POOL
    if POOL is not None:
        POOL.terminate()
        POOL.join()
        POOL = None


# ---------------------------------------------------------------------------
# Phase sharded: the whole-file analyses (parallel/*_sharded.py) on 4 ranks
# that share the one card (gloo, host-staged collectives)
# ---------------------------------------------------------------------------

SHARD_RANKS = 4
SHARD_LAYOUTS = ((2, 2), (1, 4))  # (dp, sp)
SHARD_R128 = (16, 600)  # R128: stereo programmes, seconds (T = 28,800,000)
# R128 at 44.1 kHz: no shard is 128-aligned (fragm = 2205), so every rank
# runs the kernel on its bulk and the meter's plain ops on the remainder
SHARD_R128_44K = (8, 60)
FS_44K = 44100
SHARD_B, SHARD_S, SHARD_SPEC_S = 8, 61, 30  # the other families
SHARD_SEED = 19
SHARD_TONES = (100.0, 220.0, 440.0, 997.0, 1499.0, 3000.0, 5000.0, 9000.0)
SHARD_WIN = FS  # samples of each window of the chain step held against the plain ballistics
# family: (meter, analyze_* name, analyze kwargs, input: "mono" [2B, T] rows,
# "stereo" [B, 2, T], "sur5" [B, 5, T], "sur8" [B, 8, T]; the spectrum's
# stereo [B, 2, 30 s])
SHARD_FAMILIES = {
    "spectr30stereo": ("spectr30stereo", {}, "analyze_spectrum", {}, "spec"),
    "dBTP": ("dBTPmono", {}, "analyze_truepeak", {}, "mono"),
    "DR14": ("dr14stereo", {}, "analyze_dr14", {}, "stereo"),
    "TPnRMS": ("TPnRMSstereo", {}, "analyze_tpnrms", {}, "stereo"),
    "sigdist": ("SigDistHist", {}, "analyze_sigdist", {}, "mono"),
    "sigdist_oor": ("SigDistHist", {"reference_oor_count": True}, "analyze_sigdist", {},
                    "mono"),
    "bitmeter": ("bitmeter", {}, "analyze_bitmeter", {}, "mono"),
    "VU": ("VUmono", {}, "analyze_needle", {}, "mono"),
    "DIN": ("DINmono", {}, "analyze_needle", {}, "mono"),
    "BBC": ("BBCmono", {}, "analyze_needle", {}, "mono"),
    "BBCM6": ("BBCM6", {}, "analyze_needle", {}, "stereo"),
    "K20": ("K20mono", {}, "analyze_kmeter", {}, "mono"),
    "COR": ("COR", {}, "analyze_stcorr", {}, "stereo"),
    "surround5": ("surround5", {}, "analyze_surround", {}, "sur5"),
    "surround8": ("surround8", {}, "analyze_surround", {}, "sur8"),
}
# the chains of each family on a rank: its ballistics launches are nsp each
SHARD_CHAINS = {"dBTP": 1, "DR14": 1, "TPnRMS": 1, "DIN": 1, "BBC": 1, "BBCM6": 2}
SHARD_KERNELS = ("r128_fused", "ballistics", "truepeak_fused", "bitmeter_stats",
                 "spectrum_fused", "surround_fused", "stft_fused", "ballistics_envelope",
                 "r128_fused_seg", "surround_fused_wide", "truepeak_fused_serial",
                 "sigdist_fused")


def shard_signal(streams, C, first, seconds, seed, fs=FS):
    """[len(streams), C, seconds * fs] float32: per stream and second a
    block of tones (one of SHARD_TONES a channel) plus uniform noise at a
    level between 0 and -30 dB, each block from
    np.random.default_rng([seed, stream, second]), so that any rank makes
    exactly its own blocks of the whole signal."""
    t = np.arange(fs) / fs
    tones = np.stack([np.sin(2 * np.pi * f * t) for f in SHARD_TONES]).astype(np.float32)
    out = np.empty((len(streams), C, seconds * fs), np.float32)
    for i, s in enumerate(streams):
        for j in range(seconds):
            rng = np.random.default_rng([seed, s, first + j])
            gain = np.float32(10.0 ** (-1.5 * rng.random()))
            amp = rng.random(C, dtype=np.float32) * gain
            k = rng.integers(0, len(SHARD_TONES), C)
            blk = out[i, :, j * fs:(j + 1) * fs]
            blk[...] = rng.random((C, fs), dtype=np.float32)
            blk -= np.float32(0.5)
            blk *= np.float32(0.2) * gain
            blk += amp[:, None] * tones[k]
    return out


def shard_inputs(kind, streams, first, seconds, fs=FS):
    """The input of a family of kind ``kind`` for stereo programmes
    ``streams`` over seconds [first, first + seconds) at rate ``fs``: "mono"
    is the stereo signal as [2 len(streams), T] rows (channel c of
    programme s in row 2 s + c), the surround kinds have seeds of their
    own."""
    if kind == "sur5":
        return shard_signal(streams, 5, first, seconds, SHARD_SEED + 5, fs)
    if kind == "sur8":
        return shard_signal(streams, 8, first, seconds, SHARD_SEED + 8, fs)
    x = shard_signal(streams, 2, first, seconds, SHARD_SEED, fs)
    return x.reshape(-1, x.shape[-1]) if kind == "mono" else x


def shard_local(kind, streams, seconds, sp, fs=FS):
    """A rank's time block (sp index ``sp.index`` of ``sp.size``) of a
    family's input over ``seconds`` at rate ``fs``: made block by block
    where the shard is whole seconds, else cut from the rank's programmes
    over the whole span."""
    n = seconds * fs // sp.size
    if n % fs:
        whole = shard_inputs(kind, streams, 0, seconds, fs)
        return np.ascontiguousarray(whole[..., sp.index * n:(sp.index + 1) * n])
    return shard_inputs(kind, streams, sp.index * n // fs, n // fs, fs)


def reset_counts():
    """Every kernel wrapper's launch count back to 0."""
    from meters_lv2_torch.ops import (
        ballistics_core, bitmeter_stats, r128_fused, sigdist_fused, spectrum_fused, stft_fused,
        surround_fused, truepeak_fused)

    r128_fused.launch_count = r128_fused.seg_launch_count = 0
    ballistics_core.launch_count = ballistics_core.envelope_launch_count = 0
    truepeak_fused.launch_count = truepeak_fused.serial_launch_count = 0
    bitmeter_stats.launch_count = 0
    spectrum_fused.launch_count = 0
    surround_fused.launch_count = surround_fused.wide_launch_count = 0
    stft_fused.launch_count = 0
    sigdist_fused.launch_count = 0


def launch_counts():
    """The kernel wrappers' launch counts by kernel name, without
    truepeak_fused's serial body (the meters run it only below 4,300 Hz)."""
    from meters_lv2_torch.ops import (
        ballistics_core, bitmeter_stats, r128_fused, sigdist_fused, spectrum_fused, stft_fused,
        surround_fused, truepeak_fused)

    return {"r128_fused": r128_fused.launch_count, "ballistics": ballistics_core.launch_count,
            "truepeak_fused": truepeak_fused.launch_count,
            "bitmeter_stats": bitmeter_stats.launch_count,
            "spectrum_fused": spectrum_fused.launch_count,
            "surround_fused": surround_fused.launch_count,
            "stft_fused": stft_fused.launch_count,
            "ballistics_envelope": ballistics_core.envelope_launch_count,
            "r128_fused_seg": r128_fused.seg_launch_count,
            "surround_fused_wide": surround_fused.wide_launch_count,
            "sigdist_fused": sigdist_fused.launch_count}


def shard_predicted(family, nsp):
    """The kernel launches one rank makes in one analyze_* call."""
    want = dict.fromkeys(SHARD_KERNELS, 0)
    if family.startswith("R128"):
        want["r128_fused"] = 1
    elif family == "bitmeter":
        want["bitmeter_stats"] = 1
    elif family in SHARD_CHAINS:  # the envelope body: <= ENVELOPE_MAX_ROWS rows
        want["ballistics_envelope"] = SHARD_CHAINS[family] * nsp
    return want


def shard_kernel_checks(mesh, m128, x128, tp, x_mono, bit_rows):
    """Rows 1, 2e and 7 against their plain versions on the rank at sp
    index 1 and dp index 0 of the first layout (a non-zero entry state):
    r128_fused on its whole shard from the composed entry state and the
    47-sample halo; bitmeter_stats on its shard; the envelope body at the
    length the path gives it: dBTP's chain step 1 over the rank's whole 4x
    upsampled series (its entry state shard 0's exit).  A plain run over
    the whole series would take minutes, so three SHARD_WIN windows of it
    are held bit for bit: at its head from the chain's entry state, in its
    middle and at its end, each from the state a kernel run over the
    series up to the window leaves, each against the kernel run from the
    entry state to the window's end (at the end, the chain step's own call).
    The ranks of every 'sp' group take part in the collectives; all but
    that one return None.  Returns (text, max errors, breaches)."""
    import io

    import torch

    from meters_lv2_torch.ops import ballistics_core, bitmeter_stats, r128_fused, resample
    from meters_lv2_torch.ops import ballistics as bal
    from meters_lv2_torch.parallel.meters_sharded import _halo47
    from meters_lv2_torch.parallel.timepar import lti_entry_state_sp

    sp = mesh.sp
    B, C, _ = x128.shape
    s_in = lti_entry_state_sp(m128.sys, x128, torch.zeros((B, C, 4), device=x128.device), sp)
    halo = sp.shift(x128[..., -47:].contiguous())
    up, _ = resample.upsample4(x_mono, _halo47(x_mono, sp))
    t_abs = up.abs().reshape(-1, up.shape[-1])
    del up
    z = torch.zeros(t_abs.shape[0], device=x128.device)
    out0 = bal._run_ballistics(tp.coeffs, t_abs, z, z, z, z)
    carry = sp.select(0, torch.stack(out0)).unbind(0)
    if (mesh.dp.index, sp.index) != (0, 1):
        return None
    buf = io.StringIO()
    errs, worst = [], {}
    with contextlib.redirect_stdout(buf):
        op = m128.sys.op(r128_fused.BLOCK)
        got = r128_fused.fused_core(x128, s_in, halo, m128.gains, op)
        ref = r128_fused.fused_core_reference(x128, s_in, halo, m128.gains, op)
        worst["r128_fused"], e = compare_core(
            got, ref, f"r128_fused on rank {mesh.rank}'s shard {tuple(x128.shape)}, entry state "
            f"|s_in| max {s_in.abs().max().item():.3g}")
        errs += e
        del got, ref
        w = dict(w1=tp.coeffs.w1, w2=tp.coeffs.w2, w3=tp.coeffs.w3, track_peak=True)

        def kernel(n):  # the envelope kernel over the series' first n samples from the carry
            rows = t_abs if n == t_abs.shape[-1] else t_abs[:, :n].contiguous()
            return ballistics_core.ballistics(rows, *carry, **w, envelope=True)

        L4 = t_abs.shape[-1]
        worst["ballistics_envelope"] = 0.0
        for o in (0, (L4 // 2 - SHARD_WIN) // 4 * 4, L4 - SHARD_WIN):
            state = kernel(o) if o else carry
            ref = ballistics_core.ballistics_envelope_reference(
                t_abs[:, o:o + SHARD_WIN].contiguous(), *state, **w)
            err, e = compare_ballistics(
                kernel(o + SHARD_WIN), ref, f"envelope, dBTP chain step 1 on rank {mesh.rank}'s "
                f"{L4}-sample upsampled series ({t_abs.shape[0]} rows), samples [{o}, "
                f"{o + SHARD_WIN}) from {'the entry state' if not o else 'the kernel state'} "
                f"(z1 max {state[0].max().item():.3g})")
            worst["ballistics_envelope"] = max(worst["ballistics_envelope"], err)
            errs += e
        got = bitmeter_stats.bitmeter_stats(bit_rows)
        ref = bitmeter_stats.bitmeter_stats_reference(bit_rows)
        worst["bitmeter_stats"], e = compare_bitstats(
            got, ref, f"on rank {mesh.rank}'s shard {tuple(bit_rows.shape)}")
        errs += e
    return buf.getvalue(), worst, errs


def sharded_rank(rank, ckpt_dir):
    """One rank of phase sharded: R128 at full width and every other family
    under both layouts, the kernel checks, the sharded checkpoint.  Returns
    host values only: rank 0's gathered readouts, every rank's launches,
    times and checks."""
    import torch

    import meters_lv2_torch
    from meters_lv2_torch.ops import truepeak_fused
    from meters_lv2_torch.parallel import (
        gather_outputs, make_mesh, meters_sharded, r128_sharded, spectrum_sharded)
    from meters_lv2_torch.runtime import build
    from meters_lv2_torch.utils.state import load_state_sharded, save_state_sharded

    build.kernels()  # the parent's build
    res = {"rank": rank, "launches": {}, "times": {}, "first": {}, "mem": {}, "out": {},
           "remainder": {}, "checks": None}
    for dp, sp in SHARD_LAYOUTS:
        mesh = make_mesh(dp, sp)
        res["device"], res["backend"], res["staged"] = str(mesh.device), mesh.backend, mesh.staged
        dev = mesh.device

        def timed(key, fn):
            """fn's wall time on this rank, its launches; under the first
            layout an untimed first run before it (its time kept apart:
            the process's first use of each analysis)."""
            for first in ((True, False) if (dp, sp) == SHARD_LAYOUTS[0] else (False,)):
                mesh.barrier()
                torch.cuda.synchronize()
                reset_counts()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                res["first" if first else "times"][key] = time.perf_counter() - t0
            res["launches"][key] = {
                **launch_counts(), "truepeak_fused_serial": truepeak_fused.serial_launch_count}
            return out

        # R128 at full width: this rank's programmes and seconds only
        B, S = SHARD_R128
        bl = B // dp
        streams = range(mesh.dp.index * bl, (mesh.dp.index + 1) * bl)
        x = torch.from_numpy(shard_local("stereo", streams, S, mesh.sp)).to(dev)
        m128 = meters_lv2_torch.create("EBUr128", FS, nchan=2)
        torch.cuda.reset_peak_memory_stats()
        out = timed(("R128", dp, sp), lambda: r128_sharded.analyze_r128(m128, x, mesh))
        res["mem"][dp, sp] = torch.cuda.max_memory_allocated()
        out = gather_outputs(out, mesh, r128_sharded.OUT_SPECS)
        if rank == 0:
            res["out"]["R128", dp, sp] = {k: v.cpu() for k, v in out.items()}
        del out

        # R128 at 44.1 kHz: the kernel's bulk and the plain remainder on every rank
        B, S = SHARD_R128_44K
        bl = B // dp
        streams = range(mesh.dp.index * bl, (mesh.dp.index + 1) * bl)
        x44 = torch.from_numpy(shard_local("stereo", streams, S, mesh.sp, FS_44K)).to(dev)
        m44 = meters_lv2_torch.create("EBUr128", FS_44K, nchan=2)
        out = timed(("R128_44k", dp, sp), lambda: r128_sharded.analyze_r128(m44, x44, mesh))
        out = gather_outputs(out, mesh, r128_sharded.OUT_SPECS)
        res["remainder"][dp, sp] = x44.shape[-1] % 128
        if rank == 0:
            res["out"]["R128_44k", dp, sp] = {k: v.cpu() for k, v in out.items()}
        del out, x44

        # the other families, B stereo programmes of SHARD_S (spectrum SHARD_SPEC_S) s
        bl = SHARD_B // dp
        streams = range(mesh.dp.index * bl, (mesh.dp.index + 1) * bl)
        inputs = {kind: torch.from_numpy(shard_local(kind, streams, SHARD_S, mesh.sp)).to(dev)
                  for kind in ("mono", "stereo", "sur5", "sur8")}
        inputs["spec"] = torch.from_numpy(
            shard_local("stereo", streams, SHARD_SPEC_S, mesh.sp)).to(dev)
        for fam, (name, kw, fn, akw, kind) in SHARD_FAMILIES.items():
            m = meters_lv2_torch.create(name, FS, **kw)
            mod = spectrum_sharded if fn == "analyze_spectrum" else meters_sharded
            out = timed((fam, dp, sp), lambda: getattr(mod, fn)(m, inputs[kind], mesh, **akw))
            if fn == "analyze_spectrum":
                out = out[0]
            out = gather_outputs(out if isinstance(out, dict) else {"value": out}, mesh)
            if rank == 0:
                res["out"][fam, dp, sp] = {k: v.cpu() for k, v in out.items()}

        if (dp, sp) == SHARD_LAYOUTS[0]:
            res["checks"] = shard_kernel_checks(
                mesh, m128, x, meters_lv2_torch.create("dBTPmono", FS), inputs["mono"],
                inputs["mono"])
        del x, inputs
        torch.cuda.empty_cache()

    # sharded checkpoint: an R128 state over dp = 4 after one 1 s update,
    # saved, loaded, one more update against the run that never saved
    mesh = make_mesh(SHARD_RANKS, 1)
    dev = mesh.device
    bl = SHARD_R128[0] // SHARD_RANKS
    x = torch.from_numpy(shard_signal(range(rank * bl, (rank + 1) * bl), 2, 0, 2,
                                      SHARD_SEED)).to(dev)
    m = meters_lv2_torch.create("EBUr128", FS, nchan=2)
    st = m.update(m.init((bl,)), x[..., :FS])
    save_state_sharded(st, ckpt_dir, mesh)
    loaded = load_state_sharded(m.init((bl,)), ckpt_dir, mesh)
    on_card = all(getattr(loaded, f).device == dev for f in loaded.__dataclass_fields__)
    a, b = m.update(loaded, x[..., FS:]), m.update(st, x[..., FS:])
    res["ckpt"] = {"files": sorted(os.listdir(ckpt_dir)), "on_card": on_card,
                   "same": all(torch.equal(getattr(a, f), getattr(b, f))
                               for f in a.__dataclass_fields__)}
    return res


def shard_serial(fam, dev, x):
    """One serial update + read of the port on the card over the whole
    input; returns (readouts on the host, seconds of the update + read)."""
    import torch

    import meters_lv2_torch

    name, kw, fn, akw, kind = SHARD_FAMILIES[fam]
    m = meters_lv2_torch.create(name, FS, **kw)
    xt = torch.from_numpy(x).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = m.init(x.shape[:1] if kind != "mono" else x.shape[:-1])
    st = m.update(st, xt, stereo=True) if fn == "analyze_spectrum" else m.update(st, xt)
    out = m.read(st)[0]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out = out if isinstance(out, dict) else {"value": out}
    return {k: v.cpu() for k, v in out.items()}, dt


def shard_compare(fam, got, want, abs_sum=None):
    """A sharded readout against the serial one at the bars of
    tests/test_meters_sharded.py and tests/test_pipeline_and_parallel.py,
    with two differences.  On the card the serial dBTP, DR-14 and TP+RMS
    run truepeak_fused (its FIR on the card) and the sharded ones
    resample.upsample4's cuBLAS products, so their true-peak readouts are
    held at TPK_RTOL (in dB for DR-14 and TP+RMS) where the CPU test holds
    them exact.  sigdist's running sum (hist_avg) adds to that file's bar
    the float32 bound of two summation orders over T samples,
    2 log2(T) 2^-24 sum|x| (``abs_sum``, per row): tones sum to near zero,
    so a bar relative to the sum alone would be one of cancellation.
    Returns (worst share of a bar, breaches)."""
    import torch

    errs, worst = [], 0.0

    def exact(*keys):
        for k in keys:
            a, b = got[k], want[k]
            if not (same_bits(a, b) if a.is_floating_point() else torch.equal(a, b)):
                errs.append(f"{fam} {k} not exact")

    def close(k, rtol=0.0, atol=0.0):
        nonlocal worst
        a, b = got[k].double(), want[k].double()
        if not same_nonfinite(a, b):
            errs.append(f"{fam} {k}: non-finite values differ")
        f = torch.isfinite(b)
        bar = rtol * b.abs()[f] + atol
        d = (a - b).abs()[f]
        if d.numel():
            share = (d / bar).max().item()
            worst = max(worst, share)
            if share > 1.0:
                errs.append(f"{fam} {k}: max abs err {d.max().item():.3g} over its bar")

    tp_db = 20 * math.log10(1 + TPK_RTOL)
    if fam.startswith("R128"):
        exact("hist_m", "hist_s", "count_m", "count_s", "radar_pos")
        for k in ("max_M", "max_S", "radar_m", "radar_s"):
            close(k, atol=1e-5)
        for k in ("integrated", "integ_thr", "range_min", "range_max", "range_thr", "lra",
                  "loudness_M", "loudness_S"):
            close(k, atol=1e-4)
        close("dbtp", rtol=1e-6)
    elif fam == "spectr30stereo":
        close("bands", atol=5e-3)
        close("peaks", atol=5e-3)
    elif fam == "dBTP":
        close("level", rtol=TPK_RTOL)
        close("peak", rtol=TPK_RTOL)
    elif fam == "DR14":
        exact("block_count")
        close("m_peak", atol=tp_db)
        close("v_peak", atol=tp_db)
        for k in ("dr", "dr_total", "m_rms", "v_rms"):
            close(k, atol=2e-3)
    elif fam == "TPnRMS":
        close("m_peak", atol=tp_db)
        close("v_peak", atol=tp_db)
        close("v_rms", rtol=2e-5)
        close("m_rms", rtol=2e-5)
    elif fam.startswith("sigdist"):
        exact("hist", "hist_max", "hist_peak_bin", "integration_time")
        close("hist_avg", rtol=2e-5, atol=1e-4 + 2 * math.log2(SHARD_S * FS) * 2.0 ** -24
              * torch.as_tensor(abs_sum)[torch.isfinite(want["hist_avg"])])
        close("mean", rtol=2e-4, atol=1e-7)
        close("variance", rtol=2e-4)
    elif fam == "bitmeter":
        exact(*want)
    elif fam == "VU":
        close("value", rtol=2e-5, atol=1e-7)
    elif fam in ("DIN", "BBC"):
        exact("value")
    elif fam == "BBCM6":
        exact("mid", "side")
    elif fam == "K20":
        exact("peak")
        close("rms", rtol=2e-5, atol=1e-7)
    elif fam == "COR":
        close("value", rtol=1e-4, atol=1e-5)
    else:  # surround5 / surround8
        exact("peak")
        close("level", rtol=2e-5, atol=1e-7)
        close("correlation", rtol=1e-4, atol=1e-5)
    if not fam.startswith("R128") and set(got) != set(want):  # R128's whole-file dict has its own keys
        errs.append(f"{fam}: keys {sorted(set(got) ^ set(want))} differ")
    return worst, errs


def sharded_phase(dev, gpu):
    """Phase sharded.  Returns the launches of rows 1, 2e and 7 over every
    rank and both layouts, by kernel name."""
    import tempfile

    import torch

    import meters_lv2_torch
    from meters_lv2_torch.parallel import launch
    from meters_lv2_torch.parallel.mesh import choose_backend

    t_phase = time.perf_counter()
    ncards = torch.cuda.device_count()
    backend = choose_backend("cuda", SHARD_RANKS, ncards)
    if ncards == 1 and backend != "gloo":
        fail(f"sharded: {SHARD_RANKS} ranks on one card must run gloo, the rule gave {backend}")

    # the serial references, on the card, before the ranks start
    B, S = SHARD_R128
    serial, serial_s = {}, {}
    x = shard_signal(range(B), 2, 0, S, SHARD_SEED)
    xt = torch.from_numpy(x).to(dev)
    del x
    m = meters_lv2_torch.create("EBUr128", FS, nchan=2)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st = m.update(m.init((B,)), xt)
    out = m.read(st)[0]
    torch.cuda.synchronize()
    serial_s["R128"] = time.perf_counter() - t0
    serial_mem = torch.cuda.max_memory_allocated() - base + xt.numel() * 4
    out.update(hist_m=st.hist_m, hist_s=st.hist_s, count_m=st.count_m, count_s=st.count_s)
    serial["R128"] = {k: v.cpu() for k, v in out.items()}
    del xt, st, out
    torch.cuda.empty_cache()
    B, S = SHARD_R128_44K
    xt = torch.from_numpy(shard_signal(range(B), 2, 0, S, SHARD_SEED, FS_44K)).to(dev)
    m = meters_lv2_torch.create("EBUr128", FS_44K, nchan=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = m.update(m.init((B,)), xt)
    out = m.read(st)[0]
    torch.cuda.synchronize()
    serial_s["R128_44k"] = time.perf_counter() - t0
    out.update(hist_m=st.hist_m, hist_s=st.hist_s, count_m=st.count_m, count_s=st.count_s)
    serial["R128_44k"] = {k: v.cpu() for k, v in out.items()}
    del xt, st, out
    whole = {kind: shard_inputs(kind, range(SHARD_B), 0, SHARD_S)
             for kind in ("mono", "stereo", "sur5", "sur8")}
    whole["spec"] = np.ascontiguousarray(whole["stereo"][..., :SHARD_SPEC_S * FS])
    for fam, (_, _, _, _, kind) in SHARD_FAMILIES.items():
        serial[fam], serial_s[fam] = shard_serial(fam, dev, whole[kind])
    abs_sum = np.abs(whole["mono"]).sum(-1, dtype=np.float64)
    del whole
    torch.cuda.empty_cache()
    t_serial = time.perf_counter() - t_phase

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt:
        t0 = time.perf_counter()
        ranks = launch(sharded_rank, SHARD_RANKS, ckpt, device="cuda")
        t_ranks = time.perf_counter() - t0
    print(f"phase sharded: {SHARD_RANKS} ranks, backend {ranks[0]['backend']} (host-staged "
          f"collectives: {ranks[0]['staged']}), {ncards} card(s), rank devices "
          f"{[r['device'] for r in ranks]}; the ranks {t_ranks:.1f} s with their start-up, the "
          f"serial references {t_serial:.1f} s [{gpu}]")

    failures = []
    if any(r["backend"] != backend for r in ranks):
        failures.append(f"a rank ran {[r['backend'] for r in ranks]}, the rule gave {backend}")
    # launches: every rank, every analysis, exactly as predicted
    totals = dict.fromkeys(SHARD_KERNELS, 0)
    for r in ranks:
        for (fam, dp, sp), got in r["launches"].items():
            want = shard_predicted(fam, sp)
            if got != want:
                failures.append(f"rank {r['rank']} {fam} dp={dp} sp={sp}: launches "
                                f"{ {k: v for k, v in got.items() if v} }, predicted "
                                f"{ {k: v for k, v in want.items() if v} }")
            for k, v in got.items():
                totals[k] += v
    # the kernels against their plain versions
    checks = [r["checks"] for r in ranks if r["checks"] is not None]
    if len(checks) != 1:
        failures.append(f"{len(checks)} ranks ran the kernel checks")
    check_err = {}
    for text, worst, errs in checks:
        print("phase sharded: kernels against their plain versions on a rank with a non-zero "
              "entry state:\n" + text.rstrip())
        failures += errs
        for k, v in worst.items():
            check_err[k] = max(check_err.get(k, 0.0), v)
    # each result against the serial update
    worst = {}
    out = ranks[0]["out"]
    for (fam, dp, sp), got in out.items():
        w, errs = shard_compare(fam, got, serial[fam], abs_sum)
        worst[fam] = max(worst.get(fam, 0.0), w)
        failures += [f"dp={dp} sp={sp}: {e}" for e in errs]
    for fam, (B, S) in (("R128", SHARD_R128), ("R128_44k", SHARD_R128_44K)):
        for dp, sp in SHARD_LAYOUTS:
            cm = out[fam, dp, sp]
            if tuple(cm["curve_M"].shape) != (B, S * 20):  # 20 fragments a second
                failures.append(f"{fam} curve_M shape {tuple(cm['curve_M'].shape)}")
            d = (cm["curve_M"][:, -1] - serial[fam]["loudness_M"]).abs().max().item()
            if d > 1e-4:
                failures.append(f"dp={dp} sp={sp}: {fam} curve_M's last point off loudness_M "
                                f"by {d:.3g}")
    if any(0 in r["remainder"].values() for r in ranks):
        failures.append("a 44.1 kHz shard was 128-aligned: the remainder branch did not run")
    # the sharded checkpoint
    for r in ranks:
        c = r["ckpt"]
        if c["files"] != ["manifest.json"] + [f"rank{i}.npz" for i in range(SHARD_RANKS)]:
            failures.append(f"checkpoint files {c['files']}")
        if not (c["on_card"] and c["same"]):
            failures.append(f"rank {r['rank']}: checkpoint on the card {c['on_card']}, resumed "
                            f"equal {c['same']}")
    for fam in ["R128", "R128_44k", *SHARD_FAMILIES]:
        secs = {"R128": SHARD_R128, "R128_44k": SHARD_R128_44K}.get(fam, (
            SHARD_B, SHARD_SPEC_S if fam == "spectr30stereo" else SHARD_S))
        ss = secs[0] * secs[1]
        line = [f"serial {serial_s[fam]:.3f} s = {ss / serial_s[fam]:.1f} x-realtime"]
        for dp, sp in SHARD_LAYOUTS:
            t = max(r["times"][fam, dp, sp] for r in ranks)
            line.append(f"dp={dp} x sp={sp} {t:.3f} s = {ss / t:.1f} x-realtime")
        first = max(r["first"][fam, *SHARD_LAYOUTS[0]] for r in ranks)
        print(f"phase times: sharded {fam} ({secs[0]} x {secs[1]} s), the slowest rank: "
              + ", ".join(line) + f"; the first use {first:.3f} s (4 ranks time-slice one "
              f"card: no speed-up is expected) [{gpu}]")
    print("phase sharded: peak device memory a rank through its R128 analysis: " + ", ".join(
        f"dp={dp} x sp={sp} {max(r['mem'][dp, sp] for r in ranks) / 2 ** 30:.2f} GiB"
        for dp, sp in SHARD_LAYOUTS) + f"; the serial update {serial_mem / 2 ** 30:.2f} GiB "
        f"[{gpu}]")
    if failures:
        fail("sharded: " + " | ".join(failures[:12]))

    print(f"phase sharded: ok: R128 at B={SHARD_R128[0]} x {SHARD_R128[1]} s stereo, at "
          f"{FS_44K} Hz B={SHARD_R128_44K[0]} x {SHARD_R128_44K[1]} s (every shard's last "
          f"{sorted({v for r in ranks for v in r['remainder'].values()})} samples past the "
          f"kernel's 128-aligned bulk through the plain ops), and "
          f"{len(SHARD_FAMILIES)} other families at B={SHARD_B} x {SHARD_S} s (the spectrum "
          f"{SHARD_SPEC_S} s) under dp x sp = "
          + ", ".join(f"{dp} x {sp}" for dp, sp in SHARD_LAYOUTS)
          + " against the serial update on the card (worst share of a bar: "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + f"); every rank's launches as predicted (totals: "
          + ", ".join(f"{k} {v}" for k, v in totals.items() if v)
          + "); the dp = 4 checkpoint: one file a rank, on the card, resumed bit for bit")
    print(f"phase sharded: the phase {time.perf_counter() - t_phase:.1f} s [{gpu}]")
    return totals, check_err


# -- phase tools: the parity sweep's native leg and the examples on the card --
TOOLS_TIMEOUT = 600  # seconds each subprocess may take
TOOLS_WORKERS = 4  # the sweep's engine processes, beside the examples' ranks
TOOLS_ROWS = ("r128_fused", "r128_fused_seg", "ballistics", "ballistics_envelope",
              "truepeak_fused", "spectrum_fused", "surround_fused", "bitmeter_stats",
              "stft_fused")


def tools_predicted(case):
    """The launches of one native-leg case of tools/gpu_parity_check.py on
    the card: one update a block (live_update's rule: the 128-aligned bulk
    through r128_fused, truepeak_fused, spectrum_fused and surround_fused, a
    tail through the serial ballistics body for dBTP, DR-14 and TP+RMS, the
    PPM needles and M-6 through the envelope body and the bit meter through
    its kernel at every length), and stft_fused once a process call of the
    phase wheel and the stereoscope.  The sweep's sigdist runs in the
    reference's out-of-range mode, which takes no kernel."""
    n = case.fs * case.seconds // case.block
    if case.kind in ("phasewheel", "stereoscope"):
        return {"stft_fused": n}
    if case.kind == "sigdist":
        return {}
    name = {"iec1": "din", "iec2": "bbc", "msppm": "bbcms"}.get(case.kind, case.kind)
    return {k: int(v) * n for k, v in live_update([name])(case.block).items() if v}


def tools_phase(gpu):
    """Phase tools: the native leg of tools/gpu_parity_check.py at the card's
    sizes (a subprocess), with the three examples on the card beside it.
    Returns the sweep's launches by kernel name."""
    import tempfile

    from meters_lv2_torch.io.wav import write_wav

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import gpu_parity_check as gpc

    t_phase = time.perf_counter()
    env = {k: v for k, v in os.environ.items() if k != WIDE_VAR}
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(7)
        wavs = []
        for i in range(2):  # 6 s: a gated I needs >= 5 s of M-points
            wavs.append(os.path.join(tmp, f"ex{i}.wav"))
            write_wav(wavs[-1], (0.2 * rng.standard_normal((2, 6 * FS))).astype(np.float32), FS)
        cmds = {
            "parity": ["tools/gpu_parity_check.py", "--legs", "native",
                       "--workers", str(TOOLS_WORKERS)],
            "batch_loudness": ["examples/torch_batch_loudness.py", *wavs],
            "streaming_monitor": ["examples/torch_streaming_monitor.py"],
            "sharded_analysis": ["examples/torch_sharded_analysis.py"],
        }
        logs = {k: open(os.path.join(tmp, f"{k}.log"), "w+") for k in cmds}
        procs = {k: subprocess.Popen([sys.executable, *c], cwd=ROOT, env=env, text=True,
                                     stdout=logs[k], stderr=subprocess.STDOUT)
                 for k, c in cmds.items()}
        secs = {}
        try:
            while len(secs) < len(procs):  # each one's own wall time
                for k, pr in procs.items():
                    if k not in secs and pr.poll() is not None:
                        secs[k] = time.perf_counter() - t_phase
                if time.perf_counter() - t_phase > TOOLS_TIMEOUT:
                    fail(f"phase tools: {sorted(set(procs) - set(secs))} took over "
                         f"{TOOLS_TIMEOUT} s")
                time.sleep(0.1)
        finally:
            for pr in procs.values():
                if pr.poll() is None:
                    pr.kill()
                    pr.wait()
        outs = {}
        for k, f in logs.items():
            f.seek(0)
            outs[k] = f.read()
            f.close()
            if procs[k].returncode != 0:
                fail(f"phase tools: {k} exited {procs[k].returncode}:\n{outs[k][-3000:]}")
    lines = outs["parity"].strip().splitlines()
    try:
        res = json.loads(lines[-1])
    except (ValueError, IndexError):
        fail(f"phase tools: the sweep's last line is not JSON:\n{outs['parity'][-3000:]}")
    table = gpc.native_cases(quick=False)
    want_total = dict.fromkeys(TOOLS_ROWS, 0)
    got_total = dict.fromkeys(TOOLS_ROWS, 0)
    shares = []
    for fam, cases in table.items():
        for case in cases:
            row = res["families"][fam]["native"]["cases"][case.name]
            if not row["share"] <= 1 or row["streams"] != case.B:
                fail(f"phase tools: {case.name}: {row['share']} of its bar over {row['streams']} "
                     f"streams (want <= 1 over {case.B})")
            got = row["launches"]  # every counted kernel; the wide layout 0
            want = {k: tools_predicted(case).get(k, 0) for k in got}
            if got != want:
                fail(f"phase tools: {case.name} launches {got}, predicted {want}")
            for k in TOOLS_ROWS:
                want_total[k] += want[k]
                got_total[k] += got[k]
            shares.append(f"{case.name} B={case.B} {case.seconds} s at {case.fs} Hz, "
                          f"{case.block}-sample blocks: {row['share']:.4g} "
                          f"(the port's side {row['seconds']:.1f} s, signals included)")
    if not res["ok"]:
        fail(f"phase tools: the sweep is not ok:\n{outs['parity'][-3000:]}")
    missing = [k for k in TOOLS_ROWS if not got_total[k]]
    if missing:
        fail(f"phase tools: the sweep launched no {missing}")
    print("phase tools: native leg of tools/gpu_parity_check.py against NativeEngine, worst share "
          "of a bar: " + "; ".join(shares))
    print("phase tools: launches as predicted from B, T and the block: "
          + ", ".join(f"{k} {got_total[k]}" for k in TOOLS_ROWS) + f" [{gpu}]")

    out = outs["batch_loudness"]
    if out.count("ADJUST") + out.count("PASS") != 2 or "-200.00" in out or "on cuda" not in out:
        fail(f"phase tools: torch_batch_loudness.py:\n{out[-2000:]}")
    out = outs["streaming_monitor"]
    if "final:" not in out or "radar -> 240" not in out or "(on cuda)" not in out:
        fail(f"phase tools: torch_streaming_monitor.py:\n{out[-2000:]}")
    out = outs["sharded_analysis"]
    if ("stream 7:" not in out or "checkpointed + restored" not in out
            or "4 ranks on cuda (gloo, host-staged)" not in out):
        fail(f"phase tools: torch_sharded_analysis.py:\n{out[-2000:]}")
    for k in ("batch_loudness", "streaming_monitor", "sharded_analysis"):
        picked = [ln for ln in outs[k].splitlines()
                  if any(w in ln for w in ("PASS", "ADJUST", "final:", "radar ->", "stream 7:",
                                           "checkpointed", "mesh:"))]
        print(f"phase tools: ok: examples/torch_{k}.py on the card ({secs[k]:.1f} s): "
              + " | ".join(ln.strip() for ln in picked))
    print(f"phase tools: ok: the sweep {secs['parity']:.1f} s; the phase "
          f"{time.perf_counter() - t_phase:.1f} s [{gpu}]")
    return got_total


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
            ballistics_core, bitmeter_stats, design, lti, r128_fused, sigdist_fused,
            spectrum_fused, stft_fused, surround_fused, truepeak_fused)
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
    from test_torch_bitmeter_body import bitmeter_rows

    for tag, x, strided in [
        (f"main-path shape N={B_MAIN} T={FS}", np.random.default_rng(0).standard_normal(
            (B_MAIN, FS), dtype=np.float32) * np.float32(0.1), False),
        ("weird_floats N=3 T=48000", xw, False),
        ("N=5 T=1000", xr[:5, :1000], False),
        ("N=5 T=1", xr[:5, :1], False),
        ("strided rows N=7 T=10000", xr[:7, :10000], True),
        ("weird_floats strided rows N=3 T=48000", xw, True),
        # a live meter's few streams; each input kind; every lane its own
        # exponent group and all 254 normal exponents with NaN, +-Inf, +-0;
        # the kernel's 512-sample blocks, 4096-sample CTA rounds and N=1's
        # cluster slices (4096 at T = 32768) +-1; T = 3; rows not 16-byte
        # aligned (a row stride of 1 mod 4) and a tensor one element into
        # its storage
        ("N=1 T=48000", xr[:1], False), ("N=8 T=48000", xr[:8], False),
        ("square N=8 T=48000", bitmeter_rows("square", 8, FS), False),
        ("silence N=8 T=48000", bitmeter_rows("silence", 8, FS), False),
        ("denormal N=4 T=48000", bitmeter_rows("denormal", 4, FS), False),
        ("diverse strided rows N=8 T=48000", bitmeter_rows("diverse", 8, FS), True),
        ("loud N=8 T=48000", bitmeter_rows("loud", 8, FS), False),
        ("every_exponent N=2 T=8192", bitmeter_rows("every_exponent", 2, 8192), False),
        *[(f"N=2 T={t}", xr[:2, :t], False) for t in (511, 513, 4095, 4097)],
        *[(f"N=1 T={t}", bitmeter_rows("gauss", 1, t, seed=t), False) for t in (32767, 32769)],
        ("N=3 T=3", xr[:3, :3], False),
        ("ld 1 mod 4 N=5 T=48000", xr[:5], "ld1mod4"),
        ("offset 1 N=5 T=48000", xr[:5], "offset1"),
        ("weird_floats offset 1 N=3 T=3", xw[:, :3], "offset1"),
    ]:
        N_, T_ = x.shape
        if strided == "ld1mod4":
            xd = torch.zeros((N_, T_ + (1 - T_) % 4), device=dev)[:, :T_]
            xd.copy_(torch.as_tensor(np.ascontiguousarray(x)))
        elif strided == "offset1":
            xd = torch.zeros(N_ * T_ + 1, device=dev)[1:].view(N_, T_)
            xd.copy_(torch.as_tensor(np.ascontiguousarray(x)))
        elif strided:
            xd = torch.as_tensor(np.concatenate([x, x], axis=1), device=dev)[:, :T_]
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
    sd_err, errs = sigdist_kernel_cases(dev)
    failures += errs
    if failures:
        fail("kernel vs plain: " + " | ".join(failures))
    print("phase kernels: ok")
    marks.append(("device, build and kernels", time.perf_counter()))

    # -- 4. main path -------------------------------------------------------
    live_jobs = live_cpu_start()  # phase live's CPU engines, from here to the end of phase golden
    meter = meters_lv2_torch.create("EBUr128", FS, nchan=2)
    blocks = main_blocks()
    st = meter.init((B_MAIN,), device=dev)
    r128_fused.launch_count = r128_fused.seg_launch_count = 0
    for xb in blocks:
        st = meter.update(st, torch.as_tensor(xb, device=dev), flat=True)
    out, st = meter.read(st)
    torch.cuda.synchronize()
    main_seg = r128_fused.seg_launch_count
    launches = r128_fused.launch_count + main_seg
    if launches != len(blocks):
        fail(f"main path launched the kernel {launches} times for {len(blocks)} blocks")
    seg_share = main_seg / launches
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
          f"{launches}, seg mode's share {seg_share:.3f}; integrated[0] "
          f"{out['integrated'][0].item():.4f} LUFS, lra[0] {out['lra'][0].item():.4f} LU, "
          f"dbtp[0] {out['dbtp'][0].item():.6f}; streams 0-3 vs CPU: worst readout diff "
          f"{worst:.3g} dB, dbtp {tp_db:.3g} dB, histograms exact")

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

    bit_launches = sd_launches = 0
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
               sigdist_fused.launch_count, r128_fused.launch_count,
               truepeak_fused.serial_launch_count)
        # sigdist's kernel in its default mode only
        want = (0, N_STATS if layout == "stereo" else 0, N_STATS if name == "bitmeter" else 0,
                N_STATS if name == "SigDistHist" and not kw else 0, 0, 0)
        if got != want:
            fail(f"main path {name}: (ballistics, truepeak, bitmeter, sigdist, r128, serial "
                 f"truepeak) launches {got}, expected {want}")
        tp_launches += got[1]
        bit_launches += got[2]
        sd_launches += got[3]
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
              f"truepeak, bitmeter, sigdist, r128, serial truepeak) launches {got}; {first}; "
              f"streams 0-3 after "
              f"{len(blocks)} blocks vs CPU: exact where exact, worst readout {worst:.3g} dB")

    # NaN / +-Inf samples: the card must bin and count them as the CPU does
    xs_nan = [torch.as_tensor(b, device=dev) for b in nan_blocks()]
    for name, kw, layout in STATS:
        if name not in ("dr14stereo", "SigDistHist"):
            continue
        m = meters_lv2_torch.create(name, FS, **kw)
        st = m.init((4,))
        n0 = sigdist_fused.launch_count
        for xb in xs_nan:
            st = m.update(st, stats_input(xb, layout))
        out, st = m.read(st)
        n_sd = sigdist_fused.launch_count - n0
        if n_sd != (len(xs_nan) if name == "SigDistHist" and not kw else 0):
            fail(f"NaN/Inf stream {name} {kw}: {n_sd} sigdist_fused launches")
        sd_launches += n_sd
        ref_state, ref_out = cpu_runs[name, tuple(kw.items()), "nan"].get(timeout=900)
        worst, errs = compare_stats(name, state_to_numpy(st),
                                    {k: v.cpu().numpy() for k, v in out.items()},
                                    ref_state, ref_out)
        if errs:
            fail(f"NaN/Inf stream {name} {kw}: card vs CPU: {'; '.join(errs)}")
        print(f"phase main: ok: NaN/+-Inf stream through {name}"
              f"{'(reference_oor_count)' if kw else ''}: card equals CPU "
              f"(worst readout {worst:.3g} dB), {n_sd} sigdist_fused launches")
    stop_workers()
    spec_main, spec_tail = spectrum_main(dev, blocks_dev, blocks3, reset_counts)
    marks.append(("main before surround", time.perf_counter()))
    sur_launches = surround_main(dev, blocks3, reset_counts)
    marks.append(("main surround", time.perf_counter()))
    stft_launches = analyzers_main(dev, blocks3, reset_counts, all_counts)
    marks.append(("main analyzers", time.perf_counter()))
    seg_launches, wide_launches = variants_main(dev, blocks_dev, reset_counts, all_counts)
    marks.append(("main variants", time.perf_counter()))
    r128_carried(dev, blocks_dev)
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

    # -- 6. ingest ----------------------------------------------------------
    ingest_launches = ingest_phase(dev, gpu, reset_counts, launch_counts)
    marks.append(("ingest", time.perf_counter()))

    # -- 7. live ------------------------------------------------------------
    live_launches = live_phase(dev, gpu, reset_counts, launch_counts, live_jobs)
    marks.append(("live", time.perf_counter()))

    # -- 8. sharded ---------------------------------------------------------
    sharded_launches, sharded_err = sharded_phase(dev, gpu)
    marks.append(("sharded", time.perf_counter()))

    # -- 9. tools -----------------------------------------------------------
    tools_launches = tools_phase(gpu)
    marks.append(("tools", time.perf_counter()))

    # -- 10. times -----------------------------------------------------------
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
    runs, enqueue = [], []
    for _ in range(3):
        st = meter.init((B_MAIN,), device=dev)
        st = meter.update(st, xb, flat=True)  # warm caches and allocator
        st = meter.init((B_MAIN,), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            st = meter.update(st, xb, flat=True)
        enqueue.append(time.perf_counter() - t0)
        out, _ = meter.read(st)
        torch.cuda.synchronize()
        out["integrated"].cpu()
        runs.append(time.perf_counter() - t0)
    xrt = B_MAIN * n_chunks / min(runs)
    print(f"phase times: main path {xrt:.1f} x-realtime (best of {len(runs)}: "
          f"{[round(r, 4) for r in runs]} s for {n_chunks} x 1 s blocks at B={B_MAIN}, "
          f"{min(runs) / n_chunks * 1e3:.3f} ms per update) [{gpu}]")
    flat_meter = types.SimpleNamespace(update=lambda s, x: meter.update(s, x, flat=True))
    r128_dev_us, r128_kern_us = device_us_per_update(flat_meter, st, [xb])
    print(f"phase times: EBUr128 update {min(runs) / n_chunks * 1e3:.3f} ms at B={B_MAIN}, host "
          f"enqueue {[round(e / n_chunks * 1e3, 3) for e in enqueue]} ms per update; "
          f"torch.profiler: device time {r128_dev_us:.1f} us per update, r128_fused "
          f"{r128_kern_us:.1f} us of it; r128_fused alone {ms_kernel:.4f} ms (PERF.md row 1) "
          f"[{gpu}]")

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
    # bitmeter_stats at the main-path shape: plain, kernel, kernel, plain;
    # and the kernel at a live meter's few streams
    x_bit = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (B_MAIN, FS), dtype=np.float32) * np.float32(0.1), device=dev)
    ms_k, ms_p = [], []
    for w in "pkkp":
        if w == "k":
            ms_k.append(cuda_ms(lambda: bitmeter_stats.bitmeter_stats(x_bit), 20))
        else:
            ms_p.append(cuda_ms(lambda: bitmeter_stats.bitmeter_stats_reference(x_bit), 3))
    times["bitmeter_stats"] = (statistics.mean(ms_k), statistics.mean(ms_p))
    bit_small = {n: cuda_ms(lambda: bitmeter_stats.bitmeter_stats(x_bit[:n]), 20) for n in (1, 8)}
    print(f"phase times: bitmeter_stats kernel {times['bitmeter_stats'][0]:.4f} ms (medians "
          f"{ms_k}), plain version {times['bitmeter_stats'][1]:.4f} ms (medians {ms_p}) at "
          f"N={B_MAIN} T={FS}; the kernel at N=1 {bit_small[1]:.4f} ms, N=8 "
          f"{bit_small[8]:.4f} ms [{gpu}]")
    # sigdist_fused at the main-path shape (channel 0 of the stereo block,
    # on a state with history): kernel, plain, plain, kernel; the launches
    # queued, so the wrapper's host time is hidden
    sd_meter = meters_lv2_torch.create("SigDistHist", FS)
    x_sd = blocks_dev[0][:, 0]
    st_sd = sd_meter._plain_update(sd_meter.init((B_MAIN,), device=dev), blocks_dev[1][:, 0])
    sd_args = [getattr(st_sd, k) for k in ("hist", "n", "mean", "m2", "total", "time",
                                           "integrating")]
    ms_k, ms_p = [], []
    for w in "kppk":
        if w == "k":
            ms_k.append(queued_ms(lambda: sigdist_fused.sigdist_fused(*sd_args, x_sd), 20))
        else:
            ms_p.append(queued_ms(lambda: sd_meter._plain_update(st_sd, x_sd), 3))
    times["sigdist_fused"] = (statistics.mean(ms_k), statistics.mean(ms_p))
    print(f"phase times: sigdist_fused kernel {times['sigdist_fused'][0]:.4f} ms (medians "
          f"{ms_k}), plain update {times['sigdist_fused'][1]:.4f} ms (medians {ms_p}) at "
          f"N={B_MAIN} T={FS} (row stride {x_sd.stride(0)}), launches queued [{gpu}]")
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
        # channel 0 in; the state (hist 361, n, mean, m2, total, time) in and
        # out, integrating in; 150 x + 180, its rounding, the sum and the
        # squared deviation (2) a sample
        "sigdist_fused": bound(4 * B_MAIN * FS + 2 * 4 * B_MAIN * (361 + 5) + B_MAIN,
                               6 * B_MAIN * FS),
        # x in, z0/v0 in and zf/val/peak out; per (sample, band) the
        # function's own work: six biquads of 5 MACs (60 operations), the
        # square (1), the smoother v + w (q - v) (3) and the max (1)
        "spectrum_fused": bound(4 * B_MAIN * FS + 4 * B_MAIN * 30 * (2 * 12 + 3),
                                SPEC_OPS * B_MAIN * FS * 30),
    }
    # x in, the K-meter / lowpass states in and out, pk and pacc out; the
    # function's own work per channel-sample and per pair-sample
    for C in (5, 8):
        bounds[f"surround_fused C={C}"] = surround_bound(B_MAIN, C, FS)
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
        "launches": launches - main_seg,  # the main path's full-rate updates
        "ingest_launches": ingest_launches["r128_fused"],  # phase ingest's pipeline runs
        "live_launches": live_launches["r128_fused"],  # phase live's four engine runs
        "sharded_launches": sharded_launches["r128_fused"],  # phase sharded, every rank
        "tools_launches": tools_launches.get("r128_fused", 0),  # phase tools' sweep
        # vs its plain version on a rank with a non-zero entry state
        "sharded_max_abs_err": sharded_err["r128_fused"],
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
        "ingest_launches": ingest_launches["ballistics"],  # phase ingest's pipeline runs
        "live_launches": live_launches["ballistics"],  # phase live's four engine runs
        "sharded_launches": sharded_launches["ballistics"],  # phase sharded, every rank
        "tools_launches": tools_launches.get("ballistics", 0),  # phase tools' sweep
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
        "ingest_launches": ingest_launches["truepeak_fused"],  # phase ingest's pipeline runs
        "live_launches": live_launches["truepeak_fused"],  # phase live's four engine runs
        "sharded_launches": sharded_launches["truepeak_fused"],  # phase sharded, every rank
        "tools_launches": tools_launches.get("truepeak_fused", 0),  # phase tools' sweep
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
        "ingest_launches": ingest_launches["bitmeter_stats"],  # phase ingest's pipeline runs
        "live_launches": live_launches["bitmeter_stats"],  # phase live's four engine runs
        "sharded_launches": sharded_launches["bitmeter_stats"],  # phase sharded, every rank
        "tools_launches": tools_launches.get("bitmeter_stats", 0),  # phase tools' sweep
        # vs its plain version on a rank with a non-zero entry state
        "sharded_max_abs_err": sharded_err["bitmeter_stats"],
        "max_abs_err": bit_err,  # every field at the main-path shape
        "ms": times["bitmeter_stats"][0],
        "plain_ms": times["bitmeter_stats"][1],
        "bound_ms": bounds["bitmeter_stats"][0],
        "bound_by": bounds["bitmeter_stats"][1],
        "library_ms": None,
        "ms_n1": bit_small[1],  # a live meter's few streams, T = 48000
        "ms_n8": bit_small[8],
    }, {
        "name": "sigdist_fused",
        "route": "cuda",
        "source": "meters_lv2_torch/csrc/sigdist_fused.cu",
        "replaces": None,  # the JAX package leaves SigDistMeter.update to XLA
        "launches": sd_launches,  # the statistics meters and the NaN/Inf streams, default mode
        "ingest_launches": ingest_launches["sigdist_fused"],  # phase ingest's pipeline runs
        "live_launches": live_launches["sigdist_fused"],  # phase live's four engine runs
        "sharded_launches": sharded_launches["sigdist_fused"],  # 0: no analysis updates
        "tools_launches": tools_launches.get("sigdist_fused", 0),  # 0: the sweep's oor mode
        "max_abs_err": sd_err,  # mean, m2, total over each one's scale at the main-path shape
        "ms": times["sigdist_fused"][0],
        "plain_ms": times["sigdist_fused"][1],
        "bound_ms": bounds["sigdist_fused"][0],
        "bound_by": bounds["sigdist_fused"][1],
        "library_ms": None,
    }, {
        "name": "spectrum_fused",
        "route": "cuda",
        "source": "meters_lv2_torch/csrc/spectrum_fused.cu",
        "replaces": "meters_lv2_tpu/ops/pallas_spectrum.py:357",
        "launches": spec_main + spec_tail,
        "ingest_launches": ingest_launches["spectrum_fused"],  # phase ingest's pipeline runs
        "live_launches": live_launches["spectrum_fused"],  # phase live's four engine runs
        "sharded_launches": sharded_launches["spectrum_fused"],  # phase sharded, every rank
        "tools_launches": tools_launches.get("spectrum_fused", 0),  # phase tools' sweep
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
        "ingest_launches": ingest_launches["surround_fused"],  # phase ingest's pipeline runs
        "live_launches": live_launches["surround_fused"],  # phase live's four engine runs
        "sharded_launches": sharded_launches["surround_fused"],  # phase sharded, every rank
        "tools_launches": tools_launches.get("surround_fused", 0),  # phase tools' sweep
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
        "ingest_launches": ingest_launches["stft_fused"],  # phase ingest's pipeline runs
        "live_launches": live_launches["stft_fused"],  # phase live's four engine runs
        "sharded_launches": sharded_launches["stft_fused"],  # phase sharded, every rank
        "tools_launches": tools_launches.get("stft_fused", 0),  # phase tools' sweep
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
        "ingest_launches": ingest_launches["ballistics_envelope"],  # phase ingest's pipeline runs
        "live_launches": live_launches["ballistics_envelope"],  # phase live's four engine runs
        "sharded_launches": sharded_launches["ballistics_envelope"],  # phase sharded, every rank
        "tools_launches": tools_launches.get("ballistics_envelope", 0),  # phase tools' sweep
        # vs its plain version on a rank with a non-zero entry state
        "sharded_max_abs_err": sharded_err["ballistics_envelope"],
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
        # the 12 blocks through fused_core(off=...) and the main path's seg-mode updates
        "launches": seg_launches + main_seg,
        "ingest_launches": ingest_launches["r128_fused_seg"],  # phase ingest's pipeline runs
        "live_launches": live_launches["r128_fused_seg"],  # phase live's four engine runs
        "sharded_launches": sharded_launches["r128_fused_seg"],  # phase sharded, every rank
        "tools_launches": tools_launches.get("r128_fused_seg", 0),  # phase tools' sweep
        "max_abs_err": seg_err,  # seg at the main-path shape, vs plain version
        "ms": var_times["seg"][0],
        "plain_ms": var_times["seg"][1],
        "bound_ms": bounds["r128_fused seg mode"][0],
        "bound_by": bounds["r128_fused seg mode"][1],
        "library_ms": None,
    }, {
        "name": "surround_fused_wide",
        # the body redesigned for Hopper; its parent is tools/surround_wide_probe_parent.cu
        "status": "redesigned",
        "route": "cuda",
        "source": "meters_lv2_torch/csrc/surround_wide.cu",
        "replaces": "meters_lv2_tpu/ops/pallas_surround.py:252",
        "launches": wide_launches,  # surround5 and surround8 with METERS_TORCH_SURROUND_WIDE=1
        "ingest_launches": ingest_launches["surround_fused_wide"],  # phase ingest's pipeline runs
        "live_launches": live_launches["surround_fused_wide"],  # phase live's four engine runs
        "sharded_launches": sharded_launches["surround_fused_wide"],  # phase sharded, every rank
        "tools_launches": tools_launches.get("surround_fused_wide", 0),  # phase tools' sweep
        "max_abs_err": wide_err,  # km_z, zl, pk and pacc at B=256 C=8 T=48000, vs plain
        "ms": var_times["wide C=8"][0],  # C=5 is printed in phase times
        "plain_ms": var_times["wide C=8"][1],
        "bound_ms": bounds["surround_fused wide C=8"][0],
        "bound_by": bounds["surround_fused wide C=8"][1],
        "library_ms": None,
        # {"B=.. C=..": [wide ms, narrow ms, bound ms]}, alternated
        "ms_by_shape": var_times["wide by shape"],
    }]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
