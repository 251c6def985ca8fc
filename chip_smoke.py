#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (meters_lv2_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:

  1. device   the card, its power limit, fp32 matmul precision settings;
  2. build    nvcc builds every kernel from meters_lv2_torch/csrc;
  3. kernels  each kernel (r128_fused, ballistics, truepeak_fused) against
              its plain PyTorch version on the same card tensors;
  4. main     at the bench operating point (B=256 streams of 48 kHz
              stereo, 12 flat 1 s blocks): EbuR128Meter, then dBTPstereo,
              BBCstereo, DINstereo, BBCM6, VUstereo, K20stereo and COR,
              each with the kernel launch counts checked and streams 0-3
              held against the same meter on CPU tensors; dBTPstereo also
              in 1000-sample blocks (a 104-sample tail per update);
  5. golden   committed C-reference fixtures streamed on the card: two
              R128 ones and every fixture of the ballistics families;
  6. times    each kernel vs its plain version, the ballistics kernel alone
              at 4,224 to 33,792 rows, and main-path x-realtime (R128 over
              120 blocks, down from 240 to keep the whole run well inside
              its time limit; dBTP, BBC and BBC M-6 over 60).

The last lines are a JSON summary of the kernels, the nvidia-smi name and
power limit, and {"ok": true, "device": {...}}.  Without CUDA, or outside a
checkout, it exits non-zero and prints no result.  It imports no JAX.
"""

import json
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
TPK_RTOL = 1e-5
COR_TOL = 1e-4  # card vs CPU correlation readout, absolute


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
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


def main():
    try:
        import torch
    except ImportError as e:
        fail(f"cannot import torch ({e})")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test runs the "
             "port on an NVIDIA GPU and does not run on the CPU")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    try:
        import meters_lv2_torch
        from meters_lv2_torch.ops import ballistics_core, design, lti, r128_fused, truepeak_fused
        from meters_lv2_torch.runtime import build
    except ImportError as e:
        fail(f"cannot import meters_lv2_torch ({e}): run from the root of a checkout")

    # -- 1. device ----------------------------------------------------------
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

    ball_err = tp_err = None
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
        ref = ballistics_core.ballistics_reference(*args, **w_ppm, track_peak=track_peak)
        torch.cuda.synchronize()
        err, errs = compare_ballistics(got, ref, tag)
        failures += [f"ballistics {tag}: {e}" for e in errs]
        ball_err = err
    for tag, N, T, inject in [
        ("N=3 T=1280", 3, 1280, False),
        ("NaN/+-Inf in x and hist N=6 T=1024", 6, 1024, True),
        (f"main-path shape N={2 * B_MAIN} T={FS}", 2 * B_MAIN, FS, False),
    ]:
        x = (0.3 * rng.standard_normal((N, T))).astype(np.float32)
        h = (0.1 * rng.standard_normal((N, 47))).astype(np.float32)
        st = [0.5 * v for v in states(N)]
        if inject:
            x[0, 300], x[1, 700], x[2, 130] = np.nan, np.inf, -np.inf
            h[3, 10], h[4, 46], h[5, 0] = np.nan, np.inf, -np.inf
        args = on_card(x, h, *st)
        got = truepeak_fused.truepeak_fused(*args, **w_tp)
        ref = truepeak_fused.truepeak_fused_reference(*args, **w_tp)
        torch.cuda.synchronize()
        err, errs = compare_truepeak(got, ref, tag)
        failures += [f"truepeak_fused {tag}: {e}" for e in errs]
        tp_err = err
    if failures:
        fail("kernel vs plain: " + " | ".join(failures))
    print("phase kernels: ok")

    # -- 4. main path -------------------------------------------------------
    meter = meters_lv2_torch.create("EBUr128", FS, nchan=2)
    rng = np.random.default_rng(0)
    blocks = [rng.standard_normal((B_MAIN, 2 * FS), dtype=np.float32) * np.float32(0.1)
              for _ in range(12)]
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
    st_c = meter.init((4,))
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
        r128_fused.launch_count = 0
        ballistics_core.launch_count = 0
        truepeak_fused.launch_count = 0

    def counts():
        return ballistics_core.launch_count, truepeak_fused.launch_count

    blocks3 = [b.reshape(B_MAIN, 2, FS) for b in blocks]  # [B, C, T] views
    blocks_dev = [torch.as_tensor(b, device=dev) for b in blocks3]
    ball_launches = tp_launches = 0
    # meter, state batch, expected (ballistics, truepeak) launches per update
    for name, batch, per_update in [
        ("dBTPstereo", (B_MAIN, 2), (0, 1)),
        ("BBCstereo", (B_MAIN, 2), (1, 0)),
        ("DINstereo", (B_MAIN, 2), (1, 0)),
        ("BBCM6", (B_MAIN,), (1, 0)),  # mid and side in one stacked launch
        ("VUstereo", (B_MAIN, 2), (0, 0)),
        ("K20stereo", (B_MAIN, 2), (0, 0)),
        ("COR", (B_MAIN,), (0, 0)),
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
        if got != want or r128_fused.launch_count:
            fail(f"main path {name}: (ballistics, truepeak) launches {got}, expected {want}")
        ball_launches += got[0]
        tp_launches += got[1]
        out = readouts(out)
        for k, v in out.items():
            if v.shape != batch or not bool(torch.isfinite(v).all()):
                fail(f"main path {name} readout {k} not finite of shape {batch}")
        st_c = m.init((4, *batch[1:]))
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
              f"(ballistics, truepeak) launches {got}; {first}; streams 0-3 vs CPU: "
              + ", ".join(f"{k} {d:.3g}" for k, d in diffs.items())
              + (" abs" if name == "COR" else " dB"))

    # dBTP in 1000-sample blocks: 896 samples through truepeak_fused and a
    # 104-sample tail through upsample4 + the ballistics kernel per update
    m = meters_lv2_torch.create("dBTPstereo", FS)
    x4 = blocks3[0][:4]
    st, st_c = m.init((4, 2), device=dev), m.init((4, 2))
    x4_dev = torch.as_tensor(x4, device=dev)
    reset_counts()
    for i in range(FS // 1000):
        st = m.update(st, x4_dev[..., i * 1000:(i + 1) * 1000])
    out, _ = m.read(st)
    torch.cuda.synchronize()
    got = counts()
    for i in range(FS // 1000):
        st_c = m.update(st_c, torch.as_tensor(x4[..., i * 1000:(i + 1) * 1000]))
    if got != (FS // 1000, FS // 1000):
        fail(f"dBTP 1000-sample blocks: (ballistics, truepeak) launches {got}")
    ball_launches += got[0]
    tp_launches += got[1]
    out_c, _ = m.read(st_c)
    d = max(level_db_diff(out[k].cpu(), out_c[k]) for k in out_c)
    if not d < TOL_DB:
        fail(f"dBTP 1000-sample blocks: card vs CPU differ by {d} dB")
    print(f"phase main: ok: dBTPstereo {FS // 1000} x 1000-sample blocks (104-sample tail) "
          f"on streams 0-3, (ballistics, truepeak) launches {got}; vs CPU {d:.3g} dB")

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
    for prefix in FAMILIES:
        try:
            worst, n = run_family(prefix, make_signal, device=dev)
        except AssertionError as e:
            fail(f"golden {prefix}: {e}")
        gw.append(f"{prefix} {n} values worst {worst:.3g}")
    print(f"phase golden: ok: ballistics families, whole fixtures (dB; stcorr absolute): "
          f"{'; '.join(gw)}")

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
    # versions loop in Python over 12,000 / 48,000 groups (seconds a call),
    # so they run 1 warmup + 2 timed calls, between two kernel turns
    t_abs = torch.abs(blocks_dev[0]).reshape(2 * B_MAIN, FS)
    x_tp = blocks_dev[0].reshape(2 * B_MAIN, FS)
    h0 = torch.zeros((2 * B_MAIN, 47), device=dev)
    zs = on_card(*[0.5 * v for v in states(2 * B_MAIN)])
    times = {}
    for name, kern, plain in [
        ("ballistics",
         lambda: ballistics_core.ballistics(t_abs, *zs, **w_ppm, track_peak=False),
         lambda: ballistics_core.ballistics_reference(t_abs, *zs, **w_ppm, track_peak=False)),
        ("truepeak_fused",
         lambda: truepeak_fused.truepeak_fused(x_tp, h0, *zs, **w_tp),
         lambda: truepeak_fused.truepeak_fused_reference(x_tp, h0, *zs, **w_tp)),
    ]:
        k1 = cuda_ms(kern, 10)
        pl = cuda_ms(plain, 2, warmup=1)
        k2 = cuda_ms(kern, 10)
        times[name] = (statistics.mean([k1, k2]), pl)
        print(f"phase times: {name} kernel {times[name][0]:.4f} ms (medians {[k1, k2]}), "
              f"plain version {pl:.1f} ms (median of 2 after 1 warmup) at N={2 * B_MAIN} "
              f"T={FS} [{gpu}]")
    # the ballistics kernel as rows grow: three 32-row CTAs fit on an SM,
    # so up to 132 * 96 = 12,672 rows run in one wave
    gen = torch.Generator(device=dev).manual_seed(0)
    t_big = torch.rand((33792, FS), generator=gen, device=dev) * 0.3
    scale = []
    for N in (4224, 12672, 33792):
        zn = [torch.zeros(N, device=dev) for _ in range(4)]
        ms = cuda_ms(lambda: ballistics_core.ballistics(
            t_big[:N], *zn, **w_ppm, track_peak=False), 5)
        scale.append(f"N={N} {ms:.4f} ms")
    del t_big
    print(f"phase times: ballistics kernel alone at T={FS}: {', '.join(scale)} [{gpu}]")
    n_chunks = 60
    for name, batch in [("dBTPstereo", (B_MAIN, 2)), ("BBCstereo", (B_MAIN, 2)),
                        ("BBCM6", (B_MAIN,))]:
        m = meters_lv2_torch.create(name, FS)
        runs = []
        for _ in range(2):
            st = m.update(m.init(batch, device=dev), blocks_dev[0])  # warm
            st = m.init(batch, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(n_chunks):
                st = m.update(st, blocks_dev[i % len(blocks_dev)])
            out, _ = m.read(st)
            torch.cuda.synchronize()
            [v.cpu() for v in readouts(out).values()]
            runs.append(time.perf_counter() - t0)
        print(f"phase times: {name} {B_MAIN * n_chunks / min(runs):.1f} x-realtime (best of "
              f"{len(runs)}: {[round(r, 4) for r in runs]} s for {n_chunks} x 1 s blocks at "
              f"B={B_MAIN}, {min(runs) / n_chunks * 1e3:.3f} ms per update) [{gpu}]")

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
    }, {
        "name": "ballistics",
        "route": "cuda",
        "source": "meters_lv2_torch/csrc/ballistics.cu",
        "replaces": "meters_lv2_tpu/ops/pallas_ballistics.py:133",
        "launches": ball_launches,
        "max_abs_err": ball_err,  # all outputs at the main-path shape
        "ms": times["ballistics"][0],
        "plain_ms": times["ballistics"][1],
    }, {
        "name": "truepeak_fused",
        "route": "cuda",
        "source": "meters_lv2_torch/csrc/truepeak_fused.cu",
        "replaces": "meters_lv2_tpu/ops/pallas_truepeak.py:161",
        "launches": tp_launches,
        "max_abs_err": tp_err,  # z1, z2, m, p at the main-path shape
        "ms": times["truepeak_fused"][0],
        "plain_ms": times["truepeak_fused"][1],
    }]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
