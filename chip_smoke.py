#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (meters_lv2_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:

  1. device   the card, its power limit, fp32 matmul precision settings;
  2. build    nvcc builds every kernel from meters_lv2_torch/csrc;
  3. kernels  each kernel against its plain PyTorch version on the card;
  4. main     EbuR128Meter.update/read at the bench operating point
              (B=256 streams of 48 kHz stereo, 1 s flat blocks), with the
              kernel launch count checked and streams 0-3 held against the
              same meter on CPU tensors;
  5. golden   two committed C-reference fixtures streamed on the card;
  6. times    kernel vs plain version, and main-path x-realtime.

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
        from meters_lv2_torch.ops import design, lti, r128_fused
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

    # -- 5. golden fixtures -------------------------------------------------
    gw = []
    for name in ("ebur128_aligned_mix.json", "ebur128_mix.json"):
        with open(os.path.join(ROOT, "tests", "fixtures", name)) as f:
            fx = json.load(f)
        gw.append(f"{name} worst {run_golden(meters_lv2_torch.create, fx, dev):.3g} dB")
    print(f"phase golden: ok: {'; '.join(gw)}; histograms and counts exact")

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
    n_chunks = 240
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
    }]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
