"""Command-line batch metering on the port: the offline counterpart of the
reference's standalone apps (x42-meter-collection, doc/x42-meter.1).

    python -m meters_lv2_torch FILES... [--meters r128,truepeak,k20,...]
                                        [--json] [--chunk-seconds 2.0] [--cpu]

All files are decoded (native WAV codec), padded into one batch and
metered together on the CUDA card, each over exactly its own length.
Without --cpu the CLI needs a CUDA device; --cpu meters on CPU tensors
(the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np

# every capability the reference bundles in x42-meter-collection
# (doc/x42-meter.1:16-76, lv2ttl/plugins.h:26-52)
METER_CHOICES = [
    "r128", "truepeak", "vu", "din", "nor", "bbc", "ebu", "bbcms",
    "k12", "k14", "k20", "cor", "dr14", "tpnrms", "spectrum", "sigdist",
    "bitmeter", "surround", "goniometer", "phasewheel", "stereoscope",
]

# GUI-thread display processors: run on the trailing audio window outside
# the measuring pipeline (like the reference's GUI analyzing the most
# recent ring-buffer / raw-atom audio, src/xfer.c, src/goniometerlv2.c)
DISPLAY_METERS = ("goniometer", "phasewheel", "stereoscope")

# meters whose reference plugin is stereo-only
_STEREO_ONLY = ("bbcms", "cor", "goniometer", "phasewheel", "stereoscope")


def applicable_meters(nchan: int) -> list[str]:
    """The subset of METER_CHOICES that can run on nchan-channel audio
    (the '--meters all' expansion)."""
    out = []
    for n in METER_CHOICES:
        if n in _STEREO_ONLY and nchan != 2:
            continue
        if n == "surround" and not (3 <= nchan <= 8):
            continue
        if n == "r128" and nchan > 5:  # MAXCH=5 (ebu_r128_proc.h:26)
            continue
        out.append(n)
    return out


def validate_meters(spec: str, nchan: int, error) -> list[str]:
    """Expand a '--meters' comma list ('all' -> applicable_meters) and
    check each name + its channel-count constraint, reporting failures
    through `error` (argparse .error or any raiser).  Shared by the batch
    CLI and the live shell."""
    names = [m.strip() for m in spec.split(",") if m.strip()]
    if names == ["all"]:
        return applicable_meters(nchan)
    for n in names:
        if n not in METER_CHOICES:
            error(f"unknown meter {n!r}")
        if n in _STEREO_ONLY and nchan != 2:
            error(f"meter {n!r} needs stereo input, files have "
                  f"{nchan} channels")
        # channel-count constraints mirror applicable_meters() so an
        # explicit request fails as an argparse error, not an assert
        if n == "surround" and not (3 <= nchan <= 8):
            error(f"surround needs 3..8 channels, files have {nchan}")
        if n == "r128" and nchan > 5:  # MAXCH=5 (ebu_r128_proc.h:26)
            error(f"r128 supports at most 5 channels, files have {nchan}")
    return names


def parse_surround_pairs(spec, nchan: int, error):
    """Parse '--surround-pairs A:B,...' (surc_a/b routing ports,
    src/surmeter.c:119-128): 3 pairs for 3-channel, else 4."""
    if not spec:
        return None
    npair = 4 if nchan > 3 else 3
    pairs = []
    for p in spec.split(","):
        parts = p.split(":")
        try:
            a, b = (int(v) for v in parts)
        except ValueError:
            error(f"--surround-pairs entry {p!r} is not A:B integers")
        if not (0 <= a < nchan and 0 <= b < nchan):
            error(f"--surround-pairs entry {p!r} out of range "
                  f"0..{nchan - 1}")
        pairs.append((a, b))
    if len(pairs) != npair:
        error(f"--surround-pairs needs {npair} A:B pairs for "
              f"{nchan} channels")
    return tuple(pairs)


def build_meter(name: str, fs: float, nchan: int, surround_pairs=None,
                runtime_ports: bool = False):
    """runtime_ports=True builds meters with their runtime-mutable control
    ports enabled (the r128 radar interval as state): the live shell's
    meters, where controls arrive mid-stream like LV2 port writes."""
    from .models import (
        cor, dr14, ebur128, goniometer, kmeter, needle, phasewheel,
        sigdist, spectrum, surround, truepeak, bitmeter,
    )

    def _surround():
        assert 3 <= nchan <= 8, (
            f"surround needs 3..8 channels, file has {nchan}"
        )
        cls = getattr(surround, f"Surround{nchan}Meter")
        return cls(fs, pairs=surround_pairs)

    table = {
        "r128": lambda: ebur128.EbuR128Meter(
            fs, nchan=nchan, runtime_radar_speed=runtime_ports),
        "truepeak": lambda: truepeak.TruePeakMeter(fs),
        "vu": lambda: needle.VUMeter(fs),
        "din": lambda: needle.DINMeter(fs),
        "nor": lambda: needle.NordicMeter(fs),
        "bbc": lambda: needle.BBCMeter(fs),
        "ebu": lambda: needle.EBUMeter(fs),
        "bbcms": lambda: needle.BBCMidSideMeter(fs),
        "k12": lambda: kmeter.K12Meter(fs),
        "k14": lambda: kmeter.K14Meter(fs),
        "k20": lambda: kmeter.K20Meter(fs),
        "cor": lambda: cor.CorrelationMeter(fs),
        "dr14": lambda: dr14.DR14Meter(fs, nchan=nchan),
        "tpnrms": lambda: dr14.TPnRMSMeter(fs, nchan=nchan),
        "spectrum": lambda: spectrum.SpectrumAnalyzer(fs),
        "sigdist": lambda: sigdist.SigDistMeter(fs),
        "bitmeter": lambda: bitmeter.BitMeter(fs),
        "surround": _surround,
        "goniometer": lambda: goniometer.Goniometer(fs),
        "phasewheel": lambda: phasewheel.PhaseWheel(fs),
        "stereoscope": lambda: phasewheel.Stereoscope(fs),
    }
    return table[name]()


def _run_display_meters(names, x, lengths, fs, device):
    """Run the GUI-thread display processors over each file's trailing
    ~1 s window (hop-aligned), one process() call per meter for the batch.

    x is the host batch [B, C, T].  Returns {meter: readout dict with
    leading batch axis}.  Mirrors the reference split where these analyses
    run GUI-side on the most recent audio (SURVEY §3.4): the trace, wheel
    and scope views show current content, not a whole-file aggregate.
    """
    import torch

    B, C, _ = x.shape
    outs = {}
    for name in names:
        m = build_meter(name, fs, C)
        hop = m.stft.hop if hasattr(m, "stft") else 4
        disp_T = hop * max(1, int(round(fs / hop)))  # ~1 s, hop-aligned
        xw = np.zeros((B, C, disp_T), np.float32)
        for i in range(B):
            end = int(lengths[i])
            n = min(end, disp_T)
            xw[i, :, disp_T - n :] = x[i, :, end - n : end]
        st = m.init((B,), device=device)
        outs[name] = m.process(st, torch.as_tensor(xw, device=device))[0]
    return outs


def _row(o, i):
    """File i's part of a batched host readout."""
    if isinstance(o, dict):
        return {k: _row(v, i) for k, v in o.items()}
    return o[i]


def _finite(v: float):
    """RFC-compliant JSON: -inf (empty radar slots) / NaN become null —
    json.dumps would emit the non-standard -Infinity/NaN tokens that
    JSON.parse and jq reject."""
    v = float(v)
    return v if math.isfinite(v) else None


def _to_py(o):
    if isinstance(o, dict):
        return {k: _to_py(v) for k, v in o.items()}
    arr = np.asarray(o)
    if arr.size > 64:  # don't dump whole histograms unless asked
        return {"shape": list(arr.shape), "max": _finite(arr.max())}
    if arr.ndim == 0:
        return _finite(arr)
    return [
        _finite(v) if not math.isfinite(float(v)) else round(float(v), 6)
        for v in arr.ravel()
    ]


def _render_views(render_dir, names, host, files, fs):
    """Save each meter's end-of-file inline view as {file}_{meter}.png
    (the batch analog of the reference's inline-display renderers); host
    holds each meter's batched readout as numpy arrays."""
    import os

    from .utils import render
    from .utils.png import write_png

    os.makedirs(render_dir, exist_ok=True)
    for i, path in enumerate(files):
        base = os.path.splitext(os.path.basename(path))[0]
        for n in names:
            img = render.meter_view(n, _row(host[n], i), fs)
            if img is not None:
                write_png(os.path.join(render_dir, f"{base}_{n}.png"), img)


def print_plugin_list(out=None):
    """--list: the x42-meter '-l' analog (doc/x42-meter.1:12-76) — every
    creatable plugin name, 1:1 with the reference's 38 exported
    descriptors (src/meters.cc:745-792)."""
    from .models import base as mbase
    from .models import schema as mschema

    out = out or sys.stdout
    for i, name in enumerate(mbase.available()):
        if name.endswith("mono"):
            ch = "1"
        elif name.endswith("stereo"):
            ch = "2"
        else:
            try:
                ch = "/".join(
                    str(c) for c in mschema.schema_for(name).channels
                )
            except KeyError:
                ch = "?"
        print(f"{i:2d}  {name}  ({ch} ch)", file=out)


def print_portlist(out=None):
    """--portlist: the x42-meter '-P' analog (doc/x42-meter.1) — control
    inputs and readout keys per plugin family, from the schema registry
    (models/schema.py = the lv2ttl port tables)."""
    from .models import base as mbase
    from .models import schema as mschema

    out = out or sys.stdout
    byfam: dict = {}
    orphans = []
    for name in mbase.available():
        try:
            s = mschema.schema_for(name)
        except KeyError:
            orphans.append(name)  # registered without a schema — surface
            continue              # it, don't silently drop (--list shows ?)
        byfam.setdefault(s.uri_suffix, (s, []))[1].append(name)

    def fmt(c):
        lo = "" if c.lo is None else c.lo
        hi = "" if c.hi is None else c.hi
        rng = f" [{lo}..{hi}]" if (c.lo is not None or c.hi is not None) else ""
        dfl = f" default={c.default}" if c.default is not None else ""
        doc = f"  -- {c.doc}" if c.doc else ""
        return f"    {c.name} ({c.unit}){rng}{dfl}{doc}"

    for fam, (s, names) in sorted(byfam.items()):
        print(f"{fam}  [{', '.join(names)}]  channels="
              f"{','.join(str(c) for c in s.channels)}", file=out)
        if s.inputs:
            print("  control inputs:", file=out)
            for c in s.inputs:
                print(fmt(c), file=out)
        if s.outputs:
            print("  readouts:", file=out)
            for c in s.outputs:
                print(fmt(c), file=out)
    for name in orphans:
        print(f"{name}  [no schema registered]", file=out)


def main(argv=None):
    from . import __version__

    ap = argparse.ArgumentParser(prog="meters_lv2_torch", description=__doc__)
    ap.add_argument("files", nargs="*", help="WAV files to analyze")
    ap.add_argument(
        "--list", action="store_true",
        help="print the creatable plugin names and exit (x42-meter -l)",
    )
    ap.add_argument(
        "--portlist", action="store_true",
        help="print control inputs / readout keys per plugin family and"
             " exit (x42-meter -P)",
    )
    ap.add_argument(
        "--version", action="version",
        version=f"meters_lv2_torch {__version__}",
    )
    ap.add_argument(
        "--meters", default="r128,truepeak",
        help=f"comma list from: {','.join(METER_CHOICES)}",
    )
    ap.add_argument("--json", action="store_true", help="machine output")
    ap.add_argument("--chunk-seconds", type=float, default=2.0)
    ap.add_argument(
        "--ref-level", type=float, default=None,
        help="needle-meter reference level in dBFS (the lv2ttl ref-level"
             " port; default: each meter's own TTL default, -22)",
    )
    ap.add_argument(
        "--target-rate", type=int, default=None,
        help="resample mixed-rate inputs to this rate on ingest",
    )
    ap.add_argument(
        "--render-dir", default=None,
        help="write end-of-file meter views as PNGs (radar, needle faces,"
             " bargraphs, spectrum, sigdist, bitmeter) to this directory",
    )
    ap.add_argument(
        "--surround-pairs", default=None, metavar="A:B,A:B,...",
        help="correlator channel pairs for the surround meter (the"
             " reference's surc_a/surc_b ports, src/surmeter.c:119-128);"
             " e.g. 0:1,2:3,0:4,1:4",
    )
    ap.add_argument(
        "--cpu", action="store_true",
        help="meter on CPU tensors (the kernels' plain versions); without"
             " it a CUDA device is required",
    )
    args = ap.parse_args(argv)

    if args.list:
        print_plugin_list()
        return 0
    if args.portlist:
        print_portlist()
        return 0
    if not args.files:
        ap.error("files required (or --list / --portlist / --version)")

    import torch

    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        ap.error("no CUDA device: the port meters on the card; pass --cpu to"
                 " meter on the CPU")

    from .io.batch import load_files
    from .io.stream import to_host
    from .parallel.pipeline import MeterPipeline

    batch = load_files(args.files, target_rate=args.target_rate, device=device)
    B, C, T = batch.data.shape
    fs = batch.rate

    names = validate_meters(args.meters, C, ap.error)
    disp_names = [n for n in names if n in DISPLAY_METERS]
    pipe_names = [n for n in names if n not in DISPLAY_METERS]
    spairs = parse_surround_pairs(args.surround_pairs, C, ap.error)
    pipe = MeterPipeline(
        {n: build_meter(n, fs, C, surround_pairs=spairs)
         for n in pipe_names}, nchan=C
    )

    # chunk on the meters' 4-sample grain: a non-multiple would inject
    # padding mid-stream (and 0 would div-by-zero below)
    chunk = max(4, int(fs * args.chunk_seconds) // 4 * 4)
    Tpad = ((T + chunk - 1) // chunk) * chunk
    x = np.zeros((B, C, Tpad), np.float32)
    x[:, :, :T] = batch.data

    # measure each file over exactly its own length (4-sample grain):
    # padding past a file's end is never processed, matching a per-file
    # reference run (src/meters.cc:298-331, one run() stream per track)
    lengths = (np.asarray(batch.lengths) // 4) * 4
    st = pipe.init((B,), device=device)
    st = pipe.run_stream_ragged(st, torch.as_tensor(x, device=device), lengths, chunk)
    outs, _ = pipe.read(st, ref_level_db=args.ref_level)
    if disp_names:
        outs = {**outs, **_run_display_meters(disp_names, x, lengths, fs, device)}

    # one device-to-host copy per readout leaf, not one per file
    host = {n: to_host(outs[n]) for n in names}
    if args.render_dir:
        _render_views(args.render_dir, names, host, args.files, fs)

    results = []
    for i, path in enumerate(args.files):
        row = {"file": path, "seconds": float(batch.lengths[i] / fs)}
        for n in names:
            row[n] = _to_py(_row(host[n], i))
        results.append(row)

    if args.json:
        print(json.dumps(results, indent=None))
    else:
        for row in results:
            print(f"== {row['file']} ({row['seconds']:.1f}s)")
            for n in names:
                print(f"  [{n}] {json.dumps(row[n])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
