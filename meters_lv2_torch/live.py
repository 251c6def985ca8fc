"""Live streaming meter shell on the port (counterpart of
``meters_lv2_tpu/live.py``): the realtime-app analog of the reference's
standalone JACK meters (x42-meter-collection: robtk wraps each plugin DSP
in a JACK client + interactive GUI, Makefile:281-446, gui/meters.c:43-57).

    python -m meters_lv2_torch.live FILE.wav [--meters r128,truepeak,...]
                                    [--port 8765] [--fps 10] [--speed 1.0]
    some-source | python -m meters_lv2_torch.live --stdin --rate 48000 \\
                                    --channels 2 --format f32

One feeder thread paces chunks of the file through the meters at
``--speed`` x realtime (0 = unpaced), or, with ``--stdin``, meters a live
raw-audio stream at the producer's own pace (the JACK-capture analog; see
feed_stream), while an embedded zero-dependency HTTP server serves an
auto-refreshing dashboard: every selected meter's inline view
(utils/render.meter_view) as PNG plus a JSON readout, with the reference
EBU GUI's transport controls (integration start / pause / reset, radar
reset: gui/ebur.c button row) exposed as endpoints.

The meter state stays on the CUDA card (``--cpu``: CPU tensors); the feeder
only enqueues update() calls and the server fetches small readouts once per
feed generation.  Without ``--cpu`` a CUDA device is required: there is no
fallback to the CPU.  Every device operation of the engine runs under its
lock, so the feeder thread and the server's request threads never overlap
on the card, nor inside ``ops/lti.py::ieee_fp32``'s process-wide precision
switch.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import select
import sys
import threading
import time

import numpy as np

from .__main__ import DISPLAY_METERS, build_meter, _to_py

# gui/ebur.c BTN_START/PAUSE/RESET + the radar-clear control
# (CTL_LV2_RESETRADAR vocabulary word; EbuR128Meter.radar_reset) +
# the K-meter wrapper's ref-level-edge peak-hold reset
# (src/meters.cc:337-357; KMeter.reset_peak)
_CONTROLS = ("start", "pause", "reset", "reset_radar", "reset_peak")

# meters whose read() takes the reference-level port
# (src/meters.cc:303-306 rlgain; lv2ttl default -22 dBFS)
_NEEDLES = ("vu", "din", "nor", "bbc", "ebu", "bbcms")


def _on_device(block: np.ndarray, device):
    """A host block as a float32 tensor on `device`.  torch.as_tensor gets a
    contiguous, writable copy: a pipe's bytes are read-only and a
    transposed or sliced block is strided."""
    import torch

    return torch.as_tensor(np.array(block, dtype=np.float32, order="C"), device=device)


class LiveEngine:
    """Streaming meter bank over one audio stream ([C, T] blocks) on
    `device` ("cuda" unless the caller asks for the CPU).

    Thread-safe: feed() runs in the ingest thread; snapshot()/frame()/
    control() may be called from server threads.  Mirrors the reference's
    RT/GUI split: run() mutates DSP state, the GUI polls readouts."""

    def __init__(self, names, fs, nchan, surround_pairs=None, device="cuda"):
        import inspect

        import torch

        from .parallel.pipeline import MeterPipeline

        self.device = torch.device(device)
        torch.empty(0, device=self.device)  # an absent device raises torch's own error here
        self.fs = float(fs)
        self.nchan = int(nchan)
        self.names = list(names)
        self._lock = threading.Lock()
        self._display = {}
        win = 0
        pipe_meters = {}
        for n in self.names:
            m = build_meter(n, fs, nchan, surround_pairs=surround_pairs,
                            runtime_ports=True)
            if n in DISPLAY_METERS:
                hop = m.stft.hop if hasattr(m, "stft") else 4
                w = hop * max(1, int(round(fs / hop)))  # ~1 s, hop-aligned
                # the goniometer's autogain toggle is a Python bool argument
                has_ag = "autogain" in inspect.signature(m.process).parameters
                self._display[n] = (m, w, has_ag)
                win = max(win, w)
            else:
                pipe_meters[n] = m
        # every pipeline meter updates per block, with the same channel
        # routing as the batch CLI (MeterPipeline's modes)
        self._pipe = MeterPipeline(pipe_meters, nchan=nchan)
        self._state = self._pipe.init((), device=self.device)
        # update() control ports (LV2 port-write analog): host values read
        # at every update, so they swap mid-stream
        self._controls = (
            {"bbcms": {"s20": np.asarray(False)}}
            if "bbcms" in pipe_meters else {}
        )
        # per-needle reference levels ride read() as host floats
        self._needles = tuple(n for n in pipe_meters if n in _NEEDLES)
        # trailing-window ring for the GUI-thread analyzers (the analog of
        # the reference GUI reading the most recent ring-buffer audio)
        self._ring = np.zeros((nchan, max(win, 4)), np.float32)
        self.fed_samples = 0
        self.generation = 0  # bumped per feed; readout cache key
        self._frames: dict[str, tuple[int, bytes]] = {}
        self._snap: tuple[int, dict] | None = None
        # host-held runtime port values (LV2 control ports live in the
        # host and are re-read every run(), so they survive resets and
        # seed the dashboard's initial control widgets)
        self._port_values: dict[tuple[str, str], float] = {}
        if "spectrum" in pipe_meters:
            self._port_values[("spectrum", "speed")] = float(
                pipe_meters["spectrum"].speed)
        if "r128" in pipe_meters:
            from .models.ebur128 import RADAR_POINTS

            self._port_values[("r128", "radar_seconds")] = (
                pipe_meters["r128"].radar_spd * RADAR_POINTS / self.fs)
        if "bbcms" in pipe_meters:
            self._port_values[("bbcms", "s20")] = 0.0
        # host-held read/display ports (no setter: the value is re-read at
        # every readout/frame, exactly like an LV2 control port)
        for n in self._needles:
            self._port_values[(n, "ref_level_db")] = -22.0
        if "goniometer" in self._display:
            # gui/goniometer.c prefs, persisted via LV2 State
            # (src/goniometerlv2.c:210-293)
            self._port_values[("goniometer", "autogain")] = 1.0
            self._port_values[("goniometer", "gain")] = 1.0
            self._port_values[("goniometer", "persistence")] = 0.33
        for n in ("phasewheel", "stereoscope"):
            if n in self._display:  # display floor (gui/phasewheel.c:1296)
                self._port_values[(n, "floor_db")] = -60.0

    def feed(self, block: np.ndarray):
        """Ingest one [C, T] host block (any T).  Only the 4-aligned prefix
        is measured (the meters' minimum block granularity); real trailing
        samples beyond the last multiple of 4 still reach the display
        ring.  Zero-padding is never fed: the padding-never-measured
        invariant of the batch path (pipeline.run_stream_ragged) holds
        here too."""
        T = block.shape[-1]
        T4 = T // 4 * 4
        with self._lock:
            if self._pipe.meters and T4:
                blk = _on_device(block[..., :T4], self.device)
                self._state = self._pipe.update(self._state, blk, self._controls)
            w = self._ring.shape[-1]
            if T >= w:
                self._ring[:] = block[..., -w:]
            elif T:
                self._ring = np.roll(self._ring, -T, axis=-1)
                self._ring[..., -T:] = block
            self.fed_samples += T
            self.generation += 1

    def _outs(self) -> dict:
        """Every meter's current readout (host numpy), cached per
        generation so polling at the frame rate costs one device
        round-trip per feed, not per request.  Lock must be held."""
        from .io.stream import to_host

        gen = self.generation
        if self._snap is not None and self._snap[0] == gen:
            return self._snap[1]
        outs = {}
        if self._pipe.meters:
            rl = {n: self._port_values[(n, "ref_level_db")] for n in self._needles}
            pouts, self._state = self._pipe.read(self._state, ref_level_db=rl)
            for n in self._pipe.meters:
                outs[n] = to_host(pouts[n])
        for n, (m, w, has_ag) in self._display.items():
            kw = {}
            if has_ag:
                kw["autogain"] = bool(self._port_values.get((n, "autogain"), 1.0))
            o, _ = m.process(m.init((), device=self.device),
                             _on_device(self._ring[..., -w:], self.device), **kw)
            outs[n] = to_host(o)
        self._snap = (gen, outs)
        return outs

    def _read_one(self, n):
        """One meter's current readout (host numpy)."""
        with self._lock:
            return self._outs()[n]

    def snapshot(self) -> dict:
        with self._lock:
            outs = self._outs()
        return {n: outs[n] for n in self.names}

    def frame(self, n: str) -> bytes:
        """Current PNG view for meter n (cached per feed generation); the
        view and the PNG are made on the host, outside the lock."""
        from .utils.png import encode_png
        from .utils.render import meter_view

        with self._lock:
            gen = self.generation
            hit = self._frames.get(n)
            if hit is not None and hit[0] == gen:
                return hit[1]
            out = self._outs()[n]
            prefs = {p: v for (mm, p), v in self._port_values.items() if mm == n}
        img = meter_view(n, out, self.fs, prefs=prefs)
        png = encode_png(img) if img is not None else b""
        with self._lock:
            self._frames[n] = (gen, png)
        return png

    def control(self, action: str, meter: str | None = None):
        """Transport controls (gui/ebur.c button row; ebu_r128_proc.h
        integr_start/integr_pause/integr_reset; 'reset_radar' clears the
        radar ring alone, CTL_LV2_RESETRADAR).  'reset' re-inits any
        non-r128 meter on the engine's device (the plugin-reinstantiation
        analog) and then re-applies its runtime port values, since LV2
        control ports are host-held and re-read every run()."""
        if action not in _CONTROLS:
            raise ValueError(f"unknown control {action!r}")
        with self._lock:
            targets = [meter] if meter else list(self._pipe.meters)
            for n in targets:
                if n not in self._pipe.meters:
                    continue
                m = self._pipe.meters[n]
                if action == "reset_peak":
                    # ref-level port edge = peak-hold reset on the K
                    # meters (src/meters.cc:337-357)
                    if hasattr(m, "reset_peak"):
                        self._state[n] = m.reset_peak(self._state[n])
                elif n == "r128":
                    if action == "reset_radar":
                        self._state[n] = m.radar_reset(self._state[n])
                    else:
                        fn = getattr(m, f"integr_{action}")
                        self._state[n] = fn(self._state[n])
                elif action == "reset":
                    self._state[n] = self._pipe.init((), device=self.device)[n]
                    for (pm, pp), v in self._port_values.items():
                        # host-held read/display ports have no setter:
                        # they are re-read at every readout, so a reset
                        # cannot revert them
                        setter = self.PORTS.get((pm, pp))
                        if pm == n and setter is not None:
                            getattr(self, setter)(v)
            self.generation += 1

    # runtime control ports: (meter, param) -> setter.  Each is either a
    # state update on the device (spectrumlv2.c:161-177 speed,
    # src/ebulv2.cc:75-78 radar time) or a host value update() reads
    # (BBC M-6 s20, src/meters.cc:562-563).
    PORTS = {
        ("spectrum", "speed"): "_set_spectrum_speed",
        ("r128", "radar_seconds"): "_set_radar_seconds",
        ("bbcms", "s20"): "_set_s20",
    }

    def set_port(self, meter: str, param: str, value: float):
        """Write one runtime control port, like an LV2 port event.

        State/update ports go through their setter (PORTS); host-held
        read/display ports (needle ref-level, goniometer prefs, display
        floors: every key seeded in _port_values) just store the value:
        it is re-read at the next readout/frame, exactly like an LV2
        control port the host rewrites before run()."""
        if not math.isfinite(float(value)):
            # a NaN slips through the setters' torch.clamp range clamps and
            # would poison the state / break RFC JSON readouts
            raise ValueError(f"non-finite value for {meter}.{param}")
        setter = self.PORTS.get((meter, param))
        if setter is not None and meter in self._pipe.meters:
            with self._lock:
                getattr(self, setter)(float(value))
                self._port_values[(meter, param)] = float(value)
                self.generation += 1
        elif (meter, param) in self._port_values:
            with self._lock:
                self._port_values[(meter, param)] = float(value)
                self.generation += 1
        else:
            raise ValueError(f"unknown port {meter}.{param}")

    def port_values(self) -> dict:
        """Current runtime port values as '{meter}.{param}' -> float
        (seeds the dashboard's control widgets)."""
        with self._lock:
            return {f"{m}.{p}": v for (m, p), v in self._port_values.items()}

    def _set_spectrum_speed(self, v):
        m = self._pipe.meters["spectrum"]
        self._state["spectrum"] = m.set_speed(self._state["spectrum"], v)

    def _set_radar_seconds(self, v):
        m = self._pipe.meters["r128"]
        self._state["r128"] = m.set_radar_speed(self._state["r128"], v)

    def _set_s20(self, v):
        self._controls["bbcms"]["s20"] = np.asarray(bool(v))

    # -- session persistence --------------------------------------------
    # The LV2 State analog (src/ebulv2.cc:514-553 persists ui_settings |
    # transport | radar_speed; measurement state restarts on resume).
    # Here the FULL measurement state round-trips, so a monitoring
    # session survives restarts with its histograms/radar/integration
    # intact: strictly more than the reference persists.  The session
    # tree has the JAX engine's keys and leaf types, so a session file
    # saved by either package loads into the other.

    def _config_sig(self) -> np.ndarray:
        """Fixed-size digest of (meters, fs, nchan): same leaf shape in
        every session, so load_state round-trips it and load() can reject
        a checkpoint from a different configuration with a clear error
        instead of positionally corrupting state."""
        import hashlib

        cfg = json.dumps(
            {"meters": self.names, "fs": self.fs, "nchan": self.nchan},
            sort_keys=True,
        )
        return np.frombuffer(hashlib.sha256(cfg.encode()).digest(), np.uint8).copy()

    def _session_tree(self):
        return {
            "state": self._state,
            "controls": self._controls,
            "ports": {
                f"{m}.{p}": np.float64(v)
                for (m, p), v in sorted(self._port_values.items())
            },
            "ring": self._ring,
            "fed": np.int64(self.fed_samples),
            "config": self._config_sig(),
        }

    def save(self, path: str):
        from .utils.state import save_state

        with self._lock:
            save_state(self._session_tree(), path)

    def load(self, path: str):
        """Restore a session; the meter state lands on the engine's device
        (load_state places each tensor as the engine's own)."""
        from .utils.state import load_state

        with self._lock:
            got = load_state(self._session_tree(), path)
            if not np.array_equal(np.asarray(got["config"]), self._config_sig()):
                raise ValueError(
                    "checkpoint was saved with a different meters/fs/"
                    "nchan configuration than this engine"
                )
            self._state = got["state"]
            # control ports and the ring live host-side
            self._controls = {
                m: {k: np.asarray(v) for k, v in ports.items()}
                for m, ports in got["controls"].items()
            }
            self._port_values = {
                tuple(k.split(".", 1)): float(v)
                for k, v in got["ports"].items()
            }
            self._ring = np.array(got["ring"])  # writable host copy
            self.fed_samples = int(got["fed"])
            self.generation += 1


_PAGE = """<!doctype html><title>meters_lv2_torch live</title>
<body style="background:#111;color:#ddd;font-family:monospace">
<h3>meters_lv2_torch live</h3>
<div id=bar>
 <button onclick="ctl('start')">integr start</button>
 <button onclick="ctl('pause')">integr pause</button>
 <button onclick="ctl('reset')">integr reset</button>
 <span id=ports></span>
 <span id=stat></span></div>
<div id=views></div>
<script>
const meters = %METERS%; const fps = %FPS%; const portv = %PORTVALS%;
const views = document.getElementById('views');
for (const m of meters) {
  const d = document.createElement('div');
  d.style = 'display:inline-block;margin:6px;text-align:center';
  d.innerHTML = `<div>${m}</div><img id="im_${m}"
    style="image-rendering:pixelated;min-width:160px">`;
  views.appendChild(d);
}
function ctl(a){fetch('/ctl?action='+a);}
function port(m,p,v){fetch(`/ctl?action=set&meter=${m}&param=${p}&value=${v}`);}
const ports = document.getElementById('ports');
if (meters.includes('spectrum')) ports.innerHTML +=
  ` spectrum speed <input type=number value=${portv['spectrum.speed']}
    min=0.01 max=15 step=0.5
    style="width:4em" onchange="port('spectrum','speed',this.value)">`;
if (meters.includes('r128')) ports.innerHTML +=
  ` radar <input type=number value=${portv['r128.radar_seconds']}
    min=30 max=720 step=30
    style="width:4em" onchange="port('r128','radar_seconds',this.value)">s
  <button onclick="ctl('reset_radar')">radar reset</button>`;
if (meters.includes('bbcms')) ports.innerHTML +=
  ` <label>S20 <input type=checkbox ${portv['bbcms.s20'] ? 'checked' : ''}
    onchange="port('bbcms','s20',this.checked?1:0)"></label>`;
// generic widgets for the remaining runtime ports (needle ref-level,
// goniometer prefs, display floors): checkbox for toggles, number input
// otherwise — the LV2 host port-widget analog
const special = new Set(['spectrum.speed','r128.radar_seconds','bbcms.s20']);
for (const [k, v] of Object.entries(portv)) {
  if (special.has(k)) continue;
  const [m, p] = k.split('.');
  if (p === 'autogain' || p === 's20') ports.innerHTML +=
    ` <label>${k} <input type=checkbox ${v ? 'checked' : ''}
      onchange="port('${m}','${p}',this.checked?1:0)"></label>`;
  else ports.innerHTML +=
    ` ${k} <input type=number value=${v} step=0.1 style="width:4.5em"
      onchange="port('${m}','${p}',this.value)">`;
}
if (meters.some(m => m.startsWith('k1') || m === 'k20')) ports.innerHTML +=
  ` <button onclick="ctl('reset_peak')">peak reset</button>`;
setInterval(() => {
  const t = Date.now();
  for (const m of meters)
    document.getElementById('im_'+m).src = `/view/${m}.png?t=${t}`;
  fetch('/state.json').then(r=>r.json()).then(s=>{
    document.getElementById('stat').textContent =
      ` fed ${(s._fed_samples/s._fs).toFixed(1)} s`;});
}, 1000/fps);
</script>"""


def make_server(engine: LiveEngine, port: int = 0, fps: float = 10.0,
                state_file: str | None = None):
    """Embedded dashboard server.  Returns a ThreadingHTTPServer (call
    serve_forever() / shutdown()).  With `state_file`, /save and /load
    checkpoint/restore the whole session at that preconfigured path
    (never a client-supplied one).  An engine error, a kernel's included,
    answers 500 with the error's text."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            try:
                if u.path in ("/", "/index.html"):
                    page = (_PAGE
                            .replace("%METERS%", json.dumps(engine.names))
                            .replace("%FPS%", str(fps))
                            .replace("%PORTVALS%",
                                     json.dumps(engine.port_values())))
                    self._send(200, "text/html", page.encode())
                elif u.path.startswith("/view/") and u.path.endswith(".png"):
                    n = u.path[len("/view/"):-len(".png")]
                    if n not in engine.names:
                        self._send(404, "text/plain", b"unknown meter")
                        return
                    self._send(200, "image/png", engine.frame(n))
                elif u.path == "/ports":
                    # runtime control-port values (the --set / ctl?action=
                    # set names): the x42-meter '-P' list, live.  RFC-safe:
                    # non-finite -> null (same convention as the batch CLI)
                    ports = {
                        k: (v if math.isfinite(v) else None)
                        for k, v in engine.port_values().items()
                    }
                    self._send(200, "application/json", json.dumps(ports).encode())
                elif u.path == "/state.json":
                    outs = {n: _to_py(o) for n, o in engine.snapshot().items()}
                    outs["_fed_samples"] = engine.fed_samples
                    outs["_fs"] = engine.fs
                    self._send(200, "application/json", json.dumps(outs).encode())
                elif u.path == "/ctl":
                    q = parse_qs(u.query)
                    action = q.get("action", [""])[0]
                    meter = q.get("meter", [None])[0]
                    if action == "set":
                        engine.set_port(meter, q.get("param", [""])[0],
                                        float(q.get("value", ["0"])[0]))
                    else:
                        engine.control(action, meter)
                    self._send(200, "text/plain", b"ok")
                elif u.path in ("/save", "/load"):
                    if not state_file:
                        self._send(400, "text/plain", b"no --state-file configured")
                        return
                    if u.path == "/save":
                        engine.save(state_file)
                    else:
                        engine.load(state_file)
                    self._send(200, "text/plain", b"ok")
                else:
                    self._send(404, "text/plain", b"not found")
            except BrokenPipeError:
                pass
            except Exception as e:  # the engine's error, reported to the client
                self._send(500, "text/plain", repr(e).encode())

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def feed_file(engine: LiveEngine, data: np.ndarray, fs: float,
              chunk: int, speed: float, stop=None):
    """Pace [C, T] data through the engine at speed x realtime
    (0 = unpaced), like the JACK process() callback cadence.  Blocks are
    exact-length (pad=False): the engine measures each block's 4-aligned
    prefix, so zero-padding never enters the meters and fed_samples
    reports real audio only."""
    from .io.stream import chunk_array

    t0 = time.monotonic()
    fed = 0
    for blk in chunk_array(data, chunk, pad=False):
        if stop is not None and stop.is_set():
            break
        engine.feed(blk)
        fed += blk.shape[-1]
        if speed > 0:
            lag = fed / (fs * speed) - (time.monotonic() - t0)
            if lag > 0:
                time.sleep(lag)


def feed_stream(engine: LiveEngine, fh, nchan: int, fmt: str = "f32",
                chunk: int = 4096, stop=None) -> int:
    """Continuous raw-audio ingest from a binary stream (stdin, a pipe,
    a socket file): the live-capture analog of the reference's JACK
    process() callback feeding each plugin (src/goniometerlv2.c:106-174
    is built for continuous capture; here the OS pipe is the transport,
    the upstream producer sets the pace).

    `fmt`: 'f32' (little-endian float32) or 's16' (little-endian int16,
    scaled by 1/32768); frames are channel-interleaved.  Each read takes
    what the stream has, up to `chunk` frames (``read1`` where the stream
    has it).  The frames gather until `chunk` of them have arrived or the
    first of them has waited `chunk`'s duration at the engine's rate, and
    are then fed: a producer in real time is fed in blocks of about
    `chunk`, as feed_file feeds a file (a feed costs the host a roughly
    fixed time, so a feed a read would cost more a second of audio), and
    a slow producer's frames wait no longer than that duration, not until
    a whole chunk has filled.  A stream with a file descriptor is waited
    on with select; one without is checked when a read returns.  Bytes
    are cut at frame boundaries and feeds at the 4-sample measurement
    grain: the sub-grain remainder carries into the next block, so
    mid-stream no real sample is ever dropped from measurement and
    zero-padding is never fed (feed()'s padding-never-measured
    invariant).  At EOF, and when `stop` is set, the frames that wait are
    fed, the sub-grain ones reaching the display ring via feed()'s prefix
    rule.  Returns frames fed."""
    if fmt not in ("f32", "s16"):
        raise ValueError(f"unknown sample format {fmt!r}")
    dt = np.dtype("<f4" if fmt == "f32" else "<i2")
    frame_bytes = nchan * dt.itemsize
    read = fh.read1 if hasattr(fh, "read1") else fh.read
    try:
        fd = fh.fileno()
    except (AttributeError, OSError):  # io.UnsupportedOperation is an OSError
        fd = None
    wait = chunk / engine.fs
    buf = b""
    carry = np.zeros((nchan, 0), np.float32)
    fed = 0
    due = None  # when the first whole grain that waits has waited `wait`
    while True:
        if stop is not None and stop.is_set():
            data = b""
        elif due is not None and fd is not None and not select.select(
                [fd], [], [], max(0.0, due - time.monotonic()))[0]:
            data = None  # nothing more arrived in time: feed what waits
        else:
            data = read(max(chunk, 4) * frame_bytes)
        if data:
            buf += data
            nframes = len(buf) // frame_bytes
            if nframes:
                raw = np.frombuffer(buf[: nframes * frame_bytes], dt)
                buf = buf[nframes * frame_bytes:]
                blk = raw.astype(np.float32).reshape(nframes, nchan).T
                if fmt == "s16":
                    blk = blk * np.float32(1.0 / 32768.0)
                carry = np.concatenate([carry, blk], axis=-1)
        elif data is not None:  # EOF or stop
            if carry.shape[-1]:
                engine.feed(carry)
                fed += carry.shape[-1]
            break
        T4 = carry.shape[-1] // 4 * 4
        if T4 and due is None:
            due = time.monotonic() + wait
        if T4 and (carry.shape[-1] >= chunk or time.monotonic() >= due):
            engine.feed(carry[..., :T4])
            fed += T4
            carry = carry[..., T4:]
            due = None
    return fed


def apply_port_sets(engine, specs, error):
    """Apply '--set METER.PARAM=VALUE' initial control-port values: the
    x42-meter standalone's '-p <idx>:<val>' analog (doc/x42-meter.1).
    Unknown ports / malformed specs report through `error` (argparse
    .error or any raiser)."""
    for spec in specs:
        key, sep, val = spec.partition("=")
        meter, dot, param = key.partition(".")
        if not sep or not dot or not meter or not param:
            error(f"--set {spec!r}: expected METER.PARAM=VALUE")
            continue
        try:
            engine.set_port(meter.strip(), param.strip(), float(val))
        except ValueError as e:
            error(f"--set {spec!r}: {e}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="meters_lv2_torch.live", description=__doc__)
    ap.add_argument("file", nargs="?", default=None,
                    help="WAV file to stream (omit with --stdin)")
    ap.add_argument("--stdin", action="store_true",
                    help="meter a live raw-audio stream from stdin"
                         " (interleaved --format frames at --rate);"
                         " the producer sets the pace")
    ap.add_argument("--rate", type=float, default=48000.0,
                    help="sample rate of the --stdin stream")
    ap.add_argument("--channels", type=int, default=2,
                    help="channel count of the --stdin stream")
    ap.add_argument("--format", choices=("f32", "s16"), default="f32",
                    help="sample format of the --stdin stream")
    ap.add_argument("--meters", default="r128,truepeak")
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--fps", type=float, default=10.0)
    ap.add_argument(
        "--speed", type=float, default=1.0,
        help="pacing in x realtime; 0 = as fast as the device goes")
    ap.add_argument("--chunk-seconds", type=float, default=0.5)
    ap.add_argument("--loop", action="store_true",
                    help="restart the file when it ends")
    ap.add_argument("--surround-pairs", default=None,
                    help="surround correlator routing, e.g. 0:1,2:3,...")
    ap.add_argument("--cpu", action="store_true",
                    help="meter on CPU tensors (the kernels' plain versions);"
                         " without it a CUDA device is required")
    ap.add_argument("--state-file", default=None,
                    help="session checkpoint path: /save and /load use it;"
                         " with --resume, restored at startup if present")
    ap.add_argument("--resume", action="store_true",
                    help="restore --state-file at startup if it exists")
    ap.add_argument("--set", action="append", default=[],
                    metavar="METER.PARAM=VALUE", dest="port_sets",
                    help="initial runtime control-port value, repeatable"
                         " (the x42-meter '-p <idx>:<val>' analog,"
                         " doc/x42-meter.1); names as in /ports, e.g."
                         " --set spectrum.speed=2.0"
                         " --set vu.ref_level_db=-18")
    args = ap.parse_args(argv)

    import torch

    from .__main__ import parse_surround_pairs, validate_meters
    from .io.wav import read_wav

    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        ap.error("no CUDA device: the port meters on the card; pass --cpu to"
                 " meter on the CPU")
    if args.stdin == (args.file is not None):
        ap.error("give exactly one input: a WAV file or --stdin")
    if args.stdin:
        data, fs, nchan = None, float(args.rate), int(args.channels)
        if fs <= 0 or nchan <= 0:
            ap.error("--stdin needs positive --rate and --channels")
    else:
        data, fs = read_wav(args.file)
        if data.ndim == 1:
            data = data[None]
        nchan = data.shape[0]
    names = validate_meters(args.meters, nchan, ap.error)
    spairs = parse_surround_pairs(args.surround_pairs, nchan, ap.error)

    engine = LiveEngine(names, fs, nchan, surround_pairs=spairs, device=device)
    if args.resume and args.state_file and os.path.exists(args.state_file):
        engine.load(args.state_file)
        print(f"resumed session from {args.state_file} "
              f"({engine.fed_samples / fs:.1f} s already metered)",
              flush=True)
    # initial port values AFTER a resume, so the explicit CLI wins over
    # the session's saved ports (like an LV2 host re-applying -p values)
    apply_port_sets(engine, args.port_sets, ap.error)
    srv = make_server(engine, args.port, args.fps, state_file=args.state_file)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    print(f"live: http://127.0.0.1:{srv.server_address[1]}/ "
          f"({','.join(names)}) on {device}", flush=True)
    chunk = max(4, int(fs * args.chunk_seconds) // 4 * 4)
    try:
        if args.stdin:
            feed_stream(engine, sys.stdin.buffer, nchan, fmt=args.format, chunk=chunk)
        else:
            while True:
                feed_file(engine, data, fs, chunk, args.speed)
                if not args.loop:
                    break
        print("stream done; serving final state (ctrl-C to exit)", flush=True)
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
