"""The port's live shell (meters_lv2_torch.live) on CPU tensors: every case of
the JAX package's tests/test_live.py and the live case of
tests/test_cli_meta.py through the port, the port's LiveEngine against the
JAX one on the same signal and feeds, raw-audio capture over pipes in both
packages, session checkpoints exchanged between the packages, and the two
capture faults of the JAX feed_stream that the port does not copy.

Bars, port against JAX (the bars of the port's pipeline and CLI tests,
tests/test_torch_pipeline.py and tests/test_torch_cli.py):
- integer readouts (histograms, counters, radar position) and R128's
  hist_m / hist_s / n_lo state leaves exact;
- R128's loudness_M, loudness_S, max_M, integrated and dbtp within 1e-4;
- K20's rms within 1e-5 relative, the correlation within 1e-6;
- every other float readout within 1e-4 + 1e-4 |value|, with the same
  non-finite entries;
- the display meters at tests/test_torch_analyzers.py's bars: the phase
  wheel's masks, levels and phases as ``_phasewheel_outputs_close`` holds
  them against the float64 powers of the ring window's frames, the
  stereoscope as ``_stereoscope_outputs_close``, the goniometer's gain
  within 1e-4 relative, its trace energies within 1e-5 relative and its
  peak within 1e-4 relative.
A port engine against a port engine fed the same blocks is held exact.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from signals import make_signal
import meters_lv2_torch.live as tlive
from meters_lv2_torch.__main__ import applicable_meters
from meters_lv2_torch.live import (
    LiveEngine, apply_port_sets, feed_file, feed_stream, main, make_server)
from meters_lv2_tpu import live as jlive
from test_torch_analyzers import (
    _frame_powers, _phasewheel_outputs_close, _stereoscope_outputs_close)

torch.set_num_threads(1)

FS = 48000
PNG = b"\x89PNG\r\n\x1a\n"
R128_KEYS = ("loudness_M", "loudness_S", "max_M", "integrated", "dbtp")


def _stereo(seconds=1.0):
    return make_signal("sine997", seconds)  # [2, T], -18/-20 dBFS tones


def _eng(names, nchan=2, **kw):
    return LiveEngine(names, FS, nchan, device="cpu", **kw)


def _n_lo(eng):
    return int(eng._state["r128"].n_lo)


def _serve(eng, **kw):
    srv = make_server(eng, port=0, fps=5.0, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _get(url):
    return urllib.request.urlopen(url, timeout=60).read()


# -- every case of tests/test_live.py, through the port -----------------------


@pytest.fixture(scope="module")
def engine():
    eng = _eng(["r128", "truepeak", "vu", "goniometer"])
    feed_file(eng, _stereo(1.0), FS, chunk=FS // 2, speed=0.0)
    return eng


def test_engine_feed_and_snapshot(engine):
    assert engine.fed_samples == FS
    outs = engine.snapshot()
    assert set(outs) == {"r128", "truepeak", "vu", "goniometer"}
    m = float(outs["r128"]["loudness_M"])
    assert -20.0 < m < -12.0
    assert float(np.max(outs["truepeak"]["peak"])) > 0.05
    assert outs["goniometer"]["x"].shape[-1] > 0
    for o in outs.values():  # host readouts
        for v in (o.values() if isinstance(o, dict) else [o]):
            assert isinstance(v, np.ndarray)


def test_frame_png_and_cache(engine):
    png = engine.frame("r128")
    assert png[:8] == PNG
    assert engine.frame("r128") is png  # same generation -> cached bytes
    for n in ("truepeak", "vu", "goniometer"):
        assert engine.frame(n)[:8] == PNG
    engine.feed(np.zeros((2, 4), np.float32))
    assert engine.frame("r128") is not png  # new generation re-renders


def test_integration_pause_and_reset():
    eng = _eng(["r128"])
    blk = _stereo(0.5)
    eng.feed(blk)
    n1 = _n_lo(eng)
    eng.control("pause")
    eng.feed(blk)
    assert _n_lo(eng) == n1  # frozen
    eng.control("start")
    eng.feed(blk)
    assert _n_lo(eng) == 2 * n1
    eng.control("reset")
    assert _n_lo(eng) == 0


def test_reset_reinits_other_meters():
    eng = _eng(["vu"])
    eng.feed(_stereo(0.5))
    assert float(np.max(eng._read_one("vu"))) > 1e-4
    eng.control("reset")
    assert float(np.max(np.abs(eng._read_one("vu")))) < 1e-4


def test_reset_clears_radar_ring():
    """GUI RESET (ebu_reset, src/ebulv2.cc:45-60) clears the radar ring and
    position but carries the open interval's sample counter."""
    eng = _eng(["r128"])
    for _ in range(3):
        eng.feed(_stereo(1.0))
    st = eng._state["r128"]
    assert float(st.radar_m.max()) > -np.inf
    spd_cur = int(st.radar_spd_cur)
    eng.control("reset")
    st = eng._state["r128"]
    assert bool(torch.isneginf(st.radar_m).all()) and bool(torch.isneginf(st.radar_s).all())
    assert int(st.radar_pos) == 0
    assert int(st.radar_spd_cur) == spd_cur


def test_radar_reset_control_clears_ring_only():
    eng = _eng(["r128"])
    for _ in range(3):
        eng.feed(_stereo(1.0))
    n1 = _n_lo(eng)
    assert n1 > 0
    eng.control("reset_radar")
    assert bool(torch.isneginf(eng._state["r128"].radar_m).all())
    assert _n_lo(eng) == n1


def test_reset_reapplies_runtime_ports():
    eng = _eng(["spectrum"])
    om0 = float(eng._state["spectrum"].omega)
    eng.set_port("spectrum", "speed", 8.0)
    om8 = float(eng._state["spectrum"].omega)
    assert om8 != om0
    eng.control("reset")
    assert float(eng._state["spectrum"].omega) == om8


def test_feed_never_measures_padding():
    eng = _eng(["r128"])
    sig = _stereo(0.5)[:, : FS // 2 - 3]  # T % 4 == 1
    eng.feed(sig)
    assert eng.fed_samples == sig.shape[-1]
    assert _n_lo(eng) == sig.shape[-1] // 4 * 4


def test_feed_file_exact_length():
    eng = _eng(["r128"])
    feed_file(eng, _stereo(1.0)[:, : FS - 2], FS, chunk=FS // 4, speed=0.0)
    assert eng.fed_samples == FS - 2


def test_s20_port_toggles_side_gain():
    """BBC M-6 s20 port (src/meters.cc:562-563): side gain -6 -> +14 dB
    mid-stream; the port is a host value that update() reads each call."""
    eng = _eng(["bbcms"])
    sig = _stereo(0.5)
    side_sig = np.stack([sig[0], -sig[0]])
    eng.feed(side_sig)
    lo = float(eng._read_one("bbcms")["side"])
    eng.set_port("bbcms", "s20", 1)
    assert eng._controls["bbcms"]["s20"].dtype == np.bool_ and bool(eng._controls["bbcms"]["s20"])
    for _ in range(4):
        eng.feed(side_sig)
    hi = float(eng._read_one("bbcms")["side"])
    np.testing.assert_allclose(hi / lo, 10.0, rtol=0.05)  # +20 dB


def test_spectrum_and_radar_ports():
    eng = _eng(["spectrum", "r128"])
    om0 = float(eng._state["spectrum"].omega)
    eng.set_port("spectrum", "speed", 8.0)
    assert float(eng._state["spectrum"].omega) > om0
    spd0 = int(eng._state["r128"].radar_spd)
    eng.set_port("r128", "radar_seconds", 240.0)
    assert int(eng._state["r128"].radar_spd) == 2 * spd0
    with pytest.raises(ValueError):
        eng.set_port("spectrum", "nope", 1.0)
    with pytest.raises(ValueError):
        eng.set_port("vu", "speed", 1.0)  # meter not in this engine


def test_http_set_port_endpoint():
    eng = _eng(["spectrum"])
    srv, base = _serve(eng)
    try:
        om0 = float(eng._state["spectrum"].omega)
        assert _get(f"{base}/ctl?action=set&meter=spectrum&param=speed&value=9.0") == b"ok"
        assert float(eng._state["spectrum"].omega) > om0
        assert json.loads(_get(f"{base}/ports"))["spectrum.speed"] == 9.0
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"{base}/ctl?action=set&meter=spectrum&param=zz&value=1")
        assert ei.value.code == 500
        with pytest.raises(urllib.error.HTTPError) as ei:  # non-finite: rejected
            _get(f"{base}/ctl?action=set&meter=spectrum&param=speed&value=nan")
        assert ei.value.code == 500 and b"non-finite" in ei.value.read()
        assert json.loads(_get(f"{base}/ports"))["spectrum.speed"] == 9.0
    finally:
        srv.shutdown()


def test_session_save_resume(tmp_path):
    """A resumed engine carries the full measurement state and integration
    continues exactly as in an engine that never saved."""
    path = str(tmp_path / "session.npz")
    blk = _stereo(1.0)
    names = ["r128", "bbcms", "goniometer"]
    a = _eng(names)
    a.set_port("bbcms", "s20", 1)
    for _ in range(3):
        a.feed(blk)
    a.save(path)
    for _ in range(2):
        a.feed(blk)
    ref = a.snapshot()

    b = _eng(names)
    b.load(path)
    assert b.fed_samples == 3 * FS
    assert bool(b._controls["bbcms"]["s20"])
    assert b._port_values[("bbcms", "s20")] == 1.0
    for _ in range(2):
        b.feed(blk)
    got = b.snapshot()
    for n in ref:
        for k in ref[n]:
            np.testing.assert_array_equal(got[n][k], ref[n][k], err_msg=f"{n}.{k}")


def test_http_save_load_endpoints(tmp_path):
    path = str(tmp_path / "s.npz")
    eng = _eng(["vu"])
    eng.feed(_stereo(0.5))
    srv, base = _serve(eng, state_file=path)
    try:
        assert _get(f"{base}/save") == b"ok"
        v1 = float(np.max(eng._read_one("vu")))
        eng.control("reset")
        assert _get(f"{base}/load") == b"ok"
        v2 = float(np.max(eng._read_one("vu")))
        assert v1 == v2 and v1 > 1e-4
    finally:
        srv.shutdown()
    srv2, base2 = _serve(eng)  # no state file -> 400
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"{base2}/save")
        assert ei.value.code == 400
    finally:
        srv2.shutdown()


def test_save_extensionless_path_roundtrip(tmp_path):
    path = str(tmp_path / "session")
    eng = _eng(["vu"])
    eng.feed(_stereo(0.5))
    eng.save(path)
    assert os.path.exists(path) and not os.path.exists(path + ".npz")
    eng2 = _eng(["vu"])
    eng2.load(path)
    assert eng2.fed_samples == eng.fed_samples


def test_load_rejects_mismatched_config(tmp_path):
    path = str(tmp_path / "s.npz")
    a = _eng(["r128", "vu"])
    a.feed(_stereo(0.5))
    a.save(path)
    with pytest.raises(ValueError):
        _eng(["vu"]).load(path)
    # the same leaves, another configuration: the digest rejects it
    b = _eng(["vu"])
    b.save(path)
    with pytest.raises(ValueError, match="different meters/fs/nchan"):
        LiveEngine(["vu"], 44100, 2, device="cpu").load(path)


def test_ref_level_port_scales_needles():
    """The needle meters' reference-level port (src/meters.cc:303-306) is a
    host port read at every readout; only the written meter's dial moves."""
    eng = _eng(["vu", "din"])
    eng.feed(_stereo(0.5))
    v22 = eng._read_one("vu")
    d22 = eng._read_one("din")
    eng.set_port("vu", "ref_level_db", -18.0)
    v18 = eng._read_one("vu")
    np.testing.assert_allclose(v18 / v22, 10.0 ** 0.2, rtol=1e-5)
    np.testing.assert_array_equal(eng._read_one("din"), d22)


def test_reset_peak_control_clears_hold_only():
    eng = _eng(["k20"])
    eng.feed(_stereo(1.0))
    out = eng._read_one("k20")
    assert float(np.max(out["peak"])) > 0.05 and float(np.max(out["rms"])) > 0.01
    eng.control("reset_peak")
    assert float(np.max(eng._read_one("k20")["peak"])) == 0.0
    assert float(eng._state["k20"].z.max()) > 1e-6  # smoother state untouched


def test_goniometer_prefs_change_the_frame():
    eng = _eng(["goniometer"])
    eng.feed(_stereo(1.0))
    a = eng.frame("goniometer")
    assert a[:8] == PNG
    eng.set_port("goniometer", "autogain", 0.0)
    eng.set_port("goniometer", "gain", 0.05)
    b = eng.frame("goniometer")
    assert b != a
    eng.set_port("goniometer", "persistence", 0.05)
    assert eng.frame("goniometer") != b


def test_display_floor_port():
    sig = _stereo(1.0)
    t = np.arange(sig.shape[-1]) / FS
    common = (0.0224 * np.sin(2 * np.pi * 5000.0 * t)).astype(np.float32)
    eng = _eng(["phasewheel"])
    eng.feed(sig + common[None])
    a = eng.frame("phasewheel")
    eng.set_port("phasewheel", "floor_db", -20.0)
    assert eng.frame("phasewheel") != a


def test_host_ports_survive_save_load(tmp_path):
    path = str(tmp_path / "s.npz")
    a = _eng(["vu", "goniometer"])
    a.feed(_stereo(0.5))
    a.set_port("vu", "ref_level_db", -20.0)
    a.set_port("goniometer", "persistence", 0.5)
    a.save(path)
    b = _eng(["vu", "goniometer"])
    b.load(path)
    assert b._port_values[("vu", "ref_level_db")] == -20.0
    assert b._port_values[("goniometer", "persistence")] == 0.5


def test_http_generic_port_widgets_and_reset_peak():
    eng = _eng(["vu", "k20"])
    eng.feed(_stereo(0.5))
    srv, base = _serve(eng)
    try:
        page = _get(f"{base}/").decode()
        assert "vu.ref_level_db" in page and "reset_peak" in page
        assert _get(f"{base}/ctl?action=set&meter=vu&param=ref_level_db&value=-18") == b"ok"
        assert eng._port_values[("vu", "ref_level_db")] == -18.0
        assert float(np.max(eng._read_one("k20")["peak"])) > 0
        _get(f"{base}/ctl?action=reset_peak&meter=k20")
        assert float(np.max(eng._read_one("k20")["peak"])) == 0
    finally:
        srv.shutdown()


def _pipe_writer(wfd, payload: bytes, sizes, pause=None):
    """Write payload down the pipe in ragged pieces, then close; with
    ``pause`` (bytes, event), wait for the event once that many bytes are
    written."""
    off = i = 0
    try:
        while off < len(payload):
            n = sizes[i % len(sizes)]
            if pause is not None and off < pause[0] <= off + n:
                n = pause[0] - off
            os.write(wfd, payload[off: off + n])
            off += n
            i += 1
            if pause is not None and off == pause[0]:
                pause[1].wait(120)
    finally:
        os.close(wfd)


def _recording(eng):
    """Wrap eng.feed to record each fed block's length."""
    sizes = []
    feed = eng.feed

    def rec(block):
        sizes.append(block.shape[-1])
        feed(block)

    eng.feed = rec
    return sizes


def _through_pipe(mod, eng, payload, sizes, fmt="f32", chunk=2048, nchan=2):
    rfd, wfd = os.pipe()
    t = threading.Thread(target=_pipe_writer, args=(wfd, payload, sizes))
    t.start()
    with os.fdopen(rfd, "rb") as fh:
        fed = mod.feed_stream(eng, fh, nchan, fmt=fmt, chunk=chunk)
    t.join()
    return fed


def test_feed_stream_pipe_f32_matches_file_path():
    """Raw f32 ingest from a pipe with ragged writes: the dashboard answers
    mid-stream, every frame is fed, and the result matches the same audio
    fed as one block (R128's momentary loudness within 1e-3 LU, its
    sample count exact, as the JAX package's test holds it)."""
    sig = _stereo(1.0)
    payload = np.ascontiguousarray(sig.T, "<f4").tobytes()
    eng = _eng(["r128"])
    srv, base = _serve(eng)
    try:
        fed = _through_pipe(tlive, eng, payload,
                            (997 * 8, 1531 * 8, 61))
        assert json.loads(_get(f"{base}/state.json"))["_fed_samples"] == sig.shape[-1]
    finally:
        srv.shutdown()
    assert fed == sig.shape[-1] == eng.fed_samples
    ref = _eng(["r128"])
    ref.feed(sig)
    np.testing.assert_allclose(float(eng._read_one("r128")["loudness_M"]),
                               float(ref._read_one("r128")["loudness_M"]), atol=1e-3)
    assert _n_lo(eng) == _n_lo(ref)


def test_feed_stream_s16_and_eof_remainder():
    T = FS // 4 + 3  # % 4 == 3
    sig = (np.clip(_stereo(1.0)[:, :T], -1, 1) * 32767).astype("<i2")
    eng = _eng(["r128"])
    sizes = _recording(eng)
    fed = _through_pipe(tlive, eng,
                        np.ascontiguousarray(sig.T).tobytes(), (4001,), fmt="s16", chunk=1000)
    assert fed == T == eng.fed_samples == sum(sizes)
    assert _n_lo(eng) == T // 4 * 4
    assert all(s % 4 == 0 for s in sizes[:-1]) and sizes[-1] % 4 == 3  # the EOF remainder


def test_http_server_endpoints(engine):
    srv, base = _serve(engine)
    try:
        page = _get(f"{base}/").decode()
        assert "r128" in page and "meters_lv2_torch live" in page
        assert "%PORTVALS%" not in page and "r128.radar_seconds" in page
        assert _get(f"{base}/view/r128.png?t=1")[:8] == PNG
        st = json.loads(_get(f"{base}/state.json"))
        assert st["_fed_samples"] == engine.fed_samples
        assert "integrated" in st["r128"]
        assert _get(f"{base}/ctl?action=pause&meter=r128") == b"ok"
        for bad in ("/view/nope.png", "/nope"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(base + bad)
            assert ei.value.code == 404
    finally:
        srv.shutdown()
    engine.control("start", "r128")


# -- the live case of tests/test_cli_meta.py ----------------------------------


def test_live_apply_port_sets():
    eng = _eng(["spectrum", "vu"])
    errs = []
    apply_port_sets(eng, ["spectrum.speed=2.0", "vu.ref_level_db=-18"], errs.append)
    assert errs == []
    ports = eng.port_values()
    assert ports["spectrum.speed"] == 2.0 and ports["vu.ref_level_db"] == -18.0
    apply_port_sets(eng, ["nosuch.port=1"], errs.append)
    apply_port_sets(eng, ["malformed"], errs.append)
    apply_port_sets(eng, ["vu.ref_level_db=abc"], errs.append)
    apply_port_sets(eng, ["spectrum.speed=nan"], errs.append)
    assert len(errs) == 4
    assert "unknown port" in errs[0]
    assert "METER.PARAM=VALUE" in errs[1]
    assert "non-finite" in errs[3]
    assert eng.port_values()["spectrum.speed"] == 2.0


# -- no fallback ----------------------------------------------------------------


def test_engine_and_main_need_the_card_without_cpu(monkeypatch, capsys, tmp_path):
    """The engine's default device is the card: where CUDA is absent it
    raises torch's own error; main without --cpu exits with an argparse
    error and does not meter on the CPU."""
    if torch.cuda.is_available():
        eng = LiveEngine(["vu"], FS, 2)
        assert eng._state["vu"].z.is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            LiveEngine(["vu"], FS, 2)
    from meters_lv2_torch.io import write_wav

    p = str(tmp_path / "a.wav")
    write_wav(p, _stereo(0.1), FS)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        main([p, "--port", "0"])
    assert e.value.code == 2 and "no CUDA device" in capsys.readouterr().err


def test_engine_error_is_a_500(monkeypatch):
    """An error raised inside the engine (a kernel's, say) reaches the
    client as a 500 with its text: nothing falls back."""
    eng = _eng(["vu"])
    eng.feed(_stereo(0.1))
    srv, base = _serve(eng)

    def broken(*a, **k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(eng._pipe, "read", broken)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"{base}/state.json")
        assert ei.value.code == 500 and b"kernel launch failed" in ei.value.read()
    finally:
        srv.shutdown()
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        eng.snapshot()


def test_main_serves_a_file_on_cpu(tmp_path):
    """python -m meters_lv2_torch.live FILE --cpu: the shell starts, meters
    the file and serves it (run in a subprocess, stopped once /state.json
    reports the whole file)."""
    import subprocess
    import sys

    from meters_lv2_torch.io import write_wav

    p = str(tmp_path / "a.wav")
    write_wav(p, _stereo(0.5), FS)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pr = subprocess.Popen([sys.executable, "-m", "meters_lv2_torch.live", p, "--cpu", "--port", "0",
                           "--speed", "0", "--meters", "k20,r128", "--set", "vu.ref_level_db=-18"],
                          cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        _, err = pr.communicate(timeout=120)
        assert pr.returncode == 2 and "unknown port vu.ref_level_db" in err
        pr = subprocess.Popen([sys.executable, "-m", "meters_lv2_torch.live", p, "--cpu",
                               "--port", "0", "--speed", "0", "--meters", "k20,r128"],
                              cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        line = pr.stdout.readline()
        assert line.startswith("live: http://127.0.0.1:") and "on cpu" in line
        base = line.split()[1].rstrip("/")
        deadline = time.monotonic() + 120
        while True:
            st = json.loads(_get(f"{base}/state.json"))
            if st["_fed_samples"] == FS // 2 or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        assert st["_fed_samples"] == FS // 2 and st["k20"]["rms"][0] > 0.01
    finally:
        pr.kill()
        pr.wait()


# -- the two capture faults of the JAX feed_stream (ROADMAP C7, C8) -------------


def test_slow_producer_is_fed_before_the_chunk_fills():
    """A producer writes 1000 frames and waits: the port's feed_stream
    (read1, then a select that ends once the first frames have waited a
    chunk's duration, 4096 / 48000 s) meters them while it waits; the JAX
    one (read(N)) blocks until a whole chunk of 4096 frames or EOF has
    arrived."""
    sig = _stereo(0.25)
    payload = np.ascontiguousarray(sig.T, "<f4").tobytes()
    for mod, eng in ((tlive, _eng(["k20"])),
                     (jlive, jlive.LiveEngine(["k20"], FS, 2))):
        go = threading.Event()
        rfd, wfd = os.pipe()
        t = threading.Thread(target=_pipe_writer, args=(wfd, payload, (8 * 8192,), (8000, go)))
        t.start()
        res = {}
        with os.fdopen(rfd, "rb") as fh:
            r = threading.Thread(target=lambda: res.setdefault(
                "fed", mod.feed_stream(eng, fh, 2, chunk=4096)))
            r.start()
            deadline = time.monotonic() + (30 if mod is not jlive else 1.0)
            while eng.fed_samples < 1000 and time.monotonic() < deadline:
                time.sleep(0.01)
            seen = eng.fed_samples
            go.set()
            r.join()
            t.join()
        if mod is jlive:
            assert seen == 0  # the JAX fault: nothing metered while the producer waits
        else:
            assert seen == 1000
        assert res["fed"] == eng.fed_samples == sig.shape[-1]


class _Scripted:
    """A stream whose read1 returns the given pieces in turn; after the
    last, it sets ``stop`` (a stop requested while the reader waited) or
    reports EOF."""

    def __init__(self, pieces, stop=None):
        self.pieces, self.stop = list(pieces), stop

    def read1(self, n):
        if self.pieces:
            p = self.pieces.pop(0)
            assert len(p) <= n
            if not self.pieces and self.stop is not None:
                self.stop.set()
            return p
        assert self.stop is None, "read after stop"
        return b""


def test_stopped_stream_feeds_the_same_samples_as_eof():
    """The frames that wait, the carried sub-grain ones among them, are
    flushed on stop as at EOF: the same blocks reach the engine, so both
    engines end identical.  A chunk of 4,099 feeds 4,096 of the first
    piece and carries 3; the 3 and the next piece's 8 wait (11 < chunk)
    until the stop or the EOF."""
    sig = _stereo(0.2)[:, : 4099 + 8]
    raw = np.ascontiguousarray(sig.T, "<f4").tobytes()
    pieces = [raw[: 4099 * 8], raw[4099 * 8:]]
    runs = []
    for stop in (threading.Event(), None):
        eng = _eng(["r128", "k20"])
        sizes = _recording(eng)
        fed = feed_stream(eng, _Scripted(pieces, stop), 2, chunk=4099, stop=stop)
        runs.append((eng, sizes, fed))
    (a, sa, fa), (b, sb, fb) = runs
    assert sa == sb == [4096, 11] and fa == fb == a.fed_samples == b.fed_samples == 4107
    np.testing.assert_array_equal(a._ring, b._ring)
    np.testing.assert_array_equal(a._ring[:, -3:], sig[:, -3:])
    for n in ("r128", "k20"):
        for k, v in a.snapshot()[n].items():
            np.testing.assert_array_equal(v, b.snapshot()[n][k], err_msg=f"{n}.{k}")


def test_fast_producer_is_fed_in_whole_chunks():
    """Reads of 1,000 frames that come at once gather into feeds of at
    least a chunk (4,096): two feeds of 5,000, not ten of 1,000, so the
    host's fixed cost a feed is paid about once a chunk, as feed_file pays
    it.  A stream without a file descriptor is checked for the wait when a
    read returns; these reads return at once."""
    sig = _stereo(0.25)[:, :10000]
    raw = np.ascontiguousarray(sig.T, "<f4").tobytes()
    eng = _eng(["k20"])
    sizes = _recording(eng)
    fed = feed_stream(eng, _Scripted([raw[i: i + 8000] for i in range(0, len(raw), 8000)]),
                      2, chunk=4096)
    assert sizes == [5000, 5000] and fed == eng.fed_samples == 10000
    w = min(eng._ring.shape[-1], 10000)
    np.testing.assert_array_equal(eng._ring[:, -w:], sig[:, -w:])


# -- the port's engine against the JAX engine -----------------------------------


def _close_readout(name, got, want, what):
    """One measuring meter's host readout against the JAX engine's at the
    bars in the module docstring."""
    def leaves(o, path=""):
        if isinstance(o, dict):
            for k, v in sorted(o.items()):
                yield from leaves(v, f"{path}.{k}")
        else:
            yield path, np.asarray(o)

    lg, lw = list(leaves(got)), list(leaves(want))
    assert [k for k, _ in lg] == [k for k, _ in lw], (what, name)
    for (k, a), (_, b) in zip(lg, lw):
        tag = f"{what} {name}{k}"
        assert a.shape == b.shape, tag
        if b.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b, err_msg=tag)
            continue
        a, b = a.astype(np.float64), b.astype(np.float64)
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b), err_msg=tag)
        np.testing.assert_array_equal(a[~np.isfinite(b)], b[~np.isfinite(b)], err_msg=tag)
        f = np.isfinite(b)
        d = np.abs(a[f] - b[f])
        if name == "r128" and k.lstrip(".") in R128_KEYS:
            bar = 1e-4
        elif name == "k20" and k == ".rms":
            bar = 1e-5 * np.abs(b[f])
        elif name == "cor":
            bar = 1e-6
        else:
            bar = 1e-4 + 1e-4 * np.abs(b[f])
        assert np.all(d <= bar), (tag, float(d.max()))


def _close_display(name, got, want, window, hop, what):
    """A display meter's readout on the ring window against JAX's, at
    tests/test_torch_analyzers.py's bars."""
    t = {k: torch.from_numpy(np.asarray(v)[None]) for k, v in got.items()}
    j = {k: np.asarray(v)[None] for k, v in want.items()}
    if name == "phasewheel":
        W = 8192
        ext = np.concatenate([np.zeros((2, W), np.float32), window], -1)[None]
        _phasewheel_outputs_close(t, j, _frame_powers(ext, W, hop), what)
    elif name == "stereoscope":
        _stereoscope_outputs_close(t, j, what)
    else:
        np.testing.assert_allclose(got["gain"], want["gain"], rtol=1e-4, err_msg=what)
        for k in ("x", "y"):
            a, b = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
            np.testing.assert_allclose((a ** 2).sum(), (b ** 2).sum(), rtol=1e-5, err_msg=what)
            np.testing.assert_allclose(np.abs(a).max(), np.abs(b).max(), rtol=1e-4, err_msg=what)


R128_EXACT = ("hist_m", "hist_s", "n_lo", "n_hi", "count_m", "count_s")


def _view(eng):
    """What the comparisons read of an engine (either package), as host
    values taken now."""
    snap = {n: jax.tree_util.tree_map(np.asarray, o) for n, o in eng.snapshot().items()}
    r128 = ({f: np.asarray(getattr(eng._state["r128"], f)) for f in R128_EXACT}
            if "r128" in eng.names else {})
    return {"names": list(eng.names), "snap": snap, "ring": eng._ring.copy(),
            "fed": eng.fed_samples, "r128": r128, "fs": eng.fs}


def _close_views(port, jaxv, what, hops):
    """A port engine's view against a JAX engine's at the module's bars;
    ``hops`` maps each display meter to its hop and window."""
    got, want = port["snap"], jaxv["snap"]
    assert list(got) == list(want) == port["names"] == jaxv["names"]
    assert port["fed"] == jaxv["fed"]
    np.testing.assert_array_equal(port["ring"], jaxv["ring"])
    for n in port["names"]:
        if n in hops:
            hop, w = hops[n]
            _close_display(n, got[n], want[n], port["ring"][:, -w:], hop, f"{what} {n}")
        else:
            _close_readout(n, got[n], want[n], what)
    for f, v in port["r128"].items():
        np.testing.assert_array_equal(v, jaxv["r128"][f], err_msg=f"{what} r128.{f}")


def _hops(eng):
    return {n: (m.stft.hop if hasattr(m, "stft") else 4, w)
            for n, (m, w, _) in eng._display.items()}


def _close_engines(port, jaxe, what):
    _close_views(_view(port), _view(jaxe), what, _hops(port))


CHUNK = FS // 2  # the shell's default 0.5 s: 187 x 128 + 64 samples


@pytest.fixture(scope="module")
def stereo_all(tmp_path_factory):
    """Stereo --meters all (20 meters) with ports set: a port and a JAX
    engine over the same 1 s of signal in 0.5 s feeds, each saved; a port
    engine loaded from the JAX session and a JAX engine loaded from the
    port's; then all four fed 1 s more.  Returns the engines' views."""
    names = applicable_meters(2)
    assert len(names) == 20
    sig = make_signal("mix", 2.0)
    d = tmp_path_factory.mktemp("sessions")
    p = LiveEngine(names, FS, 2, device="cpu")
    j = jlive.LiveEngine(names, FS, 2)
    for e in (p, j):
        e.set_port("spectrum", "speed", 4.0)
        e.set_port("bbcms", "s20", 1)
        e.set_port("vu", "ref_level_db", -18.0)
    feed_file(p, sig[:, :FS], FS, CHUNK, 0.0)
    jlive.feed_file(j, sig[:, :FS], FS, CHUNK, 0.0)
    out = {"names": names, "hops": _hops(p), "dir": d, "p1": _view(p), "j1": _view(j)}
    p.save(str(d / "port.npz"))
    j.save(str(d / "jax.npz"))
    p2 = LiveEngine(names, FS, 2, device="cpu")
    p2.load(str(d / "jax.npz"))
    j2 = jlive.LiveEngine(names, FS, 2)
    j2.load(str(d / "port.npz"))
    out["p2_ports"], out["p2_s20"] = dict(p2._port_values), p2._controls["bbcms"]["s20"]
    for e in (p, p2):
        feed_file(e, sig[:, FS:], FS, CHUNK, 0.0)
    for e in (j, j2):
        jlive.feed_file(e, sig[:, FS:], FS, CHUNK, 0.0)
    out.update({k: _view(e) for k, e in (("p", p), ("j", j), ("p2", p2), ("j2", j2))})
    out["j_ports"] = dict(j._port_values)
    out["engines"] = {"p": p, "j": j}
    return out


def test_stereo_all_matches_jax_after_1s(stereo_all):
    s = stereo_all
    _close_views(s["p1"], s["j1"], "after 1 s", s["hops"])


def test_stereo_all_matches_jax_after_2s(stereo_all):
    s = stereo_all
    _close_views(s["p"], s["j"], "after 2 s", s["hops"])


def test_session_from_jax_continues_in_the_port(stereo_all):
    """Saved by the JAX engine, loaded by the port, fed 1 s more: equal to
    the JAX engine that fed throughout.  The port values come back (the
    JAX engine reads its own back through float32)."""
    s = stereo_all
    assert s["p2_ports"] == {k: pytest.approx(v, rel=1e-7) for k, v in s["j_ports"].items()}
    assert s["p2_s20"].dtype == np.bool_ and bool(s["p2_s20"])
    _close_views(s["p2"], s["j"], "port from the JAX session", s["hops"])


def test_session_from_port_continues_in_jax(stereo_all):
    """Saved by the port engine, loaded by the JAX engine, fed 1 s more:
    equal to the port engine that fed throughout."""
    s = stereo_all
    _close_views(s["p"], s["j2"], "JAX from the port session", s["hops"])


def test_session_file_layout_is_the_jax_one(stereo_all):
    """The two packages' session files hold the same leaves: count, shapes
    and dtypes, and equal values for the host leaves (config digest, ports,
    ring, fed)."""
    d = stereo_all["dir"]
    with np.load(d / "port.npz") as a, np.load(d / "jax.npz") as b:
        ka = sorted(k for k in a.files if k.startswith("leaf_"))
        assert ka == sorted(k for k in b.files if k.startswith("leaf_"))
        assert len(ka) == 156
        for k in ka:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        n = len(ka)
        # the tree's sorted top level: config, controls, fed, ports, ring, state
        np.testing.assert_array_equal(a["leaf_0"], b["leaf_0"])  # config digest
        np.testing.assert_array_equal(a["leaf_1"], b["leaf_1"])  # bbcms.s20
        assert a["leaf_2"] == b["leaf_2"] == FS and a["leaf_2"].dtype == np.int64  # fed
        for i in range(3, 17):  # the 14 ports
            assert a[f"leaf_{i}"] == b[f"leaf_{i}"] and a[f"leaf_{i}"].dtype == np.float64
        np.testing.assert_array_equal(a["leaf_17"], b["leaf_17"])  # ring
        assert n - 18 == 138  # the pipeline state's leaves


def test_server_json_keys_match_jax(stereo_all):
    """/state.json and /ports answer with the JAX server's keys."""
    s = stereo_all["engines"]
    got, want = {}, {}
    for eng, mod, out in ((s["p"], None, got), (s["j"], jlive, want)):
        srv = (mod.make_server if mod else make_server)(eng, port=0, fps=5.0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            out["state"] = json.loads(_get(f"{base}/state.json"))
            out["ports"] = json.loads(_get(f"{base}/ports"))
        finally:
            srv.shutdown()

    def keys(o, path=""):
        if isinstance(o, dict):
            return {path + "." + k for k in o} | set().union(
                *(keys(v, f"{path}.{k}") for k, v in o.items()))
        return set()

    assert keys(got["state"]) == keys(want["state"])
    assert got["state"]["_fed_samples"] == want["state"]["_fed_samples"] == 2 * FS
    assert list(got["ports"]) == list(want["ports"])
    for k, v in want["ports"].items():
        assert got["ports"][k] == pytest.approx(v, rel=1e-7), k


def test_five_channel_engine_matches_jax():
    """r128 at C=5 and surround5: 1.5 s of five tones over noise in 0.5 s
    feeds and a ragged last one."""
    rng = np.random.default_rng(18)
    T = 3 * CHUNK + 1234
    t = np.arange(T) / FS
    x = np.stack([(0.1 + 0.08 * c) * np.sin(2 * np.pi * (200 + 350 * c) * t)
                  + 0.02 * rng.standard_normal(T) for c in range(5)]).astype(np.float32)
    p = LiveEngine(["r128", "surround"], FS, 5, device="cpu")
    j = jlive.LiveEngine(["r128", "surround"], FS, 5)
    feed_file(p, x, FS, CHUNK, 0.0)
    jlive.feed_file(j, x, FS, CHUNK, 0.0)
    assert p.fed_samples == T
    _close_engines(p, j, "5 channels")
    assert p.snapshot()["surround"]["level"].shape == (5,)


def test_feed_stream_pipes_in_both_packages():
    """The same ragged writes down a pipe into each package's feed_stream
    (the port reads what is there, the JAX package whole chunks), to EOF:
    every frame fed in both.  The two feed the meters in different blocks,
    so the bars are those of a block split: R128's momentary loudness
    within 1e-3 LU and its sample count exact (the JAX package's own pipe
    test), the sigdist histogram exact, K20's rms and the true peak within
    1e-5 relative."""
    names = ["r128", "k20", "truepeak", "sigdist"]
    sig = make_signal("noise", 0.5)[:, : FS // 2 - 1]
    payload = np.ascontiguousarray(sig.T, "<f4").tobytes()
    writes = (997 * 8, 1531 * 8 + 4, 61)
    p = _eng(names)
    fed = _through_pipe(tlive, p, payload, writes, chunk=4096)
    j = jlive.LiveEngine(names, FS, 2)
    jfed = _through_pipe(jlive, j, payload, writes, chunk=4096)
    assert fed == jfed == p.fed_samples == j.fed_samples == sig.shape[-1]
    a, b = p.snapshot(), _view(j)["snap"]
    np.testing.assert_allclose(a["r128"]["loudness_M"], b["r128"]["loudness_M"], atol=1e-3)
    assert _n_lo(p) == int(j._state["r128"].n_lo) == sig.shape[-1] // 4 * 4
    np.testing.assert_array_equal(a["sigdist"]["hist"], b["sigdist"]["hist"])
    np.testing.assert_allclose(a["k20"]["rms"], b["k20"]["rms"], rtol=1e-5)
    np.testing.assert_allclose(a["truepeak"]["peak"], b["truepeak"]["peak"], rtol=1e-5)
