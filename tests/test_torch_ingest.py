"""The port's ingest: WAV decode (Python and native), batch assembly,
mixed-rate resampling, and the native loader's build.

Bars: decodes are exact (the same file gives the same float32 samples by
either reader); the resampler meets the JAX tests' bars against the zita
fixtures (atol 1e-6; streamed against whole 2e-6,
tests/test_fft_golden_parity.py) and is within 1e-6 absolute of the JAX
resampler (two float32 products in another summation order).
"""

import glob
import json
import os
import shutil
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from signals import make_signal
from meters_lv2_torch.io import batch as tbatch
from meters_lv2_torch.io import wav as twav
from meters_lv2_torch.ops.resample import RationalResampler, resample_signal
from meters_lv2_torch.runtime import native
from meters_lv2_torch.runtime.build import digest
from meters_lv2_tpu.io import batch as jbatch
from meters_lv2_tpu.ops import resample as jresample

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(ROOT, "tests", "fixtures")
BITS = ("16", "24", "32f", "64f")


def write_pcm(path, data, rate, bits):
    """A RIFF/WAVE file of planar [C, T] float data as PCM16, PCM24,
    float32 or float64 (the codecs write only 16 and 32f)."""
    inter = np.ascontiguousarray(np.asarray(data, np.float64).T)
    if bits == "16":
        payload = np.round(np.clip(inter, -1, 1) * 32767).astype("<i2").tobytes()
        fmt, nb = 1, 16
    elif bits == "24":
        v = np.round(np.clip(inter, -1, 1) * 8388607).astype("<i4").reshape(-1)
        payload = np.stack([v & 255, (v >> 8) & 255, (v >> 16) & 255], -1).astype(np.uint8).tobytes()
        fmt, nb = 1, 24
    elif bits == "32f":
        payload = inter.astype("<f4").tobytes()
        fmt, nb = 3, 32
    else:
        payload = inter.astype("<f8").tobytes()
        fmt, nb = 3, 64
    c = inter.shape[1]
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, fmt, c, rate, rate * c * nb // 8, c * nb // 8, nb))
        f.write(b"data" + struct.pack("<I", len(payload)) + payload)


def expected(data, bits):
    """What a decode of write_pcm(data, bits) gives."""
    d = np.asarray(data, np.float64)
    if bits == "16":
        return (np.round(np.clip(d, -1, 1) * 32767) / 32768.0).astype(np.float32)
    if bits == "24":
        return (np.round(np.clip(d, -1, 1) * 8388607).astype(np.int32).astype(np.float32)
                / np.float32(8388608.0))
    return d.astype(np.float32)


def _signal(C, T, seed):
    return (0.5 * np.random.default_rng(seed).standard_normal((C, T))).clip(-1, 1).astype(np.float32)


def _native_or_skip():
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler: the native WAV codec cannot be built")
    lib = native.load()
    assert lib is not None, (native.BUILD_DIR / "build.log").read_text()
    return lib


@pytest.mark.parametrize("bits", BITS)
def test_python_wav_round_trip(tmp_path, bits):
    x = _signal(2, 1001, 1)
    p = str(tmp_path / f"x{bits}.wav")
    if bits in ("16", "32f"):  # the Python writer's own formats
        twav._write_wav_py(p, x, 44100, 16 if bits == "16" else 32)
    else:
        write_pcm(p, x, 44100, bits)
    y, rate = twav._read_wav_py(p)
    assert rate == 44100 and y.dtype == np.float32 and y.shape == (2, 1001)
    if bits == "16":  # the Python writer truncates toward zero
        want = ((np.clip(x, -1, 1) * np.float32(32767.0)).astype(np.int16).astype(np.float32)
                / np.float32(32768.0))
    else:
        want = expected(x, bits)
    np.testing.assert_array_equal(y, want)


@pytest.mark.parametrize("bits", BITS)
def test_native_decode_equals_python_decode(tmp_path, bits):
    _native_or_skip()
    x = _signal(3, 2003, 2)
    p = str(tmp_path / f"x{bits}.wav")
    write_pcm(p, x, 48000, bits)
    want, rate = twav._read_wav_py(p)
    got, grate = native.wav_read(p)
    assert grate == rate == 48000
    np.testing.assert_array_equal(got, want)
    (b, brate), = native.wav_read_batch([p])
    np.testing.assert_array_equal(b, want)
    got2, _ = twav.read_wav(p)  # the entry point takes the native codec
    np.testing.assert_array_equal(got2, want)


def test_native_write_equals_python_write(tmp_path):
    _native_or_skip()
    x = _signal(2, 777, 3)
    for fmt in (16, 32):
        pn, pp = str(tmp_path / f"n{fmt}.wav"), str(tmp_path / f"p{fmt}.wav")
        twav.write_wav(pn, x, 48000, fmt)
        twav._write_wav_py(pp, x, 48000, fmt)
        np.testing.assert_array_equal(twav._read_wav_py(pn)[0], twav._read_wav_py(pp)[0])


def test_read_wav_decode_errors_propagate(tmp_path):
    """A corrupt file raises; the native decode error does not fall back to
    the Python parser, which could return a partial decode."""
    p = str(tmp_path / "corrupt.wav")
    with open(p, "wb") as f:
        f.write(b"RIFF\x10\x00\x00\x00WAVEjunk")
    with pytest.raises(ValueError):
        twav._read_wav_py(p)
    _native_or_skip()
    with pytest.raises(IOError):
        twav.read_wav(p)
    good = str(tmp_path / "good.wav")
    write_pcm(good, _signal(2, 100, 4), 48000, "16")
    with pytest.raises(IOError, match="corrupt.wav"):
        tbatch.load_files([good, p])


def test_assemble_pads_and_keeps_lengths():
    files = [_signal(2, n, n) for n in (100, 2401, 4800)]
    b = tbatch.assemble(files, 48000)
    assert b.data.shape == (3, 2, 4800) and b.rate == 48000
    np.testing.assert_array_equal(b.lengths, [100, 2401, 4800])
    for f, row in zip(files, b.data):
        n = f.shape[1]
        np.testing.assert_array_equal(row[:, :n], f)
        assert not row[:, n:].any()
    b = tbatch.assemble(files[:2], 48000)
    assert b.data.shape == (2, 2, 2 * tbatch.ALIGN)  # rounded up to the alignment
    np.testing.assert_array_equal(b.lengths, [100, 2401])
    np.testing.assert_array_equal(b.data[1, :, :2401], files[1])
    assert not b.data[1, :, 2401:].any()
    with pytest.raises(ValueError, match="channel counts"):
        tbatch.assemble([_signal(2, 10, 0), _signal(1, 10, 0)], 48000)


def test_load_files_mixed_rate_matches_jax(tmp_path):
    paths = []
    for i, (fs, sec, bits) in enumerate([(44100, 0.5, "16"), (48000, 1.25, "24"),
                                         (44100, 1.0, "32f"), (48000, 0.75, "16")]):
        p = str(tmp_path / f"f{i}.wav")
        write_pcm(p, make_signal("mix", sec, fs=fs), fs, bits)
        paths.append(p)
    got = tbatch.load_files(paths, target_rate=48000, device="cpu")
    want = jbatch.load_files(paths, target_rate=48000)
    assert got.rate == want.rate == 48000
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert got.data.shape == want.data.shape
    np.testing.assert_allclose(got.data, want.data, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="sample-rate mismatch"):
        tbatch.load_files(paths)
    with pytest.raises(ValueError, match="expected"):
        tbatch.load_files(paths[1::2], expect_rate=44100)


@pytest.mark.parametrize("factor", (2, 4, 8))
def test_rational_resampler_zita_npz(factor):
    """The goniometer's zita setup (fs -> factor*fs, hl = 12, frel = 1)
    through the generic resampler against the captured zita output."""
    data = np.load(os.path.join(FIXDIR, "resample_zita.npz"))
    rs = RationalResampler(48000, 48000 * factor, 12, frel=1.0)
    assert (rs.n, rs.s) == (factor, 1)
    y, _ = rs.apply(torch.from_numpy(data["x"]), rs.init((2,), device="cpu"))
    np.testing.assert_allclose(y.numpy(), data[f"up{factor}"], rtol=0, atol=1e-6)


def _rresample_fixtures():
    out = []
    for p in sorted(glob.glob(os.path.join(FIXDIR, "rresample_*.json"))):
        with open(p) as f:
            out.append(json.load(f))
    return out


def test_rational_resampler_zita_fixtures():
    fixtures = _rresample_fixtures()
    assert {fx["meter"] for fx in fixtures} == {"rresample_up", "rresample_down"}
    for fx in fixtures:
        rec = fx["reads"][0]
        fs_in, fs_out, hl = fx["fs"], rec["fs_out"], rec["hlen"]
        x = make_signal(fx["signal"], fx["seconds"], fs=fs_in)
        g = np.array(rec["data"], np.float64).reshape(-1, 2).T
        rs = RationalResampler(fs_in, fs_out, hl)
        xp = np.concatenate([x, np.zeros((2, (-x.shape[1]) % rs.s), np.float32)], -1)
        y, _ = rs.apply(torch.from_numpy(xp), rs.init((2,), device="cpu"))
        n = min(g.shape[1], y.shape[1])
        np.testing.assert_allclose(y.numpy()[:, :n], g[:, :n], rtol=0, atol=1e-6,
                                   err_msg=f"{fx['meter']}/{fx['signal']}")
        # resample_signal pads to whole cycles the same way
        np.testing.assert_array_equal(resample_signal(torch.from_numpy(x), fs_in, fs_out, hl).numpy(),
                                      y.numpy())


@pytest.mark.parametrize("fs_in,fs_out,hl", [(44100, 48000, 24), (32000, 48000, 32)])
def test_rational_resampler_streaming(fs_in, fs_out, hl):
    """Chunked apply() with carried history == one-shot (32 kHz -> 48 kHz
    has nh = 63 > s = 2, the frames' multi-block heads)."""
    rs = RationalResampler(fs_in, fs_out, hl)
    T = rs.s * 200
    x = torch.from_numpy((0.5 * np.random.default_rng(2).standard_normal((3, T))).astype(np.float32))
    y_once, h_once = rs.apply(x, rs.init((3,), device="cpu"))
    h = rs.init((3,), device="cpu")
    outs = []
    step = rs.s * 17
    for i in range(0, T, step):
        y, h = rs.apply(x[:, i : i + step], h)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, -1).numpy(), y_once.numpy(), rtol=0, atol=2e-6)
    assert torch.equal(h, h_once)
    with pytest.raises(ValueError, match="multiple"):
        rs.apply(x[:, : rs.s + 1], rs.init((3,), device="cpu"))


@pytest.mark.parametrize("fs_in,fs_out", [(44100, 48000), (48000, 44100), (32000, 48000)])
def test_resample_signal_matches_jax(fs_in, fs_out):
    x = make_signal("mix", 0.6, fs=fs_in)[:, :-3]  # not a whole number of cycles
    got = resample_signal(torch.from_numpy(x), fs_in, fs_out).numpy()
    want = np.asarray(jresample.resample_signal(jnp.asarray(x), fs_in, fs_out))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    rs, rj = RationalResampler(fs_in, fs_out), jresample.RationalResampler(fs_in, fs_out)
    assert (rs.n, rs.s, rs.h) == (rj.n, rj.s, rj.h)
    np.testing.assert_array_equal(rs._Wc, rj._Wc)
    t = torch.from_numpy(x)
    assert resample_signal(t, fs_in, fs_in) is t


def test_concurrent_loader_builds(tmp_path):
    """Two processes that find a stale stamp both end with a loadable
    library; native/ is not written."""
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler")
    src_before = sorted(os.listdir(native.SRC_DIR))
    d = tmp_path / "build"
    d.mkdir()
    (d / native.LIB_NAME).write_bytes(b"not a library")
    (d / (native.LIB_NAME + ".srchash")).write_text("stale")
    code = (
        "import ctypes, sys\n"
        "from meters_lv2_torch.runtime import native\n"
        "p = native.build(sys.argv[1])\n"
        "lib = native._bind(ctypes.CDLL(str(p)))\n"
        "print(p)\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(d)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        assert out.strip() == str(d / native.LIB_NAME)
    want = digest([native.SRC_DIR / n for n in native._SOURCES], native.CXX_FLAGS)
    assert (d / (native.LIB_NAME + ".srchash")).read_text() == want
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
    assert sorted(os.listdir(native.SRC_DIR)) == src_before
    assert native.BUILD_DIR.parts[-3:] == ("build", "meters_lv2_torch", "native")
