"""The port's block streaming: chunking on the 4-sample grain, the readout
cadence, stream_pipelined against stream (bit for bit), stream_wav end to
end, and a caller's "high" matmul precision leaving the results' bits as
they are.  The port alone, on CPU tensors (tests/test_torch_cuda.py holds
stream_pipelined to stream on the card)."""

import numpy as np
import pytest
import torch

from signals import make_signal
from meters_lv2_torch.io import write_wav
from meters_lv2_torch.io.stream import (
    chunk_array, state_device, stream, stream_pipelined, stream_wav, to_host)
from meters_lv2_torch.models.ebur128 import EbuR128Meter
from meters_lv2_torch.models.kmeter import K20Meter, KMeter
from meters_lv2_torch.models.needle import DINMeter
from meters_lv2_torch.models.phasewheel import Stereoscope
from meters_lv2_torch.models.spectrum import SpectrumAnalyzer

torch.set_num_threads(1)

FS = 48000


def _leaves(s):
    import dataclasses

    if dataclasses.is_dataclass(s):
        for f in dataclasses.fields(s):
            yield from _leaves(getattr(s, f.name))
    elif isinstance(s, dict):
        for v in s.values():
            yield from _leaves(v)
    else:
        yield s


def _same_bits(a, b):
    return all(torch.equal(u, v) for u, v in zip(_leaves(a), _leaves(b), strict=True))


def test_chunk_array_never_pads_midstream():
    """A 44.1 kHz-style chunk (22050 % 4 == 2) injects no zeros between
    real samples: the chunk rounds down to the 4-grain and only the final
    piece is padded."""
    x = np.arange(1, 100001, dtype=np.float32)
    pieces = list(chunk_array(x, 22050))
    recon = np.concatenate(pieces)
    n = len(x)
    np.testing.assert_array_equal(recon[:n], x)
    assert np.all(recon[n:] == 0) and len(recon) - n < 4
    assert all(len(p) % 4 == 0 for p in pieces) and len(pieces[0]) == 22048
    np.testing.assert_array_equal(np.concatenate(list(chunk_array(x, 22050, pad=False))), x)
    stereo = np.stack([x, -x])
    assert [p.shape for p in chunk_array(stereo[:, :10], 3)] == [(2, 4), (2, 4), (2, 4)]


def test_stream_readout_cadence():
    x = make_signal("bursts", 3.0)[0]
    m = KMeter(FS)
    seen = []
    stream(m, m.init((), device="cpu"), chunk_array(x, 12000), read_every=2,
           on_read=lambda i, out: seen.append((i, float(out["rms"]))))
    assert [i for i, _ in seen] == [1, 3, 5, 7, 9, 11]  # 12 chunks, read every 2
    assert max(v for _, v in seen) > 0
    assert isinstance(to_host({"a": torch.ones(2)})["a"], np.ndarray)


@pytest.mark.parametrize("depth", (1, 3))
def test_stream_pipelined_equals_stream(depth):
    """The same updates in the same order: bit-identical states, and the
    same readouts at the same cadence."""
    x = make_signal("mix", 2.0)
    for m in (EbuR128Meter(FS, nchan=2), DINMeter(FS)):
        def init():
            return m.init((2,) if isinstance(m, DINMeter) else (), device="cpu")

        seen1, seen2 = [], []
        s1 = stream(m, init(), chunk_array(x, 9600), read_every=4,
                    on_read=lambda i, o: seen1.append((i, to_host(o))))
        s2 = stream_pipelined(m, init(), chunk_array(x, 9600), depth=depth, read_every=4,
                              on_read=lambda i, o: seen2.append((i, to_host(o))))
        assert _same_bits(s1, s2)
        assert [i for i, _ in seen1] == [i for i, _ in seen2] == [3, 7]
        for (_, a), (_, b) in zip(seen1, seen2):
            for u, v in zip(_leaves(a), _leaves(b), strict=True):
                np.testing.assert_array_equal(u, v)
    # tensors as blocks, and a dict state (the stereoscope's)
    sc = Stereoscope(FS)
    blocks = [torch.from_numpy(x[:, i : i + 1920]) for i in range(0, 5 * 1920, 1920)]

    class Proc:  # process() as update(), as the pipeline drives display meters
        def update(self, st, b):
            return sc.process(st, b)[1]

    assert state_device(sc.init((), device="cpu")) == torch.device("cpu")
    a = stream(Proc(), sc.init((), device="cpu"), blocks)
    b = stream_pipelined(Proc(), sc.init((), device="cpu"), iter(blocks), depth=depth)
    assert _same_bits(a, b)
    with pytest.raises(ValueError):
        stream_pipelined(m, init(), [], depth=0)


def test_stream_wav_end_to_end(tmp_path):
    x = make_signal("mix", 4.0)
    p = str(tmp_path / "s.wav")
    write_wav(p, x, FS)
    m = EbuR128Meter(FS, nchan=2)
    out, st = stream_wav(m, p, chunk_seconds=1.3, device="cpu")  # odd chunking
    assert isinstance(out["integrated"], np.ndarray) and st.hist_m.device.type == "cpu"
    ref, _ = m.read(m.update(m.init((), device="cpu"), torch.from_numpy(x)))
    assert abs(float(out["loudness_S"]) - float(ref["loudness_S"])) < 0.01
    assert abs(float(out["integrated"]) - float(ref["integrated"])) < 0.01
    np.testing.assert_allclose(float(out["dbtp"]), float(ref["dbtp"]), rtol=1e-5)
    with pytest.raises(ValueError, match="Hz"):
        stream_wav(EbuR128Meter(44100, nchan=2), p, device="cpu")


def test_stream_under_high_matmul_precision():
    """A caller's "high" float32 matmul precision changes no bit: every
    product of the port runs in IEEE float32 (ops/lti.ieee_fp32)."""
    x = make_signal("mix", 1.0)
    meters = (EbuR128Meter(FS, nchan=2), SpectrumAnalyzer(FS), K20Meter(FS))

    def run():
        out = []
        for m in meters:
            st = m.init(() if isinstance(m, EbuR128Meter) else (2,), device="cpu")
            kw = {"depth": 2} if isinstance(m, SpectrumAnalyzer) else {}
            go = stream_pipelined if kw else stream
            out.append(go(m, st, chunk_array(x, 4800), **kw))
        return out

    want = run()
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        got = run()
    finally:
        torch.set_float32_matmul_precision(saved)
    for a, b in zip(got, want):
        assert _same_bits(a, b)
