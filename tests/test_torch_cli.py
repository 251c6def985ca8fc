"""The port's batch CLI (python -m meters_lv2_torch) on CPU tensors, against
the JAX package's CLI where both run.

Bars: every number of the JSON within 1e-4 + 1e-4 x |value| of the JAX
CLI's (the pipeline bars: R128's loudness within 1e-4; linear levels within
0.001 dB, inside the ±0.01 dB budget); histogram shapes equal.
"""

import json
import os

import numpy as np
import pytest
import torch

from signals import make_signal
from meters_lv2_torch import __main__ as tcli
from meters_lv2_torch.io import write_wav
from meters_lv2_tpu import __main__ as jcli

torch.set_num_threads(1)

FS = 48000


def _out(capsys, main, argv):
    assert main(argv) == 0
    return capsys.readouterr().out


def test_list_and_portlist_print_the_jax_clis_text(capsys):
    out = _out(capsys, tcli.main, ["--list"])
    assert out == _out(capsys, jcli.main, ["--list"])
    lines = out.strip().splitlines()
    assert len(lines) == 38
    assert any("VUmono  (1 ch)" in ln for ln in lines)
    out = _out(capsys, tcli.main, ["--portlist"])
    assert out == _out(capsys, jcli.main, ["--portlist"])
    assert "ref_level_db" in out and "control inputs:" in out and "None" not in out


def test_version_and_no_files(capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(["--version"])
    assert e.value.code == 0
    assert "meters_lv2_torch" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        tcli.main([])
    assert e.value.code == 2


def test_no_cuda_without_cpu_flag_exits_nonzero(tmp_path, monkeypatch, capsys):
    p = str(tmp_path / "a.wav")
    write_wav(p, make_signal("sine997", 0.1), FS)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tcli.main([p])
    assert e.value.code != 0
    assert "no CUDA device" in capsys.readouterr().err


def _close(a, b, path):
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _close(u, v, f"{path}[{i}]")
    elif isinstance(b, (int, float)) and not isinstance(b, bool):
        assert a is not None and abs(a - b) <= 1e-4 + 1e-4 * abs(b), (path, a, b)
    else:
        assert a == b, (path, a, b)


def test_json_and_render_dir_match_the_jax_cli(tmp_path, capsys):
    paths = []
    for i, (sig, sec) in enumerate([("mix", 1.5), ("sine997", 0.75)]):
        p = str(tmp_path / f"f{i}.wav")
        write_wav(p, make_signal(sig, sec), FS)
        paths.append(p)
    args = [*paths, "--meters", "r128,truepeak,k20,cor", "--json", "--chunk-seconds", "0.1",
            "--ref-level", "-18"]
    got = json.loads(_out(capsys, tcli.main, [*args, "--cpu", "--render-dir", str(tmp_path / "t")]))
    want = json.loads(_out(capsys, jcli.main, [*args, "--render-dir", str(tmp_path / "j")]))
    assert [r["file"] for r in got] == paths and list(got[0]) == list(want[0])
    _close(got, want, "rows")
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 8
    text = _out(capsys, tcli.main, [*paths, "--cpu", "--meters", "k20"])
    assert text.splitlines()[0] == f"== {paths[0]} (1.5s)" and "  [k20] {" in text


@pytest.mark.parametrize("C", (2, 5))
def test_meters_all_gives_every_applicable_meter(tmp_path, capsys, C):
    paths = []
    for i in range(2):
        t = np.arange(FS // 2 + 40 * i) / FS
        x = np.stack([0.1 * (c + 1) * np.sin(2 * np.pi * 220 * (c + 1 + i) * t)
                      for c in range(C)]).astype(np.float32)
        paths.append(str(tmp_path / f"c{C}_{i}.wav"))
        write_wav(paths[-1], x, FS)
    rows = json.loads(_out(capsys, tcli.main, [*paths, "--cpu", "--meters", "all", "--json",
                                                "--chunk-seconds", "0.25"]))
    want = tcli.applicable_meters(C)
    assert want == jcli.applicable_meters(C)
    for row in rows:
        assert list(row) == ["file", "seconds", *want]
    if C == 5:
        lv = rows[0]["surround"]["level"]
        assert len(lv) == 5 and lv == sorted(lv)  # rising per-channel levels
    else:
        assert {"goniometer", "phasewheel", "stereoscope"} <= set(rows[0])
        assert rows[1]["seconds"] == (FS // 2 + 40) / FS


def test_surround_pairs_and_chunk_grain(tmp_path, capsys):
    t = np.arange(FS // 4) / FS
    x = np.stack([np.sin(2 * np.pi * 300 * t + c) * 0.2 for c in range(5)]).astype(np.float32)
    x[4] = x[0]  # channel 4 equals channel 0
    p = str(tmp_path / "s.wav")
    write_wav(p, x, FS)
    base = [p, "--cpu", "--meters", "surround", "--json"]
    default = json.loads(_out(capsys, tcli.main, base))[0]["surround"]["correlation"]
    routed = json.loads(_out(capsys, tcli.main, [*base, "--surround-pairs", "0:4,1:2,2:3,3:4"]))
    assert abs(routed[0]["surround"]["correlation"][0] - 1.0) < 1e-3
    assert abs(default[0] - 1.0) > 1e-2
    for bad in ("0:1,1:2", "0:9,1:2,2:3,3:4", "a:b,1:2,2:3,3:4"):
        with pytest.raises(SystemExit) as e:
            tcli.main([*base, "--surround-pairs", bad])
        assert e.value.code == 2
    with pytest.raises(SystemExit):
        tcli.main([p, "--cpu", "--meters", "cor"])  # stereo only
    # a 44.1 kHz file: 0.5 s is 22050 samples, a chunk of 22048 on the
    # 4-sample grain gives the same readout as asking for 22048 directly
    q = str(tmp_path / "q.wav")
    write_wav(q, make_signal("mix", 1.2, fs=44100), 44100)
    a = _out(capsys, tcli.main, [q, "--cpu", "--meters", "k20,vu", "--json", "--chunk-seconds", "0.5"])
    b = _out(capsys, tcli.main, [q, "--cpu", "--meters", "k20,vu", "--json",
                                 "--chunk-seconds", str(22048 / 44100)])
    assert a == b
