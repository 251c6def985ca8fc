"""The port's surround meters against the committed C-reference goldens:
surround3_mix, surround5_mix, surround7_mix and surround8_mix.

``run_surround`` streams one fixture whole (6 s in blocks of 1024 samples,
a read every 16 blocks) with the asserts of
tests/test_golden_parity.py::test_surround_parity: every channel's level
and peak within 0.01 dB (``assert_level``: 20 log10 of the magnitudes,
both below 1e-6 pass), every pair's correlation within 1e-3 absolute.
The fixtures record ``rms``/``peak`` per channel and ``cor`` per pair.
``chip_smoke.py`` streams the same fixtures on the card with the same
function.  This module imports no JAX.
"""

import json
import os

import pytest
import torch

import meters_lv2_torch as mt
from test_torch_golden_ballistics import assert_level

torch.set_num_threads(1)

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
TOL_DB = 0.01
COR_TOL = 1e-3
PREFIXES = ("surround3", "surround5", "surround7", "surround8")


def run_surround(prefix, device="cpu"):
    """Stream the ``prefix``_mix fixture whole through the port's meter on
    ``device``; assert every read.  Returns (worst level/peak deviation in
    dB, worst correlation deviation, number of values checked)."""
    from signals import make_surround

    with open(os.path.join(FIXDIR, prefix + "_mix.json")) as f:
        fx = json.load(f)
    C = fx["nchan"]
    m = mt.create(f"surround{C}", fx["fs"])
    x = torch.as_tensor(make_surround(fx["signal"], fx["seconds"], fs=fx["fs"], nchan=C),
                        device=device)
    st = m.init((), device=device)
    reads = iter(fx["reads"])
    blk = fx["block"]
    worst_db = worst_cor = 0.0
    n = 0
    for b in range(x.shape[1] // blk):
        st = m.update(st, x[:, b * blk:(b + 1) * blk])
        if (b + 1) % fx["read_every"]:
            continue
        out, st = m.read(st)
        rec = next(reads)
        level, peak, cor = (out[k].cpu().double().tolist() for k in ("level", "peak", "correlation"))
        for c in range(C):
            tag = f"{prefix} ch{c} blk {rec['block']}"
            worst_db = max(worst_db, assert_level(level[c], rec["rms"][c], msg=f"{tag} rms"),
                           assert_level(peak[c], rec["peak"][c], msg=f"{tag} peak"))
            n += 2
        for p, want in enumerate(rec["cor"]):
            d = abs(cor[p] - want)
            assert d < COR_TOL, f"{prefix} pair {p} blk {rec['block']}: {cor[p]} vs {want}"
            worst_cor = max(worst_cor, d)
            n += 1
    assert next(reads, None) is None, f"{prefix}: reads left over"
    return worst_db, worst_cor, n


@pytest.mark.parametrize("prefix", PREFIXES)
def test_surround_golden(prefix):
    worst_db, worst_cor, n = run_surround(prefix)
    assert n > 0 and worst_db <= TOL_DB and worst_cor < COR_TOL
