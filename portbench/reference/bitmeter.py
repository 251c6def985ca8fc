"""Plain bit meter (x42 ``bitmeter``, src/bitmeter.c float_stats :63-105).

A mono meter: the configuration's pipeline feeds it channel 0 of the
stereo stream.  Over the stream's whole history from the start of
integration, read once at the programme's end (bitmeter.c:268-296), per
float32 sample with sign s, biased exponent e and mantissa m:

  * e = 255: a NaN (m != 0) or an Inf (m = 0), and nothing else;
  * e = 0 and m = 0: a zero, and nothing else;
  * every other sample: a denormal where e = 0; positive where s = 0; the
    |min| and |max| over the normals (e > 0), +inf and 0 where none;
  * bit positions p = e' + k with e' = max(e, 1): ``hit`` counts the 24
    positions k = 0..23 of a normal (the implicit bit at k = 23) and the 23
    of a denormal; ``one`` counts those whose bit of (m, with 2^23 for a
    normal) is set; ``dset`` counts the set bits k = 0..22 of m;
  * ``integration_time``: every sample integrated.

The fields come from integer arithmetic on the sample's 32 bits: shifts,
masks and one count a bit index; nothing here rounds, so the control, in
any precision, gives the same counts.  Departures: none (the 2^31-sample
integration cap is never reached in a programme; the averaging mode, the
meter's default, never clears).

How it is judged (``judge``): exactly.  ``bit_moves`` counts the fields
and counters, min and max among them, where the program's answer is not
this reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from .lti import Prec

KIND = "bitmeter"
READOUTS = {k: "bits" for k in ("hit", "one", "dset", "nan", "inf", "den", "zero", "pos",
                                 "min", "max", "integration_time")}
STATE = {}
NPOS = 280
NMAN = 23


def expected(x: torch.Tensor, fs: int, reads: list[int], prec: Prec, block: int) -> dict:
    """x [S, C, n], one read at the end -> {key: [S, 1, ...]}."""
    S, C, n = x.shape
    if reads != [n]:
        raise ValueError("the bit meter reference reads once, at the programme's end")
    v = x[:, 0].to(torch.float32).contiguous()
    bits = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    sign = bits >> 31
    exp = (bits >> 23) & 0xFF
    man = bits & 0x7FFFFF
    special = exp == 255
    zero = (exp == 0) & (man == 0)
    num = ~special & ~zero
    normal = num & (exp > 0)

    def count(mask):
        return mask.sum(-1)

    a = v.abs().to(torch.float64)
    out = {
        "nan": count(special & (man != 0)), "inf": count(special & (man == 0)),
        "zero": count(zero), "den": count(num & (exp == 0)), "pos": count(num & (sign == 0)),
        "min": torch.where(normal, a, torch.full_like(a, float("inf"))).amin(-1),
        "max": torch.where(normal, a, torch.zeros_like(a)).amax(-1),
    }
    full = torch.where(normal, man | (1 << 23), man)
    width = torch.where(normal, 24, 23)
    pos0 = torch.clamp(exp, min=1) + torch.arange(S, device=x.device)[:, None] * NPOS
    hit = torch.zeros(S * NPOS, dtype=torch.int64, device=x.device)
    one = torch.zeros_like(hit)
    dset = torch.zeros((S, NMAN), dtype=torch.int64, device=x.device)
    for k in range(24):
        at = (pos0 + k).reshape(-1)
        set_k = num & (((full >> k) & 1) == 1)
        hit.index_add_(0, at, (num & (k < width)).reshape(-1).long())
        one.index_add_(0, at, set_k.reshape(-1).long())
        if k < NMAN:
            dset[:, k] = count(set_k)
    out.update(hit=hit.reshape(S, NPOS), one=one.reshape(S, NPOS), dset=dset,
               integration_time=torch.full((S,), n, dtype=torch.int64, device=x.device))
    return {key: t[:, None] for key, t in out.items()}


def judge(name: str, port: dict, at: dict, ref: dict) -> dict:
    """{"bit_moves": [S]} for the meter ``name``."""
    S = ref[f"{name}.hit"].shape[0]
    moves = np.zeros(S)
    for key in READOUTS:
        got = port.get(f"{name}.{key}")
        where = at.get(f"{name}.{key}", np.zeros(0, np.int64))
        if got is None or not len(where):
            return {"bit_moves": np.full(S, np.inf)}
        want = ref[f"{name}.{key}"][:, where]
        moves = moves + (np.asarray(got, np.float64) != want).reshape(S, -1).sum(-1)
    return {"bit_moves": moves}
