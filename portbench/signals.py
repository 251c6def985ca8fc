"""Programme-like stereo audio, made on the device from a seed.

One general generator for every traffic mix: a traffic file names its
mix, ``portbench/mixes/<name>.json``, whose keys set the parameters.  Per
stream:

  * level segments of ``segment_s`` seconds, each at an RMS level drawn
    from ``level_dbfs``; a ``silent_share`` of them at ``silent_dbfs``,
    below the -70 LUFS absolute gate of BS.1770;
  * pink-shaped noise (1/f power above ``pink_floor_hz``, rising below)
    with up to ``tones_per_segment`` sine tones a segment at ``tone_hz``
    and ``tone_rel_db`` against the noise;
  * inter-channel correlation drawn from ``corr``: +1 (R = L), 0 (R
    independent), -1 (R = -L) or mixed (R = rho L + sqrt(1 - rho^2) N);
  * in an ``isp_share`` of the streams one burst of a tone at fs/4 with a
    45 degree phase: its samples sit at 0.707 of its amplitude, so its
    true peak lies between samples, up to +2.6 dBTP;
  * in a ``clip_share`` of the streams the whole programme driven so that
    its loudest segment's RMS sits at ``clip_rms_dbfs``, into full scale;
  * every sample clamped to [-1, 1], as PCM would hold it.

The segment tables are drawn on the host from the seed (a few numbers a
stream); the samples are made on the device with a ``torch.Generator``
seeded with it, streams in chunks, straight into the pool.  The same seed
gives the same audio on the same kind of device; every seed gives the same
sizes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

CORR_MODES = ("+1", "0", "-1", "mixed")


@dataclass(frozen=True)
class Plan:
    """Per-stream tables, [B, K] or [B]; times in samples."""

    seg_start: np.ndarray  # [B, K] int64, seg_start[:, 0] == 0
    level_db: np.ndarray  # [B, K] RMS level of the segment, dBFS
    silent: np.ndarray  # [B, K] bool
    tone_hz: np.ndarray  # [B, K, 2] int64 (0: no tone)
    tone_amp: np.ndarray  # [B, K, 2] amplitude against unit-RMS noise
    corr: np.ndarray  # [B] index into CORR_MODES
    rho: np.ndarray  # [B] mixed-mode correlation
    isp: np.ndarray  # [B] bool
    isp_start: np.ndarray  # [B] int64
    isp_len: np.ndarray  # [B] int64
    isp_amp: np.ndarray  # [B]
    clip: np.ndarray  # [B] bool
    clip_gain: np.ndarray  # [B] linear drive


def _uniform(rng, lo_hi, size):
    lo, hi = lo_hi
    return rng.uniform(lo, hi, size)


def plan(seed: int, batch: int, n: int, fs: int, mix: dict) -> Plan:
    """The segment tables of ``batch`` streams of ``n`` samples."""
    rng = np.random.default_rng([seed % (1 << 64), 0x5EED])
    smin, smax = mix["segment_s"]
    k = int(math.ceil(n / (smin * fs))) + 1
    lens = np.round(_uniform(rng, (smin * fs, smax * fs), (batch, k))).astype(np.int64)
    starts = np.concatenate([np.zeros((batch, 1), np.int64), np.cumsum(lens, 1)[:, :-1]], 1)
    silent = rng.random((batch, k)) < mix["silent_share"]
    level = np.where(silent, _uniform(rng, mix["silent_dbfs"], (batch, k)),
                     _uniform(rng, mix["level_dbfs"], (batch, k)))
    tmin, tmax = mix["tones_per_segment"]
    ntones = rng.integers(tmin, tmax + 1, (batch, k))
    fmin, fmax = mix["tone_hz"]
    tone_hz = rng.integers(fmin, fmax + 1, (batch, k, 2)).astype(np.int64)
    amp = 10.0 ** (_uniform(rng, mix["tone_rel_db"], (batch, k, 2)) / 20.0)
    have = np.arange(2)[None, None, :] < ntones[..., None]
    tone_hz = np.where(have, tone_hz, 0)
    amp = np.where(have, amp, 0.0)
    corr = rng.integers(0, len(mix["corr"]), batch)
    corr = np.array([CORR_MODES.index(mix["corr"][c]) for c in corr], np.int64)
    rho = rng.uniform(-0.9, 0.9, batch)
    isp = rng.random(batch) < mix["isp_share"]
    ilen = np.minimum(np.round(_uniform(rng, mix["isp_s"], batch) * fs).astype(np.int64), n)
    istart = (rng.random(batch) * (n - ilen + 1)).astype(np.int64)
    iamp = _uniform(rng, mix["isp_amp"], batch)
    clip = rng.random(batch) < mix["clip_share"]
    loudest = np.where(silent | (starts >= n), -np.inf, level).max(1)
    cgain = 10.0 ** ((_uniform(rng, mix["clip_rms_dbfs"], batch) - loudest) / 20.0)
    clip &= np.isfinite(loudest)
    return Plan(starts, level, silent, tone_hz, amp, corr, rho, isp, istart, ilen, iamp,
                clip, cgain)


def _pink(noise: torch.Tensor, fs: int, floor_hz: float) -> torch.Tensor:
    """noise [..., n] white -> unit-RMS pink-shaped rows."""
    n = noise.shape[-1]
    spec = torch.fft.rfft(noise, dim=-1)
    f = torch.fft.rfftfreq(n, d=1.0 / fs, device=noise.device).clamp_min(1e-3)
    w = torch.where(f >= floor_hz, torch.rsqrt(f), (f / floor_hz) * (floor_hz ** -0.5))
    w[0] = 0.0
    y = torch.fft.irfft(spec * w, n=n, dim=-1)
    return y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True))


def _chunk(p: Plan, b0: int, b1: int, n: int, fs: int, mix: dict,
           gen: torch.Generator, device) -> torch.Tensor:
    """Streams b0..b1 as [b1 - b0, 2, n] float32 on ``device``."""
    nb = b1 - b0
    dev = torch.device(device)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a[b0:b1]), dtype=dtype, device=dev)

    noise = torch.randn((nb, 2, n), generator=gen, device=dev, dtype=torch.float32)
    pink = _pink(noise, fs, float(mix["pink_floor_hz"]))
    del noise
    idx = torch.arange(n, device=dev, dtype=torch.int64)
    seg = torch.searchsorted(t(p.seg_start, torch.int64),
                             idx.expand(nb, n).contiguous(), right=True) - 1
    amp = t(p.tone_amp)  # [nb, K, 2]
    hz = t(p.tone_hz, torch.int64)
    # RMS of noise plus tones is sqrt(1 + sum a^2 / 2): each segment's gain
    # sets its RMS to the level
    norm = torch.rsqrt(1.0 + 0.5 * (amp * amp).sum(-1))  # [nb, K]
    gain = 10.0 ** (t(p.level_db) / 20.0) * norm
    src = pink[:, 0]
    for j in range(2):
        hz_j = torch.gather(hz[..., j], 1, seg)
        a_j = torch.gather(amp[..., j], 1, seg)
        phase = ((hz_j * idx) % fs).to(torch.float64) / fs
        src = src + a_j * torch.sin(2.0 * math.pi * phase).to(torch.float32)
    g = torch.gather(gain, 1, seg)
    mode = t(p.corr, torch.int64)[:, None]
    rho = t(p.rho)[:, None]
    right = torch.where(mode == 0, src, torch.where(mode == 2, -src, pink[:, 1]))
    right = torch.where(mode == 3, rho * src + torch.sqrt(1.0 - rho * rho) * pink[:, 1], right)
    x = torch.stack([src * g, right * g], dim=1)
    del pink, src, right, g, seg
    # intersample-peak bursts: fs/4 at 45 degrees, samples at +-0.707 A
    on = (t(p.isp, torch.bool)[:, None]
          & (idx >= t(p.isp_start, torch.int64)[:, None])
          & (idx < (t(p.isp_start, torch.int64) + t(p.isp_len, torch.int64))[:, None]))
    burst = t(p.isp_amp)[:, None] * torch.sin(
        0.5 * math.pi * (idx % 4).to(torch.float32) + 0.25 * math.pi)
    x = torch.where(on[:, None, :], burst[:, None, :], x)
    drive = torch.where(t(p.clip, torch.bool), t(p.clip_gain), 1.0)
    return torch.clamp(x * drive[:, None, None], -1.0, 1.0)


def fill_pool(pool: torch.Tensor, seed: int, fs: int, mix: dict) -> Plan:
    """Fill ``pool`` [P, B, 2, T] with B programmes of P*T samples: sample
    i of stream b, channel c at pool[i // T, b, c, i % T].  Returns the plan."""
    P, B, C, T = pool.shape
    if C != 2:
        raise ValueError(f"the generator makes stereo, the pool has {C} channels")
    n = P * T
    chunk = max(1, (64 << 20) // n)  # ~64 M samples a chunk: a few GB of temporaries
    p = plan(seed, B, n, fs, mix)
    gen = torch.Generator(device=pool.device)
    gen.manual_seed(seed % (1 << 63))
    for b0 in range(0, B, chunk):
        b1 = min(B, b0 + chunk)
        x = _chunk(p, b0, b1, n, fs, mix, gen, pool.device)
        pool[:, b0:b1] = x.view(b1 - b0, 2, P, T).permute(2, 0, 1, 3)
        del x
    return p


def stream_audio(pool: torch.Tensor, streams, cycles: int = 1) -> torch.Tensor:
    """The programmes of ``streams`` as [S, 2, P*T*cycles] (the pool played
    ``cycles`` times over), a copy on the pool's device."""
    P, B, C, T = pool.shape
    idx = torch.as_tensor(np.asarray(streams), device=pool.device, dtype=torch.long)
    x = pool.index_select(1, idx).permute(1, 2, 0, 3).reshape(len(idx), C, P * T)
    return x.repeat(1, 1, cycles) if cycles > 1 else x.contiguous()
