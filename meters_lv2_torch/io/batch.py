"""Batch assembly: pad a ragged set of audio files into the fixed-shape
[B, C, T] array the meter pipeline consumes (counterpart of
``meters_lv2_tpu/io/batch.py``: the batch is numpy on the host, the
resampling of mixed-rate ingest runs on the caller's device).

The reference's throughput axis is "one plugin instance per track"; here a
thousand files become one batch.  Files are right-padded with silence to a
common (block-aligned) length; per-file valid lengths ride along and
parallel.pipeline.run_stream_ragged consumes them so each file is measured
over exactly its own samples — trailing padding is never processed and
per-file readouts equal a serial per-file run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class AudioBatch:
    data: np.ndarray  # [B, C, T] float32
    lengths: np.ndarray  # [B] int64 valid frames per file
    rate: int


# the padded length is a multiple of one R128 fragment at 48 kHz
ALIGN = 2400


def assemble(files: list[np.ndarray], rate: int) -> AudioBatch:
    """Stack [C, T_i] arrays into one batch padded to a multiple of ALIGN."""
    if not files:
        raise ValueError("no files to assemble")
    C = files[0].shape[0]
    if any(f.shape[0] != C for f in files):
        raise ValueError(f"channel counts differ: {sorted({f.shape[0] for f in files})}")
    lens = np.array([f.shape[1] for f in files], np.int64)
    T = -(-int(lens.max()) // ALIGN) * ALIGN
    out = np.zeros((len(files), C, T), np.float32)
    for i, f in enumerate(files):
        out[i, :, : f.shape[1]] = f
    return AudioBatch(data=out, lengths=lens, rate=rate)


def load_files(
    paths: list[str],
    expect_rate: int | None = None,
    target_rate: int | None = None,
    device="cuda",
) -> AudioBatch:
    """Read WAVs (native decoder) and assemble a batch.

    target_rate: normalize a mixed-rate set to one meter rate via the
    arbitrary-ratio polyphase resampler (ops.resample.RationalResampler:
    the zita Resampler is generic, resampler.cc:67-120), whose product runs
    on ``device``; only a file at another rate goes there and back.
    Without it, all files must share one rate.
    """
    from ..runtime import native

    if native.load() is not None:
        # the native thread-pool decode; a decode error (a corrupt file)
        # propagates: only the library's unavailability falls back
        decoded = native.wav_read_batch(paths)
    else:
        from .wav import read_wav

        decoded = [read_wav(p) for p in paths]

    arrs = []
    rate = None
    for p, (x, r) in zip(paths, decoded):
        if target_rate is not None and r != target_rate:
            from ..ops.resample import resample_signal

            x = resample_signal(torch.as_tensor(x, device=device), r, target_rate).cpu().numpy()
            r = target_rate
        if rate is None:
            rate = r
        if r != rate:
            raise ValueError(f"sample-rate mismatch: {p} has {r}, want {rate} "
                             f"(pass target_rate= to resample on ingest)")
        arrs.append(x)
    if expect_rate is not None and rate != expect_rate:
        raise ValueError(f"files are at {rate} Hz, expected {expect_rate}")
    return assemble(arrs, rate)
