"""Inline-display rendering: needle and bargraph mini-views as arrays.

The reference provides host-embedded mini-meters via the LV2 inline-display
extension (src/dpy_needle.c:54-157, src/dpy_bargraph.c:97-150, cairo).
Here the same capability renders to numpy RGBA images using the identical
deflection transfer curves (utils/db) — suitable for notebooks, web UIs or
video overlay, and batch-friendly.  A copy of ``meters_lv2_tpu/utils/render.py``
(numpy only); the views take host arrays.
"""

from __future__ import annotations

import math

import numpy as np

from . import db


def needle_image(
    value: float,
    meter_type: int = db.MT_VU,
    width: int = 120,
    height: int | None = None,
) -> np.ndarray:
    """Render a needle meter face -> [H, W, 4] uint8 RGBA.

    Mirrors the geometry of needle_render (dpy_needle.c:14-47): deflection
    in [0, 1.05] maps to a ±45° needle sweep.
    """
    h = height or int(math.ceil(width * 17.0 / 30.0))
    img = np.zeros((h, width, 4), np.uint8)
    img[..., :3] = 28
    img[..., 3] = 255

    x0, y0 = width / 2.0, h * 1.2
    rad = h * 1.0

    # scale arc ticks
    for frac in np.linspace(0.0, 1.0, 11):
        a = (frac - 0.5) * 1.5708
        x = int(x0 + math.sin(a) * rad)
        y = int(y0 - math.cos(a) * rad)
        if 0 <= x < width and 0 <= y < h:
            img[max(y - 1, 0) : y + 1, max(x - 1, 0) : x + 1, :3] = 160

    d = float(np.clip(db.meter_deflect(meter_type, np.float32(value)), 0.0, 1.05))
    a = (d - 0.5) * 1.5708
    n = max(h, width)
    ts = np.linspace(0.35, 1.0, n)
    xs = (x0 + np.sin(a) * rad * ts).astype(int)
    ys = (y0 - np.cos(a) * rad * ts).astype(int)
    ok = (xs >= 0) & (xs < width) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok], :3] = np.array([230, 60, 40], np.uint8)
    return img


def bargraph_image(
    db_value: float,
    krange: float = 20.0,
    width: int = 16,
    height: int = 120,
) -> np.ndarray:
    """Render a K-meter bargraph -> [H, W, 4] uint8 RGBA with the reference
    color bands (green below 0K, amber to +3, red above; dpy_bargraph.c)."""
    img = np.zeros((height, width, 4), np.uint8)
    img[..., :3] = 24
    img[..., 3] = 255
    d = float(db.kmeter_deflect(np.float32(db_value), krange))
    top = int(round(height * d))
    thr0 = float(db.kmeter_deflect(np.float32(-krange), krange))  # 0K mark
    thr3 = float(db.kmeter_deflect(np.float32(3.0 - krange), krange))
    for row in range(top):
        frac = row / max(height - 1, 1)
        if frac < thr0:
            c = (0, 180, 40)
        elif frac < thr3:
            c = (230, 180, 0)
        else:
            c = (230, 40, 30)
        img[height - 1 - row, 1 : width - 1, :3] = c
    return img


def radar_image(
    radar_db: np.ndarray,
    pos: int,
    size: int = 200,
    floor_db: float = -60.0,
) -> np.ndarray:
    """Render the EBU radar loudness history -> [size, size, 4] RGBA
    (gui/ebur.c radar view: angle = ring index, radius = loudness)."""
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 3] = 255
    c = size / 2.0
    n = len(radar_db)
    vals = np.clip(
        (np.nan_to_num(radar_db, nan=floor_db, neginf=floor_db) - floor_db)
        / (-floor_db), 0.0, 1.0,
    )  # nan -> floor too: the default 0.0 would render full-scale spokes
    for i in range(n):
        ang = 2 * math.pi * ((i - pos) % n) / n - math.pi / 2
        r = vals[i] * (c - 2)
        steps = max(int(r), 1)
        ts = np.linspace(0, r, steps)
        xs = (c + np.cos(ang) * ts).astype(int)
        ys = (c + np.sin(ang) * ts).astype(int)
        ok = (xs >= 0) & (xs < size) & (ys >= 0) & (ys < size)
        g = np.uint8(60 + 195 * vals[i])
        img[ys[ok], xs[ok], 1] = np.maximum(img[ys[ok], xs[ok], 1], g)
        img[ys[ok], xs[ok], 2] = 60
    return img


def ebu_histogram_image(
    hist: np.ndarray,
    size: int = 200,
    plus9: bool = False,
) -> np.ndarray:
    """Render the EBU loudness-distribution histogram view -> RGBA.

    gui/ebur.c:588-655: polar wedges over a 1.5 pi arc; bin k (0.1 LU,
    LUFS = 0.1*k - 70) maps to an angle in [-59, -5] LUFS (or [-41, -14]
    with the +9 fine scale), wedge radius = R * (1 + log10(count /
    total)) — i.e. bins holding >=10% of the measured points reach out
    of the center, with a log falloff.
    """
    amin, amax = (290, 560) if plus9 else (110, 650)
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 3] = 255
    c = size / 2.0
    total = float(hist.sum())
    if total <= 0:
        return img
    astep = 1.5 * math.pi / (amax - amin)
    aoff = math.pi / 2.0 - amin * astep
    R = c - 2
    for k in range(amin, min(amax, len(hist))):
        if hist[k] <= 0:
            continue
        rad = R * (1.0 + math.log10(hist[k] / total))
        if rad < 5.0 * size / 400.0:
            continue
        ang = k * astep + aoff
        ts = np.linspace(0, rad, max(int(rad), 1))
        xs = (c + np.cos(ang) * ts).astype(int)
        ys = (c + np.sin(ang) * ts).astype(int)
        ok = (xs >= 0) & (xs < size) & (ys >= 0) & (ys < size)
        # green->red gradient with level, like histogram_pattern
        frac = (k - amin) / (amax - amin)
        img[ys[ok], xs[ok], 0] = np.uint8(80 + 175 * frac)
        img[ys[ok], xs[ok], 1] = np.uint8(220 - 160 * frac)
        img[ys[ok], xs[ok], 2] = 40
    return img


def bitmeter_image(
    hit: np.ndarray,
    one: np.ndarray,
    width: int = 120,
    max_height: int = 72,
) -> np.ndarray:
    """Render the bit meter inline view -> [H, W, 4] RGBA.

    Mirrors bit_render (src/bitmeter.c:420-539): 36 rows for absolute bit
    positions 2^0 .. 2^-35 (histS index o = 153-k); each row is a bar
    centered at mid-width whose half-length is the set-ratio one[o]/hit[o],
    colored by significance band; dashed guides every 8 bits.  (The
    reference's text fallbacks — 'Silence', NaN/Inf counters — are GUI
    typography, not meter data, and are omitted.)
    """
    h = min(72, max_height) & ~1
    img = np.zeros((h, width, 4), np.uint8)
    img[..., :3] = 51  # .2 gray background
    img[..., 3] = 255
    xc = width // 2
    xr = width // 2 - 4

    # dashed guide rows at bits 0/8/16/24 (bitmeter.c:478-494)
    for yy in (6, 22, 38, 54):
        if yy < h:
            img[yy, 0 : width - 8 : 4, :3] = 128

    bands = [
        (4, (230, 76, 0)),     # 2^0 .. 2^-3
        (12, (178, 178, 0)),   # 2^-4 .. 2^-11
        (20, (51, 230, 51)),   # 2^-12 .. 2^-19
        (28, (0, 153, 0)),     # 2^-20 .. 2^-27
        (36, (0, 0, 153)),     # 2^-28 .. 2^-35
    ]
    hit = np.asarray(hit)
    one = np.asarray(one)
    for k in range(36):
        o = 153 - k
        if o < 0 or o >= len(hit) or hit[o] == 0:
            continue
        xo = int(round(xr * float(one[o]) / float(hit[o])))
        y = 2 * k
        if y >= h:
            break
        color = next(c for lim, c in bands if k < lim)
        img[y, max(xc - xo, 0) : min(xc + xo + 1, width), :3] = color
    return img


def sigdist_image(
    hist: np.ndarray,
    width: int = 240,
    height: int = 120,
    log_y: bool = True,
) -> np.ndarray:
    """Render the signal-distribution histogram view -> [H, W, 4] RGBA.

    Mirrors gui/sdhmeter.c's linear-x histogram plot: 361 bins across the
    width (sample value -1.2 .. +1.2, zero mark at DIST_ZERO), bar height
    normalized to the peak count, optional log-y (y_log_pos = log(1+0.4 i),
    sdhmeter.c:167-169); center/±1.0 gridlines.
    """
    hist = np.asarray(hist, np.float64)
    nb = len(hist)  # 361
    img = np.zeros((height, width, 4), np.uint8)
    img[..., :3] = 30
    img[..., 3] = 255

    def ylp(v):
        return np.log1p(0.4 * v)

    peak = hist.max()
    if peak > 0:
        norm = ylp(hist) / ylp(peak) if log_y else hist / peak
        xs = (np.arange(nb) * width) // nb
        for i in range(nb):
            bh = int(round(norm[i] * (height - 2)))
            if bh > 0:
                img[height - 1 - bh : height - 1, xs[i], :3] = (90, 200, 90)
    # gridlines: zero center and +-1.0 full-scale (sdhmeter.c:234,283-292)
    for frac, shade in ((180.0 / 360.0, 200), (30.0 / 360.0, 120),
                        (330.0 / 360.0, 120)):
        x = int(round(width * frac))
        if 0 <= x < width:
            img[:, x, :3] = np.maximum(img[:, x, :3], shade)
    return img


def spectrum_image(
    bands_db: np.ndarray,
    peaks_db: np.ndarray | None = None,
    width: int = 240,
    height: int = 120,
    floor_db: float = -70.0,
    ceil_db: float = 6.0,
) -> np.ndarray:
    """Render the 30-band 1/3-octave analyzer view -> [H, W, 4] RGBA.

    Mirrors the spectrum GUI's bar plot (gui/dpm.c bar geometry with the
    IEC-268-18-style dB scale used by the 30-band meter): one bar per band,
    dB mapped linearly between floor and ceiling, peak-hold ticks above.
    """
    bands_db = np.asarray(bands_db, np.float64)
    nb = len(bands_db)
    img = np.zeros((height, width, 4), np.uint8)
    img[..., :3] = 26
    img[..., 3] = 255
    span = ceil_db - floor_db
    bw = max(width // nb - 1, 1)
    for i in range(nb):
        x0 = i * width // nb
        frac = np.clip((bands_db[i] - floor_db) / span, 0.0, 1.0)
        bh = int(round(frac * (height - 2)))
        if bh > 0:
            col = (60, 200, 90) if bands_db[i] < 0 else (230, 180, 0)
            img[height - 1 - bh : height - 1, x0 : x0 + bw, :3] = col
        if peaks_db is not None:
            pf = np.clip((float(peaks_db[i]) - floor_db) / span, 0.0, 1.0)
            py = height - 1 - int(round(pf * (height - 2)))
            if 0 <= py < height:
                img[py, x0 : x0 + bw, :3] = (230, 230, 230)
    # 0 dB gridline
    y0 = height - 1 - int(round((0.0 - floor_db) / span * (height - 2)))
    if 0 <= y0 < height:
        img[y0, :, :3] = np.maximum(img[y0, :, :3], 90)
    return img


# 3x5 bitmap glyphs for numeric readouts (the reference panels draw text
# via pango; batch views get a minimal pixel font for the same numbers)
_GLYPHS = {
    "0": ("111", "101", "101", "101", "111"),
    "1": ("010", "110", "010", "010", "111"),
    "2": ("111", "001", "111", "100", "111"),
    "3": ("111", "001", "111", "001", "111"),
    "4": ("101", "101", "111", "001", "001"),
    "5": ("111", "100", "111", "001", "111"),
    "6": ("111", "100", "111", "101", "111"),
    "7": ("111", "001", "010", "010", "010"),
    "8": ("111", "101", "111", "101", "111"),
    "9": ("111", "101", "111", "001", "111"),
    "-": ("000", "000", "111", "000", "000"),
    ".": ("000", "000", "000", "000", "010"),
    " ": ("000", "000", "000", "000", "000"),
    "D": ("110", "101", "101", "101", "110"),
    "R": ("110", "101", "110", "101", "101"),
}


def _blit_text(img, text, x, y, scale=2, color=(230, 230, 230)):
    """Draw `text` with the 3x5 pixel font at (x, y), top-left anchored."""
    h, w = img.shape[:2]
    for ch in str(text):
        rows = _GLYPHS.get(ch)
        if rows is None:
            x += 4 * scale
            continue
        for r, bits in enumerate(rows):
            for c, b in enumerate(bits):
                if b == "1":
                    y0, x0 = y + r * scale, x + c * scale
                    if 0 <= y0 < h and 0 <= x0 < w:
                        img[y0 : min(y0 + scale, h),
                            x0 : min(x0 + scale, w), :3] = color
        x += 4 * scale
    return x


def cor_image(correlation: float, width: int = 120) -> np.ndarray:
    """Render the phase-correlation needle view -> RGBA.

    The COR plugin's inline display uses the needle renderer with the
    linear [-1, +1] -> [0, 1] transfer curve (src/meters.cc COR wrapper +
    src/dpy_needle.c; curve at gui/needle.c:267-269)."""
    return needle_image(float(correlation), db.MT_COR, width)


def dr14_image(
    dr_total: float,
    rms_db: np.ndarray,
    peak_db: np.ndarray,
    width: int = 160,
    height: int = 90,
) -> np.ndarray:
    """Render the DR-14 panel -> [H, W, 4] RGBA.

    Mirrors gui/dr14meter.c: the large DR number (DR1..DR20, blank until
    enough 3 s windows accumulated = value 21) plus per-channel RMS and
    true-peak bargraphs on the IEC-268-18 scale."""
    img = np.zeros((height, width, 4), np.uint8)
    img[..., :3] = 24
    img[..., 3] = 255
    dr = float(dr_total)
    label = "DR--" if dr > 20.0 else f"DR{dr:.0f}" if dr >= 9.5 else f"DR {dr:.0f}"
    _blit_text(img, label, 8, 8, scale=4, color=(240, 240, 170))

    rms_db = np.atleast_1d(np.asarray(rms_db, np.float64))
    peak_db = np.atleast_1d(np.asarray(peak_db, np.float64))
    nch = len(rms_db)
    x0 = width // 2 + 8
    bw = max((width - x0 - 8) // max(2 * nch, 1) - 1, 2)
    for c in range(nch):
        for j, (v, col) in enumerate(
            ((rms_db[c], (60, 200, 90)), (peak_db[c], (230, 180, 0)))
        ):
            frac = float(db.iec268_deflect(np.float32(v)))
            bh = int(round(np.clip(frac, 0.0, 1.0) * (height - 10)))
            xs = x0 + (2 * c + j) * (bw + 1)
            if bh > 0:
                img[height - 4 - bh : height - 4, xs : xs + bw, :3] = col
    return img


def surround_image(
    rms_db: np.ndarray,
    peak_db: np.ndarray,
    correlation: np.ndarray | None = None,
    width: int | None = None,
    height: int = 120,
) -> np.ndarray:
    """Render the surround composite view -> [H, W, 4] RGBA.

    Mirrors gui/surmeter.c's capability (N channel bargraphs + the 4
    user-routable correlation needles) as a batch-friendly panel: one
    IEC-scale bargraph per channel (RMS bar, peak tick) over a row of
    correlation strips (marker position = (c+1)/2)."""
    rms_db = np.atleast_1d(np.asarray(rms_db, np.float64))
    peak_db = np.atleast_1d(np.asarray(peak_db, np.float64))
    nch = len(rms_db)
    width = width or max(18 * nch + 8, 80)
    img = np.zeros((height, width, 4), np.uint8)
    img[..., :3] = 24
    img[..., 3] = 255
    bar_h = height - 24
    bw = (width - 8) // nch - 2
    for c in range(nch):
        x0 = 4 + c * (bw + 2)
        frac = float(db.iec268_deflect(np.float32(rms_db[c])))
        bh = int(round(np.clip(frac, 0.0, 1.0) * bar_h))
        if bh > 0:
            img[bar_h - bh : bar_h, x0 : x0 + bw, :3] = (60, 200, 90)
        pf = float(db.iec268_deflect(np.float32(peak_db[c])))
        py = bar_h - int(round(np.clip(pf, 0.0, 1.0) * bar_h))
        if 0 <= py < bar_h:
            img[py, x0 : x0 + bw, :3] = (230, 230, 230)
    if correlation is not None:
        corr = np.atleast_1d(np.asarray(correlation, np.float64))
        npair = len(corr)
        sw = (width - 8) // max(npair, 1)
        for p in range(npair):
            x0 = 4 + p * sw
            y = height - 10
            img[y, x0 : x0 + sw - 4, :3] = 70
            mx = x0 + int(round(np.clip(0.5 + 0.5 * corr[p], 0, 1) * (sw - 5)))
            img[y - 2 : y + 3, mx : mx + 2, :3] = (230, 100, 40)
    return img


def goniometer_image(
    x: np.ndarray,
    y: np.ndarray,
    gain: float = 1.0,
    size: int = 200,
    persistence: float = 0.33,
) -> np.ndarray:
    """Render a goniometer (vectorscope) trace -> [size, size, 4] RGBA.

    Mirrors draw_rb's point plot (gui/goniometer.c:340-470): screen
    position = center - gain * (ax, ay) * radius, accumulated with additive
    intensity (the GUI's alpha build-up).  `persistence` scales the
    per-point alpha build-up like the GUI's persistence preference
    (gui/goniometer.c setting, persisted via LV2 State,
    src/goniometerlv2.c:210-293); 0.33 matches the prior fixed look.
    """
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 3] = 255
    c = size / 2.0
    rad = size * 0.45
    px = np.rint(c - gain * np.asarray(x, np.float64) * rad).astype(int)
    py = np.rint(c - gain * np.asarray(y, np.float64) * rad).astype(int)
    ok = (px >= 0) & (px < size) & (py >= 0) & (py < size)
    if ok.any():
        # additive green-yellow accumulation via a 2D histogram
        hist = np.zeros((size, size), np.int64)
        np.add.at(hist, (py[ok], px[ok]), 1)
        lvl = np.clip(
            (40.0 * persistence / 0.33) * np.log1p(hist), 0, 255
        ).astype(np.uint8)
        img[..., 0] = np.maximum(img[..., 0], (lvl * 0.88).astype(np.uint8))
        img[..., 1] = np.maximum(img[..., 1], (lvl * 0.88).astype(np.uint8))
        img[..., 2] = np.maximum(img[..., 2], (lvl * 0.15).astype(np.uint8))
    # axes
    img[int(c), :, :3] = np.maximum(img[int(c), :, :3], 50)
    img[:, int(c), :3] = np.maximum(img[:, int(c), :3], 50)
    return img


def phasewheel_image(
    phase: np.ndarray,
    level: np.ndarray,
    freq_per_bin: float,
    size: int = 200,
    floor_db: float = -60.0,
) -> np.ndarray:
    """Render the phase wheel -> [size, size, 4] RGBA.

    Mirrors plot_data_fft's polar mapping (gui/phasewheel.c:571-606):
    angle = inter-channel phase, radius = log-frequency, brightness =
    level (power, dB-scaled from floor).
    """
    phase = np.asarray(phase, np.float64)
    level = np.asarray(level, np.float64)
    nb = len(phase)
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 3] = 255
    c = size / 2.0
    freqs = np.maximum(np.arange(nb) * freq_per_bin, 1.0)
    rr = np.log10(freqs / 20.0) / np.log10(1000.0)  # 20 Hz .. 20 kHz
    rr = np.clip(rr, 0.0, 1.0) * (c - 2)
    with np.errstate(divide="ignore"):
        ldb = 10.0 * np.log10(np.maximum(level, 1e-30))
    bright = np.clip((ldb - floor_db) / (-floor_db), 0.0, 1.0)
    xs = np.rint(c + np.sin(phase) * rr).astype(int)
    ys = np.rint(c - np.cos(phase) * rr).astype(int)
    ok = (bright > 0) & (xs >= 0) & (xs < size) & (ys >= 0) & (ys < size)
    # max-composite BOTH channels: colliding bins on one pixel must keep
    # a consistent hue (fancy assignment alone is last-index-wins)
    g = (60 + 195 * bright[ok]).astype(np.uint8)
    np.maximum.at(img[..., 1], (ys[ok], xs[ok]), g)
    np.maximum.at(img[..., 0], (ys[ok], xs[ok]), (0.4 * g).astype(np.uint8))
    return img


def stereoscope_image(
    lr: np.ndarray,
    level: np.ndarray,
    size: int = 200,
    floor_db: float = -60.0,
) -> np.ndarray:
    """Render the stereoscope -> [size, size, 4] RGBA.

    Mirrors gui/stereoscope.c:325-437: x = left/right position (0..1),
    y = log-frequency (low at bottom), brightness = level.
    """
    lr = np.asarray(lr, np.float64)
    level = np.asarray(level, np.float64)
    nb = len(lr)
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 3] = 255
    yy = size - 1 - np.rint(
        np.clip(np.log10(np.maximum(np.arange(nb), 1) / 1.0)
                / np.log10(max(nb - 1, 2)), 0, 1) * (size - 1)
    ).astype(int)
    xs = np.rint(np.clip(lr, 0.0, 1.0) * (size - 1)).astype(int)
    with np.errstate(divide="ignore"):
        ldb = 10.0 * np.log10(np.maximum(level, 1e-30))
    bright = np.clip((ldb - floor_db) / (-floor_db), 0.0, 1.0)
    ok = bright > 0
    g = (60 + 195 * bright[ok]).astype(np.uint8)
    np.maximum.at(img[..., 1], (yy[ok], xs[ok]), g)
    np.maximum.at(img[..., 2], (yy[ok], xs[ok]), (0.5 * g).astype(np.uint8))
    # center (mono) line
    img[:, size // 2, :3] = np.maximum(img[:, size // 2, :3], 45)
    return img


def meter_view(
    name: str, o, fs: float, prefs: dict | None = None
) -> np.ndarray | None:
    """Render ONE meter's (unbatched) readout dict to its inline view.

    The single routing table from meter name -> view, shared by the batch
    CLI (--render-dir) and the live viewer — the analog of the reference's
    per-plugin inline-display dispatch (src/meters.cc queue_draw -> the
    dpy_* renderer each plugin registers).

    `prefs` carries the display-preference ports the reference GUIs
    persist (goniometer gain/autogain/persistence,
    src/goniometerlv2.c:210-293; phasewheel/stereoscope display floor,
    gui/phasewheel.c:1296-1342) — absent keys keep the defaults."""
    prefs = prefs or {}
    _needle_types = {
        "vu": db.MT_VU, "din": db.MT_DIN, "nor": db.MT_NOR,
        "bbc": db.MT_BBC, "ebu": db.MT_EBU,
    }
    _kranges = {"k12": 12.0, "k14": 14.0, "k20": 20.0}

    def _db(v):
        return 20.0 * np.log10(np.maximum(np.asarray(v, np.float64), 1e-10))

    if name == "r128":
        return radar_image(o["radar_m"], int(o["radar_pos"]))
    if name in _needle_types:
        if isinstance(o, dict):  # explicit key, not dict insertion order
            v = o.get("level", o.get("peak"))
            assert v is not None, f"needle readout keys: {list(o)}"
        else:
            v = o
        return needle_image(float(np.max(v)), _needle_types[name])
    if name == "bbcms":
        return needle_image(float(o["mid"]), db.MT_BM6)
    if name == "cor":
        v = o if not isinstance(o, dict) else o["correlation"]
        return cor_image(float(np.asarray(v)))
    if name in _kranges:
        rms_db = 20.0 * np.log10(max(float(np.max(o["rms"])), 1e-10))
        return bargraph_image(rms_db, _kranges[name])
    if name == "spectrum":
        return spectrum_image(o["bands"], o.get("peaks"))
    if name == "sigdist":
        return sigdist_image(o["hist"])
    if name == "bitmeter":
        return bitmeter_image(o["hit"], o["one"])
    if name == "truepeak":
        # dBTP digital bargraph + held-peak tick (src/dpy_bargraph.c)
        return surround_image(_db(o["level"]), _db(o["peak"]), None, width=80)
    if name in ("dr14", "tpnrms"):
        dr = float(o["dr_total"]) if "dr_total" in o else 21.0
        return dr14_image(dr, o["v_rms"], o["v_peak"])
    if name == "surround":
        return surround_image(_db(o["level"]), _db(o["peak"]), o["correlation"])
    if name == "goniometer":
        # autogain follows the computed gain; manual mode uses the gain
        # preference port (gui/goniometer.c:497-537 vs the g_gain dial)
        g = (float(o["gain"]) if prefs.get("autogain", 1.0)
             else float(prefs.get("gain", 1.0)))
        return goniometer_image(
            o["x"], o["y"], gain=g,
            persistence=float(prefs.get("persistence", 0.33)),
        )
    if name == "phasewheel":
        nb = o["phase"].shape[-1]
        return phasewheel_image(
            o["phase"][-1], o["level"][-1], fs / (2.0 * nb),
            floor_db=float(prefs.get("floor_db", -60.0)),
        )
    if name == "stereoscope":
        return stereoscope_image(
            o["lr"], o["level"],
            floor_db=float(prefs.get("floor_db", -60.0)),
        )
    return None
