"""Machine-readable meter schemas — the equivalent of the reference's TTL
port metadata (lv2ttl/meters.lv2.ttl.in: ranges, defaults, units per port)
and the generated port tables (lv2ttl/*.h).

Used by the CLI for validation/pretty-printing and by hosts embedding the
framework to discover readout semantics without instantiating meters.

A copy of ``meters_lv2_tpu/models/schema.py`` (numpy- and jax-free), kept
in the port so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Control:
    name: str
    unit: str
    lo: float | None = None
    hi: float | None = None
    default: float | None = None
    doc: str = ""


@dataclasses.dataclass(frozen=True)
class MeterSchema:
    uri_suffix: str
    channels: tuple[int, ...]  # supported channel counts
    inputs: tuple[Control, ...]  # runtime controls (former control-in ports)
    outputs: tuple[Control, ...]  # readout keys (former control-out/atoms)


REF_LEVEL = Control("ref_level_db", "dB", -30.0, 0.0, -22.0,
                    "reference level; gain = 10^(0.05*(refl+18))")

SCHEMAS: dict[str, MeterSchema] = {}


def _add(s: MeterSchema):
    SCHEMAS[s.uri_suffix] = s


for _name in ("VU", "DIN", "NOR", "BBC", "EBU"):
    _add(MeterSchema(
        uri_suffix=_name,
        channels=(1, 2),
        inputs=(REF_LEVEL,),
        outputs=(Control("level", "linear", 0.0, None, doc="needle value"),),
    ))

_add(MeterSchema(
    "BBCM6", (2,),
    (REF_LEVEL, Control("s20", "bool", 0, 1, 0, "side gain +14 dB mode")),
    (Control("mid", "linear"), Control("side", "linear")),
))
_add(MeterSchema(
    "COR", (2,), (),
    (Control("correlation", "", -1.0, 1.0),),
))
_add(MeterSchema(
    "dBTP", (1, 2), (),
    (Control("level", "linear", 0, None, doc="ballistic true-peak level"),
     Control("peak", "linear", 0, None, doc="held oversampled |peak|")),
))
for _k in ("K12", "K14", "K20"):
    _add(MeterSchema(
        _k, (1, 2), (),
        (Control("rms", "linear"), Control("peak", "linear")),
    ))
_add(MeterSchema(
    "EBUr128", (1, 2, 5),
    (Control("integrating", "bool", 0, 1, 1),
     Control("radar_seconds", "s", 30.0, 14400.0, 120.0,
             "runtime-mutable with runtime_radar_speed=True "
             "(set_radar_speed, CTL_RADARTIME analog)"),
     Control("cadence_500ms", "bool", 0, 1, 0,
             "read() arg: I/LRA as the reference's 500 ms cached values "
             "(requires track_cadence=True)")),
    (Control("loudness_M", "LUFS", -200.0, 0.0),
     Control("loudness_S", "LUFS", -200.0, 0.0),
     Control("max_M", "LUFS"), Control("max_S", "LUFS"),
     Control("integrated", "LUFS"), Control("integ_thr", "LUFS"),
     Control("range_min", "LUFS"), Control("range_max", "LUFS"),
     Control("range_thr", "LUFS"), Control("lra", "LU"),
     Control("dbtp", "linear"), Control("integ_time_s", "s"),
     Control("radar_m", "LUFS[360]"), Control("radar_s", "LUFS[360]"),
     Control("radar_pos", "index")),
))
_add(MeterSchema(
    "spectr30", (1, 2),
    (Control("speed", "s", 0.01, 15.0, 1.0,
             "display time constant; runtime-mutable via set_speed(state, "
             "v) — no recompile"),),
    (Control("bands", "dB[30]", -100.0, None),
     Control("peaks", "dB[30]", -100.0, None)),
))
_add(MeterSchema(
    "dr14", (1, 2), (),
    (Control("v_rms", "dB"), Control("v_peak", "dB"),
     Control("m_rms", "dB"), Control("m_peak", "dBTP"),
     Control("dr", "DR", 1.0, 21.0), Control("dr_total", "DR", 1.0, 21.0),
     Control("block_count", "s")),
))
_add(MeterSchema(
    "TPnRMS", (1, 2), (),
    (Control("v_rms", "dB"), Control("v_peak", "dB"),
     Control("m_rms", "dB"), Control("m_peak", "dBTP")),
))
_add(MeterSchema(
    "SigDistHist", (1,),
    (Control("integrating", "bool", 0, 1, 1),),
    (Control("hist", "count[361]"), Control("hist_max", "count"),
     Control("hist_peak_bin", "index"), Control("hist_avg", "sum"),
     Control("hist_var", "M2"), Control("integration_time", "samples"),
     Control("mean", ""), Control("variance", "")),
))
_add(MeterSchema(
    "bitmeter", (1,),
    (Control("averaging", "bool", 0, 1, 1),),
    (Control("hit", "count[280]"), Control("one", "count[280]"),
     Control("dset", "count[23]"), Control("nan", "count"),
     Control("inf", "count"), Control("den", "count"),
     Control("zero", "count"), Control("pos", "count"),
     Control("min", "linear"), Control("max", "linear"),
     Control("integration_time", "samples")),
))
_add(MeterSchema(
    "goniometer", (2,),
    (Control("oversample", "x", 1, 8, 4),
     Control("autogain_attack", "", 0, 100, 54.0),
     Control("autogain_decay", "", 0, 100, 58.0),
     Control("autogain_rms", "%", 0, 100, 50.0),
     Control("autogain_target", "", 0, 100, 40.0)),
    (Control("x", "trace"), Control("y", "trace"), Control("gain", "")),
))
_add(MeterSchema(
    "phasewheel", (2,),
    (Control("bins", "", 64, 8192, 4096),
     Control("fps", "Hz", 1, 60, 25.0),
     Control("db_thresh_db", "dB", -120.0, 0.0, -60.0)),
    (Control("phase", "rad[bins]"), Control("level", "power[bins]"),
     Control("peak", "power"), Control("correlation", "", -1, 1)),
))
_add(MeterSchema(
    "stereoscope", (2,),
    (Control("bins", "", 64, 8192, 4096), Control("fps", "Hz", 1, 60, 25.0)),
    (Control("lr", "position[bins]", 0.0, 1.0),
     Control("level", "power[bins]")),
))
for _n in range(3, 9):
    _add(MeterSchema(
        f"surround{_n}", (_n,),
        (Control("pairs", "channel pairs", doc="correlator routing"),),
        (Control("level", f"linear[{_n}]"), Control("peak", f"linear[{_n}]"),
         Control("correlation", f"[{4 if _n > 3 else 3}]", -1.0, 1.0)),
    ))


def schema_for(uri_suffix: str) -> MeterSchema:
    key = uri_suffix
    for suffix in ("mono", "stereo"):
        if key.endswith(suffix):
            key = key[: -len(suffix)]
    return SCHEMAS[key]
