"""The device's idle share in the batch cells: the traced stretch (one
programme) less the union of its device operations, over the stretch.
Moves xrt."""

UNIT = "%"


def read(m):
    if m.loop != "batch" or m.trace is None or m.trace.window_s <= 0 or not m.trace.device_ops:
        return None
    return 100.0 * (1.0 - m.trace.busy_s / m.trace.window_s)
