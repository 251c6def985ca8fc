"""Device busy ms an update in the batch cells: the union of device
operations over the traced programme, its read, copy and fresh state
spread over its updates.  Against the wall time an update takes (an
update's stream-seconds over xrt) it says how far the host holds the card
back.  Moves xrt."""

UNIT = "ms"


def read(m):
    if m.loop != "batch" or m.trace is None or not m.trace.device_ops:
        return None
    units = m.trace.count("update")
    return 1e3 * m.trace.busy_s / units if units else None
