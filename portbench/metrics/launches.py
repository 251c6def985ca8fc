"""Device operations (kernels, copies, fills) an update in the batch
cells, from the profiler; the programme's read, copy and fresh state
spread over its updates.  A count that repeats exactly.  Moves xrt."""

UNIT = "count"


def read(m):
    if m.loop != "batch" or m.trace is None:
        return None
    units = m.trace.count("update")
    if not units or not m.trace.device_ops:
        return None
    return len(m.trace.device_ops) / units
