"""Host ms a call of the system's update() in the batch cells, with the
device idle: the median of the harness's spans around the updates that a
``--trace 1`` run makes alone after its traced programme, each after a
synchronise outside its span (loops/batch.py, ``HOST_PROBE``), so that no
launch waits for room in the queue and the span holds the meters' and the
pipeline's own host time, not the device's.  Outside the profiler.  The
median, so that one pause of the interpreter among the calls does not
stand for them all.  Moves xrt."""

import statistics

UNIT = "ms"


def read(m):
    t = m.host.get("update.alone")
    if m.loop != "batch" or not t:
        return None
    return 1e3 * statistics.median(t)
