"""bitmeter_stats's share of its roofline in the batch cells: the least
time of an update's bit-meter work (costs/bitmeter_stats.py, one row a
stream, the whole block) over the kernel's device time an update
(profiler).  The peak table holds the float32 rate, which stands for the
integer rate here; the bound is the bytes either way.  Moves xrt."""

UNIT = "%"


def read(m):
    if m.loop != "batch":
        return None
    meters = sum(x["kind"] == "bitmeter" for x in m.config["meters"].values())
    if not meters:
        return None
    ops, nbytes = m.cost("bitmeter_stats").count(meters * m.traffic["batch"], m.traffic["block"])
    return m.roofline("bitmeter_stats_kernel", ops, nbytes, "update")
