"""truepeak_fused's share of its roofline in the batch cells: the least
time of an update's true-peak work (costs/truepeak_fused.py, one row a
channel of every stream of each true-peak meter, the block's 128-aligned
bulk) over the kernel's device time an update (profiler).  Moves xrt."""

UNIT = "%"
# meters whose update runs truepeak_fused on every channel of the stream
TRUE_PEAK_KINDS = ("dr14stereo", "TPnRMSstereo", "dBTPstereo")


def read(m):
    if m.loop != "batch":
        return None
    meters = sum(x["kind"] in TRUE_PEAK_KINDS for x in m.config["meters"].values())
    if not meters:
        return None
    T = m.traffic["block"] // 128 * 128
    rows = meters * m.traffic["batch"] * m.config["nchan"]
    flops, nbytes = m.cost("truepeak_fused").count(rows, T)
    return m.roofline("truepeak_fused_kernel", flops, nbytes, "update")
