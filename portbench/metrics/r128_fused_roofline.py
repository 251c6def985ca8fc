"""r128_fused's share of its roofline in the batch cells: the least time
of an update's R128 work (costs/r128_fused.py, all streams at the block's
128-aligned bulk) over the kernel's device time an update (profiler).
Moves xrt."""

UNIT = "%"


def read(m):
    if m.loop != "batch":
        return None
    kinds = [x["kind"] for x in m.config["meters"].values()]
    if "EBUr128" not in kinds:
        return None
    T = m.traffic["block"] // 128 * 128
    flops, nbytes = m.cost("r128_fused").count(m.traffic["batch"], m.config["nchan"], T,
                                                m.config["fs"])
    return m.roofline("r128_fused_kernel", flops, nbytes, "update")
