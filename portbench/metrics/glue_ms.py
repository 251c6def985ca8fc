"""Device ms an update outside the port's named CUDA kernels (the L0
glue: PyTorch kernels, copies and fills), in the batch cells; the
programme's read, copy and fresh state spread over its updates.  Moves
xrt."""

UNIT = "ms"


def read(m):
    if m.loop != "batch" or m.trace is None:
        return None
    from portbench.trace import is_port_kernel

    units = m.trace.count("update")
    if not units or not m.trace.device_ops:
        return None
    glue = sum(d for n, _, d in m.trace.device_ops if not is_port_kernel(n))
    return glue * 1e-3 / units
