"""flash_attention's share of its roofline over the traced steps: the least time of
every call, forward and backward, counted from its shapes
(``flops.flash_attention_call``, the larger of operations over the bf16 peak and
bytes over the memory bandwidth), over all device time launched inside the
port's ``ops.flash_attention`` calls and their backward nodes, whatever kernels
implement them, in percent."""


def read(m):
    t = m.get("trace")
    if not t:
        return None
    r = t["ranges"]["flash_attention"]
    # every call needs its backward matched, or the device time is short
    if not r["calls"] or r["backward_nodes"] < r["calls"] or not r["device_s"] \
            or not r["least_s"]:
        return None
    return 100.0 * r["least_s"] / r["device_s"]
