"""Device milliseconds a step in which a kernel, copy or fill ran (the
union of the profiler's device intervals over the device-traced steps), in
the cells whose step the shared host paces: the card's own share of the
step, which the host's speed leaves steady."""


def read(m):
    t = m.get("trace")
    if not t or not t["busy_s"] or not t["steps"]:
        return None
    return 1e3 * t["busy_s"] / t["steps"]
