"""The share of a step with no kernel, copy or fill on the card, in percent:
the device's busy seconds a step in the device-traced steps (the union of
the profiler's device intervals) over the untraced window's seconds a step.
Device tracing slows a host-bound step (a third for phi3, more for bert), so
the traced steps' own wall time would read the idle share high."""


def read(m):
    t = m.get("trace")
    if not t or not t["busy_s"] or not t["steps"]:
        return None
    w = m["window"]
    return 100.0 * (1.0 - (t["busy_s"] / t["steps"]) / (w["seconds"] / w["steps"]))
