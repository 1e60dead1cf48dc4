"""The whole step's share of the card's dense bf16 peak: the model FLOPs of
the window's steps (``flops.step_flops``) over the window's seconds times
the peak (``peaks.json``), in percent."""


def read(m):
    if not m.get("peak"):
        return None
    w = m["window"]
    return 100.0 * w["flops_per_step"] * w["steps"] / (w["seconds"] * m["peak"]["bf16_flops"])
