"""Device milliseconds a traced step in PyTorch's elementwise kernels (the
stage workers' AdamW passes, casts and gradient accumulation), from the
profiler's kernel names."""


def read(m):
    t = m.get("trace")
    if not t or not t["steps"] or not t["busy_s"]:
        return None
    return 1e3 * t["elementwise_s"] / t["steps"]
