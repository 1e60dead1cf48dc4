"""``torch.cuda.max_memory_allocated`` from the window's first step to its
last, read before the comparison with the reference, in GB."""


def read(m):
    return m["peak_bytes"] / 1e9
