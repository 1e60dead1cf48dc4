"""Seconds from the process's start to the window's first step: imports, the
card, weights and batches, the kernels' libraries (built on a checkout's
first run), the probe call and the warm steps."""


def read(m):
    return m["setup_s"]
