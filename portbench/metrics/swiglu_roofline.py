"""swiglu's share of its roofline over the traced steps: the least time of
every call, forward and backward, counted from its shapes
(``kernels/swiglu.py``: ``flops.swiglu_call``, the larger of operations over
the bf16 peak and bytes over the memory bandwidth), over all device time
launched inside the port's ``ops.swiglu`` calls and their backward nodes,
whatever kernels implement them, in percent."""
from portbench.kernels import roofline


def read(m):
    return roofline(m, "swiglu")
