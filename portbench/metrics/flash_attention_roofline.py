"""flash_attention's share of its roofline over the traced steps: the least
time of every call, forward and backward, counted from its shapes
(``kernels/flash_attention.py``: ``flops.flash_call``, the larger of
operations over the bf16 peak and bytes over the memory bandwidth), over all
device time launched inside the port's ``ops.flash_attention`` calls and
their backward nodes, whatever kernels implement them, in percent."""
from portbench.kernels import roofline


def read(m):
    return roofline(m, "flash_attention")
