"""AdamW's share of its roofline over the traced steps: the least time of
every ``ops.adamw_`` call, its bytes over the memory bandwidth
(``kernels/adamw.py``: 30 B an element updated, the fp32 gradient, master,
m and v read, master, m, v and the bf16 parameter written), over all device
time launched inside the calls (``csrc/adamw.cu``, one launch a worker and
step), in percent.  A call has no backward."""
from portbench.kernels import roofline


def read(m):
    return roofline(m, "adamw")
