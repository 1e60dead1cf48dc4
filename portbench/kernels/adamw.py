"""``ops.adamw_(opt, grad, state, param, table, step=...)``: one AdamW step
of a stage worker's leaves, in place over its flat fp32 state
(``csrc/adamw.cu``), one call a worker and step.

A call updates the leaf table's gradient elements (the state's padding
between leaves is not counted).  Each element reads the fp32 gradient,
master, m and v and writes master, m and v, and writes the parameter where
``param`` is given (bf16): 30 B an element, 28 B without ``param``.  Its
dozen fp32 operations an element are not counted: on the CUDA cores (67
TFLOP/s) they take under a tenth of the bytes' time, so the bound is the
bytes'.  No autograd node is made."""
from portbench import flops

OP = "adamw_"
RANGE = "portbench::adamw"
BACKWARD = False


def shape(opt, grad, state, param, table, *args, **kwargs) -> tuple:
    """(elements updated, bytes an element of the parameter written, 0
    without one)."""
    return (sum(n for *_, n in table.rows), 0 if param is None else param.element_size())


def count(shape: tuple) -> dict:
    n, param_bytes = shape
    return {"fwd_ops": 0.0, "bwd_ops": 0.0,
            "fwd_bytes": float(n * (7 * flops.FP32 + param_bytes)), "bwd_bytes": 0.0}
