"""``ops.swiglu(x, w_gate, w_up)``: x [..., d], the weights [d, f]; counted
by ``flops.swiglu_call``."""
import math

from portbench import flops

OP = "swiglu"
RANGE = "portbench::swiglu"
BACKWARD = True


def shape(x, w_gate, w_up, *args, **kwargs) -> tuple:
    """(tokens, d, f, bytes an element)."""
    return (math.prod(x.shape[:-1]), x.shape[-1], w_gate.shape[1], x.element_size())


def count(shape: tuple) -> dict:
    *dims, elem = shape
    return flops.swiglu_call(*dims, elem=elem)
