"""``ops.flash_attention(q, k, v, causal=...)``: q [B, S, H, hd], k and v
[B, S, Hkv, hd]; counted by ``flops.flash_call``."""
from portbench import flops

OP = "flash_attention"
RANGE = "portbench::flash_attention"
BACKWARD = True


def shape(q, k, v, *args, **kwargs) -> tuple:
    """(B, S, H, Hkv, hd, causal, bytes an element)."""
    return (q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3],
            bool(kwargs.get("causal", True)), q.element_size())


def count(shape: tuple) -> dict:
    *dims, elem = shape
    return flops.flash_call(*dims, elem=elem)
