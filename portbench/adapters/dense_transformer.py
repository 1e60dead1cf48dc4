"""The dense transformer family in the port: the configuration file's sizes
as the port's ``ArchConfig``, and the kernel launches a micro-batch makes.

What the harness reads of a family's adapter: ``arch_config`` and
``expected_launches``."""
from __future__ import annotations

import dataclasses


def arch_config(cfg: dict):
    from repro_torch.configs import get_config

    base = get_config(cfg["port_arch"])
    plain = all(s.mixer == "attn" and s.ff == "dense" and s.window == 0 for s in base.period)
    if not plain or base.qk_norm or base.frontend != "none":
        raise ValueError(f"{cfg['port_arch']} is not a plain dense transformer in the port")
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    encoder = cfg["objective"] == "same_token"
    return dataclasses.replace(
        base,
        n_layers=cfg["num_hidden_layers"], d_model=d, n_heads=H,
        n_kv_heads=cfg.get("num_key_value_heads", H), head_dim=cfg.get("head_dim", d // H),
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        rope_theta=cfg["rope_theta"],
        norm_eps=cfg.get("rms_norm_eps", cfg.get("layer_norm_eps")),
        causal=cfg["causal"], is_encoder=encoder, tie_embeddings=cfg["tie_word_embeddings"],
        qkv_bias=cfg.get("attention_bias", False), param_dtype=cfg["param_dtype"])


def expected_launches(arch, traffic: dict) -> dict:
    """{kernel: forward calls a micro-batch and replica}: every layer's
    attention through flash attention and its FFN through swiglu (each with
    one backward call)."""
    return {"flash_attention": arch.n_layers, "swiglu": arch.n_layers}
