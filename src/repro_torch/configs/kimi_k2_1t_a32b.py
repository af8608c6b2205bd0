"""Kimi K2 1T-A32B  [arXiv:2501.kimi2; paper-table] — trillion-parameter MoE:
384 routed experts top-8 (+1 shared), 61 layers, first layer dense."""
import dataclasses

from repro_torch.config import ArchConfig, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="kimi-k2-1t-a32b", family="moe",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=18432,  # dense-prefix FFN width
        vocab=163840, act="swiglu",
        moe=MoEConfig(n_experts=384, top_k=8, d_ff=2048, n_shared=1),
        dense_prefix_layers=1,
    )


def reduced() -> ArchConfig:
    return dataclasses.replace(
        config(), n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=192, vocab=512,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=64, n_shared=1))
