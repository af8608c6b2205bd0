"""Jamba-1.5 Large 398B  [arXiv:2403.19887; hf] — hybrid Mamba/attention at a
1:7 ratio (one attention layer per 8-layer period, at position 4), MoE
(16 experts, top-2) on every other layer."""
import dataclasses

from repro_torch.config import ArchConfig, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=24576, vocab=65536, act="swiglu",
        period=8, attn_positions=(4,),
        moe=MoEConfig(n_experts=16, top_k=2, d_ff=24576), moe_every=2,
        mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    )


def reduced() -> ArchConfig:
    return dataclasses.replace(
        config(), n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=512,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=128))
