"""Llama-3 405B  [arXiv:2407.21783] — dense GQA, 128k vocab."""
import dataclasses

from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="llama3-405b", family="dense",
        n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, head_dim=128,
        d_ff=53248, vocab=128256, act="swiglu", rope_theta=500000.0,
    )


def reduced() -> ArchConfig:
    return dataclasses.replace(
        config(), n_layers=3, d_model=128, n_heads=8, n_kv_heads=2,
        head_dim=16, d_ff=352, vocab=512)
