"""Llama-3 8B  [arXiv:2407.21783] — dense GQA, 128k vocab."""
import dataclasses

from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="llama3-8b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=128256, act="swiglu", rope_theta=500000.0,
    )


def reduced() -> ArchConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
        head_dim=16, d_ff=256, vocab=512)
