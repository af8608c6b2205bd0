"""Gemma 7B  [arXiv:2403.08295; hf] — GeGLU, head_dim=256, kv=16."""
import dataclasses

from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="gemma-7b", family="dense",
        n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
        d_ff=24576, vocab=256000, act="geglu", rope_theta=10000.0,
        tie_embeddings=True,
    )


def reduced() -> ArchConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=32, d_ff=192, vocab=512)
