"""Command-R 35B  [hf:CohereForAI/c4ai-command-r-v01] — GQA, no biases."""
import dataclasses

from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="command-r-35b", family="dense",
        n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=22528, vocab=256000, act="swiglu", rope_theta=8000000.0,
        tie_embeddings=True,
    )


def reduced() -> ArchConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
        head_dim=16, d_ff=256, vocab=512)
