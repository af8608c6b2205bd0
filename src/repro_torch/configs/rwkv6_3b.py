"""RWKV-6 "Finch" 3B  [arXiv:2404.05892; hf] — attention-free, data-dependent
decay; 32L d_model=2560, vocab 65536."""
import dataclasses

from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-3b", family="ssm",
        n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
        rwkv_head_dim=64, d_ff=8960, vocab=65536, act="rwkv",
    )


def reduced() -> ArchConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
        rwkv_head_dim=64, d_ff=256, vocab=512)
