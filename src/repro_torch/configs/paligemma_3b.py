"""PaliGemma 3B  [arXiv:2407.07726; hf] — SigLIP vision tower (STUB:
``input_specs`` provides 256 precomputed patch embeddings) + gemma-2b-style
decoder with MQA (kv=1) and GeGLU."""
import dataclasses

from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="paligemma-3b", family="vlm",
        n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
        d_ff=16384, vocab=257216, act="geglu", rope_theta=10000.0,
        tie_embeddings=True, n_img_tokens=256,
    )


def reduced() -> ArchConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
        head_dim=16, d_ff=160, vocab=512, n_img_tokens=8)
