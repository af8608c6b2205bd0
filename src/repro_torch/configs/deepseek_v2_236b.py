"""DeepSeek-V2 236B  [arXiv:2405.04434; hf] — MLA (kv_lora=512) + MoE with
2 shared + 160 routed experts, top-6; first layer dense."""
import dataclasses

from repro_torch.config import ArchConfig, MLAConfig, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-236b", family="moe",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
        d_ff=12288,  # dense-prefix FFN width
        vocab=102400, act="swiglu",
        moe=MoEConfig(n_experts=160, top_k=6, d_ff=1536, n_shared=2),
        dense_prefix_layers=1,
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
                      nope_head_dim=128, v_head_dim=128),
    )


def reduced() -> ArchConfig:
    return dataclasses.replace(
        config(), n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=160, vocab=512,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=64, n_shared=1),
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=8,
                      nope_head_dim=16, v_head_dim=16))
