"""Configuration system: architecture configs, input-shape sets, runtime knobs.

The port's own copy of the JAX package's configuration module (pure Python,
kept equal to it; ``tests/test_torch_model.py`` holds the two to the same
parameter counts and layer kinds).  ``tune``'s levers were chosen on the
TPU; none of them has been measured on the card.

Every assigned architecture has a module in ``repro_torch/configs`` exporting
``config()`` (the exact published numbers) and ``reduced()`` (a same-family
miniature for CPU smoke tests).  Shapes follow the assignment:

    train_4k     seq 4096,   global_batch 256   (training)
    prefill_32k  seq 32768,  global_batch 32    (inference prefill)
    decode_32k   seq 32768,  global_batch 128   (one-token decode w/ KV cache)
    long_500k    seq 524288, global_batch 1     (long-context decode;
                                                 sub-quadratic archs only)
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                 # per-expert FFN width
    n_shared: int = 0         # shared (always-on) experts
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None            # default d_model // n_heads
    act: str = "swiglu"                        # swiglu | geglu
    norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    tie_embeddings: bool = False
    qkv_bias: bool = False
    # MoE
    moe: Optional[MoEConfig] = None
    moe_every: int = 1                         # MoE layer cadence
    dense_prefix_layers: int = 0               # leading dense layers (dsv2/kimi)
    # MLA
    mla: Optional[MLAConfig] = None
    # hybrid (jamba): within each period, which positions are attention
    period: int = 1
    attn_positions: tuple[int, ...] = ()       # for hybrid families
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # rwkv6
    rwkv_head_dim: int = 64
    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 1500                        # audio frames after conv stub
    # vlm (paligemma)
    n_img_tokens: int = 0                      # SigLIP patch tokens (stub)
    # runtime knobs (hillclimbing targets)
    dtype: str = "bfloat16"
    remat: str = "full"                        # none | full | dots
    logits_fp32: bool = True
    attn_impl: str = "dense"                   # dense | chunked (flash-style)
    attn_chunk: int = 1024                     # kv-block for chunked attention
    # tp: TP+FSDP | fsdp: ZeRO only | ep: experts on "model", rest ZeRO
    parallel_style: str = "tp"
    scores_bf16: bool = False                  # bf16 attention scores

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.hd
        emb = V * D * (1 if self.tie_embeddings else 2)
        total = emb
        for li in range(L):
            kind = self.layer_kind(li)
            if kind == "attn" or kind == "mla":
                if self.mla:
                    m = self.mla
                    qd = m.nope_head_dim + m.rope_head_dim
                    attn = (D * m.q_lora_rank + m.q_lora_rank * self.n_heads * qd
                            + D * (m.kv_lora_rank + m.rope_head_dim)
                            + m.kv_lora_rank * self.n_heads *
                            (m.nope_head_dim + m.v_head_dim)
                            + self.n_heads * m.v_head_dim * D)
                else:
                    attn = D * self.n_heads * hd + 2 * D * self.n_kv_heads * hd \
                        + self.n_heads * hd * D
            elif kind == "mamba":
                di = self.mamba_expand * D
                attn = 2 * D * di + di * self.mamba_d_conv + \
                    di * (2 * self.mamba_d_state + di // 16 * 2) + di * D
            elif kind == "rwkv":
                attn = 5 * D * D + D * D  # time-mix projections + output
            else:
                attn = 0
            if kind == "rwkv":
                ff = 2 * D * self.d_ff + self.d_ff * D  # channel mix approx
            elif self.is_moe_layer(li):
                ff = (self.moe.n_experts + self.moe.n_shared) * 3 * D * self.moe.d_ff \
                    + D * self.moe.n_experts
            else:
                ff = 3 * D * F
            total += attn + ff
        if self.n_enc_layers:
            total += self.n_enc_layers * (4 * D * self.n_heads * hd + 3 * D * F)
            total += L * (4 * D * self.n_heads * hd)  # cross attention
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: routed top-k only)."""
        if not self.moe:
            return self.param_count()
        D = self.d_model
        total = self.vocab * D * (1 if self.tie_embeddings else 2)
        for li in range(self.n_layers):
            hd = self.hd
            attn = D * self.n_heads * hd + 2 * D * self.n_kv_heads * hd \
                + self.n_heads * hd * D
            if self.mla:
                m = self.mla
                qd = m.nope_head_dim + m.rope_head_dim
                attn = (D * m.q_lora_rank + m.q_lora_rank * self.n_heads * qd
                        + D * (m.kv_lora_rank + m.rope_head_dim)
                        + m.kv_lora_rank * self.n_heads *
                        (m.nope_head_dim + m.v_head_dim)
                        + self.n_heads * m.v_head_dim * D)
            if self.is_moe_layer(li):
                ff = (self.moe.top_k + self.moe.n_shared) * 3 * D * self.moe.d_ff
            else:
                ff = 3 * D * self.d_ff
            total += attn + ff
        return total

    def layer_kind(self, li: int) -> str:
        if self.family == "ssm":
            return "rwkv"
        if self.family == "hybrid":
            return "attn" if (li % self.period) in self.attn_positions else "mamba"
        if self.mla:
            return "mla"
        return "attn"

    def is_moe_layer(self, li: int) -> bool:
        if self.moe is None or li < self.dense_prefix_layers:
            return False
        return (li % self.moe_every) == 0 if self.moe_every > 1 else True

    @property
    def subquadratic(self) -> bool:
        """Can this arch run 500k-token decode?  (SSM / mostly-SSM hybrid.)"""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have an autoregressive decoder


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}

ARCH_IDS = [
    "rwkv6_3b", "llama3_405b", "gemma_7b", "llama3_8b", "command_r_35b",
    "jamba_1_5_large_398b", "deepseek_v2_236b", "kimi_k2_1t_a32b",
    "whisper_small", "paligemma_3b",
]


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("skip: pure full-attention architecture — 524288-token "
                       "quadratic attention is out of scope (DESIGN.md)")
    return True, ""


def get_config(arch_id: str, reduced: bool = False,
               tuned: bool = False) -> ArchConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    cfg = mod.reduced() if reduced else mod.config()
    return tune(cfg) if tuned else cfg


def tune(cfg: ArchConfig, shape: "ShapeConfig" = None,
         n_chips: int = 256) -> ArchConfig:
    """Apply the §Perf-confirmed levers (EXPERIMENTS.md):
      * remat=dots (confirmed on every hillclimbed cell: -20% compute),
      * bf16 attention scores with fp32 row stats,
      * ZeRO-only sharding when (a) the optimizer state fits a 256-chip pod
        (params + 2 moments bf16 <= ~13 GB/chip), (b) the model is dense
        (expert tensors do not divide across all axes), and (c) the global
        batch actually divides the full chip count — pure DP with an
        unshardable batch replicates work (measured 14x regression on
        prefill_32k, §Perf).  Confirmed 5.0x on rwkv6-3b and 1.4x on
        llama3-405b train."""
    per_chip = 3 * 2 * cfg.param_count() / n_chips / 1e9  # GB, bf16 p+m+v
    batch_ok = shape is None or shape.global_batch % n_chips == 0
    style = "fsdp" if (cfg.moe is None and per_chip <= 13.0 and batch_ok) \
        else "tp"
    return dataclasses.replace(cfg, remat="dots", scores_bf16=True,
                               parallel_style=style)


def all_cells():
    """All (arch, shape) dry-run cells with applicability flags."""
    for aid in ARCH_IDS:
        cfg = get_config(aid)
        for sname, shape in SHAPES.items():
            ok, why = shape_applicable(cfg, shape)
            yield aid, sname, ok, why
