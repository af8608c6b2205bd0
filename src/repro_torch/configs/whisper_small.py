"""Whisper small  [arXiv:2212.04356] — encoder-decoder, 12+12 layers,
d_model=768.  The conv audio frontend is a STUB per the assignment:
``input_specs`` provides precomputed frame embeddings (batch, 1500, d)."""
import dataclasses

from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-small", family="encdec",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
        d_ff=3072, vocab=51865, act="gelu",
        n_enc_layers=12, enc_seq=1500,
    )


def reduced() -> ArchConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab=512, n_enc_layers=2, enc_seq=16)
