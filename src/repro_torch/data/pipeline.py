"""Deterministic synthetic LM data pipeline (the port's copy of
``repro.data.pipeline``: numpy only, so its batches are bitwise the
reference's for any seed, step and host).

Design goals for the multi-pod setting:
  * deterministic per (seed, step, host): every host can regenerate its shard
    after a restart without coordination (fault tolerance),
  * cheap on-host generation with double-buffered prefetch,
  * sequence packing of variable-length "documents" into fixed (B, S) blocks
    with an EOS-delimited structure, so the loss mask is non-trivial.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass
class SyntheticLMData:
    vocab: int
    seq_len: int
    batch: int                   # per-host batch
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    eos: int = 1

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Markov-ish token stream packed into (batch, seq_len) blocks."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.host_id)
        B, S, V = self.batch, self.seq_len, self.vocab
        # documents of random length packed back-to-back with EOS separators
        toks = rng.integers(2, V, size=(B, S), dtype=np.int64)
        # correlate neighbours so a model can actually learn something
        toks[:, 1:] = np.where(rng.random((B, S - 1)) < 0.5,
                               toks[:, :-1], toks[:, 1:])
        doc_ends = rng.random((B, S)) < (1.0 / 97)
        toks = np.where(doc_ends, self.eos, toks)
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = self.eos
        mask = np.ones((B, S), np.float32)
        return {"tokens": toks.astype(np.int32),
                "labels": labels.astype(np.int32),
                "mask": mask}


@dataclass
class SyntheticStubData:
    """``SyntheticLMData``'s batches with the stub input of a model's
    modality frontend, which the trainer's batches of an encoder-decoder
    or a VLM must hold: ``frames`` (B, enc_seq, D), or ``patches`` (B,
    n_img_tokens, D) with the tokens the text positions alone (``seq_len``
    less the image tokens), N(0, 1) in f32 from a generator seeded by
    (seed, step).  The reference's trainer has no such batches."""
    cfg: object                  # an ArchConfig, family "encdec" or "vlm"
    seq_len: int
    batch: int
    seed: int = 0

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        vlm = cfg.family == "vlm"
        out = SyntheticLMData(
            vocab=cfg.vocab, seq_len=self.seq_len - vlm * cfg.n_img_tokens,
            batch=self.batch, seed=self.seed).batch_at(step)
        rng = np.random.default_rng((self.seed, step))
        key, rows = ("patches", cfg.n_img_tokens) if vlm else \
            ("frames", cfg.enc_seq)
        out[key] = rng.standard_normal(
            (self.batch, rows, cfg.d_model)).astype(np.float32)
        return out


def train_data(cfg, seq_len: int, batch: int, seed: int = 0):
    """The trainer's batches for ``cfg``: ``SyntheticLMData``'s, with the
    modality stub an encoder-decoder or a VLM reads
    (``SyntheticStubData``)."""
    if cfg.family in ("encdec", "vlm"):
        return SyntheticStubData(cfg, seq_len, batch, seed)
    return SyntheticLMData(vocab=cfg.vocab, seq_len=seq_len, batch=batch,
                           seed=seed)


def make_train_iterator(ds: SyntheticLMData, start_step: int = 0,
                        prefetch: int = 2):
    """Background-thread prefetching iterator, resumable at any step."""
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            item = (step, ds.batch_at(step))
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    class _It:
        def __iter__(self):
            return self

        def __next__(self):
            return q.get()

        def close(self):
            """Stop the prefetch thread and wait for it (it checks every
            0.1 s)."""
            stop.set()
            t.join()

    return _It()
