"""Synthetic data pipeline: Zipf-distributed CTR queries + LM token streams.

Deterministic per (seed, step) so a restarted trainer resumes on the exact
batch sequence (required for the bitwise checkpoint-resume test). Generation
is host-side numpy; the trainer moves each batch to the device.

A copy of ``repro.data.synthetic``: the same ``(seed, step)`` gives the same
batch bit for bit (``tests/test_torch_trainer.py``).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.core.locality import zipf_indices
from repro_torch.models.dlrm import DLRMArch


def make_dlrm_batch(arch: DLRMArch, batch: int, *, seed: int, step: int,
                    alpha: float = 1.2) -> dict:
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    idx = np.stack([
        zipf_indices(rng, rows, alpha, batch * arch.pooling).reshape(batch, arch.pooling)
        for rows in arch.all_tables])                       # [T, B, P]
    dense = rng.standard_normal((batch, arch.num_dense)).astype(np.float32)
    # labels from a FIXED (per-seed) teacher so the task is learnable
    wrng = np.random.default_rng(np.random.SeedSequence([seed, 991]))
    w = wrng.standard_normal(arch.num_dense).astype(np.float32) / np.sqrt(arch.num_dense)
    labels = (dense @ w * 3.0 + 0.1 * rng.standard_normal(batch) > 0).astype(np.int32)
    return {"dense": dense, "indices": idx.astype(np.int32), "labels": labels}


def dlrm_batch_stream(arch: DLRMArch, batch: int, *, seed: int = 0,
                      start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield make_dlrm_batch(arch, batch, seed=seed, step=step)
        step += 1


def make_lm_batch(vocab: int, batch: int, seq: int, *, seed: int, step: int,
                  zipf_alpha: float = 1.1) -> dict:
    """Token stream with Zipfian unigram stats (a realistic long tail) and a
    next-token structure."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    toks = zipf_indices(rng, vocab, zipf_alpha, batch * (seq + 1)).reshape(batch, seq + 1)
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def lm_batch_stream(vocab: int, batch: int, seq: int, *, seed: int = 0,
                    start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield make_lm_batch(vocab, batch, seq, seed=seed, step=step)
        step += 1
