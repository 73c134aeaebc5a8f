"""Training data pipeline: token streams → batches (numpy only).

An own copy of ``elastic_gpu_scheduler_tpu/models/data.py`` (the port
imports nothing of the JAX package, not even its jax-free modules).  For
the same seed the batch streams are byte-identical to the reference's
(tests/test_torch_train.py).

Two sources:
- ``MemmapTokenDataset``: a flat binary file of token ids (np.uint16/uint32
  memmap) — zero-copy random windows, the standard LM pretraining layout;
- ``SyntheticTokenDataset``: a deterministic synthetic language (repeated
  motifs + noise) so convergence tests have real signal without any files.

Batches are sharded for multi-process data parallelism: each process
takes its ``process_index``-th slice of the global batch, so the same
global batch order is seen regardless of process count.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np


class MemmapTokenDataset:
    def __init__(self, path: str, dtype: str = "uint16"):
        self.path = path
        self.tokens = np.memmap(path, dtype=np.dtype(dtype), mode="r")
        if len(self.tokens) == 0:
            raise ValueError(f"{path}: empty token file")

    def __len__(self) -> int:
        return len(self.tokens)

    def window(self, start: int, length: int) -> np.ndarray:
        """A contiguous `length`-token window; `start` is taken modulo the
        valid range so any 64-bit start is usable."""
        if len(self.tokens) < length:
            raise ValueError(
                f"{self.path}: {len(self.tokens)} tokens < window {length}"
            )
        # valid start positions are 0..len-length INCLUSIVE
        valid = len(self.tokens) - length + 1
        start = int(start) % valid
        return np.asarray(self.tokens[start : start + length], dtype=np.int32)


class SyntheticTokenDataset:
    """Motif language: sequences stitched from a fixed motif bank + noise.

    Predictable structure (motifs repeat) gives a learnable signal; the
    noise rate bounds the achievable loss above zero.
    """

    def __init__(
        self, vocab_size: int, seed: int = 0, n_motifs: int = 32,
        motif_len: int = 8, noise: float = 0.1,
    ):
        rng = np.random.default_rng(seed)
        self.vocab_size = vocab_size
        self.noise = noise
        self.motifs = rng.integers(
            0, vocab_size, size=(n_motifs, motif_len), dtype=np.int64
        )

    def sample(self, rng: np.random.Generator, length: int) -> np.ndarray:
        out = []
        while sum(len(m) for m in out) < length:
            out.append(self.motifs[rng.integers(0, len(self.motifs))])
        seq = np.concatenate(out)[:length]
        noise_mask = rng.random(length) < self.noise
        seq = np.where(
            noise_mask, rng.integers(0, self.vocab_size, size=length), seq
        )
        return seq.astype(np.int32)


def batches(
    source,
    batch_size: int,
    seq_len: int,
    seed: int = 0,
    process_index: int = 0,
    process_count: int = 1,
    max_batches: Optional[int] = None,
    start_batch: int = 0,
) -> Iterator[np.ndarray]:
    """Yields (local_batch, seq_len+1) int32 arrays (inputs+shift target).

    ``batch_size`` is the GLOBAL batch; each process yields its slice.
    Each batch index gets its own RNG derived from (seed, index), so
    ``start_batch`` fast-forwards a resumed run in O(1) — no arrays are
    built for skipped batches — while the stream stays identical.
    """
    if batch_size % process_count:
        raise ValueError(
            f"global batch {batch_size} not divisible by {process_count} processes"
        )
    local = batch_size // process_count
    i = start_batch
    while max_batches is None or i < start_batch + max_batches:
        rng = np.random.default_rng([seed, i])
        rows = []
        for b in range(batch_size):
            if isinstance(source, MemmapTokenDataset):
                row = source.window(rng.integers(0, 1 << 62), seq_len + 1)
            else:
                row = source.sample(rng, seq_len + 1)
            rows.append(row)
        global_batch = np.stack(rows)
        start = process_index * local
        yield global_batch[start : start + local]
        i += 1


def write_token_file(path: str, tokens: np.ndarray, dtype: str = "uint16") -> None:
    np.asarray(tokens, dtype=np.dtype(dtype)).tofile(path)
