"""LM training data pipeline: tokenized corpus → per-process sharded batches.

The reference moves its (image) dataset to workers over SDFS before
inference (`README.md:37-38`); the LM-training analogue stores the tokenized
corpus in the replicated file layer (`idunno_tpu.store`), and every training
process loads it once and draws its OWN disjoint shard of each epoch —
deterministic from (seed, epoch), so data parallelism across
`jax.distributed` processes needs no coordination traffic at all.

TPU-first shape discipline: every batch is exactly [batch, seq_len + 1]
int32 (inputs = [:, :-1], targets = [:, 1:] — or feed the full block to
`train_lm`'s roll-based loss); the ragged tail of an epoch is dropped so
jit never sees a new shape.

(Copied from ``idunno_tpu/engine/data_lm.py``, numpy only. ``save_corpus``
and ``load_corpus`` wait for the port of the replicated store.)
"""
from __future__ import annotations

from collections.abc import Iterator

import numpy as np

_DTYPE = np.int32


class TokenDataset:
    """Fixed-length block sampler over a token stream.

    Blocks are the ``n // (seq_len+1)`` non-overlapping windows; each epoch
    visits every block exactly once in a seeded shuffle, partitioned
    round-robin across processes (process p takes blocks p, p+P, p+2P, ...
    of the permutation — equal counts, disjoint, union = epoch).
    """

    def __init__(self, tokens: np.ndarray, seq_len: int, *,
                 seed: int = 0) -> None:
        self.tokens = np.ascontiguousarray(tokens, dtype=_DTYPE)
        self.seq_len = seq_len
        self.seed = seed
        self.block = seq_len + 1
        self.n_blocks = len(self.tokens) // self.block
        if self.n_blocks == 0:
            raise ValueError(f"corpus of {len(self.tokens)} tokens is "
                             f"shorter than one {self.block}-token block")

    def epoch_blocks(self, epoch: int, *, process_index: int = 0,
                     process_count: int = 1) -> np.ndarray:
        """This process's block indices for ``epoch`` (deterministic).
        The permutation is truncated to a multiple of process_count so every
        process gets the SAME shard length — unequal lengths would leave one
        process alone inside a collective-bearing train step (SPMD hang)."""
        rng = np.random.default_rng((self.seed, epoch))
        perm = rng.permutation(self.n_blocks)
        usable = self.n_blocks - self.n_blocks % process_count
        return perm[:usable][process_index::process_count]

    def batches(self, batch_size: int, epoch: int = 0, *,
                process_index: int = 0,
                process_count: int = 1) -> Iterator[np.ndarray]:
        """Yield [batch_size, seq_len+1] int32 arrays; ragged tail dropped
        (static shapes for jit)."""
        idx = self.epoch_blocks(epoch, process_index=process_index,
                                process_count=process_count)
        view = self.tokens[:self.n_blocks * self.block].reshape(
            self.n_blocks, self.block)
        for i in range(0, len(idx) - batch_size + 1, batch_size):
            yield view[idx[i:i + batch_size]]
