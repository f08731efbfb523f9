"""Deterministic synthetic LM token pipeline, sharded per host (a copy of
``repro.data.tokens``, numpy only).

A first-order Markov source over a zipf-ish unigram distribution: learnable
structure (bigram statistics) so small-model training loss demonstrably
drops below the unigram entropy floor.  Deterministic in
(seed, host_id, step) -- restarting from a checkpoint replays the exact
stream, which the restart tests rely on; the batches are the
reference's bit for bit.
"""

from __future__ import annotations

import numpy as np


class TokenDataset:
    def __init__(
        self,
        vocab_size: int,
        seq_len: int,
        batch: int,
        *,
        seed: int = 0,
        host_id: int = 0,
        num_hosts: int = 1,
        branch: int = 4,
    ):
        assert batch % num_hosts == 0
        self.vocab = vocab_size
        self.seq = seq_len
        self.local_batch = batch // num_hosts
        self.seed = seed
        self.host_id = host_id
        self.branch = branch
        # fixed sparse bigram table: each token has `branch` likely successors
        rng = np.random.default_rng(seed)
        self.succ = rng.integers(0, vocab_size, size=(vocab_size, branch))

    def batch_at(self, step: int) -> dict:
        """Stateless: batch for global step (replayable after restart)."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 4099 + self.host_id
        )
        B, S = self.local_batch, self.seq
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=B)
        follow = rng.random((B, S)) < 0.8  # 80% markov, 20% noise
        choice = rng.integers(0, self.branch, size=(B, S))
        noise = rng.integers(0, self.vocab, size=(B, S))
        for t in range(S):
            nxt = self.succ[toks[:, t], choice[:, t]]
            toks[:, t + 1] = np.where(follow[:, t], nxt, noise[:, t])
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
