"""Synthetic token data (NumPy, bit-identical to the reference's
``repro/data/tokens.py``).

LM batches use a Zipf-distributed vocabulary with a deterministic structure
(a repeating Markov chain per sequence) so that a small model trained for a
few hundred steps shows a real, measurable loss drop; pure-uniform tokens
have irreducible loss = log V and show nothing.
"""
from __future__ import annotations

import numpy as np

from repro_torch.serving.batcher import Request


def _zipf_probs(vocab: int, a: float = 1.2) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-a)
    return p / p.sum()


def synthetic_lm_batches(*, vocab: int, seq_len: int, batch: int, seed: int = 0,
                         n_states: int = 64):
    """Infinite generator of {"tokens", "labels"} batches (int32 NumPy).

    Tokens follow a random deterministic automaton over ``n_states`` states
    emitting Zipf-ranked symbols: learnable structure with entropy well
    below log(V)."""
    rng = np.random.default_rng(seed)
    emit = rng.choice(vocab, size=(n_states, 8), p=_zipf_probs(vocab))
    trans = rng.integers(0, n_states, size=(n_states, 8))
    while True:
        toks = np.zeros((batch, seq_len + 1), dtype=np.int32)
        state = rng.integers(0, n_states, size=batch)
        for t in range(seq_len + 1):
            e = rng.integers(0, 8, size=batch)
            toks[:, t] = emit[state, e]
            state = trans[state, e]
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


def synthetic_requests(n: int, *, vocab: int = 512, seq_len: int = 32,
                       seed: int = 0):
    """Request token prompts for the serving examples."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i, tokens=rng.integers(1, vocab, size=seq_len).astype(np.int32))
            for i in range(n)]
