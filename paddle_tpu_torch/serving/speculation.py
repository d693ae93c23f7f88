"""Sampling math shared with speculative decoding (port of
``serving/speculation.py``: ``processed_probs`` only).

Sampling stays host-side numpy with a per-request
``np.random.default_rng(seed)``, exactly as in the JAX package, so a
seeded stochastic request draws the same tokens in both packages. The
proposers and lossless verification port with speculative decoding.
"""

from __future__ import annotations

import numpy as np


def processed_probs(logits: np.ndarray, seq) -> np.ndarray:
    """The request's processed distribution over one f32 logits row:
    temperature, then top-k, then top-p. Callers guarantee
    ``seq.temperature > 0``."""
    logits = np.asarray(logits, dtype=np.float32)
    logits = logits / seq.temperature
    if seq.top_k > 0:
        k = min(seq.top_k, logits.size)   # top_k >= vocab keeps all
        kth = np.partition(logits, -k)[-k]
        logits = np.where(logits < kth, -1e30, logits)
    if 0.0 < seq.top_p < 1.0:
        srt = np.sort(logits)[::-1]
        probs = np.exp(srt - srt.max())
        probs /= probs.sum()
        keep = (np.cumsum(probs) - probs) < seq.top_p
        cutoff = srt[keep].min()
        logits = np.where(logits < cutoff, -1e30, logits)
    z = logits - logits.max()
    p = np.exp(z)
    return p / p.sum()
