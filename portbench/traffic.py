"""The one traffic generator: it reads a mix's parameters from
``traffic/<name>.json`` and draws the cell's inputs from ``--seed``.

Two shapes of traffic exist so far:

* ``sweep_queries``: a closed loop of design-space queries.  Each query
  names the L1 geometry it asks about; the geometries come in shuffled
  blocks of one each, so every seed offers the same work in another
  order;
* ``packed_documents``: training batches of ``batch`` rows of
  ``seq_len`` tokens, cut from a stream of synthetic documents (Zipfian
  tokens, log-normal lengths) joined by the end-of-text token.  Every
  batch is a function of (seed, step) alone, and no two rows repeat.
"""

from __future__ import annotations

import numpy as np


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, *stream])


def sweep_queries(traffic: dict, geometries: list, seed: int,
                  count: int) -> list[int]:
    """``count`` queries, each an index into ``geometries``."""
    rng = _rng(seed, 1)
    order = []
    while len(order) < count:
        order.extend(rng.permutation(len(geometries)).tolist())
    return order[:count]


class Documents:
    """Packed synthetic documents for one configuration's vocabulary."""

    def __init__(self, traffic: dict, vocab_size: int, eos: int):
        self.batch = int(traffic["batch"])
        self.seq_len = int(traffic["seq_len"])
        doc = traffic["documents"]
        self.median = float(doc["median_tokens"])
        self.sigma = float(doc["sigma"])
        self.lo, self.hi = int(doc["min_tokens"]), int(doc["max_tokens"])
        self.eos = int(eos)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        w = ranks ** -float(doc["zipf_exponent"])
        w[self.eos] = 0.0
        self._cdf = np.cumsum(w) / w.sum()

    def tokens(self, seed: int, step: int) -> np.ndarray:
        """(batch, seq_len + 1) int64 tokens of one step; inputs are
        ``[:, :-1]`` and targets ``[:, 1:]``."""
        rng = _rng(seed, 2, step)
        need = self.batch * (self.seq_len + 1)
        parts, have = [], 0
        while have < need:
            n = int(np.clip(rng.lognormal(np.log(self.median), self.sigma),
                            self.lo, self.hi))
            doc = np.searchsorted(self._cdf, rng.random(n), side="right")
            parts += [doc, np.array([self.eos])]
            have += n + 1
        stream = np.concatenate(parts)[:need]
        return stream.reshape(self.batch, self.seq_len + 1).astype(np.int64)
