"""Deterministic, shard-aware synthetic data pipeline (a numpy copy of
the reference's ``data/pipeline.py``: its batches are bitwise the
reference's).

Generates a reproducible token stream (mixture of Zipfian unigram draws and
repeated n-gram 'motifs' so models have learnable structure) and serves
fixed-shape batches.  Every batch is a pure function of (seed, step, shard),
which gives exactly-once semantics across restarts and elastic re-sharding:
a restarted worker re-derives the batches it owes without coordination —
the data-side half of fault tolerance.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    motif_len: int = 16
    num_motifs: int = 64
    motif_prob: float = 0.35


class SyntheticCorpus:
    """Stateless batch source: ``batch(step)`` is deterministic."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        g = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # Zipfian unigram distribution + a bank of repeated motifs.
        ranks = np.arange(1, v + 1)
        self._p = (1.0 / ranks) / np.sum(1.0 / ranks)
        self._motifs = g.integers(0, v, (cfg.num_motifs, cfg.motif_len))

    def _sequence(self, rng: np.random.Generator) -> np.ndarray:
        cfg = self.cfg
        out = np.empty(cfg.seq_len + 1, np.int64)
        i = 0
        while i < out.size:
            if rng.random() < cfg.motif_prob:
                m = self._motifs[rng.integers(cfg.num_motifs)]
                n = min(m.size, out.size - i)
                out[i:i + n] = m[:n]
                i += n
            else:
                n = min(int(rng.integers(4, 32)), out.size - i)
                out[i:i + n] = rng.choice(
                    cfg.vocab_size, size=n, p=self._p)
                i += n
        return out

    def batch(self, step: int, *, shard: int = 0, num_shards: int = 1
              ) -> dict[str, np.ndarray]:
        """Global (or per-shard) batch for ``step``: tokens (B, S+1)."""
        cfg = self.cfg
        assert cfg.global_batch % num_shards == 0
        bsz = cfg.global_batch // num_shards
        rows = []
        for j in range(bsz):
            idx = step * cfg.global_batch + shard * bsz + j
            rng = np.random.default_rng((cfg.seed, idx))
            rows.append(self._sequence(rng))
        tokens = np.stack(rows).astype(np.int32)
        pos = np.broadcast_to(np.arange(cfg.seq_len, dtype=np.int32),
                              (bsz, cfg.seq_len))
        return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:],
                "positions": np.ascontiguousarray(pos)}
