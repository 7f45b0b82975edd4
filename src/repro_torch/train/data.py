"""Deterministic synthetic data pipeline.

Random-access by (seed, step): any node can reproduce any batch without
a shared service — which is exactly what a TrainMover joiner needs to
resume the data stream mid-run (the data-loader state is implicit in the
step counter it receives during state sync).

Tokens follow a Zipf-ish marginal with a short-range Markov flavor so
losses are non-trivial and the LM actually learns in the examples.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeCfg


@dataclass(frozen=True)
class DataCfg:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 1234


class SyntheticStream:
    """Stateless, replayable token stream."""

    def __init__(self, cfg: DataCfg, arch: Optional[ArchConfig] = None):
        self.cfg = cfg
        self.arch = arch
        v = cfg.vocab_size
        base = np.random.default_rng(cfg.seed)
        # fixed per-stream unigram table (Zipf) + token successor map
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        self._p = p / p.sum()
        self._succ = base.integers(0, v, size=v, dtype=np.int64)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s = cfg.global_batch, cfg.seq_len
        draws = rng.choice(cfg.vocab_size, size=(b, s), p=self._p)
        # 50% of positions copy a deterministic successor of the previous
        # token -> learnable structure.
        follow = rng.random((b, s)) < 0.5
        toks = draws.copy()
        for t in range(1, s):
            toks[:, t] = np.where(follow[:, t],
                                  self._succ[toks[:, t - 1]], draws[:, t])
        out = {"tokens": toks.astype(np.int32)}
        if self.arch is not None and self.arch.frontend == "vision_patches":
            out["patches"] = rng.standard_normal(
                (b, self.arch.num_patches, self.arch.d_model)
            ).astype(np.float32) * 0.02
        if self.arch is not None and self.arch.frontend == "audio_frames":
            out["frames"] = rng.standard_normal(
                (b, self.arch.encoder_seq, self.arch.d_model)
            ).astype(np.float32) * 0.02
        return out


def stream_for(arch: ArchConfig, shape: ShapeCfg,
               seed: int = 1234) -> SyntheticStream:
    return SyntheticStream(
        DataCfg(arch.vocab_size, shape.global_batch, shape.seq_len, seed),
        arch)
