"""Token data pipeline.

Offline container -> no real corpus; the pipeline synthesizes a stationary
Zipf-Markov token stream (document lengths ~ lognormal, EOS-separated,
packed into fixed-length rows) so the training loop exercises a realistic
input path: document sampling -> packing -> host-to-device batching.
Deterministic given (seed, step): the stream is restartable for
checkpoint-resume without data-state files.
"""
from __future__ import annotations

import dataclasses

import numpy as np

EOS = 0


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    n_codebooks: int = 0
    zipf_a: float = 1.2
    mean_doc_len: float = 512.0
    seed: int = 0


class PackedStream:
    """Deterministic packed token batches; batch(step) is pure in step."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # Zipf weights over the vocab (token 0 reserved for EOS).
        ranks = np.arange(1, cfg.vocab_size, dtype=np.float64)
        w = ranks ** -cfg.zipf_a
        self._probs = w / w.sum()

    def _doc(self, rng: np.random.Generator, length: int) -> np.ndarray:
        """First-order Markov-ish doc: Zipf unigram with local repetition."""
        base = rng.choice(len(self._probs), size=length, p=self._probs) + 1
        rep = rng.random(length) < 0.15
        base[1:][rep[1:]] = base[:-1][rep[1:]]
        return base.astype(np.int32)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        rows = np.empty((cfg.batch_size, cfg.seq_len + 1), np.int32)
        for b in range(cfg.batch_size):
            buf: list[np.ndarray] = []
            n = 0
            while n < cfg.seq_len + 1:
                L = max(8, int(rng.lognormal(np.log(cfg.mean_doc_len), 0.6)))
                doc = self._doc(rng, L)
                buf.append(np.append(doc, EOS))
                n += L + 1
            row = np.concatenate(buf)[: cfg.seq_len + 1]
            rows[b] = row
        tokens, targets = rows[:, :-1], rows[:, 1:]
        if cfg.n_codebooks:
            # Multi-stream (audio): independent streams per codebook.
            t = np.stack([np.roll(tokens, q, axis=1) % cfg.vocab_size
                          for q in range(cfg.n_codebooks)], axis=-1)
            g = np.stack([np.roll(targets, q, axis=1) % cfg.vocab_size
                          for q in range(cfg.n_codebooks)], axis=-1)
            return dict(tokens=t, targets=g)
        return dict(tokens=tokens, targets=targets)
