"""Batched serving engine: prefill + greedy decode of one planned pair.

This is the execution layer the paper's allocator plans FOR: one active
(model, tier) pair serves a static batch of requests with one prefill
and then one decode step per new token.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..models import decoder
from ..models.config import ModelConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # [T] int32
    max_new_tokens: int
    arrived_s: float = 0.0
    first_token_s: float | None = None
    done_s: float | None = None
    output: list[int] = dataclasses.field(default_factory=list)


def check_servable(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a configuration the engine cannot
    serve: one with codebook tokens, whose prompts are [T, nq] (musicgen
    runs through `decoder.prefill` / `decode_step` instead). The
    reference's engine cannot serve them either (its prompts are 1-D).
    Prefix-capable configs are served with text-only prompts, as the
    reference serves them (it never passes a prefix)."""
    decoder.check_supported(cfg)
    if cfg.n_codebooks:
        raise NotImplementedError(
            f"{cfg.name}: the engine serves 1-D token prompts, not "
            f"{cfg.n_codebooks}-codebook tokens")


class Engine:
    """Single-deployment engine (one model, one parallelism config). Runs
    on the device that holds `params`."""

    def __init__(self, cfg: ModelConfig, params: dict, max_len: int,
                 max_batch: int):
        check_servable(cfg)
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.max_batch = max_batch
        self.device = params["embed"].device

    @torch.inference_mode()
    def generate(self, requests: list[Request]) -> list[Request]:
        """Static-batch greedy generation: left-pad the prompts with token 0
        to a common length (the pads are attended, as in the reference),
        prefill once, decode until every request has its tokens."""
        t_start = time.perf_counter()
        B = len(requests)
        if B > self.max_batch:
            raise ValueError(f"{B} requests exceed max_batch "
                             f"{self.max_batch}")
        Tp = max(len(r.prompt) for r in requests)
        n_new = max(r.max_new_tokens for r in requests)
        if Tp + n_new - 1 > self.max_len:
            raise ValueError(f"prompt {Tp} + {n_new} new tokens exceed "
                             f"max_len {self.max_len}")
        toks = np.zeros((B, Tp), np.int64)
        for b, r in enumerate(requests):
            toks[b, -len(r.prompt):] = r.prompt      # left-pad
        logits, cache = decoder.prefill(
            self.params, self.cfg, torch.from_numpy(toks).to(self.device),
            max_len=self.max_len)
        step = logits[:, -1].argmax(dim=-1)          # ties: first index
        # repro-lint: ignore[RPR402] -- the TTFT read: the first tokens are
        # the requests' output and their arrival time is the metric
        first = step.tolist()                         # waits for the device
        now = time.perf_counter() - t_start
        for r, t in zip(requests, first, strict=True):
            r.output.append(t)
            r.first_token_s = now
        # The decode loop keeps its tokens on the device and reads them back
        # once at the end; the cache is updated in place.
        steps = []
        for pos in range(Tp, Tp + n_new - 1):
            logits, cache = decoder.decode_step(self.params, self.cfg, cache,
                                                step[:, None], pos)
            step = logits[:, -1].argmax(dim=-1)
            steps.append(step)
        if steps:
            # repro-lint: ignore[RPR402] -- the loop's one read: every
            # decoded token comes back in a single copy after the last step
            rest = torch.stack(steps, dim=1).tolist()
            for r, toks_r in zip(requests, rest, strict=True):
                r.output.extend(toks_r[:r.max_new_tokens - 1])
        now = time.perf_counter() - t_start
        for r in requests:
            r.done_s = now
        return requests
