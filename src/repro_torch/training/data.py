"""Synthetic data: deterministic and step-indexed (the port of
``repro.training.data``).

Every batch is a pure function of ``(seed, step)``, drawn by the
reference's numpy stream, so the two packages see the same batches bit for
bit and a resumed run replays exactly the batches it would have seen: the
trainer records only the step.  The stream is a Markov chain through a
fixed random permutation of the vocabulary, with 15% noise, so that
training has something to learn.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.devices import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int = 128
    global_batch: int = 8
    vocab_size: int = 512
    seed: int = 17


def _host_batch(cfg: DataConfig, model_cfg, step: int) -> dict:
    rng = np.random.default_rng(np.uint64(cfg.seed * 1_000_003 + step))
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    perm = np.random.default_rng(cfg.seed).permutation(V)
    toks = np.empty((B, S + 1), np.int32)
    toks[:, 0] = rng.integers(0, V, B)
    noise = rng.random((B, S)) < 0.15
    rand = rng.integers(0, V, (B, S))
    for t in range(S):
        nxt = perm[toks[:, t]]
        toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if model_cfg is not None and model_cfg.is_encdec:
        batch["src_embeds"] = rng.standard_normal(
            (B, S, model_cfg.d_model), np.float32).astype(np.float32) * 0.1
    if model_cfg is not None and model_cfg.num_prefix_embeds:
        batch["vision_embeds"] = rng.standard_normal(
            (B, model_cfg.num_prefix_embeds, model_cfg.d_model),
            np.float32).astype(np.float32) * 0.1
    return batch


class SyntheticDataset:
    """Stateless step-indexed loader; batches land on ``device`` (default:
    the CUDA device)."""

    def __init__(self, cfg: DataConfig, model_cfg=None, device=None):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.device = resolve_device(device)

    def host_batch(self, step: int) -> dict:
        return _host_batch(self.cfg, self.model_cfg, step)

    def batch(self, step: int) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in self.host_batch(step).items()}
