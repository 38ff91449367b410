"""Deterministic synthetic data pipeline, port of ``repro.data.synthetic``.

Offline-reproducible streams for every model family: token LM batches,
audio-frame stubs, image-patch stubs and diffusion latents.  A batch is a
pure function of (seed, step), so a restarted job resumes bit-identically.
Each batch is drawn with the reference's NumPy calls in the reference's
order and only then converted to tensors on ``device``, so it equals the
reference's batch bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig

__all__ = ["DataConfig", "DataState", "make_batch", "data_stream"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    batch: int = 8
    seq_len: int = 256


@dataclasses.dataclass
class DataState:
    step: int = 0

    def as_dict(self):
        return {"step": self.step}


def _tensor(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    np_dtype = np.int32 if dtype == torch.int32 else np.float32
    return torch.from_numpy(np.asarray(a, np_dtype)).to(device)


def _tok_batch(cfg: ArchConfig, dcfg: DataConfig, step: int, *, device) -> dict:
    rng = np.random.default_rng(dcfg.seed * 1_000_003 + step)
    # Markov-ish synthetic text: mixture of ngram repetition + noise gives a
    # learnable signal (loss decreases) without any external data.
    base = rng.integers(0, cfg.vocab, size=(dcfg.batch, dcfg.seq_len + 1))
    period = 1 + (step % 7)
    base[:, period:] = np.where(
        rng.random((dcfg.batch, dcfg.seq_len + 1 - period)) < 0.7,
        base[:, :-period], base[:, period:])
    return {"tokens": _tensor(base[:, :-1], torch.int32, device),
            "labels": _tensor(base[:, 1:], torch.int32, device)}


def make_batch(cfg: ArchConfig, dcfg: DataConfig, step: int, *, device) -> dict:
    """One batch for the arch's family at ``step`` (pure function of inputs)."""
    rng = np.random.default_rng(dcfg.seed * 7_000_003 + step)
    f32 = lambda a: _tensor(a, torch.float32, device)
    if cfg.family in ("dense", "moe", "ssm", "hybrid"):
        return _tok_batch(cfg, dcfg, step, device=device)
    if cfg.family == "encdec":
        b = _tok_batch(cfg, dcfg, step, device=device)
        b["frames"] = f32(rng.standard_normal((dcfg.batch, cfg.encoder_len, cfg.d_model)))
        return b
    if cfg.family == "vlm":
        b = _tok_batch(cfg, dcfg, step, device=device)
        b["patches"] = f32(rng.standard_normal((dcfg.batch, cfg.num_image_tokens,
                                                cfg.d_model)))
        return b
    if cfg.family == "dit":
        nv = dcfg.seq_len
        lat = rng.standard_normal((dcfg.batch, nv, cfg.patch_dim))
        noise = rng.standard_normal((dcfg.batch, nv, cfg.patch_dim))
        t = rng.random((dcfg.batch,))
        xt = (1 - t)[:, None, None] * noise + t[:, None, None] * lat
        emb = rng.standard_normal((cfg.patch_dim, cfg.d_model)) * 0.2
        return {
            "latents": f32(lat),
            "noise": f32(noise),
            "patch_emb": f32(xt @ emb),
            "text_emb": f32(rng.standard_normal((dcfg.batch, max(cfg.n_text_tokens, 1),
                                                 cfg.d_model))),
            "t": f32(t),
        }
    raise ValueError(cfg.family)


def data_stream(cfg: ArchConfig, dcfg: DataConfig, start_step: int = 0, *,
                device) -> Iterator[tuple[int, dict]]:
    step = start_step
    while True:
        yield step, make_batch(cfg, dcfg, step, device=device)
        step += 1
