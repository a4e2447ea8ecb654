"""Data pipeline: deterministic synthetic LM stream + memmap token files.

A copy of the JAX package's ``training/data.py`` (numpy only): the same
``DataCfg`` gives bit-identical batches and the same ``state()`` /
``restore()``. Host-side numpy producers; the launcher
(``launch/train.py``) moves each batch to the device. Synthetic tokens
follow a Zipf distribution so losses are non-degenerate; the file
pipeline memory-maps a flat uint16/uint32 token file (the GoFS
philosophy: layout chosen so each host reads only its slice).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataCfg:
    batch: int
    seq: int
    vocab: int
    seed: int = 0
    zipf_a: float = 1.2
    path: Optional[str] = None           # token file (memmap) if set
    frames: Optional[tuple] = None       # (enc_seq, d_model) for encdec stubs
    mrope: bool = False


class SyntheticLM:
    """Deterministic, restartable synthetic token stream."""

    def __init__(self, cfg: DataCfg):
        self.cfg = cfg
        self.step = 0

    def state(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def restore(self, state: dict):
        self.step = int(state["step"])

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        c = self.cfg
        rng = np.random.default_rng((c.seed, self.step))
        self.step += 1
        toks = rng.zipf(c.zipf_a, size=(c.batch, c.seq + 1)).astype(np.int64)
        toks = np.clip(toks, 1, c.vocab - 1).astype(np.int32)
        batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
        if c.frames is not None:
            es, d = c.frames
            batch["frames"] = rng.standard_normal((c.batch, es, d)).astype(np.float32)
        if c.mrope:
            pos = np.broadcast_to(np.arange(c.seq)[None, None],
                                  (3, c.batch, c.seq)).copy()
            batch["positions"] = pos.astype(np.int32)
        return batch


class TokenFile:
    """Memmap-backed contiguous token stream, host-sharded by offset."""

    def __init__(self, cfg: DataCfg, host_index: int = 0, host_count: int = 1,
                 dtype=np.uint16):
        self.cfg = cfg
        self.data = np.memmap(cfg.path, dtype=dtype, mode="r")
        span = len(self.data) // host_count
        self.lo = host_index * span
        self.hi = self.lo + span
        self.pos = self.lo
        self.step = 0

    def state(self) -> dict:
        return {"pos": int(self.pos), "step": self.step}

    def restore(self, state: dict):
        self.pos = int(state["pos"])
        self.step = int(state["step"])

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        c = self.cfg
        need = c.batch * (c.seq + 1)
        if self.pos + need >= self.hi:
            self.pos = self.lo
        chunk = np.asarray(self.data[self.pos:self.pos + need], np.int32)
        self.pos += need
        self.step += 1
        toks = np.clip(chunk.reshape(c.batch, c.seq + 1), 0, c.vocab - 1)
        return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}


def make_dataset(cfg: DataCfg, **kw):
    return TokenFile(cfg, **kw) if cfg.path else SyntheticLM(cfg)
