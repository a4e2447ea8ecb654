"""Checkpoint/restore of nested tensors, with async save and a CRC32
manifest.

The port of the JAX package's ``training/checkpoint.py`` on one process.
The on-disk layout is the JAX package's, so either package restores what
the other saved:

    <dir>/step_<N>/host_0.npz        every leaf, keyed by its path
    <dir>/step_<N>/manifest.json     step, paths, extra, checksums,
                                     process_index 0, process_count 1
    <dir>/step_<N>/COMMIT            written last: restore ignores a step
                                     without it (a partial write)

A state is a nest of dicts (keys sorted), lists and tuples whose leaves
are torch tensors (on any device), numpy arrays or Python scalars; ``None``
holds no leaf. A leaf's path is spelled as ``jax.tree_util.keystr`` spells
it (``"['state']['x']"``, ``"[0]"``). bfloat16 and the float8 types, which
npz cannot hold, are stored as a same-width unsigned integer view plus a
``"<path>::dtype"`` marker naming the dtype. The manifest's CRC32 of each
entry is taken over the encoded bytes, before the commit marker is
written; :meth:`Checkpointer.verify_step` recomputes them from the files,
and :meth:`Checkpointer.latest_good_step` skips a committed snapshot whose
bytes no longer match (bit-rot, truncation).

The BSP engine's checkpointed runs (``GopherEngine.run(checkpointer=)``)
snapshot ``{"state": ..., "inbox": ...}`` through this class. On the
``shard_map`` backend a snapshot still holds the full (P, ...) arrays:
every rank passes the gathered arrays to ``save(group=)``, rank 0 of the
group writes them and the ranks meet at a barrier once the commit marker
is on disk, so every rank sees the same newest snapshot; each rank
restores its own rows (``restore(rows=)``), or on an LM mesh its block of
every leaf (``restore(index=)``, ``launch.elastic.restart``). A snapshot of a mesh run is
therefore the one file a one-process run writes, and either package
restores it.
"""
from __future__ import annotations

import json
import os
import threading
import time
import zlib
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import wire
from repro_torch.core.engine import resolve_device

# what npz cannot hold: dtype -> (its marker, the same-width torch dtype
# it is viewed as, that view's numpy dtype, the numpy dtype stored). The
# stored dtypes are the JAX package's (ml_dtypes viewed as unsigned).
_EXOTIC = {
    torch.bfloat16: ("bfloat16", torch.int16, np.int16, np.uint16),
    torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8, np.uint8, np.uint8),
    torch.float8_e5m2: ("float8_e5m2", torch.uint8, np.uint8, np.uint8)}
_EXOTIC_BY_NAME = {v[0]: (dt, v[2]) for dt, v in _EXOTIC.items()}


def _leaves_with_paths(tree, prefix: str = "") -> list:
    """[(path, leaf)] in ``jax.tree_util``'s flattening order: dict keys
    sorted, sequences in order, None empty."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves_with_paths(tree[k], f"{prefix}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _leaves_with_paths(v, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def _rebuild(tree, values):
    """``tree``'s structure with its leaves replaced, in order, by the
    iterator ``values``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], values) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values) for v in tree)
    return next(values)


def _to_host(leaf):
    """One leaf as a numpy array of its own (a copy, never a view of the
    caller's memory: an async write must not see later changes), and its
    dtype marker (None for a dtype npz holds)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype in _EXOTIC:
            name, view, _, stored = _EXOTIC[leaf.dtype]
            arr = leaf.contiguous().view(view).to("cpu", copy=True).numpy()
            return arr.view(stored), name
        return leaf.to("cpu", copy=True).numpy(), None
    return np.array(leaf), None


def _from_host(arr: np.ndarray, dtype_name: Optional[str], device):
    """An npz entry as a tensor on ``device``, decoding a dtype marker."""
    if dtype_name:
        dt, np_view = _EXOTIC_BY_NAME[dtype_name]
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np_view))
        return t.view(dt).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def _block(arr: np.ndarray, index: tuple) -> np.ndarray:
    """``arr`` indexed one dim at a time (so that two integer arrays do not
    pair up as numpy's fancy indexing would pair them)."""
    for d, ix in enumerate(index):
        arr = arr[(slice(None),) * d + (ix,)]
    return arr


def _crc(arr) -> int:
    return zlib.crc32(np.ascontiguousarray(np.asarray(arr)).tobytes())


def _committed(directory: str) -> list:
    return [int(d.split("_")[1]) for d in os.listdir(directory)
            if d.startswith("step_")
            and os.path.exists(os.path.join(directory, d, "COMMIT"))]


class Checkpointer:
    def __init__(self, directory: str, async_save: bool = False):
        self.dir = directory
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # seconds of the last save's pieces: device-to-host, CRC, write
        # (the write's is known once it has finished: after wait())
        self.last_save_s: dict = {}
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------ save
    def save(self, state, step: int, extra: Optional[dict] = None,
             group=None):
        """Snapshot `state` at `step`. The device-to-host copies happen
        here, before the call returns, so the caller may go on changing
        its tensors; with async_save only the file writes (numpy arrays)
        run on a background thread.

        With a process ``group`` every rank of it calls this with the same
        ``state``; only its rank 0 writes, synchronously, and the ranks
        leave through a barrier after the commit marker is written."""
        if group is not None:
            try:
                if dist.get_rank(group) == 0:
                    self._save(state, step, extra)
                    self.wait()
            finally:
                wire.barrier(group=group)
            return
        self._save(state, step, extra)

    def _save(self, state, step: int, extra: Optional[dict]):
        self.wait()
        t0 = time.perf_counter()
        pairs = _leaves_with_paths(state)
        paths = [p for p, _ in pairs]
        host_blocks = {}
        for pth, leaf in pairs:
            arr, dtype_name = _to_host(leaf)
            host_blocks[pth] = arr
            if dtype_name:
                host_blocks[f"{pth}::dtype"] = np.str_(dtype_name)
        t1 = time.perf_counter()
        sdir = os.path.join(self.dir, f"step_{step}")
        os.makedirs(sdir, exist_ok=True)
        # per-entry CRC32 over the encoded bytes, recorded in the manifest
        # BEFORE the commit marker: restore-side verification detects
        # bit-rot / truncation of a committed snapshot and falls back to
        # the previous good one (latest_good_step)
        checksums = {k: _crc(v) for k, v in host_blocks.items()}
        t2 = time.perf_counter()
        manifest = dict(step=step, paths=paths, extra=extra or {},
                        checksums=checksums, process_index=0,
                        process_count=1)
        self.last_save_s = {"device_to_host": t1 - t0, "crc": t2 - t1}

        def _write():
            t = time.perf_counter()
            try:
                np.savez(os.path.join(sdir, "host_0.npz"), **host_blocks)
                with open(os.path.join(sdir, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                # commit marker: restore ignores partially-written steps
                with open(os.path.join(sdir, "COMMIT"), "w") as f:
                    f.write("ok")
            except Exception as e:          # re-raised by wait()
                self._error = e
            self.last_save_s["write"] = time.perf_counter() - t

        if self.async_save:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()
            self._raise_pending()

    def wait(self):
        """Join the background write, re-raising its error if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def _raise_pending(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------ restore
    def latest_step(self) -> Optional[int]:
        steps = _committed(self.dir)
        return max(steps) if steps else None

    def verify_step(self, step: int) -> bool:
        """Recompute every entry's CRC32 from the files on disk and compare
        against the manifest. A snapshot without ``checksums`` verifies
        when it holds every path; unreadable files or any mismatch fail."""
        sdir = os.path.join(self.dir, f"step_{step}")
        try:
            with open(os.path.join(sdir, "manifest.json")) as f:
                manifest = json.load(f)
            want = manifest.get("checksums")
            with np.load(os.path.join(sdir, "host_0.npz")) as z:
                if want is None:
                    return set(z.files) >= set(manifest["paths"])
                if set(want) != set(z.files):
                    return False
                return all(_crc(z[k]) == want[k] for k in z.files)
        except Exception:
            return False

    def latest_good_step(self) -> Optional[int]:
        """The newest committed snapshot that passes checksum verification:
        a corrupted/truncated latest snapshot is skipped and recovery
        restarts one (or more) snapshots earlier instead of restoring
        garbage."""
        for s in sorted(_committed(self.dir), reverse=True):
            if self.verify_step(s):
                return s
        return None

    def restore(self, state_like, step: Optional[int] = None, device=None,
                rows: Optional[slice] = None, index=None):
        """Restore into the structure of `state_like` (its leaves' values
        are not read). Returns ``(state, step)``: every leaf a torch tensor
        on ``device`` (``cuda`` when None, as every entry point of the port
        defaults) with the saved dtype and shape, or only the leading-axis
        ``rows`` of each (a ``shard_map`` rank's partitions), or with
        ``index`` (one entry a leaf, in leaf order: None for the whole
        leaf, else one indexer a dim, a slice or an integer array) each
        leaf's block."""
        if rows is not None and index is not None:
            raise ValueError("pass rows= or index=, not both")
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {self.dir}")
        device = resolve_device("cuda" if device is None else device)
        sdir = os.path.join(self.dir, f"step_{step}")
        with np.load(os.path.join(sdir, "host_0.npz")) as z:
            blocks = {k: z[k] for k in z.files}
        pairs = _leaves_with_paths(state_like)
        if index is None:
            index = [None if rows is None else (rows,)] * len(pairs)
        if len(index) != len(pairs):
            raise ValueError(f"{len(index)} indices for {len(pairs)} leaves")
        out = []
        for (pth, _), ix in zip(pairs, index):
            dmark = blocks.get(f"{pth}::dtype")
            arr = blocks[pth] if ix is None else _block(blocks[pth], ix)
            out.append(_from_host(arr,
                                  str(dmark) if dmark is not None else None,
                                  device))
        return _rebuild(state_like, iter(out)), step

    def extra(self, step: Optional[int] = None) -> dict:
        step = step if step is not None else self.latest_step()
        with open(os.path.join(self.dir, f"step_{step}",
                               "manifest.json")) as f:
            return json.load(f)["extra"]
