"""Logical-axis sharding rules resolved against the active mesh, and the
collectives the LM layers issue on it.

The port of the JAX package's ``models/sharding.py``. The rule tables,
``base_param_spec`` and ``fit_axes`` are copies with the same arithmetic;
:func:`set_rules` takes a ``torch.distributed`` ``DeviceMesh`` (its
``mesh_dim_names`` and sizes) or a tuple of axis names. Logical axes:

    batch     -> ('pod', 'data') when a pod axis exists, else ('data',)
    fsdp      -> 'data'   (parameter sharding)
    tp        -> 'model'  (tensor parallel: heads / ffn hidden / vocab /
                           Mamba channels)
    batch_tp  -> ('pod', 'data', 'model'): attention's batch fold when the
                 heads do not divide TP (``cfg.attn_batch_fold``)
    seq, none -> replicated

Where the JAX package states a layout and GSPMD inserts the collectives,
the port states the collectives, Megatron-style: each rank holds only its
block of every parameter and cache leaf (``training.shardspec``), and the
layers call the helpers below, each a ``torch.distributed`` collective on
the group of the mesh axes a logical name resolves to (a name that
resolves to several axes, ('pod', 'data'), is one group: the mesh
flattened over them, in the mesh's row-major order). Off a mesh (no rules
set) every helper returns its input, as JAX ``shard`` is a no-op there,
and the single-device path keeps its code and launches. On a mesh the
helpers issue their collective whatever the axis's size, so a one-rank
mesh runs the calls a larger one does. The LM path issues:

  all_gather over 'data'   :func:`weight`, before every product with a
                           parameter whose spec names 'data' (FSDP): wq,
                           wk, wv, wo, w_gate, w_up, w_down, tok, unembed,
                           in_proj, out_proj; over 'model' too where the
                           batch fold needs whole attention weights
  all_reduce over 'model'  :func:`reduce` after a row-parallel product: wo,
                           w_down, out_proj, x_proj (its (dt, B, C)), wk/wv
                           where kv heads do not divide TP; the embedding's
                           masked lookup on the rank's vocab rows; the
                           decode's partial scores where the cache splits
                           its head dim
  all_gather over 'model'  :func:`gather`: the vocab-sharded greedy argmax
                           (:func:`greedy`), the folded attention's rows,
                           and the dh-split decode's q heads and output
  all_gather over batch    the generated tokens (:func:`gather_batch`), so
                           every rank returns all B (a batch splits over
                           the 'batch' axes or raises: :func:`batch_rows`)

:func:`collectives` counts the calls by kind since
:func:`reset_collectives`.
"""
from __future__ import annotations

import collections
import contextlib
import threading
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import wire

_state = threading.local()
_counts: collections.Counter = collections.Counter()

DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),
    "tp": ("model",),
    "seq": (),
    # the JAX package's layer-boundary residual layout (training's ZeRO-R
    # save); the port keeps the residual whole on every TP rank
    "actd": ("model",),
    # attention fallback when n_heads < TP (gemma3 h=8): the block's batch
    # folds onto ('pod', 'data', 'model') so no device idles
    "batch_tp": ("pod", "data", "model"),
    "none": (),
}

# base (unstacked) PartitionSpec per parameter leaf name — shared with
# training.shardspec. FSDP='data', TP='model'.
PARAM_RULES = {
    "tok": ("model", "data"), "unembed": ("data", "model"),
    "pos_enc": (None, None), "pos_dec": (None, None),
    "wq": ("data", "model", None), "wk": ("data", "model", None),
    "wv": ("data", "model", None), "wo": ("model", None, "data"),
    "bq": ("model", None), "bk": ("model", None), "bv": ("model", None),
    "q_norm": (None,), "k_norm": (None,),
    "w_gate": ("data", "model"), "w_up": ("data", "model"),
    "w_down": ("model", "data"),
    "router": (None, None),
    "we_gate": ("model", "data", None), "we_up": ("model", "data", None),
    "we_down": ("model", None, "data"),
    "in_proj": ("data", "model"), "out_proj": ("model", "data"),
    "x_proj": ("model", None), "dt_proj_w": (None, "model"),
    "dt_proj_b": ("model",), "conv_w": (None, "model"), "conv_b": ("model",),
    "D": ("model",), "dt_bias": ("model",), "norm": ("model",),
    "a_log2": ("model",),   # mamba2 per-head decay (H,)
}


class PartitionSpec(tuple):
    """How a leaf lies on a mesh, as the JAX package's ``PartitionSpec``:
    one entry per leading dimension, an axis name, a tuple of axis names
    (split over their product, the first major) or None (not split); the
    empty spec is replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


def base_param_spec(name: str, ndim: int, shape=None, sizes=None):
    if name == "A_log":  # mamba1 (di, N) vs mamba2 (H,)
        return ("model", None) if ndim >= 2 else ("model",)
    if name in ("wk", "wv") and shape is not None and sizes:
        # GQA: kv heads may not divide TP — fall back to row-parallel over
        # d_model, TP axis only (k/v become TP-replicated after an
        # all_reduce): the classic KV-replication scheme
        kv = shape[-2]
        if kv % max(sizes.get("model", 1), 1) != 0:
            return ("model", None, None)
    return PARAM_RULES.get(name)


def fit_axes(entry, dim: int, sizes: dict):
    """Drop mesh axes that don't divide `dim` (GQA kv<TP, odd vocabs, ...)."""
    if entry is None:
        return None
    axes = entry if isinstance(entry, tuple) else (entry,)
    kept, prod = [], 1
    for a in axes:
        s = sizes.get(a, 0)
        if s and dim % (prod * s) == 0:
            kept.append(a)
            prod *= s
    if not kept:
        return None
    return tuple(kept) if len(kept) > 1 else kept[0]


def axes_of(entry) -> tuple:
    """A spec entry as a tuple of axis names (None -> ())."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` ({} for None)."""
    if mesh is None:
        return {}
    return {a: int(s) for a, s in zip(mesh.mesh_dim_names, mesh.shape)}


# ---------------------------------------------------------------- rules

def set_rules(mesh_or_names, overrides: Optional[dict] = None):
    """Activate sharding for the model code on this thread. Accepts a
    ``DeviceMesh`` (axis sizes for the divisibility checks, this rank's
    coordinates and the groups of the collectives) or a tuple of axis
    names (specs only: the helpers then raise)."""
    if hasattr(mesh_or_names, "mesh_dim_names"):
        mesh = mesh_or_names
        names = tuple(mesh.mesh_dim_names)
        sizes = mesh_sizes(mesh)
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not on the mesh")
        _state.coords = dict(zip(names, (int(c) for c in coord)))
        _state.mesh = mesh
    else:
        names = tuple(mesh_or_names)
        sizes = {}
        _state.coords = {}
        _state.mesh = None
    rules = {}
    for k, axes in {**DEFAULT_RULES, **(overrides or {})}.items():
        rules[k] = tuple(a for a in axes if a in names)
    _state.rules = rules
    _state.sizes = sizes
    _state.active = True


def active_mesh():
    return getattr(_state, "mesh", None) if active() else None


def active() -> bool:
    return getattr(_state, "active", False)


def rule_axes(name: str):
    rules = getattr(_state, "rules", None)
    return rules.get(name, ()) if rules else ()


def clear_rules():
    _state.active = False


def resolve(*logical) -> PartitionSpec:
    rules = getattr(_state, "rules", None)
    if rules is None:
        return PartitionSpec(*[None for _ in logical])
    out = []
    for name in logical:
        if name is None:
            out.append(None)
            continue
        axes = rules.get(name, ())
        out.append(axes if len(axes) > 1 else (axes[0] if axes else None))
    return PartitionSpec(*out)


def param_spec(*logical) -> PartitionSpec:
    return resolve(*logical)


def sizes() -> dict:
    return dict(getattr(_state, "sizes", {})) if active() else {}


def _axes(logical) -> tuple:
    """A logical name's mesh axes on the active rules, or a tuple of axis
    names as given (() off a mesh)."""
    if not active():
        return ()
    return tuple(logical) if isinstance(logical, tuple) else \
        rule_axes(logical)


def size(logical) -> int:
    """The product of the sizes of the axes ``logical`` resolves to (a
    logical name or a tuple of axis names; 1 off a mesh)."""
    s = sizes()
    n = 1
    for a in _axes(logical):
        n *= s.get(a, 1)
    return n


def index(logical) -> int:
    """This rank's index along the axes ``logical`` resolves to, the first
    axis major (0 off a mesh)."""
    s = sizes()
    i = 0
    for a in _axes(logical):
        i = i * s[a] + _state.coords[a]
    return i


# ---------------------------------------------------------------- groups

def _group(axes: tuple):
    """The process group of this rank's slice of the mesh along ``axes``:
    the mesh's own group for one axis, a group over the flattened axes
    for several (made once a mesh, by the slice's members only: every
    rank of an SPMD program makes them at the same point)."""
    mesh = _state.mesh
    if mesh is None:
        raise RuntimeError("collectives need set_rules(mesh) with a "
                           "DeviceMesh")
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    cache = mesh.__dict__.setdefault("_flat_groups", {})
    if axes not in cache:
        names = tuple(mesh.mesh_dim_names)
        grid = mesh.mesh
        # move the flattened axes last, fix the others at this rank's place
        keep = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in keep]
        grid = grid.permute(*rest, *keep)
        for i in rest:
            grid = grid[_state.coords[names[i]]]
        ranks = [int(r) for r in grid.reshape(-1)]
        if ranks != sorted(ranks):
            raise ValueError(f"the mesh's ranks along {axes} are not in "
                             f"rank order: {ranks}")
        cache[axes] = wire.new_group(ranks, use_local_synchronization=True)
    return cache[axes]


def collectives() -> dict:
    """The collectives issued by kind since :func:`reset_collectives`."""
    return dict(_counts)


def reset_collectives() -> None:
    _counts.clear()


def gather(x: torch.Tensor, logical, dim: int) -> torch.Tensor:
    """all_gather ``x`` over the axes ``logical`` resolves to, the blocks
    concatenated along ``dim`` in mesh order. Identity off a mesh."""
    axes = _axes(logical)
    if not axes:
        return x
    group = _group(axes)
    n = dist.get_world_size(group)
    dim = dim % x.dim()
    src = x.contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    _counts["all_gather"] += 1
    wire.all_gather_into_tensor(out, src, group=group)
    out = out.view((n,) + tuple(src.shape))            # the blocks stacked
    # contiguous in x's own layout (a view where n == 1 or dim == 0), so
    # that a gathered weight meets the products it met unsharded
    shape = list(src.shape)
    shape[dim] *= n
    return out.movedim(0, dim).reshape(shape)


def reduce(x: torch.Tensor, logical="tp") -> torch.Tensor:
    """all_reduce (sum) ``x`` over the axes ``logical`` resolves to, in
    place. Identity off a mesh."""
    axes = _axes(logical)
    if not axes:
        return x
    x = x.contiguous()
    _counts["all_reduce"] += 1
    wire.all_reduce(x, group=_group(axes))
    return x


# ---------------------------------------------------------------- params

def spec_of(w) -> Optional[PartitionSpec]:
    """The spec a sharded parameter carries (``training.shardspec``
    tags each block it cuts), None for a whole one or off a mesh."""
    return getattr(w, "spec", None) if active() else None


def split(w, dim: int) -> bool:
    """Whether ``w``'s dim ``dim`` is split over 'model' on this mesh."""
    spec = spec_of(w)
    return spec is not None and dim < len(spec) and \
        "model" in axes_of(spec[dim])


def weight(w: torch.Tensor, whole: bool = False) -> torch.Tensor:
    """The block of ``w`` a product uses: its 'data' (FSDP) dims
    all-gathered, its 'model' dims kept split (tensor parallel), or
    gathered too with ``whole``. Identity off a mesh."""
    spec = spec_of(w)
    if spec is None:
        return w
    out = w
    for dim, entry in enumerate(spec):
        for a in axes_of(entry):
            if a == "data" or (whole and a == "model"):
                if len(axes_of(entry)) > 1:
                    raise ValueError(f"a parameter dim split over "
                                     f"{entry} is not gathered here")
                out = gather(out, "fsdp" if a == "data" else "tp", dim)
    return out


# ---------------------------------------------------------------- logits

def logit_layout(cfg, seq: int) -> Optional[str]:
    """How the logits lie over 'model': 'vocab' (the vocab divides TP),
    'seq' (it does not and the sequence does, S > 1: the JAX package's
    odd-vocab rule) or None (whole on every rank)."""
    if not active() or not rule_axes("tp"):
        return None
    tp = size("tp")
    if cfg.vocab % tp == 0:
        return "vocab"
    if tp > 1 and seq % tp == 0 and seq > 1:
        return "seq"
    return None


def full_logits(logits: torch.Tensor, cfg, seq: int) -> torch.Tensor:
    """The rank's logits gathered over 'model' to (B_local, S, V)."""
    layout = logit_layout(cfg, seq)
    if layout == "vocab":
        return gather(logits, "tp", -1)
    if layout == "seq":
        return gather(logits, "tp", 1)
    return logits


def greedy(last: torch.Tensor, cfg, seq: int) -> torch.Tensor:
    """argmax over the vocab of the last position's float32 logits (B, V
    or its block), ties to the first global index, as ``torch.argmax``
    keeps them: each rank's first maximum and its global index are
    gathered over 'model' and the first rank holding the largest value
    wins (the blocks are in vocab order)."""
    layout = logit_layout(cfg, seq)
    if layout is None:
        return torch.argmax(last, dim=-1)
    if layout == "seq":        # the last rank on 'model' holds position S-1
        return gather(torch.argmax(last, dim=-1)[None], "tp", 0)[-1]
    if cfg.vocab >= 1 << 24:
        raise ValueError("vocab indices above 2**24 do not ride float32")
    i = torch.argmax(last, dim=-1)
    m = last.gather(-1, i[..., None])[..., 0]
    i = i + index("tp") * last.shape[-1]
    both = gather(torch.stack([m, i.to(m.dtype)])[None], "tp", 0)
    win = torch.argmax(both[:, 0], dim=0)              # first rank's max
    return both[:, 1].gather(0, win[None])[0].to(torch.int64)


def batch_rows(n: int) -> slice:
    """This rank's rows of a batch of ``n``, which must split over the
    'batch' axes (('pod', 'data')); all of them off a mesh."""
    k = size("batch")
    if n % k:
        raise ValueError(f"a batch of {n} does not split over the "
                         f"{k} ranks of {rule_axes('batch')}")
    b = n // k
    return slice(index("batch") * b, (index("batch") + 1) * b)


def gather_batch(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of the batch along dim 0, in order."""
    return gather(x, "batch", 0)


@contextlib.contextmanager
def use(mesh):
    """The rules of ``mesh`` on this thread for the block (nothing changes
    for None), the earlier state restored after it."""
    if mesh is None:
        yield
        return
    keys = ("active", "rules", "sizes", "coords", "mesh")
    saved = {k: getattr(_state, k) for k in keys if hasattr(_state, k)}
    set_rules(mesh)
    try:
        yield
    finally:
        for k in keys:
            if k in saved:
                setattr(_state, k, saved[k])
            elif hasattr(_state, k):
                delattr(_state, k)
