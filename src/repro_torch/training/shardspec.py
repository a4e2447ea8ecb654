"""Parameter / state / batch / cache PartitionSpecs, and each rank's block.

The port of the JAX package's ``training/shardspec.py``. Specs are derived
from leaf NAMES (``models.sharding.PARAM_RULES``), divisibility-checked
per dim against the mesh. FSDP = 'data', TP = 'model'; the pod axis
carries pure data parallelism (batch only), so parameters are replicated
across pods.

Each function takes either a pytree of arrays as the JAX package's (nested
dicts and lists; a leaf's name is its last dict key, and the leading
stacked dims of ``params["blocks"][seg]`` map to None) or the port's own
objects: :func:`param_pspecs` of an ``nn.Module`` is a flat dict by
``named_parameters`` name, each leaf unstacked (``Block`` a layer), so its
spec is the JAX package's without the leading stack dim. The port's
caches keep the JAX package's stacked layout, and so their specs. Specs
are ``models.sharding.PartitionSpec``s.

:func:`local_index` is the rank's block of a leaf by its spec and the
rank's mesh coordinates (the first axis of a multi-axis entry major, as
JAX lays out a ``PartitionSpec``); :func:`shard_module` cuts every
parameter of a module to its block and tags it with its spec. One leaf
departs from a plain block: Mamba1's ``in_proj`` (d, 2·di) holds
``[xin | z]`` side by side, so the 'model' block of its columns would give
the first ranks only xin channels and the last only z. Each rank holds
instead the xin and the z columns of its own di/TP channels, the same
number of bytes as the spec's block, and every cut here (the conversion,
``init_params(mesh=)``, ``launch.elastic.restart``) makes that one.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.models.sharding import (PartitionSpec, axes_of,
                                         base_param_spec, fit_axes,
                                         mesh_sizes)

TP = "model"


def _sizes(mesh) -> dict:
    """Axis sizes of a ``DeviceMesh``, a ``launch.elastic.MeshPlan`` (the
    mesh a restart is about to build) or a dict of them; {} for names."""
    if hasattr(mesh, "mesh_dim_names"):
        return mesh_sizes(mesh)
    if hasattr(mesh, "axes") and hasattr(mesh, "shape"):
        return dict(zip(mesh.axes, mesh.shape))
    return dict(mesh) if isinstance(mesh, dict) else {}


def _names(mesh) -> tuple:
    if mesh is None:
        return ()
    if hasattr(mesh, "mesh_dim_names"):
        return tuple(mesh.mesh_dim_names)
    if hasattr(mesh, "axes") and hasattr(mesh, "shape"):
        return tuple(mesh.axes)
    return tuple(mesh)


def _fit(entry, dim: int, sizes: dict):
    if entry is None or not sizes:
        return entry
    return fit_axes(entry, dim, sizes)


def _map(tree, fn, name: str = ""):
    """``fn(name, leaf)`` over a nest of dicts, lists and tuples; a leaf's
    name is its last dict key. None holds no leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(v, fn, str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, name) for v in tree)
    return fn(name, tree)


def leaf_names(tree, name: str = "") -> list:
    """Each leaf's name (its last dict key), in the checkpoint's leaf order
    (dict keys sorted, sequences in order)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], str(k))]
    if isinstance(tree, (list, tuple)):
        return [n for v in tree for n in leaf_names(v, name)]
    return [name]


def _shape(leaf) -> tuple:
    return tuple(np.shape(leaf)) if not isinstance(leaf, torch.Tensor) \
        else tuple(leaf.shape)


def _param_spec(name: str, shape: tuple, sizes: dict) -> PartitionSpec:
    nd = len(shape)
    base = base_param_spec(name, nd, shape, sizes)
    if base is None:
        return PartitionSpec()     # replicate (norm scales, misc)
    pad = nd - len(base)
    if pad < 0:                    # unstacked variant of a stacked rule
        base = base[-nd:] if nd else ()
        pad = 0
    full = (None,) * pad + tuple(base)
    return PartitionSpec(*(_fit(e, d, sizes) for e, d in zip(full, shape)))


def param_pspecs(params, mesh=None):
    """Specs of ``params``: an ``nn.Module`` (a dict by parameter name; a
    parameter already cut to its block answers with the spec it carries)
    or a pytree of arrays (the same structure). With ``mesh`` (a
    ``DeviceMesh``, a ``MeshPlan`` or a dict of axis sizes), specs are
    divisibility-checked per dim."""
    sizes = _sizes(mesh)
    if isinstance(params, nn.Module):
        return {n: (p.spec if getattr(p, "spec", None) is not None
                    else _param_spec(n.rsplit(".", 1)[-1], tuple(p.shape),
                                     sizes))
                for n, p in params.named_parameters()}
    return _map(params, lambda n, x: _param_spec(n, _shape(x), sizes))


def state_pspecs(state, mesh=None) -> dict:
    """Train-state specs: params/master/m/v mirror param specs; step
    replicated."""
    out = {}
    for k in ("params", "master", "m", "v"):
        if k in state:
            out[k] = param_pspecs(state[k], mesh)
    out["step"] = PartitionSpec()
    return out


def _batch_entry(mesh):
    baxes = tuple(a for a in ("pod", "data") if a in _names(mesh))
    return baxes if len(baxes) > 1 else (baxes[0] if baxes else None)


def batch_pspecs(batch, mesh):
    """Batch dims shard over ('pod', 'data'); mrope positions keep their
    leading 3-axis replicated; everything else follows the batch dim."""
    sizes, b = _sizes(mesh), _batch_entry(mesh)

    def spec(name, leaf):
        shape = _shape(leaf)
        nd = len(shape)
        if name == "positions" and nd == 3:   # (3, B, S) mrope
            return PartitionSpec(None, _fit(b, shape[1], sizes), None)
        if not nd:
            return PartitionSpec()
        return PartitionSpec(_fit(b, shape[0], sizes), *(None,) * (nd - 1))

    return _map(batch, spec)


def cache_pspecs(cache, mesh):
    """Decode cache: the batch dim shards over ('pod', 'data'), kv heads
    over 'model' (dim -2 of (L?, B, S, KV, dh) tensors) or, where they do
    not divide TP and the head dim does, the head dim; Mamba1's ssm
    (L, B, di, N) and conv (L, B, K-1, di) states their channels; ``len``
    (a Python int in the port) replicated."""
    names, sizes, b = _names(mesh), _sizes(mesh), _batch_entry(mesh)
    tp = TP if TP in names else None

    def spec(name, leaf):
        shape = _shape(leaf)
        nd = len(shape)
        if name == "len" or nd == 0:
            return PartitionSpec()
        if name in ("k", "v", "xk", "xv", "attn_k", "attn_v"):
            kv_dim, dh_dim = shape[-2], shape[-1]
            tp_sz = sizes.get(tp, 1) if tp else 1
            if tp and kv_dim % tp_sz and dh_dim % tp_sz == 0:
                raw = ((None, b, None, None, tp) if nd == 5
                       else (b, None, None, tp))
            else:
                raw = ((None, b, None, tp, None) if nd == 5
                       else (b, None, tp, None))
        elif name == "ssm":
            raw = (None, b, tp) + (None,) * (nd - 3)
        elif name == "conv":
            raw = (None, b, None, tp)
        else:
            raw = (b,) + (None,) * (nd - 1)
        return PartitionSpec(*(_fit(e, d, sizes) for e, d in zip(raw,
                                                                 shape)))

    return _map(cache, spec)


# ---------------------------------------------------------------- blocks

def _coords(mesh) -> dict:
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not on the mesh")
    return dict(zip(mesh.mesh_dim_names, (int(c) for c in coord)))


def local_index(name: str, spec, shape, mesh) -> tuple:
    """This rank's block of a leaf named ``name`` of full ``shape`` laid
    out by ``spec`` on ``mesh``: one indexer a dim (a slice, or for
    ``in_proj``'s columns the rank's xin and z channels). Raises where an
    axis is not the mesh's or a split dim does not divide."""
    sizes, coords = mesh_sizes(mesh), _coords(mesh)
    out = []
    for dim, n in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        k, i = 1, 0
        for a in axes_of(entry):
            if a not in sizes:
                raise ValueError(f"{name}: axis {a!r} of spec {spec} is not "
                                 f"an axis of the mesh "
                                 f"{tuple(mesh.mesh_dim_names)}")
            k, i = k * sizes[a], i * sizes[a] + coords[a]
        if n % k:
            raise ValueError(f"{name}: dim {dim} of size {n} does not split "
                             f"over {entry} ({k} ranks)")
        b = n // k
        if name == "in_proj" and dim == len(shape) - 1 and k > 1:
            if (n // 2) % k:
                raise ValueError(f"in_proj: {n // 2} channels do not split "
                                 f"over {k} ranks")
            c = n // 2 // k
            out.append(np.r_[i * c:(i + 1) * c, n // 2 + i * c:
                             n // 2 + (i + 1) * c])
        else:
            out.append(slice(i * b, (i + 1) * b))
    return tuple(out)


def local_block(x, spec, mesh, name: str = ""):
    """``x``'s block on this rank (see :func:`local_index`)."""
    idx = local_index(name, spec, _shape(x), mesh)
    if isinstance(x, torch.Tensor):
        idx = tuple(torch.as_tensor(i, device=x.device)
                    if isinstance(i, np.ndarray) else i for i in idx)
    return x[idx]


def shard_module(module: nn.Module, mesh, specs=None) -> nn.Module:
    """Cut every parameter of ``module`` (whole, as drawn or converted) to
    this rank's block in place, each tagged ``.spec`` with its spec
    (``param_pspecs(module, mesh)`` unless ``specs`` names them); a
    parameter tagged already stays. A block that is the whole tensor (a
    mesh of one rank) shares its storage: the cut allocates nothing."""
    specs = specs or param_pspecs(module, mesh)
    with torch.no_grad():
        for name, p in list(module.named_parameters()):
            if getattr(p, "spec", None) is not None:      # cut already
                continue
            owner, _, leaf = name.rpartition(".")
            parent = module.get_submodule(owner) if owner else module
            blk = nn.Parameter(local_block(p.data, specs[name], mesh,
                                           leaf).contiguous(),
                               requires_grad=False)
            blk.spec = specs[name]
            setattr(parent, leaf, blk)
    return module


def local_shape(name: str, spec, shape, mesh) -> tuple:
    """The shape of this rank's block of a leaf of full ``shape``."""
    return tuple(torch.empty(shape, device="meta")[
        local_index(name, spec, shape, mesh)].shape)


def local_cache_shapes(shapes: dict, mesh) -> dict:
    """{cache leaf name: full shape} -> the shapes of this rank's blocks
    by :func:`cache_pspecs` (the full shapes where ``mesh`` is None)."""
    if mesh is None:
        return shapes
    specs = cache_pspecs({k: torch.empty(v, device="meta")
                          for k, v in shapes.items()}, mesh)
    return {k: local_shape(k, specs[k], v, mesh) for k, v in shapes.items()}
