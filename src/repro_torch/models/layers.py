"""Model building blocks of the dense decoder and ssm families: RMS norm,
RoPE, attention (prefill through kernel K7, decode as plain ops), the
attention projections, the gated MLP, the embeddings and the Mamba1 (S6)
mixer (its scan through kernel K8 for L > 1, decode as plain ops).

The functions mirror the JAX package's ``models/layers.py`` and keep its
layouts: activations (B, S, d), heads (B, S, H, dh), projections wq (d, H,
dh) and wo (H, dh, d). Parameters are ``nn.ParameterDict``s: matrices,
biases and embeddings are stored in the compute dtype (the JAX package
keeps float32 and casts at every use, which gives the same bits), norm
scales and the Mamba decays ``A_log`` and skip ``D`` in float32, where the
reference upcasts them. The MoE and Mamba2 blocks, M-RoPE and LayerNorm
come with their families (ROADMAP A10).

On a mesh (``models.sharding.set_rules``) each parameter is the rank's
block (``training.shardspec.shard_module``) and the functions state the
JAX package's sharding constraints as collectives (``models.sharding``'s
helpers, identities off a mesh): heads, the MLP's hidden units, the vocab
and the Mamba channels split over 'model', every product's 'data' dims
all-gathered first, one all_reduce after each row-parallel product.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels.mamba_scan import scan_step
from repro_torch.models import sharding as sh


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _normal(gen: torch.Generator, shape, std: float, dtype,
            device) -> nn.Parameter:
    """N(0, std²) drawn in float32 from ``gen`` on ``device``, cast to
    ``dtype`` at once (so a float32 copy of a bf16 model never exists)."""
    t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return _param(t.mul_(std).to(dtype))


def _zeros(shape, dtype, device) -> nn.Parameter:
    return _param(torch.zeros(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------- norms

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x·rsqrt(mean(x²) + eps)·(1 + scale), in float32, cast back."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


# ---------------------------------------------------------------- RoPE

def rope_freqs(dh: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, dh, 2, dtype=np.float32) / dh))


@functools.lru_cache(maxsize=16)
def _rope_freqs_on(dh: int, theta: float, device: torch.device):
    """``rope_freqs`` uploaded once per device: a copy from host memory
    waits for the device's queue, which every layer of every step would
    otherwise do twice."""
    return torch.from_numpy(rope_freqs(dh, theta)).to(device)


def apply_rope(x: torch.Tensor, pos: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, dh); pos: broadcastable to (..., S). Rotates the two
    halves of dh (not interleaved pairs) by float32 angles."""
    dh = x.shape[-1]
    inv = _rope_freqs_on(dh, float(theta), x.device)
    ang = pos[..., None].float() * inv                      # (..., S, dh/2)
    ang = ang[..., None, :]                                  # add head dim
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, dh); k, v: (B, Sk, KV, dh) with H % KV == 0 (GQA).
    ``q_offset`` is the absolute position of q[0]; ``window`` masks keys
    with q_pos - k_pos >= window. Kernel K7 on the card (as the TPU takes
    its Pallas kernel), its plain version on the CPU."""
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int,
                     cfg) -> torch.Tensor:
    """Single-token attention against a KV cache, as plain ops (the JAX
    package has no kernel for it either).

    q: (B, H, dh); caches: (B, S, KV, dh); cache_len: #valid entries (the
    new token's k/v already written at cache_len - 1). A window segment's
    ring buffer holds only the window, so no window mask is needed.

    On a mesh q holds the rank's heads and the caches its block: its kv
    heads (:func:`kv_for_heads` picks each q head's), or, where the kv
    heads do not divide TP, its slice of the head dim. Then each rank
    scores every head on its slice, one all_reduce over 'model' sums the
    partial scores before the softmax (a sum over ranks, so the float32
    dot products associate differently), and the rank's slice of p·V is
    all-gathered back to whole heads."""
    if k_cache.shape[-1] < q.shape[-1]:
        return _decode_dh_split(q, k_cache, v_cache, cache_len, cfg)
    k_cache, v_cache = kv_for_heads(k_cache, v_cache, q.shape[1], cfg)
    B, H, dh = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    g = H // KV
    scale = 1.0 / math.sqrt(dh)
    qr = q.reshape(B, KV, g, dh).float() * scale
    s = torch.einsum("bkgd,bskd->bkgs", qr, k_cache.float())
    kpos = torch.arange(S, device=q.device)
    s = s.masked_fill(kpos >= cache_len, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return o.reshape(B, H, dh).to(q.dtype)


def _decode_dh_split(q, k_cache, v_cache, cache_len: int, cfg):
    """:func:`decode_attention` on a cache split on its head dim over
    'model': every head's partial scores on the rank's slice, summed by
    one all_reduce, then the rank's slice of p·V gathered to whole heads,
    of which the rank keeps its own."""
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    Hl = q.shape[1]
    qa = sh.gather(q, "tp", 1) if Hl < H else q            # (B, H, dh)
    B, S, dhl = q.shape[0], k_cache.shape[1], k_cache.shape[-1]
    lo = sh.index("tp") * dhl
    qr = qa.reshape(B, KV, H // KV, dh).float() * (1.0 / math.sqrt(dh))
    s = torch.einsum("bkgd,bskd->bkgs", qr[..., lo:lo + dhl],
                     k_cache.float())
    s = sh.reduce(s, "tp")
    kpos = torch.arange(S, device=q.device)
    s = s.masked_fill(kpos >= cache_len, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    o = sh.gather(o, "tp", -1).reshape(B, H, dh)
    if Hl < H:
        o = o[:, sh.index("tp") * Hl:(sh.index("tp") + 1) * Hl]
    return o.to(q.dtype)


def kv_for_heads(k: torch.Tensor, v: torch.Tensor, n_q: int, cfg):
    """The keys and values the rank's ``n_q`` query heads read, laid out
    so that local q head i reads local kv head i // (n_q / KV_local), as
    K7 and :func:`decode_attention` take GQA. Off a mesh, and where q and
    kv heads split over 'model' alike, that is all of ``k`` and ``v``.
    Where the kv heads are whole (they do not divide TP: wk and wv are
    row-parallel) each local q head takes its GLOBAL kv head,
    ``global_head // (H / KV)``: a slice of ``k`` when the local heads
    share them evenly, else one kv head a q head."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    KVl = k.shape[2]
    if n_q == H and KVl == KV:
        return k, v
    g = H // KV
    r = sh.index("tp")
    q_off = r * n_q if n_q < H else 0
    kv_off = r * KVl if KVl < KV else 0
    need = [(q_off + i) // g - kv_off for i in range(n_q)]
    lo, n = need[0], need[-1] - need[0] + 1
    if n_q % n == 0 and need == [lo + i // (n_q // n) for i in range(n_q)]:
        return k.narrow(2, lo, n), v.narrow(2, lo, n)
    idx = torch.tensor(need, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


# ---------------------------------------------------------------- attention block

def attn_proj_params(gen: torch.Generator, cfg, dtype,
                     device) -> nn.ParameterDict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    std = d ** -0.5
    p = nn.ParameterDict({
        "wq": _normal(gen, (d, h, dh), std, dtype, device),
        "wk": _normal(gen, (d, kv, dh), std, dtype, device),
        "wv": _normal(gen, (d, kv, dh), std, dtype, device),
        "wo": _normal(gen, (h, dh, d), (h * dh) ** -0.5, dtype, device),
    })
    if cfg.qkv_bias:
        p["bq"] = _zeros((h, dh), dtype, device)
        p["bk"] = _zeros((kv, dh), dtype, device)
        p["bv"] = _zeros((kv, dh), dtype, device)
    if cfg.qk_norm:
        p["q_norm"] = _zeros((dh,), torch.float32, device)
        p["k_norm"] = _zeros((dh,), torch.float32, device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def qkv(x: torch.Tensor, p, cfg, whole: bool = False):
    """(B, S, d) -> q (B, S, H, dh), k and v (B, S, KV, dh).

    On a mesh: q's heads are the rank's where wq splits them over 'model';
    k and v likewise, or, where the kv heads do not divide TP (wk and wv
    row-parallel over d_model), whole heads after one all_reduce of the
    rank's partial products each. ``whole``: every weight gathered whole
    (the batch fold's attention on the rank's rows)."""
    q = _proj(x, sh.weight(p["wq"], whole))
    k, v = (_kv_proj(x, p[w], whole) for w in ("wk", "wv"))
    if cfg.qkv_bias:
        q = q + sh.weight(p["bq"], whole)
        k = k + sh.weight(p["bk"], whole)
        v = v + sh.weight(p["bv"], whole)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _kv_proj(x: torch.Tensor, w, whole: bool) -> torch.Tensor:
    if whole or not sh.split(w, 0):
        return _proj(x, sh.weight(w, whole))
    # row-parallel: the rank's d_model rows, then the sum over 'model'
    n = w.shape[0]
    lo = sh.index("tp") * n
    return sh.reduce(_proj(x[..., lo:lo + n].contiguous(), w), "tp")


def attn_out(o: torch.Tensor, p, x_dtype, whole: bool = False):
    """(B, S, H, dh) -> (B, S, d): einsum('bshk,hkd->bsd'); on a mesh the
    rank's heads' share, summed over 'model' where wo splits its heads."""
    wo = sh.weight(p["wo"], whole)
    h, k, d = wo.shape
    y = (o.flatten(-2) @ wo.reshape(h * k, d)).to(x_dtype)
    if not whole and sh.split(p["wo"], 0):
        y = sh.reduce(y, "tp")
    return y


def batch_fold(cfg, x: torch.Tensor) -> Optional[slice]:
    """The rank's rows of the attention block when it folds its batch over
    'model' too (the JAX package's ``batch_tp``: ``cfg.attn_batch_fold``,
    heads that do not divide TP, a prefill, local rows that split over
    TP), else None. The fold runs the projections and attention on
    B_local / TP rows with whole weights, so no TP rank repeats another's
    work; unfolded, each TP rank computes every head of its rows, with the
    same results."""
    tp = sh.size("tp")
    B = x.shape[0]
    if not (cfg.attn_batch_fold and tp > 1 and cfg.n_heads % tp
            and x.shape[1] > 1 and B % tp == 0):
        return None
    b = B // tp
    return slice(sh.index("tp") * b, (sh.index("tp") + 1) * b)


# ---------------------------------------------------------------- MLP

def mlp_params(gen: torch.Generator, d: int, d_ff: int, dtype,
               device) -> nn.ParameterDict:
    return nn.ParameterDict({
        "w_gate": _normal(gen, (d, d_ff), d ** -0.5, dtype, device),
        "w_up": _normal(gen, (d, d_ff), d ** -0.5, dtype, device),
        "w_down": _normal(gen, (d_ff, d), d_ff ** -0.5, dtype, device),
    })


def mlp(x: torch.Tensor, p, act: str = "silu") -> torch.Tensor:
    """The gated MLP. ``gelu`` is the tanh approximation, as
    ``jax.nn.gelu``'s default. On a mesh the hidden units are the rank's
    and w_down's product is summed over 'model'."""
    g = x @ sh.weight(p["w_gate"])
    u = x @ sh.weight(p["w_up"])
    h = (F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")) * u
    y = h @ sh.weight(p["w_down"])
    return sh.reduce(y, "tp") if sh.split(p["w_down"], 0) else y


# ---------------------------------------------------------------- embedding

def embed_params(gen: torch.Generator, cfg, dtype,
                 device) -> nn.ParameterDict:
    p = nn.ParameterDict({
        "tok": _normal(gen, (cfg.vocab, cfg.d_model), 0.02, dtype, device)})
    if not cfg.tie_embeddings:
        p["unembed"] = _normal(gen, (cfg.d_model, cfg.vocab),
                               cfg.d_model ** -0.5, dtype, device)
    return p


def embed(tokens: torch.Tensor, p) -> torch.Tensor:
    """The token rows of ``tok``. On a mesh that splits the vocab over
    'model', each rank looks up the tokens in its own rows, zero for the
    rest, and one all_reduce adds the ranks' rows (exact: one addend is
    nonzero)."""
    tok = sh.weight(p["tok"])
    if not sh.split(p["tok"], 0):
        return tok[tokens]
    V = tok.shape[0]
    idx = tokens - sh.index("tp") * V
    mine = (idx >= 0) & (idx < V)
    e = torch.where(mine[..., None], tok[idx.clamp(0, V - 1)],
                    torch.zeros((), dtype=tok.dtype, device=tok.device))
    return sh.reduce(e, "tp")


def unembed(x: torch.Tensor, p, cfg) -> torch.Tensor:
    """Logits in x's dtype; tied embeddings unembed by ``tok``ᵀ. On a mesh
    they are the rank's block as ``sharding.logit_layout`` gives it: its
    vocab columns, or, where the vocab does not divide TP, its rows of
    the sequence."""
    if cfg.tie_embeddings:
        w = sh.weight(p["tok"]).T
    else:
        w = sh.weight(p["unembed"])
    if sh.logit_layout(cfg, x.shape[1]) == "seq":
        n = x.shape[1] // sh.size("tp")
        x = x[:, sh.index("tp") * n:(sh.index("tp") + 1) * n]
    return x @ w


# ---------------------------------------------------------------- Mamba1 (S6)

def mamba1_params(gen: torch.Generator, cfg, dtype,
                  device) -> nn.ParameterDict:
    """The JAX package's ``mamba1_params`` distributions, drawn from
    ``gen``: dt_proj_b is the inverse softplus of a log-uniform step in
    [0.001, 0.1], A_log = log(1..N) on every channel, D ones."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    N = s.d_state
    dt_rank = max(d // 16, 1)
    p = nn.ParameterDict({
        "in_proj": _normal(gen, (d, 2 * di), d ** -0.5, dtype, device),
        "conv_w": _normal(gen, (s.d_conv, di), s.d_conv ** -0.5, dtype,
                          device),
        "conv_b": _zeros((di,), dtype, device),
        "x_proj": _normal(gen, (di, dt_rank + 2 * N), di ** -0.5, dtype,
                          device),
        "dt_proj_w": _normal(gen, (dt_rank, di), dt_rank ** -0.5, dtype,
                             device),
    })
    u = torch.rand((di,), generator=gen, dtype=torch.float32, device=device)
    step = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    p["dt_proj_b"] = _param(torch.log(torch.expm1(step)).to(dtype))
    p["A_log"] = _param(torch.log(torch.arange(
        1, N + 1, dtype=torch.float32, device=device)).repeat(di, 1))
    p["D"] = _param(torch.ones((di,), dtype=torch.float32, device=device))
    p["out_proj"] = _normal(gen, (di, d), di ** -0.5, dtype, device)
    return p


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) everywhere (``F.softplus``
    returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d as the JAX package writes it: the K shifted
    products summed in order in x's dtype, then the bias. x: (B, L, C);
    w: (K, C); state: (B, K-1, C), the context carried across calls
    (decode). Returns (y, new state)."""
    K = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)
    L = x.shape[1]
    y = xp[:, 0:L] * w[0].to(x.dtype)
    for i in range(1, K):
        y = y + xp[:, i:i + L] * w[i].to(x.dtype)
    return y + b.to(x.dtype), xp[:, -(K - 1):] if K > 1 else state


def mamba1_mixer(x: torch.Tensor, p, cfg, state: Optional[dict] = None):
    """Selective SSM (S6). x: (B, L, d); state: None (prefill, forward) or
    dict(conv (B, K-1, di), ssm (B, di, N) float32) to continue from.
    Returns (y (B, L, d), dict(conv, ssm) after the last step).

    The JAX package's casts: projections, conv, softplus in x's dtype;
    A = -exp(A_log) float32; the scan's y float32 until ``+ xc·D``. For
    L > 1 the scan is one call of ``ops.mamba1_scan`` (K8 on the card) from
    ``state["ssm"]``. For L == 1 (decode) it is the reference's one
    recurrence step as plain ops, ``mamba_scan.scan_step``, in float32 as
    K8 forms it (the reference rounds δ·x·B to x's dtype there). x_proj
    and out_proj go through ``ops.batch_invariant_matmul``, so that a
    decode step's rows round as the same rows of a prefill or forward do.

    On a mesh the rank runs its di/TP channels: in_proj's xin and z
    columns of them (``training.shardspec``), conv, dt_proj, A_log and D
    their blocks, and K8 on them. x_proj and out_proj are row-parallel:
    the rank's product (still ``batch_invariant_matmul``) is summed over
    'model' by one all_reduce each, which reorders the float32 sum over
    the channels.
    """
    s = cfg.ssm
    B, L, _ = x.shape
    N = s.d_state
    xin, z = (x @ sh.weight(p["in_proj"])).chunk(2, dim=-1)
    xc, conv_state = _causal_conv(xin, p["conv_w"], p["conv_b"],
                                  None if state is None else state["conv"])
    xc = F.silu(xc)
    dt_rank = p["dt_proj_w"].shape[0]
    proj = ops.batch_invariant_matmul(xc, p["x_proj"])
    if sh.split(p["x_proj"], 0):
        proj = sh.reduce(proj, "tp")
    dt, Bs, Cs = proj.split([dt_rank, N, N], dim=-1)
    delta = softplus(dt @ p["dt_proj_w"] + p["dt_proj_b"])   # (B, L, di)
    A = -torch.exp(p["A_log"].float())                         # (di, N)
    h_prev = None if state is None else state["ssm"]
    if L == 1:              # decode: one recurrence step, no scan
        if h_prev is None:
            h_prev = torch.zeros((B, A.shape[0], N), dtype=torch.float32,
                                 device=x.device)
        h_last, y = scan_step(h_prev, delta[:, 0].float(), xc[:, 0].float(),
                              Bs[:, 0].float(), Cs[:, 0].float(), A)
        y = y[:, None]
    else:
        y, h_last = ops.mamba1_scan(xc, delta, Bs.contiguous(),
                                    Cs.contiguous(), A, h_prev,
                                    return_state=True, y_dtype=torch.float32)
    y = (y + xc * p["D"].float()).to(x.dtype)
    y = y * F.silu(z)
    out = ops.batch_invariant_matmul(y, sh.weight(p["out_proj"]))
    if sh.split(p["out_proj"], 0):
        out = sh.reduce(out, "tp")
    return out, {"conv": conv_state, "ssm": h_last}
