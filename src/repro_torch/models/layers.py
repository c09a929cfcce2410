"""Shared layers of the dense decoder, in PyTorch.

The port of the dense subset of ``repro.models.layers``: the same
initialisers, RMSNorm (fp32 accumulation), rotary embeddings (fp32 angles
from integer positions), the gated MLP, the attention projections and the
plain attention functions.  Weights of ``nn.Linear`` are ``[out, in]``,
the transpose of the reference's ``[in, out]``.

Attention comes in three implementations, chosen by
``ModelConfig.attn_impl``:

* ``dense``   — the plain O(S^2) attention below (``dense_attention``,
                ``decode_attention``, which also reads an int8 cache
                quantized by ``quantize_kv``)
* ``blocked`` — the reference's default for a full sequence
                (``blocked_attention``: an online softmax over kv blocks,
                q in chunks, in plain PyTorch); decode as ``dense``
* ``kernel``  — the hand-written CUDA kernels (``repro_torch.kernels``),
                which take their plain versions only for CPU tensors
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.sharding.plan import (contiguous_stride, local_index,
                                       local_offset, shard, splits_evenly,
                                       to_placements)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Initializers (in place, from an explicit generator; drawn in fp32)
# ---------------------------------------------------------------------------


@torch.no_grad()
def dense_init_(w: torch.Tensor, generator: torch.Generator,
                fan_in: Optional[int] = None) -> None:
    """Truncated-normal (±2σ) fan-in init of an ``[out, in]`` weight, or
    of a stack ``[E, in, out]``: the fan-in is ``w.shape[1]`` unless
    given."""
    x = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    bound = math.erf(math.sqrt(2.0))              # 2Φ(2) - 1
    x.uniform_(-bound, bound, generator=generator)
    x.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    w.copy_(x.mul_(1.0 / math.sqrt(fan_in or w.shape[1])))


@torch.no_grad()
def embed_init_(w: torch.Tensor, generator: torch.Generator) -> None:
    """Normal / sqrt(d) init of a ``[vocab, d]`` embedding table."""
    x = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    x.normal_(generator=generator)
    w.copy_(x.mul_(1.0 / math.sqrt(w.shape[1])))


def linear(d_in: int, d_out: int, bias: bool, device, dtype) -> nn.Linear:
    """An ``nn.Linear`` whose storage is left for the model's own init."""
    return uninitialized(nn.Linear(d_in, d_out, bias=bias, device="meta",
                                   dtype=dtype), device)


def uninitialized(module: nn.Module, device) -> nn.Module:
    """``module`` (built on the meta device) with empty parameters on
    ``device``: ``nn.utils.skip_init``, by new ``Parameter`` objects (its
    in-place swap fails on a fake tensor: the dry run builds models under
    ``FakeTensorMode``)."""
    for name, p in list(module.named_parameters(recurse=False)):
        setattr(module, name, nn.Parameter(torch.empty_like(p,
                                                             device=device)))
    return module


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def embed_lookup(weight: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``weight[tokens]``; under a plan that shards the table's vocab
    dim, a vocab-parallel lookup.

    Each rank looks up the tokens that fall in its slice of the
    vocabulary (zeros elsewhere) in its local rows, and the result is a
    ``Partial`` sum over the vocab-sharding mesh dims, which the
    caller's placement reduces.  DTensor's own embedding rule yields a
    masked partial that cannot be moved to a ``Shard``, nor its
    gradient back from a ``Partial`` one.
    """
    if not isinstance(weight, DTensor) or not any(
            p.is_shard(0) for p in weight.placements):
        return F.embedding(tokens, weight)
    mesh, wpl = weight.device_mesh, weight.placements
    if any(p.is_shard(1) for p in wpl):
        raise ValueError(f"embedding table placed {wpl}: its feature dim "
                         "is not sharded by any rule")
    if not isinstance(tokens, DTensor):
        tokens = to_placements(tokens, mesh, [Replicate()] * mesh.ndim)
    # the tokens whole on the mesh dims that split the vocabulary
    tpl = [Replicate() if w.is_shard(0) else t
           for w, t in zip(wpl, tokens.placements)]
    tokens = to_placements(tokens, mesh, tpl)
    # the local rows' gradient covers this rank's tokens only: a partial
    # sum over the mesh dims that split the tokens and replicate the table
    local = weight.to_local(grad_placements=[
        Partial() if w.is_replicate() and t.is_shard() else w
        for w, t in zip(wpl, tpl)])
    idx, inside = local_index(tokens.to_local(), local.shape[0],
                              local_offset(weight, 0))
    x = F.embedding(idx, local) * inside[..., None].to(local.dtype)
    shape = tuple(tokens.shape) + (weight.shape[1],)
    return DTensor.from_local(
        x, mesh, [Partial() if w.is_shard(0) else t
                  for w, t in zip(wpl, tpl)],
        shape=torch.Size(shape), stride=contiguous_stride(shape))


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm in fp32 accumulation, cast back to the input dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, device):
        super().__init__()
        self.eps = eps
        # the scale stays fp32 whatever the model's dtype, as in the
        # reference (init_rmsnorm)
        self.scale = nn.Parameter(torch.ones(d, dtype=torch.float32,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale, self.eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings (full / partial)
# ---------------------------------------------------------------------------


def rope_angles(positions: torch.Tensor, head_dim: int,
                rope_fraction: float = 1.0, theta: float = 10_000.0
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables of shape ``positions.shape + (rot_dim // 2,)``,
    computed in fp32 from integer positions."""
    rot_dim = int(head_dim * rope_fraction)
    rot_dim -= rot_dim % 2
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=positions.device) / rot_dim
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                            device=positions.device), exps)
    ang = positions.float()[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Rotate the leading ``2 * cos.shape[-1]`` channels of the head dim.

    x: [..., S, H, D]; cos/sin: [..., S, R/2] broadcast over heads.  The
    trailing ``D - R`` channels pass through (partial rotary).
    """
    r2 = cos.shape[-1]
    x1, x2, rest = x[..., :r2], x[..., r2:2 * r2], x[..., 2 * r2:]
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2, rest.to(out1.dtype)], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    def __init__(self, d: int, d_ff: int, activation: str, device, dtype):
        super().__init__()
        if activation not in ("swiglu", "geglu"):
            raise ValueError(f"unknown activation {activation!r}")
        self.activation = activation
        self.w_gate = linear(d, d_ff, False, device, dtype)
        self.w_up = linear(d, d_ff, False, device, dtype)
        self.w_down = linear(d_ff, d, False, device, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for lin in (self.w_gate, self.w_up, self.w_down):
            dense_init_(lin.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the hidden's placement pins ff -> "model" (the reference's
        # Megatron-SP pattern: gather activations, not weights)
        g = shard(self.w_gate(x), "batch", "seq", "ff")
        u = shard(self.w_up(x), "batch", "seq", "ff")
        if self.activation == "swiglu":
            h = F.silu(g) * u
        else:
            h = F.gelu(g, approximate="tanh") * u
        return self.w_down(h)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """GQA projections: ``proj`` (attention_proj) and ``out``
    (attention_out) of the reference."""

    def __init__(self, d: int, n_heads: int, n_kv_heads: int, head_dim: int,
                 qkv_bias: bool, device, dtype):
        super().__init__()
        self.n_heads, self.n_kv_heads, self.head_dim = (n_heads, n_kv_heads,
                                                        head_dim)
        self.wq = linear(d, n_heads * head_dim, qkv_bias, device, dtype)
        self.wk = linear(d, n_kv_heads * head_dim, qkv_bias, device, dtype)
        self.wv = linear(d, n_kv_heads * head_dim, qkv_bias, device, dtype)
        self.wo = linear(n_heads * head_dim, d, False, device, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for lin in (self.wq, self.wk, self.wv, self.wo):
            dense_init_(lin.weight, generator)
            if lin.bias is not None:
                with torch.no_grad():
                    lin.bias.zero_()

    def proj(self, x: torch.Tensor):
        """x [B,S,d] -> q [B,S,H,D], k [B,S,K,D], v [B,S,K,D].

        Under a plan q's features shard over heads (the reference's
        constraint), and k and v are placed as the reference places
        them after the rotary step, whole over heads and sequence,
        before they are split into heads."""
        B, S, _ = x.shape
        hd = self.head_dim
        if splits_evenly(self.n_heads, "heads"):
            q = shard(self.wq(x), "batch", "seq", "heads")
        else:
            # heads that do not divide their ranks (llava-next-34b's 56 on
            # 16): the weight's even feature chunks cut heads apart, so
            # q is gathered whole and split by heads after the view
            # (GSPMD pads instead)
            q = shard(self.wq(x), "batch", "seq", None)
        k = shard(self.wk(x), "batch", None, None)
        v = shard(self.wv(x), "batch", None, None)
        return (q.view(B, S, self.n_heads, hd),
                k.view(B, S, self.n_kv_heads, hd),
                v.view(B, S, self.n_kv_heads, hd))

    def out(self, o: torch.Tensor) -> torch.Tensor:
        B, S = o.shape[:2]
        if not splits_evenly(self.n_heads, "heads"):
            # unevenly split heads do not flatten into features (nor the
            # features' gradient unflatten into heads)
            o = shard(o, "batch", None, None, "head_dim")
            return self.wo(shard(o.reshape(B, S, -1), "batch", None, None))
        return self.wo(o.reshape(B, S, -1))


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B,S,K,D] -> [B,S,H,D] by repeating each kv head H/K times."""
    if k.shape[2] == n_heads:           # also a shard holding no head
        return k
    return k.repeat_interleave(n_heads // k.shape[2], dim=2)


def dense_attention(q, k, v, *, causal: bool, q_offset: int = 0
                    ) -> torch.Tensor:
    """Plain attention. q:[B,Sq,H,D] k,v:[B,Sk,K,D] -> [B,Sq,H,D].

    ``q_offset``: the position of q's first row (a sequence shard).
    DTensor inputs (under a plan) run ``sharded_attention``."""
    if isinstance(q, DTensor):
        return sharded_attention(q, k, v, causal=causal)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(D))
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(Sk, device=q.device)[None, :]
        logits = logits.masked_fill(qpos < kpos, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def blocked_attention(q, k, v, *, causal: bool, q_chunk: int = 512,
                      kv_chunk: int = 512, block_skip: bool = True,
                      q_offset: int = 0) -> torch.Tensor:
    """Flash-style attention: online softmax over kv blocks, chunked q.

    ``repro.models.layers.blocked_attention`` in PyTorch.  The scores
    live O(B * H * q_chunk * kv_chunk) at a time instead of O(S^2).
    With ``block_skip`` (causal only) each q chunk visits only its
    causal kv prefix.  q: [B,Sq,H,D]; k,v: [B,Sk,K,D] (K divides H, GQA
    without expanding kv) -> [B,Sq,H,D].  Ragged tails are padded; the
    padded kv positions are masked (by the causal mask when causal).
    ``q_offset``: the position of q's first row (a sequence shard).
    DTensor inputs (under a plan) run ``sharded_attention``."""
    if isinstance(q, DTensor):
        return sharded_attention(q, k, v, causal=causal, attend=(
            functools.partial(blocked_attention, q_chunk=q_chunk,
                              kv_chunk=kv_chunk, block_skip=block_skip)))
    B, Sq_real, H, D = q.shape
    Sk_real, K = k.shape[1], k.shape[2]
    # query heads per kv head (a head shard may hold none)
    G = H // max(K, 1)
    scale = 1.0 / math.sqrt(D)
    q_chunk = min(q_chunk, Sq_real)
    kv_chunk = min(kv_chunk, Sk_real)
    q = _pad_seq(q, q_chunk)
    k = _pad_seq(k, kv_chunk)
    v = _pad_seq(v, kv_chunk)
    nq, nk = q.shape[1] // q_chunk, k.shape[1] // kv_chunk
    kv_padded = k.shape[1] != Sk_real
    # float32 operands laid out for the two products of each block:
    # q [B,K,G,S,D] (scaled), k [B,K,D,S], v [B,K,S,D]; a chunk or a
    # block is a slice along S
    qh = (q.float() * scale).reshape(B, nq * q_chunk, K, G, D).permute(
        0, 2, 3, 1, 4)
    kt = k.float().permute(0, 2, 3, 1)
    vh = v.float().permute(0, 2, 1, 3)
    ar_q = torch.arange(q_chunk, device=q.device)
    ar_k = torch.arange(kv_chunk, device=q.device)
    outs = []
    for qi in range(nq):
        q0 = qi * q_chunk
        qc = qh[:, :, :, q0:q0 + q_chunk].reshape(B, K, G * q_chunk, D)
        if causal and block_skip:
            # only kv blocks whose start <= the q block's last position
            n_vis = min(nk, (q_offset + q0 + q_chunk + kv_chunk - 1)
                        // kv_chunk)
        else:
            n_vis = nk
        for j in range(n_vis):
            k0 = j * kv_chunk
            s = torch.matmul(qc, kt[..., k0:k0 + kv_chunk]).view(
                B, K, G, q_chunk, kv_chunk)
            # the reference masks every block; a block with nothing to
            # mask is left as it is (the same values)
            if causal and k0 + kv_chunk - 1 > q_offset + q0:
                s = s.masked_fill((q_offset + q0 + ar_q)[:, None]
                                  < (k0 + ar_k)[None, :], NEG_INF)
            elif not causal and kv_padded and j == nk - 1:
                s = s.masked_fill(k0 + ar_k >= Sk_real, NEG_INF)
            vj = vh[:, :, k0:k0 + kv_chunk]
            if n_vis == 1:
                # one block: the online softmax is the softmax itself
                p = torch.softmax(s, dim=-1).view(B, K, G * q_chunk,
                                                  kv_chunk)
                acc = torch.matmul(p, vj).view(B, K, G, q_chunk, D)
                l = None
                continue
            # the running max only steadies exp: the result does not
            # depend on it, so no gradient flows through it
            m_blk = s.detach().amax(dim=-1)
            if j == 0:
                # the running max starts at -inf: no correction yet
                m = m_blk
                p = torch.exp(s - m[..., None])
                l = p.sum(dim=-1)
                acc = torch.matmul(p.view(B, K, G * q_chunk, kv_chunk),
                                   vj).view(B, K, G, q_chunk, D)
                continue
            m_new = torch.maximum(m, m_blk)
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.matmul(p.view(B, K, G * q_chunk, kv_chunk), vj).view(
                B, K, G, q_chunk, D)
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc if l is None else acc / l[..., None].clamp_min(1e-30)
        # [B,K,G,q,D] -> [B,q,K*G,D]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, H, D))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out[:, :Sq_real].to(q.dtype)


def _pad_seq(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """Pad the seq axis (1) of [B,S,...] with zeros up to a multiple of
    ``chunk``."""
    rem = x.shape[1] % chunk
    if rem == 0:
        return x
    return F.pad(x, [0, 0] * (x.dim() - 2) + [0, chunk - rem])


def sharded_attention(q: DTensor, k, v, *, causal: bool,
                      attend=dense_attention) -> DTensor:
    """``attend`` (``dense_attention``, or ``blocked_attention`` with
    its chunks) on each rank's own (batch, heads, query rows) shard:
    attention is independent per sequence and head, so no collective
    runs inside it.  k and v take q's batch and head
    placements, whole over the sequence; where q's rows are split over
    a mesh dim, their gradient there is a partial sum.  (DTensor's own
    propagation of the attention einsums over a 3-D mesh takes minutes
    for one op.)"""
    mesh = q.device_mesh
    pl = [p if any(p.is_shard(d) for d in (0, 1, 2)) else Replicate()
          for p in q.placements]
    kpl = [Replicate() if p.is_shard(1) else p for p in pl]
    kgrad = [Partial() if p.is_shard(1) else p for p in pl]
    q = to_placements(q, mesh, pl)
    k, v = (to_placements(t, mesh, kpl).to_local(grad_placements=kgrad)
            for t in (k, v))
    o = attend(q.to_local(), k, v, causal=causal,
               q_offset=local_offset(q, 1))
    return DTensor.from_local(o.contiguous(), mesh, pl, shape=q.shape,
                              stride=contiguous_stride(q.shape))


def decode_attention(q, k_cache, v_cache, kv_len, *,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     extra_kv: Optional[tuple] = None) -> torch.Tensor:
    """Single-position attention against a (padded) KV cache.

    q: [B,1,H,D]; k_cache/v_cache: [B,Smax,K,D]; kv_len: [B] = number of
    valid cache positions.  ``extra_kv`` is the in-flight token's
    (k_new, v_new) [B,1,K,D], attended in addition to the kv_len cache
    entries (the deferred-commit path).

    int8 cache: pass the per-token-head ``k_scale``/``v_scale``
    [B,Smax,K]; they fold into the scores (before the mask) and into the
    softmax weights (after it), so no dequantized copy of the cache is
    formed.  The in-flight entry is not quantized.

    A DTensor cache (under a plan) runs ``sharded_decode_attention``.
    """
    if isinstance(k_cache, DTensor):
        return sharded_decode_attention(q, k_cache, v_cache, kv_len,
                                        k_scale=k_scale, v_scale=v_scale,
                                        extra_kv=extra_kv)
    B, _, H, D = q.shape
    Smax, K = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, K, H // K, D).float() * (1.0 / math.sqrt(D))
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    if k_scale is not None:
        s = s * k_scale.float().transpose(1, 2)[:, :, None, :]
    valid = torch.arange(Smax, device=q.device)[None, :] < kv_len.reshape(B, 1)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    if extra_kv is not None:
        k_new, v_new = extra_kv
        s_x = torch.einsum("bkgd,bxkd->bkgx", qg, k_new.float())
        s = torch.cat([s, s_x], dim=-1)
    p = torch.softmax(s, dim=-1)
    p, p_x = p[..., :Smax], p[..., Smax:]
    if v_scale is not None:
        p = p * v_scale.float().transpose(1, 2)[:, :, None, :]
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    if extra_kv is not None:
        out = out + torch.einsum("bkgx,bxkd->bkgd", p_x, v_new.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


@torch.no_grad()
def sharded_decode_attention(q, k_cache: DTensor, v_cache: DTensor, kv_len,
                             *, k_scale=None, v_scale=None, extra_kv=None
                             ) -> DTensor:
    """``decode_attention`` against a cache sharded over batch and
    positions (``kv_seq``), as split-KV decoding: each rank scores its
    rows' slice of the positions (masked by the global position), and
    the slices' maxima, exponential sums and weighted values are
    combined over the position-sharding mesh dims (a MAX and two SUM
    all-reduces of [B,K,G] and [B,K,G,D]); the in-flight entry joins
    the combined result.  Serving only (no gradient)."""
    mesh = k_cache.device_mesh
    cpl = k_cache.placements
    seq = [p.is_shard(1) for p in cpl]
    bpl = [Shard(0) if p.is_shard(0) else Replicate() for p in cpl]

    def rows(t):
        return to_placements(t, mesh, bpl).to_local()

    ql, lens = rows(q), rows(kv_len)
    kl, vl = k_cache.to_local(), v_cache.to_local()
    B_l, _, H, D = ql.shape
    Sl, K = kl.shape[1], kl.shape[2]
    qg = ql.reshape(B_l, K, H // K, D).float() * (1.0 / math.sqrt(D))
    s = torch.einsum("bkgd,bskd->bkgs", qg, kl.float())
    if k_scale is not None:
        s = s * k_scale.to_local().float().transpose(1, 2)[:, :, None, :]
    pos = torch.arange(Sl, device=s.device) + local_offset(k_cache, 1)
    valid = pos[None, :] < lens.reshape(B_l, 1)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    m = s.amax(dim=-1)                                       # [b,K,G]
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    if v_scale is not None:
        p = p * v_scale.to_local().float().transpose(1, 2)[:, :, None, :]
    o = torch.einsum("bkgs,bskd->bkgd", p, vl.float())

    def combine(t, op):
        pl = [Partial(op) if sq else b for sq, b in zip(seq, bpl)]
        d = DTensor.from_local(t, mesh, pl, run_check=False,
                               shape=torch.Size((q.shape[0],) + t.shape[1:]),
                               stride=contiguous_stride((q.shape[0],)
                                                        + t.shape[1:]))
        return d.redistribute(mesh, bpl).to_local()

    M = combine(m, "max")
    w = torch.exp(m - M)
    l = combine(l * w, "sum")
    o = combine(o * w[..., None], "sum")
    if extra_kv is not None:
        k_new, v_new = (rows(t) for t in extra_kv)
        s_x = torch.einsum("bkgd,bxkd->bkgx", qg, k_new.float())[..., 0]
        M2 = torch.maximum(M, s_x)
        a, e = torch.exp(M - M2), torch.exp(s_x - M2)
        l = l * a + e
        o = o * a[..., None] + e[..., None] * v_new.float()[:, 0, :, None, :]
    out = (o / l[..., None]).reshape(B_l, 1, H, D).to(ql.dtype)
    return DTensor.from_local(out.contiguous(), mesh, bpl,
                              shape=q.shape,
                              stride=contiguous_stride(q.shape))


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token-head symmetric int8. x: [..., K, D] -> (q int8,
    scale float32 [..., K]).  The reference's rounding: divide by the
    scale (floored at 1e-8), round half to even, clip to +-127."""
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax(dim=-1) / 127.0, 1e-8)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s
