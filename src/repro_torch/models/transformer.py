"""The decoder in PyTorch: prefill and cached decode for serving.

The port of ``repro.models.transformer``, every family.  Where the
reference scans stacked layer params with ``lax.scan``, the port keeps
one module per layer in an ``nn.ModuleList`` and loops over them:

* dense  -- a ``DecoderBlock`` (GQA attention + gated MLP) per layer;
* moe    -- a ``DecoderBlock`` whose feed-forward is the MoE layer
  (``repro_torch.models.moe``); ``forward(..., return_aux=True)`` also
  gives the summed load-balance and router-z losses;
* vlm    -- the dense decoder; ``forward`` and ``prefill`` take optional
  ``vision_embeds [B, P, d]`` that overwrite the first P positions (the
  serving engine passes tokens only, as the reference's does);
* audio  -- an encoder: no embedding table, ``forward`` takes frame
  embeddings [B, S, d], attention is not causal, and there is no cache;
* ssm    -- a ``MambaLayer`` (RMSNorm + Mamba2 mixer) per layer;
* hybrid -- Mamba layers, with one ``DecoderBlock`` (``shared``, one set
  of weights) applied after each run of ``attn_every`` of them; the
  ``n_layers % attn_every`` layers left over run after the last
  application (Zamba2).

The serving cache is a dict of tensors, ``{"pos": [B] int32}`` plus, by
family, ``"k"/"v": [L or n_apps, B, Smax, K, D]`` and ``"ssm_h": [L, B,
H, P, N]`` (float32), ``"conv_tail": [L, B, W-1, ch]``; with
``kv_cache_dtype="int8"`` (every family but hybrid) ``"k"/"v"`` are int8
beside float32 ``"k_scale"/"v_scale": [L, B, Smax, K]``.  ``decode_step``
updates it in place (the reference returns a new cache and donates the
old one to XLA).

Entry points, by the reference's names: ``init_params`` is the
``Transformer(cfg, device=, generator=)`` constructor (its
``reset_parameters``); ``Transformer.forward`` (full-sequence logits),
``prefill`` (prompt -> cache + last logits), ``init_cache`` and
``decode_step`` (one token per sequence, with an optional ``active``
mask for continuous batching).  These run without grad; training goes
through ``logits_and_aux`` (``forward``'s body, under per-layer remat)
and ``loss_fn``.

Under a sharding plan (``repro_torch.sharding.plan.use_plan``) the
same code runs on DTensors: ``shard(...)`` calls at the reference's
sites place the activations, the entry points run in ``plan_scope()``
(DTensor's implicit replication: the plain tensors they make --
positions, masks, ``arange`` indices, the aux-loss zero -- count as
replicated), the serving cache is placed by ``CACHE_AXES``, the
embedding and the loss are vocab-parallel, and attention, the SSD scan
and the MoE experts run on each rank's local shard.  Without a plan
nothing of this runs: ``shard`` returns its input.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MOE
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import plan as SP
from repro_torch.sharding.plan import shard


def n_shared_apps(cfg: ModelConfig) -> int:
    """Hybrid: number of shared-attention applications."""
    if cfg.family != "hybrid":
        return 0
    return cfg.n_layers // cfg.attn_every


class DecoderBlock(nn.Module):
    """One pre-norm block: GQA attention + gated MLP (the MoE layer for
    the moe family)."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d = cfg.d_model
        self.attn_impl = cfg.attn_impl
        self.causal = cfg.causal
        self.ln1 = L.RMSNorm(d, cfg.norm_eps, device)
        self.attn = L.Attention(d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                cfg.qkv_bias, device, dtype)
        self.ln2 = L.RMSNorm(d, cfg.norm_eps, device)
        self.is_moe = cfg.family == "moe"
        if self.is_moe:
            self.moe = MOE.MoE(d, cfg.moe, device, dtype)
        else:
            self.mlp = L.MLP(d, cfg.d_ff, cfg.activation, device, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.attn.reset_parameters(generator)
        (self.moe if self.is_moe else self.mlp).reset_parameters(generator)
        with torch.no_grad():
            self.ln1.scale.fill_(1.0)
            self.ln2.scale.fill_(1.0)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                kv_cache: Optional[tuple] = None,
                cache_pos: Optional[torch.Tensor] = None,
                with_aux: bool = False):
        """Full-sequence mode (kv_cache None) or decode mode (x [B,1,d]
        against the read-only (k_cache, v_cache) of this layer, or
        (k_cache, v_cache, k_scale, v_scale) for an int8 cache).

        Returns (x_out, (k, v), aux): this block's keys and values, not
        quantized, for the caller to store (prefill) or commit (decode),
        and its MoE losses (empty for an MLP block or without
        ``with_aux``).
        """
        # under sequence parallelism the projections take the whole
        # sequence (the Megatron-SP gather, made explicit: a linear layer
        # over a batch- and sequence-split input flattens to a strided
        # shard, whose sharding propagation takes minutes on a 3-D mesh)
        h = shard(self.ln1(x), "batch", None, "embed",
                  grad_placed=False)
        q, k, v = self.attn.proj(h)
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
        q = shard(q, "batch", "seq", "heads", "head_dim")
        if kv_cache is None:
            # no "seq" on k and v: under sequence parallelism each shard
            # attends over the whole sequence
            k = shard(k, "batch", None, None, "head_dim")
            v = shard(v, "batch", None, None, "head_dim")
            if self.attn_impl == "kernel":
                o = flash_ops.flash_attention(q, k, v, causal=self.causal)
            else:
                H = self.attn.n_heads
                ke = shard(L._expand_kv(k, H), "batch", "seq", "heads",
                           "head_dim")
                ve = shard(L._expand_kv(v, H), "batch", "seq", "heads",
                           "head_dim")
                o = L.dense_attention(q, ke, ve, causal=self.causal)
            o = shard(o, "batch", "seq", "heads", "head_dim")
        else:
            # deferred commit: attend over the cache plus the in-flight
            # token's (k, v); the caller writes them into the cache after
            k_cache, v_cache, *scales = kv_cache
            k_scale, v_scale = scales or (None, None)
            if self.attn_impl == "kernel":
                o = decode_ops.decode_attention(
                    q[:, 0], k_cache, v_cache, cache_pos, k[:, 0], v[:, 0],
                    k_scale=k_scale, v_scale=v_scale)[:, None]
            else:
                o = L.decode_attention(q, k_cache, v_cache, cache_pos,
                                       k_scale=k_scale, v_scale=v_scale,
                                       extra_kv=(k, v))
        # each residual branch is placed as the stream before the add:
        # a partial sum over heads (or ff, or experts) is reduce-scattered
        # onto the sequence shards, and its gradient gathered back (the
        # Megatron-SP pair), so no linear layer sees a strided gradient
        x = x + shard(self.attn.out(o), "batch", "seq", "embed")
        h = shard(self.ln2(x), "batch", None, "embed",
                  grad_placed=False)
        if self.is_moe:
            y, aux = self.moe(h, with_aux)
        else:
            y, aux = self.mlp(h), {}
        return x + shard(y, "batch", "seq", "embed"), (k, v), aux


class MambaLayer(nn.Module):
    """One pre-norm Mamba2 layer (ssm and hybrid families)."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        self.ln = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.mamba = M.MambaBlock(cfg.d_model, cfg.ssm, device, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.mamba.reset_parameters(generator)
        with torch.no_grad():
            self.ln.scale.fill_(1.0)

    def forward(self, x: torch.Tensor, impl: str):
        """Full sequence -> (x_out, decode state)."""
        y, state = self.mamba(shard(self.ln(x), "batch", None, "embed",
                                    grad_placed=False), impl)
        return x + shard(y.to(x.dtype), "batch", "seq", "embed"), state

    def step(self, x: torch.Tensor, h: torch.Tensor, tail: torch.Tensor):
        """One token -> (x_out, new ssm state, new conv tail)."""
        y, h, tail = self.mamba.step(self.ln(x), h, tail)
        return x + y.to(x.dtype), h, tail


# logical axes of each cache entry (the reference's _cache_shardings)
CACHE_AXES = {
    "pos": ("batch",),
    "k": (None, "batch", "kv_seq", None, None),
    "v": (None, "batch", "kv_seq", None, None),
    "k_scale": (None, "batch", "kv_seq", None),
    "v_scale": (None, "batch", "kv_seq", None),
    "ssm_h": (None, "batch", "heads", None, None),
    "conv_tail": (None, "batch", None, None),
}


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, *,
               device) -> dict:
    """An empty serving cache; under a plan each entry is a DTensor
    placed by ``CACHE_AXES``, each rank allocating its own shard (on
    ``device="meta"``: shapes only)."""
    c = cfg
    dt = getattr(torch, c.dtype)

    def zeros(key, shape, dtype):
        return SP.zeros(shape, *CACHE_AXES[key], dtype=dtype, device=device)

    cache = {"pos": zeros("pos", (batch_size,), torch.int32)}
    if c.family in ("ssm", "hybrid"):
        s = c.ssm
        d_inner, H = M.ssm_dims(c.d_model, s)
        conv_ch = d_inner + 2 * s.n_groups * s.d_state
        cache["ssm_h"] = zeros("ssm_h", (c.n_layers, batch_size, H,
                                         s.head_dim, s.d_state),
                               torch.float32)
        cache["conv_tail"] = zeros("conv_tail", (c.n_layers, batch_size,
                                                 s.conv_width - 1, conv_ch),
                                   dt)
    if c.family != "ssm":
        nl = n_shared_apps(c) if c.family == "hybrid" else c.n_layers
        shape = (nl, batch_size, max_len, c.n_kv_heads, c.head_dim)
        kv_dt = torch.int8 if c.int8_cache else dt
        cache["k"] = zeros("k", shape, kv_dt)
        cache["v"] = zeros("v", shape, kv_dt)
        if c.int8_cache:
            for key in ("k_scale", "v_scale"):
                cache[key] = zeros(key, shape[:-1], torch.float32)
    return cache


def _layer_local(arr: DTensor, i: int, val: torch.Tensor,
                 positions: bool = False) -> tuple:
    """Layer ``i`` of a sharded cache entry and ``val`` placed as that
    layer is (with ``positions``, whole over its positions dim), both as
    this rank's local tensors."""
    if any(p.is_shard(0) for p in arr.placements):
        raise ValueError("a cache's layer dim is never sharded")
    pl = [Replicate() if positions and p.is_shard(2) else
          Shard(p.dim - 1) if p.is_shard() else p for p in arr.placements]
    return (arr.to_local()[i],
            SP.to_placements(val, arr.device_mesh, pl).to_local())


def _set_layer(arr: torch.Tensor, i: int, val: torch.Tensor) -> None:
    """``arr[i] = val`` (under a plan, each rank its own shard)."""
    if isinstance(arr, DTensor):
        dst, src = _layer_local(arr, i, val)
        dst.copy_(src)
    else:
        arr[i] = val


def _keep_inactive(dst: torch.Tensor, new: torch.Tensor,
                   active: Optional[torch.Tensor]) -> None:
    """Write a decode step's recurrent state into ``dst`` ([B, ...]) in
    place; rows whose ``active`` is False keep their old values bit for
    bit (``torch.where``, no host synchronisation)."""
    if active is None:
        dst.copy_(new)
    else:
        sel = active.reshape((-1,) + (1,) * (dst.dim() - 1))
        dst.copy_(torch.where(sel, new.to(dst.dtype), dst))


def _keep_inactive_layer(arr: torch.Tensor, i: int, new: torch.Tensor,
                         active: Optional[torch.Tensor]) -> None:
    """``_keep_inactive`` into layer ``i`` of a cache entry."""
    if isinstance(arr, DTensor):
        if active is not None:
            new = torch.where(active.reshape((-1,) + (1,) * (new.dim() - 1)),
                              new.to(arr.dtype), arr[i])
        _set_layer(arr, i, new)
    else:
        _keep_inactive(arr[i], new, active)


def _kv_keys(cache: dict) -> tuple:
    """The attention cache's entries: ("k", "v"), and for an int8 cache
    their scales after them."""
    return ("k", "v", "k_scale", "v_scale") if "k_scale" in cache \
        else ("k", "v")


def _kv_entries(cache: dict, k: torch.Tensor, v: torch.Tensor) -> tuple:
    """One layer's new keys and values as the cache stores them, in the
    order of ``_kv_keys``: (k, v), or for an int8 cache the quantized
    (k, v, k_scale, v_scale)."""
    if "k_scale" not in cache:
        return k, v
    kq, ks = L.quantize_kv(k)
    vq, vs = L.quantize_kv(v)
    return kq, vq, ks, vs


def _store_layer(cache: dict, i: int, k: torch.Tensor, v: torch.Tensor
                 ) -> None:
    """Write a prefill's keys and values [B,S,K,D] of layer (or
    application) ``i`` at positions 0..S-1."""
    S = k.shape[1]
    for key, val in zip(_kv_keys(cache), _kv_entries(cache, k, v)):
        arr = cache[key]
        if isinstance(arr, DTensor):
            # this rank's slice of the positions, from the whole sequence
            dst, src = _layer_local(arr, i, val, positions=True)
            off = SP.local_offset(arr, 2)
            n = max(0, min(S - off, dst.shape[1]))
            dst[:, :n] = src[:, off:off + n]
        else:
            arr[i, :, :S] = val


def _commit_layer(cache: dict, i: int, k: torch.Tensor, v: torch.Tensor,
                  pos: torch.Tensor) -> None:
    """Commit layer (or application) ``i``'s new entries at ``pos``."""
    for key, val in zip(_kv_keys(cache), _kv_entries(cache, k, v)):
        arr = cache[key]
        if isinstance(arr, DTensor):
            dst, src = _layer_local(arr, i, val, positions=True)
            p = SP.to_placements(pos, arr.device_mesh, [
                Shard(0) if q.is_shard(1) else Replicate()
                for q in arr.placements]).to_local()
            _commit_kv(dst, src, p, SP.local_offset(arr, 2), arr.shape[2])
        else:
            _commit_kv(arr[i], val, pos)


def _commit_kv(cache_arr: torch.Tensor, new_vals: torch.Tensor,
               pos: torch.Tensor, offset: int = 0,
               smax: Optional[int] = None) -> None:
    """Write one layer's new entries into its cache at per-sequence
    ``pos``, in place.

    cache_arr: [B,Smax,...] (keys or values, [B,Smax,K,D], or an int8
    cache's scales, [B,Smax,K]); new_vals: [B,1,...]; pos: [B].  A
    position past the end writes the last slot, as the reference's
    ``dynamic_update_slice`` clamps its start index.

    A rank's shard of a cache sharded over positions: ``cache_arr``
    holds positions ``offset..`` of ``smax``; a row whose position lies
    elsewhere keeps its value (fixed shapes, no host synchronisation).
    """
    B, Sl = cache_arr.shape[:2]
    smax = Sl if smax is None else smax
    idx = pos.long().clamp(0, smax - 1) - offset
    rows = torch.arange(B, device=cache_arr.device)
    new = new_vals[:, 0].to(cache_arr.dtype)
    if offset == 0 and Sl == smax:
        cache_arr[rows, idx] = new
        return
    inside = (idx >= 0) & (idx < Sl)
    idx = idx.clamp(0, max(Sl - 1, 0))
    if Sl:
        keep = inside.reshape((-1,) + (1,) * (new.dim() - 1))
        cache_arr[rows, idx] = torch.where(keep, new, cache_arr[rows, idx])


class Transformer(nn.Module):
    """The model of every family.

    Weights are drawn from ``generator`` (a seeded ``torch.Generator`` on
    ``device``; seed 0 if None) with the reference's distributions; the
    JAX package's own weights load through
    :func:`repro_torch.models.convert.params_from_jax`.
    """

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        self.cfg = cfg
        V, d = cfg.vocab_padded, cfg.d_model
        self.mamba = cfg.family in ("ssm", "hybrid")
        # audio frames arrive embedded: no table
        self.embed = (None if cfg.family == "audio" else
                      L.uninitialized(nn.Embedding(V, d, device="meta",
                                                   dtype=self.dtype), dev))
        layer = MambaLayer if self.mamba else DecoderBlock
        self.layers = nn.ModuleList(layer(cfg, dev, self.dtype)
                                    for _ in range(cfg.n_layers))
        self.shared = (DecoderBlock(cfg, dev, self.dtype)
                       if cfg.family == "hybrid" else None)
        self.final_norm = L.RMSNorm(d, cfg.norm_eps, dev)
        self.lm_head = (None if cfg.tie_embeddings
                        else L.linear(d, V, False, dev, self.dtype))
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.reset_parameters(generator)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.embed is not None:
            L.embed_init_(self.embed.weight, generator)
        if self.lm_head is not None:
            L.dense_init_(self.lm_head.weight, generator)
        for blk in self._blocks():
            blk.reset_parameters(generator)
        self.final_norm.scale.fill_(1.0)

    def _blocks(self) -> list:
        """Every layer, then the hybrid's shared block."""
        return list(self.layers) + ([] if self.shared is None
                                    else [self.shared])

    def set_attn_impl(self, impl: str) -> None:
        """Switch attention and the SSD step between "dense" (the plain
        PyTorch versions) and "kernel"."""
        self.cfg = self.cfg.replace(attn_impl=impl)
        for blk in self._blocks():
            if isinstance(blk, DecoderBlock):
                blk.attn_impl = impl

    @property
    def _ssd_impl(self) -> str:
        return "kernel" if self.cfg.attn_impl == "kernel" else "plain"

    def _segments(self):
        """The Mamba layers in runs ``(first, end, app)``: layers
        first..end-1, then the shared block's application ``app`` (None
        for the run left over after the last application)."""
        c = self.cfg
        if c.family == "ssm":
            return [(0, c.n_layers, None)]
        k, napps = c.attn_every, n_shared_apps(c)
        segs = [(a * k, (a + 1) * k, a) for a in range(napps)]
        if napps * k < c.n_layers:
            segs.append((napps * k, c.n_layers, None))
        return segs

    def _need_decode(self) -> None:
        if not self.cfg.has_decode:
            raise ValueError(f"{self.cfg.name} is encoder-only: it has no "
                             "cache, prefill or decode step")

    # -- embedding / logits ------------------------------------------------
    def _embed(self, tokens: torch.Tensor,
               vision_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [B,S] -> [B,S,d]; audio: frames [B,S,d] in the model's
        dtype.  vlm: ``vision_embeds`` [B,P,d] overwrite positions
        0..P-1."""
        c = self.cfg
        if c.family == "audio":
            return shard(tokens.to(self.dtype), "batch", "seq", "embed")
        x = L.embed_lookup(self.embed.weight, tokens)
        if c.embed_scale:
            x = x * torch.tensor(math.sqrt(c.d_model), dtype=x.dtype)
        if vision_embeds is not None:
            if c.family != "vlm":
                raise ValueError(f"{c.name} ({c.family}) takes no "
                                 "vision_embeds")
            P = vision_embeds.shape[1]
            if P > x.shape[1]:
                raise ValueError(f"{P} vision positions do not fit "
                                 f"{x.shape[1]} tokens")
            # under a plan the prefix is written with the sequence whole
            # (the vocab-parallel lookup's partial sum reduced first)
            x = shard(x, "batch", None, "embed", grad_placed=False)
            x[:, :P] = shard(vision_embeds.to(x.dtype), "batch", None,
                             "embed", grad_placed=False)
        return shard(x, "batch", "seq", "embed")

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = shard(self.final_norm(x), "batch", None, "embed",
                  grad_placed=False)
        head = (self.embed.weight if self.lm_head is None
                else self.lm_head.weight)
        return shard(torch.nn.functional.linear(x, head), "batch", "seq",
                     "vocab")

    def _rope(self, positions: torch.Tensor):
        c = self.cfg
        return L.rope_angles(positions, c.head_dim, c.rope_fraction,
                             c.rope_theta)

    def _positions(self, S: int, device) -> tuple:
        """cos/sin of positions 0..S-1 (None for the ssm family)."""
        if self.cfg.family == "ssm":
            return None, None
        return self._rope(torch.arange(S, device=device)[None, :])

    # -- full sequence -------------------------------------------------------
    @torch.no_grad()
    def forward(self, tokens: torch.Tensor,
                vision_embeds: Optional[torch.Tensor] = None,
                return_aux: bool = False):
        """tokens [B,S] (audio: frames [B,S,d]) -> logits [B,S,V], or
        (logits, aux) with ``return_aux``: the MoE layers' load-balance
        and router-z losses summed over the layers (0 for other
        families), the reference's ``aux``."""
        logits, aux = self.logits_and_aux(tokens, vision_embeds, return_aux)
        return (logits, aux) if return_aux else logits

    @SP.scoped
    def logits_and_aux(self, tokens: torch.Tensor,
                       vision_embeds: Optional[torch.Tensor] = None,
                       with_aux: bool = True):
        """``forward``'s body, differentiable: (logits, aux).

        With ``remat == "block"`` and grad enabled, each layer and each
        application of the hybrid's shared block runs under
        ``torch.utils.checkpoint``: only its input stays live for the
        backward, which recomputes the rest (the reference's
        ``jax.checkpoint`` of the scan body).
        """
        x = self._embed(tokens, vision_embeds)
        cos, sin = self._positions(x.shape[1], x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = self.cfg.remat == "block" and torch.is_grad_enabled()

        plan = SP.current_plan()

        def run(fn, *args):
            if remat:
                return checkpoint(SP.with_plan(plan, fn), *args,
                                  use_reentrant=False)
            return fn(*args)

        def block(blk, xx):
            xo, _, blk_aux = blk(xx, cos, sin, with_aux=with_aux)
            if blk_aux:
                return xo, blk_aux["moe_aux"] + blk_aux["moe_z"]
            return xo, None

        if not self.mamba:
            for blk in self.layers:
                x, blk_aux = run(block, blk, x)
                if blk_aux is not None:
                    aux = aux + blk_aux
        else:
            def mamba(i, xx):
                return self.layers[i](xx, self._ssd_impl)[0]
            for first, end, app in self._segments():
                for i in range(first, end):
                    x = run(mamba, i, x)
                if app is not None:
                    x = run(block, self.shared, x)[0]
        return self._logits(x), aux

    # -- serving -------------------------------------------------------------
    def init_cache(self, batch_size: int, max_len: int) -> dict:
        """An empty serving cache for ``batch_size`` sequences (under a
        plan, placed by ``CACHE_AXES``)."""
        self._need_decode()
        return init_cache(self.cfg, batch_size, max_len, device=self.device)

    @SP.scoped
    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int,
                vision_embeds: Optional[torch.Tensor] = None):
        """Process the prompts tokens [B,S] (one shared length; vlm: with
        optional ``vision_embeds`` [B,P,d] for the first P positions);
        returns (cache padded to max_len, last-position logits [B,1,V])."""
        self._need_decode()
        B, S = tokens.shape
        x = self._embed(tokens, vision_embeds)
        cache = self.init_cache(B, max_len)
        cache["pos"].fill_(S)
        cos, sin = self._positions(S, x.device)
        if not self.mamba:
            for i, blk in enumerate(self.layers):
                x, (k, v), _ = blk(x, cos, sin)
                _store_layer(cache, i, k, v)
            return cache, self._logits(x[:, -1:, :])
        for first, end, app in self._segments():
            for i in range(first, end):
                x, st = self.layers[i](x, self._ssd_impl)
                _set_layer(cache["ssm_h"], i, st["h"])
                _set_layer(cache["conv_tail"], i, st["conv_tail"])
            if app is not None:
                x, (k, v), _ = self.shared(x, cos, sin)
                _store_layer(cache, app, k, v)
        return cache, self._logits(x[:, -1:, :])

    @SP.scoped
    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor,
                    active: Optional[torch.Tensor] = None):
        """One decode step: tokens [B] or [B,1] -> (cache, logits [B,1,V]).

        Updates ``cache`` in place and returns it.  ``active`` ([B] bool)
        supports continuous batching: inactive slots do not advance their
        position and keep their SSM state and conv tail bit for bit (the
        KV written at their frozen position is overwritten when the slot
        resumes, so attention never reads it).  A MoE layer routes each
        sequence on its own, so inactive slots take no expert capacity
        from active ones.
        """
        self._need_decode()
        if tokens.dim() == 1:
            tokens = tokens[:, None]
        pos = cache["pos"]
        x = self._embed(tokens)
        if self.cfg.family != "ssm":
            cos, sin = self._rope(pos[:, None])
        keys = _kv_keys(cache)
        if not self.mamba:
            for i, blk in enumerate(self.layers):
                x, (k, v), _ = blk(
                    x, cos, sin,
                    kv_cache=tuple(cache[key][i] for key in keys),
                    cache_pos=pos)
                # this layer's attention is done: commit its entries now
                _commit_layer(cache, i, k, v, pos)
        else:
            for first, end, app in self._segments():
                for i in range(first, end):
                    x, h, tail = self.layers[i].step(
                        x, cache["ssm_h"][i], cache["conv_tail"][i])
                    _keep_inactive_layer(cache["ssm_h"], i, h, active)
                    _keep_inactive_layer(cache["conv_tail"], i, tail, active)
                if app is not None:
                    x, (k, v), _ = self.shared(
                        x, cos, sin, kv_cache=(cache["k"][app],
                                               cache["v"][app]),
                        cache_pos=pos)
                    _commit_layer(cache, app, k, v, pos)
        if active is None:
            pos.add_(1)
        else:
            pos.add_(active.to(torch.int32))
        return cache, self._logits(x)


NEG_BIG = -3.0e38          # below any float32 logit: an empty slice's max


def _vocab_parallel_terms(logits: DTensor, labels: torch.Tensor) -> tuple:
    """``logsumexp`` and the gold logit of vocab-sharded logits, without
    gathering the vocabulary: (logz, gold, labels), DTensors placed as
    the logits with the vocab dim reduced.

    Each rank works on its slice of the vocabulary: its maximum (a MAX
    all-reduce gives the row's), its sum of exponentials past that
    maximum (summed as a ``Partial``), and the gold logit of the labels
    that fall in its slice (0 elsewhere; summed as a ``Partial``).
    DTensor's own reductions over a sharded dim gather the whole
    vocabulary, and ``gather`` on the DTensor would read the labels as
    indices into the local slice.
    """
    mesh, pl = logits.device_mesh, logits.placements
    vd = logits.dim() - 1
    red = [Replicate() if p.is_shard(vd) else p for p in pl]
    part = [Partial() if p.is_shard(vd) else p for p in pl]
    labels = SP.to_placements(labels, mesh, red)
    shape, stride = labels.shape, labels.stride()

    def placed(t, placements):
        return DTensor.from_local(t, mesh, placements, shape=shape,
                                  stride=stride)

    local = logits.to_local().float()
    m = local.detach().amax(dim=-1) if local.shape[-1] else \
        local.new_full(local.shape[:-1], NEG_BIG)
    m = placed(m, [Partial("max") if p.is_shard(vd) else p for p in pl]
               ).redistribute(mesh, red).to_local()
    e = torch.exp(local - m[..., None]).sum(dim=-1)
    logz = placed(e, part).log() + placed(m, red)
    idx, inside = SP.local_index(labels.to_local().clamp_min(0),
                                 local.shape[-1], SP.local_offset(logits, vd))
    if local.shape[-1]:
        g = local.gather(-1, idx[..., None])[..., 0] * inside
    else:                               # an empty shard of an uneven vocab
        g = local.new_zeros(idx.shape) + local.sum()
    return logz, placed(g, part), labels


@SP.scoped
def loss_fn(model: Transformer, batch: dict):
    """Cross-entropy LM loss; labels == -1 are masked (prefix/pad).

    The port of the reference's ``loss_fn``: ``batch`` holds ``labels``
    [B,S] and ``tokens`` [B,S] (audio: ``frames`` [B,S,d]; vlm: optional
    ``vision_embeds`` [B,P,d]).  The cross-entropy is taken in float32;
    the MoE layers' aux losses are added.  Returns (loss + aux,
    {"loss", "aux", "tokens"}).
    """
    c = model.cfg
    inp = batch["frames"] if c.family == "audio" else batch["tokens"]
    ve = batch.get("vision_embeds") if c.family == "vlm" else None
    logits, aux = model.logits_and_aux(inp, ve)
    labels = batch["labels"]
    if isinstance(logits, DTensor):
        logz, gold, labels = _vocab_parallel_terms(logits, labels)
    else:
        lbl = labels.clamp_min(0).long()
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, lbl[..., None])[..., 0]
    mask = (labels >= 0).float()
    nll = (logz - gold) * mask
    loss = nll.sum() / mask.sum().clamp_min(1.0)
    return loss + aux, {"loss": loss, "aux": aux, "tokens": mask.sum()}
