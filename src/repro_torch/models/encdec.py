"""Whisper-style encoder-decoder with MoD on the decoder stack.

Port of ``repro/models/encdec.py``. The audio frontend (log-mel + conv) is
a stub: the model takes precomputed frame embeddings ``enc_emb`` (B, S_enc,
D) that already carry positional information. The encoder is a
bidirectional transformer (``causal=False``, no rotation); the decoder is
causal with cross-attention. MoD routes around whole decoder blocks
(self-attention, cross-attention and MLP); the encoder stays dense.

As in :mod:`repro_torch.models.transformer`, parameters and caches are per
layer: ``params["enc_blocks"]`` is a list of encoder blocks and
``params["groups"]`` a list of ``{"full": block, "mod": routed block}``
groups (one ``{"full"}`` per layer with MoD off), each decoder block
holding ``ln1``/``attn``, ``lnx``/``xattn`` and ``ln2``/``mlp``. A group's
cache is ``{"self": ring, "cross": {"k", "v"}}`` per block kind; the MoD
block's self ring is capacity-sized, its cross-KV full (it is read only
through the routed rows). Serving runs the encoder once per request
(:func:`prefill_cross`) and decodes against the filled cross-KV.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.core import router as R
from repro_torch.core import routing as ROUT
from repro_torch.device import torch_dtype
from repro_torch.models import attention as A
from repro_torch.models import blocks as BLK
from repro_torch.models.layers import (
    embed,
    init_embedding,
    init_mlp,
    init_rmsnorm,
    mlp,
    rmsnorm,
    unembed,
)
from repro_torch.models.transformer import _default_positions, mean_aux, run_groups

Params = Dict[str, Any]
Aux = Dict[str, torch.Tensor]


def enc_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder's config: bidirectional attention, no rotation."""
    return dataclasses.replace(cfg, attn=dataclasses.replace(cfg.attn, causal=False,
                                                             pos_emb="none"))


def init_dec_block(gen: torch.Generator, cfg: ModelConfig, device: torch.device) -> Params:
    dtype = torch_dtype(cfg.dtype)
    return {
        "ln1": init_rmsnorm(cfg.d_model, dtype, device),
        "attn": A.init_attention(gen, cfg, device),
        "lnx": init_rmsnorm(cfg.d_model, dtype, device),
        "xattn": A.init_attention(gen, cfg, device),
        "ln2": init_rmsnorm(cfg.d_model, dtype, device),
        "mlp": init_mlp(gen, cfg, device),
    }


def init_dec_mod_wrap(gen: torch.Generator, cfg: ModelConfig, device: torch.device) -> Params:
    p: Params = {"block": init_dec_block(gen, cfg, device),
                 "router": R.init_router(gen, cfg, device)}
    if cfg.mod.sampling == "predictor":
        p["predictor"] = R.init_predictor(gen, cfg, device)
    return p


def init_encdec(gen: torch.Generator, cfg: ModelConfig, device: torch.device) -> Params:
    """Parameters drawn from the same distributions as the JAX
    ``init_encdec`` (not the same values: the generators differ)."""
    if cfg.mod.enabled and (cfg.mod.every != 2 or cfg.n_layers % 2):
        raise ValueError("enc-dec MoD needs mod.every == 2 and an even n_layers")
    ecfg = enc_cfg(cfg)
    dtype = torch_dtype(cfg.dtype)
    params: Params = {
        "embed": init_embedding(gen, cfg, device),
        "enc_blocks": [BLK.init_block(gen, ecfg, device) for _ in range(cfg.n_enc_layers)],
        "enc_norm": init_rmsnorm(cfg.d_model, dtype, device),
        "final_norm": init_rmsnorm(cfg.d_model, dtype, device),
    }
    groups: List[Params] = []
    for _ in range(cfg.n_layers // 2 if cfg.mod.enabled else cfg.n_layers):
        g: Params = {"full": init_dec_block(gen, cfg, device)}
        if cfg.mod.enabled:
            g["mod"] = init_dec_mod_wrap(gen, cfg, device)
        groups.append(g)
    params["groups"] = groups
    return params


def encode(params: Params, enc_emb: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The encoder over the stub frontend's frames: (B, S_enc, D)."""
    ecfg = enc_cfg(cfg)
    B, S = enc_emb.shape[0], enc_emb.shape[1]
    pos = _default_positions(B, S, enc_emb.device)
    x = enc_emb
    for bp in params["enc_blocks"]:
        x, _ = BLK.block_apply(bp, x, pos, ecfg)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _dec_block(p: Params, x: torch.Tensor, positions: torch.Tensor, enc_out: torch.Tensor,
               cfg: ModelConfig, delta_only: bool = False) -> torch.Tensor:
    """A decoder block on a sequence without a cache; it projects the
    encoder output to its cross-KV itself, as JAX's does in every block."""
    a = A.self_attention(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps), positions, cfg)
    h = x + a
    ek, ev = A.encode_kv(p["xattn"], enc_out, cfg)
    xa = A.cross_attention(p["xattn"], rmsnorm(p["lnx"], h, cfg.norm_eps), ek, ev, cfg)
    h = h + xa
    m = mlp(p["mlp"], rmsnorm(p["ln2"], h, cfg.norm_eps), cfg)
    return (a + xa + m) if delta_only else (h + m)


def _train_group(enc_out: torch.Tensor, gp: Params, positions: torch.Tensor, cfg: ModelConfig,
                 seed: Optional[int], h: torch.Tensor) -> Tuple[torch.Tensor, Aux]:
    """One layer group of the training forward (the JAX scan body)."""
    aux: Aux = {}
    h = _dec_block(gp["full"], h, positions, enc_out, cfg)
    if "mod" in gp:
        mp = gp["mod"]
        gen = None if seed is None else torch.Generator(device=h.device).manual_seed(seed)

        def delta_fn(xs, ps):
            return _dec_block(mp["block"], xs, ps, enc_out, cfg, delta_only=True), {}

        h, a = ROUT.apply_mod(mp, h, positions, delta_fn, cfg, gen)
        aux.update(a)
    return h, aux


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # (B, S_dec)
    enc_emb: torch.Tensor,  # (B, S_enc, D): the stub frontend's output
    positions: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    last_only: bool = False,
) -> Tuple[torch.Tensor, Aux]:
    """Teacher-forced forward: the encoder, then the decoder groups (MoD's
    routed blocks gather and scatter their rows with the dispatch kernels
    under every backend: the routed block holds cross-attention, which the
    fused kernels do not). Returns (logits (B, S_dec, V), aux means over
    the groups)."""
    enc_out = encode(params, enc_emb, cfg)
    x = embed(params["embed"], tokens)
    if positions is None:
        positions = _default_positions(x.shape[0], x.shape[1], x.device)

    def group_fn(gp, pos, c, seed, h):
        return _train_group(enc_out, gp, pos, c, seed, h)

    x, aux = run_groups(params["groups"], group_fn, x, positions, cfg, generator)
    if last_only:
        x = x[:, -1:]
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x), aux


# ---------------------------------------------------------------------------
# Serving: the encoder runs once; the decoder decodes against its self-KV
# rings and the cross-KV
# ---------------------------------------------------------------------------


def make_cache(cfg: ModelConfig, batch: int, ctx: int, device: torch.device) -> Params:
    """Per-group caches: each block kind's self ring (MoD: capacity-sized)
    and its cross-KV, zeros of (batch, enc_seq_len, nkv, hd)."""
    nkv, hd, dt = cfg.attn.n_kv_heads, cfg.head_dim, torch_dtype(cfg.dtype)

    def cross():
        shape = (batch, cfg.enc_seq_len, nkv, hd)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}

    groups: List[Params] = []
    for _ in range(cfg.n_layers // 2 if cfg.mod.enabled else cfg.n_layers):
        g: Params = {"full": {"self": A.init_kv_cache(batch, ctx, cfg, device), "cross": cross()}}
        if cfg.mod.enabled:
            g["mod"] = {"self": A.init_kv_cache(batch, cfg.mod.capacity(ctx), cfg, device),
                        "cross": cross()}
        groups.append(g)
    return {"groups": groups}


def prefill_cross(params: Params, caches: Params, enc_emb: torch.Tensor, cfg: ModelConfig
                  ) -> Params:
    """Run the encoder once and fill every decoder block's cross-KV. Returns
    a new tree: the ``self`` leaves are ``caches``' own, the ``cross``
    leaves new tensors (``caches`` is not written)."""
    enc_out = encode(params, enc_emb, cfg)
    groups: List[Params] = []
    for gp, gc in zip(params["groups"], caches["groups"]):
        g: Params = {}
        for kind, c in gc.items():
            blk = gp[kind]["block"] if kind == "mod" else gp[kind]
            k, v = A.encode_kv(blk["xattn"], enc_out, cfg)
            g[kind] = {"self": c["self"], "cross": {"k": k, "v": v}}
        groups.append(g)
    return {"groups": groups}


def _dec_block_decode(p: Params, x: torch.Tensor, positions: torch.Tensor, self_cache: Params,
                      cross_kv: Params, cfg: ModelConfig, delta_only: bool = False
                      ) -> Tuple[torch.Tensor, Params]:
    a, self_cache = A.decode_attention(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps), positions,
                                       self_cache, cfg)
    h = x + a
    xa = A.cross_attention(p["xattn"], rmsnorm(p["lnx"], h, cfg.norm_eps), cross_kv["k"],
                           cross_kv["v"], cfg)
    h = h + xa
    m = mlp(p["mlp"], rmsnorm(p["ln2"], h, cfg.norm_eps), cfg)
    return ((a + xa + m) if delta_only else (h + m)), self_cache


def decode_step(params: Params, caches: Params, cfg: ModelConfig, token: torch.Tensor,
                pos: torch.Tensor, active: Optional[torch.Tensor] = None, spmd=None
                ) -> Tuple[torch.Tensor, Params, Aux]:
    """One autoregressive step; the self rings are updated in place, the
    cross-KV only read. The routed block gathers its rows' cross-KV through
    the batch_capacity decision, so only the self ring is scattered back.
    Returns (logits (B, V), caches, aux means over the routed groups).
    ``spmd``: partitioned MoD decode routing (JAX downgrades it to
    ``semantic_only`` here; a rank's rows run the same function)."""
    x = embed(params["embed"], token)  # (B, 1, D)
    positions = pos.to(torch.int32)[:, None]
    aux_steps: List[Aux] = []
    for gp, gc in zip(params["groups"], caches["groups"]):
        x, _ = _dec_block_decode(gp["full"], x, positions, gc["full"]["self"],
                                 gc["full"]["cross"], cfg)
        if "mod" in gp:
            mp, mc = gp["mod"], gc["mod"]

            def block_fn(h_sub, pos_sub, sc_sub, decision, mp=mp, mc=mc):
                ckv_sub = ROUT.gather_batch(decision, mc["cross"])
                d, sc = _dec_block_decode(mp["block"], h_sub, pos_sub, sc_sub, ckv_sub, cfg,
                                          delta_only=True)
                return d, sc, {}

            x, _, a = ROUT.route_decode(mp, x, mc["self"], block_fn, cfg, positions, active,
                                        spmd)
            aux_steps.append(a)
    aux = mean_aux(aux_steps)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x)[:, 0], caches, aux
