"""Token-choice top-k MoE with per-sequence capacity-bucketed dispatch.

Port of ``repro/models/moe.py``. Dispatch groups are sequences (GShard
groups): each token-choice's queue position comes from a choice-major
cumsum over the sequence (first choices win capacity), a ``(B, E, C)``
dispatch index (sentinel ``S`` = a zero pad row) gathers every expert's
rows, and the expert SwiGLU runs as one batched product over E
(``torch.bmm`` on ``(E, B·C, ·)``, the JAX ``becd,edf`` einsums).

The combine is deterministic and in the JAX scatter's order: each token
gathers its kept slots' gated outputs and sums them in ascending expert
index, starting from zero, every partial sum rounded to ``combine_dtype``
(the order XLA's scatter-add applies a token's updates in). A scatter-add
(``index_add_``) on CUDA adds with atomics in an order that changes from
run to run. Dropped choices go to the sentinel slot ``(E, C)`` of the
dispatch index, which is sliced off (the only slot written twice), as in
JAX. The router is f32 and its top-k a stable descending sort (ties to
the lower expert index, ``jax.lax.top_k``'s order).

Integrated MoDE (paper §4.3): ``n_noop_experts`` extra router columns
whose experts are no-ops: a token routed there gets no update, MoD's
residual path inside the MoE router. Everything here is torch ops, as
the JAX package computes the MoE outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.models.layers import activation, dense_init

Params = Dict[str, torch.Tensor]
Aux = Dict[str, torch.Tensor]


def init_moe(gen: torch.Generator, cfg: ModelConfig, device: torch.device) -> Params:
    D = cfg.d_model
    E = cfg.moe.n_experts
    E_total = E + cfg.moe.n_noop_experts
    Fe = cfg.moe.d_ff_expert or cfg.d_ff
    dtype = torch_dtype(cfg.dtype)
    p = {
        "router_w": dense_init(gen, D, (D, E_total), torch.float32, device),
        "w_up": dense_init(gen, D, (E, D, Fe), dtype, device),
        "w_down": dense_init(gen, Fe, (E, Fe, D), dtype, device),
    }
    if cfg.glu:
        p["w_gate"] = dense_init(gen, D, (E, D, Fe), dtype, device)
    return p


def expert_capacity(seq_len: int, cfg: ModelConfig) -> int:
    """Per-sequence per-expert capacity: ``capacity_factor·S·top_k/E``,
    rounded up to a multiple of 8 once it reaches 8, never below 1."""
    c = int(cfg.moe.capacity_factor * seq_len * cfg.moe.top_k / cfg.moe.n_experts)
    return max(1, -(-c // 8) * 8 if c >= 8 else c)


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax``: exp of the max-shifted logits over their sum."""
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True).detach())
    return e / e.sum(dim=-1, keepdim=True)


class Routing(NamedTuple):
    """One call's token-choice routing. Choice-major ``(B, k·S)`` leaves
    (all first choices, then all second choices, ...): ``sel`` expert,
    ``gate`` f32 router probability, ``pos`` queue position in the expert
    (-1 for a no-op expert), ``keep`` real and within capacity.
    ``disp`` (B, E, C): the token in each expert slot, ``S`` for an empty
    slot. ``logits``/``probs`` (B, S, E_total) f32."""

    logits: torch.Tensor
    probs: torch.Tensor
    sel: torch.Tensor
    gate: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    disp: torch.Tensor


def route(params: Params, x: torch.Tensor, cfg: ModelConfig) -> Routing:
    """Router softmax, its top-k, the choice-major position-in-expert
    cumsum (first choices win capacity) and the dispatch index."""
    B, S, _ = x.shape
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    C = expert_capacity(S, cfg)
    dev = x.device
    logits = x.float() @ params["router_w"]  # (B, S, Et) f32
    probs = _softmax(logits)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    sel = top.indices[..., :k].transpose(1, 2).reshape(B, k * S)  # 1st choices first
    gate = top.values[..., :k].transpose(1, 2).reshape(B, k * S)
    is_real = sel < E
    onehot = (sel[..., None] == torch.arange(E, device=dev)).to(torch.int32)  # noop -> 0
    filled = torch.cumsum(onehot, dim=1)  # (B, kS, E)
    pos = torch.where(is_real, filled.gather(-1, sel.clamp(max=E - 1)[..., None])[..., 0] - 1,
                      -1)
    keep = is_real & (pos >= 0) & (pos < C)
    # dropped choices all land on the sentinel slot (E, C), sliced off
    tok = torch.arange(S, device=dev).repeat(k)[None].expand(B, k * S)
    bidx = torch.arange(B, device=dev)[:, None].expand(B, k * S)
    disp = torch.full((B, E + 1, C + 1), S, dtype=torch.long, device=dev)
    disp[bidx, torch.where(keep, sel, E), torch.where(keep, pos, C)] = tok
    return Routing(logits, probs, sel, gate, pos, keep, disp[:, :E, :C])


def experts(params: Params, x: torch.Tensor, disp: torch.Tensor, cfg: ModelConfig
            ) -> torch.Tensor:
    """Every expert's MLP on its slots: x (B, S, D), disp (B, E, C) ->
    (E, B·C, D), one batched product over E per weight (an empty slot
    reads the zero pad row ``S``)."""
    B, S, D = x.shape
    E, C = disp.shape[1], disp.shape[2]
    xpad = torch.cat([x, x.new_zeros(B, 1, D)], dim=1).reshape(B * (S + 1), D)
    rows = disp + (torch.arange(B, device=x.device) * (S + 1))[:, None, None]
    xe = xpad.index_select(0, rows.transpose(0, 1).reshape(-1)).view(E, B * C, D)
    act = activation(cfg.act)
    up = torch.bmm(xe, params["w_up"])
    if "w_gate" in params:
        up = act(torch.bmm(xe, params["w_gate"])) * up
    else:
        up = act(up)
    return torch.bmm(up, params["w_down"])


def combine(ye: torch.Tensor, r: Routing, S: int, dtype: torch.dtype,
            combine_dtype: torch.dtype) -> torch.Tensor:
    """Gated combine of ``ye`` (E, B·C, D) back to token order (B, S, D):
    each token's kept slots times their gates, summed from zero in
    ascending expert index with every partial sum in ``combine_dtype``,
    then cast to ``dtype``. Deterministic: a gather per choice, no
    scatter-add."""
    E, BC, D = ye.shape
    B, C = r.disp.shape[0], r.disp.shape[2]
    k = r.sel.shape[1] // S
    bidx = torch.arange(B, device=ye.device)[:, None]
    slot = torch.where(r.keep, r.sel * BC + bidx * C + r.pos, E * BC)  # E·BC: zero row
    g = torch.where(r.keep, r.gate, 0.0)
    # token-major (B, S, k), a token's choices by ascending expert
    sel, slot, g = (t.view(B, k, S).transpose(1, 2) for t in (r.sel, slot, g))
    asc = torch.argsort(sel, dim=-1)
    slot = torch.take_along_dim(slot, asc, dim=-1)
    g = torch.take_along_dim(g, asc, dim=-1)
    ye_flat = torch.cat([ye.reshape(E * BC, D), ye.new_zeros(1, D)])
    out = torch.zeros((B, S, D), dtype=combine_dtype, device=ye.device)
    for j in range(k):
        yj = ye_flat.index_select(0, slot[..., j].reshape(-1)).view(B, S, D)
        out = out + (yj.float() * g[..., j, None]).to(combine_dtype)
    return out.to(dtype)


def moe_mlp(params: Params, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, Aux]:
    """x (B, S, D) -> (out (B, S, D) in x's dtype, aux): ``moe/lb_loss``,
    ``moe/z_loss``, ``moe/drop_frac`` and, with no-op experts,
    ``moe/noop_frac`` (f32 scalars)."""
    S = x.shape[1]
    E = cfg.moe.n_experts
    E_total = E + cfg.moe.n_noop_experts
    r = route(params, x, cfg)
    ye = experts(params, x, r.disp, cfg)
    out = combine(ye, r, S, x.dtype, torch_dtype(cfg.moe.combine_dtype))

    lp = r.logits.reshape(-1, E_total)
    top1 = lp.argmax(dim=-1)  # the first maximum, as jnp.argmax
    f_e = (top1[:, None] == torch.arange(E_total, device=x.device)).float().mean(dim=0)
    P_e = r.probs.reshape(-1, E_total).mean(dim=0)
    is_real = r.sel < E
    aux: Aux = {
        "moe/lb_loss": E_total * (f_e * P_e).sum(),
        "moe/z_loss": torch.logsumexp(lp, dim=-1).square().mean(),
        "moe/drop_frac": 1.0 - r.keep.float().sum() / is_real.float().sum().clamp_min(1.0),
    }
    if cfg.moe.n_noop_experts > 0:
        aux["moe/noop_frac"] = (~is_real).float().mean()
    return out, aux
