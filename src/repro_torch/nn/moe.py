"""Mixture-of-Experts FFN: token-choice top-k routing with a capacity for
each (row, expert) (GShard with dropping), as the JAX package's
``repro/nn/moe.py``, in both its layouts: every device holds every
expert (the "replicated" layout: the train path and one-device serving),
or each rank of a model group holds E/mp of them (expert parallelism,
``ep_axis``, see ``_moe_apply_ep``).

A call routes each token to its ``top_k`` experts (softmax over E in
float32, renormalised), then each (row, expert) keeps its C heaviest
tokens, C = min(max(1, ceil(top_k * L * capacity_factor / E)), L), and
drops the rest.  The kept tokens are gathered, every expert runs its
SwiGLU on its C rows of every batch row (one batched product over E of B x
C rows a matrix, so a call reads each expert's weights once), and each
token sums its kept experts' outputs, weighted by its gates.

The JAX package's combine is a scatter-add in the compute dtype
(``out.at[b, token].add``), which XLA's CPU scatter runs in (b, e, c)
order: a token's expert rows are added in ascending expert index, each
add rounded to the compute dtype.  The combine here keeps that order
without atomics: an inverse map gives each token the slot of each of its
kept experts, and the rows are gathered and added one expert at a time,
so two calls, and a captured call, give the same bits.  Nothing reads a
value back to the host and every shape follows from (B, L, E, top_k,
capacity_factor), so a call can be captured in a CUDA graph.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.group import pmean_fwd


def capacity_of(cfg: ModelConfig, L: int, capacity: int | None = None) -> int:
    """The per-(row, expert) capacity C for rows of L tokens, the JAX
    package's: ceil(top_k * L * capacity_factor / E), at least 1, at most
    L (an expert cannot hold more than every token of a row)."""
    if capacity is None:
        capacity = int(max(1, -(-cfg.top_k * L * cfg.capacity_factor // cfg.n_experts)))
    return min(int(capacity), L)


def _route(params, x, cfg: ModelConfig, capacity=None):
    """Token-choice routing and the per-(row, expert) capacity selection.

    x: (B, L, d) -> (gate_vals, token_idx, keep (B, E, C), frac_tokens,
    frac_probs (E,), top_idx (B, L, k)): the gate and token of each
    capacity slot and whether it holds a routed token, the fractions the
    aux loss is built from, and each token's experts.  The router logits
    are ``x @ router`` in x's dtype, then float32."""
    B, L, _ = x.shape
    E, k = cfg.n_experts, cfg.top_k
    logits = (x @ params["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)  # (B, L, E)
    top_p, top_idx = torch.topk(probs, k, dim=-1)  # (B, L, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    # the (B, L, E) weights of the selected experts (zero elsewhere)
    weights = torch.zeros_like(probs).scatter_(-1, top_idx, top_p)
    C = capacity_of(cfg, L, capacity)
    # per (row, expert): its C heaviest tokens; ties among the zero
    # weights pick any token, which ``keep`` masks
    gate_vals, token_idx = torch.topk(weights.transpose(1, 2), C, dim=-1)  # (B, E, C)
    keep = gate_vals > 0.0
    frac_tokens = torch.zeros_like(probs).scatter_(-1, top_idx, 1.0).mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    return gate_vals, token_idx, keep, frac_tokens, frac_probs, top_idx


def _gather(x, token_idx, keep):
    """Each expert's capacity rows of x (B, L, d), expert-major: (E, B * C,
    d), the slots that hold no routed token zeroed."""
    B, L, d = x.shape
    E, C = token_idx.shape[1:]
    flat = (token_idx + torch.arange(B, device=x.device)[:, None, None] * L).transpose(0, 1)
    xg = x.reshape(B * L, d).index_select(0, flat.reshape(-1)).view(E, B * C, d)
    return xg * keep.transpose(0, 1).reshape(E, B * C, 1).to(x.dtype)


def _expert_ffn(params, xg, cdt):
    """The batched-over-experts SwiGLU: xg (E, M, d) against the (E, d, ff)
    and (E, ff, d) stacks -> (E, M, d); silu of the gate in float32, cast
    back, times the up path."""
    g = torch.bmm(xg, params["w_gate"].to(cdt))
    u = torch.bmm(xg, params["w_up"].to(cdt))
    h = F.silu(g.float()).to(cdt) * u
    return torch.bmm(h, params["w_down"].to(cdt))


def _aux_loss(frac_tokens, frac_probs, cfg: ModelConfig):
    """The Switch-style load-balancing loss."""
    return cfg.n_experts * torch.sum(frac_tokens * frac_probs) / cfg.top_k


def _combine(y, gate_vals, token_idx, keep, top_idx, L: int):
    """out (B, L, d): each token's kept expert rows of y (E, B * C, d),
    times their gates, added in ascending expert index with a rounding to
    y's dtype after each add (the JAX package's scatter-add order)."""
    B, E, C = token_idx.shape
    k, d = top_idx.shape[-1], y.shape[-1]
    dev = y.device
    y = y * (gate_vals * keep).transpose(0, 1).reshape(E, B * C, 1).to(y.dtype)
    # slot[b, e, l]: where token l sits among expert e's C rows of row b,
    # or -1; the C tokens of a (b, e) row are distinct, so no two writes
    # meet
    slots = torch.arange(C, device=dev).expand(B, E, C)
    slot = torch.full((B, E, L), -1, dtype=torch.int64, device=dev)
    slot.scatter_(2, token_idx, torch.where(keep, slots, -1))
    experts = torch.sort(top_idx, dim=-1).values  # (B, L, k) ascending
    mine = slot.transpose(1, 2).gather(2, experts)  # (B, L, k)
    # row of y, or the zero row appended at E * B * C where dropped
    b = torch.arange(B, device=dev)[:, None, None]
    rows = torch.where(mine >= 0, experts * (B * C) + b * C + mine, E * B * C)
    y_rows = torch.cat([y.reshape(E * B * C, d), y.new_zeros(1, d)])
    parts = y_rows.index_select(0, rows.reshape(-1)).view(B, L, k, d)
    out = torch.zeros((B, L, d), dtype=y.dtype, device=dev)
    for j in range(k):
        out = out + parts[:, :, j]
    return out


def moe_apply(params, x, cfg: ModelConfig, capacity: int | None = None,
              ep_axis=None, seq_sharded: bool = False, batch_axis=None):
    """x: (B, L, d) -> ((B, L, d) in x's dtype, {"moe_aux_loss": ()}).
    ``params``: router (d, E), w_gate and w_up (E, d, ff), w_down (E, ff,
    d); each used in x's dtype.

    ``ep_axis`` (a ``repro_torch.distributed.group`` ``ModelGroup``): expert
    parallelism, taken only where the expert stacks are this rank's block
    (``w_gate.shape[0] != n_experts``), so replicated params run the
    unsharded code, as in the JAX package.  ``seq_sharded`` marks x as the
    rank's (B, L/mp, d) sequence slice (Ulysses): the dispatch then takes
    no token slice of its own and the output stays local.

    ``batch_axis`` (a ``ModelGroup``): the data-parallel ranks of a mesh
    trainer, each holding an equal block of the batch's rows.  The aux
    loss is then the whole batch's, its routing fractions averaged over
    the group (``pmean_fwd``), as the JAX package's step under ``jit``
    computes it; routing and capacity are per row and need nothing."""
    if ep_axis is not None and params["w_gate"].shape[0] != cfg.n_experts:
        return _moe_apply_ep(params, x, cfg, capacity, ep_axis, seq_sharded)
    gate_vals, token_idx, keep, ft, fp, top_idx = _route(params, x, cfg, capacity)
    ft, fp = pmean_fwd(ft, batch_axis), pmean_fwd(fp, batch_axis)
    y = _expert_ffn(params, _gather(x, token_idx, keep), x.dtype)
    out = _combine(y, gate_vals, token_idx, keep, top_idx, x.shape[1])
    return out, {"moe_aux_loss": _aux_loss(ft, fp, cfg)}


def _moe_apply_ep(params, x, cfg: ModelConfig, capacity, ep_axis, seq_sharded: bool):
    """Expert-parallel dispatch over the group ``ep_axis`` (the JAX
    package's ``_moe_apply_ep``): rank r owns experts [r E/mp, (r+1) E/mp).

    Each rank owns a contiguous L/mp slice of the tokens (its own under
    Ulysses, else cut from the replicated input), routes it against the
    replicated router and gathers it for every expert; the routing
    fractions are averaged over the group.  A tiled all-to-all splits the
    expert axis, so every rank receives its experts' capacity rows from
    every sender (sender-major), runs its E/mp expert FFNs, and a second
    all-to-all hands each sender its rows back in global expert order.
    The combine is the replicated layout's (ascending expert, no atomics)
    over the local tokens; a replicated input is restored by a psum of the
    zero-padded slices.

    Where L does not divide the group and the stream is not sequence
    sharded there is no exchange: every rank routes every token, runs its
    expert block, and the same psum combines (correct for any L)."""
    E, E_local = cfg.n_experts, params["w_gate"].shape[0]
    mp = E // E_local
    r = ep_axis.axis_index()
    B, L, d = x.shape
    own = slice(r * E_local, (r + 1) * E_local)

    if not seq_sharded and L % mp:
        gate_vals, token_idx, keep, ft, fp, top_idx = _route(params, x, cfg, capacity)
        y_local = _expert_ffn(params, _gather(x, token_idx[:, own], keep[:, own]), x.dtype)
        # the other ranks' experts contribute zero rows here
        y = y_local.new_zeros((E,) + tuple(y_local.shape[1:]))
        y[own] = y_local
        out = _combine(y, gate_vals, token_idx, keep, top_idx, L)
        return ep_axis.psum(out), {"moe_aux_loss": _aux_loss(ft, fp, cfg)}

    Lc = L if seq_sharded else L // mp
    xl = x if seq_sharded else x[:, r * Lc:(r + 1) * Lc]
    gate_vals, token_idx, keep, ft, fp, top_idx = _route(params, xl, cfg, capacity)
    # equal slices: the global fractions are the mean of the ranks'
    ft, fp = ep_axis.pmean(ft), ep_axis.pmean(fp)
    xg = _gather(xl, token_idx, keep)  # (E, B * C, d): every expert's rows
    xg = ep_axis.all_to_all(xg, 0, 1)  # (E_local, mp * B * C, d)
    y = _expert_ffn(params, xg, x.dtype)
    y = ep_axis.all_to_all(y, 1, 0)  # (E, B * C, d), global expert order
    out_l = _combine(y, gate_vals, token_idx, keep, top_idx, Lc)
    aux = {"moe_aux_loss": _aux_loss(ft, fp, cfg)}
    if seq_sharded:
        return out_l, aux  # the stream stays sequence-sharded
    out = out_l.new_zeros((B, L, d))
    out[:, r * Lc:(r + 1) * Lc] = out_l
    return ep_axis.psum(out), aux  # row-parallel combine
