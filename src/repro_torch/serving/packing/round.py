"""The packed speculation round: plan -> pack -> verify -> commit.

One round over a slot batch of chains that spends at most ``budget``
verification points, however the live windows are spread:

  1. PLAN    ``plan_round`` over the slot batch: one proposal call and the
     theta-shaped rollout.  Demands are each slot's live points
     ``min(theta_live, K - a)``.
  2. PACK    the ``BudgetAllocator`` turns demands into grants, the pack
     maps (``build_pack_maps``) lay the granted points out contiguously,
     and the ragged gather moves the y / xi / m_hat rows into the dense
     budget-shaped batch.  With ``eager_head`` each slot's head point rides
     in a fixed extra lane, so the call is (budget + slots) points.
  3. VERIFY  ONE model call over the packed points and ONE GRS pass.
  4. COMMIT  scatter z / accept back to theta-shaped per-slot windows and
     run ``commit_round`` with each slot's grant as its effective window.

A grant depends only on pre-round state, so a trimmed round is a round at
a smaller live window and the chain's law is unchanged; when the budget
covers every live window the packed round is the unpacked ``asd_round``.
The plan's noise window comes from the buffers or, with
``noise_mode="counter"``, from the chains' keys; the gathers below move its
rows either way.

``round_impl``:
  "packed"  the gathers run three launches of the row-gather kernel (B3),
            the scalars are plain index reads, GRS is its kernel (B1) and
            z goes back through the row-scatter kernel (B4).
  "fused"   one launch of the fused gather (B5) moves the three row
            tables and the (t, u, A, B, sigma) scalar table; the target
            mean, GRS and the commit scatter of z and accept are the fused
            verify-commit kernels (B6).
``budget_data`` (an int <= ``budget``, or a 0-d int64 tensor on the
slots' device) is the tier the allocator splits while the maps keep the
``budget`` width; lanes past the granted total are padding, dropped at the
commit scatter.  The serving worker passes the tensor, filled before each
call, so a captured superstep reads the tier it is replayed at instead of
the one it was captured at.

``num_branches`` B > 1 runs the branched round (``_branched_packed_round``):
a slot's demand is ``b_live`` windows, a grant sheds branches before it
trims the window, the maps are branch-major over the (S * B * theta)-row
branch stacks, the same kernels move the rows, and each slot commits its
longest accepted prefix.  B = 1 is the round above.

The JAX package's ``pack_impl`` and ``grs_impl`` are not ported: the
tensors' device picks the plain versions (CPU) or the kernels (CUDA).
Nothing here reads a device value on the host, so a superstep of R rounds
is one queue of launches.  ``sharded_packed_superstep`` runs every shard's
``packed_superstep`` on its own block of a stacked (shards, S_local, ...)
slot batch: the JAX package's ``shard_map`` over a ``slots`` mesh, here a
loop over the shard axis on one device, which the sharded engine's fused
program captures (``serving/sharded.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.asd import (ModelFn, _clamp_theta, commit_round, plan_round,
                                  select_longest)
from repro_torch.core.controller import (BranchController, StaticBranches, StaticTheta,
                                         ThetaController)
from repro_torch.core.grs import bcast_right
from repro_torch.core.schedules import Schedule
from repro_torch.kernels.grs.ops import grs
from repro_torch.kernels.pack.ops import gather_rows, scatter_rows
from repro_torch.kernels.superstep.ops import fused_gather, fused_verify_commit
from repro_torch.serving.packing.plan import build_branched_pack_maps, build_pack_maps

_STATIC = StaticTheta()
_STATIC_B = StaticBranches()
ROUND_IMPLS = ("packed", "fused")


def packed_round(model_fn: ModelFn, schedule: Schedule, states,
                 conds: Optional[torch.Tensor], weights: torch.Tensor, *,
                 theta: int, budget: int, allocator, eager_head: bool = True,
                 keep_trajectory: bool = False,
                 controller: ThetaController = _STATIC,
                 round_impl: str = "packed", budget_data=None,
                 noise_mode: str = "buffer", num_branches: int = 1,
                 branch_controller: BranchController = _STATIC_B):
    """One packed verification round over all slots; returns the new state.

    ``states`` is the slot batch (``ASDChainState``, leading S axis),
    ``conds`` (S, d_cond) or None, ``weights`` (S,) float32 allocator
    priorities.  ``model_fn(t, y)``, or ``model_fn(t, y, cond)`` with one
    condition row per point when ``conds`` is given: each model call of
    the round is one batched call.  ``num_branches`` > 1 runs the branched
    round."""
    if round_impl not in ROUND_IMPLS:
        raise ValueError(f"unknown round_impl {round_impl!r}; have {ROUND_IMPLS}")
    if num_branches > 1:
        return _branched_packed_round(
            model_fn, schedule, states, conds, weights, theta=theta, budget=budget,
            allocator=allocator, eager_head=eager_head, keep_trajectory=keep_trajectory,
            controller=controller, round_impl=round_impl, budget_data=budget_data,
            noise_mode=noise_mode, num_branches=num_branches,
            branch_controller=branch_controller)
    K = schedule.K
    theta = _clamp_theta(theta, K)
    S = states.a.shape[0]
    ev = tuple(states.v_cache.shape[1:])
    ev_ndim = len(ev)
    rows = torch.arange(S, device=states.a.device)

    # --- 1. plan: proposal call + rollout of every slot ----------------------
    plan = plan_round(model_fn, schedule, states, theta, eager_head,
                      keep_trajectory, conds, noise_mode)

    # --- 2. pack: allocate the budget, build maps, gather the live points ---
    demand = torch.where(states.a < K, plan.n_valid, 0)
    grants = allocator.allocate(demand, budget if budget_data is None else budget_data,
                                weights)
    grants = torch.minimum(grants, demand)  # contract guard: g <= d always
    # a fully granted slot runs its live window (head index included); a
    # trimmed one runs its grant.  A zero grant (budget < #active) verifies
    # nothing, commits nothing and advances nowhere.
    theta_r = torch.where(grants >= demand, plan.theta_live, grants)
    maps = build_pack_maps(grants, budget)
    src_rows = torch.where(maps.valid, maps.slot_id * theta + maps.step_id, 0)

    def flat(x):  # (S, theta, ...) -> (S * theta, ...)
        return x.reshape((S * theta,) + tuple(x.shape[2:]))

    if round_impl == "fused":
        scal_tbl = torch.stack(
            [flat(plan.t_w1[:, :theta]), flat(plan.u_w), flat(plan.A_w),
             flat(plan.B_w), flat(plan.sig_w)], dim=-1).float()
        y_pt, xi_pt, mh_pt, scal_pt = fused_gather(
            flat(plan.y_prev), flat(plan.xi_w), flat(plan.m_hats), scal_tbl, src_rows)
        t_pt, u_pt, A_pt, B_pt, sig_pt = scal_pt.unbind(-1)
    else:
        y_pt = gather_rows(flat(plan.y_prev), src_rows)
        xi_pt = gather_rows(flat(plan.xi_w), src_rows)
        mh_pt = gather_rows(flat(plan.m_hats), src_rows)
        t_pt, u_pt, A_pt, B_pt, sig_pt = (
            tbl[maps.slot_id, maps.step_id]
            for tbl in (plan.t_w1[:, :theta], plan.u_w, plan.A_w, plan.B_w,
                        plan.sig_w))

    if eager_head:
        # one fixed head lane per slot: the point the chain lands on when it
        # accepts its whole effective window, i.e. next round's proposal
        # call.  A zero grant makes the index -1, which torch wraps to the
        # last row as the JAX package's dynamic_index_in_dim does (it
        # normalises negative indices before clamping); the round leaves
        # v_valid False there, so the value is never used.
        y_head = plan.y_props[rows, theta_r - 1]
        t_head = plan.t_w1[rows, theta_r]
        ts_all = torch.cat([t_pt, t_head])
        ys_all = torch.cat([y_pt, y_head])
        conds_all = None if conds is None else torch.cat([conds[maps.slot_id], conds])
    else:
        ts_all, ys_all = t_pt, y_pt
        conds_all = None if conds is None else conds[maps.slot_id]

    # --- 3. verify: ONE budget-shaped model call ----------------------------
    g_all = model_fn(ts_all, ys_all) if conds is None else model_fn(ts_all, ys_all,
                                                                   conds_all)
    g_pt, g_head = (g_all[:budget], g_all[budget:]) if eager_head else (g_all, None)

    drop_rows = maps.row_id(theta)  # padding lanes -> the drop row
    if round_impl == "fused":
        # target mean + GRS + both commit scatters
        z_tbl, acc_tbl = fused_verify_commit(y_pt, g_pt, xi_pt, mh_pt, A_pt, B_pt,
                                             u_pt, sig_pt, drop_rows, S * theta)
    else:
        m_tgt_pt = (bcast_right(A_pt, ev_ndim + 1) * y_pt
                    + bcast_right(B_pt, ev_ndim + 1) * g_pt)
        z_pt, acc_pt = grs(u_pt, xi_pt, mh_pt, m_tgt_pt, sig_pt, event_ndim=ev_ndim)
        # --- 4. commit: scatter back and close each slot's round ------------
        z_tbl = scatter_rows(z_pt, drop_rows, S * theta)
        acc_tbl = torch.zeros((S * theta + 1,), dtype=torch.bool, device=acc_pt.device)
        acc_tbl[drop_rows] = acc_pt
        acc_tbl = acc_tbl[:S * theta]
    z_seg = z_tbl.reshape((S, theta) + ev)
    acc_seg = acc_tbl.reshape(S, theta)
    return commit_round(schedule, states, plan, z_seg, acc_seg, theta_r, g_head,
                        theta, eager_head, keep_trajectory, controller)


def _branched_packed_round(model_fn: ModelFn, schedule: Schedule, states,
                           conds: Optional[torch.Tensor], weights: torch.Tensor, *,
                           theta: int, budget: int, allocator, eager_head: bool,
                           keep_trajectory: bool, controller: ThetaController,
                           round_impl: str, budget_data, noise_mode: str,
                           num_branches: int, branch_controller: BranchController):
    """The branched packed round: plan -> pack -> verify -> commit with a
    branch axis through every stage.

    Demand is ``b_live * min(theta_live, K - a)`` a slot.  A grant sheds
    branches before it trims the window: below one window it runs one
    trimmed branch (the single-draft trimmed round on the canonical
    stream); past it, whole extra branches ride along (a partial branch
    could not beat branch 0's prefix).  The maps are branch-major over the
    (S * NB * theta)-row stacks, and with ``eager_head`` every (slot,
    branch) has a head lane after the budget's, S * NB in all."""
    K = schedule.K
    theta = _clamp_theta(theta, K)
    NB = num_branches
    S = states.a.shape[0]
    ev = tuple(states.v_cache.shape[1:])
    ev_ndim = len(ev)
    rows = torch.arange(S, device=states.a.device)

    # --- 1. plan: proposal call + the rollout of every branch ---------------
    plan = plan_round(model_fn, schedule, states, theta, eager_head, keep_trajectory,
                      conds, noise_mode, NB)

    # --- 2. pack: branched demand, branch-shedding grants, gather -----------
    n1 = plan.n_valid  # live points a branch
    b_live = torch.clamp(states.b_live, 1, NB)
    demand = torch.where(states.a < K, b_live * n1, 0)
    grants = allocator.allocate(demand, budget if budget_data is None else budget_data,
                                weights)
    grants = torch.minimum(grants, demand)
    covered = grants >= n1
    # whole windows only: clip(grants // n1, 1, b_live)
    b_r = torch.minimum(torch.clamp(grants // torch.clamp(n1, min=1), min=1), b_live)
    theta_r = torch.where(covered, plan.theta_live, grants)
    pts1 = torch.where(covered, n1, grants)  # == min(theta_r, K - a)
    maps = build_branched_pack_maps(pts1, b_r, budget)
    src_rows = torch.where(maps.valid,
                           (maps.slot_id * NB + maps.branch_id) * theta + maps.step_id, 0)

    def flatb(x):  # (S, NB, theta, ...) -> (S * NB * theta, ...)
        return x.reshape((S * NB * theta,) + tuple(x.shape[3:]))

    def btile(x):  # a slot's (S, theta) scalar window, the same for each branch
        return x[:, None, :].expand(S, NB, theta)

    if round_impl == "fused":
        scal_tbl = torch.stack(
            [flatb(btile(plan.t_w1[:, :theta])), flatb(plan.u_w_b), flatb(btile(plan.A_w)),
             flatb(btile(plan.B_w)), flatb(btile(plan.sig_w))], dim=-1).float()
        y_pt, xi_pt, mh_pt, scal_pt = fused_gather(
            flatb(plan.y_prev_b), flatb(plan.xi_w_b), flatb(plan.m_hats_b), scal_tbl,
            src_rows)
        t_pt, u_pt, A_pt, B_pt, sig_pt = scal_pt.unbind(-1)
    else:
        y_pt = gather_rows(flatb(plan.y_prev_b), src_rows)
        xi_pt = gather_rows(flatb(plan.xi_w_b), src_rows)
        mh_pt = gather_rows(flatb(plan.m_hats_b), src_rows)
        t_pt, A_pt, B_pt, sig_pt = (
            tbl[maps.slot_id, maps.step_id]
            for tbl in (plan.t_w1[:, :theta], plan.A_w, plan.B_w, plan.sig_w))
        u_pt = plan.u_w_b[maps.slot_id, maps.branch_id, maps.step_id]

    if eager_head:
        # a head lane per (slot, branch); a zero grant's index -1 reads the
        # last row, as in the single-branch round
        y_head = plan.y_props_b[rows[:, None], torch.arange(NB, device=rows.device),
                                (theta_r - 1)[:, None]]
        t_head = plan.t_w1[rows, theta_r]
        ts_all = torch.cat([t_pt, t_head.repeat_interleave(NB)])
        ys_all = torch.cat([y_pt, y_head.reshape((S * NB,) + ev)])
        conds_all = (None if conds is None
                     else torch.cat([conds[maps.slot_id], conds.repeat_interleave(NB, 0)]))
    else:
        ts_all, ys_all = t_pt, y_pt
        conds_all = None if conds is None else conds[maps.slot_id]

    # --- 3. verify: ONE budget-shaped model call ----------------------------
    g_all = model_fn(ts_all, ys_all) if conds is None else model_fn(ts_all, ys_all,
                                                                   conds_all)
    g_pt = g_all[:budget] if eager_head else g_all

    n_rows = S * NB * theta
    drop_rows = maps.row_id(NB, theta)
    if round_impl == "fused":
        z_tbl, acc_tbl = fused_verify_commit(y_pt, g_pt, xi_pt, mh_pt, A_pt, B_pt, u_pt,
                                             sig_pt, drop_rows, n_rows)
    else:
        m_tgt_pt = (bcast_right(A_pt, ev_ndim + 1) * y_pt
                    + bcast_right(B_pt, ev_ndim + 1) * g_pt)
        z_pt, acc_pt = grs(u_pt, xi_pt, mh_pt, m_tgt_pt, sig_pt, event_ndim=ev_ndim)
        z_tbl = scatter_rows(z_pt, drop_rows, n_rows)
        acc_tbl = torch.zeros((n_rows + 1,), dtype=torch.bool, device=acc_pt.device)
        acc_tbl[drop_rows] = acc_pt
        acc_tbl = acc_tbl[:n_rows]
    z_seg = z_tbl.reshape((S, NB, theta) + ev)
    acc_seg = acc_tbl.reshape(S, NB, theta)

    # --- 4. commit each slot's longest accepted prefix -----------------------
    best, acc_m, gain = select_longest(acc_seg, torch.minimum(theta_r, K - plan.a), b_r)
    g_head = g_all[budget:].reshape((S, NB) + ev)[rows, best] if eager_head else None
    return commit_round(schedule, states, plan, z_seg[rows, best], acc_m[rows, best],
                        theta_r, g_head, theta, eager_head, keep_trajectory, controller,
                        b_r=b_r, gain=gain, num_branches=NB,
                        branch_controller=branch_controller)


def packed_superstep(model_fn: ModelFn, schedule: Schedule, states,
                     conds: Optional[torch.Tensor], weights: torch.Tensor, *,
                     rounds: int, theta: int, budget: int, allocator,
                     eager_head: bool = True, keep_trajectory: bool = False,
                     controller: ThetaController = _STATIC,
                     round_impl: str = "packed", budget_data=None,
                     noise_mode: str = "buffer", num_branches: int = 1,
                     branch_controller: BranchController = _STATIC_B):
    """``rounds`` packed rounds in a row on the device-resident slot state
    (the JAX package's ``lax.scan``): each re-allocates the budget from that
    round's windows, and retired slots stay frozen.  ``weights`` and
    ``conds`` are constants of the superstep.  No device value is read on
    the host between rounds."""
    for _ in range(int(rounds)):
        states = packed_round(
            model_fn, schedule, states, conds, weights, theta=theta, budget=budget,
            allocator=allocator, eager_head=eager_head,
            keep_trajectory=keep_trajectory, controller=controller,
            round_impl=round_impl, budget_data=budget_data, noise_mode=noise_mode,
            num_branches=num_branches, branch_controller=branch_controller)
    return states


def sharded_packed_superstep(model_fn: ModelFn, schedule: Schedule, states,
                             conds: Optional[torch.Tensor], weights: torch.Tensor, *,
                             rounds: int, theta: int, budget: int, allocator,
                             eager_head: bool = True, keep_trajectory: bool = False,
                             controller: ThetaController = _STATIC,
                             round_impl: str = "packed", budget_data=None,
                             noise_mode: str = "buffer", num_branches: int = 1,
                             branch_controller: BranchController = _STATIC_B):
    """Every shard's packed superstep over a stacked slot batch: ``states``
    has a leading shard axis on every field, ``conds`` is (shards, S_local,
    d_cond) or None, ``weights`` (shards, S_local).  Shard i runs
    ``packed_superstep`` on its own (S_local, ...) block alone, so the
    allocator splits that shard's budget over its own demands and the pack
    maps address only its own rows; the result is stacked back.

    ``budget`` is the common static cap.  ``budget_data`` (shards,) gives
    each shard its own tier as data (the fused round's budget-as-data), or
    None.  Equal, shard by shard, to ``packed_superstep`` on that shard."""
    out = []
    for i in range(states.a.shape[0]):
        st = dataclasses.replace(states, **{
            f.name: getattr(states, f.name)[i] for f in dataclasses.fields(states)
            if getattr(states, f.name) is not None})
        out.append(packed_superstep(
            model_fn, schedule, st, None if conds is None else conds[i], weights[i],
            rounds=rounds, theta=theta, budget=budget, allocator=allocator,
            eager_head=eager_head, keep_trajectory=keep_trajectory, controller=controller,
            round_impl=round_impl,
            budget_data=None if budget_data is None else budget_data[i],
            noise_mode=noise_mode, num_branches=num_branches,
            branch_controller=branch_controller))
    return dataclasses.replace(out[0], **{
        f.name: torch.stack([getattr(o, f.name) for o in out])
        for f in dataclasses.fields(out[0]) if getattr(out[0], f.name) is not None})
