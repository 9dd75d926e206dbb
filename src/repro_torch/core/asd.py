"""Autospeculative Decoding — paper Algorithm 1, for a batch of chains.

Each round of every chain makes

  1. one model call at the chain's position a (the *proposal* call),
  2. a theta-step elementwise rollout of proposal means and samples with the
     pre-drawn noises xi (no model calls),
  3. ONE batched model call over all theta proposal points of all chains
     (the parallel verification call),
  4. the verifier (Alg 2 / GRS Alg 3), a windowed commit of the accepted
     prefix and the reflected first rejection, and the advance a <- j+1.

Every round re-reads the (u_i, xi_i) of absolute steps a .. a+theta-1, so
re-speculation sees the same noise, the filtration the exactness proof
relies on.  Two noise modes give the same law:

  * ``noise_mode="buffer"``: the streams are drawn once per chain into
    ``u_buf`` (K+theta+1,) and ``xi_buf`` (K+theta+1, *event);
  * ``noise_mode="counter"``: nothing is stored but the chain's two keys
    ``k_u``, ``k_xi``; u_i and xi_i are drawn when a round needs them, as
    ``uniform(fold_in(k_u, i))`` and ``normal(fold_in(k_xi, i), event)``
    (``repro_torch.core.prng``, JAX's threefry bit for bit).

A chain started from a key draws what the JAX package draws from it, in
either mode.

The JAX package writes one chain and ``vmap``s it; here every state tensor
carries the batch of chains on its leading axis.  Its ``while_loop`` is a
``SamplerLoop``: one round as a program (``repro_torch.programs``; on the
card a captured CUDA graph), replayed until every chain has a >= K.  A
round leaves a finished chain's state, counters included, exactly as it
was, and the host reads the positions only once per bound of rounds (see
``_rounds_bound``), so the loop runs exactly the rounds of a loop that
checked after every round.

``eager_head`` ("ASD+"): the verification call also evaluates the model at
the last live proposal point; after a fully accepted round that evaluation
is the next round's proposal call.

Conditioning: where the JAX package ``vmap``s one model function per chain
over its condition vector, the port passes ``conds`` (B, d_cond) and calls
``model_fn(t, y, cond)`` with the condition rows of every point, so each
call stays one batched call.

Branched speculation (``num_branches`` B > 1): each round rolls B draft
branches from the same proposal output, verifies all B x theta points of
every chain in the one batched call, and commits the branch with the
longest accepted prefix (the lowest index on ties).  Branch 0 is the
canonical stream, so B = 1 is the single-draft round; branch b >= 1 draws
step i from ``fold_in(fold_in(k, _BRANCH_SALT + b), i)`` of the chain's
stream keys, in either noise mode.  ``b_live`` <= B, set by a
``BranchController``, is how many branches compete.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core import prng
from repro_torch.core.controller import (BranchController, StaticBranches, StaticTheta,
                                         ThetaController)
from repro_torch.core.grs import bcast_right
from repro_torch.core.schedules import Schedule
from repro_torch.core.sequential import init_y0
from repro_torch.core.verifier import leading_true_count
from repro_torch.device import resolve_device
from repro_torch.kernels.grs.ops import grs
from repro_torch.programs import SuperstepProgram

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

_STATIC = StaticTheta()
_STATIC_B = StaticBranches()
NOISE_MODES = ("buffer", "counter")

# the key-fold offset of branch b >= 1's streams: a pure function of the
# chain's keys, the branch and the absolute step, as in the JAX package
_BRANCH_SALT = 0x5D5_0000


@dataclasses.dataclass
class LoopStats:
    """What a sampler call's loop did: the rounds it ran (every chain's
    ``rounds`` counter is at most this), its reads of the positions on the
    host, and the host ms of its capture (None where nothing was captured:
    on the CPU, or on a warm loop)."""

    rounds: int = 0
    host_reads: int = 0
    capture_ms: Optional[float] = None


@dataclasses.dataclass
class ASDResult:
    sample: torch.Tensor  # (*batch, *event) final sample y_K
    trajectory: torch.Tensor  # (*batch, K+1, *event), or the final window
    rounds: torch.Tensor  # (*batch,) speculation rounds (paper's R)
    head_calls: torch.Tensor  # (*batch,) proposal calls actually made
    model_evals: torch.Tensor  # (*batch,) model evaluations (all slots)
    accepts: torch.Tensor  # (*batch,) accepted speculations
    proposals: torch.Tensor  # (*batch,) verified slots
    draft_points: torch.Tensor  # (*batch,) verified points of every branch
    loop: Optional[LoopStats] = None  # the call's loop, shared by its chains

    def parallel_depth(self):
        """Sequential model-call depth: rounds + proposal calls."""
        return self.rounds + self.head_calls

    def algorithmic_speedup(self, K: int):
        return K / self.parallel_depth()

    def accept_rate(self):
        return self.accepts / torch.clamp(self.proposals, min=1)


@dataclasses.dataclass
class ASDChainState:
    """Resumable state of a batch of B chains (leading axis B everywhere).

    ``y`` is the committed chain: the padded (B, K+theta+1, *event)
    trajectory when keep_trajectory, else the live (B, theta+1, *event)
    window whose slot 0 is position ``a``.
    """

    y: torch.Tensor
    a: torch.Tensor  # (B,) int64 current position
    v_cache: torch.Tensor  # (B, *event) cached g(t_a, y_a) for eager_head
    v_valid: torch.Tensor  # (B,) bool
    rounds: torch.Tensor  # (B,) int64 counters ...
    head_calls: torch.Tensor
    model_evals: torch.Tensor
    accepts: torch.Tensor
    proposals: torch.Tensor
    theta_live: torch.Tensor  # (B,) current speculation window (<= theta_max)
    ctrl: torch.Tensor  # (B, n) controller state
    k_u: torch.Tensor  # (B, 2) uniform-stream key (counter mode)
    k_xi: torch.Tensor  # (B, 2) noise-stream key (counter mode)
    u_buf: Optional[torch.Tensor]  # (B, K+theta+1), None in counter mode
    xi_buf: Optional[torch.Tensor]  # (B, K+theta+1, *event), None in counter mode
    b_live: torch.Tensor  # (B,) current branch count (<= num_branches)
    bctrl: torch.Tensor  # (B, n) branch controller state
    draft_points: torch.Tensor  # (B,) verified points of every branch


# the fields a round may change (the keys and noise buffers never change)
_ROUND_FIELDS = ("y", "a", "v_cache", "v_valid", "rounds", "head_calls",
                 "model_evals", "accepts", "proposals", "theta_live", "ctrl",
                 "b_live", "bctrl", "draft_points")


def _clamp_theta(theta: int, K: int) -> int:
    return int(min(theta, K))


def init_chain_state(schedule: Schedule, y0: torch.Tensor, theta: int,
                     keep_trajectory: bool = True,
                     controller: ThetaController = _STATIC,
                     generator: Optional[torch.Generator] = None,
                     u_buf: Optional[torch.Tensor] = None,
                     xi_buf: Optional[torch.Tensor] = None,
                     key=None, noise_mode: str = "buffer", num_branches: int = 1,
                     branch_controller: BranchController = _STATIC_B) -> ASDChainState:
    """Fresh chains y0 (B, *event) at position 0 with their absolute-step
    randomness fixed.  ``key`` (B, 2) holds each chain's key, split into
    its streams ``k_u``, ``k_xi`` as the JAX package splits it.

    Buffer mode: ``u_buf`` (B, K+theta+1) and ``xi_buf`` (B, K+theta+1,
    *event) are taken as given, or drawn from the stream keys (the JAX
    package's buffers), or else from ``generator``.  Counter mode holds no
    buffer and needs ``key``.  ``theta`` is the static cap theta_max that
    shapes the buffers.  ``num_branches`` is the branch cap; branches past
    the first draw from the stream keys in either mode, so they need
    ``key`` too (without one every chain would draw the same branches)."""
    if noise_mode not in NOISE_MODES:
        raise ValueError(f"unknown noise_mode {noise_mode!r}; have {NOISE_MODES}")
    if num_branches > 1 and key is None:
        raise ValueError(f"num_branches {num_branches}: branches past the first draw from "
                         "the chains' keys; pass key")
    K = schedule.K
    theta = _clamp_theta(theta, K)
    B, ev = y0.shape[0], tuple(y0.shape[1:])
    dev = y0.device
    n = K + theta + 1
    if key is not None:
        k_u, k_xi = prng.split(prng.as_key(key, dev), 2).unbind(-2)
    else:
        k_u = k_xi = torch.zeros((B, 2), dtype=torch.int64, device=dev)
    if noise_mode == "counter":
        if key is None or u_buf is not None or xi_buf is not None:
            raise ValueError("counter noise draws from the chains' keys: pass key "
                             "and no u_buf / xi_buf")
    else:
        if u_buf is None:
            u_buf = (prng.uniform(k_u, (n,)) if key is not None
                     else torch.rand((B, n), generator=generator, device=dev))
        if xi_buf is None:
            xi_buf = (prng.normal(k_xi, (n,) + ev) if key is not None
                      else torch.randn((B, n) + ev, generator=generator, dtype=y0.dtype,
                                       device=dev))
        u_buf, xi_buf = u_buf.to(dev), xi_buf.to(dev, y0.dtype)
        if tuple(u_buf.shape) != (B, n) or tuple(xi_buf.shape) != (B, n) + ev:
            raise ValueError(f"u_buf {tuple(u_buf.shape)} / xi_buf "
                             f"{tuple(xi_buf.shape)}: expected {(B, n)} / {(B, n) + ev}")
    y = torch.zeros((B, n if keep_trajectory else theta + 1) + ev,
                    dtype=y0.dtype, device=dev)
    y[:, 0] = y0
    ctrl, theta_live = controller.init(theta, B, dev)
    bctrl, b_live = branch_controller.init(num_branches, B, dev)
    zero = torch.zeros((B,), dtype=torch.int64, device=dev)
    return ASDChainState(
        y=y, a=zero, v_cache=torch.zeros_like(y0),
        v_valid=torch.zeros((B,), dtype=torch.bool, device=dev),
        rounds=zero, head_calls=zero, model_evals=zero, accepts=zero,
        proposals=zero, theta_live=theta_live.to(torch.int64), ctrl=ctrl,
        k_u=k_u, k_xi=k_xi, u_buf=u_buf, xi_buf=xi_buf,
        b_live=b_live.to(torch.int64), bctrl=bctrl, draft_points=zero)


def chain_done(st: ASDChainState, K: int) -> torch.Tensor:
    return st.a >= K


def chain_sample(st: ASDChainState, K: int, keep_trajectory: bool = True):
    """The final samples of finished chains (either trajectory mode)."""
    return st.y[:, K] if keep_trajectory else st.y[:, 0]


@dataclasses.dataclass
class RoundPlan:
    """What one round computes before the verification call: the proposal
    call's output, the theta-step rollout, and the schedule and noise
    windows it used (all per chain, leading axis B)."""

    a: torch.Tensor  # (B,) position entering the round
    theta_live: torch.Tensor  # (B,) clipped live window
    n_valid: torch.Tensor  # (B,) live verification points min(theta_live, K-a)
    v_a: torch.Tensor  # (B, *event) proposal-call output g(t_a, y_a)
    new_head: torch.Tensor  # (B,) 1 if the proposal call was actually made
    y_prev: torch.Tensor  # (B, theta, *event) verification inputs y_{a+j}
    y_props: torch.Tensor  # (B, theta, *event) proposal samples
    m_hats: torch.Tensor  # (B, theta, *event) proposal means
    t_w1: torch.Tensor  # (B, theta+1) model times t_a .. t_{a+theta}
    u_w: torch.Tensor  # (B, theta) verifier uniforms
    xi_w: torch.Tensor  # (B, theta, *event) step noises
    A_w: torch.Tensor  # (B, theta)
    B_w: torch.Tensor  # (B, theta)
    sig_w: torch.Tensor  # (B, theta)
    # branched plans: (B, NB, theta, ...) stacks over every draft branch,
    # branch 0 the canonical leaves above; None for a single-draft plan
    y_prev_b: Optional[torch.Tensor] = None  # (B, NB, theta, *event)
    y_props_b: Optional[torch.Tensor] = None  # (B, NB, theta, *event)
    m_hats_b: Optional[torch.Tensor] = None  # (B, NB, theta, *event)
    u_w_b: Optional[torch.Tensor] = None  # (B, NB, theta)
    xi_w_b: Optional[torch.Tensor] = None  # (B, NB, theta, *event)


def _offsets(start: torch.Tensor, length: int) -> torch.Tensor:
    return start[:, None] + torch.arange(length, device=start.device)


def _call(model_fn: ModelFn, t, y, conds, per: int = 1):
    """One batched model call; with ``conds`` (B, d_cond), each chain's
    condition row is repeated for its ``per`` consecutive points."""
    if conds is None:
        return model_fn(t, y)
    return model_fn(t, y, conds if per == 1 else conds.repeat_interleave(per, 0))


def _window(arr: torch.Tensor, start: torch.Tensor, length: int):
    """arr (B, N, ...) -> (B, length, ...) rows start[b] .. start[b]+length-1."""
    rows = torch.arange(arr.shape[0], device=arr.device)[:, None]
    return arr[rows, _offsets(start, length)]


def _noise_window(st: ASDChainState, theta: int, noise_mode: str):
    """u (B, theta) and xi (B, theta, *event) of absolute steps a .. a+theta-1:
    read from the buffers, or drawn from the stream keys folded on each
    step (one batched draw for every chain)."""
    if noise_mode == "buffer":
        if st.u_buf is None:
            raise ValueError("buffer noise on a chain state that holds no buffers "
                             "(made in counter mode)")
        return _window(st.u_buf, st.a, theta), _window(st.xi_buf, st.a, theta)
    if noise_mode != "counter":
        raise ValueError(f"unknown noise_mode {noise_mode!r}; have {NOISE_MODES}")
    steps = _offsets(st.a, theta)
    u_w = prng.uniform(prng.fold_in(st.k_u[:, None], steps))
    xi_w = prng.normal(prng.fold_in(st.k_xi[:, None], steps), tuple(st.v_cache.shape[1:]))
    return u_w, xi_w.to(st.y.dtype)


def _branch_noise(st: ASDChainState, theta: int, num_branches: int):
    """u (B, NB-1, theta) and xi (B, NB-1, theta, *event) of branches
    1 .. NB-1 at absolute steps a .. a+theta-1: each stream key folded on
    ``_BRANCH_SALT + b``, then on the step, in one batched draw per stream
    for every chain and branch."""
    dev = st.a.device
    salts = _BRANCH_SALT + torch.arange(1, num_branches, device=dev)
    steps = _offsets(st.a, theta)[:, None, :]
    u_r = prng.uniform(prng.fold_in(prng.fold_in(st.k_u[:, None], salts)[:, :, None], steps))
    xi_r = prng.normal(prng.fold_in(prng.fold_in(st.k_xi[:, None], salts)[:, :, None], steps),
                       tuple(st.v_cache.shape[1:]))
    return u_r, xi_r.to(st.y.dtype)


def _rollout(y_a, v_a, A_w, B_w, sig_w, xi):
    """The theta-step proposal rollout (Alg 1 lines 7-9) from y_a, v_a
    (B, *event) over noises xi (B, *branch, theta, *event): proposal means
    and samples, both of xi's shape."""
    ev = tuple(y_a.shape[1:])
    lead = xi.ndim - len(ev) - 1  # the axes before theta
    nd = lead + len(ev)
    y_i = y_a.reshape(y_a.shape[:1] + (1,) * (lead - 1) + ev).expand(xi.shape[:lead] + ev)
    v = v_a.reshape(y_a.shape[:1] + (1,) * (lead - 1) + ev)
    m_hats, y_props = [], []
    for j in range(xi.shape[lead]):
        m_hat = bcast_right(A_w[:, j], nd) * y_i + bcast_right(B_w[:, j], nd) * v
        y_i = m_hat + bcast_right(sig_w[:, j], nd) * xi.select(lead, j)
        m_hats.append(m_hat)
        y_props.append(y_i)
    return torch.stack(m_hats, lead), torch.stack(y_props, lead)


def plan_round(model_fn: ModelFn, schedule: Schedule, st: ASDChainState,
               theta: int, eager_head: bool = False,
               keep_trajectory: bool = True, conds=None,
               noise_mode: str = "buffer", num_branches: int = 1) -> RoundPlan:
    """Phase 1 of a round (Alg 1 lines 6-9): the proposal call (possibly
    served from the eager cache) and the theta-step rollout, with the
    noise window of ``noise_mode``.  With ``num_branches`` > 1 the rollout
    runs every branch from the same proposal output and the ``*_b`` fields
    hold the branch stacks; the canonical fields are branch 0."""
    K = schedule.K
    theta = _clamp_theta(theta, K)
    sched = schedule.pad(theta + 1)
    B = st.a.shape[0]
    ev_ndim = st.v_cache.ndim - 1
    theta_live = torch.clamp(st.theta_live, 1, theta)
    a = st.a
    rows = torch.arange(B, device=a.device)
    y_a = st.y[rows, a] if keep_trajectory else st.y[:, 0]
    t_a = sched.t_model[a]

    if eager_head:
        v_a = torch.where(bcast_right(st.v_valid, ev_ndim + 1), st.v_cache,
                          _call(model_fn, t_a, y_a, conds))
        new_head = (~st.v_valid).to(torch.int64)
    else:
        v_a = _call(model_fn, t_a, y_a, conds)
        new_head = torch.ones_like(a)

    idx = _offsets(a, theta)
    A_w, B_w, sig_w = sched.A[idx], sched.B[idx], sched.sigma[idx]
    t_w1 = sched.t_model[_offsets(a, theta + 1)]
    u_w, xi_w = _noise_window(st, theta, noise_mode)

    branched = {}
    if num_branches > 1:
        # every branch in one rollout: elementwise, so branch 0's values
        # are the single-draft rollout's to the bit
        u_r, xi_r = _branch_noise(st, theta, num_branches)
        u_w_b = torch.cat([u_w[:, None], u_r], dim=1)
        xi_w_b = torch.cat([xi_w[:, None], xi_r], dim=1)
        m_hats_b, y_props_b = _rollout(y_a, v_a, A_w, B_w, sig_w, xi_w_b)
        y_start = y_a[:, None, None].expand((B, num_branches, 1) + tuple(y_a.shape[1:]))
        y_prev_b = torch.cat([y_start, y_props_b[:, :, :-1]], dim=2)
        branched = dict(y_prev_b=y_prev_b, y_props_b=y_props_b, m_hats_b=m_hats_b,
                        u_w_b=u_w_b, xi_w_b=xi_w_b)
        m_hats, y_props, y_prev = m_hats_b[:, 0], y_props_b[:, 0], y_prev_b[:, 0]
    else:
        m_hats, y_props = _rollout(y_a, v_a, A_w, B_w, sig_w, xi_w)
        y_prev = torch.cat([y_a[:, None], y_props[:, :-1]], dim=1)
    return RoundPlan(
        a=a, theta_live=theta_live, n_valid=torch.minimum(theta_live, K - a),
        v_a=v_a, new_head=new_head, y_prev=y_prev, y_props=y_props,
        m_hats=m_hats, t_w1=t_w1, u_w=u_w, xi_w=xi_w, A_w=A_w, B_w=B_w,
        sig_w=sig_w, **branched)


def commit_round(schedule: Schedule, st: ASDChainState, plan: RoundPlan,
                 z: torch.Tensor, acc: torch.Tensor, theta_r: torch.Tensor,
                 g_head: Optional[torch.Tensor], theta: int,
                 eager_head: bool = False, keep_trajectory: bool = True,
                 controller: ThetaController = _STATIC, *,
                 b_r: Optional[torch.Tensor] = None, gain: Optional[torch.Tensor] = None,
                 num_branches: int = 1,
                 branch_controller: BranchController = _STATIC_B) -> ASDChainState:
    """Phase 3 (Alg 1 lines 12-13): commit the accepted prefix and the
    reflected first rejection, update the counters and the window.  Only
    slots < min(theta_r, K - a) of ``z``/``acc`` are read.  Finished chains
    come back unchanged.

    A branched round passes the selected branch's ``z``/``acc``/``g_head``
    with ``b_r`` (B,), the branches it ran (they scale ``model_evals`` and
    ``draft_points``), and ``gain`` (B,), the selected branch's accepted
    slots over branch 0's (what the branch controller observes)."""
    K = schedule.K
    theta = _clamp_theta(theta, K)
    ev_ndim = st.v_cache.ndim - 1
    B = st.a.shape[0]
    a = plan.a
    dev = a.device

    n_valid = torch.minimum(theta_r, K - a)
    slot = torch.arange(theta, device=dev)[None, :]
    acc = acc & (slot < n_valid[:, None])
    lead = leading_true_count(acc, dim=1).to(torch.int64)
    rejected = lead < n_valid
    advance = lead + rejected.to(torch.int64)

    old = _window(st.y, a + 1, theta) if keep_trajectory else st.y[:, 1:]
    mask = bcast_right(slot < advance[:, None], ev_ndim + 2)
    committed = torch.where(mask, z, old)
    rows = torch.arange(B, device=dev)[:, None]
    if keep_trajectory:
        y_new = st.y.clone()
        y_new[rows, _offsets(a + 1, theta)] = committed
    else:
        # shift the live window so slot 0 becomes position a + advance
        buf2 = torch.cat([st.y[:, :1], committed, torch.zeros_like(committed)],
                         dim=1)
        y_new = buf2[rows, _offsets(advance, theta + 1)]

    full_accept = (~rejected) & (n_valid == theta_r) & (n_valid > 0)
    ctrl_new, theta_next = controller.update(st.ctrl, theta_r, lead, n_valid,
                                             rejected, theta)
    # one branch: the single-draft counters; a branched round verified b_r
    # windows (and b_r eager heads)
    b_eff = 1 if b_r is None else b_r
    if num_branches > 1:
        bctrl_new, b_next = branch_controller.update(
            st.bctrl, b_eff, torch.zeros_like(lead) if gain is None else gain, lead,
            rejected, num_branches)
        b_next = torch.clamp(b_next.to(torch.int64), 1, num_branches)
    else:
        bctrl_new, b_next = st.bctrl, st.b_live
    new = dict(
        y=y_new,
        a=a + advance,
        v_cache=g_head if eager_head else st.v_cache,
        v_valid=full_accept if eager_head else torch.zeros_like(st.v_valid),
        rounds=st.rounds + 1,
        head_calls=st.head_calls + plan.new_head,
        model_evals=(st.model_evals + plan.new_head + b_eff * n_valid
                     + (b_eff if eager_head else 0)),
        accepts=st.accepts + lead,
        proposals=st.proposals + n_valid,
        theta_live=torch.clamp(theta_next.to(torch.int64), 1, theta),
        ctrl=ctrl_new,
        b_live=b_next,
        bctrl=bctrl_new,
        draft_points=st.draft_points + b_eff * n_valid,
    )
    live = a < K
    for name in _ROUND_FIELDS:
        old_v = getattr(st, name)
        new[name] = torch.where(bcast_right(live, old_v.ndim), new[name], old_v)
    return dataclasses.replace(st, **new)


def asd_round(model_fn: ModelFn, schedule: Schedule, st: ASDChainState,
              theta: int, eager_head: bool = False,
              keep_trajectory: bool = True,
              controller: ThetaController = _STATIC,
              conds=None, noise_mode: str = "buffer", num_branches: int = 1,
              branch_controller: BranchController = _STATIC_B) -> ASDChainState:
    """One speculation round of every chain: propose, roll theta steps,
    verify all chains' points in ONE model call, GRS, commit.

    ``theta`` is the static cap: the round always rolls and verifies
    theta-shaped windows, and ``st.theta_live`` masks how many slots count.
    The GRS step goes through ``repro_torch.kernels.grs`` (the CUDA kernel
    on the card).  ``conds`` (B, d_cond) conditions each chain's calls.
    ``num_branches`` > 1 verifies every branch of every chain in the one
    call and commits each chain's longest accepted prefix.  Identity on
    finished chains.  Nothing in a round reads a device value on the host."""
    K = schedule.K
    theta = _clamp_theta(theta, K)
    plan = plan_round(model_fn, schedule, st, theta, eager_head, keep_trajectory,
                      conds, noise_mode, num_branches)
    if num_branches > 1:
        z, acc, g_head, b_r, gain = _branched_verify_select(
            model_fn, st, plan, theta, num_branches, eager_head, conds)
        return commit_round(schedule, st, plan, z, acc, plan.theta_live, g_head, theta,
                            eager_head, keep_trajectory, controller, b_r=b_r, gain=gain,
                            num_branches=num_branches, branch_controller=branch_controller)
    B = st.a.shape[0]
    ev = tuple(st.v_cache.shape[1:])
    ev_ndim = len(ev)
    t_w = plan.t_w1[:, :theta]
    y_prev = plan.y_prev

    if eager_head:
        # the head point sits at the END of the live window: on a full accept
        # the chain lands on y_props[theta_live - 1]
        rows = torch.arange(B, device=st.a.device)
        y_head = plan.y_props[rows, plan.theta_live - 1]
        pts = torch.cat([y_prev, y_head[:, None]], dim=1)
        ts = torch.cat([t_w, plan.t_w1[rows, plan.theta_live][:, None]], dim=1)
        g_all = _call(model_fn, ts.reshape(-1), pts.reshape((B * (theta + 1),) + ev),
                      conds, theta + 1)
        g_all = g_all.reshape((B, theta + 1) + ev)
        g_par, g_head = g_all[:, :-1], g_all[:, -1]
    else:
        g_par = _call(model_fn, t_w.reshape(-1), y_prev.reshape((B * theta,) + ev),
                      conds, theta)
        g_par = g_par.reshape((B, theta) + ev)
        g_head = None
    m_tgt = (bcast_right(plan.A_w, ev_ndim + 2) * y_prev
             + bcast_right(plan.B_w, ev_ndim + 2) * g_par)

    z, acc = grs(plan.u_w, plan.xi_w, plan.m_hats, m_tgt, plan.sig_w,
                 event_ndim=ev_ndim)
    return commit_round(schedule, st, plan, z, acc, plan.theta_live, g_head,
                        theta, eager_head, keep_trajectory, controller)


def select_longest(acc_b: torch.Tensor, n_valid: torch.Tensor, b_r: torch.Tensor):
    """The branch each chain commits: accept bits (B, NB, theta), masked to
    the first ``n_valid`` (B,) slots, and the branches that ran, ``b_r``
    (B,).  Returns (best (B,), the masked bits (B, NB, theta), gain (B,)):
    the branch with the longest accepted prefix, the lowest index on ties
    (``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does),
    and its prefix's length over branch 0's."""
    NB, theta = acc_b.shape[1:]
    acc_m = acc_b & (torch.arange(theta, device=acc_b.device) < n_valid[:, None, None])
    lead_b = leading_true_count(acc_m, dim=2).to(torch.int64)
    live = torch.arange(NB, device=acc_b.device) < b_r[:, None]
    lead_m = torch.where(live, lead_b, -1)
    best = torch.argmax(lead_m, dim=1)
    rows = torch.arange(acc_b.shape[0], device=acc_b.device)
    return best, acc_m, lead_m[rows, best] - lead_b[:, 0]


def _branched_verify_select(model_fn: ModelFn, st: ASDChainState, plan: RoundPlan,
                            theta: int, num_branches: int, eager_head: bool, conds):
    """Phase 2 of a branched round: one model call over every chain's
    NB x theta points (and NB eager heads), one GRS pass over the
    (B, NB, theta) rows (B1 on the card), and the longest accepted prefix.
    Returns (z, acc, g_head, b_r, gain) for ``commit_round``; branches at or
    past a chain's ``b_live`` are masked out of the selection."""
    NB = num_branches
    B = st.a.shape[0]
    ev = tuple(st.v_cache.shape[1:])
    ev_ndim = len(ev)
    rows = torch.arange(B, device=st.a.device)
    b_live = torch.clamp(st.b_live, 1, NB)
    t_w = plan.t_w1[:, None, :theta].expand(B, NB, theta).reshape(B, NB * theta)
    y_prev = plan.y_prev_b.reshape((B, NB * theta) + ev)
    per = NB * theta
    if eager_head:
        # a head point per branch at the end of the live window: whichever
        # branch wins a full accept, its head is the next proposal call
        heads = plan.y_props_b[rows, :, plan.theta_live - 1]
        pts = torch.cat([y_prev, heads], dim=1)
        ts = torch.cat([t_w, plan.t_w1[rows, plan.theta_live][:, None].expand(B, NB)], dim=1)
        per += NB
    else:
        pts, ts = y_prev, t_w
    g_all = _call(model_fn, ts.reshape(-1), pts.reshape((B * per,) + ev), conds, per)
    g_all = g_all.reshape((B, per) + ev)
    g_par = g_all[:, :NB * theta].reshape((B, NB, theta) + ev)
    m_tgt = (bcast_right(plan.A_w[:, None], ev_ndim + 3) * plan.y_prev_b
             + bcast_right(plan.B_w[:, None], ev_ndim + 3) * g_par)
    sig = plan.sig_w[:, None].expand(B, NB, theta)
    z_b, acc_b = grs(plan.u_w_b, plan.xi_w_b, plan.m_hats_b, m_tgt, sig, event_ndim=ev_ndim)
    best, acc_m, gain = select_longest(acc_b, plan.n_valid, b_live)
    g_head = g_all[:, NB * theta:][rows, best] if eager_head else None
    return z_b[rows, best], acc_m[rows, best], g_head, b_live, gain


def asd_superstep(model_fn: ModelFn, schedule: Schedule, st: ASDChainState,
                  theta: int, rounds: int, eager_head: bool = False,
                  keep_trajectory: bool = True,
                  controller: ThetaController = _STATIC,
                  conds=None, noise_mode: str = "buffer", num_branches: int = 1,
                  branch_controller: BranchController = _STATIC_B) -> ASDChainState:
    """``rounds`` speculation rounds in a row: R calls of ``asd_round``
    (the JAX package's ``lax.scan``), with no read of a device value on the
    host between them, so the card runs the R rounds as one queue of
    launches.  A chain that finishes mid-superstep is frozen by
    ``commit_round`` for the remaining rounds, counters included."""
    for _ in range(int(rounds)):
        st = asd_round(model_fn, schedule, st, theta, eager_head,
                       keep_trajectory, controller, conds, noise_mode, num_branches,
                       branch_controller)
    return st


def asd_sample_batched(model_fn: ModelFn, schedule: Schedule, y0: torch.Tensor,
                       theta: int, eager_head: bool = False,
                       keep_trajectory: bool = True,
                       controller: ThetaController = _STATIC,
                       generator: Optional[torch.Generator] = None,
                       u_buf: Optional[torch.Tensor] = None,
                       xi_buf: Optional[torch.Tensor] = None,
                       device=None, conds: Optional[torch.Tensor] = None,
                       key=None, noise_mode: str = "buffer", num_branches: int = 1,
                       branch_controller: BranchController = _STATIC_B,
                       keys=None, eager: bool = False) -> ASDResult:
    """ASD on independent chains y0 (B, *event), stepped together.

    Each round makes one proposal call over the B chains and one
    verification call over their B * theta points; the loop runs until the
    slowest chain finishes, and finished chains stay frozen.  ``key`` (2,)
    is split into one key a chain, as the JAX package splits it, and the
    chains draw from those in ``noise_mode`` ("buffer" or "counter").
    ``keys`` (B, 2), in place of ``key``, gives the chains' keys
    themselves: a rank that holds chains [b n, (b + 1) n) of a batch passes
    rows b n ... (b + 1) n - 1 of ``split(key, chains)``, and its chains
    draw what they draw in the whole batch.  Without a key, ``u_buf`` / ``xi_buf`` inject each chain's noise (see
    ``init_chain_state``), or it is drawn from ``generator`` (buffer mode).
    ``theta >= K`` gives ASD-infinity.

    ``model_fn(t: f32[m], y: f32[m, *event]) -> f32[m, *event]`` must accept
    any leading batch size m; with ``conds`` (B, d_cond), one condition row
    a chain, it is called as ``model_fn(t, y, cond_rows)`` with the row of
    every point.  ``num_branches`` > 1 runs branched rounds (it needs
    ``key``).  Runs on ``device`` (None means "cuda").  ``eager``: the
    rounds run eagerly on the card too, never captured (a model function
    whose collectives are staged through the host, which no graph can
    capture: the serve CLI's fused engine over a mesh's model axis); see
    ``SamplerLoop``.
    """
    dev = resolve_device(device)
    if keys is not None:
        if key is not None:
            raise ValueError("asd_sample_batched: key or keys, not both")
        keys = prng.as_key(keys, dev)
        if tuple(keys.shape) != (y0.shape[0], 2):
            raise ValueError(f"keys {tuple(keys.shape)} for {y0.shape[0]} chains: one "
                             "(2,) key a chain")
    elif key is not None:
        keys = prng.split(prng.as_key(key, dev), y0.shape[0])
    return _sample(model_fn, schedule, y0.to(dev), theta, eager_head, keep_trajectory,
                   controller, generator, u_buf, xi_buf, conds, keys, noise_mode,
                   num_branches, branch_controller, eager)


def _rounds_bound(a: torch.Tensor, K: int, theta: int) -> int:
    """The fewest rounds in which every chain at host positions ``a`` (B,)
    could be done: 0 when all are.

    A round advances a chain by at most theta: ``commit_round`` advances by
    ``lead + rejected <= n_valid = min(theta_r, K - a)``, and theta_r is
    the live window clamped to [1, theta] (``plan_round``), theta itself
    clamped to K (``_clamp_theta``).  That holds for every theta
    controller (they only move theta_live inside the clamp), for branches
    (the selected branch's prefix is masked to the same n_valid) and for
    the eager head (it changes which call is made, not the advance).  So a
    chain at a < K needs at least ceil((K - a) / theta) more rounds, and a
    loop that checked after every round would run at least the largest of
    these before it stopped."""
    left = K - a[a < K]
    return -(-int(left.max()) // theta) if left.numel() else 0


class SamplerLoop:
    """The sampler's ``while_loop``: one ``asd_round`` over a batch of
    chains as a program (``repro_torch.programs``), replayed until every
    chain is done.  On the card the first round runs eagerly and is
    captured as a CUDA graph, and every later round replays it; on the CPU
    each round runs eagerly through the same code.

    The loop owns the round fields of its chain state (a tensor of its own
    for each: ``init_chain_state`` hands the counters one zero tensor) and
    writes every round back into them in place.  The keys, noise buffers,
    condition rows, schedule and weights are read where they are and must
    not be rebound; ``load`` copies a fresh batch of chains into all of
    them, so one loop serves batch after batch of the same shapes with no
    second capture.  No round draws from a generator: buffers are drawn
    by ``init_chain_state``, before the loop.

    ``run`` replays the round ``_rounds_bound`` times back to back, then
    reads the positions (one small copy to the host) and repeats until
    every chain is done.  The bound never exceeds the rounds a loop
    checking after every round would still run, and finished chains are
    frozen, so the result is that loop's, bit for bit and counter for
    counter, with one host read per bound of rounds.

    ``eager``: every round runs eagerly on the card too, through the same
    code, and nothing is captured: the caller asks for it where the model
    function's collectives are staged through the host (a host copy and a
    gloo call cannot be captured).  Without it the round is captured on
    the card, and a capture that fails raises."""

    def __init__(self, model_fn: ModelFn, schedule: Schedule, st: ASDChainState,
                 theta: int, eager_head: bool = False, keep_trajectory: bool = True,
                 controller: ThetaController = _STATIC, conds=None,
                 noise_mode: str = "buffer", num_branches: int = 1,
                 branch_controller: BranchController = _STATIC_B, eager: bool = False):
        self.K = schedule.K
        self.theta = theta = _clamp_theta(theta, self.K)
        self.keep_trajectory = keep_trajectory
        self.state = state = dataclasses.replace(
            st, **{name: getattr(st, name).clone() for name in _ROUND_FIELDS})
        self.conds = conds

        # the body holds locals, not self: a loop that holds its program
        # through a closure over itself would be a cycle, and its graph and
        # pool would outlive the call until the next collection
        def body():
            with torch.no_grad():
                new = asd_round(model_fn, schedule, state, theta, eager_head,
                                keep_trajectory, controller, conds, noise_mode,
                                num_branches, branch_controller)
                for name in _ROUND_FIELDS:
                    dst, src = getattr(state, name), getattr(new, name)
                    if src is not dst:
                        dst.copy_(src)

        self.program = SuperstepProgram(body, st.a.device, eager=eager)

    def load(self, st: ASDChainState, conds=None) -> None:
        """Copy fresh chains ``st`` (and their condition rows) into the
        loop's tensors, in place."""
        with torch.no_grad():
            for f in dataclasses.fields(ASDChainState):
                src = getattr(st, f.name)
                if src is not None:
                    getattr(self.state, f.name).copy_(src)
            if conds is not None:
                self.conds.copy_(conds)

    def run(self) -> LoopStats:
        """Run the loaded chains, fresh at a = 0 (which the host knows
        without a read), until every one is done."""
        stats = LoopStats()
        cold = self.program.calls == 0
        a = torch.zeros(self.state.a.shape, dtype=torch.int64)
        while n := _rounds_bound(a, self.K, self.theta):
            for _ in range(n):
                self.program()
            stats.rounds += n
            a = self.state.a.cpu()
            stats.host_reads += 1
        if cold:
            stats.capture_ms = self.program.capture_ms
        return stats

    def result(self, stats: LoopStats) -> ASDResult:
        """The loop's chains as a result; its tensors are views of the
        loop's, which the next ``load`` overwrites."""
        st, keep = self.state, self.keep_trajectory
        return ASDResult(
            sample=chain_sample(st, self.K, keep),
            trajectory=st.y[:, : self.K + 1] if keep else st.y,
            rounds=st.rounds, head_calls=st.head_calls,
            model_evals=st.model_evals, accepts=st.accepts,
            proposals=st.proposals, draft_points=st.draft_points, loop=stats)


def _sample(model_fn, schedule, y0, theta, eager_head, keep_trajectory, controller,
            generator, u_buf, xi_buf, conds, keys, noise_mode, num_branches=1,
            branch_controller=_STATIC_B, eager=False) -> ASDResult:
    """Chains y0 (B, *event) on y0's device, each from its own key of
    ``keys`` (B, 2) or else from the buffers or the generator, run to K by
    a ``SamplerLoop`` of their own (each call captures anew)."""
    dev = y0.device
    schedule = schedule.to(dev)
    st = init_chain_state(schedule, y0, theta, keep_trajectory, controller, generator,
                          u_buf, xi_buf, keys, noise_mode, num_branches, branch_controller)
    if conds is not None:
        conds = conds.to(dev)
        if conds.shape[0] != y0.shape[0]:
            raise ValueError(f"conds: {conds.shape[0]} rows for {y0.shape[0]} chains")
    loop = SamplerLoop(model_fn, schedule, st, theta, eager_head, keep_trajectory,
                       controller, conds, noise_mode, num_branches, branch_controller,
                       eager)
    return loop.result(loop.run())


def asd_sample(model_fn: ModelFn, schedule: Schedule, y0: torch.Tensor,
               theta: int, eager_head: bool = False,
               keep_trajectory: bool = True,
               controller: ThetaController = _STATIC,
               generator: Optional[torch.Generator] = None,
               u_buf: Optional[torch.Tensor] = None,
               xi_buf: Optional[torch.Tensor] = None,
               device=None, cond: Optional[torch.Tensor] = None,
               key=None, noise_mode: str = "buffer", num_branches: int = 1,
               branch_controller: BranchController = _STATIC_B) -> ASDResult:
    """ASD for one chain y0 (*event): ``key`` (2,) is the chain's own key
    (not split, as in the JAX package), or ``u_buf`` (K+theta+1,) and
    ``xi_buf`` (K+theta+1, *event) inject its noise; ``cond`` (d_cond,)
    conditions it.  Results have no batch axis."""
    dev = resolve_device(device)
    res = _sample(
        model_fn, schedule, y0.to(dev)[None], theta, eager_head, keep_trajectory,
        controller, generator, None if u_buf is None else u_buf[None],
        None if xi_buf is None else xi_buf[None],
        None if cond is None else cond[None],
        None if key is None else prng.as_key(key, dev)[None], noise_mode, num_branches,
        branch_controller)
    return ASDResult(**{f.name: getattr(res, f.name)[0]
                        for f in dataclasses.fields(ASDResult) if f.name != "loop"},
                     loop=res.loop)


def asd_init_y0(schedule: Schedule, key, event_shape, dtype=torch.float32):
    """The JAX package's ``asd_init_y0``: y0 (*event) drawn from ``key`` on
    its device (zeros where the schedule starts at zero)."""
    key = prng.as_key(key)
    return init_y0(schedule, event_shape, dtype=dtype, device=key.device, key=key)
