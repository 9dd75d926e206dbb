"""The ranks' side of ``tests/test_torch_mesh_serve.py``: what each rank of a
serve mesh computes, in a module that imports no JAX (the ranks are spawned
processes, and import this module by name).

``rank_cases(group, meshes, inputs)`` runs, on this rank, every continuous
engine case of ``GMM_CASES`` on each mesh of ``meshes`` (the analytic GMM
oracle) beside the 1 x 1 engine on the same requests, stepping both in
lockstep and holding this rank's block of every ``ASDChainState`` field
against the 1 x 1 rows at each boundary; with ``inputs`` (the numpy params
the test wrote) also the ``paper-diffusion-policy-smoke`` engine and the
fused sampler on the first mesh, the planted fault, and last the serve
CLI's rank function ``serve_rank`` on each of ``cli_argvs`` (rank 0's
printed lines)."""

from __future__ import annotations

import contextlib
import dataclasses
import io
import time

import numpy as np
import torch

from repro_torch.core import analytic as t_an
from repro_torch.core import prng
from repro_torch.core import schedules as t_sch
from repro_torch.core.asd import ASDChainState, asd_sample_batched
from repro_torch.distributed.sharding import chain_state_shardings
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_rank_mesh
from repro_torch.models.diffusion import make_ddpm_model_fn
from repro_torch.serving.engine import ContinuousASDEngine
from repro_torch.serving.scheduler import make_policy
from repro_torch.serving.worker import Request
from repro_torch.weights import from_jax_params

import torch_mp_ranks as mp

COUNTERS = ("rounds", "head_calls", "model_evals", "accepts", "proposals", "draft_points")
# the GMM cases: K, theta, slots, requests as tests/test_torch_sharded_engine.py
K, THETA, SLOTS, N_REQ = 16, 5, 4, 9
GMM_CASES = {
    "r1": dict(rounds_per_sync=1),
    "auto_counter": dict(rounds_per_sync="auto", noise_mode="counter",
                         keep_trajectory=False),
    "deadline": dict(rounds_per_sync=2, policy="deadline"),
}
# the policy smoke denoiser (its engine and the fused sampler) against JAX
POLICY_K, POLICY_THETA, POLICY_REQ, CHAINS = 10, 4, 6, 4
_GMM = t_an.sl_mean_fn(t_an.default_gmm(2))


def gmm_requests(n=N_REQ):
    return [Request(i, key=np.array([0, 100 + i], np.uint32), y0=np.zeros((2,), np.float32))
            for i in range(n)]


def counters(eng) -> dict:
    return {m.rid: tuple(getattr(m, c) for c in COUNTERS) for m in eng.stats.per_request}


def slot_bytes(eng) -> int:
    st = eng._states
    return sum(t.numel() * t.element_size() for f in dataclasses.fields(ASDChainState)
               if (t := getattr(st, f.name)) is not None)


def _gmm_engine(kw, state_sharding=None):
    kw = dict(kw)
    if "policy" in kw:
        kw["policy"] = make_policy(kw["policy"], drop_late=True)
    return ContinuousASDEngine(_GMM, t_sch.sl_uniform(K, t_max=8.0), (2,), num_slots=SLOTS,
                               theta=THETA, eager_head=True, device="cpu",
                               state_sharding=state_sharding,
                               **dict(dict(keep_trajectory=True), **kw))


def _block_problems(eng, ref, boundary) -> list:
    """Fields of this rank's block that differ from the 1 x 1 rows."""
    rows = eng.slot_rows
    bad = []
    for f in dataclasses.fields(ASDChainState):
        mine, whole = getattr(eng._states, f.name), getattr(ref._states, f.name)
        if (mine is None) != (whole is None) or (
                mine is not None and not torch.equal(mine, whole[rows])):
            bad.append((boundary, f.name))
    return bad


def gmm_case(layout, name: str, rank: int) -> dict:
    """One GMM case on this rank: the mesh engine and the 1 x 1 engine
    stepped in lockstep (the block held at every boundary), then both
    served again through ``serve``."""
    kw = GMM_CASES[name]
    eng, ref = _gmm_engine(kw, layout), _gmm_engine(kw)
    out = {"eager": eng._eager, "rows": (eng.slot_rows.start, eng.slot_rows.stop),
           "bytes": slot_bytes(eng), "ref_bytes": slot_bytes(ref)}
    mine_reqs, ref_reqs = gmm_requests(), gmm_requests()
    deadline = kw.get("policy") == "deadline"
    n = 6 if deadline else N_REQ
    for e, reqs in ((eng, mine_reqs[:4] if deadline else mine_reqs),
                    (ref, ref_reqs[:4] if deadline else ref_reqs)):
        for r in reqs:
            e.submit(r)
    # boundary 0: the dummy chains, before any admission
    bad, boundaries = _block_problems(eng, ref, 0), 0
    if deadline:
        # a warm round gives the policy its seconds-per-round estimate; then
        # rids 4 and 5 queue with deadlines that differ by rank (rank 0 and
        # the 1 x 1 run: rid 4's has passed; the other ranks: rid 5's), and
        # the ranks follow rank 0's decision
        eng.step(), ref.step()
        boundaries += 1
        bad += _block_problems(eng, ref, boundaries)
        late, far = (4, 5) if rank == 0 else (5, 4)
        mine_reqs[late].deadline, mine_reqs[far].deadline = 0.0, time.perf_counter() + 1e6
        ref_reqs[4].deadline, ref_reqs[5].deadline = 0.0, time.perf_counter() + 1e6
        for e, reqs in ((eng, mine_reqs), (ref, ref_reqs)):
            for r in reqs[4:n]:
                e.submit(r)
    while True:
        more, ref_more = eng.step(), ref.step()
        boundaries += 1
        bad += _block_problems(eng, ref, boundaries)
        if more != ref_more:
            bad.append((boundaries, "has_work"))
        if not more or not ref_more:
            break
    out.update(boundaries=boundaries, bad=bad, samples=eng.drain_results(),
               counters=counters(eng), dropped=list(eng.dropped_rids),
               rounds=eng.stats.rounds_total, gather_s=eng.stats.gather_s)
    if rank == 0:
        out.update(ref_samples=ref.drain_results(), ref_counters=counters(ref),
                   ref_dropped=list(ref.dropped_rids))
    if not deadline:  # the serve loop (dispatch before harvest) on fresh engines
        eng, ref = _gmm_engine(kw, layout), _gmm_engine(kw)
        out["served"] = (eng.serve(gmm_requests()), counters(eng))
        if rank == 0:
            out["ref_served"] = (ref.serve(gmm_requests()), counters(ref))
    return out


def policy_requests(dc):
    rng = np.random.default_rng(100)
    return [Request(i, key=np.array([0, 100 + i], np.uint32),
                    y0=rng.standard_normal((dc.seq_len, dc.d_data)).astype(np.float32))
            for i in range(POLICY_REQ)]


def fused_y0(dc) -> np.ndarray:
    return np.random.default_rng(0).standard_normal(
        (CHAINS, dc.seq_len, dc.d_data)).astype(np.float32)


def _fused(model_fn, dc, y0, **keys):
    res = asd_sample_batched(model_fn, t_sch.ddpm(POLICY_K), torch.from_numpy(y0),
                             POLICY_THETA, eager_head=True, keep_trajectory=False,
                             device="cpu", noise_mode="counter", **keys)
    return {k: getattr(res, k).numpy() for k in ("sample", "rounds", "head_calls")}


def policy_cases(layout, data, rank: int) -> dict:
    """The smoke denoiser on this rank: the continuous engine (keyed
    requests, counter noise) and the fused sampler's block of chains, and
    on rank 0 their 1 x 1 runs; the planted fault draws the block's chains
    from ``split(key, n_local)``."""
    dc = mp.config(mp.POLICY)
    params = from_jax_params(mp.params_tree(data, mp.POLICY, dc), dc, "cpu")
    model_fn = make_ddpm_model_fn(params, dc)

    def engine(state_sharding=None):
        return ContinuousASDEngine(model_fn, t_sch.ddpm(POLICY_K), (dc.seq_len, dc.d_data),
                                   num_slots=SLOTS, theta=POLICY_THETA, eager_head=True,
                                   noise_mode="counter", keep_trajectory=False,
                                   device="cpu", state_sharding=state_sharding)

    eng = engine(layout)
    out = {"engine": (eng.serve(policy_requests(dc)), counters(eng))}
    rows = layout.rows(CHAINS)
    y0 = fused_y0(dc)
    with torch.no_grad():
        out["fused"] = _fused(model_fn, dc, y0[rows],
                              keys=prng.split(prng.PRNGKey(1), CHAINS)[rows])
        out["fused_fault"] = _fused(model_fn, dc, y0[rows], key=prng.PRNGKey(1))
        if rank == 0:
            ref = engine()
            out["ref_engine"] = (ref.serve(policy_requests(dc)), counters(ref))
            out["ref_fused"] = _fused(model_fn, dc, y0, key=prng.PRNGKey(1))
    return out


def rank_cases(group, meshes, inputs=None, cli_argvs=()) -> dict:
    torch.set_num_threads(1)  # the ranks share the test's CPU
    out = {"rank": group.rank, "gmm": {}, "index": {}}
    layouts = {}
    for spec in meshes:
        mesh = make_rank_mesh(group, spec)
        layouts[spec] = layout = chain_state_shardings(mesh)
        out["index"][spec] = (layout.index, dict(mesh.coords))
        for name in GMM_CASES:
            out["gmm"][spec, name] = gmm_case(layout, name, group.rank)
    if inputs is not None:
        out["policy"] = policy_cases(layouts[meshes[0]], dict(np.load(inputs)), group.rank)
    out["cli"] = []
    for argv in cli_argvs:  # last: serve_rank sets the rank's thread count
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            serve.serve_rank(group, argv)
        out["cli"].append(printed.getvalue())
    return out
