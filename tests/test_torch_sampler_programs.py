"""The sampler's loop and the K-step baseline as programs, on the CPU.

``asd_sample_batched`` runs a ``SamplerLoop`` (one round as a program,
replayed once per bound of rounds, one host read of the positions per
bound), and the sequential samplers a ``SequentialProgram`` (one step with
a device step index, replayed K times).  On the CPU a program runs its body
eagerly, so these tests hold the loop's control flow:

  * against the JAX package's ``asd_sample_batched`` (its ``while_loop``)
    from the same key, in buffer and counter noise, at B 1 and 2 branches,
    with the static and aimd controllers, on the GMM oracle: counters equal
    and samples within 1e-5 (``tests/test_torch_asd.py``'s tolerance);
  * against the loop that checks every round (written here from
    ``init_chain_state`` and ``asd_round``): the same bits, counters and
    rounds, with host reads at most the rounds; a bound one round too long
    is seen;
  * the step program against JAX ``sequential_sample`` and
    ``sequential_sample_with_noise``, and bit for bit against the eager
    step loop, with and without the trajectory;
  * ``ASDServingEngine`` serving twice with one program;
  * a finished loop freed by reference counting alone."""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analytic as j_an
from repro.core import asd as j_asd
from repro.core import controller as j_ctl
from repro.core import schedules as j_sch
from repro.core import sequential as j_seq
from repro.serving.engine import Request as JRequest
from repro_torch.core import analytic as t_an
from repro_torch.core import asd as t_asd
from repro_torch.core import controller as t_ctl
from repro_torch.core import prng
from repro_torch.core import schedules as t_sch
from repro_torch.core import sequential as t_seq
from repro_torch.serving.engine import Request
from tests.test_torch_static_engine import _engines

COUNTERS = ("rounds", "head_calls", "model_evals", "accepts", "proposals", "draft_points")
D, K, THETA, CHAINS = 2, 16, 4, 3
TOL = 1e-5


def _gmm():
    return (j_an.sl_mean_fn(j_an.default_gmm(D)), t_an.sl_mean_fn(t_an.default_gmm(D)),
            j_sch.sl_uniform(K, t_max=8.0), t_sch.sl_uniform(K, t_max=8.0))


def _controllers(kind):
    return j_ctl.make_controller(kind), t_ctl.make_controller(kind)


def _y0():
    return np.random.default_rng(1).standard_normal((CHAINS, D)).astype(np.float32)


def _eager_loop(model_fn, sched, y0, theta, key, **kw):
    """The loop that checks every round on the host, as the sampler ran
    before it became a program: (final state, rounds run)."""
    keys = prng.split(prng.as_key(key), y0.shape[0])
    st = t_asd.init_chain_state(sched, y0, theta, kw["keep_trajectory"], kw["controller"],
                                key=keys, noise_mode=kw["noise_mode"],
                                num_branches=kw["num_branches"])
    rounds = 0
    while not bool(t_asd.chain_done(st, sched.K).all()):
        st = t_asd.asd_round(model_fn, sched, st, theta, kw["eager_head"],
                             kw["keep_trajectory"], kw["controller"], None, kw["noise_mode"],
                             kw["num_branches"])
        rounds += 1
    return st, rounds


CASES = [(noise, nb, ctl) for noise in ("buffer", "counter") for nb in (1, 2)
         for ctl in ("static", "aimd")]


@pytest.mark.parametrize("noise,nb,ctl", CASES)
def test_sampler_loop_matches_jax(noise, nb, ctl):
    jfn, tfn, js, ts = _gmm()
    jc, tc = _controllers(ctl)
    key = jax.random.PRNGKey(7)
    y0 = _y0()
    jr = j_asd.asd_sample_batched(jfn, js, jnp.asarray(y0), key, THETA, eager_head=True,
                                  noise_mode=noise, keep_trajectory=False, controller=jc,
                                  num_branches=nb)
    tr = t_asd.asd_sample_batched(tfn, ts, torch.from_numpy(y0), THETA, eager_head=True,
                                  keep_trajectory=False, controller=tc, device="cpu",
                                  key=np.asarray(key), noise_mode=noise, num_branches=nb)
    for name in COUNTERS:
        assert getattr(tr, name).tolist() == np.asarray(getattr(jr, name)).tolist(), name
    np.testing.assert_allclose(tr.sample.numpy(), np.asarray(jr.sample), rtol=TOL, atol=TOL)
    assert tr.loop.rounds == int(np.asarray(jr.rounds).max())
    assert 1 <= tr.loop.host_reads <= tr.loop.rounds
    assert tr.loop.capture_ms is None  # nothing is captured on the CPU
    assert bool((tr.accepts < tr.proposals).any())  # the reject path ran


@pytest.mark.parametrize("keep", [False, True])
@pytest.mark.parametrize("noise,nb,ctl", CASES)
def test_host_read_rule_runs_the_eager_loops_rounds(noise, nb, ctl, keep):
    """The same bits, counters and rounds as the loop that checks every
    round, with at most one host read a round."""
    _, tfn, _, ts = _gmm()
    kw = dict(eager_head=True, keep_trajectory=keep, controller=t_ctl.make_controller(ctl),
              noise_mode=noise, num_branches=nb)
    y0, key = torch.from_numpy(_y0()), prng.PRNGKey(11)
    st, rounds = _eager_loop(tfn, ts, y0, THETA, key, **kw)
    res = t_asd.asd_sample_batched(tfn, ts, y0, THETA, device="cpu", key=key, **kw)
    assert res.loop.rounds == rounds == int(st.rounds.max())
    assert res.loop.host_reads <= rounds
    for name in COUNTERS:
        assert torch.equal(getattr(res, name), getattr(st, name)), name
    assert torch.equal(res.sample, t_asd.chain_sample(st, K, keep))


def _zero_model(t, y):
    return torch.zeros_like(y)


def test_a_bound_one_round_too_long_is_seen(monkeypatch):
    """With a model whose proposals are always accepted, every round
    advances theta, so the first bound is the whole run: one round more
    than it overruns the eager loop, which the rounds gate sees (the bits
    and counters alone do not: finished chains are frozen)."""
    _, _, _, ts = _gmm()
    kw = dict(eager_head=False, keep_trajectory=False, controller=t_ctl.StaticTheta(),
              noise_mode="counter", num_branches=1)
    y0, key = torch.zeros((CHAINS, D)), prng.PRNGKey(3)
    st, rounds = _eager_loop(_zero_model, ts, y0, THETA, key, **kw)
    assert rounds == -(-K // THETA)
    right = t_asd.asd_sample_batched(_zero_model, ts, y0, THETA, device="cpu", key=key, **kw)
    assert right.loop.rounds == rounds and right.loop.host_reads == 1
    bound = t_asd._rounds_bound
    first = []

    def too_long(a, K_, theta):
        n = bound(a, K_, theta)
        if not first:
            first.append(n)
            return n + 1
        return n

    monkeypatch.setattr(t_asd, "_rounds_bound", too_long)
    wrong = t_asd.asd_sample_batched(_zero_model, ts, y0, THETA, device="cpu", key=key, **kw)
    assert wrong.loop.rounds == rounds + 1 != rounds
    for name in COUNTERS:
        assert torch.equal(getattr(wrong, name), getattr(right, name)), name


@pytest.mark.parametrize("a,want", [([0, 0], 4), ([16, 3], 4), ([15, 16], 1), ([16, 16], 0),
                                    ([1, 9], 4)])
def test_rounds_bound(a, want):
    assert t_asd._rounds_bound(torch.tensor(a), K, THETA) == want


# ------------------------------------------------------------- sequential


def _eager_steps(model_fn, sched, y, xi, conds=None):
    """The K steps as the eager loop ran them, indexed by a Python int."""
    m, traj = y.shape[0], [y]
    for i in range(sched.K):
        t = sched.t_model[i].expand(m)
        g = model_fn(t, y) if conds is None else model_fn(t, y, conds)
        y = sched.A[i] * y + sched.B[i] * g + sched.sigma[i] * xi[i]
        traj.append(y)
    return y, torch.stack(traj)


def test_sequential_program_matches_jax_and_the_eager_loop():
    jfn, tfn, js, ts = _gmm()
    key = jax.random.PRNGKey(5)
    y0 = _y0()[0]
    jy, jtraj = j_seq.sequential_sample(jfn, js, jnp.asarray(y0), key, return_trajectory=True)
    xi = np.array(jax.random.normal(key, (K, D), jnp.float32))
    ty = t_seq.sequential_sample_with_noise(tfn, ts, torch.from_numpy(y0),
                                            torch.from_numpy(xi), device="cpu")
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    jn = j_seq.sequential_sample_with_noise(jfn, js, jnp.asarray(y0), jnp.asarray(xi))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jn), rtol=TOL, atol=TOL)
    ey, etraj = _eager_steps(tfn, ts, torch.from_numpy(y0)[None], torch.from_numpy(xi)[:, None])
    assert torch.equal(ty, ey[0])
    # the trajectory, from a generator: row i+1 written by step i
    g = torch.Generator().manual_seed(4)
    gy, gtraj = t_seq.sequential_sample(tfn, ts, torch.from_numpy(y0), generator=g,
                                        return_trajectory=True, device="cpu")
    xi_g = torch.randn((K, D), generator=torch.Generator().manual_seed(4))
    ey, etraj = _eager_steps(tfn, ts, torch.from_numpy(y0)[None], xi_g[:, None])
    assert gtraj.shape == (K + 1, D) and torch.equal(gtraj, etraj[:, 0])
    assert torch.equal(gy, ey[0]) and torch.equal(gtraj[-1], gy)
    assert np.asarray(jtraj).shape == tuple(gtraj.shape)


def test_sequential_program_batched_with_conds_is_the_eager_loop():
    _, _, _, ts = _gmm()

    def cond_model(t, y, c):
        return torch.tanh(y * c[:, :1] + t[:, None])

    y0 = torch.from_numpy(np.random.default_rng(2).standard_normal((4, D)).astype(np.float32))
    conds = torch.linspace(0.5, 2.0, 8).reshape(4, 2)
    xi = torch.randn((K, 4, D), generator=torch.Generator().manual_seed(9))
    got = t_seq.sequential_sample_batched(cond_model, ts, y0, xi=xi, conds=conds, device="cpu")
    want, _ = _eager_steps(cond_model, ts, y0, xi, conds)
    assert torch.equal(got, want)
    prog = t_seq.SequentialProgram(cond_model, ts, y0, xi.clone(), conds.clone(), True)
    assert torch.equal(prog.run(), want) and int(prog.step) == K
    assert prog.program.calls == K
    # a second batch through the same program: the step index restarts
    prog.load(y0 * 2, xi, conds)
    want2, traj2 = _eager_steps(cond_model, ts, y0 * 2, xi, conds)
    assert torch.equal(prog.run(), want2) and torch.equal(prog.trajectory, traj2)


# ----------------------------------------------------------------- engine


@pytest.mark.parametrize("mode,sched", [("asd", "ddpm"), ("ddpm", "sl")])
def test_static_engine_keeps_one_program(mode, sched):
    """Two serves of the same shapes (conditioned, two chunks each) through
    one ``ASDServingEngine``: one program, built by the first chunk and
    loaded by every later one; equal results from equal keys, and the JAX
    engine's from the same key within ``test_torch_static_engine.py``'s
    1e-4."""
    jeng, eng = _engines(mode, sched, 3)
    rng = np.random.default_rng(4)
    conds = [rng.standard_normal(3).astype(np.float32) for _ in range(5)]
    key = jax.random.PRNGKey(21)
    jout = jeng.serve([JRequest(i, cond=c) for i, c in enumerate(conds)], key)
    reqs = [Request(i, cond=c) for i, c in enumerate(conds)]
    first = eng.serve(reqs, np.asarray(key))
    prog = eng._program
    assert isinstance(prog, t_asd.SamplerLoop if mode == "asd" else t_seq.SequentialProgram)
    second = eng.serve(reqs, np.asarray(key))
    assert eng._program is prog and eng.stats.batches == 4
    for rid in range(5):
        assert np.array_equal(first[rid], second[rid]), rid
        np.testing.assert_allclose(first[rid], np.asarray(jout[rid]), rtol=1e-4, atol=1e-4)


def test_loop_state_is_its_own():
    """The loop writes its round fields into tensors of its own (the
    counters of a fresh state share one zero tensor)."""
    _, tfn, _, ts = _gmm()
    st = t_asd.init_chain_state(ts, torch.zeros((CHAINS, D)), THETA, key=prng.split(
        prng.PRNGKey(1), CHAINS))
    assert st.rounds is st.accepts
    loop = t_asd.SamplerLoop(tfn, ts, st, THETA)
    fields = [f for f in t_asd._ROUND_FIELDS if getattr(st, f).numel()]
    ptrs = [getattr(loop.state, f).data_ptr() for f in fields]
    assert len(set(ptrs)) == len(ptrs)
    stats = loop.run()
    assert [getattr(loop.state, f).data_ptr() for f in fields] == ptrs
    assert stats.rounds == int(loop.state.rounds.max())
    assert not st.rounds.any()  # the state the loop was made from is untouched
    assert loop.state.u_buf is st.u_buf  # read where it is


@pytest.mark.parametrize("kind", ["asd", "sequential"])
def test_finished_program_is_freed_without_a_collection(kind):
    """A loop and its program form no reference cycle: with the collector
    off, dropping the loop frees its program (on the card its graph and
    pool), while the results it handed out stay valid."""
    _, tfn, _, ts = _gmm()
    y0 = torch.from_numpy(_y0())
    collecting = gc.isenabled()
    gc.disable()
    try:
        if kind == "asd":
            st = t_asd.init_chain_state(ts, y0, THETA, key=prng.split(prng.PRNGKey(3), CHAINS))
            loop = t_asd.SamplerLoop(tfn, ts, st, THETA)
            out = loop.result(loop.run()).sample
        else:
            xi = torch.randn((K,) + tuple(y0.shape), generator=torch.Generator().manual_seed(3))
            loop = t_seq.SequentialProgram(tfn, ts, y0, xi)
            out = loop.run()
        program = weakref.ref(loop.program)
        del loop
        assert program() is None
    finally:
        if collecting:
            gc.enable()
    assert out.shape == y0.shape and torch.isfinite(out).all()
