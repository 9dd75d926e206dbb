"""The worker's admission programs and in-program sync packet, on the CPU.

Admission (the JAX worker's ``_admit_fn`` at one power-of-two width) runs
``init_chain_state`` over a boundary's staged chains and writes every field
into the slot tensors at their indices; the superstep program ends by
writing the sync packet into tensors the worker owns, and the host copies
it into one of two buffers.  On the CPU a program runs its body eagerly, so
these hold the programs' results against the eager versions they replace:

  * admission at widths 1, 2, 3 (padded to 4) and S, in buffer (with noise
    injected by some requests) and counter noise, conditioned: the slot
    tensors bit for bit the per-field writes of one ``init_chain_state`` a
    request; at most one program a power-of-two width;
  * the packet bit for bit the eager one (nine stacked int32 rows and
    ``chain_sample``), alternating between two buffers made once;
  * the JAX worker's admission from the same keys (counters and keys equal,
    y0 within 1e-6)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analytic as j_an
from repro.core import schedules as j_sch
from repro.serving.worker import ShardWorker as JWorker
from repro_torch.core import analytic as t_an
from repro_torch.core import prng
from repro_torch.core import schedules as t_sch
from repro_torch.core.asd import ASDChainState, chain_sample, init_chain_state
from repro_torch.core.controller import make_controller
from repro_torch.core.sequential import init_y0
from repro_torch.serving.engine import ContinuousASDEngine, Request
from repro_torch.serving.worker import _SYNC_ROWS, ShardWorker, _as_tensor

D, K, THETA, D_COND = 3, 16, 4, 2


def _cond_model(gmm):
    fn = t_an.sl_mean_fn(gmm)

    def model_fn(t, y, cond):
        return fn(t, y) + 0.25 * cond[:, :1]

    return model_fn


def _engine(slots, noise, cls=ContinuousASDEngine, **kw):
    return cls(_cond_model(t_an.default_gmm(D)), t_sch.sl_uniform(K, t_max=8.0), (D,),
               num_slots=slots, theta=THETA, d_cond=D_COND, noise_mode=noise,
               controller=make_controller("aimd"), seed=3, device="cpu", **kw)


def _eager_admit(eng, placed):
    """The admission the program replaces: one ``init_chain_state`` a
    request, every field written into its slot, then its condition row."""
    states = eng._states
    for slot, req in placed:
        key = prng.as_key(req.key) if req.key is not None else eng._request_key(req.rid)
        if req.y0 is not None:
            y0 = _as_tensor(req.y0, eng.device)
        else:
            key, k0 = prng.split(key, 2).unbind(0)
            y0 = init_y0(eng.schedule, eng.event_shape, device=eng.device, key=k0)
        new = init_chain_state(
            eng.schedule, y0[None], eng.theta, eng.keep_trajectory, eng.controller, None,
            None if req.u_buf is None else _as_tensor(req.u_buf, eng.device)[None],
            None if req.xi_buf is None else _as_tensor(req.xi_buf, eng.device)[None],
            key=key[None], noise_mode=eng.noise_mode, num_branches=eng.num_branches,
            branch_controller=eng.branch_controller)
        for f in dataclasses.fields(ASDChainState):
            rows = getattr(new, f.name)
            if rows is not None:
                getattr(states, f.name)[slot] = rows[0]
        eng._conds[slot] = 0.0 if req.cond is None else _as_tensor(req.cond, eng.device)


def _slots(eng):
    st = eng._states
    out = {f.name: getattr(st, f.name).clone() for f in dataclasses.fields(st)
           if getattr(st, f.name) is not None}
    out["conds"] = eng._conds.clone()
    return out


def _requests(start, n, noise):
    rng = np.random.default_rng(start)
    n_buf = K + THETA + 1
    reqs = []
    for rid in range(start, start + n):
        kw = {}
        if rid % 3 == 0:
            kw["key"] = np.array([0, 900 + rid], np.uint32)
        if rid % 4 == 1:
            kw["y0"] = rng.standard_normal(D).astype(np.float32)
        if rid % 2 == 0:
            kw["cond"] = rng.standard_normal(D_COND).astype(np.float32)
        if noise == "buffer" and rid % 5 == 2:
            kw["u_buf"] = rng.uniform(size=n_buf).astype(np.float32)
        if noise == "buffer" and rid % 5 == 3:
            kw["xi_buf"] = rng.standard_normal((n_buf, D)).astype(np.float32)
        reqs.append(Request(rid, **kw))
    return reqs


@pytest.mark.parametrize("noise", ["buffer", "counter"])
@pytest.mark.parametrize("slots", [4, 6])
def test_admission_program_equals_the_per_field_writes(noise, slots):
    """Widths 1, 2, 3 (padded to 4) and S in one worker, against the same
    admissions written field by field; slots are reused (re-admission)."""
    prog_eng, eager_eng = _engine(slots, noise), _engine(slots, noise)
    assert all(torch.equal(a, b) for a, b in zip(_slots(prog_eng).values(),
                                                 _slots(eager_eng).values()))
    rid, widths = 0, []
    for n in (1, 2, 3, slots):
        placed = list(zip(range(n), _requests(rid, n, noise)))
        rid += n
        prog_eng._admit(placed)
        _eager_admit(eager_eng, placed)
        got, want = _slots(prog_eng), _slots(eager_eng)
        for name in want:
            assert torch.equal(got[name], want[name]), (n, name)
        widths.append(1 << (n - 1).bit_length())
    assert sorted(prog_eng._admit_fns) == sorted(set(widths))
    assert len(prog_eng._admit_fns) <= prog_eng._admit_bound() == (slots - 1).bit_length() + 1
    if slots == 4:
        assert prog_eng._admit_bound() == slots.bit_length()
    # the last width-4 admission: 3 chains padded with the first, or S = 4
    stage = prog_eng._admit_fns[4].stage
    assert tuple(stage["y0"].shape) == (4, D)
    assert stage["slots"].tolist() == ([0, 1, 2, 3] if slots == 4 else [0, 1, 2, 0])


def test_counter_noise_refuses_injected_buffers():
    eng = _engine(4, "counter")
    with pytest.raises(ValueError, match="counter noise"):
        eng._admit([(0, Request(0, u_buf=np.zeros(K + THETA + 1, np.float32)))])


@pytest.mark.parametrize("execution", ["unpacked", "packed"])
def test_packet_is_the_eager_packet_in_two_buffers(execution):
    """Each superstep's packet equals the eager stack of the slot tensors'
    nine rows (int32) and their samples, bit for bit; packets go to two
    buffers made once, so packet s is intact after superstep s + 1."""
    kw = dict(execution="packed", round_budget=8) if execution == "packed" else {}
    eng = _engine(4, "counter", rounds_per_sync=2, **kw)
    buffers = [(id(h), id(s)) for h, s in zip(eng._info_out, eng._samples_out)]
    for r in _requests(0, 4, "counter"):
        eng.submit(r)
    eng._admit_pending()
    packets = []
    for step in range(3):
        eng._launch_superstep(2, eng._pick_budget())
        st = eng._states
        want_info = torch.stack([getattr(st, n) for n in _SYNC_ROWS]).to(torch.int32)
        want_samples = chain_sample(st, K, eng.keep_trajectory).clone()
        host, ready, samples = eng._sync_packet()
        assert ready is None and (id(host), id(samples)) == buffers[step % 2]
        assert torch.equal(host, want_info) and torch.equal(samples, want_samples)
        packets.append((host.clone(), samples.clone(), host, samples))
    # packet 1 was not overwritten by superstep 2 (it went to the other buffer)
    assert torch.equal(packets[1][2], packets[1][0])
    assert not torch.equal(packets[0][0], packets[1][0])


def test_admission_matches_the_jax_worker():
    """The JAX worker's ``_admit_fn`` from the same serve key and requests
    (keys derived from the request ids, y0 drawn from the split key): keys,
    positions, windows and controller states equal; y0 within 1e-6."""
    js = j_sch.sl_uniform(K, t_max=8.0)
    jw = JWorker(j_an.sl_mean_fn(j_an.default_gmm(D)), js, (D,), num_slots=4, theta=THETA,
                 noise_mode="counter", seed=3)
    tw = ShardWorker(t_an.sl_mean_fn(t_an.default_gmm(D)), t_sch.sl_uniform(K, t_max=8.0),
                     (D,), num_slots=4, theta=THETA, noise_mode="counter", seed=3,
                     device="cpu")
    reqs = [Request(r) for r in range(3)]
    for w in (jw, tw):
        for r in reqs:
            w.scheduler.submit(r, 0.0)
        w._admit_pending()
    jst, tst = jw._states, tw._states
    for name in ("k_u", "k_xi"):
        assert np.array_equal(getattr(tst, name).numpy(),
                              np.asarray(getattr(jst, name)).astype(np.int64)), name
    for name in ("a", "theta_live", "rounds"):
        assert getattr(tst, name).tolist() == np.asarray(getattr(jst, name)).tolist(), name
    np.testing.assert_allclose(tst.v_cache.numpy(), np.asarray(jst.v_cache))
    np.testing.assert_allclose(tst.y[:, 0].numpy(), np.asarray(jst.y[:, 0]), atol=1e-6,
                               rtol=1e-6)
    assert jnp.asarray(jst.y).shape == tuple(tst.y.shape)
    assert jax.devices()[0].platform == "cpu"
