"""The port's superstep programs on the CPU, in the port alone: engines that
adopt a warm engine's programs give a fresh engine's bits (the
counterparts of JAX's ``adopt_programs`` tests in
``tests/test_serving_engine.py`` and ``tests/test_obs.py``), the slot
tensors never change address, the fused round takes its budget as an int
or as a 0-d tensor to the same bits, and a cold dispatch stays out of
``dispatch_s`` and carries ``cold`` in its span."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import paper_diffusion_policy_smoke
from repro_torch.core import schedules as t_sch
from repro_torch.models.diffusion import make_sl_model_fn
from repro_torch.serving import packing as t_pack
from repro_torch.serving.engine import ContinuousASDEngine, Request
from repro_torch.serving.obs import TraceRecorder
from repro_torch.programs import SuperstepProgram
from repro_torch.weights import init_denoiser_params
from tests.test_torch_packed_round import K as ROUND_K
from tests.test_torch_packed_round import SLOTS as ROUND_SLOTS
from tests.test_torch_packed_round import THETA as ROUND_THETA
from tests.test_torch_packed_round import smoke_case, slot_states

K, THETA = 16, 5
_DC = paper_diffusion_policy_smoke()
_MODEL = make_sl_model_fn(init_denoiser_params(_DC, 0, out_scale=1.0, device="cpu"), _DC)
_EVENT = (_DC.seq_len, _DC.d_data)


def _engine(num_slots=4, tracer=None, **kw):
    kw = dict(dict(theta=THETA, eager_head=True, keep_trajectory=True), **kw)
    return ContinuousASDEngine(_MODEL, t_sch.sl_geometric(K, 0.05, 10.0), _EVENT,
                               num_slots=num_slots, device="cpu", seed=3, tracer=tracer, **kw)


def _requests(n, seed0=100):
    return [Request(i, key=np.array([0, seed0 + i], np.uint32)) for i in range(n)]


@pytest.fixture(scope="module")
def warm():
    eng = _engine()
    eng.serve(_requests(2, seed0=10**6))
    return eng


def _assert_same_bits(a, b):
    assert sorted(a) == sorted(b)
    for rid in a:
        np.testing.assert_array_equal(a[rid], b[rid])


@pytest.mark.parametrize("rounds_per_sync", [1, 3])
def test_adopted_engine_gives_a_fresh_engines_bits(warm, rounds_per_sync):
    """More requests than slots, through an engine that adopted the warm
    one's programs, and through a fresh engine: the same bits."""
    fresh = _engine(rounds_per_sync=rounds_per_sync).serve(_requests(6))
    eng = _engine(rounds_per_sync=rounds_per_sync).adopt_programs(warm)
    assert eng._graph_pool is warm._graph_pool
    _assert_same_bits(eng.serve(_requests(6)), fresh)
    # each worker builds its own programs: a graph binds its own slot tensors
    assert eng._compiled_supersteps == 1 and eng._superstep_fns is not warm._superstep_fns


def test_traced_adopted_engine_keeps_its_spans_and_bits(tmp_path):
    """Tracing is host bookkeeping: an engine that adopted a plain one's
    programs and records spans gives the plain engine's bits."""
    plain = _engine()
    out_plain = plain.serve(_requests(6))
    tr = TraceRecorder()
    traced = _engine(tracer=tr).adopt_programs(plain)
    _assert_same_bits(out_plain, traced.serve(_requests(6)))
    names = {s["name"] for s in tr.spans()}
    assert {"dispatch", "device_wait", "harvest", "queued", "request"} <= names
    req_spans = [s for s in tr.spans() if s["name"] == "request"]
    assert sorted(s["args"]["rid"] for s in req_spans) == list(range(6))
    assert all(s["tid"] < traced.num_slots for s in req_spans)
    dispatch = [s for s in tr.spans() if s["name"] == "dispatch"]
    assert all(s["tid"] == traced.num_slots for s in dispatch)
    # the adopter still builds (on the card: captures) its own program once
    assert [s["args"]["cold"] for s in dispatch] == [True] + [False] * (len(dispatch) - 1)
    doc = tr.export_chrome_trace(str(tmp_path / "t.json"))
    assert doc["droppedEvents"] == 0


@pytest.mark.parametrize("kw", [dict(theta=THETA - 1), dict(num_slots=3),
                                dict(execution="packed"), dict(noise_mode="counter")],
                         ids=["theta", "slots", "execution", "noise"])
def test_adopt_refuses_other_statics(warm, kw):
    with pytest.raises(ValueError, match="statics"):
        _engine(**kw).adopt_programs(warm)


def _addresses(eng):
    st = eng._states
    ptrs = {f.name: getattr(st, f.name).data_ptr()
            for f in dataclasses.fields(st) if getattr(st, f.name) is not None}
    ptrs.update(weights=eng._weights_dev.data_ptr(), budget=eng._budget_dev.data_ptr())
    return ptrs


@pytest.mark.parametrize("kw", [
    dict(execution="unpacked", rounds_per_sync=2),
    dict(execution="packed", round_impl="fused", round_budget="auto",
         rounds_per_sync="auto", noise_mode="counter", keep_trajectory=False),
    dict(execution="packed", round_budget=6, num_branches=2, noise_mode="counter",
         keep_trajectory=False),
], ids=["unpacked", "fused-auto-counter", "packed-branched"])
def test_slot_tensors_keep_their_addresses(kw):
    """Admission and supersteps write into the slot tensors: no field,
    nor the weights or the budget tier, ever moves (a graph replays on the
    addresses it was captured on), across supersteps and two waves."""
    eng = _engine(num_slots=2, **kw)
    before = _addresses(eng)
    for wave in range(2):
        for r in _requests(3, seed0=100 * wave):
            eng.submit(r)
        while eng.step():
            assert _addresses(eng) == before
        assert len(eng.drain_results()) == 3
    assert eng.stats.supersteps > 4


@pytest.mark.parametrize("allocator", ["waterfill", "proportional", "priority"])
def test_fused_budget_as_int_or_tensor_gives_the_same_bits(allocator):
    """The fused round with its tier as an int and as the 0-d int64 tensor
    the worker fills: equal bits in every field, at a binding tier."""
    case = smoke_case()
    _, st = slot_states(case, seed=4)
    live = st.a < ROUND_K
    assert int(torch.minimum(st.theta_live, ROUND_K - st.a)[live].sum()) > 5  # binding
    alloc = (t_pack.WaterfillingAllocator(theta_max=ROUND_THETA) if allocator == "waterfill"
             else t_pack.make_allocator(allocator))
    weights = torch.tensor([1.0, 2.0, 1.0, 1.5])
    outs = []
    for tier in (5, torch.tensor(5, dtype=torch.int64)):
        with torch.no_grad():
            outs.append(t_pack.packed_superstep(
                case.t_fn, case.ts, st, None, weights, rounds=2, theta=ROUND_THETA,
                budget=ROUND_SLOTS * ROUND_THETA, allocator=alloc, eager_head=True,
                round_impl="fused", budget_data=tier))
    for f in dataclasses.fields(outs[0]):
        a, b = getattr(outs[0], f.name), getattr(outs[1], f.name)
        assert (a is None and b is None) or torch.equal(a, b), f.name


def test_cold_dispatch_stays_out_of_dispatch_time():
    """The first call of each program is cold: its span says so, and it
    adds nothing to dispatch_s nor to the seconds-per-round EWMA."""
    tr = TraceRecorder()
    eng = _engine(tracer=tr, execution="packed", round_budget="auto", rounds_per_sync="auto")
    observed = []
    observe = eng._observe_round_time
    eng._observe_round_time = lambda dt: (observed.append(dt), observe(dt))
    eng.serve(_requests(6))
    dispatch = [s for s in tr.spans() if s["name"] == "dispatch"]
    cold = [s["args"]["cold"] for s in dispatch]
    assert sum(cold) == eng._compiled_supersteps == len(eng._superstep_fns) >= 1
    assert cold[0] and not all(cold)
    warm_s = sum(s["dur"] for s, c in zip(dispatch, cold) if not c)
    assert eng.stats.dispatch_s == pytest.approx(warm_s, rel=1e-9)
    assert len(observed) == len(dispatch) - sum(cold)
    waits = [s for s in tr.spans() if s["name"] == "device_wait"]
    assert [s["args"]["cold"] for s in waits] == cold


def test_a_program_on_the_cpu_runs_its_body_every_call():
    calls = []
    prog = SuperstepProgram(lambda: calls.append(1), "cpu")
    assert [prog(), prog(), prog()] == [True, False, False]
    assert len(calls) == prog.calls == 3 and prog.graph is None and prog.launches is None
