"""The sharded front end's checks and views, on the CPU: its validation
(slot counts, dispatch modes, a model_shards other than its model group's
world, a model group without params),
``chain_state(shard, slot)`` in both dispatch modes (in fused dispatch a
view of the stacked batch), one program a boundary in fused dispatch,
``instrument_engine``'s label set a shard, ``healthz``'s worst shard, and
the ``route`` instant and frontend lanes of the trace."""

import json
import urllib.request

import numpy as np
import pytest
import torch

from repro_torch.core import analytic as t_an
from repro_torch.core import schedules as t_sch
from repro_torch.distributed.group import ModelGroup
from repro_torch.serving.obs import MetricsRegistry, MetricsServer, TraceRecorder, \
    instrument_engine
from repro_torch.serving.engine import Request
from repro_torch.serving.router import make_router
from repro_torch.serving.sharded import ShardedASDEngine

K, THETA = 16, 5
_MODEL = t_an.sl_mean_fn(t_an.default_gmm(2))


def _engine(shards=2, num_slots=4, **kw):
    kw = dict(dict(theta=THETA, eager_head=True, keep_trajectory=True,
                   router=make_router("round-robin")), **kw)
    return ShardedASDEngine(_MODEL, t_sch.sl_uniform(K, t_max=8.0), (2,), num_slots=num_slots,
                            shards=shards, device="cpu", **kw)


def _requests(n, seed0=100):
    return [Request(i, key=np.array([0, seed0 + i], np.uint32), y0=np.zeros(2, np.float32))
            for i in range(n)]


@pytest.mark.parametrize("what,kw,match", [
    ("slots over shards", dict(shards=3), "divide evenly"),
    ("no shards", dict(shards=0), "shards must be"),
    ("unknown dispatch", dict(dispatch="broadcast"), "dispatch"),
    ("model shards", dict(model_shards=2), "must equal the model group's world"),
    ("param specs", dict(model_group=ModelGroup(0, 1, "cpu"), param_specs={"w": None}),
     "needs explicit params AND param_specs"),
    ("short devices", dict(devices=["cpu"]), "shorter"),
])
def test_the_engine_validates_what_jax_validates(what, kw, match):
    with pytest.raises(ValueError, match=match):
        _engine(**kw)


@pytest.mark.parametrize("dispatch", ["per-shard", "fused"])
def test_chain_state_of_a_shard_and_slot(dispatch):
    eng = _engine(dispatch=dispatch, execution="packed", round_budget=2 * THETA)
    for r in _requests(4):
        eng.submit(r)
    eng.step()
    for shard in range(2):
        for slot in range(2):
            st = eng.chain_state(shard, slot)
            w = eng.workers[shard]
            assert int(st.a) == int(w._states.a[slot]) and int(st.a) > 0
            assert torch.equal(st.y, w._states.y[slot])
    if dispatch == "fused":  # views of the one stacked batch
        st = eng.chain_state(1, 0)
        assert st.y.data_ptr() == eng._states.y[1, 0].data_ptr()
        assert eng.workers[1]._states.a.data_ptr() == eng._states.a[1].data_ptr()
        assert eng.workers[1]._weights_dev.data_ptr() == eng._weights[1].data_ptr()
    while eng.step():
        pass
    assert sorted(eng.drain_results()) == [0, 1, 2, 3]


def test_fused_dispatch_runs_one_program_a_boundary():
    eng = _engine(shards=4, num_slots=8, dispatch="fused", execution="packed",
                  round_impl="fused", round_budget="auto")
    out = eng.serve(_requests(11))
    assert sorted(out) == list(range(11))
    assert not any(w._superstep_fns for w in eng.workers)  # no per-shard program
    (prog,) = eng._fused_fns.values()  # budget as data: one program for every tier
    boundaries = eng.workers[0].stats.supersteps
    assert prog.calls == boundaries and eng.stats.supersteps == 4 * boundaries
    assert all(w.stats.supersteps == boundaries for w in eng.workers)
    assert len(eng._fused_admit_fns) <= 4  # powers of two up to 8 rows
    assert eng._compiled_supersteps == 1
    s = eng.stats
    assert s.fused_dispatch_s > 0 and s.dispatch_s == 0.0
    assert all(w.stats.fused_dispatch_s == 0.0 for w in eng.workers)
    assert s.timing_breakdown()["fused_dispatch_s"] == s.fused_dispatch_s


def test_instrument_engine_gives_a_label_set_a_shard_and_healthz_the_worst():
    eng = _engine(shards=2)
    reg = instrument_engine(MetricsRegistry(), eng)
    eng.serve(_requests(4))
    snap = reg.snapshot()
    retired = {s["labels"]["shard"]: s["value"] for s in snap["asd_retired_total"]["samples"]}
    assert retired == {"0": 2, "1": 2}
    assert {s["labels"]["shard"] for s in snap["asd_rounds_total"]["samples"]} == {"0", "1"}
    assert eng.healthz()["status"] == "ok" and len(eng.healthz()["shards"]) == 2
    eng.workers[1].begin_drain()
    hz = eng.healthz()
    assert hz["status"] == "draining" and eng.draining
    assert [h["status"] for h in hz["shards"]] == ["ok", "draining"]
    with pytest.raises(RuntimeError, match="draining"):
        eng.submit(Request(99))
    server = MetricsServer(reg, health_fn=eng.healthz, port=0)
    server.start()
    try:
        try:
            body = urllib.request.urlopen(server.url + "/healthz", timeout=5).read()
        except urllib.error.HTTPError as e:  # a 503 carries the document too
            body = e.read()
        assert json.loads(body)["status"] == "draining"
    finally:
        server.stop()


def test_backpressure_in_one_shard_is_the_engines_status():
    """A shard is saturated once more than its slot batch (2) is queued."""
    eng = _engine(shards=2)
    for r in _requests(2):
        eng.workers[1].scheduler.submit(r, 0.0)
    assert eng.healthz()["status"] == "ok"
    eng.workers[1].scheduler.submit(Request(2), 0.0)
    hz = eng.healthz()
    assert hz["status"] == "backpressure"
    assert [h["saturated"] for h in hz["shards"]] == [False, True]


@pytest.mark.parametrize("dispatch", ["per-shard", "fused"])
def test_the_trace_holds_the_route_instant_and_the_frontend_lanes(dispatch):
    tracer = TraceRecorder()
    eng = _engine(dispatch=dispatch, tracer=tracer)
    eng.serve(_requests(5))
    doc = tracer.to_chrome()
    events = doc["traceEvents"]
    routes = [e for e in events if e["name"] == "route"]
    assert len(routes) == 5 and {e["args"]["shard"] for e in routes} == {0, 1}
    names = {e["name"] for e in events}
    if dispatch == "fused":
        assert {"fused_dispatch", "fused_device_wait", "harvest", "request"} <= names
        assert "dispatch" not in names
    else:
        assert {"dispatch", "device_wait", "harvest", "request"} <= names
        assert "fused_dispatch" not in names
    frontend = [e for e in events if e.get("ph") == "M" and e["args"].get("name") == "frontend"]
    assert frontend and all(e["pid"] == 2 for e in frontend)
