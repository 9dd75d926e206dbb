"""The port's serving observability (``repro_torch.serving.obs``) against the
JAX package's: the trace recorder and the metrics registry, fed the same
spans and the same stats, render the same Chrome trace JSON and the same
Prometheus text; the engine's catalog is the JAX one, the model-parallel
collective gauges included; the HTTP endpoints answer on an ephemeral
port."""

import json
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro.serving import metrics as j_metrics
from repro.serving import obs as j_obs
from repro.serving import scheduler as j_sched
from repro_torch.core import analytic as t_an
from repro_torch.core import schedules as t_sch
from repro_torch.serving import metrics as t_metrics
from repro_torch.serving import obs as t_obs
from repro_torch.serving import scheduler as t_sched
from repro_torch.serving.engine import ContinuousASDEngine, Request

# the JAX catalog's families the port's engine has no feature for yet (none)
_NOT_PORTED = ()


def _record(rec, t0):
    rec.add_span("dispatch", t0 + 0.001, t0 + 0.004, pid=0, tid=4, pname="shard-0",
                 tname="dispatch", args={"superstep": 1, "R": 2, "budget": None})
    rec.add_span("queued", t0, t0 + 0.002, pid=0, tid=1, tname="slot-1", args={"rid": 7})
    rec.add_instant("retire", t0 + 0.005, pid=0, tid=1, args={"rid": 7})
    for i in range(6):  # overflows a capacity-5 ring: the oldest drop
        rec.add_span("harvest", t0 + 0.01 * i, t0 + 0.01 * i + 0.003, pid=1, tid=6,
                     pname="shard-1", tname="harvest", args={"retired": i})


@pytest.mark.parametrize("capacity", [5, 64])
def test_trace_renders_what_jax_renders(tmp_path, capacity):
    j_rec, t_rec = j_obs.TraceRecorder(capacity=capacity), t_obs.TraceRecorder(capacity=capacity)
    t_rec.epoch = j_rec.epoch
    _record(j_rec, j_rec.epoch)
    _record(t_rec, j_rec.epoch)
    assert t_rec.to_chrome() == j_rec.to_chrome()
    assert t_rec.spans() == j_rec.spans() and len(t_rec) == len(j_rec)
    assert t_rec.dropped == j_rec.dropped == max(0, 9 - capacity)
    j_doc = j_rec.export_chrome_trace(str(tmp_path / "j.json"))
    t_doc = t_rec.export_chrome_trace(str(tmp_path / "t.json"))
    assert t_doc == j_doc
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    t_rec.clear()
    assert len(t_rec) == 0 and t_rec.to_chrome()["traceEvents"][0]["ph"] == "M"


def test_a_disabled_recorder_records_nothing():
    rec = t_obs.TraceRecorder(enabled=False)
    rec.add_span("x", 0.0, 1.0)
    assert len(rec) == 0
    with pytest.raises(ValueError):
        t_obs.TraceRecorder(capacity=0)


def _fill(reg, values):
    reg.counter("req_total", "requests", shard="0").inc(3)
    reg.counter("req_total", "requests", shard="1", fn=lambda: 11)
    reg.gauge("depth", "queue depth", shard="0").set(2.5)
    reg.gauge("ratio", 'a "quoted" help', fn=lambda: 1 / 3, kind='we\\ird"\n')
    h = reg.histogram("lat_seconds", "latency", buckets=(0.01, 0.1, 1.0), shard="0")
    for v in values:
        h.observe(v)
    reg.histogram("pulled_seconds", "pulled", fn=lambda: list(values))
    return reg


def test_registry_renders_what_jax_renders():
    values = [0.005, 0.05, 0.05, 0.5, 5.0]
    j_reg, t_reg = _fill(j_obs.MetricsRegistry(), values), _fill(t_obs.MetricsRegistry(), values)
    assert t_reg.render() == j_reg.render()
    assert t_reg.snapshot() == j_reg.snapshot()
    with pytest.raises(ValueError, match="already registered"):
        t_reg.gauge("req_total")
    with pytest.raises(ValueError, match=">= 0"):
        t_reg.counter("req_total", shard="0").inc(-1)


def _stub_engine(metrics, sched_mod):
    """An engine-shaped object over the given package's stats and
    scheduler, with the same numbers in both packages."""
    stats = metrics.EngineStats(shard=0)
    stats.requests, stats.rounds_total, stats.supersteps = 4, 30, 12
    for rid, (q, s, r, a, p) in enumerate([(0.01, 0.2, 9, 20, 30), (0.5, 0.3, 8, 25, 27),
                                            (0.02, 1.5, 12, 30, 44)]):
        stats.observe(metrics.RequestMetrics(rid=rid, queue_latency=q, service_time=s,
                                             rounds=r, head_calls=r // 2, model_evals=a + r,
                                             accepts=a, proposals=p, draft_points=2 * p))
    stats.observe_drop()
    sched = sched_mod.SlotScheduler(3)
    for i in range(5):
        sched.submit(types.SimpleNamespace(rid=i, priority=0.0, deadline=None,
                                           expected_accept_rate=None), 0.0)
    sched.deferred = 2
    ctx = sched_mod.AdmissionContext(K=16, theta_max=4, round_budget=8, live_demand=6)
    return types.SimpleNamespace(shard_id=0, stats=stats, scheduler=sched, round_budget=8,
                                 num_slots=3, draining=False,
                                 _admission_context=lambda now: ctx)


def _families(text):
    """Prometheus text -> {family: its lines}."""
    out = {}
    for line in text.splitlines():
        name = line.split()[2] if line.startswith("#") else line.split("{")[0].split()[0]
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in out:
                name = name[: -len(suffix)]
        out.setdefault(name, []).append(line)
    return out


def test_instrument_engine_renders_the_jax_catalog():
    j_reg = j_obs.instrument_engine(j_obs.MetricsRegistry(), _stub_engine(j_metrics, j_sched))
    t_reg = t_obs.instrument_engine(t_obs.MetricsRegistry(), _stub_engine(t_metrics, t_sched))
    j_fams, t_fams = _families(j_reg.render()), _families(t_reg.render())
    assert set(j_fams) - set(t_fams) == set(_NOT_PORTED)
    assert t_fams == {k: v for k, v in j_fams.items() if k not in _NOT_PORTED}
    snap = t_reg.snapshot()
    assert snap["asd_retired_total"]["samples"][0]["value"] == 3
    assert snap["asd_queue_depth"]["samples"][0]["value"] == 5


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def test_the_endpoints_answer_on_an_ephemeral_port():
    eng = ContinuousASDEngine(t_an.sl_mean_fn(t_an.default_gmm(2)),
                              t_sch.sl_uniform(8, t_max=8.0), (2,), num_slots=2, theta=3,
                              device="cpu", noise_mode="counter")
    eng.serve([Request(i) for i in range(3)])
    server = t_obs.MetricsServer(t_obs.instrument_engine(t_obs.MetricsRegistry(), eng),
                                 health_fn=eng.healthz, port=0).start()
    try:
        assert server.port > 0 and server.url.startswith("http://127.0.0.1:")
        code, ctype, body = _get(server.url + "/metrics")
        assert code == 200 and ctype == t_obs.PROM_CONTENT_TYPE
        assert 'asd_retired_total{shard="0"} 3' in body.decode().splitlines()
        code, _, body = _get(server.url + "/metrics.json")
        assert code == 200 and json.loads(body)["asd_rounds_total"]["samples"][0]["value"] > 0
        code, _, body = _get(server.url + "/healthz")
        assert code == 200 and json.loads(body)["status"] == "ok"
        eng.begin_drain()
        code, _, body = _get(server.url + "/healthz")
        assert code == 503 and json.loads(body)["status"] == "draining"
        assert _get(server.url + "/nowhere")[0] == 404
    finally:
        server.stop()


def test_the_engine_records_its_spans():
    rec = t_obs.TraceRecorder()
    eng = ContinuousASDEngine(t_an.sl_mean_fn(t_an.default_gmm(2)),
                              t_sch.sl_uniform(8, t_max=8.0), (2,), num_slots=2, theta=3,
                              device="cpu", rounds_per_sync=2, tracer=rec)
    eng.serve([Request(i) for i in range(3)])
    names = [s["name"] for s in rec.spans()]
    supersteps = eng.stats.supersteps
    assert names.count("dispatch") == names.count("device_wait") == supersteps
    assert names.count("harvest") == supersteps
    assert names.count("queued") == names.count("request") == 3
    req = [s for s in rec.spans() if s["name"] == "request"]
    assert sorted(s["args"]["rid"] for s in req) == [0, 1, 2]
    assert all(s["tid"] < 2 for s in req)  # one lane per slot
    lanes = {e["args"]["name"] for e in rec.to_chrome()["traceEvents"] if e["ph"] == "M"}
    assert {"shard-0", "dispatch", "device", "harvest", "slot-0"} <= lanes
    assert np.isfinite([s["dur"] for s in rec.spans()]).all()
