"""The port's fused dispatch against the JAX package's own fused dispatch.

JAX's ``ShardedASDEngine(dispatch="fused")`` needs one device a shard, so
it runs in a subprocess with two forced host devices.  On this JAX its
``shard_map`` calls pass ``check_rep``, which ``jax.shard_map`` now names
``check_vma`` (a TypeError); the subprocess wraps
``repro.distributed.sharding.get_shard_map`` to rename the argument.  The
wrapper lives in this test only: the JAX package is not changed.  The
subprocess writes the per-request samples and counters of 2 shards to an
``.npz``; the port's fused dispatch must give the counters and be within
1e-5 of the samples (the analytic GMM oracle, keyed requests)."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_sharded_engine import COUNTERS, K, THETA, _metrics, _port, _t_requests

ROOT = Path(__file__).resolve().parents[1]
N = 9
CONFIGS = {
    "unpacked": {},
    "fused-round-auto-budget": dict(execution="packed", round_impl="fused",
                                    round_budget="auto"),
}

_SCRIPT = textwrap.dedent(f"""
    import sys
    import jax
    import numpy as np
    from repro.distributed import sharding

    _shard_map = sharding.get_shard_map

    def _renamed():
        sm = _shard_map()

        def call(*args, check_rep=None, **kw):
            if check_rep is not None:
                kw["check_vma"] = check_rep
            return sm(*args, **kw)
        return call

    sharding.get_shard_map = _renamed

    from repro.core import analytic, schedules
    from repro.serving.engine import Request
    from repro.serving.router import make_router
    from repro.serving.sharded import ShardedASDEngine

    assert len(jax.devices()) == 2
    model = analytic.sl_mean_fn(analytic.default_gmm(2))
    out = {{}}
    for name, kw in {CONFIGS!r}.items():
        eng = ShardedASDEngine(
            lambda cond: model, schedules.sl_uniform({K}, t_max=8.0), (2,), num_slots=4,
            theta={THETA}, eager_head=True, keep_trajectory=True, shards=2,
            dispatch="fused", router=make_router("round-robin"), **kw)
        samples = eng.serve([Request(i, key=jax.random.PRNGKey(100 + i),
                                     y0=np.zeros((2,), np.float32)) for i in range({N})])
        m = {{r.rid: r for r in eng.stats.per_request}}
        out[name + "/samples"] = np.stack([samples[i] for i in range({N})])
        out[name + "/counters"] = np.array(
            [[getattr(m[i], c) for c in {COUNTERS!r}] for i in range({N})])
        out[name + "/routed"] = eng.routed_counts
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def jax_fused(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_fused") / "fused.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(path)], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_fused_dispatch_matches_jax_fused_dispatch(jax_fused, config):
    eng = _port(shards=2, dispatch="fused", **CONFIGS[config])
    out = eng.serve(_t_requests(N))
    samples = np.stack([out[i] for i in range(N)])
    np.testing.assert_allclose(samples, jax_fused[config + "/samples"], rtol=1e-5, atol=1e-5)
    m = _metrics(eng)
    assert np.array_equal(np.array([m[i] for i in range(N)]), jax_fused[config + "/counters"])
    assert eng.routed_counts.tolist() == jax_fused[config + "/routed"].tolist()
