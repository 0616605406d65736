"""The port's cluster at layer level on the CPU: ``run_layer``, its
resident-filter store, stragglers, dead workers and elastic re-plan.

Mirrors ``tests/test_runtime.py``.  The port runs ``backend="kernel"`` (the
kernels' plain versions on CPU tensors) and is held against the uncoded
convolution and the reference's ``FcdccCluster.run_layer`` on the same
numpy inputs and the same survivors.  Tolerance 1e-5 relative and absolute
against the reference (fp32 sums in another order through one decode);
the reference's own 1e-3 against the float64 numpy convolution.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.fcdcc import FcdccPlan as RefPlan
from repro.core.partition import ConvGeometry as RefGeo
from repro.core.partition import np_reference_conv
from repro.runtime import FcdccCluster as RefCluster
from repro.runtime import StragglerModel as RefStraggler
from repro_torch.core.fcdcc import FcdccPlan
from repro_torch.core.partition import ConvGeometry
from repro_torch.runtime import (ClusterDegraded, FcdccCluster, StragglerModel,
                                 run_layer_elastic)

RNG = np.random.default_rng(0)
PLAN = FcdccPlan(n=6, k_a=2, k_b=4)
GEO = ConvGeometry(3, 8, 12, 12, 3, 3, 1, 1, 2, 4)
X = RNG.standard_normal((3, 12, 12)).astype(np.float32)
K = RNG.standard_normal((8, 3, 3, 3)).astype(np.float32)
REF = np_reference_conv(X, K, 1, 1)
REF_TOL = dict(atol=1e-3)
TOL = dict(rtol=1e-5, atol=1e-5)
POOLS = ["threads", "device"]


def _cluster(straggler=None, mode="simulated", pool=None, **kw):
    return FcdccCluster(PLAN, straggler, mode=mode, pool=pool, device="cpu", **kw)


def test_simulated_avoids_stragglers():
    cl = _cluster(StragglerModel.fixed(6, 2, 5.0))
    y, t = cl.run_layer(GEO, X, K)
    np.testing.assert_allclose(y.numpy(), REF, **REF_TOL)
    assert t.compute_s < 1.0  # delta-th fastest, not the 5 s stragglers
    assert all(t.worker_compute_s[i] < 1.0 for i in t.used_workers)


@pytest.mark.parametrize("pool", POOLS)
def test_threads_mode_returns_before_stragglers(pool):
    with _cluster(StragglerModel.fixed(6, 2, 0.5), mode="threads",
                  pool=pool) as cl:
        y, t = cl.run_layer(GEO, X, K)
    np.testing.assert_allclose(y.numpy(), REF, **REF_TOL)
    assert t.compute_s < 0.4


@pytest.mark.parametrize("mode,pool", [("simulated", None), ("threads", "threads"),
                                       ("threads", "device")])
def test_dead_workers_within_gamma(mode, pool):
    d = np.zeros(6)
    d[[0, 1, 2, 3]] = np.inf  # 4 dead, gamma = 6 - 2 = 4
    with _cluster(StragglerModel(d), mode=mode, pool=pool) as cl:
        y, t = cl.run_layer(GEO, X, K)
    np.testing.assert_allclose(y.numpy(), REF, **REF_TOL)
    assert t.used_workers == [4, 5]


def test_degraded_raises_then_elastic_recovers():
    d = np.zeros(6)
    d[:5] = np.inf  # one survivor < delta=2
    with pytest.raises(ClusterDegraded):
        _cluster(StragglerModel(d)).run_layer(GEO, X, K)
    y, _, plan2 = run_layer_elastic(PLAN, GEO, X, K, StragglerModel(d),
                                    mode="simulated", device="cpu")
    np.testing.assert_allclose(y.numpy(), REF, **REF_TOL)
    assert plan2.delta <= 1  # shrank to a grid the survivor can cover


@pytest.mark.parametrize("pool", POOLS)
def test_elastic_recovery_threads_mode(pool):
    """The same elastic path over real workers: dead workers fail inside
    the pool and the master re-plans."""
    d = np.zeros(6)
    d[:5] = np.inf
    with pytest.raises(ClusterDegraded):
        with _cluster(StragglerModel(d), mode="threads", pool=pool) as cl:
            cl.run_layer(GEO, X, K)
    y, timing, plan2 = run_layer_elastic(PLAN, GEO, X, K, StragglerModel(d),
                                         mode="threads", pool=pool,
                                         device="cpu")
    np.testing.assert_allclose(y.numpy(), REF, **REF_TOL)
    assert plan2.delta <= 1
    assert timing.used_workers == [5]  # only the survivor contributed


@pytest.mark.parametrize("pool", POOLS)
def test_dead_and_discarded_worker_times(pool):
    """Dead workers report inf, workers discarded before finishing report
    nan: neither is mistakable for a fast node."""
    d = np.zeros(6)
    d[0] = np.inf
    cl = _cluster(StragglerModel(d))
    y, t = cl.run_layer(GEO, X, K)
    np.testing.assert_allclose(y.numpy(), REF, **REF_TOL)
    assert t.worker_compute_s[0] == float("inf")
    assert all(np.isfinite(t.worker_compute_s[i]) for i in t.used_workers)
    assert all(np.isfinite(v) for v in t.finished_worker_s)
    assert len(t.finished_worker_s) == 5

    d2 = np.zeros(6)
    d2[1] = np.inf  # dead
    d2[2] = 1.0     # straggler, still held back at collect
    with _cluster(StragglerModel(d2), mode="threads", pool=pool) as cl2:
        y2, t2 = cl2.run_layer(GEO, X, K)
    np.testing.assert_allclose(y2.numpy(), REF, **REF_TOL)
    assert t2.worker_compute_s[1] == float("inf")
    assert np.isnan(t2.worker_compute_s[2])
    assert all(np.isfinite(v) for v in t2.finished_worker_s)


@pytest.mark.parametrize("pool", POOLS)
def test_elastic_retries_release_worker_pools(monkeypatch, pool):
    """Every per-attempt cluster of ``run_layer_elastic`` releases its pool
    (the thread pool's executors; the device pool's timer thread, due
    dispatches and shards)."""
    import repro_torch.runtime.cluster as rc

    created = []
    orig_cluster = rc.FcdccCluster

    class Recording(orig_cluster):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            created.append(self)

    monkeypatch.setattr(rc, "FcdccCluster", Recording)
    d = np.zeros(6)
    d[:5] = np.inf
    y, _, _ = rc.run_layer_elastic(PLAN, GEO, X, K, StragglerModel(d),
                                   mode="threads", pool=pool, device="cpu")
    np.testing.assert_allclose(y.numpy(), REF, **REF_TOL)
    assert len(created) >= 2  # at least one degraded attempt + the retry
    assert all(c._pools is None for c in created)
    if pool == "device":
        assert all(not c._pool_obj._filters and not c._pool_obj._programs
                   and not c._pool_obj._due and c._pool_obj._timer_thread is None
                   for c in created)


# -- against the reference's run_layer ------------------------------------
def _ref_geo(geo):
    return RefGeo(geo.in_channels, geo.out_channels, geo.height, geo.width,
                  geo.kernel_h, geo.kernel_w, geo.stride, geo.padding)


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("geo,kab,batch", [
    (GEO, (2, 4), None),
    (ConvGeometry(4, 6, 15, 11, 3, 3, 2, 1), (2, 2), 2),
    (ConvGeometry(2, 8, 10, 10, 1, 1, 1, 0), (4, 2), None),
])
def test_run_layer_matches_reference_for_every_survivor_subset(pool, geo, kab, batch):
    """Every delta-subset of survivors, forced by marking the others dead:
    the port's ``run_layer`` on either pool equals the reference's on the
    same subset."""
    plan = FcdccPlan(n=6, k_a=kab[0], k_b=kab[1])
    ref_plan = RefPlan(n=6, k_a=kab[0], k_b=kab[1])
    shape = ((batch,) if batch else ()) + (geo.in_channels, geo.height, geo.width)
    x = RNG.standard_normal(shape).astype(np.float32)
    k = RNG.standard_normal((geo.out_channels, geo.in_channels, geo.kernel_h,
                             geo.kernel_w)).astype(np.float32)
    for ids in itertools.combinations(range(6), plan.delta):
        d = np.full(6, np.inf)
        d[list(ids)] = 0.0
        with FcdccCluster(plan, StragglerModel(d), mode="threads", pool=pool,
                          device="cpu") as cl:
            y, t = cl.run_layer(geo, x, k)
        ref_y, ref_t = RefCluster(ref_plan, RefStraggler(d),
                                  mode="simulated").run_layer(
            _ref_geo(geo), jnp.asarray(x), jnp.asarray(k))
        assert t.used_workers == list(ids) == list(ref_t.used_workers)
        np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), **TOL)


@pytest.mark.parametrize("pool", POOLS)
def test_resident_store_rules(pool):
    """``preload_filters`` encodes once; ``run_layer(layer_name=...)`` hits
    the resident entry only under the same filter-code key and with no
    weights or the very weights object it was built from: new weights or
    another plan under an old name re-encode and replace the entry."""
    with _cluster(None, mode="threads", pool=pool) as cl:
        layer = cl.coded_layer(GEO)
        ke = cl.preload_filters("conv", GEO, K)
        assert layer.filter_encode_calls == 1
        y, t = cl.run_layer(GEO, X, layer_name="conv")
        np.testing.assert_allclose(y.numpy(), REF, **REF_TOL)
        assert t.name == "conv" and layer.filter_encode_calls == 1
        # the same weights object: still a hit
        cl.run_layer(GEO, X, K, layer_name="conv")
        assert layer.filter_encode_calls == 1
        # the resident entry serves any input size (H/W are not in the key)
        geo_big = ConvGeometry(3, 8, 16, 14, 3, 3, 1, 1, 2, 4)
        x_big = RNG.standard_normal((3, 16, 14)).astype(np.float32)
        y_big, _ = cl.run_layer(geo_big, x_big, layer_name="conv")
        np.testing.assert_allclose(y_big.numpy(),
                                   np_reference_conv(x_big, K, 1, 1), **REF_TOL)
        # other weights under the old name: re-encoded, never the stale ones
        k2 = RNG.standard_normal(K.shape).astype(np.float32)
        y2, _ = cl.run_layer(GEO, X, k2, layer_name="conv")
        np.testing.assert_allclose(y2.numpy(), np_reference_conv(X, k2, 1, 1),
                                   **REF_TOL)
        assert layer.filter_encode_calls == 2
        assert cl._resident["conv"][2] is k2
        # another plan under the same name: the key differs, re-encode
        plan2 = FcdccPlan(n=6, k_a=2, k_b=2)
        y3, _ = cl.run_layer(GEO, X, k2, layer_name="conv", plan=plan2)
        np.testing.assert_allclose(y3.numpy(), np_reference_conv(X, k2, 1, 1),
                                   **REF_TOL)
        assert cl._resident["conv"][0] == cl._filter_code_key(plan2, GEO)
        # pre-encoded filters win over everything
        y4, _ = cl.run_layer(GEO, X, coded_filters=ke, layer_name="conv")
        np.testing.assert_allclose(y4.numpy(), REF, **REF_TOL)
        with pytest.raises(ValueError, match="need k"):
            cl.run_layer(GEO, X, layer_name="missing")
        # one worker program per signature, on the master device
        assert cl.worker_program(layer) is cl.worker_program(layer)
