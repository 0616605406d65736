"""The port's device worker pool (``pool="device"``) on the CPU.

Mirrors ``tests/test_device_pool.py``.  On the CPU every worker's device is
``cpu`` and dispatch is synchronous (the card's streams and event reaping
are held by ``tests/test_torch_cuda.py``).  The reference's own device
pool needs ``XLA_FLAGS`` set before jax is imported, so it cannot run in
this process; the reference proves its pools bit-identical, so the port
is held against the reference's ``CodedPipeline.run`` with the same forced
survivors.

Tolerances: pool against pool within the port, exact (``torch.equal``):
the same shares, filters and fp32 programs in the same order.  The port
against the reference, 1e-5 relative and absolute: fp32 sums in another
order through up to 13 decodes, each multiplying rounding error by its
recovery matrix's condition number.  Greedy LM decode, token for token.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smollm_135m as ref_smollm
from repro.core.pipeline import build_cnn_pipeline as ref_build_cnn_pipeline
from repro.models import transformer as ref_lm
from repro.runtime import FcdccCluster as RefCluster
from repro_torch.configs import smollm_135m
from repro_torch.core.decoder_pipeline import build_lm_decoder_pipeline
from repro_torch.core.fcdcc import FcdccPlan
from repro_torch.core.partition import ConvGeometry
from repro_torch.core.pipeline import build_cnn_pipeline
from repro_torch.devices import worker_devices
from repro_torch.models import transformer as lm
from repro_torch.models.cnn import CNN_SPECS, init_cnn, input_hw
from repro_torch.runtime import (ClusterDegraded, DeviceWorkerPool,
                                 FcdccCluster, StragglerModel,
                                 run_layer_elastic)
from repro_torch.runtime.devicepool import resolve_pool
from repro_torch.serving import CodedLMServer, CodedServer

RNG = np.random.default_rng(0)
N = 6
TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")


def _params(arch, seed=0):
    return init_cnn(arch, torch.Generator().manual_seed(seed), "cpu")


def _pipe(arch, n=N, kab=(2, 4), fused=False, hw=None):
    return build_cnn_pipeline(arch, _params(arch), n, default_kab=kab,
                              input_hw=hw or input_hw(arch, smoke=True),
                              fuse_transitions=fused, device="cpu")


def _in_shape(pipe, batch):
    return (batch,) + pipe.input_shape


def _forced_subset_straggler(pipe, n=N):
    """Finite delays on workers delta..n-1: both pools must keep exactly
    the undelayed subset, making their decodes bit-identical."""
    dm = max(spec.plan.delta for spec in pipe.specs)
    delays = np.zeros(n)
    delays[dm:] = 0.3
    return StragglerModel(delays), dm


def _run_pool(pipe, pool, x, straggler, name):
    cluster = FcdccCluster(pipe.specs[0].plan, straggler=straggler,
                           mode="threads", pool=pool, device="cpu")
    try:
        cluster.load_pipeline(pipe, name)
        y, timings = cluster.run_pipeline(x, model=name)
        return y, timings
    finally:
        cluster.shutdown()


# -- bit-parity across pools ----------------------------------------------
@pytest.mark.parametrize("arch", sorted(CNN_SPECS))
def test_pools_bit_identical_forced_subset(arch):
    """With the fastest-delta subset pinned, the device pool's gather +
    decode is bitwise the thread pool's, and both match the reference's
    pipeline on the same survivors."""
    pipe_t, pipe_d = _pipe(arch), _pipe(arch)
    straggler, dm = _forced_subset_straggler(pipe_t)
    x = RNG.standard_normal(_in_shape(pipe_t, 1)).astype(np.float32)
    yt, tt = _run_pool(pipe_t, "threads", x, straggler, arch)
    yd, td = _run_pool(pipe_d, "device", x, straggler, arch)
    assert torch.equal(yt, yd)
    delayed = set(range(dm, N))
    for t in tt + td:
        assert not (set(t.used_workers) & delayed), (
            f"{t.name}: decode consumed a delayed shard {t.used_workers}")
    ref = ref_build_cnn_pipeline(
        arch, {k: jnp.asarray(v.numpy()) for k, v in _params(arch).items()},
        N, default_kab=(2, 4), input_hw=input_hw(arch, smoke=True))
    want = np.asarray(ref.run(jnp.asarray(x), list(range(dm))))
    np.testing.assert_allclose(yd.numpy(), want, **TOL)


# -- fastest-delta discard ------------------------------------------------
def test_slowed_device_discarded():
    """A delayed worker's shard is excluded from the decode subset and its
    slot marked nan (discarded), never silently gathered."""
    delays = np.zeros(N)
    delays[0] = 3.0
    pipe = _pipe("lenet5")
    cluster = FcdccCluster(pipe.specs[0].plan, StragglerModel(delays),
                           mode="threads", pool="device", device="cpu")
    try:
        cluster.load_pipeline(pipe)
        x = RNG.standard_normal(_in_shape(pipe, 1)).astype(np.float32)
        y, timing = cluster.run_pipeline_layer(0, torch.as_tensor(x))
        assert 0 not in timing.used_workers
        assert np.isnan(timing.worker_compute_s[0])
        assert len(timing.used_workers) == pipe.specs[0].plan.delta
        assert all(np.isfinite(timing.worker_compute_s[i])
                   for i in timing.used_workers)
    finally:
        cluster.shutdown()


GEO = ConvGeometry(in_channels=2, height=12, width=12, out_channels=8,
                   kernel_h=3, kernel_w=3, stride=1, padding=1)


def test_dead_device_elastic_replan():
    """inf-delay workers never dispatch; when fewer than delta survive the
    elastic re-plan shrinks the subtask grid and retries on the device pool,
    matching the reference's ``run_layer`` and the port's thread pool."""
    plan = FcdccPlan(n=N, k_a=2, k_b=4)
    x = RNG.standard_normal((2, 12, 12)).astype(np.float32)
    k = RNG.standard_normal((8, 2, 3, 3)).astype(np.float32)
    from repro.core.fcdcc import FcdccPlan as RefPlan
    from repro.core.partition import ConvGeometry as RefGeo

    ref_geo = RefGeo(2, 8, 12, 12, 3, 3, 1, 1)
    ref = np.asarray(RefCluster(RefPlan(n=N, k_a=2, k_b=4), None,
                                mode="threads").run_layer(ref_geo, x, k)[0])
    d = np.zeros(N)
    d[:5] = np.inf  # 5 dead of 6: delta=2's plan cannot survive
    with pytest.raises(ClusterDegraded):
        with FcdccCluster(plan, StragglerModel(d), mode="threads",
                          pool="device", device="cpu") as cl:
            cl.run_layer(GEO, x, k)
    y, timing, plan2 = run_layer_elastic(
        plan, GEO, x, k, StragglerModel(d), mode="threads", pool="device",
        device="cpu")
    np.testing.assert_allclose(y.numpy(), ref, **TOL)
    assert plan2.delta < plan.delta
    assert timing.used_workers == [5]


# -- bounded programs per device ------------------------------------------
def test_bounded_programs_per_device():
    """After serving several buckets, every device's worker-program shape
    signatures stay <= (layer geometries) x (buckets): programs are per
    cell, never per round or per request."""
    pipe = _pipe("lenet5")
    buckets = (1, 2)
    cluster = FcdccCluster(pipe.specs[0].plan, None, mode="threads",
                           pool="device", device="cpu")
    try:
        cluster.load_pipeline(pipe)
        for b in buckets:
            x = RNG.standard_normal(_in_shape(pipe, b)).astype(np.float32)
            for _ in range(3):  # repeats must not add signatures
                cluster.run_pipeline(x)
        traces = cluster._pool_impl().program_traces()
        assert set(traces) == {CPU}  # every worker on the one device
        bound = len(pipe.specs) * len(buckets)
        assert all(0 < c <= bound for c in traces.values()), (traces, bound)
        # the pipeline's own (thread-pool) program cache was never used
        assert pipe.worker_program_traces == 0
    finally:
        cluster.shutdown()


# -- residency + placement ------------------------------------------------
def test_filters_resident_on_worker_devices():
    pipe = _pipe("lenet5")
    cluster = FcdccCluster(pipe.specs[0].plan, None, mode="threads",
                           pool="device", device="cpu")
    try:
        cluster.load_pipeline(pipe, "m")
        impl = cluster._pool_impl()
        devs = cluster.worker_devices
        assert devs == [CPU] * N
        for spec, ke in zip(pipe.specs, pipe.coded_filters):
            src, shards = impl._filters[f"m/{spec.name}"]
            assert src is ke and len(shards) == N
            for i, shard in enumerate(shards):
                assert shard.device == devs[i]
                # one device: the shard is the master copy, not a copy of it
                assert shard.data_ptr() == ke[i].data_ptr()
        # placement is cached: a second lookup returns the same shards
        name = f"m/{pipe.specs[0].name}"
        assert impl.resident_filters(name, pipe.coded_filters[0]) is \
            impl._filters[name][1]
        # unload reclaims every per-worker shard of the namespace
        cluster.unload_pipeline("m")
        assert not any(key.startswith("m/") for key in impl._filters)
        with pytest.raises(RuntimeError, match="device pool"):
            cluster._ensure_pools()
        assert cluster._pools is None
    finally:
        cluster.shutdown()


def test_worker_devices_round_robin_when_fewer_devices():
    """Worker i runs on devs[i % len(devs)]; a cluster with more workers
    than devices serves the same outputs as the thread pool."""
    meta = torch.device("meta")
    assert worker_devices(5, ["cpu", meta]) == [CPU, meta, CPU, meta, CPU]
    assert worker_devices(2, ["cpu", "cpu", "cpu"]) == [CPU, CPU]
    with pytest.raises(ValueError, match="n >= 1"):
        worker_devices(0, ["cpu"])
    with pytest.raises(ValueError, match="empty"):
        worker_devices(3, [])
    with pytest.raises(ValueError, match="one type"):
        DeviceWorkerPool(3, StragglerModel.none(3), devices=["cpu", meta],
                         device="cpu")
    n_big = 9
    pipe = _pipe("lenet5", n=n_big)
    cluster = FcdccCluster(pipe.specs[0].plan, None, mode="threads",
                           pool="device", devices=["cpu", "cpu"], device="cpu")
    try:
        cluster.load_pipeline(pipe)
        assert cluster.worker_devices == [CPU] * n_big
        x = RNG.standard_normal(_in_shape(pipe, 1)).astype(np.float32)
        y, _ = cluster.run_pipeline(x)
        with FcdccCluster(pipe.specs[0].plan, None, mode="threads",
                          device="cpu") as ref_cluster:
            ref, _ = ref_cluster.run_pipeline(x, pipe)
        np.testing.assert_allclose(y.numpy(), ref.numpy(), **TOL)
    finally:
        cluster.shutdown()


# -- pool resolution ------------------------------------------------------
def test_resolve_pool_rules(monkeypatch):
    assert resolve_pool(None, "threads") == "threads"  # no second card here
    assert resolve_pool(None, "threads", devices=["cpu", "cpu"]) == "device"
    assert resolve_pool(None, "simulated") == "threads"
    assert resolve_pool("threads", "threads") == "threads"
    assert resolve_pool("device", "threads") == "device"
    with pytest.raises(ValueError, match="simulated"):
        resolve_pool("device", "simulated")
    with pytest.raises(ValueError, match="unknown pool"):
        resolve_pool("gpu", "threads")
    with pytest.raises(ValueError, match="simulated"):
        FcdccCluster(FcdccPlan(n=N, k_a=2, k_b=4), None, mode="simulated",
                     pool="device", device="cpu")
    # a multi-card host auto-selects the device pool
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert resolve_pool(None, "threads") == "device"
    assert resolve_pool(None, "simulated") == "threads"


# -- serving through the device pool --------------------------------------
def test_serving_on_device_pool():
    pipe, ref = _pipe("lenet5"), _pipe("lenet5")
    server = CodedServer(pipe, StragglerModel.none(N), mode="threads",
                         pool="device")
    xs = [RNG.standard_normal(_in_shape(pipe, 1)[1:]).astype(np.float32)
          for _ in range(3)]
    with server:
        assert server.cluster.pool == "device"
        outs = [h.result(timeout=120.0) for h in server.submit_many(xs)]
    for x, y in zip(xs, outs):
        np.testing.assert_allclose(y, ref.run(torch.as_tensor(x)).numpy(), **TOL)


def test_fused_transitions_on_device_pool():
    """Partition-resident transitions on the device pool: with a forced
    fastest-delta subset the end result is bitwise the thread pool's, and
    matches the reference's fused pipeline."""
    pipe_t, pipe_d = _pipe("lenet5", fused=True), _pipe("lenet5", fused=True)
    straggler, dm = _forced_subset_straggler(pipe_t)
    x = RNG.standard_normal(_in_shape(pipe_t, 1)).astype(np.float32)
    yt, tt = _run_pool(pipe_t, "threads", x, straggler, "m")
    yd, td = _run_pool(pipe_d, "device", x, straggler, "m")
    assert torch.equal(yt, yd)
    delayed = set(range(dm, N))
    for t in tt + td:
        assert not (set(t.used_workers) & delayed)
    ref = ref_build_cnn_pipeline(
        "lenet5", {k: jnp.asarray(v.numpy()) for k, v in _params("lenet5").items()},
        N, default_kab=(2, 4), input_hw=input_hw("lenet5", smoke=True),
        fuse_transitions=True)
    np.testing.assert_allclose(
        yd.numpy(), np.asarray(ref.run(jnp.asarray(x), list(range(dm)))), **TOL)


# -- non-blocking readiness + adaptive collect backoff ---------------------
def test_device_pool_round_ready_nonblocking():
    """``round_ready`` is False while the delta-th shard's deferred dispatch
    has not landed, flips True without blocking, and
    ``collect(block=False)`` mirrors it."""
    pipe = _pipe("lenet5")
    dm = max(spec.plan.delta for spec in pipe.specs)
    delays = np.full(N, 0.4)  # every dispatch deferred: nothing ready early
    cluster = FcdccCluster(pipe.specs[0].plan, StragglerModel(delays),
                           mode="threads", pool="device", device="cpu")
    try:
        cluster.load_pipeline(pipe)
        x = torch.as_tensor(RNG.standard_normal(_in_shape(pipe, 1)).astype(np.float32))
        rnd = cluster.dispatch_pipeline_layer(0, x)
        assert not cluster.round_ready(rnd)
        assert cluster.collect(rnd.pending, dm, block=False) is None
        deadline = time.perf_counter() + 30.0
        while not cluster.round_ready(rnd):
            assert time.perf_counter() < deadline
            time.sleep(0.01)
        y, timing = cluster.collect_pipeline_layer(rnd)
        assert len(timing.used_workers) == dm
        with FcdccCluster(pipe.specs[0].plan, None, mode="threads",
                          device="cpu") as refc:
            refc.load_pipeline(pipe)
            ref, _ = refc.run_pipeline_layer(0, x)
        np.testing.assert_allclose(y.numpy(), ref.numpy(), **TOL)
    finally:
        cluster.shutdown()


def test_device_pool_adaptive_poll_default_and_override():
    """``poll_interval_s=None`` (the default) collects with a short spin,
    then the adaptive 5us..1ms backoff; an explicit value is kept as a
    fixed period.  Both produce identical results."""
    assert DeviceWorkerPool._POLL_MIN == pytest.approx(5e-6)
    assert DeviceWorkerPool._POLL_MAX == pytest.approx(1e-3)
    outs = {}
    straggler, _ = _forced_subset_straggler(_pipe("lenet5"))
    x = RNG.standard_normal(_in_shape(_pipe("lenet5"), 1)).astype(np.float32)
    for label, pool_kwargs in (("adaptive", {}),
                               ("fixed", {"poll_interval_s": 5e-5})):
        pipe = _pipe("lenet5")
        impl = DeviceWorkerPool(N, straggler, device="cpu", **pool_kwargs)
        assert impl._poll_interval_s == pool_kwargs.get("poll_interval_s")
        cluster = FcdccCluster(pipe.specs[0].plan, None, mode="threads",
                               pool="device", device="cpu")
        try:
            cluster._pool_obj = impl  # inject before the lazy default build
            cluster.load_pipeline(pipe)
            outs[label] = cluster.run_pipeline(x)[0]
        finally:
            cluster.shutdown()
    assert torch.equal(outs["adaptive"], outs["fixed"])


# -- a dispatch that raises never hangs the round ---------------------------
class _Boom(RuntimeError):
    pass


def _collect_in_thread(impl, pending, delta, timeout=20.0):
    """``impl.collect`` on a helper thread, joined with a timeout: returns
    (finished, result, error)."""
    box = {}

    def run():
        try:
            box["result"] = impl.collect(pending, delta)
        except BaseException as err:  # handed to the test thread
            box["error"] = err

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    return not t.is_alive(), box.get("result"), box.get("error")


def test_deferred_dispatch_failure_surfaces_from_collect():
    """A delayed worker whose program raises on its timer thread: the round
    reports ready and ``collect`` re-raises the error (within the test's
    timeout) instead of waiting forever for a result that never lands; it
    is never counted as a dead worker.  A failure that lands after its
    round was reaped is raised by the next ``submit``."""
    n, delta = 4, 2
    delays = np.array([0.0, 0.05, 0.05, np.inf])
    impl = DeviceWorkerPool(n, StragglerModel(delays), device="cpu")
    xe = torch.ones(n, 1, 3)
    ke = torch.ones(n, 3, 2)

    def program(i):
        def run(x, k):
            if i == 2:
                raise _Boom(f"kernel of worker {i} failed to launch")
            return x[0] @ k
        return run

    try:
        pending = impl.submit(program, xe, ke)
        assert pending.expected == {0, 1, 2}  # the dead worker never dispatches
        deadline = time.perf_counter() + 20.0
        while not impl.ready(pending, 3):
            assert time.perf_counter() < deadline, "a failed round never got ready"
            time.sleep(0.005)
        finished, _, err = _collect_in_thread(impl, pending, 3)
        assert finished, "collect hung on a dispatch that raised"
        assert isinstance(err, _Boom)

        # the round completes before the failing straggler dispatches: its
        # error surfaces at the next submit, not never
        pending = impl.submit(program, xe, ke)
        finished, result, err = _collect_in_thread(impl, pending, 1)
        assert finished and err is None and set(result[0]) == {0}
        deadline = time.perf_counter() + 20.0
        while impl._late_error is None:  # the straggler's dispatch has run
            assert time.perf_counter() < deadline
            time.sleep(0.005)
        with pytest.raises(_Boom):
            impl.submit(program, xe, ke)
        # raised once: the pool serves again afterwards
        pending = impl.submit(lambda i: (lambda x, k: x[0] @ k), xe, ke)
        finished, result, err = _collect_in_thread(impl, pending, delta)
        assert finished and err is None and len(result[0]) == delta
    finally:
        impl.shutdown()



def test_shutdown_joins_the_timer_thread_and_no_dispatch_follows():
    """``shutdown`` called from another thread while a delayed dispatch
    runs on the timer thread returns only after that dispatch finished and
    the timer thread exited; a delayed dispatch still queued never runs.
    Every wait has its own timeout, so a hang fails within seconds."""
    n = 3
    delays = np.array([0.0, 0.01, 0.3])
    impl = DeviceWorkerPool(n, StragglerModel(delays), device="cpu")
    xe, ke = torch.ones(n, 1, 3), torch.ones(n, 3, 2)
    running, release, returned = (threading.Event(), threading.Event(),
                                  threading.Event())
    calls = []  # (worker, whether shutdown had returned when it started)

    def program(i):
        def run(x, k):
            calls.append((i, returned.is_set()))
            if i == 1:
                running.set()
                assert release.wait(20.0)
            return x[0] @ k
        return run

    try:
        impl.submit(program, xe, ke)
        assert running.wait(20.0), "the delayed dispatch never started"
        timer = impl._timer_thread
        assert timer is not None and timer.is_alive()

        def stop():
            impl.shutdown()
            returned.set()

        stopper = threading.Thread(target=stop, daemon=True)
        stopper.start()
        # shutdown waits for the dispatch the timer thread is running
        assert not returned.wait(0.2)
        release.set()
        assert returned.wait(20.0), "shutdown never returned"
        stopper.join(20.0)
        assert not timer.is_alive()
        time.sleep(0.4)  # past worker 2's due time
        assert calls == [(0, False), (1, False)]
    finally:
        release.set()
        impl.shutdown()


def test_shutdown_from_a_delayed_dispatch_does_not_wait_for_itself():
    """A dispatch on the timer thread that shuts its own pool down returns
    (the timer thread cannot join itself), and the thread then exits."""
    delays = np.array([0.0, 0.01])
    impl = DeviceWorkerPool(2, StragglerModel(delays), device="cpu")
    xe, ke = torch.ones(2, 1, 3), torch.ones(2, 3, 2)
    done = threading.Event()
    timer = []

    def program(i):
        def run(x, k):
            if i == 1:
                timer.append(threading.current_thread())
                impl.shutdown()
                done.set()
            return x[0] @ k
        return run

    impl.submit(program, xe, ke)
    assert done.wait(20.0), "shutdown on the timer thread hung"
    deadline = time.perf_counter() + 20.0
    while timer[0].is_alive():
        assert time.perf_counter() < deadline, "the timer thread never exited"
        time.sleep(0.005)


# -- the LM on the device pool --------------------------------------------
LM_MAX_LEN, LM_PROMPTS, LM_GENS = 32, [[5, 9, 2], [7, 1], [3, 3, 4, 8, 2]], [5, 3, 4]


def test_lm_server_on_device_pool_matches_reference_tokens():
    """``CodedLMServer(pool="device")`` on smollm-135m-smoke with exp13's
    plan (n=4, k_b=4) under one straggler and one dead worker: every token
    equals the reference's uncoded greedy decoder's."""
    bundle = ref_smollm.smoke()
    params = bundle.init(jax.random.PRNGKey(0), jnp.float32)
    cfg_r = bundle.cfg
    port = lm.lm_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    pipe = build_lm_decoder_pipeline(smollm_135m.smoke(), port, 4, k_b=4,
                                     bucket_sizes=(1, 2, 4),
                                     max_len=LM_MAX_LEN, device="cpu")
    srv = CodedLMServer(pipe, StragglerModel(np.array([0.0, 0.0, 0.02, np.inf])),
                        mode="threads", pool="device", max_prompt=8,
                        poll_interval_s=0.002)
    assert srv.cluster.pool == "device"
    with srv:
        handles = [srv.submit(p, g) for p, g in zip(LM_PROMPTS, LM_GENS)]
        results = [list(h.result(timeout=120)) for h in handles]
    for prompt, gen, got in zip(LM_PROMPTS, LM_GENS, results):
        cache = ref_lm.init_cache(cfg_r, 1, LM_MAX_LEN, jnp.float32)
        logits, cache = ref_lm.prefill(params, cfg_r, cache, jnp.asarray([prompt]))
        want = [int(jnp.argmax(logits[0, len(prompt) - 1]))]
        for j in range(gen - 1):
            logits, cache = ref_lm.decode_step(
                params, cfg_r, cache, jnp.asarray([[want[-1]]], jnp.int32),
                jnp.int32(len(prompt) + j))
            want.append(int(jnp.argmax(logits[0, 0])))
        assert got == want
    assert srv.rounds > 0
    # the dead worker never ran; the straggler's late shards were discarded
    assert srv.cluster.worker_devices == [CPU] * 4
