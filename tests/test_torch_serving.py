"""The port's runtime and serving engine on the CPU.

``CodedServer`` in the threads and simulated modes, pipeline depths 1 and
2, with one straggler and one dead worker: every served result equals the
port's own ``CodedPipeline.run`` for the same survivors and matches the
reference (``repro``) pipeline to 1e-4.  With n = 4 and delta = 2 the
straggler model leaves exactly delta fast workers, so the survivors are
known in advance.
"""
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pipeline import CodedPipeline as RefPipeline
from repro.core.pipeline import plan_layers as ref_plan_layers
from repro.models import cnn as ref_cnn
from repro_torch.core.pipeline import CodedPipeline, plan_layers
from repro_torch.models import cnn
from repro_torch.runtime import (ClusterDegraded, FcdccCluster, StragglerModel,
                                 resolve_pool)
from repro_torch.serving import CodedServer, MetricsCollector, RequestRecord
from repro_torch.serving.scheduler import ScheduledBatch, Scheduler

RNG = np.random.default_rng(5)
TOL = dict(rtol=1e-4, atol=1e-4)
# the port against itself for the same survivors, bit for bit: the fused
# cluster path re-encodes for all n workers where run() encodes only the
# survivors' columns, but each coded element is the same k_a-term sum
SELF = dict(rtol=0, atol=0)

STACK = [cnn.ConvL("s1", 2, 8, 3, padding=1, pool=2),
         cnn.ConvL("s2", 8, 8, 3, padding=1)]
REF_STACK = [ref_cnn.ConvL("s1", 2, 8, 3, padding=1, pool=2),
             ref_cnn.ConvL("s2", 8, 8, 3, padding=1)]
STACK_B = [cnn.ConvL("s1", 3, 8, 3, padding=1, pool=2),
           cnn.ConvL("s2", 8, 4, 3, padding=1)]
N, HW, KAB = 4, 12, (2, 4)
# worker 0 dead, 1 straggles, 2 and 3 (= delta) answer fast
DELAYS = np.array([np.inf, 0.3, 0.0, 0.0])
SURVIVORS = [2, 3]


def _params(layers, seed=0):
    rng = np.random.default_rng(seed)
    return {l.name: (rng.standard_normal((l.out_ch, l.in_ch, l.kernel, l.kernel))
                     * (l.in_ch * l.kernel**2) ** -0.5).astype(np.float32)
            for l in layers}


def _pipe(fused=True, layers=STACK, buckets=(1, 2, 4), n=N):
    return CodedPipeline(plan_layers(layers, HW, n, default_kab=KAB),
                         _params(layers), bucket_sizes=buckets,
                         fuse_transitions=fused, device="cpu")


def _images(count, c=2):
    return [RNG.standard_normal((c, HW, HW)).astype(np.float32)
            for _ in range(count)]


def _reference(xs):
    ref = RefPipeline(ref_plan_layers(REF_STACK, HW, N, default_kab=KAB),
                      {k: jnp.asarray(v) for k, v in _params(STACK).items()})
    return np.asarray(ref.run(jnp.asarray(np.stack(xs)), SURVIVORS))


@pytest.mark.parametrize("mode", ["threads", "simulated"])
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("fused", [True, False])
def test_server_matches_pipeline_and_reference(mode, depth, fused):
    pipe = _pipe(fused)
    server = CodedServer(pipe, StragglerModel(DELAYS), mode=mode,
                         pipeline_depth=depth)
    xs = _images(5)
    with server:
        outs = [h.result(timeout=60.0) for h in server.submit_many(xs)]
    own = _pipe(fused).run(torch.as_tensor(np.stack(xs)), SURVIVORS).numpy()
    want = _reference(xs)
    for i, y in enumerate(outs):
        np.testing.assert_allclose(y, own[i], **SELF)
        np.testing.assert_allclose(y, want[i], **TOL)
    stats = server.stats()
    assert stats.completed == 5 and stats.images_per_s > 0
    assert pipe.filter_encode_calls == len(STACK)


def test_direct_execution_matches_cluster():
    xs = _images(4)
    own = _pipe().run(torch.as_tensor(np.stack(xs)), SURVIVORS).numpy()
    server = CodedServer(_pipe(), StragglerModel(DELAYS), execution="direct")
    with server:
        outs = [h.result(timeout=60.0) for h in server.submit_many(xs)]
    for i, y in enumerate(outs):
        np.testing.assert_allclose(y, own[i], **SELF)


def test_cluster_rounds_record_survivors_and_timings():
    pipe = _pipe()
    with FcdccCluster(pipe.specs[0].plan, StragglerModel(DELAYS), mode="simulated",
                      device="cpu") as cluster:
        y, timings = cluster.run_pipeline(torch.as_tensor(np.stack(_images(2))), pipe)
    assert y.shape[0] == 2 and len(timings) == len(STACK)
    for t in timings:
        assert t.used_workers == SURVIVORS
        assert np.isinf(t.worker_compute_s[0])
        assert len(t.finished_worker_s) == N - 1


def test_threads_mode_returns_before_stragglers():
    delays = np.array([0.0, 2.0, 0.0, 2.0])
    server = CodedServer(_pipe(), StragglerModel(delays), mode="threads")
    server.warmup()
    t0 = time.perf_counter()
    with server:
        outs = [h.result(timeout=60.0) for h in server.submit_many(_images(2))]
    assert len(outs) == 2
    assert time.perf_counter() - t0 < 2.0  # fastest-delta collect, no join


def test_degraded_cluster_fails_requests_not_engine():
    delays = np.array([np.inf] * (N - 1) + [0.0])  # one live worker < delta = 2
    server = CodedServer(_pipe(), StragglerModel(delays), mode="simulated")
    with server:
        with pytest.raises(ClusterDegraded):
            server.submit(_images(1)[0]).result(timeout=60.0)
        with pytest.raises(ClusterDegraded):  # the engine is still serving
            server.submit(_images(1)[0]).result(timeout=60.0)


def test_two_models_share_one_pool():
    server = CodedServer(straggler=StragglerModel(DELAYS), mode="simulated")
    server.register_model("a", _pipe())
    server.register_model("b", _pipe(layers=STACK_B))
    xa, xb = _images(3), _images(3, c=3)
    with server:
        ha, hb = server.submit_many(xa, "a"), server.submit_many(xb, "b")
        outs_a = [h.result(timeout=60.0) for h in ha]
        outs_b = [h.result(timeout=60.0) for h in hb]
    own_a = _pipe().run(torch.as_tensor(np.stack(xa)), SURVIVORS).numpy()
    own_b = _pipe(layers=STACK_B).run(torch.as_tensor(np.stack(xb)), SURVIVORS).numpy()
    for y, w in zip(outs_a + outs_b, list(own_a) + list(own_b)):
        np.testing.assert_allclose(y, w, **SELF)
    assert set(server.per_model_stats()) == {"a", "b"}
    with pytest.raises(ValueError, match="pass model="):
        server.submit(xa[0])


def test_concurrent_clients_stress():
    """More worker threads than cores, several client threads, a short
    switch interval: every request still gets its own correct result."""
    n = 12
    delays = np.zeros(n)
    delays[[1, 7]] = 0.01
    pipe = _pipe(n=n)
    own = _pipe(n=n)
    server = CodedServer(pipe, StragglerModel(delays), mode="threads",
                         pipeline_depth=2)
    xs = _images(12)
    results: dict[int, np.ndarray] = {}
    lock = threading.Lock()

    def client(lo):
        for i in range(lo, lo + 4):
            y = server.submit(xs[i]).result(timeout=60.0)
            with lock:
                results[i] = y

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with server:
            threads = [threading.Thread(target=client, args=(lo,))
                       for lo in (0, 4, 8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60.0)
                assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert sorted(results) == list(range(12))
    for i, y in results.items():
        # survivors vary with timing here; any delta-subset decodes alike
        np.testing.assert_allclose(y, own.run(torch.as_tensor(xs[i])).numpy(), **TOL)


def test_bounded_programs_after_warmup():
    pipe = _pipe()
    server = CodedServer(pipe, StragglerModel(DELAYS), mode="simulated")
    server.warmup()
    before = pipe.worker_program_traces + pipe.transition_program_traces
    with server:
        for burst in (1, 3, 2, 4, 1):
            for h in server.submit_many(_images(burst)):
                h.result(timeout=60.0)
    assert pipe.worker_program_traces + pipe.transition_program_traces == before
    assert before <= pipe.program_trace_bound


def test_server_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is exercised there")
    with pytest.raises(RuntimeError, match="cuda"):
        CodedServer.from_cnn("lenet5", _params(STACK), N, default_kab=KAB)
    with pytest.raises(RuntimeError, match="cuda"):
        FcdccCluster(_pipe().specs[0].plan)
    assert resolve_pool("device", "threads") == "device"
    with pytest.raises(RuntimeError, match="cuda"):
        FcdccCluster(_pipe().specs[0].plan, pool="device")


def test_partition_state_batches_coalesce_on_their_batch_axis():
    pipe = _pipe()
    sched = Scheduler(pipe.pad_to_bucket, max_batch=4)
    shares = (N, 2, 1, 8, 5, 8)  # (n, ell_a, B, C, h_hat, Wp)
    a = ScheduledBatch([object()], torch.ones(shares), bucket=1, layer_idx=1,
                       batch_axis=2)
    b = ScheduledBatch([object(), object()], 2 * torch.ones(shares[:2] + (2,) + shares[3:]),
                       bucket=2, layer_idx=1, batch_axis=2)
    sched.inflight.extend([a, b])
    assert sched.coalesce() == 1
    (merged,) = sched.inflight
    assert merged.bucket == 4 and merged.x.shape[2] == 4 and merged.real == 3
    assert torch.equal(merged.x[:, :, 3], torch.zeros(shares[:2] + shares[3:]))


def test_metrics_math():
    m = MetricsCollector()
    for i, (a, s, f) in enumerate([(0.0, 0.1, 0.5), (0.0, 0.2, 1.0),
                                   (0.5, 0.6, 1.5)]):
        m.record(RequestRecord(i, a, s, f, bucket=2, batch_real=1 + i % 2))
    st = m.stats()
    assert st.completed == 3
    assert st.wall_s == pytest.approx(1.5)
    assert st.images_per_s == pytest.approx(2.0)
    assert st.e2e_p50_s == pytest.approx(1.0)
    assert st.queue_wait_p50_s == pytest.approx(0.1)
    assert st.mean_batch_real == pytest.approx(4 / 3)


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", "lenet5", "--device", "cpu", "--requests", "3",
          "--mode", "simulated", "--fuse-transitions", "--stragglers", "1"])
    out = capsys.readouterr().out
    assert "lenet5: coded serving on n=8" in out and "3 reqs" in out
    with pytest.raises(SystemExit):
        main(["--arch", "resnet", "--device", "cpu"])


def test_unregister_model_drains_then_removes():
    server = CodedServer(straggler=StragglerModel(DELAYS), mode="simulated")
    server.register_model("a", _pipe())
    server.register_model("b", _pipe(layers=STACK_B))
    with server:
        last = server.submit(_images(1, c=3)[0], "b")
        server.unregister_model("b", drain=True, timeout=60.0)
        assert last.result(timeout=1.0) is not None  # drained, not dropped
        with pytest.raises(ValueError, match="unknown model"):
            server.submit(_images(1, c=3)[0], "b")
        assert server.submit(_images(1)[0], "a").result(timeout=60.0) is not None
        assert "b" not in server.models and "b" not in server.cluster.pipelines
        server.register_model("b", _pipe(layers=STACK_B))
        assert server.submit(_images(1, c=3)[0], "b").result(timeout=60.0) is not None
    # engine not running: queued work cannot drain, so drain=False cancels
    h = server.scheduler["b"].submit(_images(1, c=3)[0])
    server.unregister_model("b", drain=False)
    with pytest.raises(RuntimeError, match="unregistered"):
        h.result(timeout=1.0)


def test_weighted_fair_share_round_ratio():
    """weights (2, 1), both models backlogged: rounds go a, a, b, ... and
    a backlogged model waits at most the other's weight between rounds."""
    server = CodedServer(straggler=StragglerModel(DELAYS), mode="simulated",
                         bucket_sizes=(1,))
    server.register_model("a", _pipe(buckets=(1,)), weight=2)
    server.register_model("b", _pipe(layers=STACK_B, buckets=(1,)), weight=1)
    advanced = []
    orig = server.cluster.dispatch_pipeline_layer

    def spy(idx, x, model=None):
        advanced.append(model)
        return orig(idx, x, model)

    server.cluster.dispatch_pipeline_layer = spy
    ha = [server.scheduler["a"].submit(torch.as_tensor(x)) for x in _images(4)]
    hb = [server.scheduler["b"].submit(torch.as_tensor(x)) for x in _images(4, c=3)]
    with server:
        for h in ha + hb:
            h.result(timeout=60.0)
    assert advanced.count("a") == 8 and advanced.count("b") == 8
    contended = advanced[:12]
    for i in range(1, len(contended) + 1):
        assert abs(contended[:i].count("a") - 2 * contended[:i].count("b")) <= 2
    b_rounds = [i for i, m in enumerate(contended) if m == "b"]
    assert all(j - i <= 3 for i, j in zip(b_rounds, b_rounds[1:]))
    with pytest.raises(ValueError, match="weight"):
        server.register_model("c", _pipe(), weight=0)


def test_has_work_sees_a_batch_mid_admission():
    """Between popping its requests off the queue and joining the in-flight
    set, an admission still counts as work: ``unregister_model``'s drain
    polls ``has_work`` from another thread and must never see a request
    in neither place (it then tore the model down under a live batch)."""
    pipe = _pipe()
    sched = Scheduler(pipe.pad_to_bucket, max_batch=pipe.max_batch,
                      max_inflight=2, name="m")
    sched.submit(torch.as_tensor(_images(1)[0]))
    popped, release = threading.Event(), threading.Event()

    def slow_pad(x):
        popped.set()  # the queue is empty now, the batch not in flight yet
        assert release.wait(30.0)
        return pipe.pad_to_bucket(x)

    sched.pad_to_bucket = slow_pad
    t = threading.Thread(target=sched.admit, daemon=True)
    t.start()
    try:
        assert popped.wait(30.0)
        assert len(sched.queue) == 0 and not sched.inflight
        assert sched.has_work()
    finally:
        release.set()
        t.join(30.0)
    assert not t.is_alive()
    assert sched.has_work() and len(sched.inflight) == 1
