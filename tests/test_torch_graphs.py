"""The port's compiled programs (``repro_torch.core.graphs``) on the CPU.

The CPU has no CUDA graphs, so these tests pass ``EmulatedGraph``
(``tests/_torch_graph_emulator.py``): it records the ops a capture runs
and replays them on the same tensors, with a graph's aliasing semantics,
and raises on a host sync.  The runtime never picks it: ``graphs=True``
runs eagerly on the CPU.

Served outputs are held ``torch.equal`` to the eager port (the same ops on
the same values, in the same batches), and to the JAX reference within the
port's fp32 tolerance (1e-5 relative and absolute, as
``tests/test_torch_device_pool.py``); greedy LM decode token for token.
"""
import gc
import threading
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_graph_emulator import EmulatedGraph
from repro.configs import smollm_135m as ref_smollm
from repro.core.pipeline import build_cnn_pipeline as ref_build_cnn_pipeline
from repro.models import transformer as ref_lm
from repro_torch.analysis import contracts
from repro_torch.configs import smollm_135m
from repro_torch.core.decoder_pipeline import build_lm_decoder_pipeline
from repro_torch.core.graphs import (GraphCaptureError, GraphSet,
                                     ResidentMoved, graph_class, merge_stats,
                                     no_collection)
from repro_torch.core.pipeline import Program, build_cnn_pipeline
from repro_torch.kernels.native import LaunchCounter
from repro_torch.models import transformer as lm
from repro_torch.models.cnn import init_cnn, input_hw
from repro_torch.runtime import FcdccCluster, StragglerModel
from repro_torch.serving import CodedLMServer, CodedServer

N = 6
TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


# -- the capture helper ----------------------------------------------------
def test_graph_class_switch():
    assert graph_class(True, "cpu") is None  # the caller asked for the CPU
    assert graph_class(False, "cpu") is None
    assert graph_class(True, torch.device("cuda")) is torch.cuda.CUDAGraph
    assert graph_class(False, torch.device("cuda")) is None
    assert graph_class(EmulatedGraph, "cpu") is EmulatedGraph
    with pytest.raises(TypeError):
        graph_class("yes", "cpu")


def test_replay_outputs_are_fresh_and_equal_eager():
    """Each call replays the one graph and returns a clone: the outputs of
    an earlier call never change when a later replay overwrites the
    graph's own outputs."""
    gs = GraphSet("t", CPU, EmulatedGraph)
    prog = Program(lambda a, b: (a @ b).relu(), name="mm", graphs=gs)
    rng = _rng(1)
    calls = [(_t(rng.standard_normal((3, 4))), _t(rng.standard_normal((4, 5))))
             for _ in range(4)]
    outs = [prog(a, b) for a, b in calls]
    snapshot = [o.clone() for o in outs]
    for o, s, (a, b) in zip(outs, snapshot, calls):
        assert torch.equal(o, s)  # untouched by later replays
        assert torch.equal(o, (a @ b).relu())
    assert gs.num_graphs == 1 and gs.captures == {"mm": 1}
    assert gs.replays == {"mm": 4} and prog.captures == 1
    static_out = gs._graphs[next(iter(gs._graphs))].outs[0]
    assert all(o.data_ptr() != static_out.data_ptr() for o in outs)


@pytest.mark.parametrize("shape", [(2, 3), (4, 3), (1, 3)])
def test_one_graph_per_signature(shape):
    gs = GraphSet("t", CPU, EmulatedGraph)
    prog = Program(lambda a: a * 2 + 1, name="aff", graphs=gs)
    for s in ((2, 3), shape, (2, 3), shape):
        x = torch.ones(s)
        assert torch.equal(prog(x), x * 2 + 1)
    assert gs.num_graphs == (1 if shape == (2, 3) else 2)
    assert len(prog.signatures) == gs.num_graphs


def test_resident_used_in_place_not_copied():
    """A resident argument is read where it lies: changing it in place
    changes the replay, and it takes no static buffer."""
    gs = GraphSet("t", CPU, EmulatedGraph)
    prog = Program(lambda x, w: x @ w, name="mm", resident=(1,), graphs=gs)
    x, w = torch.ones(2, 3), torch.ones(3, 4)
    assert torch.equal(prog(x, w, slot="w"), x @ w)
    assert gs.static_bytes == x.numel() * 4  # x only
    w.mul_(3.0)
    assert torch.equal(prog(x, w, slot="w"), x @ w)
    assert gs.num_graphs == 1


def test_resident_of_a_new_storage_raises():
    """Under one slot, a resident argument of another storage raises (a
    replay would read the captured address); another slot captures its
    own graph."""
    gs = GraphSet("t", CPU, EmulatedGraph)
    prog = Program(lambda x, w: x @ w, name="mm", resident=(1,), graphs=gs)
    x, w1, w2 = torch.ones(2, 3), torch.ones(3, 4), torch.full((3, 4), 2.0)
    prog(x, w1, slot="a")
    with pytest.raises(ResidentMoved):
        prog(x, w2, slot="a")
    with pytest.raises(ResidentMoved):
        prog(x, w1.clone(), slot="a")
    assert torch.equal(prog(x, w2, slot="b"), x @ w2)
    assert torch.equal(prog(x, w1, slot="a"), x @ w1)
    assert gs.num_graphs == 2


def test_output_that_is_an_argument_is_the_callers_tensor():
    """The in-place glue returns the cache it wrote: the caller gets its own
    resident tensor back, not a clone."""
    gs = GraphSet("t", CPU, EmulatedGraph)

    def write(row, cache, i):
        cache[i.long()] = row[None]
        return row.sum(), cache

    prog = Program(write, name="w", resident=(1,), graphs=gs)
    cache = torch.zeros(4, 3)
    for k in range(3):
        s, c = prog(torch.full((3,), float(k + 1)), cache,
                    torch.tensor([k], dtype=torch.int32))
        assert c is cache and float(s) == 3.0 * (k + 1)
    assert torch.equal(cache[:3], torch.tensor([[1.0] * 3, [2.0] * 3, [3.0] * 3]))
    assert gs.num_graphs == 1


def test_capture_failure_raises_and_never_falls_back():
    """A host sync inside the program fails the capture; the next call
    fails again — no path gives way to eager."""
    gs = GraphSet("t", CPU, EmulatedGraph)
    prog = Program(lambda x: x * float(x.sum()), name="sync", graphs=gs)
    for _ in range(2):
        with pytest.raises(GraphCaptureError, match="sync on t"):
            prog(torch.ones(3))
    assert gs.num_graphs == 0 and gs.replays == {}
    assert torch.equal(prog.eager(torch.ones(3)), torch.full((3,), 3.0))


class _CollectorSpy(EmulatedGraph):
    """The emulator, noting whether the cyclic collector is on at the
    capture's begin and end."""

    seen: list = []

    def capture_begin(self, pool=None, capture_error_mode="global"):
        type(self).seen.append(gc.isenabled())
        super().capture_begin(pool, capture_error_mode)

    def capture_end(self):
        type(self).seen.append(gc.isenabled())
        super().capture_end()


def test_no_garbage_collection_inside_a_capture():
    """A collection inside a capture would reset unreachable CUDA graphs
    on the capturing thread and invalidate the capture: the collector is
    off from the capture's begin to its end, and back on after; holds
    from two threads nest, and a collector already off stays off."""
    assert gc.isenabled()
    _CollectorSpy.seen = []
    gs = GraphSet("t", CPU, _CollectorSpy)
    Program(lambda x: x + 1, name="p", graphs=gs)(torch.zeros(2))
    assert _CollectorSpy.seen == [False, False] and gc.isenabled()

    inside, release = threading.Event(), threading.Event()

    def hold():
        with no_collection():
            inside.set()
            release.wait(10)

    t = threading.Thread(target=hold)
    t.start()
    try:
        assert inside.wait(10)
        with no_collection():
            assert not gc.isenabled()
        assert not gc.isenabled()  # the other thread still holds it off
    finally:
        release.set()
        t.join(10)
    assert not t.is_alive() and gc.isenabled()
    gc.disable()
    try:
        with no_collection():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()


def test_held_launches_count_once_per_replay():
    """A wrapper called during a capture records into the graph: its count
    rises by the warm-up's launch, then once per replay."""
    counter = LaunchCounter("fake")

    def wrapper(x):
        counter.add()
        return x + 1

    gs = GraphSet("t", CPU, EmulatedGraph)
    prog = Program(wrapper, name="k", graphs=gs)
    for _ in range(3):
        prog(torch.zeros(2))
    assert counter.count == 1 + 3  # warm-up + three replays
    assert gs.held == {"k": {"fake": 1}}


def test_drop_by_slot_prefix():
    """``drop`` takes the graphs of the slots under a prefix (and the
    residents they hold) and leaves the rest; a later call captures
    again."""
    gs = GraphSet("t", CPU, EmulatedGraph)
    prog = Program(lambda x, w: x @ w, name="mm", resident=(1,), graphs=gs)
    x, w = torch.ones(2, 3), torch.ones(3, 4)
    for slot in ("a/conv1", "a/conv2", "ab/conv1", None):
        prog(x, w, slot=slot)
    held = weakref.ref(w2 := torch.full((3, 4), 2.0))
    prog(x, w2, slot="a/conv3")
    assert gs.drop("a/") == 3 and gs.num_graphs == 2 and prog.captures == 2
    del w2
    gc.collect()
    assert held() is None  # the dropped graph let its resident go
    assert torch.equal(prog(x, 2 * w, slot="a/conv1"), x @ (2 * w))
    assert gs.captures["mm"] == 6 and gs.num_graphs == 3


def test_merge_stats_sums_owners():
    a, b = GraphSet("a", CPU, EmulatedGraph), GraphSet("b", CPU, EmulatedGraph)
    pa = Program(lambda x: x + 1, name="p", graphs=a)
    pb = Program(lambda x: x + 1, name="p", graphs=b)
    for _ in range(2):
        pa(torch.zeros(2))
        pb(torch.zeros(3))
    st = merge_stats([a, b, None])
    assert st["owners"] == 2 and st["graphs"] == 2
    assert st["captures"] == {"p": 2} and st["replays"] == {"p": 4}
    assert st["static_bytes"] == 2 * 4 + 3 * 4 and st["pool_bytes"] == 0


def test_owner_threads_serialise():
    """Two threads replaying one owner's graph never interleave a
    copy-in, replay and clone-out: every output matches its own input."""
    gs = GraphSet("t", CPU, EmulatedGraph)
    prog = Program(lambda x: x * 3, name="m", graphs=gs)
    prog(torch.zeros(64))
    bad = []

    def run(v):
        for _ in range(50):
            x = torch.full((64,), float(v))
            if not torch.equal(prog(x), x * 3):
                bad.append(v)

    threads = [threading.Thread(target=run, args=(v,)) for v in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not bad and gs.num_graphs == 1


# -- pipelines and pools ---------------------------------------------------
def _params(arch):
    return init_cnn(arch, torch.Generator().manual_seed(0), "cpu")


def test_master_graphs_switch_and_direct_path_eager():
    """The pipeline's master programs follow ``set_graphs``; the
    single-process path runs them eagerly (no capture)."""
    pipe = build_cnn_pipeline("lenet5", _params("lenet5"), N, default_kab=(2, 4),
                              input_hw=input_hw("lenet5", smoke=True),
                              fuse_transitions=True, bucket_sizes=(1, 2),
                              device="cpu")
    assert pipe.master_graphs is None  # graphs=True on the CPU: eager
    pipe.set_graphs(EmulatedGraph)
    gs = pipe.master_graphs
    assert pipe.transition_fn(0).graphs is gs and pipe.encoder(0).graphs is gs
    x = torch.as_tensor(_rng(2).standard_normal((2,) + pipe.input_shape)
                        .astype(np.float32))
    pipe.run(x)
    assert gs.num_graphs == 0
    pipe.set_graphs(False)
    assert pipe.master_graphs is None and pipe.transition_fn(0).graphs is None


def test_decode_operand_memoised_per_subset():
    pipe = build_cnn_pipeline("lenet5", _params("lenet5"), N, default_kab=(2, 4),
                              input_hw=input_hw("lenet5", smoke=True), device="cpu")
    a = pipe.decode_operand(0, (0, 1))
    assert pipe.decode_operand(0, (0, 1)) is a
    b = pipe.decode_operand(0, (2, 5))
    assert b is not a and not torch.equal(a, b)
    want = torch.as_tensor(pipe.decode_matrix(0, (2, 5)), dtype=torch.float32)
    assert torch.equal(b, want)


def _cnn_server(arch, graphs, pool, delays, workers=False):
    srv = CodedServer.from_cnn(
        arch, _params(arch), N, default_kab=(2, 4),
        input_hw=input_hw(arch, smoke=True),
        straggler=StragglerModel(np.array(delays)), mode="threads",
        bucket_sizes=(1, 2, 4), pipeline_depth=2, fuse_transitions=True,
        pool=pool, device="cpu")
    srv.pipeline.set_graphs(graphs, workers=workers)
    return srv


# forced: workers 2..5 slowed far beyond a round, so 0 and 1 decode;
# delayed survivor: worker 1 delayed and needed (2..5 dead)
SCENARIOS = {"forced": [0.0, 0.0, 0.3, 0.3, 0.3, 0.3],
             "delayed_survivor": [0.0, 0.02] + [np.inf] * 4}
GROUPS = (1, 3, 2, 4, 1)  # request groups: buckets 1, 4, 2, 4, 1


def _serve_groups(srv, xs):
    """Serve ``xs`` in ``GROUPS``, each group submitted at once (under the
    scheduler's condition, so the engine admits it whole) and finished
    before the next: the same batches in every run."""
    outs, i = [], 0
    srv.warmup()
    with srv:
        for g in GROUPS:
            with srv.scheduler.not_empty:
                handles = srv.submit_many(xs[i:i + g])
            outs += [torch.as_tensor(h.result(timeout=300)) for h in handles]
            i += g
        # the pool drops its workers' graphs at shutdown
        counts = srv.cluster._pool_impl().graph_counts() \
            if srv.cluster.pool == "device" else []
    return outs, counts


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("pool", ["device", "threads"])
@pytest.mark.parametrize("arch", ["lenet5", "vgg16"])
def test_cnn_served_replayed_equals_eager_and_reference(arch, pool, scenario):
    """CodedServer at pipeline depth 2 with fused transitions, the rounds
    replayed from emulated graphs (the master's on both pools, the
    workers' on the device pool): every result ``torch.equal`` to the
    eager server's, and within fp32 tolerance of the reference's pipeline
    on the same survivors; captures within their bounds."""
    delays = SCENARIOS[scenario]
    srv = _cnn_server(arch, EmulatedGraph, pool, delays, workers=True)
    pipe = srv.pipeline
    xs = _rng(3).standard_normal((sum(GROUPS),) + pipe.input_shape) \
        .astype(np.float32)
    got, counts = _serve_groups(srv, xs)
    eager, _ = _serve_groups(_cnn_server(arch, False, pool, delays), xs)
    for g, e in zip(got, eager):
        assert torch.equal(g, e)
    master = pipe.master_graphs
    assert 0 < master.num_graphs <= pipe.master_graph_bound
    assert master.replays["transition"] > 0 and master.replays["encoder"] > 0
    if pool == "device":
        live = [i for i in range(N) if np.isfinite(delays[i])]
        assert all(0 < counts[i] <= pipe.worker_graph_bound for i in live)
        assert all(counts[i] == 0 for i in range(N) if i not in live)
    ref = ref_build_cnn_pipeline(
        arch, {k: jnp.asarray(v.numpy()) for k, v in _params(arch).items()},
        N, default_kab=(2, 4), input_hw=input_hw(arch, smoke=True),
        fuse_transitions=True)
    want = np.asarray(ref.run(jnp.asarray(xs), [0, 1]))
    np.testing.assert_allclose(torch.stack(got).numpy(), want, **TOL)


def test_cnn_captures_bounded_under_many_batches_and_subsets():
    """Many batch sizes and survivor subsets on the device pool: captures
    per worker stay at or below one per (layer, bucket), the master's at
    its bound, and a repeat run adds no capture."""
    pipe = build_cnn_pipeline("lenet5", _params("lenet5"), N, default_kab=(2, 4),
                              input_hw=input_hw("lenet5", smoke=True),
                              fuse_transitions=True, bucket_sizes=(1, 2, 4),
                              device="cpu", graphs=EmulatedGraph)
    pipe.set_graphs(EmulatedGraph, workers=True)
    rng = _rng(4)
    for delays in ([0.0] * N, [0.0, 0.0, np.inf, 0.0, np.inf, 0.0],
                   [np.inf, 0.0, 0.0, np.inf, 0.0, 0.0]):
        with FcdccCluster(pipe.specs[0].plan, StragglerModel(np.array(delays)),
                          mode="threads", pool="device",
                          device="cpu") as cluster:
            cluster.load_pipeline(pipe, "m")
            for b in (1, 2, 3, 4, 2):
                x = rng.standard_normal((b,) + pipe.input_shape).astype(np.float32)
                xp, _ = pipe.pad_to_bucket(torch.as_tensor(x))
                y, timings = cluster.run_pipeline(xp, model="m")
                ids = timings[0].used_workers
                want = pipe.run(xp, ids)
                torch.testing.assert_close(y, want, **TOL)
            counts = cluster._pool_impl().graph_counts()
            assert max(counts) <= pipe.worker_graph_bound
            before = pipe.master_graphs.num_graphs
            cluster.run_pipeline(xp, model="m")
            assert pipe.master_graphs.num_graphs == before
    assert pipe.master_graphs.num_graphs <= pipe.master_graph_bound


def test_device_pool_programs_keyed_by_worker():
    """Every worker has its own program (and graph set), so no graph is
    shared between two workers' streams."""
    pipe = build_cnn_pipeline("lenet5", _params("lenet5"), N, default_kab=(2, 4),
                              input_hw=input_hw("lenet5", smoke=True),
                              device="cpu")
    pipe.set_graphs(EmulatedGraph, workers=True)
    with FcdccCluster(pipe.specs[0].plan, None, mode="threads", pool="device",
                      device="cpu") as cluster:
        cluster.load_pipeline(pipe)
        cluster.run_pipeline(torch.zeros((1,) + pipe.input_shape))
        impl = cluster._pool_impl()
        progs = {id(p) for p in impl._programs.values()}
        assert len(progs) == N * len({s.program_key for s in pipe.specs})
        sets = impl.graph_sets()
        assert len({id(s) for s in sets}) == N
        assert all(s.num_graphs == len(pipe.specs) for s in sets)
        assert set(impl.program_traces()) == {CPU}
    assert impl.graph_sets() == []  # shutdown drops them


def test_device_pool_workers_eager_by_default():
    """A pipeline's worker rounds run eagerly unless it asks for worker
    graphs: on the device pool the master replays and no worker captures,
    and the results equal the all-eager server's."""
    delays = SCENARIOS["delayed_survivor"]
    srv = _cnn_server("lenet5", EmulatedGraph, "device", delays)
    assert not srv.pipeline.worker_graphs
    xs = _rng(9).standard_normal((sum(GROUPS),) + srv.pipeline.input_shape) \
        .astype(np.float32)
    got, counts = _serve_groups(srv, xs)
    eager, _ = _serve_groups(_cnn_server("lenet5", False, "device", delays), xs)
    assert all(torch.equal(g, e) for g, e in zip(got, eager))
    assert counts == [0] * N
    assert srv.pipeline.master_graphs.replays["transition"] > 0


def _lenet(seed, graphs):
    pipe = build_cnn_pipeline(
        "lenet5", init_cnn("lenet5", torch.Generator().manual_seed(seed), "cpu"),
        N, default_kab=(2, 4), input_hw=input_hw("lenet5", smoke=True),
        fuse_transitions=True, bucket_sizes=(1, 2), device="cpu")
    pipe.set_graphs(graphs, workers=True)
    return pipe


def _serve_model(srv, xs, model):
    with srv.scheduler.not_empty:
        handles = srv.submit_many(xs, model=model)
    return [torch.as_tensor(h.result(timeout=300)) for h in handles]


def test_reregistered_model_recaptures_and_releases_old_shards():
    """Hot swap on the device pool with worker graphs: a model unregistered
    and registered again under its name with new weights serves the new
    weights (its worker graphs are captured anew, never replayed on the
    old shards), equal to an eager server of the new pipeline; the pool
    and the graphs let the old shards go."""
    xs = _rng(10).standard_normal((2,) + _lenet(0, False).input_shape) \
        .astype(np.float32)
    with CodedServer(_lenet(1, False), StragglerModel.none(N), mode="threads",
                     pool="device", model="b") as ref:
        want = _serve_model(ref, xs, "b")
    old, new = _lenet(0, EmulatedGraph), _lenet(1, EmulatedGraph)
    srv = CodedServer(old, StragglerModel.none(N), mode="threads",
                      pool="device", model="b")
    srv.warmup()
    with srv:
        first = _serve_model(srv, xs, "b")
        impl = srv.cluster._pool_impl()
        shards = [weakref.ref(t) for name, (_, per) in impl._filters.items()
                  if name.startswith("b/") for t in per]
        assert shards and max(impl.graph_counts()) > 0
        srv.unregister_model("b")
        assert impl.graph_counts() == [0] * N
        srv.register_model("b", new)
        got = _serve_model(srv, xs, "b")
        counts = impl.graph_counts()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not all(torch.equal(f, g) for f, g in zip(first, got))
    assert 0 < max(counts) <= new.worker_graph_bound
    del first
    gc.collect()
    assert all(r() is None for r in shards)


def test_graphs_false_serves_eagerly():
    srv = _cnn_server("lenet5", False, "device", [0.0] * N)
    srv.warmup()
    assert srv.pipeline.master_graphs is None
    assert srv.cluster._pool_impl().graph_sets() == []
    srv.shutdown()


def test_contracts_capture_replay_through_the_helper():
    """The gate's capture check runs the serving path's helper: every cell
    of a fused LeNet-5 and of the LM decoder captures and replays equal to
    eager on a second argument set (with the emulator on the CPU)."""
    cfg = contracts.ContractConfig("lenet5", "kernel", True)
    rep = contracts.analyze_config(cfg, "cpu", capture=True,
                                   graph_cls=EmulatedGraph)
    assert not rep.findings, rep.render_text()
    assert rep.stats[f"{cfg.label}/captured"] == \
        rep.stats[f"{cfg.label}/programs_checked"]
    dcfg = contracts.DecoderContractConfig("coded", "kernel")
    rep = contracts.analyze_decoder_config(dcfg, "cpu", capture=True,
                                           graph_cls=EmulatedGraph)
    assert not rep.findings, rep.render_text()
    assert rep.stats[f"{dcfg.label}/captured"] > 0


# -- the LM -----------------------------------------------------------------
LM_MAX_LEN = 32
LM_PROMPTS = [[5, 9, 2], [7, 1], [3, 3, 4, 8, 2], [11], [6, 2, 9, 4]]
LM_GENS = [5, 3, 6, 2, 4]
LM_SCENARIOS = {"straggler": [0.0, 0.0, 0.02, np.inf],
                "delayed_survivor": [0.0, 0.02, np.inf, np.inf]}


@pytest.fixture(scope="module")
def lm_ref():
    bundle = ref_smollm.smoke()
    params = bundle.init(jax.random.PRNGKey(0), jnp.float32)
    port = lm.lm_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    want = []
    for prompt, gen in zip(LM_PROMPTS, LM_GENS):
        cache = ref_lm.init_cache(bundle.cfg, 1, LM_MAX_LEN, jnp.float32)
        logits, cache = ref_lm.prefill(params, bundle.cfg, cache,
                                       jnp.asarray([prompt]))
        toks = [int(jnp.argmax(logits[0, len(prompt) - 1]))]
        for j in range(gen - 1):
            logits, cache = ref_lm.decode_step(
                params, bundle.cfg, cache, jnp.asarray([[toks[-1]]], jnp.int32),
                jnp.int32(len(prompt) + j))
            toks.append(int(jnp.argmax(logits[0, 0])))
        want.append(toks)
    return port, want


def _lm_pipe(port, graphs, workers=False):
    pipe = build_lm_decoder_pipeline(smollm_135m.smoke(), port, 4, k_b=4,
                                     bucket_sizes=(1, 2, 4), max_len=LM_MAX_LEN,
                                     device="cpu", graphs=graphs)
    pipe.set_graphs(graphs, workers=workers)
    return pipe


def _lm_serve(pipe, delays, pool="device"):
    rows = {}
    srv = CodedLMServer(
        pipe, StragglerModel(np.array(delays)), mode="threads", pool=pool,
        max_prompt=8, poll_interval_s=0.002,
        on_logits=lambda rid, row: rows.setdefault(rid, []).append(row.clone()))
    srv.warmup()
    captured = (0 if pipe.master_graphs is None
                else pipe.master_graphs.num_graphs)
    with srv:
        with srv.scheduler.not_empty:
            handles = [srv.submit(p, g) for p, g in zip(LM_PROMPTS, LM_GENS)]
        toks = [list(h.result(timeout=300)) for h in handles]
        counts = srv.cluster._pool_impl().graph_counts() \
            if srv.cluster.pool == "device" else []
    rows = [torch.stack(rows[h.request_id]) for h in handles]
    return toks, rows, captured, counts


@pytest.mark.parametrize("pool", ["device", "threads"])
@pytest.mark.parametrize("scenario", sorted(LM_SCENARIOS))
def test_lm_served_replayed_equals_eager_and_reference(lm_ref, scenario, pool):
    """The coded SmolLM smoke decoder served with the glue and (device
    pool) the worker rounds replayed: tokens equal the eager server's and
    the reference's greedy decode token for token, logits rows
    ``torch.equal`` to eager; warmup captured everything, so serving
    captured nothing; captures within their bounds."""
    port, want = lm_ref
    delays = LM_SCENARIOS[scenario]
    pipe = _lm_pipe(port, EmulatedGraph, workers=True)
    toks, rows, warm, counts = _lm_serve(pipe, delays, pool)
    toks_e, rows_e, _, _ = _lm_serve(_lm_pipe(port, False), delays, pool)
    assert toks == toks_e == want
    for r, e in zip(rows, rows_e):
        assert torch.equal(r, e)
    master = pipe.master_graphs
    assert master.num_graphs == warm <= pipe.glue_graph_bound
    assert master.replays["glue.attn"] > 0 and master.replays["glue.finish"] > 0
    assert all(c <= pipe.worker_graph_bound for c in counts)
    if pool == "device":
        live = [i for i in range(4) if np.isfinite(delays[i])]
        assert all(counts[i] > 0 for i in live)


def test_lm_glue_bound_is_tight(lm_ref):
    """Every bucket of a decode step on the direct path captures exactly
    the stated glue bound: five glue programs and one attention graph per
    layer, per bucket."""
    port, _ = lm_ref
    pipe = _lm_pipe(port, EmulatedGraph)
    srv = CodedLMServer(pipe, execution="direct", max_prompt=8)
    srv.warmup()
    assert pipe.master_graphs.num_graphs == pipe.glue_graph_bound
    assert pipe.master_graphs.captures["glue.attn"] == \
        pipe.cfg.layers * len(pipe.bucket_sizes)


def test_lm_slot_cache_zeroed_in_place_and_a_new_cache_raises(lm_ref):
    """The engine's cache is the pipeline's own, zeroed in place; a decode
    step handed another cache under the captured layer raises rather than
    replay on the captured one."""
    port, _ = lm_ref
    pipe = _lm_pipe(port, EmulatedGraph)
    cache = pipe.slot_cache(4)
    toks = torch.zeros(2, dtype=torch.int32)
    pos = torch.tensor([0, 1], dtype=torch.int32)
    pipe.run_decode_step_direct(toks, cache, pos)
    assert float(cache[0]["k"].abs().sum()) > 0
    again = pipe.slot_cache(4)
    assert again is cache and float(cache[0]["k"].abs().sum()) == 0
    with pytest.raises(ResidentMoved):
        pipe.run_decode_step_direct(toks, pipe.init_slot_cache(4), pos)


def test_lm_slot_cache_serves_one_server_at_a_time(lm_ref):
    """The slot caches are the pipeline's own: a second server on the
    pipeline raises while the first is live (it would zero and overwrite
    the first one's cache), and may serve once the first shut down or was
    dropped."""
    port, want = lm_ref
    pipe = _lm_pipe(port, False)
    first = CodedLMServer(pipe, execution="direct", max_prompt=8)
    first.warmup()
    second = CodedLMServer(pipe, execution="direct", max_prompt=8)
    with pytest.raises(RuntimeError, match="another server"):
        second.warmup()
    with pytest.raises(RuntimeError, match="another server"):
        second.start()
    first.shutdown()
    with second:
        assert list(second.generate(LM_PROMPTS[0], LM_GENS[0],
                                    timeout=300)) == want[0]
        with pytest.raises(RuntimeError, match="another server"):
            first.start()
    third = CodedLMServer(pipe, execution="direct", max_prompt=8)
    third.warmup()
    del third
    gc.collect()
    second.warmup()  # the dropped server's claim went with it
