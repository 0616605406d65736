"""The port's autotune ledger (``repro_torch.kernels.autotune``) and
``CodedPipeline.autotune_kernels``, on the CPU: the counterpart of
``tests/test_autotune.py``.

Held here: the ledger's round trip, its persistence and atomic save,
``clear_cache``; that lookups never sweep; the key format (the reference's
shapes, the card's tag in place of its ``interpret`` flag); the plan each
wrapper launches (a ledger hit its plan, a miss the heuristic's, a
malformed entry ``ValueError``); ``tune_*`` and ``autotune_kernels``
without a card; and that the pipeline's walk visits the reference's cells,
keys compared without their device tag, and the shapes K1 and K2 are
launched with.  The sweeps themselves time the card:
``tests/test_torch_cuda.py``.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.core.pipeline import build_cnn_pipeline as ref_build_cnn
from repro.kernels import autotune as ref_autotune
from repro.models.cnn import init_cnn as ref_init_cnn
from repro_torch.core import fcdcc
from repro_torch.core.pipeline import build_cnn_pipeline
from repro_torch.kernels import autotune
from repro_torch.kernels.conv2d import kernel as k1
from repro_torch.kernels.conv2d import ops
from repro_torch.kernels.matmul import kernel as k2

RNG = np.random.default_rng(7)
XE, KE = (2, 1, 2, 12, 16), (2, 3, 2, 3, 3)


@pytest.fixture
def ledger(tmp_path, monkeypatch):
    """An isolated, initially-empty ledger file for each test."""
    path = tmp_path / "autotune_cache_torch.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    autotune.clear_cache(memory_only=True)
    yield path
    autotune.clear_cache(memory_only=True)


def _untagged(key: str) -> tuple:
    """A key without its device (or backend) tag: kind and shape parts."""
    parts = key.split("/")
    return (parts[0],) + tuple(parts[-3:] if parts[0] == "worker"
                               else parts[-2:])


# -- keys ----------------------------------------------------------------------
def test_keys_carry_the_device_tag_and_the_reference_shapes():
    assert autotune.device_tag("cpu") == "cpu"
    assert autotune.worker_key(XE, KE, 1, device="cpu") == \
        "worker/cpu/xe2x1x2x12x16/ke2x3x2x3x3/s1"
    assert autotune.matmul_key(16, 16, 512, relu=True, device="cpu") == \
        "matmul/cpu/m16k16n512/relu=1"
    assert _untagged(autotune.worker_key(XE, KE, 2, device="cpu")) == \
        _untagged(ref_autotune.worker_key(XE, KE, 2))
    assert _untagged(autotune.matmul_key(8, 4, 300, device="cpu")) == \
        _untagged(ref_autotune.matmul_key(8, 4, 300))


# -- the ledger ------------------------------------------------------------------
def test_ledger_roundtrip_and_persistence(ledger):
    wkey = autotune.worker_key(XE, KE, 1, device="cpu")
    mkey = autotune.matmul_key(16, 16, 512, relu=True, device="cpu")
    swept = [{"params": {"route": "tc", "bn": 32, "splits": 1}, "us": 3.5},
             {"params": {"route": "ffma", "bn": 64, "splits": 1}, "us": 4.25}]
    autotune._record(wkey, {"route": "tc", "bn": 32, "splits": 1}, 3.5, swept)
    autotune._record(mkey, {"kernel": "column"}, 2.0,
                     [{"params": {"kernel": "column"}, "us": 2.0}])
    assert autotune.sweep_count() == 2
    assert autotune.worker_params(XE, KE, 1, device="cpu") == \
        {"route": "tc", "bn": 32, "splits": 1}
    assert autotune.matmul_params(16, 16, 512, relu=True, device="cpu") == \
        {"kernel": "column"}
    # other cells miss
    assert autotune.matmul_params(16, 16, 512, relu=False, device="cpu") is None
    assert autotune.worker_params(XE, KE, 2, device="cpu") is None
    on_disk = json.loads(ledger.read_text())
    assert on_disk[wkey] == {"params": {"route": "tc", "bn": 32, "splits": 1},
                             "us": 3.5, "swept": swept}
    # a fresh process (simulated: drop memory, reload the file) sees them
    autotune.clear_cache(memory_only=True)
    assert autotune.sweep_count() == 0
    assert autotune.worker_params(XE, KE, 1, device="cpu") == \
        {"route": "tc", "bn": 32, "splits": 1}
    assert autotune.sweep_count() == 0  # a reload is not a sweep


def test_clear_cache_drops_the_file_unless_memory_only(ledger):
    autotune._record("matmul/cpu/m1k1n1/relu=0", {"kernel": "column"}, 1.0, [])
    autotune.clear_cache(memory_only=True)
    assert ledger.exists()
    autotune.clear_cache()
    assert not ledger.exists()
    assert autotune.load_cache() == {}
    autotune.clear_cache()  # no file: nothing to remove, no error


def test_save_is_atomic(ledger, monkeypatch):
    """The ledger is written to a temporary file beside it and renamed over
    it: a reader sees the old file or the new one, never a torn one."""
    calls = []
    replace = os.replace

    def spy(src, dst):
        calls.append((src, dst, os.path.exists(dst)))
        assert json.loads(open(src).read())  # complete before the rename
        replace(src, dst)

    monkeypatch.setattr(autotune.os, "replace", spy)
    autotune._record("matmul/cpu/m1k1n1/relu=0", {"kernel": "column"}, 1.0, [])
    autotune._record("matmul/cpu/m2k1n1/relu=0", {"kernel": "column"}, 1.0, [])
    assert [(os.path.dirname(s), d) for s, d, _ in calls] == \
        [(str(ledger.parent), str(ledger))] * 2
    assert [existed for _, _, existed in calls] == [False, True]
    assert all(not os.path.exists(s) for s, _, _ in calls)
    assert len(json.loads(ledger.read_text())) == 2


def test_lookups_never_sweep(ledger):
    assert autotune.matmul_params(31, 41, 59, device="cpu") is None
    assert autotune.worker_params((1, 1, 1, 8, 8), (1, 1, 1, 3, 3), 1,
                                  device="cpu") is None
    assert autotune.sweep_count() == 0
    assert not ledger.exists()


def test_default_ledger_lies_in_the_checkout(monkeypatch):
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert autotune.cache_path() == os.path.join(
        root, "results", "autotune_cache_torch.json")


# -- the plan each wrapper launches ---------------------------------------------
def test_worker_plan_choice(ledger):
    m, n, k = k1.gemm_shape((1, 8, 512, 16, 16), (4, 128, 512, 3, 3), 1)
    xe, ke = (1, 8, 512, 16, 16), (4, 128, 512, 3, 3)
    assert k1.choose_worker_plan(xe, ke, 1, "cpu") == k1.worker_plan(m, n, k)
    autotune._record(autotune.worker_key(xe, ke, 1, device="cpu"),
                     {"route": "tc", "bn": 32, "splits": 8}, 1.0, [])
    plan = k1.choose_worker_plan(xe, ke, 1, "cpu")
    assert (plan.route, plan.bn, plan.splits) == ("tc", 32, 8)
    assert plan.k_slice * 8 >= k and plan.blocks == plan.tiles * 8
    assert plan != k1.worker_plan(m, n, k)
    # another cell, or another stride, still takes the heuristic
    assert k1.choose_worker_plan(xe, ke, 2, "cpu") == k1.worker_plan(
        *k1.gemm_shape(xe, ke, 2))


def test_matmul_plan_choice(ledger):
    m, k, n = 4, 2048, 2048
    assert k2.choose_matmul_plan(m, n, k, device="cpu") == k2.matmul_plan(m, n, k)
    autotune._record(autotune.matmul_key(m, k, n, device="cpu"),
                     {"kernel": "split", "splits": 8}, 1.0, [])
    plan = k2.choose_matmul_plan(m, n, k, device="cpu")
    assert (plan.kernel, plan.splits, plan.k_slice) == ("split", 8, 256)
    # keyed by the ReLU too
    assert k2.choose_matmul_plan(m, n, k, relu=True, device="cpu") == \
        k2.matmul_plan(m, n, k)
    autotune._record(autotune.matmul_key(m, k, n, relu=True, device="cpu"),
                     {"kernel": "column"}, 1.0, [])
    assert k2.choose_matmul_plan(m, n, k, relu=True, device="cpu").kernel == \
        "column"


@pytest.mark.parametrize("params", [
    {"route": "tc", "bn": 48, "splits": 1},
    {"route": "ffma", "bn": 64, "splits": 3}, {"route": "tc", "bn": 64},
    {"route": "tc", "bn": 64, "splits": 1, "bo": 8},
    {"route": "tc", "bn": 64.0, "splits": 1}, [64, 1],
    {"route": "wgmma", "bn": 64, "splits": 1}])
def test_malformed_worker_entry_raises(ledger, params):
    xe, ke = (2, 1, 2, 12, 16), (2, 3, 2, 3, 3)  # K = 18: 2 stages
    autotune._record(autotune.worker_key(xe, ke, 1, device="cpu"), params,
                     1.0, [])
    with pytest.raises(ValueError):
        k1.choose_worker_plan(xe, ke, 1, "cpu")


@pytest.mark.parametrize("route", ["tc", "ffma"])
def test_worker_entry_too_shallow_to_split_raises(ledger, route):
    xe, ke = (2, 1, 2, 12, 16), (2, 3, 2, 3, 3)  # K = 18: 1 or 2 stages
    autotune._record(autotune.worker_key(xe, ke, 1, device="cpu"),
                     {"route": route, "bn": 32, "splits": 2}, 1.0, [])
    with pytest.raises(ValueError, match="stages"):
        k1.choose_worker_plan(xe, ke, 1, "cpu")


@pytest.mark.parametrize("params", [{"bn": 32, "splits": 1},
                                    {"bn": 128, "splits": 8}])
def test_entry_of_the_ffma_only_ledger_is_refused(ledger, params):
    """An entry recorded before K1 had routes names a plan of the FFMA
    kernel alone: it is refused (the cell is swept again), never launched
    on either kernel; a sweep's own entry for the cell replaces it."""
    xe, ke = (1, 8, 512, 16, 16), (4, 128, 512, 3, 3)  # K = 4,608
    key = autotune.worker_key(xe, ke, 1, device="cpu")
    autotune._record(key, params, 1.0, [])
    with pytest.raises(ValueError, match="route"):
        k1.choose_worker_plan(xe, ke, 1, "cpu")
    fresh = {"route": "ffma", **params}
    autotune._record(key, fresh, 1.0, [])
    plan = k1.choose_worker_plan(xe, ke, 1, "cpu")
    assert k1.plan_params(plan) == fresh


@pytest.mark.parametrize("params,m", [
    ({"kernel": "split", "splits": 3}, 4), ({"kernel": "split", "splits": 2}, 32),
    ({"kernel": "split"}, 4), ({"kernel": "tiles"}, 4),
    ({"kernel": "column", "splits": 0}, 4), ({}, 4)])
def test_malformed_matmul_entry_raises(ledger, params, m):
    autotune._record(autotune.matmul_key(m, 256, 512, device="cpu"), params,
                     1.0, [])
    with pytest.raises(ValueError):
        k2.choose_matmul_plan(m, 512, 256, device="cpu")


def test_candidates_hold_the_heuristic_first():
    xe, ke = (1, 8, 512, 16, 16), (4, 128, 512, 3, 3)
    m, n, k = k1.gemm_shape(xe, ke, 1)
    h = k1.worker_plan(m, n, k)
    cands = autotune.worker_candidates(xe, ke, 1)
    assert cands[0] == k1.plan_params(h) == {"route": h.route, "bn": h.bn,
                                             "splits": h.splits}
    assert {c["route"] for c in cands} == set(k1.ROUTES)
    assert len(cands) == len({json.dumps(c, sort_keys=True) for c in cands})
    assert all(k1.worker_plan_of(c, m, n, k) for c in cands)
    # K = 18 (2 stages): no split keeps 8 stages a slice
    assert {c["splits"] for c in autotune.worker_candidates(XE, KE, 1)} == {1}
    for m, k, n in [(4, 2048, 2048), (16, 16, 50176), (32, 4, 100)]:
        cands = autotune.matmul_candidates(m, k, n)
        assert cands[0] == k2.plan_params(k2.matmul_plan(m, n, k))
        assert all(k2.matmul_plan_of(c, m, n, k) for c in cands)
        split = m <= k2.SPLIT_MAX_M and k >= k2.SPLIT_MIN_K
        assert len(cands) == (1 + len(k2.SPLIT_CHOICES) if split else 1)


def test_tune_raises_without_a_card(ledger):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the sweep runs in test_torch_cuda.py")
    with pytest.raises(RuntimeError, match="card"):
        autotune.tune_worker(XE, KE, 1)
    with pytest.raises(RuntimeError, match="card"):
        autotune.tune_matmul(16, 16, 512)
    assert autotune.sweep_count() == 0
    assert not ledger.exists()


# -- the pipeline's walk ---------------------------------------------------------
@pytest.fixture(scope="module")
def lenet_params():
    params = ref_init_cnn("lenet5", jax.random.PRNGKey(0))
    return {k: np.array(v) for k, v in params.items()}


def _port_pipe(params, fused: bool, buckets=(2,)):
    return build_cnn_pipeline(
        "lenet5", {k: torch.as_tensor(v) for k, v in params.items()}, 8,
        default_kab=(2, 4), backend="kernel", fuse_transitions=fused,
        bucket_sizes=buckets, device="cpu")


def _ref_cells(params, fused: bool, monkeypatch, buckets=(2,)) -> list:
    """The keys the reference's ``autotune_kernels`` visits, its sweeps
    replaced by a recorder (nothing is timed)."""
    monkeypatch.setattr(ref_autotune, "tune_worker", lambda *a, **kw: {})
    monkeypatch.setattr(ref_autotune, "tune_matmul", lambda *a, **kw: {})
    pipe = ref_build_cnn("lenet5", params, 8, default_kab=(2, 4),
                         backend="pallas", interpret=True,
                         fuse_transitions=fused, bucket_sizes=buckets,
                         donate_transitions=False)
    return [_untagged(key) for key in pipe.autotune_kernels(repeat=1)]


def _port_keys(pipe, buckets=None) -> list:
    keys = []
    for kind, *cell in pipe._tune_cells(buckets):
        if kind == "worker":
            key = autotune.worker_key(*cell, device="cpu")
        else:
            m, k, n, relu = cell
            key = autotune.matmul_key(m, k, n, relu=relu, device="cpu")
        if key not in keys:
            keys.append(key)
    return keys


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_walk_visits_the_reference_cells(lenet_params, fused, monkeypatch):
    want = _ref_cells(lenet_params, fused, monkeypatch)
    got = [_untagged(k) for k in _port_keys(_port_pipe(lenet_params, fused))]
    assert got == want
    assert any(k[0] == "matmul" for k in got) == fused


def test_walk_visits_the_reference_cells_for_every_bucket(lenet_params,
                                                          monkeypatch):
    pipe = _port_pipe(lenet_params, True, buckets=(1, 2, 4))
    want = _ref_cells(lenet_params, True, monkeypatch, buckets=(1, 2, 4))
    assert [_untagged(k) for k in _port_keys(pipe)] == want
    # a bucket asked for alone: the reference's pipeline of that bucket
    want = _ref_cells(lenet_params, True, monkeypatch, buckets=(4,))
    assert [_untagged(k) for k in _port_keys(pipe, (4,))] == want


def test_walk_is_what_k1_and_k2_launch(lenet_params, monkeypatch):
    """The cells' shapes are those the kernel backend's wrappers are called
    with: a fused pass at the bucket launches every worker cell, every
    decode GEMM and the fastest-delta re-encode; the cluster's all-n
    re-encode is the walk's other width."""
    pipe = _port_pipe(lenet_params, True)
    seen = set()
    worker, matmul = fcdcc.coded_worker, ops.matmul

    def spy_worker(xe, ke, stride):
        seen.add(("worker", tuple(xe.shape), tuple(ke.shape), stride))
        return worker(xe, ke, stride)

    def spy_matmul(a, b, *, relu=False):
        seen.add(("matmul", a.shape[0], a.shape[1], b.shape[1], relu))
        return matmul(a, b, relu=relu)

    monkeypatch.setattr(fcdcc, "coded_worker", spy_worker)
    monkeypatch.setattr(ops, "matmul", spy_matmul)
    x = torch.as_tensor(RNG.standard_normal((2,) + pipe.input_shape),
                        dtype=torch.float32)
    pipe.run(x)
    cells = set(pipe._tune_cells())
    assert seen <= cells
    all_n = {pipe.encode_columns_all(i).shape[1]
             for i in range(1, len(pipe.specs))}
    assert all(c[0] == "matmul" and not c[4] and c[1] in all_n
               for c in cells - seen)


def test_autotune_kernels_without_a_card_is_empty(lenet_params, ledger):
    pipe = _port_pipe(lenet_params, True)
    assert pipe.autotune_kernels(repeat=1) == {}
    assert autotune.sweep_count() == 0
    assert not ledger.exists()


def test_autotune_kernels_off_the_kernel_backend_is_empty(lenet_params, ledger):
    pipe = build_cnn_pipeline(
        "lenet5", {k: torch.as_tensor(v) for k, v in lenet_params.items()}, 8,
        default_kab=(2, 4), backend="torch", device="cpu")
    assert pipe.autotune_kernels() == {}
    assert autotune.sweep_count() == 0
