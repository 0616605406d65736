"""The port's sharding specs against the reference's, on the CPU.

``repro_torch.sharding``, ``launch/mesh.py``, the schema half of
``models/common.py``, each family's schema, the bundles' ``param_shapes``
/ ``cache_axes`` / ``batch_axes``, ``launch/steps.py``'s
``batch_pspecs`` / ``cache_pspecs`` / ``opt_state_pspecs`` /
``make_opt_shapes`` and ``configs/shapes.py`` are pure functions of
shapes, so the port's answers equal the reference's exactly: parameter
counts, PartitionSpecs leaf by leaf (the reference's ``P`` compares equal
to the tuple of its entries, the port's is that tuple), and shapes and
dtypes.  The reference's ``spec_to_pspec`` reads only ``mesh.shape``, so
it is given an object with that dict for the production meshes, which no
host here holds.

Draws from the schema are held bit for bit to the draws before the
schema replaced the port's shapes trees: a digest of every leaf of each
arch's smoke params at seed 0, taken from those draws.
"""
import hashlib
import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RefP

from repro.configs import get_bundle as ref_get_bundle
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.configs.shapes import batch_structs as ref_batch_structs
from repro.launch import steps as ref_steps
from repro.models.common import count_params as ref_count_params
from repro.models.common import schema_pspecs as ref_schema_pspecs
from repro.sharding import resolve_pspec as ref_resolve_pspec
from repro_torch import devices
from repro_torch.configs import ARCH_IDS, get_bundle
from repro_torch.configs.shapes import SHAPES, Cell, batch_structs, token_struct
from repro_torch.launch import steps
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     make_worker_mesh)
from repro_torch.models.common import (ParamSpec, count_params, schema_pspecs,
                                       schema_shapes, spec_to_pspec)
from repro_torch.sharding import (BATCH, PartitionSpec, resolve_pspec,
                                   worker_devices)
from repro_torch.tree import tree_items

P = PartitionSpec

MESH = {"data": 16, "model": 16}
MESH3 = {"pod": 2, "data": 16, "model": 16}
MESHES = {"pod": False, "multipod": True}

# sha256 (first 24 hex digits) over every leaf's key path and fp32 bytes,
# in sorted-key order, of get_bundle(arch, smoke=True).init(
# torch.Generator().manual_seed(0), device="cpu") drawn from the shapes
# trees the schema replaced
DRAW_DIGESTS = {
    "deepseek-v3-671b": "c434840078de110ad5232ae9",
    "deepseek-v2-236b": "0bfe298997c79558af4d86a2",
    "codeqwen1.5-7b": "889d24a5bf02ba4afb3369f4",
    "smollm-135m": "f65ce0b10348e5fbde2536e8",
    "gemma2-9b": "dd4089a92320f5b17d2a56af",
    "qwen3-4b": "77d8dcac68cf6d474fbb5e12",
    "hymba-1.5b": "61783805aa45572ecf35f252",
    "whisper-medium": "4020acca542cdb62eeb47e2a",
    "rwkv6-1.6b": "610dfcf87a3409f5de6eb79e",
    "paligemma-3b": "42b24afb97e4f919284cea9c",
}


class _MeshShape:
    """What the reference's ``spec_to_pspec`` and ``batch_pspecs`` read of
    a mesh: its ``shape`` dict."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _ref_items(tree) -> list:
    """``[(key path, leaf)]`` of a reference tree, PartitionSpecs and
    ParamSpecs as leaves, in the order ``tree_items`` gives the port's."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, RefP))
    return [(tuple(k.key for k in path), leaf) for path, leaf in flat]


def _pspecs(tree) -> list:
    return [(path, tuple(p)) for path, p in tree_items(tree)]


def _ref_pspecs(tree) -> list:
    return [(path, tuple(p)) for path, p in _ref_items(tree)]


def _cells():
    """Every (arch, shape) cell but long_500k for the archs that are not
    sub-quadratic: the reference dry run's ``cell_skip_reason``
    (``src/repro/launch/dryrun.py``), restated, since importing that
    module sets the process's XLA flags."""
    out = []
    for arch in ARCH_IDS:
        sub_quadratic = get_bundle(arch).sub_quadratic
        for shape in SHAPES:
            if shape == "long_500k" and not sub_quadratic:
                continue
            out.append((arch, shape))
    return out


# -- resolve_pspec ----------------------------------------------------------
def test_resolve_reference_cases():
    """The reference's own cases (``tests/test_sharding_and_analysis.py``)."""
    assert resolve_pspec((256, 4096), (BATCH, None), MESH) == P("data", None)
    assert resolve_pspec((256, 4096), (BATCH, None), MESH3) == \
        P(("pod", "data"), None)
    assert resolve_pspec((30, 9, 64), (None, "model", None), MESH) == \
        P(None, None, None)
    assert resolve_pspec((30, 576), (None, "model"), MESH) == P(None, "model")
    assert resolve_pspec((32, 32), ("model", "model"), MESH) == P("model", None)
    assert resolve_pspec((8,), (("model",),), MESH) == P(None)
    assert isinstance(P("model"), tuple) and P("model") == ("model",)
    assert repr(P(None, "model")) == "PartitionSpec(None, 'model')"


def test_resolve_seeded_sweep_equals_reference():
    rng = np.random.default_rng(0)
    dims = [1, 2, 3, 8, 9, 16, 24, 32, 48, 64, 256, 576, 4096]
    cands = [None, "data", "model", "pod", "workers", BATCH, ("data", "model"),
             ("model",), ("pod", "model"), ("model", "data")]
    meshes = [MESH, MESH3, {"workers": 4}, {"data": 2, "model": 3}]
    for _ in range(600):
        rank = int(rng.integers(1, 5))
        shape = tuple(int(rng.choice(dims)) for _ in range(rank))
        axes = tuple(cands[int(rng.integers(len(cands)))] for _ in range(rank))
        mesh = meshes[int(rng.integers(len(meshes)))]
        assert tuple(resolve_pspec(shape, axes, mesh)) == \
            tuple(ref_resolve_pspec(shape, axes, mesh)), (shape, axes, mesh)


# -- meshes and the worker round-robin --------------------------------------
def test_meshes():
    pod, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert pod.shape == MESH and pod.devices is None
    assert multi.shape == MESH3 and multi.axis_names == ("pod", "data", "model")
    host = make_host_mesh("cpu")
    assert host.shape == {"data": 1, "model": 1}
    assert host.devices.shape == (1, 1) and host.devices[0, 0] == torch.device("cpu")
    w = make_worker_mesh(4, ["cpu", "meta", "cpu", "meta", "cpu"])
    assert w.shape == {"workers": 4}  # capped at n
    assert list(w.devices.flat) == [torch.device(d) for d in
                                    ("cpu", "meta", "cpu", "meta")]
    with pytest.raises(ValueError, match="n >= 1"):
        make_worker_mesh(0, ["cpu"])
    with pytest.raises(ValueError, match="empty"):
        make_worker_mesh(2, [])


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_worker_devices_one_round_robin(n):
    """``devices.worker_devices`` is the worker mesh's round-robin, for n
    below, equal to and above the device count (3)."""
    devs = ["cpu", "meta", "cpu"]
    want = [torch.device(devs[i % min(n, 3)]) for i in range(n)]
    assert devices.worker_devices(n, devs) == want
    assert worker_devices(make_worker_mesh(n, devs), n) == want


def test_worker_devices_need_a_card_or_a_list(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        devices.worker_devices(2)


# -- the param schemas ------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_count_params_equals_reference_at_full_config(arch):
    schema, ref_schema = get_bundle(arch).schema, ref_get_bundle(arch).schema
    assert count_params(schema) == ref_count_params(ref_schema)
    leaves, ref_leaves = tree_items(schema), _ref_items(ref_schema)
    assert [p for p, _ in leaves] == [p for p, _ in ref_leaves]
    for (path, s), (_, r) in zip(leaves, ref_leaves):
        assert (s.shape, s.axes, s.scale) == (r.shape, r.axes, r.scale), path


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_schema_pspecs_equal_reference(arch, mesh, fsdp):
    m = make_production_mesh(multi_pod=MESHES[mesh])
    got = schema_pspecs(get_bundle(arch).schema, m, fsdp)
    want = ref_schema_pspecs(ref_get_bundle(arch).schema, _MeshShape(m.shape),
                             fsdp)
    assert _pspecs(got) == _ref_pspecs(want)


def test_spec_to_pspec_rules():
    mesh = make_production_mesh(multi_pod=True)
    # 9 heads do not divide model = 16: replicated
    assert spec_to_pspec(ParamSpec((576, 9), ("embed", "heads")), mesh) == \
        P(None, None)
    # the first model-sharded axis that divides takes model, once
    assert spec_to_pspec(ParamSpec((64, 32), ("ff", "heads")), mesh) == \
        P("model", None)
    # FSDP: stacked weights only, the largest free dimension over pod+data
    w = ParamSpec((30, 576, 1536), (None, "embed", "ff"))
    assert spec_to_pspec(w, mesh, fsdp=True) == P(None, ("pod", "data"), "model")
    assert spec_to_pspec(ParamSpec((576, 1536), ("embed", "ff")), mesh,
                         fsdp=True) == P(None, "model")
    with pytest.raises(ValueError):
        ParamSpec((2, 3), ("embed",))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shapes_are_meta_tensors_of_the_schema(arch):
    bundle = get_bundle(arch)
    got = tree_items(bundle.param_shapes(torch.bfloat16))
    want = _ref_items(ref_get_bundle(arch).param_shapes())
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, t), (_, r) in zip(got, want):
        assert t.device.type == "meta" and t.dtype == torch.bfloat16, path
        assert tuple(t.shape) == tuple(r.shape) and str(r.dtype) == "bfloat16"
    assert tree_items(schema_shapes(bundle.schema))[0][1].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_schema_draws_unchanged(arch):
    """The smoke params drawn from the schema at seed 0 are bit for bit
    the draws from the shapes trees it replaced."""
    params = get_bundle(arch, smoke=True).init(torch.Generator().manual_seed(0),
                                               device="cpu")
    h = hashlib.sha256()
    for path, leaf in tree_items(params):
        h.update("/".join(path).encode())
        h.update(leaf.contiguous().numpy().tobytes())
    assert h.hexdigest()[:24] == DRAW_DIGESTS[arch]


# -- the cells: batch, cache and optimizer specs ------------------------------
def test_shapes_table_equals_reference():
    assert SHAPES == REF_SHAPES
    assert Cell("smollm-135m", "decode_32k").kind == "decode"
    t = token_struct(2, 16)
    assert t.device.type == "meta" and t.dtype == torch.int32


@pytest.mark.parametrize("arch,shape", _cells())
def test_cell_pspecs_equal_reference(arch, shape):
    """A cell's batch and cache, built on meta tensors with no allocation,
    have the reference's shapes and dtypes, and resolve to its
    PartitionSpecs on both production meshes."""
    bundle, ref = get_bundle(arch), ref_get_bundle(arch)
    batch, cache = batch_structs(bundle, shape)
    ref_batch, ref_cache = ref_batch_structs(ref, shape)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in batch.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in ref_batch.items()}
    assert (cache is None) == (ref_cache is None)
    if cache is not None:
        got = [(p, tuple(t.shape), str(t.dtype).removeprefix("torch."), t.device.type)
               for p, t in tree_items(cache)]
        want = [(p, tuple(t.shape), str(t.dtype), "meta")
                for p, t in _ref_items(ref_cache)]
        assert got == want
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        ms = _MeshShape(mesh.shape)
        got = steps.batch_pspecs(bundle, batch, mesh)
        want = ref_steps.batch_pspecs(ref, ref_batch, ms)
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}
        if cache is not None:
            assert _pspecs(steps.cache_pspecs(bundle, cache, mesh)) == \
                _ref_pspecs(ref_steps.cache_pspecs(ref, ref_cache, ms))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_opt_state_specs_equal_reference(arch):
    bundle, ref = get_bundle(arch), ref_get_bundle(arch)
    got = tree_items(steps.make_opt_shapes(bundle, torch.bfloat16))
    want = _ref_items(ref_steps.make_opt_shapes(ref))
    assert [(p, tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for p, t in got] == [(p, tuple(t.shape), str(t.dtype))
                                 for p, t in want]
    assert all(t.device.type == "meta" for _, t in got)
    mesh = make_production_mesh(multi_pod=True)
    pspecs = schema_pspecs(bundle.schema, mesh, fsdp=True)
    ref_ps = ref_schema_pspecs(ref.schema, _MeshShape(mesh.shape), True)
    assert _pspecs(steps.opt_state_pspecs(pspecs)) == \
        _ref_pspecs(ref_steps.opt_state_pspecs(ref_ps))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_make_cache_runs_on_meta(arch):
    """Every family's cache at the largest decode cell, on the meta device:
    no storage, no host sync, the reference's shapes."""
    bundle = get_bundle(arch)
    cache = bundle.make_cache(128, 32768, torch.float32, "meta")
    assert all(t.device.type == "meta" for _, t in tree_items(cache))
    assert all(isinstance(p, PartitionSpec) for _, p in tree_items(
        steps.cache_pspecs(bundle, cache, make_production_mesh())))


def test_cells_cover_the_reference_dry_run():
    """The cell list skips exactly the full-attention archs' long_500k."""
    cells = _cells()
    skipped = set(itertools.product(ARCH_IDS, SHAPES)) - set(cells)
    assert skipped == {(a, "long_500k") for a in ARCH_IDS
                       if not ref_get_bundle(a).sub_quadratic}
