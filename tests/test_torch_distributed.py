"""The port's execution over ``torch.distributed`` against the reference,
on the CPU with gloo: ranks spawned by ``launch.mesh.run_ranks`` with a
``FileStore`` under the test's temporary directory (no fixed port, so
parallel test workers never collide), each joined within ``RANK_TIMEOUT_S``
(well inside the suite's per-test watchdog, which reaches only this
process) and stopped if it hangs.  The rank bodies are in
``tests/_torch_ranks.py``; each spawn runs once a module and the tests
read its results.

Tolerances.  ``run_sharded`` sums the same fp32 products as the reference
in another order through one decode: within 1e-5 of max|ref|, the
reference's ``run_sharded`` (4 fake XLA host devices in a subprocess, as
``tests/test_fcdcc_e2e.py`` runs it) and its ``run_simulated``; every
rank's output equal.  The data-parallel train step averages two
half-batch gradients where the reference takes one full-batch gradient
(fp32 sums in another order): the loss within 1e-5 relative and every
param and moment leaf within 1e-4 of its max after 3 steps, FSDP on and
off.  With int8 compression the averaged gradient may round one
quantisation step (absmax/127) otherwise where fp32 rounding crosses a
rounding boundary, and Adam moves such an element by up to about the
learning rate either way, so besides 1e-4 of max|leaf| an element may
differ by twice the summed learning rates of the steps
(``int8_param_bound``); the losses stay within 1e-5.  DeepSeek-V2's MoE
over 2 ranks dispatches the reference's groups of the global tokens: one
layer within 1e-5 of max|ref| of the reference's on all the tokens (fp32
sums in another order; the capacity drops the same entries), and the
first step's loss and gradient norm within 1e-5 relative; a group that
would span the ranks is refused.  The train step over (data 2, model 2)
(tensor parallel, FSDP on) is held as the data-parallel one, and over
(pod 2, data 1, model 2) with int8 as the int8 run; RWKV6 over a model
axis is refused.  Checkpoints and tokens are held exactly.
"""
import dataclasses
import math
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as RefNamedSharding

import _torch_ranks as ranks
from repro import checkpoint as ref_ckpt
from repro.configs import get_bundle as ref_get_bundle
from repro.configs import smollm_135m as ref_smollm
from repro.launch import steps as ref_steps
from repro.launch.mesh import make_host_mesh as ref_host_mesh
from repro.models import moe as ref_moe
from repro.models.common import schema_pspecs as ref_schema_pspecs
from repro.models.common import schema_shardings as ref_schema_shardings
from repro.models.registry import make_lm_bundle as ref_make_lm_bundle
from repro.optim import init_state as ref_init_state
from repro.sharding import resolve_pspec as ref_resolve_pspec
from repro_torch.checkpoint import restore
from repro_torch.configs import ARCH_IDS, get_bundle
from repro_torch.core.fcdcc import CodedConv2d
from repro_torch.launch import steps
from repro_torch.launch.mesh import (Mesh, backend_for, make_process_mesh,
                                     run_ranks, use_mesh, active_mesh)
from repro_torch.launch.serve import serve, serve_lm
from repro_torch.launch.train import train
from repro_torch.models.common import params_from_numpy, schema_shardings
from repro_torch.models.moe import moe_ffn, moe_schema
from repro_torch.optim import init_state
from repro_torch.optim.schedule import cosine_with_warmup
from repro_torch.sharding import (BATCH, NamedSharding, hint_pspec,
                                  shard_hint, shard_tree)
from repro_torch.tree import tree_items, tree_leaves

TIMEOUT_S = int(os.environ.get("REPRO_TEST_TIMEOUT", "300"))
RANK_TIMEOUT_S = min(120, TIMEOUT_S // 2) if TIMEOUT_S > 0 else 120
REL_SHARDED, REL_LOSS, REL_LEAF = 1e-5, 1e-5, 1e-4


def spawn(fn, world, tmp, *args):
    return run_ranks(fn, world, *args, store_path=str(tmp / "store"),
                     device="cpu", timeout_s=RANK_TIMEOUT_S)


def _close(got, want, rel, extra=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if got.size else 0.0
    bound = rel * float(np.abs(want).max()) + extra
    assert err <= bound, f"max abs err {err} > {bound}"


# -- run_sharded ------------------------------------------------------------

REF_SHARDED = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.core import CodedConv2d, ConvGeometry, FcdccPlan
plan = FcdccPlan(n=4, k_a=2, k_b=4)
geo = ConvGeometry(3, 8, 12, 10, 3, 3, 1, 1, 2, 4)
mesh = jax.make_mesh((4,), ("workers",), axis_types=(jax.sharding.AxisType.Auto,))
cases = {cases!r}
out = {{}}
for label, ids, batch in cases:
    rng = np.random.default_rng(0)
    shape = (3, 12, 10) if batch is None else (batch, 3, 12, 10)
    x = rng.standard_normal(shape).astype(np.float32)
    k = rng.standard_normal((8, 3, 3, 3)).astype(np.float32)
    layer = CodedConv2d(plan, geo)
    out[label + "/sharded"] = np.asarray(layer.run_sharded(
        mesh, "workers", jnp.asarray(x), jnp.asarray(k), worker_ids=ids))
    out[label + "/simulated"] = np.asarray(layer.run_simulated(
        jnp.asarray(x), jnp.asarray(k), worker_ids=ids))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref_sharded(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref_sharded") / "out.npz"
    code = REF_SHARDED.format(cases=ranks.SHARDED_CASES)
    env = {**os.environ, "PYTHONPATH": "src"}
    res = subprocess.run([sys.executable, "-c", code, str(path)],
                         capture_output=True, text=True, env=env,
                         timeout=RANK_TIMEOUT_S)
    assert res.returncode == 0, res.stderr[-2000:]
    with np.load(path) as data:
        return dict(data)


@pytest.fixture(scope="module")
def four(tmp_path_factory, ref_weights):
    _, p = ref_weights
    return spawn(ranks.four_ranks, 4, tmp_path_factory.mktemp("four"), p)


CASES = [c[0] for c in ranks.SHARDED_CASES]


@pytest.mark.parametrize("label", CASES)
def test_run_sharded_matches_reference_run_sharded(four, ref_sharded, label):
    _close(four[0]["sharded"][label]["y"], ref_sharded[f"{label}/sharded"],
           REL_SHARDED)


@pytest.mark.parametrize("label", CASES)
def test_run_sharded_matches_reference_run_simulated(four, ref_sharded, label):
    _close(four[0]["sharded"][label]["y"], ref_sharded[f"{label}/simulated"],
           REL_SHARDED)
    _close(four[0]["sharded"][label]["y"],
           four[0]["sharded"][label]["simulated"], REL_SHARDED)


@pytest.mark.parametrize("label", CASES)
def test_run_sharded_is_replicated(four, label):
    y0 = torch.from_numpy(four[0]["sharded"][label]["y"])
    batch = dict((c[0], c[2]) for c in ranks.SHARDED_CASES)[label]
    assert tuple(y0.shape) == ((8, 12, 10) if batch is None
                               else (batch, 8, 12, 10))
    for r in four[1:]:
        assert torch.equal(torch.from_numpy(r["sharded"][label]["y"]), y0)


class _Shape:
    def __init__(self, shape):
        self.shape = shape


def test_run_sharded_needs_the_axis_to_hold_n_workers():
    layer = CodedConv2d(ranks.PLAN, ranks.GEO)
    x, k = (torch.from_numpy(a) for a in ranks.sharded_input(None))
    with pytest.raises(AssertionError):
        layer.run_sharded(_Shape({"workers": 2}), "workers", x, k)


# -- shard_hint ---------------------------------------------------------------

SITES = [s[0] for s in ranks.hint_sites()]


@pytest.mark.parametrize("mesh_name", list(ranks.HINT_MESHES))
@pytest.mark.parametrize("site", SITES)
def test_hint_resolves_as_the_reference(site, mesh_name):
    """The global shape (the local batch times pod x data) and its spec,
    against the reference's ``resolve_pspec`` on that shape."""
    _, shape, axes = next(s for s in ranks.hint_sites() if s[0] == site)
    axes = ranks.real_axes(axes)
    sizes, names = ranks.HINT_MESHES[mesh_name]
    mesh_shape = dict(zip(names, sizes))
    k = math.prod(mesh_shape.get(a, 1) for a in BATCH)
    glob = (shape[0] * k,) + shape[1:]
    got_shape, spec = hint_pspec(shape, axes, mesh_shape)
    assert got_shape == glob
    assert tuple(spec) == tuple(ref_resolve_pspec(glob, axes, mesh_shape))


def _expect_raise(site, mesh_name) -> bool:
    """Whether the reference places a non-batch dimension over an axis of
    more than one rank at this site and mesh."""
    _, shape, axes = next(s for s in ranks.hint_sites() if s[0] == site)
    axes = ranks.real_axes(axes)
    sizes, names = ranks.HINT_MESHES[mesh_name]
    mesh_shape = dict(zip(names, sizes))
    k = math.prod(mesh_shape.get(a, 1) for a in BATCH)
    spec = ref_resolve_pspec((shape[0] * k,) + shape[1:], axes, mesh_shape)
    for entry in tuple(spec)[1:]:
        entry = (entry,) if isinstance(entry, str) else (entry or ())
        if any(mesh_shape[a] > 1 for a in entry):
            return True
    return False


@pytest.mark.parametrize("mesh_name", list(ranks.HINT_MESHES))
def test_shard_hint_is_identity_or_raises_on_ranks(four, two, mesh_name):
    runs = [r for r in four + two if mesh_name in r["hints"]]
    assert len(runs) == math.prod(ranks.HINT_MESHES[mesh_name][0])
    for r in runs:
        got = r["hints"][mesh_name]
        for site in SITES:
            if _expect_raise(site, mesh_name):
                assert got[site].startswith("raised") and "3(c)" in got[site], \
                    (site, got[site])
            else:
                assert got[site] == "same", (site, got[site])
    if mesh_name == "data2-model2":  # the model-sharded sites raise there
        assert _expect_raise("moe.buf", mesh_name)
        assert _expect_raise("transformer._layer", mesh_name)


def test_shard_hint_without_a_mesh_is_identity():
    assert active_mesh() is None
    x = torch.zeros(2, 16, 64)
    assert shard_hint(x, BATCH, "model", None) is x


def test_shard_hint_on_one_process_meshes():
    x = torch.zeros(2, 16, 64)
    with use_mesh(Mesh(("data", "model"), (1, 1))):
        assert shard_hint(x, BATCH, "model", None) is x
    with use_mesh(Mesh(("data", "model"), (2, 1))):  # no rank holds a shard
        with pytest.raises(NotImplementedError, match=r"3\(c\)"):
            shard_hint(x, BATCH, None, None)
    assert active_mesh() is None


def test_models_run_under_the_hints(monkeypatch):
    """The transformer's forward (embed and, with the reference's flag,
    the sequence-parallel site) under a one-process mesh: the hints are
    the identity, the logits unchanged."""
    bundle = get_bundle("smollm-135m", smoke=True)
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, 256, (2, 8), generator=torch.Generator().manual_seed(1))
    want = bundle.prefill_fn(params, {"tokens": toks})
    monkeypatch.setenv("REPRO_SEQ_PARALLEL", "1")
    with use_mesh(Mesh(("data", "model"), (1, 1))):
        got = bundle.prefill_fn(params, {"tokens": toks})
    assert torch.equal(got, want)


# -- schema_shardings, shard_tree, gather_tree --------------------------------

MESH_SIZES = {"data2-model2": ((2, 2), ("data", "model")),
              "pod2-data2-model2": ((2, 2, 2), ("pod", "data", "model"))}


def _placement_spec(sh: NamedSharding, ndim: int) -> tuple:
    """The PartitionSpec that the placements say, dimension by dimension."""
    from torch.distributed.tensor import Shard

    out = []
    for d in range(ndim):
        axes = tuple(a for a, p in zip(sh.mesh.axis_names, sh.placements)
                     if isinstance(p, Shard) and p.dim == d)
        out.append(None if not axes else axes[0] if len(axes) == 1 else axes)
    return tuple(out)


@pytest.mark.parametrize("mesh_name", list(MESH_SIZES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_schema_shardings_equal_reference(arch, mesh_name):
    sizes, names = MESH_SIZES[mesh_name]
    schema = get_bundle(arch, smoke=True).schema
    ref = ref_schema_shardings(ref_get_bundle(arch, smoke=True).schema,
                               AbstractMesh(sizes, names))
    ref_items = jax.tree_util.tree_flatten_with_path(
        ref, is_leaf=lambda x: isinstance(x, RefNamedSharding))[0]
    got = tree_items(schema_shardings(schema, Mesh(names, sizes)))
    assert len(got) == len(ref_items)
    for ((_, sh), (_, rsh)), (_, spec) in zip(zip(got, ref_items),
                                             tree_items(schema)):
        assert tuple(sh.spec) == tuple(rsh.spec)
        assert _placement_spec(sh, len(spec.shape)) == tuple(
            rsh.spec) + (None,) * (len(spec.shape) - len(rsh.spec))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fsdp_placements_equal_reference_pspecs(arch):
    sizes, names = MESH_SIZES["pod2-data2-model2"]
    schema = get_bundle(arch, smoke=True).schema
    ref = ref_schema_pspecs(ref_get_bundle(arch, smoke=True).schema,
                            _Shape(dict(zip(names, sizes))), fsdp=True)
    ref_leaves = jax.tree.leaves(ref, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    got = tree_items(schema_shardings(schema, Mesh(names, sizes), fsdp=True))
    for (_, sh), rspec, (_, spec) in zip(got, ref_leaves, tree_items(schema)):
        assert _placement_spec(sh, len(spec.shape)) == tuple(rspec)


def test_shard_then_gather_is_exact_on_ranks(four):
    for r in four:
        rt = r["round_trip"]
        assert rt["equal"]
        assert rt["full_shapes"] == four[0]["round_trip"]["full_shapes"]
        cut = [k for k in rt["full_shapes"]
               if rt["local_shapes"][k] != rt["full_shapes"][k]]
        assert cut, "FSDP on (pod 2, data 2) cut no leaf"
        for key in cut:  # one dimension, by the pod x data degree of 4
            full, local = rt["full_shapes"][key], rt["local_shapes"][key]
            assert math.prod(full) == 4 * math.prod(local)


def test_shard_tree_needs_a_rank():
    mesh = Mesh(("data", "model"), (2, 1))
    sh = schema_shardings(get_bundle("smollm-135m", smoke=True).schema, mesh,
                          fsdp=True)
    full = get_bundle("smollm-135m", smoke=True).init(
        torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="process mesh"):
        shard_tree(full, sh)


def test_shard_tree_on_one_process_is_a_copy():
    mesh = Mesh(("data", "model"), (1, 1))
    bundle = get_bundle("smollm-135m", smoke=True)
    full = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    got = shard_tree(full, schema_shardings(bundle.schema, mesh, fsdp=True))
    for (_, a), (_, b) in zip(tree_items(got), tree_items(full)):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


# -- the train step, checkpoints, train and serve_lm over a mesh --------------


@pytest.fixture(scope="module")
def ref_weights():
    bundle = ref_smollm.smoke()
    p = jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(0), jnp.float32))
    return bundle, p


def _ref_run(bundle, p_np, mesh, tcfg):
    data = ranks._global_batches()
    fn, _, _ = ref_steps.build_train_step(bundle, mesh, tcfg)
    with jax.set_mesh(mesh):
        step = jax.jit(fn)
        params = jax.tree.map(jnp.asarray, p_np)
        opt = ref_init_state(params)
        losses = []
        for b in data:
            params, opt, met = step(params, opt,
                                    {k: jnp.asarray(v.numpy()) for k, v in b.items()})
            losses.append(float(met["loss"]))
    return losses, jax.tree.map(np.asarray, {"params": params, "opt": opt})


def _ref_pod_mesh():
    """The reference's one-device (pod 1, data 1, model 1) mesh, its axes
    Auto as its host mesh's."""
    return jax.make_mesh((1, 1, 1), ("pod", "data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)


@pytest.fixture(scope="module")
def ref_runs(ref_weights):
    bundle, p = ref_weights
    kw = ranks.TRAIN_KW
    pod_mesh = _ref_pod_mesh()
    return {"fsdp": _ref_run(bundle, p, ref_host_mesh(),
                             ref_steps.TrainConfig(fsdp=True, **kw)),
            "replicated": _ref_run(bundle, p, ref_host_mesh(),
                                   ref_steps.TrainConfig(fsdp=False, **kw)),
            "int8": _ref_run(bundle, p, pod_mesh, ref_steps.TrainConfig(
                grad_compression="int8", **kw))}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory, ref_weights):
    root = tmp_path_factory.mktemp("two")
    _, p = ref_weights
    ref_ckpt.save(str(root / "ref"), 0, {"params": p, "opt": jax.tree.map(
        np.asarray, ref_init_state(jax.tree.map(jnp.asarray, p)))})
    return root


def _ref_moe_config(groups: int):
    cfg = ref_get_bundle(ranks.MOE_ARCH, smoke=True).cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch_groups=groups))


@pytest.fixture(scope="module")
def moe_case():
    """One MoE layer's weights and ``MOE_TOKENS`` tokens drawn with numpy,
    and the reference LM's weights with 2 dispatch groups: the ranks'
    inputs; the reference's layer outputs and first-step loss and
    gradient norm on all the tokens."""
    rng = np.random.default_rng(0)
    cfg = ranks.moe_config(1).moe
    w = {k: (rng.standard_normal(s.shape) / np.sqrt(s.shape[-2])).astype(
        np.float32) if not isinstance(s, dict) else
        {kk: (rng.standard_normal(ss.shape) / np.sqrt(ss.shape[-2])).astype(
            np.float32) for kk, ss in s.items()}
        for k, s in moe_schema(cfg).items()}
    x = rng.standard_normal((ranks.MOE_TOKENS, cfg.d_model)).astype(np.float32)
    wj = jax.tree.map(jnp.asarray, w)
    ys = {f"groups-{g}": np.asarray(ref_moe.moe_ffn(
        wj, jnp.asarray(x), _ref_moe_config(g).moe)) for g in ranks.MOE_GROUPS}
    rb = ref_make_lm_bundle(_ref_moe_config(2))
    p = jax.tree.map(np.asarray, rb.init(jax.random.PRNGKey(0), jnp.float32))
    batch = {k: jnp.asarray(v.numpy()) for k, v in ranks.moe_batch().items()}
    loss, g = jax.jit(jax.value_and_grad(rb.loss_fn))(
        jax.tree.map(jnp.asarray, p), batch)
    norm = math.sqrt(sum(float(jnp.sum(jnp.square(l))) for l in jax.tree.leaves(g)))
    return {"inputs": {"w": w, "x": x, "params": p}, "y": ys,
            "loss": float(loss), "grad_norm": norm}


@pytest.fixture(scope="module")
def two(dirs, ref_weights, moe_case):
    _, p = ref_weights
    return spawn(ranks.two_ranks, 2, dirs, p, str(dirs / "ref"),
                 str(dirs / "fsdp"), str(dirs / "train"), moe_case["inputs"])


# int8 leaves beyond REL_LEAF: the rounding flips of the quantised
# gradient, a handful of elements (one or two a run at the tests' size)
INT8_FLIP_FRACTION = 0.01


def _close_int8(name, got, want):
    """A compressed run's leaf: within ``REL_LEAF`` of its max but where
    the quantised gradient rounded one step otherwise, at most
    ``INT8_FLIP_FRACTION`` of its elements.  Those are held to the
    quantisation step: a param to ``int8_param_bound``; a moment to one
    step (1/127 of the gradient's absmax) a train step, through m's
    (1 - b1) and v's (1 - b2) * 2|g|, at most 2/127 of the moment leaf's
    max a step."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    err = np.abs(got - want)
    flips = float(np.mean(err > REL_LEAF * scale))
    assert flips <= INT8_FLIP_FRACTION, f"{name}: {flips:.2%} beyond {REL_LEAF}"
    extra = (int8_param_bound() if name == "params"
             else 2.0 * ranks.TRAIN_STEPS / 127 * scale)
    _close(got, want, REL_LEAF, extra)


def int8_param_bound() -> float:
    """Twice the learning rates the run's steps applied (step 1's is 0)."""
    tcfg = steps.TrainConfig(**ranks.TRAIN_KW)
    return 2 * sum(tcfg.opt.lr * float(cosine_with_warmup(
        torch.tensor(s), warmup=tcfg.warmup, total=tcfg.total_steps))
        for s in range(ranks.TRAIN_STEPS))


@pytest.mark.parametrize("run", ["fsdp", "replicated", "int8"])
def test_data_parallel_losses_match_reference(two, ref_runs, run):
    want, _ = ref_runs[run]
    for r in two:
        _close(r[run]["losses"], want, REL_LOSS)
        assert r[run]["losses"] == two[0][run]["losses"]


@pytest.mark.parametrize("run", ["fsdp", "replicated", "int8"])
def test_data_parallel_state_matches_reference(two, ref_runs, run):
    _, want = ref_runs[run]
    got = two[0][run]["full"]
    assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == ranks.TRAIN_STEPS
    for name, tree, ref in (("params", got["params"], want["params"]),
                            ("m", got["opt"]["m"], want["opt"]["m"]),
                            ("v", got["opt"]["v"], want["opt"]["v"])):
        ref_leaves = jax.tree.leaves(ref)
        assert len(tree_leaves(tree)) == len(ref_leaves)
        for g, w in zip(tree_leaves(tree), ref_leaves):
            if run == "int8":
                _close_int8(name, g, w)
            else:
                _close(g, w, REL_LEAF)
    for r in two[1:]:  # the gathered state is the same on every rank
        for a, b in zip(tree_leaves(r[run]["full"]), tree_leaves(got)):
            assert np.array_equal(a, b)


def test_int8_compression_applies_across_the_pod(two):
    """Compression changes the step: the compressed losses differ from the
    uncompressed run's after the first update."""
    assert two[0]["int8"]["losses"][0] == pytest.approx(
        two[0]["fsdp"]["losses"][0], rel=REL_LOSS)
    assert two[0]["int8"]["losses"][2] != two[0]["fsdp"]["losses"][2]


def test_fsdp_holds_shards(two):
    shapes = two[0]["fsdp"]["local_shapes"]
    full = {"/".join(p): tuple(a.shape)
            for p, a in tree_items(two[0]["fsdp"]["full"]["params"])}
    cut = [k for k in full if shapes[k] != full[k]]
    whole = [k for k in full if shapes[k] == full[k]]
    assert cut and whole  # stacked layer weights cut, embeddings whole
    for k in cut:
        assert math.prod(full[k]) == 2 * math.prod(shapes[k])


def test_data_parallel_step_refuses_capture(two):
    assert "3(c)" in two[0]["captured"]


def test_train_step_over_a_model_axis_matches_reference(four, ref_runs):
    """SmolLM smoke over (data 2, model 2), FSDP on (3 query heads of 16
    cut at 24 columns: inside a head): the losses and the gathered state
    after 3 steps against the reference's one-device step."""
    want_losses, want = ref_runs["fsdp"]
    for r in four:
        _close(r["model_axis"]["losses"], want_losses, REL_LOSS)
    got = four[0]["model_axis"]["full"]
    for tree, ref in ((got["params"], want["params"]),
                      (got["opt"]["m"], want["opt"]["m"]),
                      (got["opt"]["v"], want["opt"]["v"])):
        ref_leaves = jax.tree.leaves(ref)
        assert len(tree_leaves(tree)) == len(ref_leaves)
        for g, w in zip(tree_leaves(tree), ref_leaves):
            _close(g, w, REL_LEAF)


def test_int8_step_over_pod_and_model_matches_reference(four, ref_runs):
    """int8 compression across the pod beside a model axis of 2: each
    leaf's gradient gathered over model and compressed whole, as the
    reference compresses it; held as the (pod 2, data 1) run."""
    want_losses, want = ref_runs["int8"]
    for r in four:
        _close(r["int8_model_axis"]["losses"], want_losses, REL_LOSS)
    got = four[0]["int8_model_axis"]["full"]
    for name, tree, ref in (("params", got["params"], want["params"]),
                            ("m", got["opt"]["m"], want["opt"]["m"]),
                            ("v", got["opt"]["v"], want["opt"]["v"])):
        for g, w in zip(tree_leaves(tree), jax.tree.leaves(ref)):
            _close_int8(name, g, w)


def test_train_step_refuses_rwkv6_over_a_model_axis(four):
    """RWKV6 of 3 heads over (data 2, model 2): no longer refused, its
    columns cut inside a head and every head scanned on every rank.  The
    step's loss and gradient norm equal one process's step on the whole
    batch (the same seeded params) within ``REL_LOSS``."""
    from repro_torch.models.registry import make_rwkv_bundle

    rwkv = make_rwkv_bundle(ranks.rwkv48_config())
    step = steps.build_train_step(rwkv, steps.TrainConfig(**ranks.TRAIN_KW))
    params = rwkv.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.zeros((4, 8), dtype=torch.long)
    _, _, met = step(params, init_state(params),
                     {"tokens": toks, "labels": toks})
    for r in four:
        assert r["rwkv6_model_axis"] == "ran", r["rwkv6_model_axis"]
        _close(r["rwkv6_model_axis_loss"], float(met["loss"]), REL_LOSS)
        _close(r["rwkv6_model_axis_norm"], float(met["grad_norm"]), REL_LOSS)


def test_fsdp_checkpoint_restores_on_two_ranks(two):
    assert all(r["restored_equal"] for r in two)


def test_fsdp_checkpoint_restores_in_one_process(two, dirs):
    full = two[0]["fsdp"]["full"]
    got = restore(str(dirs / "fsdp"), ranks.TRAIN_STEPS, _blank(_t(full)))
    for (_, a), (_, b) in zip(tree_items(got), tree_items(_t(full))):
        assert torch.equal(a, b)


def test_reference_checkpoint_restores_into_shards(two):
    assert all(r["ref_restored_equal"] for r in two)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree))


def _blank(tree):
    if isinstance(tree, dict):
        return {k: _blank(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def test_train_over_a_mesh_matches_one_process(two):
    want = train("smollm-135m", steps=4, batch=ranks.TRAIN_BATCH,
                 seq=ranks.TRAIN_SEQ, smoke=True, device="cpu", log_every=100)
    for r in two:
        _close(r["train"], want, REL_LOSS)


def test_train_over_a_mesh_checkpoints_full_leaves(two, dirs):
    d = dirs / "train"
    assert sorted(os.listdir(d)) == ["step-00000002", "step-00000004"]
    bundle = get_bundle("smollm-135m", smoke=True)
    like = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    state = restore(str(d), 4, {"params": like, "opt": init_state(like)})
    assert int(state["opt"]["step"]) == 4
    assert all(torch.isfinite(t).all() for t in tree_leaves(state))


def test_serve_lm_over_a_mesh_equals_one_process(two):
    want = serve_lm("smollm-135m", smoke=True, device="cpu", **ranks.SERVE)
    for r in two:
        assert torch.equal(torch.from_numpy(r["serve"]), want)


@pytest.mark.parametrize("groups", ranks.MOE_GROUPS)
def test_moe_over_a_mesh_matches_reference(two, moe_case, groups):
    """Each rank dispatches the reference's groups of the global tokens
    that its rows make up, at the reference's capacity."""
    label = f"groups-{groups}"
    got = np.concatenate([r["moe"][label] for r in two])
    want = moe_case["y"][label]
    _close(got, want, REL_SHARDED)
    # grouping a rank's tokens alone (the reference's groups of T/2
    # tokens, not of T) drops other entries: the check tells them apart
    half = moe_ffn(params_from_numpy(moe_case["inputs"]["w"], "cpu"),
                   torch.from_numpy(moe_case["inputs"]["x"]).chunk(2)[0],
                   ranks.moe_config(groups).moe).numpy()
    n = half.shape[0]
    assert np.abs(half - want[:n]).max() > REL_SHARDED * np.abs(want).max()


def test_moe_data_parallel_step_matches_reference(two, moe_case):
    """The first data-parallel step of DeepSeek-V2 with 2 dispatch groups:
    its loss and gradient norm against the reference's full batch."""
    for r in two:
        _close(r["moe"]["loss"], moe_case["loss"], REL_LOSS)
        _close(r["moe"]["grad_norm"], moe_case["grad_norm"], REL_LOSS)


def test_moe_group_spanning_ranks_is_refused(two):
    """The smoke's one dispatch group spans both data ranks: no longer
    refused, each rank gathers the group's rows and dispatches it as one
    device does.  The step's loss and gradient norm equal one process's
    step on the whole batch (the same seeded params) within
    ``REL_LOSS``."""
    bundle = get_bundle(ranks.MOE_ARCH, smoke=True)
    step = steps.build_train_step(bundle, steps.TrainConfig(**ranks.TRAIN_KW))
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    _, _, met = step(params, init_state(params), ranks.moe_batch())
    for r in two:
        assert r["moe"]["one_group"] == "ran", r["moe"]["one_group"]
        _close(r["moe"]["one_group_loss"], float(met["loss"]), REL_LOSS)
        _close(r["moe"]["one_group_norm"], float(met["grad_norm"]), REL_LOSS)


def test_serve_refuses_a_mesh_for_a_cnn():
    with pytest.raises(ValueError, match="mesh"):
        serve("lenet5", batch=1, prompt_len=0, gen=0, device="cpu",
              mesh=Mesh(("data",), (1,)))


# -- compression without a pod axis, meshes, backends, failing ranks ----------


def test_compression_warns_only_without_a_pod_axis(ref_weights, ref_runs):
    """No mesh or a mesh without ``pod``: the warning, and the step is the
    uncompressed one.  A one-process mesh with ``pod``: no warning, and
    the step compresses, as the reference's on its (1, 1, 1) mesh."""
    bundle, p = ref_weights
    tcfg = steps.TrainConfig(grad_compression="int8", **ranks.TRAIN_KW)
    port = get_bundle("smollm-135m", smoke=True)
    for mesh in (None, Mesh(("data", "model"), (1, 1))):
        with pytest.warns(UserWarning, match="'int8' does not apply"):
            steps.build_train_step(port, tcfg, mesh)
    pod = Mesh(("pod", "data", "model"), (1, 1, 1))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        step = steps.build_train_step(port, tcfg, pod)
    params = params_from_numpy(p, "cpu")
    opt = init_state(params)
    losses = []
    for b in ranks._global_batches():
        params, opt, met = step(params, opt, b)
        losses.append(float(met["loss"]))
    want, ref = ref_runs["int8"]
    _close(losses, want, REL_LOSS)
    for g, w in zip(tree_leaves(params), jax.tree.leaves(ref["params"])):
        _close_int8("params", g.numpy(), w)


def test_make_process_mesh_asks_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the CPU-only refusal does not apply")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_process_mesh((1,), ("data",))


def test_backend_rule():
    assert backend_for("cpu", 1) == "gloo"
    assert backend_for("cpu", 4) == "gloo"
    cards = torch.cuda.device_count()
    assert backend_for("cuda", cards + 1) == "gloo"  # ranks share a card
    if cards:
        assert backend_for("cuda", cards) == "nccl"


def test_run_ranks_raises_for_a_failing_rank(tmp_path):
    with pytest.raises(RuntimeError, match="planted failure on rank 1"):
        spawn(ranks.failing, 2, tmp_path)


def test_run_ranks_stops_a_hung_rank(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 did not finish"):
        run_ranks(ranks.hanging, 2, store_path=str(tmp_path / "store"),
                  device="cpu", timeout_s=4)
