"""The port's training path against the reference's, on the same weights
(the reference's ``bundle.init``, carried across as numpy) and the same
batches: ``lm_loss`` and its gradient on all three attention routes, the
train step over several steps from one carried state, microbatches and
remat, checkpoints across the two packages, and the ``train`` entry point.

Tolerances (fp32, sums in another order): the loss within 1e-5 relative;
every gradient leaf within 1e-5 of its max|g|; after 5 train steps the
losses within 1e-5 relative and every param and moment leaf within 1e-5
of its max (the schedule's lr is small, Adam normalises the gradient, so
a step moves a param by at most lr: an fp32 difference in a gradient
moves it by far less).  Microbatches against the full batch and against
the reference's microbatched step are held to the same 1e-5, the
accumulated gradient included.  Checkpoints restore bit for bit.
"""
import dataclasses
import json
import os
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as ref_ckpt
from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_bundle as ref_get_bundle
from repro.configs import smollm_135m as ref_smollm
from repro.launch import steps as ref_steps
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as ref_lm
from repro.optim import init_state as ref_init_state
from repro_torch import checkpoint as ckpt
from repro_torch.configs import ARCH_IDS, get_bundle, smollm_135m
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.launch import steps, train as train_mod
from repro_torch.launch.mesh import Mesh
from repro_torch.sharding import NamedSharding
from repro_torch.sharding import PartitionSpec
from repro_torch.launch.train import train
from repro_torch.models import registry
from repro_torch.models import transformer as lm
from repro_torch.optim import init_state
from repro_torch.tree import tree_leaves, tree_map

REL = 1e-5


def _close(got, want, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max abs err {err} > {rel} * {scale}"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.fixture(scope="module")
def ref_params():
    bundle = ref_smollm.smoke()
    return bundle, _np(bundle.init(jax.random.PRNGKey(0), jnp.float32))


# (label, flash_chunk, flash_block_skip, seq, prefix length): the plain
# masked route (S <= flash_chunk), the rectangle scan, and the triangle
# scan over 8 prefix embeddings and 24 tokens
ROUTES = [("plain", 1024, True, 16, 0), ("rectangle", 8, False, 32, 0),
          ("triangle-prefix", 8, True, 24, 8)]


@pytest.mark.parametrize("label,chunk,skip,seq,pre", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_lm_loss_and_grads_match_reference(ref_params, label, chunk, skip, seq,
                                           pre):
    bundle, p_np = ref_params
    cfg_r = dataclasses.replace(bundle.cfg, flash_chunk=chunk, flash_block_skip=skip)
    cfg = dataclasses.replace(smollm_135m.smoke(), flash_chunk=chunk,
                              flash_block_skip=skip)
    rng = np.random.default_rng(seq + pre)
    toks = rng.integers(0, cfg.vocab, (2, seq)).astype(np.int32)
    tgts = rng.integers(0, cfg.vocab, (2, seq)).astype(np.int32)
    prefix = (rng.standard_normal((2, pre, cfg.d_model)).astype(np.float32)
              if pre else None)
    loss_r, g_r = jax.jit(jax.value_and_grad(ref_lm.lm_loss), static_argnums=1)(
        jax.tree.map(jnp.asarray, p_np), cfg_r, jnp.asarray(toks),
        jnp.asarray(tgts), None if prefix is None else jnp.asarray(prefix))
    port = lm.lm_params_from_numpy(p_np, "cpu")
    loss, g = steps.value_and_grad(
        lambda p, b: lm.lm_loss(p, cfg, b["tokens"], b["labels"], b.get("prefix")),
        port, {"tokens": _t(toks), "labels": _t(tgts),
               **({"prefix": _t(prefix)} if pre else {})})
    _close(float(loss), float(loss_r))
    leaves_r = jax.tree.leaves(g_r)
    assert len(tree_leaves(g)) == len(leaves_r)
    for got, want in zip(tree_leaves(g), leaves_r):
        assert torch.isfinite(got).all()
        _close(got.numpy(), np.asarray(want))


def test_forward_with_prefix_matches_reference_on_both_routes(ref_params):
    """``forward(prefix_embeds=)``: the serving route (K4's plain version on
    the CPU) and the training route give the reference's logits."""
    bundle, p_np = ref_params
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 256, (2, 6)).astype(np.int32)
    prefix = rng.standard_normal((2, 3, 48)).astype(np.float32)
    want = ref_lm.forward(jax.tree.map(jnp.asarray, p_np), bundle.cfg,
                          jnp.asarray(toks), jnp.asarray(prefix))
    port = lm.lm_params_from_numpy(p_np, "cpu")
    for autograd in (False, True):
        got = lm.forward(port, smollm_135m.smoke(), _t(toks), _t(prefix),
                         autograd=autograd)
        assert got.shape == (2, 9, 256)
        _close(got.detach().numpy(), np.asarray(want))


def _ref_step(bundle, tcfg):
    fn, _, _ = ref_steps.build_train_step(bundle, make_host_mesh(), tcfg)
    return jax.jit(fn)


def test_train_step_matches_reference_over_5_steps(ref_params):
    """Five steps from one carried state (the reference's params and its
    AdamW state, as numpy), on the same synthetic batches."""
    bundle, p_np = ref_params
    mesh = make_host_mesh()
    tkw = dict(warmup=2, total_steps=5)
    data = SyntheticTokens(DataConfig(vocab=256, seq_len=16, global_batch=4))
    with jax.set_mesh(mesh):
        step_r = _ref_step(bundle, ref_steps.TrainConfig(fsdp=False, **tkw))
        params_r = jax.tree.map(jnp.asarray, p_np)
        opt_r = ref_init_state(params_r)
        opt_np = _np(opt_r)
        losses_r = []
        for s in range(5):
            b = {k: jnp.asarray(v) for k, v in data.batch(s).items()}
            params_r, opt_r, met = step_r(params_r, opt_r, b)
            losses_r.append(float(met["loss"]))
    step_fn = steps.build_train_step(get_bundle("smollm-135m", smoke=True),
                                     steps.TrainConfig(**tkw))
    params = lm.lm_params_from_numpy(p_np, "cpu")
    opt = lm.lm_params_from_numpy(opt_np, "cpu")
    assert opt["step"].dtype == torch.int32
    losses = []
    for s in range(5):
        b = {k: torch.from_numpy(v) for k, v in data.batch(s).items()}
        params, opt, met = step_fn(params, opt, b)
        losses.append(float(met["loss"]))
    _close(losses, losses_r)
    assert int(opt["step"]) == int(opt_r["step"]) == 5
    for tree, tree_r in ((params, params_r), (opt["m"], opt_r["m"]),
                         (opt["v"], opt_r["v"])):
        for got, want in zip(tree_leaves(tree), jax.tree.leaves(tree_r)):
            _close(got.numpy(), np.asarray(want))


def _one_step(tcfg, seed=0, carried=False):
    """One train step of the smoke model, from a fresh state or, with
    ``carried``, from the state after a full-batch step at step 0 (its
    moments filled, the learning rate of the step taken not 0)."""
    bundle = get_bundle("smollm-135m", smoke=True)
    params = bundle.init(torch.Generator().manual_seed(seed), device="cpu")
    opt = init_state(params)
    gen = torch.Generator().manual_seed(seed + 1)
    batch = {"tokens": torch.randint(0, 256, (8, 32), generator=gen),
             "labels": torch.randint(0, 256, (8, 32), generator=gen)}
    if carried:
        first = steps.TrainConfig(warmup=tcfg.warmup, total_steps=tcfg.total_steps)
        params, opt, _ = steps.build_train_step(bundle, first)(params, opt, batch)
    before = [p.clone() for p in tree_leaves(params)]
    grads = steps.accumulated_value_and_grad(
        bundle.loss_fn, params, batch, tcfg.microbatches, tcfg.remat)
    params, opt, met = steps.build_train_step(bundle, tcfg)(params, opt, batch)
    return params, opt, met, grads, before


@pytest.mark.parametrize("microbatches", [2, 4])
def test_microbatch_update_matches_full_batch(microbatches):
    """The accumulated gradient (every leaf within 1e-5 of its max|g|), the
    loss, and one update from a carried state with a learning rate that is
    not 0 (params and both moments within 1e-5 of each leaf's max) equal
    the full batch's.  The moments see the gradient after clipping, so the
    gradient itself is held too: one off by a factor clips to the same
    update."""
    tkw = dict(warmup=2, total_steps=10)
    p1, o1, m1, (l1, g1), before = _one_step(steps.TrainConfig(**tkw), carried=True)
    pm, om, mm, (lm_, gm), _ = _one_step(
        steps.TrainConfig(microbatches=microbatches, **tkw), carried=True)
    assert max(float((a - b).abs().max())
               for a, b in zip(tree_leaves(p1), before)) > 0
    _close(float(lm_), float(l1))
    _close(float(mm["loss"]), float(m1["loss"]))
    for a, b in zip(tree_leaves(gm), tree_leaves(g1)):
        _close(a.numpy(), b.numpy())
    for tree1, tree2 in ((p1, pm), (o1["m"], om["m"]), (o1["v"], om["v"])):
        for a, b in zip(tree_leaves(tree2), tree_leaves(tree1)):
            _close(a.numpy(), b.numpy())


@pytest.mark.parametrize("microbatches", [2, 4])
def test_microbatch_train_step_matches_reference(ref_params, microbatches):
    """The reference's train step with ``microbatches=m`` (its slices
    accumulated under ``lax.scan``) and the port's, three steps from one
    carried state: the reference's after a full-batch step at step 0, its
    moments filled, so that each step compared has a learning rate that is
    not 0 (Adam's first step from empty moments moves a param by
    lr * g / (|g| + eps), which turns an fp32 difference in a near-zero
    gradient into a large one).  Losses within 1e-5 relative, params and
    moments within 1e-5 of each leaf's max."""
    bundle, p_np = ref_params
    tkw = dict(warmup=2, total_steps=10)
    data = SyntheticTokens(DataConfig(vocab=256, seq_len=16, global_batch=8))
    with jax.set_mesh(make_host_mesh()):
        params_r = jax.tree.map(jnp.asarray, p_np)
        first = _ref_step(bundle, ref_steps.TrainConfig(fsdp=False, **tkw))
        b = {k: jnp.asarray(v) for k, v in data.batch(0).items()}
        params_r, opt_r, _ = first(params_r, ref_init_state(params_r), b)
        carried = _np({"params": params_r, "opt": opt_r})
        step_r = _ref_step(bundle, ref_steps.TrainConfig(
            fsdp=False, microbatches=microbatches, **tkw))
        losses_r = []
        for s in range(1, 4):
            b = {k: jnp.asarray(v) for k, v in data.batch(s).items()}
            params_r, opt_r, met = step_r(params_r, opt_r, b)
            losses_r.append(float(met["loss"]))
    step_fn = steps.build_train_step(
        get_bundle("smollm-135m", smoke=True),
        steps.TrainConfig(microbatches=microbatches, **tkw))
    params = lm.lm_params_from_numpy(carried["params"], "cpu")
    opt = lm.lm_params_from_numpy(carried["opt"], "cpu")
    assert int(opt["step"]) == 1
    losses = []
    for s in range(1, 4):
        b = {k: torch.from_numpy(v) for k, v in data.batch(s).items()}
        params, opt, met = step_fn(params, opt, b)
        losses.append(float(met["loss"]))
    _close(losses, losses_r)
    assert int(opt["step"]) == int(opt_r["step"]) == 4
    for tree, tree_r in ((params, params_r), (opt["m"], opt_r["m"]),
                         (opt["v"], opt_r["v"])):
        for got, want in zip(tree_leaves(tree), jax.tree.leaves(tree_r)):
            _close(got.numpy(), np.asarray(want))


def test_remat_matches_no_remat():
    p1, o1, m1, _, _ = _one_step(steps.TrainConfig())
    p2, o2, m2, _, _ = _one_step(steps.TrainConfig(remat=True))
    assert float(m1["loss"]) == float(m2["loss"])
    for tree1, tree2 in ((p1, p2), (o1["m"], o2["m"]), (o1["v"], o2["v"])):
        for a, b in zip(tree_leaves(tree1), tree_leaves(tree2)):
            _close(a.numpy(), b.numpy(), 1e-6)


def test_train_config_rejects_unknown_options():
    with pytest.raises(ValueError):
        steps.TrainConfig(grad_compression="fp4")
    with pytest.raises(ValueError):
        steps.TrainConfig(microbatches=0)


def test_prefill_and_serve_steps_match_reference(ref_params):
    bundle, p_np = ref_params
    toks = np.random.default_rng(8).integers(0, 256, (2, 5)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, p_np)
    want = ref_steps.build_prefill_step(bundle, make_host_mesh())[0](
        jp, {"tokens": jnp.asarray(toks)})
    pb = get_bundle("smollm-135m", smoke=True)
    port = lm.lm_params_from_numpy(p_np, "cpu")
    _close(steps.build_prefill_step(pb)(port, {"tokens": _t(toks)}).numpy(),
           np.asarray(want))
    cache_r = bundle.make_cache(2, 8, jnp.float32)
    serve_r = jax.jit(ref_steps.build_serve_step(bundle, make_host_mesh())[0])
    cache = pb.make_cache(2, 8, torch.float32, "cpu")
    serve = steps.build_serve_step(pb)
    for t in range(5):
        col = toks[:, t:t + 1]
        tok_r, cache_r = serve_r(jp, cache_r, {"tokens": jnp.asarray(col),
                                               "pos": jnp.int32(t)})
        tok, cache = serve(port, cache, {"tokens": _t(col), "pos": t})
        assert tok.dtype == torch.int32
        np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_r))


# -- checkpoints ------------------------------------------------------------


def _ckpt_trees(p_np):
    params_r = jax.tree.map(jnp.asarray, p_np)
    opt_r = ref_init_state(params_r)
    opt_r = {"m": jax.tree.map(lambda a: a + 0.5, opt_r["m"]), "v": opt_r["v"],
             "step": jnp.int32(7)}
    tree_r = {"params": params_r, "opt": opt_r}
    tree = {"params": lm.lm_params_from_numpy(p_np, "cpu"),
            "opt": lm.lm_params_from_numpy(_np(opt_r), "cpu")}
    return tree_r, tree


def _blank(tree):
    return tree_map(torch.zeros_like, tree)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_restores_across_packages(ref_params, tmp_path, writer):
    _, p_np = ref_params
    tree_r, tree = _ckpt_trees(p_np)
    d = str(tmp_path)
    if writer == "reference":
        ref_ckpt.save(d, 7, tree_r, {"by": writer})
        got = ckpt.restore(d, ckpt.latest_step(d), _blank(tree))
        pairs = zip(tree_leaves(got), jax.tree.leaves(tree_r))
        assert got["opt"]["step"].dtype == torch.int32
    else:
        ckpt.save(d, 7, tree, {"by": writer})
        like = jax.tree.map(jnp.zeros_like, tree_r)
        got = ref_ckpt.restore(d, ref_ckpt.latest_step(d), like)
        pairs = zip(jax.tree.leaves(got), tree_leaves(tree))
    with open(os.path.join(d, "step-00000007", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["step"] == 7 and manifest["extra"] == {"by": writer}
    assert any(k == "opt/step" for k in manifest["keys"])
    for a, b in pairs:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_round_trip_with_bf16_and_gc(tmp_path):
    d = str(tmp_path)
    tree = {"a": torch.randn(3, 4).to(torch.bfloat16), "b": {"c": torch.arange(5)},
            "step": torch.tensor(2, dtype=torch.int32)}
    writer = ckpt.AsyncCheckpointer(d, keep=2)
    for s in (1, 2, 3, 4):
        writer.submit(s, tree)
    writer.wait()
    assert sorted(os.listdir(d)) == ["step-00000003", "step-00000004"]
    assert ckpt.latest_step(d) == 4
    got = ckpt.restore(d, 4, _blank(tree))
    for a, b in zip(tree_leaves(got), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the reference reads the bf16 leaf's two bytes as numpy's V2, as it
    # writes them
    with np.load(os.path.join(d, "step-00000004", "arrays.npz")) as z:
        assert z["a"].dtype == np.dtype("V2") and z["b/c"].dtype == np.int64
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    # restore(shardings=) cuts each leaf to this process's shard: on a
    # one-process mesh that is the whole leaf; a sharding tree that lacks
    # a leaf raises
    mesh = Mesh(("data", "model"), (1, 1))
    sh = {"a": NamedSharding(mesh, PartitionSpec("data", None)),
          "b": {"c": NamedSharding(mesh, PartitionSpec("data"))},
          "step": NamedSharding(mesh, PartitionSpec())}
    got = ckpt.restore(d, 4, _blank(tree), shardings=sh)
    for a, b in zip(tree_leaves(got), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(KeyError):
        ckpt.restore(d, 4, _blank(tree), shardings={"a": sh["a"]})


def test_async_checkpoint_snapshots_before_submit_returns(tmp_path, monkeypatch):
    """The writer thread is held until the tree was changed in place after
    ``submit`` returned: the checkpoint still holds the values at submit."""
    real_write = ckpt.checkpoint._write
    go = threading.Event()

    def held_write(*args):
        assert go.wait(30)
        return real_write(*args)

    monkeypatch.setattr(ckpt.checkpoint, "_write", held_write)
    tree = {"w": torch.arange(6, dtype=torch.float32)}
    writer = ckpt.AsyncCheckpointer(str(tmp_path))
    writer.submit(1, tree)
    tree["w"].add_(100.0)  # the optimizer's in-place update
    go.set()
    writer.wait()
    got = ckpt.restore(str(tmp_path), 1, {"w": torch.zeros(6)})
    assert torch.equal(got["w"], torch.arange(6, dtype=torch.float32))


def test_async_checkpoint_failure_reraises_from_wait(tmp_path, monkeypatch):
    def failing_write(*args):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.checkpoint, "_write", failing_write)
    writer = ckpt.AsyncCheckpointer(str(tmp_path))
    writer.submit(1, {"w": torch.zeros(2)})
    with pytest.raises(OSError, match="disk full"):
        writer.wait()
    writer.wait()  # reported once


# -- the trainer (the port's versions of tests/test_train_e2e.py) ------------


def test_train_loss_decreases():
    losses = train("smollm-135m", steps=40, batch=8, seq=64, smoke=True,
                   device="cpu")
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.02


def test_checkpoint_restart_continues(tmp_path):
    d = str(tmp_path)
    l1 = train("smollm-135m", steps=20, batch=4, seq=32, smoke=True, ckpt_dir=d,
               ckpt_every=10, device="cpu")
    l2 = train("smollm-135m", steps=30, batch=4, seq=32, smoke=True, ckpt_dir=d,
               ckpt_every=10, device="cpu")
    assert len(l1) == 20 and len(l2) == 10  # only steps 20..30 ran
    assert ckpt.latest_step(d) == 30


def test_restart_equals_uninterrupted_run(tmp_path):
    """A run that restores its step-10 checkpoint in a fresh ``train`` call
    continues with the uninterrupted run's losses."""
    d = str(tmp_path)
    full = train("smollm-135m", steps=20, batch=4, seq=32, smoke=True,
                 ckpt_dir=d, ckpt_every=10, device="cpu")
    shutil.rmtree(os.path.join(d, "step-00000020"))
    rest = train("smollm-135m", steps=20, batch=4, seq=32, smoke=True,
                 ckpt_dir=d, ckpt_every=10, device="cpu")
    assert len(rest) == 10
    _close(rest, full[10:])


def test_train_with_grad_compression_and_on_step(monkeypatch):
    """Compression is accepted and warns that it does not apply on one
    device; TF32 is off inside the run and the process's flags are
    restored after it."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    seen = []

    def on_step(s, m):
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        seen.append((s, m["loss"]))

    with pytest.warns(UserWarning, match="'int8' does not apply"):
        losses = train("smollm-135m", steps=5, batch=4, seq=32, smoke=True,
                       grad_compression="int8", device="cpu", on_step=on_step)
    assert all(np.isfinite(l) for l in losses)
    assert seen == list(enumerate(losses))
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


def test_train_stubs_a_vlm_prefix(monkeypatch):
    """A ``"vlm"`` bundle trains with seeded prefix embeddings in its batch."""
    vlm = registry.make_lm_bundle(smollm_135m.smoke(), family="vlm")
    monkeypatch.setattr(train_mod, "get_bundle", lambda arch, smoke: vlm)
    seen = {}
    real = vlm.loss_fn

    def loss_fn(params, batch):
        seen["prefix"] = tuple(batch["prefix"].shape)
        return real(params, batch)

    vlm.loss_fn = loss_fn
    losses = train("smollm-135m", steps=3, batch=2, seq=16, smoke=True,
                   device="cpu")
    assert len(losses) == 3 and seen["prefix"] == (2, 8, 48)
    with pytest.raises(ValueError):
        registry.make_lm_bundle(smollm_135m.smoke(), family="ssm")


def test_train_refuses_the_card_when_absent():
    if torch.cuda.is_available():
        pytest.skip("a card is present: train would run on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train("smollm-135m", steps=1, batch=2, seq=8, smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_mod.main(["--smoke", "--steps", "1"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_get_bundle_has_the_reference_numbers(arch):
    """Every arch of the reference: the bundle's name, family and every
    field of its config (``LMConfig`` with its nested ``MoEConfig`` /
    ``MLAConfig``, ``RwkvConfig``, ``HymbaConfig``, ``WhisperConfig``) equal
    the reference's, for ``full()`` and ``smoke()``."""
    assert ARCH_IDS == REF_ARCH_IDS
    for smoke in (False, True):
        got = get_bundle(arch, smoke=smoke)
        want = ref_get_bundle(arch, smoke=smoke)
        assert (got.name, got.family, got.has_decoder, got.sub_quadratic) == (
            want.name, want.family, want.has_decoder, want.sub_quadratic)
        names = [f.name for f in dataclasses.fields(want.cfg)]
        assert [f.name for f in dataclasses.fields(got.cfg)] == names
        for f in names:
            a, b = getattr(got.cfg, f), getattr(want.cfg, f)
            if dataclasses.is_dataclass(b):
                assert type(a).__name__ == type(b).__name__, f
                assert dataclasses.asdict(a) == dataclasses.asdict(b), f
            else:
                assert a == b, f
    with pytest.raises(KeyError):
        get_bundle("gpt-5")


def _chip_smoke():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_step1_check_passes_on_the_smoke_config():
    """``chip_smoke.py``'s float64 recompute (written apart from the port's
    model code) agrees with the port's step-1 loss and gradients, and its
    check refuses a gradient cut through attention."""
    cs = _chip_smoke()
    bundle = get_bundle("smollm-135m", smoke=True)
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    data = SyntheticTokens(DataConfig(vocab=256, seq_len=24, global_batch=4))
    batch = {k: torch.from_numpy(v) for k, v in data.batch(0).items()}
    out = cs.check_step1_fp64(bundle, params, batch)
    assert out["loss_rel_err"] <= 1e-6 and out["grad_rel_err"] <= 1e-5
    cut = dataclasses.replace(bundle, loss_fn=lambda p, b: bundle.loss_fn(
        {**p, "dense_layers": {**p["dense_layers"],
                               "wq": p["dense_layers"]["wq"].detach()}}, b))
    with pytest.raises(AssertionError, match="wq is zero"):
        cs.check_step1_fp64(cut, params, batch)


def test_bf16_params_carry_across(ref_params):
    """The reference's default bf16 params (ml_dtypes arrays) carry across
    bit for bit."""
    bundle, _ = ref_params
    p = _np(bundle.init(jax.random.PRNGKey(1), jnp.bfloat16))
    port = lm.lm_params_from_numpy(p, "cpu")
    for got, want in zip(tree_leaves(port), jax.tree.leaves(p)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
