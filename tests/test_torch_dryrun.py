"""The port's dry run (``repro_torch.launch.dryrun``) and its op-level cost
counter (``repro_torch.launch.cost_analysis``) against the reference's
``launch/dryrun.py`` and ``launch/hlo_analysis.py``, on the CPU.

The reference's cells are lowered in subprocesses (``_torch_dryrun_ref.py``:
``repro.launch.dryrun`` sets ``XLA_FLAGS`` for 512 host devices before jax
is imported), started together when the module's first test asks for them
and read as each test needs them.  Held:

(a) the counter on the reference's own analyzer cases: 8 ``tanh(x @ w)``
    at 64^3, and 8 x 4 nested, against ``analyze_hlo`` of the jitted scans;
    the ring factors of all-reduce and all-gather through a ``ProcessMesh``
    over a 4-rank fake group, and of collective-permute, against
    ``analyze_hlo`` of the reference's synthetic HLO;
(b) product FLOPs on the 1 x 1 mesh equal to the reference's
    ``analyze_hlo(...).dot_flops`` as integers: SmolLM-135M at smoke scale
    16 (decode, train with the per-layer remat, and prefill: the
    reference's count less 3/4 of its full S^2 attention, which its chunked
    scan skips, plus K4's charged causal work), Qwen3-4B's and
    DeepSeek-V2's decode; the argument bytes equal too;
(c) argument bytes per device on the production meshes equal to the
    reference's ``argument_size_in_bytes``;
(d) the CLI, ``skipped`` and ``error`` records, and no process group left
    behind;
and the train step over a batch whose rows do not split over the data
ranks (a smoke-scaled cell on 2 x 16 x 16), on 2 gloo ranks against the
reference's train step.  DeepSeek-V3 at full size: ``tests/test_torch_dryrun_full.py``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_dryrun_ranks as ranks
from repro.configs import get_bundle as ref_get_bundle
from repro.configs import smollm_135m as ref_smollm
from repro.launch import steps as ref_steps
from repro.launch.hlo_analysis import analyze_hlo
from repro.launch.mesh import make_host_mesh as ref_host_mesh
from repro.optim import init_state as ref_init_state
from repro_torch.configs import get_bundle
from repro_torch.configs.shapes import batch_structs
from repro_torch.data.synthetic import DataConfig, SyntheticTokens
from repro_torch.kernels.flash_attn.kernel import flash_cost
from repro_torch.launch import dryrun, steps
from repro_torch.launch.cost_analysis import CostCounter, wire_bytes
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.common import params_from_numpy
from repro_torch.optim import init_state

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
REF_TIMEOUT_S = 180
# the train step against the reference's, as tests/test_torch_distributed.py
# holds it: losses relative, params relative to each leaf's max
REL_LOSS, REL_LEAF = 1e-5, 1e-4

CELLS_1X1 = [("smollm-135m", "decode_32k"), ("smollm-135m", "train_4k"),
             ("smollm-135m", "prefill_32k"), ("qwen3-4b", "decode_32k"),
             ("deepseek-v2-236b", "decode_32k")]
CELLS_PROD = [("smollm-135m", "train_4k", "16x16", 16),
              ("smollm-135m", "train_4k", "2x16x16", 16),
              ("qwen3-4b", "decode_32k", "16x16", 16),
              # the rank's 8 rows in its 8 microbatches
              ("deepseek-v2-236b", "train_4k", "16x16", 2)]
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _ref_cell(arch, shape, mesh, smoke):
    return {"arch": arch, "shape": shape, "mesh": mesh, "smoke": smoke}


class _Reference:
    """The reference's cells, lowered in subprocesses started at once;
    ``get`` waits for the one that holds a cell."""

    def __init__(self, batches):
        env = {**os.environ, "PYTHONPATH": SRC}
        self.procs = [(batch, subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_torch_dryrun_ref.py"),
             json.dumps(batch)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env)) for batch in batches]
        self.results: dict = {}

    def get(self, arch, shape, mesh, smoke):
        cell = _ref_cell(arch, shape, mesh, smoke)
        key = json.dumps(cell, sort_keys=True)
        for batch, proc in self.procs:
            if cell in batch and key not in self.results:
                out, err = proc.communicate(timeout=REF_TIMEOUT_S)
                assert proc.returncode == 0, err[-3000:]
                for rec in json.loads(out.strip().splitlines()[-1]):
                    got = {k: rec[k] for k in ("arch", "shape", "mesh", "smoke")}
                    self.results[json.dumps(got, sort_keys=True)] = rec
        return self.results[key]

    def close(self):
        for _, proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module")
def ref():
    r = _Reference([
        [_ref_cell(a, s, "1x1", 16) for a, s in CELLS_1X1],
        [_ref_cell(a, s, m, k) for a, s, m, k in CELLS_PROD[:3]],
        [_ref_cell(a, s, m, k) for a, s, m, k in CELLS_PROD[3:]]])
    yield r
    r.close()


def _trace(arch, shape, mesh, smoke):
    sizes, names = MESHES[mesh]
    with dryrun.fake_mesh(sizes, names) as m:
        counter, out, meta = dryrun.lower_cell(arch, shape, m, smoke_scale=smoke)
    assert not dist.is_initialized()
    return counter, out, meta


@pytest.fixture(scope="module")
def traced():
    """``_trace`` of a cell, once for the module: (b) and (c) read it."""
    cells: dict = {}

    def get(arch, shape, mesh, smoke):
        key = (arch, shape, mesh, smoke)
        if key not in cells:
            cells[key] = _trace(*key)
        return cells[key]

    return get


# -- (a) the counter on the reference's analyzer cases ----------------------


def _loop(x, w, inner):
    for i in range(w.shape[0]):
        for _ in range(inner):
            x = torch.tanh(x @ w[i])
    return x


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("inner", [1, 4])
def test_counter_counts_the_references_scan_cases(device, inner):
    def f(x, w):
        def body(c, wi):
            def step(ci, _):
                return jnp.tanh(ci @ wi), None
            c, _ = jax.lax.scan(step, c, None, length=inner)
            return c, None
        c, _ = jax.lax.scan(body, x, w)
        return c

    want = analyze_hlo(jax.jit(f).lower(jnp.ones((64, 64)), jnp.ones(
        (8, 64, 64))).compile().as_text()).dot_flops
    assert want == 8 * inner * 2 * 64 ** 3
    x = torch.ones(64, 64, device=device)
    w = torch.ones(8, 64, 64, device=device)
    with CostCounter((x, w)) as c:
        _loop(x, w, inner)
    assert c.cost.dot_flops == want
    # each tanh one FLOP a result element beside the products
    assert c.cost.flops == want + 8 * inner * 64 * 64
    assert c.argument_bytes == 4 * (64 * 64 + 8 * 64 * 64)


def test_cost_is_the_references():
    from repro.launch.hlo_analysis import Cost as RefCost

    from repro_torch.launch.cost_analysis import Cost

    got, want = Cost(1.0, 2.0, 3.0, dot_flops=0.5), RefCost(1.0, 2.0, 3.0,
                                                          dot_flops=0.5)
    for c in (got, want):
        c.collectives["all-reduce"] += 4.0
        c += c.scaled(2.5)
    assert got.as_dict() == want.as_dict()


def test_ring_factors_match_the_reference():
    hlo = """
HloModule test, entry_computation_layout={()->f32[]}

ENTRY %main (p: f32[128,8]) -> f32[128,8] {
  %p = f32[128,8]{1,0} parameter(0)
  %ar = f32[128,8]{1,0} all-reduce(%p), replica_groups=[1,4]<=[4], to_apply=%add
  %ag = f32[512,8]{1,0} all-gather(%ar), replica_groups=[1,4]<=[4], dimensions={0}
  ROOT %cp = f32[128,8]{1,0} collective-permute(%ar), source_target_pairs={{0,1}}
}
"""
    want = analyze_hlo(hlo, 4).collectives
    with dryrun.fake_mesh((4,), ("model",)) as mesh:
        p = torch.empty(128, 8, device="meta")
        with CostCounter((p,), mesh) as c:
            ar = mesh.all_reduce(p, "model")
            ag = mesh.all_gather(ar, "model", dim=0)
        assert tuple(ag.shape) == (512, 8)
    assert not dist.is_initialized()
    assert c.cost.collectives["all-reduce"] == want["all-reduce"]
    assert c.cost.collectives["all-gather"] == want["all-gather"]
    sz = 128 * 8 * 4
    assert wire_bytes("collective-permute", sz, sz, 4) == want["collective-permute"]
    assert c.by_axis["model"]["calls"] == 2
    assert c.cost.collective_bytes == want["all-reduce"] + want["all-gather"]


@pytest.mark.parametrize("sq,sk", [(16, 16), (2048, 2048), (16, 48), (48, 16)])
def test_k4_on_meta_charges_its_causal_work_and_launches_nothing(sq, sk):
    from repro_torch.kernels.flash_attn.kernel import flash_attention, launches

    bh, rep, d = 8, 4, 64
    keys = sum(min(i + 1, sk) for i in range(sq))
    flops, nbytes = flash_cost(bh, bh // rep, sq, sk, d, 2)
    assert flops == 4 * d * keys * bh
    assert nbytes == 2 * (2 * bh * sq * d + 2 * (bh // rep) * sk * d)
    q = torch.empty(bh, sq, d, dtype=torch.bfloat16, device="meta")
    k = torch.empty(bh // rep, sk, d, dtype=torch.bfloat16, device="meta")
    before = launches.count
    with CostCounter((q, k)) as c:
        out = flash_attention(q, k, k, rep=rep)
    assert out.is_meta and out.shape == q.shape and out.dtype == q.dtype
    assert launches.count == before
    assert c.kernels == {"flash_attention": {"launches": 1, "flops": flops,
                                             "bytes": nbytes}}
    assert c.cost.dot_flops == flops
    # outside a counter it charges nothing, and still launches nothing
    assert flash_attention(q, k, k, rep=rep).is_meta
    assert launches.count == before


# -- (b) product FLOPs on the 1 x 1 mesh --------------------------------------


def _k4_terms(arch, shape, smoke):
    """The reference's full S^2 attention of a prefill cell (2 products of
    4·S²·d a query head over every layer) and K4's charged work there."""
    bundle = get_bundle(arch)
    cfg = bundle.cfg
    batch, _ = batch_structs(bundle, shape, smoke_scale=smoke)
    b, s = batch["tokens"].shape
    bh = b * cfg.n_heads
    full = 4 * s * s * cfg.head_dim * bh * cfg.layers
    k4 = cfg.layers * flash_cost(bh, b * cfg.n_kv_heads, s, s, cfg.head_dim,
                                 2)[0]
    return full, k4


@pytest.mark.parametrize("arch,shape", CELLS_1X1)
def test_product_flops_on_one_device_equal_the_reference(ref, traced, arch,
                                                         shape):
    counter, out, meta = traced(arch, shape, "1x1", 16)
    r = ref.get(arch, shape, "1x1", 16)
    want = int(r["dot_flops"])
    if meta["kind"] == "prefill":
        full, k4 = _k4_terms(arch, shape, 16)
        assert full % 4 == 0
        want = want - 3 * full // 4 + int(k4)
        k = counter.kernels["flash_attention"]
        assert k["launches"] == get_bundle(arch).cfg.layers
        assert k["flops"] == k4
    else:
        assert counter.kernels == {}
    if (arch, shape) == ("smollm-135m", "train_4k"):
        # each layer's forward runs twice, as under the reference's
        # per-layer ``jax.checkpoint``
        assert want == 4_247_185_784_832
    assert int(counter.cost.dot_flops) == want
    assert counter.memory(out)["argument_size_in_bytes"] == \
        r["argument_size_in_bytes"]


def test_remat_recomputes_under_the_forwards_mesh():
    """The backward, and so a checkpointed layer's recompute, may run on
    another thread (autograd's device thread on the card), which does not
    see the caller's ``use_mesh``: the recompute runs under the mesh that
    was active for the forward."""
    import threading

    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.common import checkpointed
    from repro_torch.sharding import active_mesh, use_mesh

    seen = []

    def layer(x):
        seen.append(active_mesh())
        return torch.tanh(x) * 2.0

    mesh = Mesh(("data", "model"), (1, 1))
    x = torch.ones(4, requires_grad=True)
    with use_mesh(mesh):
        y = checkpointed(layer, x).sum()
    grads = []
    t = threading.Thread(target=lambda: grads.append(torch.autograd.grad(y, x)))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and grads
    assert seen == [mesh, mesh]
    assert active_mesh() is None


# -- (c) argument bytes per device on the production meshes -----------------


@pytest.mark.parametrize("arch,shape,mesh,smoke", CELLS_PROD)
def test_argument_bytes_per_device_equal_the_reference(ref, traced, arch, shape,
                                                       mesh, smoke):
    counter, out, _ = traced(arch, shape, mesh, smoke)
    mem = counter.memory(out)
    assert mem["argument_size_in_bytes"] == \
        ref.get(arch, shape, mesh, smoke)["argument_size_in_bytes"]
    if (arch, mesh) == ("smollm-135m", "16x16"):
        assert mem["argument_size_in_bytes"] == 84_403_332
    assert mem["temp_size_in_bytes"] > 0
    assert sum(ax["calls"] for ax in counter.by_axis.values()) > 0


def test_cell_rules_follow_the_reference():
    """DeepSeek's dispatch groups and the train cell's microbatches and
    FSDP, as the reference's dry run sets them."""
    prod = dryrun.make_production_mesh(multi_pod=True)
    assert dryrun.cell_bundle("deepseek-v2-236b", "train_4k", prod
                              ).cfg.moe.dispatch_groups == 32
    assert dryrun.cell_bundle("deepseek-v2-236b", "train_4k", prod, 16
                              ).cfg.moe.dispatch_groups == 1
    for arch, micro, fsdp in (("smollm-135m", 1, False), ("qwen3-4b", 1, False),
                              ("codeqwen1.5-7b", 4, True),
                              ("deepseek-v3-671b", 8, True)):
        tcfg = dryrun.train_config(get_bundle(arch))
        assert (tcfg.microbatches, tcfg.fsdp) == (micro, fsdp), arch
    for shape in ("train_4k", "long_500k"):
        for arch in ("smollm-135m", "rwkv6-1.6b"):
            assert dryrun.cell_skip_reason(get_bundle(arch), shape) == \
                _ref_skip(arch, shape)


def _ref_skip(arch, shape):
    if shape == "long_500k" and not ref_get_bundle(arch).sub_quadratic:
        return "long_500k skipped: full-attention arch (quadratic); see DESIGN.md"
    return None


# -- (d) the CLI and the records ---------------------------------------------


def test_cli_writes_an_ok_record(tmp_path):
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; from repro_torch.launch import dryrun; "
         "dryrun.RESULTS_DIR = sys.argv[1]; dryrun.main(sys.argv[2:])",
         str(tmp_path), "--arch", "smollm-135m", "--shape", "train_4k",
         "--smoke-scale", "16", "--force"],
        capture_output=True, text=True, env={**os.environ, "PYTHONPATH": SRC},
        timeout=REF_TIMEOUT_S)
    assert out.returncode == 0, out.stdout[-1500:] + out.stderr[-1500:]
    assert "[ok" in out.stdout
    rec = json.loads((tmp_path / "smollm-135m__train_4k__16x16__smoke16.json"
                      ).read_text())
    assert rec["status"] == "ok" and rec["devices"] == 256
    assert rec["smoke_scale"] == 16 and rec["trace_s"] >= 0
    assert rec["memory"]["argument_size_in_bytes"] == 84_403_332
    assert set(rec["cost"]) == {"flops", "bytes", "collective_bytes",
                                "dot_flops", "collectives"}
    assert set(rec["by_axis"]) == {"data", "model"}
    assert rec["cost"]["collective_bytes"] == pytest.approx(sum(
        ax["wire_bytes"] for ax in rec["by_axis"].values()))
    assert rec["kernels"] == {}


def test_records_error_and_skipped_and_leave_no_group(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    # every arch runs over model, and so does the sequence-parallel
    # residual stream; so does a MoE whose dispatch group spans the data
    # ranks (2 x 16 x 16 at smoke scale 16: 16 rows cut over pod, held
    # alike over data, one group over the pod ranks)
    monkeypatch.setenv("REPRO_SEQ_PARALLEL", "1")
    rec = dryrun.run_cell("smollm-135m", "train_4k", multi_pod=False,
                          smoke_scale=16)
    assert rec["status"] == "ok", rec
    assert not dist.is_initialized()
    rec = dryrun.run_cell("deepseek-v2-236b", "train_4k", multi_pod=True,
                          smoke_scale=16)
    assert rec["status"] == "ok", rec
    assert not dist.is_initialized()
    # a placement the port leaves refused (ROADMAP Queue A item 3(c)): a
    # captured decode step, whose position is a tensor, over a cache cut
    # over model (Qwen3-4B's 8 KV heads: the sequence over model)
    serve = steps.build_serve_step

    def captured(bundle):
        step = serve(bundle)

        def run(params, cache, batch):
            at = torch.zeros((), dtype=torch.long, device="meta")
            return step(params, cache, {**batch, "pos": at})

        return run

    monkeypatch.setattr(steps, "build_serve_step", captured)
    rec = dryrun.run_cell("qwen3-4b", "decode_32k", multi_pod=False,
                          smoke_scale=16)
    assert rec["status"] == "error" and "3(c)" in rec["error"], rec
    assert "captured step" in rec["error"], rec
    assert not dist.is_initialized()
    monkeypatch.setattr(steps, "build_serve_step", serve)
    rec = dryrun.run_cell("qwen3-4b", "long_500k", multi_pod=False)
    assert rec["status"] == "skipped"
    assert rec["reason"] == _ref_skip("qwen3-4b", "long_500k")
    # a record is resumed, never recomputed, unless forced
    path = tmp_path / "qwen3-4b__long_500k__16x16.json"
    path.write_text(json.dumps({**rec, "reason": "cached"}))
    assert dryrun.run_cell("qwen3-4b", "long_500k", multi_pod=False
                           )["reason"] == "cached"
    assert dryrun.run_cell("qwen3-4b", "long_500k", multi_pod=False,
                           force=True)["reason"] != "cached"


def test_a_group_already_up_is_refused():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="in one already"):
            with dryrun.fake_mesh((1, 1), ("data", "model")):
                pass
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


# -- the train step over rows held alike by the data ranks ------------------


def test_rows_held_alike_over_the_data_ranks_train_as_one_process(tmp_path):
    """SmolLM's smoke config over (data 2, model 1), FSDP on, each global
    batch of 3 rows held whole by both ranks: the losses and gathered
    params against the reference's train step on its one-device host mesh
    (which holds rows that do not divide whole, as these ranks do), from
    the same numpy weights and batches; and bit-near the port's own step
    in one process.  DeepSeek-V2's smoke MoE over the same rows: its loss
    and gradient norm those of one process."""
    ref_bundle = ref_smollm.smoke()
    p_np = jax.tree.map(np.asarray, ref_bundle.init(jax.random.PRNGKey(0),
                                                    jnp.float32))
    data = SyntheticTokens(DataConfig(vocab=256, seq_len=16, global_batch=3))
    batches = [data.batch(s) for s in range(3)]
    got = run_ranks(ranks.replicated_rows, 2, p_np, batches,
                    store_path=str(tmp_path / "store"), device="cpu",
                    timeout_s=300)
    mesh = ref_host_mesh()
    fn, _, _ = ref_steps.build_train_step(
        ref_bundle, mesh, ref_steps.TrainConfig(fsdp=True, **ranks.TRAIN_KW))
    with jax.set_mesh(mesh):
        ref_step = jax.jit(fn)
        ref_params = jax.tree.map(jnp.asarray, p_np)
        ref_opt = ref_init_state(ref_params)
        ref_losses = []
        for b in batches:
            ref_params, ref_opt, met = ref_step(
                ref_params, ref_opt, {k: jnp.asarray(v) for k, v in b.items()})
            ref_losses.append(float(met["loss"]))
    ref_params = jax.tree.map(np.asarray, ref_params)
    step = steps.build_train_step(get_bundle("smollm-135m", smoke=True),
                                  steps.TrainConfig(**ranks.TRAIN_KW))
    params = params_from_numpy(p_np, "cpu")
    opt = init_state(params)
    losses = []
    for b in batches:
        params, opt, met = step(params, opt, {k: torch.from_numpy(v)
                                              for k, v in b.items()})
        losses.append(float(met["loss"]))
    for r in got:
        np.testing.assert_allclose(r["losses"], ref_losses, rtol=REL_LOSS)
        _close_tree(r["params"], ref_params, REL_LEAF)
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-6)
        _close_tree(r["params"], _numpy(params), 1e-5)
    # DeepSeek-V2's smoke MoE over the same rows held alike: its one
    # dispatch group counts each row once, so the step is one process's
    moe = get_bundle("deepseek-v2-236b", smoke=True)
    step = steps.build_train_step(moe, steps.TrainConfig(**ranks.TRAIN_KW))
    params = moe.init(torch.Generator().manual_seed(0), device="cpu")
    _, _, met = step(params, init_state(params),
                     {k: torch.from_numpy(v) for k, v in batches[0].items()})
    for r in got:
        assert r["moe"] == "ran", r["moe"]
        np.testing.assert_allclose(r["moe_loss"], float(met["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(r["moe_norm"], float(met["grad_norm"]),
                                   rtol=1e-5)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _close_tree(got, want, rel):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close_tree(got[k], want[k], rel)
        return
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale
