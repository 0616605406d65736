"""Microbatches over data ranks are the reference's global slices (ROADMAP
Queue C item 4), on the CPU with gloo.

The reference cuts the global batch into ``microbatches`` slices of
consecutive rows (``repro.launch.steps.build_train_step``), so a MoE's
dispatch groups, and the entries its capacity drops, are those of each
slice's tokens.  Each rank of the port takes its block of every slice
(``ParallelStep.local_batch``), so its i-th microbatch is its block of
slice i.  Held here:

* DeepSeek-V2's smoke MoE with one dispatch group and a capacity factor of
  0.5 (entries drop), trained ``MICRO_STEPS`` steps of 8 x 8 tokens with 2
  microbatches over (data 2) and over (pod 2, data 2), and with 4 over
  (data 4), whose slices of 2 rows do not cut over the 4 ranks, FSDP on,
  against the reference's ``build_train_step`` with as many microbatches
  on one device on the same global batches from the same numpy weights:
  losses and gradient norms within
  ``REL_LOSS`` = 1e-5 relative, every updated leaf within ``REL_LEAF`` =
  1e-5 of its largest magnitude.  The rank bodies are in
  ``tests/_torch_uneven_ranks.py``;
* the rows every rank runs in each of its microbatches, on a fake process
  group of each rank of a (pod 2, data 16) mesh (the dry run's
  DeepSeek-V2 ``train_4k`` cell at smoke scale 16: 16 rows cut over pod,
  held alike over data), of (pod 2, data 2) and of (data 4) holding 6
  rows alike: each is its block of one reference slice, and the ranks
  holding alike rows share the slices (``ParallelStep._share``, one slice
  for k / m ranks), so that together they run every slice equally often;
  and where a slice's rows do not cut over the ranks that cut the batch
  (6 rows in 2 slices over data 2; the dry run's DeepSeek ``train_4k``
  cells on 16 x 16 at smoke scale 16, 16 rows in 8 slices over data 16),
  every rank holds the batch whole and runs whole slices
  (``ParallelStep._whole_slices``), shared as above.
  ``_share``'s other case, m / k slices a rank, cannot meet slices that
  divide over the ranks holding distinct rows: it needs the alike ranks
  to divide m, and then the rows divide over every data axis.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_uneven_ranks as ranks
from repro.launch import steps as ref_steps
from repro.launch.mesh import make_host_mesh as ref_host_mesh
from repro.models import moe as ref_moe
from repro.models import transformer as ref_lm
from repro.models.registry import make_lm_bundle as ref_make_lm_bundle
from repro.optim import init_state as ref_init_state
from repro_torch.configs import get_bundle
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_process_mesh, run_ranks
from test_torch_tensor_parallel import _draw

TIMEOUT_S = int(os.environ.get("REPRO_TEST_TIMEOUT", "300"))
RANK_TIMEOUT_S = min(150, TIMEOUT_S // 2) if TIMEOUT_S > 0 else 150
REL_LOSS, REL_LEAF = 1e-5, 1e-5


def _ref_bundle():
    port = ranks.micro_bundle().cfg
    kw = {f.name: getattr(port, f.name) for f in dataclasses.fields(port)}
    kw["mla"] = ref_lm.MLAConfig(**dataclasses.asdict(kw["mla"]))
    kw["moe"] = ref_moe.MoEConfig(**dataclasses.asdict(kw["moe"]))
    return ref_make_lm_bundle(ref_lm.LMConfig(**kw))


@pytest.fixture(scope="module")
def case():
    """The numpy weights and global batches, and the reference's steps on
    one device with each number of microbatches: losses, gradient norms
    and the params after."""
    rb = _ref_bundle()
    rng = np.random.default_rng(31)
    p = _draw(rb.schema, rng)
    batches = []
    for _ in range(ranks.MICRO_STEPS):
        toks = rng.integers(0, rb.cfg.vocab, (ranks.MICRO_BATCH,
                                              ranks.MICRO_SEQ)).astype(np.int32)
        batches.append({"tokens": toks, "labels": np.roll(toks, -1, axis=1)})
    mesh = ref_host_mesh()
    ref = {}
    for m in sorted({v[2] for v in ranks.MICRO_MESHES.values()}):
        fn, _, _ = ref_steps.build_train_step(rb, mesh, ref_steps.TrainConfig(
            microbatches=m, **ranks.MICRO_KW))
        with jax.set_mesh(mesh):
            step = jax.jit(fn)
            params = jax.tree.map(jnp.asarray, p)
            opt = ref_init_state(params)
            losses, norms = [], []
            for b in batches:
                params, opt, met = step(params, opt, {
                    k: jnp.asarray(v) for k, v in b.items()})
                losses.append(float(met["loss"]))
                norms.append(float(met["grad_norm"]))
        ref[m] = {"losses": losses, "norms": norms,
                  "params": jax.tree.map(np.asarray, params)}
    return p, batches, ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory, case):
    p, batches, _ = case
    out = {}
    for world in (2, 4):
        got = run_ranks(ranks.microbatch_ranks, world, p, batches,
                        store_path=str(tmp_path_factory.mktemp(f"micro{world}")
                                       / "store"),
                        device="cpu", timeout_s=RANK_TIMEOUT_S)
        for name in got[0]:
            out[name] = [r[name] for r in got]
    return out


def _close_tree(got, want, rel, path=()):
    if isinstance(want, dict):
        for k in want:
            _close_tree(got[k], want[k], rel, path + (k,))
        return
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, ("/".join(path), err, scale)


@pytest.mark.parametrize("mesh_name", list(ranks.MICRO_MESHES))
def test_microbatches_over_data_ranks_match_the_reference(case, runs,
                                                          mesh_name):
    _, _, refs = case
    ref = refs[ranks.MICRO_MESHES[mesh_name][2]]
    for r in runs[mesh_name]:
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=REL_LOSS)
        np.testing.assert_allclose(r["norms"], ref["norms"], rtol=REL_LOSS)
        _close_tree(r["params"], ref["params"], REL_LEAF)


def _slice_rows(sizes, names, rows, m):
    """For each rank of a mesh of ``sizes`` (on a fake process group of
    that rank): its coordinates on the axes whose ranks hold alike rows,
    and the global row ids of each microbatch it runs of a batch of
    ``rows`` rows."""
    import torch.testing._internal.distributed.fake_pg  # noqa: F401

    bundle = get_bundle("smollm-135m", smoke=True)
    world = int(np.prod(sizes))
    batch = {"tokens": torch.arange(rows)[:, None].expand(rows, 4).contiguous(),
             "labels": torch.zeros((rows, 4), dtype=torch.long)}
    out = []
    for r in range(world):
        dist.init_process_group("fake", store=dist.HashStore(), rank=r,
                                world_size=world)
        try:
            mesh = make_process_mesh(sizes, names, device="cpu",
                                     backend="fake")
            step = steps.build_train_step(
                bundle, steps.TrainConfig(microbatches=m, fsdp=False), mesh)
            alike = step.alike_axes(batch)
            local, micro = step._share(step.local_batch(batch), alike, m)
            got = [mb["tokens"][:, 0].tolist()
                   for mb in steps._slices(local, micro)]
            out.append((tuple(mesh.coordinate[a] for a in alike), got))
        finally:
            dist.destroy_process_group()
    return out


@pytest.mark.parametrize("sizes,names,rows,m", [
    ((2, 16, 1), ("pod", "data", "model"), 16, 8),  # 16 alike share 8
    ((2, 2, 1), ("pod", "data", "model"), 8, 2),  # rows over both axes
    ((4, 1), ("data", "model"), 6, 2),  # 6 rows alike on 4 ranks, 2 slices
    ((2, 1), ("data", "model"), 6, 2),  # slices of 3 rows whole on 2 ranks
    ((16, 1), ("data", "model"), 16, 8),  # slices of 2 rows whole on 16
], ids=["pod2-data16", "pod2-data2", "data4-alike", "data2-whole",
        "data16-whole"])
def test_each_microbatch_is_a_block_of_a_reference_slice(sizes, names, rows,
                                                         m):
    """The ranks that hold distinct rows and run the same microbatch step
    together (one alike coordinate, one step) hold exactly the rows of one
    reference slice, and every slice is run equally often."""
    n = rows // m  # the reference's slice i: rows i*n .. i*n+n-1
    together: dict = {}
    for alike, micro in _slice_rows(sizes, names, rows, m):
        for j, ids in enumerate(micro):
            together.setdefault((alike, j), []).extend(ids)
    count = np.zeros(m, dtype=int)
    for key, ids in together.items():
        i = min(ids) // n
        assert sorted(ids) == list(range(i * n, (i + 1) * n)), (key, ids)
        count[i] += 1
    assert (count == count[0]).all() and count[0] > 0, count
