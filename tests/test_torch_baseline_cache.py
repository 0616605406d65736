"""``REPRO_BASELINE=1`` as the reference reads it (ROADMAP Queue A
3(c)2), on the CPU.

Under the switch the reference lays every K/V cache out over heads and
head dim (``_kv_cache_axes``: the KV heads over ``model`` where they
divide it, else the head dim) and every MLA latent over its width, writes
it in place (``_use_ring_cache`` False) and attends over the full
rectangle (``flash_block_skip`` False).  Held here:

* each arch id's decode cell caches (batch 128 and a batch of one) resolve
  to the reference's PartitionSpecs on both production meshes, and
  ``flash_block_skip`` defaults to False in both packages;
* ``serve_lm`` over (data 1, model 2) on 2 gloo ranks (rank bodies in
  ``tests/_torch_uneven_ranks.py``): SmolLM-135M's smoke config (one KV
  head of 16: the head dim cut, 8 a rank), Qwen3-4B's (2 KV heads: one a
  rank) and DeepSeek-V2's (latents of 32 and 8: 16 and 4 a rank), the
  tokens equal to the reference's greedy loop under the switch and every
  call's logits within 1e-4 of max|logit| of one process's; each cache
  leaf the cut those PartitionSpecs give;
* the dry run under the switch against the reference's (lowered in a
  subprocess, ``_torch_dryrun_ref.py``, with the switch set): Qwen3-4B
  ``decode_32k`` (8 KV heads do not divide 16: the head dim is cut, and
  each step sums partial scores over it), SmolLM-135M ``decode_32k`` (3
  KV heads: the head dim cut; ``wq``'s 9 heads cut inside a head, so each
  rank computes every head and sums partial scores likewise) and
  DeepSeek-V2-236B ``decode_32k`` (the latents' widths cut, gathered each
  step) on the 16 x 16 mesh at smoke scale 16, temporary
  bytes within 1.25x and collective wire bytes within 1.0x of the
  reference's (``tests/test_torch_dryrun_bytes.py``'s bounds); and
  Gemma2-9B ``prefill_32k`` on one device at smoke scale 16, whose 2,048
  positions and softcaps take the chunked attention over two blocks: its
  product FLOPs equal the reference's full rectangle, above the lower
  triangle's without the switch.
"""
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

import _torch_uneven_ranks as ranks
from repro.configs import get_bundle as ref_get_bundle
from repro.configs.shapes import batch_structs as ref_batch_structs
from repro.launch import steps as ref_steps
from repro_torch.configs import ARCH_IDS, get_bundle
from repro_torch.configs.shapes import batch_structs
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import Mesh, make_production_mesh, run_ranks
from repro_torch.launch.serve import serve_lm
from repro_torch.models.common import params_from_numpy
from repro_torch.sharding import spec_axes
from repro_torch.tree import tree_items
from test_torch_dryrun_bytes import COLLECTIVE_RATIO, TEMP_RATIO
from test_torch_sharding import _MeshShape, _pspecs, _ref_pspecs
from test_torch_tensor_parallel import _close, _draw, _greedy

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
REF_TIMEOUT_S = 180
TIMEOUT_S = int(os.environ.get("REPRO_TEST_TIMEOUT", "300"))
RANK_TIMEOUT_S = min(150, TIMEOUT_S // 2) if TIMEOUT_S > 0 else 150
REL_REF = 1e-4
SMOKE = 16
# (arch, shape, mesh): the decode cells held to the reference's bytes, and
# the prefill cell held to its FLOPs (its softcaps keep it off K4, so the
# chunked scan runs, where the block skip applies)
BYTES_CELLS = [("qwen3-4b", "decode_32k", "16x16"),
               ("smollm-135m", "decode_32k", "16x16"),
               ("deepseek-v2-236b", "decode_32k", "16x16")]
FLOPS_CELL = ("gemma2-9b", "prefill_32k", "1x1")
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model"))}


@pytest.fixture
def baseline(monkeypatch):
    monkeypatch.setenv("REPRO_BASELINE", "1")


@pytest.fixture(scope="module")
def ref_cells():
    """The reference's cells under the switch, lowered in a subprocess
    started when the module first asks for it."""
    cells = [{"arch": a, "shape": s, "mesh": m, "smoke": SMOKE}
             for a, s, m in BYTES_CELLS + [FLOPS_CELL]]
    proc = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_dryrun_ref.py"),
         json.dumps(cells)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env={**os.environ, "PYTHONPATH": SRC,
                        "REPRO_BASELINE": "1"})
    try:
        yield proc
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


def _ref_records(proc) -> dict:
    if not hasattr(proc, "records"):
        out, err = proc.communicate(timeout=REF_TIMEOUT_S)
        assert proc.returncode == 0, err[-3000:]
        proc.records = {(r["arch"], r["shape"], r["mesh"]): r
                        for r in json.loads(out.strip().splitlines()[-1])}
    return proc.records


def _decode_shape(arch: str) -> str:
    return "long_500k" if get_bundle(arch).sub_quadratic else "decode_32k"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_pspecs_equal_the_reference_under_the_switch(baseline, arch):
    bundle, ref = get_bundle(arch), ref_get_bundle(arch)
    shape = _decode_shape(arch)
    _, cache = batch_structs(bundle, shape)
    _, ref_cache = ref_batch_structs(ref, shape)
    one = bundle.make_cache(1, 4096, torch.bfloat16, "meta")
    ref_one = jax.eval_shape(lambda: ref.make_cache(1, 4096))
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        ms = _MeshShape(mesh.shape)
        for got, want in ((cache, ref_cache), (one, ref_one)):
            assert _pspecs(steps.cache_pspecs(bundle, got, mesh)) == \
                _ref_pspecs(ref_steps.cache_pspecs(ref, want, ms))


def test_flash_block_skip_defaults_off_under_the_switch(monkeypatch):
    assert get_bundle("qwen3-4b").cfg.flash_block_skip
    monkeypatch.setenv("REPRO_BASELINE", "1")
    assert not get_bundle("qwen3-4b").cfg.flash_block_skip
    assert not ref_get_bundle("qwen3-4b").cfg.flash_block_skip


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Each arch's numpy weights, the reference's greedy tokens under the
    switch, one process's logits and the ranks' results."""
    inputs, ref, one = {}, {}, {}
    lens = ranks.BASELINE_SERVE
    prompts = None
    os.environ["REPRO_BASELINE"] = "1"
    try:
        for i, arch in enumerate(ranks.BASELINE_ARCHS):
            rb = ref_get_bundle(arch, smoke=True)
            p = _draw(rb.schema, np.random.default_rng(300 + i))
            inputs[arch] = p
            prompts = torch.randint(
                0, rb.cfg.vocab, (lens["batch"], lens["prompt_len"]),
                generator=torch.Generator().manual_seed(1)).numpy()
            ref[arch] = _greedy(
                jax.jit(rb.prefill_cache_fn), jax.jit(rb.decode_fn),
                jax.tree.map(jnp.asarray, p), prompts, lens["gen"],
                rb.make_cache(lens["batch"], lens["prompt_len"] + lens["gen"],
                              jnp.float32))
            calls = []
            serve_lm(arch, smoke=True, device="cpu",
                     params=params_from_numpy(p, "cpu"), graphs=False,
                     on_logits=calls.append, **lens)
            one[arch] = torch.cat([c[:, -1] for c in calls]).numpy()
        runs = run_ranks(ranks.baseline_ranks, 2, inputs,
                         store_path=str(tmp_path_factory.mktemp("baseline")
                                        / "store"),
                         device="cpu", timeout_s=RANK_TIMEOUT_S)
    finally:
        del os.environ["REPRO_BASELINE"]
    return ref, one, runs


@pytest.mark.parametrize("arch", ranks.BASELINE_ARCHS)
def test_serve_over_model2_equals_the_reference(served, arch):
    ref, one, runs = served
    sizes = {"data": 1, "model": 2}
    os.environ["REPRO_BASELINE"] = "1"
    try:
        bundle = get_bundle(arch, smoke=True)
        full = bundle.make_cache(ranks.BASELINE_SERVE["batch"], 16,
                                 device="meta")
        specs = dict(tree_items(steps.cache_pspecs(
            bundle, full, Mesh(tuple(sizes), tuple(sizes.values())))))
    finally:
        del os.environ["REPRO_BASELINE"]
    for r in runs:
        got = r[arch]
        np.testing.assert_array_equal(got["tokens"], ref[arch])
        _close(got["logits"], one[arch], REL_REF, f"{arch} logits")
        for path, leaf in tree_items(full):
            want = tuple(n // int(np.prod([sizes[a] for a in spec_axes(e)]))
                         for n, e in zip(leaf.shape, specs[path]))
            assert got["cache"]["/".join(path)] == want, (arch, path)
        # a cut head dim's partial scores are summed over model, a cut
        # latent width gathered, at every decode step
        assert got["by_axis"]["model"]["calls"] > 0


def _port(arch, shape, mesh):
    with dryrun.fake_mesh(*MESHES[mesh]) as m:
        counter, out, _ = dryrun.lower_cell(arch, shape, m, smoke_scale=SMOKE)
        rec = {"temp": counter.memory(out)["temp_size_in_bytes"],
               "collective": counter.cost.collective_bytes,
               "dot_flops": counter.cost.dot_flops}
    assert not dist.is_initialized()
    return rec


@pytest.mark.parametrize("arch,shape,mesh", BYTES_CELLS)
def test_decode_bytes_within_the_reference_under_the_switch(
        baseline, ref_cells, arch, shape, mesh):
    got = _port(arch, shape, mesh)
    r = _ref_records(ref_cells)[(arch, shape, mesh)]
    assert got["temp"] <= TEMP_RATIO * r["temp_size_in_bytes"], (
        got["temp"], r["temp_size_in_bytes"])
    assert got["collective"] <= COLLECTIVE_RATIO * r["collective_bytes"], (
        got["collective"], r["collective_bytes"])


def test_prefill_flops_are_the_references_full_rectangle(ref_cells,
                                                         monkeypatch):
    skip = _port(*FLOPS_CELL)["dot_flops"]
    monkeypatch.setenv("REPRO_BASELINE", "1")
    got = _port(*FLOPS_CELL)
    r = _ref_records(ref_cells)[FLOPS_CELL]
    assert int(got["dot_flops"]) == int(r["dot_flops"])
    assert got["dot_flops"] > skip
