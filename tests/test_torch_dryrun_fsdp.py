"""FSDP a layer at a time (ROADMAP Queue C item 3), on the CPU.

Under FSDP the train step holds the stacked layer weights as this rank's
shards over the data axes and each layer all-gathers its own as it runs
(``sharding.gather_layer``, inside the layer's remat, so backward gathers
it again), its gradient reduce-scattered back onto the shards: the
reference's per-layer gather inside its scan.  Held here:

* the dry run's DeepSeek-V3-671B and DeepSeek-V2-236B ``train_4k`` on
  the 16 x 16 mesh at smoke scale 16 against the reference's cells (in a
  subprocess, ``_torch_dryrun_ref.py``): temporary bytes within
  ``TEMP_RATIO`` = 1.25x and collective wire bytes within
  ``COLLECTIVE_RATIO`` = 1.0x, the bounds of ``test_torch_dryrun_bytes.py``
  (the port counted 16.58x and 15.81x while it gathered the whole tree);
  PaliGemma-3B ``prefill_32k`` likewise (1.43x while its plain attention
  held three S x S fp32 tensors);
* SmolLM-135M's smoke config trained 3 steps with FSDP and 2 microbatches
  on gloo ranks over (data 2, model 1) and (data 2, model 2) against one
  process's step on the full batch: losses and gradient norms within
  1e-5 relative, the params within 1e-4 of each leaf's max (the data
  parallel tests' tolerance: fp32 sums of the same products in another
  order); and each step's largest data-axis all-gather at most one
  layer's shard times the data ranks, never the whole tree.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch.distributed as dist

import _torch_fsdp_ranks as ranks
from _torch_ranks import TRAIN_STEPS, _global_batches
from repro_torch.configs import get_bundle
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import run_ranks
from repro_torch.optim import init_state
from repro_torch.tree import tree_leaves
from test_torch_dryrun_bytes import COLLECTIVE_RATIO, TEMP_RATIO

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
REF_TIMEOUT_S = 180
TIMEOUT_S = int(os.environ.get("REPRO_TEST_TIMEOUT", "300"))
RANK_TIMEOUT_S = min(150, TIMEOUT_S // 2) if TIMEOUT_S > 0 else 150
CELLS = [("deepseek-v3-671b", "train_4k"), ("deepseek-v2-236b", "train_4k"),
         ("paligemma-3b", "prefill_32k")]
SMOKE = 16
REL_LOSS, REL_LEAF = 1e-5, 1e-4
MESHES = {"data2": (2, 1), "data2-model2": (2, 2)}


@pytest.fixture(scope="module")
def cells():
    """The reference's cells, lowered in a subprocess while the port's are
    traced here."""
    spec = [{"arch": a, "shape": s, "mesh": "16x16", "smoke": SMOKE}
            for a, s in CELLS]
    proc = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_dryrun_ref.py"),
         json.dumps(spec)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env={**os.environ, "PYTHONPATH": SRC})
    try:
        port = {}
        for arch, shape in CELLS:
            with dryrun.fake_mesh((16, 16), ("data", "model")) as mesh:
                counter, out, _ = dryrun.lower_cell(arch, shape, mesh,
                                                    smoke_scale=SMOKE)
                port[(arch, shape)] = {
                    "temp": counter.memory(out)["temp_size_in_bytes"],
                    "collective": counter.cost.collective_bytes,
                    "by_axis": counter.by_axis}
            assert not dist.is_initialized()
        stdout, stderr = proc.communicate(timeout=REF_TIMEOUT_S)
    finally:
        proc.kill()
    assert proc.returncode == 0, stderr[-3000:]
    ref = {(r["arch"], r["shape"]): r
           for r in json.loads(stdout.strip().splitlines()[-1])}
    return port, ref


@pytest.mark.parametrize("arch,shape", CELLS)
def test_temp_and_collective_bytes_within_the_reference(cells, arch, shape):
    port, ref = cells
    got, want = port[(arch, shape)], ref[(arch, shape)]
    assert got["temp"] <= TEMP_RATIO * want["temp_size_in_bytes"], (
        got["temp"], want["temp_size_in_bytes"])
    assert got["collective"] <= COLLECTIVE_RATIO * want["collective_bytes"], (
        got["collective"], want["collective_bytes"])


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "deepseek-v2-236b"])
def test_fsdp_gathers_over_data_and_keeps_the_model_cuts(cells, arch):
    """The per-layer gathers and reduce-scatters run over ``data``, each
    microbatch forward and in the recompute; ``model`` keeps its own."""
    port, ref = cells
    by_axis = port[(arch, "train_4k")]["by_axis"]
    assert by_axis["data"]["calls"] > 2 * get_bundle(arch).cfg.layers
    assert by_axis["model"]["wire_bytes"] < by_axis["data"]["wire_bytes"]


@pytest.fixture(scope="module")
def one_process():
    """The same steps in one process on the full batch."""
    bundle = get_bundle(ranks.ARCH, smoke=True)
    step = steps.build_train_step(bundle, ranks.train_config())
    params = ranks.init_params(bundle)
    opt = init_state(params)
    losses, norms = [], []
    for batch in _global_batches():
        params, opt, met = step(params, opt, batch)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    return {"losses": losses, "norms": norms, "params": params}


@pytest.fixture(scope="module", params=list(MESHES))
def fsdp_run(request, tmp_path_factory):
    sizes = MESHES[request.param]
    return run_ranks(ranks.fsdp_rank, sizes[0] * sizes[1], sizes,
                     store_path=str(tmp_path_factory.mktemp(request.param)
                                    / "store"),
                     device="cpu", timeout_s=RANK_TIMEOUT_S)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    bound = rel * float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= bound


def test_fsdp_microbatched_steps_match_one_process(fsdp_run, one_process):
    for r in fsdp_run:
        assert len(r["losses"]) == TRAIN_STEPS
        np.testing.assert_allclose(r["losses"], one_process["losses"],
                                   rtol=REL_LOSS, atol=0)
        np.testing.assert_allclose(r["norms"], one_process["norms"],
                                   rtol=REL_LOSS, atol=0)
        assert r["losses"] == fsdp_run[0]["losses"]
    want = tree_leaves(one_process["params"])
    got = tree_leaves(fsdp_run[0]["params"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w.detach().numpy(), REL_LEAF)


def test_fsdp_gathers_a_layer_at_a_time(fsdp_run):
    """Each step's largest data-axis all-gather is one layer's shards times
    the data ranks, never the whole tree; each layer gathers in every
    microbatch's forward and again in its backward recompute."""
    for r in fsdp_run:
        bound = r["layer_shard_bytes"] * r["data_ranks"]
        assert 0 < max(r["gather_bytes"]) <= bound
        assert bound < r["tree_shard_bytes"] * r["data_ranks"]
        assert r["gathers"] == [2 * ranks.MICROBATCHES * r["layers"]] * \
            TRAIN_STEPS
