"""DeepSeek-V3-671B traced at full size by the port's dry run
(``repro_torch.launch.dryrun``) on the single-pod production mesh: its
decode and train cells run as rank 0 of 256 fake ranks, on meta tensors,
and record ``status: "ok"``; the per-rank argument bytes they record equal
the rank's shard of every input, reckoned apart from the specs
(``steps.batch_pspecs`` / ``cache_pspecs`` / ``opt_state_pspecs`` and the
params' ``schema_pspecs``).  Its own file: the train cell's trace (8
microbatches of 61 layers, forward, recomputed forward and backward) takes
most of a minute and a half on one core."""
from __future__ import annotations

import math

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.shapes import SHAPES, batch_structs
from repro_torch.launch import dryrun, steps
from repro_torch.models.common import schema_pspecs
from repro_torch.sharding import spec_axes
from repro_torch.tree import tree_leaves, tree_map

ARCH = "deepseek-v3-671b"


def _shard_bytes(tree, specs, mesh_shape) -> int:
    """The bytes of this rank's shard of every leaf of ``tree``, each cut
    over the mesh axes its spec names."""
    def one(leaf, spec):
        ranks = math.prod(mesh_shape[a] for entry in spec
                          for a in spec_axes(entry))
        nbytes = leaf.numel() * leaf.element_size()
        assert nbytes % ranks == 0
        return nbytes // ranks

    return sum(tree_leaves(tree_map(one, tree, specs)))


def _expected(shape: str) -> int:
    mesh = dryrun.make_production_mesh()
    bundle = dryrun.cell_bundle(ARCH, shape, mesh)
    batch, cache = batch_structs(bundle, shape)
    total = _shard_bytes(batch, steps.batch_pspecs(bundle, batch, mesh),
                         mesh.shape)
    if SHAPES[shape]["kind"] == "train":
        tcfg = dryrun.train_config(bundle)
        assert tcfg.fsdp and tcfg.microbatches == 8
        pspecs = schema_pspecs(bundle.schema, mesh, fsdp=True)
        total += _shard_bytes(bundle.param_shapes(torch.bfloat16), pspecs,
                              mesh.shape)
        total += _shard_bytes(steps.make_opt_shapes(bundle, torch.bfloat16),
                              steps.opt_state_pspecs(pspecs), mesh.shape)
    else:
        total += _shard_bytes(bundle.param_shapes(torch.bfloat16),
                              schema_pspecs(bundle.schema, mesh), mesh.shape)
        total += _shard_bytes(cache, steps.cache_pspecs(bundle, cache, mesh),
                              mesh.shape)
    return total


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_deepseek_v3_traces_at_full_size(tmp_path, monkeypatch, shape):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    rec = dryrun.run_cell(ARCH, shape, multi_pod=False)
    assert not dist.is_initialized()
    assert rec["status"] == "ok", rec.get("error")
    assert rec["devices"] == 256 and rec["smoke_scale"] is None
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == _expected(shape)
    assert mem["temp_size_in_bytes"] > 0
    assert rec["cost"]["dot_flops"] > 0 and rec["cost"]["collective_bytes"] > 0
    assert rec["by_axis"]["model"]["calls"] > 0
