"""The dry run of the recurrent and encoder-decoder families (RWKV6, Hymba,
Whisper) over the production meshes, where each rank runs its cut of
every leaf and cache over ``model`` (``models/rwkv6.py``, ``hymba.py``,
``whisper.py``), against the reference's ``launch/dryrun.py``, on the CPU.

The reference's cells are lowered in subprocesses as in
``tests/test_torch_dryrun.py`` (whose ``_Reference`` this reuses).  Held,
at smoke scale 16, for one cell a family (RWKV6 ``train_4k``, Hymba and
Whisper ``decode_32k``): product FLOPs on the 1 x 1 mesh equal to the
reference's (RWKV6's less three products a layer that its scan's
backward spends on zero cotangents), argument bytes there and per
device on 16 x 16 equal to the reference's (counting, as ``jax.jit``
keeps, only the arguments the step reads: Whisper's decode reads no
encoder weight and no cross ``wk``/``wv``); and every cell of
the three families on both production meshes traces ``ok`` (the 22 cells
the dry run recorded as errors before these families ran over
``model``), on the fake mesh without the reference.
"""
from __future__ import annotations

import pytest
import torch.distributed as dist

from repro_torch.configs import get_bundle
from repro_torch.configs.shapes import SHAPES, batch_structs
from repro_torch.launch import dryrun
from test_torch_dryrun import MESHES, _Reference, _ref_cell

CELLS = [("rwkv6-1.6b", "train_4k"), ("hymba-1.5b", "decode_32k"),
         ("whisper-medium", "decode_32k")]
ARCHS = ("rwkv6-1.6b", "hymba-1.5b", "whisper-medium")
# Whisper is not sub-quadratic: its long_500k is skipped by design
FORMER_ERRORS = [(a, s, m) for m in ("16x16", "2x16x16") for a in ARCHS
                 for s in SHAPES if (a, s) != ("whisper-medium", "long_500k")]


@pytest.fixture(scope="module")
def ref():
    r = _Reference([[_ref_cell(a, s, "1x1", 16) for a, s in CELLS],
                    [_ref_cell(a, s, "16x16", 16) for a, s in CELLS]])
    yield r
    r.close()


def _trace(arch, shape, mesh):
    sizes, names = MESHES[mesh]
    with dryrun.fake_mesh(sizes, names) as m:
        counter, out, meta = dryrun.lower_cell(arch, shape, m, smoke_scale=16)
    assert not dist.is_initialized()
    return counter, out, meta


def _zero_cotangent_products(arch, shape) -> int:
    """The products the reference's train step computes and the port's
    does not: its chunk scan (``lax.scan``) transposes one loop body for
    every chunk, so it takes the cotangent of the first chunk's initial
    state (a constant) and, from the last chunk's final state (unused, a
    zero cotangent), of its state update's two operands; autograd skips
    all three.  Each is 2 B H C dk dv a layer."""
    bundle = get_bundle(arch)
    if SHAPES[shape]["kind"] != "train" or bundle.family != "ssm":
        return 0
    cfg = bundle.cfg
    b, t = batch_structs(bundle, shape, smoke_scale=16)[0]["tokens"].shape
    c = min(cfg.chunk, t)
    return cfg.layers * 3 * 2 * b * cfg.n_heads * c * cfg.head_dim ** 2


@pytest.mark.parametrize("arch,shape", CELLS)
def test_product_flops_on_one_device_equal_the_reference(ref, arch, shape):
    """Equal, less the three zero-cotangent products a layer of the
    reference's scan backward (RWKV6's train step)."""
    counter, out, _ = _trace(arch, shape, "1x1")
    r = ref.get(arch, shape, "1x1", 16)
    want = int(r["dot_flops"]) - _zero_cotangent_products(arch, shape)
    assert int(counter.cost.dot_flops) == want
    assert counter.memory(out)["argument_size_in_bytes"] == \
        r["argument_size_in_bytes"]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_argument_bytes_per_device_equal_the_reference(ref, arch, shape):
    counter, out, _ = _trace(arch, shape, "16x16")
    mem = counter.memory(out)
    assert mem["argument_size_in_bytes"] == \
        ref.get(arch, shape, "16x16", 16)["argument_size_in_bytes"]
    assert counter.by_axis["model"]["calls"] > 0


def test_the_former_error_cells_are_the_families_cells():
    """22 cells: RWKV6's and Hymba's four shapes and Whisper's three, on
    each production mesh."""
    assert len(FORMER_ERRORS) == 22


@pytest.mark.parametrize("arch,shape,mesh", FORMER_ERRORS)
def test_cell_traces_over_the_model_axis(arch, shape, mesh):
    """The cell's step runs once on meta tensors as rank 0 of the mesh,
    its collectives over ``model`` counted."""
    counter, out, _ = _trace(arch, shape, mesh)
    assert counter.by_axis["model"]["calls"] > 0
    assert counter.memory(out)["argument_size_in_bytes"] > 0
