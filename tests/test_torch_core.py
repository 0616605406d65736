"""The port's code algebra, partitioning and coded layer against the JAX
reference (``repro``) on the same numpy inputs, on the CPU.

The code matrices and the cost model are float64 numpy on both sides and
must agree exactly; partition slicing moves values without arithmetic and
must agree exactly; encode/decode and the coded layer agree to fp32
tolerance (the two frameworks sum in different orders).
"""
import functools
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import crme as ref_crme
from repro.core import partition as ref_part
from repro.core.cost import optimal_partition as ref_optimal_partition
from repro.core.fcdcc import CodedConv2d as RefCodedConv2d
from repro.core.fcdcc import FcdccPlan as RefPlan
from repro.core.nsctc import decode_blocks as ref_decode_blocks
from repro.core.nsctc import encode_tensor_list as ref_encode
from repro.core.pipeline import relu_pool as ref_relu_pool
from repro.models import cnn as ref_cnn
from repro.models.cnn import CNN_SPECS as REF_SPECS
from repro_torch.core import crme, partition
from repro_torch.core.cost import optimal_partition
from repro_torch.core.fcdcc import CodedConv2d, FcdccPlan
from repro_torch.core.nsctc import decode_blocks, encode_tensor_list
from repro_torch.core.pipeline import relu_pool
from repro_torch.models.cnn import CNN_SPECS, layer_geometry

RNG = np.random.default_rng(7)
# fp32 tolerance: same products, summed in another order by each framework
FP32 = dict(rtol=1e-5, atol=1e-5)

PLANS = [(2, 4, 6), (4, 4, 6), (2, 2, 5), (1, 8, 4), (8, 1, 4), (2, 32, 20),
         (1, 1, 3)]


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _geo_pair(*args):
    return partition.ConvGeometry(*args), ref_part.ConvGeometry(*args)


# -- crme / cost -------------------------------------------------------------
@pytest.mark.parametrize("k_a,k_b,n", PLANS)
def test_crme_matrices_exact(k_a, k_b, n):
    a, b = crme.make_axis_codes(k_a, k_b, n)
    ra, rb = ref_crme.make_axis_codes(k_a, k_b, n)
    for got, want in ((a, ra), (b, rb)):
        assert (got.k, got.n, got.q, got.ell, got.base) == \
            (want.k, want.n, want.q, want.ell, want.base)
        assert np.array_equal(got.matrix, want.matrix)
    for i in range(n):
        assert np.array_equal(crme.joint_columns(a, b, i),
                              ref_crme.joint_columns(ra, rb, i))


@pytest.mark.parametrize("k_a,k_b,n", [(2, 4, 6), (4, 4, 6), (2, 2, 5),
                                       (1, 8, 4), (8, 1, 4), (4, 8, 9)])
def test_recovery_matrix_exact_every_subset(k_a, k_b, n):
    a, b = crme.make_axis_codes(k_a, k_b, n)
    ra, rb = ref_crme.make_axis_codes(k_a, k_b, n)
    delta = FcdccPlan(n, k_a, k_b).delta
    for ids in itertools.combinations(range(n), delta):
        e = crme.recovery_matrix(a, b, ids)
        assert np.array_equal(e, ref_crme.recovery_matrix(ra, rb, ids))
        assert crme.condition_number(e) == ref_crme.condition_number(e)


def test_crme_rejects_what_the_reference_rejects():
    for args in ((3, 2, 5), (2, 4, 1), (2, 2, 4, 4)):
        with pytest.raises(ValueError):
            ref_crme.make_axis_codes(*args)
        with pytest.raises(ValueError):
            crme.make_axis_codes(*args)


@pytest.mark.parametrize("arch", sorted(REF_SPECS))
@pytest.mark.parametrize("q", [4, 8, 16])
def test_optimal_partition_every_layer(arch, q):
    hw, layers = CNN_SPECS[arch]
    assert [l.name for l in layers] == [l.name for l in REF_SPECS[arch][1]]
    for layer in layers:
        geo = layer_geometry(layer, hw)
        rgeo = ref_cnn.layer_geometry(layer, hw)
        assert optimal_partition(geo, q) == ref_optimal_partition(rgeo, q)
        hw = geo.out_h // layer.pool


# -- partitioning ------------------------------------------------------------
GEOS = [
    (3, 8, 13, 11, 3, 3, 1, 1, 2, 4),
    (2, 8, 16, 9, 3, 2, 2, 0, 4, 4),
    (3, 16, 21, 13, 5, 3, 2, 2, 4, 8),
    (1, 6, 32, 32, 5, 5, 1, 0, 1, 8),
    (4, 5, 7, 7, 3, 3, 1, 1, 8, 1),
]


@pytest.mark.parametrize("args", GEOS)
@pytest.mark.parametrize("batched", [False, True])
def test_apcp_kccp_merge_exact(args, batched):
    geo, rgeo = _geo_pair(*args)
    for prop in ("out_h", "out_w", "h_hat", "s_hat", "in_h_needed",
                 "out_c_block", "out_h_block"):
        assert getattr(geo, prop) == getattr(rgeo, prop)
    shape = ((3,) if batched else ()) + (geo.in_channels, geo.height, geo.width)
    x = RNG.standard_normal(shape).astype(np.float32)
    np.testing.assert_array_equal(
        partition.apcp_partition(_t(x), geo).numpy(),
        np.asarray(ref_part.apcp_partition(jnp.asarray(x), rgeo)))
    k = RNG.standard_normal((geo.out_channels, geo.in_channels, geo.kernel_h,
                             geo.kernel_w)).astype(np.float32)
    np.testing.assert_array_equal(
        partition.kccp_partition(_t(k), geo).numpy(),
        np.asarray(ref_part.kccp_partition(jnp.asarray(k), rgeo)))
    q = geo.k_a * geo.k_b
    bshape = (q,) + ((3,) if batched else ()) + partition.block_output_shape(geo)
    blocks = RNG.standard_normal(bshape).astype(np.float32)
    np.testing.assert_array_equal(
        partition.merge_output(_t(blocks), geo).numpy(),
        np.asarray(ref_part.merge_output(jnp.asarray(blocks), rgeo)))
    np.testing.assert_array_equal(
        partition.partition_channel_merge(_t(blocks), geo).numpy(),
        np.asarray(ref_part.partition_channel_merge(jnp.asarray(blocks), rgeo)))


# (geo of layer i, pool, geo of layer i+1) — the reference's own transition
# cases: floor-crops, halos across boundaries, windows spanning >2
# partitions, degenerate axes, a last partition of pure zero-pad rows
TRANSITIONS = [
    ((1, 6, 32, 32, 5, 5, 1, 0, 2, 2), 1, (6, 16, 28, 28, 5, 5, 1, 0, 2, 2)),
    ((1, 6, 32, 32, 5, 5, 1, 0, 4, 2), 2, (6, 16, 14, 14, 5, 5, 1, 2, 2, 2)),
    ((3, 8, 13, 13, 3, 3, 1, 0, 4, 2), 2, (8, 8, 5, 5, 3, 3, 2, 1, 2, 1)),
    ((2, 4, 9, 9, 3, 3, 1, 0, 8, 1), 3, (4, 4, 2, 2, 1, 1, 1, 0, 2, 2)),
    ((2, 8, 12, 12, 3, 3, 1, 1, 1, 8), 2, (8, 8, 6, 6, 3, 3, 1, 1, 4, 1)),
    ((2, 4, 7, 7, 3, 3, 1, 0, 4, 2), 1, (4, 4, 5, 5, 3, 3, 1, 1, 4, 1)),
]


@pytest.mark.parametrize("g0,pool,g1", TRANSITIONS)
@pytest.mark.parametrize("batched,relu", [(True, True), (False, False)])
def test_partition_transition_exact(g0, pool, g1, batched, relu):
    geo, rgeo = _geo_pair(*g0)
    nxt, rnxt = _geo_pair(*g1)
    q = geo.k_a * geo.k_b
    shape = (q,) + ((3,) if batched else ()) + partition.block_output_shape(geo)
    blocks = RNG.standard_normal(shape).astype(np.float32)
    got = partition.partition_transition(_t(blocks), geo, pool, nxt, relu=relu)
    want = ref_part.partition_transition(jnp.asarray(blocks), rgeo, pool, rnxt,
                                         relu=relu)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert partition.partition_pool_bounds(geo, pool) == \
        ref_part.partition_pool_bounds(rgeo, pool)


@pytest.mark.parametrize("pool", [1, 2, 3])
def test_relu_pool_exact(pool):
    y = RNG.standard_normal((2, 3, 7, 9)).astype(np.float32)
    np.testing.assert_array_equal(relu_pool(_t(y), pool).numpy(),
                                  np.asarray(ref_relu_pool(jnp.asarray(y), pool)))


# -- NSCTC encode / decode ---------------------------------------------------
@pytest.mark.parametrize("k_a,k_b,n", [(2, 4, 6), (4, 2, 5), (4, 4, 9)])
def test_encode_decode_matches_reference(k_a, k_b, n):
    a, b = crme.make_axis_codes(k_a, k_b, n)
    ra, rb = ref_crme.make_axis_codes(k_a, k_b, n)
    parts = RNG.standard_normal((k_a, 2, 3, 5, 4)).astype(np.float32)
    np.testing.assert_allclose(
        encode_tensor_list(_t(parts), a.matrix).numpy(),
        np.asarray(ref_encode(jnp.asarray(parts), ra.matrix)), **FP32)
    delta = FcdccPlan(n, k_a, k_b).delta
    ell2 = a.ell * b.ell
    outs = RNG.standard_normal((delta, ell2, 2, 3, 4)).astype(np.float32)
    ids = list(range(n))[-delta:]
    np.testing.assert_allclose(
        decode_blocks(a, b, ids, _t(outs), (2, 3, 4)).numpy(),
        np.asarray(ref_decode_blocks(ra, rb, ids, jnp.asarray(outs), (2, 3, 4))),
        rtol=1e-4, atol=1e-4)


# -- the coded layer ---------------------------------------------------------
LAYER_CASES = [
    # n, k_a, k_b, (C, H, W, N, KH, KW, stride, padding), batch
    (4, 2, 4, (3, 13, 11, 8, 3, 3, 1, 1), None),
    (6, 2, 4, (3, 13, 11, 8, 3, 3, 1, 1), 3),
    (6, 4, 4, (2, 16, 9, 8, 3, 2, 2, 0), 2),
    (4, 1, 8, (3, 13, 11, 8, 3, 3, 1, 1), None),
    (4, 8, 1, (3, 13, 11, 8, 3, 3, 1, 1), 2),
]


@functools.lru_cache(maxsize=None)
def _reference_layer(case: int):
    """Inputs of one LAYER_CASES entry and the reference's output for every
    delta-subset (computed once, shared by the four port variants)."""
    n, k_a, k_b, dims, batch = LAYER_CASES[case]
    c, h, w, nout, kh, kw, s, p = dims
    rng = np.random.default_rng(case)
    xshape = ((batch,) if batch else ()) + (c, h, w)
    x = rng.standard_normal(xshape).astype(np.float32)
    k = rng.standard_normal((nout, c, kh, kw)).astype(np.float32)
    ref = RefCodedConv2d(RefPlan(n, k_a, k_b),
                         ref_part.ConvGeometry(c, nout, h, w, kh, kw, s, p, k_a, k_b))
    delta = RefPlan(n, k_a, k_b).delta
    outs = {ids: np.asarray(ref.run_simulated(jnp.asarray(x), jnp.asarray(k), list(ids)))
            for ids in itertools.combinations(range(n), delta)}
    return x, k, outs


@pytest.mark.parametrize("case", range(len(LAYER_CASES)))
@pytest.mark.parametrize("backend,fused", [("kernel", True), ("kernel", False),
                                           ("torch", True), ("torch", False)])
def test_coded_layer_every_subset(case, backend, fused):
    """run_simulated of the port == the reference's for every delta-subset,
    on both backends, fused and paper-literal workers."""
    n, k_a, k_b, dims, _ = LAYER_CASES[case]
    c, h, w, nout, kh, kw, s, p = dims
    geo = partition.ConvGeometry(c, nout, h, w, kh, kw, s, p, k_a, k_b)
    layer = CodedConv2d(FcdccPlan(n, k_a, k_b), geo, backend=backend,
                        fused_worker=fused)
    x, k, outs = _reference_layer(case)
    for ids, want in outs.items():
        got = layer.run_simulated(_t(x), _t(k), list(ids))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert layer.filter_encode_calls == len(outs)
