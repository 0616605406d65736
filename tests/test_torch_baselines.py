"""The port's code baselines and the small core functions against the
reference's.

The polynomial (real Vandermonde and Chebyshev) codes stay float64 numpy
in both packages, so their points, code matrices, recovery matrices and
condition numbers are held to exact equality, over the survivor subsets
``tests/test_stability.py`` draws.  The uncoded splits of Table II run
fp32 convolutions on both sides (XLA's against PyTorch's, summing in
another order): within 1e-5 of max|reference|.  ``continuous_optimum``
and ``np_reference_conv`` are the same float arithmetic: equal.
``encode_from_partitions`` is one fp32 tensordot against the reference's
einsum: within 1e-6 of max|reference|.

Also here: the fp32 guard on the ``backend="torch"`` convolutions
(``core/fcdcc.py``) and the splits — every ``F.conv2d`` runs with cuDNN's
TF32 off, whatever the process's flag.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as ref_bl
from repro.core.cost import continuous_optimum as ref_continuous_optimum
from repro.core.fcdcc import CodedConv2d as RefCodedConv2d
from repro.core.fcdcc import FcdccPlan as RefPlan
from repro.core.partition import ConvGeometry as RefGeometry
from repro.core.partition import apcp_partition as ref_apcp
from repro.core.partition import np_reference_conv as ref_np_conv
from repro.models.cnn import CNN_SPECS as REF_SPECS
from repro.models.cnn import layer_geometry as ref_layer_geometry
from repro_torch.core import baselines, fcdcc
from repro_torch.core.cost import CostWeights, continuous_optimum
from repro_torch.core.fcdcc import CodedConv2d, FcdccPlan
from repro_torch.core.partition import ConvGeometry, apcp_partition, np_reference_conv
from repro_torch.models.cnn import CNN_SPECS, layer_geometry

TOL_SPLIT, TOL_ENCODE = 1e-5, 1e-6
POINTS = [baselines.real_points, baselines.chebyshev_points]
REF_POINTS = {baselines.real_points: ref_bl.real_points,
              baselines.chebyshev_points: ref_bl.chebyshev_points}
# (k_a, k_b, n) of the stability test (2, delta/2 = 8, 20) and smaller ones
CODES = [(2, 8, 20), (2, 2, 6), (1, 4, 5), (2, 4, 10)]


def _subsets(n, delta, trials=20, seed=0):
    """The survivor subsets ``tests/test_stability.py``'s ``_worst_cond``
    draws."""
    rng = np.random.default_rng(seed)
    return [sorted(rng.choice(n, delta, replace=False).tolist())
            for _ in range(trials)]


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


# -- the polynomial codes ------------------------------------------------------
@pytest.mark.parametrize("points", POINTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("n", [2, 5, 8, 20])
def test_points_exact(points, n):
    got, want = points(n), REF_POINTS[points](n)
    assert got.dtype == want.dtype == np.float64
    assert np.array_equal(got, want)


@pytest.mark.parametrize("points", POINTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("k_a,k_b,n", CODES)
def test_code_matrices_exact(points, k_a, k_b, n):
    a, b = baselines.make_poly_codes(k_a, k_b, n, points(n))
    ra, rb = ref_bl.make_poly_codes(k_a, k_b, n, REF_POINTS[points](n))
    for got, want in ((a, ra), (b, rb)):
        assert (got.k, got.n, got.ell, got.base) == (want.k, want.n, want.ell,
                                                     want.base)
        assert got.matrix.dtype == np.float64
        assert np.array_equal(got.matrix, want.matrix)
        for i in range(n):
            assert np.array_equal(got.worker_columns(i), want.worker_columns(i))


@pytest.mark.parametrize("points", POINTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("k_a,k_b,n", CODES)
def test_recovery_matrix_and_condition_exact(points, k_a, k_b, n):
    a, b = baselines.make_poly_codes(k_a, k_b, n, points(n))
    ra, rb = ref_bl.make_poly_codes(k_a, k_b, n, REF_POINTS[points](n))
    for sub in _subsets(n, k_a * k_b):
        e = baselines.poly_recovery_matrix(a, b, sub)
        re = ref_bl.poly_recovery_matrix(ra, rb, sub)
        assert e.dtype == np.float64 and np.array_equal(e, re)
        assert np.linalg.cond(e) == np.linalg.cond(re)


def test_recovery_matrix_rejects_a_short_subset():
    a, b = baselines.make_poly_codes(2, 2, 6, baselines.real_points(6))
    with pytest.raises(AssertionError):
        baselines.poly_recovery_matrix(a, b, [0, 1, 2])


# -- the uncoded splits of Table II -------------------------------------------
SPLITS = [
    ("uncoded_spatial", (6, 17, 13), (8, 6, 3, 3), 1, 1, 2),
    ("uncoded_spatial", (4, 20, 20), (6, 4, 5, 5), 2, 2, 4),
    ("uncoded_out_channel", (6, 12, 12), (8, 6, 3, 3), 1, 1, 4),
    ("uncoded_out_channel", (3, 15, 11), (6, 3, 3, 3), 2, 0, 2),
    ("uncoded_in_channel", (8, 12, 12), (4, 8, 3, 3), 1, 1, 4),
    ("uncoded_in_channel", (6, 13, 9), (5, 6, 3, 3), 2, 1, 2),
]


@pytest.mark.parametrize("name,xs,ks,stride,padding,parts", SPLITS)
def test_uncoded_split_matches_reference(name, xs, ks, stride, padding, parts):
    rng = np.random.default_rng(sum(xs) + 7 * stride + padding)
    x = rng.standard_normal(xs).astype(np.float32)
    k = rng.standard_normal(ks).astype(np.float32)
    got = getattr(baselines, name)(torch.as_tensor(x), torch.as_tensor(k),
                                   stride, padding, parts)
    want = getattr(ref_bl, name)(jnp.asarray(x), jnp.asarray(k), stride,
                                 padding, parts)
    assert got.dtype == torch.float32
    assert _rel(got, want) <= TOL_SPLIT
    # and the split computes the whole convolution
    assert _rel(got, ref_np_conv(x, k, stride, padding)) <= TOL_SPLIT


# -- the small functions -------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(CNN_SPECS))
@pytest.mark.parametrize("q", [4, 8, 16])
def test_continuous_optimum_equal(arch, q):
    hw, layers = CNN_SPECS[arch]
    _, ref_layers = REF_SPECS[arch]
    w = CostWeights()
    for layer, ref_layer in zip(layers, ref_layers):
        got = continuous_optimum(layer_geometry(layer, hw), q, w)
        want = ref_continuous_optimum(ref_layer_geometry(ref_layer, hw), q)
        assert got == want
    flat = ConvGeometry(3, 8, 12, 12, 3, 3)
    assert continuous_optimum(flat, 4, CostWeights(store=0.0)) == float("inf")


@pytest.mark.parametrize("stride,padding", [(1, 0), (1, 1), (2, 1), (3, 2)])
def test_np_reference_conv_equal(stride, padding):
    rng = np.random.default_rng(stride * 10 + padding)
    x = rng.standard_normal((3, 11, 9))
    k = rng.standard_normal((4, 3, 3, 3))
    got = np_reference_conv(x, k, stride, padding)
    want = ref_np_conv(x, k, stride, padding)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("k_a,k_b,n", [(2, 2, 5), (4, 2, 8), (1, 4, 4)])
@pytest.mark.parametrize("batched", [False, True])
def test_encode_from_partitions_matches_reference(k_a, k_b, n, batched):
    geo = ConvGeometry(4, 8, 14, 10, 3, 3, 1, 1, k_a, k_b)
    ref_geo = RefGeometry(4, 8, 14, 10, 3, 3, 1, 1, k_a, k_b)
    layer = CodedConv2d(FcdccPlan(n, k_a, k_b), geo)
    ref_layer = RefCodedConv2d(RefPlan(n, k_a, k_b), ref_geo)
    rng = np.random.default_rng(k_a * 100 + n)
    x = rng.standard_normal((2, 4, 14, 10) if batched else (4, 14, 10)
                            ).astype(np.float32)
    parts = apcp_partition(torch.as_tensor(x), geo)
    got = layer.encode_from_partitions(parts)
    want = ref_layer.encode_from_partitions(ref_apcp(jnp.asarray(x), ref_geo))
    assert _rel(got, want) <= TOL_ENCODE
    assert layer.input_encode_calls == 1
    # the same shares as encode_inputs, which partitions first
    assert torch.equal(got, layer.encode_inputs(torch.as_tensor(x)))
    # a column subset, as the transitions pass it
    m = layer.a_code.matrix[:, :2]
    assert _rel(layer.encode_from_partitions(parts, m),
                ref_layer.encode_from_partitions(
                    ref_apcp(jnp.asarray(x), ref_geo), m)) <= TOL_ENCODE


# -- the fp32 guard ------------------------------------------------------------
@pytest.fixture
def tf32_seen(monkeypatch):
    """Turns the process's cuDNN TF32 flag on (PyTorch's default on a card)
    and records the flag inside every ``F.conv2d`` call of the port's coded
    layer and baselines."""
    seen = []
    real = torch.nn.functional.conv2d

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return real(*args, **kwargs)

    monkeypatch.setattr(fcdcc.F, "conv2d", spy)
    monkeypatch.setattr(baselines.F, "conv2d", spy)
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    yield seen
    torch.backends.cudnn.allow_tf32 = old


@pytest.mark.parametrize("fused_worker", [True, False])
def test_torch_backend_convs_run_without_tf32(tf32_seen, fused_worker):
    geo = ConvGeometry(3, 8, 10, 10, 3, 3, 1, 1, 2, 2)
    layer = CodedConv2d(FcdccPlan(5, 2, 2), geo, backend="torch",
                        fused_worker=fused_worker)
    x, k = torch.randn(2, 3, 10, 10), torch.randn(8, 3, 3, 3)
    layer.run_simulated(x, k)
    assert tf32_seen and not any(tf32_seen)
    assert torch.backends.cudnn.allow_tf32  # the process's flag is left as it was


def test_uncoded_splits_run_without_tf32(tf32_seen):
    x, k = torch.randn(4, 12, 12), torch.randn(8, 4, 3, 3)
    baselines.uncoded_spatial(x, k, 1, 1, 2)
    baselines.uncoded_out_channel(x, k, 1, 1, 2)
    baselines.uncoded_in_channel(x, k, 1, 1, 2)
    assert len(tf32_seen) == 6 and not any(tf32_seen)
