"""The precision argument for K1's tensor-core route, on the CPU.

K1's tensor-core kernel computes each fp32 product as three TF32 ones
(3xTF32): every operand is split into a TF32 high and low part, ``a = hi
+ lo``, and ``lo*hi + hi*lo + hi*hi`` is summed in fp32.  The CRME decode
multiplies rounding error by the recovery matrix's condition number, so
one TF32 product (10 mantissa bits) would not hold the served results to
1e-4 of the uncoded stack.  ``split_tf32`` and
``coded_worker_3xtf32_plain`` are that arithmetic in torch ops; here they
are held to

  * the split's contract: hi and lo keep 10 mantissa bits (the low 13 bits
    of their fp32 patterns are zero) and ``hi + lo`` is within 2^-22 of
    ``|a|`` (plus half the TF32 subnormal spacing, 2^-137, where lo
    falls below the normal range), on ties, subnormals, the float maximum
    and the values around it; inf and NaN pass through into hi;
  * the reference's ``coded_worker_pallas`` in interpret mode, within 1e-5
    of max|reference|, on ``tests/test_torch_kernels.py``'s cases;
  * a small coded stack, VGG-16's first four layers at 32x32 on n = 8,
    (k_a, k_b) = (2, 4), decoded from each of the 28 survivor pairs:
    within 1e-4 of the uncoded stack (float64), and at most 1/10 of the
    error of one TF32 product on the same draw, so the check tells the two
    apart.  The tensor cores' own accumulation inside one ``wgmma`` is not
    modelled here (products are exact in fp32 and summed in fp32): the
    card holds the kernel to the fp32 path's error against float64
    (``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.conv2d.kernel import coded_worker_pallas
from repro_torch.core.fcdcc import CodedConv2d, FcdccPlan
from repro_torch.core.pipeline import relu_pool
from repro_torch.kernels.conv2d import kernel as k1
from repro_torch.models.cnn import CNN_SPECS, layer_geometry
from test_torch_kernels import WORKER_CASES, _worker_inputs

RNG = np.random.default_rng(32)
TF32_DROP = 0x1FFF  # the mantissa bits TF32 does not keep
TF32_MAX = np.uint32(0x7F7FE000).view(np.float32)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _edges() -> np.ndarray:
    """Ties (half a TF32 step above a TF32 value, both signs), subnormals,
    the smallest normals, the float maximum and the values just below
    the TF32 overflow, zeros, and random normals over the exponent
    range."""
    f32 = np.finfo(np.float32)
    ties = [np.float32(1 + 2.0 ** -11), np.float32(3 * 2.0 ** -12 + 1),
            np.float32(1.5 + 2.0 ** -11), np.float32(2.0 ** 100 * (1 + 2.0 ** -11))]
    sub = np.array([0x1, 0x2, 0x1000, 0x1FFF, 0x3000, 0x7FFFFF, 0x400000,
                    0x12345], dtype=np.uint32).view(np.float32)
    top = np.array([0x7F7FFFFF, 0x7F7FF000, 0x7F7FEFFF, 0x7F7FE000,
                    0x7F7FE001, 0x00800000, 0x00801000, 0x00800FFF],
                   dtype=np.uint32).view(np.float32)
    rand = (RNG.standard_normal(256) * np.exp2(RNG.integers(-120, 120, 256))
            ).astype(np.float32)
    vals = np.concatenate([ties, sub, top, rand, [0.0, -0.0, f32.max, f32.tiny]])
    return np.concatenate([vals, -vals]).astype(np.float32)


def test_split_keeps_ten_mantissa_bits_and_the_value():
    a = torch.as_tensor(_edges())
    hi, lo = k1.split_tf32(a)
    assert not (_bits(hi) & TF32_DROP).any()
    assert not (_bits(lo) & TF32_DROP).any()
    a64, s64 = a.double(), hi.double() + lo.double()
    assert torch.isfinite(hi).all() and torch.isfinite(lo).all()
    err = (s64 - a64).abs()
    assert bool((err <= 2.0 ** -22 * a64.abs() + 2.0 ** -137).all()), \
        float((err / a64.abs().clamp_min(1e-300)).max())


def test_split_rounds_to_nearest_with_ties_away():
    one_tie = np.float32(1 + 2.0 ** -11)  # halfway between 1 and 1 + 2^-10
    a = torch.tensor([one_tie, -one_tie, np.float32(1 + 2.0 ** -12),
                      np.float32(1 + 3 * 2.0 ** -12)])
    hi, lo = k1.split_tf32(a)
    assert hi.tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0, 1 + 2.0 ** -10]
    assert (hi + lo).tolist() == a.tolist()


def test_split_saturates_and_passes_inf_and_nan():
    big = np.array([0x7F7FF000, 0x7F7FFFFF], dtype=np.uint32).view(np.float32)
    a = torch.as_tensor(np.concatenate([big, -big, [np.inf, -np.inf, np.nan]])
                        .astype(np.float32))
    hi, lo = k1.split_tf32(a)
    assert hi[:4].abs().eq(float(TF32_MAX)).all()
    assert torch.equal(hi[:4].sign(), a[:4].sign())
    assert hi[4:6].tolist() == [np.inf, -np.inf] and torch.isnan(hi[6])
    assert lo[4:].eq(0).all()
    with pytest.raises(TypeError):
        k1.split_tf32(a.double())


@pytest.mark.parametrize("case", WORKER_CASES)
def test_3xtf32_worker_matches_pallas(case):
    xe, ke, stride = _worker_inputs(case, np.random.default_rng(11))
    want = np.asarray(coded_worker_pallas(jnp.asarray(xe), jnp.asarray(ke), stride))
    got = k1.coded_worker_3xtf32_plain(torch.as_tensor(xe), torch.as_tensor(ke),
                                       stride)
    assert tuple(got.shape) == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * scale)


def _tf32_worker(xe, ke, stride):
    """One TF32 product a multiply-add: the high parts only."""
    w = ke.reshape(ke.shape[0] * ke.shape[1], -1)
    y = k1.coded_worker_plain(k1.split_tf32(xe)[0],
                              k1.split_tf32(w)[0].reshape(ke.shape), stride)
    return y


STACK = CNN_SPECS["vgg16"][1][:4]
HW, N, KAB = 32, 8, (2, 4)


@pytest.fixture(scope="module")
def stack():
    gen = np.random.default_rng(4)
    x = gen.standard_normal((1, 3, HW, HW)).astype(np.float32)
    params = {l.name: (gen.standard_normal((l.out_ch, l.in_ch, l.kernel, l.kernel))
                       / np.sqrt(l.in_ch * l.kernel ** 2)).astype(np.float32)
              for l in STACK}
    ref = torch.as_tensor(x).double()
    for l in STACK:
        ref = relu_pool(F.conv2d(ref, torch.as_tensor(params[l.name]).double(),
                                 padding=l.padding), l.pool)
    return x, params, ref


def _coded(x, params, ids, worker):
    """The four layers coded with the A and B codes, each worker's subtask
    through ``worker``, decoded from the survivors ``ids``."""
    plan = FcdccPlan(N, *KAB)
    h = torch.as_tensor(x)
    hw = HW
    for l in STACK:
        conv = CodedConv2d(plan, layer_geometry(l, hw, *KAB))
        xe = conv.encode_inputs(h)
        ke = conv.encode_filters(torch.as_tensor(params[l.name]))
        outs = torch.stack([worker(xe[i].contiguous(), ke[i].contiguous(), l.stride)
                            for i in ids])
        h = relu_pool(conv.decode(ids, outs), l.pool)
        hw //= l.pool
    return h


def test_coded_stack_over_every_survivor_pair(stack):
    x, params, ref = stack
    scale = float(ref.abs().max())
    pairs = list(itertools.combinations(range(N), FcdccPlan(N, *KAB).delta))
    assert len(pairs) == 28
    worst3 = worst1 = 0.0
    for ids in pairs:
        err3 = float((_coded(x, params, ids, k1.coded_worker_3xtf32_plain)
                      .double() - ref).abs().max()) / scale
        err1 = float((_coded(x, params, ids, _tf32_worker)
                      .double() - ref).abs().max()) / scale
        assert err3 <= 1e-4, (ids, err3)
        assert err3 <= err1 / 10, (ids, err3, err1)
        worst3, worst1 = max(worst3, err3), max(worst1, err1)
    # one TF32 product is what the decode cannot take at this tolerance's
    # margin; 3xTF32 sits at fp32 rounding
    assert worst1 > 10 * worst3
