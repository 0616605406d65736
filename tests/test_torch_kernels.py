"""The port's kernels (K1 worker conv, K2 GEMM) against the reference's
Pallas kernels run in interpret mode, on the same numpy inputs.

On the CPU a wrapper runs its kernel's plain PyTorch version, so these
cases hold the plain versions (the functions the CUDA kernels are held to
on the card) against ``coded_worker_pallas`` / ``matmul_pallas``.  The
reference sums fp32 in 128-wide K chunks, the plain versions in another
order: agreement is to about 1e-5 relative, not bit equality.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py``.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import partition as ref_part
from repro.kernels.conv2d.kernel import (coded_transition_pallas,
                                         coded_worker_pallas,
                                         conv2d_im2col_pallas)
from repro.kernels.matmul.kernel import matmul_pallas
from repro_torch.core import partition
from repro_torch.kernels.conv2d import kernel as k1
from repro_torch.kernels.conv2d.ops import (coded_transition, coded_worker,
                                            conv2d_im2col)
from repro_torch.kernels.matmul import kernel as k2
from repro_torch.kernels.native import LaunchCounter

RNG = np.random.default_rng(11)
REL = 1e-5  # relative to max|reference|: fp32 sums in another order


def _close(got: torch.Tensor, want, rel=REL):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=rel, atol=rel * scale)


# (ell_a, B or None, C, h_hat, Wp, ell_b, N/k_b, KH, KW, stride): the
# reference's worker-kernel geometries (tests/test_kernels.py)
WORKER_CASES = [
    (2, 2, 3, 18, 32, 2, 4, 5, 5, 1),
    (2, 1, 1, 9, 9, 2, 2, 3, 3, 2),
    (1, 2, 4, 16, 16, 2, 3, 3, 3, 1),
    (3, 1, 2, 11, 13, 1, 4, 3, 5, 1),
    (2, 2, 8, 10, 16, 2, 4, 1, 1, 1),
    (2, None, 3, 14, 14, 2, 4, 3, 3, 1),
    (2, 2, 8, 12, 16, 2, 8, 3, 3, 1),
    (1, None, 4, 17, 17, 1, 6, 5, 5, 2),
    (3, 1, 16, 10, 10, 2, 16, 1, 1, 1),
    (1, None, 2, 9, 9, 3, 5, 2, 2, 1),
]


def _worker_inputs(case, rng=RNG):
    ea, b, c, hh, wp, eb, nb, kh, kw, stride = case
    xshape = (ea, b, c, hh, wp) if b else (ea, c, hh, wp)
    xe = rng.standard_normal(xshape).astype(np.float32)
    ke = rng.standard_normal((eb, nb, c, kh, kw)).astype(np.float32)
    return xe, ke, stride


@pytest.mark.parametrize("case", WORKER_CASES)
def test_worker_plain_matches_pallas(case):
    xe, ke, stride = _worker_inputs(case)
    want = coded_worker_pallas(jnp.asarray(xe), jnp.asarray(ke), stride)
    got = k1.coded_worker_plain(torch.as_tensor(xe), torch.as_tensor(ke), stride)
    _close(got, want)
    # the wrapper takes the plain version for CPU tensors, and only then
    assert torch.equal(coded_worker(torch.as_tensor(xe), torch.as_tensor(ke),
                                    stride), got)


@pytest.mark.parametrize("shape", [
    (3, 12, 10, 8, 3, 3, 1, 1),
    (2, 16, 9, 5, 3, 2, 2, 0),
    (1, 7, 7, 4, 5, 5, 1, 2),
    (4, 9, 9, 3, 1, 1, 1, 0),
])
def test_conv2d_im2col_matches_pallas(shape):
    c, h, w, n, kh, kw, s, p = shape
    x = RNG.standard_normal((c, h, w)).astype(np.float32)
    k = RNG.standard_normal((n, c, kh, kw)).astype(np.float32)
    want = conv2d_im2col_pallas(jnp.asarray(x), jnp.asarray(k), s, p)
    _close(conv2d_im2col(torch.as_tensor(x), torch.as_tensor(k), s, p), want)


MATMUL_SHAPES = [(7, 5, 9), (128, 128, 128), (130, 257, 64), (1, 300, 1),
                 (200, 64, 384), (8, 8, 8), (129, 1, 129), (16, 16, 3600),
                 (8, 8, 5000), (16, 2, 4099)]


@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
@pytest.mark.parametrize("relu", [False, True])
def test_matmul_plain_matches_pallas(m, k, n, relu):
    a = RNG.standard_normal((m, k)).astype(np.float32)
    b = RNG.standard_normal((k, n)).astype(np.float32)
    want = matmul_pallas(jnp.asarray(a), jnp.asarray(b), relu=relu)
    got = k2.matmul(torch.as_tensor(a), torch.as_tensor(b), relu=relu)
    _close(got, want)
    if relu:
        assert (got >= 0).all()


@pytest.mark.parametrize("g0,pool,g1", [
    ((1, 6, 32, 32, 5, 5, 1, 0, 4, 2), 2, (6, 16, 14, 14, 5, 5, 1, 2, 2, 2)),
    ((3, 8, 13, 13, 3, 3, 1, 0, 4, 2), 2, (8, 8, 5, 5, 3, 3, 2, 1, 2, 1)),
    ((2, 8, 12, 12, 3, 3, 1, 1, 2, 4), 2, (8, 8, 6, 6, 3, 3, 1, 1, 4, 1)),
])
def test_coded_transition_matches_pallas(g0, pool, g1):
    """decode GEMM (ReLU epilogue) -> partition re-slice -> encode GEMM."""
    geo, rgeo = partition.ConvGeometry(*g0), ref_part.ConvGeometry(*g0)
    nxt, rnxt = partition.ConvGeometry(*g1), ref_part.ConvGeometry(*g1)
    q = geo.k_a * geo.k_b
    ell2 = (1 if geo.k_a == 1 else 2) * (1 if geo.k_b == 1 else 2)
    outs = RNG.standard_normal((q // ell2, ell2, 2)
                               + partition.block_output_shape(geo)).astype(np.float32)
    d = RNG.standard_normal((q, q)).astype(np.float32)
    m_next = RNG.standard_normal((nxt.k_a, 2 * 5)).astype(np.float32)
    want = coded_transition_pallas(
        jnp.asarray(outs), jnp.asarray(d), jnp.asarray(m_next),
        lambda blk: ref_part.partition_transition(blk, rgeo, pool, rnxt))
    got = coded_transition(
        torch.as_tensor(outs), torch.as_tensor(d), torch.as_tensor(m_next),
        lambda blk: partition.partition_transition(blk, geo, pool, nxt))
    _close(got, want)


def test_wrappers_reject_bad_input():
    x = torch.zeros(2, 1, 3, 8, 8)
    with pytest.raises(ValueError, match="channel"):
        coded_worker(x, torch.zeros(2, 4, 5, 3, 3))
    with pytest.raises(ValueError, match="VALID"):
        coded_worker(x, torch.zeros(2, 4, 3, 9, 3))
    with pytest.raises(ValueError, match="shapes"):
        k2.matmul(torch.zeros(3, 4), torch.zeros(5, 2))
    # a device that is neither the card nor the CPU never takes the plain path
    with pytest.raises(ValueError, match="cuda or cpu"):
        coded_worker(x.to("meta"), torch.zeros(2, 4, 3, 3, 3, device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        k2.matmul(torch.zeros(3, 4, device="meta"), torch.zeros(4, 2, device="meta"))


def test_cpu_path_launches_nothing():
    c1, c2 = k1.launches.count, k2.launches.count
    coded_worker(torch.zeros(2, 3, 8, 8), torch.zeros(2, 4, 3, 3, 3))
    k2.matmul(torch.zeros(3, 4), torch.zeros(4, 2), relu=True)
    assert (k1.launches.count, k2.launches.count) == (c1, c2)


def test_launch_counter_is_exact_under_threads():
    counter = LaunchCounter("t")
    threads = [threading.Thread(target=lambda: [counter.add() for _ in range(2000)])
               for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert counter.count == 32000
    counter.reset()
    assert counter.count == 0
