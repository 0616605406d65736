"""The port's ``CodedLinear`` against the reference's, on the CPU.

Mirrors ``tests/test_coded_linear.py``: the same numpy inputs through both,
for every survivor subset of each plan (the worker GEMM and the decode take
their plain versions on CPU tensors; on the card, K2 and K3).  Tolerance
1e-5 relative to max|Y| and 1e-5 relative elementwise: fp32 sums in another
order through one decode; the reference's own test holds both against
``x @ w`` at 2e-3.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.coded_linear import CodedLinear as RefCodedLinear
from repro.core.fcdcc import FcdccPlan as RefPlan
from repro_torch.core.coded_linear import CodedLinear
from repro_torch.core.fcdcc import FcdccPlan

RNG = np.random.default_rng(0)


def _close(got: torch.Tensor, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rel,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("n,k_a,k_b", [
    (6, 2, 4), (8, 4, 8), (4, 1, 8), (4, 8, 1), (5, 2, 2), (4, 1, 4)])
def test_coded_linear_matches_reference_every_subset(n, k_a, k_b):
    plan, ref_plan = FcdccPlan(n=n, k_a=k_a, k_b=k_b), RefPlan(n=n, k_a=k_a, k_b=k_b)
    t, d_in, d_out = 8 * k_a, 32, 8 * k_b
    layer = CodedLinear(plan, t, d_in, d_out)
    ref = RefCodedLinear(ref_plan, t, d_in, d_out)
    x = RNG.standard_normal((t, d_in)).astype(np.float32)
    w = RNG.standard_normal((d_in, d_out)).astype(np.float32)
    xt, wt = torch.as_tensor(x), torch.as_tensor(w)
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    # the coded shares and weights themselves agree
    _close(layer.encode_inputs(xt), ref.encode_inputs(xj))
    _close(layer.encode_weights(wt), ref.encode_weights(wj))
    subsets = list(itertools.combinations(range(n), plan.delta))
    for ids in subsets:
        got = layer.run_simulated(xt, wt, list(ids))
        _close(got, ref.run_simulated(xj, wj, list(ids)))
        np.testing.assert_allclose(got.numpy(), x @ w, rtol=2e-3, atol=2e-3)
        np.testing.assert_array_equal(layer.decode_matrix(ids),
                                      ref.decode_matrix(ids))
    # encode-once: the weights were coded once (plus the direct call above)
    assert layer.weight_encode_calls == 2
    # a runtime decode inverse gives the same result as the cached one
    ids = list(subsets[-1])
    _close(layer.run_simulated(xt, wt, ids, layer.decode_matrix(ids)),
           ref.run_simulated(xj, wj, ids))


def test_coded_ffn_block():
    """A coded SwiGLU-style FFN: the nonlinearity on the master side of the
    coded boundary, both matmuls coded."""
    plan, ref_plan = FcdccPlan(n=5, k_a=2, k_b=2), RefPlan(n=5, k_a=2, k_b=2)
    t, d, f = 16, 24, 32
    up, down = CodedLinear(plan, t, d, f), CodedLinear(plan, t, f, d)
    ref_up, ref_down = RefCodedLinear(ref_plan, t, d, f), RefCodedLinear(ref_plan, t, f, d)
    x = RNG.standard_normal((t, d)).astype(np.float32)
    w1 = RNG.standard_normal((d, f)).astype(np.float32)
    w2 = RNG.standard_normal((f, d)).astype(np.float32)
    h = torch.tanh(up.run_simulated(torch.as_tensor(x), torch.as_tensor(w1), [4]))
    y = down.run_simulated(h, torch.as_tensor(w2), [2])
    hr = jnp.tanh(ref_up.run_simulated(jnp.asarray(x), jnp.asarray(w1), [4]))
    _close(y, ref_down.run_simulated(hr, jnp.asarray(w2), [2]))
    np.testing.assert_allclose(y.numpy(), np.tanh(x @ w1) @ w2, rtol=2e-3, atol=2e-3)


def test_coded_linear_rejects_ragged_shapes():
    with pytest.raises(ValueError, match="divide"):
        CodedLinear(FcdccPlan(n=6, k_a=2, k_b=4), 5, 8, 16)
    with pytest.raises(ValueError, match="divide"):
        CodedLinear(FcdccPlan(n=6, k_a=2, k_b=4), 4, 8, 10)
