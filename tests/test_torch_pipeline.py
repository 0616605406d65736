"""The port's ``CodedPipeline`` against the reference's on the same inputs.

The port runs ``backend="kernel"`` on the CPU (the kernels' plain
versions), the reference ``backend="pallas"`` in interpret mode, both fused
(partition-resident transitions) and unfused, for every survivor subset of
the first layer.  Tolerance 1e-4, as the reference's own pipeline tests:
fp32 sums in another order, through a decode whose recovery matrix
amplifies rounding by its condition number.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pipeline import CodedPipeline as RefPipeline
from repro.core.pipeline import plan_layers as ref_plan_layers
from repro.models import cnn as ref_cnn
from repro_torch.core.fcdcc import FcdccPlan
from repro_torch.core.pipeline import CodedPipeline, build_cnn_pipeline, plan_layers
from repro_torch.models import cnn

RNG = np.random.default_rng(3)
TOL = dict(rtol=1e-4, atol=1e-4)

STACK = [cnn.ConvL("s1", 2, 8, 3, padding=1, pool=2),
         cnn.ConvL("s2", 8, 8, 3, padding=1)]
REF_STACK = [ref_cnn.ConvL("s1", 2, 8, 3, padding=1, pool=2),
             ref_cnn.ConvL("s2", 8, 8, 3, padding=1)]
N, HW, KAB = 6, 12, (2, 4)


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {l.name: (rng.standard_normal((l.out_ch, l.in_ch, l.kernel, l.kernel))
                     * (l.in_ch * l.kernel**2) ** -0.5).astype(np.float32)
            for l in STACK}


def _pipes(fused, buckets=(2,), backend="kernel"):
    params = _params()
    port = CodedPipeline(plan_layers(STACK, HW, N, default_kab=KAB),
                         params, backend=backend, bucket_sizes=buckets,
                         fuse_transitions=fused, device="cpu")
    ref = RefPipeline(ref_plan_layers(REF_STACK, HW, N, default_kab=KAB),
                      {k: jnp.asarray(v) for k, v in params.items()},
                      backend="pallas", bucket_sizes=buckets,
                      fuse_transitions=fused)
    return port, ref


@pytest.mark.parametrize("fused", [True, False])
def test_every_survivor_subset_matches_reference(fused):
    port, ref = _pipes(fused)
    x = RNG.standard_normal((2, 2, HW, HW)).astype(np.float32)
    delta = port.layer_delta(0)
    for ids in itertools.combinations(range(N), delta):
        per_layer = [list(ids), [5, 0]]
        got = port.run_prepared(torch.as_tensor(x), port.prepare(per_layer))
        want = ref.run_prepared(jnp.asarray(x), ref.prepare(per_layer))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the shared-availability form and plain run agree with it
    np.testing.assert_allclose(port.run(torch.as_tensor(x), [4, 2, 0]).numpy(),
                               np.asarray(ref.run(jnp.asarray(x), [4, 2, 0])), **TOL)
    # encode-once: every run above reused the resident coded filters
    assert port.filter_encode_calls == len(STACK)


@pytest.mark.parametrize("fused", [True, False])
def test_kernel_and_torch_backends_agree(fused):
    port, _ = _pipes(fused)
    torch_pipe, _ = _pipes(fused, backend="torch")
    x = torch.as_tensor(RNG.standard_normal((2, 2, HW, HW)).astype(np.float32))
    for ids in (None, [5, 3, 1], [2, 4]):
        np.testing.assert_allclose(port.run(x, ids).numpy(),
                                   torch_pipe.run(x, ids).numpy(), **TOL)


@pytest.mark.parametrize("fused", [True, False])
def test_lenet5_reference_weights_carried_over(fused):
    """The reference's ``init_cnn`` weights (jax PRNG) carried across with
    ``params_from_numpy``: the coded stack matches the reference's coded
    stack and both frameworks' uncoded stacks."""
    ref_params = ref_cnn.init_cnn("lenet5", jax.random.PRNGKey(0))
    params = cnn.params_from_numpy({k: np.asarray(v) for k, v in ref_params.items()},
                                   device="cpu")
    for k, v in ref_params.items():
        assert np.array_equal(params[k].numpy(), np.asarray(v))
    x = RNG.standard_normal((2, 1, 32, 32)).astype(np.float32)
    port = build_cnn_pipeline("lenet5", params, 6, default_kab=KAB,
                              fuse_transitions=fused, device="cpu")
    ref = RefPipeline(ref_plan_layers(ref_cnn.CNN_SPECS["lenet5"][1], 32, 6,
                                      default_kab=KAB),
                      ref_params, backend="pallas", fuse_transitions=fused)
    got = port.run(torch.as_tensor(x), [5, 1, 3])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.run(jnp.asarray(x), [5, 1, 3])),
                               **TOL)
    uncoded = cnn.run_convls("lenet5", params, torch.as_tensor(x))
    np.testing.assert_allclose(
        uncoded.numpy(), np.asarray(ref_cnn.run_convls("lenet5", ref_params,
                                                       jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(got.numpy(), uncoded.numpy(), **TOL)


def test_run_convls_coded_matches_uncoded():
    params = cnn.init_cnn("lenet5", torch.Generator().manual_seed(0), "cpu")
    x = torch.as_tensor(RNG.standard_normal((2, 1, 32, 32)).astype(np.float32))
    uncoded = cnn.run_convls("lenet5", params, x)
    coded = cnn.run_convls("lenet5", params, x, plan=FcdccPlan(n=6, k_a=2, k_b=2),
                           worker_ids=[5, 2, 0])
    np.testing.assert_allclose(coded.numpy(), uncoded.numpy(), **TOL)
    one = cnn.run_convls("lenet5", params, x[0], plan=FcdccPlan(n=6, k_a=2, k_b=2))
    np.testing.assert_allclose(one.numpy(), uncoded[0].numpy(), **TOL)


def test_init_cnn_is_seeded_and_scaled():
    a = cnn.init_cnn("vgg16", torch.Generator().manual_seed(4), "cpu")
    b = cnn.init_cnn("vgg16", torch.Generator().manual_seed(4), "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["conv5_1"]
    assert tuple(w.shape) == (512, 512, 3, 3)
    assert abs(float(w.std()) * (512 * 9) ** 0.5 - 1.0) < 0.05


@pytest.mark.parametrize("fused", [True, False])
def test_bounded_programs_and_bucket_padding(fused):
    """After many distinct batch sizes, each program has seen at most one
    shape per bucket, and zero-padded rows come out zero."""
    port, _ = _pipes(fused, buckets=(1, 2, 4))
    unpadded, _ = _pipes(fused, buckets=None)
    assert port.bucketize(3) == 4
    with pytest.raises(ValueError, match="exceeds"):
        port.bucketize(5)
    for b in (1, 3, 2, 4, 3, 1):
        x = torch.as_tensor(RNG.standard_normal((b, 2, HW, HW)).astype(np.float32))
        padded, real = port.pad_to_bucket(x)
        assert real == b and padded.shape[0] == port.bucketize(b)
        y = port.run(padded)
        assert torch.count_nonzero(y[real:]) == 0
        np.testing.assert_allclose(y[:real].numpy(), unpadded.run(x).numpy(), **TOL)
    traces = port.worker_program_traces + port.transition_program_traces
    assert traces <= port.program_trace_bound
    assert port.filter_encode_calls == len(STACK)
    assert port.num_transitions == (1 if fused else 0)


def test_entry_points_run_on_the_card_or_raise():
    """The default device is CUDA: without a card, building raises rather
    than dropping to the CPU."""
    params = _params()
    if torch.cuda.is_available():
        pipe = build_cnn_pipeline("lenet5", cnn.init_cnn(
            "lenet5", torch.Generator().manual_seed(0)), 6, default_kab=KAB)
        assert pipe.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        CodedPipeline(plan_layers(STACK, HW, N, default_kab=KAB), params)
    with pytest.raises(RuntimeError, match="cuda"):
        cnn.init_cnn("lenet5", torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="backend"):
        CodedPipeline(plan_layers(STACK, HW, N, default_kab=KAB), params,
                      backend="pallas", device="cpu")
