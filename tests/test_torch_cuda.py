"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every case needs a CUDA device and skips without one (the check happens in
the ``cuda`` fixture, per test).  The file imports torch and the port only,
so it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerance: 1e-5 relative to max|plain|; the kernels and their plain
versions may sum fp32 products in different orders.  K1 at VGG-16's
depths (K up to 4,608) is held to 1e-4, as ``chip_smoke.py`` holds it,
and, on both of its routes (the tensor-core kernel's 3xTF32 and the FFMA
kernel), its error against the plain version in float64 to at most
``K1_FP64_RATIO`` times the fp32 plain version's (cuBLAS, TF32 off);
K4 in bf16 to one bf16 rounding of its output.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS
from repro_torch.kernels.conv2d import kernel as k1
from repro_torch.kernels.conv2d.ops import coded_worker
from repro_torch.kernels.coded_gemm import kernel as k3
from repro_torch.kernels.flash_attn import kernel as k4
from repro_torch.kernels.matmul import kernel as k2

RNG = np.random.default_rng(11)
REL = 1e-5
K1_FP64_RATIO = 4.0  # chip_smoke.py's criterion for K1 against float64


def _close(got: torch.Tensor, want: torch.Tensor, rel=REL):
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape
    scale = max(float(want.abs().max()), 1.0)
    torch.testing.assert_close(got, want, rtol=rel, atol=rel * scale)


@pytest.fixture
def cuda():
    """The card, or a skip: decided per test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU machine)")
    return torch.device("cuda")


# (ell_a, B or None, C, h_hat, Wp, ell_b, N/k_b, KH, KW, stride): the
# reference's worker-kernel geometries plus ragged and multi-tile edges
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
    (2, 3, 5, 37, 70, 2, 33, 3, 3, 1),   # ragged M, N and K edges
    (2, 2, 64, 20, 30, 2, 70, 3, 3, 2),  # K > one chunk, N > one tile
    (2, 8, 3, 20, 30, 2, 16, 3, 3, 1),   # K 27, N 32: the FFMA route
    (2, 2, 64, 13, 17, 2, 32, 3, 3, 1),  # N 64, M 660: a ragged last tile
    (2, 2, 128, 9, 12, 2, 128, 3, 3, 1),  # N 256, K 1,152
    (2, 2, 512, 6, 6, 2, 128, 3, 3, 1),  # K 4,608, M 64
]
MATMUL_SHAPES = [(7, 5, 9), (128, 128, 128), (130, 257, 64), (1, 300, 1),
                 (200, 64, 384), (8, 8, 8), (129, 1, 129), (16, 16, 3600),
                 (8, 8, 5000), (16, 2, 4099), (16, 40, 70000), (33, 2, 9)]


def _fp64_ratio(got, xe, ke, stride, want=None):
    """K1's error against the plain version in float64 over the fp32 plain
    version's (cuBLAS, TF32 off), both relative to max|float64|; the fp32
    one at least half an fp32 ulp of it."""
    ref = k1.coded_worker_plain(xe.double(), ke.double(), stride)
    want = k1.coded_worker_plain(xe, ke, stride) if want is None else want
    scale = float(ref.abs().max())
    err = float((got.double() - ref).abs().max()) / scale
    plain = float((want.double() - ref).abs().max()) / scale
    return err / max(plain, 2.0 ** -24)


def _k1_route(m, n, k):
    """The route ``worker_plan`` takes: FFMA where K fits one 32-deep
    stage of the tensor-core kernel."""
    return "ffma" if k <= k1.TILE_K["tc"] else "tc"


@pytest.mark.parametrize("case", WORKER_CASES)
def test_cuda_worker_kernel_matches_plain(cuda, case):
    ea, b, c, hh, wp, eb, nb, kh, kw, stride = case
    xshape = (ea, b, c, hh, wp) if b else (ea, c, hh, wp)
    xe = torch.as_tensor(RNG.standard_normal(xshape).astype(np.float32), device=cuda)
    ke = torch.as_tensor(RNG.standard_normal((eb, nb, c, kh, kw)).astype(np.float32),
                         device=cuda)
    plan = k1.choose_worker_plan(xe.shape, ke.shape, stride, cuda)
    assert plan.route == _k1_route(*k1.gemm_shape(xe.shape, ke.shape, stride))
    before = k1.launches.count
    by_route = {r: c.count for r, c in k1.route_launches.items()}
    got = coded_worker(xe, ke, stride)
    torch.cuda.synchronize()
    assert k1.launches.count == before + 1
    assert {r: c.count - by_route[r] for r, c in k1.route_launches.items()} == \
        {r: int(r == plan.route) for r in k1.ROUTES}
    want = k1.coded_worker_plain(xe, ke, stride)
    _close(got, want, rel=1e-4)
    assert _fp64_ratio(got, xe, ke, stride, want) <= K1_FP64_RATIO
    assert torch.equal(coded_worker(xe, ke, stride), got)


@pytest.mark.parametrize("route", ["tc", "ffma"])
@pytest.mark.parametrize("case", WORKER_CASES[-6:])
def test_cuda_worker_routes_and_splits(cuda, case, route):
    """Each route at every split its slice depth allows (every cluster
    size where K is deep enough), on the edge cases: within 1e-4 of the
    plain version, within ``K1_FP64_RATIO`` of its float64 error, and the
    same bits from a second launch."""
    ea, b, c, hh, wp, eb, nb, kh, kw, stride = case
    xe = torch.as_tensor(RNG.standard_normal((ea, b, c, hh, wp)).astype(np.float32),
                         device=cuda)
    ke = torch.as_tensor(RNG.standard_normal((eb, nb, c, kh, kw)).astype(np.float32),
                         device=cuda)
    m, n, k = k1.gemm_shape(xe.shape, ke.shape, stride)
    want = k1.coded_worker_plain(xe, ke, stride)
    bn = k1.route_plan(route, m, n, k).bn
    chunks = -(-k // k1.TILE_K[route])
    for s in k1.SPLIT_CHOICES:
        if s > 1 and chunks < s * k1.MIN_SPLIT_CHUNKS[route]:
            continue
        plan = k1.worker_plan_of({"route": route, "bn": bn, "splits": s}, m, n, k)
        got = k1.launch_worker(plan, xe, ke, stride)
        torch.cuda.synchronize()
        _close(got, want, rel=1e-4)
        assert _fp64_ratio(got, xe, ke, stride, want) <= K1_FP64_RATIO, plan
        assert torch.equal(k1.launch_worker(plan, xe, ke, stride), got), plan


@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
@pytest.mark.parametrize("relu", [False, True])
def test_cuda_matmul_kernel_matches_plain(cuda, m, k, n, relu):
    a = torch.as_tensor(RNG.standard_normal((m, k)).astype(np.float32), device=cuda)
    b = torch.as_tensor(RNG.standard_normal((k, n)).astype(np.float32), device=cuda)
    before = k2.launches.count
    got = k2.matmul(a, b, relu=relu)
    torch.cuda.synchronize()
    assert k2.launches.count == before + 1
    _close(got, k2.matmul_plain(a, b, relu=relu))


# K2's split kernel: the LM worker GEMMs (d_in, width) = (576, 480) qkv,
# (576, 288) wo, (576, 1536) gate-up and (1536, 288) down at M = 1, 2, 4, 16,
# and ragged K and N (N % 4 != 0, K not a multiple of the split), plus b one
# float into its storage (no 16-byte loads): (K, N, offset)
LM_GEMMS = [(576, 480, 0), (576, 288, 0), (576, 1536, 0), (1536, 288, 0),
            (577, 479, 0), (1000, 290, 0), (100, 17, 0), (576, 288, 1)]


@pytest.mark.parametrize("m", [1, 2, 4, 16])
@pytest.mark.parametrize("k,n,offset", LM_GEMMS)
@pytest.mark.parametrize("relu", [False, True])
def test_cuda_matmul_split_kernel_matches_plain(cuda, m, k, n, offset, relu):
    assert k2.matmul_plan(m, n, k).kernel == "split"
    a = torch.as_tensor(RNG.standard_normal((m, k)).astype(np.float32), device=cuda)
    flat = torch.as_tensor(RNG.standard_normal(k * n + offset).astype(np.float32),
                           device=cuda)
    b = flat[offset:].view(k, n)
    before = k2.launches.count
    got = k2.matmul(a, b, relu=relu)
    torch.cuda.synchronize()
    assert k2.launches.count == before + 1
    _close(got, k2.matmul_plain(a, b, relu=relu))


# K2's split kernel past one staging chunk of a slice: Qwen3-4B's coded
# worker GEMMs (d_in, width) = (2560, 3072) qkv, (4096, 1280) wo, (2560,
# 9728) gate-up and (9728, 1280) down (K > 8,192: slices of more than 1,024
# rows), and ragged deep K, one with a ragged N: (K, N)
DEEP_GEMMS = [(2560, 3072), (4096, 1280), (2560, 9728), (9728, 1280),
              (9729, 1280), (20000, 290)]


@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("k,n", DEEP_GEMMS)
def test_cuda_matmul_split_kernel_deep_k_matches_plain(cuda, m, k, n):
    plan = k2.matmul_plan(m, n, k)
    assert plan.kernel == "split"
    if k > 8 * k2.SPLIT_CHUNK:
        assert plan.k_slice > k2.SPLIT_CHUNK
    a = torch.as_tensor(RNG.standard_normal((m, k)).astype(np.float32), device=cuda)
    b = torch.as_tensor(RNG.standard_normal((k, n)).astype(np.float32), device=cuda)
    before = k2.launches.count
    got = k2.matmul(a, b, relu=True)
    torch.cuda.synchronize()
    assert k2.launches.count == before + 1
    _close(got, k2.matmul_plain(a, b, relu=True))


# K1 at each VGG-16 layer's (C, N/k_b, KH, KW, stride) on ell_a = ell_b = 2
# with a small M: (C, NB, h_hat, Wp) — the first at K = 27 (the FFMA
# route), those with C >= 256 on the split-K path; the last three with
# many row tiles and a ragged last one (M 13,920 at K 27, 10,336 at N 32,
# 4,256 at N 256 and K 4,608)
VGG_WORKER_CASES = [(3, 16, 8, 8), (64, 16, 8, 8), (64, 32, 6, 10),
                    (128, 32, 6, 10), (128, 64, 5, 9), (256, 64, 5, 9),
                    (256, 128, 6, 6), (512, 128, 6, 6), (512, 128, 20, 21),
                    (3, 16, 60, 62), (64, 16, 40, 70), (512, 128, 30, 40)]


@pytest.mark.parametrize("c,nb,hh,wp", VGG_WORKER_CASES)
def test_cuda_worker_kernel_vgg_layers_match_plain(cuda, c, nb, hh, wp):
    xe = torch.as_tensor(RNG.standard_normal((2, 2, c, hh, wp)).astype(np.float32),
                         device=cuda)
    ke = torch.as_tensor(RNG.standard_normal((2, nb, c, 3, 3)).astype(np.float32),
                         device=cuda)
    plan = k1.choose_worker_plan(xe.shape, ke.shape, 1, cuda)
    assert plan.route == _k1_route(*k1.gemm_shape(xe.shape, ke.shape, 1))
    before = k1.launches.count
    got = coded_worker(xe, ke, 1)
    torch.cuda.synchronize()
    assert k1.launches.count == before + 1
    want = k1.coded_worker_plain(xe, ke, 1)
    _close(got, want, rel=1e-4)
    assert _fp64_ratio(got, xe, ke, 1, want) <= K1_FP64_RATIO
    assert torch.equal(coded_worker(xe, ke, 1), got)


# (kernel, case): K1 without and with split-K; K2's column and split kernels,
# the split one also over slices of several staging chunks; K3 at a decode
# and a build-time width; K4 at the prefill shape in fp32 and bf16 and over
# several key chunks, and at the Qwen3-4B prefill of 2 x 2,048 tokens on
# the tiled route in both types
REPEAT_CASES = [("k1", (2, 2, 64, 20, 30, 2, 70, 3, 3, 1)),
                ("k1", (2, 2, 512, 6, 6, 2, 128, 3, 3, 1)),
                ("k2", (8, 8, 100000)), ("k2", (4, 1536, 288)),
                ("k2", (4, 9728, 1280)),
                ("k3", (4, 4, 960)), ("k3", (8, 4, 138240)),
                ("k4", (36, 16, 64, 3, torch.float32)),
                ("k4", (36, 16, 64, 3, torch.bfloat16)),
                ("k4", (8, 256, 128, 2, torch.float32)),
                ("k4", (64, 2048, 128, 4, torch.float32)),
                ("k4", (64, 2048, 128, 4, torch.bfloat16))]


@pytest.mark.parametrize("kernel,case", REPEAT_CASES)
def test_cuda_kernels_repeat_bit_for_bit(cuda, kernel, case):
    """Two launches on the same inputs give the same bits: every sum,
    split-K and cluster reductions included, runs in a fixed order."""
    if kernel == "k1":
        ea, b, c, hh, wp, eb, nb, kh, kw, stride = case
        xe = torch.as_tensor(RNG.standard_normal((ea, b, c, hh, wp)).astype(np.float32),
                             device=cuda)
        ke = torch.as_tensor(RNG.standard_normal((eb, nb, c, kh, kw)).astype(np.float32),
                             device=cuda)
        def run():
            return coded_worker(xe, ke, stride)
    elif kernel == "k2":
        m, k, n = case
        a = torch.as_tensor(RNG.standard_normal((m, k)).astype(np.float32), device=cuda)
        bm = torch.as_tensor(RNG.standard_normal((k, n)).astype(np.float32), device=cuda)
        def run():
            return k2.matmul(a, bm, relu=True)
    elif kernel == "k3":
        r_out, r_in, f = case
        code = RNG.standard_normal((r_out, r_in)).astype(np.float32)
        feats = torch.as_tensor(RNG.standard_normal((r_in, f)).astype(np.float32),
                                device=cuda)
        def run():
            return k3.coded_gemm(code, feats)
    else:
        bh, s, d, rep, dtype = case
        q, k, v = (torch.as_tensor(RNG.standard_normal((n, s, d)).astype(np.float32),
                                   device=cuda).to(dtype)
                   for n in (bh, bh // rep, bh // rep))
        def run():
            return k4.flash_attention(q, k, v, causal=True, rep=rep)
    first = run()
    for _ in range(3):
        assert torch.equal(run(), first)


def test_cuda_kernels_reject_what_they_do_not_take(cuda):
    xe = torch.zeros(2, 3, 8, 8, device=cuda)
    ke = torch.zeros(2, 4, 3, 3, 3, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        coded_worker(xe.half(), ke.half())
    with pytest.raises(ValueError, match="contiguous"):
        coded_worker(xe.transpose(-1, -2), ke)
    with pytest.raises(ValueError, match="on"):
        coded_worker(xe, ke.cpu())
    with pytest.raises(TypeError, match="float32"):
        k2.matmul(torch.zeros(3, 4, device=cuda).double(),
                  torch.zeros(4, 2, device=cuda).double())
    with pytest.raises(ValueError, match="contiguous"):
        k2.matmul(torch.zeros(4, 3, device=cuda).t(), torch.zeros(4, 2, device=cuda))


# -- the served path on the card ---------------------------------------------
def _uncoded(params, xs, device):
    from repro_torch.models.cnn import run_convls

    return run_convls("vgg16", params, torch.as_tensor(np.stack(xs), device=device)).cpu()


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_cuda_server_under_stragglers_matches_uncoded(cuda, depth):
    """Threads pool with one stream per worker, fused transitions, VGG-16 at
    32x32: many requests from two client threads under stragglers and a
    dead worker.  Cross-stream buffer reuse would corrupt results here."""
    import threading

    from repro_torch.models.cnn import init_cnn
    from repro_torch.runtime import StragglerModel
    from repro_torch.serving import CodedServer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    params = init_cnn("vgg16", torch.Generator().manual_seed(1), cuda)
    delays = np.array([0.0, 0.005, 0.0, np.inf, 0.0, 0.005, 0.0, 0.0])
    server = CodedServer.from_cnn(
        "vgg16", params, 8, default_kab=(2, 4), input_hw=32,
        straggler=StragglerModel(delays), mode="threads",
        bucket_sizes=(1, 2, 4, 8), pipeline_depth=depth,
        fuse_transitions=True, device=cuda)
    xs = [RNG.standard_normal((3, 32, 32)).astype(np.float32) for _ in range(40)]
    results = {}

    def client(lo):
        handles = [(i, server.submit(xs[i])) for i in range(lo, len(xs), 2)]
        for i, h in handles:
            results[i] = h.result(timeout=120.0)

    before = (k1.launches.count, k2.launches.count)
    with server:
        threads = [threading.Thread(target=client, args=(lo,)) for lo in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300.0)
            assert not t.is_alive()
    assert sorted(results) == list(range(len(xs)))
    assert k1.launches.count > before[0] and k2.launches.count > before[1]
    ref = _uncoded(params, xs, cuda)
    for i, y in results.items():
        _close(torch.as_tensor(y), ref[i], rel=1e-4)


@pytest.mark.parametrize("fused", [True, False])
def test_cuda_pipeline_kernel_matches_torch_backend(cuda, fused):
    from repro_torch.core.pipeline import build_cnn_pipeline
    from repro_torch.models.cnn import init_cnn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    params = init_cnn("alexnet", torch.Generator().manual_seed(2), cuda)
    pipes = [build_cnn_pipeline("alexnet", params, 6, default_kab=(2, 4),
                                input_hw=67, backend=b, fuse_transitions=fused,
                                device=cuda) for b in ("kernel", "torch")]
    x = torch.as_tensor(RNG.standard_normal((3, 3, 67, 67)).astype(np.float32),
                        device=cuda)
    for ids in (None, [5, 1, 3], [2, 4]):
        got, want = (p.run(x, ids) for p in pipes)
        _close(got, want, rel=1e-4)


# -- the LM path: K3 coded GEMM, K4 flash attention ---------------------------
# (R_out, R_in, F, offset): the LM decode (4x4) and encode (8x4) shapes,
# the float4 path (F % 4 == 0 at build-time widths) and the one-column path
# (decode widths, ragged F, or a feature matrix that starts one float into
# its storage).  The code matrix stays on the host (a CPU tensor here).
CODED_GEMM_CASES = [(4, 4, 960, 0), (4, 4, 144, 0), (8, 4, 138240, 0),
                    (4, 4, 7, 0), (16, 16, 4099, 0), (3, 5, 64, 1),
                    (1, 1, 1, 0), (8, 8, 1 << 20, 0), (12, 2, 33, 0)]


@pytest.mark.parametrize("r_out,r_in,f,offset", CODED_GEMM_CASES)
def test_cuda_coded_gemm_matches_plain(cuda, r_out, r_in, f, offset):
    code = torch.as_tensor(RNG.standard_normal((r_out, r_in)).astype(np.float32))
    flat = torch.as_tensor(RNG.standard_normal(r_in * f + offset).astype(np.float32),
                           device=cuda)
    feats = flat[offset:].view(r_in, f)
    before = k3.launches.count
    got = k3.coded_gemm(code, feats)
    torch.cuda.synchronize()
    assert k3.launches.count == before + 1
    _close(got, k3.coded_gemm_plain(code, feats))


# the SmolLM-135M decode widths at bucket 4 (wo/down, qkv, gate-up) and
# bucket 1, and the build-time encode widths, with the code as a numpy array
# or a CPU tensor
K3_HOST_CASES = [(4, 4, 576), (4, 4, 960), (4, 4, 3072), (4, 4, 144),
                 (8, 4, 576 * 240), (8, 4, 1536 * 144)]


@pytest.mark.parametrize("r_out,r_in,f", K3_HOST_CASES)
@pytest.mark.parametrize("as_numpy", [True, False])
def test_cuda_coded_gemm_takes_host_code(cuda, r_out, r_in, f, as_numpy):
    code = RNG.standard_normal((r_out, r_in)).astype(np.float32)
    feats = torch.as_tensor(RNG.standard_normal((r_in, f)).astype(np.float32),
                            device=cuda)
    host = code if as_numpy else torch.from_numpy(code)
    before = k3.launches.count
    got = k3.coded_gemm(host, feats)
    torch.cuda.synchronize()
    assert k3.launches.count == before + 1
    _close(got, torch.as_tensor(code, device=cuda) @ feats)


# (BH, Sq, Sk, D, rep, causal): the prefill shape (4 prompts x 9 heads over
# 3 KV heads, head_dim 64), the smoke head_dim 16, several query and key
# tiles, cross lengths and D = 128; then long and ragged sequences on the
# tiled route: the Qwen3-4B prefill of 2 x 2,048 tokens (rep 4, D 128),
# ragged row and key tiles, the Whisper-medium encoder (4 x 16 heads over
# 1,500 frames, no mask) and its decoder's 16 queries over those frames
FLASH_CASES = [(36, 16, 16, 64, 3, True), (12, 8, 8, 16, 3, True),
               (4, 200, 200, 64, 1, True), (4, 130, 130, 32, 2, True),
               (2, 384, 384, 128, 1, True), (4, 64, 200, 32, 1, False),
               (8, 70, 70, 64, 4, False), (3, 1, 1, 16, 1, True),
               (64, 2048, 2048, 128, 4, True), (4, 1000, 1000, 64, 1, True),
               (8, 2047, 2047, 128, 2, True), (64, 1500, 1500, 64, 1, False),
               (4, 16, 1500, 64, 1, False)]


def _route(sq, sk, rep, causal, bf16=False):
    return "tiled" if k4.tiled_route(sq, 0 if causal else sk, rep, bf16) else "rows"


def _qkv(cuda, bh, sq, sk, d, rep, dtype=torch.float32):
    return tuple(torch.as_tensor(RNG.standard_normal(shape).astype(np.float32),
                                 device=cuda).to(dtype)
                 for shape in ((bh, sq, d), (bh // rep, sk, d), (bh // rep, sk, d)))


@pytest.mark.parametrize("bh,sq,sk,d,rep,causal", FLASH_CASES)
def test_cuda_flash_attention_matches_plain(cuda, bh, sq, sk, d, rep, causal):
    assert k4.flash_plan(bh, sq, sk, d, rep, causal=causal).route == _route(
        sq, sk, rep, causal)
    q, k, v = _qkv(cuda, bh, sq, sk, d, rep)
    before = k4.launches.count
    got = k4.flash_attention(q, k, v, causal=causal, rep=rep)
    torch.cuda.synchronize()
    assert k4.launches.count == before + 1
    _close(got, k4.flash_attention_plain(q, k, v, causal=causal, rep=rep), rel=2e-5)


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("bh,sq,sk,d,rep,causal", FLASH_CASES)
def test_cuda_flash_attention_bf16_matches_plain(cuda, bh, sq, sk, d, rep, causal):
    """bf16 operands against the bf16 plain version: within one bf16
    rounding of the output (2^-7 of max|out|) — both round p and the output
    to bf16, and an fp32 sum in another order may flip either rounding.
    Over many keys that bound is set by row 0 alone, so the tiled route is
    also held row by row to the tile-order walk, as ``chip_smoke.py`` holds
    it (``check_tiled_bf16``: each row within 2^-7 of its own max, nearly
    every bit equal, and p left whole visibly different)."""
    plan = k4.flash_plan(bh, sq, sk, d, rep, bf16=True, causal=causal)
    route = plan.route
    assert route == _route(sq, sk, rep, causal, bf16=True)
    q, k, v = _qkv(cuda, bh, sq, sk, d, rep, torch.bfloat16)
    before = k4.launches.count
    got = k4.flash_attention(q, k, v, causal=causal, rep=rep)
    torch.cuda.synchronize()
    assert k4.launches.count == before + 1
    assert got.dtype == torch.bfloat16
    want = k4.flash_attention_plain(q, k, v, causal=causal, rep=rep)
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2.0 ** -7 * float(want.float().abs().max())
    if route == "tiled":
        _chip_smoke().check_tiled_bf16(f"K4 {(bh, sq, sk, d, rep, causal)}", q,
                                       k, v, got, causal, rep, plan.keys)


# (BH, Sq, Sk, D, rep, causal): every tiled FLASH_CASES shape at D 64 and
# 128, then ragged query and key tiles, GQA and cross lengths at both D
TILED_BF16_CASES = ([c for c in FLASH_CASES if c[1] >= 32 and c[3] >= 64]
                    + [(bh, sq, sk, d, rep, causal) for d in (64, 128)
                       for bh, sq, sk, rep, causal in
                       ((8, 1000, 1000, 2, True), (4, 300, 700, 1, False),
                        (6, 129, 129, 3, True))])


@pytest.mark.parametrize("kernel", ["wgmma", "mma"])
@pytest.mark.parametrize("bh,sq,sk,d,rep,causal", TILED_BF16_CASES)
def test_cuda_flash_tiled_bf16_kernels_match_walk(cuda, kernel, bh, sq, sk, d,
                                                  rep, causal):
    """Each bf16 tiled kernel, the wgmma one and the kept mma.sync one,
    forced at D 64 and 128 (``tiled_plan(kernel=)``, whichever the plan
    picks at the shape): within one bf16 rounding of the plain version,
    and row by row and bit by bit against the tile-order walk at the
    kernel's own key tile (128 and 64)."""
    plan = k4.tiled_plan(bh, sq, d, rep, True, kernel=kernel)
    assert plan.keys == (128 if kernel == "wgmma" else 64)
    q, k, v = _qkv(cuda, bh, sq, sk, d, rep, torch.bfloat16)
    got = k4.launch_plan(plan, q, k, v, scale=None, causal=causal, rep=rep)
    torch.cuda.synchronize()
    want = k4.flash_attention_plain(q, k, v, causal=causal, rep=rep)
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2.0 ** -7 * float(want.float().abs().max())
    _chip_smoke().check_tiled_bf16(f"K4 {kernel} {(bh, sq, sk, d, rep, causal)}",
                                   q, k, v, got, causal, rep, plan.keys)


@pytest.mark.parametrize("kernel", ["wgmma", "mma"])
def test_cuda_flash_tiled_bf16_launches_repeat(cuda, kernel):
    """Two launches of a bf16 tiled kernel on the same inputs give the same
    bits (no atomics; every sum in a fixed order), at phase 15's shape."""
    bh, s, d, rep = 64, 2048, 128, 4
    plan = k4.tiled_plan(bh, s, d, rep, True, kernel=kernel)
    q, k, v = _qkv(cuda, bh, s, s, d, rep, torch.bfloat16)
    first = k4.launch_plan(plan, q, k, v, scale=None, causal=True, rep=rep)
    second = k4.launch_plan(plan, q, k, v, scale=None, causal=True, rep=rep)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# (BH, Sq, Sk, D, rep, causal) for the fp32 3xTF32 kernel: D 64 and 128,
# causal and not, Sq != Sk, query and key tiles cut short (Sq off 128, Sk
# off 64, fewer keys than a tile), GQA rep 1, 4 and 5, and query rows over
# all heads on both sides of TF32X3_MIN_ROWS (8,192 and 9,216 at 64 heads)
TF32X3_CASES = [(2, 128, 128, 64, 1, True), (2, 128, 128, 128, 1, False),
                (4, 200, 200, 64, 4, False), (4, 130, 300, 128, 4, False),
                (5, 257, 257, 64, 5, True), (10, 300, 300, 128, 5, True),
                (8, 1000, 1000, 128, 4, True), (3, 77, 45, 128, 1, False),
                (4, 16, 1500, 64, 1, False), (6, 333, 1000, 64, 3, True),
                (64, 128, 128, 64, 1, True), (64, 144, 144, 128, 4, True),
                (64, 1500, 1500, 64, 1, False), (32, 511, 511, 128, 4, True)]


@pytest.mark.parametrize("bh,sq,sk,d,rep,causal", TF32X3_CASES)
def test_cuda_flash_tiled_tf32x3_kernel_holds_fp32(cuda, bh, sq, sk, d, rep, causal):
    """The fp32 tiled kernel on wgmma (3xTF32), forced at each shape: within
    2e-5 of the fp32 plain version, its error against the plain version in
    float64 at most ``chip_smoke.K4_FP64_RATIO`` times the fp32 plain
    version's, and a second launch repeats it bit for bit."""
    plan = k4.tiled_plan(bh, sq, d, rep, False, kernel="tf32x3")
    assert (plan.rows, plan.keys, plan.warps) == (128, 64, 12)
    q, k, v = _qkv(cuda, bh, sq, sk, d, rep)
    got = k4.launch_plan(plan, q, k, v, scale=None, causal=causal, rep=rep)
    again = k4.launch_plan(plan, q, k, v, scale=None, causal=causal, rep=rep)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = k4.flash_attention_plain(q, k, v, causal=causal, rep=rep)
    _close(got, want, rel=2e-5)
    want64 = k4.flash_attention_plain(q.double(), k.double(), v.double(),
                                      causal=causal, rep=rep)
    err = float((got.double() - want64).abs().max())
    plain_err = float((want.double() - want64).abs().max())
    assert err <= _chip_smoke().K4_FP64_RATIO * plain_err, (err, plain_err)


def test_cuda_lm_kernels_reject_what_they_do_not_take(cuda):
    with pytest.raises(TypeError, match="float32"):
        k3.coded_gemm(torch.zeros(4, 4).double(),
                      torch.zeros(4, 8, device=cuda).double())
    with pytest.raises(ValueError, match="contiguous"):
        k3.coded_gemm(torch.zeros(4, 4), torch.zeros(8, 4, device=cuda).t())
    with pytest.raises(ValueError, match="on the host"):  # no hidden sync
        k3.coded_gemm(torch.zeros(4, 4, device=cuda), torch.zeros(4, 8, device=cuda))
    q = torch.zeros(6, 4, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        k4.flash_attention(q, q[:2], q[:2], rep=3)
    with pytest.raises(TypeError, match="float32"):
        k4.flash_attention(q.half(), q.half(), q.half())
    q16 = torch.zeros(6, 4, 16, device=cuda)
    with pytest.raises(TypeError, match="float32"):  # fp16 stays refused
        k4.flash_attention(q16.half(), q16.half(), q16.half())
    with pytest.raises(TypeError, match="one type"):
        k4.flash_attention(q16, q16.bfloat16(), q16.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        x = torch.zeros(6, 16, 4, device=cuda).transpose(1, 2)
        k4.flash_attention(x, x, x)
    # a launch either entry point refuses raises: head dim 48 has no instance
    q48 = torch.zeros(6, 64, 48, device=cuda)
    for plan in (k4.rows_plan(6, 64, 48, 3), k4.tiled_plan(6, 64, 48, 3)):
        with pytest.raises(RuntimeError, match="failed to launch"):
            k4.launch_plan(plan, q48, q48[:2], q48[:2], scale=None, causal=True,
                           rep=3)
    # the tiled entry point takes only its kernels' own launch shapes: a
    # bf16 plan with fp32 operands, or rows other than 64, raise
    q64 = torch.zeros(6, 64, 64, device=cuda)
    mma_plan = k4.tiled_plan(6, 64, 64, 3, bf16=True, kernel="mma")
    wgmma_plan = k4.tiled_plan(6, 64, 64, 3, bf16=True, kernel="wgmma")
    for plan in (mma_plan, wgmma_plan, mma_plan._replace(rows=32, warps=8)):
        with pytest.raises(RuntimeError, match="failed to launch"):
            k4.launch_plan(plan, q64, q64[:2], q64[:2], scale=None, causal=True,
                           rep=3)
    # ... and the wgmma kernel takes its own shape only: the mma.sync
    # kernel's 64 rows or 4 warps with its others, or a head dim it has no
    # instance for (32), raise
    b64 = q64.bfloat16()
    for plan in (wgmma_plan._replace(rows=64), wgmma_plan._replace(warps=4)):
        with pytest.raises(RuntimeError, match="failed to launch"):
            k4.launch_plan(plan, b64, b64[:2], b64[:2], scale=None, causal=True,
                           rep=3)
    b32 = torch.zeros(6, 64, 32, device=cuda).bfloat16()
    with pytest.raises(RuntimeError, match="failed to launch"):
        k4.launch_plan(k4.tiled_plan(6, 64, 32, 3, bf16=True, kernel="wgmma"),
                       b32, b32[:2], b32[:2], scale=None, causal=True, rep=3)
    # ... and so does the 3xTF32 kernel: the FFMA kernel's warps with its
    # rows, or head dim 32
    tf_plan = k4.tiled_plan(6, 64, 64, 3, kernel="tf32x3")
    for plan, x in ((tf_plan._replace(warps=8), q64),
                    (k4.tiled_plan(6, 64, 32, 3, kernel="tf32x3"), b32.float())):
        with pytest.raises(RuntimeError, match="failed to launch"):
            k4.launch_plan(plan, x, x[:2], x[:2], scale=None, causal=True, rep=3)


def _smoke_lm(device):
    from repro_torch.configs import smollm_135m
    from repro_torch.models import transformer as lm

    cfg = smollm_135m.smoke()
    return cfg, lm.init_lm(cfg, torch.Generator().manual_seed(3), device)


def test_cuda_lm_prefill_decode_match_cpu(cuda):
    """The port's transformer on the card (prefill attention on K4) against
    the same weights on the CPU (K4's plain version)."""
    from repro_torch.models import transformer as lm

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = _smoke_lm("cpu")
    gpu = {k: ({kk: vv.to(cuda) for kk, vv in v.items()} if isinstance(v, dict)
               else v.to(cuda)) for k, v in params.items()}
    toks = torch.as_tensor(RNG.integers(0, cfg.vocab, (3, 9)))
    outs = []
    for dev, p in (("cpu", params), (cuda, gpu)):
        cache = lm.init_cache(cfg, 3, 16, device=dev)
        logits, cache = lm.prefill(p, cfg, cache, toks.to(dev))
        step, cache = lm.decode_step(p, cfg, cache, toks[:, :1].to(dev), 9)
        outs.append((logits.cpu(), step.cpu(), cache["dense"]["k"].cpu()))
    before = k4.launches.count
    lm.forward(gpu, cfg, toks.to(cuda))
    assert k4.launches.count > before
    for got, want in zip(outs[1], outs[0]):
        _close(got, want)


def test_cuda_lm_server_under_stragglers_matches_greedy(cuda):
    """Coded LM serving on the card (threads pool, one stream per worker,
    K2/K3/K4 all launched) with a straggler and a dead worker: every
    token stream equals the port's undistributed greedy decode on the
    card."""
    from repro_torch.core.decoder_pipeline import build_lm_decoder_pipeline
    from repro_torch.models import transformer as lm
    from repro_torch.runtime import StragglerModel
    from repro_torch.serving import CodedLMServer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = _smoke_lm(cuda)
    pipe = build_lm_decoder_pipeline(cfg, params, 4, k_b=4, bucket_sizes=(1, 2, 4),
                                     max_len=32, backend="kernel", device=cuda)
    prompts = [RNG.integers(0, cfg.vocab, int(n)).tolist()
               for n in RNG.integers(1, 9, 6)]
    gens = [int(g) for g in RNG.integers(1, 8, 6)]
    counts = [c.launches.count for c in (k2, k3, k4)]
    st = StragglerModel(np.array([0.0, 0.0, 0.005, np.inf]))
    with CodedLMServer(pipe, st, mode="threads", max_prompt=8) as srv:
        handles = [srv.submit(p, g) for p, g in zip(prompts, gens)]
        results = [h.result(timeout=300) for h in handles]
    assert all(c.launches.count > n for c, n in zip((k2, k3, k4), counts))
    for p, g, got in zip(prompts, gens, results):
        cache = lm.init_cache(cfg, 1, 32, device=cuda)
        logits, cache = lm.prefill(params, cfg, cache, torch.as_tensor([p], device=cuda))
        want = [int(logits[0, -1].argmax())]
        for t in range(len(p), len(p) + g - 1):
            logits, cache = lm.decode_step(
                params, cfg, cache, torch.as_tensor([[want[-1]]], device=cuda), t)
            want.append(int(logits[0, -1].argmax()))
        assert list(got) == want


# -- the device worker pool on the card ---------------------------------------
def test_cuda_device_pool_bit_identical_to_thread_pool(cuda):
    """VGG-16 at 32x32, fused transitions, the fastest-delta subset pinned by
    delaying every other worker: the device pool (dispatch from the master,
    event reaping) gives the thread pool's bits exactly (fixed-order
    kernels on another stream), and both launch K1 and K2."""
    from repro_torch.core.pipeline import build_cnn_pipeline
    from repro_torch.models.cnn import init_cnn
    from repro_torch.runtime import FcdccCluster, StragglerModel

    torch.backends.cuda.matmul.allow_tf32 = False
    params = init_cnn("vgg16", torch.Generator().manual_seed(4), cuda)
    delays = np.array([0.0, 0.0] + [0.05] * 6)
    x = torch.as_tensor(RNG.standard_normal((2, 3, 32, 32)).astype(np.float32),
                        device=cuda)
    outs = {}
    for pool in ("threads", "device"):
        pipe = build_cnn_pipeline("vgg16", params, 8, default_kab=(2, 4),
                                  input_hw=32, fuse_transitions=True, device=cuda)
        before = (k1.launches.count, k2.launches.count)
        with FcdccCluster(pipe.specs[0].plan, StragglerModel(delays),
                          mode="threads", pool=pool, device=cuda) as cl:
            y, timings = cl.run_pipeline(x, pipe)
            assert all(t.used_workers == [0, 1] for t in timings)
            outs[pool] = y.cpu()
        assert k1.launches.count > before[0] and k2.launches.count > before[1]
    assert torch.equal(outs["threads"], outs["device"])


def _pool(cuda, delays, **kw):
    from repro_torch.runtime import DeviceWorkerPool, StragglerModel

    return DeviceWorkerPool(len(delays), StragglerModel(np.asarray(delays)),
                            device=cuda, **kw)


def test_cuda_device_pool_reaps_by_event(cuda):
    """A worker held on the card by ``torch.cuda._sleep`` is not ready and
    not reaped until its completion event fires; the reaped outputs are
    complete and right."""
    impl = _pool(cuda, [0.0, 0.0, 0.0])
    xe = torch.arange(3 * 4, dtype=torch.float32, device=cuda).reshape(3, 1, 4)
    ke = torch.ones(3, 4, 2, device=cuda)

    def program(i):
        def run(x, k):
            if i == 1:
                torch.cuda._sleep(200_000_000)  # ~0.1 s on the worker's stream
            return x[0] @ k
        return run

    try:
        pending = impl.submit(program, xe, ke)
        ev = {i: r[1] for i, r in pending.results.items()}
        assert all(isinstance(e, torch.cuda.Event) for e in ev.values())
        assert not impl.ready(pending, 3)  # worker 1 still asleep on the card
        results, times, _ = impl.collect(pending, 2)
        assert set(results) == {0, 2} and np.isnan(times[1])
        for i, out in results.items():
            _close(out, (xe[i, 0] @ ke[i]))
        results, _, _ = impl.collect(pending, 3)
        assert ev[1].query() and set(results) == {0, 1, 2}
    finally:
        impl.shutdown()
        torch.cuda.synchronize()


def test_cuda_device_pool_delayed_dispatch_on_worker_stream(cuda):
    """A straggler's delayed dispatch runs on a timer thread, and still
    launches on its own worker's stream and device (the kernels launch on
    the calling thread's current stream), waiting for the master's ready
    event; an undelayed one on the master thread likewise."""
    import threading

    impl = _pool(cuda, [0.0, 0.02])
    seen = {}

    def program(i):
        def run(x, k):
            seen[i] = (threading.current_thread().name,
                       torch.cuda.current_stream().cuda_stream,
                       torch.cuda.current_device())
            return k2.matmul(x[0].contiguous(), k.contiguous())
        return run

    try:
        master = torch.cuda.Stream(device=cuda)
        with torch.cuda.stream(master):
            # shares produced late on the master's stream: the workers must
            # wait for them, not read stale memory
            torch.cuda._sleep(50_000_000)
            xe = torch.full((2, 1, 2, 8), 3.0, device=cuda)
            ke = torch.ones(2, 8, 5, device=cuda)
            before = k2.launches.count
            pending = impl.submit(program, xe, ke)
            results, _, _ = impl.collect(pending, 2)
            assert k2.launches.count == before + 2
            outs = {i: impl.gather(o) for i, o in results.items()}
        torch.cuda.synchronize()
        for i in (0, 1):
            assert seen[i][1] == impl.streams[i].cuda_stream
            assert seen[i][2] == impl.devices[i].index
            _close(outs[i], torch.full((2, 5), 24.0))
        assert seen[0][0] == threading.current_thread().name
        assert seen[1][0] != threading.current_thread().name
    finally:
        impl.shutdown()


def test_cuda_device_pool_reraises_a_failed_dispatch(cuda):
    """A launch that fails on a delayed worker's timer thread surfaces from
    ``collect`` (the round reports ready), and is never taken for a dead
    worker."""
    import threading

    impl = _pool(cuda, [0.0, 0.02, 0.02])
    xe = torch.ones(3, 1, 2, 4, device=cuda)
    ke = torch.ones(3, 4, 3, device=cuda)

    def program(i):
        def run(x, k):
            if i == 2:  # K2 refuses a non-contiguous operand
                return k2.matmul(x[0], k.t().contiguous().t())
            return k2.matmul(x[0].contiguous(), k.contiguous())
        return run

    try:
        pending = impl.submit(program, xe, ke)
        box = {}

        def reap():
            try:
                impl.collect(pending, 3)
            except ValueError as err:
                box["err"] = err

        t = threading.Thread(target=reap, daemon=True)
        t.start()
        t.join(30.0)
        assert not t.is_alive(), "collect hung on a failed dispatch"
        assert "contiguous" in str(box["err"])
        assert impl.ready(pending, 3)
    finally:
        impl.shutdown()
        torch.cuda.synchronize()


def test_cuda_coded_linear_matches_plain(cuda):
    """``CodedLinear`` at SmolLM's up-projection widths on the card (worker
    GEMM on K2, decode on K3 with the inverse on the host) against the same
    layer on the CPU (their plain versions) and a plain fp32 matmul, for
    every survivor subset."""
    import itertools

    from repro_torch.core.coded_linear import CodedLinear
    from repro_torch.core.fcdcc import FcdccPlan

    torch.backends.cuda.matmul.allow_tf32 = False
    plan = FcdccPlan(n=6, k_a=2, k_b=4)
    x = RNG.standard_normal((4, 576)).astype(np.float32)
    w = (RNG.standard_normal((576, 1536)) / 24.0).astype(np.float32)
    gpu, cpu = CodedLinear(plan, 4, 576, 1536), CodedLinear(plan, 4, 576, 1536)
    xg, wg = torch.as_tensor(x, device=cuda), torch.as_tensor(w, device=cuda)
    want = torch.as_tensor(x) @ torch.as_tensor(w)
    for ids in itertools.combinations(range(6), plan.delta):
        before = (k2.launches.count, k3.launches.count)
        got = gpu.run_simulated(xg, wg, list(ids))
        assert k2.launches.count == before[0] + len(ids)
        assert k3.launches.count == before[1] + 1
        _close(got, cpu.run_simulated(torch.as_tensor(x), torch.as_tensor(w), list(ids)))
        _close(got, want, rel=1e-4)
    assert gpu.weight_encode_calls == 1


# -- the torch backend under PyTorch's default TF32 flags --------------------
@pytest.mark.parametrize("fused", [True, False])
def test_cuda_torch_backend_pipeline_fp32_under_default_tf32(cuda, fused,
                                                             monkeypatch):
    """``backend="torch"`` convolves through cuDNN, whose TF32 flag PyTorch
    turns on by default: the coded layer's guard keeps its convolutions in
    IEEE fp32, so VGG-16 (56x56, n=8, (2, 4)) stays within 1e-4 of
    max|uncoded|.  Prints the error, and the error without the guard."""
    import contextlib

    from repro_torch.core import fcdcc
    from repro_torch.core.pipeline import build_cnn_pipeline
    from repro_torch.models.cnn import init_cnn, run_convls

    params = init_cnn("vgg16", torch.Generator().manual_seed(4), cuda)
    x = torch.as_tensor(RNG.standard_normal((2, 3, 56, 56)).astype(np.float32),
                        device=cuda)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        want = run_convls("vgg16", params, x).cpu()
    scale = float(want.abs().max())

    def err():
        pipe = build_cnn_pipeline("vgg16", params, 8, default_kab=(2, 4),
                                  input_hw=56, backend="torch",
                                  fuse_transitions=fused, device=cuda)
        return float((pipe.run(x, [6, 1, 3]).cpu() - want).abs().max()) / scale

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        assert torch.backends.cudnn.allow_tf32
        guarded = err()
        monkeypatch.setattr(fcdcc, "_fp32_conv", contextlib.nullcontext)
        unguarded = err()
    print(f"torch backend, fused={fused}, cuDNN TF32 on: rel err vs uncoded "
          f"{guarded:.3e} with the guard, {unguarded:.3e} without")
    assert guarded <= 1e-4


# -- the analysis gate's card half: capture and replay -----------------------
def _vgg_pipe(cuda):
    from repro_torch.analysis import contracts

    return contracts.build_pipeline(contracts.ContractConfig(
        "vgg16", "kernel", True, n=8, kab=(2, 4), buckets=(1, 2)), cuda)


def _capture(pipe, cell, cuda, seed=0):
    from repro_torch.analysis import contracts, dispatch_tools

    gen = torch.Generator(device=cuda).manual_seed(seed)
    a1 = dispatch_tools.materialize(pipe, cell, cuda, gen)
    a2 = dispatch_tools.materialize(pipe, cell, cuda, gen, variant=1)
    return a1, a2, contracts.capture_replay(cell, a1, a2, cuda)


def test_cuda_capture_replays_k1_worker_and_k2_transition_cells(cuda):
    """A K1 worker cell and a K2 transition cell, captured after a warm-up,
    replayed on a second argument set (the transition's on another survivor
    subset's decode inverse) bit-equal to eager; the replay launches
    through the graph, not the wrappers."""
    pipe = _vgg_pipe(cuda)
    cells = list(pipe.program_space())
    worker = next(c for c in cells if c.kind == "worker" and c.mode == "cluster"
                  and c.layer == 3 and c.bucket == 2)
    trans = next(c for c in cells if c.kind == "transition"
                 and c.mode == "direct" and c.layer == 1 and c.bucket == 2)
    for cell, counter, per_call in ((worker, k1.launches, 1),
                                    (trans, k2.launches, 2)):
        before = counter.count
        a1, a2, err = _capture(pipe, cell, cuda)
        assert err is None, (cell.cell_id, err)
        # warm-up, two replays (each adds the launches its graph holds; the
        # capture itself launches nothing) and the eager call
        assert counter.count - before == 4 * per_call
    assert not torch.equal(a1[1], a2[1])  # another subset's decode inverse


def test_cuda_capture_replays_a_k3_encoder_cell(cuda):
    """K3 encoding with a fixed (subset-independent) code, as the weight
    encode runs it, captures and replays bit-equal to eager: the code is a
    launch parameter that never changes."""
    from repro_torch.core.fcdcc import FcdccPlan
    from repro_torch.core.pipeline import ArgSpec, ProgramCell
    from repro_torch.kernels.coded_gemm import crme_encode

    matrix = FcdccPlan(n=4, k_a=1, k_b=4).codes[1].matrix
    cell = ProgramCell("k3.encode", "encoder", "master", 0, 1, ("k3",),
                       lambda parts: crme_encode(parts, matrix),
                       (ArgSpec((4, 576, 144), torch.float32),))
    before = k3.launches.count
    _, _, err = _capture(None, cell, cuda)
    assert err is None, err
    assert k3.launches.count - before == 4  # warm-up, two replays, eager


def test_cuda_k3_decode_capture_bakes_the_inverse(cuda):
    """Why the LM decoder cells are eager-only: K3 takes the survivor
    inverse by value, so a captured decode replays the captured subset's
    inverse whatever the static host tensor holds afterwards."""
    from repro_torch.analysis import contracts

    pipe = contracts.build_decoder_pipeline(
        contracts.DecoderContractConfig("coded", "kernel"), cuda)
    cell = next(c for c in pipe.program_space() if c.kind == "decoder")
    assert cell.eager_only and cell.args[1].host
    a1, a2, err = _capture(pipe, cell, cuda)
    assert not torch.equal(a1[1], a2[1])
    assert err is not None and "differs" in err


def test_cuda_contracts_clean_and_captured(cuda):
    """The gate's card half on one CNN and the LM decoder at smoke size:
    no finding; every CNN cell captured; the LM decoder cells eager-only."""
    from repro_torch.analysis import contracts

    cfg = contracts.ContractConfig("lenet5", "kernel", True)
    rep = contracts.analyze_config(cfg, cuda)
    assert not rep.findings, rep.render_text()
    assert rep.stats[f"{cfg.label}/captured"] == \
        rep.stats[f"{cfg.label}/programs_checked"]
    dcfg = contracts.DecoderContractConfig("coded", "kernel")
    rep = contracts.analyze_decoder_config(dcfg, cuda)
    assert not rep.findings, rep.render_text()
    eager = rep.stats[f"{dcfg.label}/eager_only_cells"]
    assert eager and all("decoder" in cid for cid in eager)
    assert all("K3" in why for why in rep.stats[f"{dcfg.label}/eager_only_reasons"])
    assert rep.stats[f"{dcfg.label}/captured"] + len(eager) == \
        rep.stats[f"{dcfg.label}/programs_checked"]


# -- compiled programs: CUDA-graph round programs -----------------------------
def _served(cuda, graphs, pool, delays, groups=(1, 3, 2, 4, 1), hw=56, seed=5,
            workers=False):
    """VGG-16 at ``hw`` served at pipeline depth 2 (fused transitions, n=8,
    (2, 4)) in request groups, each submitted at once and finished before
    the next (the same batches in every run), the worker rounds replayed
    too where ``workers``.  Returns the outputs, the server and the worker
    graph counts read before shutdown."""
    from repro_torch.models.cnn import init_cnn
    from repro_torch.runtime import StragglerModel
    from repro_torch.serving import CodedServer

    torch.backends.cuda.matmul.allow_tf32 = False
    params = init_cnn("vgg16", torch.Generator().manual_seed(seed), cuda)
    srv = CodedServer.from_cnn(
        "vgg16", params, 8, default_kab=(2, 4), input_hw=hw,
        straggler=StragglerModel(np.asarray(delays)), mode="threads",
        bucket_sizes=(1, 2, 4), pipeline_depth=2, fuse_transitions=True,
        pool=pool, device=cuda)
    srv.pipeline.set_graphs(graphs, workers=workers)
    xs = np.random.default_rng(seed).standard_normal(
        (sum(groups), 3, hw, hw)).astype(np.float32)
    srv.warmup()
    outs, i = [], 0
    with srv:
        for g in groups:
            with srv.scheduler.not_empty:
                handles = srv.submit_many(xs[i:i + g])
            outs += [torch.as_tensor(h.result(timeout=300)) for h in handles]
            i += g
        counts = (srv.cluster._pool_impl().graph_counts()
                  if srv.cluster.pool == "device" else [])
    return outs, srv, counts, params, xs


# survivors 0 and 1, worker 1 delayed (its dispatch, and so its replay, on
# the timer thread); every other worker slowed far beyond a round
FORCED_DELAYED = [0.0, 0.01] + [0.25] * 6


@pytest.mark.parametrize("pool", ["device", "threads"])
def test_cuda_vgg16_56_served_replayed_equals_eager(cuda, pool):
    """VGG-16 56x56 served with the rounds replayed from CUDA graphs (the
    master's on both pools, the workers' on the device pool) against the
    same server with ``graphs=False`` and (device pool) with the default,
    worker rounds eager: every result ``torch.equal``, all within 1e-4 of
    max|uncoded|, captures within their bounds, and every kind of program
    replayed."""
    from repro_torch.models.cnn import run_convls

    got, srv, counts, params, xs = _served(cuda, True, pool, FORCED_DELAYED,
                                           workers=pool == "device")
    eager, _, _, _, _ = _served(cuda, False, pool, FORCED_DELAYED)
    for g, e in zip(got, eager):
        assert torch.equal(g, e)
    if pool == "device":
        default, _, eager_counts, _, _ = _served(cuda, True, pool,
                                                 FORCED_DELAYED)
        assert eager_counts == [0] * 8
        for g, d in zip(got, default):
            assert torch.equal(g, d)
    ref = run_convls("vgg16", params, torch.as_tensor(xs, device=cuda)).cpu()
    scale = float(ref.abs().max())
    assert float((torch.stack(got) - ref).abs().max()) <= 1e-4 * scale
    pipe = srv.pipeline
    master = pipe.master_graphs
    assert 0 < master.num_graphs <= pipe.master_graph_bound
    assert all(master.replays[k] > 0 for k in ("encoder", "transition", "decoder"))
    if pool == "device":
        assert counts[0] > 0 and counts[1] > 0
        assert max(counts) <= pipe.worker_graph_bound


def test_cuda_capture_on_master_while_timer_dispatches(cuda):
    """The master captures new programs while the device pool's timer
    thread dispatches (and replays) a straggler's rounds on its own
    stream: thread-local capture mode lets both proceed, and every result
    is right."""
    from repro_torch.core.graphs import GraphSet
    from repro_torch.core.pipeline import Program

    impl = _pool(cuda, [0.0, 0.002])
    xe = torch.ones(2, 1, 4, 64, device=cuda)
    ke = torch.ones(2, 64, 32, device=cuda)

    def raw(x, k):
        return k2.matmul(x[0].contiguous(), k)

    fn = lambda i: impl.program(("t",), raw, i, None,  # noqa: E731
                                torch.cuda.CUDAGraph)
    master = GraphSet("master", cuda)
    try:
        impl.warm(fn, xe, ke, "s")
        pendings = [impl.submit(fn, xe, ke, "s") for _ in range(40)]
        worker1 = impl.graph_set(1, torch.cuda.CUDAGraph)
        replays0 = worker1.replays.get("worker", 0)
        for m in range(1, 25):  # new signatures: a capture each
            prog = Program(lambda a: k2.matmul(a, a.t().contiguous()),
                           name=f"m{m}", graphs=master)
            a = torch.full((m, 16), 0.5, device=cuda)
            _close(prog(a), torch.full((m, m), 4.0))
        for pending in pendings:
            results, _, _ = impl.collect(pending, 2)
            for out in results.values():
                _close(impl.gather(out), torch.full((4, 32), 64.0))
        assert worker1.replays["worker"] > replays0  # the timer kept going
        assert master.num_graphs == 24
    finally:
        impl.shutdown()
        torch.cuda.synchronize()


def test_cuda_resident_filter_shard_is_not_copied(cuda):
    """A worker graph keeps its coded filter shard where it lies: the
    graph's resident is the shard itself, its static buffers hold the
    share only, and rewriting the shard in place changes the replay."""
    from repro_torch.core.pipeline import build_cnn_pipeline
    from repro_torch.models.cnn import init_cnn
    from repro_torch.runtime import FcdccCluster, StragglerModel

    params = init_cnn("vgg16", torch.Generator().manual_seed(6), cuda)
    pipe = build_cnn_pipeline("vgg16", params, 8, default_kab=(2, 4),
                              input_hw=32, fuse_transitions=True, device=cuda)
    pipe.set_graphs(True, workers=True)
    x = torch.as_tensor(RNG.standard_normal((1, 3, 32, 32)).astype(np.float32),
                        device=cuda)
    with FcdccCluster(pipe.specs[0].plan, StragglerModel.none(8),
                      mode="threads", pool="device", device=cuda) as cl:
        cl.load_pipeline(pipe, "v")
        cl.run_pipeline(x, model="v")
        impl = cl._pool_impl()
        shards = impl.resident_filters("v/conv1_1", pipe.coded_filters[0])
        gs = impl.graph_set(3, torch.cuda.CUDAGraph)
        ent = next(g for (prog, sig, slot), g in gs._graphs.items()
                   if slot == "v/conv1_1")
        copied = [(j, hex(t.data_ptr()), str(t.device), tuple(t.shape))
                  for j, t in ent.copied]
        shard = (hex(shards[3].data_ptr()), str(shards[3].device),
                 tuple(shards[3].shape))
        held = {j: (hex(ptr), str(t.device)) for j, (t, ptr, _) in
                ent.resident.items()}
        assert [j for j, _ in ent.copied] == [0], (
            f"copied arguments (index, pointer, device, shape) {copied}; the "
            f"shard {shard}; residents {held}")
        assert ent.resident[1][1] == shards[3].data_ptr(), (
            f"resident {held} is not the shard {shard}; copied {copied}")
        share_bytes = sum(s.numel() * 4 for g in gs._graphs.values()
                          for _, s in g.copied)
        assert gs.static_bytes == share_bytes
        fn = lambda i: impl.program(pipe.specs[0].program_key,  # noqa: E731
                                    pipe.layers[0].worker_compute, i,
                                    pipe._cluster_programs,
                                    torch.cuda.CUDAGraph)
        xe = pipe.encoder(0)(x)

        def launch():
            out, done = impl._launch(fn, xe, shards, 3, impl._ready_event(),
                                     "v/conv1_1")
            done.synchronize()
            return out.clone()

        before = launch()
        shards[3].mul_(2.0)
        after = launch()
        shards[3].mul_(0.5)
        _close(after, 2.0 * before)
        assert len(gs._graphs) == len(pipe.specs)  # replayed, not recaptured


def test_cuda_capture_counts_bounded_under_batches_and_subsets(cuda):
    """Many batch sizes and survivor subsets on the device pool: graphs per
    worker at or below one per (layer, bucket), the master's at its
    bound; a repeat adds no capture."""
    from repro_torch.core.pipeline import build_cnn_pipeline
    from repro_torch.models.cnn import init_cnn
    from repro_torch.runtime import FcdccCluster, StragglerModel

    params = init_cnn("vgg16", torch.Generator().manual_seed(7), cuda)
    pipe = build_cnn_pipeline("vgg16", params, 8, default_kab=(2, 4),
                              input_hw=32, fuse_transitions=True,
                              bucket_sizes=(1, 2, 4), device=cuda)
    pipe.set_graphs(True, workers=True)
    for delays in ([0.0] * 8, [0.0, np.inf, 0.0, 0.0, np.inf, 0.0, 0.0, 0.0],
                   [np.inf, np.inf, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]):
        with FcdccCluster(pipe.specs[0].plan, StragglerModel(np.array(delays)),
                          mode="threads", pool="device", device=cuda) as cl:
            cl.load_pipeline(pipe, "v")
            for b in (1, 2, 3, 4, 1, 3):
                x = torch.as_tensor(RNG.standard_normal((b, 3, 32, 32))
                                    .astype(np.float32), device=cuda)
                xp, _ = pipe.pad_to_bucket(x)
                y, timings = cl.run_pipeline(xp, model="v")
                want = pipe.run(xp, timings[0].used_workers)
                _close(y, want, rel=1e-4)
            counts = cl._pool_impl().graph_counts()
            assert 0 < max(counts) <= pipe.worker_graph_bound
            n = pipe.master_graphs.num_graphs
            cl.run_pipeline(xp, model="v")
            assert pipe.master_graphs.num_graphs == n
    assert pipe.master_graphs.num_graphs <= pipe.master_graph_bound


def test_cuda_lm_smoke_replayed_equals_eager(cuda):
    """SmolLM smoke on the device pool (worker 2 straggling, worker 3
    dead), glue and worker rounds replayed, against the same requests
    served with ``graphs=False``: tokens and logits rows ``torch.equal``
    (the prefill's rows among them); warmup captured every graph, the
    prefill's one a bucket, serving none; captures within bounds."""
    from repro_torch.core.decoder_pipeline import build_lm_decoder_pipeline
    from repro_torch.runtime import StragglerModel
    from repro_torch.serving import CodedLMServer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = _smoke_lm(cuda)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(1, 9, 6)]
    gens = [int(g) for g in rng.integers(2, 9, 6)]
    runs = {}
    for graphs in (True, False):
        pipe = build_lm_decoder_pipeline(cfg, params, 4, k_b=4,
                                         bucket_sizes=(1, 2, 4), max_len=32,
                                         backend="kernel", device=cuda,
                                         graphs=graphs)
        pipe.set_graphs(graphs, workers=graphs)
        rows = {}
        srv = CodedLMServer(
            pipe, StragglerModel(np.array([0.0, 0.0, 0.01, np.inf])),
            mode="threads", pool="device", max_prompt=8, poll_interval_s=0.001,
            on_logits=lambda rid, row, rows=rows: rows.setdefault(rid, []).append(
                row.clone()))
        srv.warmup()
        warm = 0 if pipe.master_graphs is None else pipe.master_graphs.num_graphs
        with srv:
            with srv.scheduler.not_empty:
                handles = [srv.submit(p, g) for p, g in zip(prompts, gens)]
            toks = [list(h.result(timeout=300)) for h in handles]
            counts = srv.cluster._pool_impl().graph_counts()
        torch.cuda.synchronize()
        runs[graphs] = (toks, [torch.stack(rows[h.request_id]) for h in handles])
        if graphs:
            assert pipe.master_graphs.num_graphs == warm <= pipe.glue_graph_bound
            assert 0 < max(counts) <= pipe.worker_graph_bound
            assert pipe.master_graphs.replays["glue.attn"] > 0
            # the prompt prefill: one graph a bucket, all of them warmup's
            assert pipe.master_graphs.captures["prefill"] == 3
            assert pipe.master_graphs.replays["prefill"] > 3
    assert runs[True][0] == runs[False][0]
    for r, e in zip(runs[True][1], runs[False][1]):
        assert torch.equal(r, e)


def test_cuda_capture_stream_released_with_its_thread(cuda):
    """A thread that captured leaves no CUDA stream behind: its capture
    stream is destroyed when it exits (a pool's timer thread, a server's
    engine thread)."""
    import gc
    import threading

    from repro_torch.core import graphs
    from repro_torch.core.pipeline import Program

    before = graphs.live_capture_streams()
    seen = []

    def capture():
        gs = graphs.GraphSet("t", cuda)
        prog = Program(lambda a: a * 2.0, name="twice", graphs=gs)
        seen.append(prog(torch.ones(8, device=cuda)).sum().item())
        seen.append(graphs.live_capture_streams())

    for _ in range(3):
        t = threading.Thread(target=capture)
        t.start()
        t.join()
    gc.collect()
    assert seen == [16.0, before + 1] * 3
    assert graphs.live_capture_streams() == before


def test_cuda_k4_refuses_autograd(cuda):
    """K4 has no backward: under grad mode an operand that requires grad
    raises before any launch; under no_grad the same call runs."""
    q = torch.randn(6, 8, 16, device=cuda, requires_grad=True)
    kv = torch.randn(2, 8, 16, device=cuda)
    before = k4.launches.count
    with pytest.raises(RuntimeError, match="no backward"):
        k4.flash_attention(q, kv, kv, rep=3)
    assert k4.launches.count == before
    with torch.no_grad():
        k4.flash_attention(q, kv, kv, rep=3)
    assert k4.launches.count == before + 1


def test_cuda_full_width_train_step_matches_fp64(cuda):
    """One SmolLM-135M train step's loss and gradients at full width on the
    card (the training route: no K4 launch) against chip_smoke.py's plain
    float64 recompute: every leaf finite, non-zero in every layer, within
    1e-4 of its max|g|."""
    from repro_torch.configs import get_bundle
    from repro_torch.data import DataConfig, SyntheticTokens

    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    bundle = get_bundle("smollm-135m")
    params = bundle.init(torch.Generator().manual_seed(0), torch.float32, cuda)
    data = SyntheticTokens(DataConfig(vocab=bundle.cfg.vocab, seq_len=256,
                                      global_batch=8))
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in data.batch(0).items()}
    before = k4.launches.count
    out = cs.check_step1_fp64(bundle, params, batch)  # raises on a mismatch
    assert k4.launches.count == before
    assert out["loss_rel_err"] <= 1e-5 and out["grad_rel_err"] <= 1e-4


# -- the arch zoo: MoE at DeepSeek-V2's widths, K4 at Qwen3's head dim, the
# plain route for shapes K4 has no instance for, init_lm on the card -----


def test_cuda_moe_gather_matches_plain_at_deepseek_v2_widths(cuda):
    """One MoE layer at DeepSeek-V2's expert widths (d 5120, 160 experts of
    1536, top-6, 2 shared, 16 dispatch groups) on 64 tokens: the gather
    dispatch against the float-scatter plain version within 1e-5 of
    max|y|, no entry dropped."""
    from repro_torch.configs import deepseek_v2_236b
    from repro_torch.models import moe

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = deepseek_v2_236b.full().moe
    gen = torch.Generator(device=cuda).manual_seed(0)

    def draw(schema):
        return {k: draw(v) if isinstance(v, dict) else
                torch.randn(v.shape, generator=gen, device=cuda).mul_(v.shape[-2] ** -0.5)
                for k, v in schema.items()}

    w = draw(moe.moe_schema(cfg))
    x = torch.randn(64, cfg.d_model, generator=gen, device=cuda)
    with torch.no_grad():
        got = moe.moe_ffn(w, x, cfg)
        want = moe.moe_ffn_plain(w, x, cfg)
        r = moe.route(w, moe._groups(x, cfg)[0], cfg)
    assert r.gate_e.shape == (16, 4, 6) and bool(r.keep.all())
    _close(got, want)


@pytest.mark.parametrize("bh,s,rep", [(128, 16, 4), (128, 16, 1), (64, 37, 4),
                                      (32, 64, 4)])
def test_cuda_flash_attention_head_dim_128(cuda, bh, s, rep):
    """K4 at head dim 128 (Qwen3's rep 4 and CodeQwen's rep 1 prefill
    shapes, and ragged and longer S) against its plain version."""
    gen = torch.Generator(device=cuda).manual_seed(bh + s + rep)
    q = torch.randn(bh, s, 128, generator=gen, device=cuda)
    k, v = (torch.randn(bh // rep, s, 128, generator=gen, device=cuda)
            for _ in range(2))
    before = k4.launches.count
    got = k4.flash_attention(q, k, v, causal=True, rep=rep)
    torch.cuda.synchronize()
    assert k4.launches.count == before + 1
    _close(got, k4.flash_attention_plain(q, k, v, causal=True, rep=rep), 2e-5)


@pytest.mark.parametrize("d,dv,k4_launches", [(256, 256, 0), (192, 128, 0),
                                              (128, 128, 1)])
def test_cuda_attend_takes_the_plain_route_where_k4_has_no_instance(
        cuda, d, dv, k4_launches):
    """The serving route's prefill attention on the card: head dim 256 and
    MLA's 192 / 128 launch no K4 (read from ``launches``) and equal the
    plain masked attention; head dim 128 launches it once."""
    from repro_torch.models import common
    from repro_torch.models import transformer as lm

    cfg = lm.LMConfig(name="r", layers=1, d_model=32, n_heads=8, n_kv_heads=2,
                      head_dim=d, d_ff=32, vocab=16)
    gen = torch.Generator(device=cuda).manual_seed(d)
    q = torch.randn(2, 16, 8, d, generator=gen, device=cuda)
    k = torch.randn(2, 16, 2, d, generator=gen, device=cuda)
    v = torch.randn(2, 16, 2, dv, generator=gen, device=cuda)
    pos = lm._positions(2, 0, 16, cuda)
    before = k4.launches.count
    got = lm._attend(q, k, v, pos, pos, cfg, None, start=0)
    torch.cuda.synchronize()
    assert k4.launches.count - before == k4_launches
    want = common.attention(q, k, v, common.make_attn_mask(pos, pos),
                            scale=d ** -0.5)
    _close(got, want, 2e-5)


def test_cuda_init_lm_draws_on_the_card(cuda):
    """``init_lm`` with a CUDA generator draws every leaf on the card: the
    same seed gives the same tree, each leaf is the generator's next draw
    in sorted-key order, and the peak holds the tree plus one leaf's
    scratch at most (no host copy, no second tree)."""
    from repro_torch.configs import deepseek_v2_236b
    from repro_torch.models import transformer as lm
    from repro_torch.tree import tree_items

    cfg = deepseek_v2_236b.smoke()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    a = lm.init_lm(cfg, torch.Generator(device=cuda).manual_seed(4), cuda)
    peak = torch.cuda.max_memory_allocated(cuda) - base
    b = lm.init_lm(cfg, torch.Generator(device=cuda).manual_seed(4), cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    total = biggest = 0
    for (path, leaf), (_, other) in zip(tree_items(a), tree_items(b)):
        assert leaf.device.type == "cuda" and torch.equal(leaf, other), path
        total += leaf.numel() * 4
        biggest = max(biggest, leaf.numel() * 4)
    for path, spec in tree_items(lm.lm_schema(cfg)):
        shape, scale = spec.shape, spec.scale
        if scale == 0.0:
            continue
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = scale if scale is not None else fan_in ** -0.5
        want = torch.randn(shape, generator=gen, device=cuda).mul_(std)
        node = a
        for key in path:
            node = node[key]
        assert torch.equal(node, want), path
    assert peak <= total + biggest + (1 << 20)


# -- the recurrent and encoder-decoder families: K4 at Hymba's rep 5, each
# family's smoke forward on the card against the CPU, and one
# value_and_grad of each family's loss at full width -------------------

FAMILIES = ["rwkv6-1.6b", "hymba-1.5b", "whisper-medium"]


@pytest.mark.parametrize("bh,s,rep", [(100, 16, 5), (100, 141, 5), (64, 16, 1)])
def test_cuda_flash_attention_head_dim_64_rep5(cuda, bh, s, rep):
    """K4 at Hymba's prefill shape (4 x 25 query heads over 5 KV heads, D
    64: rep 5, never launched before), a longer ragged S at rep 5, and
    Whisper's decoder (4 x 16 heads, rep 1) against its plain version."""
    gen = torch.Generator(device=cuda).manual_seed(bh + s + rep)
    q = torch.randn(bh, s, 64, generator=gen, device=cuda)
    k, v = (torch.randn(bh // rep, s, 64, generator=gen, device=cuda)
            for _ in range(2))
    before = k4.launches.count
    got = k4.flash_attention(q, k, v, causal=True, rep=rep)
    torch.cuda.synchronize()
    assert k4.launches.count == before + 1
    _close(got, k4.flash_attention_plain(q, k, v, causal=True, rep=rep), 2e-5)


def _family_batch(bundle, b, s, gen, device):
    toks = torch.randint(0, bundle.cfg.vocab, (b, s + 1), generator=gen,
                         device=gen.device).to(device)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if bundle.family == "encdec":
        batch["frames"] = torch.randn((b, bundle.cfg.enc_len, bundle.cfg.d_model),
                                      generator=gen, device=gen.device).to(device)
    return batch


@pytest.mark.parametrize("arch", FAMILIES)
def test_cuda_family_smoke_forward_matches_cpu(cuda, arch):
    """Each family's smoke ``prefill_fn`` (Hymba's attention and Whisper's
    encoder, decoder and cross-attention on K4) and 6 ``decode_fn`` steps
    on the card against the same weights on the CPU, TF32 off."""
    from repro_torch.configs import get_bundle
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    bundle = get_bundle(arch, smoke=True)
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    on_card = tree_map(lambda a: a.to(cuda), params)
    batch = _family_batch(bundle, 2, 13, torch.Generator().manual_seed(1), "cpu")
    batch.pop("labels")
    before = k4.launches.count
    got = bundle.prefill_fn(on_card, {k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    # Whisper: 2 encoder layers, and 2 decoder layers of self- and
    # cross-attention each
    launches = {"rwkv6-1.6b": 0, "hymba-1.5b": 2, "whisper-medium": 6}[arch]
    assert k4.launches.count - before == launches
    _close(got, bundle.prefill_fn(params, batch), 1e-4)
    caches = [bundle.make_cache(2, 8, torch.float32, dev) for dev in ("cpu", cuda)]
    for t in range(6):
        tok = batch["tokens"][:, t:t + 1]
        want, caches[0] = bundle.decode_fn(params, caches[0], {"tokens": tok, "pos": t})
        got, caches[1] = bundle.decode_fn(on_card, caches[1],
                                          {"tokens": tok.to(cuda), "pos": t})
        _close(got, want, 1e-4)


@pytest.mark.parametrize("arch", FAMILIES)
def test_cuda_family_full_width_value_and_grad(cuda, arch, capsys):
    """One ``value_and_grad`` of each family's loss at full width and 2
    layers (Whisper 2 + 2), batch 2, seq 128, on the card: the training
    route (no K4 launch), the loss and every gradient leaf finite, and
    every leaf's gradient non-zero; the peak memory printed."""
    from repro_torch.configs import get_bundle
    from repro_torch.launch import steps
    from repro_torch.models.registry import with_layers
    from repro_torch.tree import tree_items

    torch.backends.cuda.matmul.allow_tf32 = False
    bundle = with_layers(get_bundle(arch), 2)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = bundle.init(gen, torch.float32, cuda)
    batch = _family_batch(bundle, 2, 128, gen, cuda)
    before = k4.launches.count
    loss, grads = steps.value_and_grad(bundle.loss_fn, params, batch)
    torch.cuda.synchronize()
    assert k4.launches.count == before
    assert bool(torch.isfinite(loss))
    for path, g in tree_items(grads):
        assert bool(torch.isfinite(g).all()), path
        assert bool(g.abs().sum() > 0), path
    peak = torch.cuda.max_memory_allocated(cuda)
    with capsys.disabled():
        print(f"\n{arch} at full width, 2 layers, batch 2 x 128: loss "
              f"{float(loss):.4f}, {len(tree_items(grads))} gradient leaves "
              f"finite, peak {peak / 2**30:.2f} GiB on "
              f"{torch.cuda.get_device_name(cuda)}")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cuda_serve_lm_captured_equals_eager(cuda, arch):
    """``serve_lm`` at the smoke config on the card, its decode step and
    prefill replayed from CUDA graphs (the default) against
    ``graphs=False`` from the same weights: tokens equal, every prefill
    and decode call's logits ``torch.equal``, at most two captures, and
    K4 inside the captured prefill counted at the warm-up and once a
    replay (twice the eager count)."""
    from repro_torch.configs import get_bundle
    from repro_torch.launch.serve import serve_lm

    torch.backends.cuda.matmul.allow_tf32 = False
    params = get_bundle(arch, smoke=True).init(
        torch.Generator(device=cuda).manual_seed(0), torch.float32, cuda)
    runs = []
    for graphs in (True, False):
        rows, timings = [], {}
        before = k4.launches.count
        toks = serve_lm(arch, batch=4, prompt_len=16, gen=8, smoke=True,
                        device=cuda, params=params, graphs=graphs,
                        timings=timings, on_logits=rows.append)
        torch.cuda.synchronize()
        runs.append((toks, rows, timings, k4.launches.count - before))
    (toks, rows, timings, k4_c), (toks_e, rows_e, timings_e, k4_e) = runs
    assert torch.equal(toks, toks_e)
    assert len(rows) == len(rows_e)
    assert all(torch.equal(a, b) for a, b in zip(rows, rows_e))
    assert sum(timings["graphs"]["captures"].values()) <= 2
    assert "graphs" not in timings_e
    assert k4_c == 2 * k4_e


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-v2-236b", "rwkv6-1.6b"])
def test_cuda_train_captured_matches_eager(cuda, tmp_path, arch):
    """``train`` at the smoke config on the card, each step replayed from
    one CUDA graph (RWKV6's scan routes under ``torch.utils.checkpoint``
    inside it), against ``graphs=False`` from the same seed: the losses
    within 1e-5 relative (the embedding's atomic backward), the captured
    restart from step 3 within 1e-5 of the uninterrupted run."""
    from repro_torch.launch.train import train

    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(steps=6, batch=2, seq=64, smoke=True, device=cuda, log_every=100)
    eager = train(arch, graphs=False, **kw)
    captured = train(arch, ckpt_dir=str(tmp_path), ckpt_every=3, **kw)
    np.testing.assert_allclose(captured, eager, rtol=1e-5, atol=0)
    for d in tmp_path.iterdir():
        if d.name.startswith("step-") and int(d.name.split("-")[1]) > 3:
            d.rename(tmp_path / ("dropped-" + d.name))
    rest = train(arch, ckpt_dir=str(tmp_path), ckpt_every=3, **kw)
    np.testing.assert_allclose(rest, captured[3:], rtol=1e-5, atol=0)


# -- the autotune ledger: one K1 and one K2 cell swept on the card ----------
@pytest.fixture
def ledger(tmp_path, monkeypatch):
    """An isolated, empty autotune ledger for the test."""
    from repro_torch.kernels import autotune

    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "ledger.json"))
    autotune.clear_cache(memory_only=True)
    yield autotune
    autotune.clear_cache(memory_only=True)


def _swept_us(entry: dict, params: dict) -> float:
    return next(s["us"] for s in entry["swept"] if s["params"] == params)


def test_cuda_autotune_k1_cell(cuda, ledger):
    """A K1 cell with every split allowed (K 2,304): each candidate plan
    held to the plain version, the winner recorded no slower than the
    heuristic's plan, then launched by ``coded_worker`` from the ledger;
    a malformed entry raises."""
    xs, ks = (1, 8, 256, 16, 30), (4, 64, 256, 3, 3)
    xe = torch.as_tensor(RNG.standard_normal(xs).astype(np.float32), device=cuda)
    ke = torch.as_tensor(RNG.standard_normal(ks).astype(np.float32), device=cuda)
    want = k1.coded_worker_plain(xe, ke, 1)
    m, n, k = k1.gemm_shape(xs, ks, 1)
    cands = ledger.worker_candidates(xs, ks, 1)
    assert len(cands) == 24  # both routes, 3 N-tiles, 4 splits each
    assert {c["route"] for c in cands} == {"tc", "ffma"}
    for c in cands:
        _close(k1.launch_worker(k1.worker_plan_of(c, m, n, k), xe, ke, 1),
               want, rel=1e-4)
    win = ledger.tune_worker(xs, ks, 1, repeat=3)
    assert ledger.sweep_count() == 1
    assert ledger.tune_worker(xs, ks, 1) == win
    assert ledger.sweep_count() == 1  # a recorded cell is not swept again
    entry = ledger.load_cache()[ledger.worker_key(xs, ks, 1, device=cuda)]
    assert [s["params"] for s in entry["swept"]] == cands
    assert entry["us"] <= _swept_us(entry, cands[0])
    assert k1.choose_worker_plan(xs, ks, 1, cuda) == k1.worker_plan_of(
        win, m, n, k)
    before = k1.launches.count
    got = coded_worker(xe, ke, 1)
    torch.cuda.synchronize()
    assert k1.launches.count == before + 1
    _close(got, want, rel=1e-4)
    ledger.load_cache()[ledger.worker_key(xs, ks, 1, device=cuda)] = {
        "params": {"route": "tc", "bn": 48, "splits": 1}}
    with pytest.raises(ValueError):
        coded_worker(xe, ke, 1)
    # an entry of the FFMA-only ledger (no route) is refused at launch and
    # swept again by the tuner, which records a routed plan
    ledger.load_cache()[ledger.worker_key(xs, ks, 1, device=cuda)] = {
        "params": {"bn": 64, "splits": 1}, "us": 1.0, "swept": []}
    with pytest.raises(ValueError, match="route"):
        coded_worker(xe, ke, 1)
    again = ledger.tune_worker(xs, ks, 1, repeat=1)
    assert ledger.sweep_count() == 2 and set(again) == {"route", "bn", "splits"}
    _close(coded_worker(xe, ke, 1), want, rel=1e-4)


def test_cuda_autotune_k2_cell(cuda, ledger):
    """A K2 cell of the split kernel's regime (M 4, K 2,048): the column
    plan and every split held to the plain version, the winner no slower
    than the heuristic's plan, launched by ``matmul`` from the ledger; a
    malformed entry raises."""
    m, k, n = 4, 2048, 2048
    a = torch.as_tensor(RNG.standard_normal((m, k)).astype(np.float32), device=cuda)
    b = torch.as_tensor(RNG.standard_normal((k, n)).astype(np.float32), device=cuda)
    want = k2.matmul_plain(a, b, relu=True)
    cands = ledger.matmul_candidates(m, k, n)
    assert len(cands) == 5
    for c in cands:
        _close(k2.launch_plan(k2.matmul_plan_of(c, m, n, k), a, b, relu=True),
               want)
    win = ledger.tune_matmul(m, k, n, relu=True, repeat=3)
    assert ledger.sweep_count() == 1
    entry = ledger.load_cache()[ledger.matmul_key(m, k, n, relu=True,
                                                   device=cuda)]
    assert entry["us"] <= _swept_us(entry, cands[0])
    before = k2.launches.count
    got = k2.matmul(a, b, relu=True)
    torch.cuda.synchronize()
    assert k2.launches.count == before + 1
    assert k2.choose_matmul_plan(m, n, k, relu=True, device=cuda) == \
        k2.matmul_plan_of(win, m, n, k)
    _close(got, want)
    ledger.load_cache()[ledger.matmul_key(m, k, n, relu=True, device=cuda)] = {
        "params": {"kernel": "split", "splits": 3}}
    with pytest.raises(ValueError):
        k2.matmul(a, b, relu=True)
