"""The launch plans of K1 (``worker_plan``), K2 (``matmul_plan``), K3
(``coded_gemm_plan``) and K4 (``flash_plan``): plain Python, so they are
held here on the CPU at the exact shapes the serving paths give the
kernels (computed by ``chip_smoke.py``'s own shape functions from the
built pipelines).

  * the CNN transition GEMMs keep K2's column kernel;
  * the LM worker GEMMs at buckets 1, 2 and 4 take K2's split kernel with
    at least one block a SM;
  * each VGG-16 layer at bucket 8 gets the route, N-tile and K split of
    K1's design (the table in ``PERF.md``);
  * K3's decode widths spread over tens of one-warp blocks, its
    build-time widths stream float4 columns over every SM;
  * K4 at the SmolLM-135M prefill runs as hundreds of warps on at least
    one block a SM, and stages each KV head's keys once for all its
    query heads; long sequences take the tiled route;
  * Qwen3-4B's coded worker GEMMs take K2's split kernel, the down
    projection (K 9,728) with slices past one staging chunk;
  * every plan covers M, N and K (F; Sq and the heads) exactly, ragged
    edges included, within the limits the C entry points check.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.coded_gemm.kernel import (THREAD_CHOICES,
                                                  VEC4_MIN_COLUMNS,
                                                  coded_gemm_plan)
from repro_torch.kernels.conv2d.kernel import (ROUTES, TC_BLOCKS_PER_SM,
                                               TILE_K, TILE_M, route_plan,
                                               worker_plan)
from repro_torch.kernels.flash_attn.kernel import (MAX_GRID_Y,
                                                   MAX_TILED_BLOCKS, MAX_WARPS,
                                                   PAIRS_A_WARP,
                                                   TF32X3_MIN_ROWS, TILED_KERNELS,
                                                   WGMMA_HEAD_DIMS, WGMMA_MIN_ROWS,
                                                   flash_plan, max_pairs,
                                                   tiled_plan, tiled_route)
from repro_torch.kernels.matmul.kernel import (COLUMN_THREADS, SPLIT_CHOICES,
                                               SPLIT_CHUNK, SPLIT_MAX_M,
                                               SPLIT_STRIP, matmul_plan)
from repro_torch.kernels.native import NUM_SMS

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke():
    return _chip_smoke()


@pytest.fixture(scope="module")
def vgg(smoke):
    server, _ = smoke.build_server(torch.device("cpu"), smoke.HW)
    return server.pipeline


@pytest.fixture(scope="module")
def lm(smoke):
    pipe, _ = smoke.build_lm(torch.device("cpu"))
    return pipe


def _gemm_mnk(xs, ks, stride):
    ea, b, c, hh, wp = xs
    eb, nb, _, kh, kw = ks
    ho, wo = (hh - kh) // stride + 1, (wp - kw) // stride + 1
    return ea * b * ho * wo, eb * nb, c * kh * kw


def _covers_matmul(m, n, k):
    plan = matmul_plan(m, n, k)
    if plan.kernel == "column":
        bm = 8 if m <= 8 else 16
        assert plan.splits == 0 and plan.k_slice == k
        assert plan.blocks == -(-n // COLUMN_THREADS) * -(-m // bm)
        return plan
    strips = plan.blocks // plan.splits
    assert plan.kernel == "split" and m <= SPLIT_MAX_M
    assert plan.splits in SPLIT_CHOICES
    assert strips * SPLIT_STRIP >= n > (strips - 1) * SPLIT_STRIP
    assert plan.splits * plan.k_slice >= k > (plan.splits - 1) * plan.k_slice
    # a slice past one staging chunk only where no split count avoids it
    assert plan.k_slice <= SPLIT_CHUNK or -(-k // max(SPLIT_CHOICES)) > SPLIT_CHUNK
    return plan


def _covers_worker(m, n, k, route=None):
    plan = worker_plan(m, n, k) if route is None else route_plan(route, m, n, k)
    assert plan.route in ROUTES and plan.bn in (32, 64, 128)
    m_tiles, n_tiles = -(-m // TILE_M), -(-n // plan.bn)
    assert plan.tiles == m_tiles * n_tiles
    assert m_tiles * TILE_M >= m > (m_tiles - 1) * TILE_M
    assert n_tiles * plan.bn >= n > (n_tiles - 1) * plan.bn
    assert plan.k_slice % TILE_K[plan.route] == 0
    assert plan.splits * plan.k_slice >= k > (plan.splits - 1) * plan.k_slice
    assert plan.blocks == plan.tiles * plan.splits
    return plan


@pytest.mark.parametrize("layer", range(12))
def test_cnn_transition_gemms_keep_the_column_kernel(smoke, vgg, layer):
    shapes = smoke.transition_shapes(vgg, smoke.BUCKET)
    assert len(shapes) == 24
    for (m, k), (_, n), _ in shapes[2 * layer:2 * layer + 2]:
        plan = _covers_matmul(m, n, k)
        assert plan.kernel == "column" and plan.blocks >= NUM_SMS


@pytest.mark.parametrize("bucket", [1, 2, 4])
@pytest.mark.parametrize("gemm", range(4))
def test_lm_worker_gemms_take_the_split_kernel(smoke, lm, bucket, gemm):
    rounds = smoke.lm_round_shapes(lm, bucket)
    assert [r["kind"] for r in rounds] == ["qkv", "wo", "gateup", "down"]
    (m, k), (_, n) = rounds[gemm]["worker"]
    assert m == bucket
    plan = _covers_matmul(m, n, k)
    assert plan.kernel == "split" and plan.blocks >= NUM_SMS


# VGG-16 224x224 at bucket 8 on n = 8, (k_a, k_b) = (2, 4): per layer the
# worker GEMM (M, N, K) and the design's route, N-tile and K split.
VGG_PLANS = [
    ((401408, 32, 27), "ffma", 32, 1), ((401408, 32, 576), "tc", 32, 1),
    ((100352, 64, 576), "tc", 64, 1), ((100352, 64, 1152), "tc", 64, 1),
    ((25088, 128, 1152), "tc", 128, 2), ((25088, 128, 2304), "tc", 128, 2),
    ((25088, 128, 2304), "tc", 128, 2),
    ((6272, 256, 2304), "tc", 128, 1), ((6272, 256, 4608), "tc", 128, 1),
    ((6272, 256, 4608), "tc", 128, 1),
    ((1568, 256, 4608), "tc", 128, 4), ((1568, 256, 4608), "tc", 128, 4),
    ((1568, 256, 4608), "tc", 128, 4),
]


@pytest.mark.parametrize("layer", range(13))
def test_vgg_worker_gemm_plans(smoke, vgg, layer):
    shapes = smoke.worker_shapes(vgg, smoke.BUCKET)
    assert len(shapes) == len(VGG_PLANS)
    mnk, route, bn, splits = VGG_PLANS[layer]
    assert _gemm_mnk(*shapes[layer]) == mnk
    plan = _covers_worker(*mnk)
    assert (plan.route, plan.bn, plan.splits) == (route, bn, splits)
    if route == "tc":  # split only where the last wave would be under half
        slots = NUM_SMS * TC_BLOCKS_PER_SM[bn]
        assert 2 * ((plan.blocks - 1) % slots + 1) >= slots
        if splits > 1:
            assert 2 * ((plan.tiles - 1) % slots + 1) < slots


MATMUL_EDGES = [(1, 1, 64), (3, 7, 65), (4, 479, 577), (16, 290, 1000),
                (17, 288, 576), (4, 300, 8), (2, 5, 8193), (16, 33793, 576),
                (1, 1, 1), (8, 64, 1025), (5, 16, 4096), (16, 17, 63),
                (4, 1280, 9728), (16, 290, 20000), (1, 9728, 2560)]


@pytest.mark.parametrize("m,n,k", MATMUL_EDGES)
def test_matmul_plan_covers_every_shape(m, n, k):
    _covers_matmul(m, n, k)


# Qwen3-4B's coded worker GEMMs at batch 4: (K, N) of qkv, wo, gate-up and
# down; the down projection's K (9,728) is past 8 slices of one chunk
QWEN3_GEMMS = [(2560, 3072), (4096, 1280), (2560, 9728), (9728, 1280)]


@pytest.mark.parametrize("k,n", QWEN3_GEMMS)
def test_qwen3_worker_gemms_take_the_split_kernel(k, n):
    plan = _covers_matmul(4, n, k)
    assert plan.kernel == "split" and plan.blocks >= NUM_SMS


@pytest.mark.parametrize("m,n,k,splits,blocks", [(4, 1280, 9728, 8, 640),
                                                 (2, 5, 8193, 8, 8)])
def test_matmul_plan_splits_past_one_chunk(m, n, k, splits, blocks):
    """Past 8 chunks of K the split kernel still takes a small-M product
    the column grid would leave the card idle for, in 8 slices (the down
    projection: 80 strips of 8 slices of 1,216 rows; before, 5 column
    blocks)."""
    plan = _covers_matmul(m, n, k)
    assert plan.kernel == "split" and plan.k_slice > SPLIT_CHUNK
    assert (plan.splits, plan.blocks) == (splits, blocks)


WORKER_EDGES = [(1, 1, 1), (127, 33, 17), (129, 65, 27), (2000, 130, 4608),
                (72, 256, 576), (401408, 32, 27), (300, 129, 16384),
                (128, 64, 257), (1568, 512, 9), (5, 200, 1153)]


@pytest.mark.parametrize("m,n,k", WORKER_EDGES)
def test_worker_plan_covers_every_shape(m, n, k):
    _covers_worker(m, n, k)
    for route in ROUTES:
        _covers_worker(m, n, k, route)


def test_worker_plan_keeps_every_slice_deep():
    """On each route a split never leaves a K slice shallower than the
    design's minimum, and never splits where the card is already busy:
    on the FFMA route where the tiles fill the SMs, on the tensor-core
    route where the last wave of tiles fills half of the card's slots."""
    from repro_torch.kernels.conv2d.kernel import MIN_SPLIT_CHUNKS

    for route in ROUTES:
        least, tk = MIN_SPLIT_CHUNKS[route], TILE_K[route]
        for m in (72, 1568, 6272, 25088):
            for k in (27, 144, 576, 1152, 4608):
                plan = route_plan(route, m, 256, k)
                if route == "tc":
                    slots = NUM_SMS * TC_BLOCKS_PER_SM[plan.bn]
                    busy = 2 * ((plan.tiles - 1) % slots + 1) >= slots
                else:
                    busy = plan.tiles >= NUM_SMS
                if plan.splits > 1:
                    assert plan.k_slice >= least * tk
                    assert not busy
                elif not busy:
                    assert -(-k // tk) < 2 * least


def _covers_coded_gemm(r_out, r_in, f, aligned=True):
    plan = coded_gemm_plan(r_out, r_in, f, aligned)
    assert plan.vec in (1, 4) and plan.threads in THREAD_CHOICES
    if plan.vec == 4:
        assert aligned and f % 4 == 0
    span = plan.threads * plan.vec
    assert plan.blocks * span >= f > (plan.blocks - 1) * span
    return plan


@pytest.mark.parametrize("bucket", [1, 2, 4])
@pytest.mark.parametrize("gemm", range(4))
def test_lm_decode_spreads_over_one_warp_blocks(smoke, lm, bucket, gemm):
    """K3's survivor decode (4 x 4 code, F = bucket * d_out / 4) takes one
    column a thread in one-warp blocks: at bucket 4 that is 18-96 blocks."""
    (r_out, r_in), (_, f) = smoke.lm_round_shapes(lm, bucket)[gemm]["decode"]
    assert (r_out, r_in) == (4, 4) and f == bucket * (240, 144, 768, 144)[gemm]
    plan = _covers_coded_gemm(r_out, r_in, f)
    assert (plan.vec, plan.threads) == (1, 32)
    if bucket == 4:
        assert 18 <= plan.blocks <= 96


@pytest.mark.parametrize("gemm", range(4))
def test_lm_weight_encode_streams_float4_over_every_sm(smoke, lm, gemm):
    (r_out, r_in), (_, f) = smoke.lm_round_shapes(lm, 4)[gemm]["encode"]
    assert (r_out, r_in) == (8, 4)
    plan = _covers_coded_gemm(r_out, r_in, f)
    assert plan.vec == 4 and plan.blocks >= NUM_SMS


CODED_GEMM_EDGES = [(1, 1, 1, True), (4, 4, 7, True), (16, 16, 4099, True),
                    (4, 4, 4 * VEC4_MIN_COLUMNS, False),
                    (4, 4, 4 * VEC4_MIN_COLUMNS + 2, True),
                    (4, 4, 4 * VEC4_MIN_COLUMNS, True), (8, 8, 1 << 24, True),
                    (3, 5, 33, True), (2, 16, 4 * VEC4_MIN_COLUMNS - 4, True)]


@pytest.mark.parametrize("r_out,r_in,f,aligned", CODED_GEMM_EDGES)
def test_coded_gemm_plan_covers_every_width(r_out, r_in, f, aligned):
    """F = 1, ragged F, unaligned operands (one column a thread), the
    float4 threshold on both sides, and a width far past the card."""
    plan = _covers_coded_gemm(r_out, r_in, f, aligned)
    wide = aligned and f % 4 == 0 and f >= 4 * VEC4_MIN_COLUMNS
    assert plan.vec == (4 if wide else 1)
    assert plan.blocks < 2 ** 31


def _covers_flash(bh, sq, d, rep, bf16=False):
    plan = flash_plan(bh, sq, sq, d, rep, bf16)
    assert plan.route == ("tiled" if tiled_route(sq, 0, rep, bf16) else "rows")
    if plan.route == "tiled":
        tiles = plan.blocks // bh
        wide = d in WGMMA_HEAD_DIMS
        wgmma = wide and bh * sq >= WGMMA_MIN_ROWS  # causal: Sk not read
        tf32x3 = wide and bh * sq >= TF32X3_MIN_ROWS
        kernel = (("wgmma" if wgmma else "mma") if bf16 else
                  "tf32x3" if tf32x3 else "ffma")
        assert plan.kernel == kernel
        assert (plan.rows, plan.keys, plan.warps) == TILED_KERNELS[kernel]
        assert (plan.heads, plan.groups) == (1, rep)
        assert plan.blocks == bh * tiles <= MAX_TILED_BLOCKS
        assert tiles * plan.rows >= sq > (tiles - 1) * plan.rows
        return plan
    assert (plan.kernel, plan.keys) == ("rows", None)
    pairs = plan.heads * plan.rows
    assert 1 <= plan.heads <= rep and pairs <= max_pairs(d)
    assert plan.rows & (plan.rows - 1) == 0 and plan.rows <= 64
    assert plan.warps == min(MAX_WARPS, pairs)
    assert -(-pairs // plan.warps) <= PAIRS_A_WARP
    assert plan.groups * plan.heads >= rep > (plan.groups - 1) * plan.heads
    assert plan.blocks == (bh // rep) * plan.groups * -(-sq // plan.rows)
    return plan


@pytest.mark.parametrize("bucket", [1, 2, 4])
@pytest.mark.parametrize("sq", [2, 7, 16])
def test_lm_prefill_attention_plan(smoke, lm, bucket, sq):
    """The SmolLM-135M prefill (9 query heads over 3 KV heads, head_dim
    64): one block stages a KV head's keys for all 3 of its query heads;
    at bucket 4 and the longest prompt, 192 blocks and 576 warps."""
    cfg = lm.cfg
    rep = cfg.n_heads // cfg.n_kv_heads
    plan = _covers_flash(bucket * cfg.n_heads, sq, cfg.head_dim, rep)
    assert (plan.heads, plan.groups) == (rep, 1)
    if (bucket, sq) == (4, smoke.LM_MAX_PROMPT):
        assert plan.blocks == 192 >= NUM_SMS
        assert plan.blocks * plan.warps == 576


FLASH_EDGES = [(1, 1, 16, 1), (3, 1, 128, 3), (36, 256, 64, 1), (36, 256, 64, 3),
               (2, 384, 128, 1), (64, 200, 32, 64), (100, 5, 16, 100),
               (40, 33, 128, 40), (8, 70, 64, 4), (4, 1000, 16, 1),
               (64, 2048, 128, 4), (8, 2047, 128, 2), (64, 1500, 64, 1),
               (4, 31, 64, 1), (4, 32, 64, 1), (4, 47, 64, 1), (4, 48, 64, 1),
               (72, 127, 128, 4), (72, 128, 128, 4), (64, 143, 64, 1),
               (64, 144, 64, 1),
               (4, 1 << 24, 16, 1)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("bh,sq,d,rep", FLASH_EDGES)
def test_flash_plan_covers_every_shape(bh, sq, d, rep, bf16):
    """S = 1, D = 128 (16 pairs a block), long sequences, and rep past what
    one block serves (head groups); each side of the routes' threshold."""
    plan = _covers_flash(bh, sq, d, rep, bf16)
    if rep > max_pairs(d):
        assert plan.groups > 1


@pytest.mark.parametrize("bf16", [False, True])
def test_flash_plan_takes_the_tiled_route_for_long_prompts(bf16):
    """The Qwen3-4B prefill of 2 x 2,048 tokens (32 query heads over 8 KV
    heads, D 128): one block per (query head, 128 rows), 1,024 of 12 warps
    (two wgmma warpgroups and a loader), walking 128-key tiles in bf16 and
    64-key tiles of split K/V in fp32 (3xTF32), where the rows route
    served 16 (head, row) pairs a block; the prefill of 16 tokens stays on
    the rows route.  Whisper-medium's decoder cross-attention (16 queries
    over 1,500 frames) takes the tiled route too: the FFMA kernel's 64-row
    blocks at D 64 in fp32, the wgmma kernel in bf16."""
    plan = flash_plan(64, 2048, 2048, 128, 4, bf16)
    assert plan.route == "tiled"
    assert plan.blocks == 64 * 16
    assert (plan.kernel, plan.warps, plan.keys) == (("wgmma", 12, 128) if bf16
                                                    else ("tf32x3", 12, 64))
    assert flash_plan(128, 16, 16, 128, 4, bf16).route == "rows"
    cross = flash_plan(64, 16, 1500, 64, 1, bf16, causal=False)
    assert (cross.route, cross.kernel) == ("tiled", "wgmma" if bf16 else "ffma")
    assert flash_plan(64, 1500, 1500, 64, 1, bf16, causal=False).route == "tiled"


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_tiled_plan_kernels_by_head_dim(d):
    """Each type takes its wgmma kernel at D 64 and 128 from its row
    threshold over all heads (``WGMMA_MIN_ROWS`` bf16, ``TF32X3_MIN_ROWS``
    fp32; the route sweep's crossovers) and keeps the mma.sync (bf16) or
    FFMA (fp32) kernel below it and at D 16 and 32; the kept kernels can
    be named at any D, to time them beside the wgmma ones (``bh *
    ceil(sq / rows)`` blocks either way)."""
    for bf16, wgmma, kept in ((True, "wgmma", "mma"), (False, "tf32x3", "ffma")):
        plan = flash_plan(8, 2047, 2047, d, 2, bf16)
        assert plan.kernel == (wgmma if d >= 64 else kept)
        assert plan.blocks == 8 * -(-2047 // plan.rows)
        assert flash_plan(128, 64, 64, d, 4, bf16).kernel == kept  # 8,192 rows
        assert flash_plan(128, 96, 96, d, 4, bf16).kernel == (wgmma if d >= 64
                                                              else kept)
    mma = tiled_plan(8, 2047, d, 2, True, kernel="mma")
    assert (mma.rows, mma.keys, mma.warps, mma.blocks) == (64, 64, 4, 8 * 32)
    ffma = tiled_plan(8, 2047, d, 2, False, kernel="ffma")
    assert (ffma.rows, ffma.keys, ffma.warps, ffma.blocks) == (64, 64, 8, 8 * 32)


# (BH, Sq, Sk, D, rep, causal, bf16, route, kernel): the route sweep's
# cells on each side of the routes' crossovers, Whisper-medium's unmasked
# cross-attention among them; and causal shapes with Sk past the cross
# thresholds, whose plan reads the query rows alone
ROUTE_CELLS = [(100, 32, 32, 64, 5, True, False, "tiled", "ffma"),
               (100, 16, 16, 64, 5, True, False, "rows", "rows"),
               (128, 32, 32, 128, 4, True, False, "rows", "rows"),
               (64, 16, 512, 64, 1, False, False, "rows", "rows"),
               (64, 32, 512, 64, 1, False, False, "rows", "rows"),
               (64, 32, 1500, 64, 1, False, False, "tiled", "ffma"),
               (64, 16, 4096, 64, 1, False, False, "tiled", "ffma"),
               (64, 16, 256, 64, 1, False, True, "tiled", "wgmma"),
               (64, 32, 4096, 64, 1, False, True, "tiled", "wgmma"),
               (128, 64, 64, 128, 4, True, True, "tiled", "mma"),
               (64, 16, 16, 64, 1, True, True, "rows", "rows"),
               (8, 1024, 1024, 128, 4, True, False, "tiled", "ffma"),
               (32, 256, 256, 64, 1, True, True, "tiled", "mma")]


@pytest.mark.parametrize("bh,sq,sk,d,rep,causal,bf16,route,kernel", ROUTE_CELLS)
def test_flash_plan_reads_sk_and_rep(bh, sq, sk, d, rep, causal, bf16, route,
                                     kernel):
    """The route and kernel ``flash_plan`` takes where the sweep crossed:
    many (head, row) pairs a KV head or many unmasked keys leave the rows
    route; a causal call's plan does not read Sk."""
    plan = flash_plan(bh, sq, sk, d, rep, bf16, causal)
    assert (plan.route, plan.kernel) == (route, kernel)


def test_flash_plan_grid_limit():
    """One row of blocks per (KV head, head group): past 65,535 of them
    the wrapper refuses the launch (grid.y)."""
    plan = flash_plan(65535, 4, 4, 64, 1)
    assert plan.blocks == 65535 * -(-4 // plan.rows)
    plan = flash_plan(2 * 65535, 4, 4, 16, 2)
    assert (2 * 65535 // 2) * plan.groups <= MAX_GRID_Y
    plan = flash_plan(65536, 4, 4, 64, 1)
    assert 65536 * plan.groups > MAX_GRID_Y
