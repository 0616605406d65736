#!/usr/bin/env python3
"""Proof that the PyTorch/CUDA port builds, runs and serves on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and the CUDA toolkit, and fails (exit code != 0,
no result line) without them or outside a checkout of the repository.
Phases, in order; any failure raises:

 1. print the card's name and power limit (``nvidia-smi``);
 2. build the hand-written kernels from ``src/repro_torch/kernels/csrc``;
 3. training: SmolLM-135M at full width and depth (30 layers, d_model
    576, vocab 49,152, fp32, TF32 off) trained through ``train`` (the
    entry point of ``python -m repro_torch.launch.train``) for 30 steps of
    8 x 256 synthetic tokens, checkpointing every 15 steps.  Step 1's loss
    and gradients (the train step's own ``value_and_grad``) held against a
    plain float64 recompute on the card (``lm_loss_fp64``, written apart
    from the port's model code): the loss within 1e-5 relative, every
    leaf's gradient within 1e-4 of its max|g|, finite and non-zero in
    every layer; ``train``'s first loss equal to the checked one; the mean
    of the last 5 losses below the first 5's.  Restart: the checkpoints
    after step 15 are removed and a fresh ``train`` call restores step 15
    and runs the last 15 steps, each loss within 1e-5 of the
    uninterrupted run's.  One step with ``microbatches=2`` from the step-15
    checkpoint against the full batch, within the reference's tolerances;
    K4 called under autograd on the card raises.  The path launches none
    of K1-K4 (the reference trains through plain ``jnp`` attention; K4 has
    no backward); its launch counts are read around the run and K4's must
    be 0.  ``train`` replays each step from one captured CUDA graph (the
    loss, its gradient, the schedule and AdamW in place: the reference's
    ``jax.jit`` of the step), and the restart runs captured too; then the
    same 30 steps eagerly (``graphs=False``) from the same seed, the
    losses of steps 1-30 within 1e-5 relative of the captured run's and
    the final params within 1e-5 of each leaf's max|p|.  Three more steps
    under ``torch.profiler``, captured and eager, give the device busy
    time a step, the idle share and the kernels that take it;
 4. kernel phase: each kernel at every shape the serving phase launches
    (VGG-16 at 224x224, bucket 8), held against its plain PyTorch version
    on the same inputs and against a second launch of itself (same bits),
    timed beside its plain version, a library call and its bound, with
    the launch plan (tile, split) K1 and K2 took at each shape;
 5. serving phase: ``CodedServer`` serving 16 VGG-16 224x224 requests on
    n=8 coded workers (2 stragglers at +50 ms, 1 dead worker, fused
    transitions, pipeline depth 2), every result held against the uncoded
    stack; the kernels' launch counts are read around this phase only;
 6. LM kernel phase: SmolLM-135M at full width and depth (random weights
    from the seed) compiled into a ``CodedDecoderPipeline`` on n=4 workers
    (k_a=1, k_b=4: delta=2, gamma=2); K2 at the worker GEMM shapes, K3 at
    every decode shape of bucket 4 and every build-time encode shape (the
    code matrix on the host, as the path passes it), K4 at the bucket-4
    prefill in fp32 and, beside it, in bf16 (the TPU kernel's other
    operand type; the served path is fp32), each held against its plain
    version and a second launch of itself, and timed beside a library call
    and its bound, with the launch plan it took;
 7. LM serving phase: ``CodedLMServer`` serving 8 requests (prompts of
    2-16 tokens, 8-16 new tokens, drawn from the seed) under one straggler
    (+50 ms) and one dead worker; the K2, K3 and K4 launch counts are read
    around this phase only.  Each admission's prefill replays the
    pipeline's prefill graph of its bucket (K4 inside, counted once a
    replay), captured in ``warmup`` with every other master graph: at most
    one a bucket, none while serving;
 8. LM correctness: the logits rows the server chose each token from
    (recorded through ``on_logits`` while it served) held against the
    undistributed ``transformer.prefill`` + ``decode_step``, teacher-forced
    on each served stream: within 1e-4 relative to max|logit|, and each
    served token an argmax of the undistributed logits up to that
    tolerance;
 9. the device worker pool, the cluster's layer entry points, the HTTP
    front-end and ``CodedLinear``: the CNN server of phase 5 rebuilt on
    ``pool="device"`` (stragglers as delayed dispatch) serving the same 16
    requests, held against the uncoded stack and printed beside the thread
    pool's rates and round phases; one forced-survivor batch through
    ``FcdccCluster.run_pipeline`` on each pool, bit-identical; the HTTP
    front-end over the device-pool server (models, one single and one
    batched infer, stats, drain), held against the uncoded stack;
    ``run_layer_elastic`` on one VGG-16 layer with more than gamma workers
    dead, and ``run_layer`` on preloaded filters, against the uncoded conv;
    the LM requests of phase 7 on the device pool, every token equal to
    the thread pool's and the logits held as in phase 8, round phases of
    both pools side by side (``scripts/torch_pool_rounds.py`` takes them
    apart further, in turns);
    ``CodedLinear`` at SmolLM's up-projection widths for every survivor
    subset against ``torch.matmul``.  Each phase reads the launch counts
    around itself only;
10. compiled programs: every served phase above runs the master's
    programs as CUDA graphs (``repro_torch.core.graphs``; captured in the
    servers' warmups, replayed while serving: the encoder, transitions,
    decoder and LM glue, on both pools); the workers' rounds run eagerly,
    the pipelines' default.  Each phase prints its captures against their
    bounds (``master_graph_bound`` / ``glue_graph_bound``), its replays by
    program kind (each > 0), capture seconds and the graph pools' bytes.
    Then eager against replayed: the forced-survivor VGG-16 batch on each
    pool with ``graphs=False`` and with graphs, and on the device pool with
    worker graphs too (``set_graphs(True, workers=True)``: each worker's
    round replayed, graphs a worker within ``worker_graph_bound``), all
    five ``torch.equal``; the LM requests on the device pool with
    ``graphs=False`` and with worker graphs, every token equal to the
    default run's and the logits held as in phase 8; the captured prefill
    against the eager one on the device pool: each request's first
    logits row ``torch.equal``, its first token equal, K4 launched as
    often, ``prefill_time_s`` printed both ways with warmup's capture
    seconds apart;
11. the analysis gate's card half (``repro_torch.analysis.contracts``)
    over every program cell of the two served configurations at full
    width (VGG-16 224, n=8, (2, 4), fused, buckets 1-8; SmolLM-135M on
    exp13's plan, buckets 1-4): each cell run once under the dispatch
    recorder (no float64 on the card, no host sync, no constant in place of
    a coding-matrix argument, float32 outputs), captured into a CUDA graph
    after a warm-up call, its static inputs refilled with a second
    argument set (for decode and transition cells the operand of another
    survivor subset), replayed and held ``torch.equal`` to an eager call on
    that set; the eager-only cells (the LM decoder: K3 takes the survivor
    inverse by value) listed with their reason; any contract error fails
    the script;
12. the six examples (``python -m repro_torch.examples.<name>``) run
    in-process on the card at their defaults, each with its own check
    (``quickstart`` and ``coded_lm_layer`` against the plain conv and the
    uncoded FFN, ``coded_cnn_inference`` and ``coded_serving`` within
    1e-4 of max|uncoded| of the uncoded stack, ``serve_decode``'s token
    ids, ``train_smollm``'s losses finite and falling), one line each
    with its seconds, its check's number and its launches (joining
    ``launches_by_path``); then the sharding specs, shapes only:
    ``count_params`` of all ten arch ids at full config (DeepSeek-V3
    included) and the leaves that shard over ``model`` on (16, 16) and
    over the data axes with FSDP on (2, 16, 16);
13. the arch zoo, after the earlier phases' servers, graphs and weights
    are released, one arch at a time: each drawn on the card from a seeded
    CUDA generator (fp32, TF32 off) at full width, through ``serve_lm``
    (the serve CLI's LM entry point; 4 prompts of 16 tokens, 16 new
    tokens) twice from the same weights: captured (its decode step and,
    for the transformer family, its prefill each one CUDA graph, the
    reference's ``jax.jit`` of both; at most 2 captures) and eagerly,
    the tokens equal and every prefill and decode call's logits
    ``torch.equal``, or the largest difference printed and the phase
    failed; the launch counts read around each run, K4's launches eagerly
    equal to the layers whose prefill route is K4 and, captured, twice
    that (the warm-up's and the graph's, held and counted once a replay);
    printed with init seconds, prefill seconds, decode tok/s both ways,
    capture seconds and peak memory beside the reckoned parameter count;
    the decode's ms a step eager and replayed, each beside its device busy
    ms under ``torch.profiler``; then ``prefill_cache_fn`` against
    ``prefill_fn`` and ``decode_fn`` teacher-forced over the prompt against
    it.  DeepSeek-V2-236B (1 dense-first + 2 MoE layers, 37 GB): the
    first MoE layer's gather dispatch on its real activations against
    ``moe_ffn_plain`` and against a float64 loop over 16 sampled tokens
    (the expert choices equal), no entry dropped.  Qwen3-4B at full width
    and depth: then served coded on the device pool on phase 7's plan and
    requests, held as phase 8 holds SmolLM's, with K2-K4 at its shapes
    against their plain versions, timed.  CodeQwen1.5-7B, Gemma2-9B (one
    local, one global layer) and PaliGemma-3B (its ``prefill_fn`` also
    over a 256 x 2048 stub prefix) at 2 layers.  RWKV6-1.6B, Hymba-1.5B
    and Whisper-medium at full width and depth: ``serve_lm`` steps
    ``decode_fn`` over their prompts (no cache-filling prefill, as in the
    reference), so K4's launches are also read around one ``prefill_fn``
    over the same prompts (Whisper's with 4 x 1500 random frames) and
    equal the layers whose route is K4 (RWKV6 0, Hymba 32, Whisper's
    decoder 24); RWKV6's and Hymba's ``decode_fn`` stepped over 141 tokens
    against ``prefill_fn`` (two chunk carries and a padded tail): RWKV6 at
    full depth in float64, and in fp32 on a cut of 2 layers and layer by
    layer at full depth, Hymba at full
    depth with its window cut to 4, from position 96 on (its decode, as
    the reference's, attends over the ring's unwritten slots as zero
    keys before); Whisper's ``decode_fn`` teacher-forced from the cross
    K/V that ``precompute_cross_kv(encode(frames))`` filled against
    ``prefill_fn``; each within 1e-4 of max|logit|.  Last, SmolLM-135M
    at full width and depth, K4 in its captured prefill (at the LM kernel
    phase's shape).  K4 at Qwen3's, CodeQwen's, Hymba's (rep 5) and
    Whisper's decoder's prefill shapes against its plain version, timed.
    Each arch's drawn params held against its schema with no new
    allocation: ``count_params`` equal to their numel, ``param_shapes``
    equal to their shapes and dtypes leaf for leaf;
14. one JSON line with the training numbers (ms a step and tokens/s, the
    median over steps 5-30, captured and eager, peak device memory, the
    model FLOPs a step and their share of the fp32 peak, the card's name
    and power limit),
    one JSON line with the arch zoo's readings, one JSON line with the
    compiled programs' counts by phase (the zoo's ``serve_lm`` graphs
    and the coded LM prefill's among them), one JSON line with the
    examples' and the specs' readings, one JSON
    line with the kernels' numbers (K1-K4; K2's top-level numbers
    are its CNN pass, its LM numbers sit under ``paths.lm``; each kernel's
    ``launches`` is its count on the phase-5 or phase-7 main path, and
    ``launches_by_path`` its count in every phase that ran it, training's
    0 and the zoo's among them; K2-K4 carry their zoo shapes under
    ``zoo``; a replayed
    graph launches no wrapper, so its launches count as the kernels the
    graph holds, once per replay), then the result line.

TF32 is off for every product here (the CRME decode multiplies rounding
error by the recovery matrix's condition number).

Two times per call.  ``ms`` is CUDA events around 10 back-to-back calls:
where the host issues a call (``ctypes``, the allocator, the launch) more
slowly than the card runs it, that is the host's rate.  ``device_ms``
holds the stream with ``torch.cuda._sleep`` while the host issues the
same calls, so its events bracket device execution only;
``library_device_ms`` times the library yardstick the same way, and
``profiler_device_ms`` sums ``torch.profiler``'s kernel records as a
cross-check.  Inputs stay in the 50 MB L2 across the 10 calls where they
fit.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, and HBM3 bandwidth.  The bound of a kernel is the larger of its
# operations over the first and its bytes over the second.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

ARCH, HW, N_WORKERS, KAB, BUCKET = "vgg16", 224, 8, (2, 4), 8
N_REQUESTS, STRAGGLER_DELAY_S, SEED = 16, 0.05, 0
# K1 sums up to C*KH*KW = 4608 fp32 products, K2 at most Q = 8; a plain
# version may sum in another order.  Both are held to a bound on
# max|kernel - plain| relative to max|plain|, far above fp32 rounding at
# those depths and far below any indexing or masking fault.
TOL_K1, TOL_K2 = 1e-4, 1e-5
# Served outputs against the uncoded stack, relative to max|uncoded|: the
# reference's own tests use 1e-4 for two small layers.  At 224 the 13
# layers of fp32 sums (K up to 4608), each decode multiplying rounding
# error by the recovery matrix's condition number, were measured at about
# 1e-5 on an H100, so the reference's 1e-4 holds here too.
TOL_SERVE = 1e-4

# The LM path: exp13's plan (n=4, k_a=1, k_b=4) on SmolLM-135M.
LM_N, LM_KB, LM_BUCKETS, LM_MAX_LEN, LM_MAX_PROMPT = 4, 4, (1, 2, 4), 64, 16
LM_REQUESTS, LM_PROMPT_LEN, LM_GEN = 8, (2, 16), (8, 16)
# worker 2 straggles at +50 ms, worker 3 is dead: both within gamma = 2
LM_DELAYS = (0.0, 0.0, STRAGGLER_DELAY_S, float("inf"))
# K3 sums R_in <= 4 products in order; K4 sums 64-term dot products and an
# online softmax over <= 16 keys (expf against the library's exp).  Both
# relative to max|plain|.  K4 in bf16 rounds p and its output to bf16, as
# its plain version does; an fp32 sum in another order may flip either
# rounding, so it is held to one bf16 rounding of the output (2^-7 of
# max|plain|).  Where one 32-key chunk holds every key (S <= 32, the
# prefill), the kernel rounds p exactly where the plain version does, so
# the two outputs are also bit-equal in all but K4_BF16_MISMATCH of their
# elements: an fp32 score summed in another order flips p's rounding in
# fewer, while a kernel that skipped rounding p (within 2^-7 all the same)
# changes about a quarter of them (both held on random data by
# tests/test_torch_lm_kernels.py).
TOL_K3, TOL_K4, TOL_K4_BF16 = 1e-5, 2e-5, 2.0 ** -7
K4_ONE_CHUNK, K4_BF16_MISMATCH = 32, 1e-3
# served (coded, cluster) logits against the undistributed transformer's, relative
# to max|logit|: the reference's own coded-decoder tolerance is 3e-4 abs
# at smoke size; 30 layers of fp32 sums through a decode whose recovery
# matrix has a condition number of a few stay far inside 1e-4
TOL_LM = 1e-4
# This slice's phases.  The forced-survivor batch delays every worker but
# the first delta by FORCED_DELAY_S, far beyond a VGG-16 round, so both
# pools decode from the same subset.  The HTTP phase posts one image, then
# HTTP_BATCH in one batched request.  The elastic phase runs ELASTIC_LAYER
# at its input size in the 224 stack.  CodedLinear sums 576 fp32 products
# through one decode, held like the served outputs, relative to max|Y|.
FORCED_DELAY_S, HTTP_BATCH = 0.2, 4
ELASTIC_LAYER, ELASTIC_HW = "conv2_1", 112
TOL_LINEAR = 1e-4
# The training phase: SmolLM-135M at full width and depth, fp32, through
# python -m repro_torch.launch.train's train().  Step 1 against a plain
# float64 recompute: fp32 sums over 576-1536 products and 2,048 tokens
# stay near 1e-6 of a leaf's max|g|, far inside 1e-4; a gradient cut
# through attention reads 0, far outside it.  The restart against the
# uninterrupted run: the embedding's CUDA backward adds atomically, so
# the two differ in the last bits of a gradient; 15 Adam steps keep that
# near 1e-7 of the loss.  Microbatches against the full batch: two fp32
# sums of the same products, so the accumulated gradient, the moments and
# the params stay near 1e-6 of each leaf's max, inside 1e-4; a step that
# dropped a slice reads near 1 (the check reads that planted fault too).
TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_CKPT = \
    "smollm-135m", 30, 8, 256, 15
TOL_TRAIN_LOSS, TOL_TRAIN_GRAD, TOL_TRAIN_RESTART = 1e-5, 1e-4, 1e-5
TOL_MICRO = 1e-4
# The captured train step against the eager one, 30 steps from one seed:
# the graph replays the eager step's kernels, so only the embedding's
# atomic backward sums in another order, as between the restart and the
# uninterrupted run; the losses within 1e-5 relative, the final params
# within 1e-5 of each leaf's max|p|.
TOL_TRAIN_GRAPH = 1e-5
# The arch zoo: (arch, layers on the card, None = full depth), each at full
# width through serve_lm: ZOO_BATCH prompts of ZOO_PROMPT tokens and
# ZOO_GEN new ones; PaliGemma's prefill_fn also over ZOO_PREFIX stub patch
# embeddings.  DeepSeek-V2 keeps its dense-first layer and two MoE layers
# (37 GB of fp32 weights); DeepSeek-V3's least depth with an MoE layer is
# 3 dense + 1 MoE, about 60 GB in fp32, and is held on the CPU only.  The
# recurrent and encoder-decoder families run at full width and depth:
# RWKV6-1.6B (5.8 GB of fp32 weights), Hymba-1.5B (6.4 GB) and
# Whisper-medium (3.2 GB).
ZOO = (("deepseek-v2-236b", 3), ("qwen3-4b", None), ("codeqwen1.5-7b", 2),
       ("gemma2-9b", 2), ("paligemma-3b", 2), ("rwkv6-1.6b", None),
       ("hymba-1.5b", None), ("whisper-medium", None), ("smollm-135m", None))
ZOO_BATCH, ZOO_PROMPT, ZOO_GEN, ZOO_PREFIX = 4, 16, 16, 256
# RWKV6's and Hymba's decode_fn stepped over ZOO_SCAN tokens against their
# prefill_fn: 2 x 64 + 13 crosses two chunk carries of the scan and a
# padded tail (16 tokens would stay inside one chunk)
ZOO_SCAN = 141
# prefill_cache_fn against prefill_fn: the same products but for masked
# keys that add exact zeros (K4's routes are the same launch on the same
# keys), relative to max|logit|; decode_fn teacher-forced against
# prefill_fn sums attention another way (plain against K4, one query at a
# time) through up to 36 layers, held as the served LM is (TOL_LM).  The
# recurrent families' decode_fn sums the scan one step at a time against
# the chunked pairs and carries (the same fp32 products in another order,
# through 24 or 32 layers), and Whisper's decode_fn runs attention plain
# against K4: both held to the same TOL_ZOO_DECODE.  The
# MoE's gather dispatch against its float-scatter plain version: the same
# fp32 products summed in another order (within 1e-5 of max|y|); against a
# float64 loop token by token, fp32 sums over 5120 and 1536 products stay
# near 1e-6 of max|y|, inside 1e-4, where a wrong expert or gate weight
# reads near 1.
TOL_ZOO_CACHE, TOL_ZOO_DECODE = 1e-5, 1e-4
# RWKV6's random-weight stack amplifies rounding layer after layer: how
# far a relative perturbation of ZOO_PERTURB in the embedding moves
# prefill_fn's logits (chip_smoke.py prints it) grows from near 1e-5 of
# max|logit| at 1 layer to near 1e-1 at 24, so no two fp32 evaluations of
# the full stack can be held within TOL_ZOO_DECODE.  Its decode_fn is held
# end to end at full width and depth in float64 (rwkv_float64_witness,
# where rounding sits near 1e-16), and in fp32 on a cut of ZOO_RWKV_CUT =
# 2 layers, the least depth at which one layer's state write can be told
# from another's, where that reading stays under TOL_ZOO_DECODE / 2 on the
# H100 (printed beside the check); at full depth each fp32 layer is held
# teacher-forced, stepped against chunked, its update (output less input)
# and final scan state within TOL_ZOO_DECODE of their max (the same fp32
# products in another order within one layer).
ZOO_PERTURB, ZOO_RWKV_CUT = 1e-6, 2
# Hymba's decode_fn attends over its ring's unwritten slots as zero keys,
# as the reference's does, and those steps' outputs feed the next layer's
# keys: it agrees with prefill_fn only from step layers x (window - 1) on,
# 32,736 at the window of 1024.  Its check runs Hymba at full width and
# depth with the window cut to ZOO_HYMBA_WINDOW and holds the positions
# from ZOO_HYMBA_FROM = 32 x 3 on (crossing the scan's carry at 128 and
# its padded tail), where the SSM states' memory of the earlier steps has
# had 96 steps to decay; the earlier positions' gap is printed, not held.
ZOO_HYMBA_WINDOW, ZOO_HYMBA_FROM = 4, 96
TOL_MOE_PLAIN, TOL_MOE_FP64, MOE_SAMPLED = 1e-5, 1e-4, 16


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Mean time of ``fn`` over ``reps`` back-to-back calls, host issue
    included: CUDA events around the run, after ``warm`` untimed calls.
    Where the host issues a call more slowly than the card runs it, this
    is the host's rate (``ms`` in the kernels line)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


_SLEEP_CYCLES_PER_MS: list[float] = []


def _sleep_cycles_per_ms() -> float:
    """``torch.cuda._sleep`` cycles per ms of device time, measured once."""
    if not _SLEEP_CYCLES_PER_MS:
        cycles = 20_000_000
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        _SLEEP_CYCLES_PER_MS.append(cycles / start.elapsed_time(end))
    return _SLEEP_CYCLES_PER_MS[0]


def device_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, host
    issue excluded: a ``torch.cuda._sleep`` holds the stream while the host
    issues the start event, the calls and the end event, so the events
    bracket device execution only.  The hold is sized from a timed run of
    the same calls and checked: the start event must still be pending when
    the host has issued everything.  Raises if no hold covers the issue."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    hold_ms = 2.0 * (time.perf_counter() - t0) * 1e3 + 1.0
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(hold_ms * _sleep_cycles_per_ms()))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not start.query()
        end.synchronize()
        if held:
            return start.elapsed_time(end) / reps
        hold_ms *= 4.0
    raise RuntimeError("device_ms: the stream hold never outlasted the host's "
                       "issue of the timed calls")


def profiler_device_ms(fn, reps: int = 10) -> float | None:
    """Mean device time of ``fn`` by ``torch.profiler``'s kernel records
    (the sum of their self device time over ``reps`` calls): a cross-check
    of ``device_ms`` by another clock.  None when the profiler recorded no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        total_us += float(t if t is not None else ev.self_cuda_time_total)
    return total_us / 1e3 / reps if total_us > 0 else None


def timings(fn, plain, library) -> dict:
    """``ms`` / ``device_ms`` (and the profiler's ``profiler_device_ms``)
    of the kernel call ``fn``, ``plain_ms`` of its plain version and
    ``library_ms`` / ``library_device_ms`` of the library yardstick (None
    where there is none)."""
    out = {"ms": cuda_ms(fn), "device_ms": device_ms(fn),
           "profiler_device_ms": profiler_device_ms(fn),
           "plain_ms": cuda_ms(plain), "library_ms": None,
           "library_device_ms": None}
    if library is not None:
        out["library_ms"] = cuda_ms(library)
        out["library_device_ms"] = device_ms(library)
    return out


def check_repeatable(name: str, fn, got: torch.Tensor) -> None:
    """A second launch on the same inputs gives the same bits."""
    if not torch.equal(fn(), got):
        raise AssertionError(f"{name}: two launches on the same inputs differ")


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def worker_shapes(pipe, bucket: int) -> list[tuple[tuple, tuple, int]]:
    """K1's ``(xe, ke, stride)`` per layer: one worker's coded shares and
    coded filter groups at ``bucket``."""
    out = []
    for spec in pipe.specs:
        g, p = spec.geo, spec.plan
        out.append(((p.ell_a, bucket, g.in_channels, g.h_hat, g.padded_w),
                    (p.ell_b, g.out_c_block, g.in_channels, g.kernel_h,
                     g.kernel_w), g.stride))
    return out


def transition_shapes(pipe, bucket: int) -> list[tuple[tuple, tuple, bool]]:
    """K2's ``(a, b, relu)`` per fused transition of the cluster path: the
    decode GEMM and the all-n re-encode GEMM."""
    out = []
    for spec, nxt in zip(pipe.specs, pipe.specs[1:]):
        g, p, g2 = spec.geo, spec.plan, nxt.geo
        q = p.k_a * p.k_b
        f = bucket * g.out_c_block * g.out_h_block * g.out_w
        out.append(((q, q), (q, f), True))
        width = nxt.plan.ell_a * pipe.n
        f2 = bucket * g2.in_channels * g2.h_hat * g2.padded_w
        out.append(((width, nxt.plan.k_a), (nxt.plan.k_a, f2), False))
    return out


def _err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    abs_err = float((got - ref).abs().max())
    return abs_err, abs_err / max(float(ref.abs().max()), 1e-30)


def _summarise(entries: list[dict]) -> dict:
    """Totals over one pass of the path (each shape times the layers that
    launch it), worst errors over all shapes."""
    tot = {k: sum(e[k] * e["count"] for e in entries)
           for k in ("ms", "device_ms", "plain_ms", "bound_ms")}
    ops = sum(e["bound_ms"] * e["count"] for e in entries
              if e["bound_by"] == "operations")

    def opt_sum(key):
        vals = [e.get(key) for e in entries]
        return (None if any(v is None for v in vals)
                else sum(v * e["count"] for v, e in zip(vals, entries)))

    return {
        **tot,
        "kernel_ms": tot["ms"],
        "profiler_device_ms": opt_sum("profiler_device_ms"),
        "library_ms": opt_sum("library_ms"),
        "library_device_ms": opt_sum("library_device_ms"),
        "bound_by": "operations" if ops >= tot["bound_ms"] / 2 else "bytes",
        "max_abs_err": max(e["max_abs_err"] for e in entries),
        "max_rel_err": max(e["max_rel_err"] for e in entries),
        "library_rel_err": max(e["library_rel_err"] for e in entries),
    }


def kernel_phase(pipe, bucket: int, device, timed: bool = True) -> list[dict]:
    """Each kernel at each of its serving shapes against its plain version
    (and, timed, beside one library call that computes the same
    function).  Raises when a kernel disagrees beyond its tolerance."""
    from repro_torch.kernels.conv2d.kernel import (coded_worker,
                                                   coded_worker_plain,
                                                   worker_plan)
    from repro_torch.kernels.matmul.kernel import matmul, matmul_plain, matmul_plan

    gen = torch.Generator(device=device).manual_seed(SEED)
    k1, k2 = [], []
    seen: dict = {}
    for xs, ks, stride in worker_shapes(pipe, bucket):
        if (xs, ks, stride) in seen:
            seen[(xs, ks, stride)]["count"] += 1
            continue
        xe = torch.randn(xs, generator=gen, device=device)
        ke = torch.randn(ks, generator=gen, device=device) / np.sqrt(np.prod(ks[2:]))
        def run():
            return coded_worker(xe, ke, stride)

        got, ref = run(), coded_worker_plain(xe, ke, stride)
        abs_err, rel_err = _err(got, ref)
        if not rel_err <= TOL_K1:
            raise AssertionError(f"K1 {xs} x {ks}: rel err {rel_err} > {TOL_K1}")
        check_repeatable(f"K1 {xs} x {ks}", run, got)
        ea, b, c, hh, wp = xs
        eb, nb, _, kh, kw = ks
        m = ea * b * got.shape[-2] * got.shape[-1]
        kk, n = c * kh * kw, eb * nb
        bnd, by = bound_ms(2.0 * m * n * kk, 4.0 * (xe.numel() + ke.numel() + got.numel()))
        e = {"xe": list(xs), "ke": list(ks), "stride": stride, "count": 1,
             "gemm_mnk": [m, n, kk], "plan": worker_plan(m, n, kk)._asdict(),
             "max_abs_err": abs_err, "max_rel_err": rel_err, "bound_ms": bnd,
             "bound_by": by, "ms": None, "device_ms": None, "plain_ms": None,
             "library_ms": None, "library_device_ms": None}
        if timed:
            xin = xe.reshape(ea * b, c, hh, wp)
            wcat = ke.reshape(eb * nb, c, kh, kw)
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                e.update(timings(run, lambda: coded_worker_plain(xe, ke, stride),
                                 lambda: F.conv2d(xin, wcat, stride=stride)))
                lib = F.conv2d(xin, wcat, stride=stride)
            # the library call sums in its own order: a second, independent
            # check of the kernel (same layout after the reference permute)
            lib = lib.reshape(ea, b, eb, nb, *lib.shape[-2:]).transpose(1, 2)
            e["library_rel_err"] = _err(got, lib.reshape(got.shape))[1]
        seen[(xs, ks, stride)] = e
        k1.append(e)
        del xe, ke, got, ref
    seen = {}
    for a_s, b_s, relu in transition_shapes(pipe, bucket):
        if (a_s, b_s, relu) in seen:
            seen[(a_s, b_s, relu)]["count"] += 1
            continue
        a = torch.randn(a_s, generator=gen, device=device)
        b = torch.randn(b_s, generator=gen, device=device)
        def run():
            return matmul(a, b, relu=relu)

        got, ref = run(), matmul_plain(a, b, relu=relu)
        abs_err, rel_err = _err(got, ref)
        if not rel_err <= TOL_K2:
            raise AssertionError(f"K2 {a_s} x {b_s}: rel err {rel_err} > {TOL_K2}")
        check_repeatable(f"K2 {a_s} x {b_s}", run, got)
        (m, kk), n = a_s, b_s[1]
        bnd, by = bound_ms(2.0 * m * n * kk, 4.0 * (m * kk + kk * n + m * n))
        e = {"a": list(a_s), "b": list(b_s), "relu": relu, "count": 1,
             "plan": matmul_plan(m, n, kk)._asdict(),
             "max_abs_err": abs_err, "max_rel_err": rel_err,
             "bound_ms": bnd, "bound_by": by, "ms": None, "device_ms": None,
             "plain_ms": None, "library_ms": None, "library_device_ms": None}
        if timed:
            e.update(timings(run, lambda: matmul_plain(a, b, relu=relu),
                             lambda: torch.matmul(a, b)))
            lib = torch.matmul(a, b)
            e["library_rel_err"] = _err(got, lib.clamp_min(0) if relu else lib)[1]
        seen[(a_s, b_s, relu)] = e
        k2.append(e)
        del a, b, got, ref
    return [
        {"name": "coded_worker", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/coded_worker.cu",
         "replaces": "src/repro/kernels/conv2d/kernel.py:291",
         "tpu_kernel": "coded_worker_pallas / _fused_worker_gemm "
                       "(src/repro/kernels/conv2d/kernel.py:190)",
         "tol": TOL_K1, "library": "F.conv2d (cuDNN, TF32 off)",
         "shapes": k1, **(_summarise(k1) if timed else {})},
        {"name": "matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/matmul.cu",
         "replaces": "src/repro/kernels/matmul/kernel.py:111",
         "tpu_kernel": "matmul_pallas (src/repro/kernels/matmul/kernel.py:111)",
         "tol": TOL_K2, "library": "torch.matmul (no ReLU)",
         "shapes": k2, **(_summarise(k2) if timed else {})},
    ]


def check_launched_shapes(pipe, bucket: int) -> None:
    """The shapes the kernel phase timed are the ones the serving phase
    ran: every K1 shape appears among the cluster worker program's
    argument signatures, every decode GEMM among the transitions'."""
    seen_k1 = {sig for prog in pipe._cluster_programs.values()
               for sig in prog.signatures}
    for xs, ks, _ in worker_shapes(pipe, bucket):
        if ((xs, "torch.float32"), (ks, "torch.float32")) not in seen_k1:
            raise AssertionError(f"K1 shape {xs} x {ks} never served")
    seen_dec = {(sig[0][0][0] * sig[0][0][1], int(np.prod(sig[0][0][2:])))
                for prog in pipe._transitions.values() for sig in prog.signatures}
    for (q, _), (_, f), relu in transition_shapes(pipe, bucket):
        if relu and (q, f) not in seen_dec:
            raise AssertionError(f"decode GEMM {q}x{f} never served")


def graph_report(pipe, cluster, master_bound: int, kinds) -> dict:
    """The compiled programs of one served phase, read before its server
    shuts down (the device pool drops its workers' graphs then): the
    master's and the workers' graphs against their bounds, replays by
    program kind, capture seconds and pool bytes.  Raises when a bound is
    broken or a kind of program in ``kinds`` (with ``worker`` where the
    pipeline replays its worker rounds on the device pool) was never
    replayed."""
    from repro_torch.core.graphs import merge_stats

    impl = cluster._pool_impl()
    workers = impl.graph_sets() if impl.kind == "device" else []
    per_worker = impl.graph_counts() if impl.kind == "device" else []
    master = merge_stats([pipe.master_graphs])
    wstats = merge_stats(workers)
    rep = {"pool": impl.kind, "master_graphs": master["graphs"],
           "master_bound": master_bound, "worker_graphs": per_worker,
           "worker_bound": pipe.worker_graph_bound,
           "master_replays": master["replays"],
           "worker_replays": wstats["replays"],
           "capture_s": master["capture_s"] + wstats["capture_s"],
           "static_bytes": master["static_bytes"] + wstats["static_bytes"],
           "pool_bytes": (None if None in (master["pool_bytes"], wstats["pool_bytes"])
                          else master["pool_bytes"] + wstats["pool_bytes"])}
    if not 0 < master["graphs"] <= master_bound:
        raise AssertionError(f"master graphs {master['graphs']} outside "
                             f"(0, {master_bound}]")
    if per_worker and not max(per_worker) <= pipe.worker_graph_bound:
        raise AssertionError(f"worker graphs {per_worker} over the bound "
                             f"{pipe.worker_graph_bound}")
    replays = {**master["replays"], **wstats["replays"]}
    if impl.kind == "device" and pipe.worker_graphs:
        kinds = tuple(kinds) + ("worker",)
    for kind in kinds:
        if replays.get(kind, 0) <= 0:
            raise AssertionError(f"no {kind} program was replayed: {replays}")
    return rep


def _graph_line(rep: dict) -> str:
    pool_mb = ("not named by the allocator" if rep["pool_bytes"] is None
               else f"{rep['pool_bytes'] / 2**20:.1f} MiB")
    return (f"  graphs ({rep['pool']} pool): master {rep['master_graphs']} <= "
            f"{rep['master_bound']}, per worker {rep['worker_graphs']} <= "
            f"{rep['worker_bound']}; replays master {rep['master_replays']}, "
            f"workers {rep['worker_replays']}; capture {rep['capture_s']:.2f} s; "
            f"graph pools {pool_mb}, static inputs "
            f"{rep['static_bytes'] / 2**20:.1f} MiB")


CNN_KINDS = ("encoder", "transition", "decoder")


def serving_phase(server, xs: np.ndarray, counters) -> tuple[list, object, dict]:
    """Warm up (capturing the rounds' graphs), zero the launch counts,
    serve ``xs`` as single-image requests, read the counts and the
    compiled programs' report.  Returns (results, stats, launches,
    graphs)."""
    server.warmup()
    for c in counters:
        c.reset()
    with server:
        handles = server.submit_many(xs)
        outs = [h.result(timeout=600.0) for h in handles]
        graphs = graph_report(server.pipeline, server.cluster,
                              server.pipeline.master_graph_bound, CNN_KINDS)
    return outs, server.stats(), {c.name: c.count for c in counters}, graphs


def straggler_delays(n: int) -> np.ndarray:
    """2 stragglers at +50 ms and 1 dead worker, placed by the seed."""
    order = np.random.default_rng(SEED).permutation(n)
    delays = np.zeros(n)
    delays[order[:2]] = STRAGGLER_DELAY_S
    delays[order[2]] = np.inf
    return delays


def build_server(device, hw: int, pool: str = "threads"):
    from repro_torch.models.cnn import init_cnn
    from repro_torch.runtime import StragglerModel
    from repro_torch.serving import CodedServer

    params = init_cnn(ARCH, torch.Generator().manual_seed(SEED), device)
    server = CodedServer.from_cnn(
        ARCH, params, N_WORKERS, default_kab=KAB, input_hw=hw,
        straggler=StragglerModel(straggler_delays(N_WORKERS)), mode="threads",
        execution="cluster", backend="kernel", bucket_sizes=(1, 2, 4, BUCKET),
        pipeline_depth=2, fuse_transitions=True, pool=pool, device=device)
    return server, params


def check_served(outs, xs: np.ndarray, params, device) -> float:
    """Every served result against the uncoded stack on the same device
    (TF32 off).  Returns the worst error relative to max|uncoded|."""
    from repro_torch.models.cnn import run_convls

    worst = 0.0
    for i in range(0, len(xs), BUCKET):
        ref = run_convls(ARCH, params, torch.as_tensor(xs[i:i + BUCKET], device=device))
        for row, got in enumerate(outs[i:i + BUCKET]):
            r = ref[row].cpu()
            g = torch.as_tensor(got)
            if g.shape != r.shape or not bool(torch.isfinite(g).all()):
                raise AssertionError(f"request {i + row}: shape {tuple(g.shape)}"
                                     f" vs {tuple(r.shape)} or non-finite")
            worst = max(worst, _err(g, r)[1])
    if not worst <= TOL_SERVE:
        raise AssertionError(f"served results off the uncoded stack: "
                             f"rel err {worst} > {TOL_SERVE}")
    return worst


# -- the coded LM decode path ---------------------------------------------
def build_lm(device, cfg=None, params=None):
    """SmolLM-135M (full width and depth unless ``cfg`` says otherwise)
    with ``params``, or random weights from the seed, compiled into the
    coded decoder pipeline the LM server runs."""
    from repro_torch.configs import smollm_135m
    from repro_torch.core.decoder_pipeline import build_lm_decoder_pipeline
    from repro_torch.models.transformer import init_lm

    cfg = cfg if cfg is not None else smollm_135m.full()
    if params is None:
        params = init_lm(cfg, torch.Generator().manual_seed(SEED), device)
    pipe = build_lm_decoder_pipeline(
        cfg, params, LM_N, k_b=LM_KB, bucket_sizes=LM_BUCKETS,
        max_len=LM_MAX_LEN, backend="kernel", device=device)
    return pipe, params


def lm_round_shapes(pipe, bucket: int) -> list[dict]:
    """Per distinct GEMM round geometry: K2's worker GEMM and K3's decode
    at ``bucket`` and K3's build-time weight encode, with how many rounds
    of one decode step (or of the build) launch each."""
    plan = pipe.plan
    eb, q = plan.ell_b, plan.delta * plan.ell_b
    out: dict = {}
    for spec in pipe.specs:
        d_in, d_out = spec.geo.in_channels, spec.geo.out_channels
        ob = d_out // plan.k_b
        key = (d_in, d_out)
        if key in out:
            out[key]["count"] += 1
            continue
        out[key] = {"kind": spec.kind, "count": 1,
                    "worker": ((bucket, d_in), (d_in, eb * ob)),
                    "decode": ((q, q), (q, bucket * ob)),
                    "encode": ((plan.ell_b * plan.n, plan.k_b),
                               (plan.k_b, d_in * ob))}
    return list(out.values())


def _gemm_entry(a_s, b_s, count, fn, plain, gen, device, tol, name,
                timed: bool, plan=None, host_a: bool = False) -> dict:
    """One GEMM shape: ``fn(a, b)`` against ``plain(a, b)``.  With
    ``host_a`` the left operand (K3's code matrix) lies on the host, as
    the path passes it; the library call gets a device copy."""
    a_dev = torch.randn(a_s, generator=gen, device=device)
    b = torch.randn(b_s, generator=gen, device=device)
    a = a_dev.cpu() if host_a else a_dev
    got, ref = fn(a, b), plain(a, b)
    abs_err, rel_err = _err(got, ref)
    if not rel_err <= tol:
        raise AssertionError(f"{name} {a_s} x {b_s}: rel err {rel_err} > {tol}")
    check_repeatable(f"{name} {a_s} x {b_s}", lambda: fn(a, b), got)
    (m, kk), n = a_s, b_s[1]
    bnd, by = bound_ms(2.0 * m * n * kk, 4.0 * (m * kk + kk * n + m * n))
    e = {"a": list(a_s), "b": list(b_s), "count": count,
         **({"a_on": "host"} if host_a else {}),
         **({"plan": plan(m, n, kk)._asdict()} if plan else {}),
         "max_abs_err": abs_err, "max_rel_err": rel_err, "bound_ms": bnd,
         "bound_by": by, "ms": None, "device_ms": None, "plain_ms": None,
         "library_ms": None, "library_device_ms": None}
    if timed:
        e.update(timings(lambda: fn(a, b), lambda: plain(a, b),
                         lambda: torch.matmul(a_dev, b)))
        e["library_rel_err"] = _err(got, torch.matmul(a_dev, b))[1]
    return e


def flash_bound(bh: int, bhkv: int, sq: int, sk: int, d: int,
                width: int = 4) -> tuple[float, str]:
    """Causal attention's least work: each query row i scores and weighs
    min(i + 1, sk) keys (2*d FLOPs each way, fp32 outside the tensor
    cores); each input read once, the output written once, ``width``
    bytes an element."""
    keys = sum(min(i + 1, sk) for i in range(sq))
    return bound_ms(4.0 * d * keys * bh,
                    width * (2 * bh * sq * d + 2 * bhkv * sk * d))


def _k3_plan(m: int, n: int, kk: int):
    from repro_torch.kernels.coded_gemm.kernel import coded_gemm_plan

    return coded_gemm_plan(m, kk, n)


def flash_entry(bh: int, s: int, d: int, rep: int, count: int, dtype, gen,
                device, tol: float, timed: bool) -> dict:
    """K4 at one causal self-attention shape in ``dtype``, against its
    plain version (and, timed, beside SDPA in the same type with K/V
    repeated outside the timed call)."""
    from repro_torch.kernels.flash_attn.kernel import (flash_attention,
                                                       flash_attention_plain,
                                                       flash_plan)

    q, k, v = (torch.randn(shape, generator=gen, device=device).to(dtype)
               for shape in ((bh, s, d), (bh // rep, s, d), (bh // rep, s, d)))

    def run():
        return flash_attention(q, k, v, causal=True, rep=rep)

    def plain():
        return flash_attention_plain(q, k, v, causal=True, rep=rep)

    got = run()
    want = plain()
    abs_err, rel_err = _err(got.float(), want.float())
    name = f"K4 {tuple(q.shape)} {dtype}"
    if not rel_err <= tol:
        raise AssertionError(f"{name}: rel err {rel_err} > {tol}")
    mismatch = float((got != want).float().mean())
    if dtype == torch.bfloat16 and s <= K4_ONE_CHUNK and not mismatch <= K4_BF16_MISMATCH:
        raise AssertionError(f"{name}: {mismatch:.2%} of the outputs differ "
                             f"from the plain version's bits > {K4_BF16_MISMATCH:.2%}")
    check_repeatable(name, run, got)
    width = torch.finfo(dtype).bits // 8
    bnd, by = flash_bound(bh, bh // rep, s, s, d, width)
    e = {"q": [bh, s, d], "kv": [bh // rep, s, d], "rep": rep,
         "dtype": str(dtype).removeprefix("torch."), "count": count,
         "plan": flash_plan(bh, s, s, d, rep)._asdict(),
         "max_abs_err": abs_err, "max_rel_err": rel_err, "tol": tol,
         "mismatch_share": mismatch,
         "bound_ms": bnd, "bound_by": by, "ms": None, "device_ms": None,
         "plain_ms": None, "library_ms": None, "library_device_ms": None}
    if timed:
        b = bh // rep  # SDPA's (B, H, S, D) with one KV head a batch row
        q4 = q.view(b, rep, s, d)
        k4r = k.view(b, 1, s, d).expand(b, rep, s, d).contiguous()
        v4r = v.view(b, 1, s, d).expand(b, rep, s, d).contiguous()

        def library():
            return F.scaled_dot_product_attention(q4, k4r, v4r, is_causal=True)

        e.update(timings(run, plain, library))
        e["library_rel_err"] = _err(got.float(), library().reshape(got.shape).float())[1]
    return e


def lm_kernel_phase(pipe, bucket: int, device, timed: bool = True) -> dict:
    """K2, K3 and K4 at the LM path's shapes against their plain versions
    (and, timed, beside a library call).  Raises on disagreement."""
    from repro_torch.kernels.coded_gemm.kernel import coded_gemm, coded_gemm_plain
    from repro_torch.kernels.matmul.kernel import matmul, matmul_plain, matmul_plan

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    k2, k3_dec, k3_enc = [], [], []
    for r in lm_round_shapes(pipe, bucket):
        k2.append({"round": r["kind"], **_gemm_entry(
            *r["worker"], r["count"], matmul, matmul_plain, gen, device,
            TOL_K2, "K2", timed, plan=matmul_plan)})
        k3_dec.append({"round": r["kind"], "phase": "decode", **_gemm_entry(
            *r["decode"], r["count"], coded_gemm, coded_gemm_plain, gen,
            device, TOL_K3, "K3", timed, plan=_k3_plan, host_a=True)})
        k3_enc.append({"round": r["kind"], "phase": "encode", **_gemm_entry(
            *r["encode"], r["count"], coded_gemm, coded_gemm_plain, gen,
            device, TOL_K3, "K3", timed, plan=_k3_plan, host_a=True)})
    cfg = pipe.cfg
    h, d = cfg.n_heads, cfg.head_dim
    bh, s, rep = bucket * h, LM_MAX_PROMPT, h // cfg.n_kv_heads
    k4 = flash_entry(bh, s, d, rep, cfg.layers, torch.float32, gen, device,
                     TOL_K4, timed)
    k4_bf16 = flash_entry(bh, s, d, rep, cfg.layers, torch.bfloat16, gen,
                          device, TOL_K4_BF16, timed)
    return {"matmul": k2, "coded_gemm": k3_dec, "coded_gemm_encode": k3_enc,
            "flash_attention": [k4], "flash_attention_bf16": [k4_bf16]}


def check_lm_launched_shapes(pipe, bucket: int) -> None:
    """The shapes the LM kernel phase timed are the ones the serving phase
    ran: every K2 worker GEMM among the cluster worker program's argument
    signatures, every K3 decode among the decode program's."""
    seen_k2 = {sig for prog in pipe._cluster_programs.values()
               for sig in prog.signatures}
    seen_dec = pipe.decoder_fn(0).signatures
    plan = pipe.plan
    for r in lm_round_shapes(pipe, bucket):
        (b, d_in), (_, width) = r["worker"]
        if (((1, b, d_in), "torch.float32"),
                ((d_in, width), "torch.float32")) not in seen_k2:
            raise AssertionError(f"K2 worker shape {r['worker']} never served")
        ob = width // plan.ell_b
        if (((plan.delta, plan.ell_b, b, ob), "torch.float32"),
                ((plan.delta * plan.ell_b,) * 2, "torch.float32")) not in seen_dec:
            raise AssertionError(f"K3 decode shape {r['decode']} never served")


def lm_requests(vocab: int) -> list[tuple[list[int], int]]:
    """``LM_REQUESTS`` (prompt, new tokens) pairs drawn from the seed."""
    rng = np.random.default_rng(SEED)
    out = []
    for _ in range(LM_REQUESTS):
        plen = int(rng.integers(LM_PROMPT_LEN[0], LM_PROMPT_LEN[1] + 1))
        gen = int(rng.integers(LM_GEN[0], LM_GEN[1] + 1))
        out.append((rng.integers(0, vocab, plen).tolist(), gen))
    return out


LM_KINDS = ("glue.embed", "glue.norm", "glue.add", "glue.act", "glue.finish",
            "glue.attn", "prefill")


def lm_serving_phase(pipe, requests, counters, mode: str = "threads",
                     pool: str = "threads", graphs=True, workers=False):
    """Serve ``requests`` on ``CodedLMServer`` under ``LM_DELAYS`` on the
    ``pool`` worker pool, its decode steps' glue replayed from CUDA graphs
    unless ``graphs`` is False, and its worker rounds too where
    ``workers`` (captured by ``warmup`` first; the pipeline's switch is
    back at its default after); the launch counts are zeroed just before
    and read just after.  All requests
    arrive together: they are submitted while the scheduler's condition is
    held, so the engine admits a full first group.  The logits row behind
    every served token is kept (a device copy).  With graphs, every
    capture happens in ``warmup`` (the prefill's at most one a bucket):
    serving captures nothing, or the phase fails.  Returns (token streams,
    served logits rows per request, latencies, server, wall seconds,
    launches, compiled programs' report or None, with the prefill's
    captures and seconds under ``prefill``)."""
    from repro_torch.runtime import StragglerModel
    from repro_torch.serving import CodedLMServer

    rows: dict[int, list] = {}
    pipe.set_graphs(graphs, workers=workers)
    try:
        server = CodedLMServer(
            pipe, StragglerModel(np.array(LM_DELAYS)), mode=mode,
            max_prompt=LM_MAX_PROMPT, poll_interval_s=0.001, pool=pool,
            on_logits=lambda rid, row: rows.setdefault(rid, []).append(
                row.clone()))
        server.warmup()
        warm = (None if pipe.master_graphs is None
                else dict(pipe.master_graphs.captures))
        for c in counters:
            c.reset()
        t0 = time.perf_counter()
        report = None
        with server:
            with server.scheduler.not_empty:
                handles = [server.submit(p, g) for p, g in requests]
            outs = [h.result(timeout=900.0) for h in handles]
            wall = time.perf_counter() - t0
            if graphs:
                report = graph_report(pipe, server.cluster,
                                      pipe.glue_graph_bound, LM_KINDS)
                captures = dict(pipe.master_graphs.captures)
                if captures != warm:
                    raise AssertionError(f"captured while serving: {warm} "
                                         f"after warmup, {captures} after")
                if not 0 < captures["prefill"] <= len(pipe.bucket_sizes):
                    raise AssertionError(f"prefill captures {captures['prefill']}"
                                         f" outside (0, {len(pipe.bucket_sizes)}]")
                report["prefill"] = {
                    "captures": captures["prefill"],
                    "replays": report["master_replays"]["prefill"],
                    "held": pipe.master_graphs.stats()["held"].get("prefill", {}),
                    "warmup_s": server.prefill_warmup_s,
                    "prefill_time_s": server.prefill_time_s}
    finally:
        pipe.set_graphs(True, workers=False)
    launches = {c.name: c.count for c in counters}
    if pipe.device.type == "cuda":  # the copies ran on the engine's stream
        torch.cuda.synchronize(pipe.device)
    for (p, g), toks in zip(requests, outs):
        if len(toks) != g:
            raise AssertionError(f"request of {g} tokens served {len(toks)}")
    served = [rows.get(h.request_id, []) for h in handles]
    return (outs, served, [h.latency_s for h in handles], server, wall,
            launches, report)


def lm_reference_rows(pipe, params, requests, outs, device) -> list:
    """The undistributed ``transformer.prefill`` + ``decode_step`` logits
    rows, teacher-forced on each served stream, one request at a time."""
    from repro_torch.models import transformer as lm

    cfg = pipe.cfg
    refs = []
    for (prompt, gen), toks in zip(requests, outs):
        cache = lm.init_cache(cfg, 1, LM_MAX_LEN, device=device)
        logits, cache = lm.prefill(params, cfg, cache,
                                   torch.as_tensor([prompt], device=device))
        rows = [logits[0, -1]]
        for j in range(gen - 1):
            step, cache = lm.decode_step(
                params, cfg, cache,
                torch.as_tensor([[int(toks[j])]], device=device), len(prompt) + j)
            rows.append(step[0, 0])
        refs.append(torch.stack(rows))
    return refs


def check_lm_served(pipe, params, requests, outs, served, device,
                    refs=None) -> dict:
    """Hold the served logits rows against the undistributed transformer's
    (``lm_reference_rows``, or ``refs`` computed already for these very
    token streams): within ``TOL_LM`` relative to max|logit|, and every
    served token the argmax of its own row and an argmax of the
    undistributed row up to that tolerance.  Returns the worst error, the
    count of served tokens equal to the undistributed argmax outright, and
    the reference rows."""
    cfg = pipe.cfg
    if refs is None:
        refs = lm_reference_rows(pipe, params, requests, outs, device)
    worst, exact, total = 0.0, 0, 0
    for r, ((prompt, gen), toks, got, ref) in enumerate(
            zip(requests, outs, served, refs)):
        got = torch.stack(got) if got else ref.new_empty((0, cfg.vocab))
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"request {r}: served logits {tuple(got.shape)} "
                                 f"vs {tuple(ref.shape)} or non-finite")
        want = torch.as_tensor(np.asarray(toks, np.int64), device=device)
        if not torch.equal(got.argmax(dim=-1), want):
            raise AssertionError(f"request {r}: a served token is not the "
                                 f"argmax of its own served logits")
        scale = float(ref.abs().max(dim=-1).values.max())
        picked = ref[torch.arange(gen, device=device), want]
        gap = float((ref.max(dim=-1).values - picked).max())
        if not gap <= TOL_LM * scale:
            raise AssertionError(f"request {r}: a served token is {gap} below "
                                 f"the argmax logit (> {TOL_LM} * {scale})")
        exact += int((ref.argmax(dim=-1) == want).sum())
        total += gen
        worst = max(worst, _err(got, ref)[1])
    if not worst <= TOL_LM:
        raise AssertionError(f"served LM logits off the undistributed "
                             f"transformer: rel err {worst} > {TOL_LM}")
    return {"max_rel_err": worst, "tokens_equal": exact, "tokens": total,
            "refs": refs}


def check_lm_prefill(requests, outs, rows, e_outs, e_rows, launches,
                     e_launches) -> dict:
    """The captured prefill against the eager one, on one pool's two
    runs of the same requests: each request's first logits row (the
    prefill's, recorded through ``on_logits``) ``torch.equal``, its first
    token equal, and K4 launched as often, replayed from the prefill
    graphs (the decode glue never launches K4) as eagerly.  Returns the
    counts."""
    for r, (got, want, o, e) in enumerate(zip(rows, e_rows, outs, e_outs)):
        if not torch.equal(got[0], want[0]):
            diff = float((got[0] - want[0]).abs().max())
            raise AssertionError(f"request {r}: captured prefill logits differ "
                                 f"from eager's by up to {diff:.3e}")
        if int(o[0]) != int(e[0]):
            raise AssertionError(f"request {r}: first token {int(o[0])} "
                                 f"captured, {int(e[0])} eager")
    k4, k4_e = launches["flash_attention"], e_launches["flash_attention"]
    if not 0 < k4 == k4_e:
        raise AssertionError(f"K4 launched {k4} times from the prefill graphs, "
                             f"{k4_e} eagerly")
    return {"rows": len(rows), "first_logits_equal": True, "k4_captured": k4,
            "k4_eager": k4_e, "prompt_width": LM_MAX_PROMPT,
            "requests": len(requests)}


def lm_kernel_summary(entries: list[dict]) -> dict:
    return _summarise([{**e, "library_rel_err": e.get("library_rel_err", 0.0)}
                       for e in entries])


# -- the device worker pool, the layer entry points, HTTP, CodedLinear ------
def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forced_survivor_delays(pipe) -> np.ndarray:
    """Every worker but the first delta delayed: both pools then decode
    from exactly workers 0..delta-1, so their outputs must agree bit for
    bit (fixed-order kernels, the same arithmetic on another stream)."""
    delta = max(spec.plan.delta for spec in pipe.specs)
    delays = np.zeros(pipe.n)
    delays[delta:] = FORCED_DELAY_S
    return delays


def pools_bit_identical(pipe, device, variants=((True, False, "threads"),
                                                (True, False, "device"))) -> dict:
    """One forced-survivor batch of ``BUCKET`` images through
    ``FcdccCluster.run_pipeline`` for each (graphs, workers, pool) of
    ``variants`` (with graphs, the master's programs replay CUDA graphs,
    and with workers the device pool's worker rounds too; without, they
    run op by op); raises unless the outputs are equal bit for bit and
    every run kept workers 0..delta-1, and, for a run with worker graphs,
    unless every kept worker replayed within ``worker_graph_bound``
    graphs.  The pipeline's switch is back at its default after."""
    from repro_torch.core.graphs import merge_stats
    from repro_torch.runtime import FcdccCluster, StragglerModel

    x = torch.as_tensor(np.random.default_rng(SEED + 2).standard_normal(
        (BUCKET,) + pipe.input_shape).astype(np.float32), device=device)
    delays = forced_survivor_delays(pipe)
    keep = [i for i in range(pipe.n) if delays[i] == 0]
    outs, worker_report = {}, None
    try:
        for graphs, workers, pool in variants:
            pipe.set_graphs(graphs, workers=workers)
            with FcdccCluster(pipe.specs[0].plan, StragglerModel(delays),
                              mode="threads", backend="kernel", pool=pool,
                              device=device) as cluster:
                cluster.load_pipeline(pipe, ARCH)
                y, timings = cluster.run_pipeline(x, model=ARCH)
                _sync(device)
                if workers:
                    impl = cluster._pool_impl()
                    counts = impl.graph_counts()
                    st = merge_stats(impl.graph_sets())
                    if not (all(counts[i] > 0 for i in keep)
                            and max(counts) <= pipe.worker_graph_bound
                            and st["replays"].get("worker", 0) > 0):
                        raise AssertionError(
                            f"worker graphs {counts} (bound "
                            f"{pipe.worker_graph_bound}), replays "
                            f"{st['replays']}")
                    worker_report = {
                        "pool": pool, "worker_graphs": counts,
                        "worker_bound": pipe.worker_graph_bound,
                        "worker_replays": st["replays"],
                        "capture_s": st["capture_s"],
                        "static_bytes": st["static_bytes"],
                        "pool_bytes": st["pool_bytes"]}
            if any(t.used_workers != keep for t in timings):
                raise AssertionError(
                    f"{pool} pool decoded from "
                    f"{[t.used_workers for t in timings]}, not {keep}")
            outs[(graphs, workers, pool)] = y
    finally:
        pipe.set_graphs(True, workers=False)
    (k0, y0), *rest = outs.items()
    for k, y in rest:
        if not torch.equal(y0, y):
            diff = float((y0 - y).abs().max())
            raise AssertionError(f"{k} differs from {k0} on a forced survivor "
                                 f"subset: max abs diff {diff}")
    return {"batch": BUCKET, "survivors": keep, "bit_identical": True,
            "runs": [f"{pool}/{('worker graphs' if w else 'graphs') if g else 'eager'}"
                     for g, w, pool in outs],
            "workers": worker_report}


def http_phase(server, params, device, counters) -> dict:
    """``ServingFrontend(port=0)`` over the device-pool server: GET
    /v1/models, one single and one batched POST /v1/infer, GET /v1/stats,
    then a graceful drain; every output against the uncoded stack."""
    import urllib.request

    from repro_torch.serving import ServingFrontend

    def call(method, url, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(url, data=data, method=method,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300.0) as resp:
            return resp.status, json.loads(resp.read())

    pipe = server.pipeline
    xs = np.random.default_rng(SEED + 3).standard_normal(
        (1 + HTTP_BATCH,) + pipe.input_shape).astype(np.float32)
    for c in counters:
        c.reset()
    frontend = ServingFrontend(server, port=0)
    frontend.start()
    t0 = time.perf_counter()
    try:
        status, models = call("GET", f"{frontend.url}/v1/models")
        if status != 200 or [m["name"] for m in models["models"]] != [ARCH]:
            raise AssertionError(f"/v1/models answered {status}: {models}")
        status, single = call("POST", f"{frontend.url}/v1/infer",
                              {"model": ARCH, "input": xs[0].tolist()})
        if status != 200:
            raise AssertionError(f"single /v1/infer answered {status}")
        status, batched = call("POST", f"{frontend.url}/v1/infer",
                               {"model": ARCH,
                                "inputs": [x.tolist() for x in xs[1:]]})
        if status != 200 or batched["count"] != HTTP_BATCH:
            raise AssertionError(f"batched /v1/infer answered {status}")
        status, stats = call("GET", f"{frontend.url}/v1/stats")
        if status != 200 or stats["aggregate"]["completed"] < 1 + HTTP_BATCH:
            raise AssertionError(f"/v1/stats answered {status}: {stats}")
    finally:
        frontend.shutdown()  # graceful drain: engine stopped, pool released
    wall = time.perf_counter() - t0
    launches = {c.name: c.count for c in counters}
    if server._thread is not None:
        raise AssertionError("the engine survived the front-end's drain")
    items = [single] + batched["results"]
    errs = [it["error"] for it in items if "error" in it]
    if errs:
        raise AssertionError(f"HTTP items failed: {errs}")
    worst = check_served([np.asarray(it["output"], np.float32) for it in items],
                         xs, params, device)
    return {"requests": 1 + HTTP_BATCH, "wall_s": wall, "max_rel_err": worst,
            "completed": stats["aggregate"]["completed"], "launches": launches}


def elastic_phase(params, device, counters) -> dict:
    """``run_layer_elastic`` on VGG-16's ``ELASTIC_LAYER`` at 224 (its 112 x
    112 input) with more than gamma workers dead on the device pool: it
    re-plans to a smaller grid and matches the uncoded conv; then one plain
    ``run_layer`` against filters placed by ``preload_filters`` under 2
    stragglers and 1 dead worker."""
    from repro_torch.core.fcdcc import FcdccPlan
    from repro_torch.models.cnn import CNN_SPECS, layer_geometry
    from repro_torch.runtime import (FcdccCluster, StragglerModel,
                                     run_layer_elastic)

    layer = next(l for l in CNN_SPECS[ARCH][1] if l.name == ELASTIC_LAYER)
    geo = layer_geometry(layer, ELASTIC_HW)
    k = params[layer.name]
    x = torch.as_tensor(np.random.default_rng(SEED + 4).standard_normal(
        (1, layer.in_ch, ELASTIC_HW, ELASTIC_HW)).astype(np.float32), device=device)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        ref = F.conv2d(x, k, stride=layer.stride, padding=layer.padding)
    plan = FcdccPlan(n=N_WORKERS, k_a=KAB[0], k_b=KAB[1])
    dead = np.full(N_WORKERS, np.inf)
    dead[N_WORKERS - 1] = 0.0  # one survivor: gamma = n - delta exceeded
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    y, timing, plan2 = run_layer_elastic(
        plan, geo, x, k, StragglerModel(dead), mode="threads", pool="device",
        backend="kernel", device=device)
    _sync(device)
    elastic_s = time.perf_counter() - t0
    if not plan2.delta < plan.delta or timing.used_workers != [N_WORKERS - 1]:
        raise AssertionError(f"elastic re-plan kept {plan2} on "
                             f"{timing.used_workers}")
    err_elastic = _err(y, ref)[1]
    with FcdccCluster(plan, StragglerModel(straggler_delays(N_WORKERS)),
                      mode="threads", backend="kernel", pool="device",
                      device=device) as cluster:
        cluster.preload_filters(layer.name, geo, k)
        y2, timing2 = cluster.run_layer(geo, x, layer_name=layer.name)
        encodes = cluster.coded_layer(geo).filter_encode_calls
    _sync(device)
    err_plain = _err(y2, ref)[1]
    launches = {c.name: c.count for c in counters}
    if encodes != 1:
        raise AssertionError(f"run_layer re-encoded preloaded filters ({encodes})")
    worst = max(err_elastic, err_plain)
    if not worst <= TOL_SERVE:
        raise AssertionError(f"run_layer off the uncoded conv: rel err "
                             f"{err_elastic} (elastic), {err_plain} (preloaded)"
                             f" > {TOL_SERVE}")
    return {"layer": layer.name, "input": list(x.shape),
            "plan": [plan.k_a, plan.k_b], "replanned": [plan2.k_a, plan2.k_b],
            "elastic_s": elastic_s, "elastic_rel_err": err_elastic,
            "preloaded_rel_err": err_plain, "preloaded_used": timing2.used_workers,
            "launches": launches}


def coded_linear_phase(device, counters) -> dict:
    """``CodedLinear`` at SmolLM-135M's up-projection widths (T = 4, d_in
    576, d_out 1536) on n=6, (k_a, k_b) = (2, 4), for every delta-subset:
    worker GEMMs on K2, the decode on K3; against ``torch.matmul`` in IEEE
    fp32 within ``TOL_LINEAR`` of max|Y|."""
    import itertools

    from repro_torch.core.coded_linear import CodedLinear
    from repro_torch.core.fcdcc import FcdccPlan

    plan = FcdccPlan(n=6, k_a=2, k_b=4)
    rng = np.random.default_rng(SEED + 5)
    x = torch.as_tensor(rng.standard_normal((4, 576)).astype(np.float32), device=device)
    w = torch.as_tensor((rng.standard_normal((576, 1536)) / 24.0).astype(np.float32),
                        device=device)
    want = torch.matmul(x, w)
    layer = CodedLinear(plan, 4, 576, 1536)
    for c in counters:
        c.reset()
    worst, subsets = 0.0, 0
    for ids in itertools.combinations(range(plan.n), plan.delta):
        got = layer.run_simulated(x, w, list(ids))
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"CodedLinear {ids}: {tuple(got.shape)} or non-finite")
        worst = max(worst, _err(got, want)[1])
        subsets += 1
    launches = {c.name: c.count for c in counters}
    if not worst <= TOL_LINEAR:
        raise AssertionError(f"CodedLinear off torch.matmul: rel err {worst} "
                             f"> {TOL_LINEAR}")
    if layer.weight_encode_calls != 1:
        raise AssertionError("CodedLinear re-encoded its weights")
    return {"plan": [plan.n, plan.k_a, plan.k_b], "subsets": subsets,
            "max_rel_err": worst, "launches": launches}


def contracts_phase(lm_pipe, device, counters) -> dict:
    """The analysis gate's card half over the served configurations'
    program spaces (phase 11): the VGG-16 pipeline the CNN server runs,
    rebuilt from the seed, and the LM pipeline the LM server ran.  Raises
    with every finding when a contract fails; returns the counts."""
    from repro_torch.analysis import contracts, dispatch_tools
    from repro_torch.core.pipeline import build_cnn_pipeline
    from repro_torch.models.cnn import init_cnn

    t0 = time.perf_counter()
    params = init_cnn(ARCH, torch.Generator().manual_seed(SEED), device)
    vgg = build_cnn_pipeline(
        ARCH, params, N_WORKERS, default_kab=KAB, input_hw=HW,
        backend="kernel", bucket_sizes=(1, 2, 4, BUCKET),
        fuse_transitions=True, device=device)
    # a replay on the second subset proves the inverse is an argument only
    # where that subset decodes differently: it does on every layer here
    for idx in range(len(vgg.specs)):
        a, b = (vgg.decode_operand(idx, dispatch_tools.survivors(vgg, idx, v))
                for v in (0, 1))
        if torch.equal(a, b):
            raise AssertionError(f"layer {idx}: both survivor subsets decode "
                                 f"alike; the replay check would be vacuous")
    for c in counters:
        c.reset()
    labels = (f"{ARCH}-{HW}/kernel/fused", f"{lm_pipe.cfg.name}/kernel/coded")
    report = contracts.analyze(vgg, labels[0], device, seed=SEED)
    report.extend(contracts.analyze(lm_pipe, labels[1], device, seed=SEED))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {c.name: c.count for c in counters}
    del vgg, params
    torch.cuda.empty_cache()
    if report.findings:
        raise AssertionError("contracts failed on the card:\n"
                             + report.render_text(show_info=True))
    st = report.stats
    out = {"seconds": seconds, "launches": launches, "configs": {}}
    for label in labels:
        out["configs"][label] = {
            key: st[f"{label}/{key}"]
            for key in ("programs_checked", "captured", "eager_only", "bound")}
        out["configs"][label]["traces"] = {
            mode: st[f"{label}/{mode}/traces"] for mode in ("direct", "cluster")}
        out["configs"][label]["eager_only_cells"] = st.get(
            f"{label}/eager_only_cells", [])
        out["configs"][label]["eager_only_reasons"] = st.get(
            f"{label}/eager_only_reasons", [])
    return out


def _pool_line(name: str, stats, ov) -> str:
    return (f"  {name:7s} {stats.images_per_s:8.2f} img/s, e2e p50 "
            f"{stats.e2e_p50_s * 1e3:7.1f} ms, p99 {stats.e2e_p99_s * 1e3:7.1f} "
            f"ms; over {ov.rounds} rounds (s): dispatch {ov.dispatch_s:.4f}, "
            f"worker {ov.worker_s:.4f}, collect {ov.collect_s:.4f}, "
            f"transition {ov.transition_s:.4f}, busy wall {ov.busy_wall_s:.4f}")


def _lm_line(name: str, server, toks: int, wall: float) -> str:
    return (f"  {name:14s} {toks / wall:7.2f} tok/s over {wall:.2f} s wall; "
            f"{server.decode_steps} decode steps {server.decode_time_s:.3f} s; "
            f"over {server.rounds} rounds (s): encode "
            f"{server.round_encode_s:.4f}, to delta-th result "
            f"{server.round_compute_s:.4f}, decode {server.round_decode_s:.4f}; "
            f"glue and host between rounds "
            f"{server.decode_time_s - server.round_encode_s - server.round_compute_s - server.round_decode_s:.4f}")


def lm_loss_fp64(params, cfg, tokens, targets):
    """SmolLM's training loss written out plainly in float64, apart from the
    port's model code: embedding, per layer RMS norm (``x / rms * (1 + g)``),
    rotary q/k (half split), causal GQA softmax attention, SwiGLU FFN, the
    final norm, the tied head, then the mean next-token NLL.  The dense
    llama case only (the configuration this phase trains)."""
    if (cfg.qk_norm or cfg.sandwich_norms or cfg.embed_scale or cfg.window
            or cfg.attn_softcap or cfg.logit_softcap or cfg.act != "silu"
            or not cfg.tie_embeddings):
        raise ValueError(f"lm_loss_fp64 covers the plain llama case, not {cfg}")
    f64 = torch.float64
    b, s = tokens.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    embed = params["embed"].to(f64)

    def norm(x, g):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * (1 + g.to(f64))

    half = hd // 2
    inv = cfg.rope_base ** (-torch.arange(half, dtype=f64, device=embed.device) / half)
    ang = torch.arange(s, dtype=f64, device=embed.device)[:, None] * inv  # (S, hd/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]

    def rope(t):  # (B, S, heads, hd)
        t1, t2 = t[..., :half], t[..., half:]
        return torch.cat([t1 * cos - t2 * sin, t2 * cos + t1 * sin], dim=-1)

    causal = torch.ones(s, s, dtype=torch.bool, device=embed.device).tril()
    x = embed[tokens.long()]
    for l in range(cfg.layers):
        w = {k: v[l].to(f64) for k, v in params["dense_layers"].items()}
        a = norm(x, w["ln_attn"])
        q = rope((a @ w["wq"]).reshape(b, s, h, hd))
        k = rope((a @ w["wk"]).reshape(b, s, hkv, hd))
        v = (a @ w["wv"]).reshape(b, s, hkv, hd)
        k = k.repeat_interleave(h // hkv, dim=2)  # query head g*rep+r reads g
        v = v.repeat_interleave(h // hkv, dim=2)
        sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        p = torch.softmax(sc.masked_fill(~causal, -math.inf), dim=-1)
        x = x + torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, s, h * hd) @ w["wo"]
        f = norm(x, w["ln_ffn"])
        x = x + (F.silu(f @ w["w_gate"]) * (f @ w["w_up"])) @ w["w_down"]
    logits = norm(x, params["ln_f"]) @ embed.t()
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets.long()[..., None]).mean()


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    scale = float(want.abs().max())
    return float((got.double() - want).abs().max()) / max(scale, 1e-300)


def check_step1_fp64(bundle, params, batch) -> dict:
    """The port's step-1 loss and gradients (``steps.value_and_grad`` of
    the bundle's loss, the train step's own) held against
    ``lm_loss_fp64`` on the same params, cast to float64, on the same
    device: the loss within TOL_TRAIN_LOSS relative, every leaf's gradient
    within TOL_TRAIN_GRAD of its max|g|, finite, and non-zero in every
    layer of every stacked leaf."""
    from repro_torch.launch import steps
    from repro_torch.tree import tree_items, tree_map

    loss, grads = steps.value_and_grad(bundle.loss_fn, params, batch)
    p64 = tree_map(lambda t: t.detach().double(), params)
    loss64, g64 = steps.value_and_grad(
        lambda p, b: lm_loss_fp64(p, bundle.cfg, b["tokens"], b["labels"]),
        p64, batch)
    loss_err = abs(float(loss) - float(loss64)) / abs(float(loss64))
    if not loss_err <= TOL_TRAIN_LOSS:
        raise AssertionError(f"step-1 loss {float(loss)} vs fp64 "
                             f"{float(loss64)}: rel err {loss_err:.2e}")
    worst, leaves = 0.0, {}
    want = dict(tree_items(g64))
    for path, g in tree_items(grads):
        name = "/".join(path)
        if not torch.isfinite(g).all():
            raise AssertionError(f"step-1 gradient {name} is not finite")
        per_layer = g.flatten(1).abs().amax(1) if path[0] == "dense_layers" \
            else g.abs().max()[None]
        if not (per_layer > 0).all():
            zero = torch.nonzero(per_layer == 0).flatten().tolist()
            raise AssertionError(f"step-1 gradient {name} is zero (layers "
                                 f"{zero}): the gradient was cut")
        err = _rel(g, want[path])
        if not err <= TOL_TRAIN_GRAD:
            raise AssertionError(f"step-1 gradient {name} vs fp64: {err:.2e} "
                                 f"of max|g| > {TOL_TRAIN_GRAD}")
        worst = max(worst, err)
        leaves[name] = err
    del p64, g64
    return {"loss": float(loss), "loss_fp64": float(loss64),
            "loss_rel_err": loss_err, "grad_rel_err": worst,
            "grad_rel_err_by_leaf": leaves}


def _train_config(**kw):
    """The ``TrainConfig`` that ``train`` gives a TRAIN_STEPS-step run."""
    from repro_torch.launch import steps
    from repro_torch.optim import AdamWConfig

    return steps.TrainConfig(opt=AdamWConfig(), warmup=min(20, TRAIN_STEPS // 10 + 1),
                             total_steps=TRAIN_STEPS, **kw)


def _restored(bundle, ckpt_dir: str, step: int, device) -> dict:
    """``{"params", "opt"}`` as the checkpoint of ``step`` holds them."""
    from repro_torch.checkpoint import restore
    from repro_torch.optim import init_state

    params = bundle.init(torch.Generator().manual_seed(SEED), torch.float32, device)
    return restore(ckpt_dir, step, {"params": params, "opt": init_state(params)})


def _worst(got: dict, want: dict) -> float:
    """The largest of ``_rel`` over the leaves of two trees of one shape."""
    from repro_torch.tree import tree_leaves

    return max(_rel(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))


def check_microbatches(bundle, ckpt_dir: str, step: int, batch, device) -> dict:
    """``microbatches=2`` against the full batch, from the run's own
    checkpoint at ``step`` (its moments filled, its learning rate not 0):
    the loss within TOL_TRAIN_LOSS relative; the accumulated gradient
    within TOL_MICRO of each leaf's max|g|; then one train step's params
    and moments within TOL_MICRO of each leaf's max, the params moved.
    The gradient is held as well as the update because the update sees it
    after clipping, where a gradient off by a factor gives the same step.
    The gradient check is also read on a planted fault, the first slice's
    gradient alone (an accumulation that dropped a slice), which must fail
    it: the limit lies between the two readings."""
    from repro_torch.launch import steps
    from repro_torch.tree import tree_leaves

    state = _restored(bundle, ckpt_dir, step, device)
    params = state["params"]
    (l1, g1), (l2, g2) = (steps.accumulated_value_and_grad(
        bundle.loss_fn, params, batch, m) for m in (1, 2))
    loss_err = abs(float(l2) - float(l1)) / abs(float(l1))
    grad_err = _worst(g2, g1)
    del g2
    half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
    _, g_fault = steps.value_and_grad(bundle.loss_fn, params, half)
    fault_err = _worst(g_fault, g1)
    del g1, g_fault, state, params
    if not fault_err > TOL_MICRO:
        raise AssertionError(f"microbatch check: a dropped slice reads "
                             f"{fault_err:.2e}, inside {TOL_MICRO}")
    if not (loss_err <= TOL_TRAIN_LOSS and grad_err <= TOL_MICRO):
        raise AssertionError(f"microbatches=2 vs the full batch: loss rel err "
                             f"{loss_err:.2e}, gradient {grad_err:.2e} of max|g|")
    outs = []
    for m in (1, 2):
        state = _restored(bundle, ckpt_dir, step, device)
        before = [p.clone() for p in tree_leaves(state["params"])]
        fn = steps.build_train_step(bundle, _train_config(microbatches=m))
        p, o, _ = fn(state["params"], state["opt"], batch)
        moved = max(float((a - b).abs().max())
                    for a, b in zip(tree_leaves(p), before))
        outs.append((p, o, moved))
        del before, state
    (p1, o1, mv1), (p2, o2, mv2) = outs
    if not (mv1 > 0 and mv2 > 0):
        raise AssertionError("microbatch check: a step did not move the params")
    update_err = {"params": _worst(p2, p1), "m": _worst(o2["m"], o1["m"]),
                  "v": _worst(o2["v"], o1["v"])}
    if not max(update_err.values()) <= TOL_MICRO:
        raise AssertionError(f"microbatches=2 vs the full batch: the update "
                             f"differs by {update_err} of each leaf's max")
    return {"loss_rel_err": loss_err, "grad_rel_err": grad_err,
            "dropped_slice_grad_rel_err": fault_err,
            "update_rel_err": update_err, "update": mv1}


def k4_refuses_autograd(device) -> str:
    """K4 under grad mode with an operand that requires grad raises on the
    card (it has no backward), and launches nothing."""
    from repro_torch.kernels.flash_attn.kernel import flash_attention, launches

    q = torch.randn(36, 16, 64, device=device, requires_grad=True)
    kv = torch.randn(12, 16, 64, device=device)
    before = launches.count
    try:
        flash_attention(q, kv, kv, rep=3)
    except RuntimeError as e:
        if launches.count != before:
            raise AssertionError("K4 launched before refusing autograd") from e
        return str(e).split(":")[0]
    raise AssertionError("K4 took an operand that requires grad under autograd")


def _synced_s(fn):
    """``(fn(), seconds)`` with the card synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def train_profile(bundle, ckpt_dir: str, step: int, data, device,
                  captured: bool, n: int = 3) -> dict:
    """Where a train step's time goes, from the checkpoint at ``step``,
    eager or replayed from the captured step (``compiled_train_step``, as
    ``train`` runs it; its capture is one step before the window): ``n``
    steps under ``torch.profiler`` (the sum of the kernel records a step
    is the device's busy time, one stream, no two kernels overlapping;
    the six kernels that took the most of it), the same steps' wall time
    on the host's clock, each step ending with its loss on the host, and
    the device's idle share of that time.  Eager, then also ``n`` steps
    with the card synchronised around the loss and gradients and around
    the AdamW update, and one checkpoint ``submit`` of the state (the
    host snapshot it takes before returning) and its write."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.checkpoint import AsyncCheckpointer
    from repro_torch.core.graphs import GraphSet
    from repro_torch.launch import steps
    from repro_torch.optim import apply_updates
    from repro_torch.optim.schedule import cosine_with_warmup
    from repro_torch.tree import tree_leaves

    state = _restored(bundle, ckpt_dir, step, device)
    tcfg = _train_config()
    fn = steps.build_train_step(bundle, tcfg)
    p, o = state["params"], state["opt"]
    batches = [{k: torch.from_numpy(v).to(device)
                for k, v in data.batch(step + i).items()} for i in range(n + 1)]
    out = {"steps": n, "captured": captured}
    if captured:
        gs = GraphSet("train_profile", device)
        fn = steps.compiled_train_step(fn, gs)
        p, o, met = fn(p, o, batches[0])
        float(met["loss"])
        out["capture_s"] = gs.capture_s
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[1:]:
            p, o, met = fn(p, o, b)
            float(met["loss"])
        step_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = []
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        t = float(t if t is not None else ev.self_cuda_time_total)
        if t > 0:
            rows.append((t / 1e3 / n, ev.key, ev.count // n))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) if rows else None
    out.update({"step_ms": step_ms, "device_busy_ms": busy,
                "device_idle_share": None if busy is None else 1.0 - busy / step_ms,
                "kernels_a_step": sum(r[2] for r in rows),
                "top_kernels": [{"name": k[:90], "ms": t, "calls": c}
                                for t, k, c in rows[:6]]})
    if captured:
        return out

    grad_s, update_s = [], []
    for b in batches[1:]:
        (_, grads), dt = _synced_s(lambda: steps.value_and_grad(bundle.loss_fn, p, b))
        grad_s.append(dt)
        scale = cosine_with_warmup(o["step"], warmup=tcfg.warmup, total=tcfg.total_steps)
        (p, o, _), dt = _synced_s(lambda: apply_updates(p, grads, o, tcfg.opt, scale))
        update_s.append(dt)
        del grads
    writer = AsyncCheckpointer(ckpt_dir)
    tree = {"params": p, "opt": o}
    _, snap_s = _synced_s(lambda: writer.submit(step + 2 * n + 1, tree))
    t0 = time.perf_counter()
    writer.wait()
    write_s = time.perf_counter() - t0
    out.update({"loss_and_grads_ms": float(np.median(grad_s)) * 1e3,
                "adamw_ms": float(np.median(update_s)) * 1e3,
                "checkpoint_snapshot_ms": snap_s * 1e3,
                "checkpoint_write_after_submit_s": write_s,
                "checkpoint_bytes": sum(t.numel() * t.element_size()
                                        for t in tree_leaves(tree))})
    return out


def _train_run(bundle, ckpt_dir: str, device, counters, graphs, smoke: bool,
               stamps: list | None = None) -> dict:
    """One ``train`` call of TRAIN_STEPS steps into ``ckpt_dir``: its losses,
    wall seconds, the kernels' launches, the device memory peak, and the
    host time of each step's callback in ``stamps`` where given."""
    from repro_torch.launch.train import train

    def on_step(step, metrics):
        if stamps is not None:
            stamps.append(time.perf_counter())
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32

    for c in counters:
        c.reset()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    losses = train(TRAIN_ARCH, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                   seq=TRAIN_SEQ, smoke=smoke, ckpt_dir=ckpt_dir,
                   ckpt_every=TRAIN_CKPT, device=device, seed=SEED,
                   on_step=on_step, graphs=graphs)
    return {"losses": losses, "wall_s": time.perf_counter() - t0,
            "launches": {c.name: c.count for c in counters},
            "peak": (torch.cuda.max_memory_allocated(device)
                     if device.type == "cuda" else None)}


def train_phase(device, counters, card: str, smoke: bool = False,
                graphs=True) -> dict:
    """SmolLM-135M trained through ``train`` (the entry point of ``python
    -m repro_torch.launch.train``), checked as the module docstring's
    phase 3 says: with ``graphs`` (its captured step; the default), then
    eagerly.  ``smoke`` runs the smoke config (a rehearsal on the CPU,
    with ``graphs`` a graph class that captures there, such as the tests'
    emulator); the script's run is the full config on the card."""
    import shutil
    import tempfile

    from repro_torch.configs import get_bundle
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.tree import tree_leaves

    bundle = get_bundle(TRAIN_ARCH, smoke=smoke)
    cfg = bundle.cfg
    params = bundle.init(torch.Generator().manual_seed(SEED), torch.float32, device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH))
    batch0 = {k: torch.from_numpy(v).to(device) for k, v in data.batch(0).items()}
    step1 = check_step1_fp64(bundle, params, batch0)
    del params
    _empty_cache(device)

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    eager_dir = tempfile.mkdtemp(prefix="chip_smoke_train_eager_")
    try:
        stamps, stamps_e = [], []
        run = _train_run(bundle, ckpt_dir, device, counters, graphs, smoke, stamps)
        final = _restored(bundle, ckpt_dir, TRAIN_STEPS, device)["params"]
        eager = _train_run(bundle, eager_dir, device, counters, False, smoke,
                           stamps_e)
        final_e = _restored(bundle, eager_dir, TRAIN_STEPS, device)["params"]
        losses, launches, peak = run["losses"], run["launches"], run["peak"]
        for label, r in (("captured", run), ("eager", eager)):
            if r["launches"].get("flash_attention", 0):
                raise AssertionError(f"{label} training launched K4: "
                                     f"{r['launches']}")
            if len(r["losses"]) != TRAIN_STEPS or not np.all(np.isfinite(r["losses"])):
                raise AssertionError(f"{label} training losses {r['losses']}")
        if abs(losses[0] - step1["loss"]) > 1e-6 * abs(step1["loss"]):
            raise AssertionError(f"train's step-1 loss {losses[0]} is not the "
                                 f"checked step's {step1['loss']}")
        first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        if not last5 < first5:
            raise AssertionError(f"loss did not fall: first 5 {first5}, last 5 "
                                 f"{last5}")
        graph_loss_err = float(np.max(np.abs(np.asarray(losses) -
                                             np.asarray(eager["losses"])) /
                                      np.abs(np.asarray(eager["losses"]))))
        graph_param_err = _worst(final, final_e)
        del final, final_e
        if not (graph_loss_err <= TOL_TRAIN_GRAPH
                and graph_param_err <= TOL_TRAIN_GRAPH):
            raise AssertionError(
                f"captured training against eager: losses rel err "
                f"{graph_loss_err:.2e}, final params {graph_param_err:.2e} of "
                f"max|p| (limit {TOL_TRAIN_GRAPH})")

        # restart: drop the later checkpoints, resume from TRAIN_CKPT in a
        # fresh (captured) train() call, and hold its losses to the run's own
        for d in os.listdir(ckpt_dir):
            if d.startswith("step-") and int(d.split("-")[1]) > TRAIN_CKPT:
                shutil.rmtree(os.path.join(ckpt_dir, d))
        rest = _train_run(bundle, ckpt_dir, device, (), graphs, smoke)["losses"]
        ref = np.asarray(losses[TRAIN_CKPT:])
        if len(rest) != len(ref):
            raise AssertionError(f"restart ran {len(rest)} steps, not {len(ref)}")
        restart_err = float(np.max(np.abs(np.asarray(rest) - ref) / np.abs(ref)))
        if not restart_err <= TOL_TRAIN_RESTART:
            raise AssertionError(f"restart losses {rest} vs {ref.tolist()}: "
                                 f"rel err {restart_err:.2e}")
        b15 = {k: torch.from_numpy(v).to(device)
               for k, v in data.batch(TRAIN_CKPT).items()}
        micro = check_microbatches(bundle, ckpt_dir, TRAIN_CKPT, b15, device)
        prof = ({"captured": train_profile(bundle, ckpt_dir, TRAIN_CKPT, data,
                                           device, True),
                 "eager": train_profile(bundle, ckpt_dir, TRAIN_CKPT, data,
                                        device, False)}
                if device.type == "cuda" else None)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        shutil.rmtree(eager_dir, ignore_errors=True)
    refused = k4_refuses_autograd(device) if device.type == "cuda" else None

    def rate(st):
        # steps 5..30 (1-based): each step's time is the gap between the
        # callbacks of consecutive steps (the loss is on the host by then)
        gaps = np.diff(np.asarray(st))[3:]
        return float(np.median(gaps)), gaps

    step_s, gaps = rate(stamps)
    step_s_e, gaps_e = rate(stamps_e)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # 6 N T for the matmuls of forward and backward (the tied head once),
    # plus attention's QK^T and PV over the full S x S square the plain
    # masked route computes: 2 matmuls x 2 flops x 3 passes
    attn = 12 * cfg.layers * TRAIN_BATCH * cfg.n_heads * TRAIN_SEQ ** 2 * cfg.head_dim
    flops = 6 * n_params * tokens + attn
    return {
        "arch": cfg.name, "layers": cfg.layers, "d_model": cfg.d_model,
        "vocab": cfg.vocab, "params": n_params, "steps": TRAIN_STEPS,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "dtype": "float32",
        "tf32": False, "ms_per_step": step_s * 1e3,
        "ms_per_step_min_max": [float(gaps.min()) * 1e3, float(gaps.max()) * 1e3],
        "tokens_per_s": tokens / step_s, "run_s": run["wall_s"],
        "peak_device_bytes": peak, "model_flops_per_step": flops,
        "fp32_peak_share": flops / step_s / PEAK_FP32_FLOPS,
        "loss_first5": first5, "loss_last5": last5, "losses": losses,
        "eager": {"ms_per_step": step_s_e * 1e3,
                  "ms_per_step_min_max": [float(gaps_e.min()) * 1e3,
                                          float(gaps_e.max()) * 1e3],
                  "tokens_per_s": tokens / step_s_e, "run_s": eager["wall_s"],
                  "peak_device_bytes": eager["peak"],
                  "losses": eager["losses"], "launches": eager["launches"]},
        "captured_vs_eager": {"loss_rel_err": graph_loss_err,
                              "final_param_rel_err": graph_param_err},
        "step1": {k: v for k, v in step1.items() if k != "grad_rel_err_by_leaf"},
        "step1_grad_rel_err_by_leaf": step1["grad_rel_err_by_leaf"],
        "restart_rel_err": restart_err, "microbatches": micro,
        "k4_under_autograd": refused, "launches": launches, "profile": prof,
        "card": card,
    }


def print_train(tr: dict, card: str) -> None:
    """The training phase's lines (``train_phase``'s readings)."""
    s1, mb, prof, e = tr["step1"], tr["microbatches"], tr["profile"], tr["eager"]
    print(f"trained {tr['arch']} ({tr['params']} params, {tr['layers']} "
          f"layers, fp32, TF32 off) for {tr['steps']} steps of "
          f"{tr['batch']} x {tr['seq']} tokens, each step one captured "
          f"graph, on {card}: "
          f"{tr['ms_per_step']:.2f} ms/step (median of steps 5-30; min/max "
          f"{tr['ms_per_step_min_max'][0]:.2f}/{tr['ms_per_step_min_max'][1]:.2f}), "
          f"{tr['tokens_per_s']:.0f} tokens/s, {tr['fp32_peak_share']:.3f} of the "
          f"fp32 peak by model FLOPs, peak {_gib(tr['peak_device_bytes'])}; "
          f"loss {tr['loss_first5']:.4f} -> {tr['loss_last5']:.4f} (mean "
          f"of first/last 5); launches {tr['launches']}")
    cv = tr["captured_vs_eager"]
    print(f"  eagerly: {e['ms_per_step']:.2f} ms/step (min/max "
          f"{e['ms_per_step_min_max'][0]:.2f}/{e['ms_per_step_min_max'][1]:.2f}), "
          f"{e['tokens_per_s']:.0f} tokens/s, peak {_gib(e['peak_device_bytes'])}; "
          f"captured against eager: losses of steps 1-{tr['steps']} rel err "
          f"{cv['loss_rel_err']:.2e}, final params {cv['final_param_rel_err']:.2e} "
          f"of max|p| (<= {TOL_TRAIN_GRAPH})")
    print(f"  step 1 vs fp64 on the card: loss {s1['loss']:.6f} vs "
          f"{s1['loss_fp64']:.6f} (rel {s1['loss_rel_err']:.2e} <= "
          f"{TOL_TRAIN_LOSS}), gradients max {s1['grad_rel_err']:.2e} of "
          f"max|g| <= {TOL_TRAIN_GRAD}, every leaf finite and non-zero in "
          f"every layer; captured restart from step {TRAIN_CKPT}: rel err "
          f"{tr['restart_rel_err']:.2e} <= {TOL_TRAIN_RESTART}; microbatches=2 "
          f"vs full batch: loss {mb['loss_rel_err']:.2e}, gradients "
          f"{mb['grad_rel_err']:.2e} of max|g| <= {TOL_MICRO} (a dropped "
          f"slice reads {mb['dropped_slice_grad_rel_err']:.2e}), update "
          f"params/m/v {mb['update_rel_err']['params']:.2e}/"
          f"{mb['update_rel_err']['m']:.2e}/{mb['update_rel_err']['v']:.2e} "
          f"(largest move {mb['update']:.2e}); K4 under autograd: "
          f"{tr['k4_under_autograd']}")
    if prof is None:
        return
    for label in ("captured", "eager"):
        pr = prof[label]
        idle = pr["device_idle_share"]
        print(f"  profiler, {label}, {pr['steps']} steps: device busy "
              f"{_ms(pr['device_busy_ms'])} ms a step in "
              f"{pr['kernels_a_step']} kernels, idle "
              f"{'not measured' if idle is None else f'{idle:.3f}'} of the "
              f"same steps' {pr['step_ms']:.2f} ms"
              + (f", capture {pr['capture_s']:.2f} s" if "capture_s" in pr else "")
              + "; most time: " + "; ".join(
                  f"{k['name'][:60]} {k['ms']:.2f} ms x{k['calls']}"
                  for k in pr["top_kernels"][:4]))
    pr = prof["eager"]
    print(f"  synchronised, eager: loss and gradients "
          f"{pr['loss_and_grads_ms']:.2f} ms, AdamW {pr['adamw_ms']:.2f} ms a "
          f"step; checkpoint of {pr['checkpoint_bytes'] / 2**30:.2f} GiB: "
          f"snapshot {pr['checkpoint_snapshot_ms']:.1f} ms inside submit, "
          f"write {pr['checkpoint_write_after_submit_s']:.2f} s after it")


def _empty_cache(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


# -- the arch zoo: the reference's other transformer archs ------------------
def moe_checks(bundle, params, prompts, device, expect_no_drops: bool) -> dict:
    """Checks (a) and (b) on the first MoE layer's real activations (its
    input recorded while ``prefill_fn`` runs): the gather dispatch against
    ``moe_ffn_plain`` within ``TOL_MOE_PLAIN`` of max|y|; a float64 loop,
    token by token, over ``MOE_SAMPLED`` sampled tokens within
    ``TOL_MOE_FP64``, its top-k equal to the served routing's in order and
    only the kept entries summed.  A group of ``tg`` tokens sends at most
    ``tg`` entries to one expert, so where ``tg <= cap`` no entry can drop;
    ``expect_no_drops`` holds the run to that case and to 0 drops."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as lm

    cfg = bundle.cfg.moe
    seen = []
    real = lm.moe_ffn

    def record(w, x, c):
        if not seen:
            seen.append((w, x.clone()))
        return real(w, x, c)

    lm.moe_ffn = record
    try:
        bundle.prefill_fn(params, {"tokens": prompts})
    finally:
        lm.moe_ffn = real
    w, x = seen[0]
    y = moe.moe_ffn(w, x, cfg)
    plain = moe.moe_ffn_plain(w, x, cfg)
    xg = moe._grouped(x, cfg)
    r = moe.route(w, xg, cfg)
    err_plain = _err(y, plain)[1]
    if not err_plain <= TOL_MOE_PLAIN:
        raise AssertionError(f"MoE gather vs plain: rel err {err_plain} > "
                             f"{TOL_MOE_PLAIN}")
    t, d = x.shape
    tg, k = t // xg.shape[0], cfg.top_k
    dropped = int((~r.keep).sum())
    if tg <= r.cap and dropped:
        raise AssertionError(f"MoE dropped {dropped} entries where none can drop")
    if expect_no_drops and not (tg <= r.cap and dropped == 0):
        raise AssertionError(f"MoE: groups of {tg} tokens, cap {r.cap}, "
                             f"{dropped} entries dropped")
    # each token-major entry's keep (keep is in expert-sorted order)
    entry_keep = torch.gather(r.keep, 1, torch.argsort(r.order, dim=-1))
    picks = np.random.default_rng(SEED).choice(t, MOE_SAMPLED, replace=False)
    worst_fp64, scale = 0.0, float(y[picks].abs().max())
    for i in picks.tolist():
        gi, ti = divmod(i, tg)
        xi = x[i].double()
        probs = torch.softmax(xi @ w["router"].double(), dim=-1)
        vals, idx = torch.sort(probs, descending=True, stable=True)
        top, wts = idx[:k], vals[:k] / vals[:k].sum()
        if not torch.equal(top, r.gate_e[gi, ti]):
            raise AssertionError(f"token {i}: float64 top-{k} {top.tolist()} vs "
                                 f"served {r.gate_e[gi, ti].tolist()}")
        yi = torch.zeros(d, dtype=torch.float64, device=device)
        for j, (e, wt) in enumerate(zip(top.tolist(), wts)):
            if not bool(entry_keep[gi, ti * k + j]):
                continue
            g = xi @ w["w_gate"][e].double()
            u = xi @ w["w_up"][e].double()
            yi += wt * ((F.silu(g) * u) @ w["w_down"][e].double())
        if cfg.n_shared:
            s = w["shared"]
            yi += (F.silu(xi @ s["w_gate"].double()) * (xi @ s["w_up"].double())) \
                @ s["w_down"].double()
        worst_fp64 = max(worst_fp64, float((y[i].double() - yi).abs().max()))
    rel_fp64 = worst_fp64 / scale
    if not rel_fp64 <= TOL_MOE_FP64:
        raise AssertionError(f"MoE vs float64 loop: rel err {rel_fp64} > "
                             f"{TOL_MOE_FP64}")
    return {"tokens": t, "groups": int(xg.shape[0]), "cap": r.cap,
            "dropped": dropped, "rel_err_vs_plain": err_plain,
            "rel_err_vs_fp64": rel_fp64, "sampled": MOE_SAMPLED}


def cache_checks(bundle, params, prompts, device) -> dict:
    """Check (c): ``prefill_cache_fn``'s logits against ``prefill_fn``'s
    within ``TOL_ZOO_CACHE`` of max|logit|, and ``decode_fn`` teacher-forced
    over the prompt within ``TOL_ZOO_DECODE``; every logit finite."""
    b, p = prompts.shape
    full = bundle.prefill_fn(params, {"tokens": prompts})
    cached, _ = bundle.prefill_cache_fn(
        params, bundle.make_cache(b, p + ZOO_GEN, torch.float32, device),
        {"tokens": prompts})
    cache = bundle.make_cache(b, p, torch.float32, device)
    rows = []
    for t in range(p):
        lg, cache = bundle.decode_fn(params, cache, {"tokens": prompts[:, t:t + 1],
                                                     "pos": t})
        rows.append(lg[:, 0])
    stepped = torch.stack(rows, dim=1)
    for name, got in (("prefill_fn", full), ("prefill_cache_fn", cached),
                      ("decode_fn", stepped)):
        if got.shape != (b, p, bundle.cfg.vocab) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{bundle.name} {name}: logits "
                                 f"{tuple(got.shape)} or non-finite")
    err_cache, err_decode = _err(cached, full)[1], _err(stepped, full)[1]
    if not err_cache <= TOL_ZOO_CACHE:
        raise AssertionError(f"{bundle.name}: prefill_cache_fn vs prefill_fn "
                             f"rel err {err_cache} > {TOL_ZOO_CACHE}")
    if not err_decode <= TOL_ZOO_DECODE:
        raise AssertionError(f"{bundle.name}: decode_fn vs prefill_fn rel err "
                             f"{err_decode} > {TOL_ZOO_DECODE}")
    return {"prefill_cache_rel_err": err_cache, "decode_rel_err": err_decode}


def _stepped(bundle, params, cache, tokens) -> tuple[torch.Tensor, dict]:
    """``decode_fn`` over ``tokens`` (B, P) from position 0, one token at
    a time: the logits rows (B, P, V) and the cache."""
    rows = []
    for t in range(tokens.shape[1]):
        lg, cache = bundle.decode_fn(params, cache, {"tokens": tokens[:, t:t + 1],
                                                     "pos": t})
        rows.append(lg[:, 0])
    return torch.stack(rows, dim=1), cache


def _check_logits(name: str, got: torch.Tensor, shape: tuple) -> None:
    if tuple(got.shape) != shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: logits {tuple(got.shape)} or non-finite")


def rwkv_layer_checks(bundle, params, toks) -> dict:
    """RWKV6's decode, layer by layer: each layer's chunked pass over the
    layer inputs of ``prefill_fn`` (teacher-forced) against the same
    layer stepped one token at a time from a zero state, its update and
    final scan state within ``TOL_ZOO_DECODE`` of their max."""
    from repro_torch.models import rwkv6
    from repro_torch.tree import tree_map

    cfg = bundle.cfg
    b, t = toks.shape
    x = params["embed"][toks]
    zero = torch.zeros((b, cfg.d_model), device=x.device)
    s0 = torch.zeros((b, cfg.n_heads, cfg.head_dim, cfg.head_dim), device=x.device)
    worst = {"update_rel_err": 0.0, "state_rel_err": 0.0}
    per_layer = []
    for l in range(cfg.layers):
        w = tree_map(lambda a: a[l], params["layers"])
        out, _, _, s = rwkv6._layer(w, x, cfg, zero, zero, s0, False, False)
        xa, xf, st, rows = zero, zero, s0, []
        for i in range(t):
            o, xa, xf, st = rwkv6._layer(w, x[:, i:i + 1], cfg, xa, xf, st, True,
                                         False)
            rows.append(o)
        errs = (_err(torch.cat(rows, dim=1) - x, out - x)[1], _err(st, s)[1])
        per_layer.append(errs[0])
        for key, err in zip(worst, errs):
            if not err <= TOL_ZOO_DECODE:
                raise AssertionError(f"{bundle.name} layer {l}: stepped vs chunked "
                                     f"{key} {err} > {TOL_ZOO_DECODE}")
            worst[key] = max(worst[key], err)
        x = out
    return {"layers": cfg.layers, **worst, "update_rel_err_by_layer": per_layer}


def _prefill_and_stepped(bundle, params, toks, device, dtype=torch.float32):
    """``prefill_fn`` and ``decode_fn`` stepped from ``make_cache`` (in
    ``dtype``) over ``toks`` (B, T): both logits, each checked for shape
    and finiteness."""
    full = bundle.prefill_fn(params, {"tokens": toks})
    stepped, _ = _stepped(bundle, params, bundle.make_cache(
        toks.shape[0], toks.shape[1], dtype, device), toks)
    shape = (*toks.shape, bundle.cfg.vocab)
    _check_logits(f"{bundle.name} prefill_fn", full, shape)
    _check_logits(f"{bundle.name} decode_fn", stepped, shape)
    return full, stepped


def _perturbed(bundle, params, toks, full, device) -> float:
    """How far a ``ZOO_PERTURB`` relative perturbation of the embedding
    moves ``prefill_fn``'s logits ``full``, relative to max|logit|."""
    noise = torch.randn(params["embed"].shape, device=device,
                        generator=torch.Generator(device=device).manual_seed(SEED + 4))
    moved = bundle.prefill_fn({**params, "embed": params["embed"] * (
        1 + ZOO_PERTURB * noise)}, {"tokens": toks})
    return _err(moved, full)[1]


def recurrent_checks(bundle, params, device) -> dict:
    """RWKV6 and Hymba: ``decode_fn`` stepped over ``ZOO_SCAN`` tokens from
    ``make_cache`` against ``prefill_fn`` over the same tokens, within
    ``TOL_ZOO_DECODE`` of max|logit|: RWKV6 on its first ``ZOO_RWKV_CUT``
    layers (each layer at full depth by ``rwkv_layer_checks``, the full
    depth end to end by ``rwkv_float64_witness``), Hymba at full depth with its window
    cut to ``ZOO_HYMBA_WINDOW``, from position ``ZOO_HYMBA_FROM`` on."""
    from repro_torch.models.registry import make_hymba_bundle, with_layers
    from repro_torch.tree import tree_map

    cfg = bundle.cfg
    toks = _recurrent_tokens(cfg, device)
    out = {"tokens": ZOO_SCAN}
    if bundle.family == "ssm":
        cut = with_layers(bundle, ZOO_RWKV_CUT)
        cut_params = {**params, "layers": tree_map(lambda a: a[:ZOO_RWKV_CUT],
                                                   params["layers"])}
        full, stepped = _prefill_and_stepped(cut, cut_params, toks, device)
        err = _err(stepped, full)[1]
        moved = _perturbed(cut, cut_params, toks, full, device)
        del full, stepped
        out.update(layers_cut=ZOO_RWKV_CUT, perturbed_rel_err=moved,
                   layers=rwkv_layer_checks(bundle, params, toks))
    else:
        start = ZOO_HYMBA_FROM
        if not cfg.layers * (ZOO_HYMBA_WINDOW - 1) <= start < ZOO_SCAN:
            raise AssertionError(f"{bundle.name}: decode agrees with prefill_fn "
                                 f"from {cfg.layers * (ZOO_HYMBA_WINDOW - 1)}, "
                                 f"not from {start} of {ZOO_SCAN} tokens")
        cut = make_hymba_bundle(dataclasses.replace(cfg, window=ZOO_HYMBA_WINDOW))
        full, stepped = _prefill_and_stepped(cut, params, toks, device)
        err = _err(stepped[:, start:], full[:, start:])[1]
        out.update(window=ZOO_HYMBA_WINDOW, start=start,
                   zero_key_rel_err=_err(stepped[:, :start], full[:, :start])[1])
        del full, stepped
    if not err <= TOL_ZOO_DECODE:
        raise AssertionError(f"{bundle.name}: decode_fn over {ZOO_SCAN} tokens vs "
                             f"prefill_fn rel err {err} > {TOL_ZOO_DECODE}")
    out["decode_rel_err"] = err
    return out


def _recurrent_tokens(cfg, device) -> torch.Tensor:
    return torch.randint(0, cfg.vocab, (ZOO_BATCH, ZOO_SCAN),
                         generator=torch.Generator().manual_seed(SEED + 2)
                         ).to(device)


def rwkv_float64_witness(cfg, params, device) -> dict:
    """RWKV6 at full depth, end to end: ``prefill_fn`` and ``decode_fn``
    over ``ZOO_SCAN`` tokens in fp32, then ``params`` turned to float64
    in place, leaf by leaf (each fp32 leaf freed as its copy is made), and
    both again in float64.  The float64 decode is held to the float64
    prefill within ``TOL_ZOO_DECODE`` of max|logit|; beside it how far
    the fp32 runs lie from each other, from the float64 prefill, and how
    far a ``ZOO_PERTURB`` perturbation of the embedding moves the fp32
    prefill (readings, not held), and the witness's peak memory."""
    from repro_torch.models.registry import make_rwkv_bundle

    bundle = make_rwkv_bundle(cfg)
    toks = _recurrent_tokens(cfg, device)
    full32, stepped32 = _prefill_and_stepped(bundle, params, toks, device)
    out = {"layers": cfg.layers, "tokens": ZOO_SCAN,
           "fp32_decode_rel_err": _err(stepped32, full32)[1],
           "fp32_perturbed_rel_err": _perturbed(bundle, params, toks, full32, device)}

    def to_float64(tree):
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                to_float64(leaf)
            else:
                tree[key] = leaf.double()
                del leaf

    to_float64(params)
    _empty_cache(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    full, stepped = _prefill_and_stepped(bundle, params, toks, device, torch.float64)
    if full.dtype != torch.float64:
        raise AssertionError(f"{cfg.name} in float64: logits in {full.dtype}")
    err = _err(stepped, full)[1]
    out.update(decode_rel_err=err, fp32_prefill_vs_fp64=_err(full32, full)[1],
               fp32_decode_vs_fp64=_err(stepped32, full)[1],
               peak_device_bytes=torch.cuda.max_memory_allocated(device)
               if device.type == "cuda" else None)
    if not err <= TOL_ZOO_DECODE:
        raise AssertionError(f"{cfg.name} in float64: decode_fn over {ZOO_SCAN} "
                             f"tokens vs prefill_fn rel err {err} > {TOL_ZOO_DECODE}")
    return out


def whisper_checks(bundle, params, prompts, frames, device) -> tuple[torch.Tensor, dict]:
    """Whisper: ``prefill_fn`` over ``frames`` and ``prompts``, then
    ``decode_fn`` teacher-forced over the prompts from a cache whose cross
    K/V ``precompute_cross_kv(encode(frames))`` filled, within
    ``TOL_ZOO_DECODE`` of max|logit|.  Returns the prefill's logits too."""
    from repro_torch.models import whisper

    full = bundle.prefill_fn(params, {"frames": frames, "tokens": prompts})
    cache = whisper.precompute_cross_kv(
        params, bundle.cfg, whisper.encode(params, bundle.cfg, frames),
        bundle.make_cache(prompts.shape[0], prompts.shape[1], torch.float32, device))
    stepped, _ = _stepped(bundle, params, cache, prompts)
    shape = (*prompts.shape, bundle.cfg.vocab)
    _check_logits(f"{bundle.name} prefill_fn", full, shape)
    _check_logits(f"{bundle.name} decode_fn", stepped, shape)
    err = _err(stepped, full)[1]
    if not err <= TOL_ZOO_DECODE:
        raise AssertionError(f"{bundle.name}: decode_fn over the encoder's cross "
                             f"K/V vs prefill_fn rel err {err} > {TOL_ZOO_DECODE}")
    return full, {"frames": list(frames.shape), "decode_rel_err": err}


def decode_profile(bundle, params, prompts, device, captured: bool,
                   steps: int = 4) -> dict:
    """Decode steps after the prompt (a cache-filling prefill, or
    ``decode_fn`` stepped over it), eager or replayed from the captured
    decode step (``launch.steps.compiled_decode``, as ``serve_lm`` runs
    it): one step first (the capture, or an eager warm-up), then ``steps``
    steps timed on the host's clock, synchronised (``wall_ms`` a step),
    then ``steps`` more under ``torch.profiler``: their wall ms a step, the
    device busy ms a step (the sum of the kernels' device time), the
    kernels a step and the three kernels that take the most time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.graphs import GraphSet
    from repro_torch.launch import steps as steps_mod

    b, p = prompts.shape
    max_len = p + 1 + 2 * steps
    gs = GraphSet("decode_profile", device) if captured else None
    decode = steps_mod.compiled_decode(bundle, gs, max_len, device)
    cache = bundle.make_cache(b, max_len, torch.float32, device)
    if bundle.prefill_cache_fn is not None:
        _, cache = bundle.prefill_cache_fn(params, cache, {"tokens": prompts})
    else:
        _, cache = _stepped(bundle, params, cache, prompts)
    tok = prompts[:, -1:]

    def run(positions):
        nonlocal tok
        for t in positions:
            tok = decode(params, cache, tok, t)[:, -1].argmax(dim=-1, keepdim=True)

    run([p])
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    run(range(p + 1, p + 1 + steps))
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(range(p + 1 + steps, max_len))
        torch.cuda.synchronize(device)
        profiled = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        t = float(t if t is not None else ev.self_cuda_time_total)
        if t > 0:
            rows.append((t / 1e3 / steps, ev.key, ev.count / steps))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    return {"steps": steps, "captured": captured, "wall_ms": wall * 1e3 / steps,
            "profiled_wall_ms": profiled * 1e3 / steps,
            "device_busy_ms": busy or None,
            "kernels_a_step": sum(r[2] for r in rows),
            "capture_s": gs.capture_s if captured else None,
            "top": [{"name": k[:80], "ms": t, "calls": c} for t, k, c in rows[:3]]}


def zoo_routes(bundle, sq: int, sk: int) -> dict:
    """The serving route's attention at a prefill of ``sq`` queries over
    ``sk`` keys (a transformer's cache, or the prompt itself), layer by
    layer: how many attention calls take each route.  RWKV6 has none."""
    from repro_torch.models import transformer as lm

    cfg = bundle.cfg
    routes: dict = {}

    def add(route, n=1):
        routes[route] = routes.get(route, 0) + n

    if bundle.family in ("lm", "vlm"):
        dv = cfg.mla.v_dim if cfg.attn == "mla" else cfg.head_dim
        for key, _, n, _, offset in lm._stacks(cfg):
            for window in lm._layer_windows(cfg, n, offset):
                add(lm.attend_route(sq, sk, cfg.q_dim, dv, window=window,
                                    attn_softcap=cfg.attn_softcap, start=0,
                                    flash_chunk=cfg.flash_chunk))
    elif bundle.family == "hybrid":
        d = cfg.head_dim
        add(lm.attend_route(sq, sk, d, d, window=cfg.window, start=0,
                            flash_chunk=cfg.flash_chunk), cfg.layers)
    elif bundle.family == "encdec":
        d, e, fc = cfg.head_dim, cfg.enc_len, cfg.flash_chunk
        add(lm.attend_route(e, e, d, d, flash_chunk=fc, causal=False), cfg.enc_layers)
        add(lm.attend_route(sq, sk, d, d, start=0, flash_chunk=fc), cfg.dec_layers)
        add(lm.attend_route(sq, e, d, d, flash_chunk=fc, causal=False), cfg.dec_layers)
    return routes


def _launches(counters) -> dict:
    return {c.name: c.count for c in counters}


def _reset(counters) -> None:
    for c in counters:
        c.reset()


def zoo_arch(arch: str, layers, device, counters, card: str,
             smoke: bool = False, graphs=True) -> dict:
    """One arch of the zoo: weights drawn on the card from a seeded CUDA
    generator, ``serve_lm`` (the serve CLI's LM entry point) over
    ``ZOO_BATCH`` prompts of ``ZOO_PROMPT`` tokens and ``ZOO_GEN`` new
    tokens, with the launch counts zeroed just before and read just after,
    then the checks.  ``serve_lm`` runs twice from the same weights: with
    ``graphs`` (its captured decode and prefill; the default) and eagerly,
    their tokens equal and every prefill and decode call's logits
    ``torch.equal``, at most two captures; the decode's ms a step eager
    and replayed beside its device busy ms (``decode_profile``).  A family without a cache-filling prefill (RWKV6,
    Hymba, Whisper) steps ``decode_fn`` over the prompt in ``serve_lm``,
    which launches no K4; its K4 launches are read around one
    ``prefill_fn`` over the same prompts (Whisper's with random frames)
    as well.  Returns its readings, params and config.  ``smoke`` runs
    the smoke config (a rehearsal on the CPU, where no kernel launch is
    counted and no memory peak read; its checks run an MoE config with the
    full config's dispatch groups; ``graphs`` a graph class that captures
    there, such as the tests' emulator)."""
    from repro_torch.configs import get_bundle
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models.registry import with_layers
    from repro_torch.tree import tree_leaves

    from repro_torch.models.registry import make_lm_bundle

    card_run = device.type == "cuda"
    t_arch = time.perf_counter()
    layers = None if smoke else layers
    bundle = get_bundle(arch, smoke=smoke)
    if layers is not None:
        bundle = with_layers(bundle, layers)
    if smoke and getattr(bundle.cfg, "moe", None) is not None:
        # the full config's dispatch groups, so that no entry can drop in
        # the checks, as at full width (the served smoke run keeps 1)
        moe = dataclasses.replace(bundle.cfg.moe, dispatch_groups=get_bundle(
            arch).cfg.moe.dispatch_groups)
        bundle = make_lm_bundle(dataclasses.replace(bundle.cfg, moe=moe))
    cfg = bundle.cfg
    cached = bundle.prefill_cache_fn is not None
    _empty_cache(device)
    if card_run:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device=device).manual_seed(SEED),
                         torch.float32, device)
    _sync(device)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tree_leaves(params))
    specs = spec_checks(bundle, params)
    # serve_lm captured (as it runs by default on the card), then eagerly
    # from the same weights and prompts; the launch counts around each
    served = []
    for run_graphs in (graphs, False):
        _reset(counters)
        timings, rows = {}, []
        toks = serve_lm(arch, batch=ZOO_BATCH, prompt_len=ZOO_PROMPT,
                        gen=ZOO_GEN, smoke=smoke, layers=layers, seed=SEED,
                        device=device, params=params, timings=timings,
                        graphs=run_graphs, on_logits=rows.append)
        served.append((toks, rows, timings, _launches(counters)))
    (toks, rows, timings, launches), (toks_e, rows_e, timings_e, launches_e) = served
    if toks.shape != (ZOO_BATCH, ZOO_GEN):
        raise AssertionError(f"{arch}: served tokens {tuple(toks.shape)}")
    if not torch.equal(toks, toks_e):
        raise AssertionError(f"{arch}: captured tokens differ from eager's in "
                             f"{int((toks != toks_e).sum())} of {toks.numel()}")
    diffs = [float((a - b).abs().max()) for a, b in zip(rows, rows_e)
             if not torch.equal(a, b)]
    if len(rows) != len(rows_e) or diffs:
        raise AssertionError(
            f"{arch}: {len(diffs)} of {len(rows)} captured logits calls differ "
            f"from eager's ({len(rows_e)} calls), largest difference "
            f"{max(diffs, default=0.0):.3e}")
    # None: nothing captured, as on the CPU unless ``graphs`` is a class
    graph_stats = timings.pop("graphs", None)
    if graph_stats is None and card_run:
        raise AssertionError(f"{arch}: serve_lm captured nothing on the card")
    if graph_stats is not None and sum(graph_stats["captures"].values()) > 2:
        raise AssertionError(f"{arch}: captures {graph_stats['captures']} > 2")
    routes = zoo_routes(bundle, ZOO_PROMPT,
                        ZOO_PROMPT + ZOO_GEN if cached else ZOO_PROMPT)
    prompts = torch.randint(0, cfg.vocab, (ZOO_BATCH, ZOO_PROMPT),
                            generator=torch.Generator().manual_seed(SEED + 1)
                            ).to(device)
    k4_routes = routes.get("k4", 0) if card_run else 0
    # K4 runs inside the captured prefill: the warm-up launches it, the
    # graph holds it and counts it once per replay (one replay here)
    k4_prefill = k4_routes if cached else 0
    k4_held = (k4_prefill if graph_stats is None else
               graph_stats["held"].get("prefill", {}).get("flash_attention", 0))
    if (launches_e["flash_attention"] != k4_prefill or k4_held != k4_prefill
            or launches["flash_attention"] != 2 * k4_prefill):
        raise AssertionError(
            f"{arch}: K4 launched {launches['flash_attention']} times serving "
            f"captured ({k4_held} held by the prefill graph), "
            f"{launches_e['flash_attention']} eagerly; the routes say {routes}")
    out = {"arch": arch, "family": bundle.family,
           "layers": cfg.layers if bundle.family != "encdec"
           else cfg.enc_layers + cfg.dec_layers, "d_model": cfg.d_model,
           "params": n_params, "param_bytes": 4 * n_params, "init_s": init_s,
           "specs": specs,
           **timings, "graphs": graph_stats, "eager": timings_e,
           "logits_calls_equal": len(rows), "routes": routes,
           "launches": launches, "launches_eager": launches_e,
           "decode_profile": decode_profile(bundle, params, prompts, device, False)
           if card_run else None,
           "decode_profile_captured": decode_profile(bundle, params, prompts,
                                                     device, True)
           if card_run else None}
    if cached:
        out["checks"] = cache_checks(bundle, params, prompts, device)
    else:
        batch = {"tokens": prompts}
        if bundle.family == "encdec":
            batch["frames"] = torch.randn(
                (ZOO_BATCH, cfg.enc_len, cfg.d_model), device=device,
                generator=torch.Generator(device=device).manual_seed(SEED + 3))
        _sync(device)
        _reset(counters)
        t0 = time.perf_counter()
        if bundle.family == "encdec":
            logits, out["checks"] = whisper_checks(bundle, params, prompts,
                                                   batch["frames"], device)
        else:
            logits = bundle.prefill_fn(params, batch)
        _sync(device)
        out["prefill_fn_s"] = time.perf_counter() - t0
        out["prefill_launches"] = _launches(counters)
        _check_logits(f"{arch} prefill_fn", logits, (ZOO_BATCH, ZOO_PROMPT, cfg.vocab))
        if out["prefill_launches"]["flash_attention"] != k4_routes:
            raise AssertionError(
                f"{arch}: K4 launched {out['prefill_launches']['flash_attention']} "
                f"times in prefill_fn, the routes say {routes}")
        del logits, batch
        if bundle.family != "encdec":
            out["checks"] = recurrent_checks(bundle, params, device)
    if getattr(cfg, "moe", None) is not None:
        out["moe"] = moe_checks(bundle, params, prompts, device,
                                expect_no_drops=not smoke)
    if bundle.family == "vlm":
        prefix = torch.randn((ZOO_BATCH, ZOO_PREFIX, cfg.d_model),
                             generator=torch.Generator(device=device).manual_seed(SEED),
                             device=device)
        _sync(device)
        t0 = time.perf_counter()
        logits = bundle.prefill_fn(params, {"tokens": prompts, "prefix": prefix})
        _sync(device)
        if (logits.shape != (ZOO_BATCH, ZOO_PREFIX + ZOO_PROMPT, cfg.vocab)
                or not bool(torch.isfinite(logits).all())):
            raise AssertionError(f"{arch} with its prefix: logits "
                                 f"{tuple(logits.shape)} or non-finite")
        out["prefix"] = {"shape": [ZOO_BATCH, ZOO_PREFIX, cfg.d_model],
                         "prefill_s": time.perf_counter() - t0}
        del logits
    out["peak_device_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if card_run else None)
    out["seconds"] = time.perf_counter() - t_arch
    out["card"] = card
    return out, params, cfg


def _zoo_line(z: dict) -> str:
    c = z["checks"]
    if "prefill_cache_rel_err" in c:
        checks = (f"prefill_cache_fn vs prefill_fn {c['prefill_cache_rel_err']:.2e} "
                  f"<= {TOL_ZOO_CACHE}, decode_fn {c['decode_rel_err']:.2e} "
                  f"<= {TOL_ZOO_DECODE}")
    elif "frames" in c:
        checks = (f"prefill_fn over {c['frames']} frames in {z['prefill_fn_s']:.3f} "
                  f"s (launches {z['prefill_launches']}); decode_fn over "
                  f"precompute_cross_kv(encode(frames)) vs prefill_fn "
                  f"{c['decode_rel_err']:.2e} <= {TOL_ZOO_DECODE}")
    else:
        checks = (f"prefill_fn in {z['prefill_fn_s']:.3f} s (launches "
                  f"{z['prefill_launches']}); decode_fn over {c['tokens']} tokens "
                  f"vs prefill_fn ")
        if "layers" in c:
            lc = c["layers"]
            checks += (f"at {c['layers_cut']} layers {c['decode_rel_err']:.2e} <= "
                       f"{TOL_ZOO_DECODE} (a {ZOO_PERTURB} perturbation of the "
                       f"embedding moves prefill_fn {c['perturbed_rel_err']:.2e})"
                       f"; each of {lc['layers']} layers teacher-forced, stepped vs "
                       f"chunked: update {lc['update_rel_err']:.2e}, scan state "
                       f"{lc['state_rel_err']:.2e} <= {TOL_ZOO_DECODE}")
        else:
            checks += (f"with the window cut to {c['window']}, from position "
                       f"{c['start']} {c['decode_rel_err']:.2e} <= {TOL_ZOO_DECODE} "
                       f"(before it, over zero keys, {c['zero_key_rel_err']:.2e}, "
                       f"not held)")
    prompt = "prefill" if "prefill_cache_rel_err" in c else "prompt stepped"
    return (f"{z['arch']} ({z['layers']} layers, d_model {z['d_model']}, "
            f"{z['params'] / 1e9:.3f} B params, {z['param_bytes'] / 1e9:.2f} GB "
            f"fp32): init {z['init_s']:.2f} s, {prompt} "
            f"{ZOO_BATCH} x {ZOO_PROMPT} in {z['prefill_s']:.3f} s, decode "
            f"{z['tok_s']:.1f} tok/s, peak {_gib(z['peak_device_bytes'])}, "
            f"{z['seconds']:.1f} s in all; attention routes {z['routes']}; "
            f"launches {z['launches']}; {checks}")


def _gib(nbytes) -> str:
    return "not measured" if nbytes is None else f"{nbytes / 2**30:.2f} GiB"


def _ms(t) -> str:
    return "not measured" if t is None else f"{t:.4f}"


def zoo_phase(device, counters, card: str, smoke: bool = False,
              graphs=True) -> dict:
    """The arch zoo, one arch at a time, each freed before the next, each
    through ``serve_lm`` captured and eagerly (``zoo_arch``):
    DeepSeek-V2-236B at full width (1 dense-first + 2 MoE layers) with the
    MoE checks; Qwen3-4B at full width and depth through ``serve_lm``, then
    served coded on the device pool's LM plan (the SmolLM plan, phase 7's
    requests) with phase 8's check and K2-K4 at its shapes; CodeQwen1.5-7B,
    Gemma2-9B (one local, one global layer) and PaliGemma-3B (with its
    256 x 2048 stub prefix) at 2 layers; RWKV6-1.6B, Hymba-1.5B and
    Whisper-medium at full width and depth, their prompts stepped by
    ``decode_fn`` in ``serve_lm``, held by ``recurrent_checks`` /
    ``whisper_checks``; SmolLM-135M at full width and depth; K4 at
    Qwen3's, CodeQwen's, Hymba's (rep 5) and Whisper's decoder's prefill
    shapes.  ``smoke`` runs the smoke configs (a rehearsal on the CPU,
    untimed, with ``graphs`` a graph class that captures there)."""
    out: dict = {"archs": [], "graphs": {}, "kernels": {
        name: [] for name in ("matmul", "coded_gemm", "coded_gemm_encode",
                              "flash_attention", "flash_attention_bf16")}}
    by_path: dict = {}
    timed = device.type == "cuda"
    for arch, layers in ZOO:
        z, params, cfg = zoo_arch(arch, layers, device, counters, card, smoke,
                                  graphs)
        print(_zoo_line(z))
        if z["family"] == "ssm":
            w = z["checks"]["float64"] = rwkv_float64_witness(cfg, params, device)
            print(f"  {arch} at {w['layers']} layers in float64 (weights "
                  f"{8 * z['params'] / 1e9:.2f} GB, peak "
                  f"{_gib(w['peak_device_bytes'])}): decode_fn over {w['tokens']} "
                  f"tokens vs prefill_fn {w['decode_rel_err']:.2e} <= "
                  f"{TOL_ZOO_DECODE}; in fp32 decode_fn vs prefill_fn "
                  f"{w['fp32_decode_rel_err']:.2e}, prefill_fn vs float64's "
                  f"{w['fp32_prefill_vs_fp64']:.2e}, decode_fn vs float64's "
                  f"prefill_fn {w['fp32_decode_vs_fp64']:.2e}, a {ZOO_PERTURB} "
                  f"perturbation of the embedding moves prefill_fn "
                  f"{w['fp32_perturbed_rel_err']:.2e} (readings, not held)")
        if "moe" in z:
            m = z["moe"]
            print(f"  MoE layer 1 on its real activations ({m['tokens']} tokens "
                  f"in {m['groups']} dispatch groups, cap {m['cap']}): gather vs "
                  f"plain rel err {m['rel_err_vs_plain']:.2e} <= {TOL_MOE_PLAIN}, "
                  f"vs a float64 loop over {m['sampled']} sampled tokens "
                  f"{m['rel_err_vs_fp64']:.2e} <= {TOL_MOE_FP64}, the expert "
                  f"choices equal; dropped entries {m['dropped']}")
        g, e = z["graphs"], z["eager"]
        graphs_read = ("nothing captured" if g is None else
                       f"captures {g['captures']} (<= 2) in "
                       f"{g['capture_s']:.3f} s, replays {g['replays']}")
        print(f"  serve_lm captured against eager: tokens equal, "
              f"{z['logits_calls_equal']} prefill and decode calls' logits "
              f"torch.equal; {graphs_read}; decode "
              f"{z['tok_s']:.1f} tok/s captured (capture included) against "
              f"{e['tok_s']:.1f} eager, prompt {z['prefill_s']:.3f} s against "
              f"{e['prefill_s']:.3f} s; launches eager {z['launches_eager']}")
        for dp in (z["decode_profile"], z["decode_profile_captured"]):
            if dp is None:
                continue
            busy = dp["device_busy_ms"]
            print(f"  {'captured' if dp['captured'] else 'eager'} decode "
                  f"({dp['steps']} steps): {dp['wall_ms']:.2f} ms a step "
                  f"({dp['profiled_wall_ms']:.2f} profiled), device busy "
                  f"{_ms(busy)} ms in {dp['kernels_a_step']:.0f} kernels"
                  + ("" if dp["capture_s"] is None else
                     f", capture {dp['capture_s']:.3f} s")
                  + "; most time: " + "; ".join(
                      f"{k['name'][:50]} {k['ms']:.3f} ms x{k['calls']:.0f}"
                      for k in dp["top"]))
        if "prefix" in z:
            print(f"  prefill_fn with a {z['prefix']['shape']} stub prefix: "
                  f"{z['prefix']['prefill_s']:.3f} s, logits finite")
        by_path[f"zoo_{arch}"] = z["launches"]
        by_path[f"zoo_{arch}_eager"] = z["launches_eager"]
        out["graphs"][arch] = z["graphs"]
        if "prefill_launches" in z:
            by_path[f"zoo_{arch}_prefill_fn"] = z["prefill_launches"]
        if arch == "qwen3-4b":
            out["qwen3_coded"] = zoo_qwen3_coded(params, cfg, device, counters,
                                                 card, out["kernels"], by_path)
        # SmolLM's prefill shape is the LM kernel phase's (BH 36, S 16,
        # D 64, rep 3), held there
        if arch in ("qwen3-4b", "codeqwen1.5-7b", "hymba-1.5b", "whisper-medium"):
            gen = torch.Generator(device=device).manual_seed(SEED + 7)
            h, d = cfg.n_heads, cfg.head_dim
            rep = h // getattr(cfg, "n_kv_heads", h)
            e = flash_entry(ZOO_BATCH * h, ZOO_PROMPT, d, rep, z["routes"]["k4"],
                            torch.float32, gen, device, TOL_K4, timed)
            path = ("serve_lm captured prefill" if "prefill_launches" not in z
                    else "prefill_fn")
            out["kernels"]["flash_attention"].append(
                {"arch": arch, "path": path, **e})
            print(f"  K4 at {arch}'s prefill {e['q']} rep {e['rep']}: "
                  f"{_ms(e['ms'])} ms, device {_ms(e['device_ms'])}, plain "
                  f"{_ms(e['plain_ms'])}, SDPA {_ms(e['library_ms'])} / device "
                  f"{_ms(e['library_device_ms'])}, bound {e['bound_ms']:.5f} by "
                  f"{e['bound_by']}; rel err {e['max_rel_err']:.2e} <= {TOL_K4}")
        out["archs"].append(z)
        del params
        _empty_cache(device)
    out["by_path"] = by_path
    return out


def zoo_qwen3_coded(params, cfg, device, counters, card, kernels, by_path) -> dict:
    """Qwen3-4B at full width and depth served coded: the device pool's LM
    plan (n=4, k_b=4), phase 7's requests under phase 7's stragglers, the
    served logits rows held as phase 8 holds SmolLM's (check (d)); K2, K3
    and K4 at its shapes against their plain versions, timed on the card.
    On the CPU (a rehearsal) the glue runs eagerly and nothing is timed."""
    card_run = device.type == "cuda"
    t0 = time.perf_counter()
    pipe, _ = build_lm(device, cfg, params=params)
    build_s = time.perf_counter() - t0
    bucket = pipe.max_batch
    lm_k = lm_kernel_phase(pipe, bucket, device, timed=card_run)
    for name, entries in lm_k.items():
        sm = lm_kernel_summary(entries) if card_run else {}
        kernels[name].append({"arch": cfg.name, "path": "coded LM", **sm,
                              "shapes": entries})
        if card_run:
            print(f"  {name} at {cfg.name}'s coded shapes: {sm['ms']:.4f} ms a "
                  f"decode step's shapes with host issue, {sm['device_ms']:.4f} "
                  f"ms device (plain {sm['plain_ms']:.4f}, library "
                  f"{sm['library_ms']:.4f} / device {sm['library_device_ms']:.4f}, "
                  f"bound {sm['bound_ms']:.5f} by {sm['bound_by']}), max rel err "
                  f"{sm['max_rel_err']:.2e}")
    requests = lm_requests(cfg.vocab)
    outs, rows, lat, server, wall, launches, graphs = lm_serving_phase(
        pipe, requests, counters, pool="device", graphs=card_run)
    if card_run:
        for name in ("matmul", "coded_gemm", "flash_attention"):
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} never launched serving "
                                     f"{cfg.name}")
    check = check_lm_served(pipe, params, requests, outs, rows, device)
    toks = sum(len(o) for o in outs)
    peak = torch.cuda.max_memory_allocated(device) if card_run else None
    by_path["zoo_qwen3-4b_coded"] = launches
    print(f"  {cfg.name} served coded on the device pool (n={LM_N}, k_b={LM_KB}, "
          f"worker 2 +{STRAGGLER_DELAY_S * 1e3:.0f} ms, worker 3 dead) on {card}: "
          f"{len(outs)} requests, {toks} tokens, {toks / wall:.2f} tok/s over "
          f"{wall:.2f} s, e2e p50 {np.percentile(lat, 50) * 1e3:.1f} ms, p99 "
          f"{np.percentile(lat, 99) * 1e3:.1f} ms; build {build_s:.1f} s, "
          f"{pipe.weight_encode_calls} weight encodes; served logits vs the "
          f"undistributed model {check['max_rel_err']:.2e} <= {TOL_LM}, "
          f"{check['tokens_equal']} of {check['tokens']} tokens its argmax "
          f"outright; peak {_gib(peak)}; launches {launches}")
    if graphs is not None:
        print(_graph_line(graphs))
    out = {"requests": len(outs), "tokens": toks, "tok_s": toks / wall,
           "wall_s": wall, "e2e_p50_s": float(np.percentile(lat, 50)),
           "e2e_p99_s": float(np.percentile(lat, 99)), "build_s": build_s,
           "max_rel_err": check["max_rel_err"], "tokens_equal": check["tokens_equal"],
           "launches": launches, "graphs": graphs, "peak_device_bytes": peak}
    del pipe, server, rows, check
    _empty_cache(device)
    return out


# -- the examples and the sharding specs ------------------------------------
EXAMPLES = ("quickstart", "coded_cnn_inference", "coded_serving",
            "coded_lm_layer", "serve_decode", "train_smollm")


def examples_phase(device, counters) -> dict:
    """The port's six examples (``python -m repro_torch.examples.<name>``),
    each run in-process through its ``main`` on ``device`` at its
    defaults, its own check raising where it fails, its printed lines kept
    apart; the launch counts zeroed just before each and read just after.
    Returns per example its seconds, its check's number and launches."""
    import contextlib
    import importlib
    import io

    out = {}
    for name in EXAMPLES:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        _reset(counters)
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            res = mod.main(["--device", str(device)])
        _sync(device)
        seconds = time.perf_counter() - t0
        if name in ("quickstart", "coded_lm_layer"):
            check = {"max_abs_err": res["max_abs_err"], "tol": mod.TOL}
        elif name in ("coded_cnn_inference", "coded_serving"):
            check = {"rel_err_vs_uncoded": res["rel_err"], "tol": mod.TOL}
        elif name == "serve_decode":
            check = {"arch": res["arch"], "tokens": list(res["tokens"].shape),
                     "request0": res["request0"][:8]}
        else:
            check = {"first_loss": res["first_loss"],
                     "last_loss": res["last_loss"], "steps": res["steps"]}
        out[name] = {"seconds": seconds, "check": check,
                     "launches": _launches(counters),
                     "last_line": printed.getvalue().strip().splitlines()[-1]}
    return out


def spec_checks(bundle, params) -> dict:
    """The schema against the params drawn from it on the card, with no
    new allocation: ``count_params`` equal to their numel, and
    ``param_shapes`` (meta tensors) equal to their shapes and dtypes leaf
    for leaf."""
    from repro_torch.models.common import count_params
    from repro_torch.tree import tree_items

    n = count_params(bundle.schema)
    drawn = tree_items(params)
    numel = sum(t.numel() for _, t in drawn)
    meta = tree_items(bundle.param_shapes(torch.float32))
    same = ([(p, tuple(t.shape), t.dtype) for p, t in meta]
            == [(p, tuple(t.shape), t.dtype) for p, t in drawn])
    if n != numel or not same:
        raise AssertionError(f"{bundle.name}: count_params {n}, numel {numel}; "
                             f"param_shapes equal to the drawn tree: {same}")
    return {"count_params": n, "leaves": len(drawn)}


def specs_phase() -> dict:
    """``count_params`` of every arch id at its full config (DeepSeek-V3's
    671 B included: no run on the card holds it), and how many leaves
    shard over ``model`` on the (16, 16) production mesh and over the data
    axes with FSDP on (2, 16, 16).  Shapes only: nothing is allocated."""
    from repro_torch.configs import ARCH_IDS, get_bundle
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.common import count_params, schema_pspecs
    from repro_torch.tree import tree_items

    pod, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    out = {}
    for arch in ARCH_IDS:
        schema = get_bundle(arch).schema
        model = [p for _, p in tree_items(schema_pspecs(schema, pod))]
        fsdp = [p for _, p in tree_items(schema_pspecs(schema, multi, True))]
        out[arch] = {"count_params": count_params(schema), "leaves": len(model),
                     "model_sharded_16x16": sum("model" in p for p in model),
                     "fsdp_data_sharded_2x16x16": sum(
                         ("pod", "data") in p for p in fsdp)}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this proof "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels.coded_gemm.kernel import launches as k3_launches
    from repro_torch.kernels.conv2d.kernel import launches as k1_launches
    from repro_torch.kernels.flash_attn.kernel import launches as k4_launches
    from repro_torch.kernels.matmul.kernel import launches as k2_launches
    from repro_torch.kernels.native import build_library, load_library

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _, log = build_library()
    load_library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())

    # -- the training path, first: a training job is a process of its own,
    # so it runs before the serving phases start their threads ----------
    tr = train_phase(device, (k1_launches, k2_launches, k3_launches,
                              k4_launches), card)
    _empty_cache(device)
    print_train(tr, card)

    # -- the coded CNN path -------------------------------------------------
    server, params = build_server(device, HW)
    pipe = server.pipeline
    t0 = time.perf_counter()
    kernels = kernel_phase(pipe, BUCKET, device)
    print(f"kernel phase: {time.perf_counter() - t0:.1f} s")
    for k in kernels:
        print(f"  {k['name']}: {k['ms']:.4f} ms per pass of its serving shapes "
              f"with host issue, {k['device_ms']:.4f} ms device (plain "
              f"{k['plain_ms']:.4f}, library {k['library_ms']:.4f} / device "
              f"{k['library_device_ms']:.4f}, bound {k['bound_ms']:.4f} by "
              f"{k['bound_by']}), max rel err {k['max_rel_err']:.2e} <= "
              f"{k['tol']} vs plain, {k['library_rel_err']:.2e} vs library")
        for e in k["shapes"]:
            print(f"    {json.dumps(e)}")

    xs = np.random.default_rng(SEED).standard_normal(
        (N_REQUESTS,) + pipe.input_shape).astype(np.float32)
    t0 = time.perf_counter()
    outs, stats, launches, graphs_t = serving_phase(server, xs,
                                                    (k1_launches, k2_launches))
    print(f"serving phase: {time.perf_counter() - t0:.1f} s (warmup included)")
    check_launched_shapes(pipe, BUCKET)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} never launched while serving")
    worst = check_served(outs, xs, params, device)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    print(f"served {stats.completed} {ARCH} {HW}x{HW} requests on n={N_WORKERS} "
          f"workers (2 stragglers +{STRAGGLER_DELAY_S * 1e3:.0f} ms, 1 dead), "
          f"fused transitions, depth 2, on {card}: "
          f"{stats.images_per_s:.2f} img/s, e2e p50 {stats.e2e_p50_s * 1e3:.1f} "
          f"ms, p99 {stats.e2e_p99_s * 1e3:.1f} ms; max rel err vs uncoded "
          f"{worst:.2e} <= {TOL_SERVE}; launches {launches}")
    ov = server.overlap_stats()
    print(f"round phases over {ov.rounds} rounds (s): dispatch {ov.dispatch_s:.4f}, "
          f"worker {ov.worker_s:.4f}, collect {ov.collect_s:.4f}, transition "
          f"{ov.transition_s:.4f}; busy wall {ov.busy_wall_s:.4f}, overlap "
          f"efficiency {ov.overlap_efficiency:.3f}, max depth {ov.max_depth}")
    print(_graph_line(graphs_t))
    del server, pipe, outs
    gc.collect()
    torch.cuda.empty_cache()
    by_path = {"train": tr["launches"], "train_eager": tr["eager"]["launches"],
               "cnn_threads": launches}
    graph_phases = {"cnn_threads": graphs_t}

    # -- the same CNN server on the device pool ------------------------------
    server_d, _ = build_server(device, HW, pool="device")
    t0 = time.perf_counter()
    outs_d, stats_d, launches_d, graphs_d = serving_phase(
        server_d, xs, (k1_launches, k2_launches))
    print(f"device-pool serving phase: {time.perf_counter() - t0:.1f} s "
          f"(warmup included)")
    for name, count in launches_d.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} never launched on the device pool")
    by_path["cnn_device"] = launches_d
    worst_d = check_served(outs_d, xs, params, device)
    ov_d = server_d.overlap_stats()
    print(f"served {stats_d.completed} {ARCH} {HW}x{HW} requests on the device "
          f"pool (stragglers as delayed dispatch, 1 dead) on {card}: max rel err "
          f"vs uncoded {worst_d:.2e} <= {TOL_SERVE}; launches {launches_d}; "
          f"both pools:")
    print(_pool_line("threads", stats, ov))
    print(_pool_line("device", stats_d, ov_d))
    print(_graph_line(graphs_d))
    graph_phases["cnn_device"] = graphs_d
    t0 = time.perf_counter()
    same = pools_bit_identical(
        server_d.pipeline, device,
        variants=[(g, False, pool) for pool in ("threads", "device")
                  for g in (False, True)] + [(True, True, "device")])
    print(f"forced survivors {same['survivors']}, batch {same['batch']}: "
          f"{', '.join(same['runs'])} bit-identical: eager and replayed "
          f"graphs on both pools ({time.perf_counter() - t0:.1f} s)")
    wr = same["workers"]
    print(f"  worker graphs ({wr['pool']} pool, forced batch): per worker "
          f"{wr['worker_graphs']} <= {wr['worker_bound']}; replays "
          f"{wr['worker_replays']}; capture {wr['capture_s']:.2f} s; graph "
          f"pools {wr['pool_bytes']} bytes, static inputs "
          f"{wr['static_bytes']} bytes")
    graph_phases["cnn_device_workers"] = wr
    http = http_phase(server_d, params, device, (k1_launches, k2_launches))
    for name, count in http["launches"].items():
        if count <= 0:
            raise AssertionError(f"kernel {name} never launched behind HTTP")
    by_path["http"] = http["launches"]
    print(f"HTTP front-end on the device pool: GET /v1/models, 1 single + "
          f"{HTTP_BATCH} batched POST /v1/infer, GET /v1/stats "
          f"({http['completed']} completed), drained in {http['wall_s']:.2f} s; "
          f"max rel err vs uncoded {http['max_rel_err']:.2e}; launches "
          f"{http['launches']}")
    del server_d, outs_d
    gc.collect()
    torch.cuda.empty_cache()
    el = elastic_phase(params, device, (k1_launches,))
    if el["launches"]["coded_worker"] <= 0:
        raise AssertionError("K1 never launched by run_layer")
    by_path["layer"] = el["launches"]
    print(f"run_layer_elastic on {el['layer']} {el['input']} with "
          f"{N_WORKERS - 1} of {N_WORKERS} workers dead: re-planned (k_a, k_b) "
          f"{el['plan']} -> {el['replanned']} in {el['elastic_s']:.2f} s, rel err "
          f"{el['elastic_rel_err']:.2e}; preloaded run_layer on "
          f"{el['preloaded_used']}: rel err {el['preloaded_rel_err']:.2e} "
          f"<= {TOL_SERVE}; launches {el['launches']}")
    del params
    torch.cuda.empty_cache()

    # -- the coded LM decode path -------------------------------------------
    t0 = time.perf_counter()
    lm_pipe, lm_params = build_lm(device)
    cfg = lm_pipe.cfg
    print(f"LM build: {cfg.name} ({cfg.layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, vocab {cfg.vocab}) on n={LM_N} "
          f"workers, k_b={LM_KB}: {time.perf_counter() - t0:.1f} s, "
          f"{lm_pipe.weight_encode_calls} weight encodes")
    bucket = lm_pipe.max_batch
    t0 = time.perf_counter()
    lm_k = lm_kernel_phase(lm_pipe, bucket, device)
    print(f"LM kernel phase: {time.perf_counter() - t0:.1f} s")
    for name, entries in lm_k.items():
        sm = lm_kernel_summary(entries)
        print(f"  {name}: {sm['ms']:.4f} ms per decode step's shapes with "
              f"host issue, {sm['device_ms']:.4f} ms device (plain "
              f"{sm['plain_ms']:.4f}, library {sm['library_ms']:.4f} / device "
              f"{sm['library_device_ms']:.4f}, bound {sm['bound_ms']:.5f} by "
              f"{sm['bound_by']}), max rel err {sm['max_rel_err']:.2e}")
        for e in entries:
            print(f"    {json.dumps(e)}")

    requests = lm_requests(cfg.vocab)
    counters = (k2_launches, k3_launches, k4_launches)
    lm_outs, lm_rows, lat, lm_server, wall, lm_launches, lm_graphs = \
        lm_serving_phase(lm_pipe, requests, counters)
    for name, count in lm_launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} never launched while serving the LM")
    check_lm_launched_shapes(lm_pipe, bucket)
    toks = sum(len(o) for o in lm_outs)
    print(f"served {len(lm_outs)} {cfg.name} requests ({toks} tokens) on "
          f"n={LM_N} workers (worker 2 +{STRAGGLER_DELAY_S * 1e3:.0f} ms, "
          f"worker 3 dead) on {card}: {toks / wall:.2f} tok/s over {wall:.2f} s "
          f"wall, {lm_server.tokens_per_second():.2f} tok/s over engine busy "
          f"time; e2e p50 {np.percentile(lat, 50) * 1e3:.1f} ms, p99 "
          f"{np.percentile(lat, 99) * 1e3:.1f} ms; {lm_server.decode_steps} "
          f"decode steps ({lm_server.decode_time_s:.3f} s), prefill "
          f"{lm_server.prefill_time_s:.3f} s; launches {lm_launches}")
    print(f"LM round phases over {lm_server.rounds} rounds (s): encode "
          f"{lm_server.round_encode_s:.4f}, to delta-th result "
          f"{lm_server.round_compute_s:.4f}, decode "
          f"{lm_server.round_decode_s:.4f}; glue and host between rounds "
          f"{lm_server.decode_time_s - lm_server.round_encode_s - lm_server.round_compute_s - lm_server.round_decode_s:.4f}")
    t0 = time.perf_counter()
    check = check_lm_served(lm_pipe, lm_params, requests, lm_outs, lm_rows,
                            device)
    assert not torch.backends.cuda.matmul.allow_tf32
    print(f"LM check: served logits vs undistributed transformer max rel err "
          f"{check['max_rel_err']:.2e} <= {TOL_LM}; {check['tokens_equal']} of "
          f"{check['tokens']} served tokens equal its argmax outright "
          f"({time.perf_counter() - t0:.1f} s)")
    by_path["lm_threads"] = lm_launches
    print(_graph_line(lm_graphs))
    graph_phases["lm_threads"] = lm_graphs

    # -- the LM on the device pool ------------------------------------------
    d_outs, d_rows, _, d_server, d_wall, d_launches, d_graphs = \
        lm_serving_phase(lm_pipe, requests, counters, pool="device")
    for name, count in d_launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} never launched serving the "
                                 f"LM on the device pool")
    if [list(o) for o in d_outs] != [list(o) for o in lm_outs]:
        raise AssertionError("device pool: served tokens differ from the "
                             "thread pool's")
    d_check = check_lm_served(lm_pipe, lm_params, requests, d_outs, d_rows,
                              device, refs=check["refs"])
    by_path["lm_device"] = d_launches
    print(f"LM on the device pool: {toks} tokens, each equal to the thread "
          f"pool's; logits max rel err {d_check['max_rel_err']:.2e} <= {TOL_LM}; "
          f"launches {d_launches}")
    print(_graph_line(d_graphs))
    graph_phases["lm_device"] = d_graphs

    # -- eager against replayed: the LM on the device pool, graphs=False ----
    e_outs, e_rows, _, e_server, e_wall, e_launches, _ = lm_serving_phase(
        lm_pipe, requests, counters, pool="device", graphs=False)
    same_toks = sum(int(a == b) for o, e in zip(d_outs, e_outs)
                    for a, b in zip(list(o), list(e)))
    if [list(o) for o in e_outs] != [list(o) for o in d_outs]:
        raise AssertionError(f"eager device pool: {same_toks} of {toks} tokens "
                             f"equal the replayed run's")
    e_check = check_lm_served(lm_pipe, lm_params, requests, e_outs, e_rows,
                              device, refs=check["refs"])
    by_path["lm_device_eager"] = e_launches
    print(f"LM eager against replayed on the device pool: {same_toks} of "
          f"{toks} tokens equal; eager logits max rel err "
          f"{e_check['max_rel_err']:.2e} <= {TOL_LM}; launches {e_launches}")
    pf = check_lm_prefill(requests, d_outs, d_rows, e_outs, e_rows,
                          d_launches, e_launches)
    lm_prefill = {"threads": lm_graphs["prefill"], "device": d_graphs["prefill"],
                  "eager_prefill_time_s": e_server.prefill_time_s,
                  "eager_warmup_s": e_server.prefill_warmup_s, **pf}
    graph_phases["lm_prefill"] = lm_prefill
    print(f"LM prefill captured (one graph a bucket, {lm_graphs['prefill']['captures']}"
          f" <= {len(LM_BUCKETS)} captures, all in warmup) on {card}: "
          f"prefill_time_s captured {lm_graphs['prefill']['prefill_time_s']:.4f} "
          f"(threads) / {d_graphs['prefill']['prefill_time_s']:.4f} (device), "
          f"eager {e_server.prefill_time_s:.4f}; the capture apart: warmup's "
          f"prefill {lm_graphs['prefill']['warmup_s']:.3f} s (eager warmup "
          f"{e_server.prefill_warmup_s:.3f} s); {pf['rows']} first logits rows "
          f"torch.equal to eager's, first tokens equal; K4 launches "
          f"{pf['k4_captured']} replayed (held {lm_graphs['prefill']['held']}) "
          f"= {pf['k4_eager']} eager")
    # -- and with the workers' rounds replayed too --------------------------
    w_outs, w_rows, _, w_server, w_wall, w_launches, w_graphs = \
        lm_serving_phase(lm_pipe, requests, counters, pool="device",
                         workers=True)
    w_toks = sum(int(a == b) for o, w in zip(d_outs, w_outs)
                 for a, b in zip(list(o), list(w)))
    if [list(o) for o in w_outs] != [list(o) for o in d_outs]:
        raise AssertionError(f"device pool with worker graphs: {w_toks} of "
                             f"{toks} tokens equal the default run's")
    w_check = check_lm_served(lm_pipe, lm_params, requests, w_outs, w_rows,
                              device, refs=check["refs"])
    by_path["lm_device_workers"] = w_launches
    print(f"LM with worker graphs on the device pool: {w_toks} of {toks} "
          f"tokens equal; logits max rel err {w_check['max_rel_err']:.2e} <= "
          f"{TOL_LM}; launches {w_launches}")
    print(_graph_line(w_graphs))
    graph_phases["lm_device_workers"] = w_graphs
    print(f"LM round phases, both pools ({card}):")
    print(_lm_line("threads", lm_server, toks, wall))
    print(_lm_line("device", d_server, toks, d_wall))
    print(_lm_line("device eager", e_server, toks, e_wall))
    print(_lm_line("device workers", w_server, toks, w_wall))
    del lm_server, d_server, d_rows, e_server, e_rows, w_server, w_rows

    lin = coded_linear_phase(device, (k2_launches, k3_launches))
    for name, count in lin["launches"].items():
        if count <= 0:
            raise AssertionError(f"kernel {name} never launched by CodedLinear")
    by_path["coded_linear"] = lin["launches"]
    print(f"CodedLinear (T 4, d_in 576, d_out 1536) on n, k_a, k_b = "
          f"{lin['plan']}: {lin['subsets']} survivor subsets, max rel err vs "
          f"torch.matmul {lin['max_rel_err']:.2e} <= {TOL_LINEAR}; launches "
          f"{lin['launches']}")

    # -- the analysis gate's card half ---------------------------------------
    con = contracts_phase(lm_pipe, device, (k1_launches, k2_launches,
                                            k3_launches, k4_launches))
    by_path["contracts"] = con["launches"]
    cells = sum(c["programs_checked"] for c in con["configs"].values())
    captured = sum(c["captured"] for c in con["configs"].values())
    eager = sum(c["eager_only"] for c in con["configs"].values())
    print(f"contracts phase on {card}: {cells} cells, {captured} captured and "
          f"replayed torch.equal to eager on a second argument set, {eager} "
          f"eager-only, 0 errors, {con['seconds']:.1f} s; launches "
          f"{con['launches']}")
    for label, c in con["configs"].items():
        print(f"  {label}: {c['programs_checked']} cells, {c['captured']} "
              f"captured, {c['eager_only']} eager-only; worker+transition "
              f"signatures {c['traces']} <= bound {c['bound']}")
        if c["eager_only_cells"]:
            print(f"    eager-only ({'; '.join(c['eager_only_reasons'])}): "
                  f"{', '.join(c['eager_only_cells'])}")

    # -- the six examples, on the card at their defaults ---------------------
    del lm_pipe, lm_params, lm_outs, lm_rows, d_outs, e_outs, w_outs
    del check, d_check, e_check, w_check
    _empty_cache(device)
    all_counters = (k1_launches, k2_launches, k3_launches, k4_launches)
    t0 = time.perf_counter()
    ex = examples_phase(device, all_counters)
    print(f"examples phase on {card}: {time.perf_counter() - t0:.1f} s")
    for name, e in ex.items():
        by_path[f"example_{name}"] = e["launches"]
        print(f"  {name}: {e['seconds']:.2f} s, check {json.dumps(e['check'])}; "
              f"launches {e['launches']}; last line: {e['last_line']}")
    _empty_cache(device)

    # -- the sharding specs: every arch id at full config, shapes only -------
    specs = specs_phase()
    print("specs phase (no allocation): count_params at full config; leaves "
          "sharded over model on (16, 16); over (pod, data) with FSDP on "
          "(2, 16, 16):")
    for arch, sp in specs.items():
        print(f"  {arch}: {sp['count_params']:,} params, {sp['leaves']} leaves, "
              f"{sp['model_sharded_16x16']} over model, "
              f"{sp['fsdp_data_sharded_2x16x16']} over data with FSDP")

    # -- the arch zoo, after the earlier phases' servers, graphs and weights
    # are released --------------------------------------------------------
    print(f"arch zoo: {torch.cuda.memory_allocated(device) / 2**30:.2f} GiB "
          f"still allocated after the earlier phases")
    t0 = time.perf_counter()
    zoo = zoo_phase(device, (k1_launches, k2_launches, k3_launches,
                             k4_launches), card)
    print(f"arch zoo: {time.perf_counter() - t0:.1f} s")
    by_path.update(zoo["by_path"])
    graph_phases["zoo"] = zoo["graphs"]
    for z in zoo["archs"]:
        specs[z["arch"]]["drawn_on_card"] = {"layers": z["layers"], **z["specs"]}
    print(f"specs against the card: count_params equal to the numel of the "
          f"params drawn on {card} and param_shapes equal to their shapes and "
          f"dtypes leaf for leaf for {len(zoo['archs'])} archs at the zoo's "
          f"depths: " + ", ".join(f"{z['arch']} {z['specs']['count_params']:,}"
                                  for z in zoo["archs"]))

    # -- the kernels line: K1-K4, launches from each path's serving run.
    # K2 runs on both paths, in two regimes: its top-level numbers stay
    # one pass of the CNN transition shapes; one LM decode step's worker
    # GEMMs are reported apart under paths.lm, never summed with them.
    k1e, k2e = kernels
    k1e["launches"] = launches["coded_worker"]
    k2e["launches"] = launches["matmul"]
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms", "max_abs_err", "max_rel_err")
    k2_lm = lm_kernel_summary(lm_k["matmul"])
    k2e["paths"] = {"cnn": {**{key: k2e[key] for key in keys},
                            "launches": launches["matmul"]},
                    "lm": {**{key: k2_lm[key] for key in keys},
                           "launches": lm_launches["matmul"]}}
    k2e["lm_shapes"] = lm_k["matmul"]
    k3 = lm_kernel_summary(lm_k["coded_gemm"])
    k3e = {"name": "coded_gemm", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/coded_gemm.cu",
           "replaces": "src/repro/kernels/coded_gemm/kernel.py:57",
           "tpu_kernel": "coded_gemm_pallas_legacy / coded_gemm_pallas "
                         "(src/repro/kernels/coded_gemm/kernel.py:57, :27)",
           "tol": TOL_K3, "library": "torch.matmul",
           "launches": lm_launches["coded_gemm"], **k3,
           "build": lm_kernel_summary(lm_k["coded_gemm_encode"]),
           "shapes": lm_k["coded_gemm"] + lm_k["coded_gemm_encode"]}
    k4 = lm_kernel_summary(lm_k["flash_attention"])
    k4e = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attn.cu",
           "replaces": "src/repro/kernels/flash_attn/kernel.py:69",
           "tpu_kernel": "flash_attention_pallas / _flash_kernel "
                         "(src/repro/kernels/flash_attn/kernel.py:69, :24)",
           "tol": TOL_K4,
           "library": "F.scaled_dot_product_attention (K/V repeated)",
           "launches": lm_launches["flash_attention"], **k4,
           "bf16": lm_kernel_summary(lm_k["flash_attention_bf16"]),
           "shapes": lm_k["flash_attention"] + lm_k["flash_attention_bf16"]}
    zk = zoo["kernels"]
    k2e["zoo"] = zk["matmul"]
    k3e["zoo"] = zk["coded_gemm"] + zk["coded_gemm_encode"]
    k4e["zoo"] = zk["flash_attention"] + zk["flash_attention_bf16"]
    for e in (k1e, k2e, k3e, k4e):
        e["launches_by_path"] = {path: counts[e["name"]]
                                 for path, counts in by_path.items()
                                 if e["name"] in counts}
    print(json.dumps({"train": tr}))
    print(json.dumps({"zoo": {"archs": zoo["archs"],
                              "qwen3_coded": zoo["qwen3_coded"]}}))
    print(json.dumps({"graphs": graph_phases}))
    print(json.dumps({"examples": ex, "specs": specs}))
    print(json.dumps({"kernels": [k1e, k2e, k3e, k4e]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
