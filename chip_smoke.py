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
    8 x 256 synthetic tokens, checkpointing every 15 steps, each layer
    recomputed in the backward (the reference's per-layer remat).  Step
    1's loss
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
    the launch plan (route, tile, split) K1 and K2 took at each shape.
    K1 is also held, against its plain version in float64, to at most
    ``K1_FP64_RATIO`` times the error of the fp32 plain version (its
    tensor-core route computes fp32 products as three TF32 ones), is timed
    on its other route's design plan too, and carries both bounds (fp32
    FMA at 67 TFLOP/s, 3xTF32 at 495/3); ``nvidia-smi``'s SM clock and
    power are sampled while K1 is timed, and printed;
 5. serving phase: ``CodedServer`` serving 16 VGG-16 224x224 requests on
    n=8 coded workers (2 stragglers at +50 ms, 1 dead worker, fused
    transitions, pipeline depth 2), every result held against the uncoded
    stack; the kernels' launch counts are read around this phase only
    (K1's also by route, each of which must launch);
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
13. the process mesh (``repro_torch.launch.mesh``): ranks spawned on
    this one card by ``run_ranks`` (``torch.multiprocessing``'s spawn, a
    ``FileStore`` rendezvous, gloo: NCCL refuses two ranks a device),
    the kernels built here first so each rank only loads them, each rank
    joined with a timeout and any failing or hung rank failing the
    script.  (a) VGG-16 at 224, batch 8, its 13 ConvLs each through
    ``CodedConv2d.run_sharded`` on 4 ranks (n=4, (k_a, k_b) = (2, 4),
    delta 2; ReLU and pool between as ``models/cnn.py``), for survivors
    [3, 1] and [0, 2]: the final features within 1e-4 of max|uncoded| of
    the uncoded stack, every rank's ``torch.equal`` to rank 0's, K1
    launched 13 times a pass on every rank; ms a layer of the worker
    (encode + K1), the all-gather and the decode.  (b) SmolLM-135M at
    full width and depth trained through ``train(mesh=...)`` on 2 ranks,
    5 steps of 8 x 256 tokens, eagerly: FSDP over (data 2, model 1), each
    loss within 1e-5 of the one-process ``train``'s, the params after
    step 5 within 1e-4 of each leaf's max of the one-process step with
    ``microbatches=2`` (the gap to the full batch printed), the last
    checkpoint restored in this process ``torch.equal`` to the ranks'
    gathered params; then int8 compression over (pod 2, data 1, model 1),
    losses finite and falling; ms a step, collective ms a step, peak
    memory a rank.  (c) ``serve_lm(mesh=...)`` on 2 ranks, batch 4: the
    tokens equal to the one-process ``serve_lm``'s, K4 launched on every
    rank.  (d) tensor and expert parallelism over the mesh's ``model``
    axis, each rank drawing its cut of the params a leaf at a time:
    SmolLM-135M at full width and depth trained through
    ``train(mesh=...)`` over (data 2, model 2) on 4 ranks, 5 steps of 8 x
    256 tokens, FSDP on (its 9 heads cut inside a head), each loss within
    1e-5 of the one-process run's and the params after step 5 held as
    (b) holds them against the full batch; at once with that job, over
    (data 1, model 2), ``serve_lm(mesh=...)`` of Qwen3-4B at full width and depth and of
    DeepSeek-V2 at full width on 1 dense-first and 1 MoE layer (80
    experts a rank), batch 4, 16 + 16 tokens, eagerly: the tokens equal
    to the one-process ``serve_lm``'s (run after the ranks exit), Qwen3's
    logits of every call within 1e-4 of max|logit|, K4 launched on every
    rank once a layer at 64 query heads (4 prompts x 16 local heads); ms
    a step and a layer, collective calls, ms and bytes by axis, peak
    memory a rank beside its reckoned shard bytes.  (e) the recurrent and
    encoder-decoder families over ``model``: RWKV6-1.6B, Hymba-1.5B and
    Whisper-medium trained through ``train(mesh=...)`` over (data 2,
    model 2) at full width on 2 layers (Whisper's encoder and decoder
    alike; RWKV6 in float64), 3 steps of 8 x 256 tokens, each loss
    within 1e-5 of the one-process run's; at once with that job, served
    over (data 1, model 2) at full width and depth, batch 4, 16 + 16 tokens, eagerly:
    Hymba's and Whisper's tokens equal to the one-process ``serve_lm``'s
    and every call's logits within 1e-4 of max|logit|, RWKV6's logits
    held to a float64 one-process run teacher-forced on its tokens
    within twice the fp32 one-process run's distance from it; then each
    one's ``prefill_fn`` over the prompts (Whisper's over 4 x 1500 random
    frames) within 1e-4 of one process's (not RWKV6's), K4 launched on
    every rank once a Hymba layer at 100 query heads (every head) and
    three times a Whisper layer at 32 (8 heads a rank); K4 at those
    per-rank shapes against its plain version, timed beside SDPA; the
    same readings as (d).  (f) the sequence over the mesh: SmolLM-135M at
    full width and depth trained through ``train(mesh=...)`` at a global
    batch of 1 x 2,048 tokens, its sequence cut over data (each rank a
    block of 1,024), over (data 2, model 1) and (data 2, model 2), 3
    steps, each loss within 1e-5 of the one-process run's on the same
    batch; the same over (data 1, model 2) and (data 2, model 2) with
    ``REPRO_SEQ_PARALLEL=1`` and without (over data 2, each data rank's
    block cut further over model), the flag's losses within 1e-5 of the
    flag off's;
    RWKV6-1.6B (float64) and Hymba-1.5B at full width on 2 layers trained
    at 1 x 1,024 over (data 2, model 1), held as (e) holds them; then
    ``serve_lm(mesh=..., batch=1)`` of Qwen3-4B at full width and depth
    over (data 2, model 1), a 512-token prompt cut over the data ranks and
    16 new tokens over the cut cache: the tokens equal to the one-process
    ``serve_lm``'s and every call's logits within 1e-4 of max|logit|; ms a
    step, collective calls, ms and bytes by axis, and peak memory a rank
    printed (gloo through the host on one card, not scaling figures).
    (g) uneven placements, each job's bytes reckoned before it starts and
    the jobs run at once as far as they fit in 70 GB: DeepSeek-V2-236B at
    full width on 1 dense-first and 1 MoE layer, its own 16 dispatch
    groups, through ``serve_lm(mesh=...)`` at batch 4, 16 + 16 tokens,
    over (data 2, model 2), where each decode step's 4 tokens are one
    dispatch group over both data ranks (gathered over data), and over
    (data 1, model 3), where its 160 experts do not divide (each
    expert's ``ff`` cut to 512 a rank, the router and the 102,400-row
    vocab whole); Qwen3-4B at full width on 4 layers over (data 1, model
    3), its 32 heads, 9,728 ``ff``, 151,936 vocab and 32-position cache
    all whole, K4 launched on every rank once a layer at BH 128, S 16, D
    128, rep 4: each job's tokens equal to the one-process ``serve_lm``'s
    (run after the ranks exit) and every call's logits within 1e-4 of
    max|logit|; ms a step, collective calls, ms and bytes by axis, and
    peak memory a rank beside its reckoned bytes printed.  (h) a held
    sequence's edges and ``REPRO_BASELINE=1``, the jobs and the
    one-process runs at once as far as their reckoned bytes fit in 70 GB:
    (i) SmolLM-135M at full width and depth trained over (data 2, model
    1) at 1 x 2,047 tokens, which do not divide over the data ranks, so
    both hold the row whole, 3 steps; (iii) Hymba-1.5B at full width on 2
    layers trained over (data 4, model 1) at 1 x 4 tokens, blocks of one
    position whose conv tail comes from up to 3 ranks back; each loss
    within 1e-5 of the one-process run's; (iv) Qwen3-4B at full width and
    depth served over (data 2, model 1) at batch 1, a 511-token prompt
    whole on each rank written into a cache of 528 cut over the data
    ranks, 17 new tokens, K4 launched on every rank once a layer at BH
    32, S 511, D 128, rep 4; (v) Qwen3-4B at full width on 4 layers
    served over (data 1, model 2) at batch 4, 16 + 16 tokens, with
    ``REPRO_BASELINE=1`` (its 8 KV heads cut 4 a rank, the full cache
    written in place) and without, K4 at BH 64, S 16, D 128, rep 4; each
    served job's tokens equal to the one-process ``serve_lm``'s and every
    call's logits within 1e-4 of max|logit|; K4 at (32, 511, 128, 4)
    against its plain version, timed beside SDPA with its bound; ms a
    step, collective calls, ms and bytes by axis and peak memory a rank
    beside its reckoned bytes printed (gloo through the host on one card,
    not scaling figures);
14. the arch zoo, after the earlier phases' servers, graphs and weights
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
    against their plain versions, timed (K2's down projection, K 9,728 on
    the split kernel, printed alone).  CodeQwen1.5-7B, Gemma2-9B (one
    local, one global layer) and PaliGemma-3B (its ``prefill_fn`` also
    over a 256 x 2048 stub prefix) at 2 layers.  RWKV6-1.6B, Hymba-1.5B
    and Whisper-medium at full width and depth: ``serve_lm`` steps
    ``decode_fn`` over their prompts (no cache-filling prefill, as in the
    reference), so K4's launches are also read around one ``prefill_fn``
    over the same prompts (Whisper's with 4 x 1500 random frames) and
    equal the layers whose route is K4 (RWKV6 0, Hymba 32, Whisper 72:
    its encoder's, its decoder's self- and cross-attention 24 each);
    Whisper's ``prefill_fn`` held within 1e-5 of max|logit| of the same
    forward on the training route (``autograd=True`` under ``no_grad``,
    plain attention), both timed; RWKV6's and Hymba's ``decode_fn``
    stepped over 141 tokens against ``prefill_fn`` (two chunk carries and a padded tail): RWKV6 at
    full depth in float64, and in fp32 on a cut of 2 layers and layer by
    layer at full depth, Hymba at full
    depth with its window cut to 4, from position 96 on (its decode, as
    the reference's, attends over the ring's unwritten slots as zero
    keys before); Whisper's ``decode_fn`` teacher-forced from the cross
    K/V that ``precompute_cross_kv(encode(frames))`` filled against
    ``prefill_fn``; each within 1e-4 of max|logit|.  Last, SmolLM-135M
    at full width and depth, K4 in its captured prefill (at the LM kernel
    phase's shape).  K4 at Qwen3's, CodeQwen's, Hymba's (rep 5) and
    Whisper's prefill shapes (its encoder's 1,500 frames without a mask on
    the tiled route, its decoder's self- and cross-attention) against its
    plain version, timed beside SDPA.
    Each arch's drawn params held against its schema with no new
    allocation: ``count_params`` equal to their numel, ``param_shapes``
    equal to their shapes and dtypes leaf for leaf;
15. the dry run (``repro_torch.launch.dryrun``): (i) the CLI in
    processes of its own (the fake process group is process-wide), started
    before phase 13 (g) (they trace on the host beside (g) and (h), whose
    jobs share it already) and read before the arch zoo, whose timed
    serves keep the host to themselves: DeepSeek-V3-671B at full size, ``decode_32k`` and
    ``train_4k`` on (pod 2, data 16, model 16), each record printed (per
    rank arguments, outputs and temporary bytes, FLOPs, HBM bytes,
    collective wire bytes by axis, K4 charges); (ii) on the card with
    no process mesh, in bf16, SmolLM-135M ``train_4k`` and
    Qwen3-4B ``prefill_32k`` at smoke scale 16, weights and tokens from
    the seed, each step run under the dry run's cost counter after a
    warm-up call and held against the dry run of the same cell on the 1 x
    1 mesh: FLOPs and product FLOPs equal (K4's launches charged on the
    card by the same ``flash_cost``), argument bytes equal, the peak above
    the arguments (``max_memory_allocated`` after a reset) within 15 % of
    the dry run's temporary bytes, K4 launched once a layer (36) where the
    dry run charges it; each step's ms printed beside the dry run's
    roofline bound, max(FLOPs / the bf16 dense peak, bytes / 3.35e12 B/s);
    K4 at the prefill's shape (BH 64, S 2,048, D 128, rep 4) on the tiled
    route in bf16 (the step's) and fp32, and at Qwen3-4B's tensor-parallel
    prefill shape (BH 64, S 16, fp32) against its plain version, timed
    beside SDPA in the same type; the prefill step's K4 share (its 36
    launches at that device time) printed beside the step;
16. the autotune ledger (``repro_torch.kernels.autotune``): a VGG-16
    224 pipeline (n=8, (2, 4), fused transitions, bucket 8) sweeps every
    K1 worker cell and K2 transition cell through
    ``CodedPipeline.autotune_kernels`` into a temporary ledger
    (``REPRO_AUTOTUNE_CACHE``, set for the whole run, so no earlier phase
    reads a ledger); a line a cell with the heuristic's plan and device us
    beside the winner's; the K1 pass of bucket 8 timed untuned (before the
    sweep) and tuned; a bucket-8 pass with the tuned plans held to the
    uncoded stack within 1e-4 of max|uncoded|, K1 and K2 launched; a
    second ``autotune_kernels`` call sweeps 0 cells;
17. one JSON line with the training numbers (ms a step and tokens/s, the
    median over steps 5-30, captured and eager, peak device memory, the
    model FLOPs a step and their share of the fp32 peak, the card's name
    and power limit),
    one JSON line with the arch zoo's readings, one JSON line with the
    compiled programs' counts by phase (the zoo's ``serve_lm`` graphs
    and the coded LM prefill's among them), one JSON line with the
    examples' and the specs' readings, one JSON line with the process
    mesh's readings, one JSON line with the dry run's, one JSON line with
    the autotune phase's, one JSON line with the kernels' numbers (K1-K4; K2's top-level numbers
    are its CNN pass, its LM numbers sit under ``paths.lm``; each kernel's
    ``launches`` is its count on the phase-5 or phase-7 main path, and
    ``launches_by_path`` its count in every phase that ran it, training's
    0 and the zoo's and the dry run's among them; K2-K4 carry their zoo
    shapes under ``zoo``, K4 the dry-run phase's under ``dryrun``; a
    replayed
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

import contextlib
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
# cores, dense bf16 on the tensor cores, and HBM3 bandwidth.  The bound of
# a kernel is the larger of its operations over the peak for its operands'
# type and its bytes over the bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12

ARCH, HW, N_WORKERS, KAB, BUCKET = "vgg16", 224, 8, (2, 4), 8
N_REQUESTS, STRAGGLER_DELAY_S, SEED = 16, 0.05, 0
# K1 sums up to C*KH*KW = 4608 fp32 products, K2 at most Q = 8; a plain
# version may sum in another order.  Both are held to a bound on
# max|kernel - plain| relative to max|plain|, far above fp32 rounding at
# those depths and far below any indexing or masking fault.
TOL_K1, TOL_K2 = 1e-4, 1e-5
# K1's tensor-core route computes fp32 products as three TF32 ones
# (3xTF32); its error against the same function in float64 is held to at
# most this many times the fp32 plain version's (cuBLAS, TF32 off), so it
# keeps the fp32 path's precision and not only TOL_K1.
K1_FP64_RATIO = 4.0
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
# K3 sums R_in <= 4 products in order; K4 sums 64- or 128-term dot
# products and an online softmax over 16 keys on the rows route, up to
# 2,048 on the tiled route (its P.V sums stay far inside 2e-5 at that
# depth); expf against the library's exp.  Both relative to max|plain|.
# K4 in bf16 rounds p and its output to bf16, as its plain version does;
# an fp32 sum in another order may flip either rounding, so it is held to
# one bf16 rounding of the output (2^-7 of max|plain|).  Where one 32-key
# chunk holds every key (S <= 32, the prefill), the kernel rounds p
# exactly where the plain version does, so the two outputs are also
# bit-equal in all but K4_BF16_MISMATCH of their elements: an fp32 score
# summed in another order flips p's rounding in fewer, while a kernel that
# skipped rounding p (within 2^-7 all the same) changes about a quarter of
# them (both held on random data by tests/test_torch_lm_kernels.py).
# Over many keys 2^-7 of max|plain| is set by row 0 (one key, |v| ~ 3.5)
# and is as large as a late row's whole output, so the tiled route in
# bf16 is also held, row by row, to flash_attention_tiled_plain, which
# rounds p against the running max of each key tile as the kernel does (128
# keys on the wgmma kernel, 64 on the mma.sync one; the walk takes the
# kernel's tile):
# each row within one bf16 rounding of its own largest element (2^-7 of
# it), and the same bits in all but K4_BF16_TILED_MISMATCH of the
# elements.  That walk with p left whole (a kernel that skipped p's
# rounding) must differ in more than K4_BF16_WHOLE_P of them on the same
# inputs, or the check could not see such a kernel.  On an H100 at the
# phase-15 shape the mma.sync kernel differs from its walk in 0.37 % of
# the bits and the wgmma kernel from its own in 0.37 %, each row by at most
# one rounding, and p left whole in 40 %
# (tests/test_torch_lm_kernels.py holds the walk to the TPU kernel's).
TOL_K3, TOL_K4, TOL_K4_BF16 = 1e-5, 2e-5, 2.0 ** -7
K4_ONE_CHUNK, K4_BF16_MISMATCH = 32, 1e-3
K4_BF16_TILED_MISMATCH, K4_BF16_WHOLE_P = 1e-2, 0.1
K4_KERNELS = ("flash_attn_kernel", "flash_tiled_")  # K4's kernels by name
# K4's fp32 tiled kernel on wgmma computes fp32 products as three TF32
# ones (3xTF32), as K1's tensor-core route; its error against the same
# function in float64 is held to at most this many times the fp32 plain
# version's (TF32 off), so it keeps the fp32 path's precision and not only
# TOL_K4.
K4_FP64_RATIO = 4.0
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
# Whisper's prefill_fn (K4 for the encoder's 1,500-frame attention without
# a mask and the decoder's self- and cross-attention) against the same
# forward on the training route (plain masked attention): the same fp32
# products summed in another order through 24 + 24 layers, relative to
# max|logit|
TOL_ZOO_ROUTE = 1e-5
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


class ClockSampler:
    """``nvidia-smi``'s SM clock, its maximum, the power draw and the
    power limit, sampled in a thread every ``period_s`` while the ``with``
    block runs (the card the timings beside it ran on)."""

    QUERY = "clocks.sm,clocks.max.sm,power.draw,power.limit"

    def __init__(self, period_s: float = 0.25):
        import threading

        self.period_s = period_s
        self.rows: list[tuple[float, ...]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _sample(self) -> None:
        try:
            out = subprocess.run(
                ["nvidia-smi", f"--query-gpu={self.QUERY}",
                 "--format=csv,noheader,nounits", "--id=0"],
                capture_output=True, text=True, timeout=10).stdout
            self.rows.append(tuple(float(v) for v in out.split(",")))
        except (OSError, ValueError, subprocess.SubprocessError):
            pass  # a failed read is a missing sample, counted in summary()

    def _run(self) -> None:
        while not self._stop.is_set():
            self._sample()
            self._stop.wait(self.period_s)

    def __enter__(self) -> "ClockSampler":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()

    def summary(self) -> dict:
        """Min, median and max of each quantity over the samples."""
        def stats(col):
            vals = sorted(r[col] for r in self.rows)
            return {"min": vals[0], "median": float(np.median(vals)),
                    "max": vals[-1]} if vals else None

        return {"samples": len(self.rows), "sm_mhz": stats(0),
                "max_sm_mhz": stats(1), "power_w": stats(2),
                "power_limit_w": stats(3)}


def clock_line(name: str, clk: dict) -> str:
    if not clk["samples"]:
        return f"SM clock during {name}: no nvidia-smi sample"
    sm, mx, pw = clk["sm_mhz"], clk["max_sm_mhz"], clk["power_w"]
    return (f"SM clock during {name}: {clk['samples']} samples, "
            f"{sm['min']:.0f} / {sm['median']:.0f} / {sm['max']:.0f} MHz "
            f"(min / median / max; max SM clock {mx['max']:.0f} MHz), power "
            f"{pw['min']:.1f} / {pw['median']:.1f} / {pw['max']:.1f} W of "
            f"{clk['power_limit_w']['max']:.2f} W")


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


def profiler_device_ms(fn, names: tuple[str, ...] = (),
                       reps: int = 10) -> tuple[float, float] | None:
    """Mean device time of a call of ``fn`` by ``torch.profiler``'s kernel
    records (the sum of their self device time over ``reps`` calls, after
    one unrecorded call), and of it the kernels whose names hold one of
    ``names``: a cross-check of ``device_ms`` by another clock, and a
    kernel's share of a step read from a trace of the step.  None when the
    profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = part_us = 0.0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        t = float(t if t is not None else ev.self_cuda_time_total)
        total_us += t
        if any(n in ev.key for n in names):
            part_us += t
    if total_us <= 0:
        return None
    return total_us / 1e3 / reps, part_us / 1e3 / reps


def timings(fn, plain, library) -> dict:
    """``ms`` / ``device_ms`` (and the profiler's ``profiler_device_ms``)
    of the kernel call ``fn``, ``plain_ms`` of its plain version and
    ``library_ms`` / ``library_device_ms`` of the library yardstick (None
    where there is none)."""
    traced = profiler_device_ms(fn)
    out = {"ms": cuda_ms(fn), "device_ms": device_ms(fn),
           "profiler_device_ms": None if traced is None else traced[0],
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


def bound_ms(flops: float, nbytes: float,
             peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_ops = flops / peak * 1e3
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


def k1_bounds(m: int, n: int, kk: int, nbytes: float) -> dict:
    """K1's two bounds: fp32 FMA outside the tensor cores, and three TF32
    products a multiply-add on them (the tensor-core route's arithmetic)."""
    ffma, ffma_by = bound_ms(2.0 * m * n * kk, nbytes)
    tf32, tf32_by = bound_ms(3 * 2.0 * m * n * kk, nbytes, PEAK_TF32_FLOPS)
    return {"ffma_ms": ffma, "ffma_by": ffma_by, "tf32x3_ms": tf32,
            "tf32x3_by": tf32_by}


def k1_entry(xs, ks, stride, gen, device, timed: bool) -> dict:
    """K1 at one worker shape: within ``TOL_K1`` of its plain version, its
    error against the float64 plain version at most ``K1_FP64_RATIO``
    times the fp32 plain version's, the same bits from a second launch;
    timed (the plan's route, the other route's design plan, the plain
    version and cuDNN) where ``timed``."""
    from repro_torch.kernels.conv2d.kernel import (choose_worker_plan,
                                                   coded_worker,
                                                   coded_worker_plain,
                                                   launch_worker, route_plan)

    xe = torch.randn(xs, generator=gen, device=device)
    ke = torch.randn(ks, generator=gen, device=device) / np.sqrt(np.prod(ks[2:]))

    def run():
        return coded_worker(xe, ke, stride)

    got, ref = run(), coded_worker_plain(xe, ke, stride)
    abs_err, rel_err = _err(got, ref)
    if not rel_err <= TOL_K1:
        raise AssertionError(f"K1 {xs} x {ks}: rel err {rel_err} > {TOL_K1}")
    ref64 = coded_worker_plain(xe.double(), ke.double(), stride)
    err64 = _err(got.double(), ref64)[1]
    plain_err64 = _err(ref.double(), ref64)[1]
    del ref64
    if not err64 <= K1_FP64_RATIO * plain_err64:
        raise AssertionError(
            f"K1 {xs} x {ks}: rel err {err64:.3e} against float64 > "
            f"{K1_FP64_RATIO} x the fp32 plain version's {plain_err64:.3e}")
    check_repeatable(f"K1 {xs} x {ks}", run, got)
    ea, b, c, hh, wp = xs
    eb, nb, _, kh, kw = ks
    m = ea * b * got.shape[-2] * got.shape[-1]
    kk, n = c * kh * kw, eb * nb
    bounds = k1_bounds(m, n, kk, 4.0 * (xe.numel() + ke.numel() + got.numel()))
    plan = choose_worker_plan(xs, ks, stride, device)
    e = {"xe": list(xs), "ke": list(ks), "stride": stride, "count": 1,
         "gemm_mnk": [m, n, kk], "route": plan.route, "plan": plan._asdict(),
         "max_abs_err": abs_err, "max_rel_err": rel_err,
         "rel_err_fp64": err64, "plain_rel_err_fp64": plain_err64,
         "bound_ms": bounds["tf32x3_ms"], "bound_by": bounds["tf32x3_by"],
         "bounds": bounds, "ms": None, "device_ms": None, "plain_ms": None,
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
        other = route_plan("ffma" if plan.route == "tc" else "tc", m, n, kk)
        e["other_route"] = {"plan": other._asdict(), "device_ms": device_ms(
            lambda: launch_worker(other, xe, ke, stride))}
    return e


def kernel_phase(pipe, bucket: int, device, timed: bool = True) -> list[dict]:
    """Each kernel at each of its serving shapes against its plain version
    (and, timed, beside one library call that computes the same
    function).  Raises when a kernel disagrees beyond its tolerance."""
    from repro_torch.kernels.matmul.kernel import matmul, matmul_plain, matmul_plan

    gen = torch.Generator(device=device).manual_seed(SEED)
    k1, k2 = [], []
    seen: dict = {}
    clock = ClockSampler()
    with clock if timed else contextlib.nullcontext():
        for xs, ks, stride in worker_shapes(pipe, bucket):
            if (xs, ks, stride) in seen:
                seen[(xs, ks, stride)]["count"] += 1
                continue
            e = k1_entry(xs, ks, stride, gen, device, timed)
            seen[(xs, ks, stride)] = e
            k1.append(e)
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
    k1_extra = {
        "routes": {r: sum(e["count"] for e in k1 if e["route"] == r)
                   for r in sorted({e["route"] for e in k1})},
        "bounds": {key: sum(e["bounds"][key] * e["count"] for e in k1)
                   for key in ("ffma_ms", "tf32x3_ms")},
        "rel_err_fp64": max(e["rel_err_fp64"] for e in k1),
        "fp64_ratio": max(e["rel_err_fp64"] / max(e["plain_rel_err_fp64"], 1e-30)
                          for e in k1),
        "fp64_ratio_limit": K1_FP64_RATIO}
    if timed:
        k1_extra["other_route_device_ms"] = sum(
            e["other_route"]["device_ms"] * e["count"] for e in k1)
        k1_extra["sm_clock"] = clock.summary()
    return [
        {"name": "coded_worker", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/coded_worker.cu",
         "replaces": "src/repro/kernels/conv2d/kernel.py:291",
         "tpu_kernel": "coded_worker_pallas / _fused_worker_gemm "
                       "(src/repro/kernels/conv2d/kernel.py:190)",
         "tol": TOL_K1, "library": "F.conv2d (cuDNN, TF32 off)",
         "shapes": k1, **k1_extra, **(_summarise(k1) if timed else {})},
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
                dtype=torch.float32, causal: bool = True,
                tf32x3: bool = False) -> tuple[float, str]:
    """Attention's least work (``flash_cost``, the dry run's charge for a
    launch) against the HBM rate and the peak for ``dtype``: fp32 outside
    the tensor cores, bf16 dense on them; with ``tf32x3`` (fp32 operands),
    three TF32 products a multiply-add on them (the 3xTF32 kernel's
    arithmetic, ``PEAK_TF32_FLOPS / 3``)."""
    from repro_torch.kernels.flash_attn.kernel import flash_cost

    width = torch.finfo(dtype).bits // 8
    flops, nbytes = flash_cost(bh, bhkv, sq, sk, d, width, causal)
    if tf32x3:
        return bound_ms(3 * flops, nbytes, PEAK_TF32_FLOPS)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    return bound_ms(flops, nbytes, peak)


def flash_bounds(bh: int, bhkv: int, sq: int, sk: int, d: int,
                 causal: bool = True) -> dict:
    """K4's two fp32 bounds, as ``k1_bounds``: fp32 FMA outside the tensor
    cores, and three TF32 products a multiply-add on them (the 3xTF32
    kernel's arithmetic)."""
    ffma, ffma_by = flash_bound(bh, bhkv, sq, sk, d, torch.float32, causal)
    tf32, tf32_by = flash_bound(bh, bhkv, sq, sk, d, torch.float32, causal,
                                tf32x3=True)
    return {"ffma_ms": ffma, "ffma_by": ffma_by, "tf32x3_ms": tf32,
            "tf32x3_by": tf32_by}


def k4_fp64(name: str, got: torch.Tensor, want64: torch.Tensor,
            plain_err64: float, held: bool) -> dict:
    """K4's fp32 output ``got`` against the float64 plain version
    ``want64``: its largest error beside the fp32 plain version's, and
    where ``held`` (the 3xTF32 kernel) at most ``K4_FP64_RATIO`` times it.
    Raises where that fails."""
    err64 = float((got.double() - want64).abs().max())
    ratio = err64 / max(plain_err64, 1e-300)
    if held and not ratio <= K4_FP64_RATIO:
        raise AssertionError(f"{name}: error {err64:.3e} against float64 is "
                             f"{ratio:.2f} x the fp32 plain version's "
                             f"{plain_err64:.3e} > {K4_FP64_RATIO}")
    return {"err_fp64": err64, "plain_err_fp64": plain_err64,
            "fp64_ratio": ratio, "fp64_ratio_limit": K4_FP64_RATIO if held else None}


def _k3_plan(m: int, n: int, kk: int):
    from repro_torch.kernels.coded_gemm.kernel import coded_gemm_plan

    return coded_gemm_plan(m, kk, n)


def row_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest error of an output row relative to that row's own
    max|want| (rows along the last dimension)."""
    got, want = got.float(), want.float()
    err = (got - want).abs().amax(dim=-1)
    return float((err / want.abs().amax(dim=-1).clamp_min(1e-30)).max())


def check_tiled_bf16(name: str, q, k, v, got: torch.Tensor, causal: bool,
                     rep: int, tile: int | None = None) -> dict:
    """K4's tiled bf16 output ``got`` against ``flash_attention_tiled_plain``
    on the same inputs, walked at the kernel's key tile ``tile`` (by
    default the walk's: that of the kernel ``flash_plan`` picks at this
    head dim): every row within ``TOL_K4_BF16`` of its own max|want| and
    all but ``K4_BF16_TILED_MISMATCH`` of the elements bit-equal, while the
    same walk with p left whole differs in more than ``K4_BF16_WHOLE_P`` of
    them.  Raises where one fails."""
    from repro_torch.kernels.flash_attn.kernel import flash_attention_tiled_plain

    want = flash_attention_tiled_plain(q, k, v, causal=causal, rep=rep, tile=tile)
    whole_p = flash_attention_tiled_plain(q.float(), k.float(), v.float(),
                                          causal=causal, rep=rep,
                                          tile=tile).to(q.dtype)
    out = {"key_tile": tile, "tiled_row_err": row_err(got, want),
           "tiled_mismatch_share": float((got != want).float().mean()),
           "whole_p_mismatch_share": float((whole_p != want).float().mean())}
    if not out["tiled_row_err"] <= TOL_K4_BF16:
        raise AssertionError(f"{name}: a row is {out['tiled_row_err']:.2e} of its "
                             f"own max from the tile-order walk > {TOL_K4_BF16}")
    if not out["tiled_mismatch_share"] <= K4_BF16_TILED_MISMATCH:
        raise AssertionError(f"{name}: {out['tiled_mismatch_share']:.2%} of the "
                             f"outputs differ from the tile-order walk's bits > "
                             f"{K4_BF16_TILED_MISMATCH:.2%}")
    if not out["whole_p_mismatch_share"] > K4_BF16_WHOLE_P:
        raise AssertionError(f"{name}: p left whole changes only "
                             f"{out['whole_p_mismatch_share']:.2%} of the "
                             f"outputs: the bit check cannot see it")
    return out


def flash_entry(bh: int, s: int, d: int, rep: int, count: int, dtype, gen,
                device, tol: float, timed: bool, sk: int | None = None,
                causal: bool = True, other: str | None = None) -> dict:
    """K4 at one self-attention shape (``sk`` keys, ``s`` by default;
    causal or not) in ``dtype``, on the route ``flash_plan`` chooses,
    against its plain version (the tiled route in bf16 also row by row
    against the tile-order walk, ``check_tiled_bf16``; fp32 also against
    the plain version in float64, ``k4_fp64``, held on the 3xTF32 kernel)
    and a second launch of itself (and, timed, beside SDPA in the same
    type with K/V repeated outside the timed call).  fp32 carries both
    bounds (``flash_bounds``; ``bound_ms`` the 3xTF32 one, the lesser).
    ``other`` names another tiled kernel of the type (``TILED_KERNELS``)
    held to the same checks on the same inputs and, timed, timed beside it
    in the same call, the SM clock sampled while both are timed
    (``other_kernel``, ``sm_clock``)."""
    from repro_torch.kernels.flash_attn.kernel import (flash_attention,
                                                       flash_attention_plain,
                                                       flash_plan, launch_plan,
                                                       tiled_plan)

    sk = s if sk is None else sk
    q, k, v = (torch.randn(shape, generator=gen, device=device).to(dtype)
               for shape in ((bh, s, d), (bh // rep, sk, d), (bh // rep, sk, d)))

    def run():
        return flash_attention(q, k, v, causal=causal, rep=rep)

    def plain():
        return flash_attention_plain(q, k, v, causal=causal, rep=rep)

    got = run()
    want = plain()
    abs_err, rel_err = _err(got.float(), want.float())
    plan = flash_plan(bh, s, sk, d, rep, dtype == torch.bfloat16, causal)
    name = (f"K4 {tuple(q.shape)} over {sk} keys{'' if causal else ', no mask'} "
            f"{dtype} ({plan.route} route)")
    if not rel_err <= tol:
        raise AssertionError(f"{name}: rel err {rel_err} > {tol}")
    mismatch = float((got != want).float().mean())
    if (dtype == torch.bfloat16 and sk <= K4_ONE_CHUNK
            and not mismatch <= K4_BF16_MISMATCH):
        raise AssertionError(f"{name}: {mismatch:.2%} of the outputs differ "
                             f"from the plain version's bits > {K4_BF16_MISMATCH:.2%}")
    bf16_tiled = dtype == torch.bfloat16 and plan.route == "tiled"
    tiled = (check_tiled_bf16(name, q, k, v, got, causal, rep, plan.keys)
             if bf16_tiled else {})
    fp64, want64, plain_err64 = {}, None, 0.0
    if dtype == torch.float32:
        want64 = flash_attention_plain(q.double(), k.double(), v.double(),
                                       causal=causal, rep=rep)
        plain_err64 = float((want.double() - want64).abs().max())
        fp64 = k4_fp64(name, got, want64, plain_err64, plan.kernel == "tf32x3")
    check_repeatable(name, run, got)
    if dtype == torch.float32:
        bounds = flash_bounds(bh, bh // rep, s, sk, d, causal)
        bnd, by = bounds["tf32x3_ms"], bounds["tf32x3_by"]
    else:
        bounds = None
        bnd, by = flash_bound(bh, bh // rep, s, sk, d, dtype, causal)
    e = {"q": [bh, s, d], "kv": [bh // rep, sk, d], "rep": rep,
         "causal": causal, "dtype": str(dtype).removeprefix("torch."),
         "count": count, "plan": plan._asdict(),
         "max_abs_err": abs_err, "max_rel_err": rel_err, "tol": tol,
         "mismatch_share": mismatch, **tiled, **fp64,
         "bound_ms": bnd, "bound_by": by, "bounds": bounds, "ms": None,
         "device_ms": None, "plain_ms": None, "library_ms": None,
         "library_device_ms": None}
    o_run = None
    if other is not None:
        o_plan = tiled_plan(bh, s, d, rep, dtype == torch.bfloat16, kernel=other)
        o_name = f"{name[:-1]}, the {other} kernel)"

        def o_run():
            return launch_plan(o_plan, q, k, v, scale=None, causal=causal, rep=rep)

        o_got = o_run()
        o_abs, o_rel = _err(o_got.float(), want.float())
        if not o_rel <= tol:
            raise AssertionError(f"{o_name}: rel err {o_rel} > {tol}")
        check_repeatable(o_name, o_run, o_got)
        e["other_kernel"] = {
            "plan": o_plan._asdict(), "max_abs_err": o_abs, "max_rel_err": o_rel,
            **(check_tiled_bf16(o_name, q, k, v, o_got, causal, rep, o_plan.keys)
               if bf16_tiled else {}),
            **(k4_fp64(o_name, o_got, want64, plain_err64, other == "tf32x3")
               if want64 is not None else {}), "ms": None, "device_ms": None}
        del o_got
    del want64
    if timed:
        b = bh // rep  # SDPA's (B, H, S, D) with one KV head a batch row
        q4 = q.view(b, rep, s, d)
        k4r = k.view(b, 1, sk, d).expand(b, rep, sk, d).contiguous()
        v4r = v.view(b, 1, sk, d).expand(b, rep, sk, d).contiguous()

        def library():
            return F.scaled_dot_product_attention(q4, k4r, v4r, is_causal=causal)

        clock = ClockSampler()
        with clock if o_run is not None else contextlib.nullcontext():
            e.update(timings(run, plain, library))
            if o_run is not None:
                e["other_kernel"].update(ms=cuda_ms(o_run),
                                         device_ms=device_ms(o_run))
        if o_run is not None:
            e["sm_clock"] = clock.summary()
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
    xg, _ = moe._groups(x, cfg)
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


def whisper_checks(bundle, params, prompts, frames, full, device) -> dict:
    """Whisper, given ``full``, ``prefill_fn``'s logits over ``frames`` and
    ``prompts`` (the serving route: K4 for the encoder's attention and the
    decoder's self- and cross-attention): the same forward on the training
    route (``autograd=True`` under ``torch.no_grad()``, plain attention)
    within ``TOL_ZOO_ROUTE`` of max|logit|, both timed on a second call;
    then ``decode_fn`` teacher-forced over the prompts from a cache whose
    cross K/V ``precompute_cross_kv(encode(frames))`` filled, within
    ``TOL_ZOO_DECODE`` of max|logit|."""
    from repro_torch.models import whisper

    cfg = bundle.cfg
    shape = (*prompts.shape, cfg.vocab)
    _check_logits(f"{bundle.name} prefill_fn", full, shape)

    def seconds(fn):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        return time.perf_counter() - t0

    with torch.no_grad():
        trained = whisper.forward(params, cfg, frames, prompts, autograd=True)
        train_s = seconds(lambda: whisper.forward(params, cfg, frames, prompts,
                                                  autograd=True))
    serve_s = seconds(lambda: bundle.prefill_fn(
        params, {"frames": frames, "tokens": prompts}))
    route_err = _err(full, trained)[1]
    if not route_err <= TOL_ZOO_ROUTE:
        raise AssertionError(f"{bundle.name}: prefill_fn (K4 route) vs the "
                             f"training route's plain attention rel err "
                             f"{route_err} > {TOL_ZOO_ROUTE}")
    del trained
    cache = whisper.precompute_cross_kv(
        params, cfg, whisper.encode(params, cfg, frames),
        bundle.make_cache(prompts.shape[0], prompts.shape[1], torch.float32, device))
    stepped, _ = _stepped(bundle, params, cache, prompts)
    _check_logits(f"{bundle.name} decode_fn", stepped, shape)
    err = _err(stepped, full)[1]
    if not err <= TOL_ZOO_DECODE:
        raise AssertionError(f"{bundle.name}: decode_fn over the encoder's cross "
                             f"K/V vs prefill_fn rel err {err} > {TOL_ZOO_DECODE}")
    return {"frames": list(frames.shape), "decode_rel_err": err,
            "training_route_rel_err": route_err, "prefill_fn_s": serve_s,
            "training_route_s": train_s}


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


def k4_by_kernel() -> dict:
    """K4's launches by kernel (``kernel_launches``) since their last
    reset, the kernels that launched."""
    from repro_torch.kernels.flash_attn.kernel import kernel_launches

    return {name: c.count for name, c in kernel_launches.items() if c.count}


def _add_counts(total: dict, *parts: dict) -> dict:
    """Counts by name summed over ``parts``, onto ``total``."""
    out = dict(total)
    for part in parts:
        for name, n in part.items():
            out[name] = out.get(name, 0) + n
    return out


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
        served.append((toks, rows, timings, _launches(counters), k4_by_kernel()))
    ((toks, rows, timings, launches, k4_kernels),
     (toks_e, rows_e, timings_e, launches_e, k4_kernels_e)) = served
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
           "k4_kernels": {"captured": k4_kernels, "eager": k4_kernels_e},
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
        logits = bundle.prefill_fn(params, batch)
        _sync(device)
        out["prefill_fn_s"] = time.perf_counter() - t0
        out["prefill_launches"] = _launches(counters)
        out["k4_kernels"]["prefill_fn"] = k4_by_kernel()
        _check_logits(f"{arch} prefill_fn", logits, (ZOO_BATCH, ZOO_PROMPT, cfg.vocab))
        if out["prefill_launches"]["flash_attention"] != k4_routes:
            raise AssertionError(
                f"{arch}: K4 launched {out['prefill_launches']['flash_attention']} "
                f"times in prefill_fn, the routes say {routes}")
        if bundle.family == "encdec":
            out["checks"] = whisper_checks(bundle, params, prompts,
                                           batch["frames"], logits, device)
        else:
            out["checks"] = recurrent_checks(bundle, params, device)
        del logits, batch
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
                  f"s (launches {z['prefill_launches']}); on a second call "
                  f"{c['prefill_fn_s']:.3f} s against the training route's "
                  f"plain attention (autograd=True under no_grad) "
                  f"{c['training_route_s']:.3f} s, logits apart "
                  f"{c['training_route_rel_err']:.2e} <= {TOL_ZOO_ROUTE}; "
                  f"decode_fn over precompute_cross_kv(encode(frames)) vs "
                  f"prefill_fn {c['decode_rel_err']:.2e} <= {TOL_ZOO_DECODE}")
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
    Qwen3's, CodeQwen's, Hymba's (rep 5) and Whisper's three prefill
    shapes.  ``smoke`` runs the smoke configs (a rehearsal on the CPU,
    untimed, with ``graphs`` a graph class that captures there)."""
    out: dict = {"archs": [], "graphs": {}, "kernels": {
        name: [] for name in ("matmul", "coded_gemm", "coded_gemm_encode",
                              "flash_attention", "flash_attention_bf16")}}
    by_path: dict = {}
    k4_paths: dict = {}  # path -> K4's launches by kernel
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
        for run, counts in z["k4_kernels"].items():
            k4_paths[f"zoo_{arch}" + ("" if run == "captured" else f"_{run}")] = counts
        out["graphs"][arch] = z["graphs"]
        if "prefill_launches" in z:
            by_path[f"zoo_{arch}_prefill_fn"] = z["prefill_launches"]
        if arch == "qwen3-4b":
            out["qwen3_coded"] = zoo_qwen3_coded(params, cfg, device, counters,
                                                 card, out["kernels"], by_path)
        # SmolLM's prefill shape is the LM kernel phase's (BH 36, S 16,
        # D 64, rep 3), held there; Whisper's prefill_fn launches K4 at
        # three shapes: its encoder's (1,500 frames, no mask), its decoder's
        # self-attention and its cross-attention over the frames
        if arch in ("qwen3-4b", "codeqwen1.5-7b", "hymba-1.5b", "whisper-medium"):
            gen = torch.Generator(device=device).manual_seed(SEED + 7)
            h, d = cfg.n_heads, cfg.head_dim
            rep = h // getattr(cfg, "n_kv_heads", h)
            bh = ZOO_BATCH * h
            if z["family"] == "encdec":
                e_len, n_dec = cfg.enc_len, cfg.dec_layers
                shapes = [("encoder", e_len, e_len, False, cfg.enc_layers),
                          ("decoder self", ZOO_PROMPT, ZOO_PROMPT, True, n_dec),
                          ("decoder cross", ZOO_PROMPT, e_len, False, n_dec)]
            else:
                shapes = [("", ZOO_PROMPT, ZOO_PROMPT, True, z["routes"]["k4"])]
            path = ("serve_lm captured prefill" if "prefill_launches" not in z
                    else "prefill_fn")
            for what, sq, sk, causal, count in shapes:
                e = flash_entry(bh, sq, d, rep, count, torch.float32, gen, device,
                                TOL_K4, timed, sk=sk, causal=causal)
                out["kernels"]["flash_attention"].append(
                    {"arch": arch, "path": f"{path} {what}".strip(), **e})
                print(f"  K4 at {arch}'s {what + ' ' if what else ''}prefill "
                      f"{e['q']} over {sk} keys{'' if causal else ' (no mask)'} "
                      f"rep {e['rep']}, {e['plan']['route']} route "
                      f"({e['plan']['kernel']}), {count} "
                      f"launches: {_ms(e['ms'])} ms, device {_ms(e['device_ms'])}, "
                      f"plain {_ms(e['plain_ms'])}, SDPA {_ms(e['library_ms'])} / "
                      f"device {_ms(e['library_device_ms'])}, bound "
                      f"{e['bound_ms']:.5f} by {e['bound_by']}; rel err "
                      f"{e['max_rel_err']:.2e} <= {TOL_K4}" + fp64_text(e))
        out["archs"].append(z)
        del params
        _empty_cache(device)
    out["by_path"] = by_path
    out["k4_by_path"] = k4_paths
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
        if card_run and name == "matmul":
            e = next(e for e in entries if e["round"] == "down")
            print(f"    its down projection {e['a']} x {e['b']} alone, "
                  f"{e['plan']['kernel']} kernel ({e['plan']['splits']} slices "
                  f"of {e['plan']['k_slice']} rows, {e['plan']['blocks']} "
                  f"blocks), {e['count']} launches a step: {e['device_ms']:.4f} "
                  f"device ms a launch, torch.matmul {e['library_device_ms']:.4f}"
                  f", bound {e['bound_ms']:.5f} by {e['bound_by']}, rel err "
                  f"{e['max_rel_err']:.2e} <= {TOL_K2}")
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


# -- the dry run: the multi-pod cells traced on meta tensors ------------------

# (i) the CLI over the multi-pod mesh (rank 0 of 512 fake ranks), DeepSeek-V3
# at full size, each cell a process of its own (the fake process group is
# process-wide), run beside phase 13 (g) and (h)
DRYRUN_CLI = (("deepseek-v3-671b", "decode_32k"), ("deepseek-v3-671b", "train_4k"))
DRYRUN_CLI_TIMEOUT_S = 900
# (ii) cells run on the card (bf16 params, no process mesh) under the dry
# run's counter and held against the dry run of the same cell on the 1 x 1
# mesh: FLOPs and argument bytes equal, the peak above the arguments within
# TOL_DRYRUN_PEAK of the dry run's temporary bytes
DRYRUN_CARD = (("smollm-135m", "train_4k"), ("qwen3-4b", "prefill_32k"))
DRYRUN_SMOKE, TOL_DRYRUN_PEAK = 16, 0.15
# K4 at Qwen3-4B's per-rank prefill over (data 1, model 2): 4 prompts x 16
# local query heads, S 16 (phase 13 (d))
K4_TP_SHAPE = (64, 16, 128, 4)


def start_dryrun_cli(tmp: str) -> list:
    """(i): one ``python -m repro_torch.launch.dryrun`` process a cell of
    ``DRYRUN_CLI`` on the multi-pod mesh, writing its record under
    ``tmp``; started, not waited for."""
    src = str(Path(__file__).resolve().parent / "src")
    env = {**os.environ, "PYTHONPATH": src}
    code = ("import sys; from repro_torch.launch import dryrun; "
            "dryrun.RESULTS_DIR = sys.argv[1]; dryrun.main(sys.argv[2:])")
    return [(arch, shape, subprocess.Popen(
        [sys.executable, "-c", code, tmp, "--arch", arch, "--shape", shape,
         "--multi-pod", "--force"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env))
        for arch, shape in DRYRUN_CLI]


def stop_dryrun_cli(procs: list) -> None:
    """Kill (i)'s processes that are still running."""
    for _, _, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def finish_dryrun_cli(procs: list, tmp: str) -> list:
    """Wait for (i)'s processes; each must exit 0 and print its ``[ok``
    line; returns their records."""
    recs = []
    for arch, shape, proc in procs:
        out, _ = proc.communicate(timeout=DRYRUN_CLI_TIMEOUT_S)
        if proc.returncode != 0 or "[ok" not in out:
            raise AssertionError(f"dry run {arch} {shape}: exit "
                                 f"{proc.returncode}\n{out[-3000:]}")
        with open(os.path.join(tmp, f"{arch}__{shape}__2x16x16.json")) as f:
            recs.append(json.load(f))
    return recs


def dryrun_card_cell(arch: str, shape: str, device, k4_launches) -> dict:
    """(ii) one cell: the dry run of ``arch`` x ``shape`` at smoke scale
    ``DRYRUN_SMOKE`` on the 1 x 1 mesh (meta tensors, rank 0 of a fake
    group of one), then the same step on the card from weights and tokens
    drawn from the seed, after a warm-up call, under the same counter.  K4
    launches on the card where the dry run charges it: the card's counts
    add ``flash_cost`` at the launched shape for each launch.  Raises where
    a count disagrees or the peak leaves the band."""
    from repro_torch.configs.shapes import batch_structs
    from repro_torch.kernels.flash_attn.kernel import flash_cost, kernel_launches
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.cost_analysis import tree_bytes
    from repro_torch.optim import init_state

    with dryrun.fake_mesh((1, 1), ("data", "model")) as mesh:
        counter, out, meta = dryrun.lower_cell(arch, shape, mesh,
                                               smoke_scale=DRYRUN_SMOKE)
        dry = {"cost": counter.cost.as_dict(), "memory": counter.memory(out),
               "kernels": counter.kernels}
    del out, counter
    bundle, kind, tcfg = meta["bundle"], meta["kind"], meta["tcfg"]
    cfg = bundle.cfg
    gen = torch.Generator(device=device).manual_seed(SEED + 25)
    params = bundle.init(gen, torch.bfloat16, device)
    structs, _ = batch_structs(bundle, shape, smoke_scale=DRYRUN_SMOKE)
    batch = {k: torch.randint(0, cfg.vocab, tuple(v.shape), generator=gen,
                              device=device, dtype=v.dtype)
             for k, v in structs.items()}
    opt = init_state(params) if kind == "train" else None

    def counted():
        return dryrun.count_step(bundle, kind, params, batch, None, opt,
                                 tcfg=tcfg)

    on_card = device.type == "cuda"  # the CPU rehearsal holds the counts
    counted()  # warm-up: cuBLAS handles and workspaces
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    k4_launches.reset()  # and each kernel's count (kernel_launches)
    counter, out = counted()
    peak = None
    if on_card:
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device) - base
    k4 = k4_launches.count
    k4_by_kernel = {name: c.count for name, c in kernel_launches.items() if c.count}
    del out
    b, s = structs["tokens"].shape
    bh = b * cfg.n_heads
    k4_flops, k4_bytes = flash_cost(bh, b * cfg.n_kv_heads, s, s, cfg.head_dim,
                                    2) if k4 else (0.0, 0.0)
    card = {"flops": counter.cost.flops + k4 * k4_flops,
            "dot_flops": counter.cost.dot_flops + k4 * k4_flops,
            "bytes": counter.cost.bytes + k4 * k4_bytes,
            "argument_size_in_bytes": tree_bytes((params, opt, batch)),
            "peak_above_arguments": peak, "k4_launches": k4,
            "k4_by_kernel": k4_by_kernel}
    want_k4 = dry["kernels"].get("flash_attention", {}).get("launches", 0)
    b_s = tuple(structs["tokens"].shape)
    temp = dry["memory"]["temp_size_in_bytes"]
    name = f"dry run {arch} {shape} (smoke {DRYRUN_SMOKE}, bf16)"
    if card["flops"] != dry["cost"]["flops"] or \
            card["dot_flops"] != dry["cost"]["dot_flops"]:
        raise AssertionError(f"{name}: FLOPs {card['flops']} / products "
                             f"{card['dot_flops']} on the card against "
                             f"{dry['cost']['flops']} / {dry['cost']['dot_flops']}")
    if card["argument_size_in_bytes"] != dry["memory"]["argument_size_in_bytes"]:
        raise AssertionError(f"{name}: argument bytes "
                             f"{card['argument_size_in_bytes']} against "
                             f"{dry['memory']['argument_size_in_bytes']}")
    if k4 != want_k4 or (kind == "prefill" and k4 != cfg.layers):
        raise AssertionError(f"{name}: K4 launched {k4} times, the dry run "
                             f"charges {want_k4}, the layers {cfg.layers}")
    if on_card and k4 and k4_by_kernel != {flash_plan_of(cfg, b_s)[0]: k4}:
        raise AssertionError(f"{name}: K4's launches by kernel {k4_by_kernel}, "
                             f"want all {k4} on {flash_plan_of(cfg, b_s)[0]}")
    if on_card and not abs(peak - temp) <= TOL_DRYRUN_PEAK * temp:
        raise AssertionError(f"{name}: peak above the arguments {peak} bytes "
                             f"against the dry run's temporary {temp} "
                             f"(band {TOL_DRYRUN_PEAK:.0%})")
    ms, traced = None, None
    if on_card and kind == "train":
        step = steps.build_train_step(bundle, tcfg)
        ms = cuda_ms(lambda: step(params, opt, batch), reps=3, warm=1)
    elif on_card:
        step = steps.build_prefill_step(bundle)
        with torch.no_grad():
            ms = cuda_ms(lambda: step(params, batch), reps=3, warm=1)
            # K4's share of the step, read from a trace of the step itself
            traced = profiler_device_ms(lambda: step(params, batch),
                                        K4_KERNELS, reps=3)
    bnd, by = bound_ms(dry["cost"]["flops"], dry["cost"]["bytes"],
                       PEAK_BF16_FLOPS)
    return {"arch": arch, "shape": shape, "smoke_scale": DRYRUN_SMOKE,
            "kind": kind, "dry": dry, "card": card,
            "peak_over_temp": None if peak is None else peak / temp,
            "ms": ms, "bound_ms": bnd, "bound_by": by,
            "device_ms": None if traced is None else traced[0],
            "k4_ms": None if traced is None else traced[1]}


def flash_plan_of(cfg, b_s: tuple) -> tuple[str, int]:
    """The K4 kernel (``FlashPlan.kernel``) and key tile a bf16 prefill of
    ``b_s = (batch, tokens)`` launches in each layer of ``cfg``."""
    from repro_torch.kernels.flash_attn.kernel import flash_plan

    b, s = b_s
    plan = flash_plan(b * cfg.n_heads, s, s, cfg.head_dim,
                      cfg.n_heads // cfg.n_kv_heads, True)
    return plan.kernel, plan.keys


def dryrun_phase(device, k4_launches, card: str, tp_k4_launches: int,
                 cli: list) -> dict:
    """(i) the DeepSeek-V3 records ``cli`` from the CLI on the multi-pod
    mesh (``start_dryrun_cli``, read by ``finish_dryrun_cli`` before the
    arch zoo), (ii) ``DRYRUN_CARD`` held on the card against
    their dry runs, K4 at the prefill's shape (S 2048, bf16 and fp32) and
    at Qwen3-4B's tensor-parallel prefill shape against its plain version,
    timed beside SDPA; that shape's count is ``tp_k4_launches``, K4's
    launches in phase 13 (d)'s ``serve_lm(mesh=)`` run of this process.
    At the prefill's shape each type's wgmma kernel is timed beside its
    kept kernel in the same call (bf16 the mma.sync one, fp32 the FFMA
    one)."""
    from repro_torch.configs import get_bundle
    from repro_torch.configs.shapes import SHAPES

    out: dict = {}
    out["cells"] = [dryrun_card_cell(arch, shape, device, k4_launches)
                    for arch, shape in DRYRUN_CARD]
    _empty_cache(device)
    gen = torch.Generator(device=device).manual_seed(SEED + 26)
    pf = next(c for c in out["cells"] if c["kind"] == "prefill")
    cfg = get_bundle(pf["arch"]).cfg
    b = SHAPES[pf["shape"]]["global_batch"] // DRYRUN_SMOKE
    s = SHAPES[pf["shape"]]["seq_len"] // DRYRUN_SMOKE
    rep = cfg.n_heads // cfg.n_kv_heads
    out["k4"] = [
        {"path": f"dry-run check, {pf['arch']} prefill", **flash_entry(
            b * cfg.n_heads, s, cfg.head_dim, rep,
            pf["card"]["k4_launches"], torch.bfloat16, gen, device,
            TOL_K4_BF16, True, other="mma")},
        {"path": f"the same shape in fp32 (the zoo's type; no path "
                 f"launches it here)", **flash_entry(
            b * cfg.n_heads, s, cfg.head_dim, rep, 0, torch.float32,
            gen, device, TOL_K4, True, other="ffma")},
        {"path": "tensor-parallel serve_lm prefill (phase 13 (d))",
         **flash_entry(*K4_TP_SHAPE, tp_k4_launches, torch.float32,
                       gen, device, TOL_K4, True)}]
    out["cli"] = cli
    return out


def _tiled_entries(e: dict, names: dict, launches, keys: tuple) -> list[dict]:
    """The kernels line's entries for the two tiled kernels of one type
    that phase 15 timed side by side (``e`` and its ``other_kernel``):
    ``names`` maps a plan's kernel to its CUDA name, ``launches(kernel)``
    gives its launch fields, ``keys`` the type's own checks to carry."""
    common = {"route": "cuda", "source": "src/repro_torch/kernels/csrc/flash_attn.cu",
              "replaces": "src/repro/kernels/flash_attn/kernel.py:69",
              "q": e["q"], "kv": e["kv"], "rep": e["rep"], "causal": e["causal"],
              "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
              "bound_by": e["bound_by"], "bounds": e["bounds"],
              "library_ms": e["library_ms"],
              "library_device_ms": e["library_device_ms"],
              "sm_clock": e["sm_clock"]}
    out = []
    for x in (e, e["other_kernel"]):
        kernel = x["plan"]["kernel"]
        out.append({"name": names[kernel], **common, "plan": x["plan"],
                    **launches(kernel), "max_abs_err": x["max_abs_err"],
                    "max_rel_err": x["max_rel_err"], **{k: x[k] for k in keys},
                    "ms": x["ms"], "device_ms": x["device_ms"]})
    return out


def tiled_bf16_kernels(dr: dict) -> list[dict]:
    """The kernels line's entries for K4's two bf16 tiled kernels at the
    dry-run check's shape (phase 15's bf16 K4 entry, the other kernel timed
    in the same call): launches are each kernel's in the prefill step
    phase 15 counted."""
    e = next(x for x in dr["k4"] if x["dtype"] == "bfloat16" and "other_kernel" in x)
    by_kernel = next(c["card"]["k4_by_kernel"] for c in dr["cells"]
                     if c["kind"] == "prefill")
    return _tiled_entries(
        e, {"wgmma": "flash_tiled_bf16_kernel", "mma": "flash_tiled_bf16_mma_kernel"},
        lambda kernel: {"launches": by_kernel.get(kernel, 0)},
        ("tiled_mismatch_share",))


def tiled_fp32_kernels(dr: dict, by_path: dict) -> list[dict]:
    """The kernels line's entries for K4's two fp32 tiled kernels at
    phase 15's fp32 shape (the 3xTF32 kernel and the FFMA one timed in the
    same call): launches are each kernel's over every path that ran
    (``by_path``, path -> launches by kernel), with both bounds and each
    kernel's error against float64."""
    e = next(x for x in dr["k4"] if x["dtype"] == "float32" and "other_kernel" in x)
    return _tiled_entries(
        e, {"tf32x3": "flash_tiled_tf32x3_kernel", "ffma": "flash_tiled_f32_kernel"},
        lambda kernel: {"launches": sum(c.get(kernel, 0) for c in by_path.values()),
                        "launches_by_path": {path: c[kernel] for path, c in
                                             by_path.items() if c.get(kernel)}},
        ("err_fp64", "plain_err_fp64", "fp64_ratio", "fp64_ratio_limit"))


def fp64_text(e: dict) -> str:
    """A K4 fp32 entry's error against float64, for its printed line."""
    if "fp64_ratio" not in e:
        return ""
    limit = e["fp64_ratio_limit"]
    return (f"; against float64 {e['err_fp64']:.2e}, {e['fp64_ratio']:.2f} x the "
            f"fp32 plain version's{'' if limit is None else f' (<= {limit})'}")


def print_dryrun(dr: dict, card: str) -> None:
    """The dry-run phase's lines (``dryrun_phase``'s readings)."""
    for r in dr["cli"]:
        m, c = r["memory"], r["cost"]
        print(f"  dry run {r['arch']} {r['shape']} on 2x16x16 (rank 0 of "
              f"{r['devices']} fake ranks, meta tensors, traced in "
              f"{r['trace_s']} s): per rank arguments "
              f"{_gib(m['argument_size_in_bytes'])}, outputs "
              f"{_gib(m['output_size_in_bytes'])}, temporary "
              f"{_gib(m['temp_size_in_bytes'])}; FLOPs {c['flops']:.6e} "
              f"(products {c['dot_flops']:.6e}), HBM bytes {c['bytes']:.6e}; "
              f"collective wire bytes {c['collective_bytes']:.6e} by axis "
              + ", ".join(f"{ax} {v['calls']} calls {v['wire_bytes']:.6e}"
                          for ax, v in r["by_axis"].items())
              + f"; K4 charges {r['kernels'] or 'none'}")
    for e in dr["cells"]:
        d, c = e["dry"], e["card"]
        print(f"  dry run against the card, {e['arch']} {e['shape']} (smoke "
              f"{e['smoke_scale']}, bf16, no mesh) on {card}: FLOPs "
              f"{c['flops']:.6e} = {d['cost']['flops']:.6e}, products "
              f"{c['dot_flops']:.6e} = {d['cost']['dot_flops']:.6e}; "
              f"arguments {c['argument_size_in_bytes']} = "
              f"{d['memory']['argument_size_in_bytes']} bytes; peak above "
              f"them {_gib(c['peak_above_arguments'])} against the "
              f"temporary {_gib(d['memory']['temp_size_in_bytes'])} (ratio "
              f"{e['peak_over_temp']}, band {TOL_DRYRUN_PEAK:.0%}); K4 "
              f"launched {c['k4_launches']} {c.get('k4_by_kernel') or ''}, charged "
              f"{d['kernels'].get('flash_attention', {}).get('launches', 0)}; "
              f"{_ms(e['ms'])} ms a step against the bound "
              f"{e['bound_ms']:.4f} ms (by {e['bound_by']})"
              + ("" if e["kind"] != "prefill" else
                 f"; in a trace of the step (torch.profiler, 3 calls) "
                 f"{_ms(e['device_ms'])} device ms a step, of which K4's "
                 f"{c['k4_launches']} launches {_ms(e['k4_ms'])}"))
    def walk(e):
        return ("" if "tiled_row_err" not in e else
                f"; against the {e['key_tile']}-key tile-order walk rows "
                f"within {e['tiled_row_err']:.2e} <= {TOL_K4_BF16} of their "
                f"own max, {e['tiled_mismatch_share']:.3%} of the bits differ "
                f"<= {K4_BF16_TILED_MISMATCH:.3%}, p left whole "
                f"{e['whole_p_mismatch_share']:.2%} > {K4_BF16_WHOLE_P:.0%}")

    for e in dr["k4"]:
        print(f"  K4 at {e['q']} rep {e['rep']} {e['dtype']} ({e['path']}, "
              f"{e['plan']['route']} route, {e['plan']['kernel']} kernel): "
              f"{_ms(e['ms'])} ms, device {_ms(e['device_ms'])}, plain "
              f"{_ms(e['plain_ms'])}, SDPA {_ms(e['library_ms'])} / device "
              f"{_ms(e['library_device_ms'])}, bound {e['bound_ms']:.5f} by "
              f"{e['bound_by']}"
              + ("" if e["bounds"] is None else
                 f" (FFMA bound {e['bounds']['ffma_ms']:.5f})")
              + f"; rel err {e['max_rel_err']:.2e} <= {e['tol']}"
              + walk(e) + fp64_text(e))
        o = e.get("other_kernel")
        if o is not None:
            print(f"    the {o['plan']['kernel']} kernel on the same inputs in "
                  f"the same call: {_ms(o['ms'])} ms, device "
                  f"{_ms(o['device_ms'])}; rel err "
                  f"{o['max_rel_err']:.2e}" + walk(o) + fp64_text(o))
            print("    " + clock_line("both kernels' timing", e["sm_clock"]))


# -- the autotune ledger: K1/K2 launch plans swept per cell -----------------
def k1_pass_ms(inputs) -> float:
    """Device ms of one K1 launch at each of ``inputs`` (``(xe, ke,
    stride)``, one per layer), as the wrapper launches it now."""
    from repro_torch.kernels.conv2d.kernel import coded_worker

    return sum(device_ms(lambda a=a: coded_worker(*a)) for a in inputs)


def autotune_phase(device, counters, card: str) -> dict:
    """Phase 16: ``autotune_kernels`` on the VGG-16 pipeline at bucket 8
    into the run's temporary ledger, the K1 pass timed before and after,
    a tuned pass held to the uncoded stack, and a second call that must
    sweep nothing.  Raises where a check fails."""
    from repro_torch.core.pipeline import build_cnn_pipeline
    from repro_torch.kernels import autotune
    from repro_torch.models.cnn import init_cnn

    t0 = time.perf_counter()
    params = init_cnn(ARCH, torch.Generator().manual_seed(SEED), device)
    pipe = build_cnn_pipeline(ARCH, params, N_WORKERS, default_kab=KAB,
                              input_hw=HW, backend="kernel",
                              bucket_sizes=(BUCKET,), fuse_transitions=True,
                              device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    inputs = [(torch.randn(xs, generator=gen, device=device),
               torch.randn(ks, generator=gen, device=device), stride)
              for xs, ks, stride in worker_shapes(pipe, BUCKET)]
    if autotune.load_cache():
        raise AssertionError(f"the run's ledger {autotune.cache_path()} is "
                             f"not empty before the sweep")
    untuned = k1_pass_ms(inputs)
    swept0, ts = autotune.sweep_count(), time.perf_counter()
    tuned = pipe.autotune_kernels((BUCKET,), repeat=3)
    sweep_s = time.perf_counter() - ts
    swept = autotune.sweep_count() - swept0
    if swept != len(tuned) or not tuned:
        raise AssertionError(f"{swept} sweeps for {len(tuned)} cells")
    ledger = autotune.load_cache()
    cells = []
    for key, win in tuned.items():
        e = ledger[key]
        heur = e["swept"][0]  # the heuristic's plan leads every candidate set
        if e["us"] > heur["us"]:
            raise AssertionError(f"{key}: winner {e['us']} us slower than the "
                                 f"heuristic's {heur['us']} us")
        cells.append({"key": key, "heuristic": heur["params"],
                      "heuristic_us": heur["us"], "winner": win,
                      "winner_us": e["us"], "candidates": len(e["swept"])})
    tuned_ms = k1_pass_ms(inputs)
    xs = np.random.default_rng(SEED).standard_normal(
        (BUCKET,) + pipe.input_shape).astype(np.float32)
    _reset(counters)
    y = pipe.run(torch.as_tensor(xs, device=device))
    torch.cuda.synchronize()
    launches = _launches(counters)
    if not all(launches.values()):
        raise AssertionError(f"the tuned pass launched {launches}")
    worst = check_served(list(y.cpu()), xs, params, device)
    again = autotune.sweep_count()
    if pipe.autotune_kernels((BUCKET,)) != tuned or autotune.sweep_count() != again:
        raise AssertionError("a second autotune_kernels call swept again")
    return {"card": card, "ledger": autotune.cache_path(), "cells": cells,
            "swept": swept, "second_call_swept": autotune.sweep_count() - again,
            "sweep_s": sweep_s, "k1_pass_device_ms": {"untuned": untuned,
                                                      "tuned": tuned_ms},
            "max_rel_err": worst, "launches": launches,
            "seconds": time.perf_counter() - t0}


def print_autotune(at: dict, card: str) -> None:
    print(f"autotune phase on {card}: {at['swept']} cells swept in "
          f"{at['sweep_s']:.1f} s into {at['ledger']}; heuristic vs winner, "
          f"device us:")
    for c in at["cells"]:
        print(f"  {c['key']}: {json.dumps(c['heuristic'])} {c['heuristic_us']}"
              f" -> {json.dumps(c['winner'])} {c['winner_us']} "
              f"({c['candidates']} candidates)")
    k = at["k1_pass_device_ms"]
    print(f"K1 pass at bucket {BUCKET}: {k['untuned']:.4f} device ms untuned, "
          f"{k['tuned']:.4f} tuned; tuned pass vs uncoded max rel err "
          f"{at['max_rel_err']:.2e} <= {TOL_SERVE}; launches {at['launches']}; "
          f"second call swept {at['second_call_swept']} cells "
          f"({at['seconds']:.1f} s)")


# -- the process mesh: SPMD over torch.distributed ----------------------------

# (a) VGG-16 at 224, batch DIST_BATCH, every ConvL through run_sharded on
# DIST_RANKS ranks of one card (plan n = 4, (k_a, k_b) = (2, 4), delta 2),
# once a survivor subset.  Against the uncoded stack, relative to
# max|uncoded|: the same 13 layers of fp32 sums and CRME decodes as the
# served VGG-16, held to the served tolerance (TOL_SERVE).
DIST_RANKS, DIST_PLAN, DIST_SURVIVORS, DIST_BATCH = 4, (4, 2, 4), ([3, 1], [0, 2]), 8
# (b) SmolLM-135M data-parallel on 2 ranks, DIST_TRAIN_STEPS of
# TRAIN_BATCH x TRAIN_SEQ tokens at lr DIST_LR, eagerly: two half-batch
# gradients averaged against one full-batch gradient (fp32 sums in
# another order): the losses within 1e-5 relative of the one-process
# train, and each step's gradient norm too (a wrong averaging factor
# shows there; Adam's step does not see a uniform scale).  The params are
# held against the one-process step with microbatches=2, which sums the
# two halves' gradients as the ranks do (halving is exact in fp32),
# within 1e-4 of each leaf's max|p|: what is left is the collectives' own
# error.  Against the full-batch run the reduction order differs, and
# Adam's normalised update lets an element whose gradients nearly cancel
# move by up to about lr a step either way on a rounding difference; so
# besides 1e-4 of max|p| an element may differ by twice the summed
# learning rates (the bound of tests/test_torch_distributed.py's int8
# runs), at most DIST_FLIP_FRACTION of a leaf's elements.
# The int8 run over (pod 2, data 1) is held finite and falling: its
# quantised gradient may round one step (1/127 of a leaf's absmax)
# otherwise at a reduction-order difference, so no one-process run is
# its bitwise twin.
DIST_TRAIN_STEPS, DIST_LR, TOL_DIST_LOSS, TOL_DIST_PARAM = 5, 3e-4, 1e-5, 1e-4
TOL_DIST_NORM, DIST_FLIP_FRACTION = 1e-5, 0.01
# (c) serve_lm data-parallel on 2 ranks (data 2): the tokens equal
DIST_SERVE = {"batch": 4, "prompt_len": 16, "gen": 16}
DIST_TIMEOUT_S = 600
# (d) tensor and expert parallelism over the mesh's model axis, ranks
# sharing the card over gloo.  Served over (data 1, model 2): Qwen3-4B at
# full width and depth and DeepSeek-V2 at full width on 1 dense-first and
# 1 MoE layer (80 of its 160 experts a rank), DIST_SERVE's batch and
# lengths, eagerly (the steps hold collectives), the tokens equal to one
# process's from the same weights and every call's logits within
# TOL_TP_LOGITS of max|logit| (36 layers of fp32 sums whose ranks' partial
# products add in another order, and a decode step over the
# sequence-cut cache merging the ranks' partial softmaxes by
# log-sum-exp).  SmolLM-135M trained over (data 2, model 2) on 4 ranks,
# FSDP on, as (b): its 9 heads cut at 288 of 576 columns, inside a head.
TP_SERVE = (("qwen3-4b", None), ("deepseek-v2-236b", 2))
TP_RANKS_SERVE, TP_RANKS_TRAIN, TOL_TP_LOGITS = 2, 4, 1e-4
# (e) the recurrent and encoder-decoder families over the model axis.
# Served over (data 1, model 2) at full width and depth, DIST_SERVE's batch
# and lengths, eagerly, each rank drawing its cut of the params: the tokens
# equal to the one-process serve_lm's and every call's logits within
# TOL_TP_LOGITS of max|logit| (Hymba, Whisper); RWKV6's fp32 stack
# amplifies rounding with depth (PERF.md), so its ranks' logits are held
# to a float64 one-process run teacher-forced on the ranks' tokens, within
# twice the one-process fp32 run's own distance from it, and each greedy
# token where the float64 top-2 margin exceeds twice that bound.  Then
# prefill_fn over the prompts (Whisper's over 4 x 1500 random frames),
# whose K4 launches every rank makes: Hymba's every head (25 a layer,
# wq cut inside a head), Whisper's 8 heads a rank for its encoder,
# decoder self- and cross-attention; its logits within TOL_TP_LOGITS of one
# process's.  Trained over (data 2, model 2) through train(mesh=...) at
# full width on TP_FAMILY_LAYERS layers (Whisper's encoder and decoder
# alike), TP_FAMILY_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens, FSDP
# on, each loss within TOL_DIST_LOSS of the one-process train's (the
# gradient norms printed beside).  RWKV6 trains in float64 there: in fp32
# at full width its gradient norm at step 1, before any update, is
# 6.1e-05 apart between the ranks' and one process's sums (2 layers;
# 4.6e-06 at 1), and the loss after the first update 1.45e-05, while in
# float64 the two agree to the norm's own fp32 rounding (on an H100,
# PERF.md): the scan's cumulated log-decays amplify rounding, as its
# served logits show.
TP_FAMILY_F64 = ("rwkv6-1.6b",)
TP_FAMILIES = ("rwkv6-1.6b", "hymba-1.5b", "whisper-medium")
TP_FAMILY_LAYERS, TP_FAMILY_STEPS = 2, 3
# a CPU rehearsal's sequence (Whisper's smoke decoder holds 64 positions)
TP_FAMILY_SMOKE_SEQ = 32


def _no_tf32() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def dist_vgg16_rank(rank: int, device: str, smoke: bool) -> dict:
    """Rank ``rank`` of ``DIST_RANKS``: VGG-16's 13 ConvLs through
    ``CodedConv2d.run_sharded`` on the ``workers`` axis, ReLU and pool
    between as ``models/cnn.py`` runs them, once for each survivor subset;
    the final features, K1's launches in each pass and the seconds of each
    layer's worker, all-gather and decode.  ``smoke``: VGG-16 at its
    smoke size, batch 2 (a CPU rehearsal)."""
    from repro_torch.core.fcdcc import CodedConv2d, FcdccPlan
    from repro_torch.core.pipeline import relu_pool
    from repro_torch.kernels.conv2d.kernel import launches as k1_launches
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models.cnn import CNN_SPECS, init_cnn, layer_geometry

    _no_tf32()
    mesh = make_process_mesh((DIST_RANKS,), ("workers",), device=device)
    n, k_a, k_b = DIST_PLAN
    plan = FcdccPlan(n=n, k_a=k_a, k_b=k_b)
    params = init_cnn(ARCH, torch.Generator().manual_seed(SEED), mesh.device)
    x = torch.from_numpy(_dist_input(smoke)).to(mesh.device)
    out = {"backend": mesh.backend, "device": str(mesh.device), "passes": []}
    for ids in DIST_SURVIVORS:
        k1_launches.reset()
        t0 = time.perf_counter()
        h, layers = x, []
        for layer in CNN_SPECS[ARCH][1]:
            coded = CodedConv2d(plan, layer_geometry(layer, h.shape[-1], k_a, k_b))
            t = {"layer": layer.name}
            y = coded.run_sharded(mesh, "workers", h, params[layer.name],
                                  worker_ids=ids, timings=t)
            h = relu_pool(y, layer.pool)
            layers.append(t)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        out["passes"].append({"survivors": ids, "features": h,
                              "k1": k1_launches.count, "layers": layers,
                              "wall_s": time.perf_counter() - t0})
    out["collectives"] = dict(mesh.stats)
    return out


def _dist_input(smoke: bool) -> np.ndarray:
    from repro_torch.models.cnn import input_hw

    hw, b = (input_hw(ARCH, smoke=True), 2) if smoke else (HW, DIST_BATCH)
    return np.random.default_rng(SEED).standard_normal(
        (b, 3, hw, hw)).astype(np.float32)


def dist_lm_rank(rank: int, ckpt_dir: str, device: str, smoke: bool) -> dict:
    """Rank ``rank`` of 2: SmolLM-135M trained data-parallel with FSDP
    (data 2, model 1) through ``train(mesh=...)``, its last checkpoint
    restored into this rank's shards and gathered; then trained over
    (pod 2, data 1) with int8 gradient compression; then served
    data-parallel through ``serve_lm(mesh=...)``.  ``smoke``: the smoke
    config (a CPU rehearsal)."""
    from repro_torch.checkpoint import restore
    from repro_torch.configs import get_bundle
    from repro_torch.kernels.flash_attn.kernel import launches as k4_launches
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.serve import serve_lm
    from repro_torch.launch.train import train
    from repro_torch.sharding import gather_tree, shard_tree
    from repro_torch.optim import init_state
    from repro_torch.tree import tree_leaves

    _no_tf32()
    data = make_process_mesh((2, 1), ("data", "model"), device=device)
    pod = make_process_mesh((2, 1, 1), ("pod", "data", "model"), device=device)
    dev = data.device
    cuda = dev.type == "cuda"
    out = {"backend": data.backend}
    for label, mesh, kw in (("fsdp", data, {"ckpt_dir": ckpt_dir,
                                             "ckpt_every": DIST_TRAIN_STEPS}),
                            ("int8_pod", pod, {"grad_compression": "int8"})):
        stamps, coll, norms = [], [], []

        def on_step(step, metrics, mesh=mesh, stamps=stamps, coll=coll,
                    norms=norms):
            stamps.append(time.perf_counter())
            coll.append(mesh.stats["collective_s"])
            norms.append(float(metrics["grad_norm"]))

        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        c0, t0 = mesh.stats["collective_s"], time.perf_counter()
        losses = train(TRAIN_ARCH, steps=DIST_TRAIN_STEPS, batch=TRAIN_BATCH,
                       seq=TRAIN_SEQ, smoke=smoke, device=device, seed=SEED,
                       lr=DIST_LR, graphs=False, mesh=mesh, on_step=on_step,
                       log_every=DIST_TRAIN_STEPS, **kw)
        steps_ms = np.diff([t0] + stamps) * 1e3
        coll_ms = np.diff([c0] + coll) * 1e3
        out[label] = {"losses": losses, "grad_norms": norms,
                      "ms_per_step": steps_ms.tolist(),
                      "collective_ms_per_step": coll_ms.tolist(),
                      "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                     if cuda else None)}
    # the FSDP run's last checkpoint into this rank's shards, then gathered
    bundle = get_bundle(TRAIN_ARCH, smoke=smoke)
    step = steps.build_train_step(bundle, steps.TrainConfig(), data)
    like = shard_tree(bundle.init(torch.Generator().manual_seed(SEED),
                                  device=dev), step.param_shardings)
    state = restore(ckpt_dir, DIST_TRAIN_STEPS,
                    {"params": like, "opt": init_state(like)},
                    shardings={"params": step.param_shardings,
                               "opt": step.opt_shardings})
    gathered = gather_tree(state["params"], step.param_shardings)
    out["fsdp"]["gathered"] = gathered if rank == 0 else None
    out["fsdp"]["shard_numel"] = sum(t.numel() for t in
                                     tree_leaves(state["params"]))
    del like, state, gathered
    k4_launches.reset()
    t0 = time.perf_counter()
    timings = {}
    out["serve"] = {"tokens": serve_lm(TRAIN_ARCH, device=device, seed=SEED,
                                       smoke=smoke, mesh=data, timings=timings,
                                       **DIST_SERVE),
                    "k4": k4_launches.count, "k4_kernels": k4_by_kernel(),
                    "wall_s": time.perf_counter() - t0,
                    "decode_s": timings["decode_s"],
                    "prefill_s": timings["prefill_s"]}
    return out


def _tp_spy():
    """Record ``(BH, S, D, rep)`` of every K4 call the transformer makes in
    this process (BH: ``B x`` query heads); returns the list."""
    from repro_torch.models import transformer

    seen, launch = [], transformer.flash_attention

    def spy(q, k, v, **kw):
        seen.append((int(q.shape[0]), int(q.shape[1]), int(q.shape[2]),
                     int(q.shape[0]) // int(k.shape[0])))
        return launch(q, k, v, **kw)

    transformer.flash_attention = spy
    return seen


def _axis_stats(mesh) -> dict:
    return {k: {"calls": v["calls"], "ms": v["s"] * 1e3, "bytes": v["bytes"]}
            for k, v in mesh.stats["by_axis"].items()}


def _shard_bytes(bundle, mesh, fsdp: bool = False) -> int:
    """The fp32 bytes of this rank's cut of every leaf, reckoned from the
    schema's shardings."""
    from repro_torch.models.common import schema_shardings
    from repro_torch.tree import tree_leaves

    total = 0
    for spec, sh in zip(tree_leaves(bundle.schema),
                        tree_leaves(schema_shardings(bundle.schema, mesh, fsdp))):
        n = math.prod(spec.shape)
        for d, entry in enumerate(sh.spec):
            for a in ((entry,) if isinstance(entry, str) else (entry or ())):
                n //= mesh.shape[a]
        total += n * 4
    return total


def dist_tp_serve_rank(rank: int, device: str, smoke: bool) -> dict:
    """Rank ``rank`` of (data 1, model 2): each arch of ``TP_SERVE``
    through ``serve_lm(mesh=...)``, eagerly, each rank drawing its cut of
    the params a leaf at a time: the tokens, every call's logits (rank 0),
    K4's launches and the query heads of each, ms a step, the collectives
    by axis, peak memory beside the reckoned shard bytes."""
    from repro_torch.configs import get_bundle
    from repro_torch.kernels.flash_attn.kernel import launches as k4_launches
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models.registry import with_layers

    _no_tf32()
    mesh = make_process_mesh((1, TP_RANKS_SERVE), ("data", "model"),
                             device=device)
    dev = mesh.device
    heads = _tp_spy()
    out = {"backend": mesh.backend}
    for arch, layers in TP_SERVE:
        bundle = get_bundle(arch, smoke=smoke)
        if layers is not None:
            bundle = with_layers(bundle, layers)
        rows, timings = [], {}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        mesh.stats["by_axis"].clear()
        heads.clear()
        k4_launches.reset()
        t0 = time.perf_counter()
        toks = serve_lm(arch, device=device, seed=SEED, smoke=smoke, mesh=mesh,
                        layers=layers, graphs=False, timings=timings,
                        on_logits=lambda lg, rows=rows: rows.append(
                            lg.cpu() if rank == 0 else None), **DIST_SERVE)
        wall = time.perf_counter() - t0
        out[arch] = {
            "tokens": toks, "logits": rows if rank == 0 else None,
            "k4": k4_launches.count, "k4_kernels": k4_by_kernel(),
            "k4_heads": [s[0] for s in heads],
            "layers": bundle.cfg.layers, "wall_s": wall,
            "prefill_s": timings["prefill_s"], "decode_s": timings["decode_s"],
            "init_s": timings["init_s"], "collectives": _axis_stats(mesh),
            "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None),
            "shard_bytes": _shard_bytes(bundle, mesh)}
        if bundle.cfg.moe is not None:
            out[arch]["experts_per_rank"] = (bundle.cfg.moe.n_routed
                                             // TP_RANKS_SERVE)
        _empty_cache(dev)
    return out


def dist_tp_train_rank(rank: int, ckpt_dir: str, device: str, smoke: bool
                       ) -> dict:
    """Rank ``rank`` of (data 2, model 2): SmolLM-135M trained through
    ``train(mesh=...)``, FSDP on, eagerly, its last checkpoint written by
    rank 0: the losses and gradient norms, ms a step, the collectives a
    step by axis, peak memory beside the reckoned shard bytes."""
    from repro_torch.configs import get_bundle
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.train import train

    _no_tf32()
    mesh = make_process_mesh((2, TP_RANKS_TRAIN // 2), ("data", "model"),
                             device=device)
    dev = mesh.device
    stamps, norms, coll = [], [], []

    def on_step(step, metrics):
        stamps.append(time.perf_counter())
        norms.append(float(metrics["grad_norm"]))
        coll.append(_axis_stats(mesh))

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    losses = train(TRAIN_ARCH, steps=DIST_TRAIN_STEPS, batch=TRAIN_BATCH,
                   seq=TRAIN_SEQ, smoke=smoke, device=device, seed=SEED,
                   lr=DIST_LR, graphs=False, mesh=mesh, on_step=on_step,
                   ckpt_dir=ckpt_dir, ckpt_every=DIST_TRAIN_STEPS,
                   log_every=DIST_TRAIN_STEPS)
    return {"backend": mesh.backend, "losses": losses, "grad_norms": norms,
            "ms_per_step": (np.diff([t0] + stamps) * 1e3).tolist(),
            "collectives_per_step": coll,
            "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None),
            "shard_bytes": _shard_bytes(get_bundle(TRAIN_ARCH, smoke=smoke),
                                        mesh, fsdp=True)}


def _timed(fn, *args, **kw):
    """``(fn(*args, **kw), its seconds)``."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def _ranks_at_once(dev: str, *jobs) -> list:
    """Each ``(fn, world, args, store)`` through ``run_ranks`` on ``dev``,
    all at once (the jobs are bound by their collectives' trips through
    the host, not by the card): ``(results, seconds)`` of each, in
    order."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch.mesh import run_ranks

    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = [pool.submit(_timed, run_ranks, fn, world, *args, device=dev,
                            timeout_s=DIST_TIMEOUT_S, store_path=store)
                for fn, world, args, store in jobs]
        return [f.result() for f in futs]


def tensor_parallel_part(device, dev: str, smoke: bool, tmp: str,
                         one_losses: list, one_norms: list, full: dict,
                         init: dict) -> dict:
    """Part (d): serving over (data 1, model 2) and training over (data 2,
    model 2), the two jobs at once, each held against this process's
    one-process run, which runs after the ranks exit."""
    from repro_torch.configs import get_bundle
    from repro_torch.checkpoint import restore
    from repro_torch.launch.serve import serve_lm
    from repro_torch.optim import init_state

    out = {}
    (tr, train_s), (sv, serve_s) = _ranks_at_once(
        dev, (dist_tp_train_rank, TP_RANKS_TRAIN,
              (os.path.join(tmp, "tp"), dev, smoke),
              os.path.join(tmp, "store-tp-train")),
        (dist_tp_serve_rank, TP_RANKS_SERVE, (dev, smoke),
         os.path.join(tmp, "store-tp-serve")))
    loss_err = max(abs(a - b) / abs(b) for res in tr
                   for a, b in zip(res["losses"], one_losses))
    if not loss_err <= TOL_DIST_LOSS:
        raise AssertionError(f"(data 2, model 2) losses vs one process: max "
                             f"rel err {loss_err:.2e} > {TOL_DIST_LOSS}")
    norm_err = max(abs(a - b) / abs(b) for res in tr
                   for a, b in zip(res["grad_norms"], one_norms))
    bundle = get_bundle(TRAIN_ARCH, smoke=smoke)
    like = {"params": init, "opt": init_state(init)}
    tp = restore(os.path.join(tmp, "tp"), DIST_TRAIN_STEPS, like)["params"]
    out["train"] = {"ranks": TP_RANKS_TRAIN, "mesh": "(data 2, model 2)",
                    "backend": tr[0]["backend"], "run_ranks_s": train_s,
                    "losses": tr[0]["losses"], "loss_max_rel_err": loss_err,
                    "grad_norm_max_rel_err": norm_err,
                    "param_full_batch": hold_full_batch(tp, full, init),
                    **{k: [res[k] for res in tr]
                       for k in ("ms_per_step", "peak_bytes", "shard_bytes")},
                    "collectives_per_step": tr[0]["collectives_per_step"]}
    del tp, like, bundle

    out["serve"] = {"ranks": TP_RANKS_SERVE, "mesh": "(data 1, model 2)",
                    "run_ranks_s": serve_s, "archs": []}
    k4_total, k4_kernels = 0, {}
    for arch, layers in TP_SERVE:
        rows = []
        want = serve_lm(arch, device=device, seed=SEED, smoke=smoke,
                        layers=layers, graphs=False,
                        on_logits=lambda lg: rows.append(lg.cpu()), **DIST_SERVE)
        got = sv[0][arch]
        for r, res in enumerate(sv):
            if not torch.equal(torch.from_numpy(res[arch]["tokens"]), want.cpu()):
                raise AssertionError(f"serve_lm {arch} over (data 1, model 2): "
                                     f"rank {r}'s tokens differ from one "
                                     f"process's")
        err = max(_max_rel(a, b) for a, b in zip(got["logits"], rows))
        if len(got["logits"]) != len(rows):
            raise AssertionError(f"{arch}: {len(got['logits'])} logits calls "
                                 f"over the mesh, {len(rows)} in one process")
        if arch == "qwen3-4b" and not err <= TOL_TP_LOGITS:
            raise AssertionError(f"serve_lm {arch} over (data 1, model 2): "
                                 f"logits max rel err {err:.2e} > "
                                 f"{TOL_TP_LOGITS}")
        cfg = get_bundle(arch, smoke=smoke).cfg
        # K4 takes GQA's prefill (MLA's v is narrower than its q: plain)
        local_heads = (DIST_SERVE["batch"] * cfg.n_heads // TP_RANKS_SERVE
                       if cfg.attn == "gqa" else None)
        if dev != "cpu" and local_heads is not None:
            for r, res in enumerate(sv):
                if res[arch]["k4"] != res[arch]["layers"] or any(
                        h != local_heads for h in res[arch]["k4_heads"]):
                    raise AssertionError(
                        f"{arch} rank {r}: K4 launched {res[arch]['k4']} times "
                        f"at {sorted(set(res[arch]['k4_heads']))} query heads, "
                        f"want {res[arch]['layers']} at {local_heads}")
        k4_total += sum(res[arch]["k4"] for res in sv)
        k4_kernels = _add_counts(k4_kernels, *(res[arch]["k4_kernels"] for res in sv))
        out["serve"]["archs"].append({
            "arch": arch, "layers": got["layers"], "tokens_equal": True,
            "logits_max_rel_err": err, "k4_heads": local_heads,
            "experts_per_rank": got.get("experts_per_rank"),
            **{k: [res[arch][k] for res in sv]
               for k in ("k4", "init_s", "prefill_s", "decode_s", "wall_s",
                         "peak_bytes", "shard_bytes", "collectives")}})
        del rows, want
        _empty_cache(device)
    out["by_path"] = {"serve_lm_tp": {"flash_attention": k4_total}}
    out["k4_by_path"] = {"serve_lm_tp": k4_kernels}
    return out


def print_tensor_parallel(tp: dict, card: str) -> None:
    """Part (d)'s lines."""
    t = tp["train"]
    med = [float(np.median(ms[1:])) for ms in t["ms_per_step"]]
    c = t["collectives_per_step"]
    per_axis = {ax: {"calls": (c[-1][ax]["calls"] - c[0][ax]["calls"])
                     / (len(c) - 1),
                     "ms": (c[-1][ax]["ms"] - c[0][ax]["ms"]) / (len(c) - 1),
                     "MB": (c[-1][ax]["bytes"] - c[0][ax]["bytes"])
                     / (len(c) - 1) / 1e6} for ax in c[-1] if ax in c[0]}
    print(f"  (d) train {TRAIN_ARCH} over {t['mesh']} on {t['ranks']} ranks "
          f"({t['backend']}), FSDP on, {DIST_TRAIN_STEPS} steps of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, eager, on {card}: losses "
          f"{[round(x, 5) for x in t['losses']]}, max rel err vs one process "
          f"{t['loss_max_rel_err']:.2e} <= {TOL_DIST_LOSS}, gradient norms "
          f"{t['grad_norm_max_rel_err']:.2e}; params after step "
          f"{DIST_TRAIN_STEPS} vs the full batch: furthest leaf "
          f"{t['param_full_batch']['leaf']} {t['param_full_batch']['rel']:.2e} "
          f"of max|p| ({t['param_full_batch']['beyond']} elements beyond "
          f"{TOL_DIST_PARAM}); ms a step (median of steps 2-{DIST_TRAIN_STEPS}) "
          f"per rank {[round(m, 1) for m in med]}; collectives a step by axis "
          + "; ".join(f"{ax} {v['calls']:.0f} calls {v['ms']:.1f} ms "
                      f"{v['MB']:.1f} MB" for ax, v in per_axis.items())
          + f"; peak {[_gib(b) for b in t['peak_bytes']]} against shards of "
          f"{[_gib(b) for b in t['shard_bytes']]} a rank")
    for a in tp["serve"]["archs"]:
        dec = [s / DIST_SERVE["gen"] * 1e3 for s in a["decode_s"]]
        coll = a["collectives"][0]
        print(f"  (d) serve_lm {a['arch']} at full width, {a['layers']} layers, "
              f"over {tp['serve']['mesh']} ({tp['serve']['ranks']} ranks), batch "
              f"{DIST_SERVE['batch']}, {DIST_SERVE['prompt_len']} + "
              f"{DIST_SERVE['gen']} tokens, eager, on {card}: tokens equal to "
              f"one process's, logits max rel err {a['logits_max_rel_err']:.2e}"
              + (f" <= {TOL_TP_LOGITS}" if a["arch"] == "qwen3-4b" else "")
              + (f"; K4 launches per rank {a['k4']} at {a['k4_heads']} query "
                 f"heads (B x local heads)" if a["k4_heads"] else
                 f"; K4 launches per rank {a['k4']} (MLA attends plain)")
              + (f"; {a['experts_per_rank']} experts a rank"
                 if a["experts_per_rank"] else "")
              + f"; init s {[round(x, 2) for x in a['init_s']]}, prefill s "
              f"{[round(x, 3) for x in a['prefill_s']]}, decode ms a step "
              f"{[round(x, 1) for x in dec]} ({[round(x / a['layers'], 2) for x in dec]}"
              f" a layer); rank 0's collectives "
              + "; ".join(f"{ax} {v['calls']} calls {v['ms']:.1f} ms "
                          f"{v['bytes'] / 1e6:.1f} MB" for ax, v in coll.items())
              + f"; peak {[_gib(b) for b in a['peak_bytes']]} against shards of "
              f"{[_gib(b) for b in a['shard_bytes']]} a rank")
    print(f"  (d) run_ranks s (the two jobs at once): train "
          f"{tp['train']['run_ranks_s']:.1f}, serve "
          f"{tp['serve']['run_ranks_s']:.1f}")


def _family_prompts(bundle, device) -> dict:
    """The prompts ``serve_lm(seed=SEED)`` draws, as a ``prefill_fn`` batch
    on ``device`` (Whisper's with random frames from the seed)."""
    cfg = bundle.cfg
    gen = torch.Generator().manual_seed(SEED + 1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (DIST_SERVE["batch"],
                                                    DIST_SERVE["prompt_len"]),
                                     generator=gen).to(device)}
    if bundle.family == "encdec":
        batch["frames"] = torch.randn(
            (DIST_SERVE["batch"], cfg.enc_len, cfg.d_model),
            generator=torch.Generator().manual_seed(SEED + 3)).to(device)
    return batch


def dist_tp_family_serve_rank(rank: int, device: str, smoke: bool) -> dict:
    """Rank ``rank`` of (data 1, model 2): each arch of ``TP_FAMILIES``
    through ``serve_lm(mesh=...)``, eagerly, from this rank's cut of the
    params drawn a leaf at a time, then ``prefill_fn`` over the same
    prompts: the tokens, every call's logits and the prefill's (rank 0),
    K4's launches and the query heads of each in the prefill, ms a step,
    the collectives by axis, peak memory beside the reckoned shard
    bytes."""
    from repro_torch.configs import get_bundle
    from repro_torch.kernels.flash_attn.kernel import launches as k4_launches
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models.common import schema_shardings
    from repro_torch.sharding import use_mesh

    _no_tf32()
    mesh = make_process_mesh((1, TP_RANKS_SERVE), ("data", "model"),
                             device=device)
    dev = mesh.device
    cuda = dev.type == "cuda"
    heads = _tp_spy()
    out = {"backend": mesh.backend}
    for arch in TP_FAMILIES:
        bundle = get_bundle(arch, smoke=smoke)
        rows, timings = [], {}
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        mesh.stats["by_axis"].clear()
        params = bundle.init(torch.Generator(device=dev).manual_seed(SEED),
                             torch.float32, dev,
                             schema_shardings(bundle.schema, mesh))
        t0 = time.perf_counter()
        toks = serve_lm(arch, device=device, seed=SEED, smoke=smoke, mesh=mesh,
                        params=params, graphs=False, timings=timings,
                        on_logits=lambda lg, rows=rows: rows.append(
                            lg.cpu() if rank == 0 else None), **DIST_SERVE)
        wall = time.perf_counter() - t0
        coll = _axis_stats(mesh)
        heads.clear()
        k4_launches.reset()
        with use_mesh(mesh), torch.no_grad():
            t0 = time.perf_counter()
            pre = bundle.prefill_fn(params, _family_prompts(bundle, dev))
            if cuda:
                torch.cuda.synchronize(dev)
            prefill_s = time.perf_counter() - t0
        out[arch] = {
            "tokens": toks, "logits": rows if rank == 0 else None,
            "prefill": pre.cpu() if rank == 0 else None,
            "k4": k4_launches.count, "k4_kernels": k4_by_kernel(),
            "k4_heads": [s[0] for s in heads],
            "layers": getattr(bundle.cfg, "layers", None)
            or bundle.cfg.dec_layers, "wall_s": wall,
            "decode_s": timings["decode_s"], "prefill_fn_s": prefill_s,
            "collectives": coll,
            "peak_bytes": (torch.cuda.max_memory_allocated(dev) if cuda
                           else None),
            "shard_bytes": _shard_bytes(bundle, mesh)}
        del params, pre
        _empty_cache(dev)
    return out


def _train_dtype(arch: str) -> torch.dtype:
    return torch.float64 if arch in TP_FAMILY_F64 else torch.float32


def dist_tp_family_train_rank(rank: int, device: str, smoke: bool) -> dict:
    """Rank ``rank`` of (data 2, model 2): each arch of ``TP_FAMILIES``
    trained through ``train(mesh=...)`` on ``TP_FAMILY_LAYERS`` layers,
    FSDP on, eagerly: the losses, ms a step, the collectives a step by
    axis, peak memory beside the reckoned shard bytes."""
    from repro_torch.configs import get_bundle
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.train import train
    from repro_torch.models.registry import with_layers

    _no_tf32()
    mesh = make_process_mesh((2, TP_RANKS_TRAIN // 2), ("data", "model"),
                             device=device)
    dev = mesh.device
    out = {"backend": mesh.backend}
    for arch in TP_FAMILIES:
        stamps, coll, norms = [], [], []

        def on_step(step, metrics, stamps=stamps, coll=coll, norms=norms):
            stamps.append(time.perf_counter())
            coll.append(_axis_stats(mesh))
            norms.append(float(metrics["grad_norm"]))

        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        coll.append(_axis_stats(mesh))
        t0 = time.perf_counter()
        losses = train(arch, steps=TP_FAMILY_STEPS, batch=TRAIN_BATCH,
                       seq=TP_FAMILY_SMOKE_SEQ if smoke else TRAIN_SEQ,
                       smoke=smoke, device=device, seed=SEED,
                       lr=DIST_LR, graphs=False, mesh=mesh, on_step=on_step,
                       log_every=TP_FAMILY_STEPS, layers=TP_FAMILY_LAYERS,
                       param_dtype=_train_dtype(arch))
        bundle = with_layers(get_bundle(arch, smoke=smoke), TP_FAMILY_LAYERS)
        out[arch] = {"losses": losses, "grad_norms": norms,
                     "ms_per_step": (np.diff([t0] + stamps) * 1e3).tolist(),
                     "collectives_per_step": coll,
                     "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                    if dev.type == "cuda" else None),
                     "shard_bytes": _shard_bytes(bundle, mesh, fsdp=True)}
        _empty_cache(dev)
    return out


def _teacher_forced(bundle, params, seq, device, dtype) -> list:
    """``decode_fn`` stepped over ``seq`` (B, T), each step's logits on the
    host: the calls ``serve_lm`` makes when it generates ``seq``'s tail."""
    cache = bundle.make_cache(seq.shape[0], seq.shape[1], dtype, device)
    out = []
    with torch.no_grad():
        for t in range(seq.shape[1]):
            lg, cache = bundle.decode_fn(params, cache, {"tokens": seq[:, t:t + 1],
                                                         "pos": t})
            out.append(lg.cpu())
    return out


def rwkv_tp_witness(bundle, toks, rows, device) -> dict:
    """RWKV6's ranks' logits ``rows`` (every ``serve_lm`` call's) against a
    float64 one-process run teacher-forced on the ranks' tokens, within
    twice the one-process fp32 run's distance from it; the ranks' greedy
    token an argmax of the float64 logits wherever their top-2 margin
    exceeds twice that bound."""
    seq = torch.cat([_family_prompts(bundle, device)["tokens"],
                     torch.as_tensor(toks).to(device)], dim=1)
    from repro_torch.tree import tree_map

    params = bundle.init(torch.Generator(device=device).manual_seed(SEED),
                         torch.float32, device)
    fp32 = _teacher_forced(bundle, params, seq, device, torch.float32)
    params = tree_map(lambda t: t.double(), params)
    _empty_cache(device)
    fp64 = _teacher_forced(bundle, params, seq, device, torch.float64)
    del params
    want = torch.cat(fp64, dim=1)
    got = torch.cat([r.double() for r in rows], dim=1)
    d32 = _max_rel(torch.cat(fp32, dim=1), want)
    err = _max_rel(got, want)
    if not err <= 2 * d32:
        raise AssertionError(f"RWKV6 over (data 1, model 2): logits {err:.2e} of "
                             f"max|logit| from float64 > 2 x the one-process "
                             f"fp32 run's {d32:.2e}")
    bound = 2 * 2 * d32 * float(want.abs().max())
    top2 = want.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > bound
    agree = got.argmax(dim=-1) == want.argmax(dim=-1)
    if not bool(agree[sure].all()):
        raise AssertionError("RWKV6 over (data 1, model 2): a greedy token where "
                             "the float64 margin exceeds the bound differs")
    return {"fp32_vs_fp64": d32, "tp_vs_fp64": err,
            "sure_tokens": int(sure.sum()), "argmax_equal": int(agree.sum()),
            "calls": int(agree.numel())}


def tp_family_part(device, dev: str, smoke: bool, tmp: str) -> dict:
    """Part (e): the recurrent and encoder-decoder families served over
    (data 1, model 2) and trained over (data 2, model 2), the two jobs at
    once, each held against this process's one-process run, which runs
    after the ranks exit; then K4 at the per-rank prefill shapes against
    its plain version, timed."""
    from repro_torch.configs import get_bundle
    from repro_torch.launch.serve import serve_lm
    from repro_torch.launch.train import train

    out = {}
    (tr, train_s), (sv, serve_s) = _ranks_at_once(
        dev, (dist_tp_family_train_rank, TP_RANKS_TRAIN, (dev, smoke),
              os.path.join(tmp, "store-tpf-train")),
        (dist_tp_family_serve_rank, TP_RANKS_SERVE, (dev, smoke),
         os.path.join(tmp, "store-tpf-serve")))
    out["train"] = {"ranks": TP_RANKS_TRAIN, "mesh": "(data 2, model 2)",
                    "backend": tr[0]["backend"], "run_ranks_s": train_s,
                    "archs": []}
    for arch in TP_FAMILIES:
        one_norms = []
        one = train(arch, steps=TP_FAMILY_STEPS, batch=TRAIN_BATCH,
                    seq=TP_FAMILY_SMOKE_SEQ if smoke else TRAIN_SEQ,
                    smoke=smoke, device=device, seed=SEED,
                    lr=DIST_LR, graphs=False, log_every=TP_FAMILY_STEPS,
                    layers=TP_FAMILY_LAYERS, param_dtype=_train_dtype(arch),
                    on_step=lambda s, m: one_norms.append(float(m["grad_norm"])))
        errs = [max(abs(res[arch]["losses"][i] - b) / abs(b) for res in tr)
                for i, b in enumerate(one)]
        norm_errs = [max(abs(res[arch]["grad_norms"][i] - b) / abs(b)
                         for res in tr) for i, b in enumerate(one_norms)]
        err = max(errs)
        out["train"]["archs"].append({
            "arch": arch, "dtype": str(_train_dtype(arch)).removeprefix("torch."),
            "losses": tr[0][arch]["losses"],
            "one_process_losses": one, "loss_max_rel_err": err,
            "loss_rel_err_by_step": errs, "grad_norm_rel_err_by_step": norm_errs,
            "collectives_per_step": tr[0][arch]["collectives_per_step"],
            **{k: [res[arch][k] for res in tr]
               for k in ("ms_per_step", "peak_bytes", "shard_bytes")}})
        _empty_cache(device)
    for a in out["train"]["archs"]:
        if not a["loss_max_rel_err"] <= TOL_DIST_LOSS:
            raise AssertionError(
                f"{a['arch']} over (data 2, model 2): losses vs one process "
                f"rel err by step {a['loss_rel_err_by_step']} > "
                f"{TOL_DIST_LOSS} (gradient norms "
                f"{a['grad_norm_rel_err_by_step']})")

    out["serve"] = {"ranks": TP_RANKS_SERVE, "mesh": "(data 1, model 2)",
                    "run_ranks_s": serve_s, "archs": []}
    k4_total, k4_kernels = 0, {}
    for arch in TP_FAMILIES:
        bundle = get_bundle(arch, smoke=smoke)
        cfg = bundle.cfg
        got = sv[0][arch]
        rows = []
        want = serve_lm(arch, device=device, seed=SEED, smoke=smoke,
                        graphs=False,
                        on_logits=lambda lg: rows.append(lg.cpu()), **DIST_SERVE)
        if len(got["logits"]) != len(rows):
            raise AssertionError(f"{arch}: {len(got['logits'])} logits calls "
                                 f"over the mesh, {len(rows)} in one process")
        a = {"arch": arch, "layers": got["layers"],
             "logits_max_rel_err": max(_max_rel(x, y) for x, y in
                                       zip(got["logits"], rows))}
        same = [bool(torch.equal(torch.from_numpy(res[arch]["tokens"]),
                                 want.cpu())) for res in sv]
        a["tokens_equal_one_process"] = int(
            (torch.from_numpy(got["tokens"]) == want.cpu()).sum())
        if bundle.family == "ssm":
            a["float64"] = rwkv_tp_witness(bundle, got["tokens"],
                                           [torch.as_tensor(np.asarray(x))
                                            for x in got["logits"]], device)
        else:
            if not all(same):
                raise AssertionError(f"serve_lm {arch} over (data 1, model 2): "
                                     f"tokens differ from one process's")
            if not a["logits_max_rel_err"] <= TOL_TP_LOGITS:
                raise AssertionError(
                    f"serve_lm {arch} over (data 1, model 2): logits max rel "
                    f"err {a['logits_max_rel_err']:.2e} > {TOL_TP_LOGITS}")
        params = bundle.init(torch.Generator(device=device).manual_seed(SEED),
                             torch.float32, device)
        with torch.no_grad():
            pre = bundle.prefill_fn(params, _family_prompts(bundle, device))
        a["prefill_max_rel_err"] = _max_rel(got["prefill"], pre.cpu())
        if bundle.family != "ssm" and not a["prefill_max_rel_err"] <= TOL_TP_LOGITS:
            raise AssertionError(f"prefill_fn {arch} over (data 1, model 2): "
                                 f"max rel err {a['prefill_max_rel_err']:.2e} > "
                                 f"{TOL_TP_LOGITS}")
        del params, pre
        # K4 on every rank: Hymba once a layer at every head (B x 25),
        # Whisper three times a layer at its 8 heads a rank (B x 8)
        n, local = 0, None
        if bundle.family == "hybrid":
            n, local = cfg.layers, DIST_SERVE["batch"] * cfg.n_heads
        elif bundle.family == "encdec":
            n = cfg.enc_layers + 2 * cfg.dec_layers
            local = DIST_SERVE["batch"] * cfg.n_heads // TP_RANKS_SERVE
        if dev != "cpu":
            for r, res in enumerate(sv):
                if res[arch]["k4"] != n or any(
                        h != local for h in res[arch]["k4_heads"]):
                    raise AssertionError(
                        f"{arch} rank {r}: K4 launched {res[arch]['k4']} times "
                        f"at {sorted(set(res[arch]['k4_heads']))} query heads, "
                        f"want {n} at {local}")
        k4_total += sum(res[arch]["k4"] for res in sv)
        k4_kernels = _add_counts(k4_kernels, *(res[arch]["k4_kernels"] for res in sv))
        a.update(tokens_equal=all(same), k4_heads=local,
                 **{k: [res[arch][k] for res in sv]
                    for k in ("k4", "wall_s", "decode_s", "prefill_fn_s",
                              "peak_bytes", "shard_bytes", "collectives")})
        out["serve"]["archs"].append(a)
        del rows, want
        _empty_cache(device)
    out["by_path"] = {"prefill_fn_tp_families": {"flash_attention": k4_total}}
    out["k4_by_path"] = {"prefill_fn_tp_families": k4_kernels}
    # K4 at the ranks' prefill shapes
    gen = torch.Generator(device=device).manual_seed(SEED + 27)
    hy = get_bundle("hymba-1.5b", smoke=smoke).cfg
    wh = get_bundle("whisper-medium", smoke=smoke).cfg
    b, p = DIST_SERVE["batch"], DIST_SERVE["prompt_len"]
    wbh = b * wh.n_heads // TP_RANKS_SERVE
    shapes = [("hymba-1.5b prefill", b * hy.n_heads, p, p, hy.head_dim,
               hy.n_heads // hy.n_kv_heads, True, hy.layers),
              ("whisper-medium encoder", wbh, wh.enc_len, wh.enc_len,
               wh.head_dim, 1, False, wh.enc_layers),
              ("whisper-medium decoder self", wbh, p, p, wh.head_dim, 1, True,
               wh.dec_layers),
              ("whisper-medium decoder cross", wbh, p, wh.enc_len, wh.head_dim,
               1, False, wh.dec_layers)]
    out["k4"] = [{"path": f"prefill_fn over (data 1, model 2), {what} (phase "
                          f"13 (e)), per rank", **flash_entry(
                      bh, sq, d, rep, count, torch.float32,
                      gen, device, TOL_K4, dev != "cpu", sk=sk, causal=causal)}
                 for what, bh, sq, sk, d, rep, causal, count in shapes]
    return out


def print_tp_families(tf: dict, card: str) -> None:
    """Part (e)'s lines."""
    for a in tf["train"]["archs"]:
        med = [float(np.median(ms[1:])) for ms in a["ms_per_step"]]
        c = a["collectives_per_step"]
        per_axis = {ax: {"calls": (c[-1][ax]["calls"] - c[0].get(ax, {"calls": 0})["calls"])
                         / (len(c) - 1),
                         "ms": (c[-1][ax]["ms"] - c[0].get(ax, {"ms": 0.0})["ms"])
                         / (len(c) - 1),
                         "MB": (c[-1][ax]["bytes"] - c[0].get(ax, {"bytes": 0})["bytes"])
                         / (len(c) - 1) / 1e6} for ax in c[-1]}
        print(f"  (e) train {a['arch']} at full width on {TP_FAMILY_LAYERS} "
              f"layers in {a['dtype']} over {tf['train']['mesh']} on "
              f"{tf['train']['ranks']} ranks ({tf['train']['backend']}), FSDP "
              f"on, {TP_FAMILY_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
              f"tokens, eager, on {card}: losses "
              f"{[round(x, 5) for x in a['losses']]}, max rel err vs one "
              f"process {a['loss_max_rel_err']:.2e} <= {TOL_DIST_LOSS}, gradient "
              f"norms {max(a['grad_norm_rel_err_by_step']):.2e}; ms a step "
              f"(median of steps 2-{TP_FAMILY_STEPS}) per rank "
              f"{[round(m, 1) for m in med]}; collectives a step by axis "
              + "; ".join(f"{ax} {v['calls']:.0f} calls {v['ms']:.1f} ms "
                          f"{v['MB']:.1f} MB" for ax, v in per_axis.items())
              + f"; peak {[_gib(x) for x in a['peak_bytes']]} against shards "
              f"of {[_gib(x) for x in a['shard_bytes']]} a rank")
    for a in tf["serve"]["archs"]:
        dec = [s / DIST_SERVE["gen"] * 1e3 for s in a["decode_s"]]
        coll = a["collectives"][0]
        if "float64" in a:
            f = a["float64"]
            held = (f"logits {f['tp_vs_fp64']:.2e} of max|logit| from a float64 "
                    f"run teacher-forced on its tokens <= 2 x the one-process "
                    f"fp32 run's {f['fp32_vs_fp64']:.2e}; greedy tokens the "
                    f"float64 argmax at {f['argmax_equal']} of {f['calls']} "
                    f"calls (held at the {f['sure_tokens']} past the margin); "
                    f"{a['tokens_equal_one_process']} of "
                    f"{DIST_SERVE['batch'] * DIST_SERVE['gen']} tokens equal to "
                    f"the one-process fp32 run's (logits max rel err "
                    f"{a['logits_max_rel_err']:.2e})")
        else:
            held = (f"tokens equal to one process's, logits max rel err "
                    f"{a['logits_max_rel_err']:.2e} <= {TOL_TP_LOGITS}")
        print(f"  (e) serve_lm {a['arch']} at full width, {a['layers']} layers, "
              f"over {tf['serve']['mesh']} ({tf['serve']['ranks']} ranks), "
              f"batch {DIST_SERVE['batch']}, {DIST_SERVE['prompt_len']} + "
              f"{DIST_SERVE['gen']} tokens, eager, on {card}: {held}; "
              f"prefill_fn max rel err {a['prefill_max_rel_err']:.2e}"
              + (f", K4 launches per rank {a['k4']} at {a['k4_heads']} query "
                 f"heads" if a["k4_heads"] else ", no K4 (attention-free)")
              + f"; decode ms a step {[round(x, 1) for x in dec]} "
              f"({[round(x / a['layers'], 2) for x in dec]} a layer), "
              f"prefill_fn s {[round(x, 3) for x in a['prefill_fn_s']]}; rank "
              f"0's collectives "
              + "; ".join(f"{ax} {v['calls']} calls {v['ms']:.1f} ms "
                          f"{v['bytes'] / 1e6:.1f} MB" for ax, v in coll.items())
              + f"; peak {[_gib(x) for x in a['peak_bytes']]} against shards "
              f"of {[_gib(x) for x in a['shard_bytes']]} a rank")
    for e in tf["k4"]:
        print(f"  (e) K4 {e['path']}: q {e['q']} over {e['kv'][1]} keys, "
              f"{e['plan']['route']} route ({e['plan']['kernel']}), {e['count']} "
              f"launches: {_ms(e['ms'])} ms, device {_ms(e['device_ms'])}, plain "
              f"{_ms(e['plain_ms'])}, SDPA {_ms(e['library_ms'])}, bound "
              f"{e['bound_ms']:.5f} by {e['bound_by']}; rel err "
              f"{e['max_rel_err']:.2e} <= {TOL_K4}" + fp64_text(e))
    print(f"  (e) run_ranks s (the two jobs at once): train "
          f"{tf['train']['run_ranks_s']:.1f}, serve "
          f"{tf['serve']['run_ranks_s']:.1f}")


# (f) the sequence over the mesh.  A global batch of one row, its
# sequence cut over the data ranks (sharding.hold_sequence): SmolLM-135M
# trained over (data 2, model 1) and (data 2, model 2) at full width and
# depth, SEQ_STEPS steps of 1 x SEQ_LEN tokens, and over (data 1, model 2)
# and (data 2, model 2) with REPRO_SEQ_PARALLEL=1 and without (over data
# 2, each data rank's block cut further over model); RWKV6-1.6B (float64, as (e)) and
# Hymba-1.5B on TP_FAMILY_LAYERS layers at 1 x SEQ_FAMILY_LEN over (data
# 2, model 1); each loss within TOL_DIST_LOSS of the one-process run's
# (the flag's of the flag off's).  Qwen3-4B served at batch 1 over (data
# 2, model 1), SEQ_SERVE's lengths: the tokens equal to one process's and
# every call's logits within TOL_TP_LOGITS of max|logit|.  Eagerly: every
# step holds collectives.  The three meshes' jobs and the one-process runs
# go at once (8 ranks and this process on the card), so their ms a step
# are read under each other's load.
SEQ_STEPS, SEQ_LEN, SEQ_FAMILY_LEN = 3, 2048, 1024
SEQ_SERVE_ARCH = "qwen3-4b"
SEQ_SERVE = {"batch": 1, "prompt_len": 512, "gen": 16}
SEQ_FAMILIES = ("rwkv6-1.6b", "hymba-1.5b")
# a CPU rehearsal's lengths
SEQ_SMOKE_LEN, SEQ_SMOKE_SERVE = 32, {"batch": 1, "prompt_len": 16, "gen": 8}


def _seq_jobs() -> tuple:
    """Part (f)'s rank jobs, ``(sizes, runs)``: a (data, model) mesh and
    the ``(kind, arch, flag)`` runs its ranks make in turn.  SmolLM-135M
    runs apart from the families on (data 2, model 1), so that no job
    holds the others back; the serve (Qwen3-4B whole on each rank) comes
    last, when this process's own Qwen3-4B run, its first, has ended.
    Over (data 2, model 2) the flag cuts each data rank's block further
    over model."""
    both = [("train", TRAIN_ARCH, "0"), ("train", TRAIN_ARCH, "1")]
    return (((2, 1), [("train", TRAIN_ARCH, "0")]),
            ((2, 1), [("train", a, "0") for a in SEQ_FAMILIES]
             + [("serve", SEQ_SERVE_ARCH, "0")]),
            ((2, 2), both), ((1, 2), both))


def _seq_train(arch: str, smoke: bool, device: str, mesh=None, on_step=None):
    """``train`` at a global batch of one row, as part (f) runs it."""
    from repro_torch.launch.train import train

    family = arch in SEQ_FAMILIES
    return train(arch, steps=SEQ_STEPS, batch=1,
                 seq=SEQ_SMOKE_LEN if smoke else (SEQ_FAMILY_LEN if family
                                                  else SEQ_LEN),
                 smoke=smoke, device=device, seed=SEED, lr=DIST_LR,
                 graphs=False, mesh=mesh, on_step=on_step,
                 log_every=SEQ_STEPS, layers=TP_FAMILY_LAYERS if family else None,
                 param_dtype=_train_dtype(arch))


def dist_seq_rank(rank: int, device: str, smoke: bool, job: int) -> dict:
    """Rank ``rank`` of part (f)'s job ``job`` (``_seq_jobs``): its runs on
    its mesh, each with ``REPRO_SEQ_PARALLEL`` set as the run says: a train's losses, gradient norms, ms a step, collectives by axis
    a step and peak memory; a serve's tokens, every call's logits (rank
    0), decode ms a step, collectives by axis and peak memory."""
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.serve import serve_lm

    _no_tf32()
    sizes, runs = _seq_jobs()[job]
    mesh = make_process_mesh(sizes, ("data", "model"), device=device)
    dev = mesh.device
    cuda = dev.type == "cuda"
    out = {"backend": mesh.backend}
    for kind, arch, flag in runs:
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        mesh.stats["by_axis"].clear()
        os.environ["REPRO_SEQ_PARALLEL"] = flag
        try:
            if kind == "train":
                stamps, coll, norms = [], [_axis_stats(mesh)], []

                def on_step(step, metrics, stamps=stamps, coll=coll,
                            norms=norms):
                    stamps.append(time.perf_counter())
                    coll.append(_axis_stats(mesh))
                    norms.append(float(metrics["grad_norm"]))

                t0 = time.perf_counter()
                res = {"losses": _seq_train(arch, smoke, device, mesh, on_step),
                       "grad_norms": norms,
                       "ms_per_step": (np.diff([t0] + stamps) * 1e3).tolist(),
                       "collectives_per_step": coll}
            else:
                rows, timings = [], {}
                toks = serve_lm(arch, device=device, seed=SEED, smoke=smoke,
                                mesh=mesh, graphs=False, timings=timings,
                                on_logits=lambda lg, rows=rows: rows.append(
                                    lg[:, -1].cpu() if rank == 0 else None),
                                **(SEQ_SMOKE_SERVE if smoke else SEQ_SERVE))
                res = {"tokens": toks, "logits": rows if rank == 0 else None,
                       "decode_s": timings["decode_s"],
                       "prefill_s": timings["prefill_s"],
                       "collectives": _axis_stats(mesh)}
        finally:
            del os.environ["REPRO_SEQ_PARALLEL"]
        res["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if cuda else None
        out[f"{kind} {arch} flag {flag}"] = res
        _empty_cache(dev)
    return out


def seq_part(device, dev: str, smoke: bool, tmp: str) -> dict:
    """Part (f): the jobs of ``_seq_jobs`` and this
    process's one-process runs, all at once, each rank's held against
    them."""
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.serve import serve_lm

    from concurrent.futures import ThreadPoolExecutor

    def one_process() -> tuple:
        # the serve first: its weights leave the card before the ranks'
        rows = []
        tokens = serve_lm(SEQ_SERVE_ARCH, device=device, seed=SEED,
                          smoke=smoke, graphs=False,
                          on_logits=lambda lg: rows.append(lg[:, -1].cpu()),
                          **(SEQ_SMOKE_SERVE if smoke else SEQ_SERVE))
        _empty_cache(device)
        one = {}
        for arch in (TRAIN_ARCH,) + SEQ_FAMILIES:
            norms = []
            one[arch] = (_seq_train(arch, smoke, device, on_step=lambda s, m,
                                    norms=norms: norms.append(
                                        float(m["grad_norm"]))), norms)
        return one, rows, tokens

    jobs = _seq_jobs()
    t0 = time.perf_counter()
    # the jobs (10 ranks on the card) and this process's one-process runs
    # at once: each job is bound by its collectives' trips through the
    # host, not by the card
    with ThreadPoolExecutor(len(jobs) + 1) as pool:
        futs = [pool.submit(
            run_ranks, dist_seq_rank, math.prod(sizes), dev, smoke, i,
            device=dev, timeout_s=DIST_TIMEOUT_S,
            store_path=os.path.join(tmp, f"store-seq-{i}"))
            for i, (sizes, _) in enumerate(jobs)]
        mine = pool.submit(one_process)
        got = [f.result() for f in futs]
        one, rows, tokens = mine.result()
    out = {"run_ranks_s": time.perf_counter() - t0, "backend":
           got[0][0]["backend"], "train": [], "serve": []}
    for (sizes, runs), ranks in zip(jobs, got):
        for kind, arch, flag in runs:
            key = f"{kind} {arch} flag {flag}"
            res = [r[key] for r in ranks]
            if kind == "serve":
                continue
            want, want_norms = one[arch]
            if flag == "1":  # held to the flag-off run on the same mesh
                off = [r[f"train {arch} flag 0"] for r in ranks]
                want, want_norms = off[0]["losses"], off[0]["grad_norms"]
            errs = [max(abs(r["losses"][i] - b) / abs(b) for r in res)
                    for i, b in enumerate(want)]
            norm_errs = [max(abs(r["grad_norms"][i] - b) / abs(b) for r in res)
                         for i, b in enumerate(want_norms)]
            a = {"arch": arch, "mesh": f"(data {sizes[0]}, model {sizes[1]})",
                 "seq_parallel": flag == "1",
                 "against": "flag off" if flag == "1" else "one process",
                 "dtype": str(_train_dtype(arch)).removeprefix("torch."),
                 "losses": res[0]["losses"], "loss_rel_err_by_step": errs,
                 "grad_norm_rel_err_by_step": norm_errs,
                 "collectives_per_step": res[0]["collectives_per_step"],
                 "ms_per_step": [r["ms_per_step"] for r in res],
                 "peak_bytes": [r["peak_bytes"] for r in res]}
            if not max(errs) <= TOL_DIST_LOSS:
                raise AssertionError(
                    f"{arch} at batch 1 over {a['mesh']} (REPRO_SEQ_PARALLEL="
                    f"{flag}): losses vs {a['against']} rel err by step {errs} "
                    f"> {TOL_DIST_LOSS} (gradient norms {norm_errs})")
            out["train"].append(a)
    res = [r[f"serve {SEQ_SERVE_ARCH} flag 0"] for r in got[1]]
    if len(res[0]["logits"]) != len(rows):
        raise AssertionError(f"{len(res[0]['logits'])} logits calls over the "
                             f"mesh, {len(rows)} in one process")
    err = max(_max_rel(x, y) for x, y in zip(res[0]["logits"], rows))
    same = [bool(torch.equal(torch.from_numpy(r["tokens"]), tokens.cpu()))
            for r in res]
    if not all(same):
        raise AssertionError(f"serve_lm {SEQ_SERVE_ARCH} at batch 1 over (data "
                             f"2, model 1): tokens differ from one process's")
    if not err <= TOL_TP_LOGITS:
        raise AssertionError(f"serve_lm {SEQ_SERVE_ARCH} at batch 1 over (data "
                             f"2, model 1): logits max rel err {err:.2e} > "
                             f"{TOL_TP_LOGITS}")
    out["serve"].append({
        "arch": SEQ_SERVE_ARCH, "mesh": "(data 2, model 1)",
        "tokens_equal": all(same), "logits_max_rel_err": err,
        "calls": len(rows), **{k: [r[k] for r in res] for k in (
            "decode_s", "prefill_s", "peak_bytes", "collectives")}})
    _empty_cache(device)
    return out


def print_seq_part(sq: dict, card: str, smoke: bool = False) -> None:
    """Part (f)'s lines."""
    for a in sq["train"]:
        c = a["collectives_per_step"]
        n = len(c) - 1
        per_axis = {ax: {k: (c[-1][ax][k] - c[0].get(ax, {k: 0})[k]) / n
                         for k in ("calls", "ms", "bytes")} for ax in c[-1]}
        med = [float(np.median(ms[1:])) for ms in a["ms_per_step"]]
        seq = SEQ_SMOKE_LEN if smoke else (
            SEQ_FAMILY_LEN if a["arch"] in SEQ_FAMILIES else SEQ_LEN)
        print(f"  (f) train {a['arch']} at batch 1 x {seq} tokens "
              f"({a['dtype']}) over {a['mesh']} ({sq['backend']}), "
              f"REPRO_SEQ_PARALLEL={int(a['seq_parallel'])}, {SEQ_STEPS} "
              f"steps, eager, on {card}: losses "
              f"{[round(x, 5) for x in a['losses']]}, rel err vs "
              f"{a['against']} {max(a['loss_rel_err_by_step']):.2e} <= "
              f"{TOL_DIST_LOSS}, gradient norms "
              f"{max(a['grad_norm_rel_err_by_step']):.2e}; ms a step (median "
              f"of steps 2-{SEQ_STEPS}) per rank {[round(m, 1) for m in med]}; "
              f"collectives a step by axis "
              + "; ".join(f"{ax} {v['calls']:.0f} calls {v['ms']:.1f} ms "
                          f"{v['bytes'] / 1e6:.1f} MB"
                          for ax, v in per_axis.items())
              + f"; peak {[_gib(x) for x in a['peak_bytes']]} a rank")
    for a in sq["serve"]:
        lens = SEQ_SMOKE_SERVE if smoke else SEQ_SERVE
        dec = [s / lens["gen"] * 1e3 for s in a["decode_s"]]
        coll = a["collectives"][0]
        print(f"  (f) serve_lm {a['arch']} at full width and depth, batch 1, "
              f"{lens['prompt_len']} + {lens['gen']} tokens, over {a['mesh']} "
              f"(the prompt and cache cut over data), eager, on {card}: tokens "
              f"equal to one process's, {a['calls']} calls' logits max rel "
              f"err {a['logits_max_rel_err']:.2e} <= {TOL_TP_LOGITS}; prefill "
              f"s {[round(x, 3) for x in a['prefill_s']]}, decode ms a step "
              f"{[round(x, 1) for x in dec]}; rank 0's collectives "
              + "; ".join(f"{ax} {v['calls']} calls {v['ms']:.1f} ms "
                          f"{v['bytes'] / 1e6:.1f} MB" for ax, v in coll.items())
              + f"; peak {[_gib(x) for x in a['peak_bytes']]} a rank")
    print(f"  (f) run_ranks s (the jobs and the one-process runs at once): "
          f"{sq['run_ranks_s']:.1f}")


# (g) uneven placements (ROADMAP Queue A item 3(c)4): served through
# serve_lm(mesh=...) at DIST_SERVE's batch and lengths, eagerly, each rank
# drawing its cut of the params: (arch, layers, (data, model)).  A job's
# bytes are reckoned before it starts (each rank's fp32 shards plus
# UNEVEN_RANK_SLACK for its context and activations) and the jobs start
# in order as far as their sum stays within UNEVEN_BUDGET.
UNEVEN_JOBS = (("deepseek-v2-236b", 2, (2, 2)), ("deepseek-v2-236b", 2, (1, 3)),
               ("qwen3-4b", 4, (1, 3)))
UNEVEN_SMOKE_JOBS = (("deepseek-v2-236b", None, (2, 2)),
                     ("deepseek-v2-236b", None, (1, 3)),
                     ("qwen3-4b", None, (1, 3)))
UNEVEN_BUDGET, UNEVEN_RANK_SLACK = 70e9, 2**30


def dist_uneven_rank(rank: int, device: str, smoke: bool, arch: str, layers,
                     sizes: tuple) -> dict:
    """Rank ``rank`` of (data, model) = ``sizes``: ``arch`` (its first
    ``layers`` layers) through ``serve_lm(mesh=...)``, eagerly: the
    tokens, every call's logits (of this rank's rows, on the ranks of
    model coordinate 0), K4's launches and their shapes,
    ms, the collectives by axis, peak memory, and the local shapes of the
    leaves the placement turns on."""
    from repro_torch.configs import get_bundle
    from repro_torch.kernels.flash_attn.kernel import launches as k4_launches
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models.common import schema_shardings
    from repro_torch.models.registry import with_layers
    from repro_torch.sharding import shard_tree

    _no_tf32()
    mesh = make_process_mesh(sizes, ("data", "model"), device=device)
    dev = mesh.device
    shapes = _tp_spy()
    k4_launches.reset()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    bundle = get_bundle(arch, smoke=smoke)
    if layers is not None:
        bundle = with_layers(bundle, layers)
    rows, timings = [], {}
    keep = mesh.coordinate["model"] == 0
    t0 = time.perf_counter()
    toks = serve_lm(arch, device=device, seed=SEED, smoke=smoke, mesh=mesh,
                    layers=layers, graphs=False, timings=timings,
                    on_logits=lambda lg: rows.append(
                        lg.cpu() if keep else None), **DIST_SERVE)
    wall = time.perf_counter() - t0
    metas = shard_tree(bundle.param_shapes(), schema_shardings(bundle.schema,
                                                               mesh))
    local = {"embed": tuple(metas["embed"].shape)}
    if bundle.cfg.moe is not None:
        w = metas["moe_layers"]["moe"]
        local.update(router=tuple(w["router"].shape),
                     w_gate=tuple(w["w_gate"].shape))
    return {"backend": mesh.backend, "tokens": toks,
            "logits": rows if keep else None, "k4": k4_launches.count,
            "k4_kernels": k4_by_kernel(),
            "k4_shapes": list(shapes), "layers": bundle.cfg.layers,
            "wall_s": wall, "prefill_s": timings["prefill_s"],
            "decode_s": timings["decode_s"], "init_s": timings["init_s"],
            "collectives": _axis_stats(mesh), "local": local,
            "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None),
            "shard_bytes": _shard_bytes(bundle, mesh)}


def _uneven_bytes(arch: str, layers, sizes: tuple, smoke: bool) -> float:
    """A job's reckoned bytes: every rank's fp32 shards plus
    ``UNEVEN_RANK_SLACK`` a rank."""
    from repro_torch.configs import get_bundle
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.registry import with_layers

    bundle = get_bundle(arch, smoke=smoke)
    if layers is not None:
        bundle = with_layers(bundle, layers)
    mesh = Mesh(("data", "model"), sizes)
    return math.prod(sizes) * (_shard_bytes(bundle, mesh) + UNEVEN_RANK_SLACK)


def _within(budget: float, items: list) -> tuple:
    """Run each ``(reckoned bytes, fn)`` of ``items`` on a thread, started
    in order as far as the running ones' bytes stay within ``budget`` (the
    rest as others end); ``(results in order, each one's start in s)``.
    A failure raises once the others have ended."""
    from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

    t0 = time.perf_counter()
    got, started, pending, running = {}, {}, list(range(len(items))), {}
    with ThreadPoolExecutor(len(items)) as pool:
        while pending or running:
            held = sum(items[i][0] for i in running.values())
            while pending and (not running
                               or held + items[pending[0]][0] <= budget):
                i = pending.pop(0)
                started[i] = time.perf_counter() - t0
                running[pool.submit(items[i][1])] = i
                held += items[i][0]
            done, _ = wait(running, return_when=FIRST_COMPLETED)
            for fut in done:
                got[running.pop(fut)] = fut.result()
    return [got[i] for i in range(len(items))], [started[i]
                                                 for i in range(len(items))]


def uneven_part(device, dev: str, smoke: bool, tmp: str) -> dict:
    """Part (g): the jobs of ``UNEVEN_JOBS``, started in order as far as
    their reckoned bytes fit in ``UNEVEN_BUDGET`` (the rest as jobs end),
    then this process's one-process ``serve_lm`` of each arch, each job's
    ranks held against it."""
    from repro_torch.configs import get_bundle
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.serve import serve_lm

    jobs = UNEVEN_SMOKE_JOBS if smoke else UNEVEN_JOBS
    reckoned = [_uneven_bytes(a, l, z, smoke) for a, l, z in jobs]
    t0 = time.perf_counter()
    got, started = _within(UNEVEN_BUDGET, [(reckoned[i], lambda i=i: run_ranks(
        dist_uneven_rank, math.prod(jobs[i][2]), dev, smoke, *jobs[i],
        device=dev, timeout_s=DIST_TIMEOUT_S,
        store_path=os.path.join(tmp, f"store-uneven-{i}")))
        for i in range(len(jobs))])
    out = {"run_ranks_s": time.perf_counter() - t0, "budget": UNEVEN_BUDGET,
           "jobs": []}
    one = {}
    k4_total, k4_kernels = 0, {}
    for i, (arch, layers, sizes) in enumerate(jobs):
        if (arch, layers) not in one:
            rows = []
            toks = serve_lm(arch, device=device, seed=SEED, smoke=smoke,
                            layers=layers, graphs=False,
                            on_logits=lambda lg, rows=rows: rows.append(
                                lg.cpu()), **DIST_SERVE)
            one[(arch, layers)] = (toks.cpu(), rows)
            _empty_cache(device)
        want, rows = one[(arch, layers)]
        res = got[i]
        mesh = f"(data {sizes[0]}, model {sizes[1]})"
        for r, rr in enumerate(res):
            if not torch.equal(torch.from_numpy(rr["tokens"]), want):
                raise AssertionError(f"serve_lm {arch} over {mesh}: rank {r}'s "
                                     f"tokens differ from one process's")
        if len(res[0]["logits"]) != len(rows):
            raise AssertionError(f"{arch} over {mesh}: {len(res[0]['logits'])} "
                                 f"logits calls, {len(rows)} in one process")
        # each call's rows from the data ranks, in data order
        calls = [np.concatenate([rr["logits"][c] for rr in res[::sizes[1]]])
                 for c in range(len(rows))]
        err = max(_max_rel(a, b) for a, b in zip(calls, rows))
        if not err <= TOL_TP_LOGITS:
            raise AssertionError(f"serve_lm {arch} over {mesh}: logits max rel "
                                 f"err {err:.2e} > {TOL_TP_LOGITS}")
        cfg = get_bundle(arch, smoke=smoke).cfg
        if cfg.attn == "gqa" and dev != "cpu":  # every rank's whole heads
            want_shape = (DIST_SERVE["batch"] * cfg.n_heads,
                          DIST_SERVE["prompt_len"], cfg.head_dim,
                          cfg.n_heads // cfg.n_kv_heads)
            for r, rr in enumerate(res):
                if rr["k4"] != rr["layers"] or any(
                        sh != want_shape for sh in rr["k4_shapes"]):
                    raise AssertionError(
                        f"{arch} over {mesh} rank {r}: K4 launched {rr['k4']} "
                        f"times at {sorted(set(rr['k4_shapes']))}, want "
                        f"{rr['layers']} at {want_shape}")
        if sizes[0] > 1 and not all(rr["collectives"].get("data", {}).get(
                "calls", 0) >= DIST_SERVE["gen"] for rr in res):
            raise AssertionError(f"{arch} over {mesh}: fewer data-axis "
                                 f"collectives than decode steps (each step's "
                                 f"dispatch group is gathered over data)")
        k4_total += sum(rr["k4"] for rr in res)
        k4_kernels = _add_counts(k4_kernels, *(rr["k4_kernels"] for rr in res))
        out["jobs"].append({
            "arch": arch, "layers": res[0]["layers"], "mesh": mesh,
            "backend": res[0]["backend"], "tokens_equal": True,
            "logits_max_rel_err": err, "calls": len(rows),
            "started_s": started[i], "reckoned_bytes": reckoned[i],
            "local": res[0]["local"],
            "k4_shapes": sorted(set(res[0]["k4_shapes"])),
            **{k: [rr[k] for rr in res]
               for k in ("k4", "init_s", "prefill_s", "decode_s", "wall_s",
                         "peak_bytes", "shard_bytes", "collectives")}})
    del one
    _empty_cache(device)
    out["by_path"] = {"serve_lm_uneven": {"flash_attention": k4_total}}
    out["k4_by_path"] = {"serve_lm_uneven": k4_kernels}
    return out


def print_uneven_part(ug: dict, card: str) -> None:
    """Part (g)'s lines."""
    for a in ug["jobs"]:
        dec = [s / DIST_SERVE["gen"] * 1e3 for s in a["decode_s"]]
        coll = a["collectives"][0]
        print(f"  (g) serve_lm {a['arch']} at full width, {a['layers']} layers, "
              f"over {a['mesh']} ({a['backend']}), batch {DIST_SERVE['batch']}, "
              f"{DIST_SERVE['prompt_len']} + {DIST_SERVE['gen']} tokens, eager, "
              f"on {card}: tokens equal to one process's, {a['calls']} calls' "
              f"logits max rel err {a['logits_max_rel_err']:.2e} <= "
              f"{TOL_TP_LOGITS}; local leaves {a['local']}; K4 launches per "
              f"rank {a['k4']} at (BH, S, D, rep) {a['k4_shapes']}; started "
              f"at {a['started_s']:.1f} s; init s "
              f"{[round(x, 2) for x in a['init_s']]}, prefill s "
              f"{[round(x, 3) for x in a['prefill_s']]}, decode ms a step "
              f"{[round(x, 1) for x in dec]}; rank 0's collectives "
              + "; ".join(f"{ax} {v['calls']} calls {v['ms']:.1f} ms "
                          f"{v['bytes'] / 1e6:.1f} MB" for ax, v in coll.items())
              + f"; peak {[_gib(b) for b in a['peak_bytes']]} a rank against "
              f"shards of {[_gib(b) for b in a['shard_bytes']]} (reckoned "
              f"{_gib(a['reckoned_bytes'])} for the job)")
    print(f"  (g) run_ranks s (the jobs, at once within "
          f"{ug['budget'] / 1e9:.0f} GB): {ug['run_ranks_s']:.1f}")


# (h) a held sequence's edges and REPRO_BASELINE=1's cache (ROADMAP Queue
# A 3(c)1-2): (job, arch, layers, (data, model)).  (i) SmolLM-135M trained
# at 1 x EDGE_WHOLE_LEN tokens, which do not divide over data 2, so the row
# is held whole on both ranks; (iii) Hymba-1.5B on TP_FAMILY_LAYERS layers
# at 1 x EDGE_ONE_LEN over data 4, blocks of one position whose conv tail
# comes from up to 3 ranks back; (iv) Qwen3-4B served at batch 1, a
# prompt of 511 whole on both data ranks written into a cache of 528 cut
# over them; (v) Qwen3-4B on EDGE_BASE_LAYERS layers over (data 1, model
# 2) at DIST_SERVE's batch and lengths with REPRO_BASELINE=1 (its 8 KV
# heads cut 4 a rank) and without.  (ii), REPRO_SEQ_PARALLEL=1 on a held
# sequence, is part (f)'s (data 2, model 2) case.  Eagerly, TF32 off; the
# jobs and the one-process runs start at once as far as their reckoned
# bytes fit in EDGE_BUDGET.
EDGE_JOBS = (("i", "smollm-135m", None, (2, 1)),
             ("iii", "hymba-1.5b", TP_FAMILY_LAYERS, (4, 1)),
             ("iv", "qwen3-4b", None, (2, 1)),
             ("v", "qwen3-4b", 4, (1, 2)))
EDGE_STEPS, EDGE_WHOLE_LEN, EDGE_ONE_LEN = 3, 2047, 4
EDGE_SERVE = {"batch": 1, "prompt_len": 511, "gen": 17}
EDGE_BUDGET = 70e9
# a CPU rehearsal's lengths: 31 over data 2; a prompt of 15 into a cache
# of 24
EDGE_SMOKE_WHOLE_LEN = 31
EDGE_SMOKE_SERVE = {"batch": 1, "prompt_len": 15, "gen": 9}


def _edge_train(job: str, arch: str, layers, smoke: bool, device: str,
                mesh=None, on_step=None) -> list:
    """``train`` at a global batch of one row, as part (h) runs it."""
    from repro_torch.launch.train import train

    seq = EDGE_ONE_LEN if job == "iii" else (
        EDGE_SMOKE_WHOLE_LEN if smoke else EDGE_WHOLE_LEN)
    return train(arch, steps=EDGE_STEPS, batch=1, seq=seq, smoke=smoke,
                 device=device, seed=SEED, lr=DIST_LR, graphs=False,
                 mesh=mesh, on_step=on_step, log_every=EDGE_STEPS,
                 layers=layers, param_dtype=_train_dtype(arch))


def _edge_jobs(smoke: bool) -> tuple:
    """``EDGE_JOBS``; a CPU rehearsal's at the smoke configs' depths."""
    return tuple((n, a, None if smoke else l, z) for n, a, l, z in EDGE_JOBS)


def _edge_serve(job: str, smoke: bool) -> dict:
    if job == "v":
        return DIST_SERVE
    return EDGE_SMOKE_SERVE if smoke else EDGE_SERVE


def dist_edge_rank(rank: int, device: str, smoke: bool, job: tuple) -> dict:
    """Rank ``rank`` of part (h)'s ``job``: a train's losses, gradient
    norms, ms a step and collectives by axis a step; a serve's tokens,
    every call's last logits (the ranks of model coordinate 0), decode ms,
    collectives by axis and K4's launches and shapes, for job (v) with
    ``REPRO_BASELINE=1`` and without; peak memory and the shard bytes."""
    from repro_torch.configs import get_bundle
    from repro_torch.kernels.flash_attn.kernel import launches as k4_launches
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models.registry import with_layers

    _no_tf32()
    name, arch, layers, sizes = job
    mesh = make_process_mesh(sizes, ("data", "model"), device=device)
    dev = mesh.device
    cuda = dev.type == "cuda"
    shapes = _tp_spy()
    keep = mesh.coordinate["model"] == 0
    out = {"backend": mesh.backend, "runs": {}}
    for flag in (("1", "0") if name == "v" else ("0",)):
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        mesh.stats["by_axis"].clear()
        k4_launches.reset()
        shapes.clear()
        os.environ["REPRO_BASELINE"] = flag
        try:
            if name in ("i", "iii"):
                stamps, coll, norms = [], [_axis_stats(mesh)], []

                def on_step(step, metrics, stamps=stamps, coll=coll,
                            norms=norms):
                    stamps.append(time.perf_counter())
                    coll.append(_axis_stats(mesh))
                    norms.append(float(metrics["grad_norm"]))

                t0 = time.perf_counter()
                res = {"losses": _edge_train(name, arch, layers, smoke,
                                             device, mesh, on_step),
                       "grad_norms": norms,
                       "ms_per_step": (np.diff([t0] + stamps) * 1e3).tolist(),
                       "collectives_per_step": coll}
            else:
                rows, timings = [], {}
                toks = serve_lm(arch, device=device, seed=SEED, smoke=smoke,
                                mesh=mesh, layers=layers, graphs=False,
                                timings=timings,
                                on_logits=lambda lg, rows=rows: rows.append(
                                    lg[:, -1].cpu() if keep else None),
                                **_edge_serve(name, smoke))
                res = {"tokens": toks, "logits": rows if keep else None,
                       "decode_s": timings["decode_s"],
                       "prefill_s": timings["prefill_s"],
                       "collectives": _axis_stats(mesh)}
        finally:
            del os.environ["REPRO_BASELINE"]
        res.update(k4=k4_launches.count, k4_kernels=k4_by_kernel(),
                   k4_shapes=list(shapes),
                   peak_bytes=(torch.cuda.max_memory_allocated(dev)
                               if cuda else None))
        out["runs"][flag] = res
        _empty_cache(dev)
    bundle = get_bundle(arch, smoke=smoke)
    if layers is not None:
        bundle = with_layers(bundle, layers)
    out.update(layers=bundle.cfg.layers, shard_bytes=_shard_bytes(bundle, mesh))
    return out


def _rel_by_step(got: list, want: list) -> list:
    return [abs(g - w) / abs(w) for g, w in zip(got, want)]


def edge_part(device, dev: str, smoke: bool, tmp: str) -> dict:
    """Part (h): the jobs of ``EDGE_JOBS`` and this process's one-process
    runs of each, at once within ``EDGE_BUDGET``, each job held against
    its one-process run; K4 at job (iv)'s per-rank shape against its plain
    version, timed beside SDPA."""
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.serve import serve_lm

    def one_process(job) -> dict:
        name, arch, layers, _ = job
        if name in ("i", "iii"):
            norms = []
            return {"losses": _edge_train(
                name, arch, layers, smoke, device,
                on_step=lambda s, m: norms.append(float(m["grad_norm"]))),
                "grad_norms": norms}
        rows = []
        toks = serve_lm(arch, device=device, seed=SEED, smoke=smoke,
                        layers=layers, graphs=False,
                        on_logits=lambda lg: rows.append(lg[:, -1].cpu()),
                        **_edge_serve(name, smoke))
        return {"tokens": toks.cpu(), "logits": rows}

    def ones():
        out = {job[0]: one_process(job) for job in jobs}
        _empty_cache(device)
        return out

    jobs = _edge_jobs(smoke)
    reckoned = [_uneven_bytes(a, l, z, smoke) for _, a, l, z in jobs]
    # the largest job first, then this process's runs (Qwen3-4B whole)
    order = sorted(range(len(jobs)), key=lambda i: -reckoned[i])
    items = [(reckoned[i], lambda i=i: run_ranks(
        dist_edge_rank, math.prod(jobs[i][3]), dev, smoke, jobs[i],
        device=dev, timeout_s=DIST_TIMEOUT_S,
        store_path=os.path.join(tmp, f"store-edge-{jobs[i][0]}")))
        for i in order]
    items.insert(1, (_uneven_bytes("qwen3-4b", None, (1, 1), smoke), ones))
    t0 = time.perf_counter()
    res, starts = _within(EDGE_BUDGET, items)
    one = res.pop(1)
    start_one = starts.pop(1)
    got = dict(zip(order, res))
    started = dict(zip(order, starts))
    out = {"run_ranks_s": time.perf_counter() - t0, "budget": EDGE_BUDGET,
           "one_process_started_s": start_one, "jobs": []}
    k4_total, k4_kernels = 0, {}
    for i, (name, arch, layers, sizes) in enumerate(jobs):
        ranks_ = got[i]
        mesh = f"(data {sizes[0]}, model {sizes[1]})"
        want = one[name]
        a = {"job": name, "arch": arch, "layers": ranks_[0]["layers"],
             "mesh": mesh, "backend": ranks_[0]["backend"],
             "started_s": started[i], "reckoned_bytes": reckoned[i],
             "shard_bytes": [r["shard_bytes"] for r in ranks_], "runs": {}}
        for flag in ranks_[0]["runs"]:
            rs = [r["runs"][flag] for r in ranks_]
            run = {"peak_bytes": [r["peak_bytes"] for r in rs],
                   "k4": [r["k4"] for r in rs],
                   "k4_shapes": sorted(set(s for r in rs
                                           for s in map(tuple, r["k4_shapes"])))}
            what = f"{arch} job ({name}) over {mesh}" + (
                f", REPRO_BASELINE={flag}" if name == "v" else "")
            if name in ("i", "iii"):
                errs = [max(e) for e in zip(*(_rel_by_step(
                    r["losses"], want["losses"]) for r in rs))]
                norm_errs = [max(e) for e in zip(*(_rel_by_step(
                    r["grad_norms"], want["grad_norms"]) for r in rs))]
                if not max(errs) <= TOL_DIST_LOSS:
                    raise AssertionError(
                        f"{what}: losses vs one process rel err by step "
                        f"{errs} > {TOL_DIST_LOSS} (gradient norms "
                        f"{norm_errs})")
                run.update(losses=rs[0]["losses"], loss_rel_err_by_step=errs,
                           grad_norm_rel_err_by_step=norm_errs,
                           ms_per_step=[r["ms_per_step"] for r in rs],
                           collectives_per_step=rs[0]["collectives_per_step"])
            else:
                for r, rr in enumerate(rs):
                    if not torch.equal(torch.from_numpy(rr["tokens"]),
                                       want["tokens"]):
                        raise AssertionError(f"serve_lm {what}: rank {r}'s "
                                             f"tokens differ from one "
                                             f"process's")
                if len(rs[0]["logits"]) != len(want["logits"]):
                    raise AssertionError(
                        f"{what}: {len(rs[0]['logits'])} logits calls, "
                        f"{len(want['logits'])} in one process")
                err = max(_max_rel(x, y) for x, y in zip(rs[0]["logits"],
                                                         want["logits"]))
                if not err <= TOL_TP_LOGITS:
                    raise AssertionError(f"serve_lm {what}: logits max rel err "
                                         f"{err:.2e} > {TOL_TP_LOGITS}")
                lens = _edge_serve(name, smoke)
                nh = get_bundle_cfg(arch, smoke).n_heads // sizes[1]
                cfg = get_bundle_cfg(arch, smoke)
                want_shape = (lens["batch"] * nh, lens["prompt_len"],
                              cfg.head_dim, cfg.n_heads // cfg.n_kv_heads)
                if dev != "cpu":
                    for r, rr in enumerate(rs):
                        if rr["k4"] != ranks_[0]["layers"] or any(
                                tuple(sh) != want_shape
                                for sh in rr["k4_shapes"]):
                            raise AssertionError(
                                f"{what} rank {r}: K4 launched {rr['k4']} "
                                f"times at {run['k4_shapes']}, want "
                                f"{ranks_[0]['layers']} at {want_shape}")
                k4_total += sum(rr["k4"] for rr in rs)
                k4_kernels = _add_counts(k4_kernels, *(rr["k4_kernels"] for rr in rs))
                run.update(tokens_equal=True, logits_max_rel_err=err,
                           calls=len(want["logits"]),
                           decode_s=[r["decode_s"] for r in rs],
                           prefill_s=[r["prefill_s"] for r in rs],
                           collectives=rs[0]["collectives"])
            a["runs"][flag] = run
        out["jobs"].append(a)
    del one
    _empty_cache(device)
    out["by_path"] = {"serve_lm_edges": {"flash_attention": k4_total}}
    out["k4_by_path"] = {"serve_lm_edges": k4_kernels}
    # K4 at job (iv)'s per-rank shape: the whole prompt on each data rank
    cfg = get_bundle_cfg("qwen3-4b", smoke)
    lens = _edge_serve("iv", smoke)
    gen = torch.Generator(device=device).manual_seed(SEED + 31)
    out["k4"] = [{"path": "serve_lm at batch 1 over (data 2, model 1), the "
                          "whole prompt on each rank (phase 13 (h) (iv)), per "
                          "rank", **flash_entry(
                      lens["batch"] * cfg.n_heads, lens["prompt_len"],
                      cfg.head_dim, cfg.n_heads // cfg.n_kv_heads, cfg.layers,
                      torch.float32, gen, device, TOL_K4, dev != "cpu")}]
    return out


def get_bundle_cfg(arch: str, smoke: bool):
    from repro_torch.configs import get_bundle

    return get_bundle(arch, smoke=smoke).cfg


def print_edge_part(hh: dict, card: str) -> None:
    """Part (h)'s lines: gloo through the host on one card, not scaling
    figures."""
    for a in hh["jobs"]:
        for flag, run in a["runs"].items():
            head = (f"  (h) ({a['job']}) {a['arch']} at full width, "
                    f"{a['layers']} layers, over {a['mesh']} ({a['backend']} "
                    f"through the host on one card: not a scaling figure)"
                    + (f", REPRO_BASELINE={flag}"
                                  if a["job"] == "v" else "")
                    + f", eager, on {card}: ")
            if "losses" in run:
                c = run["collectives_per_step"]
                n = len(c) - 1
                per_axis = {ax: {k: (c[-1][ax][k] - c[0].get(ax, {k: 0})[k])
                                 / n for k in ("calls", "ms", "bytes")}
                            for ax in c[-1]}
                med = [float(np.median(ms[1:])) for ms in run["ms_per_step"]]
                body = (f"{EDGE_STEPS} steps, losses "
                        f"{[round(x, 5) for x in run['losses']]}, rel err vs "
                        f"one process {max(run['loss_rel_err_by_step']):.2e} "
                        f"<= {TOL_DIST_LOSS}, gradient norms "
                        f"{max(run['grad_norm_rel_err_by_step']):.2e}; ms a "
                        f"step (median of steps 2-{EDGE_STEPS}) per rank "
                        f"{[round(m, 1) for m in med]}; collectives a step "
                        + "; ".join(f"{ax} {v['calls']:.0f} calls "
                                    f"{v['ms']:.1f} ms "
                                    f"{v['bytes'] / 1e6:.1f} MB"
                                    for ax, v in per_axis.items()))
            else:
                gen = (DIST_SERVE if a["job"] == "v" else EDGE_SERVE)["gen"]
                dec = [s / gen * 1e3 for s in run["decode_s"]]
                coll = run["collectives"]
                body = (f"tokens equal to one process's, {run['calls']} calls' "
                        f"logits max rel err {run['logits_max_rel_err']:.2e} "
                        f"<= {TOL_TP_LOGITS}; K4 launches per rank "
                        f"{run['k4']} at (BH, S, D, rep) {run['k4_shapes']}; "
                        f"prefill s {[round(x, 3) for x in run['prefill_s']]}"
                        f", decode ms a step {[round(x, 1) for x in dec]}; "
                        f"rank 0's collectives "
                        + "; ".join(f"{ax} {v['calls']} calls {v['ms']:.1f} "
                                    f"ms {v['bytes'] / 1e6:.1f} MB"
                                    for ax, v in coll.items()))
            print(head + body + f"; peak {[_gib(x) for x in run['peak_bytes']]}"
                  f" a rank against shards of "
                  f"{[_gib(x) for x in a['shard_bytes']]} (reckoned "
                  f"{_gib(a['reckoned_bytes'])} for the job, started at "
                  f"{a['started_s']:.1f} s)")
    for e in hh["k4"]:
        print(f"  (h) K4 {e['path']}: q {e['q']} over {e['kv'][1]} keys, "
              f"{e['plan']['route']} route ({e['plan']['kernel']}), {e['count']} "
              f"launches: {_ms(e['ms'])} ms, device {_ms(e['device_ms'])}, plain "
              f"{_ms(e['plain_ms'])}, SDPA {_ms(e['library_ms'])}, bound "
              f"{e['bound_ms']:.5f} by {e['bound_by']}; rel err "
              f"{e['max_rel_err']:.2e} <= {TOL_K4}" + fp64_text(e))
    print(f"  (h) run_ranks s (the jobs and the one-process runs at once "
          f"within {hh['budget'] / 1e9:.0f} GB): {hh['run_ranks_s']:.1f}")


def _max_rel(got, want) -> float:
    got = torch.as_tensor(np.asarray(got)).double()
    want = torch.as_tensor(np.asarray(want)).double()
    return float((got - want).abs().max() / want.abs().max())


def distributed_phase(device, card: str, smoke: bool = False,
                      beside=None) -> dict:
    """The process mesh on one card, as the module docstring's phase 13
    says: (a) VGG-16 through ``run_sharded`` on ``DIST_RANKS`` ranks, (b)
    SmolLM-135M trained data-parallel, (c) served data-parallel, (d)
    tensor and expert parallelism over the model axis (Qwen3-4B and
    DeepSeek-V2 served over (data 1, model 2), SmolLM-135M trained over
    (data 2, model 2)), each held against this process's one-process run.  Ranks are spawned by
    ``run_ranks`` (the kernels are already built here, so each rank loads
    them), joined with a timeout; any failing or hung rank raises.
    ``beside``, where given, is called before part (g), to start work that
    runs beside (g) and (h).  ``smoke`` rehearses it on the CPU at the
    smoke sizes."""
    import tempfile

    from repro_torch.checkpoint import restore
    from repro_torch.configs import get_bundle
    from repro_torch.launch.mesh import backend_for, run_ranks
    from repro_torch.launch.serve import serve_lm
    from repro_torch.launch.train import train
    from repro_torch.models.cnn import CNN_SPECS, init_cnn, run_convls
    from repro_torch.optim import init_state
    from repro_torch.tree import tree_items

    out = {"cards": torch.cuda.device_count(),
           "backend_rule": {f"{r} ranks": backend_for("cuda", r)
                            for r in (1, 2, DIST_RANKS)}}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the paper's SPMD path
        t0 = time.perf_counter()
        dev = str(device)
        vgg = run_ranks(dist_vgg16_rank, DIST_RANKS, dev, smoke, device=dev,
                        timeout_s=DIST_TIMEOUT_S,
                        store_path=os.path.join(tmp, "store-vgg"))
        spawn_s = time.perf_counter() - t0
        params = init_cnn(ARCH, torch.Generator().manual_seed(SEED), device)
        x = torch.from_numpy(_dist_input(smoke)).to(device)
        ref = run_convls(ARCH, params, x).cpu().numpy()
        del params
        layers = [l.name for l in CNN_SPECS[ARCH][1]]
        passes = []
        for i, ids in enumerate(DIST_SURVIVORS):
            feats = vgg[0]["passes"][i]["features"]
            for r, res in enumerate(vgg):
                p = res["passes"][i]
                if not np.array_equal(p["features"], feats):
                    raise AssertionError(f"run_sharded {ids}: rank {r}'s output "
                                         f"differs from rank 0's")
                if p["k1"] != len(layers) and dev != "cpu":  # CPU: plain
                    raise AssertionError(f"run_sharded {ids}: rank {r} launched "
                                         f"K1 {p['k1']} times for {len(layers)} "
                                         f"layers")
            err = _max_rel(feats, ref)
            if not err <= TOL_SERVE:
                raise AssertionError(f"run_sharded {ids}: max rel err {err:.2e} "
                                     f"vs the uncoded stack > {TOL_SERVE}")
            # each phase's time is the slowest rank's (the all-gather waits
            # for it)
            per_layer = [{key: max(res["passes"][i]["layers"][j][key]
                                   for res in vgg) * 1e3
                          for key in ("worker_s", "gather_s", "decode_s")}
                         for j in range(len(layers))]
            passes.append({"survivors": ids, "max_rel_err": err,
                           "k1_per_rank": [res["passes"][i]["k1"] for res in vgg],
                           "wall_s": max(res["passes"][i]["wall_s"] for res in vgg),
                           "ms": {name: {k.replace("_s", "_ms"): v
                                         for k, v in pl.items()}
                                  for name, pl in zip(layers, per_layer)}})
        out["vgg16"] = {"ranks": DIST_RANKS, "backend": vgg[0]["backend"],
                        "plan": DIST_PLAN, "batch": int(x.shape[0]),
                        "hw": int(x.shape[-1]),
                        "run_ranks_s": spawn_s, "passes": passes,
                        "collectives_per_rank": vgg[0]["collectives"]}
        out["by_path"] = {"sharded_vgg16": {"coded_worker": sum(
            p["k1"] for res in vgg for p in res["passes"])}}
        out["k4_by_path"] = {}  # path -> K4's launches by kernel
        del vgg, x

        # (b) and (c): training and serving over two ranks
        t0 = time.perf_counter()
        lm = run_ranks(dist_lm_rank, 2, os.path.join(tmp, "fsdp"), dev, smoke,
                       device=dev, timeout_s=DIST_TIMEOUT_S,
                       store_path=os.path.join(tmp, "store-lm"))
        spawn_s = time.perf_counter() - t0
        one_norms = []
        one_losses = train(TRAIN_ARCH, steps=DIST_TRAIN_STEPS, batch=TRAIN_BATCH,
                           seq=TRAIN_SEQ, smoke=smoke, device=device, seed=SEED,
                           lr=DIST_LR, graphs=False,
                           on_step=lambda s, m: one_norms.append(
                               float(m["grad_norm"])),
                           ckpt_dir=os.path.join(tmp, "one"),
                           ckpt_every=DIST_TRAIN_STEPS,
                           log_every=DIST_TRAIN_STEPS)
        bundle = get_bundle(TRAIN_ARCH, smoke=smoke)
        like = bundle.init(torch.Generator().manual_seed(SEED), device=device)
        like = {"params": like, "opt": init_state(like)}
        full = restore(os.path.join(tmp, "one"), DIST_TRAIN_STEPS, like)["params"]
        dp = restore(os.path.join(tmp, "fsdp"), DIST_TRAIN_STEPS, like)["params"]
        init = like["params"]
        del like
        micro_losses, one = one_process_microbatched(bundle, device)
        loss_err = max(abs(a - b) / abs(b) for res in lm
                       for a, b in zip(res["fsdp"]["losses"], one_losses))
        if not loss_err <= TOL_DIST_LOSS:
            raise AssertionError(f"data-parallel losses vs one process: max "
                                 f"rel err {loss_err:.2e} > {TOL_DIST_LOSS}")
        norm_err = max(abs(a - b) / abs(b) for res in lm
                       for a, b in zip(res["fsdp"]["grad_norms"], one_norms))
        if not norm_err <= TOL_DIST_NORM:
            raise AssertionError(f"data-parallel gradient norms vs one process: "
                                 f"max rel err {norm_err:.2e} > {TOL_DIST_NORM}")
        gathered = dict(tree_items(lm[0]["fsdp"]["gathered"]))
        param_err = 0.0
        for path, leaf in tree_items(dp):
            if not torch.equal(leaf.cpu(), torch.from_numpy(gathered[path])):
                raise AssertionError(f"checkpoint leaf {'/'.join(path)} restored "
                                     f"in one process differs from the ranks' "
                                     f"gathered params")
        for (path, got), (_, want) in zip(tree_items(dp), tree_items(one)):
            param_err = max(param_err, _max_rel(got.cpu(), want.cpu()))
        if not param_err <= TOL_DIST_PARAM:
            raise AssertionError(f"data-parallel params after step "
                                 f"{DIST_TRAIN_STEPS}: max rel err "
                                 f"{param_err:.2e} > {TOL_DIST_PARAM} vs one "
                                 f"process with microbatches=2")
        full_gap = hold_full_batch(dp, full, init)
        micro_loss_err = max(abs(a - b) / abs(b) for res in lm
                             for a, b in zip(res["fsdp"]["losses"], micro_losses))
        del one, dp, gathered
        for res in lm:
            l8 = res["int8_pod"]["losses"]
            if not (all(math.isfinite(v) for v in l8) and l8[-1] < l8[0]):
                raise AssertionError(f"int8 over (pod 2, data 1): losses {l8}")
        want = serve_lm(TRAIN_ARCH, device=device, seed=SEED, smoke=smoke,
                        **DIST_SERVE)
        for r, res in enumerate(lm):
            if not torch.equal(torch.from_numpy(res["serve"]["tokens"]),
                               want.cpu()):
                raise AssertionError(f"serve_lm over the mesh: rank {r}'s tokens "
                                     f"differ from one process's")
            if res["serve"]["k4"] <= 0 and dev != "cpu":
                raise AssertionError(f"rank {r} served without launching K4")
        out["by_path"]["serve_lm_mesh"] = {"flash_attention": sum(
            res["serve"]["k4"] for res in lm)}
        out["lm"] = {"backend": lm[0]["backend"], "run_ranks_s": spawn_s,
                     "one_process_losses": one_losses,
                     "loss_max_rel_err": loss_err,
                     "grad_norm_max_rel_err": norm_err,
                     "one_process_grad_norms": one_norms,
                     "microbatched_loss_max_rel_err": micro_loss_err,
                     "param_max_rel_err": param_err,
                     "param_full_batch": full_gap,
                     "serve": {"tokens_equal": True, **{
                         k: [res["serve"][k] for res in lm]
                         for k in ("k4", "wall_s", "prefill_s", "decode_s")}}}
        for label in ("fsdp", "int8_pod"):
            out["lm"][label] = {k: [res[label][k] for res in lm]
                                for k in ("losses", "ms_per_step",
                                          "collective_ms_per_step",
                                          "peak_bytes")}
        out["lm"]["fsdp"]["shard_numel"] = [res["fsdp"]["shard_numel"]
                                            for res in lm]
        del lm
        _empty_cache(device)
        # (d) tensor and expert parallelism over the model axis
        t0 = time.perf_counter()
        tp = tensor_parallel_part(device, dev, smoke, tmp, one_losses,
                                  one_norms, full, init)
        tp["seconds"] = time.perf_counter() - t0
        out["by_path"].update(tp.pop("by_path"))
        out["k4_by_path"].update(tp.pop("k4_by_path"))
        out["tensor_parallel"] = tp
        del full, init
        _empty_cache(device)
        # (e) the recurrent and encoder-decoder families over the model axis
        t0 = time.perf_counter()
        tf = tp_family_part(device, dev, smoke, tmp)
        tf["seconds"] = time.perf_counter() - t0
        out["by_path"].update(tf.pop("by_path"))
        out["k4_by_path"].update(tf.pop("k4_by_path"))
        out["tp_families"] = tf
        _empty_cache(device)
        # (f) the sequence over the mesh
        t0 = time.perf_counter()
        sq = seq_part(device, dev, smoke, tmp)
        sq["seconds"] = time.perf_counter() - t0
        out["seq"] = sq
        _empty_cache(device)
        # (g) uneven placements
        if beside is not None:
            beside()
        t0 = time.perf_counter()
        ug = uneven_part(device, dev, smoke, tmp)
        ug["seconds"] = time.perf_counter() - t0
        out["by_path"].update(ug.pop("by_path"))
        out["k4_by_path"].update(ug.pop("k4_by_path"))
        out["uneven"] = ug
        _empty_cache(device)
        # (h) a held sequence's edges and REPRO_BASELINE=1
        t0 = time.perf_counter()
        hh = edge_part(device, dev, smoke, tmp)
        hh["seconds"] = time.perf_counter() - t0
        out["by_path"].update(hh.pop("by_path"))
        out["k4_by_path"].update(hh.pop("k4_by_path"))
        out["edges"] = hh
    return out


def dist_lr_sum() -> float:
    """The learning rates that ``train``'s schedule applies over
    ``DIST_TRAIN_STEPS`` steps at ``DIST_LR``, summed (step 1's is 0)."""
    from repro_torch.optim.schedule import cosine_with_warmup

    warmup = min(20, DIST_TRAIN_STEPS // 10 + 1)  # train's
    return sum(DIST_LR * float(cosine_with_warmup(
        torch.tensor(s), warmup=warmup, total=DIST_TRAIN_STEPS))
        for s in range(DIST_TRAIN_STEPS))


def hold_full_batch(dp: dict, full: dict, init: dict) -> dict:
    """The data-parallel params against the one-process full-batch run's:
    each leaf within ``TOL_DIST_PARAM`` of its max|p| but for at most
    ``DIST_FLIP_FRACTION`` of its elements, which may differ by twice the
    summed learning rates besides.  Returns the readings of the leaf
    furthest off: its largest difference, the element there (its value in
    both runs and at init), and how many elements lie beyond 1e-4."""
    from repro_torch.tree import tree_items

    two_lr = 2 * dist_lr_sum()
    worst = None
    for (path, got), (_, want), (_, p0) in zip(tree_items(dp), tree_items(full),
                                               tree_items(init)):
        got, want = got.double().cpu(), want.double().cpu()
        scale = float(want.abs().max())
        err = (got - want).abs()
        beyond = int((err > TOL_DIST_PARAM * scale).sum())
        e, i = float(err.max()), int(err.argmax())
        name = "/".join(path)
        if beyond > DIST_FLIP_FRACTION * err.numel():
            raise AssertionError(f"data-parallel params vs the full batch: "
                                 f"{name} has {beyond} of {err.numel()} "
                                 f"elements beyond {TOL_DIST_PARAM} of max|p|")
        if e > TOL_DIST_PARAM * scale + two_lr:
            raise AssertionError(f"data-parallel params vs the full batch: "
                                 f"{name} differs by {e:.3e} > {TOL_DIST_PARAM}"
                                 f" * {scale:.3e} + 2 * sum(lr) {two_lr:.3e}")
        if worst is None or e / scale > worst["rel"]:
            worst = {"leaf": name, "rel": e / scale, "abs": e, "max": scale,
                     "beyond": beyond, "numel": err.numel(),
                     "element": i, "dp": float(got.flatten()[i]),
                     "one": float(want.flatten()[i]),
                     "init": float(p0.flatten()[i]), "two_lr": two_lr}
    return worst


def one_process_microbatched(bundle, device) -> tuple[list, dict]:
    """``DIST_TRAIN_STEPS`` one-process steps of ``train``'s schedule on
    its batches and params, each step's gradient summed over two
    microbatches of half the batch: the losses and the params after."""
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.devices import fp32_products
    from repro_torch.launch import steps
    from repro_torch.optim import AdamWConfig, init_state

    tcfg = steps.TrainConfig(opt=AdamWConfig(lr=DIST_LR),
                             warmup=min(20, DIST_TRAIN_STEPS // 10 + 1),
                             total_steps=DIST_TRAIN_STEPS, microbatches=2)
    fn = steps.build_train_step(bundle, tcfg)
    params = bundle.init(torch.Generator().manual_seed(SEED), torch.float32,
                         device)
    opt = init_state(params)
    data = SyntheticTokens(DataConfig(vocab=bundle.cfg.vocab, seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH))
    losses = []
    with fp32_products():
        for step in range(DIST_TRAIN_STEPS):
            b = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch(step).items()}
            params, opt, met = fn(params, opt, b)
            losses.append(float(met["loss"]))
    return losses, params


def print_distributed(d: dict, card: str) -> None:
    """The process-mesh phase's lines."""
    v = d["vgg16"]
    print(f"process mesh on {d['cards']} card(s), {card}: backend rule "
          f"{d['backend_rule']} (nccl needs a card a rank; gloo stages every "
          f"collective through host memory)")
    for p in v["passes"]:
        tot = {k: sum(ms[k] for ms in p["ms"].values())
               for k in ("worker_ms", "gather_ms", "decode_ms")}
        print(f"  run_sharded VGG-16 {v['hw']} x {v['batch']}, 13 ConvLs on "
              f"{v['ranks']} ranks ({v['backend']}), plan (n, k_a, k_b) "
              f"{v['plan']}, survivors {p['survivors']}: max rel err vs uncoded "
              f"{p['max_rel_err']:.2e} <= {TOL_SERVE}, ranks torch.equal, K1 "
              f"launches per rank {p['k1_per_rank']}; {p['wall_s']:.2f} s; "
              f"sum over layers: worker (encode + K1) {tot['worker_ms']:.1f} ms, "
              f"all-gather {tot['gather_ms']:.1f} ms, decode + merge "
              f"{tot['decode_ms']:.1f} ms")
    last = v["passes"][-1]["ms"]
    print("    ms a layer (slowest rank), last pass: " + "; ".join(
        f"{name} {ms['worker_ms']:.1f}/{ms['gather_ms']:.1f}/{ms['decode_ms']:.1f}"
        for name, ms in last.items()))
    lm = d["lm"]
    for label, what in (("fsdp", "FSDP (data 2, model 1)"),
                        ("int8_pod", "int8 compression (pod 2, data 1, model 1)")):
        r = lm[label]
        med = [float(np.median(ms[1:])) for ms in r["ms_per_step"]]
        coll = [float(np.median(ms[1:])) for ms in r["collective_ms_per_step"]]
        print(f"  train {TRAIN_ARCH} {what}, {DIST_TRAIN_STEPS} steps of "
              f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, eager, on {card}: losses "
              f"{[round(x, 5) for x in r['losses'][0]]}; ms a step (median of "
              f"steps 2-{DIST_TRAIN_STEPS}) per rank {[round(m, 1) for m in med]}, "
              f"collective ms a step {[round(c, 1) for c in coll]}, peak "
              f"{[_gib(b) for b in r['peak_bytes']]}")
    f = lm["param_full_batch"]
    print(f"  FSDP against one process: losses max rel err "
          f"{lm['loss_max_rel_err']:.2e} <= {TOL_DIST_LOSS} (train, full batch) "
          f"and {lm['microbatched_loss_max_rel_err']:.2e} (microbatches=2); "
          f"gradient norms max rel err {lm['grad_norm_max_rel_err']:.2e} <= "
          f"{TOL_DIST_NORM} (full batch); params after step {DIST_TRAIN_STEPS} "
          f"max rel err {lm['param_max_rel_err']:.2e} <= {TOL_DIST_PARAM} "
          f"(microbatches=2); the last checkpoint restored in one process "
          f"torch.equal to the ranks' gathered params; shard numel per rank "
          f"{lm['fsdp']['shard_numel']}")
    print(f"  FSDP params against the full batch: furthest leaf {f['leaf']}, "
          f"max abs err {f['abs']:.3e} = {f['rel']:.2e} of max|p| "
          f"{f['max']:.3e} <= {TOL_DIST_PARAM} * max|p| + 2 * sum(lr) "
          f"{f['two_lr']:.3e}; {f['beyond']} of {f['numel']} elements beyond "
          f"{TOL_DIST_PARAM} of max|p| (at most {DIST_FLIP_FRACTION:.0%}); "
          f"element {f['element']}: data-parallel {f['dp']:.6e}, one process "
          f"{f['one']:.6e}, init {f['init']:.6e}")
    s = lm["serve"]
    print(f"  serve_lm {TRAIN_ARCH} data-parallel on 2 ranks, batch "
          f"{DIST_SERVE['batch']}, {DIST_SERVE['prompt_len']} + "
          f"{DIST_SERVE['gen']} tokens: tokens equal to one process's; K4 "
          f"launches per rank {s['k4']}; decode s per rank "
          f"{[round(x, 3) for x in s['decode_s']]}")
    if "tensor_parallel" in d:
        print(f"  (d) tensor parallelism: {d['tensor_parallel']['seconds']:.1f} s")
        print_tensor_parallel(d["tensor_parallel"], card)
    if "tp_families" in d:
        print(f"  (e) the recurrent and encoder-decoder families: "
              f"{d['tp_families']['seconds']:.1f} s")
        print_tp_families(d["tp_families"], card)
    if "seq" in d:
        print(f"  (f) the sequence over the mesh: {d['seq']['seconds']:.1f} s")
        print_seq_part(d["seq"], card)
    if "uneven" in d:
        print(f"  (g) uneven placements: {d['uneven']['seconds']:.1f} s")
        print_uneven_part(d["uneven"], card)
    if "edges" in d:
        print(f"  (h) a held sequence's edges and REPRO_BASELINE=1: "
              f"{d['edges']['seconds']:.1f} s")
        print_edge_part(d["edges"], card)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this proof "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels.coded_gemm.kernel import launches as k3_launches
    from repro_torch.kernels.conv2d.kernel import launches as k1_launches
    from repro_torch.kernels.conv2d.kernel import route_launches as k1_routes
    from repro_torch.kernels.flash_attn.kernel import launches as k4_launches
    from repro_torch.kernels.matmul.kernel import launches as k2_launches
    from repro_torch.kernels.native import build_library, load_library

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    device = torch.device("cuda")
    # the run's own autotune ledger: the wrappers find no plan in it before
    # phase 16 sweeps, whatever ledger the checkout holds
    import tempfile
    ledger_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_autotune_")
    os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(
        ledger_dir.name, "autotune_cache_torch.json")
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
    k1k = kernels[0]
    print(f"  coded_worker routes {k1k['routes']}; bounds a pass: FFMA "
          f"{k1k['bounds']['ffma_ms']:.4f} ms, 3xTF32 "
          f"{k1k['bounds']['tf32x3_ms']:.4f} ms; the other route's design "
          f"plans {k1k['other_route_device_ms']:.4f} device ms; against "
          f"float64 max rel err {k1k['rel_err_fp64']:.3e}, at most "
          f"{k1k['fp64_ratio']:.3f} x the fp32 plain version's (limit "
          f"{K1_FP64_RATIO})")
    print("  " + clock_line("K1's timing", k1k["sm_clock"]))

    xs = np.random.default_rng(SEED).standard_normal(
        (N_REQUESTS,) + pipe.input_shape).astype(np.float32)
    t0 = time.perf_counter()
    outs, stats, launches, graphs_t = serving_phase(server, xs,
                                                    (k1_launches, k2_launches,
                                                     *k1_routes.values()))
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
        server_d, xs, (k1_launches, k2_launches, *k1_routes.values()))
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

    # -- the process mesh: run_sharded, data-parallel training and serving
    # on ranks sharing this card; the dry run's CLI traces on the host
    # beside parts (g) and (h), whose jobs share it already, and is read
    # before the arch zoo, whose timed serves keep the host to themselves
    t0 = time.perf_counter()
    cli_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_")
    cli: list = []
    try:
        dist = distributed_phase(device, card, beside=lambda: cli.extend(
            start_dryrun_cli(cli_dir.name)))
        dist["seconds"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        cli_records = finish_dryrun_cli(cli, cli_dir.name)
    finally:
        stop_dryrun_cli(cli)
        cli_dir.cleanup()
    print(f"process-mesh phase: {dist['seconds']:.1f} s; the dry run's CLI "
          f"read {time.perf_counter() - t1:.1f} s after it")
    print_distributed(dist, card)
    by_path.update(dist.pop("by_path"))
    k4_paths = dist.pop("k4_by_path")
    _empty_cache(device)

    # -- the arch zoo, after the earlier phases' servers, graphs and weights
    # are released --------------------------------------------------------
    print(f"arch zoo: {torch.cuda.memory_allocated(device) / 2**30:.2f} GiB "
          f"still allocated after the earlier phases")
    t0 = time.perf_counter()
    zoo = zoo_phase(device, (k1_launches, k2_launches, k3_launches,
                             k4_launches), card)
    print(f"arch zoo: {time.perf_counter() - t0:.1f} s")
    by_path.update(zoo["by_path"])
    k4_paths.update(zoo["k4_by_path"])
    graph_phases["zoo"] = zoo["graphs"]
    for z in zoo["archs"]:
        specs[z["arch"]]["drawn_on_card"] = {"layers": z["layers"], **z["specs"]}
    print(f"specs against the card: count_params equal to the numel of the "
          f"params drawn on {card} and param_shapes equal to their shapes and "
          f"dtypes leaf for leaf for {len(zoo['archs'])} archs at the zoo's "
          f"depths: " + ", ".join(f"{z['arch']} {z['specs']['count_params']:,}"
                                  for z in zoo["archs"]))

    # -- the dry run: DeepSeek-V3's multi-pod records, and two cells held on
    # the card against their dry runs -------------------------------------
    t0 = time.perf_counter()
    dr = dryrun_phase(device, k4_launches, card,
                      by_path["serve_lm_tp"]["flash_attention"], cli_records)
    dr["seconds"] = time.perf_counter() - t0
    print(f"dry-run phase: {dr['seconds']:.1f} s")
    print_dryrun(dr, card)
    by_path["dryrun"] = {"coded_worker": 0, "matmul": 0, "coded_gemm": 0,
                         "flash_attention": sum(c["card"]["k4_launches"]
                                                for c in dr["cells"])}
    _empty_cache(device)

    # -- the autotune ledger: VGG-16's K1/K2 cells swept, then served tuned
    at = autotune_phase(device, (k1_launches, k2_launches), card)
    print_autotune(at, card)
    by_path["autotune"] = at["launches"]
    _empty_cache(device)

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
    k4e["dryrun"] = dr["k4"]
    k4e["tiled_bf16"] = tiled_bf16_kernels(dr)
    # K4's launches by kernel on the zoo's and the process mesh's paths;
    # the 3xTF32 kernel must have served those whose fp32 shapes its plan
    # takes
    for path in ("zoo_whisper-medium_prefill_fn", "prefill_fn_tp_families",
                 "serve_lm_edges"):
        if not k4_paths.get(path, {}).get("tf32x3"):
            raise AssertionError(f"K4's 3xTF32 kernel launched no time on {path}: "
                                 f"{k4_paths.get(path)}")
    k4e["launches_by_kernel_by_path"] = k4_paths
    k4e["tiled_fp32"] = tiled_fp32_kernels(dr, k4_paths)
    k4e["tp_families"] = dist["tp_families"]["k4"]
    k4e["edges"] = dist["edges"]["k4"]
    for e in (k1e, k2e, k3e, k4e):
        e["launches_by_path"] = {path: counts[e["name"]]
                                 for path, counts in by_path.items()
                                 if e["name"] in counts}
    print(json.dumps({"train": tr}))
    print(json.dumps({"zoo": {"archs": zoo["archs"],
                              "qwen3_coded": zoo["qwen3_coded"]}}))
    print(json.dumps({"graphs": graph_phases}))
    print(json.dumps({"examples": ex, "specs": specs}))
    print(json.dumps({"distributed": dist}))
    print(json.dumps({"dryrun": dr}))
    print(json.dumps({"autotune": at}))
    print(json.dumps({"kernels": [k1e, k2e, k3e, k4e]}))
    ledger_dir.cleanup()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
