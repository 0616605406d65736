"""Serving CLI for both model families.

  * the coded CNNs (``lenet5``/``alexnet``/``vgg16``): a
    ``repro_torch.serving.CodedServer`` with one or several resident
    ``CodedPipeline``s sharing a straggler-injecting ``FcdccCluster``
    worker pool (``--pool threads`` or ``device``), continuous batching
    across the models' concurrent requests, optionally behind the JSON/HTTP
    front-end (``--http-port``);
  * the LMs (``configs.ARCH_IDS``: SmolLM, Qwen3, CodeQwen, Gemma2,
    PaliGemma, DeepSeek-V2/V3, RWKV6, Hymba, Whisper): a batched prefill
    (attention on K4 where K4 has an instance for the shape) plus a
    greedy decode loop with a KV cache through ``models.transformer``;
    the families without a cache-filling prefill (RWKV6, Hymba, Whisper's
    decoder over zero cross K/V, as the reference's loop) step their
    decoder over the prompt.  On the card the decode step and the
    prefill each replay one CUDA graph (``launch.steps.compiled_decode``,
    ``compiled_prefill``: the reference's ``jax.jit`` of both);
    ``serve_lm(graphs=False)`` runs them eagerly.  ``serve_lm(mesh=...)``
    serves over a process mesh: each rank its rows of the batch over the
    pod and data axes (a batch of one: the transformer's prompt and cache
    cut along the sequence over ``data``) and its cut of the params and
    caches over the ``model`` axis (tensor parallelism for every family,
    expert parallelism for the MoE, eagerly; the logits kept as each
    rank's vocab block, the greedy token picked across them).

It runs on the card by default, through the hand-written kernels.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch vgg16 \\
      --fuse-transitions --requests 16 --workers 8 --stragglers 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch lenet5 \\
      --device cpu --pool device --http-port 0
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --batch 4 --prompt-len 32 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b \\
      --smoke --device cpu --batch 2 --prompt-len 8 --gen 8
"""
from __future__ import annotations

import argparse
import contextlib
import time
from typing import Callable

import numpy as np
import torch

from ..configs import ARCH_IDS, get_bundle
from ..core.graphs import GraphSet, graph_class
from ..core.pipeline import build_cnn_pipeline
from ..devices import resolve_device
from ..models.cnn import CNN_SPECS, init_cnn, input_hw
from ..models.common import greedy, schema_shardings, whole_vocab
from ..models.registry import with_layers
from ..runtime import StragglerModel
from ..serving import CodedServer, ServingFrontend
from ..sharding import (BATCH, MODEL, QUEUE_3C, NamedSharding, PartitionSpec,
                        check_data_parallel, hold_sequence, keep_vocab_cut,
                        resolve_pspec, sequence_ranks, shard_tree, use_mesh,
                        whole_sequence)
from . import steps as steps_mod

__all__ = ["build_cnn_server", "serve_cnn", "serve_lm", "serve", "main"]


def serve_lm(arch: str, *, batch: int, prompt_len: int, gen: int,
             smoke: bool = False, seed: int = 0,
             param_dtype: torch.dtype = torch.float32,
             device: str | torch.device = "cuda", layers: int | None = None,
             params: dict | None = None,
             timings: dict | None = None, graphs=True,
             on_logits: Callable[[torch.Tensor], None] | None = None,
             mesh=None) -> torch.Tensor:
    """Greedy generation for ``batch`` random prompts: one batched prefill
    fills the cache (or, for a family without one, ``decode_fn`` steps
    over the prompt one token at a time), then ``gen`` decode steps,
    through the model's first ``layers`` layers where given (full width,
    less depth; all of them otherwise).  Weights are ``params`` where given, else drawn in
    ``param_dtype`` (the cache's dtype too) from a ``torch.Generator`` on
    ``device`` seeded with ``seed`` (on the card for CUDA, leaf by leaf);
    prompts from a CPU generator seeded with ``seed + 1``.

    ``graphs`` (``core.graphs.graph_class``): ``True`` replays the decode
    step and the prefill from CUDA graphs on the card (one each for this
    call's batch, prompt length and cache length; the reference's
    ``jax.jit``) and runs eagerly on the CPU; ``False`` runs eagerly; a
    graph class captures with that class on any device.  ``on_logits`` is
    called with the logits of every prefill or decode call, in order.
    Prints prefill/decode times and tok/s, and writes them (``prefill_s``,
    ``decode_s``, ``tok_s``, ``init_s`` where it drew the weights, and
    ``graphs``, the graph set's ``stats()``, where it captured) into
    ``timings`` where given; returns the generated tokens ``(batch,
    gen)``.

    ``mesh`` (a ``launch.mesh.ProcessMesh``; every rank calls
    ``serve_lm``) serves data-parallel on the mesh's device: each rank
    draws the same params and prompts, serves its rows of the batch (cut
    over the pod and data axes, which must divide ``batch``), captured as
    above (a decode step holds no collective), and the tokens are
    all-gathered to every rank at the end.  ``decode_s`` is this rank's,
    ``tok_s`` every rank's tokens over the slowest rank's decode time.
    Rank 0 prints.  A ``batch`` of 1 over data ranks holds its sequence
    (``sharding.hold_sequence``): the transformer family prefills each
    rank's block of the prompt (equal blocks of one position or more; a
    prompt that does not divide over the ranks whole on every rank,
    ``sharding.whole_sequence``) into its block of the cache (where the
    cache's length divides, else the whole cache), and each decode step
    attends over the ranks' blocks merged by log-sum-exp; the other
    families step ``decode_fn`` over the whole prompt on every rank.  Over a ``model``
    axis of more than one rank (every family: the transformer, RWKV6,
    Hymba and Whisper) each rank draws the params a leaf at a time and
    keeps its cut (``params``, where given, are this rank's cut), its
    cache is its cut (``bundle.make_cache`` under the mesh: the
    transformer's ``cache_layout``, the other families' ``cache_axes``
    through ``registry.rank_cache``), its logits its vocab block (the
    greedy token picked across the blocks, ``models.common.greedy``; the
    blocks gathered for ``on_logits`` only), and the steps run eagerly:
    they hold collectives, so ``graphs`` must resolve to no capture
    (``graphs=False`` on the card), else ``NotImplementedError`` (the
    distributed step captured is ROADMAP Queue A item 3(c)).  Any step
    over a cut sequence runs eagerly too."""
    if arch not in ARCH_IDS:
        raise SystemExit(f"unknown LM arch {arch!r}; valid: {ARCH_IDS}")
    dev = resolve_device(device)
    rows, held = None, ()
    if steps_mod.spans_ranks(mesh):
        if mesh.device.type != dev.type:
            raise ValueError(f"device {dev} for a mesh on {mesh.device}")
        dev = mesh.device
        if batch == 1 and mesh.shape.get("data", 1) > 1:
            held = ("data",)
            # a prompt that does not divide is whole on every rank, as the
            # reference replicates it (the cache is cut by its own length)
            cut = (get_bundle(arch, smoke=smoke).prefill_cache_fn is not None
                   and prompt_len % mesh.shape["data"] == 0)
            spec = PartitionSpec(None, "data" if cut else None)
        else:
            spec = resolve_pspec((batch, prompt_len), (BATCH, None),
                                 mesh.shape)
            check_data_parallel(spec, 0, mesh.shape, True,
                                f"serving a batch of {batch}")
        rows = NamedSharding(mesh, spec)
    with use_mesh(mesh), hold_sequence(held):
        return _serve_lm(arch, dev, rows, batch=batch, prompt_len=prompt_len,
                         gen=gen, smoke=smoke, seed=seed,
                         param_dtype=param_dtype, layers=layers,
                         params=params, timings=timings, graphs=graphs,
                         on_logits=on_logits)


def _serve_lm(arch, dev, rows, *, batch, prompt_len, gen, smoke, seed,
              param_dtype, layers, params, timings, graphs, on_logits):
    """``serve_lm`` on ``dev``; ``rows`` cuts this rank's rows of the
    batch where serving over a process mesh."""
    bundle = get_bundle(arch, smoke=smoke)
    if layers is not None:
        bundle = with_layers(bundle, layers)
    max_len = prompt_len + gen
    mesh = None if rows is None else rows.mesh
    model = 1 if mesh is None else mesh.shape.get(MODEL, 1)
    seq = sequence_ranks()  # a held sequence (batch 1 over data)
    # the prompt cut over it, or whole on every rank
    block = seq is not None and rows.spec[1] is not None
    cls = graph_class(graphs, dev)
    if (model > 1 or seq is not None) and cls is not None:
        raise NotImplementedError(
            f"serving over model = {model} or a sequence cut over data runs "
            f"eagerly (graphs=False): its steps hold collectives, which no "
            f"graph captures; {QUEUE_3C}")
    vocab = bundle.cfg.vocab

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    drawn = {}
    if params is None:
        t0 = time.perf_counter()
        params = bundle.init(torch.Generator(device=dev).manual_seed(seed),
                             param_dtype, dev,
                             schema_shardings(bundle.schema, mesh)
                             if model > 1 else None)
        sync()
        drawn["init_s"] = time.perf_counter() - t0
    prompts = torch.randint(0, bundle.cfg.vocab, (batch, prompt_len),
                            generator=torch.Generator().manual_seed(seed + 1)
                            ).to(dev)
    if rows is not None:
        prompts = shard_tree(prompts, rows)
        batch = prompts.shape[0]
    cache = bundle.make_cache(batch, max_len, param_dtype, dev)
    gs = None if cls is None else GraphSet("serve", dev, cls)
    decode = steps_mod.compiled_decode(bundle, gs, max_len, dev)

    def seen(logits, block: bool = False):
        """The next token from a call's logits (this rank's vocab block;
        with ``block``, this rank's block of the prompt's positions), the
        whole logits handed to ``on_logits`` first."""
        if on_logits is not None:
            whole = whole_vocab(logits, vocab)
            if block:
                whole = mesh.all_gather(whole, seq.axes, dim=1)
            on_logits(whole)
        last = logits[:, -1]
        if block:  # the prompt's last position: the last rank's
            last = mesh.all_gather(last[:, None], seq.axes, dim=1)[:, -1]
        return greedy(last, vocab)[:, None]

    t0 = time.perf_counter()
    with keep_vocab_cut():
        if prompt_len > 0:
            if bundle.prefill_cache_fn is not None:
                prefill = steps_mod.compiled_prefill(bundle, gs)
                with (contextlib.nullcontext() if block or seq is None
                      else whole_sequence()):
                    logits = prefill(params, cache, prompts)
                tok = seen(logits, block)
            else:
                for t in range(prompt_len):
                    tok = seen(decode(params, cache, prompts[:, t:t + 1], t))
        else:  # empty prompt: no logits yet, start from token 0
            tok = torch.zeros((batch, 1), dtype=torch.long, device=dev)
        sync()
        prefill_s = time.perf_counter() - t0

        out_tokens = []
        t0 = time.perf_counter()
        for t in range(prompt_len, max_len):
            out_tokens.append(tok)
            tok = seen(decode(params, cache, tok, t))
        sync()
        decode_s = time.perf_counter() - t0
    seq_tokens = torch.cat(out_tokens, dim=1)
    span_s = decode_s
    if rows is not None:
        if seq is None:  # every rank's rows; a held sequence's are alike
            seq_tokens = rows.mesh.all_gather(seq_tokens, BATCH, dim=0)
        # every rank's tokens over the slowest rank's decode time
        span_s = float(rows.mesh.all_gather(torch.tensor(
            [decode_s], dtype=torch.float64, device=dev), BATCH).max())
    tok_s = seq_tokens.shape[0] * gen / span_s
    if rows is None or rows.mesh.device_mesh.get_rank() == 0:
        print(f"{arch}: prefill {prompt_len} toks in {prefill_s:.2f}s; "
              f"generated {gen} x {seq_tokens.shape[0]} in {span_s:.2f}s "
              f"({tok_s:.1f} tok/s)")
    if timings is not None:
        timings.update(drawn, prefill_s=prefill_s, decode_s=decode_s,
                       tok_s=tok_s)
        if gs is not None:
            timings["graphs"] = gs.stats()
    return seq_tokens


def _check_cnn_archs(archs) -> None:
    unknown = [a for a in archs if a not in CNN_SPECS]
    if unknown:
        raise SystemExit(
            f"unknown CNN arch(s) {unknown}; valid: {sorted(CNN_SPECS)}")
    dupes = sorted({a for a in archs if archs.count(a) > 1})
    if dupes:
        raise SystemExit(f"duplicate --arch value(s) {dupes}; each model "
                         f"registers once on the shared pool")


def build_cnn_server(archs, *, workers: int, stragglers: int,
                     straggler_delay: float, smoke: bool = False, kab=(2, 4),
                     mode: str = "threads", seed: int = 0,
                     fuse_transitions: bool = False, pipeline_depth: int = 2,
                     pool: str | None = None,
                     device: str | torch.device = "cuda") -> CodedServer:
    """One multi-model ``CodedServer``: every arch's pipeline resident on
    the same n-worker pool, weights drawn from a ``torch.Generator`` seeded
    with ``seed``.  ``fuse_transitions`` serves on the partition-resident
    path; ``pipeline_depth`` is how many worker rounds may be in flight;
    ``pool`` picks the worker executor (``"threads"``, ``"device"``: each
    coded worker on a device with a stream of its own, reaped by CUDA
    events; None: the device pool where several cards are visible)."""
    _check_cnn_archs(archs)
    straggler = StragglerModel.fixed(workers, stragglers, straggler_delay,
                                     seed=seed)
    server = CodedServer(straggler=straggler, mode=mode,
                         bucket_sizes=(1, 2, 4, 8), pool=pool,
                         pipeline_depth=pipeline_depth)
    for arch in archs:
        params = init_cnn(arch, torch.Generator().manual_seed(seed), device)
        server.register_model(arch, build_cnn_pipeline(
            arch, params, workers, default_kab=kab,
            input_hw=input_hw(arch, smoke=smoke),
            fuse_transitions=fuse_transitions, device=device,
        ))
    return server


def serve_cnn(archs, *, requests: int, workers: int, stragglers: int,
              straggler_delay: float, smoke: bool = False, kab=(2, 4),
              mode: str = "threads", seed: int = 0,
              fuse_transitions: bool = False, pipeline_depth: int = 2,
              pool: str | None = None, http_port: int | None = None,
              device: str | torch.device = "cuda"):
    """Serve one or several CNN archs from one shared coded worker pool.

    Without ``http_port``: fire ``requests`` concurrent single-image
    requests per model and print latency/throughput stats; returns
    ``(outputs per model, stats)``.  With it: raise the JSON front-end on
    that port (0 = an ephemeral one), serve until interrupted, drain, and
    return ``(None, stats)``.

    Default ``mode="threads"``: the printed percentiles are wall-clock, so
    injected straggler delays really elapse."""
    archs = [archs] if isinstance(archs, str) else list(archs)
    server = build_cnn_server(
        archs, workers=workers, stragglers=stragglers,
        straggler_delay=straggler_delay, smoke=smoke, kab=kab, mode=mode,
        seed=seed, fuse_transitions=fuse_transitions,
        pipeline_depth=pipeline_depth, pool=pool, device=device,
    )
    server.warmup()
    if http_port is not None:
        frontend = ServingFrontend(server, port=http_port)
        with frontend:
            print(f"serving {archs} on {frontend.url} (POST /v1/infer, "
                  f"GET /v1/models, GET /v1/stats); Ctrl-C drains and exits",
                  flush=True)
            try:
                frontend._thread.join()
            except KeyboardInterrupt:
                print("\ndraining ...")
        for m, st in server.per_model_stats().items():
            print(f"{m}: {st.summary_line()}")
        return None, server.stats()
    rng = np.random.default_rng(seed)
    handles = []
    with server:
        for arch in archs:
            hw0 = input_hw(arch, smoke=smoke)
            c0 = CNN_SPECS[arch][1][0].in_ch
            xs = rng.standard_normal((requests, c0, hw0, hw0)).astype(np.float32)
            handles.append(server.submit_many(xs, arch))
        outs = [[h.result(timeout=300.0) for h in hs] for hs in handles]
    where = (torch.cuda.get_device_name(server.cluster.device)
             if server.cluster.device.type == "cuda" else "cpu")
    for arch in archs:
        stats = server.stats(arch) if len(archs) > 1 else server.stats()
        print(f"{arch}: coded serving on n={workers} shared workers "
              f"({stragglers} stragglers +{straggler_delay}s) on {where}: "
              f"{stats.summary_line()}")
    agg = server.stats()
    if len(archs) > 1:
        print(f"aggregate: {agg.summary_line()} "
              f"(coalesced merges: {agg.coalesced})")
    return outs, agg


def serve(arch: str, *, batch: int, prompt_len: int, gen: int,
          smoke: bool = False, mesh=None,
          param_dtype: torch.dtype = torch.float32,
          workers: int = 8, stragglers: int = 1, straggler_delay: float = 0.1,
          device: str | torch.device = "cuda"):
    """Route by family, as the reference's ``serve``: a CNN arch goes to
    the coded serving engine (``batch`` concurrent requests on ``workers``
    workers, ``stragglers`` of them ``straggler_delay`` s late) and returns
    its outputs; an LM arch to the decode loop (over ``mesh`` where given),
    returning its tokens.  A CNN's workers are the coded cluster's, so a
    mesh is refused there."""
    if arch in CNN_SPECS:
        if mesh is not None:
            raise ValueError(f"{arch}: the CNN archs serve on the coded "
                             f"cluster's workers; mesh= is for the LMs")
        outs, _ = serve_cnn(arch, requests=batch, workers=workers,
                            stragglers=stragglers,
                            straggler_delay=straggler_delay, smoke=smoke,
                            device=device)
        return outs[0]
    return serve_lm(arch, batch=batch, prompt_len=prompt_len, gen=gen,
                    smoke=smoke, param_dtype=param_dtype, device=device,
                    mesh=mesh)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", action="append", default=None,
                    help=f"CNN ({sorted(CNN_SPECS)}; repeat to co-serve "
                         f"several CNNs on one pool) or LM ({ARCH_IDS})")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced input resolution (SMOKE_HW) / the LM's "
                         "smoke config")
    ap.add_argument("--batch", type=int, default=4, help="LM: prompts")
    ap.add_argument("--prompt-len", type=int, default=32, help="LM")
    ap.add_argument("--gen", type=int, default=32, help="LM: new tokens")
    ap.add_argument("--layers", type=int, default=None,
                    help="LM: run only the first LAYERS layers (full width)")
    ap.add_argument("--requests", type=int, default=16,
                    help="concurrent single-image requests per model")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--stragglers", type=int, default=2)
    ap.add_argument("--straggler-delay", type=float, default=0.1)
    ap.add_argument("--mode", default="threads",
                    choices=("threads", "simulated"),
                    help="threads = wall-clock straggler sleeps")
    ap.add_argument("--fuse-transitions", action="store_true",
                    help="partition-resident layer transitions: batches "
                         "advance between ConvLs as coded partition shares")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="worker rounds in flight at once (1 = serial)")
    ap.add_argument("--pool", default="auto",
                    choices=("auto", "threads", "device"),
                    help="CNN worker executor: device = each coded worker on "
                         "a device with a stream of its own, reaped by CUDA "
                         "events; auto picks it where several cards are "
                         "visible")
    ap.add_argument("--http-port", type=int, default=None,
                    help="CNN: serve the JSON front-end on this port until "
                         "interrupted (0 = ephemeral)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises when absent) or cpu")
    args = ap.parse_args(argv)
    archs = args.arch or ["vgg16"]
    lm_archs = [a for a in archs if a in ARCH_IDS]
    if lm_archs:
        if len(archs) != 1:
            raise SystemExit("an LM arch is served alone: pass one --arch")
        if args.http_port is not None:
            raise SystemExit("--http-port serves the CNN archs only")
        serve_lm(lm_archs[0], batch=args.batch, prompt_len=args.prompt_len,
                 gen=args.gen, smoke=args.smoke, device=args.device,
                 layers=args.layers)
        return
    serve_cnn(archs, requests=args.requests,
              workers=args.workers, stragglers=args.stragglers,
              straggler_delay=args.straggler_delay, smoke=args.smoke,
              mode=args.mode, fuse_transitions=args.fuse_transitions,
              pipeline_depth=args.pipeline_depth,
              pool=None if args.pool == "auto" else args.pool,
              http_port=args.http_port, device=args.device)


if __name__ == "__main__":
    main()
