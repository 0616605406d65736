"""End-to-end training entry point, as the reference's ``launch/train.py``, on
one device: the deterministic resumable data pipeline, AdamW under a
cosine schedule, checkpoint / restart with an asynchronous writer.

It runs on the card unless asked for the CPU, with TF32 off for every
product (the reference trains in true fp32).  On the card each step
replays one CUDA graph (``launch.steps.compiled_train_step``: the
reference's ``jax.jit`` of the step); ``train(graphs=False)`` runs it
eagerly.  ``train(mesh=...)`` trains over a process mesh
(``launch.mesh.make_process_mesh``), eagerly: data-parallel (FSDP by
default) over its pod and data axes and tensor parallel (every family;
the MoE expert parallel too) over its ``model`` axis.  Every rank calls it,
e.g. under ``torchrun --nproc-per-node N``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 200 --batch 8 --seq 256
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --smoke --device cpu --steps 20 --batch 4 --seq 32
"""
from __future__ import annotations

import argparse
import time
from typing import Callable

import torch

from ..checkpoint import AsyncCheckpointer, latest_step, restore
from ..configs import ARCH_IDS, get_bundle
from ..core.graphs import GraphSet, graph_class
from ..devices import fp32_products, resolve_device
from ..data import DataConfig, SyntheticTokens
from ..models.registry import with_layers
from ..optim import AdamWConfig, init_state
from ..sharding import gather_tree, use_mesh
from . import steps as steps_mod

__all__ = ["train", "main"]


def train(arch: str, *, steps: int, batch: int, seq: int, smoke: bool = False,
          ckpt_dir: str | None = None, ckpt_every: int = 50,
          grad_compression: str | None = None, lr: float = 3e-4,
          log_every: int = 10, param_dtype: torch.dtype = torch.float32,
          device: str | torch.device = "cuda", seed: int = 0,
          on_step: Callable[[int, dict], None] | None = None,
          graphs=True, mesh=None, layers: int | None = None) -> list[float]:
    """Train ``arch`` for steps ``start..steps-1`` (``start`` the latest
    checkpoint in ``ckpt_dir``, else 0) on synthetic tokens; returns the
    losses of the steps it ran.

    ``layers`` cuts the model to its first ``layers`` layers (full width,
    less depth; Whisper's encoder and decoder alike).  Params are drawn
    from a ``torch.Generator`` seeded with ``seed``; stub
    frontend inputs (an ``"encdec"`` bundle's frames (batch, enc_len,
    d_model), a ``"vlm"`` bundle's prefix embeddings) from a CPU one
    seeded with ``seed + 1 + step``, in the param dtype.  A checkpoint
    ``{"params", "opt"}`` is submitted every ``ckpt_every`` steps and at
    the end.  ``on_step(step, metrics)`` is called after each step, the
    loss already on the host (``metrics["loss"]`` a float).  TF32 is off
    for the run.  ``graphs`` (``core.graphs.graph_class``): ``True``
    replays each step from one CUDA graph on the card (captured at this
    call's first step) and runs eagerly on the CPU; ``False`` runs
    eagerly; a graph class captures with that class on any device.

    ``mesh`` (a ``launch.mesh.ProcessMesh``; every rank calls ``train``)
    trains on the mesh's device: each rank draws the same params from
    ``seed`` a leaf at a time and keeps its cut of each (over ``model`` as
    ``schema_shardings`` places it, and over the data axes with FSDP,
    ``TrainConfig``'s default, as the reference's), and takes its rows of
    each global batch (``steps.ParallelStep``; a global batch of 1, its
    block of the sequence over the data ranks); ``grad_compression``
    applies where the mesh has a ``"pod"`` axis.  Its steps run eagerly
    (with ``graphs`` a graph class, or ``True`` on the card, it raises).  Checkpoints are
    gathered to full leaves and written by rank 0 alone, so they restore
    under any mesh or none; every rank restores its shards.  Rank 0 logs;
    every rank returns the same losses."""
    dev = resolve_device(device)
    if steps_mod.spans_ranks(mesh):
        if mesh.device.type != dev.type:
            raise ValueError(f"device {dev} for a mesh on {mesh.device}")
        dev = mesh.device
    with fp32_products(), use_mesh(mesh):
        bundle = get_bundle(arch, smoke=smoke)
        if layers is not None:
            bundle = with_layers(bundle, layers)
        tcfg = steps_mod.TrainConfig(
            opt=AdamWConfig(lr=lr), warmup=min(20, steps // 10 + 1),
            total_steps=steps, grad_compression=grad_compression,
        )
        cls = graph_class(graphs, dev)
        train_step = steps_mod.build_train_step(bundle, tcfg, mesh)
        step_fn = steps_mod.compiled_train_step(
            train_step, None if cls is None else GraphSet("train", dev, cls))
        dp = (train_step if isinstance(train_step, steps_mod.ParallelStep)
              else None)
        lead = dp is None or mesh.device_mesh.get_rank() == 0

        shardings = None
        if dp is not None:
            shardings = {"params": dp.param_shardings, "opt": dp.opt_shardings}
        params = bundle.init(torch.Generator().manual_seed(seed), param_dtype,
                             dev, None if dp is None else dp.param_shardings)
        opt_state = init_state(params)

        def full_state():
            state = {"params": params, "opt": opt_state}
            return state if dp is None else gather_tree(state, shardings)

        start = 0
        ckpt = None
        if ckpt_dir:
            ckpt = AsyncCheckpointer(ckpt_dir) if lead else None
            last = latest_step(ckpt_dir)
            if last is not None:
                state = restore(ckpt_dir, last,
                                {"params": params, "opt": opt_state},
                                shardings=shardings)
                params, opt_state = state["params"], state["opt"]
                start = last
                if lead:
                    print(f"restored step {start} from {ckpt_dir}")

        data = SyntheticTokens(
            DataConfig(vocab=bundle.cfg.vocab, seq_len=seq, global_batch=batch))
        losses = []
        try:
            t0 = time.time()
            for step in range(start, steps):
                b = {k: torch.from_numpy(v).to(dev)
                     for k, v in data.batch(step).items()}
                if bundle.family in ("encdec", "vlm"):
                    key, n = (("frames", bundle.cfg.enc_len)
                              if bundle.family == "encdec" else ("prefix", 8))
                    gen = torch.Generator().manual_seed(seed + 1 + step)
                    b[key] = torch.randn(
                        (batch, n, bundle.cfg.d_model), generator=gen,
                    ).to(dev, param_dtype)
                params, opt_state, metrics = step_fn(params, opt_state, b)
                losses.append(float(metrics["loss"]))
                if on_step is not None:
                    on_step(step, {**metrics, "loss": losses[-1]})
                if lead and (step + 1) % log_every == 0:
                    dt = (time.time() - t0) / log_every
                    print(f"step {step + 1:5d} loss {losses[-1]:.4f} "
                          f"gnorm {float(metrics['grad_norm']):.3f} "
                          f"{dt * 1e3:.0f} ms/step", flush=True)
                    t0 = time.time()
                if ckpt_dir and (step + 1) % ckpt_every == 0:
                    state = full_state()  # every rank gathers
                    if ckpt:
                        ckpt.submit(step + 1, state)
            if ckpt_dir:
                state = full_state()
                if ckpt:
                    ckpt.submit(steps, state)
        finally:
            if ckpt:
                ckpt.wait()
        if dp is not None and ckpt_dir:
            # no rank returns before rank 0's write is in place
            torch.distributed.barrier()
        return losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m", help=f"one of {ARCH_IDS}")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--grad-compression", default=None,
                    choices=("int8", "topk"),
                    help="accepted; applies only across a 'pod' axis, which "
                         "one device lacks (warns)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises when absent) or cpu")
    args = ap.parse_args(argv)
    losses = train(
        args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        smoke=args.smoke, ckpt_dir=args.ckpt_dir,
        grad_compression=args.grad_compression, lr=args.lr,
        device=args.device,
    )
    if losses:
        print(f"first loss {losses[0]:.4f} -> last loss {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
