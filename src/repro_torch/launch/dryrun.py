"""Multi-pod dry run: trace every (arch x shape x mesh) cell as one rank of
the production mesh, with no device and no allocation.

The reference (``src/repro/launch/dryrun.py``) lowers and compiles each
cell's jitted step on 512 host devices and reads XLA's memory analysis and
the HLO's cost.  The port has no compiler between its eager step and the
device, so it traces the step itself.  For each cell it:

  1. joins a ``fake`` process group (``torch.distributed``'s backend whose
     collectives return at once and move nothing) of 256 or 512 ranks as
     rank 0, and lays them out as the production mesh, (data 16, model 16)
     or (pod 2, data 16, model 16), in a ``ProcessMesh`` on the meta device;
  2. builds the cell's params (bf16), optimizer state, batch and cache as
     meta tensors (shapes and dtypes, no storage) and cuts each leaf to
     this rank's shard (``sharding.shard_tree``);
  3. calls the cell's step once, the train step a ``ParallelStep``, under a
     ``cost_analysis.CostCounter``: FLOPs, HBM bytes, the collectives' wire
     bytes by kind and by mesh axis, argument / output / temporary bytes,
     and the K4 launches it would make (``flash_attention`` on meta
     operands charges their work);
  4. writes the record to ``results/dryrun_torch/<cell>.json`` (a
     resumable cache) and tears the process group down.

A cell that raises is recorded with ``status: "error"`` and counts as a
failure, as a sharding bug does in the reference (a placement the port
does not execute, ROADMAP Queue A item 3(c)).  Nothing here touches
CUDA.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--force]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch

from ..configs import ARCH_IDS, get_bundle
from ..configs.shapes import SHAPES, batch_structs
from ..models.common import count_params, schema_shardings
from ..sharding import NamedSharding, baseline, shard_tree, use_mesh
from ..tree import tree_map
from . import steps as steps_mod
from .cost_analysis import CostCounter
from .mesh import make_process_mesh, make_production_mesh

__all__ = ["RESULTS_DIR", "cell_skip_reason", "fake_mesh", "cell_bundle",
           "train_config", "count_step", "lower_cell", "run_cell", "main"]

RESULTS_DIR = os.path.join(os.path.dirname(__file__),
                           "../../../results/dryrun_torch")


# Cells skipped by design: long_500k needs sub-quadratic attention; pure
# full-attention archs skip it.
def cell_skip_reason(bundle, shape: str) -> str | None:
    if shape == "long_500k" and not bundle.sub_quadratic:
        return "long_500k skipped: full-attention arch (quadratic); see DESIGN.md"
    return None


@contextlib.contextmanager
def fake_mesh(axis_sizes, axis_names):
    """A ``ProcessMesh`` of ``axis_sizes`` on the meta device whose rank 0
    is this process, over a ``fake`` process group of as many ranks (a
    ``HashStore`` rendezvous); the group is destroyed on the way out.  The
    process must not be in a process group already."""
    import torch.distributed as dist
    # registers the "fake" backend (torch's FakeProcessGroup)
    import torch.testing._internal.distributed.fake_pg  # noqa: F401

    if dist.is_initialized():
        raise RuntimeError("the dry run joins a fake process group of its "
                           "own: this process is in one already")
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=math.prod(axis_sizes))
    try:
        yield make_process_mesh(axis_sizes, axis_names, device="meta",
                                backend="fake")
    finally:
        dist.destroy_process_group()


def cell_bundle(arch: str, shape: str, mesh, smoke_scale=None):
    """The cell's bundle at full config; DeepSeek's MoE dispatch groups
    aligned with the data-parallel degree where the batch divides it (the
    reference's rule, ``dryrun.py:59-65``)."""
    kw = {}
    if arch.startswith("deepseek") and shape != "long_500k":
        dp = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
        b = SHAPES[shape]["global_batch"]
        if smoke_scale:
            b = max(b // smoke_scale, 2)
        kw["dispatch_groups"] = dp if b % dp == 0 else 1
    return get_bundle(arch, **kw)


def train_config(bundle) -> steps_mod.TrainConfig:
    """The reference's train cell (``dryrun.py:77-85``): 8 microbatches
    above 1e11 params, 4 above 5e9; FSDP above 5e9 (on smaller models the
    weight all-gathers cost more than they save); ``REPRO_BASELINE=1``
    turns both off."""
    base = baseline()
    n_params = count_params(bundle.schema)
    micro = 1 if base else (8 if n_params > 1e11 else
                            4 if n_params > 5e9 else 1)
    return steps_mod.TrainConfig(microbatches=micro,
                                 fsdp=(not base) and n_params > 5e9)


def _cut(tree, specs, mesh):
    return shard_tree(tree, tree_map(lambda sp: NamedSharding(mesh, sp), specs))


def count_step(bundle, kind: str, params, batch, cache=None, opt_state=None, *,
               mesh=None, tcfg=None):
    """One call of the cell's step under a ``CostCounter``: ``(counter,
    outputs)``.  ``params``, ``opt_state``, ``batch`` and ``cache`` are the
    whole trees (meta tensors in the dry run, real ones on the card);
    under a process mesh each is cut to this rank's shard first.  A train
    step over several ranks is a ``ParallelStep``, which takes the global
    batch and cuts its rows itself (its arguments count only those rows).
    Prefill and decode run under ``use_mesh(mesh)`` and ``no_grad``; the
    decode step takes its position as the host int 0 (a tensor position
    refuses model ranks), the batch's position scalar still counted among
    its arguments (as read, as the reference's step reads it); an
    argument the step never reads is not counted (Whisper's decode reads
    no encoder weight), as ``jax.jit`` drops it from the reference's."""
    if kind == "train":
        step = steps_mod.build_train_step(bundle, tcfg, mesh)
        if isinstance(step, steps_mod.ParallelStep):
            params = shard_tree(params, step.param_shardings)
            opt_state = shard_tree(opt_state, step.opt_shardings)
            args = (params, opt_state, step.local_batch(batch))
        else:
            args = (params, opt_state, batch)
        # a ParallelStep cuts its rows from the global batch itself: the
        # rows it reads are those
        with CostCounter(args, mesh, read=args[2]) as counter:
            out = step(params, opt_state, batch)
        return counter, out
    if mesh is not None:
        params = shard_tree(params, schema_shardings(bundle.schema, mesh))
        batch = _cut(batch, steps_mod.batch_pspecs(bundle, batch, mesh), mesh)
        if cache is not None:
            cache = _cut(cache, steps_mod.cache_pspecs(bundle, cache, mesh), mesh)
    with use_mesh(mesh), torch.no_grad():
        if kind == "prefill":
            step = steps_mod.build_prefill_step(bundle)
            with CostCounter((params, batch), mesh) as counter:
                out = step(params, batch)
        else:
            step = steps_mod.build_serve_step(bundle)
            with CostCounter((params, cache, batch), mesh,
                             read=batch["pos"]) as counter:
                out = step(params, cache, {**batch, "pos": 0})
    return counter, out


def lower_cell(arch: str, shape: str, mesh, *, smoke_scale=None, extra=None):
    """Trace one cell as this rank of ``mesh`` (a ``fake_mesh``; the
    reference lowers and compiles here): the cell's step called once on
    meta tensors.  Returns ``(counter, outputs, meta)``, the counter a
    ``CostCounter``.  Raises where the step does (a placement the port
    does not execute)."""
    bundle = cell_bundle(arch, shape, mesh, smoke_scale)
    if extra:
        bundle = extra(bundle)
    kind = SHAPES[shape]["kind"]
    batch, cache = batch_structs(bundle, shape, smoke_scale=smoke_scale)
    params = bundle.param_shapes(torch.bfloat16)
    tcfg = opt_state = None
    if kind == "train":
        tcfg = train_config(bundle)
        opt_state = steps_mod.make_opt_shapes(bundle, torch.bfloat16)
    counter, out = count_step(bundle, kind, params, batch, cache, opt_state,
                              mesh=mesh, tcfg=tcfg)
    return counter, out, {"bundle": bundle, "kind": kind, "tcfg": tcfg}


def run_cell(arch: str, shape: str, *, multi_pod: bool, force=False,
             smoke_scale=None):
    tag = f"{arch}__{shape}__{'2x16x16' if multi_pod else '16x16'}"
    if smoke_scale:
        # smoke runs get their own cache file: a scaled-down record must
        # never be resumed as a production cell
        tag += f"__smoke{smoke_scale}"
    os.makedirs(RESULTS_DIR, exist_ok=True)
    out_path = os.path.join(RESULTS_DIR, tag + ".json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            cached = json.load(f)
        if cached.get("smoke_scale", -1) == smoke_scale:
            return cached

    bundle = get_bundle(arch)
    skip = cell_skip_reason(bundle, shape)
    rec = {"arch": arch, "shape": shape, "multi_pod": multi_pod, "tag": tag,
           "smoke_scale": smoke_scale}
    if skip:
        rec.update(status="skipped", reason=skip)
    else:
        prod = make_production_mesh(multi_pod=multi_pod)
        t0 = time.time()
        try:
            with fake_mesh(prod.axis_sizes, prod.axis_names) as mesh:
                counter, out, _ = lower_cell(arch, shape, mesh,
                                             smoke_scale=smoke_scale)
                rec.update(
                    status="ok", trace_s=round(time.time() - t0, 1),
                    devices=mesh.size, memory=counter.memory(out),
                    cost=counter.cost.as_dict(), by_axis=counter.by_axis,
                    kernels=counter.kernels)
        except Exception as e:  # a placement the port lacks: record it
            rec.update(status="error", error=f"{type(e).__name__}: {e}",
                       trace=traceback.format_exc()[-2000:])
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    status = rec["status"]
    print(f"[{status:7s}] {tag} " + (
        f"trace={rec['trace_s']}s temp="
        f"{rec['memory']['temp_size_in_bytes'] / 2**30:.2f}GiB"
        if status == "ok" else rec.get("reason", rec.get("error", ""))[:160]
    ), flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--smoke-scale", type=int, default=None,
                    help="divide batch/seq for quick validation")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = 0
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, multi_pod=mp, force=args.force,
                               smoke_scale=args.smoke_scale)
                failures += rec["status"] == "error"
    print(f"\ndone; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
