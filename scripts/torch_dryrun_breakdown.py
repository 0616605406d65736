"""Where a dry-run cell's temporary and collective bytes come from, on the
CPU (no card): the peak of the storages a step makes, broken down by the
op that made each one live at the peak, and the collectives' wire bytes
by the line of the model or step code that called them.

  PYTHONPATH=src python scripts/torch_dryrun_breakdown.py \\
      --cell smollm-135m:train_4k --cell qwen3-4b:prefill_32k --smoke-scale 16

Each cell is traced as rank 0 of the production (data 16, model 16) mesh
(``--multi-pod`` for 2 x 16 x 16), as ``repro_torch.launch.dryrun`` traces
it; ``REPRO_SEQ_PARALLEL=1`` in the environment turns the sequence-parallel
residual stream on.  Prints one JSON line a cell: ``temp``, ``collective``
(wire bytes), ``peak_by_op`` and ``collectives_by_site`` (the largest
``--top`` of each, bytes descending).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import traceback
from collections import defaultdict

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch import cost_analysis, dryrun  # noqa: E402
from repro_torch.launch.mesh import ProcessMesh, make_production_mesh  # noqa: E402

_SKIP = ("launch/mesh.py", "repro_torch/sharding.py", "scripts/")


def _site() -> str:
    """The innermost frame of the port outside the mesh and the hints."""
    for fr in reversed(traceback.extract_stack()):
        f = os.path.normpath(fr.filename).replace(os.sep, "/")
        if "repro_torch" in f and not any(s in f for s in _SKIP):
            return f"{f.split('repro_torch/')[-1]}:{fr.lineno} {fr.name}"
    return "backward (autograd engine)"


def breakdown(arch: str, shape: str, smoke: int | None, multi_pod: bool,
              top: int) -> dict:
    sites: dict = defaultdict(lambda: [0, 0.0])
    staged = ProcessMesh._staged

    def traced(self, t, run, kind, axes):
        out = staged(self, t, run, kind, axes)
        k = cost_analysis._KIND[kind]
        n = t.numel() * t.element_size()
        g = self.group_size(axes)
        entry = sites[f"{_site()} [{kind} {'+'.join(self._live(axes))}]"]
        entry[0] += 1
        entry[1] += cost_analysis.wire_bytes(
            k, n, n * (g if k == "all-gather" else 1), g)
        return out

    counters = []
    init = cost_analysis.CostCounter.__init__

    def by_op_init(self, *a, **kw):
        init(self, *a, **{**kw, "by_op": True})
        counters.append(self)

    prod = make_production_mesh(multi_pod=multi_pod)
    ProcessMesh._staged = traced
    cost_analysis.CostCounter.__init__ = by_op_init
    try:
        with dryrun.fake_mesh(prod.axis_sizes, prod.axis_names) as mesh:
            counter, out, _ = dryrun.lower_cell(arch, shape, mesh,
                                                smoke_scale=smoke)
    finally:
        ProcessMesh._staged = staged
        cost_analysis.CostCounter.__init__ = init
    ops = sorted(counter.peak_by_op.items(), key=lambda kv: -kv[1])[:top]
    by_site = sorted(sites.items(), key=lambda kv: -kv[1][1])[:top]
    return {"cell": f"{arch}:{shape}", "smoke": smoke,
            "seq_parallel": os.environ.get("REPRO_SEQ_PARALLEL") == "1",
            "temp": counter.peak_bytes,
            "collective": counter.cost.collective_bytes,
            "by_axis": counter.by_axis,
            "peak_by_op": dict(ops),
            "collectives_by_site": {k: {"calls": c, "wire_bytes": w}
                                    for k, (c, w) in by_site}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", action="append", required=True,
                    help="arch:shape, e.g. qwen3-4b:train_4k")
    ap.add_argument("--smoke-scale", type=int, default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    for cell in args.cell:
        arch, shape = cell.split(":")
        print(json.dumps(breakdown(arch, shape, args.smoke_scale,
                                   args.multi_pod, args.top)), flush=True)


if __name__ == "__main__":
    main()
