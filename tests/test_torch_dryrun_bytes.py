"""The port's dry run against the reference's on temporary and collective
bytes (ROADMAP Queue C item 2), on the CPU: the three cells where the port
had counted 1.76-4.80x the reference's temporary bytes, on the 16 x 16
mesh at smoke scale 16, and one cell on 2 x 16 x 16.  The reference's
cells are lowered in a subprocess (``_torch_dryrun_ref.py``: ``repro.launch.dryrun`` sets
``XLA_FLAGS`` for 512 host devices before jax is imported).

Held, with their tolerances:

* temporary bytes a rank at most ``TEMP_RATIO`` = 1.25x the reference's
  ``memory_analysis().temp_size_in_bytes``.  Since the logits stay
  vocab-cut through the loss and the prefill and the AdamW update runs in
  slices, the port counts 0.97x, 0.55x and 0.26x;
* collective wire bytes a rank at most the reference's ``analyze_hlo``
  collective bytes (``COLLECTIVE_RATIO`` = 1.0): the port counts
  0.41-0.57x, each collective by its call site in ``PERF.md`` §6
  (``scripts/torch_dryrun_breakdown.py``);
* DeepSeek-V2-236B ``train_4k`` on the 2 x 16 x 16 mesh, where its one
  dispatch group spans the ranks holding distinct rows (16 rows cut over
  ``pod``, held alike over ``data``), held to the same two bounds: the
  ranks holding alike rows share the 8 microbatch slices
  (``ParallelStep._share``), so each layer is gathered once a slice they
  run, not once a slice of the batch;
* the sequence-parallel residual stream (``REPRO_SEQ_PARALLEL=1``) on
  Qwen3-4B ``train_4k`` at full scale (at smoke scale its peak is the
  averaged gradients', which the flag does not touch): it lowers the
  temporary bytes and raises the ``model`` axis' collective bytes, as the
  reference's own note says (``src/repro/models/transformer.py:438-444``).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch.distributed as dist

from repro_torch.launch import dryrun

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
REF_TIMEOUT_S = 180
TEMP_RATIO, COLLECTIVE_RATIO = 1.25, 1.0
CELLS = [("smollm-135m", "train_4k", "16x16"), ("qwen3-4b", "train_4k", "16x16"),
         ("qwen3-4b", "prefill_32k", "16x16"),
         ("deepseek-v2-236b", "train_4k", "2x16x16")]
SMOKE = 16
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def ref():
    """The reference's cells, lowered in one subprocess."""
    cells = [{"arch": a, "shape": s, "mesh": m, "smoke": SMOKE}
             for a, s, m in CELLS]
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_dryrun_ref.py"),
         json.dumps(cells)], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": SRC}, timeout=REF_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    recs = json.loads(out.stdout.strip().splitlines()[-1])
    return {(r["arch"], r["shape"], r["mesh"]): r for r in recs}


def _port(arch, shape, monkeypatch=None, seq_parallel=False, smoke=SMOKE,
          mesh="16x16"):
    if monkeypatch is not None:
        monkeypatch.setenv("REPRO_SEQ_PARALLEL", "1" if seq_parallel else "0")
    with dryrun.fake_mesh(*MESHES[mesh]) as mesh:
        counter, out, _ = dryrun.lower_cell(arch, shape, mesh,
                                            smoke_scale=smoke)
        rec = {"temp": counter.memory(out)["temp_size_in_bytes"],
               "collective": counter.cost.collective_bytes,
               "by_axis": counter.by_axis}
    assert not dist.is_initialized()
    return rec


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_temp_and_collective_bytes_within_the_reference(ref, arch, shape,
                                                         mesh):
    r = ref[(arch, shape, mesh)]
    got = _port(arch, shape, mesh=mesh)
    assert got["temp"] <= TEMP_RATIO * r["temp_size_in_bytes"], (
        got["temp"], r["temp_size_in_bytes"])
    assert got["collective"] <= COLLECTIVE_RATIO * r["collective_bytes"], (
        got["collective"], r["collective_bytes"])


def test_sequence_parallel_trades_temp_for_model_collectives(monkeypatch):
    off = _port("qwen3-4b", "train_4k", monkeypatch, False, smoke=None)
    on = _port("qwen3-4b", "train_4k", monkeypatch, True, smoke=None)
    assert on["temp"] < off["temp"], (on["temp"], off["temp"])
    assert (on["by_axis"]["model"]["wire_bytes"]
            > off["by_axis"]["model"]["wire_bytes"])
