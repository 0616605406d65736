"""The port's analysis gate (``repro_torch.analysis``) on the CPU.

- Concurrency: the port's lint gives the reference's findings (rule,
  severity, location, message) on the reference's seeded fixtures and on
  the port's own scope, which lints clean under ``--strict``.  Only
  ``repro.analysis.concurrency`` and ``findings`` are imported from the
  reference: its ``contracts`` does not import under this tree's jax.
- Contracts: every rule fires on a hand-built cell that breaks it (the
  reference's ``tests/test_analysis.py`` does the same on jitted
  programs), and stays quiet where the cell keeps it; the bounded-program
  proof holds on a real LeNet-5 pipeline and a seeded positive breaks it;
  one real configuration runs clean.  ``CAPTURE`` needs a card:
  ``tests/test_torch_cuda.py`` holds it.
- The CLI: exit codes and JSON, and the whole gate under ``--strict
  --device cpu`` in a subprocess.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from repro.analysis import concurrency as ref_concurrency
from repro.analysis.findings import Report as RefReport
from repro_torch.analysis import concurrency, contracts, dispatch_tools
from repro_torch.analysis.findings import Report, Severity
from repro_torch.core.pipeline import ArgSpec

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "analysis")
VIOLATIONS = os.path.join(FIXTURES, "conc_violations.py")
CLEAN = os.path.join(FIXTURES, "conc_clean.py")
CPU = torch.device("cpu")


# -- concurrency: parity with the reference ---------------------------------
def _findings(report):
    return sorted((f.rule, f.severity, f.location, f.message)
                  for f in report.findings)


@pytest.mark.parametrize("fixture", [VIOLATIONS, CLEAN],
                         ids=["violations", "clean"])
def test_concurrency_parity_on_fixtures(fixture):
    got = concurrency.run(paths=[fixture])
    want = ref_concurrency.run(paths=[fixture])
    assert _findings(got) == _findings(want)
    assert got.stats == want.stats
    if fixture == VIOLATIONS:  # every rule of the lint fires there
        assert {f.rule for f in got.findings} == {
            "CONC-GUARD", "CONC-GUARD-UNKNOWN", "CONC-SELF-DEADLOCK",
            "CONC-ORDER", "CONC-WAIT-LOOP", "CONC-THREAD-LIFECYCLE"}
    else:
        assert got.findings == []


def test_concurrency_parity_on_the_port_scope():
    got = concurrency.run()
    want = ref_concurrency.run(paths=concurrency.DEFAULT_SCOPE, root=str(ROOT))
    assert _findings(got) == _findings(want)
    assert got.stats == want.stats


def test_port_scope_lints_clean_in_strict_mode():
    """The serving/runtime stack passes the lint strictly — the device
    pool's timer thread is joined by ``shutdown`` (no suppression)."""
    report = concurrency.run()
    assert not report.failed(strict=True), report.render_text(show_info=True)
    assert report.stats["guarded_fields_checked"] >= 30
    assert report.stats["locks_discovered"] >= 10
    assert report.stats["concurrency_files"] >= 10
    text = (ROOT / "src/repro_torch/runtime/devicepool.py").read_text()
    assert "analysis: allow(" not in text


def test_lint_runs_from_any_working_directory(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert concurrency.run().stats["concurrency_files"] >= 10


def test_report_json_and_text_match_the_reference():
    got, want = Report(), RefReport()
    for r in (got, want):
        r.add("CONC-GUARD", Severity.ERROR, "a.py:3", "m")
        r.add("OUT-DTYPE", Severity.WARNING, "cell", "w")
        r.add("X", Severity.INFO, "cell", "i")
        r.stats["k"] = 1
    assert got.to_json() == want.to_json()
    assert got.render_text() == want.render_text()
    assert got.render_text(show_info=True) == want.render_text(show_info=True)


# -- contract rules: seeded positives on hand-built cells --------------------
def _cell(fn, args, *, allowed=()):
    return types.SimpleNamespace(
        fn=fn, args=tuple(args), cell_id="synthetic",
        allowed_const_shapes=tuple(allowed), donate_argnums=(), eager_only="")


def _f32(*shape, host=False):
    return ArgSpec(shape, torch.float32, host=host)


def _run(cell, device=CPU):
    gen = torch.Generator().manual_seed(0)
    args = dispatch_tools.materialize(None, cell, device, gen)
    return contracts.check_cell(cell, args, device)


def _rules(found, rule, severity):
    return [f for f in found if f.rule == rule and f.severity == severity]


def test_baked_const_positive():
    baked = torch.ones(8, 8)
    found = _run(_cell(lambda x: x @ baked, [_f32(4, 8)]))
    assert _rules(found, "BAKED-CONST", Severity.ERROR)


def test_baked_const_from_a_host_matrix_positive():
    import numpy as np

    code = np.ones((4, 8))  # converted per call, as an encode once was
    found = _run(_cell(lambda x: x @ torch.as_tensor(code, dtype=x.dtype),
                       [_f32(2, 4)]))
    assert _rules(found, "BAKED-CONST", Severity.ERROR)


def test_baked_const_allowed_shape_and_small_consts_pass():
    baked = torch.ones(8, 8)
    assert not _run(_cell(lambda x: x @ baked, [_f32(4, 8)], allowed=[(8, 8)]))
    eps = torch.full((), 1e-6)
    assert not _run(_cell(lambda x: x + eps, [_f32(4, 8)]))
    # tensors made inside the call are no constants
    assert not _run(_cell(lambda x: x @ torch.ones(8, 8), [_f32(4, 8)]))


def test_f64_positive():
    found = _run(_cell(lambda x: x.double().sum().float(), [_f32(4)]))
    assert _rules(found, "F64", Severity.ERROR)
    found = _run(_cell(lambda x: x.float(),
                       [ArgSpec((4,), torch.float64)]))
    assert _rules(found, "F64", Severity.ERROR)


def test_f64_on_the_host_beside_a_card_cell_passes():
    """A float64 host argument of a cell on another device is the host's
    business (the recovery inverse is taken in float64 on the host)."""
    cell = _cell(lambda x, d: x, [_f32(4), ArgSpec((4, 4), torch.float64,
                                                   host=True)])
    args = (torch.randn(4, device="meta"), torch.zeros(4, 4, dtype=torch.float64))
    rec = dispatch_tools.record(cell.fn, args, torch.device("meta"))
    assert not _rules(contracts.check_recording(cell, rec, "meta"), "F64",
                      Severity.ERROR)


def test_out_dtype_positive():
    found = _run(_cell(lambda x: x.half(), [_f32(2)]))
    assert _rules(found, "OUT-DTYPE", Severity.WARNING)
    assert not _run(_cell(lambda x: (x, x.argmax().to(torch.int32)), [_f32(2)]))


@pytest.mark.parametrize("sync", ["item", "nonzero", "mask", "bool", "copy_off"])
def test_host_sync_positive(sync):
    fns = {
        "item": lambda x: x * x.sum().item(),
        "nonzero": lambda x: x[torch.nonzero(x > 0)[:, 0]],
        "mask": lambda x: x[x > 0],
        "bool": lambda x: x * 2 if bool((x > 0).any()) else x,
        "copy_off": lambda x: x.to("meta"),
    }
    found = _run(_cell(fns[sync], [_f32(8)]))
    assert _rules(found, "HOST-SYNC", Severity.ERROR), found


def test_clean_program_has_no_findings():
    def fn(x, d):
        rows = x.reshape(4, -1)
        return torch.relu(d @ rows).reshape(x.shape)

    assert not _run(_cell(fn, [_f32(4, 3, 5), _f32(4, 4)]))


def test_recorder_records_ops_and_outputs():
    rec = dispatch_tools.record(lambda a, b: (a @ b).relu(),
                                (torch.randn(2, 3), torch.randn(3, 4)), CPU)
    assert "aten.mm.default" in rec.op_names()
    assert rec.consts == [] and rec.syncs == []
    assert [tuple(t.shape) for t in rec.outputs] == [(2, 4)]
    assert all(op.out_dtypes == (torch.float32,) for op in rec.ops)


# -- trace bound + a real config ---------------------------------------------
@pytest.fixture(scope="module")
def lenet():
    cfg = contracts.ContractConfig("lenet5", "kernel", fused=True)
    pipe = contracts.build_pipeline(cfg, CPU)
    return cfg, pipe, list(pipe.program_space())


def test_trace_bound_holds_on_real_pipeline(lenet):
    _, pipe, cells = lenet
    report = contracts.check_trace_bound(pipe, cells, "lenet5")
    assert not report.findings, report.render_text()
    assert report.stats["lenet5/direct/traces"] > 0
    assert report.stats["lenet5/cluster/traces"] > 0
    assert report.stats["lenet5/bound"] == pipe.program_trace_bound


def test_trace_bound_positive(lenet):
    _, pipe, cells = lenet
    workers = [c for c in cells if c.kind == "worker"]
    extra = [dataclasses.replace(workers[0], cache_key=("impostor", i))
             for i in range(pipe.program_trace_bound + 1)]
    report = contracts.check_trace_bound(pipe, cells + extra, "seeded")
    assert _rules(report.findings, "TRACE-BOUND", Severity.ERROR)


def test_repo_contracts_clean_one_config(lenet):
    cfg, pipe, cells = lenet
    report = contracts.analyze(pipe, cfg.label, CPU)
    assert not report.findings, report.render_text()
    assert report.stats["lenet5/kernel/fused/programs_checked"] > 0
    assert "lenet5/kernel/fused/captured" not in report.stats  # CPU: no capture


def test_materialize_gives_each_role_its_values():
    """On the served plan (n=8, (2, 4)) the second survivor subset has
    another decode inverse, so a replay on it proves the inverse is an
    argument.  (On the gate's n=4, (2, 2) every one-worker subset decodes
    with the same inverse.)"""
    cfg = contracts.ContractConfig("lenet5", "kernel", True, n=8, kab=(2, 4))
    pipe = contracts.build_pipeline(cfg, CPU)
    cells = list(pipe.program_space())
    cell = next(c for c in cells if c.kind == "transition" and c.mode == "direct")
    gen = torch.Generator().manual_seed(0)
    outs, d, m_next = dispatch_tools.materialize(pipe, cell, CPU, gen)
    _, d2, m2 = dispatch_tools.materialize(pipe, cell, CPU, gen, variant=1)
    ids = pipe.layer_worker_ids(cell.layer)
    assert torch.equal(d, pipe.decode_operand(cell.layer, ids))
    other = dispatch_tools.survivors(pipe, cell.layer, 1)
    assert other != ids and torch.equal(d2, pipe.decode_operand(cell.layer, other))
    assert not torch.equal(d, d2) and m_next.shape == m2.shape


def test_decoder_cells_declared_eager_only():
    cfg = contracts.DecoderContractConfig("coded", "kernel")
    pipe = contracts.build_decoder_pipeline(cfg, CPU)
    cells = list(pipe.program_space())
    eager = {c.kind for c in cells if c.eager_only}
    assert eager == {"decoder"}
    assert all("K3" in c.eager_only for c in cells if c.eager_only)
    glue = {c.cache_key[0] for c in cells if c.kind == "glue"}
    assert glue == {"embed", "norm", "add", "act", "finish", "attn"}


# -- CLI ------------------------------------------------------------------------
def test_cli_json_and_exit_code(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main

    out = tmp_path / "findings.json"
    code = main(["--only", "concurrency", "--strict", "--format", "json",
                 "--json-out", str(out)])
    assert code == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["counts"]["error"] == 0
    assert json.loads(out.read_text())["counts"] == payload["counts"]


def test_cli_contracts_on_the_cpu(capsys):
    from repro_torch.analysis.__main__ import main

    code = main(["--only", "contracts", "--strict", "--arch", "lenet5",
                 "--backend", "kernel", "--device", "cpu", "--format", "json"])
    payload = json.loads(capsys.readouterr().out)
    assert code == 0 and payload["counts"]["error"] == 0
    assert payload["stats"]["contract_device"] == "cpu"
    for label in ("lenet5/kernel/fused", "lenet5/kernel/unfused",
                  "lm-decoder/kernel/coded", "lm-decoder/kernel/uncoded"):
        assert payload["stats"][f"{label}/programs_checked"] > 0


def test_cli_strict_fails_on_findings(monkeypatch, capsys):
    from repro_torch.analysis import __main__ as cli

    monkeypatch.setattr(concurrency, "DEFAULT_SCOPE", (VIOLATIONS,),
                        raising=True)
    code = cli.main(["--only", "concurrency", "--strict"])
    capsys.readouterr()
    assert code == 1


def test_cli_without_a_card_needs_device_cpu(capsys):
    from repro_torch.analysis.__main__ import main

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--only", "contracts", "--arch", "lenet5"])


def test_strict_gate_on_the_cpu_exits_zero():
    """The whole gate, as a user runs it here: every configuration of the
    matrix named in the stats, no finding, exit 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--strict",
         "--device", "cpu", "--format", "json"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    payload = json.loads(out.stdout)
    assert payload["findings"] == []
    stats = payload["stats"]
    assert stats["contract_configs"] == 16
    labels = [c.label for c in contracts.iter_configs()] + [
        c.label for c in contracts.iter_decoder_configs()]
    for label in labels:
        assert stats[f"{label}/programs_checked"] > 0, label
    assert stats["concurrency_files"] >= 10
