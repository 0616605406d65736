"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package ``repro``, and
the package imports where JAX cannot be imported at all."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_ast_scan_catches_a_forbidden_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    from repro.core import crme\n    import jax.numpy\n")
    assert _imported_roots(probe) == {"repro", "jax"}


def test_package_imports_without_jax():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch, repro_torch.core, repro_torch.models.cnn\n"
        "import repro_torch.runtime, repro_torch.serving\n"
        "import repro_torch.launch.serve, repro_torch.kernels.native\n"
        "import repro_torch.kernels.conv2d, repro_torch.kernels.matmul\n"
        "import repro_torch.kernels.coded_gemm, repro_torch.kernels.flash_attn\n"
        "import repro_torch.models.common, repro_torch.models.transformer\n"
        "import repro_torch.configs.smollm_135m\n"
        "import repro_torch.core.decoder_pipeline, repro_torch.serving.lm_engine\n"
        "import repro_torch.serving.frontend, repro_torch.core.coded_linear\n"
        "import repro_torch.core.baselines, repro_torch.analysis.contracts\n"
        "import repro_torch.analysis.concurrency, repro_torch.analysis.__main__\n"
        "import repro_torch.optim, repro_torch.data, repro_torch.checkpoint\n"
        "import repro_torch.launch.train, repro_torch.launch.steps\n"
        "import repro_torch.models.registry, repro_torch.configs, repro_torch.tree\n"
        "import repro_torch.models.linear_scan, repro_torch.models.rwkv6\n"
        "import repro_torch.models.hymba, repro_torch.models.whisper\n"
        "import repro_torch.configs.rwkv6_1p6b, repro_torch.configs.hymba_1p5b\n"
        "import repro_torch.configs.whisper_medium\n"
        "assert 'jax' not in {m.split('.')[0] for m, v in sys.modules.items() if v}\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_a_card():
    """Without CUDA the proof script exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    env = dict(os.environ)
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], env=env,
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
