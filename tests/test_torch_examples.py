"""The port's six examples (``src/repro_torch/examples``) on the CPU.

Each runs through its ``main(argv)`` with ``--device cpu`` at a small
size, and its own check holds (each raises where it fails).
``quickstart`` and ``coded_lm_layer`` draw the reference examples' numpy
inputs, so their outputs are held against the reference example run
here (``runpy`` of ``examples/*.py``) within 1e-5 of max|reference|: the
same fp32 products summed in another order.
"""
import math
import os
import runpy

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS
from repro_torch.examples import (coded_cnn_inference, coded_lm_layer,
                                  coded_serving, quickstart, serve_decode,
                                  train_smollm)

REF_EXAMPLES = os.path.join(os.path.dirname(__file__), os.pardir, "examples")
TOL_REF = 1e-5
CPU = ["--device", "cpu"]


def _close_to_reference(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float64)
    got = got.double().numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max() / np.abs(want).max())
    assert err <= TOL_REF
    return err


@pytest.mark.parametrize("name,module", [("quickstart", quickstart),
                                         ("coded_lm_layer", coded_lm_layer)])
def test_example_matches_reference_example(name, module):
    out = module.main(CPU)
    assert out["max_abs_err"] < module.TOL
    ref = runpy.run_path(os.path.join(REF_EXAMPLES, f"{name}.py"))
    _close_to_reference(out["output"], ref["y"])
    assert (out["n"], out["delta"], out["gamma"]) == (
        ref["plan"].n, ref["plan"].delta, ref["plan"].gamma)


def test_coded_cnn_inference_against_uncoded_stack():
    out = coded_cnn_inference.main(CPU + ["--batch", "2"])
    assert out["rel_err"] <= coded_cnn_inference.TOL
    assert tuple(out["output"].shape) == (2, 256, 3, 3)
    assert len(out["layers"]) == 5
    for layer in out["layers"]:
        # the dead worker (3) and the two stragglers (1, 7) are never used
        assert not {1, 3, 7} & set(layer["used_workers"]), layer


def test_coded_serving_against_uncoded_stack():
    out = coded_serving.main(CPU + ["--requests", "6"])
    assert out["completed"] == 6
    assert out["rel_err"] <= coded_serving.TOL
    assert tuple(out["output"].shape) == (6, 16, 12, 12)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_decode_every_arch(arch):
    out = serve_decode.main(["--arch", arch, "--batch", "2", "--prompt-len",
                             "4", "--gen", "3"] + CPU)
    assert tuple(out["tokens"].shape) == (2, 3)
    assert out["request0"] == out["tokens"][0].tolist()


def test_train_smollm_loss_falls():
    out = train_smollm.main(["--steps", "20", "--batch", "4", "--seq", "32"]
                            + CPU)
    assert len(out["losses"]) == 20
    assert all(math.isfinite(v) for v in out["losses"])
    assert out["last_loss"] < out["first_loss"]


@pytest.mark.parametrize("module", [quickstart, coded_lm_layer,
                                    coded_cnn_inference, coded_serving,
                                    serve_decode, train_smollm])
def test_example_defaults_to_the_card(module, monkeypatch):
    """Without ``--device`` an example asks for the card, and refuses to
    run where there is none rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        module.main([])
