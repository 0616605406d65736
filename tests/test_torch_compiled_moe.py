"""The compiled steps of ``serve_lm`` and ``train`` for the MoE and MLA
archs (DeepSeek-V3, DeepSeek-V2): the cases of
``tests/_torch_compiled_cases.py``, which says what each holds and with
which tolerance."""
import pytest

import _torch_compiled_cases as cases

ARCHS = ["deepseek-v3-671b", "deepseek-v2-236b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_captured_decode_equals_eager_and_reference(arch):
    cases.captured_decode_equals_eager_and_reference(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_position_hits_no_host_sync(arch):
    cases.tensor_position_hits_no_host_sync(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_position_past_the_cache_raises_before_any_replay(arch):
    cases.position_past_the_cache_raises_before_any_replay(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_captured_prefill_equals_eager(arch):
    cases.captured_prefill_equals_eager(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_lm_captured_equals_eager_and_reference(arch):
    cases.serve_lm_captured_equals_eager_and_reference(arch)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b"])
def test_captured_train_steps_equal_eager(arch):
    cases.captured_train_steps_equal_eager(arch)
