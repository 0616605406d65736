"""The compiled steps of ``serve_lm`` and ``train`` for the recurrent
and encoder-decoder archs (Hymba, Whisper, RWKV6): the cases of
``tests/_torch_compiled_cases.py``, which says what each holds and with
which tolerance."""
import pytest

import _torch_compiled_cases as cases

ARCHS = ["hymba-1.5b", "whisper-medium", "rwkv6-1.6b"]


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


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b"])
def test_first_captured_step_advances_the_state_once(arch):
    cases.first_captured_step_advances_the_state_once(arch)
