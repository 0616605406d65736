"""``chip_smoke.py``'s training and arch-zoo phases rehearsed captured
on the CPU: the cases of ``tests/_torch_compiled_cases.py``, which says
what each holds."""
import _torch_compiled_cases as cases


def test_chip_smoke_training_phase_rehearses_captured_on_the_cpu(capsys):
    cases.chip_smoke_training_phase_rehearses_captured_on_the_cpu(capsys)


def test_chip_smoke_zoo_phase_rehearses_captured_on_the_cpu(capsys):
    cases.chip_smoke_zoo_phase_rehearses_captured_on_the_cpu(capsys)
