"""Four train steps of every arch's ``smoke()`` config at the configs'
bf16 compute, the port's ``make_train_step`` (in place) against JAX's
jitted step from the same state on one fixed batch, on the CPU, within the
tolerances ``tests/test_torch_train_steps.py`` states for bf16.
"""
import pytest
import torch

from _torch_train_common import ARCHS, check_four_steps

torch.set_num_threads(2)


@pytest.mark.parametrize("arch", ARCHS)
def test_four_steps_equal(arch):
    check_four_steps(arch, "bfloat16")
