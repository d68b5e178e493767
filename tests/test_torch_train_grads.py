"""The loss and grads of the other half of the archs' ``smoke()`` configs
(``tests/test_torch_train.py`` has the first), the port against the JAX
package on the CPU, at fp32 compute and at the configs' bf16, within the
tolerances ``tests/_torch_train_common.py`` states.
"""
import pytest
import torch

from _torch_train_common import ARCHS, DTYPES, check_loss_and_grads

torch.set_num_threads(2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS[1::2])
def test_loss_and_grads_equal(arch, dtype):
    check_loss_and_grads(arch, dtype)
