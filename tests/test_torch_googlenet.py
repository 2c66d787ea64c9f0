"""GoogLeNet (image_classification.googlenet: the main tower, nine
inception modules of concat-ed conv branches, dropout 0.4) in the port
against the JAX package on the CPU, at 3 x 64 x 64, batch 8: one fp32
training step with dropout at p = 0 in both built programs, and the
inference program (test_torch_image_nets' check_step and
check_inference). No batch_norm: each gradient within 1e-5 (fp32 sums in
another order; measured 8.2e-7), the class probabilities within 1e-5.
"""
import pytest
import torch

from test_torch_image_nets import check_inference, check_step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_googlenet_step_matches_the_jax_one():
    check_step("googlenet", 64, 8, 2 * 57 + 2, 1e-5, 1e-5)


def test_googlenet_inference_matches_the_jax_one():
    check_inference("googlenet", 64, 8)
