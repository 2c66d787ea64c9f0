"""The inference programs of VGG-16 and SE-ResNeXt-50 (the net alone,
clone(for_test=True): every batch_norm normalizes by its moving
statistics and every dropout scales by 1 - p) in the port against the
JAX package on the CPU, at 3 x 32 x 32, batch 8, from the port's startup
state (test_torch_image_nets' check_inference): the class probabilities
within atol 1e-5 (a well-conditioned forward; measured 3.0e-8 and
1.5e-7), and a second run repeats the first exactly. Two forward-only
JAX compiles, each freed before the next; the training steps are in
tests/test_torch_vgg16.py and tests/test_torch_se_resnext.py.
"""
import pytest
import torch

from test_torch_image_nets import check_inference


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("model", ["vgg16", "se_resnext50"])
def test_inference_matches_the_jax_one(model):
    check_inference(model, 32, 8)
