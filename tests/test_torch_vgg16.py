"""VGG-16 (image_classification.vgg16: five img_conv_group blocks of conv
+ batch_norm + relu, fc 4096 + batch_norm + dropout 0.5, fc 4096, fc) in
the port against the JAX package on the CPU, at 3 x 32 x 32, batch 8:
one fp32 training step with dropout at p = 0 in both built programs
(test_torch_image_nets' check_step; the inference program is in
tests/test_torch_image_net_inference.py, one JAX compile a file).

The fp32 gradients are ill-conditioned here, as ResNet-50's are
(tests/test_torch_resnet50.py): the fc's batch_norm normalizes 8 values
per channel and the last block's 1 x 1 maps 8, and a ReLU whose input
lies within rounding of 0 branches by rounding. Every conv and the first
fc carry a bias in front of a batch_norm, whose gradient is 0 in exact
arithmetic and rounding noise in either package. Measured
(||port - jax|| / ||jax||): on this test's state and batch the median
gradient 7.4e-3, the largest 9.3e-3 but for the biases, whose noise
reaches 7.1e-3 of the largest gradient's norm, the loss 2.4e-6; on three
other states and batches the median 3.5e-5 to 2.3e-3, the loss up to
8.1e-6. Bounds: each gradient 5e-2, or its error within
1e-4 of the largest gradient's norm; the median 2.5e-2 (ResNet-50's fp32
bounds); the loss rtol 1e-5.
"""
import pytest
import torch

from test_torch_image_nets import check_step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_vgg16_step_matches_the_jax_one():
    # 13 conv and 13 batch_norm weights and biases; fc, batch_norm, fc, fc
    check_step("vgg16", 32, 8, 2 * 13 + 2 * 13 + 2 * 4, 5e-2,
               2.5e-2, floor=1e-4)
