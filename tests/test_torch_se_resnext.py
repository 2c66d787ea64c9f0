"""SE-ResNeXt-50 (image_classification.se_resnext: 16 bottlenecks of
grouped 3 x 3 convs with cardinality 32, each with a squeeze-excitation
fc pair, batch_norm after every conv, dropout 0.5 before the classifier)
in the port against the JAX package on the CPU, at 3 x 32 x 32, batch 8:
one fp32 training step with dropout at p = 0 in both built programs
(test_torch_image_nets' check_step; the inference program is in
tests/test_torch_image_net_inference.py, one JAX compile a file).

The fp32 gradients are ill-conditioned here, as ResNet-50's are
(tests/test_torch_resnet50.py: its 53 batch_norms normalize a few values
per channel in the last stages, ReLUs branch by rounding), and more so
in the JAX package itself. Measured (||port - jax|| / ||jax||): on
this test's state and batch the median gradient 1.4e-3, the largest
3.2e-2, the loss 8.8e-6; on three other states and batches the median
9.3e-3 to 1.2e-2, the largest 1.7e-2 to 2.1e-2. Bounds: each gradient
5e-2, the median 2.5e-2 (ResNet-50's fp32 bounds), the loss rtol 1e-5.
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


def test_se_resnext50_step_matches_the_jax_one():
    # 53 conv weights, 53 batch_norm scale and shift, 16 x 2 SE fc weight
    # and bias, the classifier's weight and bias
    check_step("se_resnext50", 32, 8, 53 + 2 * 53 + 16 * 4 + 2, 5e-2,
               2.5e-2)
