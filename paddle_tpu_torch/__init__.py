"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The public surface mirrors the JAX package's (and `paddle.fluid`'s):

    import paddle_tpu_torch as fluid
    x = fluid.layers.data(name="x", shape=[13], dtype="float32")
    y = fluid.layers.fc(input=x, size=1)
    loss = fluid.layers.reduce_sum(y)
    fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    exe = fluid.Executor()            # the CUDA card; Executor("cpu") for CPU
    exe.run(fluid.default_startup_program())
    exe.run(feed={"x": xs}, fetch_list=[loss])

Programs are the same IR and serialize to the same JSON bytes as the JAX
package's, so either package loads the other's saved models. Execution is
eager, op by op, over torch tensors; the kernels the JAX package wrote in
Pallas for the TPU are hand-written CUDA C++ here (ops/cuda_kernels.py,
csrc/). This package imports torch and numpy, never jax or paddle_tpu.
"""
from .core import framework  # noqa: F401
from .core.framework import (Program, Operator, Variable, Parameter,  # noqa: F401
                             default_main_program, default_startup_program,
                             program_guard)
from .core.executor import Executor, Scope, global_scope  # noqa: F401
from .core.lod import LoDTensor, create_lod_tensor  # noqa: F401
from .core.param_attr import ParamAttr  # noqa: F401
from .core import initializer  # noqa: F401
from .core import unique_name  # noqa: F401

from .core.backward import append_backward, calc_gradient  # noqa: F401

from . import ops as _ops  # noqa: F401  (registers the op rules)
from . import layers  # noqa: F401
from . import nets  # noqa: F401
from . import optimizer  # noqa: F401
from . import regularizer  # noqa: F401
from . import clip  # noqa: F401
from .clip import (ErrorClipByValue, GradientClipByValue,  # noqa: F401
                   GradientClipByNorm, GradientClipByGlobalNorm)
from . import backward  # noqa: F401
from . import io  # noqa: F401
