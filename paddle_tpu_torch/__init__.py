"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The public surface mirrors the JAX package's (and `paddle.fluid`'s):

    import paddle_tpu_torch as fluid
    x = fluid.layers.data(name="x", shape=[13], dtype="float32")
    y = fluid.layers.fc(input=x, size=1)
    loss = fluid.layers.reduce_sum(y)
    fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    exe = fluid.Executor()            # the CUDA card (fluid.CUDAPlace(0));
                                      # Executor(fluid.CPUPlace()) for CPU
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
from .core.framework import (Block, get_var,  # noqa: F401
                             switch_main_program, switch_startup_program)
from .core.executor import (Executor, Scope, fetch_var,  # noqa: F401
                            global_scope, scope_guard, switch_scope)
from .core.lod import LoDTensor, create_lod_tensor  # noqa: F401
from .core.param_attr import ParamAttr, WeightNormParamAttr  # noqa: F401
from .places import (CPUPlace, CUDAPlace, TPUPlace,  # noqa: F401
                     is_compiled_with_cuda, is_compiled_with_tpu)
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
from .io import (save_params, load_params,  # noqa: F401
                 save_persistables, load_persistables, save_inference_model,
                 load_inference_model)
from . import metrics  # noqa: F401
from . import evaluator  # noqa: F401
from . import average  # noqa: F401
from .average import WeightedAverage  # noqa: F401
from .data_feeder import DataFeeder  # noqa: F401
from . import default_scope_funcs  # noqa: F401
from . import concurrency  # noqa: F401
from .concurrency import (make_channel, channel_send,  # noqa: F401
                          channel_recv, channel_close, Select)
from . import reader  # noqa: F401
from .core.readers import EOFException  # noqa: F401
from . import datasets  # noqa: F401
from . import recordio  # noqa: F401
from . import recordio_writer  # noqa: F401
from .reader import batch  # noqa: F401
from . import checkpoint  # noqa: F401
from .checkpoint import CheckpointManager  # noqa: F401
from . import memory_optimization_transpiler  # noqa: F401
from .memory_optimization_transpiler import (memory_optimize,  # noqa: F401
                                             release_memory)
from . import parallel  # noqa: F401
from .parallel import ParallelExecutor  # noqa: F401
from . import transpiler  # noqa: F401
from .transpiler import DistributeTranspiler  # noqa: F401
from . import resilience  # noqa: F401
from .resilience import (Supervisor, TrainingAborted,  # noqa: F401
                         install_numeric_guards, NumericalGuardError,
                         DispatchTimeoutError)

Tensor = LoDTensor
