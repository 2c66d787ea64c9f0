"""Training over a device mesh from one controller: meshes of torch
devices (a device repeated for replicas that share it), the ShardingPlan,
the ParallelExecutor, ring and Ulysses attention, the looped pipeline
schedule and the top-1 mixture of experts, and the multi-process glue
(DeviceLayout, init_distributed). Parity: the JAX package's parallel/."""
from .mesh import make_mesh, data_parallel_mesh, replicated, \
    batch_sharded, Mesh, NamedSharding, P
from .parallel_executor import ParallelExecutor
from .plan import ShardingPlan, VarPlan
from .ring_attention import ring_attention, ring_attention_sharded, \
    attention_reference, sequence_parallel_specs
from .distributed import init_distributed, shutdown_distributed, \
    global_mesh, DeviceLayout, active_layout, set_active_layout, \
    is_initialized as distributed_is_initialized
from .ulysses import ulysses_attention, ulysses_attention_sharded
from .pipeline import pipeline_apply, pipeline_stages_spec, \
    stack_stage_params, sequential_reference
from .moe import moe_layer, init_moe_params, moe_param_specs
