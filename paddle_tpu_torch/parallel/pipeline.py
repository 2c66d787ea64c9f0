"""Pipeline parallelism (the `pp` mesh axis): the GPipe looped schedule.

Parity: the JAX package's parallel/pipeline.py. There the stage
parameters are stacked on a leading [S, ...] dim sharded P('pp'), one
`lax.scan` of M + S - 1 ticks runs the schedule (stage s computes
microbatch t - s at tick t) and `lax.ppermute` moves activations one
stage on a tick; bubble slots compute values that are masked out.

Here the replicas of the 'pp' axis share one device (a mesh lists a
device once a replica), so the schedule runs its ticks in order on that
device and hands each stage's output to the next stage directly. It
skips the bubble slots instead of computing and masking them: their
results are never read, so a step makes S * M stage calls, no more. The
backward is autograd's through the same calls (the JAX package's is the
transpose of scan and ppermute). Replicas of 'pp' on distinct cards raise
NotImplementedError.
"""
import torch

from .mesh import P

__all__ = ["pipeline_apply", "pipeline_stages_spec", "stack_stage_params",
           "sequential_reference", "mlp_block_init", "mlp_block_apply",
           "mlp_block_specs", "pipeline_schedule"]


def _tree_map(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *[x[k] for x in trees]) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


# ---------------------------------------------------------------------------
# The homogeneous stage block: a Megatron column/row two-product MLP, dense
# (tp_size=1) or as tp_size partial products over hidden-dim shards summed
# (the all-reduce of the row-parallel product, on one device).
# ---------------------------------------------------------------------------

def mlp_block_init(rng, d, d_hidden, scale=0.1, device="cpu"):
    """Params of one tanh MLP block [d -> d_hidden -> d] (shape-preserving,
    so it can serve as a pipeline stage). `rng` seeds a torch generator;
    the draws are the port's own, not the JAX package's."""
    g = torch.Generator().manual_seed(int(rng))
    return {
        "w1": (torch.randn(d, d_hidden, generator=g) * scale).to(device),
        "b1": torch.zeros(d_hidden, device=device),
        "w2": (torch.randn(d_hidden, d, generator=g) * scale).to(device),
        "b2": torch.zeros(d, device=device),
    }


def mlp_block_specs(tp_axis="mp", pp_axis=None):
    """PartitionSpecs of (optionally stage-stacked) mlp_block params: w1/b1
    column-parallel over `tp_axis`, w2 row-parallel, b2 replicated; a
    leading stage dim over `pp_axis` when given."""
    def pp(*rest):
        return P(pp_axis, *rest) if pp_axis else P(*rest)
    return {"w1": pp(None, tp_axis), "b1": pp(tp_axis),
            "w2": pp(tp_axis, None), "b2": pp(None)}


def mlp_block_apply(params, x, tp_size=1):
    """y = tanh(x w1 + b1) w2 + b2. With tp_size > 1 the hidden dim runs
    in tp_size shards, each a column-parallel then a row-parallel product,
    and their partial outputs are summed (the Megatron all-reduce)."""
    if tp_size == 1:
        return torch.tanh(x @ params["w1"] + params["b1"]) @ params["w2"] \
            + params["b2"]
    w1 = params["w1"].chunk(tp_size, dim=1)
    b1 = params["b1"].chunk(tp_size)
    w2 = params["w2"].chunk(tp_size, dim=0)
    z = None
    for a, b, c in zip(w1, b1, w2):
        part = torch.tanh(x @ a + b) @ c
        z = part if z is None else z + part
    return z + params["b2"]


def sequential_reference(stage_fn, stacked_params, x):
    """The S stages applied in order on one device."""
    S = _leaves(stacked_params)[0].shape[0]
    out = x
    for s in range(S):
        out = stage_fn(_tree_map(lambda a: a[s], stacked_params), out)
    return out


def stack_stage_params(per_stage_params):
    """[params of stage 0, of stage 1, ...] -> one tree of [S, ...]."""
    return _tree_map(lambda *leaves: torch.stack(leaves), *per_stage_params)


def pipeline_stages_spec(stacked_params, axis="pp"):
    """PartitionSpecs putting stage s's slice of every stacked param on
    pipeline rank s."""
    return _tree_map(lambda _: P(axis), stacked_params)


def pipeline_schedule(num_stages, num_microbatches):
    """The (tick, stage, microbatch) slots that compute, in the order they
    run: stage s takes microbatch t - s at tick t, for t in [0, M + S - 1);
    the bubble slots (t - s outside [0, M)) are left out."""
    S, M = int(num_stages), int(num_microbatches)
    return [(t, s, t - s) for t in range(M + S - 1) for s in range(S)
            if 0 <= t - s < M]


def run_schedule(stage_call, num_stages, xs):
    """The looped schedule over microbatches `xs` (a list): stage_call(s,
    x_mb) -> y_mb. Returns the last stage's outputs in microbatch order."""
    acts = list(xs)
    for _, s, m in pipeline_schedule(num_stages, len(xs)):
        acts[m] = stage_call(s, acts[m])
    return acts


def _microbatches(x, M):
    B = x.shape[0]
    if B % M:
        raise ValueError("batch %d not divisible into %d microbatches"
                         % (B, M))
    return list(x.split(B // M))


def pipeline_apply(stage_fn, stacked_params, x, mesh, num_microbatches=None,
                   axis="pp", batch_axis=None, param_specs=None):
    """Run x through S pipeline stages over mesh axis `axis`.

    stage_fn(params, x_mb) -> y_mb must be shape-preserving.
    stacked_params: a tree with leading dim S == mesh.shape[axis]. x: the
    [B, ...] batch, B divisible by num_microbatches (default S).
    batch_axis ('dp'): each microbatch's rows split further over that
    axis, one part a replica. param_specs is accepted for the JAX
    signature (the dp x mp x pp hook): on a device the replicas share,
    every placement is that device, and a stage_fn splitting its own
    products (mlp_block_apply(tp_size=...)) carries the tensor parallelism.
    Differentiable through autograd."""
    S = int(mesh.shape[axis])
    leading = _leaves(stacked_params)[0].shape[0]
    if leading != S:
        raise ValueError("stacked_params leading dim %d != pipeline size %d"
                         % (leading, S))
    if len(mesh.distinct_devices()) > 1:
        raise NotImplementedError(
            "pipeline_apply over distinct cards (%s) is not distributed "
            "yet (ROADMAP §A item 5): put every replica of the mesh on "
            "one device" % [str(d) for d in mesh.distinct_devices()])
    M = int(num_microbatches) if num_microbatches else S
    dp = int(mesh.shape.get(batch_axis, 1)) if batch_axis else 1
    per_stage = [_tree_map(lambda a: a[s], stacked_params)
                 for s in range(S)]

    def call(s, xb):
        if dp == 1:
            return stage_fn(per_stage[s], xb)
        if xb.shape[0] % dp:
            raise ValueError("microbatch of %d rows does not split over "
                             "the %d-way %r axis" % (xb.shape[0], dp,
                                                     batch_axis))
        return torch.cat([stage_fn(per_stage[s], part)
                          for part in xb.chunk(dp)])

    return torch.cat(run_schedule(call, S, _microbatches(x, M)))
