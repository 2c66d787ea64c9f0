"""CTR (click-through-rate) model: wide & deep over sparse id features.

Parity: the reference's CTR workload (paddle/v2 CTR demo; fluid-era dist
CTR benchmark) and the JAX package's models/ctr.py: per-slot sparse
embeddings + dense features, a deep MLP tower plus a wide (logistic) part,
log-loss. `is_sparse=True` is recorded in the lookup ops as the JAX
package records it; the port's lookup_table is a dense gather either way,
and its gradient a dense index_add. `embedding_param_names()` names the
big tables (the JAX package shards them over its mesh; the port runs on
one card).
"""
import paddle_tpu_torch as fluid

DENSE_DIM = 13
NUM_SLOTS = 26


def build(sparse_feature_dim=100000, embedding_size=16, dense_dim=DENSE_DIM,
          num_slots=NUM_SLOTS, hidden_sizes=(400, 400, 400),
          learning_rate=1e-3, is_sparse=True, with_optimizer=True):
    """Returns (feeds, avg_cost, predict). Feeds: dense, C0..Cn-1, label."""
    dense = fluid.layers.data(name="dense_input", shape=[dense_dim],
                              dtype="float32")
    sparse_ins = [fluid.layers.data(name="C%d" % i, shape=[1], dtype="int64")
                  for i in range(num_slots)]
    label = fluid.layers.data(name="label", shape=[1], dtype="float32")

    # deep tower: per-slot embeddings + dense features
    embs = [fluid.layers.embedding(
        input=s, size=[sparse_feature_dim, embedding_size],
        is_sparse=is_sparse,
        param_attr=fluid.ParamAttr(name="emb_slot_%d" % i))
        for i, s in enumerate(sparse_ins)]
    deep = fluid.layers.concat(input=embs + [dense], axis=1)
    for i, h in enumerate(hidden_sizes):
        deep = fluid.layers.fc(input=deep, size=h, act="relu")
    deep_logit = fluid.layers.fc(input=deep, size=1)

    # wide part: one scalar weight per sparse id (embedding_size=1) + dense lr
    wide_embs = [fluid.layers.embedding(
        input=s, size=[sparse_feature_dim, 1], is_sparse=is_sparse,
        param_attr=fluid.ParamAttr(name="wide_slot_%d" % i))
        for i, s in enumerate(sparse_ins)]
    wide_logit = fluid.layers.sums(
        [fluid.layers.fc(input=dense, size=1)] + wide_embs)

    logit = fluid.layers.elementwise_add(deep_logit, wide_logit)
    predict = fluid.layers.sigmoid(logit)
    cost = fluid.layers.sigmoid_cross_entropy_with_logits(x=logit,
                                                          label=label)
    avg_cost = fluid.layers.mean(x=cost)
    if with_optimizer:
        fluid.optimizer.Adam(learning_rate=learning_rate).minimize(avg_cost)
    feeds = [dense] + sparse_ins + [label]
    return feeds, avg_cost, predict


def embedding_param_names(num_slots=NUM_SLOTS):
    """The big tables to shard over the mesh (pserver-equivalent placement)."""
    return ["emb_slot_%d" % i for i in range(num_slots)] + \
           ["wide_slot_%d" % i for i in range(num_slots)]
