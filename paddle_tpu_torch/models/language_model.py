"""PTB RNN language model (rnnlm).

Parity: the era's RNN-LM benchmark (reference `benchmark/paddle/rnn/rnn_v2.py`
stacked-LSTM LM; SURVEY §2 model list "rnnlm / language_model (ptb)") fed by
`paddle.v2.dataset.imikolov` with ``DataType.SEQ`` shifted (src, trg) pairs
(reference `python/paddle/v2/dataset/imikolov.py:92`).

Each dynamic_lstm keeps its peepholes, so it runs the torch loop of
ops/cuda_kernels.fused_lstm_plain (the JAX package's masked lax.scan; its
fused LSTM kernel takes no peepholes either). The tied softmax is one
[B,T,E] x [E,V] matmul against the transposed embedding table: the table
is read by the lookup AND the output projection, and the backward sums
both gradients into its one @GRAD. The 3-D logits take the plain
log-softmax path of softmax_with_cross_entropy (the JAX package's fused
cross-entropy kernel takes 2-D logits). Loss is the length-masked mean
token NLL; perplexity = exp(nll) is computed in-graph so the fetch is a
single scalar.
"""
import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers
from paddle_tpu_torch import ParamAttr
from .common import masked_mean_cost

__all__ = ["build"]


def build(vocab_size=2075, emb_size=64, hidden_size=64, num_layers=2,
          learning_rate=0.003, tie_weights=True, dropout_prob=0.0,
          is_test=False):
    """Stacked-LSTM LM over shifted sequences.

    Feeds: ``words`` / ``nextwords`` — both int64 lod_level=1 sequences
    (imikolov SEQ pairs). Returns (words, nextwords, avg_cost, ppl) where
    avg_cost is mean per-token NLL and ppl its exponent.
    """
    words = layers.data(name="words", shape=[1], dtype="int64", lod_level=1)
    nextwords = layers.data(name="nextwords", shape=[1], dtype="int64",
                            lod_level=1)

    emb = layers.embedding(
        input=words, size=[vocab_size, emb_size], dtype="float32",
        param_attr=ParamAttr(name="lm_embedding"))          # [B,T,E]

    x = emb
    for i in range(num_layers):
        proj = layers.fc(input=x, size=hidden_size * 4,
                         param_attr=ParamAttr(name="lm_lstm_w_%d" % i),
                         bias_attr=ParamAttr(name="lm_lstm_b_%d" % i))
        hidden, _cell = layers.dynamic_lstm(input=proj, size=hidden_size * 4)
        if dropout_prob and not is_test:
            hidden = layers.dropout(hidden, dropout_prob=dropout_prob)
        x = hidden                                          # [B,T,H]

    if tie_weights:
        # project back to embedding width, then logits against the table
        out = layers.fc(input=x, size=emb_size, num_flatten_dims=2,
                        param_attr=ParamAttr(name="lm_proj_w"),
                        bias_attr=ParamAttr(name="lm_proj_b"))  # [B,T,E]
        emb_table = words.block.program.global_block().var("lm_embedding")
        logits = layers.matmul(out, emb_table, transpose_y=True)  # [B,T,V]
        out_bias = layers.create_parameter(
            shape=[vocab_size], dtype="float32", name="lm_out_bias",
            default_initializer=fluid.initializer.Constant(0.0))
        logits = layers.elementwise_add(x=logits, y=out_bias)
    else:
        logits = layers.fc(input=x, size=vocab_size, num_flatten_dims=2,
                           param_attr=ParamAttr(name="lm_softmax_w"),
                           bias_attr=ParamAttr(name="lm_softmax_b"))

    cost = layers.softmax_with_cross_entropy(
        logits=logits, label=nextwords)                     # [B,T,1]
    avg_cost = masked_mean_cost(cost, nextwords, logits)
    ppl = layers.exp(avg_cost)

    if not is_test:
        fluid.optimizer.Adam(learning_rate=learning_rate).minimize(avg_cost)
    return words, nextwords, avg_cost, ppl
