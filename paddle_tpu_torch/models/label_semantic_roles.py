"""Book chapter 07: label_semantic_roles (CoNLL-05 SRL).

Parity: python/paddle/fluid/tests/book/test_label_semantic_roles.py —
the db-lstm topology (8 feature embeddings, depth-8 stack of alternating
forward/reverse LSTMs with direct edges) into a linear-chain CRF cost,
Viterbi decode for inference. The same module as the JAX package's
models/label_semantic_roles.py, on the port's layers: both build the same
Program. The book's LSTMs (relu candidate, sigmoid cell) run the torch
loop of the lstm rule, as they run the JAX package's lax.scan: neither
package has a kernel for those activations.
"""
import paddle_tpu_torch as fluid

FEATURE_NAMES = ["word_data", "ctx_n2_data", "ctx_n1_data", "ctx_0_data",
                 "ctx_p1_data", "ctx_p2_data", "verb_data", "mark_data"]


def db_lstm(word, predicate, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, mark,
            word_dict_len, label_dict_len, pred_dict_len, word_dim=32,
            mark_dim=5, mark_dict_len=2, hidden_dim=512, depth=8,
            is_sparse=True, embedding_name="emb"):
    predicate_embedding = fluid.layers.embedding(
        input=predicate, size=[pred_dict_len, word_dim], dtype="float32",
        is_sparse=is_sparse, param_attr="vemb")
    mark_embedding = fluid.layers.embedding(
        input=mark, size=[mark_dict_len, mark_dim], dtype="float32",
        is_sparse=is_sparse)

    word_input = [word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2]
    emb_layers = [
        fluid.layers.embedding(
            size=[word_dict_len, word_dim], input=x,
            param_attr=fluid.ParamAttr(name=embedding_name, trainable=False))
        for x in word_input
    ]
    emb_layers.append(predicate_embedding)
    emb_layers.append(mark_embedding)

    hidden_0_layers = [
        fluid.layers.fc(input=emb, size=hidden_dim) for emb in emb_layers
    ]
    hidden_0 = fluid.layers.sums(input=hidden_0_layers)

    lstm_0, _ = fluid.layers.dynamic_lstm(
        input=hidden_0, size=hidden_dim, candidate_activation="relu",
        gate_activation="sigmoid", cell_activation="sigmoid")

    # stack L-LSTM and R-LSTM with direct edges
    input_tmp = [hidden_0, lstm_0]
    for i in range(1, depth):
        mix_hidden = fluid.layers.sums(input=[
            fluid.layers.fc(input=input_tmp[0], size=hidden_dim),
            fluid.layers.fc(input=input_tmp[1], size=hidden_dim)
        ])
        lstm, _ = fluid.layers.dynamic_lstm(
            input=mix_hidden, size=hidden_dim, candidate_activation="relu",
            gate_activation="sigmoid", cell_activation="sigmoid",
            is_reverse=((i % 2) == 1))
        input_tmp = [mix_hidden, lstm]

    feature_out = fluid.layers.sums(input=[
        fluid.layers.fc(input=input_tmp[0], size=label_dict_len),
        fluid.layers.fc(input=input_tmp[1], size=label_dict_len)
    ])
    return feature_out


def build_train(word_dict_len, label_dict_len, pred_dict_len,
                mix_hidden_lr=1e-3, lr=0.01, **model_kwargs):
    """Declare data layers, db_lstm, CRF cost + decode + chunk counts.

    Returns (feed_names, avg_cost, crf_decode, chunk_counts).
    """
    feats = {}
    for name in FEATURE_NAMES:
        feats[name] = fluid.layers.data(
            name=name, shape=[1], dtype="int64", lod_level=1)
    target = fluid.layers.data(
        name="target", shape=[1], dtype="int64", lod_level=1)

    feature_out = db_lstm(
        word=feats["word_data"], predicate=feats["verb_data"],
        ctx_n2=feats["ctx_n2_data"], ctx_n1=feats["ctx_n1_data"],
        ctx_0=feats["ctx_0_data"], ctx_p1=feats["ctx_p1_data"],
        ctx_p2=feats["ctx_p2_data"], mark=feats["mark_data"],
        word_dict_len=word_dict_len, label_dict_len=label_dict_len,
        pred_dict_len=pred_dict_len, **model_kwargs)

    crf_cost = fluid.layers.linear_chain_crf(
        input=feature_out, label=target,
        param_attr=fluid.ParamAttr(name="crfw", learning_rate=mix_hidden_lr))
    avg_cost = fluid.layers.mean(x=crf_cost)

    sgd_optimizer = fluid.optimizer.SGD(
        learning_rate=fluid.layers.exponential_decay(
            learning_rate=lr, decay_steps=100000, decay_rate=0.5,
            staircase=True))
    sgd_optimizer.minimize(avg_cost)

    crf_decode = fluid.layers.crf_decoding(
        input=feature_out, param_attr=fluid.ParamAttr(name="crfw"))
    import math
    chunk_counts = fluid.layers.chunk_eval(
        input=crf_decode, label=target, chunk_scheme="IOB",
        num_chunk_types=int(math.ceil((label_dict_len - 1) / 2.0)))

    feed_names = FEATURE_NAMES + ["target"]
    return feed_names, avg_cost, crf_decode, chunk_counts
