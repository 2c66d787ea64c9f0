"""Book chapter 08: machine translation, the attention seq2seq trainer
and its beam-search decoder.

Parity: python/paddle/fluid/tests/book/test_machine_translation.py and
benchmark/fluid/machine_translation.py (attention seq2seq), and the JAX
package's models/machine_translation.py, unchanged in content: an LSTM
encoder (dynamic_lstm with its default peepholes, so the torch loop and
no fused-LSTM kernel); a teacher-forced decoder in a DynamicRNN, whose
step block runs dot-product attention over the encoder states with a
length-masked sequence_softmax (the masked-softmax kernel, K8, once per
decoder step); and the decode path, a While loop over dense [batch, beam]
state with beam_search and beam_search_decode (ops/control_ops.py), its
weights shared with training by their ParamAttr names.
"""
import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers
from paddle_tpu_torch import ParamAttr
from .common import masked_mean_cost


def encoder(dict_size, word_dim=16, hidden_dim=32, is_sparse=False):
    """Returns (enc_seq [B,Ts,H] sequence var, enc_last [B,H])."""
    src_word_id = layers.data(
        name="src_word_id", shape=[1], dtype="int64", lod_level=1)
    src_embedding = layers.embedding(
        input=src_word_id, size=[dict_size, word_dim], dtype="float32",
        is_sparse=is_sparse, param_attr=ParamAttr(name="vemb"))
    fc1 = layers.fc(input=src_embedding, size=hidden_dim * 4, act="tanh")
    lstm_hidden0, lstm_0 = layers.dynamic_lstm(
        input=fc1, size=hidden_dim * 4)
    encoder_out = layers.sequence_last_step(input=lstm_hidden0)
    return lstm_hidden0, encoder_out


def _attention(enc_seq, dec_state):
    """Dot-product attention: enc_seq [B,Ts,H] x dec_state [B,H] -> ctx [B,H].

    Scores are masked past each row's true source length by
    sequence_softmax: `scores` inherits enc_seq's lengths companion (the
    SOURCE lengths), while the DynamicRNN around this step masks by the
    target lengths."""
    scores = layers.matmul(enc_seq,
                           layers.unsqueeze(x=dec_state, axes=[2]))  # [B,Ts,1]
    scores = layers.squeeze(x=scores, axes=[2])                      # [B,Ts]
    att = layers.sequence_softmax(scores)
    ctx = layers.matmul(layers.unsqueeze(x=att, axes=[1]), enc_seq)  # [B,1,H]
    return layers.squeeze(x=ctx, axes=[1])


def decoder_train(context, enc_seq, dict_size, word_dim=16, decoder_size=32,
                  is_sparse=False, use_attention=False):
    """Teacher-forced decoder. `context` = encoder last state [B,H]."""
    trg_language_word = layers.data(
        name="target_language_word", shape=[1], dtype="int64", lod_level=1)
    trg_embedding = layers.embedding(
        input=trg_language_word, size=[dict_size, word_dim], dtype="float32",
        is_sparse=is_sparse, param_attr=ParamAttr(name="vemb"))

    rnn = layers.DynamicRNN()
    with rnn.block():
        current_word = rnn.step_input(trg_embedding)
        pre_state = rnn.memory(init=context)
        if use_attention:
            ctx = _attention(enc_seq, pre_state)
            fc_in = [current_word, pre_state, ctx]
        else:
            fc_in = [current_word, pre_state]
        current_state = layers.fc(
            input=fc_in, size=decoder_size, act="tanh",
            param_attr=[ParamAttr(name="dec_state_w_%d" % i)
                        for i in range(len(fc_in))],
            bias_attr=ParamAttr(name="dec_state_b"))
        current_score = layers.fc(
            input=current_state, size=dict_size, act="softmax",
            param_attr=ParamAttr(name="dec_score_w"),
            bias_attr=ParamAttr(name="dec_score_b"))
        rnn.update_memory(pre_state, current_state)
        rnn.output(current_score)

    return rnn()


def build_train(dict_size=100, word_dim=16, hidden_dim=32, decoder_size=32,
                learning_rate=0.01, is_sparse=False, use_attention=False,
                optimizer="adagrad"):
    """Full training graph. Returns (avg_cost, prediction)."""
    enc_seq, context = encoder(dict_size, word_dim, hidden_dim, is_sparse)
    rnn_out = decoder_train(context, enc_seq, dict_size, word_dim,
                            decoder_size, is_sparse, use_attention)
    label = layers.data(name="target_language_next_word", shape=[1],
                        dtype="int64", lod_level=1)
    cost = layers.cross_entropy(input=rnn_out, label=label)  # [B,T,1]
    # masked mean over true target tokens (the reference's flat-LoD mean)
    avg_cost = masked_mean_cost(cost, label, rnn_out)
    opt = (fluid.optimizer.Adam if optimizer == "adam"
           else fluid.optimizer.Adagrad)(learning_rate=learning_rate)
    opt.minimize(avg_cost)
    return avg_cost, rnn_out


def decoder_decode(context, enc_seq, dict_size, word_dim=16, decoder_size=32,
                   beam_size=2, max_length=8, start_id=1, end_id=2,
                   is_sparse=False, use_attention=False):
    """While-loop beam-search decode on the dense [batch, beam] layout.

    Parity: test_machine_translation.py decoder_decode. The weights are
    decoder_train's, by their ParamAttr names. Feed init_ids [B, K]
    (start_id) and init_scores [B, K] ([0, -1e9, ...] per row: see
    layers.beam_search)."""
    init_ids = layers.data(name="init_ids", shape=[beam_size],
                           dtype="int64")
    init_scores = layers.data(name="init_scores", shape=[beam_size],
                              dtype="float32")

    counter = layers.zeros(shape=[1], dtype="int32")
    counter.stop_gradient = True
    array_len = layers.fill_constant(shape=[1], dtype="int32",
                                     value=max_length)

    # per-beam decoder state [B, K, H]
    init_state = layers.expand(
        layers.unsqueeze(x=context, axes=[1]), [1, beam_size, 1])
    state_array = layers.create_array("float32", capacity=max_length + 1)
    layers.array_write(init_state, counter, state_array)
    ids_array = layers.create_array("int64", capacity=max_length + 1)
    scores_array = layers.create_array("float32", capacity=max_length + 1)
    parent_array = layers.create_array("int32", capacity=max_length + 1)
    layers.array_write(init_ids, counter, ids_array)
    layers.array_write(init_scores, counter, scores_array)
    init_parent = layers.fill_constant_batch_size_like(
        input=init_ids, shape=[-1, beam_size], dtype="int32", value=0)
    layers.array_write(init_parent, counter, parent_array)

    cond = layers.less_than(x=counter, y=array_len)
    while_op = layers.While(cond=cond)
    with while_op.block():
        pre_ids = layers.array_read(ids_array, counter)       # [B,K] int64
        pre_state = layers.array_read(state_array, counter)   # [B,K,H]
        pre_score = layers.array_read(scores_array, counter)  # [B,K]

        pre_ids_emb = layers.embedding(
            input=pre_ids, size=[dict_size, word_dim], dtype="float32",
            is_sparse=is_sparse, param_attr=ParamAttr(name="vemb"))  # [B,K,E]

        if use_attention:
            # scores over the source: [B,K,H] x [B,H,Ts] -> [B,K,Ts], masked
            att_scores = layers.matmul(
                pre_state, layers.transpose(enc_seq, perm=[0, 2, 1]))
            enc_len = enc_seq.block.var_recursive(enc_seq.seq_len_var)
            src_mask = layers.sequence_mask(
                enc_len, maxlen=enc_seq, dtype="float32")     # [B,Ts]
            neg = layers.scale(x=src_mask, scale=1e9, bias=-1e9)
            att_scores = layers.elementwise_add(
                x=att_scores, y=layers.unsqueeze(x=neg, axes=[1]))
            att = layers.softmax(att_scores)                  # [B,K,Ts]
            ctx = layers.matmul(att, enc_seq)                 # [B,K,H]
            fc_in = [pre_ids_emb, pre_state, ctx]
        else:
            fc_in = [pre_ids_emb, pre_state]

        current_state = layers.fc(
            input=fc_in, size=decoder_size, act="tanh", num_flatten_dims=2,
            param_attr=[ParamAttr(name="dec_state_w_%d" % i)
                        for i in range(len(fc_in))],
            bias_attr=ParamAttr(name="dec_state_b"))          # [B,K,H]
        current_logp = layers.fc(
            input=current_state, size=dict_size, num_flatten_dims=2,
            param_attr=ParamAttr(name="dec_score_w"),
            bias_attr=ParamAttr(name="dec_score_b"))          # [B,K,V]
        current_logp = layers.log(layers.softmax(current_logp))

        selected_ids, selected_scores, parent = layers.beam_search(
            pre_ids=pre_ids, pre_scores=pre_score, ids=None,
            scores=current_logp, beam_size=beam_size, end_id=end_id,
            return_parent_idx=True)

        # each beam's state follows its selected parent:
        # state[b, k] = current_state[b, parent[b, k]]
        onehot = layers.one_hot(parent, beam_size)            # [B,K,Ksrc]
        new_state = layers.matmul(onehot, current_state)      # [B,K,H]

        layers.increment(counter, 1, in_place=True)
        layers.array_write(new_state, counter, state_array)
        layers.array_write(selected_ids, counter, ids_array)
        layers.array_write(selected_scores, counter, scores_array)
        layers.array_write(parent, counter, parent_array)
        layers.less_than(x=counter, y=array_len, cond=cond)

    translation_ids, translation_scores = layers.beam_search_decode(
        ids_array, scores_array, parent_idx=parent_array, end_id=end_id)
    return translation_ids, translation_scores


def build_decode(dict_size=100, word_dim=16, hidden_dim=32, decoder_size=32,
                 beam_size=2, max_length=8, start_id=1, end_id=2,
                 is_sparse=False, use_attention=False):
    """The encoder and the beam-search decoder. Returns (translation_ids
    [B, K, max_length + 1], translation_scores [B, K])."""
    enc_seq, context = encoder(dict_size, word_dim, hidden_dim, is_sparse)
    return decoder_decode(context, enc_seq, dict_size, word_dim, decoder_size,
                          beam_size, max_length, start_id, end_id, is_sparse,
                          use_attention)
