"""Book chapter 08: machine translation, the attention seq2seq trainer.

Parity: python/paddle/fluid/tests/book/test_machine_translation.py and
benchmark/fluid/machine_translation.py (attention seq2seq), and the JAX
package's models/machine_translation.py, unchanged in content for the
training graph: an LSTM encoder (dynamic_lstm with its default
peepholes, so the torch loop and no fused-LSTM kernel) and a
teacher-forced decoder in a DynamicRNN, whose step block runs dot-product
attention over the encoder states with a length-masked sequence_softmax
(the masked-softmax kernel, K8, once per decoder step).

The beam-search decoder (`decoder_decode`, `build_decode`) needs While,
tensor arrays and beam_search, which the port does not have yet.
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
