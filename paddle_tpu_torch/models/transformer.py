"""Transformer (Attention is All You Need) scoring graph, built from the
port's layers.

Parity: the JAX package's models/transformer.py, fused-attention branch:
the same helpers, layer calls and parameter names, so both packages build
the same Program for the same configuration. This slice ports the scoring
graph only — `transformer()` returns the [B, T, trg_vocab] logits of
teacher-forced decoding. The training loss and the decode builders are
not ported yet.
"""
import numpy as np

import paddle_tpu_torch as fluid

POS_ENC_PARAM_NAMES = ("src_pos_enc_table", "trg_pos_enc_table")
SCORING_FEED_NAMES = ["src_word", "src_pos", "trg_word", "trg_pos",
                      "src_len", "trg_len"]


def position_encoding_init(n_position, d_model):
    """Sinusoid table [n_position, d_model]."""
    pos = np.arange(n_position)[:, None].astype("float64")
    dim = np.arange(d_model)[None, :].astype("float64")
    angle = pos / np.power(10000, 2 * (dim // 2) / d_model)
    table = np.zeros((n_position, d_model))
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table.astype("float32")


def multi_head_attention(queries, keys, values, d_key, d_value, d_model,
                         n_head=1, causal=False, kv_len=None):
    """q/k/v fc -> [B, T, H, d] -> fused (flash) attention -> combine fc.
    Padding is expressed as kv_len, decoder causality as causal=True."""
    keys = queries if keys is None else keys
    values = keys if values is None else values
    q = fluid.layers.fc(input=queries, size=d_key * n_head,
                        bias_attr=False, num_flatten_dims=2)
    k = fluid.layers.fc(input=keys, size=d_key * n_head,
                        bias_attr=False, num_flatten_dims=2)
    v = fluid.layers.fc(input=values, size=d_value * n_head,
                        bias_attr=False, num_flatten_dims=2)
    qf = fluid.layers.reshape(q, shape=[0, -1, n_head, d_key])
    kf = fluid.layers.reshape(k, shape=[0, -1, n_head, d_key])
    vf = fluid.layers.reshape(v, shape=[0, -1, n_head, d_value])
    ctx = fluid.layers.fused_attention(qf, kf, vf, causal=causal,
                                       kv_len=kv_len)
    ctx = fluid.layers.reshape(ctx, shape=[0, -1, n_head * d_value])
    return fluid.layers.fc(input=ctx, size=d_model, bias_attr=False,
                           num_flatten_dims=2)


def positionwise_feed_forward(x, d_inner_hid, d_model):
    hidden = fluid.layers.fc(input=x, size=d_inner_hid, num_flatten_dims=2,
                             act="relu")
    return fluid.layers.fc(input=hidden, size=d_model, num_flatten_dims=2)


def pre_post_process_layer(prev_out, out, process_cmd):
    """'a': residual add, 'n': layer_norm ('d', dropout, is a no-op at
    inference and is accepted for parity)."""
    for cmd in process_cmd:
        if cmd == "a":
            out = out + prev_out if prev_out is not None else out
        elif cmd == "n":
            out = fluid.layers.layer_norm(
                out, begin_norm_axis=len(out.shape) - 1,
                param_attr=fluid.initializer.Constant(1.0),
                bias_attr=fluid.initializer.Constant(0.0))
    return out


def prepare_encoder(src_word, src_pos, src_vocab_size, src_emb_dim,
                    src_max_len, pos_enc_param_name=None):
    """word emb * sqrt(d) + frozen sinusoid position emb."""
    word_emb = fluid.layers.embedding(
        src_word, size=[src_vocab_size, src_emb_dim],
        param_attr=fluid.ParamAttr(
            initializer=fluid.initializer.Normal(0., src_emb_dim ** -0.5)))
    word_emb = fluid.layers.scale(x=word_emb, scale=src_emb_dim ** 0.5)
    pos_enc = fluid.layers.embedding(
        src_pos, size=[src_max_len, src_emb_dim],
        param_attr=fluid.ParamAttr(
            name=pos_enc_param_name, trainable=False,
            initializer=fluid.initializer.NumpyArrayInitializer(
                position_encoding_init(src_max_len, src_emb_dim))))
    return word_emb + pos_enc


def encoder_layer(enc_input, n_head, d_key, d_value, d_model, d_inner_hid,
                  kv_len=None):
    attn_output = multi_head_attention(
        pre_post_process_layer(None, enc_input, "n"), None, None, d_key,
        d_value, d_model, n_head, kv_len=kv_len)
    attn_output = pre_post_process_layer(enc_input, attn_output, "da")
    ffd_output = positionwise_feed_forward(
        pre_post_process_layer(None, attn_output, "n"), d_inner_hid, d_model)
    return pre_post_process_layer(attn_output, ffd_output, "da")


def decoder_layer(dec_input, enc_output, n_head, d_key, d_value, d_model,
                  d_inner_hid, src_len=None, trg_len=None):
    slf_attn_output = multi_head_attention(
        pre_post_process_layer(None, dec_input, "n"), None, None, d_key,
        d_value, d_model, n_head, causal=True, kv_len=trg_len)
    slf_attn_output = pre_post_process_layer(dec_input, slf_attn_output, "da")
    enc_attn_output = multi_head_attention(
        pre_post_process_layer(None, slf_attn_output, "n"), enc_output,
        enc_output, d_key, d_value, d_model, n_head, kv_len=src_len)
    enc_attn_output = pre_post_process_layer(slf_attn_output,
                                             enc_attn_output, "da")
    ffd_output = positionwise_feed_forward(
        pre_post_process_layer(None, enc_attn_output, "n"), d_inner_hid,
        d_model)
    return pre_post_process_layer(enc_attn_output, ffd_output, "da")


def encoder(enc_input, n_layer, n_head, d_key, d_value, d_model,
            d_inner_hid, kv_len=None):
    for _ in range(n_layer):
        enc_input = encoder_layer(enc_input, n_head, d_key, d_value, d_model,
                                  d_inner_hid, kv_len=kv_len)
    return pre_post_process_layer(None, enc_input, "n")


def decoder(dec_input, enc_output, n_layer, n_head, d_key, d_value, d_model,
            d_inner_hid, src_len=None, trg_len=None):
    for _ in range(n_layer):
        dec_input = decoder_layer(dec_input, enc_output, n_head, d_key,
                                  d_value, d_model, d_inner_hid,
                                  src_len=src_len, trg_len=trg_len)
    return pre_post_process_layer(None, dec_input, "n")


def make_inputs(max_length):
    """Declare the scoring feeds: [B, T] int64 token ids and positions,
    [B, 1] int32 source and target lengths (the flash kernel's kv_len)."""
    src_word = fluid.layers.data("src_word", [max_length], dtype="int64")
    src_pos = fluid.layers.data("src_pos", [max_length], dtype="int64")
    trg_word = fluid.layers.data("trg_word", [max_length], dtype="int64")
    trg_pos = fluid.layers.data("trg_pos", [max_length], dtype="int64")
    src_len = fluid.layers.data("src_len", [1], dtype="int32")
    trg_len = fluid.layers.data("trg_len", [1], dtype="int32")
    return src_word, src_pos, trg_word, trg_pos, src_len, trg_len


def transformer(src_vocab_size, trg_vocab_size, max_length, n_layer=2,
                n_head=4, d_key=16, d_value=16, d_model=64, d_inner_hid=128):
    """Build the scoring graph (every attention core through the fused
    flash op); returns the logits Variable [-1, max_length,
    trg_vocab_size]. Feeds: SCORING_FEED_NAMES (see prepare_batch)."""
    (src_word, src_pos, trg_word, trg_pos, src_len,
     trg_len) = make_inputs(max_length)
    enc_input = prepare_encoder(
        src_word, src_pos, src_vocab_size, d_model, max_length,
        pos_enc_param_name=POS_ENC_PARAM_NAMES[0])
    enc_output = encoder(enc_input, n_layer, n_head, d_key, d_value, d_model,
                         d_inner_hid, kv_len=src_len)
    dec_input = prepare_encoder(
        trg_word, trg_pos, trg_vocab_size, d_model, max_length,
        pos_enc_param_name=POS_ENC_PARAM_NAMES[1])
    dec_output = decoder(dec_input, enc_output, n_layer, n_head, d_key,
                         d_value, d_model, d_inner_hid, src_len=src_len,
                         trg_len=trg_len)
    return fluid.layers.fc(input=dec_output, size=trg_vocab_size,
                           bias_attr=False, num_flatten_dims=2)


def prepare_batch(src_seqs, trg_seqs, max_length, pad_id=0):
    """Pack python token lists into the dense scoring feeds (teacher
    forcing: the decoder input is <s>=1 followed by trg[:-1])."""
    b = len(src_seqs)
    src = np.full((b, max_length), pad_id, "int64")
    src_pos = np.zeros((b, max_length), "int64")
    trg = np.full((b, max_length), pad_id, "int64")
    trg_pos = np.zeros((b, max_length), "int64")
    src_len = np.zeros((b, 1), "int32")
    trg_len = np.zeros((b, 1), "int32")
    for i, (s, t) in enumerate(zip(src_seqs, trg_seqs)):
        s = list(s)[:max_length]
        t_in = ([1] + list(t[:-1]))[:max_length]
        src[i, :len(s)] = s
        src_pos[i, :len(s)] = np.arange(len(s))
        trg[i, :len(t_in)] = t_in
        trg_pos[i, :len(t_in)] = np.arange(len(t_in))
        src_len[i, 0] = len(s)
        trg_len[i, 0] = len(t_in)
    return {"src_word": src, "src_pos": src_pos, "trg_word": trg,
            "trg_pos": trg_pos, "src_len": src_len, "trg_len": trg_len}
