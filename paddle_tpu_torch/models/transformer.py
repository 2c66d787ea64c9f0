"""Transformer (Attention is All You Need) built from the port's layers:
the teacher-forced scoring graph, its training loss (label smoothing,
per-token weights) and `build_train` (Adam with noam warmup).

Parity: the JAX package's models/transformer.py, fused-attention branch:
the same helpers, layer calls and parameter names, so both packages build
the same Program for the same configuration. `transformer()` returns
(sum_cost, avg_cost, predict) as the JAX one does; `predict` is the
[B, T, trg_vocab] logits a scoring model saves (save_inference_model
prunes the loss away). Not ported yet: the dense attn_bias attention path,
dropout, the fused-qkv projection, the unfused label-smoothing path and
the decode builders.
"""
import numpy as np

import paddle_tpu_torch as fluid

POS_ENC_PARAM_NAMES = ("src_pos_enc_table", "trg_pos_enc_table")
SCORING_FEED_NAMES = ["src_word", "src_pos", "trg_word", "trg_pos",
                      "src_len", "trg_len"]
FUSED_FEED_NAMES = SCORING_FEED_NAMES + ["lbl_word", "lbl_weight"]


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
    """Declare the feeds: [B, T] int64 token ids and positions, [B, 1]
    int32 source and target lengths (the flash kernel's kv_len), and the
    [B, T, 1] int64 labels and float32 per-token loss weights."""
    src_word = fluid.layers.data("src_word", [max_length], dtype="int64")
    src_pos = fluid.layers.data("src_pos", [max_length], dtype="int64")
    trg_word = fluid.layers.data("trg_word", [max_length], dtype="int64")
    trg_pos = fluid.layers.data("trg_pos", [max_length], dtype="int64")
    src_len = fluid.layers.data("src_len", [1], dtype="int32")
    trg_len = fluid.layers.data("trg_len", [1], dtype="int32")
    lbl_word = fluid.layers.data("lbl_word", [max_length, 1], dtype="int64")
    lbl_weight = fluid.layers.data("lbl_weight", [max_length, 1])
    return (src_word, src_pos, trg_word, trg_pos, src_len, trg_len,
            lbl_word, lbl_weight)


def transformer(src_vocab_size, trg_vocab_size, max_length, n_layer=2,
                n_head=4, d_key=16, d_value=16, d_model=64, d_inner_hid=128,
                label_smooth_eps=0.0):
    """Build the training graph (every attention core through the fused
    flash op); returns (sum_cost, avg_cost, predict). Feeds:
    FUSED_FEED_NAMES (see prepare_batch); a scoring model needs only
    SCORING_FEED_NAMES.

    label_smooth_eps > 0 takes the JAX package's exact decomposition of
    uniform label smoothing: cost = nll + eps * (logit_label -
    sum(logits) / V), with the hard-label softmax_with_cross_entropy (the
    K4 kernel) for nll. This is the JAX builder with dropout_rate=0,
    use_fused_attention=True and use_fused_label_smooth=True."""
    (src_word, src_pos, trg_word, trg_pos, src_len, trg_len, lbl_word,
     lbl_weight) = make_inputs(max_length)
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
    predict = fluid.layers.fc(input=dec_output, size=trg_vocab_size,
                              bias_attr=False, num_flatten_dims=2)
    predict_2d = fluid.layers.reshape(predict, shape=[-1, trg_vocab_size])
    lbl_flat = fluid.layers.reshape(lbl_word, shape=[-1, 1])
    if label_smooth_eps:
        # -(sum smoothed*logp) = nll + eps*(logit_label - sum(logits)/V)
        nll = fluid.layers.softmax_with_cross_entropy(
            logits=predict_2d, label=lbl_flat)
        logit_lbl = fluid.layers.reduce_sum(
            fluid.layers.one_hot(lbl_flat, depth=trg_vocab_size)
            * predict_2d, dim=1, keep_dim=True)
        cost = nll + label_smooth_eps * (
            logit_lbl - fluid.layers.reduce_sum(
                predict_2d, dim=1, keep_dim=True) / float(trg_vocab_size))
    else:
        cost = fluid.layers.softmax_with_cross_entropy(
            logits=predict_2d, label=lbl_flat)
    weight_flat = fluid.layers.reshape(lbl_weight, shape=[-1, 1])
    weighted_cost = cost * weight_flat
    sum_cost = fluid.layers.reduce_sum(weighted_cost)
    token_num = fluid.layers.reduce_sum(weight_flat)
    token_num.stop_gradient = True
    avg_cost = sum_cost / token_num
    return sum_cost, avg_cost, predict


def build_train(src_vocab_size, trg_vocab_size, max_length, d_model=64,
                warmup_steps=40, learning_rate=1.0, **kwargs):
    """transformer() plus Adam(beta1 0.9, beta2 0.98, epsilon 1e-9) on the
    noam schedule; returns (sum_cost, avg_cost, predict)."""
    sum_cost, avg_cost, predict = transformer(
        src_vocab_size, trg_vocab_size, max_length, d_model=d_model,
        **kwargs)
    lr = fluid.layers.noam_decay(d_model, warmup_steps, learning_rate)
    optimizer = fluid.optimizer.Adam(learning_rate=lr, beta1=0.9,
                                     beta2=0.98, epsilon=1e-9)
    optimizer.minimize(avg_cost)
    return sum_cost, avg_cost, predict


def prepare_batch(src_seqs, trg_seqs, max_length, pad_id=0, labels=False):
    """Pack python token lists into the dense feeds (teacher forcing: the
    decoder input is <s>=1 followed by trg[:-1], the label is trg). The
    scoring feeds (SCORING_FEED_NAMES), plus with labels=True the training
    feeds lbl_word and lbl_weight (weight 1 on real tokens, 0 on pads)."""
    b = len(src_seqs)
    src = np.full((b, max_length), pad_id, "int64")
    src_pos = np.zeros((b, max_length), "int64")
    trg = np.full((b, max_length), pad_id, "int64")
    trg_pos = np.zeros((b, max_length), "int64")
    lbl = np.full((b, max_length, 1), pad_id, "int64")
    lbl_w = np.zeros((b, max_length, 1), "float32")
    src_len = np.zeros((b, 1), "int32")
    trg_len = np.zeros((b, 1), "int32")
    for i, (s, t) in enumerate(zip(src_seqs, trg_seqs)):
        s = list(s)[:max_length]
        t_in = ([1] + list(t[:-1]))[:max_length]
        src[i, :len(s)] = s
        src_pos[i, :len(s)] = np.arange(len(s))
        trg[i, :len(t_in)] = t_in
        trg_pos[i, :len(t_in)] = np.arange(len(t_in))
        tl = min(len(t), max_length)
        lbl[i, :tl, 0] = list(t)[:tl]
        lbl_w[i, :tl, 0] = 1.0
        src_len[i, 0] = len(s)
        trg_len[i, 0] = len(t_in)
    feeds = {"src_word": src, "src_pos": src_pos, "trg_word": trg,
             "trg_pos": trg_pos, "src_len": src_len, "trg_len": trg_len}
    if labels:
        feeds["lbl_word"] = lbl
        feeds["lbl_weight"] = lbl_w
    return feeds
