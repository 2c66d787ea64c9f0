"""Transformer (Attention is All You Need) built from the port's layers:
the teacher-forced scoring graph, its training loss (label smoothing,
per-token weights) and `build_train` (Adam with noam warmup).

Parity: the JAX package's models/transformer.py: the same helpers,
signatures, defaults, layer calls and parameter names, so both packages
build the same Program for the same call. `transformer()` returns
(sum_cost, avg_cost, predict) as the JAX one does; `predict` is the [B,
T, trg_vocab] logits a scoring model saves (save_inference_model prunes
the loss away). The attention core runs the dense path by default: [B,
H, T, T] scores plus the additive attn_bias feeds, softmax, dropout on
the weights, and the weighted sum; use_fused_attention=True runs the
fused flash op instead (padding as src_len / trg_len, the decoder's mask
as causal; no dropout there). Not ported yet: the decode builders
(ROADMAP A6).
"""
import numpy as np

import paddle_tpu_torch as fluid

POS_ENC_PARAM_NAMES = ("src_pos_enc_table", "trg_pos_enc_table")
SCORING_FEED_NAMES = ["src_word", "src_pos", "trg_word", "trg_pos",
                      "src_len", "trg_len"]
FUSED_FEED_NAMES = SCORING_FEED_NAMES + ["lbl_word", "lbl_weight"]
FEED_NAMES = ["src_word", "src_pos", "trg_word", "trg_pos",
              "src_slf_attn_bias", "trg_slf_attn_bias", "trg_src_attn_bias",
              "lbl_word", "lbl_weight"]


def position_encoding_init(n_position, d_model):
    """Sinusoid table [n_position, d_model]."""
    pos = np.arange(n_position)[:, None].astype("float64")
    dim = np.arange(d_model)[None, :].astype("float64")
    angle = pos / np.power(10000, 2 * (dim // 2) / d_model)
    table = np.zeros((n_position, d_model))
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table.astype("float32")


def multi_head_attention(queries, keys, values, attn_bias, d_key, d_value,
                         d_model, n_head=1, dropout_rate=0.0,
                         use_fused=False, causal=False, kv_len=None,
                         fuse_qkv=False):
    """q/k/v fc -> split heads -> attention -> combine fc.

    use_fused: the fused (flash) op over [B, T, H, d], padding as kv_len
    and decoder causality as causal=True (attn_bias must be None, and
    dropout_rate 0: attention-weight dropout cannot run inside the flash
    kernel). Otherwise the dense path over [B, H, T, d]: scaled scores
    plus the additive attn_bias, softmax, dropout on the weights, weighted
    sum.

    fuse_qkv (self-attention only, d_value == d_key): one [D, 3 * d_key *
    H] projection named fused_qkv.w, split into q, k and v (its columns
    are [W_q | W_k | W_v]), its Xavier init with fan_out pinned to one
    projection's so the default init matches the unfused path's scale."""
    if use_fused and dropout_rate:
        raise ValueError(
            "use_fused attention requires dropout_rate=0: attention-weight "
            "dropout can't run inside the flash kernel, and the dense path "
            "expresses masks as attn_bias, not causal/kv_len")
    if use_fused and attn_bias is not None:
        raise ValueError(
            "use_fused attention ignores dense attn_bias tensors — express "
            "the mask as kv_len (key padding) and/or causal=True instead")
    if fuse_qkv and keys is not None:
        raise ValueError("fuse_qkv requires self-attention (keys=None): "
                         "cross-attention projects different inputs")
    if fuse_qkv and d_value != d_key:
        raise ValueError(
            "fuse_qkv requires d_value == d_key: a single Xavier init "
            "cannot match both per-slice scales otherwise")
    keys = queries if keys is None else keys
    values = keys if values is None else values

    if fuse_qkv:
        qkv = fluid.layers.fc(
            input=queries, size=(2 * d_key + d_value) * n_head,
            bias_attr=False, num_flatten_dims=2,
            param_attr=fluid.ParamAttr(
                name=fluid.unique_name.generate("fused_qkv.w"),
                initializer=fluid.initializer.XavierInitializer(
                    fan_out=d_key * n_head)))
        q, k, v = fluid.layers.split(
            qkv, num_or_sections=[d_key * n_head, d_key * n_head,
                                  d_value * n_head], dim=-1)
    else:
        q = fluid.layers.fc(input=queries, size=d_key * n_head,
                            bias_attr=False, num_flatten_dims=2)
        k = fluid.layers.fc(input=keys, size=d_key * n_head,
                            bias_attr=False, num_flatten_dims=2)
        v = fluid.layers.fc(input=values, size=d_value * n_head,
                            bias_attr=False, num_flatten_dims=2)

    if use_fused:
        # [B, T, H*d] -> [B, T, H, d] (BTHD, the fused kernel's layout)
        qf = fluid.layers.reshape(q, shape=[0, -1, n_head, d_key])
        kf = fluid.layers.reshape(k, shape=[0, -1, n_head, d_key])
        vf = fluid.layers.reshape(v, shape=[0, -1, n_head, d_value])
        ctx = fluid.layers.fused_attention(qf, kf, vf, causal=causal,
                                           kv_len=kv_len)
        ctx = fluid.layers.reshape(ctx, shape=[0, -1, n_head * d_value])
        return fluid.layers.fc(input=ctx, size=d_model, bias_attr=False,
                               num_flatten_dims=2)

    def split_heads(x, d):
        # [B, T, H*d] -> [B, H, T, d]
        reshaped = fluid.layers.reshape(x, shape=[0, -1, n_head, d])
        return fluid.layers.transpose(reshaped, perm=[0, 2, 1, 3])

    q = split_heads(q, d_key)
    k = split_heads(k, d_key)
    v = split_heads(v, d_value)
    product = fluid.layers.matmul(x=q, y=k, transpose_y=True)
    product = fluid.layers.scale(x=product, scale=d_key ** -0.5)
    if attn_bias is not None:
        product = product + attn_bias
    weights = fluid.layers.softmax(product)
    if dropout_rate:
        weights = fluid.layers.dropout(weights, dropout_prob=dropout_rate)
    ctx = fluid.layers.matmul(weights, v)              # [B, H, T, dv]
    ctx = fluid.layers.transpose(ctx, perm=[0, 2, 1, 3])
    ctx = fluid.layers.reshape(ctx, shape=[0, -1, n_head * d_value])
    return fluid.layers.fc(input=ctx, size=d_model, bias_attr=False,
                           num_flatten_dims=2)


def positionwise_feed_forward(x, d_inner_hid, d_model):
    hidden = fluid.layers.fc(input=x, size=d_inner_hid, num_flatten_dims=2,
                             act="relu")
    return fluid.layers.fc(input=hidden, size=d_model, num_flatten_dims=2)


def pre_post_process_layer(prev_out, out, process_cmd, dropout_rate=0.0):
    """'a': residual add, 'n': layer_norm, 'd': dropout (at a nonzero
    dropout_rate)."""
    for cmd in process_cmd:
        if cmd == "a":
            out = out + prev_out if prev_out is not None else out
        elif cmd == "n":
            out = fluid.layers.layer_norm(
                out, begin_norm_axis=len(out.shape) - 1,
                param_attr=fluid.initializer.Constant(1.0),
                bias_attr=fluid.initializer.Constant(0.0))
        elif cmd == "d":
            if dropout_rate:
                out = fluid.layers.dropout(out, dropout_prob=dropout_rate)
    return out


def prepare_encoder(src_word, src_pos, src_vocab_size, src_emb_dim,
                    src_max_len, dropout_rate=0.0, pos_enc_param_name=None):
    """word emb * sqrt(d) + frozen sinusoid position emb, then dropout."""
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
    enc_input = word_emb + pos_enc
    if dropout_rate:
        enc_input = fluid.layers.dropout(enc_input,
                                         dropout_prob=dropout_rate)
    return enc_input


def encoder_layer(enc_input, attn_bias, n_head, d_key, d_value, d_model,
                  d_inner_hid, dropout_rate=0.0, use_fused=False,
                  kv_len=None, fuse_qkv=False):
    attn_output = multi_head_attention(
        pre_post_process_layer(None, enc_input, "n"), None, None, attn_bias,
        d_key, d_value, d_model, n_head, dropout_rate,
        use_fused=use_fused, kv_len=kv_len, fuse_qkv=fuse_qkv)
    attn_output = pre_post_process_layer(enc_input, attn_output, "da",
                                         dropout_rate)
    ffd_output = positionwise_feed_forward(
        pre_post_process_layer(None, attn_output, "n"), d_inner_hid, d_model)
    return pre_post_process_layer(attn_output, ffd_output, "da",
                                  dropout_rate)


def decoder_layer(dec_input, enc_output, slf_attn_bias, dec_enc_attn_bias,
                  n_head, d_key, d_value, d_model, d_inner_hid,
                  dropout_rate=0.0, use_fused=False, src_len=None,
                  trg_len=None, fuse_qkv=False):
    slf_attn_output = multi_head_attention(
        pre_post_process_layer(None, dec_input, "n"), None, None,
        slf_attn_bias, d_key, d_value, d_model, n_head, dropout_rate,
        use_fused=use_fused, causal=True, kv_len=trg_len,
        fuse_qkv=fuse_qkv)
    slf_attn_output = pre_post_process_layer(dec_input, slf_attn_output,
                                             "da", dropout_rate)
    enc_attn_output = multi_head_attention(
        pre_post_process_layer(None, slf_attn_output, "n"), enc_output,
        enc_output, dec_enc_attn_bias, d_key, d_value, d_model, n_head,
        dropout_rate, use_fused=use_fused, kv_len=src_len)
    enc_attn_output = pre_post_process_layer(slf_attn_output,
                                             enc_attn_output, "da",
                                             dropout_rate)
    ffd_output = positionwise_feed_forward(
        pre_post_process_layer(None, enc_attn_output, "n"), d_inner_hid,
        d_model)
    return pre_post_process_layer(enc_attn_output, ffd_output, "da",
                                  dropout_rate)


def encoder(enc_input, attn_bias, n_layer, n_head, d_key, d_value, d_model,
            d_inner_hid, dropout_rate=0.0, use_fused=False, kv_len=None,
            fuse_qkv=False):
    for _ in range(n_layer):
        enc_input = encoder_layer(enc_input, attn_bias, n_head, d_key,
                                  d_value, d_model, d_inner_hid,
                                  dropout_rate, use_fused=use_fused,
                                  fuse_qkv=fuse_qkv, kv_len=kv_len)
    return pre_post_process_layer(None, enc_input, "n")


def decoder(dec_input, enc_output, slf_attn_bias, dec_enc_attn_bias,
            n_layer, n_head, d_key, d_value, d_model, d_inner_hid,
            dropout_rate=0.0, use_fused=False, src_len=None, trg_len=None,
            fuse_qkv=False):
    for _ in range(n_layer):
        dec_input = decoder_layer(dec_input, enc_output, slf_attn_bias,
                                  dec_enc_attn_bias, n_head, d_key, d_value,
                                  d_model, d_inner_hid, dropout_rate,
                                  use_fused=use_fused, fuse_qkv=fuse_qkv,
                                  src_len=src_len, trg_len=trg_len)
    return pre_post_process_layer(None, dec_input, "n")


def make_inputs(max_length, n_head=None, fused=False):
    """Declare the feeds: [B, T] int64 token ids and positions; with fused,
    [B, 1] int32 source and target lengths (the flash kernel's kv_len),
    else the three [B, H, T, T] float32 additive attention biases
    (FEED_NAMES); and the [B, T, 1] int64 labels and float32 per-token
    loss weights."""
    src_word = fluid.layers.data("src_word", [max_length], dtype="int64")
    src_pos = fluid.layers.data("src_pos", [max_length], dtype="int64")
    trg_word = fluid.layers.data("trg_word", [max_length], dtype="int64")
    trg_pos = fluid.layers.data("trg_pos", [max_length], dtype="int64")
    if fused:
        masks = (fluid.layers.data("src_len", [1], dtype="int32"),
                 fluid.layers.data("trg_len", [1], dtype="int32"))
    else:
        masks = tuple(fluid.layers.data(n, [n_head, max_length, max_length])
                      for n in FEED_NAMES[4:7])
    lbl_word = fluid.layers.data("lbl_word", [max_length, 1], dtype="int64")
    lbl_weight = fluid.layers.data("lbl_weight", [max_length, 1])
    return (src_word, src_pos, trg_word, trg_pos) + masks + (lbl_word,
                                                             lbl_weight)


def transformer(src_vocab_size, trg_vocab_size, max_length, n_layer=2,
                n_head=4, d_key=16, d_value=16, d_model=64, d_inner_hid=128,
                dropout_rate=0.0, label_smooth_eps=0.0,
                use_fused_attention=False, use_fused_label_smooth=True,
                use_qkv_fusion=False):
    """Build the training graph; returns (sum_cost, avg_cost, predict).
    The JAX package's signature and defaults.

    use_fused_attention: every attention core through the fused flash op,
    feeds FUSED_FEED_NAMES (see prepare_batch; a scoring model needs only
    SCORING_FEED_NAMES); requires dropout_rate == 0. Otherwise (the
    default) the dense path with the attn_bias feeds of FEED_NAMES
    (prepare_batch with n_head), where dropout_rate also drops attention
    weights.

    dropout_rate: dropout after the embeddings, on every sublayer's output
    before its residual add ('d' of pre_post_process_layer) and, dense,
    on the attention weights.

    label_smooth_eps > 0 with use_fused_label_smooth (the default) takes
    the exact decomposition of uniform label smoothing: cost = nll + eps *
    (logit_label - sum(logits) / V), with the hard-label
    softmax_with_cross_entropy (the K4 kernel) for nll. Without it:
    one_hot -> label_smooth -> soft-label softmax_with_cross_entropy (the
    plain log-softmax rule; K4 takes hard labels only).

    use_qkv_fusion: each self-attention's q, k, v from one fused_qkv.w
    projection (multi_head_attention's fuse_qkv)."""
    if use_fused_attention and dropout_rate:
        raise ValueError("use_fused_attention requires dropout_rate=0 "
                         "(attention-weight dropout can't run inside "
                         "the flash kernel)")
    inputs = make_inputs(max_length, n_head, use_fused_attention)
    src_word, src_pos, trg_word, trg_pos = inputs[:4]
    lbl_word, lbl_weight = inputs[-2:]
    if use_fused_attention:
        src_len, trg_len = inputs[4:6]
        src_bias = trg_bias = cross_bias = None
    else:
        src_bias, trg_bias, cross_bias = inputs[4:7]
        src_len = trg_len = None
    enc_input = prepare_encoder(
        src_word, src_pos, src_vocab_size, d_model, max_length,
        dropout_rate, pos_enc_param_name=POS_ENC_PARAM_NAMES[0])
    enc_output = encoder(enc_input, src_bias, n_layer, n_head, d_key,
                         d_value, d_model, d_inner_hid, dropout_rate,
                         use_fused=use_fused_attention, kv_len=src_len,
                         fuse_qkv=use_qkv_fusion)
    dec_input = prepare_encoder(
        trg_word, trg_pos, trg_vocab_size, d_model, max_length,
        dropout_rate, pos_enc_param_name=POS_ENC_PARAM_NAMES[1])
    dec_output = decoder(dec_input, enc_output, trg_bias, cross_bias,
                         n_layer, n_head, d_key, d_value, d_model,
                         d_inner_hid, dropout_rate,
                         use_fused=use_fused_attention, src_len=src_len,
                         trg_len=trg_len, fuse_qkv=use_qkv_fusion)
    predict = fluid.layers.fc(input=dec_output, size=trg_vocab_size,
                              bias_attr=False, num_flatten_dims=2)
    predict_2d = fluid.layers.reshape(predict, shape=[-1, trg_vocab_size])
    lbl_flat = fluid.layers.reshape(lbl_word, shape=[-1, 1])
    if label_smooth_eps and use_fused_label_smooth:
        # -(sum smoothed*logp) = nll + eps*(logit_label - sum(logits)/V)
        nll = fluid.layers.softmax_with_cross_entropy(
            logits=predict_2d, label=lbl_flat)
        logit_lbl = fluid.layers.reduce_sum(
            fluid.layers.one_hot(lbl_flat, depth=trg_vocab_size)
            * predict_2d, dim=1, keep_dim=True)
        cost = nll + label_smooth_eps * (
            logit_lbl - fluid.layers.reduce_sum(
                predict_2d, dim=1, keep_dim=True) / float(trg_vocab_size))
    elif label_smooth_eps:
        smoothed = fluid.layers.label_smooth(
            fluid.layers.one_hot(lbl_flat, depth=trg_vocab_size),
            epsilon=label_smooth_eps)
        cost = fluid.layers.softmax_with_cross_entropy(
            logits=predict_2d, label=smoothed, soft_label=True)
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


def prepare_batch(src_seqs, trg_seqs, max_length, pad_id=0, labels=False,
                  n_head=None):
    """Pack python token lists into the dense feeds (teacher forcing: the
    decoder input is <s>=1 followed by trg[:-1], the label is trg). The
    scoring feeds (SCORING_FEED_NAMES), plus with labels=True the training
    feeds lbl_word and lbl_weight (weight 1 on real tokens, 0 on pads).
    With n_head, the dense program's feeds instead of src_len / trg_len:
    the three [B, n_head, T, T] additive biases of FEED_NAMES, -1e9 on
    the keys past a row's length and, in the decoder's self-attention, on
    the keys after the query."""
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
    if n_head is not None:
        shape = (b, n_head, max_length, max_length)
        src_bias, trg_bias, cross_bias = (np.zeros(shape, "float32")
                                          for _ in range(3))
        causal = np.triu(np.full((max_length, max_length), -1e9, "float32"),
                         1)
        for i in range(b):
            src_bias[i, :, :, src_len[i, 0]:] = -1e9
            trg_bias[i] = causal[None]
            trg_bias[i, :, :, trg_len[i, 0]:] = -1e9
            cross_bias[i, :, :, src_len[i, 0]:] = -1e9
        del feeds["src_len"], feeds["trg_len"]
        feeds.update(zip(FEED_NAMES[4:7], (src_bias, trg_bias, cross_bias)))
    return feeds
