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
as causal; no dropout there). The decode builders (`build_decode`,
`build_cached_decode`) beam-search with a While loop over dense [batch,
beam] state, built with `transformer`'s parameter-creation sequence so
they run in its training scope.
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
                use_qkv_fusion=False, inputs=None):
    """Build the training graph; returns (sum_cost, avg_cost, predict).
    The JAX package's signature and defaults, plus `inputs`: the feeds as
    make_inputs declares them (in its order), given by the caller instead
    — a reader-fed program passes layers.read_file's outputs.

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
    if inputs is None:
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


def build_decode(src_vocab_size, trg_vocab_size, max_length, n_layer=2,
                 n_head=4, d_key=16, d_value=16, d_model=64,
                 d_inner_hid=128, beam_size=2, max_out_len=None,
                 bos_id=1, eos_id=2, fuse_qkv=False):
    """Autoregressive beam-search decode (the era's transformer infer
    path: re-run the whole decoder on the growing prefix each step — no
    KV cache in the reference either; the dense [batch, beam] state rides
    one While loop like models/machine_translation.decoder_decode).

    Build under a fresh unique_name.guard with the SAME call sequence as
    `transformer`, so every parameter shares its training name and the
    decode program runs in the training scope. Returns
    (sentence_ids [B, K, C], sentence_scores [B, K]).
    """
    if fuse_qkv:
        raise NotImplementedError(
            "the decode builders create the unfused q/k/v weight layout; "
            "decode a fuse_qkv-trained scope is not supported — train "
            "with use_qkv_fusion=False for decode interop")

    L = fluid.layers
    K = beam_size
    T = max_length
    limit_steps = T - 1 if max_out_len is None else min(max_out_len, T - 1)

    src_word = L.data("src_word", [T], dtype="int64")
    src_pos = L.data("src_pos", [T], dtype="int64")
    src_slf = L.data("src_slf_attn_bias", [n_head, T, T])
    trg_pos_full = L.data("trg_pos_full", [T], dtype="int64")
    trg_slf = L.data("trg_slf_attn_bias", [n_head, T, T])
    trg_src = L.data("trg_src_attn_bias", [n_head, T, T])
    init_ids = L.data("init_ids", [K], dtype="int64")
    init_scores = L.data("init_scores", [K])

    # encoder: identical call order to `transformer` => identical param
    # names (word emb, encoder fcs)
    enc_input = prepare_encoder(
        src_word, src_pos, src_vocab_size, d_model, T, 0.0,
        pos_enc_param_name=POS_ENC_PARAM_NAMES[0])
    enc_output = encoder(enc_input, src_slf, n_layer, n_head, d_key,
                         d_value, d_model, d_inner_hid)

    def beam_rep(x, tail_dims):
        """[B, ...] -> [B*K, ...] (repeat each row per beam)."""
        r = L.expand(L.unsqueeze(x, axes=[1]),
                     [1, K] + [1] * len(tail_dims))
        return L.reshape(r, shape=[-1] + list(tail_dims))

    enc_rep = beam_rep(enc_output, [T, d_model])
    trg_slf_rep = beam_rep(trg_slf, [n_head, T, T])
    trg_src_rep = beam_rep(trg_src, [n_head, T, T])
    trg_pos_rep = beam_rep(trg_pos_full, [T])

    counter = L.zeros(shape=[1], dtype="int32")
    counter.stop_gradient = True
    limit = L.fill_constant(shape=[1], dtype="int32", value=limit_steps)

    ids_array = L.create_array("int64", capacity=limit_steps + 1)
    scores_array = L.create_array("float32", capacity=limit_steps + 1)
    parent_array = L.create_array("int32", capacity=limit_steps + 1)
    L.array_write(init_ids, counter, ids_array)
    L.array_write(init_scores, counter, scores_array)
    init_parent = L.fill_constant_batch_size_like(
        input=init_ids, shape=[-1, K], dtype="int32", value=0)
    L.array_write(init_parent, counter, parent_array)

    # the decoded prefix, float-typed so one_hot matmul reordering works;
    # cast to int64 for the embedding lookup each step
    prefix = L.fill_constant_batch_size_like(
        input=init_ids, shape=[-1, K, T], dtype="float32", value=0.0)

    cond = L.less_than(x=counter, y=limit)
    while_op = L.While(cond=cond)
    with while_op.block():
        pre_ids = L.array_read(ids_array, counter)        # [B, K] int64
        pre_scores = L.array_read(scores_array, counter)  # [B, K]

        # prefix[:, :, t] = pre_ids
        t64 = L.cast(L.reshape(counter, shape=[1, 1]), "int64")
        onehot_t = L.one_hot(t64, T)                      # [1, T]
        keep = L.elementwise_sub(
            x=L.fill_constant(shape=[1, T], dtype="float32", value=1.0),
            y=onehot_t)
        new_prefix = L.elementwise_add(
            x=L.elementwise_mul(x=prefix, y=keep),
            y=L.elementwise_mul(
                x=L.expand(L.unsqueeze(L.cast(pre_ids, "float32"),
                                       axes=[2]), [1, 1, T]),
                y=onehot_t))
        L.assign(new_prefix, prefix)

        tokens = L.cast(L.reshape(prefix, shape=[-1, T]), "int64")
        # trg embedding + pos enc: same prepare_encoder call as training
        dec_input = prepare_encoder(
            tokens, trg_pos_rep, trg_vocab_size, d_model, T, 0.0,
            pos_enc_param_name=POS_ENC_PARAM_NAMES[1])
        dec_output = decoder(dec_input, enc_rep, trg_slf_rep, trg_src_rep,
                             n_layer, n_head, d_key, d_value, d_model,
                             d_inner_hid)
        logits = fluid.layers.fc(input=dec_output, size=trg_vocab_size,
                                 bias_attr=False, num_flatten_dims=2)
        # logits at position t: mask-and-reduce (no dynamic slicing op
        # needed)
        step_logits = L.reduce_sum(
            L.elementwise_mul(
                x=logits, y=L.reshape(onehot_t, shape=[1, T, 1])),
            dim=1)                                        # [B*K, V]
        logp = L.log(L.softmax(L.reshape(
            step_logits, shape=[-1, K, trg_vocab_size])))  # [B, K, V]

        selected_ids, selected_scores, parent = L.beam_search(
            pre_ids=pre_ids, pre_scores=pre_scores, ids=None, scores=logp,
            beam_size=K, end_id=eos_id, return_parent_idx=True)

        # reorder prefixes to follow their selected parent beams
        onehot_p = L.one_hot(parent, K)                   # [B, K, Ksrc]
        L.assign(L.matmul(onehot_p, prefix), prefix)

        L.increment(counter, 1, in_place=True)
        L.array_write(selected_ids, counter, ids_array)
        L.array_write(selected_scores, counter, scores_array)
        L.array_write(parent, counter, parent_array)
        L.less_than(x=counter, y=limit, cond=cond)

    return L.beam_search_decode(ids_array, scores_array,
                                parent_idx=parent_array, end_id=eos_id)


def build_cached_decode(src_vocab_size, trg_vocab_size, max_length,
                        n_layer=2, n_head=4, d_key=16, d_value=16,
                        d_model=64, d_inner_hid=128, beam_size=2,
                        max_out_len=None, bos_id=1, eos_id=2, fuse_qkv=False):
    """Incremental beam decode with per-layer self-attention KV caches —
    the JAX package's upgrade over build_decode (and over the reference
    era, which re-ran the whole decoder on the growing prefix each step,
    python/paddle/fluid's transformer infer path): step t computes ONE
    query position and attends its cached keys, so total decode FLOPs
    drop from O(T^2) decoder runs to O(T), with the caches living as
    While carries (beam-reordered by parent via one_hot matmul — static
    shapes end to end).

    Built under a fresh unique_name.guard with the SAME parameter-creation
    sequence as `transformer`, so every weight shares its training name
    and the decode program runs in the training scope. Feeds: src_word,
    src_pos, src_slf_attn_bias, src_len [B,1] int32 (cross-attention key
    padding), init_ids, init_scores. Returns
    (sentence_ids [B,K,C], sentence_scores [B,K]) — must match
    build_decode token-for-token (tested)."""
    if fuse_qkv:
        raise NotImplementedError(
            "the decode builders create the unfused q/k/v weight layout; "
            "decode a fuse_qkv-trained scope is not supported — train "
            "with use_qkv_fusion=False for decode interop")

    L = fluid.layers
    K = beam_size
    T = max_length
    limit_steps = T - 1 if max_out_len is None else min(max_out_len, T - 1)

    src_word = L.data("src_word", [T], dtype="int64")
    src_pos = L.data("src_pos", [T], dtype="int64")
    src_slf = L.data("src_slf_attn_bias", [n_head, T, T])
    src_len = L.data("src_len", [1], dtype="int32")
    init_ids = L.data("init_ids", [K], dtype="int64")
    init_scores = L.data("init_scores", [K])

    enc_input = prepare_encoder(
        src_word, src_pos, src_vocab_size, d_model, T, 0.0,
        pos_enc_param_name=POS_ENC_PARAM_NAMES[0])
    enc_output = encoder(enc_input, src_slf, n_layer, n_head, d_key,
                         d_value, d_model, d_inner_hid)

    def beam_rep(x, tail_dims):
        r = L.expand(L.unsqueeze(x, axes=[1]),
                     [1, K] + [1] * len(tail_dims))
        return L.reshape(r, shape=[-1] + list(tail_dims))

    enc_rep = beam_rep(enc_output, [T, d_model])            # [B*K, Ts, D]
    src_len_rep = L.cast(beam_rep(L.cast(src_len, "float32"), [1]),
                         "float32")                          # [B*K, 1]

    counter = L.zeros(shape=[1], dtype="int32")
    counter.stop_gradient = True
    limit = L.fill_constant(shape=[1], dtype="int32", value=limit_steps)

    ids_array = L.create_array("int64", capacity=limit_steps + 1)
    scores_array = L.create_array("float32", capacity=limit_steps + 1)
    parent_array = L.create_array("int32", capacity=limit_steps + 1)
    L.array_write(init_ids, counter, ids_array)
    L.array_write(init_scores, counter, scores_array)
    init_parent = L.fill_constant_batch_size_like(
        input=init_ids, shape=[-1, K], dtype="int32", value=0)
    L.array_write(init_parent, counter, parent_array)

    # per-layer self-attention KV caches [B*K, T, H*d]
    caches = []
    for _ in range(n_layer):
        ck = L.fill_constant_batch_size_like(
            input=enc_rep, shape=[-1, T, n_head * d_key],
            dtype="float32", value=0.0)
        cv = L.fill_constant_batch_size_like(
            input=enc_rep, shape=[-1, T, n_head * d_value],
            dtype="float32", value=0.0)
        caches.append((ck, cv))

    # constant position row [1, 1, 1, T] for building step masks
    pos_row = L.assign(np.arange(T, dtype="float32").reshape(1, 1, 1, T))

    def one_query_attention(q, ks, vs, valid, dk, dv):
        """q [BK,1,H*dk] attends ks/vs [BK,Tk,H*dk] under `valid`
        [*,1,1,Tk] (1 = attendable) — the O(Tk) cached step."""
        qh = L.transpose(L.reshape(q, shape=[0, 1, n_head, dk]),
                         perm=[0, 2, 1, 3])                  # [BK,H,1,dk]
        kh = L.transpose(L.reshape(ks, shape=[0, -1, n_head, dk]),
                         perm=[0, 2, 1, 3])
        vh = L.transpose(L.reshape(vs, shape=[0, -1, n_head, dv]),
                         perm=[0, 2, 1, 3])
        sc = L.scale(L.matmul(qh, kh, transpose_y=True),
                     scale=dk ** -0.5)                       # [BK,H,1,Tk]
        sc = sc + (valid - 1.0) * 1e9
        w = L.softmax(sc)
        ctx = L.matmul(w, vh)                                # [BK,H,1,dv]
        return L.reshape(L.transpose(ctx, perm=[0, 2, 1, 3]),
                         shape=[0, 1, n_head * dv])

    cond = L.less_than(x=counter, y=limit)
    while_op = L.While(cond=cond)
    with while_op.block():
        pre_ids = L.array_read(ids_array, counter)           # [B, K]
        pre_scores = L.array_read(scores_array, counter)

        t_f = L.cast(L.reshape(counter, shape=[1, 1]), "float32")
        t64 = L.cast(L.reshape(counter, shape=[1, 1]), "int64")
        onehot_t = L.one_hot(t64, T)                         # [1, T]

        # current token embedding + position encoding (same call order as
        # prepare_encoder: word emb then pos table)
        cur = L.reshape(L.cast(pre_ids, "int64"), shape=[-1, 1])
        word_emb = L.embedding(
            cur, size=[trg_vocab_size, d_model],
            param_attr=fluid.ParamAttr(
                initializer=fluid.initializer.Normal(
                    0., d_model ** -0.5)))
        word_emb = L.scale(x=word_emb, scale=d_model ** 0.5)
        pos_ids = L.cast(
            L.fill_constant_batch_size_like(
                input=cur, shape=[-1, 1], dtype="int32", value=0)
            + L.cast(L.reshape(counter, shape=[1]), "int32"), "int64")
        pos_enc = L.embedding(
            pos_ids, size=[T, d_model],
            param_attr=fluid.ParamAttr(
                name=POS_ENC_PARAM_NAMES[1], trainable=False,
                initializer=fluid.initializer.NumpyArrayInitializer(
                    position_encoding_init(T, d_model))))
        # embedding of [BK, 1] ids yields [BK, D] (reference lookup_table
        # squeezes the id column); restore the explicit one-step time axis so
        # every fc below sees [BK, 1, D] and creates [D, size] weights that
        # share shapes (and names) with the training program's.
        x = L.reshape(word_emb + pos_enc, shape=[-1, 1, d_model])

        # step masks: self-attn sees cache positions <= t; cross-attn sees
        # source positions < src_len
        t4 = L.reshape(t_f, shape=[1, 1, 1, 1])
        self_valid = L.clip(t4 + 1.0 - pos_row, min=0.0, max=1.0)
        cross_valid = L.clip(
            L.reshape(src_len_rep, shape=[-1, 1, 1, 1]) - pos_row,
            min=0.0, max=1.0)                                # [BK,1,1,T]

        new_caches = []
        for l in range(n_layer):
            ck, cv = caches[l]
            # EXACT training param order per decoder_layer: LN; self
            # q/k/v fc, out fc; LN; cross q/k/v fc, out fc; LN; ffn fc1/2
            xn = pre_post_process_layer(None, x, "n")
            q = L.fc(input=xn, size=d_key * n_head, bias_attr=False,
                     num_flatten_dims=2)
            k = L.fc(input=xn, size=d_key * n_head, bias_attr=False,
                     num_flatten_dims=2)
            v = L.fc(input=xn, size=d_value * n_head, bias_attr=False,
                     num_flatten_dims=2)
            # cache[:, t] = k / v (one_hot write, static shapes)
            keep = L.reshape(1.0 - onehot_t, shape=[1, T, 1])
            put = L.reshape(onehot_t, shape=[1, T, 1])
            ck = ck * keep + L.expand(k, [1, T, 1]) * put
            cv = cv * keep + L.expand(v, [1, T, 1]) * put
            new_caches.append((ck, cv))
            att = one_query_attention(q, ck, cv, self_valid, d_key,
                                      d_value)
            x = x + L.fc(input=att, size=d_model, bias_attr=False,
                         num_flatten_dims=2)

            xn = pre_post_process_layer(None, x, "n")
            q2 = L.fc(input=xn, size=d_key * n_head, bias_attr=False,
                      num_flatten_dims=2)
            ek = L.fc(input=enc_rep, size=d_key * n_head, bias_attr=False,
                      num_flatten_dims=2)
            ev = L.fc(input=enc_rep, size=d_value * n_head,
                      bias_attr=False, num_flatten_dims=2)
            att2 = one_query_attention(q2, ek, ev, cross_valid, d_key,
                                       d_value)
            x = x + L.fc(input=att2, size=d_model, bias_attr=False,
                         num_flatten_dims=2)

            xn = pre_post_process_layer(None, x, "n")
            x = x + positionwise_feed_forward(xn, d_inner_hid, d_model)

        dec_out = pre_post_process_layer(None, x, "n")       # final LN
        logits = L.fc(input=dec_out, size=trg_vocab_size, bias_attr=False,
                      num_flatten_dims=2)                    # [BK, 1, V]
        logp = L.log(L.softmax(L.reshape(
            logits, shape=[-1, K, trg_vocab_size])))         # [B, K, V]

        selected_ids, selected_scores, parent = L.beam_search(
            pre_ids=pre_ids, pre_scores=pre_scores, ids=None, scores=logp,
            beam_size=K, end_id=eos_id, return_parent_idx=True)

        # reorder every cache row to follow its selected parent beam
        onehot_p = L.one_hot(parent, K)                      # [B, K, Ksrc]
        for l, (ck, cv) in enumerate(new_caches):
            ckb = L.reshape(ck, shape=[-1, K, T * n_head * d_key])
            cvb = L.reshape(cv, shape=[-1, K, T * n_head * d_value])
            L.assign(L.reshape(L.matmul(onehot_p, ckb),
                               shape=[-1, T, n_head * d_key]),
                     caches[l][0])
            L.assign(L.reshape(L.matmul(onehot_p, cvb),
                               shape=[-1, T, n_head * d_value]),
                     caches[l][1])

        L.increment(counter, 1, in_place=True)
        L.array_write(selected_ids, counter, ids_array)
        L.array_write(selected_scores, counter, scores_array)
        L.array_write(parent, counter, parent_array)
        L.less_than(x=counter, y=limit, cond=cond)

    return L.beam_search_decode(ids_array, scores_array,
                                parent_idx=parent_array, end_id=eos_id)


def prepare_cached_decode_batch(src_seqs, max_length, n_head, beam_size,
                                bos_id=1, pad_id=0):
    """Feed arrays for build_cached_decode: encoder feeds + src_len +
    beam init (no [H,T,T] target bias tensors needed)."""
    feeds = prepare_decode_batch(src_seqs, max_length, n_head, beam_size,
                                 bos_id=bos_id, pad_id=pad_id)
    feeds["src_len"] = np.array(
        [[min(len(s), max_length)] for s in src_seqs], "int32")
    for k in ("trg_pos_full", "trg_slf_attn_bias", "trg_src_attn_bias"):
        feeds.pop(k)
    return feeds


def prepare_decode_batch(src_seqs, max_length, n_head, beam_size,
                         bos_id=1, pad_id=0):
    """Feed arrays for build_decode: encoder feeds + beam init."""
    b = len(src_seqs)
    neg = -1e9
    src = np.full((b, max_length), pad_id, "int64")
    src_pos = np.zeros((b, max_length), "int64")
    src_bias = np.zeros((b, n_head, max_length, max_length), "float32")
    cross_bias = np.zeros((b, n_head, max_length, max_length), "float32")
    causal = np.triu(np.full((max_length, max_length), neg, "float32"), 1)
    trg_bias = np.tile(causal[None, None], (b, n_head, 1, 1))
    for i, s in enumerate(src_seqs):
        s = list(s)[:max_length]
        src[i, :len(s)] = s
        src_pos[i, :len(s)] = np.arange(len(s))
        src_bias[i, :, :, len(s):] = neg
        cross_bias[i, :, :, len(s):] = neg
    init_ids = np.full((b, beam_size), bos_id, "int64")
    init_scores = np.zeros((b, beam_size), "float32")
    init_scores[:, 1:] = neg  # break initial beam symmetry
    return {
        "src_word": src, "src_pos": src_pos, "src_slf_attn_bias": src_bias,
        "trg_pos_full": np.tile(np.arange(max_length, dtype="int64")[None],
                                (b, 1)),
        "trg_slf_attn_bias": trg_bias.astype("float32"),
        "trg_src_attn_bias": cross_bias,
        "init_ids": init_ids, "init_scores": init_scores,
    }


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
