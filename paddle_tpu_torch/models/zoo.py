"""Small-config build registry over the bundled model families.

Parity: the JAX package's models/zoo.py: the same nine names, each built
at the same small config into the same Program (the SHAPE of each program,
its op vocabulary, sub-blocks and sequence plumbing, not its capacity).
`srl` needs linear_chain_crf, which is not ported yet: building it raises
(ROADMAP A6).

    for name in zoo.names():
        main, startup = zoo.build(name)
"""
import paddle_tpu_torch as fluid


def _builders():
    L = fluid.layers

    def mnist():
        from . import recognize_digits
        recognize_digits.build(nn_type="conv")

    def sentiment():
        from .understand_sentiment import stacked_lstm_net
        data = L.data(name="words", shape=[1], dtype="int64", lod_level=1)
        stacked_lstm_net(data, dict_dim=100, class_dim=2, emb_dim=16,
                         hid_dim=16, stacked_num=3)

    def seq2seq():
        from .machine_translation import build_train
        build_train(dict_size=30, word_dim=8, hidden_dim=16,
                    decoder_size=16)

    def transformer():
        from . import transformer as tfm
        # the JAX package's default attention: the dense attn_bias path
        tfm.build_train(src_vocab_size=20, trg_vocab_size=20, max_length=8,
                        n_layer=1, n_head=2, d_key=8, d_value=8, d_model=16,
                        d_inner_hid=32, use_fused_attention=False)

    def srl():
        raise NotImplementedError(
            "zoo model 'srl' (label_semantic_roles) needs the "
            "linear_chain_crf op, which is not ported yet (ROADMAP A6)")

    def ctr():
        from . import ctr as m
        m.build(sparse_feature_dim=1000, embedding_size=8)

    def word2vec():
        from . import word2vec as m
        m.build(dict_size=100, embed_size=8, hidden_size=16)

    def recommender():
        from . import recommender_system as m
        m.build_train(emb_dim=8, fc_dim=16)

    def language_model():
        from . import language_model as m
        m.build(vocab_size=120, emb_size=8, hidden_size=8, num_layers=2)

    return {"mnist": mnist, "sentiment": sentiment, "seq2seq": seq2seq,
            "transformer": transformer, "srl": srl, "ctr": ctr,
            "word2vec": word2vec, "recommender": recommender,
            "language_model": language_model}


def names():
    """Sorted model names in the zoo."""
    return sorted(_builders())


def build(name):
    """Construct model `name` at its zoo config -> (main, startup)
    Programs, built under fresh name/program guards."""
    builder = _builders().get(name)
    if builder is None:
        raise KeyError("no zoo model named %r (have: %s)"
                       % (name, ", ".join(names())))
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        builder()
    return main, startup
