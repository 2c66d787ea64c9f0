"""The port's zoo against the JAX package's, on the CPU.

- Program bytes: each of models/zoo.py's nine names, built by the port at
  the zoo's config, serializes to the JAX package's bytes but for its
  int64 -> int32 narrowing of inferred dtypes (x64 is off there). Zoo
  `transformer` takes the JAX package's default, the dense attn_bias
  attention.
- Training: word2vec, ctr, recommender, language_model, transformer (zoo
  configs; the transformer's dense feeds from the port's prepare_batch,
  which equals the JAX package's) and fit_a_line (book chapter 01:
  fc(13 -> 1), square_error_cost, mean, SGD), 20 steps in both packages
  from the JAX startup state (carried
  into the port by io.scope_from_numpy) on the same numpy feeds from a
  seed: the losses, step 1's gradients and every persistable's change
  (parameters and optimizer state: Adam's moments and beta powers,
  SGD's untouched learning rate).
- The language model's tied table: its one gradient is the sum of the
  lookup's and the output matmul's, each rebuilt in numpy from the
  fetched activations and output gradients.

Tolerances (fp32 in both packages, sums in another order; measured values
over the 20 steps beside each):
- losses: rtol 1e-5 (measured: at most 2.3e-6 relative, the recommender;
  1.0e-7 to 2.1e-7 for the others);
- step 1's gradients, per parameter, ||port - jax|| / ||jax||: 1e-5
  (measured: at most 7.5e-7, the transformer; 6.0e-7 ctr);
- every persistable's change over the 20 steps, ||port change - jax
  change|| / ||jax change||: 1e-4 (measured: at most 4.0e-5, ctr, whose
  Adam moves a parameter by about lr whatever the size of its gradient,
  so a gradient at rounding-noise level moves it either way; 1.2e-7 to
  5.4e-6 for the others, the transformer's 1.3e-6);
- the tied table's gradient against the sum of its two parts: 1e-6 of
  its largest value (measured 8.0e-8).
Alone the file takes about 50 s and 0.75 GB of RSS.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core import program_desc as jdesc
from paddle_tpu.models import ctr as jctr
from paddle_tpu.models import language_model as jlm
from paddle_tpu.models import recommender_system as jrec
from paddle_tpu.models import transformer as jtr
from paddle_tpu.models import word2vec as jw2v
from paddle_tpu.models import zoo as jzoo

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import program_desc as tdesc
from paddle_tpu_torch.datasets import movielens
from paddle_tpu_torch.models import ctr as tctr
from paddle_tpu_torch.models import language_model as tlm
from paddle_tpu_torch.models import recommender_system as trec
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.models import word2vec as tw2v
from paddle_tpu_torch.models import zoo as tzoo

STEPS, BATCH = 20, 8
LOSS_RTOL, GRAD_TOL, CHANGE_TOL, TIED_TOL = 1e-5, 1e-5, 1e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes are small: one intra-op thread does, and leaves the
    other test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_bytes(jprog, tprog):
    """program_to_bytes equal but for the JAX package's int64 -> int32
    narrowing; returns the number of narrowed vars."""
    jd = json.loads(jdesc.program_to_bytes(jprog))
    td = json.loads(tdesc.program_to_bytes(tprog))
    narrowed = 0
    for jb, tb in zip(jd["blocks"], td["blocks"]):
        for jv, tv in zip(jb["vars"], tb["vars"]):
            if (jv["dtype"], tv["dtype"]) == ("int32", "int64"):
                jv["dtype"] = "int64"
                narrowed += 1
    assert td == jd
    return narrowed


def _built(fluid, fn):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = fn()
    return main, startup, out


# ---------------------------------------------------------------- bytes --

def test_zoo_has_the_jax_names():
    assert tzoo.names() == jzoo.names()
    with pytest.raises(KeyError, match="no zoo model"):
        tzoo.build("alexnet")


# vars the JAX package narrows from int64 to int32: at most 2 a model,
# but srl's 4 (its Viterbi path and chunk_eval's three counts)
NARROWED = {"srl": 4}


@pytest.mark.parametrize("name", sorted(jzoo.names()))
def test_zoo_program_matches_the_jax_one(name):
    tmain, tstartup = tzoo.build(name)
    jmain, jstartup = jzoo.build(name)
    assert _same_bytes(jmain, tmain) <= NARROWED.get(name, 2)
    assert tdesc.program_to_bytes(tstartup) == \
        jdesc.program_to_bytes(jstartup)


def test_zoo_models_take_their_ops():
    """The slice's models carry the ops they were ported for."""
    want = {"word2vec": {"concat", "sigmoid", "softmax", "cross_entropy",
                         "sgd"},
            "ctr": {"sum", "concat", "relu", "sigmoid",
                    "sigmoid_cross_entropy_with_logits", "adam"},
            "recommender": {"sequence_pool", "sequence_conv", "cos_sim",
                            "scale", "square_error_cost", "sgd"},
            "language_model": {"lstm", "matmul", "exp",
                               "softmax_with_cross_entropy", "adam"}}
    for name, types in want.items():
        main, _ = tzoo.build(name)
        have = {op.type for op in main.global_block().ops}
        assert types <= have, (name, types - have)
    main, _ = tzoo.build("recommender")
    pools = [op for op in main.global_block().ops
             if op.type == "sequence_pool"]
    assert [op.attrs["pooltype"] for op in pools] == ["SUM", "SUM"]


def test_movielens_metadata_is_the_synthetic_tables():
    assert (movielens.max_user_id(), movielens.max_movie_id(),
            movielens.max_job_id()) == (943, 1682, 20)
    assert len(movielens.movie_categories()) == 18
    assert len(movielens.get_movie_title_dict()) == 1024
    assert movielens.age_table == [1, 18, 25, 35, 45, 50, 56]


def test_movielens_refuses_the_real_file(tmp_path, monkeypatch):
    """With ml-1m.zip under the data home both packages size the
    recommender from it (tests/test_torch_datasets.py reads a valid one);
    a file that is no zip is refused by each metadata function, as the
    JAX package refuses it, and nothing is cached."""
    import zipfile
    from paddle_tpu_torch.datasets import common
    (tmp_path / "movielens").mkdir()
    (tmp_path / "movielens" / "ml-1m.zip").write_bytes(b"")
    monkeypatch.setattr(common, "DATA_HOME", str(tmp_path))
    for fn in (movielens.max_user_id, movielens.max_movie_id,
               movielens.max_job_id, movielens.movie_categories,
               movielens.get_movie_title_dict):
        with pytest.raises(zipfile.BadZipFile):
            fn()
    assert movielens._REAL_CACHE is None


# ------------------------------------------------------------- training --

def _fit_a_line(fluid):
    x = fluid.layers.data(name="x", shape=[13], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    pred = fluid.layers.fc(input=x, size=1)
    avg = fluid.layers.mean(fluid.layers.square_error_cost(input=pred,
                                                           label=y))
    fluid.optimizer.SGD(learning_rate=0.01).minimize(avg)
    return avg


_TFM = dict(src_vocab_size=20, trg_vocab_size=20, max_length=8, n_layer=1,
            n_head=2, d_key=8, d_value=8, d_model=16, d_inner_hid=32)

_BUILDERS = {
    "word2vec": (lambda: jw2v.build(dict_size=100, embed_size=8,
                                    hidden_size=16)[1],
                 lambda: tw2v.build(dict_size=100, embed_size=8,
                                    hidden_size=16)[1]),
    "ctr": (lambda: jctr.build(sparse_feature_dim=1000,
                               embedding_size=8)[1],
            lambda: tctr.build(sparse_feature_dim=1000,
                               embedding_size=8)[1]),
    "recommender": (lambda: jrec.build_train(emb_dim=8, fc_dim=16)[1],
                    lambda: trec.build_train(emb_dim=8, fc_dim=16)[1]),
    "language_model": (lambda: jlm.build(vocab_size=120, emb_size=8,
                                         hidden_size=8, num_layers=2)[2],
                       lambda: tlm.build(vocab_size=120, emb_size=8,
                                         hidden_size=8, num_layers=2)[2]),
    "fit_a_line": (lambda: _fit_a_line(jfluid),
                   lambda: _fit_a_line(tfluid)),
    "transformer": (lambda: jtr.build_train(**_TFM)[1],
                    lambda: ttr.build_train(use_fused_attention=False,
                                            **_TFM)[1]),
}


def _feed(model, step, lod_cls):
    """One batch of `model`'s feeds from seed 300 + step; sequence feeds
    as `lod_cls` (each package's LoDTensor)."""
    rng = np.random.RandomState(300 + step)

    def ids(hi, n=BATCH):
        return rng.randint(0, hi, (n, 1)).astype(np.int64)

    def seqs(hi, lo_len, hi_len):
        return lod_cls.from_sequences(
            [rng.randint(0, hi, (int(n), 1)).astype(np.int64)
             for n in rng.randint(lo_len, hi_len + 1, BATCH)])

    if model == "word2vec":
        return {n: ids(100) for n in ("firstw", "secondw", "thirdw",
                                      "forthw", "nextw")}
    if model == "ctr":
        feed = {"C%d" % i: ids(1000) for i in range(26)}
        feed["dense_input"] = rng.rand(BATCH, 13).astype(np.float32)
        feed["label"] = rng.randint(0, 2, (BATCH, 1)).astype(np.float32)
        return feed
    if model == "recommender":
        feed = {"user_id": 1 + ids(movielens.max_user_id()),
                "gender_id": ids(2),
                "age_id": ids(len(movielens.age_table)),
                "job_id": ids(movielens.max_job_id() + 1),
                "movie_id": 1 + ids(movielens.max_movie_id())}
        feed["category_id"] = seqs(len(movielens.movie_categories()), 1, 3)
        feed["movie_title"] = seqs(len(movielens.get_movie_title_dict()),
                                   1, 5)
        feed["score"] = rng.randint(1, 6, (BATCH, 1)).astype(np.float32)
        return feed
    if model == "language_model":
        # consecutive ids from a random start: a next word to learn
        lens = rng.randint(2, 11, BATCH)
        sents = [((rng.randint(0, 120) + np.arange(int(n) + 1)) % 120)
                 .reshape(-1, 1).astype(np.int64) for n in lens]
        return {"words": lod_cls.from_sequences([s[:-1] for s in sents]),
                "nextwords": lod_cls.from_sequences([s[1:] for s in sents])}
    if model == "transformer":
        # a copy task: the target is the source
        src = [rng.randint(3, 20, rng.randint(2, 9)).tolist()
               for _ in range(BATCH)]
        return ttr.prepare_batch(src, src, 8, labels=True, n_head=2)
    x = rng.rand(BATCH, 13).astype(np.float32)
    return {"x": x, "y": (x @ np.arange(13, dtype=np.float32)[:, None]
                          / 13.0).astype(np.float32)}


def _train_both(model, extra_fetch=()):
    """Both packages' STEPS steps from the JAX startup state, fetching the
    loss, every gradient and `extra_fetch` each step (one fetch list: one
    JAX compile)."""
    jb, tb = _BUILDERS[model]
    jmain, jstartup, _ = _built(jfluid, jb)
    tmain, _, tavg = _built(tfluid, tb)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
    state = {v.name: np.array(jscope.get(v.name))
             for v in jmain.list_vars() if v.persistable}
    tscope = tio.scope_from_numpy(state, "cpu", program=tmain)
    texe = tfluid.Executor("cpu")
    grads = sorted(p.name + "@GRAD" for p in tmain.all_parameters()
                   if p.trainable)
    fetch = [tavg.name] + grads + list(extra_fetch(tmain) if extra_fetch
                                       else ())
    jl, tl, jfirst, tfirst = [], [], None, None
    for step in range(STEPS):
        with jfluid.scope_guard(jscope):
            jres = jexe.run(jmain, feed=_feed(model, step, jfluid.LoDTensor),
                            fetch_list=fetch)
        tres = texe.run(tmain, feed=_feed(model, step, tfluid.LoDTensor),
                        fetch_list=fetch, scope=tscope)
        jl.append(float(np.asarray(jres[0]).reshape(-1)[0]))
        tl.append(float(tres[0].reshape(-1)[0]))
        if step == 0:
            jfirst = [np.asarray(a) for a in jres]
            tfirst = tres
    return dict(tmain=tmain, state=state, jl=jl, tl=tl, grads=grads,
                fetch=fetch, jfirst=jfirst, tfirst=tfirst, jscope=jscope,
                tscope=tscope)


def _norm_rel(got, want):
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module", params=sorted(_BUILDERS))
def trained(request):
    return request.param, _train_both(request.param)


def test_losses_agree_over_twenty_steps(trained):
    model, r = trained
    assert len(r["tl"]) == STEPS and np.isfinite(r["tl"]).all()
    np.testing.assert_allclose(r["tl"], r["jl"], rtol=LOSS_RTOL)
    assert np.mean(r["tl"][-5:]) < np.mean(r["tl"][:5]), r["tl"]


def test_step_one_gradients_agree(trained):
    model, r = trained
    n = len(r["grads"])
    assert n >= 2
    for name, got, want in zip(r["grads"], r["tfirst"][1:n + 1],
                               r["jfirst"][1:n + 1]):
        assert got.shape == want.shape, name
        assert _norm_rel(got, want) <= GRAD_TOL, (name,
                                                  _norm_rel(got, want))


def test_persistables_change_alike_over_twenty_steps(trained):
    """Every persistable the optimizer moves (parameters, Adam's moments
    and beta powers) changes as in the JAX package; the learning rate
    stays."""
    model, r = trained
    moved = 0
    for v in r["tmain"].list_vars():
        if not v.persistable:
            continue
        got = r["tscope"].get(v.name).numpy()
        want = np.asarray(r["jscope"].get(v.name)).astype(got.dtype)
        if v.name.startswith("learning_rate"):
            np.testing.assert_array_equal(got, want)
            continue
        change = _norm_rel(got - r["state"][v.name],
                           want - r["state"][v.name])
        assert change <= CHANGE_TOL, (v.name, change)
        moved += 1
    assert moved >= len(r["grads"])


def test_language_model_tied_table_sums_both_gradients():
    """lm_embedding feeds the lookup and the output matmul (transpose_y):
    its gradient is the lookup's rows scattered by id plus out^T @
    d(logits) summed over the batch and time, each rebuilt in numpy from
    the port's fetches of step 1; it also equals the JAX package's, and
    rows no id looked up get only the matmul's part, which is nonzero."""
    def extra(main):
        ops = main.global_block().ops
        look = next(op for op in ops if op.type == "lookup_table"
                    and op.inputs["W"] == ["lm_embedding"])
        mm = next(op for op in ops if op.type == "matmul"
                  and op.inputs["Y"] == ["lm_embedding"])
        return [look.outputs["Out"][0] + "@GRAD", mm.inputs["X"][0],
                mm.outputs["Out"][0] + "@GRAD", "lm_embedding@GRAD"]

    r = _train_both("language_model", extra)
    emb_g, out, logit_g, table_g = r["tfirst"][-4:]
    ids = _feed("language_model", 0, tfluid.LoDTensor)["words"]
    padded, _ = ids.to_padded()
    lookup_part = np.zeros_like(table_g)
    np.add.at(lookup_part, padded.reshape(-1),
              emb_g.reshape(-1, emb_g.shape[-1]))
    matmul_part = np.einsum("btv,bte->ve", logit_g, out)
    err = float(np.abs(table_g - lookup_part - matmul_part).max()
                / np.abs(table_g).max())
    assert err <= TIED_TOL, err
    unused = np.setdiff1d(np.arange(table_g.shape[0]), padded.reshape(-1))
    assert len(unused) and np.abs(table_g[unused]).max() > 0
    assert np.abs(lookup_part).max() > 0
    jtable = r["jfirst"][r["fetch"].index("lm_embedding@GRAD")]
    assert _norm_rel(table_g, jtable) <= GRAD_TOL


def test_transformer_dense_feeds_match_the_jax_ones():
    """prepare_batch with n_head gives the JAX package's dense feeds: the
    three [B, H, T, T] biases (-1e9 past a row's length and above the
    decoder's diagonal) in place of src_len / trg_len."""
    rng = np.random.RandomState(9)
    src = [rng.randint(3, 20, n).tolist() for n in (8, 3, 5)]
    trg = [rng.randint(3, 20, n).tolist() for n in (2, 8, 6)]
    got = ttr.prepare_batch(src, trg, 8, labels=True, n_head=2)
    want = jtr.prepare_batch(src, trg, 8, 2)
    assert sorted(got) == sorted(want) == sorted(ttr.FEED_NAMES)
    for name in got:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
