"""The OCR model (CRNN-CTC, models/ocr_recognition.py, ROADMAP A6) in the
port against the JAX package, on the CPU, at
tests/book/test_ocr_recognition.py's widths: 1 x 16 x 64 images, channels
(8, 16, 32), GRU hidden 32, 4 classes and the blank, a batch of 8 images
of 2-4 stripe glyphs.

- ctc_train_net builds the JAX package's program bytes.
- Training: from the JAX startup state (io.scope_from_numpy), three
  Momentum steps on three batches: each step's summed CTC loss, its greedy
  decode (ctc_greedy_decoder) with its lengths and the edit distance
  equal the JAX package's; then every persistable.
- Serving: the is_test encoder with the greedy decoder, built apart from
  the training program (the same parameter names), saved by
  io.save_inference_model with the decode and its lengths as targets and
  served by the port's InferenceEngine on the CPU, one image a request:
  each answer equals Executor.run's decode of that image alone, and the
  JAX package's inference program on the same state.

Tolerances: losses and persistables rtol = atol = 1e-4 (fp32 through six
convolutions, batch norms and two GRUs of 8 steps, in another order, three
steps); decodes, lengths and edit distances exact.
"""
import json
import os
import tempfile

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core import program_desc as jdesc
from paddle_tpu.core.lod import LoDTensor as JLoDTensor
from paddle_tpu.models import ocr_recognition as jocr

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import program_desc as tdesc
from paddle_tpu_torch.core.lod import LoDTensor as TLoDTensor
from paddle_tpu_torch.models import ocr_recognition as tocr
from paddle_tpu_torch.serving import InferenceEngine

CLASSES, H, W = 4, 16, 64
CFG = dict(rnn_hidden_size=32, channels=(8, 16, 32))
TOL = dict(rtol=1e-4, atol=1e-4)
_PKG = {"jax": (jfluid, jocr, JLoDTensor), "port": (tfluid, tocr,
                                                    TLoDTensor)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def render(chars):
    """The book test's glyphs: character c is a stripe in row band c."""
    img = np.zeros((1, H, W), dtype="float32")
    for i, c in enumerate(chars):
        y0 = c * (H // CLASSES)
        img[0, y0:y0 + H // CLASSES, i * 16:(i + 1) * 16] = 1.0
    return img


def synth_batch(rng, n=8):
    chars = [rng.randint(0, CLASSES, rng.randint(2, 5)) for _ in range(n)]
    return (np.stack([render(c) for c in chars]),
            [np.asarray(c, dtype="int64").reshape(-1, 1) for c in chars])


def _train_program(pkg):
    fluid, ocr, _ = _PKG[pkg]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        images = fluid.layers.data(name="pixel", shape=[1, H, W],
                                   dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64",
                                  lod_level=1)
        sum_cost, decoded, error, _ = ocr.ctc_train_net(
            images, label, CLASSES, learning_rate=3e-3, **CFG)
        decoded_len = main.global_block().var(decoded.seq_len_var)
    return main, startup, [sum_cost, decoded, decoded_len, error]


def _infer_program(pkg):
    fluid, ocr, _ = _PKG[pkg]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        images = fluid.layers.data(name="pixel", shape=[1, H, W],
                                   dtype="float32")
        fc_out = ocr.encoder_net(images, CLASSES, is_test=True, **CFG)
        decoded = fluid.layers.ctc_greedy_decoder(input=fc_out,
                                                  blank=CLASSES)
        decoded_len = main.global_block().var(decoded.seq_len_var)
    return main, [decoded, decoded_len]


def _bytes(program):
    return json.loads((jdesc if program.__module__.startswith("paddle_tpu.")
                       else tdesc).program_to_bytes(program))


def test_ctc_train_net_is_the_jax_program():
    jd = _bytes(_train_program("jax")[0])
    td = _bytes(_train_program("port")[0])
    for jb, tb in zip(jd["blocks"], td["blocks"]):
        for jv, tv in zip(jb["vars"], tb["vars"]):
            if (jv["dtype"], tv["dtype"]) == ("int32", "int64"):
                jv["dtype"] = "int64"
    assert td == jd


@pytest.fixture(scope="module")
def trained():
    """Three Momentum steps in both packages from the JAX startup state:
    ((JAX fetches, port fetches) per step, JAX state, port scope)."""
    jmain, jstartup, jfetch = _train_program("jax")
    tmain, _, tfetch = _train_program("port")
    exe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        exe.run(jstartup)
    state = {v.name: np.array(jscope.get(v.name))
             for v in jmain.list_vars() if v.persistable}
    tscope = tio.scope_from_numpy(state, "cpu", program=tmain)
    texe = tfluid.Executor("cpu")
    rng = np.random.RandomState(0)
    steps = []
    for _ in range(3):
        imgs, labels = synth_batch(rng)
        with jfluid.scope_guard(jscope):
            want = exe.run(jmain, feed={
                "pixel": imgs, "label": JLoDTensor.from_sequences(labels)},
                fetch_list=jfetch)
        got = texe.run(tmain, feed={
            "pixel": imgs, "label": TLoDTensor.from_sequences(labels)},
            fetch_list=tfetch, scope=tscope)
        steps.append(([np.asarray(w) for w in want], got))
    jstate = {v.name: np.array(jscope.get(v.name))
              for v in jmain.list_vars() if v.persistable}
    return steps, jstate, tscope


def test_momentum_steps_match_the_jax_package(trained):
    steps, jstate, tscope = trained
    losses = []
    for want, got in steps:
        np.testing.assert_allclose(got[0], want[0], **TOL)
        for g, w in zip(got[1:], want[1:]):       # decode, lengths, errors
            np.testing.assert_array_equal(g, w)
        losses.append(float(got[0][0]))
    assert losses[-1] < losses[0], losses
    for name, value in jstate.items():
        np.testing.assert_allclose(tscope.get(name).numpy(), value,
                                   err_msg=name, **TOL)


def test_served_decode_equals_executor_run(trained):
    _, jstate, tscope = trained
    infer, fetch = _infer_program("port")
    rng = np.random.RandomState(1)
    imgs, _ = synth_batch(rng, 4)
    texe = tfluid.Executor("cpu")
    with tempfile.TemporaryDirectory(prefix="ptt_ocr_") as tmp:
        path = os.path.join(tmp, "ocr")
        tio.save_inference_model(path, ["pixel"], fetch, texe,
                                 main_program=infer, scope=tscope)
        engine = InferenceEngine(path, device="cpu", batch_buckets=[1, 4])
        try:
            answers = [engine.infer({"pixel": img[None]})
                       for img in imgs]
        finally:
            engine.close()
    jinfer, jfetch = _infer_program("jax")
    exe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    for name, value in jstate.items():
        jscope.set(name, value)
    for img, ans in zip(imgs, answers):
        want = texe.run(infer, feed={"pixel": img[None]}, fetch_list=fetch,
                        scope=tscope)
        with jfluid.scope_guard(jscope):
            jwant = exe.run(jinfer, feed={"pixel": img[None]},
                            fetch_list=jfetch)
        for name, w, jw in zip(engine.fetch_names, want, jwant):
            np.testing.assert_array_equal(ans[name], w)
            np.testing.assert_array_equal(ans[name], np.asarray(jw))
        n = int(ans[engine.fetch_names[1]][0])
        assert not ans[engine.fetch_names[0]][0, n:].any()
