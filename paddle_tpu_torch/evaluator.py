"""Evaluators: metric states accumulated across mini-batches in the
program.

Parity: python/paddle/fluid/evaluator.py and the JAX package's
evaluator.py. An Evaluator's states are persistable vars that `sums` ops
appended to the main program update each run (so accumulation runs on
the device with the step); `reset` zeroes them with a side program and
`eval` fetches them. DetectionMAP accumulates fetched detections on the
host (metrics.DetectionMAP), as in the JAX package. ChunkEvaluator and
EditDistance wait for their chunk_eval and edit_distance op rules
(ROADMAP A5).
"""
import numpy as np

from .core.framework import Program, Variable, program_guard
from .core.layer_helper import LayerHelper
from .core import unique_name
from . import layers

__all__ = ["Accuracy", "DetectionMAP"]


def _clone_var_(block, var):
    assert isinstance(var, Variable)
    return block.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                            lod_level=var.lod_level, persistable=True)


class Evaluator(object):
    """Base class: states zeroed by reset(); metrics computed per batch."""

    def __init__(self, name, **kwargs):
        self.states = []
        self.metrics = []
        self.helper = LayerHelper(name, **kwargs)

    def reset(self, executor, reset_program=None):
        if reset_program is None:
            reset_program = Program()
        with program_guard(main_program=reset_program):
            for var in self.states:
                g_var = _clone_var_(reset_program.current_block(), var)
                layers.fill_constant(shape=g_var.shape, value=0.0,
                                     dtype=g_var.dtype, out=g_var)
        executor.run(reset_program)

    def eval(self, executor, eval_program=None):
        raise NotImplementedError()

    def create_state(self, suffix, dtype, shape):
        """A persistable state, zeroed by the startup program too (the
        reference leaves it undefined until the first reset)."""
        from .core.initializer import ConstantInitializer
        state = self.helper.create_or_get_global_variable(
            name=unique_name.generate(".".join([self.helper.name, suffix])),
            persistable=True, dtype=dtype, shape=shape)
        self.helper.set_variable_initializer(state, ConstantInitializer(0.0))
        self.states.append(state)
        return state

    def _fetch_states(self, executor, eval_program=None):
        if eval_program is None:
            eval_program = Program()
        block = eval_program.current_block()
        return executor.run(
            eval_program,
            fetch_list=[_clone_var_(block, s) for s in self.states])


class Accuracy(Evaluator):
    """Top-k accuracy accumulated over the batches since the last reset."""

    def __init__(self, input, label, k=1, **kwargs):
        super(Accuracy, self).__init__("accuracy", **kwargs)
        self.total = self.create_state(dtype="int64", shape=[1],
                                       suffix="total")
        self.correct = self.create_state(dtype="int64", shape=[1],
                                         suffix="correct")
        total = layers.create_tensor(dtype="int64")
        correct = layers.create_tensor(dtype="int64")
        acc = layers.accuracy(input=input, label=label, k=k, total=total,
                              correct=correct)
        layers.sums(input=[self.total, total], out=self.total)
        layers.sums(input=[self.correct, correct], out=self.correct)
        self.metrics.append(acc)

    def eval(self, executor, eval_program=None):
        total, correct = self._fetch_states(executor, eval_program)
        total = float(np.ravel(total)[0])
        correct = float(np.ravel(correct)[0])
        return np.array([correct / total if total else 0.0], "float32")


class DetectionMAP(object):
    """Mean average precision for detection, accumulated on the host:
    `update(nmsed_out, nmsed_lens, gt_boxes, gt_labels)` with fetched
    numpy results per batch, `eval()` the mAP (metrics.DetectionMAP)."""

    def __init__(self, overlap_threshold=0.5, evaluate_difficult=True,
                 ap_version="integral", background_label=None):
        from .metrics import DetectionMAP as _Metric
        self._metric = _Metric(overlap_threshold=overlap_threshold,
                               ap_version=ap_version,
                               evaluate_difficult=evaluate_difficult,
                               background_label=background_label)

    def reset(self, executor=None, reset_program=None):
        self._metric.reset()

    def update(self, nmsed_out, nmsed_lens, gt_boxes, gt_labels,
               gt_difficult=None):
        self._metric.update(nmsed_out, nmsed_lens, gt_boxes, gt_labels,
                            gt_difficult=gt_difficult)

    def eval(self, executor=None, eval_program=None):
        return np.array([self._metric.eval()], "float32")
