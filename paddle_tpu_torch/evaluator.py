"""Evaluators: metric states accumulated across mini-batches in the
program.

Parity: python/paddle/fluid/evaluator.py and the JAX package's
evaluator.py. An Evaluator's states are persistable vars that `sums` ops
appended to the main program update each run (so accumulation runs on
the device with the step); `reset` zeroes them with a side program and
`eval` fetches them. DetectionMAP accumulates fetched detections on the
host (metrics.DetectionMAP), as in the JAX package. ChunkEvaluator and
EditDistance accumulate the counts of the chunk_eval and edit_distance
ops (ops/crf_ops.py, ops/ctc_ops.py) on the device.
"""
import numpy as np

from .core.framework import Program, Variable, program_guard
from .core.layer_helper import LayerHelper
from .core import unique_name
from . import layers

__all__ = ["Accuracy", "ChunkEvaluator", "EditDistance", "DetectionMAP"]


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


class ChunkEvaluator(Evaluator):
    """Accumulated chunk precision/recall/F1 (evaluator.py ChunkEvaluator)."""

    def __init__(self, input, label, chunk_scheme, num_chunk_types,
                 excluded_chunk_types=None):
        super(ChunkEvaluator, self).__init__("chunk_eval")
        self.num_infer_chunks = self.create_state(
            dtype="int64", shape=[1], suffix="num_infer_chunks")
        self.num_label_chunks = self.create_state(
            dtype="int64", shape=[1], suffix="num_label_chunks")
        self.num_correct_chunks = self.create_state(
            dtype="int64", shape=[1], suffix="num_correct_chunks")
        (precision, recall, f1_score, num_infer_chunks, num_label_chunks,
         num_correct_chunks) = layers.chunk_eval(
            input=input, label=label, chunk_scheme=chunk_scheme,
            num_chunk_types=num_chunk_types,
            excluded_chunk_types=excluded_chunk_types)
        layers.sums(input=[self.num_infer_chunks, num_infer_chunks],
                    out=self.num_infer_chunks)
        layers.sums(input=[self.num_label_chunks, num_label_chunks],
                    out=self.num_label_chunks)
        layers.sums(input=[self.num_correct_chunks, num_correct_chunks],
                    out=self.num_correct_chunks)
        self.metrics.extend([precision, recall, f1_score])

    def eval(self, executor, eval_program=None):
        ni, nl, nc = [float(np.ravel(v)[0]) for v in
                      self._fetch_states(executor, eval_program)]
        precision = nc / ni if ni else 0.0
        recall = nc / nl if nl else 0.0
        f1 = 2 * precision * recall / (precision + recall) if nc else 0.0
        return (np.array([precision], "float32"),
                np.array([recall], "float32"), np.array([f1], "float32"))


class EditDistance(Evaluator):
    """Accumulated average edit distance + instance error rate."""

    def __init__(self, input, label, ignored_tokens=None, **kwargs):
        super(EditDistance, self).__init__("edit_distance", **kwargs)
        self.total_distance = self.create_state(
            dtype="float32", shape=[1], suffix="total_distance")
        self.seq_num = self.create_state(dtype="int64", shape=[1],
                                         suffix="seq_num")
        self.instance_error = self.create_state(
            dtype="int64", shape=[1], suffix="instance_error")
        distances, seq_num = layers.edit_distance(
            input=input, label=label, ignored_tokens=ignored_tokens)
        zero = layers.fill_constant(shape=[1], value=0.0, dtype="float32")
        compare_result = layers.equal(distances, zero)
        compare_result_int = layers.cast(x=compare_result, dtype="int64")
        seq_right_count = layers.reduce_sum(compare_result_int)
        instance_error_count = layers.elementwise_sub(x=seq_num,
                                                      y=seq_right_count)
        total_distance = layers.reduce_sum(distances)
        layers.sums(input=[self.total_distance, total_distance],
                    out=self.total_distance)
        layers.sums(input=[self.seq_num, seq_num], out=self.seq_num)
        layers.sums(input=[self.instance_error, instance_error_count],
                    out=self.instance_error)
        self.metrics.append(total_distance)
        self.metrics.append(instance_error_count)

    def eval(self, executor, eval_program=None):
        total, seq_num, inst_err = [
            float(np.ravel(v)[0]) for v in
            self._fetch_states(executor, eval_program)]
        avg_distance = total / seq_num if seq_num else 0.0
        inst_err_rate = inst_err / seq_num if seq_num else 0.0
        return (np.array([avg_distance], "float32"),
                np.array([inst_err_rate], "float32"))


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
