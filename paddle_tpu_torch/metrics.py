"""Host-side streaming metrics.

Parity: python/paddle/fluid/metrics.py + evaluator.py (Accuracy, ChunkEvaluator,
EditDistance, DetectionMAP are graph-side; these accumulate across batches),
and the JAX package's metrics module: plain numpy on fetched values, copied
here so that the port imports none of it.
"""
import numpy as np

__all__ = ["MetricBase", "CompositeMetric", "Accuracy", "ChunkEvaluator",
           "EditDistance", "Auc"]


class MetricBase(object):
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        for attr, value in self.__dict__.items():
            if attr.startswith("_"):
                continue
            if isinstance(value, (int, float)):
                setattr(self, attr, 0)
            elif isinstance(value, np.ndarray):
                setattr(self, attr, np.zeros_like(value))

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super(CompositeMetric, self).__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def update(self, *args, **kwargs):
        for m in self._metrics:
            m.update(*args, **kwargs)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super(Accuracy, self).__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight=1):
        self.value += float(np.asarray(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("no batches accumulated")
        return self.value / self.weight


class ChunkEvaluator(MetricBase):
    def __init__(self, name=None):
        super(ChunkEvaluator, self).__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer_chunks += int(np.asarray(num_infer_chunks).sum())
        self.num_label_chunks += int(np.asarray(num_label_chunks).sum())
        self.num_correct_chunks += int(np.asarray(num_correct_chunks).sum())

    def eval(self):
        precision = (self.num_correct_chunks / self.num_infer_chunks
                     if self.num_infer_chunks else 0)
        recall = (self.num_correct_chunks / self.num_label_chunks
                  if self.num_label_chunks else 0)
        f1 = (2 * precision * recall / (precision + recall)
              if self.num_correct_chunks else 0)
        return precision, recall, f1


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super(EditDistance, self).__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        d = np.asarray(distances)
        self.total_distance += float(d.sum())
        self.seq_num += int(seq_num)
        self.instance_error += int((d > 0).sum())

    def eval(self):
        avg = self.total_distance / max(self.seq_num, 1)
        err_rate = self.instance_error / max(self.seq_num, 1)
        return avg, err_rate


class Auc(MetricBase):
    def __init__(self, name=None, num_thresholds=200):
        super(Auc, self).__init__(name)
        self._num_thresholds = num_thresholds
        self.tp = np.zeros(num_thresholds, dtype=np.int64)
        self.fp = np.zeros(num_thresholds, dtype=np.int64)

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1)
        pos_score = preds[:, 1] if preds.ndim == 2 and preds.shape[1] == 2 \
            else preds.reshape(-1)
        bucket = np.clip((pos_score * self._num_thresholds).astype(int),
                         0, self._num_thresholds - 1)
        for b, l in zip(bucket, labels):
            if l > 0:
                self.tp[b] += 1
            else:
                self.fp[b] += 1

    def eval(self):
        tp_c = np.cumsum(self.tp[::-1])[::-1].astype(float)
        fp_c = np.cumsum(self.fp[::-1])[::-1].astype(float)
        tpr = tp_c / max(tp_c[0], 1)
        fpr = fp_c / max(fp_c[0], 1)
        return float(-np.trapezoid(tpr, fpr))


class DetectionMAP(MetricBase):
    """Mean average precision over accumulated detections.

    Parity: paddle/fluid/operators/detection_map_op.h semantics (score-sorted
    greedy TP/FP assignment at an IoU threshold, 11point or integral AP),
    computed host-side from fetched numpy results instead of an in-graph
    CPU-only accumulator op.

    update(nmsed_out [B, K, 6] (-1 padded), nmsed_lens [B],
           gt_boxes: list of [Gi, 4], gt_labels: list of [Gi]) per batch.
    """

    def __init__(self, overlap_threshold=0.5, ap_version="integral",
                 evaluate_difficult=True, background_label=None,
                 name=None):
        super(DetectionMAP, self).__init__(name)
        self.overlap_threshold = overlap_threshold
        self.ap_version = ap_version
        self.evaluate_difficult = evaluate_difficult
        self.background_label = background_label
        self.reset()

    def reset(self):
        self._dets = []   # (class, score, box, image_id)
        self._gts = []    # (class, box, image_id, difficult)
        self._img = 0

    def update(self, nmsed_out, nmsed_lens, gt_boxes, gt_labels,
               gt_difficult=None):
        nmsed_out = np.asarray(nmsed_out)
        nmsed_lens = np.ravel(np.asarray(nmsed_lens))
        for i in range(nmsed_out.shape[0]):
            img = self._img + i
            for j in range(int(nmsed_lens[i])):
                lab, score = nmsed_out[i, j, 0], nmsed_out[i, j, 1]
                self._dets.append((int(lab), float(score),
                                   nmsed_out[i, j, 2:6].copy(), img))
            gb = np.asarray(gt_boxes[i]).reshape(-1, 4)
            gl = np.ravel(np.asarray(gt_labels[i]))
            gd = np.ravel(np.asarray(gt_difficult[i])) \
                if gt_difficult is not None else np.zeros(len(gl))
            for g in range(gb.shape[0]):
                self._gts.append((int(gl[g]), gb[g].copy(), img,
                                  bool(gd[g])))
        self._img += nmsed_out.shape[0]

    @staticmethod
    def _iou(a, b):
        iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
        ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
        inter = iw * ih
        ua = max(0.0, a[2] - a[0]) * max(0.0, a[3] - a[1]) + \
            max(0.0, b[2] - b[0]) * max(0.0, b[3] - b[1]) - inter
        return inter / ua if ua > 0 else 0.0

    def _ap(self, recall, precision):
        if self.ap_version == "11point":
            ap = 0.0
            for t in np.arange(0.0, 1.1, 0.1):
                p = np.max(precision[recall >= t]) if \
                    np.any(recall >= t) else 0.0
                ap += p / 11.0
            return ap
        # integral
        ap = 0.0
        prev_r = 0.0
        for r, p in zip(recall, precision):
            ap += p * (r - prev_r)
            prev_r = r
        return ap

    def eval(self):
        classes = sorted({c for c, _, _, _ in self._gts
                          if c != self.background_label})
        aps = []
        for cls in classes:
            gts = [(b, i, d) for c, b, i, d in self._gts if c == cls]
            # difficult gts don't count as positives when excluded
            npos = sum(1 for _, _, d in gts
                       if self.evaluate_difficult or not d)
            dets = sorted((d for d in self._dets if d[0] == cls),
                          key=lambda d: -d[1])
            used = set()
            tp = np.zeros(len(dets))
            fp = np.zeros(len(dets))
            for k, (_, score, box, img) in enumerate(dets):
                # reference protocol (detection_map_op.h / VOC): argmax over
                # ALL gts of the image; a detection whose best gt is already
                # claimed counts FP (no re-matching to the second-best gt)
                best, best_g = 0.0, -1
                for gi, (gb, gimg, _) in enumerate(gts):
                    if gimg != img:
                        continue
                    ov = self._iou(box, gb)
                    if ov > best:
                        best, best_g = ov, gi
                if best >= self.overlap_threshold and best_g >= 0:
                    if not self.evaluate_difficult and gts[best_g][2]:
                        continue  # matched a difficult gt: neither TP nor FP
                    if best_g not in used:
                        tp[k] = 1
                        used.add(best_g)
                    else:
                        fp[k] = 1
                else:
                    fp[k] = 1
            if npos == 0:
                continue
            tp_c = np.cumsum(tp)
            fp_c = np.cumsum(fp)
            recall = tp_c / npos
            precision = tp_c / np.maximum(tp_c + fp_c, 1e-9)
            aps.append(self._ap(recall, precision))
        return float(np.mean(aps)) if aps else 0.0
