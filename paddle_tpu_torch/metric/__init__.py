"""paddle.metric parity: Metric base + Accuracy/Precision/Recall/Auc.

ref: python/paddle/metric/metrics.py (2.0 API in the reference
snapshot) and fluid/metrics.py. Metrics accumulate on host numpy, as the
reference accumulates in python between executor runs.

A copy of ``paddle_tpu/metric/__init__.py``. ``_to_np`` reads a tensor
on the card with one device-to-host copy (the port's ``Tensor.numpy``);
``DetectionMAP`` builds its ops with the port's static builders, and the
``detection_map`` op is the port's (``ops/rcnn_ops.py``).
"""
from __future__ import annotations

import numpy as np


def _to_np(x):
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy())
    return np.asarray(x)


class Metric:
    """ref: python/paddle/metric/metrics.py Metric ABC."""

    def __init__(self, name=None):
        self._name = name or self.__class__.__name__.lower()

    def name(self):
        return self._name

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    # hapi hook: turn (pred, label) batch outputs into update() args
    def compute(self, pred, label, *args):
        return pred, label

    # 1.x fluid.metrics spelling (ref: fluid/metrics.py MetricBase.eval)
    def eval(self):
        return self.accumulate()

    def get_config(self):
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_")}


class Accuracy(Metric):
    """top-k accuracy (ref: metrics.py Accuracy)."""

    def __init__(self, topk=(1,), name="acc"):
        super().__init__(name)
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label, *args):
        pred = _to_np(pred)
        label = _to_np(label)
        idx = np.argsort(-pred, axis=-1)[..., :self.maxk]
        if label.ndim == pred.ndim:          # one-hot / [N, 1] index
            if label.shape[-1] == pred.shape[-1]:
                label = np.argmax(label, axis=-1)
            else:
                label = label[..., 0]
        correct = (idx == label[..., None])
        return correct

    def update(self, correct):
        correct = _to_np(correct)
        n = correct[..., 0].size
        for i, k in enumerate(self.topk):
            self.total[i] += correct[..., :k].any(-1).sum()
            self.count[i] += n
        acc = self.total / np.maximum(self.count, 1)
        return acc[0] if len(self.topk) == 1 else acc

    def accumulate(self):
        acc = self.total / np.maximum(self.count, 1)
        return float(acc[0]) if len(self.topk) == 1 else list(acc)

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """binary precision over 0.5-thresholded scores (ref: metrics.py)."""

    def __init__(self, name="precision"):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = (_to_np(preds).reshape(-1) > 0.5).astype(np.int64)
        labels = _to_np(labels).reshape(-1).astype(np.int64)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())
        return self.accumulate()

    def accumulate(self):
        denom = self.tp + self.fp
        return float(self.tp) / denom if denom else 0.0


class Recall(Metric):
    def __init__(self, name="recall"):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = (_to_np(preds).reshape(-1) > 0.5).astype(np.int64)
        labels = _to_np(labels).reshape(-1).astype(np.int64)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())
        return self.accumulate()

    def accumulate(self):
        denom = self.tp + self.fn
        return float(self.tp) / denom if denom else 0.0


class Auc(Metric):
    """ROC AUC via threshold histogram (ref: metrics.py Auc — same
    bucketed trapezoid estimate, distributable by summing the stats)."""

    def __init__(self, num_thresholds=4095, name="auc"):
        super().__init__(name)
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        preds = _to_np(preds)
        if preds.ndim == 2 and preds.shape[1] == 2:
            preds = preds[:, 1]
        preds = preds.reshape(-1)
        labels = _to_np(labels).reshape(-1)
        idx = np.clip((preds * self.num_thresholds).astype(np.int64), 0,
                      self.num_thresholds)
        np.add.at(self._stat_pos, idx[labels == 1], 1)
        np.add.at(self._stat_neg, idx[labels != 1], 1)
        return self.accumulate()

    def accumulate(self):
        tot_pos = tot_neg = 0.0
        auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = tot_pos + self._stat_pos[i]
            new_neg = tot_neg + self._stat_neg[i]
            auc += (new_pos + tot_pos) * self._stat_neg[i] / 2.0
            tot_pos, tot_neg = new_pos, new_neg
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        return float(auc / (tot_pos * tot_neg))


# ------------------------------------------------------ 1.x fluid.metrics
# (ref: python/paddle/fluid/metrics.py — MetricBase/CompositeMetric/
# ChunkEvaluator/EditDistance/DetectionMAP; update()+eval() spelling)
MetricBase = Metric


class CompositeMetric(Metric):
    """ref: fluid/metrics.py CompositeMetric — update fans out to every
    added metric; eval returns their results in add order."""

    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        if not isinstance(metric, Metric):
            raise TypeError("add_metric expects a Metric instance")
        self._metrics.append(metric)

    def reset(self):
        for m in self._metrics:
            m.reset()

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def accumulate(self):
        return [m.accumulate() for m in self._metrics]


class ChunkEvaluator(Metric):
    """ref: fluid/metrics.py:513 — accumulate chunk_eval counters and
    report (precision, recall, f1)."""

    def __init__(self, name=None):
        super().__init__(name or "chunk")
        self.reset()

    def reset(self):
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks,
               num_correct_chunks):
        def _scalar(v):
            a = _to_np(v)
            return int(a.reshape(-1)[0]) if hasattr(a, "reshape") \
                else int(a)

        self.num_infer_chunks += _scalar(num_infer_chunks)
        self.num_label_chunks += _scalar(num_label_chunks)
        self.num_correct_chunks += _scalar(num_correct_chunks)
        return self.accumulate()

    def accumulate(self):
        precision = (self.num_correct_chunks / self.num_infer_chunks
                     if self.num_infer_chunks else 0.0)
        recall = (self.num_correct_chunks / self.num_label_chunks
                  if self.num_label_chunks else 0.0)
        f1 = (2 * precision * recall / (precision + recall)
              if self.num_correct_chunks else 0.0)
        return precision, recall, f1


class EditDistance(Metric):
    """ref: fluid/metrics.py:611 — mean edit distance + wrong-instance
    ratio over accumulated batches."""

    def __init__(self, name=None):
        super().__init__(name or "edit_distance")
        self.reset()

    def reset(self):
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        d = _to_np(distances).reshape(-1).astype(np.float64)
        self.total_distance += float(d.sum())
        self.seq_num += int(seq_num)
        self.instance_error += int((d != 0).sum())
        return self.accumulate()

    def accumulate(self):
        if self.seq_num == 0:
            raise ValueError(
                "There is no data in EditDistance Metric. Please "
                "check layers.edit_distance output has been added to "
                "EditDistance.")
        avg = self.total_distance / self.seq_num
        ratio = self.instance_error / self.seq_num
        return avg, ratio


class DetectionMAP:
    """ref: fluid/metrics.py DetectionMAP — the GRAPH-BUILDING 1.x
    class: appends a detection_map op for the current batch's mAP plus
    persistable running-mean accumulators for the accumulated value.

    Design note (documented deviation): the reference accumulates raw
    per-class TP/FP statistics across batches inside the op's state
    tensors; here ``accum_map`` is the running MEAN of batch mAPs —
    identical when classes appear evenly across batches, and the raw-
    statistic path remains available eagerly via ops
    detection_map's own outputs."""

    def __init__(self, input, gt_label, gt_box, gt_difficult=None,
                 class_num=None, background_label=0,
                 overlap_threshold=0.5, evaluate_difficult=True,
                 ap_version="integral"):
        from ..nn import initializer as I
        from ..static import _new_tmp, _op, create_parameter, nn

        block = input.block
        gt_label = nn.cast(gt_label, out_dtype=gt_box.dtype or
                           "float32")
        parts = [gt_label]
        if gt_difficult is not None:
            parts.append(nn.cast(gt_difficult,
                                 out_dtype=gt_box.dtype or "float32"))
        parts.append(gt_box)
        label = nn.concat(parts, axis=1)
        outs = nn.detection_map(
            input, label, overlap_threshold=overlap_threshold,
            ap_type=ap_version,
            background_label=background_label,
            evaluate_difficult=evaluate_difficult,
            class_num=class_num or 0)
        self.cur_map = outs[0] if isinstance(outs, (tuple, list)) \
            else outs

        def _acc(prefix):
            v = create_parameter([1], "float32",
                                 default_initializer=I.Constant(0.0))
            v.desc.stop_gradient = True
            return v

        self._sum = _acc("map_sum")
        self._count = _acc("map_count")
        _op(block, "elementwise_add",
            {"X": [self._sum.name], "Y": [self.cur_map.name]},
            {"Out": [self._sum.name]}, {"axis": -1})
        one = _new_tmp(block, "map_one")
        _op(block, "fill_constant", {}, {"Out": [one.name]},
            {"shape": [1], "value": 1.0, "dtype": "float32"})
        _op(block, "elementwise_add",
            {"X": [self._count.name], "Y": [one.name]},
            {"Out": [self._count.name]}, {"axis": -1})
        self.accum_map = _new_tmp(block, "accum_map")
        _op(block, "elementwise_div",
            {"X": [self._sum.name], "Y": [self._count.name]},
            {"Out": [self.accum_map.name]}, {"axis": -1})

    def get_map_var(self):
        """ref: returns (cur_map, accum_map) program vars."""
        return self.cur_map, self.accum_map

    def reset(self, executor, reset_program=None):
        """Zero the accumulators (ref: DetectionMAP.reset — runs a
        small reset program through the executor)."""
        from ..core.program import Program
        from ..static import _op, program_guard
        prog = reset_program or Program()
        with program_guard(prog):
            blk = prog.global_block()
            for v in (self._sum, self._count):
                blk.create_var(v.name, shape=(1,), persistable=True)
                _op(blk, "fill_constant", {}, {"Out": [v.name]},
                    {"shape": [1], "value": 0.0, "dtype": "float32"})
        executor.run(prog)
