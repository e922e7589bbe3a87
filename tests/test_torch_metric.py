"""``paddle_tpu_torch.metric`` and ``average.WeightedAverage`` against the
JAX package's on the same seeded numpy arrays.

Both sides accumulate in numpy, so every value must be equal, not close;
the port is also fed torch tensors (its ``_to_np`` reads them). The
graph-building ``DetectionMAP`` runs through both static executors on
the same detections: the current and the accumulated mAP within 1e-6
(the ``detection_map`` op sums in another order in each package).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import average as javerage
from paddle_tpu import metric as jmetric
from paddle_tpu import static as jstatic

import paddle_tpu_torch as tpt
from paddle_tpu_torch import average as taverage
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core.enforce import InvalidArgumentError

MAP_RTOL = 1e-6


def _batches(seed, n=3, rows=16, classes=10):
    rs = np.random.RandomState(seed)
    return [(rs.rand(rows, classes).astype(np.float32),
             rs.randint(0, classes, (rows, 1)).astype(np.int64))
            for _ in range(n)]


def _feed(metric, args, tensors):
    """update(compute(*args)), the port's from torch tensors when asked;
    returns what update returned."""
    if tensors:
        args = [torch.from_numpy(np.asarray(a)) for a in args]
    state = metric.compute(*args)
    state = state if isinstance(state, tuple) else (state,)
    return metric.update(*state)


@pytest.mark.parametrize("tensors", [False, True], ids=["numpy", "torch"])
@pytest.mark.parametrize("topk", [(1,), (1, 5)], ids=["top1", "top1_5"])
def test_accuracy(topk, tensors):
    j, t = jmetric.Accuracy(topk=topk), tmetric.Accuracy(topk=topk)
    for pred, label in _batches(0):
        np.testing.assert_array_equal(_feed(t, (pred, label), tensors),
                                      _feed(j, (pred, label), False))
    assert t.accumulate() == j.accumulate()
    assert t.name() == j.name()
    t.reset()
    assert np.all(t.total == 0) and np.all(t.count == 0)


@pytest.mark.parametrize("tensors", [False, True], ids=["numpy", "torch"])
@pytest.mark.parametrize("name", ["Precision", "Recall", "Auc"])
def test_binary_metrics(name, tensors):
    """Precision and Recall over 0.5-thresholded scores; Auc at its 4095
    thresholds, fed [N, 2] scores (the positive column) and [N] ones."""
    j, t = getattr(jmetric, name)(), getattr(tmetric, name)()
    rs = np.random.RandomState(1)
    for i in range(3):
        preds = rs.rand(32, 2) if name == "Auc" and i else rs.rand(32)
        labels = rs.randint(0, 2, (32, 1)).astype(np.int64)
        assert _feed(t, (preds, labels), tensors) == \
            _feed(j, (preds, labels), False)
    if name == "Auc":
        assert t.num_thresholds == j.num_thresholds == 4095
        np.testing.assert_array_equal(t._stat_pos, j._stat_pos)
    assert t.accumulate() == j.accumulate()


def test_composite_metric():
    j, t = jmetric.CompositeMetric(), tmetric.CompositeMetric()
    for pkg, m in ((jmetric, j), (tmetric, t)):
        m.add_metric(pkg.Precision())
        m.add_metric(pkg.Recall())
    rs = np.random.RandomState(2)
    for _ in range(2):
        preds, labels = rs.rand(20), rs.randint(0, 2, 20)
        j.update(preds, labels)
        t.update(preds, labels)
    assert t.accumulate() == j.accumulate() == t.eval()
    with pytest.raises(TypeError):
        t.add_metric(object())


@pytest.mark.parametrize("tensors", [False, True], ids=["numpy", "torch"])
def test_chunk_evaluator(tensors):
    j, t = jmetric.ChunkEvaluator(), tmetric.ChunkEvaluator()
    rs = np.random.RandomState(3)
    for _ in range(4):
        infer, label = rs.randint(1, 20, 2)
        counts = [np.array([infer]), np.array([label]),
                  np.array([rs.randint(0, min(infer, label) + 1)])]
        got = t.update(*[torch.from_numpy(c) for c in counts]
                       if tensors else counts)
        assert got == j.update(*counts)
    assert t.accumulate() == j.accumulate()
    assert t.get_config() == j.get_config()


@pytest.mark.parametrize("tensors", [False, True], ids=["numpy", "torch"])
def test_edit_distance(tensors):
    j, t = jmetric.EditDistance(), tmetric.EditDistance()
    with pytest.raises(ValueError):
        t.accumulate()
    rs = np.random.RandomState(4)
    for _ in range(3):
        d = rs.randint(0, 4, (8, 1)).astype(np.float32)
        got = t.update(torch.from_numpy(d) if tensors else d, 8)
        assert got == j.update(d, 8)
    assert t.eval() == j.eval()
    assert tmetric.MetricBase is tmetric.Metric


@pytest.mark.parametrize("kind", ["scalar", "array"])
def test_weighted_average(kind):
    j, t = javerage.WeightedAverage(), taverage.WeightedAverage()
    rs = np.random.RandomState(5)
    for _ in range(4):
        value = (float(rs.rand()) if kind == "scalar"
                 else rs.rand(3).astype(np.float32))
        weight = int(rs.randint(1, 5))
        j.add(value, weight)
        t.add(value, weight)
    np.testing.assert_array_equal(t.eval(), j.eval())
    t.reset()
    with pytest.raises(InvalidArgumentError, match="no data"):
        t.eval()
    with pytest.raises(InvalidArgumentError, match="number or ndarray"):
        t.add([1.0, 2.0], 1)


def _detection_map(pt, static, metric, feeds):
    """DetectionMAP on 5 detections of 3 classes against 4 ground-truth
    boxes, run twice, reset, and run once more: (cur, accum) of each
    run."""
    prog, startup = pt.Program(), pt.Program()
    with static.program_guard(prog, startup):
        det = static.data("det", [5, 6], "float32")
        gl = static.data("gl", [4, 1], "float32")
        gb = static.data("gb", [4, 4], "float32")
        m = metric.DetectionMAP(det, gl, gb, class_num=3)
        cur, accum = m.get_map_var()
    exe, scope = pt.Executor(), pt.Scope()
    out = []
    with pt.scope_guard(scope):
        exe.run(startup)
        for i in range(3):
            if i == 2:
                m.reset(exe)
            out.append([float(np.asarray(v).reshape(-1)[0]) for v in
                        exe.run(prog, feed=feeds, fetch_list=[cur, accum])])
    return out


def _detections(seed):
    """4 ground-truth boxes of classes 1 and 2 (0 is the background) and
    5 detections: three of them near a box of its class, one near a box
    but of the other class, one stray; seeded scores."""
    rs = np.random.RandomState(seed)
    lo = rs.rand(4, 2) * 5
    gb = np.hstack([lo, lo + 2 + rs.rand(4, 2) * 3])
    gl = np.array([[1], [2], [1], [2]])
    near = gb[[0, 1, 2, 3]] + rs.randn(4, 4) * 0.2
    boxes = np.vstack([near, [[8, 8, 9, 9]]])
    labels = np.array([[1], [2], [1], [1], [2]])
    det = np.hstack([labels, rs.rand(5, 1), boxes])
    return {"det": det.astype(np.float32), "gl": gl.astype(np.float32),
            "gb": gb.astype(np.float32)}


def test_detection_map_through_both_executors():
    feeds = _detections(0)
    want = _detection_map(jpt, jstatic, jmetric, feeds)
    assert 0 < want[0][0] < 1
    tpt.set_device("cpu")
    got = _detection_map(tpt, tstatic, tmetric, feeds)
    np.testing.assert_allclose(got, want, rtol=MAP_RTOL, atol=0)
    # the same batch twice: the running mean equals the batch's value
    assert got[1][1] == pytest.approx(got[1][0], rel=MAP_RTOL)
    assert got[2][1] == pytest.approx(got[2][0], rel=MAP_RTOL)
