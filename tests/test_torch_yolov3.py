"""The port's YOLOv3 (``paddle_tpu_torch/vision/detection_models.py``)
against ``paddle_tpu.vision.detection_models``: the tiny model of
``tests/test_yolov3.py`` (``yolov3(num_classes=4, keep_top_k=20,
nms_top_k=50)``, full DarkNet-53 depth and widths), eval(), 64 px, batch
2 of uniform images from numpy with a seed. The JAX model draws the
weights; they and its BN buffers carry across by structured name.

Two sets of BN statistics, loaded into both packages:
- "bench": the initial ones (mean 0, variance 1), as bench.py's seed-0
  model has them. The activations grow through the 75 convolutions
  (heads up to 8.2e3 here), the heads saturate, and every kept row
  scores exactly 1.0 on boxes clipped to the image edges: tie order
  alone decides ``predict``'s output.
- "calibrated": each BN's running statistics set to the batch statistics
  of its input on a seeded calibration batch of 8 other images
  (``chip_smoke.calibrated_state``, computed once on the port, written
  to one numpy state dict). On the 2 images of the test, BN statistics
  of the test batch itself would be ill-conditioned (the stride-32 BNs
  see 8 values a channel, and a channel of near-equal values turns the
  two packages' conv rounding into 3e-4 of a head). Heads then lie
  within 6.2 of 0, scores are graded (at most 0.94, 2,016 distinct), and
  ``predict``'s NMS has real suppressions to make: of the 9,800 pairs of
  valid candidates it compares, 447 lie above the 0.45 IoU threshold and
  15 within 1e-3 of it; 138 and 140 candidates are kept, and 20 rows
  survive per image (keep_top_k). ``test_calibrated_case_is_real``
  counts these.

Tolerances, each beside what it reads on this CPU (bench / calibrated):
- heads: absolute error over the head's largest magnitude 1e-4 (reads
  3.3e-6 / 2.2e-5: fp32 convolutions summed in other orders);
- decoded boxes (pixels) atol 5e-2 and scores atol 1e-3 (read 1.4e-2
  and 3.1e-4 / 2.0e-3 and 1.7e-5). At the bench's statistics a logit
  near 0 carries the absolute rounding of sums of size 8,000 (0.027),
  which sigmoid and exp pass on;
- predict: counts and labels exact, and on the bench's statistics the
  score column too (all 1.0); rows atol 1e-2 (read 0 / 1.1e-3).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.vision import yolov3 as jax_yolov3

import chip_smoke
import paddle_tpu_torch as tpt
from paddle_tpu_torch.convert import load_state_dict
from paddle_tpu_torch.core.enforce import UnavailableError
from paddle_tpu_torch.dygraph import no_grad
from paddle_tpu_torch.ops import detection_ops
from paddle_tpu_torch.vision import yolov3

TINY = dict(num_classes=4, keep_top_k=20, nms_top_k=50)
HEAD_TOL = 1e-4
BOX_ATOL = 5e-2
SCORE_ATOL = 1e-3
DET_ATOL = 1e-2
VARIANTS = ("bench", "calibrated")


def _np(v):
    return np.asarray(v._jax_value())


@pytest.fixture(scope="module")
def run():
    """Both models and both packages' outputs for each BN variant."""
    jpt.seed(0)
    jm = jax_yolov3(**TINY)
    jm.eval()
    bench = {k: _np(v) for k, v in jm.state_dict().items()}
    tpt.set_device("cpu")
    pm = load_state_dict(yolov3(**TINY), bench)
    x = np.random.RandomState(0).rand(2, 3, 64, 64).astype(np.float32)
    img_size = np.array([[64, 64], [64, 64]], np.int32)
    calib = np.random.RandomState(1).rand(8, 3, 64, 64).astype(np.float32)
    states = {"bench": bench,
              "calibrated": chip_smoke.calibrated_state(
                  pm, torch.from_numpy(calib))}
    out = {"state": states, "port_model": pm}
    for name in VARIANTS:
        assert not jm.set_state_dict(states[name])
        load_state_dict(pm, states[name])
        xj, sj = jpt.to_tensor(x), jpt.to_tensor(img_size)
        heads = jm(xj)
        boxes, scores = jm.decode(heads, sj)
        dets, num = jm.predict(xj, sj)
        want = [[_np(h) for h in heads], _np(boxes), _np(scores), _np(dets),
                _np(num)]
        with no_grad():
            xt, st = torch.from_numpy(x), torch.from_numpy(img_size)
            heads = pm(xt)
            boxes, scores = pm.decode(heads, st)
            dets, num = pm.predict(xt, st)
        got = [[h.numpy() for h in heads], boxes.numpy(), scores.numpy(),
               dets.numpy(), num.numpy()]
        out[name] = (got, want)
    return out


def test_structured_names_match(run):
    names = set(run["state"]["bench"])
    assert names == set(run["port_model"].state_dict())
    assert len(names) == 366            # 75 convs, 3 head biases, 72 BNs x 4
    assert not any(n.split(".")[0] in ("stages", "blocks", "heads", "routes")
                   or ".stages." in n for n in names)


@pytest.mark.parametrize("variant", VARIANTS)
def test_heads(run, variant):
    got, want = run[variant]
    for g, w in zip(got[0], want[0]):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= HEAD_TOL * np.abs(w).max()


@pytest.mark.parametrize("variant", VARIANTS)
def test_decode(run, variant):
    got, want = run[variant]
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=BOX_ATOL)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=SCORE_ATOL)


@pytest.mark.parametrize("variant", VARIANTS)
def test_predict(run, variant):
    got, want = run[variant]
    dets, num = got[3:]
    assert dets.shape == (2, TINY["keep_top_k"], 6)
    np.testing.assert_array_equal(num, want[4])
    cols = 2 if variant == "bench" else 1      # label (and score 1.0)
    np.testing.assert_array_equal(dets[..., :cols], want[3][..., :cols])
    np.testing.assert_allclose(dets, want[3], rtol=0, atol=DET_ATOL)
    valid = dets[..., 0] >= 0
    assert (valid.sum(-1) == num).all()
    if variant == "bench":              # saturated: every kept score is 1.0
        assert (dets[valid][:, 1] == 1.0).all()


def test_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """With no device asked for, the model goes to ``cuda``; with no card
    (this CPU) it raises rather than fall back to the CPU."""
    import paddle_tpu_torch.device as device
    monkeypatch.setattr(device, "_device", None)
    if torch.cuda.is_available():
        assert device.get_device().type == "cuda"
        return
    with pytest.raises(UnavailableError):
        yolov3(**TINY)


def test_calibrated_case_is_real(run):
    """The calibrated heads give graded scores, and predict's NMS has
    suppressions to make: pairs of valid candidates above the threshold,
    and a few within 1e-3 of it (so a rounding of the IoU there would
    show)."""
    got, _ = run["calibrated"]
    boxes, scores = (torch.from_numpy(a) for a in got[1:3])
    model = run["port_model"]
    sc, _, cand, k = detection_ops._per_class_candidates(
        boxes, scores.transpose(1, 2), -1, model.nms_top_k)
    iou = detection_ops._pairwise_iou(cand, cand, False)
    valid = sc > model.conf_thresh
    pairs = valid[..., :, None] & valid[..., None, :] & torch.ones(
        k, k, dtype=torch.bool).triu(1)
    above = int(((iou > model.nms_thresh) & pairs).sum())
    near = int((((iou - model.nms_thresh).abs() < 1e-3) & pairs).sum())
    assert scores.max() < 0.95 and len(np.unique(got[2])) > 1000
    assert (above, near, int(pairs.sum())) == (447, 15, 9800)
    keep = detection_ops._greedy_keep(iou.reshape(-1, k, k),
                                      valid.reshape(-1, k),
                                      model.nms_thresh, 1.0)
    assert keep.reshape(2, -1).sum(-1).tolist() == [138, 140]
