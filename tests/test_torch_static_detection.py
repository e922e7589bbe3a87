"""The fluid detection builders the two-stage detection slice brought to
the port: the 12 of ``static/detection.py``, the detection entries of the
simple-layer tables (the RoI pools, ``target_assign``, ``detection_map``,
``locality_aware_nms``, ``roi_perspective_transform``,
``collect_fpn_proposals``), ``deformable_roi_pooling``, the detection
composites (``detection_output``, the proposal, target-assign and FPN
builders, batched target assignment with its index offsets),
``multi_box_head`` and ``ssd_loss`` with ``zeros_like`` / ``ones_like``.

Each builder is called by both packages on the same data vars: the two
programs' JSON is the same (op types, slots, attrs, and every output's
shape and dtype, unknown where the JAX package's is: a host-side op's
outputs have no shape in either). Then programs run in both executors
from the same startup values on the same feeds: the SSD head and loss to
a finite loss equal to the JAX package's (rtol 1e-5), the two-image RPN
target assignment with its offsets into the batch's rows, and the
proposal path (``generate_proposals``, ``generate_proposal_labels``,
``generate_mask_labels``, ``distribute_fpn_proposals``): indices equal,
floats at rtol 1e-5 (``rcnn_cases.DECODE`` where a decode's ``exp``
enters).
"""
import types

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu.static as jstatic
import paddle_tpu.static.detection as jdet

import paddle_tpu_torch as tpt
import paddle_tpu_torch.static as pstatic
import paddle_tpu_torch.static.detection as pdet
from paddle_tpu_torch.testing import rcnn_cases as rc
from test_torch_program import _first_difference

JAX = types.SimpleNamespace(pt=jpt, static=jstatic, det=jdet)
PORT = types.SimpleNamespace(pt=tpt, static=pstatic, det=pdet)


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")


def _data(st, name, shape, dtype="float32"):
    return st.data(name, shape, dtype)


def _feature(st):
    return _data(st, "feat", [2, 8, 4, 5]), _data(st, "img", [2, 3, 64, 80])


# builder name -> fn(api) building its ops in the current program
def b_yolo_box(a):
    x = _data(a.static, "x", [2, 3 * 7, 4, 4])
    size = _data(a.static, "size", [2, 2], "int32")
    return a.det.yolo_box(x, size, [10, 13, 16, 30, 33, 23], 2, 0.01, 32)


def b_prior_box(a):
    feat, img = _feature(a.static)
    return a.det.prior_box(feat, img, [16.0], [32.0], [1.0, 2.0],
                           flip=True, clip=True)


def b_density_prior_box(a):
    feat, img = _feature(a.static)
    return a.det.density_prior_box(feat, img, [2, 1], [16.0, 32.0], [1.0])


def b_anchor_generator(a):
    feat, _ = _feature(a.static)
    return a.det.anchor_generator(feat, [32.0, 64.0], [0.5, 1.0, 2.0],
                                  variance=[1.0, 1.0, 1.0, 1.0])


def b_box_coder(a):
    prior = _data(a.static, "prior", [6, 4])
    pvar = _data(a.static, "pvar", [6, 4])
    tgt = _data(a.static, "tgt", [3, 6, 4])
    return (a.det.box_coder(prior, pvar, tgt, "decode_center_size"),
            a.det.box_coder(prior, [0.1, 0.1, 0.2, 0.2],
                            _data(a.static, "gt", [3, 4])))


def b_iou_similarity(a):
    return a.det.iou_similarity(_data(a.static, "x", [3, 4]),
                                _data(a.static, "y", [5, 4]))


def b_box_clip(a):
    return a.det.box_clip(_data(a.static, "boxes", [2, 5, 4]),
                          _data(a.static, "im_info", [2, 3]))


def b_bipartite_match(a):
    return a.det.bipartite_match(_data(a.static, "dist", [3, 6]),
                                 "per_prediction", 0.5)


def b_roi_align(a):
    feat, _ = _feature(a.static)
    return a.det.roi_align(feat, _data(a.static, "rois", [5, 4]), 3, 3,
                           0.25, 2)


def b_multiclass_nms(a):
    return a.det.multiclass_nms(_data(a.static, "bb", [2, 6, 4]),
                                _data(a.static, "sc", [2, 3, 6]), 0.1, 6, 8,
                                return_index=True)


def b_matrix_nms(a):
    return a.det.matrix_nms(_data(a.static, "bb", [2, 6, 4]),
                            _data(a.static, "sc", [2, 3, 6]), 0.1, 0.2, 6, 8)


def b_roi_pools(a):
    nn = a.static.nn
    feat, _ = _feature(a.static)
    rois = _data(a.static, "rois", [5, 4])
    return (nn.roi_pool(feat, rois, pooled_height=2, pooled_width=2),
            nn.prroi_pool(feat, rois, pooled_height=2, pooled_width=2),
            nn.psroi_pool(feat, rois, output_channels=2, spatial_scale=0.5,
                          pooled_height=2, pooled_width=2),
            nn.deformable_roi_pooling(feat, rois, None, no_trans=True,
                                      pooled_height=2, pooled_width=2,
                                      position_sensitive=True))


def b_detection_tables(a):
    nn, st = a.static.nn, a.static
    x = _data(st, "x", [6, 4])
    match = _data(st, "match", [2, 8], "int32")
    det = _data(st, "det", [5, 6])
    label = _data(st, "label", [3, 6])
    quads = _data(st, "quads", [3, 8])
    feat, _ = _feature(st)
    return (nn.target_assign(x, match, mismatch_value=-1.0),
            nn.detection_map(det, label, overlap_threshold=0.3),
            nn.locality_aware_nms(_data(st, "bb", [1, 8, 4]),
                                  _data(st, "sc", [1, 1, 8]),
                                  nms_threshold=0.3),
            nn.roi_perspective_transform(feat, quads,
                                         transformed_height=4,
                                         transformed_width=5),
            nn.collect_fpn_proposals([_data(st, "r0", [4, 4]),
                                      _data(st, "r1", [3, 4])],
                                     [_data(st, "s0", [4]),
                                      _data(st, "s1", [3])],
                                     post_nms_topN=5))


def b_detection_output(a):
    st = a.static
    return st.nn.detection_output(
        _data(st, "loc", [1, 4, 4]), _data(st, "sc", [1, 2, 4]),
        _data(st, "prior", [4, 4]), _data(st, "pvar", [4, 4]),
        score_threshold=0.2, nms_threshold=0.4)


def _rpn_inputs(a, batch):
    st = a.static
    feat = _data(st, "feat", [batch, 8, 4, 5])
    anchors, var = a.det.anchor_generator(
        feat, [16.0, 32.0, 48.0], [1.0], variance=[1.0] * 4)
    return (feat, anchors, var, _data(st, "bbox_pred", [batch, 12, 4, 5]),
            _data(st, "cls", [batch, 3, 4, 5]),
            _data(st, "gt", [batch, 3, 4] if batch > 1 else [3, 4]),
            _data(st, "crowd", [batch, 3, 1] if batch > 1 else [3, 1],
                  "int32"),
            _data(st, "im_info", [batch, 3]))


def b_rpn_target_assign(a):
    _, anchors, var, bbox, cls, gt, crowd, info = _rpn_inputs(a, 1)
    return a.static.nn.rpn_target_assign(
        bbox, cls, anchors, var, gt, crowd, info,
        rpn_batch_size_per_im=16, rpn_positive_overlap=0.5)


def b_rpn_target_assign_batched(a):
    _, anchors, var, bbox, cls, gt, crowd, info = _rpn_inputs(a, 2)
    return a.static.nn.rpn_target_assign(
        bbox, cls, anchors, var, gt, crowd, info,
        rpn_batch_size_per_im=16, rpn_positive_overlap=0.5)


def b_retinanet_target_assign(a):
    st = a.static
    _, anchors, var, bbox, cls, gt, crowd, info = _rpn_inputs(a, 2)
    labels = _data(st, "gt_labels", [2, 3, 1], "int32")
    return st.nn.retinanet_target_assign(bbox, cls, anchors, var, gt,
                                         labels, crowd, info, num_classes=1)


def b_proposals(a):
    st, nn = a.static, a.static.nn
    _, anchors, var, bbox, cls, gt, crowd, info = _rpn_inputs(a, 1)
    rois, probs, num = nn.generate_proposals(
        nn.sigmoid(cls), bbox, info, anchors, var, pre_nms_top_n=40,
        post_nms_top_n=12, return_rois_num=True)
    labels = nn.generate_proposal_labels(
        rois, _data(st, "gt_cls", [3], "int32"), crowd, gt, info,
        batch_size_per_im=16, class_nums=5)
    masks = nn.generate_mask_labels(info, _data(st, "gt_cls2", [2], "int32"),
                                    crowd, _data(st, "segms", [2, 12]),
                                    labels[0], labels[1], 5, 8)
    multi, restore = nn.distribute_fpn_proposals(rois, 2, 5, 4, 224)
    return (rois, probs, num) + tuple(labels) + tuple(masks) + \
        tuple(multi) + (restore,)


def b_box_decoder_and_assign(a):
    st = a.static
    return st.nn.box_decoder_and_assign(
        _data(st, "prior", [6, 4]), _data(st, "pvar", [6, 4]),
        _data(st, "tgt", [6, 12]), _data(st, "score", [6, 3]), 4.135)


def b_retinanet_detection_output(a):
    st = a.static
    return st.nn.retinanet_detection_output(
        [_data(st, "b0", [1, 12, 4]), _data(st, "b1", [1, 4, 4])],
        [_data(st, "s0", [1, 12, 3]), _data(st, "s1", [1, 4, 3])],
        [_data(st, "a0", [12, 4]), _data(st, "a1", [4, 4])],
        _data(st, "im_info", [1, 3]), score_threshold=0.3)


def b_zeros_ones_like(a):
    x = _data(a.static, "x", [3, 4])
    return a.static.nn.zeros_like(x), a.static.nn.ones_like(x)


def _ssd(a):
    st, nn = a.static, a.static.nn
    img = st.data("mb_img", [1, 3, 32, 32], "float32")
    f1 = st.data("mb_f1", [1, 8, 4, 4], "float32")
    f2 = st.data("mb_f2", [1, 8, 2, 2], "float32")
    locs, confs, boxes, pvars = nn.multi_box_head(
        [f1, f2], img, base_size=32, num_classes=3,
        aspect_ratios=[[1.0, 2.0], [2.0]], min_sizes=[8.0, 16.0],
        max_sizes=[16.0, 24.0], flip=True)
    gt_box = st.data("mb_gt", [1, 2, 4], "float32")
    gt_lab = st.data("mb_gl", [1, 2, 1], "float32")
    loss = nn.ssd_loss(locs, confs, gt_box, gt_lab, boxes, pvars)
    return loss, locs, confs, boxes, pvars


def b_ssd(a):
    return _ssd(a)


BUILDERS = {n[2:]: f for n, f in dict(globals()).items()
            if n.startswith("b_") and callable(f)}


def _build(api, fn):
    main, startup = api.pt.Program(), api.pt.Program()
    with api.static.program_guard(main, startup):
        outs = fn(api)
    return main, startup, outs


def _flat(outs):
    if isinstance(outs, (tuple, list)):
        return [v for o in outs for v in _flat(o)]
    return [outs]


def _x64_as_x32(text):
    """The JAX package's program under the tests' x64 mode: a Python
    float against an integer tensor (``ssd_loss``'s ``clip`` of the match
    indices) promotes to float64 there, to float32 in the JAX package's
    own runtime and in the port."""
    return text.replace('"float64"', '"float32"')


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_writes_the_reference_program(name):
    jmain, jstart, jouts = _build(JAX, BUILDERS[name])
    pmain, pstart, pouts = _build(PORT, BUILDERS[name])
    want, got = _x64_as_x32(jmain.to_json()), pmain.to_json()
    assert got == want, _first_difference(got, want)
    assert pstart.to_json() == jstart.to_json()
    jflat, pflat = _flat(jouts), _flat(pouts)
    assert len(pflat) == len(jflat)
    for j, p in zip(jflat, pflat):
        assert p.name == j.name and p.shape == j.shape, (p.name, j.name)


def _run_both(fn, feed, fetch_of):
    """Build with both packages, run the JAX startup, carry its values
    into the port by name, run the main program in both executors."""
    jmain, jstart, jouts = _build(JAX, fn)
    pmain, pstart, pouts = _build(PORT, fn)
    jscope, pscope = jpt.Scope(), tpt.Scope()
    jexe, pexe = jpt.Executor(), tpt.Executor("cpu")
    with jpt.scope_guard(jscope):
        jexe.run(jstart, feed={}, fetch_list=[], scope=jscope)
    for n in jstart.global_block().vars:
        pscope.var(n).set(tpt.TpuTensor(np.asarray(
            jscope.find_var(n).get().value)))
    names = [v.name for v in fetch_of(jouts)]
    want = jexe.run(jmain, feed=feed, fetch_list=names, scope=jscope)
    got = pexe.run(pmain, feed=feed, fetch_list=names, scope=pscope)
    return names, [np.asarray(v) for v in got], [np.asarray(v) for v in want]


def _assert_all(names, got, want, rtol=1e-5, atol=1e-6):
    for n, g, w in zip(names, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (n, g.shape,
                                                           w.shape)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=n)
        else:
            np.testing.assert_array_equal(g, w, err_msg=n)


def test_ssd_loss_through_multi_box_head_matches_jax():
    """SSD head and loss (two feature maps, the prior count from the
    prior_box op's own ratio expansion): the loss, the head's outputs and
    the priors equal the JAX package's from the same weights, and the
    loss is finite and positive."""
    rs = np.random.RandomState(0)
    feed = {"mb_img": rs.randn(1, 3, 32, 32).astype(np.float32),
            "mb_f1": rs.randn(1, 8, 4, 4).astype(np.float32),
            "mb_f2": rs.randn(1, 8, 2, 2).astype(np.float32),
            "mb_gt": np.array([[[0.1, 0.1, 0.4, 0.4],
                                [0.5, 0.5, 0.9, 0.9]]], np.float32),
            "mb_gl": np.array([[[1.0], [2.0]]], np.float32)}
    names, got, want = _run_both(_ssd, feed, _flat)
    _assert_all(names, got, want)
    assert got[0].shape == (1, 1) and np.isfinite(got[0]).all() and \
        got[0].item() > 0
    assert got[1].shape[1] == got[3].shape[0] == 4 * 4 * 4 + 2 * 2 * 4


def _rpn_feed(batch, seed=0):
    rs = np.random.RandomState(seed)
    gt = np.stack([rc.boxes(seed + i, 3, 80, 64, 12, 40)
                   for i in range(batch)])
    return {"feat": rs.randn(batch, 8, 4, 5).astype(np.float32),
            "bbox_pred": rs.randn(batch, 12, 4, 5).astype(np.float32),
            "cls": rs.randn(batch, 3, 4, 5).astype(np.float32),
            "gt": gt if batch > 1 else gt[0],
            "crowd": np.zeros((batch, 3, 1) if batch > 1 else (3, 1),
                              np.int32),
            "im_info": np.tile(np.asarray([[64, 80, 1]], np.float32),
                               (batch, 1))}


def _seeded(fn, seed):
    """fn, with every sampling op's seed attr set after it is built."""
    def build(api):
        outs = fn(api)
        block = api.pt.default_main_program().global_block()
        for op in block.ops:
            if op.type in ("rpn_target_assign", "generate_proposal_labels"):
                op.attrs["seed"] = seed
        return outs
    return build


def test_batched_rpn_target_assign_runs_as_the_reference():
    """Two images through ``_target_assign_batched``: each image's op
    samples from its own gt, and the second image's indices are offset by
    the anchor count into the batch's rows; the gathered predictions and
    targets equal the JAX package's."""
    names, got, want = _run_both(
        _seeded(b_rpn_target_assign_batched, 3), _rpn_feed(2),
        _flat)
    _assert_all(names, got, want, atol=1e-5)
    assert len(got[2]) > 16            # both images' labels, concatenated


def test_proposal_path_runs_as_the_reference():
    """generate_proposals -> generate_proposal_labels ->
    generate_mask_labels and distribute_fpn_proposals, from seeded
    sampling: every output equals the JAX package's (the decode at
    ``rcnn_cases.DECODE``)."""
    feed = dict(_rpn_feed(1), gt_cls=np.asarray([3, 1, 4], np.int32),
                gt_cls2=np.asarray([2, 1], np.int32),
                segms=np.asarray([[2, 2, 30, 2, 30, 30, 2, 30, 2, 30, 2, 30],
                                  [20, 20, 60, 20, 60, 28, 28, 28, 28, 60,
                                   20, 60]], np.float32))
    names, got, want = _run_both(_seeded(b_proposals, 5), feed, _flat)
    _assert_all(names, got, want, *rc.DECODE)
    assert 0 < got[0].shape[0] <= 12
