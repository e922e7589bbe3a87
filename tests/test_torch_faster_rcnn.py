"""The Faster R-CNN training script of the two-stage detection slice
(``rcnn_cases.faster_rcnn_program``) at ``FRCNN_TINY`` (a block a stage,
widths 4-32, 64 x 96 images, 32 anchors and 32 RoIs an image, 5 classes)
in both packages: both builders write the same program, and two
Momentum steps from the same startup values (the port's, carried into
the JAX scope by name) on two seeded images run as the JAX executor
runs them.

Held per step: the anchors the RPN samples (``rpn_target_assign``'s
score and location indices, labels) and the RoIs and labels that
``generate_proposal_labels`` samples equal; the proposals within
``rcnn_cases.DECODE`` (their decode passes through ``exp``); the four
losses within rtol 1e-4 (sums over the RoIs of products through
convolutions); after the two steps each trained parameter by the norm of
its update error, within 1e-3 of its update's norm (a ReLU input within
rounding of 0 moves a gradient element, Queue 3's precedent). The frozen
parameters (the stem, res2 and every affine_channel) do not move.
"""
import types

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu.static as jstatic
import paddle_tpu.static.detection as jdet
from paddle_tpu.core.tensor import TpuTensor as JaxTpuTensor
from paddle_tpu.nn import ParamAttr as JaxParamAttr
from paddle_tpu.nn.initializer import Constant as JaxConstant
from paddle_tpu.nn.initializer import Normal as JaxNormal
from paddle_tpu.optimizer import L2Decay as JaxL2Decay
from paddle_tpu.optimizer import Momentum as JaxMomentum

import paddle_tpu_torch as tpt
from paddle_tpu_torch.testing import rcnn_cases as rc
from test_torch_program import _first_difference

JAX_API = types.SimpleNamespace(
    pt=jpt, static=jstatic, det=jdet, ParamAttr=JaxParamAttr,
    Normal=JaxNormal, Constant=JaxConstant, Momentum=JaxMomentum,
    L2Decay=JaxL2Decay)
LOSSES = ("loss", "rpn_cls", "rpn_reg", "rcnn_cls", "rcnn_reg")
LOSS_RTOL = 1e-4
UPDATE_TOL = 1e-3


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")


def _sampled(main):
    """Output names of the sampling ops: (rpn_target_assign's
    ScoreIndex, LocationIndex, TargetLabel; generate_proposal_labels'
    Rois and LabelsInt32)."""
    ops = {op.type: op for op in main.global_block().ops}
    rpn, gpl = ops["rpn_target_assign"], ops["generate_proposal_labels"]
    return [rpn.outputs[s][0] for s in ("ScoreIndex", "LocationIndex",
                                        "TargetLabel")] + \
        [gpl.outputs[s][0] for s in ("Rois", "LabelsInt32")]


@pytest.fixture(scope="module")
def runs():
    tpt.set_device("cpu")
    cfg = rc.FRCNN_TINY
    jmain, jstart, names = rc.faster_rcnn_program(JAX_API, cfg)
    pmain, pstart, pnames = rc.faster_rcnn_program(rc.port_api(), cfg)
    jscope, pscope = jpt.Scope(), tpt.Scope()
    jexe, pexe = jpt.Executor(), tpt.Executor("cpu")
    pexe.run(pstart, scope=pscope)
    params = sorted(pstart.global_block().vars)
    start = {n: pscope.find_var(n).get().numpy().copy() for n in params}
    for n, v in start.items():
        jscope.var(n).set(JaxTpuTensor(v))
    fetch = [names[k] for k in LOSSES] + [names["proposals"]] + \
        _sampled(jmain)
    steps = []
    for seed in (0, 1):
        feed = rc.frcnn_feed(cfg, seed)
        want = jexe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope)
        got = pexe.run(pmain, feed=feed, fetch_list=fetch, scope=pscope)
        steps.append(([np.asarray(v) for v in got],
                      [np.asarray(v) for v in want]))
    after = {n: (pscope.find_var(n).get().numpy(),
                 np.asarray(jscope.find_var(n).get().value))
             for n in params}
    return dict(jmain=jmain, pmain=pmain, jstart=jstart, pstart=pstart,
                names=names, pnames=pnames, steps=steps, start=start,
                after=after)


def test_both_builders_write_the_same_program(runs):
    got, want = runs["pmain"].to_json(), runs["jmain"].to_json()
    assert got == want, _first_difference(got, want)
    assert runs["pstart"].to_json() == runs["jstart"].to_json()
    assert runs["pnames"] == runs["names"]
    types_ = runs["pmain"].op_types()
    for t in ("anchor_generator", "generate_proposals", "rpn_target_assign",
              "generate_proposal_labels", "roi_align", "affine_channel",
              "momentum", "roi_align_grad"):
        assert t in types_, t


@pytest.mark.parametrize("step", [0, 1])
def test_sampling_and_proposals_match_jax(runs, step):
    got, want = runs["steps"][step]
    n = len(LOSSES)
    np.testing.assert_allclose(got[n], want[n], rtol=rc.DECODE[0],
                               atol=rc.DECODE[1], err_msg="proposals")
    for g, w, what in zip(got[n + 1:], want[n + 1:],
                          ("ScoreIndex", "LocationIndex", "TargetLabel",
                           "Rois", "LabelsInt32")):
        assert g.shape == w.shape, what
        if what == "Rois":
            np.testing.assert_allclose(g, w, rtol=rc.DECODE[0],
                                       atol=rc.DECODE[1], err_msg=what)
        else:
            np.testing.assert_array_equal(g, w, err_msg=what)
    labels = got[-1]
    assert len(labels) == rc.FRCNN_TINY["rois"] and (labels > 0).any()
    assert len(got[n + 1]) == rc.FRCNN_TINY["rpn_batch"]


@pytest.mark.parametrize("step", [0, 1])
def test_losses_match_jax(runs, step):
    got, want = runs["steps"][step]
    for name, g, w in zip(LOSSES, got, want):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=name)


def test_parameters_after_two_steps_match_jax(runs):
    moved = frozen = 0
    for n, (got, want) in runs["after"].items():
        start = runs["start"][n]
        update = np.linalg.norm(want - start)
        if "@" in n or n.startswith("learning_rate"):
            continue
        if update == 0.0:
            np.testing.assert_array_equal(got, start, err_msg=n)
            frozen += 1
            continue
        err = np.linalg.norm(got - want) / update
        assert err <= UPDATE_TOL, (n, err)
        moved += 1
    assert moved and frozen
    for n in runs["after"]:
        if n.startswith(("bn_conv1", "bn2a", "conv1_", "res2a")):
            assert np.array_equal(runs["after"][n][1], runs["start"][n]), n


def test_full_config_counts():
    """The full configuration as the card runs it, counted on the CPU
    from the program's shapes: 33,852,960 parameters (the stem, res2
    and the affine_channel norms frozen among them) and the
    convolutions' forward FLOPs, 219,902,412,800 in the backbone and the
    RPN and 828,660,252,672 in the res5 head on 512 RoIs."""
    main, startup, _ = rc.faster_rcnn_program(rc.port_api(), rc.FRCNN,
                                              mode="loss")
    params = sum(int(np.prod(v.shape))
                 for v in startup.global_block().vars.values())
    assert params == 33_852_960
    assert rc.conv_flops(main, rc.FRCNN["rois"]) == (219_902_412_800,
                                                     828_660_252_672)
