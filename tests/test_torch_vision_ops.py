"""The 26 op types of ``paddle_tpu/ops/vision_ops.py`` and the four of
``long_tail_ops.py`` that the ``nn`` layers call (``adaptive_pool2d`` /
``3d``, ``brelu``, ``bilinear_tensor_product``), against the JAX
package's ops: forward and gradient, case by case
(``paddle_tpu_torch/testing/nn_cases.py``; helpers and tolerances are
``test_torch_tensor_ops.py``'s). The interpolation family runs each
coordinate rule of ``interpolate_op.h`` (aligned corners, half-pixel,
the legacy mapping, nearest's rounding and flooring, Keys' cubic);
``max_pool*_with_index`` runs on tied maxima (the first one's index).

The reference's ``max_pool*_with_index`` gives NaN wherever a window
meets its padding (its patches are a convolution, and -inf times a zero
tap is NaN). The padded cases hold the port against the reference run
on the input padded by hand with a large negative number and no padding
attr, its Mask mapped back to the unpadded positions.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.core.registry import OpInfoMap as JaxOpInfoMap
from paddle_tpu.core.registry import generic_vjp_grad as jax_vjp_grad

import paddle_tpu_torch as tpt
from paddle_tpu_torch.core.registry import OpInfoMap, generic_vjp_grad
from paddle_tpu_torch.device import op_device
from test_torch_nn_ops import nn_cases_of
from test_torch_tensor_ops import (_jax_in, _port_in, assert_same,
                                   check_forward, check_gradient)

CASES = nn_cases_of(("paddle_tpu.ops.vision_ops",
                     "paddle_tpu.ops.long_tail_ops"))


def padded_pool(case):
    return case.op.startswith("max_pool") and \
        any(case.attrs.get("paddings", [0]))


PLAIN = [c for c in CASES if not padded_pool(c)]
GRAD = [c for c in PLAIN if c.grad]
PADDED = [c for c in CASES if padded_pool(c)]


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")


@pytest.mark.parametrize("case", PLAIN, ids=[c.id for c in PLAIN])
def test_forward_matches_jax(case):
    check_forward(case)


@pytest.mark.parametrize("case", GRAD, ids=[c.id for c in GRAD])
def test_gradient_matches_jax(case):
    check_gradient(case)


@pytest.mark.parametrize("case", PADDED, ids=[c.id for c in PADDED])
def test_padded_pool_with_index_matches_jax_on_padded_input(case):
    x = case.inputs["X"][0]
    nd = x.ndim - 2
    p = list(case.attrs["paddings"])
    xp = np.pad(x, [(0, 0), (0, 0)] + [(v, v) for v in p],
                constant_values=-1e30).astype(np.float32)
    attrs = dict(case.attrs, paddings=[0] * nd)
    jdef = JaxOpInfoMap.instance().get(case.op)
    want = jdef.compute(_jax_in({"X": [xp]}), attrs)
    # the reference's Mask over the padded grid, mapped to the input's
    flat = np.asarray(want["Mask"][0])
    coords = np.unravel_index(flat, xp.shape[2:])
    inside = [c - v for c, v in zip(coords, p)]
    mask = np.ravel_multi_index(inside, x.shape[2:]).astype(np.int32)
    with op_device("cpu"):
        pdef = OpInfoMap.instance().get(case.op)
        got = pdef.compute(_port_in(case.inputs), dict(case.attrs))
    assert_same(got["Out"][0], want["Out"][0], case.tol, "Out")
    assert_same(got["Mask"][0], mask, case.tol, "Mask")
    ct = np.random.RandomState(99).randn(*got["Out"][0].shape).astype(
        np.float32)
    gwant = np.asarray(jax_vjp_grad(
        jdef, _jax_in({"X": [xp]}), want,
        {"Out": [_jax_in({"c": [ct]})["c"][0]]}, attrs)["X"][0])
    crop = tuple([slice(None)] * 2 + [slice(v, v + s) for v, s in
                                      zip(p, x.shape[2:])])
    ggot = generic_vjp_grad(pdef, _port_in(case.inputs), {},
                            {"Out": [torch.from_numpy(ct)]},
                            dict(case.attrs))["X"][0]
    assert_same(ggot, gwant[crop], case.grad_tol, "dX")
