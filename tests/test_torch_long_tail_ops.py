"""The 10 op types of ``ops/long_tail_ops.py`` that the decoding slice
brought to the port (``hash``, ``sampling_id``, ``mean_iou``,
``add_position_encoding``, ``soft_relu``, ``random_crop``,
``similarity_focus``, ``chunk_eval``, ``scatter_nd``,
``deformable_psroi_pooling``), against the JAX package's ops. The
registry test of the slice is in ``test_torch_decode_ops.py``.

Each value case of ``paddle_tpu_torch/testing/decode_cases.py`` runs one
op through ``OpInfoMap`` in both packages on the same numpy inputs: the
forward outputs, then the gradients for the same seeded cotangents.
``hash``, ``mean_iou``'s counts, ``similarity_focus``'s masks and
``chunk_eval``'s counts are integer or mask logic and must be equal
(``hash`` bit for bit with the JAX package's uint32 arithmetic);
``deformable_psroi_pooling`` (bilinear samples) holds at rtol 1e-4 /
atol 2e-5, the rest at fp32's rtol 1e-5 / atol 1e-6.

``sampling_id`` and ``random_crop`` draw from JAX's threefry in the
reference and from torch's generators in the port, which cannot give
the same numbers: both packages are held to the ops' contracts. A
``sampling_id`` draw over many rows of one distribution gives each id at
its probability within 4.5 standard errors (a failure about once in
150,000 runs of a correct op); a zero-probability id is never drawn; the
same seed gives the same draws. Each ``random_crop`` output is a window
of the input of the crop's shape at one start for the whole batch, in
bounds, and ``SeedOut`` is the seed + 1 (the Seed input's, or the attr's
plus the op's call count), as the JAX op advances it.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.core.registry import OpInfoMap as JaxOpInfoMap

import paddle_tpu_torch as tpt
from paddle_tpu_torch.core.registry import OpInfoMap
from paddle_tpu_torch.device import op_device
from paddle_tpu_torch.testing import decode_cases as dc
from test_torch_parity_ops import (cf_check_forward, cf_check_gradient,
                                   cf_run_both)
from test_torch_tensor_ops import _jax_in, _port_in, ref_module

CASES = [c for c in dc.DECODE_CASES
         if ref_module(c.op) == "paddle_tpu.ops.long_tail_ops"]
VALUE = [c for c in CASES if c.kind == "value"]
GRAD = [c for c in VALUE if c.grad]
DRAWS = [c for c in CASES if c.kind == "draws"]


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")


def test_cases_cover_the_ten_types():
    assert len({c.op for c in CASES}) == 10


@pytest.mark.parametrize("case", VALUE, ids=[c.id for c in VALUE])
def test_forward_matches_jax(case, tmp_path):
    cf_check_forward(case, tmp_path)


@pytest.mark.parametrize("case", GRAD, ids=[c.id for c in GRAD])
def test_gradient_matches_jax(case, tmp_path):
    cf_check_gradient(case, tmp_path)


def _np_outs(outs):
    return {s: [np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
                for v in vs] for s, vs in outs.items()}


@pytest.mark.parametrize("case", DRAWS, ids=[c.id for c in DRAWS])
def test_draws_hold_their_contract_in_both_packages(case, tmp_path):
    """The case's contract (decode_cases.DRAW_CONTRACTS) holds for the
    port's draws and for the JAX package's, with the same shapes and
    dtypes; the port's same seed gives the same draws."""
    got, want = cf_run_both(case, tmp_path)
    holds = dc.DRAW_CONTRACTS[case.op]
    for outs in (_np_outs(got), _np_outs(want)):
        assert holds(case.inputs, outs), case.id
    for slot in want:
        for g, w in zip(got[slot], want[slot]):
            assert tuple(g.shape) == tuple(np.shape(w))
            assert str(g.dtype).split(".")[-1] == str(np.asarray(w).dtype)
    again, _ = cf_run_both(case, tmp_path)
    for slot in got:
        for a, b in zip(got[slot], again[slot]):
            assert torch.equal(a, b), f"{case.id}: same seed, other draws"


def _sampling_counts(package, probs, rows, seed):
    x = np.tile(probs, (rows, 1)).astype(np.float32)
    if package == "jax":
        out = JaxOpInfoMap.instance().get("sampling_id").compute(
            _jax_in({"X": [x]}), {"seed": seed})["Out"][0]
    else:
        with op_device("cpu"):
            out = OpInfoMap.instance().get("sampling_id").compute(
                _port_in({"X": [x]}), {"seed": seed})["Out"][0]
    return np.bincount(np.asarray(out).ravel(), minlength=len(probs))


@pytest.mark.parametrize("package", ["jax", "port"])
def test_sampling_id_frequencies_follow_the_probabilities(package):
    probs = np.asarray([0.05, 0.0, 0.25, 0.6, 0.1])
    rows = 20000
    counts = _sampling_counts(package, probs, rows, seed=3)
    se = np.sqrt(probs * (1 - probs) / rows)
    assert counts.sum() == rows and counts[1] == 0
    assert (np.abs(counts / rows - probs) <= 4.5 * se + 1e-12).all(), \
        counts / rows


@pytest.mark.parametrize("package", ["jax", "port"])
def test_random_crop_without_seed_advances_with_each_call(package):
    """No Seed input: the attr plus the op's call count seeds the draw,
    so SeedOut steps by one a call, and every crop is a window of the
    input."""
    x = dc.CROP_X
    attrs = {"shape": list(dc.CROP), "startup_seed": 11}
    seeds = []
    for _ in range(3):
        if package == "jax":
            out = JaxOpInfoMap.instance().get("random_crop").compute(
                _jax_in({"X": [x]}), dict(attrs))
        else:
            with op_device("cpu"):
                out = OpInfoMap.instance().get("random_crop").compute(
                    _port_in({"X": [x]}), dict(attrs))
        out = _np_outs(out)
        assert dc._in_bounds(out["Out"][0], x, dc.CROP)
        seeds.append(int(out["SeedOut"][0][0]))
    assert np.diff(seeds).tolist() == [1, 1] and seeds[0] >= 12
