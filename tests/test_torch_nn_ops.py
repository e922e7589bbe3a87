"""The 63 op types the rest of ``paddle.nn`` brought to the port, against
the JAX package's ops: the 19 of ``ops/nn_ops.py`` here, with the
registry test of the slice; the 14 of ``ops/loss_ops.py`` in
``test_torch_loss_ops.py``, and the 26 of ``ops/vision_ops.py`` and the
four of ``ops/long_tail_ops.py`` in ``test_torch_vision_ops.py``.

Each case of ``paddle_tpu_torch/testing/nn_cases.py`` runs one op through
``OpInfoMap`` in both packages on the same numpy inputs: the forward
outputs (integer outputs equal, float within the case's tolerance, fp32
rtol 1e-5 / atol 1e-6 unless the case says why not), then the gradients
for the same seeded cotangents (``generic_vjp_grad`` on each side), over
``test_torch_tensor_ops.py``'s helpers.
"""
import collections
import inspect
import re

import pytest

from paddle_tpu.core.registry import OpInfoMap as JaxOpInfoMap

import paddle_tpu_torch as tpt
from paddle_tpu_torch.core.registry import OpInfoMap
from paddle_tpu_torch.testing.cf_cases import CF_CASES
from paddle_tpu_torch.testing.decode_cases import DECODE_TYPES
from paddle_tpu_torch.testing.nn_cases import NN_CASES
from paddle_tpu_torch.testing.rcnn_cases import RCNN_TYPES
from paddle_tpu_torch.testing.seq_cases import SEQ_TYPES
from test_torch_tensor_ops import (check_forward, check_gradient,
                                   ref_module)

# reference module -> the op types this slice took from it
SLICE = {"paddle_tpu.ops.nn_ops": 19, "paddle_tpu.ops.loss_ops": 14,
         "paddle_tpu.ops.vision_ops": 26, "paddle_tpu.ops.long_tail_ops": 4}
# what the port registered before this slice (228 types), by module
BEFORE = {"paddle_tpu.ops.nn_ops": 11, "paddle_tpu.ops.loss_ops": 2,
          "paddle_tpu.ops.long_tail_ops": 1}
PORTED_BEFORE = 228


def nn_cases_of(modules):
    return [c for c in NN_CASES if ref_module(c.op) in modules]


def slice_types():
    return {c.op for c in NN_CASES}


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")


def test_registry_holds_the_slice_against_the_reference():
    """The port registers 228 + 63 types before the later slices', none
    that the reference lacks;
    the 63 are the cases' types, from the modules and in the counts of
    the slice (nn_ops, loss_ops and vision_ops whole), with the
    reference's intermediate outputs and non-differentiable inputs; no
    compute among them reaches ``pallas_call``."""
    import importlib
    for mod in ("ops", "vision", "text", "static", "inference", "serving"):
        importlib.import_module("paddle_tpu." + mod)
        importlib.import_module("paddle_tpu_torch." + mod)
    jops, pops = JaxOpInfoMap.instance()._ops, OpInfoMap.instance()._ops
    assert not set(pops) - set(jops)
    new = slice_types()
    # the later slices' types (control flow's, the sequence slice's,
    # the decoding slice's, then the two-stage detection slice's) aside
    later = {c.op for c in CF_CASES} | SEQ_TYPES | DECODE_TYPES | RCNN_TYPES
    assert len(new) == 63 and len(set(pops) - later) == PORTED_BEFORE + 63
    assert new <= set(pops)
    assert collections.Counter(ref_module(t) for t in new) == SLICE
    taken = collections.Counter(jdef.compute.__module__
                                for t, jdef in jops.items()
                                if t in pops and t not in later)
    for mod, n in SLICE.items():
        assert taken[mod] == n + BEFORE.get(mod, 0), mod
    for mod in ("paddle_tpu.ops.nn_ops", "paddle_tpu.ops.loss_ops",
                "paddle_tpu.ops.vision_ops"):
        whole = {t for t, d in jops.items() if d.compute.__module__ == mod}
        assert whole <= set(pops), (mod, sorted(whole - set(pops)))
    for t in new:
        jdef, pdef = jops[t], pops[t]
        assert pdef.intermediate_outputs == jdef.intermediate_outputs, t
        assert set(pdef.non_differentiable_inputs) == \
            set(jdef.non_differentiable_inputs), t
        src = inspect.getsource(inspect.getmodule(jdef.compute))
        assert not re.search(r"pallas", src), t


CASES = nn_cases_of(("paddle_tpu.ops.nn_ops",))
GRAD = [c for c in CASES if c.grad]


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_forward_matches_jax(case):
    check_forward(case)


@pytest.mark.parametrize("case", GRAD, ids=[c.id for c in GRAD])
def test_gradient_matches_jax(case):
    check_gradient(case)
