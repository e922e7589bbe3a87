"""The 75 op types of ``paddle_tpu/ops/math.py`` the 2.0 tensor API
brought to the port, against the JAX package's ops: forward and
gradient, case by case (``paddle_tpu_torch/testing/op_cases.py``; the
helpers and tolerances are ``test_torch_tensor_ops.py``'s). Integer
modulo and floor division run on negative operands (the divisor's
sign, as ``jnp``), ``arg_*`` and ``top_k_v2`` on ties (the first index;
ties in index order), and the max / min reductions on ties (the
gradient split between them)."""
import pytest

import paddle_tpu_torch as tpt
from test_torch_tensor_ops import (cases_of, check_forward,
                                   check_gradient)

CASES = cases_of(("paddle_tpu.ops.math",))
GRAD = [c for c in CASES if c.grad]


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_forward_matches_jax(case):
    check_forward(case)


@pytest.mark.parametrize("case", GRAD, ids=[c.id for c in GRAD])
def test_gradient_matches_jax(case):
    check_gradient(case)
