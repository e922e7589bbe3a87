"""The 22 op types of ``paddle_tpu/ops/linalg_ops.py``, against the JAX
package's ops: forward and gradient, case by case
(``paddle_tpu_torch/testing/op_cases.py``; the helpers and tolerances are
``test_torch_tensor_ops.py``'s). ``inverse`` and ``cholesky`` run on
well-conditioned matrices (condition number under 10), where LAPACK's
and XLA's factorizations agree to 1e-5 and their gradients to 1e-4
relative. ``argsort`` runs on ties (a stable sort: index order)."""
import pytest

import paddle_tpu_torch as tpt
from test_torch_tensor_ops import (cases_of, check_forward,
                                   check_gradient)

CASES = cases_of(("paddle_tpu.ops.linalg_ops",))
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
