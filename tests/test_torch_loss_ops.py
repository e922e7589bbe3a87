"""The 14 op types of ``paddle_tpu/ops/loss_ops.py`` this slice brought
to the port, against the JAX package's ops: forward and gradient, case
by case (``paddle_tpu_torch/testing/nn_cases.py``; helpers and
tolerances are ``test_torch_tensor_ops.py``'s).

``nce`` draws its negatives (threefry in the reference, the port's
generators here, which never draw alike): it is held against the
reference's own code on the port's draws, the reference's
``jax.random.randint`` made to return the negatives the port drew (its
``SampleLabels`` past the true classes), outputs and gradients. Equal
seeds must give the port equal draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu_torch as tpt
from test_torch_nn_ops import nn_cases_of
from test_torch_tensor_ops import check_forward, check_gradient, run_both

CASES = nn_cases_of(("paddle_tpu.ops.loss_ops",))
VALUE = [c for c in CASES if c.kind == "value"]
GRAD = [c for c in VALUE if c.grad]
DRAWS = [c for c in CASES if c.kind == "draws"]


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")


@pytest.mark.parametrize("case", VALUE, ids=[c.id for c in VALUE])
def test_forward_matches_jax(case):
    check_forward(case)


@pytest.mark.parametrize("case", GRAD, ids=[c.id for c in GRAD])
def test_gradient_matches_jax(case):
    check_gradient(case)


@pytest.fixture
def port_draws(monkeypatch):
    """Make the reference draw what the port drew for ``case``."""
    def install(case):
        got, _ = run_both(case)
        true = np.asarray(case.inputs["Label"][0]).reshape(
            got["SampleLabels"][0].shape[0], -1).shape[1]
        noise = got["SampleLabels"][0][:, true:].numpy()
        monkeypatch.setattr(jax.random, "randint",
                            lambda key, shape, lo, hi: jnp.asarray(
                                noise, jnp.int32))
        return noise
    return install


@pytest.mark.parametrize("case", DRAWS, ids=[c.id for c in DRAWS])
def test_nce_matches_jax_on_the_ports_draws(case, port_draws):
    noise = port_draws(case)
    k = case.attrs["num_neg_samples"]
    total = case.attrs["num_total_classes"]
    assert noise.shape == (case.inputs["Input"][0].shape[0], k)
    assert noise.min() >= 0 and noise.max() < total
    check_forward(case)
    check_gradient(case)
    again, _ = run_both(case)
    assert np.array_equal(again["SampleLabels"][0][:, 1:].numpy(), noise)
