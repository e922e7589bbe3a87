"""The 11 op types of the decoding slice outside ``decode_ops`` and
``long_tail_ops``, against the JAX package's ops: the 9 of
``ops/fusion_ops.py``, ``fusion_seqpool_cvm_concat`` (``parity_ops``,
over ``fusion_seqpool_concat``) and ``deformable_conv_v1``
(``misc_ops``, over ``deformable_conv``). The registry test of the
slice is in ``test_torch_decode_ops.py``.

Each case of ``paddle_tpu_torch/testing/decode_cases.py`` runs one op
through ``OpInfoMap`` in both packages on the same numpy inputs: the
forward outputs, then the gradients for the same seeded cotangents,
``generic_vjp_grad`` on each side. The recurrent fusions (which compose
the registered ``gru`` / ``lstm`` ops, fluid gate order (c, i, f, o),
and ``attention_lstm``'s own loop, gate order (f, i, o, c)) hold at
rtol 1e-4 / atol 2e-5, sums over the steps of products through sigmoid
and tanh; ``deformable_conv_v1`` at the convolutions' 1e-4 / 2e-5; the
rest at fp32's rtol 1e-5 / atol 1e-6.
"""
import pytest

import paddle_tpu_torch as tpt
from paddle_tpu_torch.testing.decode_cases import DECODE_CASES
from test_torch_parity_ops import cf_check_forward, cf_check_gradient
from test_torch_tensor_ops import ref_module

MODULES = ("paddle_tpu.ops.fusion_ops", "paddle_tpu.ops.parity_ops",
           "paddle_tpu.ops.misc_ops")
CASES = [c for c in DECODE_CASES if ref_module(c.op) in MODULES]
GRAD = [c for c in CASES if c.grad]


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")


def test_cases_cover_the_eleven_types():
    assert len({c.op for c in CASES}) == 11


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_forward_matches_jax(case, tmp_path):
    cf_check_forward(case, tmp_path)


@pytest.mark.parametrize("case", GRAD, ids=[c.id for c in GRAD])
def test_gradient_matches_jax(case, tmp_path):
    cf_check_gradient(case, tmp_path)
