"""The flash kernels K1-K3 against their plain PyTorch versions on a CUDA
card (needs a card; skips where there is none).

This file imports torch and the port only, so it runs on a machine
without JAX:

    python -m pytest tests/test_torch_kernels_cuda.py -m gpu --noconftest

Tolerances: fp32 o, lse and delta at rtol 1e-4 / atol 1e-5 and gradients
at rtol 2e-3 / atol 3e-4 (both sides are full fp32; TF32 is off for the
plain version's matmuls); bf16 outputs round to 8 mantissa bits, so
rtol / atol 2e-2; lse is fp32 from the same widened products in both.
"""
import math

import pytest
import torch

from paddle_tpu_torch.core.enforce import InvalidArgumentError
from paddle_tpu_torch.ops import flash_attention as fa

CASES = [
    # (b, s, h, d, causal): BERT-base, then tests/test_flash_tpu.py's
    (16, 128, 12, 64, False),
    (1, 256, 4, 64, True),
    (2, 100, 3, 64, False),
    (1, 512, 8, 128, True),
    (2, 100, 3, 64, True),
    (1, 130, 2, 128, False),
]
TOL = {torch.float32: (dict(rtol=1e-4, atol=1e-5), dict(rtol=2e-3, atol=3e-4)),
       torch.bfloat16: (dict(rtol=2e-2, atol=2e-2), dict(rtol=2e-2, atol=2e-2))}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,d,causal", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain(cuda, b, s, h, d, causal, dtype):
    gen = torch.Generator(device=cuda).manual_seed(11)
    q, k, v, g = (torch.randn(b, s, h, d, generator=gen, device=cuda)
                  .to(dtype) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    tol_o, tol_g = TOL[dtype]
    launches = fa.flash_fwd.launches
    o, lse = fa.flash_fwd(q, k, v, causal, scale)
    assert fa.flash_fwd.launches == launches + 1
    o_r, lse_r = fa.blockwise_attention(q, k, v, causal=causal, scale=scale)
    torch.testing.assert_close(o.float(), o_r, **tol_o)
    torch.testing.assert_close(lse, lse_r, rtol=1e-4, atol=1e-5)
    o_r = o_r.to(dtype)
    dq, delta = fa.flash_bwd_dq(q, k, v, o_r, g, lse_r, causal, scale)
    dk, dv = fa.flash_bwd_dkv(q, k, v, g, lse_r, delta, causal, scale)
    dq_r, dk_r, dv_r, delta_r = fa.blockwise_attention_backward(
        q, k, v, o_r, lse_r, g, causal, scale)
    torch.testing.assert_close(delta, delta_r, **tol_o)
    for got, want in ((dq, dq_r), (dk, dk_r), (dv, dv_r)):
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), **tol_g)


@pytest.mark.gpu
def test_wrapper_raises_instead_of_falling_back(cuda):
    q = torch.zeros(1, 8, 2, 32, device=cuda)      # head dim 32: no kernel
    with pytest.raises(InvalidArgumentError):
        fa.flash_fwd(q, q, q, False, 1.0)
