"""Fused attention: the three Hopper flash kernels and their plain
PyTorch versions.

Port of ``paddle_tpu/ops/flash_attention.py``. Layout [B, S, H, D].

- ``blockwise_attention`` (ref ``:69-130``) and
  ``blockwise_attention_backward`` (ref ``:485-533``): the plain versions,
  online softmax over key blocks in torch ops. They run the op on the CPU
  and the bias / ``q_offset`` route everywhere, and are what the kernels
  are held against.
- ``flash_fwd`` (K1), ``flash_bwd_dq`` (K2), ``flash_bwd_dkv`` (K3): the
  wrappers of the CUDA kernels in ``paddle_tpu_torch/csrc/flash_attention.cu``
  (which say what each replaces and what bounds it). A wrapper takes the
  plain version only for a tensor on the CPU; for a CUDA tensor it
  launches its kernel or raises. ``<wrapper>.launches`` counts launches.
- ``FlashAttentionFunction``: the autograd Function (ref ``:451-536``); it
  saves ``(q, k, v, o, lse)`` and nothing of size S x S.
- ``flash_attention``: the bias-free route to K1-K3. K1-K3 take fp32,
  bf16 or fp16, head dim 64 or 128, contiguous and 16-byte aligned; a
  smaller head dim is zero-padded to the next of those (the Pallas
  kernel takes any head dim), and a view or an unaligned tensor is
  copied.
- The ``flash_attention`` op sends its bias and ``q_offset`` routes to
  the plain version under autograd on any device (``blockwise_route``,
  as the reference does), everything else to ``flash_attention``.
  ``blockwise_route.calls`` counts the former beside the wrappers'
  ``launches``.

Numerics: the plain versions take the score and P·V products in float32
(the reference's ``preferred_element_type=float32``) and round P to the
value dtype before P·V as the reference does, and so does K1. K1-K3 run
every product on the tensor cores in 3xTF32 (fp32 accuracy, no plain
TF32), and round only their outputs (and K1 its bf16 or fp16 P).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.enforce import InvalidArgumentError, UnimplementedError
from ..core.registry import register_infer_meta, register_op
from . import kernels

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
KERNEL_HEAD_DIMS = (64, 128)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------
def blockwise_attention(q, k, v, bias: Optional[torch.Tensor] = None,
                        causal: bool = False, block_size: int = 512,
                        scale: Optional[float] = None, q_offset: int = 0,
                        k_offset: int = 0):
    """Memory-efficient attention: a loop over key blocks with online
    softmax. Returns (out [B,S,H,D] fp32, lse [B,H,S] fp32).

    ``q_offset``/``k_offset`` are global positions of the local q/k
    shards, for causal masking across shards."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    blk = min(block_size, sk)
    if bias is not None:
        bias = bias.expand(bias.shape[0], bias.shape[1], sq, sk)
    qf = q.float()
    q_pos = q_offset + torch.arange(sq, device=q.device)
    o = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, sq), float("-inf"), dtype=torch.float32,
                     device=q.device)
    for start in range(0, sk, blk):
        stop = min(start + blk, sk)
        s = torch.einsum("bqhd,bkhd->bhqk", qf,
                         k[:, start:stop].float()) * scale
        if bias is not None:
            s = s + bias[..., start:stop]
        if causal:
            k_pos = k_offset + torch.arange(start, stop, device=q.device)
            keep = q_pos[:, None] >= k_pos[None, :]
            s = s + torch.where(keep, 0.0, NEG_INF)
        lse_i = torch.logsumexp(s, dim=-1)                   # [B, H, Sq]
        p = torch.exp(s - lse_i[..., None])
        # rows with every key masked have lse=-inf -> p=nan; zero them
        p = torch.where(torch.isfinite(lse_i)[..., None], p, 0.0)
        o_i = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                           v[:, start:stop].float())
        lse_new = torch.logaddexp(lse, lse_i)
        w_acc = torch.nan_to_num(torch.exp(lse - lse_new)).transpose(1, 2)
        w_i = torch.nan_to_num(torch.exp(lse_i - lse_new)).transpose(1, 2)
        o = o * w_acc[..., None] + o_i * w_i[..., None]
        lse = lse_new
    return o, lse


def blockwise_attention_backward(q, k, v, o, lse, g, causal: bool,
                                 scale: float, block_size: int = 512,
                                 delta: Optional[torch.Tensor] = None):
    """Flash backward from (o, lse): scores are recomputed one key block
    at a time, never the full [Sq, Sk] matrix. ``delta = rowsum(g * o)``
    [B, H, Sq] is computed from ``o`` unless given. Returns
    (dq, dk, dv) in the input dtypes and delta in fp32."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    blk = min(block_size, sk)
    gf, qf = g.float(), q.float()
    if delta is None:
        delta = torch.einsum("bqhd,bqhd->bhq", gf, o.float())
    q_pos = torch.arange(sq, device=q.device)
    # rows whose every key is masked have lse == NEG_INF; zero their p
    row_valid = (lse > NEG_INF / 2)[..., None]               # [B, H, Sq, 1]
    dq = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    dk = torch.empty((b, sk, h, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for start in range(0, sk, blk):
        stop = min(start + blk, sk)
        kf, vf = k[:, start:stop].float(), v[:, start:stop].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
        if causal:
            k_pos = torch.arange(start, stop, device=q.device)
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
        p = torch.where(row_valid, torch.exp(s - lse[..., None]), 0.0)
        dv[:, start:stop] = torch.einsum("bhqk,bqhd->bkhd", p, gf)
        dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
        ds = p * (dp - delta[..., None]) * scale
        dq += torch.einsum("bhqk,bkhd->bqhd", ds, kf)
        dk[:, start:stop] = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), delta


# ---------------------------------------------------------------------------
# Kernel wrappers (K1-K3)
# ---------------------------------------------------------------------------
def _refusal(q, k, v, *more):
    """Why K1-K3 do not take these tensors, the device aside, or None:
    they take fp32, bf16 or fp16 (all one dtype), contiguous [B, S, H, D]
    with D in {64, 128}, 16-byte aligned."""
    ts = (q, k, v) + more
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype for t in ts):
        return (f"flash kernels take q/k/v/o/dO of one dtype (float32 or "
                f"bfloat16, or float16), got {[t.dtype for t in ts]}")
    if any(not t.is_contiguous() for t in ts):
        return "flash kernels take contiguous tensors"
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4 or \
            q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        return (f"flash kernels: bad shapes q {tuple(q.shape)}, "
                f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.shape[3] not in KERNEL_HEAD_DIMS:
        return f"flash kernels take head dim 64 or 128, got {q.shape[3]}"
    if any(t.data_ptr() % 16 for t in ts):
        return ("flash kernels take 16-byte aligned tensors (they copy rows "
                "16 bytes at a time)")
    return None


def _check_cuda(q, k, v, *more):
    """Raise unless K1-K3 take these tensors on one CUDA device."""
    ts = (q, k, v) + more
    reason = _refusal(q, k, v, *more)
    if reason is None and (q.device.type != "cuda" or
                           any(t.device != q.device for t in ts)):
        reason = (f"flash kernels take tensors on one CUDA device, got "
                  f"{[str(t.device) for t in ts]}")
    if reason is not None:
        raise InvalidArgumentError(reason)


def _dims(q, k, scale, causal):
    b, sq, h, d = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return (b, h, sq, k.shape[1], d, *q.stride()[:3], *k.stride()[:3],
            float(scale), int(bool(causal)), _DTYPE_CODE[q.dtype], stream)


def flash_fwd(q, k, v, causal: bool, scale: float, block_size: int = 512):
    """K1: (o [B,Sq,H,D] in q's dtype, lse [B,H,Sq] fp32)."""
    if q.device.type == "cpu":
        o, lse = blockwise_attention(q, k, v, causal=causal, scale=scale,
                                     block_size=block_size)
        return o.to(q.dtype), lse
    _check_cuda(q, k, v)
    lib = kernels.library("flash_attention")
    o = torch.empty_like(q)
    lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]),
                      dtype=torch.float32, device=q.device)
    err = lib.ptt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), lse.data_ptr(),
                            *_dims(q, k, scale, causal))
    flash_fwd.launches += 1
    kernels.check(lib, err, "flash_fwd")
    return o, lse


def flash_bwd_dq(q, k, v, o, do, lse, causal: bool, scale: float,
                 block_size: int = 512):
    """K2: (dq in q's dtype, delta = rowsum(dO*O) [B,H,Sq] fp32)."""
    if q.device.type == "cpu":
        dq, _, _, delta = blockwise_attention_backward(
            q, k, v, o, lse, do, causal, scale, block_size)
        return dq, delta
    _check_cuda(q, k, v, o, do)
    lib = kernels.library("flash_attention")
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    err = lib.ptt_flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                               delta.data_ptr(), dq.data_ptr(),
                               *_dims(q, k, scale, causal))
    flash_bwd_dq.launches += 1
    kernels.check(lib, err, "flash_bwd_dq")
    return dq, delta


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale: float,
                  block_size: int = 512):
    """K3: (dk, dv) in k's and v's dtype, from K2's delta."""
    if q.device.type == "cpu":
        _, dk, dv, _ = blockwise_attention_backward(
            q, k, v, None, lse, do, causal, scale, block_size, delta=delta)
        return dk, dv
    _check_cuda(q, k, v, do)
    lib = kernels.library("flash_attention")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = lib.ptt_flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                do.data_ptr(), lse.data_ptr(),
                                delta.data_ptr(), dk.data_ptr(),
                                dv.data_ptr(), *_dims(q, k, scale, causal))
    flash_bwd_dkv.launches += 1
    kernels.check(lib, err, "flash_bwd_dkv")
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0
WRAPPERS = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)


class FlashAttentionFunction(torch.autograd.Function):
    """Flash-style autograd: the forward saves only (q, k, v, o, lse); the
    backward recomputes P block by block (K2 then K3 on the card)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_size):
        o, lse = flash_fwd(q, k, v, causal, scale, block_size)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.attrs = (causal, scale, block_size)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        g = g.contiguous()
        dq, delta = flash_bwd_dq(q, k, v, o, g, lse, *ctx.attrs)
        dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, *ctx.attrs)
        return dq, dk, dv, None, None, None


def blockwise_route(q, k, v, bias=None, causal=False, scale=None,
                    block_size=512, q_offset=0):
    """The op's bias and ``q_offset`` route: the plain version under
    autograd, on any device (the reference's own route: its Pallas kernel
    is the square, bias-free fast path). Counts its calls."""
    blockwise_route.calls += 1
    o, _ = blockwise_attention(q, k, v, bias=bias, causal=causal,
                               scale=scale, block_size=block_size,
                               q_offset=q_offset)
    return o.to(q.dtype)


blockwise_route.calls = 0


def _kernel_head_dim(d: int) -> int:
    """The head dim K1-K3 run a head dim ``d`` at: ``d`` itself, or the
    next of theirs when ``d`` is smaller (zeros pad the rest)."""
    return next((n for n in KERNEL_HEAD_DIMS if n >= d), d)


def _kernel_layout(t, dp: int):
    """``t`` as K1-K3 read it: head dim zero-padded to ``dp``, contiguous
    and 16-byte aligned (a copy only where it is not)."""
    d = t.shape[-1]
    if d != dp:
        return torch.nn.functional.pad(t, (0, dp - d))
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, block_size: int = 512):
    """Fused scaled-dot-product attention, [B, S, H, D] layout, through
    K1-K3 on the card. A head dim below 128 that K1-K3 lack is padded
    with zeros (zero columns add nothing to q k^T, and o's extra columns,
    zero too, are dropped); a view or an unaligned tensor is copied."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    dp = _kernel_head_dim(d)
    q, k, v = (_kernel_layout(t, dp) for t in (q, k, v))
    o = FlashAttentionFunction.apply(q, k, v, bool(causal), float(scale),
                                     int(block_size))
    return o[..., :d] if dp != d else o


@register_op("flash_attention")
def _flash_attention_op(inputs, attrs):
    """Inputs Q/K/V: [B, S, H, D]; optional Bias: [B|1, H|1, Sq, Sk]
    additive attention bias. The bias and KV-cache (``q_offset``) routes
    take the blockwise path, as in the reference (its Pallas kernel is
    the square, bias-free fast path); everything else goes to K1-K3."""
    q, k, v = inputs["Q"][0], inputs["K"][0], inputs["V"][0]
    causal = attrs.get("causal", False)
    scale = attrs.get("scale")
    block_size = attrs.get("block_size", 512)
    q_offset = attrs.get("q_offset", 0)
    bias = inputs["Bias"][0] if inputs.get("Bias") else None
    if bias is not None or q_offset:
        return {"Out": [blockwise_route(q, k, v, bias, causal, scale,
                                        block_size, q_offset)]}
    if attrs.get("sp_axis"):
        raise UnimplementedError(
            "flash_attention: sequence parallelism (sp_axis) is not ported")
    out = flash_attention(q, k, v, causal=causal, scale=scale,
                          block_size=block_size)
    return {"Out": [out]}


@register_infer_meta("flash_attention")
def _flash_attention_meta(inputs, attrs):
    """Shape rule for static builders: the wrappers take only CPU and
    CUDA tensors, so ``meta`` inference never reaches K1-K3 (nor their
    launch counts). Out has Q's shape and dtype on every route."""
    return {"Out": [torch.empty_like(inputs["Q"][0])]}
