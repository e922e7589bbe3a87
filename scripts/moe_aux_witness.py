#!/usr/bin/env python3
"""How the MoE aux losses of gpt_tiny's O2 steps move with the attention
backward's rounding: ``chip_smoke``'s moe O2 run (gpt_tiny, moe=True,
num_experts=4, seed-0 weights, three bf16 steps) under each way of
computing attention, on the card and on the CPU.

    python3 scripts/moe_aux_witness.py [--cpu]

A variant is a forward and a backward: ``kernels`` (K1, or K2 and K3;
on the CPU their plain versions), ``plain`` (the plain version in place
of the kernels on the card: fp32 products, P and dS rounded to the input
type as the reference rounds them), ``plain_fp32`` (the plain backward
on fp32 copies of its inputs: P and dS stay fp32, the arithmetic K2 and
K3 ran before their 16-bit redesign) and, on the CPU, ``plain_fp64``
(the plain backward with float64 products, rounded as ``plain``: the
same rounding from sums in another order). Prints each variant's losses
and aux losses by step. The first O2 step runs at learning rate 0, so
step 2's forward is step 1's; step 3 is the first after an update.
On the card it first prints how far K2 and K3 lie from ``plain`` and
from ``plain_fp32`` on the same inputs at gpt_tiny's attention shape
(B2 S64 H4, head dim 32 padded to 64, causal, bf16), by relative
Frobenius error of dq, dk and dv.
"""
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import paddle_tpu_torch as tpt  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.text import gpt_tiny  # noqa: E402


def backward_of(widen):
    """K2 and K3's stand-ins: the plain backward on ``widen`` of each
    input (``None``: the inputs as they are), results in the input type."""
    def run(q, k, v, o, lse, do, causal, scale, block_size, delta=None):
        dtype = q.dtype
        if widen is not None:
            q, k, v, do = (t.to(widen) for t in (q, k, v, do))
            o = None if o is None else o.to(widen)
        r = fa.blockwise_attention_backward(q, k, v, o, lse, do, causal,
                                            scale, block_size, delta=delta)
        return tuple(x.to(dtype) for x in r[:3]) + (r[3].float(),)

    def dq(q, k, v, o, do, lse, causal, scale, block_size=512):
        r = run(q, k, v, o, lse, do, causal, scale, block_size)
        return r[0], r[3]

    def dkv(q, k, v, do, lse, delta, causal, scale, block_size=512):
        r = run(q, k, v, None, lse, do, causal, scale, block_size, delta)
        return r[1], r[2]
    return dq, dkv


def plain_fp64_backward(q, k, v, o, lse, g, causal, scale,
                        block_size=512, delta=None):
    """``blockwise_attention_backward`` with its products in float64 and
    P and dS rounded to the input type from there."""
    rnd = lambda x: x.to(q.dtype).double()  # noqa: E731
    qd, kd, vd, gd = (t.double() for t in (q, k, v, g))
    if delta is None:
        delta = torch.einsum("bqhd,bqhd->bhq", g.float(), o.float())
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * scale
    if causal:
        keep = torch.arange(sq)[:, None] >= torch.arange(sk)[None, :]
        s = torch.where(keep.to(s.device), s, fa.NEG_INF)
    valid = (lse > fa.NEG_INF / 2)[..., None]
    p = torch.where(valid, torch.exp(s - lse.double()[..., None]), 0.0)
    dv = torch.einsum("bhqk,bqhd->bkhd", rnd(p), gd)
    dp = torch.einsum("bqhd,bkhd->bhqk", gd, vd)
    ds = rnd(p * (dp - delta.double()[..., None]) * scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kd)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qd)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), delta


def plain_forward(q, k, v, causal, scale, block_size=512):
    o, lse = fa.blockwise_attention(q, k, v, causal=causal, scale=scale,
                                    block_size=block_size)
    return o.to(q.dtype), lse


def kernel_rounding(dev):
    """Relative Frobenius error of K2/K3's dq, dk, dv against ``plain``
    and ``plain_fp32``, and of ``plain_fp32`` against ``plain``."""
    gen = torch.Generator(device=dev).manual_seed(11)
    q, k, v, g = (torch.randn(2, 64, 4, 64, generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(4))
    causal, scale = True, 32 ** -0.5
    o, lse = fa.flash_fwd(q, k, v, causal, scale)
    dq, delta = fa.flash_bwd_dq(q, k, v, o, g, lse, causal, scale)
    got = {"kernels": (dq,) + fa.flash_bwd_dkv(q, k, v, g, lse, delta,
                                               causal, scale)}
    for name, widen in (("plain", None), ("plain_fp32", torch.float32)):
        dq_fn, dkv_fn = backward_of(widen)
        dq, delta = dq_fn(q, k, v, o, g, lse, causal, scale)
        got[name] = (dq,) + dkv_fn(q, k, v, g, lse, delta, causal, scale)

    def frob(a, b):
        return " ".join(
            f"{n} {((x.float() - y.float()).norm() / y.float().norm()).item():.3e}"
            for n, x, y in zip(("dq", "dk", "dv"), got[a], got[b]))
    for a, b in (("kernels", "plain"), ("kernels", "plain_fp32"),
                 ("plain_fp32", "plain")):
        print(f"[witness] card {a} against {b}: {frob(a, b)}")


def main():
    cpu = "--cpu" in sys.argv or not torch.cuda.is_available()
    dev = "cpu" if cpu else torch.device("cuda")
    if not cpu:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(chip_smoke.card_line())
        kernel_rounding(dev)
    b, s, vocab = (chip_smoke.GPT_TINY[k] for k in ("batch", "seq", "vocab"))
    gen = torch.Generator().manual_seed(3)
    ids = torch.randint(0, vocab, (b, s), generator=gen, dtype=torch.int32)
    kw = {"moe": True, "num_experts": 4}
    tpt.set_device("cpu")
    tpt.seed(0)
    state = {k: v.numpy().copy() for k, v in
             gpt_tiny(**kw).state_dict().items()}
    backs = {"kernels": None, "plain": backward_of(None),
             "plain_fp32": backward_of(torch.float32)}
    if cpu:
        backs["plain_fp64"] = "fp64"
    fwds = {"kernels": None, "plain": plain_forward}
    saved = fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv, \
        fa.blockwise_attention_backward
    for fwd_name, fwd in fwds.items():
        for bwd_name, bwd in backs.items():
            if cpu and fwd_name == "plain":
                continue                 # on the CPU K1's stand-in is this
            if fwd is not None:
                fa.flash_fwd = fwd
            if bwd == "fp64":
                fa.blockwise_attention_backward = plain_fp64_backward
            elif bwd is not None:
                fa.flash_bwd_dq, fa.flash_bwd_dkv = bwd
            try:
                losses, auxes = chip_smoke._gpt_tiny_run(
                    tpt, fa, dev, state, ids.to(dev), kw, "O2", 3)[:2]
            finally:
                (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
                 fa.blockwise_attention_backward) = saved
            print(f"[witness] {'cpu' if cpu else 'card'} forward "
                  f"{fwd_name:<8} backward {bwd_name:<10} losses {losses} "
                  f"aux {auxes}", flush=True)


if __name__ == "__main__":
    main()
