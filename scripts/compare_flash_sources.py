#!/usr/bin/env python3
"""K1 (forward), K2 (dQ) and K3 (dK/dV) of versions of the flash-attention
source, side by side on one card.

    python3 scripts/compare_flash_sources.py [--shape bert|gpt] [--dtype fp32|bf16|fp16] \
        NAME=path/to/flash_attention.cu ... [CONTROL ...]

Each version is built by ``kernels.build`` in place of
``paddle_tpu_torch/csrc/flash_attention.cu`` and launched through the
port's wrappers, at a shape (``bert``: B16 S128 H12 D64, the default;
``gpt``: B4 S2048 H16 D128 causal) in a dtype (fp32 by default). Per
version it prints ptxas' report of K1-K3 at that dtype and head dim. In
fp32: K1's o and lse and K2/K3's dq, dk and dv against float64 at
BERT-base, plain and with q scaled by 8 (``chip_smoke.fp64_errors``), and
K1's o element by element with q scaled by 8 (``sharp_o``); in bf16 and
fp16: K2/K3's relative Frobenius error against the plain backward in
fp32 at the shape (``chip_smoke.bwd_frobenius``). Then the times of K1,
K2, K3 and the K2 + K3 pair (``chip_smoke.cuda_ms``) at the shape and
dtype, the versions in turns (a, b, ..., b, a) ROUNDS times, median and
least, beside SDPA's backward (one call for dq, dk and dv) timed in the
same turns. A CONTROL adds
the BERT-base O1 losses of seed 0 and step_ms (``chip_smoke.phase_bert``)
of each version and each control, in turns; a control runs the last
version with one part replaced on the card: ``plain`` the plain backward
in place of K2 and K3, ``plain_fwd`` the plain forward in place of K1,
``fp64_fwd`` o and lse of float64 rounded to fp32 in place of K1,
``fp64_fwd_ulp1`` to ``fp64_fwd_ulp4`` the same with o moved by half an
ulp of noise from seeds 1 to 4. An
earlier commit's source: ``git archive <commit> | tar -x -C
build/parent``.
"""
import functools
import math
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import paddle_tpu_torch as tpt  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.ops import kernels  # noqa: E402

ROUNDS = 2
SHAPES = {"bert": chip_smoke.BERT_SHAPE, "gpt": chip_smoke.GPT_SHAPE}
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
          "fp16": torch.float16}
CALLS = {"bert": 50, "gpt": 10}         # cuda_ms calls a time


def use(path):
    """The wrappers launch the version built from ``path`` from now on."""
    return kernels.build(sources={"flash_attention": path})["flash_attention"]


def _inputs(dev, shape, dtype, seed=7):
    b, s, h, d, _ = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(b, s, h, d, generator=gen, device=dev)
                 .to(dtype) for _ in range(4))


def timing(versions, dev, shape_name, dtype):
    shape = SHAPES[shape_name]
    causal, d, n = shape[4], shape[3], CALLS[shape_name]
    scale = 1.0 / math.sqrt(d)
    q, k, v, g = _inputs(dev, shape, dtype)
    o, lse = fa.blockwise_attention(q, k, v, causal=causal, scale=scale)
    o = o.to(dtype).contiguous()
    k2 = lambda: fa.flash_bwd_dq(q, k, v, o, g, lse, causal, scale)  # noqa: E731
    qr, kr, vr = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qr, kr, vr, is_causal=causal)
    gt = g.transpose(1, 2)
    sdpa = lambda: torch.autograd.grad(  # noqa: E731
        out, (qr, kr, vr), gt, retain_graph=True)
    times = {name: [] for name in versions}
    for name in (list(versions) + list(reversed(list(versions)))) * ROUNDS:
        use(versions[name])
        _, delta = k2()
        times[name].append((
            chip_smoke.cuda_ms(lambda: fa.flash_fwd(q, k, v, causal, scale),
                               n),
            chip_smoke.cuda_ms(k2, n),
            chip_smoke.cuda_ms(lambda: fa.flash_bwd_dkv(
                q, k, v, g, lse, delta, causal, scale), n),
            chip_smoke.cuda_ms(lambda: fa.flash_bwd_dkv(
                q, k, v, g, lse, k2()[1], causal, scale), n),
            chip_smoke.cuda_ms(sdpa, n)))
    for name, ts in times.items():
        cols = [f"{what} {statistics.median(x * 1e3 for x in col):.2f} us "
                f"(least {min(col) * 1e3:.2f}, most {max(col) * 1e3:.2f})"
                for what, col in zip(("K1", "K2", "K3", "pair", "sdpa_bwd"),
                                     zip(*ts))]
        print(f"[time] {shape_name} {str(dtype)[6:]} {name:<12} "
              + "  ".join(cols) + f"  over {len(ts)} turns")


def sharp_o(dev):
    """K1's o with a sharp softmax (tests/test_torch_kernels_cuda.py's
    test_sharp_softmax_matches_plain: BERT-base, seed 5, q x 8) against
    the plain version and float64, element by element. Returns (worst
    |o - o_plain| / (atol + rtol |o_plain|), the fp32 tolerance's share;
    elements past it; K1's and the plain version's largest |o - o64|;
    K1's and the plain version's worst share of the tolerance against
    o64)."""
    b, s, h, d, causal = chip_smoke.BERT_SHAPE
    scale = 1.0 / math.sqrt(d)
    gen = torch.Generator(device=dev).manual_seed(5)
    q, _ = (torch.randn(b, s, h, d, generator=gen, device=dev)
            for _ in range(2))
    k, v = (torch.randn(b, s, h, d, generator=gen, device=dev)
            for _ in range(2))
    q = q * 8.0
    o = fa.flash_fwd(q, k, v, causal, scale)[0]
    o_r = fa.blockwise_attention(q, k, v, causal=causal, scale=scale)[0]
    o64 = chip_smoke.attention_fp64(q, k, v, causal, scale)[0]
    rtol, atol = chip_smoke.TOL[torch.float32]["o"]
    share = (o - o_r).abs() / (atol + rtol * o_r.abs())
    truth = [((x.double() - o64).abs() / (atol + rtol * o64.abs())).max()
             .item() for x in (o, o_r)]
    return (share.max().item(), int((share > 1).sum()),
            (o.double() - o64).abs().max().item(),
            (o_r.double() - o64).abs().max().item(), *truth)


def plain_backward():
    """The plain backward on the card in place of K2 and K3 (a control)."""
    def dq(q, k, v, o, do, lse, causal, scale, block_size=512):
        r = fa.blockwise_attention_backward(q, k, v, o, lse, do, causal,
                                            scale, block_size)
        return r[0], r[3]

    def dkv(q, k, v, do, lse, delta, causal, scale, block_size=512):
        r = fa.blockwise_attention_backward(q, k, v, None, lse, do, causal,
                                            scale, block_size, delta=delta)
        return r[1], r[2]
    fa.flash_bwd_dq, fa.flash_bwd_dkv = dq, dkv


def plain_forward():
    """The plain forward (fp32 products on cuBLAS) in place of K1."""
    def fwd(q, k, v, causal, scale, block_size=512):
        o, lse = fa.blockwise_attention(q, k, v, causal=causal, scale=scale,
                                        block_size=block_size)
        return o.to(q.dtype), lse
    fa.flash_fwd = fwd


def fp64_forward(noise_seed=None):
    """o and lse of float64 (``chip_smoke.attention_fp64``) rounded to fp32
    in place of K1; with a seed, o times (1 + 2^-24 n) first, n standard
    normal from that seed: about half an ulp of fp32, to show how far the
    losses move with o's last bit alone."""
    def fwd(q, k, v, causal, scale, block_size=512):
        o, lse = chip_smoke.attention_fp64(q, k, v, causal, scale)
        if noise_seed is not None:
            gen = torch.Generator(device=o.device).manual_seed(noise_seed)
            o = o * (1 + 2.0 ** -24 * torch.randn(
                o.shape, generator=gen, device=o.device, dtype=o.dtype))
        return o.to(q.dtype).contiguous(), lse.float()
    fa.flash_fwd = fwd


CONTROLS = {"plain": plain_backward, "plain_fwd": plain_forward,
            "fp64_fwd": fp64_forward,
            **{f"fp64_fwd_ulp{i}": functools.partial(fp64_forward, i)
               for i in range(1, 5)}}


def _ptxas(name, lines, dtype, d):
    """ptxas' registers, spills and shared memory of K1-K3's instances at
    ``dtype`` and head dim ``d``."""
    mangled = {torch.float32: "f", torch.bfloat16: "13__nv_bfloat16",
               torch.float16: "6__half"}[dtype]
    for i, line in enumerate(lines):
        m = chip_smoke._INSTANCE.search(line)
        if "Compiling entry" in line and m and m.group(2) == mangled \
                and int(m.group(3)) == d:
            print(f"[ptxas] {name:<12} {m.group(1)} | "
                  f"{lines[i + 2].strip()} | {lines[i + 3].strip()}")


def main():
    if not torch.cuda.is_available():
        sys.exit("compare_flash_sources: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args, shape_name, dtype_name = list(sys.argv[1:]), "bert", "fp32"
    for flag in ("--shape", "--dtype"):
        if flag in args:
            i = args.index(flag)
            value = args[i + 1]
            del args[i:i + 2]
            if flag == "--shape":
                shape_name = value
            else:
                dtype_name = value
    dtype = DTYPES[dtype_name]
    controls = [a for a in args if a in CONTROLS]
    versions = dict(a.split("=", 1) for a in args if a not in CONTROLS)
    dev = torch.device("cuda")
    print(chip_smoke.card_line())
    for name, path in versions.items():
        _ptxas(name, use(path)["ptxas"].splitlines(), dtype,
               SHAPES[shape_name][3])
        if dtype != torch.float32:
            shape = SHAPES[shape_name]
            causal, scale = shape[4], 1.0 / math.sqrt(shape[3])
            q, k, v, g = _inputs(dev, shape, dtype, seed=23)
            o, lse = fa.flash_fwd(q, k, v, causal, scale)
            dq, delta = fa.flash_bwd_dq(q, k, v, o, g, lse, causal, scale)
            got = (dq,) + fa.flash_bwd_dkv(q, k, v, g, lse, delta, causal,
                                           scale)
            frob, _ = chip_smoke.bwd_frobenius(fa, q, k, v, o, lse, g,
                                               causal, got)
            print(f"[frob] {name:<12} {shape_name} {dtype_name} K2/K3 "
                  f"against the plain backward in fp32: "
                  + " ".join(f"{n} {e:.3e}" for n, e in frob.items()))
            del q, k, v, g, o, lse, dq, delta, got
            continue
        for q_mul in (1.0, 8.0):
            errs = chip_smoke.fp64_errors(fa, dev, q_mul)
            print(f"[fp64] {name:<12} q*{q_mul:g} relative Frobenius "
                  + " ".join(f"{n} {e:.3e}" for n, e in errs.items()))
        share, n_past, k1_err, plain_err, k1_sh, plain_sh = sharp_o(dev)
        print(f"[sharp] {name:<12} K1 o against plain: worst {share:.3f} of "
              f"the tolerance, {n_past} elements past it; largest |o - o64| "
              f"K1 {k1_err:.3e}, plain {plain_err:.3e}; against o64 worst "
              f"K1 {k1_sh:.3f}, plain {plain_sh:.3f} of the tolerance")
    timing(versions, dev, shape_name, dtype)
    runs = list(versions) + controls if controls else []
    for name in runs + runs[-2::-1]:          # a, b, ..., b, a
        print(f"[bert] {name}")
        saved = fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv
        if name in CONTROLS:
            CONTROLS[name]()
        else:
            use(versions[name])
        try:
            chip_smoke.phase_bert(tpt, fa, dev)
        except chip_smoke.CheckFailed as e:   # a control skips a kernel
            print(f"[bert] {name}: {e}")
        fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv = saved


if __name__ == "__main__":
    main()
