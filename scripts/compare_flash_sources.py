#!/usr/bin/env python3
"""K1 (forward), K2 (dQ) and K3 (dK/dV) of versions of the flash-attention
source, side by side on one card.

    python3 scripts/compare_flash_sources.py NAME=path/to/flash_attention.cu ... [CONTROL ...]

Each version is built by ``kernels.build`` in place of
``paddle_tpu_torch/csrc/flash_attention.cu`` and launched through the
port's wrappers. Per version it prints ptxas' report of K1-K3 (fp32,
D=64); K1's o and lse and K2/K3's dq, dk and dv against float64 at
BERT-base, plain and with q scaled by 8 (``chip_smoke.fp64_errors``), and
K1's o element by element with q scaled by 8 (``sharp_o``); the times of
K1, K2, K3 and the K2 + K3 pair (``chip_smoke.cuda_ms``), the versions in
turns (a, b, ..., b, a) ROUNDS times, median and least. A CONTROL adds
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


def use(path):
    """The wrappers launch the version built from ``path`` from now on."""
    return kernels.build(sources={"flash_attention": path})["flash_attention"]


def timing(versions, dev):
    b, s, h, d, causal = chip_smoke.BERT_SHAPE
    scale = 1.0 / math.sqrt(d)
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v, g = (torch.randn(b, s, h, d, generator=gen, device=dev)
                  for _ in range(4))
    o, lse = fa.blockwise_attention(q, k, v, scale=scale)
    o = o.contiguous()
    k2 = lambda: fa.flash_bwd_dq(q, k, v, o, g, lse, causal, scale)  # noqa: E731
    times = {name: [] for name in versions}
    for name in (list(versions) + list(reversed(list(versions)))) * ROUNDS:
        use(versions[name])
        _, delta = k2()
        times[name].append((
            chip_smoke.cuda_ms(lambda: fa.flash_fwd(q, k, v, causal, scale),
                               50),
            chip_smoke.cuda_ms(k2, 50),
            chip_smoke.cuda_ms(lambda: fa.flash_bwd_dkv(
                q, k, v, g, lse, delta, causal, scale), 50),
            chip_smoke.cuda_ms(lambda: fa.flash_bwd_dkv(
                q, k, v, g, lse, k2()[1], causal, scale), 50)))
    for name, ts in times.items():
        cols = [f"{what} {statistics.median(x * 1e3 for x in col):.2f} us "
                f"(least {min(col) * 1e3:.2f})"
                for what, col in zip(("K1", "K2", "K3", "pair"), zip(*ts))]
        print(f"[time] {name:<12} " + "  ".join(cols) +
              f"  over {len(ts)} turns")


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


def main():
    if not torch.cuda.is_available():
        sys.exit("compare_flash_sources: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    controls = [a for a in sys.argv[1:] if a in CONTROLS]
    versions = dict(a.split("=", 1) for a in sys.argv[1:]
                    if a not in CONTROLS)
    dev = torch.device("cuda")
    print(chip_smoke.card_line())
    for name, path in versions.items():
        lines = use(path)["ptxas"].splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and any(
                    f"{fn}IfLi64" in line for fn in
                    chip_smoke.KERNEL_FN.values()):
                print(f"[ptxas] {name:<12} {line.split('entry function')[-1]}"
                      f" | {lines[i + 2].strip()} | {lines[i + 3].strip()}")
        for q_mul in (1.0, 8.0):
            errs = chip_smoke.fp64_errors(fa, dev, q_mul)
            print(f"[fp64] {name:<12} q*{q_mul:g} relative Frobenius "
                  + " ".join(f"{n} {e:.3e}" for n, e in errs.items()))
        share, n_past, k1_err, plain_err, k1_sh, plain_sh = sharp_o(dev)
        print(f"[sharp] {name:<12} K1 o against plain: worst {share:.3f} of "
              f"the tolerance, {n_past} elements past it; largest |o - o64| "
              f"K1 {k1_err:.3e}, plain {plain_err:.3e}; against o64 worst "
              f"K1 {k1_sh:.3f}, plain {plain_sh:.3f} of the tolerance")
    timing(versions, dev)
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
