#!/usr/bin/env python3
"""K2 (dQ) and K3 (dK/dV) of versions of the flash-attention source, side
by side on one card.

    python3 scripts/compare_flash_sources.py NAME=path/to/flash_attention.cu ... [plain]

Each version is built by ``kernels.build`` in place of
``paddle_tpu_torch/csrc/flash_attention.cu`` and launched through the
port's wrappers. Per version it prints ptxas' report of K2 and K3 (fp32,
D=64); dq, dk and dv against float64 at BERT-base, plain and with q
scaled by 8 (``chip_smoke.fp64_errors``); the times of K2, K3 and the
pair (``chip_smoke.cuda_ms``), the versions in turns (a, b, ..., b, a)
ROUNDS times, median and least. ``plain`` adds the BERT-base O1 losses
of seed 0 and step_ms (``chip_smoke.phase_bert``) of each version, in
turns, with a control: the plain backward on the card in place of K2 and
K3. An earlier commit's source: ``git archive <commit> | tar -x -C
build/parent``.
"""
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
            chip_smoke.cuda_ms(k2, 50),
            chip_smoke.cuda_ms(lambda: fa.flash_bwd_dkv(
                q, k, v, g, lse, delta, causal, scale), 50),
            chip_smoke.cuda_ms(lambda: fa.flash_bwd_dkv(
                q, k, v, g, lse, k2()[1], causal, scale), 50)))
    for name, ts in times.items():
        cols = [f"{what} {statistics.median(x * 1e3 for x in col):.2f} us "
                f"(least {min(col) * 1e3:.2f})"
                for what, col in zip(("K2", "K3", "pair"), zip(*ts))]
        print(f"[time] {name:<12} " + "  ".join(cols) +
              f"  over {len(ts)} turns")


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


def main():
    if not torch.cuda.is_available():
        sys.exit("compare_flash_sources: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    control = "plain" in sys.argv[1:]
    versions = dict(a.split("=", 1) for a in sys.argv[1:] if a != "plain")
    dev = torch.device("cuda")
    print(chip_smoke.card_line())
    for name, path in versions.items():
        lines = use(path)["ptxas"].splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and any(
                    f"{fn}IfLi64" in line for fn in
                    ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")):
                print(f"[ptxas] {name:<12} {line.split('entry function')[-1]}"
                      f" | {lines[i + 2].strip()} | {lines[i + 3].strip()}")
        for q_mul in (1.0, 8.0):
            errs = chip_smoke.fp64_errors(fa, dev, q_mul)
            print(f"[fp64] {name:<12} q*{q_mul:g} relative Frobenius "
                  + " ".join(f"{n} {e:.3e}" for n, e in errs.items()))
    timing(versions, dev)
    runs = list(versions) + ["plain"] if control else []
    for name in runs + runs[-2::-1]:          # a, b, ..., b, a
        print(f"[bert] {name}")
        if name == "plain":
            saved = fa.flash_bwd_dq, fa.flash_bwd_dkv
            plain_backward()
        else:
            use(versions[name])
        try:
            chip_smoke.phase_bert(tpt, fa, dev)
        except chip_smoke.CheckFailed as e:   # the control launches no K2/K3
            print(f"[bert] {name}: {e}")
        if name == "plain":
            fa.flash_bwd_dq, fa.flash_bwd_dkv = saved


if __name__ == "__main__":
    main()
