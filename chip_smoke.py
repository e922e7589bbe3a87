#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (paddle_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when a check fails:
  1. the card: name, power limit and device count;
  2. build the flash-attention kernels from paddle_tpu_torch/csrc with nvcc
     (sm_90a) and print the build time, ptxas' register / shared-memory /
     spill report, each kernel's tensor-core (HMMA) instructions in its SASS
     (cuobjdump; every kernel must have some), and its blocks per SM and
     waves at the BERT-base grid;
  3. hold each kernel (K1 forward, K2 dQ, K3 dK/dV) against its plain
     PyTorch version on the card, in fp32 and bf16, at BERT-base's shape, at
     the cases of tests/test_flash_tpu.py (ragged S, D=128, causal), at
     Sq != Sk and at S = 17 and 65, also through the autograd Function;
     check that two launches of each kernel give the same bits, and that
     K1's o and lse and K2/K3's gradients at BERT-base hold fp32 accuracy
     against float64 (bounds that plain TF32 fails); the same checks
     against the plain versions in fp16; time each kernel at
     BERT-base in fp32 (what O1 feeds it) and in bf16 (what O2 feeds it)
     with CUDA events beside its bound (on fp32 inputs the 3xTF32 units
     it runs on, with the fp32 CUDA cores as a yardstick; on bf16 inputs
     the function's products at the bf16 tensor-core rate, with the TF32
     passes the kernel runs beside it), its plain version and torch's
     SDPA in the same dtype (a yardstick only; SDPA's backward stands
     beside the K2 + K3 pair);
  4. flash_route: the flash_attention op on inputs K1-K3 take only after
     the op pads or copies them (head dims 32 and 96, a strided q, an
     unaligned q) and in fp16, on the card against the CPU: each launches
     K1-K3 once and nothing takes the blockwise route;
  5. BERT-tiny (head dim 64) for 2 O0 steps on the card and on the CPU
     from the same weights: losses and parameters agree;
  6. tiny_o2: BERT-tiny at AMP O2 on the card against the CPU: bf16
     through amp.decorate and TrainStep with fp32 masters, AdamW,
     LinearWarmup, ClipGradByGlobalNorm(1.0) and weight decay, 3 steps
     (K1-K3 on bf16 inputs); then fp16 in the eager loop with GradScaler,
     where two forced overflows are skipped and the scale halves (K1-K3
     on fp16 inputs);
  7. the O1 main path: BERT-base pretraining through BertForPretraining,
     Momentum and TrainStep(amp_level="O1") at batch 16, seq 128 (as
     bench.py builds it), 2 warm-up and 5 timed steps; losses finite, step
     time, samples/s, peak memory and the kernels' launch counts (12 a step
     each);
  8. bert_o2, the main path of the O2 slice: BERT-base at AMP O2 bf16
     (amp.decorate, fp32 masters, AdamW with LinearWarmup(PolynomialDecay),
     ClipGradByGlobalNorm(1.0), weight decay 0.01), batch 16, seq 128, 2
     warm-up and 5 timed steps: step time, samples/s, peak memory,
     launches and host syncs of one profiled step; K1-K3 launched 12 times
     a step each on bf16 inputs, nothing on the blockwise route, the
     parameters bf16 and the masters fp32 and moved;
  9. resnet18 at 64 px, batch 4, for 2 O0 steps (Momentum 1e-2) on the
     card and on the CPU
     from the same weights, in NHWC and NCHW: losses, parameters and the
     BN running statistics agree (cuDNN's conv, batch norm and pool
     kernels against torch's CPU ones; TF32 off, cudnn.benchmark off);
  10. the second model of the main path: ResNet-50 training as bench.py
     runs it (resnet50(num_classes=1000), cross_entropy, Momentum(0.1,
     0.9), TrainStep(amp_level="O1"), batch 256, 224 px), NHWC then NCHW
     from the same weights and images, 2 warm-up and 5 timed steps each
     with cudnn.benchmark on; losses finite, the first near ln(1000) and
     the same in both layouts within bf16 noise; step time, images/s and
     peak memory. It runs no kernel of the port's own: XLA compiled the
     JAX package's conv, batch norm and pool ops, and the port leaves
     them to cuDNN and torch.
  11. detection_ops: every op of the detection module (yolo_box,
     multiclass_nms, matrix_nms, the prior generators, box_coder,
     iou_similarity, box_clip, roi_align, bipartite_match, yolov3_loss
     with its gradient) and leaky_relu, concat, transpose2 and
     interpolate on the card against the CPU from the same inputs;
     multiclass_nms exact, also on saturated ties and at YOLOv3-416's
     shape (10,647 boxes, 80 classes, nms_top_k 400);
  12. yolov3_tiny: YOLOv3 at full depth, 4 classes, 64 px, batch 2, on the
     card against the CPU, with the initial and with calibrated BN
     statistics: heads, boxes, scores and detections agree;
  13. yolov3: the third model of the main path, bench.py's YOLOv3-416
     inference leg (yolov3(num_classes=80), eval(), batch 1, 416 px,
     fp32, predict = network + yolo_box decode + multiclass NMS), with
     the bench's initial BN statistics and calibrated ones: latency over
     30 predicts, device time, launches and host syncs a predict, peak
     memory, NmsedNum, conv FLOPs and their bound, one timing with
     cuDNN's TF32 on; the initial statistics' detections equal on the
     card and the CPU. No kernel of the port's own: cuDNN and torch's.
  14. gpt_kernels (beside phase 3): K1-K3 at GPT-3 1.3B's shape (B4 S2048
     H16 D128, causal, bf16) against their plain versions, K2/K3's
     gradients by relative Frobenius error against the plain backward in
     fp32 (a bound that the same backward with its last key tile left
     out fails), bitwise determinism, blocks per SM and waves, CUDA-event
     times beside their bound over the causal triangle, and SDPA's bf16
     causal forward and backward;
  15. gpt_tiny: gpt_tiny from seed-0 weights on the card against the CPU,
     dense and with moe=True, num_experts=4: two O0 AdamW steps and three
     O2 bf16 steps (fp32 masters, warm-up and cosine, clip, decay):
     losses, aux losses and the parameters after the steps; then a cached
     decode on the card (prompt 16, 8 single-token steps) against the
     uncached forward;
  16. gpt_cache: GPT-3 1.3B (gpt3_1p3b) from seed 0 in fp32, eval(), batch
     1: a 128-token prompt through the blocks with a Cache (K1 once a
     layer), then 16 single-token steps (the q_offset route once a layer
     a step), against the uncached forward over all 144 tokens;
  17. gpt_o2, the main path of the GPT slice: that model at AMP O2 bf16
     (amp.decorate, fp32 masters, AdamW 0.9 / 0.95 with weight decay 0.1,
     GPT-3's warm-up and cosine schedule, ClipGradByGlobalNorm(1.0)),
     micro-batch 4 at seq 2048, 2 warm-up and 3 timed steps: losses near
     ln(50257), step time, samples/s, tokens/s, MFU, peak memory,
     launches, host syncs and device busy of one profiled step; K1-K3
     launched 24 times a step each on bf16 inputs, nothing on the
     blockwise route, the parameters bf16 and the masters fp32 and moved.
  18. static_flash: a static program (Program, append_backward, Executor)
     of one flash_attention op at BERT-base's shape in bf16 and mean: K1
     launches in the forward op and K2 and K3 in its grad op, once each a
     run, and o, dq, dk and dv equal the dygraph op's bit for bit;
  19. static_book: tests/test_book.py's six programs (fit_a_line,
     recognize_digits, word2vec, sentiment, label_semantic_roles,
     recommender) through Program -> append_backward -> SGD ops ->
     Executor on the card, each meeting its book threshold, against the
     port's CPU run from the same startup parameters and feeds; fit_a_line
     round-trips through save_inference_model / load_inference_model;
  20. static_resnet_tiny: the static ResNet builder at narrow widths
     (batch 4, 64 px) on the card against the CPU for two steps;
  21. static_resnet50, the main path of the static slice: the classic
     fluid ResNet-50 (static_resnet) in fp32 NCHW at batch 256, 224 px,
     Momentum(0.1, 0.9).minimize, 3 warm-up and 10 timed steps on one
     batch: step time, images/s, peak memory, launches and host syncs a
     step; the recompute grad route; the port's dygraph ResNet-50 at O0
     through jit.TrainStep on the same batch beside it; the loss finite
     and falling, the parameters and BN statistics moved.
The last two lines are the kernels' JSON record (each kernel at fp32,
its launches from phase 7; as <name>_bf16 at bf16, its launches from
phase 8; as <name>_gpt at GPT-3 1.3B's shape, its launches from phase
17) and {"ok": true, "device": {...}}. Phase 18 checks its own K1-K3
launches.
"""
import collections
import contextlib
import ctypes
import functools
import json
import math
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BYTES_S = 3.35e12                       # H100 SXM HBM3
PEAK_OPS_S = {torch.float32: 67e12,          # fp32, CUDA cores
              torch.bfloat16: 989e12}        # bf16 dense, tensor cores
# fp32 on the tensor cores as 3xTF32: three TF32 passes at 495 TFLOP/s
# (timed at fp32 only, what the O1 main path feeds the kernels)
PEAK_TC_OPS_S = {torch.float32: 495e12 / 3}
# the units each kernel's products run on; its bound_ms is theirs
UNITS = {name: ("tensor cores, 3xTF32", PEAK_TC_OPS_S)
         for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
FP16_TOL = (4e-3, 4e-3)      # a few fp16 ulps (11 significant bits)
TOL = {torch.float32: {"o": (1e-4, 1e-5), "grad": (2e-3, 3e-4)},
       torch.bfloat16: {"o": (2e-2, 2e-2), "grad": (2e-2, 2e-2)},
       torch.float16: {"o": FP16_TOL, "grad": FP16_TOL}}
CHECKED = (torch.float32, torch.bfloat16, torch.float16)
LSE_TOL = (1e-4, 1e-5)
# Relative Frobenius error of K1's o and K2/K3's dq, dk and dv against
# float64 at BERT-base fp32, by the factor q is scaled with (8: a sharp
# softmax). 3xTF32 reads about 1e-6 (o) and 2e-6 and 1e-5 (gradients)
# there; the same kernels in plain TF32 (the lo passes taken out) read
# 4e-4 to 3e-3 and fail the bound (tests/test_torch_kernels_cuda.py).
FP64_BOUND = {1.0: 3e-5, 8.0: 1.5e-4}
# lse moves less with an error of S than o does (a softmax-weighted mean
# of it, where o also takes P V's error), so it has a bound of its own:
# 3xTF32 reads about 4e-8 and 1e-7, plain TF32 1.2e-5 and 1.0e-4
LSE_FP64_BOUND = {1.0: 1e-6, 8.0: 1e-5}
BERT_SHAPE = (16, 128, 12, 64, False)        # B, S, H, D, causal
CASES = [(b, s, s, h, d, c) for (b, s, h, d, c) in [      # B, Sq, Sk, H, D, causal
         BERT_SHAPE,
         (2, 128, 12, 64, False), (1, 256, 4, 64, True),   # test_flash_tpu
         (2, 100, 3, 64, False), (1, 512, 8, 128, True),
         (2, 128, 2, 64, False), (2, 100, 3, 64, True),
         (1, 130, 2, 128, False),
         (2, 256, 8, 64, True), (1, 384, 4, 128, False),
         (2, 17, 3, 64, True), (2, 65, 2, 64, False)]] + [
         (1, 64, 192, 4, 64, False), (1, 64, 192, 4, 64, True),  # Sq != Sk
         (2, 130, 60, 3, 64, False), (2, 130, 60, 3, 64, True),
         (1, 130, 60, 2, 128, True)]
SOURCE = "paddle_tpu_torch/csrc/flash_attention.cu"
REPLACES = {"flash_fwd": "paddle_tpu/ops/flash_attention.py:217",
            "flash_bwd_dq": "paddle_tpu/ops/flash_attention.py:401",
            "flash_bwd_dkv": "paddle_tpu/ops/flash_attention.py:415"}
KERNEL_FN = {"flash_fwd": "flash_fwd_kernel",       # wrapper -> CUDA kernel
             "flash_bwd_dq": "flash_bwd_dq_kernel",
             "flash_bwd_dkv": "flash_bwd_dkv_kernel"}
PAIR = "flash_bwd_dq+flash_bwd_dkv"          # what SDPA's backward covers
# TF32 passes a kernel runs on bf16 inputs, over its products
# (flash_attention.cu:21-40): K1 S and P.V one each; K2 S and dP one, dQ
# (A = dS, fp32) two; K3 S^T and dP^T one, dV and dK (A = P^T, dS^T) two
TF32_PASSES_BF16 = {"flash_fwd": 2, "flash_bwd_dq": 4, "flash_bwd_dkv": 6}


class CheckFailed(RuntimeError):
    pass


def check(ok, what):
    if not ok:
        raise CheckFailed(what)


def err_of(got, want, rtol, atol, what):
    """Max abs / rel error of got against want; fails past the tolerance."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    abs_err = diff.max().item()
    rel_err = (diff / want.abs().clamp_min(1e-6)).max().item()
    ok = bool((diff <= atol + rtol * want.abs()).all()) and \
        bool(torch.isfinite(got).all())
    print(f"    {what:<6} max_abs {abs_err:.3e} max_rel {rel_err:.3e} "
          f"(rtol {rtol:g} atol {atol:g}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{what} outside tolerance")
    return abs_err


@functools.lru_cache(maxsize=None)
def _spin_cycles_per_ms():
    """GPU clock cycles a millisecond, from timing torch.cuda._sleep."""
    cycles = 10 ** 7
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return cycles / start.elapsed_time(end)


def cuda_ms(fn, n=20):
    """Mean device time of fn: CUDA events around n calls. The calls queue
    behind a spin kernel that outlasts the host's time to launch them, so
    the card runs them back to back and the host's launch cost (tens of
    microseconds a call, more than a kernel at these shapes) is not
    what gets timed."""
    fn()                          # a first call may load or tune
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    host_ms = (time.perf_counter() - t0) / 3 * 1e3
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    torch.cuda._sleep(int((2 * n * host_ms + 1.0) * _spin_cycles_per_ms()))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def causal_pairs(s, causal):
    """(query, key) pairs the scores need: s * s, or the s (s + 1) / 2 on
    and below the diagonal when causal."""
    return s * (s + 1) / 2 if causal else s * s


def bound(kernel, b, s, h, d, dtype, peak_ops=PEAK_OPS_S, causal=False):
    """Least time for the work: bytes (each input read once, each output
    written once) over the memory rate, operations over the peak rate of
    the input type in ``peak_ops`` (the fp32 CUDA cores by default,
    PEAK_TC_OPS_S for the tensor cores), the causal triangle's only when
    causal; returns (ms, "bytes" | "operations")."""
    el = torch.finfo(dtype).bits // 8
    t = b * s * h * d * el                       # one [B, S, H, D] tensor
    r = b * h * s * 4                            # one [B, H, S] fp32 row
    n_bytes, mm = {"flash_fwd": (4 * t + r, 2),  # q k v -> o, lse
                   "flash_bwd_dq": (6 * t + 2 * r, 3),  # q k v o dO lse -> dq delta
                   "flash_bwd_dkv": (6 * t + 2 * r, 4)}[kernel]  # q k v dO lse delta -> dk dv
    ops = 2 * mm * b * h * causal_pairs(s, causal) * d  # mm products
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = ops / peak_ops[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


_INSTANCE = re.compile(
    r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)I(f|13__nv_bfloat16|6__half)"
    r"Li(\d+)E")
# mangled template argument -> name, in the order of the dtype codes
# flash_attention.cu dispatches on (0, 1, 2)
_DTYPE_NAME = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16"}


def hmma_counts(path):
    """(tensor-core HMMA instructions, all instructions) in each kernel's
    SASS, by (kernel, "f32" | "bf16" | "f16", D), from cuobjdump
    --dump-sass."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", str(path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, key = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = _INSTANCE.search(line)
            key = m and (m.group(1), _DTYPE_NAME[m.group(2)],
                         int(m.group(3)))
            if key:
                counts[key] = [0, 0]
        elif key and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[key][1] += 1
            counts[key][0] += "HMMA" in line
    return counts


def occupancy(lib, which, dtype_code, d):
    """(blocks an SM holds, threads a block, dynamic shared bytes, rows a
    tile) of kernel ``which`` (0 K1, 1 K2, 2 K3), from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    info = (ctypes.c_int * 4)()
    err = lib.ptt_flash_occupancy(which, dtype_code, d,
                                  ctypes.addressof(info))
    check(err == 0, f"occupancy query failed: CUDA error {err}")
    return tuple(info)


def phase_build(kernels):
    t0 = time.perf_counter()
    log = kernels.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s wall")
    for name, entry in log.items():
        print(f"[build] {name}.cu nvcc {entry['seconds']:.1f} s")
        for line in entry["ptxas"].splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill", "smem")):
                print(f"[build]   {line.strip()}")
    counts = hmma_counts(kernels._target("flash_attention"))
    for key in sorted(counts):
        hmma, total = counts[key]
        print(f"[build] {key[0]} {key[1]} D{key[2]}: {hmma} HMMA "
              f"(tensor-core) instructions of {total} in its SASS")
    for fn in KERNEL_FN.values():
        for dname in _DTYPE_NAME.values():
            for d in (64, 128):
                key = (fn, dname, d)
                check(counts.get(key, [0])[0] > 0,
                      f"{key}: no HMMA in its SASS")
    lib = kernels.library("flash_attention")
    b, s, h, d, _ = BERT_SHAPE
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for which, wrapper in enumerate(REPLACES):
        for dtype_code, dname in enumerate(_DTYPE_NAME.values()):
            blocks, threads, smem, rows = occupancy(lib, which, dtype_code, d)
            grid = b * h * -(-s // rows)
            print(f"[build] {KERNEL_FN[wrapper]} {dname} D{d}: {blocks} "
                  f"blocks/SM ({threads} threads, {smem} B shared); BERT-base "
                  f"grid {grid} blocks on {sms} SMs = "
                  f"{grid / (blocks * sms):.3f} waves")


def kernels_against_plain(fa, q, k, v, g, causal, dtype):
    """K1, K2 and K3 through their wrappers against the plain versions on
    the same inputs, at ``TOL[dtype]``. Returns the largest error of each
    wrapper and the plain versions' (o, dq, dk, dv)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    tol = TOL[dtype]
    o, lse = fa.flash_fwd(q, k, v, causal, scale)
    o_r, lse_r = fa.blockwise_attention(q, k, v, causal=causal, scale=scale)
    torch.cuda.synchronize()
    errs = {"flash_fwd": max(err_of(o, o_r, *tol["o"], "o"),
                             err_of(lse, lse_r, *LSE_TOL, "lse"))}
    # kernels first: their outputs cannot reuse a freed buffer that
    # already holds the plain version's answer
    o_r = o_r.to(dtype)
    dq, delta = fa.flash_bwd_dq(q, k, v, o_r, g, lse_r, causal, scale)
    delta_r = torch.einsum("bqhd,bqhd->bhq", g.float(), o_r.float())
    dk, dv = fa.flash_bwd_dkv(q, k, v, g, lse_r, delta_r, causal, scale)
    dq_r, dk_r, dv_r, _ = fa.blockwise_attention_backward(
        q, k, v, o_r, lse_r, g, causal, scale)
    torch.cuda.synchronize()
    errs["flash_bwd_dq"] = max(err_of(delta, delta_r, *tol["o"], "delta"),
                               err_of(dq, dq_r, *tol["grad"], "dq"))
    errs["flash_bwd_dkv"] = max(err_of(dk, dk_r, *tol["grad"], "dk"),
                                err_of(dv, dv_r, *tol["grad"], "dv"))
    return errs, (o_r, dq_r, dk_r, dv_r)


def phase_kernels(fa, dev):
    """Returns the largest error of each kernel by (wrapper, dtype)."""
    errs = {(w.__name__, dt): 0.0 for w in fa.WRAPPERS for dt in CHECKED}
    for (b, sq, sk, h, d, causal) in CASES:
        for dtype in CHECKED:
            gen = torch.Generator(device=dev).manual_seed(b * sq + sk + h + d)
            q, k, v, g = (torch.randn(b, n, h, d, generator=gen, device=dev)
                          .to(dtype) for n in (sq, sk, sk, sq))
            tol = TOL[dtype]
            print(f"[check] B{b} Sq{sq} Sk{sk} H{h} D{d} causal={causal} "
                  f"{str(dtype).split('.')[-1]}")
            found, want = kernels_against_plain(fa, q, k, v, g, causal, dtype)
            for name, e in found.items():
                errs[name, dtype] = max(errs[name, dtype], e)
            # the autograd Function end to end (K1, then K2 and K3)
            qa, ka, va = (t.detach().requires_grad_() for t in (q, k, v))
            out = fa.flash_attention(qa, ka, va, causal=causal)
            out.backward(g)
            torch.cuda.synchronize()
            for name, got, ref in zip(("fn.o", "fn.dq", "fn.dk", "fn.dv"),
                                      (out, qa.grad, ka.grad, va.grad),
                                      want):
                err_of(got, ref, *tol["o" if name == "fn.o" else "grad"],
                       name)
    return errs


def phase_determinism(fa, dev):
    """No atomics in K1-K3: two launches on the same inputs give the same
    bits."""
    for (b, sq, sk, h, d, causal) in (CASES[0], (2, 130, 60, 3, 64, True)):
        gen = torch.Generator(device=dev).manual_seed(5)
        q, k, v, g = (torch.randn(b, n, h, d, generator=gen, device=dev)
                      for n in (sq, sk, sk, sq))
        scale = 1.0 / math.sqrt(d)
        fwd = [fa.flash_fwd(q, k, v, causal, scale) for _ in range(2)]
        o, lse = fwd[0]
        runs = []
        for _ in range(2):
            dq, delta = fa.flash_bwd_dq(q, k, v, o, g, lse, causal, scale)
            runs.append((dq, delta) + fa.flash_bwd_dkv(
                q, k, v, g, lse, delta, causal, scale))
        torch.cuda.synchronize()
        same = {"K1": all(torch.equal(x, y) for x, y in zip(*fwd)),
                "K2/K3": all(torch.equal(x, y) for x, y in zip(*runs))}
        print(f"[determinism] B{b} Sq{sq} Sk{sk} causal={causal}: two "
              f"launches of " + ", ".join(
                  f"{n} {'bitwise equal' if ok else 'DIFFER'}"
                  for n, ok in same.items()))
        check(all(same.values()), f"not bitwise deterministic: {same}")


def attention_fp64(q, k, v, causal, scale):
    """(o [B, Sq, H, D], lse [B, H, Sq]) of softmax(mask(q k^T scale)) v in
    float64: the function K1 computes, causal keeping key j for row i
    when j <= i (no offset, as the reference's kernels), a row with no key
    giving o = 0 and lse = -inf."""
    qd, kd, vd = (t.double() for t in (q, k, v))
    sc = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * scale
    if causal:
        rows = torch.arange(sc.shape[-2], device=sc.device)[:, None]
        cols = torch.arange(sc.shape[-1], device=sc.device)[None, :]
        sc = sc.masked_fill(cols > rows, float("-inf"))
    lse = torch.logsumexp(sc, -1)
    p = torch.nan_to_num(torch.exp(sc - lse[..., None]))
    return torch.einsum("bhqk,bkhd->bqhd", p, vd), lse


def fp64_errors(fa, dev, q_mul):
    """Relative Frobenius error, through the wrappers, against float64 at
    BERT-base, fp32 inputs with q scaled by q_mul: K1's o and lse against
    attention_fp64; K2/K3's dq, dk and dv from o and lse of float64
    rounded to fp32, the reference the exact function of those fp32
    inputs."""
    b, s, h, d, causal = BERT_SHAPE
    scale = 1.0 / math.sqrt(d)
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v, g = (torch.randn(b, s, h, d, generator=gen, device=dev)
                  for _ in range(4))
    q = q * q_mul
    o1, lse1 = fa.flash_fwd(q, k, v, causal, scale)
    o64, lse64 = attention_fp64(q, k, v, causal, scale)
    qd, kd, vd, gd = (t.double() for t in (q, k, v, g))
    sc = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * scale
    lse = torch.logsumexp(sc, -1).float()
    p = torch.exp(sc - lse.double()[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, vd).float().contiguous()
    delta = torch.einsum("bqhd,bqhd->bhq", gd, o.double())
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", gd, vd)
              - delta[..., None]) * scale
    want = (torch.einsum("bhqk,bkhd->bqhd", ds, kd),
            torch.einsum("bhqk,bqhd->bkhd", ds, qd),
            torch.einsum("bhqk,bqhd->bkhd", p, gd))
    dq, delta32 = fa.flash_bwd_dq(q, k, v, o, g, lse, causal, scale)
    got = (o1, lse1, dq) + fa.flash_bwd_dkv(q, k, v, g, lse, delta32, causal,
                                            scale)
    return {name: ((x.double() - y).norm() / y.norm()).item()
            for name, x, y in zip(("o", "lse", "dq", "dk", "dv"), got,
                                  (o64, lse64, *want))}


def fp64_bound(name, q_mul):
    return (LSE_FP64_BOUND if name == "lse" else FP64_BOUND)[q_mul]


def phase_fp64(fa, dev):
    """fp32 accuracy on TF32 tensor cores: K1-K3 against float64 within
    bounds that plain TF32 does not meet."""
    for q_mul in FP64_BOUND:
        errs = fp64_errors(fa, dev, q_mul)
        bad = [n for n, e in errs.items() if e > fp64_bound(n, q_mul)]
        print(f"[fp64] BERT-base q*{q_mul:g}: relative Frobenius error "
              + " ".join(f"{n} {e:.3e}" for n, e in errs.items())
              + f" (bounds lse {LSE_FP64_BOUND[q_mul]:g}, others "
              f"{FP64_BOUND[q_mul]:g}) {'FAIL ' + str(bad) if bad else 'ok'}")
        check(not bad, f"K1-K3 against float64 at q*{q_mul:g}: {errs}")


def bound_tf32_passes(kernel, b, s, h, d, causal=False):
    """K1-K3's own bound on bf16 inputs: bytes at 2 an element against
    the TF32 passes they run on them (flash_attention.cu:21-40: a product
    of two staged bf16 tiles is exact in TF32 and takes one pass, one
    whose A is the fp32 P or dS takes two, and K1 rounds P to bf16)."""
    t_bytes, _ = bound(kernel, b, s, h, d, torch.bfloat16,
                       {torch.bfloat16: math.inf})
    t_ops = (TF32_PASSES_BF16[kernel] * 2 * b * h * causal_pairs(s, causal)
             * d / 495e12 * 1e3)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_timing(fa, dev, dtype, shape=BERT_SHAPE, n=20):
    """K1-K3 at ``shape`` (B, S, H, D, causal; BERT-base unless given) in
    ``dtype`` (fp32, what O1 feeds them; bf16, what O2 feeds them): CUDA
    events (means of ``n`` calls) beside their bound, a second bound
    (fp32: the CUDA cores; bf16: the TF32 passes the kernels run), their
    plain versions and SDPA in the same dtype."""
    b, s, h, d, causal = shape
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v, g = (torch.randn(b, s, h, d, generator=gen, device=dev)
                  .to(dtype) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    o, lse = fa.flash_fwd(q, k, v, causal, scale)
    _, delta = fa.flash_bwd_dq(q, k, v, o, g, lse, causal, scale)
    plain_fwd = cuda_ms(lambda: fa.blockwise_attention(
        q, k, v, causal=causal, scale=scale), n)
    plain_bwd = cuda_ms(lambda: fa.blockwise_attention_backward(
        q, k, v, o, lse, g, causal, scale), n)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_fwd = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=causal), n)
    qr, kr, vr = (t.detach().requires_grad_() for t in (qt, kt, vt))
    out = sdpa(qr, kr, vr, is_causal=causal)
    gt = g.transpose(1, 2)
    sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(
        out, (qr, kr, vr), gt, retain_graph=True), n)

    def pair():
        _, delta_ = fa.flash_bwd_dq(q, k, v, o, g, lse, causal, scale)
        fa.flash_bwd_dkv(q, k, v, g, lse, delta_, causal, scale)

    timed = {
        "flash_fwd": (cuda_ms(lambda: fa.flash_fwd(q, k, v, causal, scale),
                              n), plain_fwd, sdpa_fwd),
        "flash_bwd_dq": (cuda_ms(lambda: fa.flash_bwd_dq(
            q, k, v, o, g, lse, causal, scale), n), plain_bwd, sdpa_bwd),
        "flash_bwd_dkv": (cuda_ms(lambda: fa.flash_bwd_dkv(
            q, k, v, g, lse, delta, causal, scale), n), plain_bwd,
            sdpa_bwd),
    }
    pair_ms = cuda_ms(pair, n)
    dname = str(dtype).split(".")[-1]
    rows = {}
    shape_of = f"B{b} S{s} H{h} D{d}" + (" causal" if causal else "")
    for name, (ms, plain_ms, lib_ms) in timed.items():
        if dtype == torch.float32:
            units, peak = UNITS[name]
            bound_ms, bound_by = bound(name, b, s, h, d, dtype, peak, causal)
            # the fp32 yardstick keeps shares comparable with the
            # CUDA-core kernels of before
            yard = "bound_fp32_cores"
            y_ms, y_by = bound(name, b, s, h, d, dtype, causal=causal)
        else:
            # the function's own products at the bf16 tensor-core rate
            units = "tensor cores, bf16 rate"
            bound_ms, bound_by = bound(name, b, s, h, d, dtype,
                                       causal=causal)
            # the TF32 passes the kernels run on bf16 inputs
            yard = "bound_tf32_passes"
            y_ms, y_by = bound_tf32_passes(name, b, s, h, d, causal)
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": lib_ms,
                      "dtype": dname, "shape": shape_of, "bound_units": units,
                      yard + "_ms": y_ms, yard + "_by": y_by}
        if name != "flash_fwd":
            rows[name]["library_covers"] = PAIR
        print(f"[time] {shape_of} {dname} {name:<14} {ms:.4f} ms  bound "
              f"{bound_ms:.4f} ms ({bound_by}, {units}; "
              f"{bound_ms / ms:.1%})  {yard} {y_ms:.4f} ms ({y_by}; "
              f"{y_ms / ms:.1%})  plain {plain_ms:.4f} ms  library "
              f"{'null' if lib_ms is None else f'{lib_ms:.4f} ms'}")
    print(f"[time] {shape_of} {dname} K2 + K3 pair {pair_ms:.4f} ms "
          f"against SDPA backward (dq, dk, dv in one call) "
          f"{sdpa_bwd:.4f} ms: "
          f"{pair_ms / sdpa_bwd:.3f}x; K1 against SDPA forward "
          f"{timed['flash_fwd'][0] / sdpa_fwd:.3f}x; the plain backward "
          f"above computes all three")
    return rows


def _tiny_run(tpt, device, state, batch):
    from paddle_tpu_torch.convert import load_state_dict
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.text.models import BertForPretraining
    tpt.set_device(device)
    model = load_state_dict(BertForPretraining(**TINY), state)
    step = TrainStep(model, step_fn, Momentum(
        learning_rate=1e-2, momentum=0.9, parameters=model.parameters()),
        amp_level="O0")
    losses = [float(step(*batch)) for _ in range(2)]
    return losses, {k: v.detach().cpu() for k, v in
                    model.state_dict().items()}


TINY = dict(vocab_size=512, d_model=128, num_layers=2, nhead=2, d_ffn=256,
            dropout=0.0)


def step_fn(m, ids, labels, nsp):
    return m(ids, masked_lm_labels=labels, next_sentence_label=nsp)


def make_batch(gen, dev, b, s, vocab):
    """bench.py's synthetic batch: ids, 15% MLM labels (-1 elsewhere) and
    an NSP label, int32, made on the device."""
    ids = torch.randint(0, vocab, (b, s), generator=gen, device=dev,
                        dtype=torch.int32)
    mask = torch.rand((b, s), generator=gen, device=dev) < 0.15
    labels = torch.where(mask, ids, -1).to(torch.int32)
    nsp = torch.randint(0, 2, (b, 1), generator=gen, device=dev,
                        dtype=torch.int32)
    return ids, labels, nsp


def phase_tiny(tpt, dev):
    """The port on the card (kernels) against the port on the CPU (plain
    versions): BERT-tiny, 2 O0 steps from the same weights."""
    from paddle_tpu_torch.text.models import BertForPretraining
    tpt.set_device("cpu")
    tpt.seed(1)
    state = {k: v.numpy().copy() for k, v in
             BertForPretraining(**TINY).state_dict().items()}
    gen = torch.Generator().manual_seed(3)
    batch = make_batch(gen, "cpu", 2, 100, TINY["vocab_size"])
    cpu_losses, cpu_params = _tiny_run(tpt, "cpu", state, batch)
    gpu_losses, gpu_params = _tiny_run(tpt, dev, state,
                                       tuple(t.to(dev) for t in batch))
    print(f"[tiny] losses card {gpu_losses} cpu {cpu_losses}")
    err_of(torch.tensor(gpu_losses), torch.tensor(cpu_losses), 1e-4, 1e-5,
           "loss")
    worst = max((gpu_params[n] - cpu_params[n]).abs().max().item()
                for n in cpu_params)
    ok = all(torch.allclose(gpu_params[n], cpu_params[n], rtol=1e-4,
                            atol=2e-5) for n in cpu_params)
    print(f"[tiny] params after 2 steps: max_abs {worst:.3e} "
          f"(rtol 1e-4 atol 2e-5) {'ok' if ok else 'FAIL'}")
    check(ok, "BERT-tiny params on the card disagree with the CPU")


def phase_bert(tpt, fa, dev):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.text.models import BertForPretraining
    batch, seq, warmup, steps = 16, 128, 2, 5
    tpt.set_device(dev)
    tpt.seed(0)
    t0 = time.perf_counter()
    model = BertForPretraining(dropout=0.0)          # BERT-base widths
    opt = Momentum(learning_rate=1e-4, momentum=0.9,
                   parameters=model.parameters())
    train = TrainStep(model, step_fn, opt, amp_level="O1").ensure_state()
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device=dev).manual_seed(0)
    batches = [make_batch(gen, dev, batch, seq, 30522) for _ in range(4)]
    torch.cuda.synchronize()
    print(f"[bert] BERT-base {n_params} params built in "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    for w in fa.WRAPPERS:
        w.launches = 0
    losses = [float(train(*batches[i % 4])) for i in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = [train(*batches[(warmup + i) % 4]) for i in range(steps)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    launches = {w.__name__: w.launches for w in fa.WRAPPERS}
    losses += [float(x) for x in out]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[bert] losses {losses}")
    print(f"[bert] step_ms {step_s * 1e3:.3f}  samples/s "
          f"{batch / step_s:.2f}  peak_mem {peak:.3f} GiB")
    n_steps = warmup + steps
    print(f"[bert] launches over {n_steps} steps: {launches} "
          f"(expected {12 * n_steps}: 12 layers a step, each kernel once)")
    check(all(math.isfinite(x) for x in losses), "non-finite loss")
    check(abs(losses[0] - (math.log(30522) + math.log(2))) < 2.0,
          "first loss far from ln(vocab) + ln(2)")
    for name, n in launches.items():
        check(n == 12 * n_steps, f"{name}: {n} launches, expected "
              f"{12 * n_steps} (12 a step)")
    return launches


# inputs K1-K3 take only after the flash_attention op pads the head dim
# or copies q, and fp16: (label, B, S, H, D, dtype, layout of q: "bshd",
# "strided" (columns of a tensor twice as wide), "unaligned" (4 bytes
# past 16-byte alignment))
FLASH_ROUTE_CASES = [("head dim 32", 2, 128, 8, 32, torch.float32, "bshd"),
                     ("head dim 96", 2, 128, 4, 96, torch.bfloat16, "bshd"),
                     ("fp16", 2, 128, 12, 64, torch.float16, "bshd"),
                     ("non-contiguous q", 2, 128, 12, 64, torch.float32,
                      "strided"),
                     ("unaligned q", 2, 128, 12, 64, torch.float32,
                      "unaligned")]


@contextlib.contextmanager
def op_dtypes():
    """While active, counts the dtypes of q, k and v the flash_attention
    op is called with."""
    from paddle_tpu_torch.core.registry import OpInfoMap
    opdef = OpInfoMap.instance().get("flash_attention")
    real = opdef.compute
    seen = collections.Counter()

    def spy(inputs, attrs):
        seen[tuple(str(inputs[s][0].dtype).split(".")[-1]
                   for s in ("Q", "K", "V"))] += 1
        return real(inputs, attrs)
    opdef.compute = spy
    try:
        yield seen
    finally:
        opdef.compute = real


def _flash_op(fa, dev, ts, causal, layout):
    """The flash_attention op on ``dev``: (o, dq, dk, dv) in fp32 on the
    CPU, the op's blockwise-route calls and the wrappers' launches."""
    from paddle_tpu_torch.core.registry import OpInfoMap
    q, k, v, g = (t.to(dev) for t in ts)
    b, s, h, d = q.shape
    if layout == "strided":       # q as columns of a tensor twice as wide
        q = torch.cat([q.reshape(b, s, h * d)] * 2, -1)[..., :h * d].view(
            b, s, h, d)
        check(not q.is_contiguous(), "the strided q is contiguous")
    elif layout == "unaligned":
        flat = torch.empty(q.numel() + 8, dtype=q.dtype, device=dev)
        off = (-flat.data_ptr() % 16 + 4) // q.element_size()
        q = flat[off:off + q.numel()].view(b, s, h, d).copy_(q)
        check(q.is_contiguous() and q.data_ptr() % 16 == 4,
              "the unaligned q is aligned")
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    calls = fa.blockwise_route.calls
    launches = [w.launches for w in fa.WRAPPERS]
    out = OpInfoMap.instance().get("flash_attention").compute(
        {"Q": leaves[:1], "K": leaves[1:2], "V": leaves[2:]},
        {"causal": causal})["Out"][0]
    (out.float() * g.float()).sum().backward()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    got = [x.detach().float().cpu() for x in (out, *(t.grad for t in leaves))]
    return (got, fa.blockwise_route.calls - calls,
            [w.launches - n for w, n in zip(fa.WRAPPERS, launches)])


def phase_flash_route(fa, dev):
    """The flash_attention op on inputs K1-K3 take only after the op pads
    or copies them, and in fp16, on the card against the CPU: K1-K3 are
    launched once each, and nothing takes the blockwise route."""
    for label, b, s, h, d, dtype, layout in FLASH_ROUTE_CASES:
        gen = torch.Generator().manual_seed(17)
        ts = [torch.randn(b, s, h, d, generator=gen).to(dtype)
              for _ in range(4)]
        tol = TOL[dtype]
        for causal in (False, True):
            want, cpu_calls, _ = _flash_op(fa, torch.device("cpu"), ts,
                                           causal, layout)
            got, calls, launches = _flash_op(fa, dev, ts, causal, layout)
            print(f"[flash_route] {label} B{b} S{s} H{h} D{d} "
                  f"causal={causal}: K1-K3 launches {launches}, "
                  f"blockwise-route calls card {calls} cpu {cpu_calls}")
            check(calls == cpu_calls == 0 and launches == [1, 1, 1],
                  f"{label}: K1-K3 not launched once each")
            for name, x, y in zip(("o", "dq", "dk", "dv"), got, want):
                err_of(x, y, *tol["o" if name == "o" else "grad"], name)


# the O2 comparisons of tests/test_torch_bert_o2.py: a parameter's master
# by the norm of its update error (Adam scales a gradient element that is
# rounding noise to about lr); the key bias, whose exact gradient is 0,
# is left out
O2_UPDATE_TOL = 2.0 ** -2
O2_LOSS_TOL = (4e-3, 1e-5)
ZERO_GRAD = ".self_attn.k_bias"


def o2_update_errors(got, want, start, zero_grad=ZERO_GRAD):
    """(worst name, worst, median) of update_error over the masters, the
    key biases (exact gradient 0) left out."""
    errs = {n: update_error(got[n], want[n], start[n]) for n in want
            if not n.endswith(zero_grad)}
    worst = max(errs, key=errs.get)
    return worst, errs[worst], sorted(errs.values())[len(errs) // 2]


def _o2_opt(model, lr_sched, clip=1.0):
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
    return AdamW(learning_rate=lr_sched, weight_decay=0.01,
                 grad_clip=ClipGradByGlobalNorm(clip),
                 parameters=model.parameters())


def _tiny_o2_run(tpt, fa, device, state, batch, steps=3):
    """BERT-tiny through TrainStep at O2 bf16 with AdamW, LinearWarmup,
    ClipGradByGlobalNorm(1.0) and weight decay 0.01."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.convert import load_state_dict
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer.lr import LinearWarmup, PolynomialDecay
    from paddle_tpu_torch.text.models import BertForPretraining
    tpt.set_device(device)
    model = load_state_dict(BertForPretraining(**TINY), state)
    sched = LinearWarmup(PolynomialDecay(1e-2, 10, 0.0), 2, 2e-3, 1e-2)
    model, opt = amp.decorate(model, _o2_opt(model, sched), level="O2")
    step = TrainStep(model, step_fn, opt, amp_level="O2")
    calls = fa.blockwise_route.calls
    launches = [w.launches for w in fa.WRAPPERS]
    losses = []
    with op_dtypes() as seen:
        for _ in range(steps):
            losses.append(float(step(*batch)))
            sched.step()
    check(all(p.dtype == torch.bfloat16 for p in model.parameters()) and
          all(m.dtype == torch.float32 for m in step._masters.values()),
          "O2: parameters not bf16 or masters not fp32")
    return (losses, {n: m.cpu() for n, m in step._masters.items()},
            fa.blockwise_route.calls - calls,
            [w.launches - n for w, n in zip(fa.WRAPPERS, launches)], seen)


def _tiny_fp16_run(tpt, fa, device, state, batch, plan):
    """BERT-tiny at O2 fp16 in the eager loop with GradScaler: auto_cast,
    scale, backward, step, clear_grad; a step marked in ``plan`` gets an
    inf in one gradient after its backward. Returns the losses, the
    scale after each step, which steps left every parameter as it was,
    the masters, and the route counts."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.convert import load_state_dict
    from paddle_tpu_torch.text.models import BertForPretraining
    tpt.set_device(device)
    model = load_state_dict(BertForPretraining(**TINY), state)
    model, opt = amp.decorate(model, _o2_opt(model, 1e-3), level="O2",
                              dtype="float16")
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 10,
                            decr_every_n_nan_or_inf=2)
    calls = fa.blockwise_route.calls
    launches = [w.launches for w in fa.WRAPPERS]
    losses, scales, skipped = [], [], []
    with op_dtypes() as seen:
        for forced in plan:
            before = [p.detach().clone() for p in model.parameters()]
            with amp.auto_cast(level="O2", dtype="float16"):
                loss = step_fn(model, *batch)
            scaler.scale(loss).backward()
            if forced:
                with torch.no_grad():
                    model.bert.embeddings.word.weight.grad[0, 0] = math.inf
            scaler.step(opt)
            opt.clear_grad()
            losses.append(float(loss.detach()))
            scales.append(scaler.get_loss_scaling())
            skipped.append(all(torch.equal(a, p) for a, p in
                               zip(before, model.parameters())))
    check(all(p.dtype == torch.float16 for p in model.parameters()),
          "fp16 O2: parameters not fp16")
    masters = {n: opt._masters[i].cpu() for i, (n, _) in
               enumerate(model.named_parameters()) if i in opt._masters}
    return (losses, scales, skipped, masters,
            fa.blockwise_route.calls - calls,
            [w.launches - n for w, n in zip(fa.WRAPPERS, launches)], seen)


def phase_tiny_o2(tpt, fa, dev):
    """BERT-tiny (head dim 64) at O2 on the card against the CPU from the
    same weights: bf16 through TrainStep, then fp16 in the eager loop with
    GradScaler, where two forced overflows are skipped and the second
    halves the scale. K1-K3 run once a layer a step on the card, on bf16
    and then fp16 inputs; nothing takes the blockwise route."""
    from paddle_tpu_torch.text.models import BertForPretraining
    tpt.set_device("cpu")
    tpt.seed(1)
    state = {k: v.numpy().copy() for k, v in
             BertForPretraining(**TINY).state_dict().items()}
    gen = torch.Generator().manual_seed(3)
    batch = make_batch(gen, "cpu", 2, 128, TINY["vocab_size"])
    card_batch = tuple(t.to(dev) for t in batch)
    n_layers = TINY["num_layers"]
    for dtype in (torch.bfloat16, torch.float16):
        dname = str(dtype).split(".")[-1]
        start = {k: torch.from_numpy(v).to(dtype).float()
                 for k, v in state.items()}
        if dtype == torch.bfloat16:
            steps = 3
            cpu = _tiny_o2_run(tpt, fa, "cpu", state, batch, steps)
            card = _tiny_o2_run(tpt, fa, dev, state, card_batch, steps)
            losses, masters, calls, launches, seen = card
            want_l, want_m = cpu[0], cpu[1]
            print(f"[tiny_o2] bf16 TrainStep: losses card {losses} cpu "
                  f"{want_l}")
        else:
            plan = [False, True, True, False, False]
            steps = len(plan)
            cpu = _tiny_fp16_run(tpt, fa, "cpu", state, batch, plan)
            card = _tiny_fp16_run(tpt, fa, dev, state, card_batch, plan)
            losses, scales, skipped, masters, calls, launches, seen = card
            want_l, want_m = cpu[0], cpu[3]
            print(f"[tiny_o2] fp16 GradScaler: losses card {losses} cpu "
                  f"{want_l}; scale after each step card {scales} cpu "
                  f"{cpu[1]}; skipped card {skipped} cpu {cpu[2]}")
            check(scales == cpu[1] == [1024.0, 1024.0, 512.0, 512.0, 512.0],
                  "fp16: the scale did not halve after two overflows")
            check(skipped == cpu[2] == plan, "fp16: skipped steps wrong")
        print(f"[tiny_o2] {dname}: K1-K3 launches {launches}, flash op "
              f"q/k/v dtypes {dict(seen)}, blockwise-route calls {calls}")
        check(launches == [n_layers * steps] * 3 and calls == 0 and
              dict(seen) == {(dname,) * 3: n_layers * steps},
              f"{dname} O2: K1-K3 not launched on {dname} inputs every "
              f"layer")
        err_of(torch.tensor(losses), torch.tensor(want_l), *O2_LOSS_TOL,
               "loss")
        worst, err, median = o2_update_errors(masters, want_m, start)
        print(f"[tiny_o2] {dname}: masters' update error card against CPU "
              f"worst {err:.3e} ({worst}), median {median:.3e} (bound "
              f"{O2_UPDATE_TOL:g})")
        check(err <= O2_UPDATE_TOL, f"{dtype} O2 masters disagree: {worst}")


def phase_bert_o2(tpt, fa, dev):
    """The main path of this slice: BERT-base pretraining at AMP O2 bf16
    through amp.decorate and TrainStep(amp_level="O2"), with fp32
    masters, AdamW, LinearWarmup(PolynomialDecay), a global-norm clip
    and weight decay, at batch 16, seq 128."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer.lr import LinearWarmup, PolynomialDecay
    from paddle_tpu_torch.text.models import BertForPretraining
    batch, seq, warmup, steps = 16, 128, 2, 5
    tpt.set_device(dev)
    tpt.seed(0)
    t0 = time.perf_counter()
    model = BertForPretraining(dropout=0.0)          # BERT-base widths
    sched = LinearWarmup(PolynomialDecay(1e-4, 1000, 0.0), 10, 0.0, 1e-4)
    model, opt = amp.decorate(model, _o2_opt(model, sched), level="O2")
    train = TrainStep(model, step_fn, opt, amp_level="O2").ensure_state()
    start = {n: m.clone() for n, m in train._masters.items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    batches = [make_batch(gen, dev, batch, seq, 30522) for _ in range(4)]
    torch.cuda.synchronize()
    print(f"[bert_o2] BERT-base O2 bf16, {len(start)} fp32 masters, built "
          f"in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    for w in fa.WRAPPERS:
        w.launches = 0
    fa.blockwise_route.calls = 0
    with op_dtypes() as seen:
        losses = []
        for i in range(warmup):
            losses.append(float(train(*batches[i % 4])))
            sched.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = []
        for i in range(steps):
            out.append(train(*batches[(warmup + i) % 4]))
            sched.step()
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / steps
    launches = {w.__name__: w.launches for w in fa.WRAPPERS}
    calls = fa.blockwise_route.calls
    losses += [float(x) for x in out]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile_call(lambda: train(*batches[0]))
    n_steps = warmup + steps
    moved = sum(not torch.equal(m, start[n])
                for n, m in train._masters.items())
    print(f"[bert_o2] losses {losses}")
    print(f"[bert_o2] step_ms {step_s * 1e3:.3f}  samples/s "
          f"{batch / step_s:.2f}  peak_mem {peak:.3f} GiB")
    print(f"[bert_o2] one profiled step: {prof['launches']} kernel launches, "
          f"{prof['syncs']} host syncs (cudaStreamSynchronize), device busy "
          f"{prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} ms (idle share "
          f"{1 - prof['busy_ms'] / prof['wall_ms']:.3f})")
    print(f"[bert_o2] device ms by op: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(prof["by_op_ms"].items(),
                                          key=lambda kv: -kv[1])[:12]))
    print(f"[bert_o2] CUDA runtime calls: " + ", ".join(
        f"{k} {v}" for k, v in prof["runtime"].most_common(8)))
    print(f"[bert_o2] launches over {n_steps} steps: {launches} (expected "
          f"{12 * n_steps} each); flash op q/k/v dtypes {dict(seen)}; "
          f"blockwise-route calls {calls}; masters moved {moved} of "
          f"{len(start)}")
    check(all(math.isfinite(x) for x in losses), "non-finite loss")
    check(abs(losses[0] - (math.log(30522) + math.log(2))) < 2.0,
          "first loss far from ln(vocab) + ln(2)")
    for name, n in launches.items():
        check(n == 12 * n_steps, f"{name}: {n} launches, expected "
              f"{12 * n_steps} (12 a step)")
    check(dict(seen) == {("bfloat16",) * 3: 12 * n_steps},
          f"flash op q/k/v dtypes {dict(seen)}: expected bf16 only")
    check(calls == 0, f"{calls} calls took the blockwise route")
    check(all(p.dtype == torch.bfloat16 for p in model.parameters()) and
          all(m.dtype == torch.float32 for m in train._masters.values()),
          "parameters not bf16 or masters not fp32")
    check(moved >= len(start) - 1, "the masters did not move")
    return launches


RESNET_TINY = dict(px=64, batch=4, classes=10, lr=1e-2)
# card against CPU, fp32 (TF32 off), resnet18, by step (first, second).
# cuDNN's fp32 convolutions are not as exact as the CPU's here: in NHWC
# the card's parameter updates after one step lie a median 2.8% and up
# to 3.9% of an update (by its norm, ``update_error``) from float64,
# the same with deterministic algorithms or conv fp32_precision "ieee",
# where torch's own CUDA convolutions (cuDNN off) lie 5e-6 and the CPU's
# fp32 run 9.4e-5 (up to 1.3%: a ReLU input within rounding of 0) from
# it (scripts/resnet_card_vs_cpu.py). The forward is exact (the first
# loss within 1e-6). A batch-4 BN net carries that into the second step:
# its loss then reads 4% apart and the running statistics 1.2e-2. At lr
# 0.1, bench.py's rate for batch 256, the second step is ill-conditioned
# even on the CPU, so this phase takes lr 1e-2, as the BERT-tiny phase.
RESNET_TINY_TOL = {"loss": (1e-4, 2.0 ** -3),
                   "update": (2.0 ** -4, 2.0 ** -3),
                   "buffer": (1e-4, 2.0 ** -5)}
RESNET = dict(depth=50, px=224, batch=256, classes=1000)
# both layouts start from the same weights and images, so their first
# O1 losses differ only by bf16 rounding (one bf16 ulp at ln(1000) is
# 2**-5); the first loss of random weights lies near ln(1000)
RESNET_LAYOUT_TOL = 2.0 ** -5
RESNET_LOSS0_TOL = 1.0


def resnet_step_fn(m, x, y):
    from paddle_tpu_torch.nn import functional as F
    return F.cross_entropy(m(x), y)


def image_batch(gen, dev, b, px, layout, classes):
    """bench.py's synthetic batch (bench.py:209-219): uniform fp32 images
    and int32 labels [b, 1], made on the device. NHWC images are the
    NCHW ones permuted, so both layouts see the same pixels."""
    x = torch.rand((b, 3, px, px), generator=gen, device=dev)
    if layout == "NHWC":
        x = x.permute(0, 2, 3, 1).contiguous()
    y = torch.randint(0, classes, (b, 1), generator=gen, device=dev,
                      dtype=torch.int32)
    return x, y


def update_error(got, want, start):
    """||got - want|| / ||want - start||: a parameter's error over the size
    of its update."""
    return ((got - want).norm() / (want - start).norm().clamp_min(1e-12)
            ).item()


def _resnet_tiny_run(tpt, device, layout, state, batch):
    from paddle_tpu_torch.convert import load_state_dict
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet18
    tpt.set_device(device)
    model = load_state_dict(resnet18(num_classes=RESNET_TINY["classes"],
                                     data_format=layout), state)
    step = TrainStep(model, resnet_step_fn, Momentum(
        learning_rate=RESNET_TINY["lr"], momentum=0.9,
        parameters=model.parameters()), amp_level="O0")
    losses, states = [], []
    for _ in range(2):
        losses.append(float(step(*batch)))
        states.append({k: v.detach().cpu().clone() for k, v in
                       model.state_dict().items()})
    return losses, states


def phase_resnet_tiny(tpt, dev):
    """The port's ResNet on the card (cuDNN, torch's CUDA batch norm and
    pools) against the port on the CPU: resnet18, 2 O0 steps from the same
    weights, each layout."""
    from paddle_tpu_torch.vision.models import resnet18
    px, b, classes = (RESNET_TINY[k] for k in ("px", "batch", "classes"))
    tol = RESNET_TINY_TOL
    for layout in ("NHWC", "NCHW"):
        tpt.set_device("cpu")
        tpt.seed(2)
        start = resnet18(num_classes=classes, data_format=layout).state_dict()
        start = {k: v.detach().clone() for k, v in start.items()}
        batch = image_batch(torch.Generator().manual_seed(4), "cpu", b, px,
                            layout, classes)
        cpu_losses, cpu_states = _resnet_tiny_run(tpt, "cpu", layout, start,
                                                  batch)
        gpu_losses, gpu_states = _resnet_tiny_run(
            tpt, dev, layout, start, tuple(t.to(dev) for t in batch))
        print(f"[resnet_tiny] {layout} losses card {gpu_losses} cpu "
              f"{cpu_losses}")
        bad = []
        for i, (g, c) in enumerate(zip(gpu_states, cpu_states)):
            loss_err = abs(gpu_losses[i] - cpu_losses[i]) / cpu_losses[i]
            errs = {n: update_error(g[n], c[n], start[n]) for n in c
                    if not n.endswith(("._mean", "._variance"))}
            worst = max(errs, key=errs.get)
            bufs = [n for n in c if n not in errs]
            buf = max((g[n] - c[n]).abs().max().item() for n in bufs)
            ok = {"loss": loss_err <= tol["loss"][i],
                  "update": errs[worst] <= tol["update"][i],
                  "buffer": all(torch.allclose(
                      g[n], c[n], rtol=tol["buffer"][i],
                      atol=tol["buffer"][i]) for n in bufs)}
            print(f"[resnet_tiny] {layout} step {i + 1}: loss rel err "
                  f"{loss_err:.3e} (bound {tol['loss'][i]:g}); parameters' "
                  f"update error worst {errs[worst]:.3e} ({worst}), median "
                  f"{sorted(errs.values())[len(errs) // 2]:.3e} (bound "
                  f"{tol['update'][i]:g}); BN running stats max_abs "
                  f"{buf:.3e} (rtol/atol {tol['buffer'][i]:g}) "
                  + " ".join(f"{k} {'ok' if v else 'FAIL'}"
                             for k, v in ok.items()))
            bad += [f"step {i + 1} {k}" for k, v in ok.items() if not v]
        check(not bad, f"resnet18 {layout} on the card disagrees with the "
              f"CPU: {bad}")


def conv_macs(model, x):
    """Multiply-adds of each convolution of one eval forward of x, in call
    order; leaves the model in eval()."""
    from paddle_tpu_torch.nn import Conv2D
    macs, hooks = [], []
    for m in model.modules():
        if isinstance(m, Conv2D):
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out: macs.append(
                    out.numel() * mod.weight[0].numel())))
    model.eval()
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return macs


def conv_flops(model, x):
    """Operations of one training step's convolutions for the batch x:
    forward, filter gradient, and input gradient for every conv but the
    first (the images need none), 2 per multiply-add, from the shapes a
    one-image eval forward gives (so no BN statistic moves)."""
    macs = conv_macs(model, x[:1])
    model.train()
    return 2 * x.shape[0] * (3 * sum(macs) - macs[0])


def calibrated_state(model, x):
    """The model's state as {name: numpy array}, with every BN layer's
    running mean and variance set to the batch statistics of its input
    (mean and biased variance over N, H, W) on the batch x, BN by BN in
    the order the forward reaches them, so each sees the ones before it
    calibrated. At random weights with the initial statistics (mean 0,
    variance 1) YOLOv3's activations grow through its 75 convolutions
    until the heads saturate and every kept score is 1.0; calibrated,
    the heads give graded scores and NMS real suppressions to make. A
    test and chip helper, not a feature of the port: loaded into the
    JAX model (set_state_dict) and the port (load_state_dict) alike."""
    from paddle_tpu_torch.nn import BatchNorm2D

    def take_stats(bn, args):
        v = args[0]
        bn._mean.copy_(v.mean(dim=(0, 2, 3)))
        bn._variance.copy_(v.var(dim=(0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(take_stats)
             for m in model.modules() if isinstance(m, BatchNorm2D)]
    model.eval()
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def _resnet_run(tpt, dev, layout, batches, warmup, steps):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50
    tpt.set_device(dev)
    tpt.seed(0)
    t0 = time.perf_counter()
    model = resnet50(num_classes=RESNET["classes"], data_format=layout)
    train = TrainStep(model, resnet_step_fn, Momentum(
        learning_rate=0.1, momentum=0.9, parameters=model.parameters()),
        amp_level="O1").ensure_state()
    torch.cuda.synchronize()
    print(f"[resnet] {layout} ResNet-50 "
          f"{sum(p.numel() for p in model.parameters())} params built in "
          f"{time.perf_counter() - t0:.1f} s")
    flops = conv_flops(model, batches[0][0])
    print(f"[resnet] {layout} convolutions {flops / 1e12:.4f} TFLOP a step: "
          f"{flops / PEAK_OPS_S[torch.bfloat16] * 1e3:.3f} ms at the bf16 "
          f"peak")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [float(train(*batches[i % len(batches)]))
              for i in range(warmup)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = [train(*batches[(warmup + i) % len(batches)])
           for i in range(steps)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    losses += [float(x) for x in out]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    b = RESNET["batch"]
    print(f"[resnet] {layout} losses {losses}")
    print(f"[resnet] {layout} step_ms {step_s * 1e3:.3f}  img/s "
          f"{b / step_s:.2f}  peak_mem {peak:.3f} GiB  (warm-up "
          f"{warm_s:.1f} s for {warmup} steps, cudnn.benchmark "
          f"{torch.backends.cudnn.benchmark})")
    check(all(math.isfinite(x) for x in losses),
          f"{layout}: non-finite loss")
    return losses


def phase_resnet(tpt, dev):
    """ResNet-50 at bench.py's size, O1, both layouts from the same
    weights (seed 0) and the same images."""
    px, b, classes = (RESNET[k] for k in ("px", "batch", "classes"))
    warmup, steps = 2, 5
    torch.backends.cudnn.benchmark = True      # as training scripts run
    try:
        first = {}
        for layout in ("NHWC", "NCHW"):
            gen = torch.Generator(device=dev).manual_seed(0)
            batches = [image_batch(gen, dev, b, px, layout, classes)
                       for _ in range(2)]
            first[layout] = _resnet_run(tpt, dev, layout, batches, warmup,
                                        steps)[0]
            del batches
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.benchmark = False
    diff = abs(first["NHWC"] - first["NCHW"])
    print(f"[resnet] first losses NHWC {first['NHWC']:.6f} NCHW "
          f"{first['NCHW']:.6f}: differ by {diff:.3e} (bound "
          f"{RESNET_LAYOUT_TOL:g}); ln(1000) = {math.log(classes):.4f}")
    for layout, loss in first.items():
        check(abs(loss - math.log(classes)) < RESNET_LOSS0_TOL,
              f"{layout}: first loss {loss} far from ln({classes})")
    check(diff <= RESNET_LAYOUT_TOL,
          "NHWC and NCHW first losses disagree beyond bf16 noise")


# ------------------------------------------------------------------- YOLOv3
YOLO_NMS = dict(background_label=-1, score_threshold=0.005,
                nms_threshold=0.45, nms_top_k=400, keep_top_k=100,
                normalized=False)                # YOLOv3.predict's attrs
YOLO_TINY = dict(num_classes=4, keep_top_k=20, nms_top_k=50)
# card against CPU, fp32 (TF32 off), the tiny model at 64 px, batch 2, as
# tests/test_torch_yolov3.py holds the port to the JAX package: heads by
# the error over the head's largest magnitude; decoded boxes (pixels)
# and scores, and predict's rows, absolutely; counts and labels exact
YOLO_TINY_TOL = {"head": 1e-4, "box": 5e-2, "score": 1e-3, "det": 1e-2}
YOLO_416 = dict(px=416, classes=80, iters=30, calib=4)
EXACT = (0.0, 0.0)
# float outputs through exp / sigmoid / log or summed in another order
ULPS = (1e-5, 1e-6)
BOX_PX = (1e-5, 1e-3)


@contextlib.contextmanager
def op_ranges():
    """While active, every registered op's compute, and
    ``nn.functional.interpolate`` (not an op), runs inside a
    ``torch.profiler.record_function`` range "op:<type>", so a trace can
    give each kernel the op that launched it. Profiling only."""
    from paddle_tpu_torch.core.registry import OpInfoMap
    from paddle_tpu_torch.nn import functional as F

    def ranged(name, fn):
        def run(*args, **kwargs):
            with torch.profiler.record_function("op:" + name):
                return fn(*args, **kwargs)
        return run

    opdefs = list(OpInfoMap.instance()._ops.values())
    saved = [d.compute for d in opdefs]
    interpolate = F.interpolate
    for d in opdefs:
        d.compute = ranged(d.type, d.compute)
    F.interpolate = ranged("interpolate", interpolate)
    try:
        yield
    finally:
        for d, fn in zip(opdefs, saved):
            d.compute = fn
        F.interpolate = interpolate


def device_busy_us(dev_events):
    """The union of the device events' intervals, in us."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in dev_events)
    if not spans:
        return 0.0
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s


def kernel_op(event):
    """The "op:<type>" range (op_ranges) around a CPU event, or None."""
    while event is not None:
        if event.name.startswith("op:"):
            return event.name[3:]
        event = event.cpu_parent
    return None


def profile_call(fn):
    """torch.profiler over one call of fn (ops ranged): its device busy
    time, wall time, device time by launching op, kernels run, CUDA
    runtime calls by name, kernel launches and host syncs
    (cudaStreamSynchronize: a device-to-host read waits for the stream;
    the closing cudaDeviceSynchronize is this function's own)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with op_ranges(), torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cpu_type = torch.autograd.DeviceType.CPU
    events = prof.events()
    # op_ranges' ranges also appear on the device timeline, spanning
    # their kernels and the gaps between them: not device work
    dev_events = [e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA and
                  not e.name.startswith("op:")]
    runtime = collections.Counter(e.name for e in events
                                  if e.device_type == cpu_type and
                                  e.name.startswith("cu"))
    by_op = collections.Counter()
    for e in events:
        if e.device_type == cpu_type:
            for k in e.kernels:
                by_op[kernel_op(e) or "other"] += k.duration
    by_op["(not linked to an op)"] = sum(
        e.time_range.end - e.time_range.start for e in dev_events) - sum(
        by_op.values())
    return dict(busy_ms=device_busy_us(dev_events) / 1e3, wall_ms=wall_ms,
                by_op_ms={k: v / 1e3 for k, v in by_op.items()},
                device_events=len(dev_events), runtime=runtime,
                launches=sum(n for name, n in runtime.items()
                             if "LaunchKernel" in name),
                syncs=runtime.get("cudaStreamSynchronize", 0))


def _run_op(op_type, inputs, attrs, dev, grad=None):
    """The registered op on ``dev`` from CPU inputs; with ``grad`` (a
    slot), also d(sum of the first output)/d(that input)."""
    from paddle_tpu_torch.core.registry import OpInfoMap
    ins = {s: [t.to(dev) for t in v] for s, v in inputs.items()}
    if grad:
        ins[grad] = [t.requires_grad_() for t in ins[grad]]
    outs = OpInfoMap.instance().get(op_type).compute(ins, attrs)
    if grad:
        first = next(iter(outs.values()))[0]
        outs = dict(outs, **{"d" + grad: list(torch.autograd.grad(
            first.sum(), ins[grad]))})
    return {s: [t.detach().cpu() for t in v] for s, v in outs.items()}


def card_vs_cpu(op_type, inputs, attrs, dev, tol=EXACT, grad=None,
                label=""):
    """The op on the card against the op on the CPU, same inputs: integer
    outputs equal, float ones within tol ((rtol, atol), or a dict of
    them by slot); returns the CPU outputs."""
    card = _run_op(op_type, inputs, attrs, dev, grad)
    cpu = _run_op(op_type, inputs, attrs, "cpu", grad)
    print(f"[detection_ops] {op_type} {label}".rstrip())
    for slot, outs in cpu.items():
        for want, got in zip(outs, card[slot]):
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"{op_type}.{slot}: {got.shape} {got.dtype} on the card, "
                  f"{want.shape} {want.dtype} on the CPU")
            if want.numel() == 0:
                print(f"    {slot:<6} {tuple(want.shape)} empty on both")
            elif want.is_floating_point():
                rtol, atol = tol.get(slot, EXACT) if isinstance(
                    tol, dict) else tol
                err_of(got, want, rtol, atol, slot)
            else:
                same = torch.equal(got, want)
                print(f"    {slot:<6} {tuple(want.shape)} "
                      f"{'equal' if same else 'DIFFER'}")
                check(same, f"{op_type}.{slot} differs on the card")
    return cpu


def _yolo_heads(gen, scale):
    """Random [1, 255, h, h] logits for YOLOv3-416's three heads (strides
    32, 16, 8) and each head's yolo_box attrs."""
    from paddle_tpu_torch.vision.detection_models import (_ANCHORS,
                                                          _ANCHOR_MASKS)
    out = []
    for i, (h, down) in enumerate(((13, 32), (26, 16), (52, 8))):
        x = torch.randn((1, 3 * 85, h, h), generator=gen) * scale
        out.append((x, dict(anchors=[_ANCHORS[2 * a + o]
                                     for a in _ANCHOR_MASKS[i]
                                     for o in (0, 1)],
                            class_num=80, conf_thresh=0.005,
                            downsample_ratio=down, clip_bbox=True,
                            scale_x_y=1.0)))
    return out


def saturated_nms_inputs(rs, n, m, c):
    """multiclass_nms inputs like those of bench.py's seed-0 YOLOv3 (BN
    statistics as initialised), from the numpy RandomState rs: boxes
    [n, m, 4] drawn from a few clipped to the image edges, so many are
    identical and some inverted (y0 = 128 > y1 = 127), and scores
    [n, c, m] of exactly 1.0, 0.5 or 0. Every kept row then scores 1.0,
    and tie order alone decides the output."""
    edges = np.array([[0, 0, 127, 127], [96, 128, 96, 127], [0, 0, 127, 64],
                      [32, 0, 127, 127], [0, 40, 60, 127]], np.float32)
    boxes = edges[rs.randint(0, len(edges), (n, m))]
    scores = rs.choice(np.array([0.0, 1.0, 1.0, 1.0, 0.5], np.float32),
                       (n, c, m))
    return torch.from_numpy(boxes), torch.from_numpy(scores)


def phase_detection_ops(dev):
    """Every op of the detection module, and the ops YOLOv3 adds, on the
    card against the same op on the CPU from the same inputs (TF32 off).
    multiclass_nms exact (Index, NmsedNum and rows) on random boxes, on
    saturated ties, and at YOLOv3-416's shape: M = 10,647 boxes from the
    three heads' yolo_box, 80 classes, nms_top_k 400."""
    from paddle_tpu_torch.nn import functional as F
    gen = torch.Generator().manual_seed(11)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale

    def rand(*shape):
        return torch.rand(shape, generator=gen)

    def boxes(*lead, extent=100.0, size=30.0):
        c = rand(*lead, 2) * extent
        wh = rand(*lead, 2) * size + 1.0
        return torch.cat([c - wh / 2, c + wh / 2], -1)

    card_vs_cpu("leaky_relu", {"X": [randn(4, 64, 52, 52)]}, {"alpha": 0.1},
                dev)
    card_vs_cpu("concat", {"X": [randn(1, 256, 26, 26),
                                 randn(1, 512, 26, 26)]}, {"axis": 1}, dev)
    card_vs_cpu("transpose2", {"X": [rand(1, 10647, 80)]},
                {"axis": [0, 2, 1]}, dev)
    x = randn(1, 256, 13, 13)
    for mode, size, tol in (("nearest", None, EXACT),
                            ("nearest", (29, 20), EXACT),
                            ("bilinear", (20, 9), ULPS),
                            ("bicubic", (26, 17), ULPS)):
        sf = 2 if size is None else None
        got = F.interpolate(x.to(dev), size, sf, mode).cpu()
        print(f"[detection_ops] interpolate {mode} to "
              f"{tuple(got.shape[2:])}")
        err_of(got, F.interpolate(x, size, sf, mode), *tol, "Out")

    decoded = {}
    for name, scale in (("random", 2.0), ("saturated", 4e4)):
        outs = [card_vs_cpu("yolo_box", {"X": [hx], "ImgSize": [
            torch.tensor([[416, 416]], dtype=torch.int32)]}, attrs, dev,
            {"Boxes": BOX_PX, "Scores": ULPS},
            label=f"{name} {tuple(hx.shape)}")
                for hx, attrs in _yolo_heads(gen, scale)]
        decoded[name] = (torch.cat([o["Boxes"][0] for o in outs], 1),
                         torch.cat([o["Scores"][0] for o in outs], 1))
    for name, (bx, sc) in decoded.items():
        cpu = card_vs_cpu("multiclass_nms", {"BBoxes": [bx], "Scores": [
            sc.transpose(1, 2).contiguous()]}, YOLO_NMS, dev,
            label=f"YOLOv3-416 {name}: M {bx.shape[1]}, 80 classes, "
            f"nms_top_k 400")
        print(f"    NmsedNum {cpu['NmsedNum'][0].tolist()}")
    sat_b, sat_s = saturated_nms_inputs(np.random.RandomState(12), 2,
                                        400, 12)
    for label, bx, sc, attrs in (
            ("random", boxes(2, 300), rand(2, 8, 300),
             dict(YOLO_NMS, nms_top_k=100, keep_top_k=50)),
            ("saturated ties", sat_b, sat_s,
             dict(YOLO_NMS, nms_top_k=100)),
            ("nms_eta 0.9", boxes(2, 120, extent=1.0, size=0.5),
             rand(2, 4, 120), dict(background_label=1, score_threshold=0.1,
                                   nms_threshold=0.7, nms_top_k=60,
                                   keep_top_k=30, nms_eta=0.9))):
        card_vs_cpu("multiclass_nms", {"BBoxes": [bx], "Scores": [sc]},
                    attrs, dev, label=label)
    card_vs_cpu("matrix_nms", {"BBoxes": [boxes(2, 40, extent=1.0, size=0.3)],
                               "Scores": [rand(2, 3, 40)]},
                dict(background_label=0, score_threshold=0.1,
                     post_threshold=0.05, nms_top_k=30, keep_top_k=25,
                     use_gaussian=False, normalized=True), dev, ULPS)
    feat, image = torch.zeros(1, 8, 13, 13), torch.zeros(1, 3, 416, 416)
    card_vs_cpu("prior_box", {"Input": [feat], "Image": [image]},
                dict(min_sizes=[30.0, 60.0], max_sizes=[60.0, 111.0],
                     aspect_ratios=[2.0, 3.0], flip=True, clip=True), dev)
    card_vs_cpu("anchor_generator", {"Input": [feat]},
                dict(anchor_sizes=[32.0, 64.0, 128.0],
                     aspect_ratios=[0.5, 1.0, 2.0], stride=[16.0, 16.0]),
                dev)
    card_vs_cpu("density_prior_box", {"Input": [feat], "Image": [image]},
                dict(fixed_sizes=[32.0, 64.0], fixed_ratios=[1.0, 2.0],
                     densities=[2, 1], clip=True), dev)
    prior, target = boxes(50, extent=1.0, size=0.2), boxes(20, extent=1.0,
                                                           size=0.2)
    enc = card_vs_cpu("box_coder", {"PriorBox": [prior],
                                    "TargetBox": [target]},
                      dict(code_type="encode_center_size",
                           variance=[0.1, 0.1, 0.2, 0.2]), dev, ULPS,
                      label="encode")
    card_vs_cpu("box_coder", {"PriorBox": [prior], "TargetBox": enc[
        "OutputBox"]}, dict(code_type="decode_center_size",
                            variance=[0.1, 0.1, 0.2, 0.2]), dev, ULPS,
                label="decode")
    card_vs_cpu("iou_similarity", {"X": [boxes(300)], "Y": [boxes(200)]},
                dict(box_normalized=False), dev)
    card_vs_cpu("box_clip", {"Input": [randn(2, 50, 4, scale=300.0)],
                             "ImInfo": [torch.tensor([[416.0, 416.0, 1.0],
                                                      [600.0, 800.0, 2.0]])]},
                {}, dev)
    rois = boxes(20, extent=24.0, size=10.0)
    card_vs_cpu("roi_align", {"X": [randn(2, 16, 26, 26)], "ROIs": [rois],
                              "RoisNum": [torch.tensor([12, 8],
                                                       dtype=torch.int32)]},
                dict(pooled_height=7, pooled_width=7, spatial_scale=1.0,
                     sampling_ratio=2), dev, ULPS)
    card_vs_cpu("bipartite_match", {"DistMat": [rand(8, 20)]},
                dict(match_type="per_prediction", dist_threshold=0.5), dev)
    gt = torch.cat([rand(2, 6, 2) * 0.5 + 0.25, rand(2, 6, 2) * 0.3 + 0.05],
                   -1)
    card_vs_cpu("yolov3_loss", {
        "X": [randn(2, 3 * 85, 13, 13, scale=0.5)], "GTBox": [gt],
        "GTLabel": [torch.randint(0, 80, (2, 6), generator=gen)]},
        dict(class_num=80, anchors=[10, 13, 16, 30, 33, 23, 30, 61, 62, 45,
                                    59, 119, 116, 90, 156, 198, 373, 326],
             anchor_mask=[6, 7, 8], downsample_ratio=32, ignore_thresh=0.7),
        dev, {"Loss": (1e-5, 0.0), "dX": ULPS}, grad="X",
        label="loss and d(loss)/dX")


def _yolo_outputs(model, x, size):
    from paddle_tpu_torch.dygraph import no_grad
    with no_grad():
        heads = model(x)
        boxes, scores = model.decode(heads, size)
        dets, num = model.predict(x, size)
    return ([h.cpu() for h in heads], boxes.cpu(), scores.cpu(), dets.cpu(),
            num.cpu())


def compare_yolo(got, want, tol, what):
    """Card outputs of _yolo_outputs against CPU ones; returns what
    disagrees beyond tol."""
    head = max(((g - w).abs().max() / w.abs().max()).item()
               for g, w in zip(got[0], want[0]))
    errs = {"head": head}
    for i, key in ((1, "box"), (2, "score"), (3, "det")):
        errs[key] = (got[i] - want[i]).abs().max().item()
    same = {"counts": torch.equal(got[4], want[4]),
            "labels": torch.equal(got[3][..., 0], want[3][..., 0])}
    print(f"[{what}] heads {head:.3e} of the largest (bound {tol['head']:g}); "
          f"boxes {errs['box']:.3e} px, scores {errs['score']:.3e}, dets "
          f"{errs['det']:.3e} (bounds {tol['box']:g}, {tol['score']:g}, "
          f"{tol['det']:g}); NmsedNum card {got[4].tolist()} cpu "
          f"{want[4].tolist()}; labels "
          f"{'equal' if same['labels'] else 'DIFFER'}")
    return [k for k, e in errs.items() if not e <= tol[k]] + \
        [k for k, ok in same.items() if not ok]


def phase_yolov3_tiny(tpt, dev):
    """YOLOv3 at full depth, 4 classes, 64 px, batch 2 (the model of
    tests/test_yolov3.py) on the card against the CPU from the same
    weights: with its initial BN statistics (saturated heads, all kept
    scores 1.0, so tie order decides) and calibrated ones."""
    from paddle_tpu_torch.convert import load_state_dict
    from paddle_tpu_torch.vision import yolov3
    tpt.set_device("cpu")
    tpt.seed(5)
    cpu_model = yolov3(**YOLO_TINY)
    gen = torch.Generator().manual_seed(6)
    calib = torch.rand((8, 3, 64, 64), generator=gen)
    x = torch.rand((2, 3, 64, 64), generator=gen)
    size = torch.full((2, 2), 64, dtype=torch.int32)
    states = {"bench": {k: v.numpy().copy() for k, v in
                        cpu_model.state_dict().items()}}
    states["calibrated"] = calibrated_state(cpu_model, calib)
    tpt.set_device(dev)
    card_model = yolov3(**YOLO_TINY).eval()
    bad = []
    for name, state in states.items():
        want = _yolo_outputs(load_state_dict(cpu_model, state), x, size)
        got = _yolo_outputs(load_state_dict(card_model, state), x.to(dev),
                            size.to(dev))
        bad += [f"{name} {k}" for k in compare_yolo(
            got, want, YOLO_TINY_TOL, f"yolov3_tiny {name}")]
        if name == "bench":
            valid = got[3][..., 0] >= 0
            print(f"[yolov3_tiny] bench: kept scores "
                  f"{sorted(set(got[3][valid][:, 1].tolist()))}")
    check(not bad, f"tiny YOLOv3 on the card disagrees with the CPU: {bad}")


def _yolo416_time(model, imgs, size, iters, label):
    """Latency of predict (host clock around ``iters`` calls on the two
    images in turn, ending in a synchronize), CUDA events around single
    predicts, peak memory; checks that each image gives the same output
    every time."""
    from paddle_tpu_torch.dygraph import no_grad
    with no_grad():
        t0 = time.perf_counter()
        ref = [model.predict(img, size) for img in imgs]   # warm-up
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs = [model.predict(imgs[i % 2], size) for i in range(iters)]
        torch.cuda.synchronize()
        latency = (time.perf_counter() - t0) / iters * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        event_ms = []
        for i in range(6):
            start, end = torch.cuda.Event(True), torch.cuda.Event(True)
            start.record()
            model.predict(imgs[i % 2], size)
            end.record()
            torch.cuda.synchronize()
            event_ms.append(start.elapsed_time(end))
    same = all(torch.equal(d, ref[i % 2][0]) and torch.equal(n, ref[i % 2][1])
               for i, (d, n) in enumerate(outs))
    print(f"[yolov3] {label}: latency {latency:.3f} ms a predict ({iters} "
          f"predicts, batch 1), CUDA events around one predict "
          f"{min(event_ms):.3f}-{max(event_ms):.3f} ms, peak_mem "
          f"{peak:.3f} GiB, warm-up {warm_s:.1f} s; outputs of each image "
          f"{'identical' if same else 'DIFFER'} across calls")
    check(same, f"{label}: predict is not deterministic")
    return ref


def _yolo416_profile(model, img, size, label):
    """Device time of the network and of decode alone (queued behind a
    spin, so the host's launch time is not timed), and one profiled
    predict: device busy, idle share, time by op, launches, host syncs."""
    from paddle_tpu_torch.dygraph import no_grad
    with no_grad():
        # few calls: with 10 networks (about 300 launches each) queued
        # behind the spin, the host seems to block on the queue of
        # pending launches and its time is timed (5.8-11.1 ms against
        # the 5.2 ms the profiler sums; 2 calls read 5.5)
        net_ms = cuda_ms(lambda: model(img), n=2)
        heads = model(img)
        dec_ms = cuda_ms(lambda: model.decode(heads, size), n=5)
        prof = profile_call(lambda: model.predict(img, size))
    by_op = prof["by_op_ms"]
    nms = by_op.get("multiclass_nms", 0.0) + by_op.get("transpose2", 0.0)
    print(f"[yolov3] {label}: device time, CUDA events behind a spin: "
          f"network {net_ms:.3f} ms, decode {dec_ms:.3f} ms; one profiled "
          f"predict: device busy {prof['busy_ms']:.3f} ms of "
          f"{prof['wall_ms']:.3f} ms (idle share "
          f"{1 - prof['busy_ms'] / prof['wall_ms']:.3f}), NMS "
          f"{nms:.3f} ms of device time, {prof['device_events']} device "
          f"events, {prof['launches']} kernel launches, {prof['syncs']} "
          f"host syncs (cudaStreamSynchronize)")
    print(f"[yolov3] {label}: device ms by op: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(by_op.items(), key=lambda kv:
                                          -kv[1])))
    print(f"[yolov3] {label}: CUDA runtime calls: " + ", ".join(
        f"{k} {v}" for k, v in prof["runtime"].most_common(8)))
    return prof


def phase_yolov3(tpt, dev):
    """The YOLOv3-416 leg of bench.py (yolov3_infer, BASELINE config 5):
    yolov3(num_classes=80) from seed 0, eval(), batch 1, 416 px, fp32,
    predict = network + decode + multiclass_nms, with the initial BN
    statistics (as the bench's model) and calibrated ones; cudnn.benchmark
    on, TF32 off, and one timing with cuDNN's TF32 on (torch's default).
    The bench's statistics are also run on the CPU: saturated heads make
    tie order decide, and the card must give the same detections."""
    from paddle_tpu_torch.convert import load_state_dict
    from paddle_tpu_torch.dygraph import no_grad
    from paddle_tpu_torch.vision import yolov3
    px, classes, iters = (YOLO_416[k] for k in ("px", "classes", "iters"))
    tpt.set_device(dev)
    tpt.seed(0)
    t0 = time.perf_counter()
    model = yolov3(num_classes=classes).eval()
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device=dev).manual_seed(0)
    imgs = [torch.rand((1, 3, px, px), generator=gen, device=dev)
            for _ in range(2)]
    calib = torch.rand((YOLO_416["calib"], 3, px, px), generator=gen,
                       device=dev)
    size = torch.full((1, 2), px, dtype=torch.int32, device=dev)
    states = {"bench": {k: v.detach().cpu().numpy().copy()
                        for k, v in model.state_dict().items()}}
    states["calibrated"] = calibrated_state(model, calib)
    torch.cuda.synchronize()
    flops = 2 * sum(conv_macs(model, imgs[0]))
    print(f"[yolov3] YOLOv3-416 {n_params} params, built and calibrated in "
          f"{time.perf_counter() - t0:.1f} s; convolutions {flops / 1e9:.3f} "
          f"GFLOP a predict: {flops / PEAK_OPS_S[torch.float32] * 1e3:.3f} "
          f"ms at the fp32 peak (67 TFLOP/s), {flops / 495e12 * 1e3:.3f} ms "
          f"at TF32's 495")
    refs = {}
    torch.backends.cudnn.benchmark = True
    try:
        for name in ("bench", "calibrated"):
            load_state_dict(model, states[name])
            refs[name] = _yolo416_time(model, imgs, size, iters, name)
            _yolo416_profile(model, imgs[0], size, name)
            dets, num = refs[name][0]
            valid = dets[0, :, 0] >= 0
            kept = dets[0][valid]
            print(f"[yolov3] {name}: NmsedNum {num.tolist()}, kept scores "
                  f"from {kept[:, 1].min().item() if len(kept) else 0:.6f} "
                  f"to {kept[:, 1].max().item() if len(kept) else 0:.6f}, "
                  f"labels {sorted(set(kept[:, 0].long().tolist()))[:10]}")
            check(dets.shape == (1, 100, 6) and bool(
                torch.isfinite(dets).all()), f"{name}: bad dets")
            check(int(valid.sum()) == int(num[0]) and 0 < int(num[0]) <= 100,
                  f"{name}: NmsedNum {num.tolist()} against the rows")
            out = ((kept[:, 2:] < 0) | (kept[:, 2:] > px)).any(-1)
            check(not bool(out.any()), f"{name}: boxes outside the image: "
                  f"{kept[out][:5].tolist()}")
        torch.backends.cudnn.allow_tf32 = True
        label = "calibrated, cudnn.allow_tf32=True (torch's default)"
        _yolo416_time(model, imgs, size, iters, label)
        _yolo416_profile(model, imgs[0], size, label)
    finally:
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.allow_tf32 = False
    tpt.set_device("cpu")
    cpu_model = load_state_dict(yolov3(num_classes=classes),
                                states["bench"]).eval()
    with no_grad():
        want = cpu_model.predict(imgs[0].cpu(), size.cpu())
    got = [t.cpu() for t in refs["bench"][0]]
    box = (got[0][..., 2:] - want[0][..., 2:]).abs().max().item()
    same = torch.equal(got[1], want[1]) and torch.equal(
        got[0][..., :2], want[0][..., :2])
    print(f"[yolov3] bench statistics, card against CPU: NmsedNum card "
          f"{got[1].tolist()} cpu {want[1].tolist()}, labels and scores "
          f"{'equal' if same else 'DIFFER'}, boxes max_abs {box:.3e} px "
          f"(bound {YOLO_TINY_TOL['box']:g})")
    check(same and box <= YOLO_TINY_TOL["box"],
          "YOLOv3-416 detections on the card disagree with the CPU")


# ---------------------------------------------------------------------------
# GPT: gpt_tiny card against CPU, GPT-3 1.3B's cached decode and its O2
# pretraining step, and K1-K3 at its shape
# ---------------------------------------------------------------------------
GPT_ZERO_GRAD = ".attn.k_bias"
GPT_TINY = dict(batch=2, seq=64, vocab=1024, lr=1e-3, prompt=16, decode=8)
# gpt_tiny O0 card against CPU (fp32, TF32 off): the masters' update
# error by its norm, as resnet_tiny and O1 hold theirs (AdamW scales a
# gradient element that is rounding noise to about lr)
GPT_O0_UPDATE_TOL = 2.0 ** -5
# losses (and the MoE aux losses) card against CPU at O0: fp32 sums in
# other orders
GPT_O0_LOSS_TOL = (1e-4, 1e-5)
# GPT-3 XL, "GPT-3 1.3B" (Brown et al. 2020, Table 2.1 and Appendix B):
# lr 2e-4, linear warm-up over 375M tokens, cosine decay to 10% over
# 260B tokens, Adam beta 0.9 / 0.95, eps 1e-8, weight decay 0.1, clip
# 1.0; here at micro-batch 4 x 2048 = 8,192 tokens a step
GPT3 = dict(batch=4, seq=2048, vocab=50257, lr=2e-4, warmup=2, steps=3,
            prompt=128, decode=16)
GPT3_TOKENS = GPT3["batch"] * GPT3["seq"]
GPT3_WARMUP_STEPS = int(375e6 // GPT3_TOKENS)
GPT3_DECAY_STEPS = int(260e9 // GPT3_TOKENS)
# cached against uncached logits of GPT-3 1.3B in fp32 (TF32 off), over
# the largest logit: the two sum in other orders (the decode's fp32
# einsums against K1's 3xTF32, about 1e-6 of float64 either way; cuBLAS
# at M = 1 against M = 144) through 24 layers, where a wrong position,
# offset or cache moves a logit by O(1) of the largest
GPT_CACHE_TOL = 1e-4
GPT_SHAPE = (4, 2048, 16, 128, True)       # B, S, H, D, causal
# K2/K3's bf16 dq, dk and dv against the plain backward in fp32 on the
# same inputs, by relative Frobenius error, at GPT's shape (the
# elementwise 2e-2 of TOL is half a typical gradient element there).
# Rounding the fp32 answer to bf16 (8 significant bits) alone reads
# 1.65e-3. The control, the same backward with the last DROPPED_KEYS
# keys left out (a missing key tile: the last one carries the least of
# the gradients' norm, so an earlier one reads more), reads 9e-3 to
# 1.0e-2 (both on the CPU at B1 H2, seeds 11 and 23) and must fail the
# bound, which lies between the two.
GRAD_FROB_BOUND = 4e-3
DROPPED_KEYS = 64


def gpt_step_fn(m, ids):
    return m(ids, labels=ids)[1]


def gpt_cached_logits(model, ids, prompt):
    """Logits [B, S, V] of a cached decode through the blocks: the first
    ``prompt`` ids at once with fresh caches, then one id at a time
    (positions made on the device)."""
    from paddle_tpu_torch.dygraph.tracer import trace_op
    gpt = model.gpt
    caches = [blk.attn.Cache(k=None, v=None) for blk in gpt.blocks]
    pos = torch.arange(ids.shape[1], device=ids.device).expand(ids.shape)
    spans = [(0, prompt)] + [(t, t + 1) for t in range(prompt,
                                                       ids.shape[1])]
    outs = []
    for a, b in spans:
        x = gpt.wte(ids[:, a:b]) + gpt.wpe(pos[:, a:b])
        for i, blk in enumerate(gpt.blocks):
            x, caches[i] = blk(x, cache=caches[i])
        outs.append(trace_op("matmul_v2", {"X": [gpt.ln_f(x)],
                                           "Y": [gpt.wte.weight]},
                             {"trans_y": True}, out_slots=["Out"])[0])
    return torch.cat(outs, 1)


def gpt3_schedule(lr_mod, peak=GPT3["lr"]):
    """GPT-3's schedule at this step size: linear warm-up from 0, then
    cosine decay to 10% of the peak."""
    return lr_mod.LinearWarmup(
        lr_mod.CosineAnnealingDecay(peak, GPT3_DECAY_STEPS, peak / 10),
        GPT3_WARMUP_STEPS, 0.0, peak)


def gpt_opt(model, learning_rate, clip=1.0):
    """GPT-3's AdamW: beta 0.9 / 0.95, eps 1e-8, weight decay 0.1, and a
    global-norm clip unless ``clip`` is None."""
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
    return AdamW(learning_rate=learning_rate, beta1=0.9, beta2=0.95,
                 epsilon=1e-8, weight_decay=0.1,
                 grad_clip=ClipGradByGlobalNorm(clip) if clip else None,
                 parameters=model.parameters())


def _gpt_tiny_run(tpt, fa, device, state, ids, kw, level, steps):
    """gpt_tiny from ``state`` through TrainStep at ``level``: AdamW at
    lr 1e-3 (O0), or at O2 with GPT-3's schedule shape (warm-up 2,
    cosine to 10% over 10) and the clip. Returns the losses, the MoE aux losses of each step,
    the fp32 values after the steps (masters at O2) on the CPU, and the
    flash routes taken."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.convert import load_state_dict
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import lr
    from paddle_tpu_torch.text import gpt_tiny
    tpt.set_device(device)
    model = load_state_dict(gpt_tiny(**kw), state)
    if level == "O2":
        sched = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-3, 10, 1e-4), 2,
                                0.0, 1e-3)
        model, opt = amp.decorate(model, gpt_opt(model, sched), level="O2")
    else:
        opt = gpt_opt(model, GPT_TINY["lr"], clip=None)
    step = TrainStep(model, gpt_step_fn, opt, amp_level=level)
    calls = fa.blockwise_route.calls
    launches = [w.launches for w in fa.WRAPPERS]
    losses, auxes = [], []
    with op_dtypes() as seen:
        for _ in range(steps):
            losses.append(float(step(ids)))
            auxes.append([float(a.detach())
                          for a in model.gpt.aux_losses()])
            if level == "O2":
                sched.step()
    if level == "O2":
        check(all(p.dtype == torch.bfloat16 for p in model.parameters())
              and all(m.dtype == torch.float32
                      for m in step._masters.values()),
              "O2: parameters not bf16 or masters not fp32")
        final = {n: m.cpu() for n, m in step._masters.items()}
    else:
        final = {n: p.detach().cpu() for n, p in step._params.items()}
    return (losses, auxes, final, fa.blockwise_route.calls - calls,
            [w.launches - n for w, n in zip(fa.WRAPPERS, launches)], seen)


def phase_gpt_tiny(tpt, fa, dev):
    """gpt_tiny (head dim 32, 2 layers) from seed-0 weights on the card
    against the CPU: two O0 AdamW steps and three O2 bf16 steps (fp32
    masters, schedule, clip, decay), dense and with moe=True,
    num_experts=4; then a cached decode on the card against its uncached
    forward."""
    from paddle_tpu_torch.dygraph import no_grad
    from paddle_tpu_torch.text import gpt_tiny
    b, s, vocab = GPT_TINY["batch"], GPT_TINY["seq"], GPT_TINY["vocab"]
    gen = torch.Generator().manual_seed(3)
    ids = torch.randint(0, vocab, (b, s), generator=gen, dtype=torch.int32)
    for kw in ({}, {"moe": True, "num_experts": 4}):
        tpt.set_device("cpu")
        tpt.seed(0)
        state = {k: v.numpy().copy() for k, v in
                 gpt_tiny(**kw).state_dict().items()}
        start = {k: torch.from_numpy(v) for k, v in state.items()}
        name = "moe" if kw else "dense"
        for level, steps in (("O0", 2), ("O2", 3)):
            cpu = _gpt_tiny_run(tpt, fa, "cpu", state, ids, kw, level,
                                steps)
            card = _gpt_tiny_run(tpt, fa, dev, state, ids.to(dev), kw,
                                 level, steps)
            losses, auxes, final, calls, launches, seen = card
            dname = "bfloat16" if level == "O2" else "float32"
            print(f"[gpt_tiny] {name} {level}: losses card {losses} cpu "
                  f"{cpu[0]}; aux losses card {auxes} cpu {cpu[1]}; K1-K3 "
                  f"launches {launches}, flash op q/k/v dtypes "
                  f"{dict(seen)}, blockwise-route calls {calls}")
            check(launches == [2 * steps] * 3 and calls == 0 and
                  dict(seen) == {(dname,) * 3: 2 * steps},
                  f"gpt_tiny {name} {level}: K1-K3 not launched on "
                  f"{dname} inputs every layer")
            tol = O2_LOSS_TOL if level == "O2" else GPT_O0_LOSS_TOL
            err_of(torch.tensor(losses), torch.tensor(cpu[0]), *tol, "loss")
            if kw:
                check(all(len(a) == 2 for a in auxes), "no aux losses")
                err_of(torch.tensor(auxes), torch.tensor(cpu[1]), *tol,
                       "aux")
            limit = O2_UPDATE_TOL if level == "O2" else GPT_O0_UPDATE_TOL
            # O2's masters start from the bf16-rounded weights
            base = {k: v.to(torch.bfloat16).float() if level == "O2"
                    else v for k, v in start.items()}
            worst, err, median = o2_update_errors(final, cpu[2], base,
                                                  GPT_ZERO_GRAD)
            print(f"[gpt_tiny] {name} {level}: update error card against "
                  f"CPU worst {err:.3e} ({worst}), median {median:.3e} "
                  f"(bound {limit:g})")
            check(err <= limit, f"gpt_tiny {name} {level} disagrees: "
                  f"{worst}")
    # the cached decode on the card equals the uncached forward there
    tpt.set_device(dev)
    tpt.seed(0)
    model = gpt_tiny().eval()
    n = GPT_TINY["prompt"] + GPT_TINY["decode"]
    card_ids = ids[:, :n].to(dev)
    calls = fa.blockwise_route.calls
    with no_grad():
        cached = gpt_cached_logits(model, card_ids, GPT_TINY["prompt"])
        full = model(card_ids)
    torch.cuda.synchronize()
    calls = fa.blockwise_route.calls - calls
    print(f"[gpt_tiny] cached decode: prompt {GPT_TINY['prompt']}, then "
          f"{GPT_TINY['decode']} steps; blockwise-route calls {calls}")
    check(calls == GPT_TINY["decode"] * 2, "the decode steps did not take "
          "the q_offset route once a layer")
    err_of(cached, full, 1e-4, 1e-5, "cache")


def phase_gpt_cache(tpt, fa, dev):
    """GPT-3 1.3B from seed 0 in fp32, eval(), batch 1: a 128-token prompt
    through the blocks with fresh caches (K1 once a layer), then 16
    single-token steps (the q_offset route once a layer a step), against
    the uncached forward over all 144 tokens. Returns the model."""
    from paddle_tpu_torch.dygraph import no_grad
    from paddle_tpu_torch.text import gpt3_1p3b
    tpt.set_device(dev)
    tpt.seed(0)
    t0 = time.perf_counter()
    model = gpt3_1p3b(vocab_size=GPT3["vocab"]).eval()
    n_params = sum(p.numel() for p in model.parameters())
    layers = len(model.gpt.blocks)
    gen = torch.Generator(device=dev).manual_seed(0)
    prompt, decode = GPT3["prompt"], GPT3["decode"]
    ids = torch.randint(0, GPT3["vocab"], (1, prompt + decode),
                        generator=gen, device=dev)
    torch.cuda.synchronize()
    print(f"[gpt_cache] GPT-3 1.3B, {n_params} parameters in "
          f"{len(list(model.parameters()))} tensors, fp32, built in "
          f"{time.perf_counter() - t0:.1f} s")
    fa.flash_fwd.launches = 0
    fa.blockwise_route.calls = 0
    with no_grad():
        t0 = time.perf_counter()
        cached = gpt_cached_logits(model, ids, prompt)
        torch.cuda.synchronize()
        cached_s = time.perf_counter() - t0
        k1, calls = fa.flash_fwd.launches, fa.blockwise_route.calls
        full = model(ids)
    torch.cuda.synchronize()
    top = full.abs().max().item()
    print(f"[gpt_cache] prompt {prompt} then {decode} single-token steps in "
          f"{cached_s * 1e3:.1f} ms ({cached_s / (decode + 1) * 1e3:.2f} ms "
          f"a call of the blocks); K1 launches {k1} (expected {layers}), "
          f"blockwise-route calls {calls} (expected {decode * layers}); "
          f"largest |logit| {top:.4f}")
    check(k1 == layers and calls == decode * layers,
          "the prefill or the decode took the wrong route")
    for what, sl in (("prompt", slice(0, prompt)),
                     ("decode", slice(prompt, None))):
        err_of(cached[:, sl], full[:, sl], GPT_CACHE_TOL,
               GPT_CACHE_TOL * top, what)
    check(bool(torch.isfinite(full).all()) and
          full.shape == (1, prompt + decode, GPT3["vocab"]), "bad logits")
    return model


def gpt_matmul_params(model):
    """Parameters that enter a matmul a token: every weight of the
    blocks (not the LayerNorms and biases) and the tied LM head."""
    blocks = sum(p.numel() for n, p in model.named_parameters()
                 if n.endswith("weight") and p.ndim >= 2 and ".blocks." in n)
    return blocks + model.gpt.wte.weight.numel()


def gpt_attention_flops(layers, b, s, d_model):
    """Attention's model FLOPs a training step: QK^T and PV (2 products
    of 2 B S^2 d each) over the causal half, times 3 (forward and
    backward)."""
    return 3 * 2 * 2 * b * causal_pairs(s, True) * d_model * layers


def phase_gpt_o2(tpt, fa, dev, model):
    """The main path of this slice: GPT-3 1.3B pretraining at AMP O2 bf16
    through amp.decorate and TrainStep(amp_level="O2"), fp32 masters,
    AdamW (beta 0.9 / 0.95, eps 1e-8, weight decay 0.1) with GPT-3's
    warm-up and cosine schedule, ClipGradByGlobalNorm(1.0), micro-batch 4
    at seq 2048."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import lr
    b, s, vocab = GPT3["batch"], GPT3["seq"], GPT3["vocab"]
    warmup, steps = GPT3["warmup"], GPT3["steps"]
    layers = len(model.gpt.blocks)
    model.train()
    sched = gpt3_schedule(lr)
    model, opt = amp.decorate(model, gpt_opt(model, sched), level="O2")
    train = TrainStep(model, gpt_step_fn, opt, amp_level="O2").ensure_state()
    start = {n: m.cpu() for n, m in train._masters.items()}
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = [torch.randint(0, vocab, (b, s), generator=gen, device=dev,
                             dtype=torch.int32) for _ in range(2)]
    n_mm = gpt_matmul_params(model)
    attn = gpt_attention_flops(layers, b, s, model.gpt.d_model)
    torch.cuda.synchronize()
    print(f"[gpt_o2] GPT-3 1.3B O2 bf16, {len(start)} fp32 masters; "
          f"{n_mm} matmul parameters (LM head included); warm-up "
          f"{GPT3_WARMUP_STEPS} steps, cosine to 10% over "
          f"{GPT3_DECAY_STEPS}")
    torch.cuda.reset_peak_memory_stats()
    for w in fa.WRAPPERS:
        w.launches = 0
    fa.blockwise_route.calls = 0
    with op_dtypes() as seen:
        losses = []
        for i in range(warmup):
            losses.append(float(train(batches[i % 2])))
            sched.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = []
        for i in range(steps):
            out.append(train(batches[(warmup + i) % 2]))
            sched.step()
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / steps
    launches = {w.__name__: w.launches for w in fa.WRAPPERS}
    calls = fa.blockwise_route.calls
    losses += [float(x) for x in out]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile_call(lambda: train(batches[0]))
    sched.step()
    n_steps = warmup + steps
    unmoved = [n for n, m in train._masters.items()
               if torch.equal(m.cpu(), start[n])]
    tokens_s = GPT3_TOKENS / step_s
    mfu = 6 * n_mm * tokens_s / PEAK_OPS_S[torch.bfloat16]
    mfu_attn = (6 * n_mm * GPT3_TOKENS + attn) / step_s / \
        PEAK_OPS_S[torch.bfloat16]
    print(f"[gpt_o2] losses {losses} (ln {vocab} = {math.log(vocab):.3f})")
    print(f"[gpt_o2] step_ms {step_s * 1e3:.3f}  samples/s {b / step_s:.3f}"
          f"  tokens/s {tokens_s:.1f}  peak_mem {peak:.3f} GiB")
    print(f"[gpt_o2] MFU {mfu:.4f} = 6 x {n_mm} x tokens/s / 989e12; with "
          f"attention {mfu_attn:.4f} = (6 x {n_mm} x {GPT3_TOKENS} + "
          f"{attn:.4e} attention FLOPs a step) / step time / 989e12")
    print(f"[gpt_o2] one profiled step: {prof['launches']} kernel launches, "
          f"{prof['syncs']} host syncs (cudaStreamSynchronize), device busy "
          f"{prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} ms (idle share "
          f"{1 - prof['busy_ms'] / prof['wall_ms']:.3f})")
    print(f"[gpt_o2] device ms by op: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(prof["by_op_ms"].items(),
                                          key=lambda kv: -kv[1])[:12]))
    print(f"[gpt_o2] CUDA runtime calls: " + ", ".join(
        f"{k} {v}" for k, v in prof["runtime"].most_common(8)))
    print(f"[gpt_o2] launches over {n_steps} steps: {launches} (expected "
          f"{layers * n_steps} each); flash op q/k/v dtypes {dict(seen)}; "
          f"blockwise-route calls {calls}; masters moved "
          f"{len(start) - len(unmoved)} of {len(start)}, unmoved {unmoved}")
    check(all(math.isfinite(x) for x in losses), "non-finite loss")
    check(abs(losses[0] - math.log(vocab)) < 1.0,
          "first loss far from ln(vocab)")
    for name, n in launches.items():
        check(n == layers * n_steps, f"{name}: {n} launches, expected "
              f"{layers * n_steps} ({layers} a step)")
    check(dict(seen) == {("bfloat16",) * 3: layers * n_steps},
          f"flash op q/k/v dtypes {dict(seen)}: expected bf16 only")
    check(calls == 0, f"{calls} calls took the blockwise route")
    check(all(p.dtype == torch.bfloat16 for p in model.parameters()) and
          all(m.dtype == torch.float32 for m in train._masters.values()),
          "parameters not bf16 or masters not fp32")
    # the warm-up's first steps move a master by lr (some 1e-8): under half
    # an ulp of 1.0, so a LayerNorm scale may stay where it started
    check(all(n.endswith(("ln1.weight", "ln2.weight", "ln_f.weight"))
              for n in unmoved), f"masters that did not move: {unmoved}")
    return launches


def bwd_frobenius(fa, q, k, v, o, lse, g, causal, got):
    """Relative Frobenius errors of ``got`` = K2/K3's (dq, dk, dv) against
    the plain backward in fp32 on the same inputs, and of the control:
    that backward with the last DROPPED_KEYS keys left out (their dk and
    dv 0), rounded to the inputs' dtype as the kernels' outputs are.
    Returns two dicts by name."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, o, g))
    want = fa.blockwise_attention_backward(qf, kf, vf, of, lse, gf, causal,
                                           scale)[:3]
    kept = k.shape[1] - DROPPED_KEYS
    dq, dk, dv, _ = fa.blockwise_attention_backward(
        qf, kf[:, :kept], vf[:, :kept], of, lse, gf, causal, scale)
    dk, dv = (torch.cat([t, t.new_zeros(t.shape[0], DROPPED_KEYS,
                                        *t.shape[2:])], 1) for t in (dk, dv))

    def rel(x, y):
        return ((x.double() - y.double()).norm() / y.double().norm()).item()
    names = ("dq", "dk", "dv")
    return ({n: rel(x, y) for n, x, y in zip(names, got, want)},
            {n: rel(x.to(q.dtype), y)
             for n, x, y in zip(names, (dq, dk, dv), want)})


def phase_gpt_kernels(fa, dev):
    """K1-K3 at GPT-3 1.3B's shape (B4 S2048 H16 D128, causal, bf16), as
    the O2 step feeds them: against their plain versions (and K2/K3 by
    relative Frobenius error against the plain backward in fp32, beside
    a control that must fail), bitwise determinism, blocks per SM and
    waves, and phase_timing's times and bounds (over the causal triangle)
    beside SDPA's bf16 causal forward and backward. Returns (rows,
    largest error by wrapper)."""
    from paddle_tpu_torch.ops import kernels
    b, s, h, d, causal = GPT_SHAPE
    dtype = torch.bfloat16
    scale = 1.0 / math.sqrt(d)
    gen = torch.Generator(device=dev).manual_seed(23)
    q, k, v, g = (torch.randn(b, s, h, d, generator=gen, device=dev)
                  .to(dtype) for _ in range(4))
    print(f"[gpt_kernels] B{b} S{s} H{h} D{d} causal={causal} bf16")
    errs, _ = kernels_against_plain(fa, q, k, v, g, causal, dtype)
    runs = []
    for _ in range(2):
        o, lse = fa.flash_fwd(q, k, v, causal, scale)
        dq, delta = fa.flash_bwd_dq(q, k, v, o, g, lse, causal, scale)
        runs.append((o, lse, dq, delta) + fa.flash_bwd_dkv(
            q, k, v, g, lse, delta, causal, scale))
    same = all(torch.equal(x, y) for x, y in zip(*runs))
    print(f"[gpt_kernels] two runs of K1, K2 and K3: "
          f"{'bitwise equal' if same else 'DIFFER'}")
    check(same, "K1-K3 at GPT's shape not bitwise deterministic")
    o, lse, dq, _, dk, dv = runs[0]
    del runs
    frob, control = bwd_frobenius(fa, q, k, v, o, lse, g, causal,
                                  (dq, dk, dv))
    print(f"[gpt_kernels] K2/K3 against the plain backward in fp32, "
          f"relative Frobenius error: "
          + " ".join(f"{n} {e:.3e}" for n, e in frob.items())
          + f"; control (last {DROPPED_KEYS} keys left out): "
          + " ".join(f"{n} {e:.3e}" for n, e in control.items())
          + f" (bound {GRAD_FROB_BOUND:g})")
    check(max(frob.values()) <= GRAD_FROB_BOUND,
          f"K2/K3 at GPT's shape against fp32: {frob}")
    check(min(control.values()) > GRAD_FROB_BOUND,
          f"the control passes the bound, which then sees no missing key "
          f"tile: {control}")
    lib = kernels.library("flash_attention")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for which, wrapper in enumerate(REPLACES):
        blocks, threads, smem, rows = occupancy(lib, which, 1, d)
        grid = b * h * -(-s // rows)
        print(f"[gpt_kernels] {KERNEL_FN[wrapper]} bf16 D{d}: {blocks} "
              f"blocks/SM ({threads} threads, {smem} B shared); grid "
              f"{grid} blocks on {sms} SMs = {grid / (blocks * sms):.3f} "
              f"waves")
    return phase_timing(fa, dev, dtype, GPT_SHAPE, n=5), errs


# ------------------------------------------------------------- static graph
def port_static_api():
    """The port's static-graph surface as the builders below take it (the
    CPU tests hand them the JAX package's)."""
    import types
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io, static
    from paddle_tpu_torch.nn import ParamAttr
    from paddle_tpu_torch.nn.initializer import Uniform
    from paddle_tpu_torch.optimizer import Momentum
    return types.SimpleNamespace(pt=pt, static=static, io=io,
                                 ParamAttr=ParamAttr, Uniform=Uniform,
                                 Momentum=Momentum)


# tests/test_book.py's six programs: (steps, SGD learning rate)
BOOK = {"fit_a_line": (200, 0.01), "recognize_digits": (60, 0.1),
        "word2vec": (150, 0.5), "sentiment": (60, 0.3),
        "label_semantic_roles": (60, 0.2), "recommender": (80, 0.2)}


def book_params(prog):
    return [n for n, v in prog.global_block().vars.items()
            if v.persistable and "@" not in n]


def book_program(api, name, backward=True):
    """tests/test_book.py's program ``name`` built with ``api`` (either
    package), with (``backward``) its grad ops and its SGD ops reading
    the persistable "lr@book": (main, startup, {"loss": name, other
    fetches})."""
    pt, static = api.pt, api.static
    nn = static.nn
    prog, startup = pt.Program(), pt.Program()
    fetch = {}
    with static.program_guard(prog, startup):
        if name == "fit_a_line":
            x = static.data("x", [16, 13], "float32")
            y = static.data("y", [16, 1], "float32")
            pred = nn.fc(x, size=1)
            loss = nn.mean(nn.square(nn.elementwise_sub(pred, y)))
            fetch["pred"] = pred.name
        elif name == "recognize_digits":
            img = static.data("img", [32, 1, 16, 16], "float32")
            label = static.data("label", [32, 1], "int64")
            c1 = nn.conv2d(img, num_filters=8, filter_size=3, padding=1,
                           act="relu")
            p1 = nn.pool2d(c1, pool_size=2, pool_stride=2)
            c2 = nn.conv2d(p1, num_filters=16, filter_size=3, padding=1,
                           act="relu")
            p2 = nn.pool2d(c2, pool_size=2, pool_stride=2)
            logits = nn.fc(p2, size=4)
            loss = nn.mean(nn.softmax_with_cross_entropy(logits, label))
            fetch["acc"] = nn.accuracy(nn.softmax(logits), label).name
        elif name == "word2vec":
            w1 = static.data("w1", [32, 1], "int64")
            w2 = static.data("w2", [32, 1], "int64")
            nxt = static.data("nxt", [32, 1], "int64")
            e1 = nn.embedding(w1, size=[30, 16])
            e2 = nn.embedding(w2, size=[30, 16])
            cat = nn.concat([nn.flatten(e1), nn.flatten(e2)], axis=1)
            h = nn.fc(cat, size=32, act="relu")
            logits = nn.fc(h, size=30)
            loss = nn.mean(nn.softmax_with_cross_entropy(logits, nxt))
        elif name == "sentiment":
            words = static.data("words", [16, 10], "int64")
            length = static.data("length", [16], "int64")
            label = static.data("slabel", [16, 1], "int64")
            embd = nn.embedding(words, size=[20, 8])
            conv = nn.sequence_conv(embd, num_filters=16, filter_size=3,
                                    act="relu")
            pooled = nn.sequence_pool(conv, length, pooltype="MAX")
            logits = nn.fc(pooled, size=2)
            loss = nn.mean(nn.softmax_with_cross_entropy(logits, label))
        elif name == "label_semantic_roles":
            x = static.data("cx", [8, 6, 5], "float32")
            tags = static.data("ctags", [8, 6], "int64")
            length = static.data("clen", [8], "int64")
            emission = nn.fc(x, size=3, num_flatten_dims=2)
            loss = nn.mean(nn.linear_chain_crf(emission, tags,
                                               length=length))
        elif name == "recommender":
            uid = static.data("uid", [16, 1], "int64")
            iid = static.data("iid", [16, 1], "int64")
            rating = static.data("rating", [16, 1], "float32")
            ue = nn.fc(nn.flatten(nn.embedding(uid, size=[12, 8])),
                       size=8, act="relu")
            ie = nn.fc(nn.flatten(nn.embedding(iid, size=[15, 8])),
                       size=8, act="relu")
            sim = nn.cos_sim(ue, ie)
            loss = nn.mean(nn.square(nn.elementwise_sub(sim, rating)))
        else:
            raise KeyError(name)
    fetch["loss"] = loss.name
    if not backward:
        return prog, startup, fetch
    blk = prog.global_block()
    pgs = pt.append_backward(loss.name, parameter_list=book_params(prog),
                             program=prog)
    blk.create_var("lr@book", persistable=True)
    for p, g in pgs:
        blk.append_op("sgd", {"Param": [p], "Grad": [g],
                              "LearningRate": ["lr@book"]},
                      {"ParamOut": [p]}, {})
    return prog, startup, fetch


def book_feeds(name):
    """tests/test_book.py's synthetic batches for ``name``, drawn in the
    test's order: (one feed a step, a held-out feed or None)."""
    steps = BOOK[name][0]
    rs = np.random.RandomState(list(BOOK).index(name))
    feeds = []
    if name == "fit_a_line":
        true_w = rs.randn(13, 1).astype(np.float32)
        for _ in range(steps):
            xb = rs.randn(16, 13).astype(np.float32)
            feeds.append({"x": xb, "y": xb @ true_w + 0.1})
        return feeds, {"x": rs.randn(16, 13).astype(np.float32)}
    for _ in range(steps):
        if name == "recognize_digits":
            lab = rs.randint(0, 4, (32, 1)).astype(np.int64)
            img = rs.randn(32, 1, 16, 16).astype(np.float32) * 0.1
            for i, label in enumerate(lab[:, 0]):
                r, c = divmod(int(label), 2)   # bright quadrant = class
                img[i, 0, r * 8:(r + 1) * 8, c * 8:(c + 1) * 8] += 1.0
            feeds.append({"img": img, "label": lab})
        elif name == "word2vec":
            a = rs.randint(0, 30, (32, 1)).astype(np.int64)
            b = rs.randint(0, 30, (32, 1)).astype(np.int64)
            feeds.append({"w1": a, "w2": b, "nxt": a})
        elif name == "sentiment":
            w = rs.randint(2, 20, (16, 10)).astype(np.int64)
            ln = rs.randint(4, 11, (16,)).astype(np.int64)
            lab = rs.randint(0, 2, (16, 1)).astype(np.int64)
            for i in range(16):
                w[i, ln[i]:] = 0
                if lab[i, 0] == 1:             # plant the keyword
                    w[i, rs.randint(0, ln[i])] = 1
                else:
                    w[i, :][w[i, :] == 1] = 2
            feeds.append({"words": w, "length": ln, "slabel": lab})
        elif name == "label_semantic_roles":
            lab = rs.randint(0, 3, (8, 6)).astype(np.int64)
            xs = rs.randn(8, 6, 5).astype(np.float32) * 0.1
            xs[..., :3] += np.eye(3)[lab] * 2.0
            feeds.append({"cx": xs, "ctags": lab,
                          "clen": np.full((8,), 6, np.int64)})
        else:
            u = rs.randint(0, 12, (16, 1)).astype(np.int64)
            i = rs.randint(0, 15, (16, 1)).astype(np.int64)
            r = (((u + i) % 2).astype(np.float32) * 2 - 1) * 0.5
            feeds.append({"uid": u, "iid": i, "rating": r})
    return feeds, None


def train_book(api, name, exe, scope, program, feeds, start=None):
    """Train a book program: its startup program, or the parameters in
    ``start`` ({name: array}); then one step a feed. Returns (losses,
    the last step's fetches, {param: array})."""
    prog, startup, fetch = program
    names = [fetch["loss"]] + [v for k, v in fetch.items()
                               if k not in ("loss", "pred")]
    with api.pt.scope_guard(scope):
        if start is None:
            exe.run(startup, feed={}, fetch_list=[], scope=scope)
        else:
            for n, v in start.items():
                scope.var(n).set(api.pt.TpuTensor(v))
        scope.var("lr@book").set(api.pt.TpuTensor(
            np.float32(BOOK[name][1])))
        losses, last = [], None
        for feed in feeds:
            last = exe.run(prog, feed=feed, fetch_list=names, scope=scope)
            losses.append(float(np.asarray(last[0]).ravel()[0]))
    params = {n: np.asarray(scope.find_var(n).get().numpy())
              for n in book_params(prog)}
    return losses, last, params


def book_converged(name, losses, last):
    """tests/test_book.py's threshold for ``name``."""
    first, final = losses[0], losses[-1]
    if name == "fit_a_line":
        return final < 1e-2
    if name == "recognize_digits":
        return (final < 0.1 * first or final < 0.05) and \
            float(np.asarray(last[1]).ravel()[0]) > 0.9
    return final < {"word2vec": 0.3, "sentiment": 0.5,
                    "label_semantic_roles": 0.6,
                    "recommender": 0.7}[name] * first


def inference_roundtrip(api, exe, scope, program, feed, path):
    """fit_a_line's save_inference_model -> load_inference_model: the
    trained program and the loaded one predict on ``feed``; returns both
    predictions."""
    prog, _, fetch = program
    pt, io = api.pt, api.io
    with pt.scope_guard(scope):
        io.save_inference_model(path, ["x"], [fetch["pred"]], exe,
                                main_program=prog, scope=scope)
    scope2 = pt.Scope()
    with pt.scope_guard(scope2):
        prog2, feeds, fetches = io.load_inference_model(path, exe,
                                                        scope=scope2)
        p2, = exe.run(prog2, feed={feeds[0]: feed["x"]}, fetch_list=fetches,
                      scope=scope2)
    p1, = exe.run(prog, feed=dict(feed, y=np.zeros((16, 1), np.float32)),
                  fetch_list=[fetch["pred"]], scope=scope)
    return np.asarray(p1), np.asarray(p2)


def static_resnet(api, batch, px, class_dim=1000, depth=(3, 4, 6, 3),
                  num_filters=(64, 128, 256, 512), lr=0.1, momentum=0.9,
                  train=True):
    """The classic fluid ResNet (PaddlePaddle/models PaddleCV
    image_classification/models/resnet.py; ResNet50 is depth [3, 4, 6, 3]
    at widths 64-512) with its parameter names, trained by
    softmax_with_cross_entropy + mean and Momentum(lr, momentum)
    .minimize (with ``train``), NCHW fp32, built with ``api`` (either
    package): (main, startup, {"loss", "acc", "image", "label"})."""
    pt, static = api.pt, api.static
    nn = static.nn

    def conv_bn(x, filters, size, stride=1, act=None, name=None):
        conv = nn.conv2d(x, num_filters=filters, filter_size=size,
                         stride=stride, padding=(size - 1) // 2,
                         param_attr=name + "_weights", bias_attr=False)
        bn = "bn_" + name if name == "conv1" else "bn" + name[3:]
        return nn.batch_norm(conv, act=act, param_attr=bn + "_scale",
                             bias_attr=bn + "_offset",
                             moving_mean_name=bn + "_mean",
                             moving_variance_name=bn + "_variance")

    def bottleneck(x, filters, stride, name):
        a = conv_bn(x, filters, 1, act="relu", name=name + "_branch2a")
        b = conv_bn(a, filters, 3, stride, act="relu",
                    name=name + "_branch2b")
        c = conv_bn(b, filters * 4, 1, name=name + "_branch2c")
        if x.shape[1] != filters * 4 or stride != 1:
            x = conv_bn(x, filters * 4, 1, stride, name=name + "_branch1")
        return nn.elementwise_add(x, c, act="relu")

    prog, startup = pt.Program(), pt.Program()
    with static.program_guard(prog, startup):
        image = static.data("image", [batch, 3, px, px], "float32")
        label = static.data("label", [batch, 1], "int64")
        conv = conv_bn(image, 64, 7, 2, act="relu", name="conv1")
        conv = nn.pool2d(conv, pool_size=3, pool_stride=2, pool_padding=1,
                         pool_type="max")
        for block, n in enumerate(depth):
            for i in range(n):
                conv = bottleneck(conv, num_filters[block],
                                  2 if i == 0 and block != 0 else 1,
                                  f"res{block + 2}{chr(97 + i)}")
        pool = nn.pool2d(conv, pool_type="avg", global_pooling=True)
        stdv = 1.0 / math.sqrt(pool.shape[1] * 1.0)
        out = nn.fc(pool, size=class_dim, param_attr=api.ParamAttr(
            initializer=api.Uniform(-stdv, stdv)))
        cost, prob = nn.softmax_with_cross_entropy(out, label,
                                                   return_softmax=True)
        loss = nn.mean(cost)
        acc = nn.accuracy(prob, label, k=1)
        if train:
            api.Momentum(learning_rate=lr, momentum=momentum).minimize(loss)
    return prog, startup, {"loss": loss.name, "acc": acc.name,
                           "image": image.name, "label": label.name}


# card against CPU for the book programs, from the same startup
# parameters and feeds: per-step losses (rtol, atol) and each final
# parameter by its update error ||card - cpu|| / ||cpu - start||. Both
# fp32 (TF32 off); measured on an NVIDIA H100 80GB HBM3 at 700.00 W:
# losses within 5.3e-5 relative (label_semantic_roles; recognize_digits,
# on cuDNN, 3.7e-5), updates within 1.1e-5 (recognize_digits); the
# bounds stand 10x over those
STATIC_BOOK_TOL = {"loss": (5e-4, 1e-5), "update": 1e-4}
# the tiny static ResNet of tests/test_torch_executor.py
STATIC_RESNET_TINY = dict(batch=4, px=64, class_dim=10, depth=(1, 1, 1, 1),
                          num_filters=(8, 16, 32, 64), lr=1e-2)
STATIC_RESNET50 = dict(batch=256, px=224, class_dim=1000, lr=0.1)
STATIC_FLASH = (16, 128, 12, 64)                    # B, S, H, D: BERT-base


def update_errors(got, want, start):
    """{name: ||got - want|| / ||want - start||} over numpy dicts."""
    return {n: float(np.linalg.norm(got[n] - want[n]) /
                     max(np.linalg.norm(want[n] - start[n]), 1e-12))
            for n in want}


def phase_static_book(tpt, dev):
    """The six book programs through Program -> append_backward -> SGD ops
    -> Executor on the card, against the port's CPU run of the same
    program from the same startup parameters and feeds; each meets its
    tests/test_book.py threshold, and fit_a_line round-trips through
    save_inference_model / load_inference_model on the card."""
    api = port_static_api()
    tpt.set_device(dev)
    tol = STATIC_BOOK_TOL
    for name in BOOK:
        program = book_program(api, name)
        feeds, held_out = book_feeds(name)
        scope0 = api.pt.Scope()
        api.pt.Executor("cpu").run(program[1], scope=scope0)
        start = {n: scope0.find_var(n).get().numpy()
                 for n in book_params(program[0])}
        card_exe, card_scope = api.pt.Executor(), api.pt.Scope()
        t0 = time.perf_counter()
        gl, glast, gp = train_book(api, name, card_exe, card_scope, program,
                                   feeds, start)
        card_s = time.perf_counter() - t0
        cl, _, cp = train_book(api, name, api.pt.Executor("cpu"),
                               api.pt.Scope(), program, feeds, start)
        loss_err = max(abs(g - c) / max(abs(c), 1e-12)
                       for g, c in zip(gl, cl))
        loss_ok = bool(np.allclose(gl, cl, rtol=tol["loss"][0],
                                   atol=tol["loss"][1]))
        errs = update_errors(gp, cp, start)
        worst = max(errs, key=errs.get)
        converged = book_converged(name, gl, glast)
        print(f"[static_book] {name}: {len(feeds)} steps on the card in "
              f"{card_s:.2f} s ({len(program[0].global_block().ops)} ops a "
              f"step); loss {gl[0]:.6f} -> {gl[-1]:.6f} (cpu {cl[-1]:.6f}), "
              f"worst loss rel err {loss_err:.3e} (rtol/atol "
              f"{tol['loss'][0]:g}/{tol['loss'][1]:g}) "
              f"{'ok' if loss_ok else 'FAIL'}; parameters' update error "
              f"worst {errs[worst]:.3e} ({worst}, bound {tol['update']:g}); "
              f"book threshold {'met' if converged else 'MISSED'}")
        check(converged, f"{name}: the card run misses its book threshold")
        check(loss_ok, f"{name}: card losses disagree with the CPU")
        check(errs[worst] <= tol["update"],
              f"{name}: card parameters disagree with the CPU")
        if held_out is not None:
            p1, p2 = inference_roundtrip(api, card_exe, card_scope, program,
                                         held_out, "build/static_book/" + name)
            same = bool(np.allclose(p1, p2, rtol=1e-5))
            print(f"[static_book] {name}: save_inference_model -> "
                  f"load_inference_model predicts "
                  f"{'the same' if same else 'DIFFERENTLY'} (rtol 1e-5)")
            check(same, "inference round trip changed the predictions")


def _static_resnet_tiny_run(api, device, program, start, feeds):
    prog, _, fetch = program
    exe, scope = api.pt.Executor(device), api.pt.Scope()
    for n, v in start.items():
        scope.var(n).set(api.pt.TpuTensor(v, device=device))
    losses, states = [], []
    for feed in feeds:
        losses.append(float(exe.run(prog, feed=feed,
                                    fetch_list=[fetch["loss"]],
                                    scope=scope)[0][0]))
        states.append({n: scope.find_var(n).get().numpy() for n in start})
    return losses, states


def phase_static_resnet_tiny(tpt, dev):
    """The static ResNet builder at narrow widths (batch 4, 64 px,
    Momentum 1e-2) on the card against the CPU for two steps, with
    phase resnet_tiny's bounds (cuDNN's fp32 drift)."""
    api = port_static_api()
    tpt.set_device(dev)
    program = static_resnet(api, **STATIC_RESNET_TINY)
    scope0 = api.pt.Scope()
    api.pt.Executor("cpu").run(program[1], scope=scope0)
    start = {n: scope0.find_var(n).get().numpy()
             for n, v in program[1].global_block().vars.items()
             if v.persistable}
    rs = np.random.RandomState(4)
    b, px, c = (STATIC_RESNET_TINY[k] for k in ("batch", "px", "class_dim"))
    feeds = [{"image": rs.rand(b, 3, px, px).astype(np.float32),
              "label": rs.randint(0, c, (b, 1)).astype(np.int64)}
             for _ in range(2)]
    gl, gs = _static_resnet_tiny_run(api, dev, program, start, feeds)
    cl, cs = _static_resnet_tiny_run(api, "cpu", program, start, feeds)
    print(f"[static_resnet_tiny] losses card {gl} cpu {cl}")
    tol = RESNET_TINY_TOL
    bad = []
    for i in range(2):
        params = [n for n in start if "@" not in n and "learning_rate"
                  not in n and not n.endswith(("_mean", "_variance"))]
        bufs = [n for n in start if n.endswith(("_mean", "_variance"))]
        errs = update_errors({n: gs[i][n] for n in params},
                             {n: cs[i][n] for n in params}, start)
        worst = max(errs, key=errs.get)
        buf = max(float(np.abs(gs[i][n] - cs[i][n]).max()) for n in bufs)
        loss_err = abs(gl[i] - cl[i]) / cl[i]
        ok = {"loss": loss_err <= tol["loss"][i],
              "update": errs[worst] <= tol["update"][i],
              "buffer": all(np.allclose(gs[i][n], cs[i][n],
                                        rtol=tol["buffer"][i],
                                        atol=tol["buffer"][i])
                            for n in bufs)}
        print(f"[static_resnet_tiny] step {i + 1}: loss rel err "
              f"{loss_err:.3e} (bound {tol['loss'][i]:g}); update error "
              f"worst {errs[worst]:.3e} ({worst}), median "
              f"{sorted(errs.values())[len(errs) // 2]:.3e} (bound "
              f"{tol['update'][i]:g}); BN running stats max_abs {buf:.3e} "
              f"(rtol/atol {tol['buffer'][i]:g}) "
              + " ".join(f"{k} {'ok' if v else 'FAIL'}"
                         for k, v in ok.items()))
        bad += [f"step {i + 1} {k}" for k, v in ok.items() if not v]
    check(not bad, f"static ResNet on the card disagrees with the CPU: {bad}")


def _timed_steps(step, warmup, steps):
    """Per-step wall times (ms) of ``steps`` calls after ``warmup``, each
    closed by a device sync. The peak-memory count restarts after the
    warm-up: cudnn.benchmark's first-step trials (workspaces of some GB)
    fall in the first path timed, not in the ones after it."""
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _report(label, times, batch, extra="", prof=None):
    med = sorted(times)[len(times) // 2]
    print(f"[static_resnet50] {label}: step_ms median {med:.3f} range "
          f"{min(times):.3f}-{max(times):.3f} over {len(times)} steps, img/s "
          f"{batch / med * 1e3:.2f}{extra}")
    if prof is not None:
        top = sorted(prof["by_op_ms"].items(), key=lambda kv: -kv[1])[:6]
        print(f"[static_resnet50] {label}: profiled step {prof['wall_ms']:.3f}"
              f" ms, device busy {prof['busy_ms']:.3f} ms (idle "
              f"{1 - prof['busy_ms'] / prof['wall_ms']:.3f}), launches "
              f"{prof['launches']}, host syncs {prof['syncs']}; device ms by "
              f"launching op (backward kernels, launched by autograd's own "
              f"thread, are not linked): "
              + ", ".join(f"{k} {v:.3f}" for k, v in top))
    return med


def phase_static_resnet50(tpt, dev):
    """The classic fluid ResNet-50 (static_resnet) at full width: fp32,
    NCHW, batch 256 at 224 px, Momentum(0.1, 0.9).minimize, through the
    static executor on the card, 3 warm-up and 10 timed steps on one
    seed-0 batch (the grad-op record route), then the recompute route,
    then the port's dygraph ResNet-50 at O0 through jit.TrainStep on the
    same batch: step times, images/s, peak memory, launches and host
    syncs a step."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50
    api = port_static_api()
    tpt.set_device(dev)
    tpt.seed(0)
    cfg = STATIC_RESNET50
    b = cfg["batch"]
    t0 = time.perf_counter()
    prog, startup, fetch = static_resnet(api, b, cfg["px"], cfg["class_dim"],
                                         lr=cfg["lr"])
    ops = prog.global_block().ops
    print(f"[static_resnet50] program built in {time.perf_counter() - t0:.2f}"
          f" s: {len(ops)} ops ({sum(o.type.endswith('_grad') for o in ops)}"
          f" grad ops, {prog.op_types().count('momentum')} momentum), "
          f"{len(book_params(prog))} persistables")
    exe, scope = api.pt.Executor(), api.pt.Scope()
    exe.run(startup, scope=scope)
    names = ("conv1_weights", "res5c_branch2c_weights", "bn_conv1_mean",
             "bn5c_branch2c_variance")
    first = {n: scope.find_var(n).get().value.clone() for n in names}
    gen = torch.Generator(device=dev).manual_seed(0)
    x, y = image_batch(gen, dev, b, cfg["px"], "NCHW", cfg["class_dim"])
    feed = {"image": x, "label": y.long()}
    losses = []

    def static_step(executor=exe, return_numpy=False):
        out = executor.run(prog, feed=feed, fetch_list=[fetch["loss"]],
                           scope=scope, return_numpy=return_numpy)
        losses.append(out[0])

    torch.backends.cudnn.benchmark = True      # as training scripts run
    try:
        static_times = _timed_steps(static_step, 3, 10)
        static_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        prof = profile_call(lambda: static_step(return_numpy=True))
        static_ms = _report(
            "static (record route)", static_times, b,
            f", peak_mem {static_peak:.3f} GiB, launches a step "
            f"{prof['launches']}, host syncs a step {prof['syncs']} (the "
            f"loss fetched as numpy)", prof)
        loss_vals = [float(v.value) for v in losses[:-1]] + [
            float(losses[-1][0])]
        print(f"[static_resnet50] losses over {len(loss_vals)} steps on one "
              f"batch: {[round(v, 4) for v in loss_vals]}")
        recompute = api.pt.Executor()
        recompute._force_recompute = True      # every grad op recomputes
        re_times = _timed_steps(lambda: static_step(recompute), 1, 5)
        re_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        re_ms = _report("static (recompute route)", re_times, b,
                        f", peak_mem {re_peak:.3f} GiB")
        after = {n: scope.find_var(n).get().value for n in names}
        del losses[:]

        model = resnet50(num_classes=cfg["class_dim"], data_format="NCHW")
        train = TrainStep(model, resnet_step_fn, Momentum(
            learning_rate=cfg["lr"], momentum=0.9,
            parameters=model.parameters()), amp_level="O0").ensure_state()
        dy_times = _timed_steps(lambda: train(x, y), 3, 10)
        dy_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        dprof = profile_call(lambda: float(train(x, y)))
        dy_ms = _report(
            "dygraph O0 (jit.TrainStep)", dy_times, b,
            f", peak_mem {dy_peak:.3f} GiB, launches a step "
            f"{dprof['launches']}, host syncs a step {dprof['syncs']} (the "
            f"loss read as a float)", dprof)
        del model, train
    finally:
        torch.backends.cudnn.benchmark = False
    print(f"[static_resnet50] static over dygraph O0: {static_ms / dy_ms:.4f}x"
          f" the step time ({static_ms - dy_ms:+.3f} ms); recompute over "
          f"record: {re_ms / static_ms:.4f}x")
    check(all(math.isfinite(v) for v in loss_vals), "non-finite loss")
    check(abs(loss_vals[0] - math.log(cfg["class_dim"])) < RESNET_LOSS0_TOL,
          f"first loss {loss_vals[0]} far from ln({cfg['class_dim']})")
    check(loss_vals[-1] < loss_vals[0],
          "the loss did not fall over repeated steps on one batch")
    for n in names:
        moved = not torch.equal(first[n], after[n])
        print(f"[static_resnet50] {n} {'moved' if moved else 'DID NOT MOVE'}")
        check(moved, f"{n} did not change over the steps")
    torch.cuda.empty_cache()


STATIC_DROPOUT_P = 0.3


def static_dropout_program(api, seed, impl):
    """fc -> dropout(STATIC_DROPOUT_P) -> mean(square), with its grad ops,
    built with ``api`` (either package): (main, startup, (weight, bias,
    mask, dropout output))."""
    pt, static = api.pt, api.static
    prog, startup = pt.Program(), pt.Program()
    with static.program_guard(prog, startup):
        x = static.data("x", [8, 16], "float32")
        h = static.nn.fc(x, size=16)
        d = static.nn.dropout(h, STATIC_DROPOUT_P, seed=seed,
                              dropout_implementation=impl)
        loss = static.nn.mean(static.nn.square(d))
    w, b = sorted(book_params(prog),
                  key=lambda n: -len(prog.global_block().var(n).shape))
    pt.append_backward(loss.name, parameter_list=[w, b], program=prog)
    mask, = [op.outputs["Mask"][0] for op in prog.global_block().ops
             if op.type == "dropout"]
    return prog, startup, (w, b, mask, d.name)


def static_dropout_step(run, prog, names, x, impl):
    """One step of a static_dropout_program through ``run`` (an
    executor's run with its scope bound): (the mask, (W@GRAD, b@GRAD),
    the gradients that mask gives in float64). d(mean(d**2))/dh is 2 d / N
    times the mask, and 1 / (1 - p) under upscale_in_train."""
    w, b, mask, d = names
    m, dd, gw, gb = run(prog, feed={"x": x},
                        fetch_list=[mask, d, w + "@GRAD", b + "@GRAD"])
    scale = (1.0 / (1 - STATIC_DROPOUT_P) if impl == "upscale_in_train"
             else 1.0)
    dh = 2.0 * dd.astype(np.float64) / dd.size * m * scale
    return m, (gw, gb), (x.astype(np.float64).T @ dh, dh.sum(0))


def static_flash_run(tpt, dev, dtype=torch.bfloat16, runs=2):
    """A static program of one flash_attention op (STATIC_FLASH, ``dtype``)
    and ``mean``, with append_backward on q, k and v, run ``runs`` times
    on ``dev``: (each run's K1, K2, K3 launch counts, the last run's o,
    dq, dk and dv, the dygraph op's o, dq, dk and dv on the same
    inputs). The dygraph launches come after the counted runs."""
    from paddle_tpu_torch.core.registry import OpInfoMap
    from paddle_tpu_torch.ops import flash_attention as fa
    b, s, h, d = STATIC_FLASH
    prog = tpt.Program()
    blk = prog.global_block()
    for n in "qkv":
        blk.create_var(n, shape=(b, s, h, d), dtype=dtype, persistable=True)
    blk.append_op("flash_attention", {"Q": ["q"], "K": ["k"], "V": ["v"]},
                  {"Out": ["o"]}, {"causal": False})
    blk.create_var("o", shape=(b, s, h, d), dtype=dtype)
    blk.append_op("mean", {"X": ["o"]}, {"Out": ["loss"]}, {})
    blk.create_var("loss", shape=(), dtype=dtype)
    pgs = tpt.append_backward("loss", parameter_list=["q", "k", "v"],
                              program=prog)
    gen = torch.Generator(device=dev).manual_seed(5)
    qkv = [torch.randn(b, s, h, d, generator=gen, device=dev).to(dtype)
           for _ in range(3)]
    scope = tpt.Scope()
    for n, t in zip("qkv", qkv):
        scope.var(n).set(tpt.TpuTensor(t))
    exe = tpt.Executor(dev)
    deltas, blockwise = [], fa.blockwise_route.calls
    for _ in range(runs):
        before = [w.launches for w in fa.WRAPPERS]
        outs = exe.run(prog, fetch_list=["o"] + [g for _, g in pgs],
                       scope=scope, return_numpy=False)
        deltas.append([w.launches - n for w, n in zip(fa.WRAPPERS, before)])
    check(fa.blockwise_route.calls == blockwise,
          "the static flash op took the blockwise route")
    leaves = [t.detach().clone().requires_grad_() for t in qkv]
    o = OpInfoMap.instance().get("flash_attention").compute(
        {"Q": [leaves[0]], "K": [leaves[1]], "V": [leaves[2]]},
        {"causal": False})["Out"][0]
    o.mean().backward()
    return (deltas, [t.value for t in outs],
            [o.detach()] + [t.grad for t in leaves])


def phase_static_flash(tpt, dev):
    """flash_attention through the static graph: K1 in the forward op and
    K2 and K3 in its grad op (the op's autograd Function, not the plain
    blockwise version), once each a run, and o, dq, dk and dv equal to the
    dygraph op's on the card."""
    from paddle_tpu_torch.ops import flash_attention as fa
    tpt.set_device(dev)
    for w in fa.WRAPPERS:
        w.launches = 0
    deltas, static, dygraph = static_flash_run(tpt, dev)
    print(f"[static_flash] B{STATIC_FLASH[0]} S{STATIC_FLASH[1]} "
          f"H{STATIC_FLASH[2]} D{STATIC_FLASH[3]} bf16: K1/K2/K3 launches "
          f"a run {deltas}")
    check(all(d == [1, 1, 1] for d in deltas),
          "the static flash program did not launch K1-K3 once each a run")
    for what, got, want in zip(("o", "dq", "dk", "dv"), static, dygraph):
        same = torch.equal(got, want)
        print(f"[static_flash] {what} {'equals' if same else 'DIFFERS FROM'}"
              f" the dygraph op's (max_abs "
              f"{(got.float() - want.float()).abs().max().item():.3e})")
        check(same, f"static {what} differs from the dygraph op's")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import kernels
    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 references
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(card)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()}")
    phase_build(kernels)
    errs = phase_kernels(fa, dev)
    phase_determinism(fa, dev)
    phase_fp64(fa, dev)
    rows = {dt: phase_timing(fa, dev, dt)
            for dt in (torch.float32, torch.bfloat16)}
    gpt_rows, gpt_errs = phase_gpt_kernels(fa, dev)
    phase_flash_route(fa, dev)
    phase_tiny(tpt, dev)
    phase_tiny_o2(tpt, fa, dev)
    launches = {torch.float32: phase_bert(tpt, fa, dev),
                torch.bfloat16: phase_bert_o2(tpt, fa, dev)}
    phase_resnet_tiny(tpt, dev)
    phase_resnet(tpt, dev)
    phase_detection_ops(dev)
    phase_yolov3_tiny(tpt, dev)
    phase_yolov3(tpt, dev)
    phase_gpt_tiny(tpt, fa, dev)
    model = phase_gpt_cache(tpt, fa, dev)
    gpt_launches = phase_gpt_o2(tpt, fa, dev, model)
    del model
    torch.cuda.empty_cache()
    phase_static_flash(tpt, dev)
    phase_static_book(tpt, dev)
    phase_static_resnet_tiny(tpt, dev)
    phase_static_resnet50(tpt, dev)
    # fp32 rows: launches on the O1 path (phase bert); bf16 rows: on the
    # O2 path (phase bert_o2); _gpt rows: at GPT-3 1.3B's shape, launches
    # on its O2 path (phase gpt_o2)
    record = {"kernels": [
        dict(name=name + ("" if dt == torch.float32 else "_bf16"),
             route="cuda", source=SOURCE, replaces=REPLACES[name],
             launches=launches[dt][name], max_abs_err=errs[name, dt],
             **rows[dt][name])
        for dt in (torch.float32, torch.bfloat16) for name in REPLACES] + [
        dict(name=name + "_gpt", route="cuda", source=SOURCE,
             replaces=REPLACES[name], launches=gpt_launches[name],
             max_abs_err=gpt_errs[name], **gpt_rows[name])
        for name in REPLACES]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
