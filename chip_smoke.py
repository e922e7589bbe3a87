#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (paddle_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when a check fails:
  1. the card: name, power limit and device count;
  2. build the flash-attention kernels from paddle_tpu_torch/csrc with nvcc
     (sm_90a) and print the build time and ptxas' register / shared-memory
     / spill report;
  3. hold each kernel (K1 forward, K2 dQ, K3 dK/dV) against its plain
     PyTorch version on the card, in fp32 and bf16, at BERT-base's shape and
     at the cases of tests/test_flash_tpu.py (ragged S, D=128, causal), also
     through the autograd Function; time each kernel with CUDA events beside
     its bound, its plain version and torch's SDPA (a yardstick only);
  4. BERT-tiny (head dim 64) for 2 O0 steps on the card and on the CPU
     from the same weights: losses and parameters agree;
  5. the main path: BERT-base pretraining through BertForPretraining,
     Momentum and TrainStep(amp_level="O1") at batch 16, seq 128 (as
     bench.py builds it), 2 warm-up and 5 timed steps; losses finite, step
     time, samples/s, peak memory and the kernels' launch counts (12 a step
     each).
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""
import functools
import json
import math
import subprocess
import sys
import time

import torch

PEAK_BYTES_S = 3.35e12                       # H100 SXM HBM3
PEAK_OPS_S = {torch.float32: 67e12,          # fp32, CUDA cores
              torch.bfloat16: 989e12}        # bf16 dense, tensor cores
TOL = {torch.float32: {"o": (1e-4, 1e-5), "grad": (2e-3, 3e-4)},
       torch.bfloat16: {"o": (2e-2, 2e-2), "grad": (2e-2, 2e-2)}}
LSE_TOL = (1e-4, 1e-5)
BERT_SHAPE = (16, 128, 12, 64, False)        # B, S, H, D, causal
CASES = [BERT_SHAPE,
         (2, 128, 12, 64, False), (1, 256, 4, 64, True),   # test_flash_tpu
         (2, 100, 3, 64, False), (1, 512, 8, 128, True),
         (2, 128, 2, 64, False), (2, 100, 3, 64, True),
         (1, 130, 2, 128, False),
         (2, 256, 8, 64, True), (1, 384, 4, 128, False)]
SOURCE = "paddle_tpu_torch/csrc/flash_attention.cu"
REPLACES = {"flash_fwd": "paddle_tpu/ops/flash_attention.py:217",
            "flash_bwd_dq": "paddle_tpu/ops/flash_attention.py:401",
            "flash_bwd_dkv": "paddle_tpu/ops/flash_attention.py:415"}


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


def bound(kernel, b, s, h, d, dtype):
    """Least time for the work: bytes (each input read once, each output
    written once) over the memory rate, operations over the peak rate of
    the input type; returns (ms, "bytes" | "operations")."""
    el = torch.finfo(dtype).bits // 8
    t = b * s * h * d * el                       # one [B, S, H, D] tensor
    r = b * h * s * 4                            # one [B, H, S] fp32 row
    n_bytes, mm = {"flash_fwd": (4 * t + r, 2),  # q k v -> o, lse
                   "flash_bwd_dq": (6 * t + 2 * r, 3),  # q k v o dO lse -> dq delta
                   "flash_bwd_dkv": (6 * t + 2 * r, 4)}[kernel]  # q k v dO lse delta -> dk dv
    ops = 2 * mm * b * h * s * s * d             # mm products of [S,S,D]
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


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


def phase_kernels(fa, dev):
    errs = {w.__name__: 0.0 for w in fa.WRAPPERS}
    for (b, s, h, d, causal) in CASES:
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=dev).manual_seed(b * s + h + d)
            q, k, v, g = (torch.randn(b, s, h, d, generator=gen, device=dev)
                          .to(dtype) for _ in range(4))
            scale = 1.0 / math.sqrt(d)
            tol = TOL[dtype]
            print(f"[check] B{b} S{s} H{h} D{d} causal={causal} "
                  f"{str(dtype).split('.')[-1]}")
            o, lse = fa.flash_fwd(q, k, v, causal, scale)
            o_r, lse_r = fa.blockwise_attention(q, k, v, causal=causal,
                                                scale=scale)
            torch.cuda.synchronize()
            e = err_of(o, o_r, *tol["o"], "o")
            e = max(e, err_of(lse, lse_r, *LSE_TOL, "lse"))
            errs["flash_fwd"] = max(errs["flash_fwd"], e)
            # kernels first: their outputs cannot reuse a freed buffer that
            # already holds the plain version's answer
            o_r = o_r.to(dtype)
            dq, delta = fa.flash_bwd_dq(q, k, v, o_r, g, lse_r, causal,
                                        scale)
            delta_r = torch.einsum("bqhd,bqhd->bhq", g.float(), o_r.float())
            dk, dv = fa.flash_bwd_dkv(q, k, v, g, lse_r, delta_r, causal,
                                      scale)
            dq_r, dk_r, dv_r, _ = fa.blockwise_attention_backward(
                q, k, v, o_r, lse_r, g, causal, scale)
            torch.cuda.synchronize()
            e = err_of(delta, delta_r, *tol["o"], "delta")
            e = max(e, err_of(dq, dq_r, *tol["grad"], "dq"))
            errs["flash_bwd_dq"] = max(errs["flash_bwd_dq"], e)
            e = max(err_of(dk, dk_r, *tol["grad"], "dk"),
                    err_of(dv, dv_r, *tol["grad"], "dv"))
            errs["flash_bwd_dkv"] = max(errs["flash_bwd_dkv"], e)
            # the autograd Function end to end (K1, then K2 and K3)
            qa, ka, va = (t.detach().requires_grad_() for t in (q, k, v))
            out = fa.flash_attention(qa, ka, va, causal=causal)
            out.backward(g)
            torch.cuda.synchronize()
            err_of(out, o_r, *tol["o"], "fn.o")
            for name, got, want in (("fn.dq", qa.grad, dq_r),
                                    ("fn.dk", ka.grad, dk_r),
                                    ("fn.dv", va.grad, dv_r)):
                err_of(got, want, *tol["grad"], name)
    return errs


def phase_timing(fa, dev):
    b, s, h, d, causal = BERT_SHAPE
    dtype = torch.float32            # what the O1 main path feeds them
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v, g = (torch.randn(b, s, h, d, generator=gen, device=dev)
                  for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    o, lse = fa.flash_fwd(q, k, v, causal, scale)
    _, delta = fa.flash_bwd_dq(q, k, v, o, g, lse, causal, scale)
    plain_fwd = cuda_ms(lambda: fa.blockwise_attention(
        q, k, v, causal=causal, scale=scale))
    plain_bwd = cuda_ms(lambda: fa.blockwise_attention_backward(
        q, k, v, o, lse, g, causal, scale))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_fwd = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=causal))
    qr, kr, vr = (t.detach().requires_grad_() for t in (qt, kt, vt))
    out = sdpa(qr, kr, vr, is_causal=causal)
    gt = g.transpose(1, 2)
    sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(
        out, (qr, kr, vr), gt, retain_graph=True))
    timed = {
        "flash_fwd": (cuda_ms(lambda: fa.flash_fwd(q, k, v, causal, scale)),
                      plain_fwd, sdpa_fwd),
        "flash_bwd_dq": (cuda_ms(lambda: fa.flash_bwd_dq(
            q, k, v, o, g, lse, causal, scale)), plain_bwd, None),
        "flash_bwd_dkv": (cuda_ms(lambda: fa.flash_bwd_dkv(
            q, k, v, g, lse, delta, causal, scale)), plain_bwd, None),
    }
    rows = {}
    for name, (ms, plain_ms, lib_ms) in timed.items():
        bound_ms, bound_by = bound(name, b, s, h, d, dtype)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=lib_ms)
        print(f"[time] {name:<14} {ms:.4f} ms  bound {bound_ms:.4f} ms "
              f"({bound_by})  plain {plain_ms:.4f} ms  library "
              f"{'null' if lib_ms is None else f'{lib_ms:.4f} ms'}")
    print(f"[time] yardstick: SDPA backward (dq, dk, dv in one call) "
          f"{sdpa_bwd:.4f} ms; the plain backward above computes all three")
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
    rows = phase_timing(fa, dev)
    phase_tiny(tpt, dev)
    launches = phase_bert(tpt, fa, dev)
    record = {"kernels": [dict(name=name, route="cuda", source=SOURCE,
                               replaces=REPLACES[name],
                               launches=launches[name],
                               max_abs_err=errs[name], **rows[name])
                          for name in REPLACES]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
