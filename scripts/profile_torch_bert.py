#!/usr/bin/env python3
"""Where a BERT-base O1 train step of paddle_tpu_torch spends its time on
one CUDA card.

    python3 scripts/profile_torch_bert.py [--steps 3]

Builds the main path as chip_smoke.py does (BertForPretraining, Momentum
1e-4 / 0.9, TrainStep amp_level="O1", batch 16, seq 128), warms up two
steps, then traces ``--steps`` steps with torch.profiler (CPU and CUDA
activities). Prints the step's wall time, the device's busy time (union
of kernel and copy intervals) and idle share, device time by kernel
family, the top kernels, and each of the port's flash kernels (ms a step,
launches a step, us a launch). Fails when there is no card or the trace
holds no device event.
"""
import argparse
import collections
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

FAMILIES = [                      # (family, substrings of the kernel name)
    ("flash K1-K3 (port)", ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                            "flash_bwd_dkv_kernel")),
    ("matmul (cuBLAS)", ("gemm", "Kernel2", "cutlass", "sm90_xmma",
                         "nvjet")),
    ("softmax / log_softmax", ("softmax",)),
    ("layer norm", ("layer_norm", "LayerNorm")),
    ("embedding / gather", ("embedding", "gather", "index", "scatter")),
    ("reduce", ("reduce",)),
    ("copy / cast / fill", ("copy", "Memcpy", "Memset", "fill", "cast")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
]


def _family(name):
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_bert: no CUDA device", file=sys.stderr)
        return 2
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.text.models import BertForPretraining
    from chip_smoke import card_line, make_batch, step_fn
    print(card_line())
    dev = torch.device("cuda")
    tpt.set_device(dev)
    tpt.seed(0)
    model = BertForPretraining(dropout=0.0)
    train = TrainStep(model, step_fn, Momentum(
        learning_rate=1e-4, momentum=0.9, parameters=model.parameters()),
        amp_level="O1").ensure_state()
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = make_batch(gen, dev, 16, 128, 30522)
    for _ in range(2):
        train(*batch)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            train(*batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        print("profile_torch_bert: the trace holds no device event",
              file=sys.stderr)
        return 1
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in dev_events)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    n = args.steps
    by_family = collections.Counter()
    by_name = collections.Counter()
    counts = collections.Counter()
    for e in dev_events:
        dur = e.time_range.end - e.time_range.start
        by_family[_family(e.name)] += dur
        by_name[e.name] += dur
        counts[e.name] += 1
    total = sum(by_family.values())
    print(f"[profile] steps {n}  wall {wall_us / n / 1e3:.3f} ms/step  "
          f"device busy {busy / n / 1e3:.3f} ms/step  idle share "
          f"{1 - busy / wall_us:.3f}  device events "
          f"{len(dev_events) / n:.0f}/step")
    for fam, us in by_family.most_common():
        print(f"[profile] {fam:<24} {us / n / 1e3:8.3f} ms/step  "
              f"{us / total:6.1%} of device time")
    for name, us in by_name.most_common(12):
        print(f"[profile]   {us / n / 1e3:8.3f} ms/step  x{counts[name] // n:<4}"
              f" {name[:110]}")
    for name, us in sorted(by_name.items()):
        if _family(name) == FAMILIES[0][0]:
            print(f"[profile] port kernel {us / n / 1e3:.3f} ms/step  "
                  f"x{counts[name] // n}  {us / counts[name]:.1f} us a launch"
                  f"  {name.split('::')[-1].split('(')[0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
