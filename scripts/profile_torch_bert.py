#!/usr/bin/env python3
"""Where a train step of paddle_tpu_torch spends its time on one CUDA
card: BERT-base O1 or O2, GPT-3 1.3B O2, ResNet-50 O1 or the eager
CycleGAN step; or a YOLOv3-416 predict.

    python3 scripts/profile_torch_bert.py [--steps 3] [--amp O2]
    python3 scripts/profile_torch_bert.py --model gpt [--steps 3]
    python3 scripts/profile_torch_bert.py --model resnet50 --layout NHWC
    python3 scripts/profile_torch_bert.py --model cyclegan [--steps 3]
    python3 scripts/profile_torch_bert.py --model yolov3 [--steps 5]

Builds the step as chip_smoke.py does. BERT: BertForPretraining,
Momentum 1e-4 / 0.9, TrainStep amp_level="O1", batch 16, seq 128; with
``--amp O2`` as phase ``bert_o2``: amp.decorate (bf16 parameters, fp32
masters), AdamW with LinearWarmup(PolynomialDecay), ClipGradByGlobalNorm
(1.0) and weight decay 0.01, and the update (clip, decay, the adamw op,
the masters' cast) also reported on its own (device ms and launches a
step).
GPT: as phase ``gpt_o2``: gpt3_1p3b() from seed 0, amp.decorate O2 (bf16
parameters, fp32 masters), AdamW (beta 0.9 / 0.95, weight decay 0.1)
with GPT-3's warm-up and cosine schedule, ClipGradByGlobalNorm(1.0),
micro-batch 4 at seq 2048; the update reported on its own as for BERT.
ResNet-50: resnet50(num_classes=1000, data_format=--layout),
cross_entropy, Momentum 0.1 / 0.9, O1, batch 256, 224 px, cudnn.benchmark
on. CycleGAN: phase ``cyclegan``'s networks, images and step
(``chip_smoke.cyclegan_step``, 256 px, batch 1, fp32 with TF32 off as the
phase runs it, or on with ``--tf32``, cudnn.benchmark on), both Adam
updates reported on their own. Warms up two steps, then traces ``--steps`` steps with torch.profiler
(CPU and CUDA activities). Prints the step's wall time, the device's busy
time (union of kernel and copy intervals) and idle share, device time by
kernel family and the top kernels; for BERT each of the port's flash
kernels (ms a step, launches a step, us a launch); for ResNet the device
time of layout transforms: cuDNN's nchwToNhwc / nhwcToNchw kernels and
torch's copy kernels that are not dtype casts, split by whether the op
that launched them had an activation-sized input (more elements than the
largest parameter) or only weight-sized ones. A kernel that a convolution
op launched counts as conv whatever its name. Fails when there is no card
or the trace holds no device event.
"""
import argparse
import collections
import math
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

FAMILIES = [                      # (family, substrings of the kernel name)
    ("flash K1-K3 (port)", ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                            "flash_bwd_dkv_kernel")),
    ("layout transform (cuDNN)", ("nchwToNhwc", "nhwcToNchw")),
    ("batch norm", ("batch_norm", "bn_fw", "bn_bw", "BatchNorm")),
    ("reflection pad", ("reflection_pad",)),
    ("mean / variance (Welford)", ("Welford",)),
    ("pool", ("pool", "Pool")),
    ("conv (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "Conv")),
    ("matmul (cuBLAS)", ("gemm", "Kernel2", "cutlass", "sm90_xmma",
                         "nvjet")),
    ("softmax / log_softmax", ("softmax",)),
    ("layer norm", ("layer_norm", "LayerNorm")),
    ("embedding / gather", ("embedding", "gather", "index", "scatter")),
    ("reduce", ("reduce",)),
    ("copy / cast / fill", ("copy", "Memcpy", "Memset", "fill", "cast")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
]
TRANSFORM_KEYS = ("nchwToNhwc", "nhwcToNchw")
CAST_OPS = ("aten::_to_copy", "aten::to")


def _family(name, ops=()):
    """A kernel's family by its name; a kernel that a convolution op
    launched (cuDNN also runs 1x1 convolutions as GEMMs) counts as conv,
    unless it is a layout transform."""
    for fam, keys in FAMILIES[:2]:
        if any(k in name for k in keys):
            return fam
    if any("convolution" in op for op in ops):
        return "conv (cuDNN)"
    for fam, keys in FAMILIES[2:]:
        if any(k in name for k in keys):
            return fam
    return "other"


UPDATE = "optimizer update"


def build_bert(dev, amp_level):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.optimizer.lr import LinearWarmup, PolynomialDecay
    from paddle_tpu_torch.text.models import BertForPretraining
    from chip_smoke import _o2_opt, make_batch, step_fn
    model = BertForPretraining(dropout=0.0)
    if amp_level == "O2":
        opt = _o2_opt(model, LinearWarmup(PolynomialDecay(1e-4, 1000, 0.0),
                                          10, 0.0, 1e-4))
        model, opt = amp.decorate(model, opt, level="O2")
    else:
        opt = Momentum(learning_rate=1e-4, momentum=0.9,
                       parameters=model.parameters())
    opt.functional_step = _ranged(UPDATE, opt.functional_step)
    train = TrainStep(model, step_fn, opt,
                      amp_level=amp_level).ensure_state()
    gen = torch.Generator(device=dev).manual_seed(0)
    return model, train, make_batch(gen, dev, 16, 128, 30522)


def build_gpt(dev):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import lr
    from paddle_tpu_torch.text import gpt3_1p3b
    from chip_smoke import GPT3, gpt3_schedule, gpt_opt, gpt_step_fn
    model = gpt3_1p3b(vocab_size=GPT3["vocab"])
    model, opt = amp.decorate(model, gpt_opt(model, gpt3_schedule(lr)),
                              level="O2")
    opt.functional_step = _ranged(UPDATE, opt.functional_step)
    train = TrainStep(model, gpt_step_fn, opt,
                      amp_level="O2").ensure_state()
    gen = torch.Generator(device=dev).manual_seed(1)
    ids = torch.randint(0, GPT3["vocab"], (GPT3["batch"], GPT3["seq"]),
                        generator=gen, device=dev, dtype=torch.int32)
    return model, train, (ids,)


def build_resnet(dev, layout):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50
    from chip_smoke import RESNET, image_batch, resnet_step_fn
    torch.backends.cudnn.benchmark = True
    model = resnet50(num_classes=RESNET["classes"], data_format=layout)
    train = TrainStep(model, resnet_step_fn, Momentum(
        learning_rate=0.1, momentum=0.9, parameters=model.parameters()),
        amp_level="O1").ensure_state()
    gen = torch.Generator(device=dev).manual_seed(0)
    return model, train, image_batch(gen, dev, RESNET["batch"],
                                     RESNET["px"], layout, RESNET["classes"])


def transforms(prof, act_numel, n):
    """Device us a step of layout transforms, by (kind, "activation" |
    "weight"): cuDNN's nchwToNhwc / nhwcToNchw kernels, and torch's copy
    kernels, apart from those a dtype cast launched."""
    out = collections.Counter()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        size = max((math.prod(s) for s in (e.input_shapes or []) if s),
                   default=0)
        where = "activation" if size > act_numel else "weight"
        cast = False
        parent = e
        while parent is not None:
            cast = cast or parent.name in CAST_OPS
            parent = parent.cpu_parent
        for k in e.kernels:
            if any(key in k.name for key in TRANSFORM_KEYS):
                out["cuDNN nchwToNhwc / nhwcToNchw", where] += k.duration
            elif "copy" in k.name and not cast:
                out["copy kernel, no dtype cast", where] += k.duration
            elif "copy" in k.name:
                out["copy kernel, dtype cast", where] += k.duration
    return {key: us / n for key, us in out.items()}


YOLO_FAMILIES = {"conv2d": "conv (cuDNN)", "batch_norm": "batch norm",
                 "leaky_relu": "leaky ReLU / residual and bias adds",
                 "elementwise_add": "leaky ReLU / residual and bias adds",
                 "interpolate": "upsample + concat",
                 "concat": "upsample + concat"}


def _ranged(name, fn):
    def run(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return run


def yolo_family(event):
    """The YOLOv3 family of a CPU event's kernels, from the ranges around
    it: a stage ("stage:network" / "stage:decode", else NMS) and an op."""
    from chip_smoke import kernel_op
    op, stage = kernel_op(event), "nms"
    while event is not None:
        if event.name.startswith("stage:"):
            stage = event.name[6:]
            break
        event = event.cpu_parent
    if stage == "network":
        return YOLO_FAMILIES.get(op, "network, other")
    return {"decode": "decode (yolo_box, concat)"}.get(
        stage, "NMS (transpose2, multiclass_nms)")


def profile_yolov3(dev, steps):
    from chip_smoke import (YOLO_416, calibrated_state, device_busy_us,
                            op_ranges)
    from paddle_tpu_torch.convert import load_state_dict
    from paddle_tpu_torch.dygraph import no_grad
    from paddle_tpu_torch.vision import yolov3
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.allow_tf32 = False
    px = YOLO_416["px"]
    model = yolov3(num_classes=YOLO_416["classes"]).eval()
    gen = torch.Generator(device=dev).manual_seed(0)
    img = torch.rand((1, 3, px, px), generator=gen, device=dev)
    calib = torch.rand((YOLO_416["calib"], 3, px, px), generator=gen,
                       device=dev)
    size = torch.full((1, 2), px, dtype=torch.int32, device=dev)
    bench = {k: v.detach().cpu().numpy().copy()
             for k, v in model.state_dict().items()}
    states = {"bench": bench, "calibrated": calibrated_state(model, calib)}
    model.forward = _ranged("stage:network", model.forward)
    model.decode = _ranged("stage:decode", model.decode)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for name, state in states.items():
        load_state_dict(model, state)
        with no_grad():
            for _ in range(2):
                model.predict(img, size)
            torch.cuda.synchronize()
            with op_ranges(), torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                for _ in range(steps):
                    model.predict(img, size)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.events()
        cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
        dev_events = [e for e in events if e.device_type == cuda and
                      not e.name.startswith(("op:", "stage:"))]
        if not dev_events:
            print("profile_torch_bert: the trace holds no device event",
                  file=sys.stderr)
            return 1
        busy = device_busy_us(dev_events)
        runtime = collections.Counter(e.name for e in events
                                      if e.device_type == cpu and
                                      e.name.startswith("cu"))
        by_family, by_name = collections.Counter(), collections.Counter()
        for e in events:
            if e.device_type == cpu:
                for k in e.kernels:
                    by_family[yolo_family(e)] += k.duration
                    by_name[k.name] += k.duration
        total = sum(e.time_range.end - e.time_range.start for e in dev_events)
        n = steps
        print(f"[profile] yolov3 {name}: {n} predicts  wall "
              f"{wall_us / n / 1e3:.3f} ms/predict  device busy "
              f"{busy / n / 1e3:.3f} ms/predict  idle share "
              f"{1 - busy / wall_us:.3f}  device events "
              f"{len(dev_events) / n:.0f}/predict  kernel launches "
              f"{sum(c for k, c in runtime.items() if 'LaunchKernel' in k) / n:.0f}"
              f"/predict  host syncs "
              f"{runtime.get('cudaStreamSynchronize', 0) / n:.1f}/predict")
        for fam, us in by_family.most_common():
            print(f"[profile]   {fam:<38} {us / n / 1e3:8.3f} ms/predict  "
                  f"{us / total:6.1%} of device time")
        print(f"[profile]   {'(not linked to an op)':<38} "
              f"{(total - sum(by_family.values())) / n / 1e3:8.3f} ms/predict")
        for kname, us in by_name.most_common(12):
            print(f"[profile]     {us / n / 1e3:8.3f} ms/predict  {kname[:100]}")
        print(f"[profile]   CUDA runtime calls a predict: " + ", ".join(
            f"{k} {c / n:g}" for k, c in runtime.most_common(10)))
    return 0


def build_cyclegan(dev, tf32):
    import numpy as np
    from paddle_tpu_torch import nn
    from chip_smoke import (CYCLEGAN, cyclegan_images, cyclegan_nets,
                            cyclegan_opts, cyclegan_step, port_cyclegan_api)
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    cfg, api = CYCLEGAN, port_cyclegan_api()
    nets = cyclegan_nets(nn, cfg["ngf"], cfg["ndf"], cfg["blocks"])
    opts = cyclegan_opts(api, nets, cfg["lr"], cfg["beta1"], cfg["beta2"])
    for opt in opts:
        opt.step = _ranged(UPDATE, opt.step)
    a, b = (torch.from_numpy(x).to(dev) for x in cyclegan_images(
        np.random.RandomState(0), cfg["batch"], cfg["px"]))
    return None, (lambda x, y: cyclegan_step(api, nets, opts, x, y,
                                             cfg["lam"])), (a, b)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--model", choices=("bert", "gpt", "resnet50",
                                        "cyclegan", "yolov3"),
                    default="bert")
    ap.add_argument("--layout", choices=("NHWC", "NCHW"), default="NHWC")
    ap.add_argument("--amp", choices=("O1", "O2"), default="O1",
                    help="BERT's AMP level")
    ap.add_argument("--tf32", action="store_true",
                    help="CycleGAN's convolutions on TF32 (default off)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_bert: no CUDA device", file=sys.stderr)
        return 2
    import paddle_tpu_torch as tpt
    from chip_smoke import card_line, device_busy_us
    print(card_line())
    dev = torch.device("cuda")
    tpt.set_device(dev)
    tpt.seed(0)
    if args.model == "yolov3":
        return profile_yolov3(dev, args.steps)
    resnet = args.model == "resnet50"
    if resnet:
        model, train, batch = build_resnet(dev, args.layout)
        print(f"[profile] resnet50 {args.layout}, cudnn.benchmark on")
    elif args.model == "gpt":
        model, train, batch = build_gpt(dev)
        print("[profile] gpt O2 (GPT-3 1.3B, batch 4, seq 2048)")
    elif args.model == "cyclegan":
        model, train, batch = build_cyclegan(dev, args.tf32)
        print(f"[profile] cyclegan (256 px, batch 1, fp32, TF32 "
              f"{'on' if args.tf32 else 'off'}, cudnn.benchmark on)")
    else:
        model, train, batch = build_bert(dev, args.amp)
        print(f"[profile] bert {args.amp}")
    for _ in range(2):
        train(*batch)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts,
                                record_shapes=resnet) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            train(*batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # the update's record_function range also shows up on the device
    # timeline, spanning its kernels and the gaps between them
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA and
                  e.name != UPDATE]
    if not dev_events:
        print("profile_torch_bert: the trace holds no device event",
              file=sys.stderr)
        return 1
    busy = device_busy_us(dev_events)
    n = args.steps
    launched_by = collections.defaultdict(set)   # kernel -> its ops
    for e in prof.events():
        for k in (e.kernels if e.device_type ==
                  torch.autograd.DeviceType.CPU else ()):
            launched_by[k.name].add(e.name)
    by_family = collections.Counter()
    by_name = collections.Counter()
    counts = collections.Counter()
    for e in dev_events:
        dur = e.time_range.end - e.time_range.start
        by_family[_family(e.name, launched_by[e.name])] += dur
        by_name[e.name] += dur
        counts[e.name] += 1
    total = sum(by_family.values())
    update_us, update_n = 0.0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.kernels:
            parent = e
            while parent is not None and parent.name != UPDATE:
                parent = parent.cpu_parent
            if parent is not None:
                update_us += sum(k.duration for k in e.kernels)
                update_n += len(e.kernels)
    if not resnet:
        print(f"[profile] {UPDATE} (clip, decay, op, masters; both Adams "
              f"for cyclegan): "
              f"{update_us / n / 1e3:.3f} ms/step of device time in "
              f"{update_n / n:.0f} kernels/step")
    print(f"[profile] steps {n}  wall {wall_us / n / 1e3:.3f} ms/step  "
          f"device busy {busy / n / 1e3:.3f} ms/step  idle share "
          f"{1 - busy / wall_us:.3f}  device events "
          f"{len(dev_events) / n:.0f}/step")
    for fam, us in by_family.most_common():
        print(f"[profile] {fam:<26} {us / n / 1e3:8.3f} ms/step  "
              f"{us / total:6.1%} of device time")
    for name, us in by_name.most_common(15):
        print(f"[profile]   {us / n / 1e3:8.3f} ms/step  x{counts[name] // n:<4}"
              f" {name[:110]}")
    for name, us in sorted(by_name.items()):
        if _family(name) == FAMILIES[0][0]:
            print(f"[profile] port kernel {us / n / 1e3:.3f} ms/step  "
                  f"x{counts[name] // n}  {us / counts[name]:.1f} us a launch"
                  f"  {name[:name.index('>(') + 1].split('::')[-1]}")
    if resnet:
        act_numel = max(p.numel() for p in model.parameters())
        found = transforms(prof, act_numel, n)
        print(f"[profile] layout transforms (activation-sized: an input of "
              f"more than {act_numel} elements, the largest parameter):")
        for kind in ("cuDNN nchwToNhwc / nhwcToNchw",
                     "copy kernel, no dtype cast", "copy kernel, dtype cast"):
            act, wgt = (found.get((kind, w), 0.0) / 1e3
                        for w in ("activation", "weight"))
            print(f"[profile]   {kind:<32} activation-sized {act:.3f} "
                  f"ms/step  weight-sized {wgt:.3f} ms/step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
