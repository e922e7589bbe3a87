#!/usr/bin/env python3
"""How far a resnet18 training step of paddle_tpu_torch on one CUDA card
lies from the same step on the CPU, and from float64.

    python3 scripts/resnet_card_vs_cpu.py [--batch 4]

Runs chip_smoke.py's ``resnet_tiny`` setup (resnet18, 64 px, 10 classes,
2 O0 Momentum(1e-2) steps from one seed's weights and images; batch 4
unless ``--batch``) in both layouts:
on the CPU in fp32 and in float64, and on the card in fp32 with TF32 off
under four cuDNN settings: its default algorithm choice, deterministic
algorithms only, convolutions told IEEE fp32 by name
(``torch.backends.cudnn.conv.fp32_precision = "ieee"``, where torch has
it; ``allow_tf32 = False`` leaves it "none"), and cuDNN off (torch's own
CUDA convolutions). For each
run and step it prints the loss's relative error and the parameters'
update errors (``chip_smoke.update_error``: median and worst over the
parameters) against the CPU fp32 run and against float64. Fails when
there is no card.
"""
import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def run(tpt, dev, layout, start, batch, dtype):
    """(losses, states after each step) of 2 O0 steps."""
    from chip_smoke import RESNET_TINY, resnet_step_fn
    from paddle_tpu_torch.convert import load_state_dict
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet18
    tpt.set_device(dev)
    model = load_state_dict(resnet18(num_classes=RESNET_TINY["classes"],
                                     data_format=layout), start).to(dtype)
    step = TrainStep(model, resnet_step_fn, Momentum(
        learning_rate=RESNET_TINY["lr"], momentum=0.9,
        parameters=model.parameters()))
    x, y = (t.to(dev) for t in batch)
    out = []
    for _ in range(2):
        loss = float(step(x.to(dtype), y))
        out.append((loss, {k: v.detach().double().cpu().clone()
                           for k, v in model.state_dict().items()}))
    return out


def compare(name, got, want, start):
    from chip_smoke import update_error
    for i, ((gl, gs), (wl, ws)) in enumerate(zip(got, want)):
        errs = sorted(update_error(gs[n], ws[n], start[n].double())
                      for n in ws if not n.endswith(("._mean",
                                                     "._variance")))
        buf = max((gs[n] - ws[n]).abs().max().item() for n in ws
                  if n.endswith(("._mean", "._variance")))
        print(f"  {name:<34} step {i + 1}: loss rel err "
              f"{abs(gl - wl) / abs(wl):.3e}  update error median "
              f"{errs[len(errs) // 2]:.3e} worst {errs[-1]:.3e}  BN stats "
              f"max_abs {buf:.3e}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("resnet_card_vs_cpu: no CUDA device", file=sys.stderr)
        return 2
    import paddle_tpu_torch as tpt
    from chip_smoke import RESNET_TINY, card_line, image_batch
    from paddle_tpu_torch.vision.models import resnet18
    print(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cudnn = torch.backends.cudnn
    print(f"[card_vs_cpu] cudnn {cudnn.version()}; fp32_precision: "
          f"backends {getattr(torch.backends, 'fp32_precision', 'n/a')}, "
          f"cudnn {getattr(cudnn, 'fp32_precision', 'n/a')}, conv "
          f"{getattr(getattr(cudnn, 'conv', None), 'fp32_precision', 'n/a')}")
    settings = {"cuDNN default": dict(enabled=True, deterministic=False),
                "cuDNN deterministic": dict(enabled=True,
                                            deterministic=True),
                "cuDNN, conv IEEE": dict(enabled=True, deterministic=False,
                                         ieee=True),
                "cuDNN off": dict(enabled=False, deterministic=False)}
    for layout in ("NHWC", "NCHW"):
        tpt.set_device("cpu")
        tpt.seed(2)
        start = {k: v.detach().clone() for k, v in resnet18(
            num_classes=RESNET_TINY["classes"],
            data_format=layout).state_dict().items()}
        batch = image_batch(torch.Generator().manual_seed(4), "cpu",
                            args.batch, RESNET_TINY["px"], layout,
                            RESNET_TINY["classes"])
        cpu32 = run(tpt, "cpu", layout, start, batch, torch.float32)
        cpu64 = run(tpt, "cpu", layout, start, batch, torch.float64)
        print(f"[card_vs_cpu] {layout} batch {args.batch}")
        compare("CPU fp32 vs float64", cpu32, cpu64, start)
        for name, flags in settings.items():
            cudnn.enabled = flags["enabled"]
            cudnn.deterministic = flags["deterministic"]
            conv = getattr(cudnn, "conv", None)
            if flags.get("ieee") and conv is None:
                continue
            before = conv.fp32_precision if conv is not None else None
            if flags.get("ieee"):
                conv.fp32_precision = "ieee"
            card = run(tpt, "cuda", layout, start, batch, torch.float32)
            if conv is not None:
                conv.fp32_precision = before
            compare(f"card ({name}) vs CPU fp32", card, cpu32, start)
            compare(f"card ({name}) vs float64", card, cpu64, start)
    return 0


if __name__ == "__main__":
    sys.exit(main())
