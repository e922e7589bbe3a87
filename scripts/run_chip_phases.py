#!/usr/bin/env python3
"""Phases of ``chip_smoke.py`` from one checkout, on one card.

    python3 scripts/run_chip_phases.py ROOT PHASE [PHASE ...]

ROOT is a checkout of the repository (``.`` for this one, or an earlier
commit unpacked with ``git archive <commit> | tar -x -C build/parent``);
its ``chip_smoke.py`` and ``paddle_tpu_torch`` are imported, its kernels
built into its own ``build/``. PHASE is one of ``bert`` (phase bert, then
one O1 step under the profiler: launches, host syncs, device busy),
``bert_o2``, ``eager_bert``, ``tensor_api``, ``nn_api``, ``nn_layers``,
``cyclegan``, ``cf_api``, ``control_flow``, ``ptb_lm``, ``seq_ops``,
``rnnlm_eager``, ``sentiment_lstm``, ``decode_ops``, ``crnn``,
``rcnn_ops``, ``faster_rcnn``, ``static_builders``, ``static_ernie``
(then K1-K3 at its shape, ``phase_ernie_kernels``), ``dy2static_nmt``
(then K1-K3 at its shape, ``phase_nmt_kernels``), ``static_decoders``,
``proto_model`` (after ``phase_predictor``, which saves the artifacts it
reads, under ``build/serving``), ``resnet_loader``, ``ctr_dataset`` and
``fp16`` (phase timing at fp16). To
compare two commits on one card, run them in turns in one call, one
process each, e.g. parent, change, change, parent.
"""
import os
import shutil
import sys
import time

root = sys.argv[1]
sys.path.insert(0, root)
import torch  # noqa: E402
import chip_smoke as cs  # noqa: E402
import paddle_tpu_torch as tpt  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as fa, kernels  # noqa: E402

assert os.path.realpath(tpt.__file__).startswith(
    os.path.realpath(root) + "/"), tpt.__file__


def profile_o1(dev):
    """One O1 TrainStep of BERT-base (phase bert's model, optimizer and
    batches) under the profiler, after three steps."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.text.models import BertForPretraining
    tpt.set_device(dev)
    tpt.seed(0)
    model = BertForPretraining(dropout=0.0)
    train = TrainStep(model, cs.step_fn, Momentum(
        learning_rate=1e-4, momentum=0.9, parameters=model.parameters()),
        amp_level="O1").ensure_state()
    gen = torch.Generator(device=dev).manual_seed(0)
    batches = [cs.make_batch(gen, dev, 16, 128, 30522) for _ in range(2)]
    for i in range(3):
        train(*batches[i % 2])
    prof = cs.profile_call(lambda: train(*batches[0]))
    print(f"[bert] one profiled O1 step: {prof['launches']} kernel launches, "
          f"{prof['syncs']} host syncs, device busy {prof['busy_ms']:.3f} ms "
          f"of {prof['wall_ms']:.3f} ms", flush=True)


def main():
    if not torch.cuda.is_available():
        print("run_chip_phases: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"=== {root}: {tpt.__file__}; {cs.card_line()}", flush=True)
    cs.phase_build(kernels)
    for ph in sys.argv[2:]:
        t0 = time.perf_counter()
        if ph == "bert":
            cs.phase_bert(tpt, fa, dev)
            profile_o1(dev)
        elif ph == "bert_o2":
            cs.phase_bert_o2(tpt, fa, dev)
        elif ph == "eager_bert":
            cs.phase_eager_bert(tpt, fa, dev)
        elif ph == "tensor_api":
            cs.phase_tensor_api(dev)
        elif ph == "nn_api":
            cs.phase_nn_api(dev)
        elif ph == "nn_layers":
            cs.phase_nn_layers(tpt, dev)
        elif ph == "cyclegan":
            cs.phase_cyclegan(tpt, dev)
        elif ph == "cf_api":
            cs.phase_cf_api(dev)
        elif ph == "control_flow":
            cs.phase_control_flow(tpt, dev)
        elif ph == "ptb_lm":
            cs.phase_ptb_lm(tpt, dev)
        elif ph == "seq_ops":
            cs.phase_seq_ops(dev)
        elif ph == "rnnlm_eager":
            cs.phase_rnnlm_eager(tpt, dev)
        elif ph == "sentiment_lstm":
            cs.phase_sentiment_lstm(tpt, dev)
        elif ph == "decode_ops":
            cs.phase_decode_ops(dev)
        elif ph == "crnn":
            cs.phase_crnn(tpt, dev)
        elif ph == "rcnn_ops":
            cs.phase_rcnn_ops(dev)
        elif ph == "faster_rcnn":
            cs.phase_faster_rcnn(tpt, dev)
        elif ph == "static_builders":
            cs.phase_static_builders(tpt, dev)
        elif ph == "static_ernie":
            _, dtype = cs.phase_static_ernie(tpt, fa, dev)
            cs.phase_ernie_kernels(fa, dev, getattr(torch, dtype))
        elif ph == "dy2static_nmt":
            cs.phase_dy2static_nmt(tpt, fa, dev)
            cs.phase_nmt_kernels(fa, dev)
        elif ph == "static_decoders":
            cs.phase_static_decoders(tpt, dev)
        elif ph == "proto_model":
            workdir = "build/serving"
            shutil.rmtree(workdir, ignore_errors=True)
            paths = cs.phase_predictor(tpt, fa, dev, workdir)
            cs.phase_proto_model(tpt, fa, dev, paths, workdir)
        elif ph == "resnet_loader":
            cs.phase_resnet_loader(tpt, dev)
        elif ph == "ctr_dataset":
            cs.phase_ctr_dataset(tpt, dev)
        elif ph == "fp16":
            cs.phase_timing(fa, dev, torch.float16)
        else:
            raise SystemExit(f"unknown phase {ph!r}")
        print(f"=== {root} {ph} {time.perf_counter() - t0:.1f} s", flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
