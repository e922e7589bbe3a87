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
     and falling at each of the first four steps, the parameters and BN
     statistics moved.
  22. static_builders: every case of
     paddle_tpu_torch/testing/static_cases.py (the static.nn builders of
     the static training slice and the five nets composites) through
     the static executor on the card against the CPU from the same
     startup values and feed, each within its tolerance;
  23. static_ernie, the main path of the static training slice: ERNIE
     1.0 base pretraining as its fluid script writes it
     (static_cases.ernie_program: 12 layers, hidden 768, 12 heads, FFN
     3072 relu, vocab 18,000, dropout 0.1, TruncatedNormal(0.02), the
     tied masked-LM head and the next-sentence head), Adam 1e-4 under
     static_amp.decorate (bf16, dynamic loss scaling), batch 16 at seq
     512, through CompiledProgram(main).with_data_parallel(loss_name=
     ...): the rewrite's casts, the first loss against the CPU (batch 2,
     seq 128, dropout 0, the same weights), K1-K3 launched 12 times a
     step each on the dtype the CPU run gives them, the masked-LM loss
     falling at each of the first four steps on one batch (the summed
     loss at the fourth under the first), the loss scale finite; step
     time, samples/s, tokens/s, peak memory, launches, host syncs and
     device busy of a profiled step, host ms inside the executor's ops;
     then K1-K3 at its shape (B16 S512 H12 D64) against their plain
     versions and timed as in phase 3;
  24. predictor: the classic fluid ResNet-50 (static_resnet, batch -1,
     224 px, 1000 classes, fp32 NCHW, the logits fetched) and the attn
     program (BERT-base's self-attention sublayer, attn_program: x [B, 128,
     768], Wq/Wk/Wv, flash_attention, Wo, residual, layer_norm, in bf16)
     saved by save_inference_model and run through inference.Predictor on
     the card: run(list) and the zero-copy handles bit for bit against
     Executor.run of the loaded program, and against a CPU Predictor
     (K1 once an attn run);
  25. serve, the main path of the serving slice: both artifacts as
     tenants of one PredictorServer (resnet50 buckets 1/8/32, attn 4/16),
     frozen; closed-loop client threads send seeded requests of 1-8 rows
     (resnet50) and 1-4 (attn); every answer against a direct Predictor
     run of the request padded to the bucket that served it; 0 steady
     compiles; K1 launched once an attn batch, from the attn worker on the
     caller's stream, K2 and K3 not at all; latency p50/p99, requests and
     rows a second, batch occupancy, pipeline depth, launches and host
     syncs a batch, peak memory and the card line;
  26. serve_restart: a second server on the same cache directory
     warm-loads every bucket, compiles nothing and answers a repeated
     request with the same bits.
  27. eager_bert, the main path of the eager slice: BERT-base (fp32, O0,
     batch 16, seq 128) trained through the eager tape as a user script
     writes it (eager_step: to_tensor, loss.backward(); opt.step();
     opt.clear_grad(), then opt.minimize(loss); model.clear_gradients()
     under dygraph.guard()), 2 warm-up and 5 timed steps, a step that
     also takes paddle.grad of the word embeddings, and a profiled step:
     step time, samples/s, peak memory, launches and host syncs; K1 12
     launches a step and K2 and K3 12 more in the paddle.grad step, the
     plain versions never; the losses against jit.TrainStep(amp_level=
     "O0") on the same batches from the same weights, paddle.grad against
     the gradient backward() leaves, loss.numpy() and param.numpy() on
     the card, and save_dygraph / load_dygraph into a fresh model giving
     the same next loss bit for bit;
  28. tensor_api: the 153 op types the 2.0 tensor API brought, each at
     the CPU tests' shapes (paddle_tpu_torch/testing/op_cases.py) on the
     card against the port on the CPU, forward and gradient, with the
     host syncs of the ops whose output length depends on the data.
  29. nn_api: the 63 op types the rest of paddle.nn brought (nn_ops,
     loss_ops, vision_ops, four of long_tail_ops), every case of
     paddle_tpu_torch/testing/nn_cases.py on the card against the port on
     the CPU, forward and gradient, index outputs equal (also on tied
     maxima), and the host syncs of one call of each type;
  30. nn_layers: one forward and backward of each nn class and
     nn.functional function of that slice (nn_cases' LAYER_CASES and
     FUNC_CASES) on the card against the CPU from the same weights;
  31. cyclegan, the main path of that slice: CycleGAN at the paper's
     widths (two 9-block ResNet generators, two 70x70 PatchGANs, 256 px,
     batch 1, fp32, TF32 off, cudnn.benchmark on, two Adams) trained by
     the eager user script cyclegan_step: the first step's losses and
     update on the card against the CPU, the same step twice on the
     card (equal bits or not), 2 warm-up and 5 timed steps: step_ms,
     images/s, peak memory, conv TFLOP/s, and the launches, host syncs,
     device busy and idle and conv device time of a profiled step.
  32. cf_api: the 97 op types of the control-flow slice
     (control_flow_ops, array_ops, parity_ops, misc_ops, special_ops),
     every case of paddle_tpu_torch/testing/cf_cases.py on the card
     against the port on the CPU, forward and gradient, the control-flow
     ops on their published Program, the error cases raising; the host
     syncs of one call of the cases that read a predicate, an index or
     data on the host;
  33. control_flow: tests/test_control_flow.py's programs (CF_PROGRAMS)
     on the card against the CPU from the same parameters, with the
     host syncs of each run;
  34. ptb_lm, the main path of that slice: the PTB-large LSTM language
     model (66,022,000 parameters, fp32, TF32 off) as a fluid script:
     StaticRNN over 35 steps of 2 layers, SGD(1.0) through
     append_backward and Executor; the first step card against CPU, the
     static.nn.lstm (cudnn_lstm) route against the StaticRNN route,
     2 warm-up and 5 timed steps of each at dropout 0.65 (step_ms,
     tokens/s, peak memory; launches, host syncs, busy and idle of a
     profiled step) and 35 greedy tokens through While and tensor
     arrays, equal on the card and the CPU, with ms and host syncs a
     token.
  35. seq_ops: the 19 op types of the sequence slice (sequence_ops,
     rnn_ops), every case of paddle_tpu_torch/testing/seq_cases.py on the
     card against the CPU, the executor's LoD-feed padding, host syncs;
  36. rnnlm_eager: PTB-large through eager paddle.nn.LSTM (cuDNN), card
     against CPU, against the static routes, and timed;
  37. sentiment_lstm: the book's stacked-LSTM sentiment net on ragged
     LoD feeds through the fluid lstm, card against CPU, and timed;
  38. decode_ops: the 27 op types of the decoding slice (decode_ops,
     fusion_ops, long_tail_ops, fusion_seqpool_cvm_concat,
     deformable_conv_v1), every case of
     paddle_tpu_torch/testing/decode_cases.py on the card against the
     CPU, forward and gradient; the true-LoD beam_search step and
     beam_search_decode over LoD tensor arrays, and the book's beam
     decode program through the Executor, equal; host syncs a call;
  39. crnn, the main path of the decoding slice: the CRNN text recognizer
     of arXiv:1507.05717 Table 1 (8,722,725 parameters, 1x32x100 gray
     images, T = 26, 37 classes) trained eagerly with nn.CTCLoss and
     Adadelta: one batch-32 step card against CPU, 20 timed steps at
     batch 256 (step_ms, images/s, peak memory, launches, host syncs,
     busy and idle), and a held-out batch's greedy decode and edit
     distance, equal on the card and the CPU;
  40. rcnn_ops: the 15 op types of the two-stage detection slice
     (rcnn_ops), every case of paddle_tpu_torch/testing/rcnn_cases.py on
     the card against the CPU, indices and labels equal; host syncs and
     ms a call of each type's first case;
  41. faster_rcnn, the main path of that slice: PaddleDetection's fluid
     Faster R-CNN R50-C4 1x (rcnn_cases.FRCNN: 800 x 1333, 81 classes,
     512 RoIs, 12,000 / 2,000 proposals) trained through static.Executor:
     step 1's sampling ops and losses card against CPU, 10 timed steps
     (step_ms, images/s, peak memory, launches, host syncs, busy and
     idle, host ms of each rcnn op, device ms by family), then the test
     forward (proposals, box_coder decode, multiclass_nms,
     detection_map), timed.
  42. proto_model (right after phase 26): the resnet50 (fp32) and attn
     (bf16) artifacts of phase 24 written again in the reference's
     protobuf layout (a binary __model__ and LoDTensor parameter
     streams, inference.proto_program), loaded through
     io.load_inference_model and a Predictor: outputs bit-equal to the
     JSON route's, the bf16 parameters bf16, K1 once an attn run;
  43. dy2static_nmt, the main path of the dy2static slice: the base
     Transformer of arXiv:1706.03762 (NMT: 6 + 6 layers, d_model 512, 8
     heads, FFN 2048, a tied vocabulary of 37,000, fp32, eval) scored by
     jit.to_static at batch 32, source and target 64 (bit-equal to the
     eager forward, K1 18 launches a call, no host sync; ms a call,
     tokens/s), and decoded greedily by a dygraph function converted by
     dygraph.declarative (a while on a tensor condition, a TensorArray of
     ids, an if on a tensor freezing finished rows): ids and scores
     against the unconverted function, K1 6 + 12 launches a step, one
     host sync an iteration; ms a step; peak memory; card against CPU on
     4 rows within NMT_CPU_TOL; then K1 (with K2 and K3) at its shape,
     B32 S64 H8 D64 fp32, plain and causal, against the plain versions
     and timed as in phase 3;
  44. static_decoders: the contrib decoder's TrainingDecoder (4 Adagrad
     steps) and BeamSearchDecoder (level-2 LoD feeds), rnn / birnn /
     dynamic_decode, and one case of each contrib_layers builder with a
     registered type (paddle_tpu_torch/testing/decoder_cases.py), card
     against CPU. Phases 42-44 print their command time together.
  45. resnet_loader, the first main path of the data slice: ResNet-50
     (O1, NHWC, batch 256, 224 px) fed by io.DataLoader workers running
     vision.transforms' PaddleClas ImageNet recipe on 1,280 seeded uint8
     images memory-mapped from build/, a pass drawing LOADER_ROUNDS
     batches a worker with replacement: the loader alone at 0, 4 and
     all cores' workers (steady-state images/s after each worker's
     first batch, the first wait apart, the workers that delivered) and
     each transform's ms an image; loader-fed steps (steady state, first
     round apart) beside as many device-fed ones, the pageable
     host-to-device copy of a batch, the steady batches' wait p50 / p99,
     a profiled steady-state stretch (busy, idle, launches, host syncs);
     batches in sampler order with the sampled labels, the first loss
     near ln(1000), no shared-memory segment or worker left after each
     pass and after a break;
  46. ctr_dataset, the second: Paddle's fluid CTR-DNN (ctr_dnn_program,
     10,431,212 parameters, batch 1000, Adam 1e-4) trained by
     Executor.train_from_dataset over 8 MultiSlot files a
     MultiSlotDataGenerator wrote (128 batches), QueueDataset with 8
     threads through the native feeder (g++-built into build/): rows/s
     and ms a batch, the feeder alone, peak memory, every batch counted
     as native, finite losses, the first 4 losses card against CPU
     within 1e-4, a profiled pass over one file (busy, idle, launches
     and host syncs a batch), and infer_from_dataset leaving the
     parameters bit-equal. Phases 45-46 print their command time
     together.
Phase 3 also times K1-K3 in fp16 at BERT-base.
The last two lines are the kernels' JSON record (each kernel at fp32,
its launches from phase 7 and, as launches_eager_bert, from phase 27;
as <name>_bf16 at bf16, its launches from phase 8; as <name>_fp16 at
fp16, its launches from phase 6's fp16 loop; as <name>_gpt at GPT-3
1.3B's shape, its launches from phase 17; the rows of the dtype that
reaches them on the static ERNIE step with launches_static_ernie, and
as <name>_ernie at its shape with its launches, from phase 23;
flash_fwd_nmt and flash_fwd_nmt_causal at the NMT's shape, with the
launches of each route in phase 43) and {"ok": true, "device": {...}}. Phase 18 checks its own K1-K3 launches. The [predictor] line
says how a bfloat16 fetch comes to the host (ml_dtypes' bfloat16, or
float32 where ml_dtypes does not import).
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
              torch.bfloat16: 989e12,        # bf16 dense, tensor cores
              torch.float16: 989e12}         # fp16 dense, tensor cores
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
    ``dtype`` (fp32, what O1 feeds them; bf16, what O2 feeds them; fp16,
    what O2 with GradScaler feeds them): CUDA events (means of ``n``
    calls) beside their bound, a second bound (fp32: the CUDA cores;
    bf16 and fp16: the TF32 passes the kernels run), their plain
    versions and SDPA in the same dtype."""
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
            # the function's own products at the 16-bit tensor-core rate
            units = f"tensor cores, {dname} rate"
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
def flash_op_calls(key):
    """While active, counts the flash_attention op's calls by
    ``key(inputs, attrs)``."""
    from paddle_tpu_torch.core.registry import OpInfoMap
    opdef = OpInfoMap.instance().get("flash_attention")
    real = opdef.compute
    seen = collections.Counter()

    def spy(inputs, attrs):
        seen[key(inputs, attrs)] += 1
        return real(inputs, attrs)
    opdef.compute = spy
    try:
        yield seen
    finally:
        opdef.compute = real


def op_dtypes():
    """While active, counts the dtypes of q, k and v the flash_attention
    op is called with."""
    return flash_op_calls(lambda inputs, attrs: tuple(
        str(inputs[s][0].dtype).split(".")[-1] for s in ("Q", "K", "V")))


def op_causal():
    """While active, counts the flash_attention op's calls by route: the
    kernels' ("causal" / "plain") or the blockwise one ("bias")."""
    def route(inputs, attrs):
        if inputs.get("Bias") or attrs.get("q_offset"):
            return "bias"
        return "causal" if attrs.get("causal") else "plain"
    return flash_op_calls(route)


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
    # the fp16 loop's launches: the fp16 rows of the kernels record
    return dict(zip((w.__name__ for w in fa.WRAPPERS), launches))


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
    order: out x (in / groups x k x k) for a conv, in x (out / groups x k
    x k) for a transposed one; leaves the model in eval()."""
    from paddle_tpu_torch.nn import Conv2D, Conv2DTranspose
    macs, hooks = [], []
    for m in model.modules():
        if isinstance(m, Conv2D):
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out: macs.append(
                    out.numel() * mod.weight[0].numel())))
        elif isinstance(m, Conv2DTranspose):
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out: macs.append(
                    inp[0].numel() * mod.weight[0].numel())))
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


def resnet_train_step(tpt, dev, layout):
    """ResNet-50 of RESNET's classes from seed 0 and its O1 TrainStep with
    Momentum(0.1, 0.9), as bench.py builds them: (model, step)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50
    tpt.set_device(dev)
    tpt.seed(0)
    model = resnet50(num_classes=RESNET["classes"], data_format=layout)
    train = TrainStep(model, resnet_step_fn, Momentum(
        learning_rate=0.1, momentum=0.9, parameters=model.parameters()),
        amp_level="O1").ensure_state()
    return model, train


def _resnet_run(tpt, dev, layout, batches, warmup, steps):
    t0 = time.perf_counter()
    model, train = resnet_train_step(tpt, dev, layout)
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
    by_kernel = collections.Counter()
    for e in dev_events:
        by_kernel[e.name] += e.time_range.end - e.time_range.start
    return dict(busy_ms=device_busy_us(dev_events) / 1e3, wall_ms=wall_ms,
                top_kernels=[(k, v / 1e3) for k, v in
                             by_kernel.most_common(5)],
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
    from paddle_tpu_torch.optimizer import SGD, Adagrad, Momentum
    return types.SimpleNamespace(pt=pt, static=static, io=io,
                                 ParamAttr=ParamAttr, Uniform=Uniform,
                                 Momentum=Momentum, SGD=SGD, Adagrad=Adagrad)


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
    package); ``batch`` -1 leaves the batch to the feed: (main, startup,
    {"loss", "acc", "image", "label", "logits"})."""
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
                           "image": image.name, "label": label.name,
                           "logits": out.name}


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
    # at lr 0.1 the loss falls for four steps, then climbs, and the last
    # steps vary run to run (the 14th 6.03-7.06 over eight runs, once
    # above the first); the first four fell in all eight (7.0578,
    # 6.2984, 5.823-5.829, 5.654-5.670): each must fall
    check(all(b < a for a, b in zip(loss_vals[:3], loss_vals[1:4])),
          "the loss did not fall at each of the first four steps on one "
          "batch")
    for n in names:
        moved = not torch.equal(first[n], after[n])
        print(f"[static_resnet50] {n} {'moved' if moved else 'DID NOT MOVE'}")
        check(moved, f"{n} did not change over the steps")
    torch.cuda.empty_cache()


def scope_copy(tpt, names, source, dev):
    """A new scope holding copies of ``source``'s values of ``names``
    (those it holds) on ``dev``."""
    scope = tpt.Scope()
    for n in names:
        var = source.find_var(n)
        if var is not None and var.is_initialized():
            scope.var(n).set(tpt.TpuTensor(var.get().value.to(dev,
                                                               copy=True)))
    return scope


def executor_host_ms(fn):
    """(wall ms, host ms by op type) of one call of fn: the time the
    static executor spends inside each op's ``_run_op`` (enqueueing its
    kernels; nothing inside waits for the card unless the op reads it)."""
    from paddle_tpu_torch.core.executor import Executor
    real = Executor._run_op
    total = collections.Counter()

    def timed(op, env, idx, records, an):
        t0 = time.perf_counter()
        try:
            return real(op, env, idx, records, an)
        finally:
            total[op.type] += (time.perf_counter() - t0) * 1e3

    torch.cuda.synchronize()
    Executor._run_op = staticmethod(timed)
    t0 = time.perf_counter()
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        Executor._run_op = staticmethod(real)
    return (time.perf_counter() - t0) * 1e3, total

def phase_static_builders(tpt, dev):
    """Every case of paddle_tpu_torch/testing/static_cases.py (the
    static.nn builders and nets composites of the static training slice)
    through the port's static executor on the card against the port on
    the CPU, from the same startup values and feed: value cases within
    the case's tolerance, integer and bool fetches equal; random cases by
    shape, dtype and their check; the raising cases raising on both."""
    from paddle_tpu_torch.core.enforce import NotFoundError, UnimplementedError
    from paddle_tpu_torch.testing import static_cases as sc
    api = sc.port_api()
    tpt.set_device(dev)
    worst, counts = {}, collections.Counter()
    for case in sc.CASES:
        counts[case.kind] += 1
        if case.kind == "unbuilt":
            try:
                sc.build_case(api, case)
            except UnimplementedError:
                continue
            raise CheckFailed(f"{case.name} built")
        main, startup, fetch = sc.build_case(api, case)
        start = tpt.Scope()
        tpt.Executor("cpu").run(startup, scope=start)
        names = list(startup.global_block().vars)
        runs = {}
        for where in ("cpu", dev):
            scope = scope_copy(tpt, names, start, torch.device(where))
            exe = tpt.Executor(where)
            if case.kind == "raises":
                try:
                    exe.run(main, feed=case.feed, fetch_list=fetch,
                            scope=scope)
                except NotFoundError:
                    continue
                raise CheckFailed(f"{case.name} ran on {where}")
            runs[str(where)] = exe.run(main, feed=case.feed,
                                       fetch_list=fetch, scope=scope)
        if case.kind == "raises":
            continue
        want, got = runs["cpu"], runs[str(dev)]
        err = 0.0
        for n, g, w in zip(fetch, got, want):
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"{case.name} {n}: {g.shape} {g.dtype} on the card, "
                  f"{w.shape} {w.dtype} on the CPU")
            if case.kind != "value":
                continue
            if g.dtype.kind in "fc":
                rtol, atol = case.tol
                diff = np.abs(g.astype(np.float64) - w.astype(np.float64))
                ok = bool((diff <= atol + rtol * np.abs(w)).all())
                err = max(err, float(diff.max()) if diff.size else 0.0)
            else:
                ok = np.array_equal(g, w)
            check(ok, f"{case.name} {n} differs card against CPU")
        if case.check is not None:
            check(case.check(got) and case.check(want),
                  f"{case.name} fails its check")
        worst[case.name] = err
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:4]
    print(f"[static_builders] {len(sc.CASES)} cases ({dict(counts)}) agree "
          f"card against CPU; largest abs errors: "
          + ", ".join(f"{k} {v:.3e}" for k, v in top))


# ERNIE 1.0 base pretraining (static_cases.ERNIE_BASE) through the static
# executor: 3 warm-up and 10 timed steps on one batch; the first loss on
# the card against the CPU at batch 2, seq 128, dropout 0, from the same
# weights, within one bf16 ulp (2**-7 relative: both sides run the white
# ops on bf16 inputs, whose products cuBLAS and the CPU sum in other
# orders)
STATIC_ERNIE = dict(warmup=3, steps=10, check_batch=2, check_seq=128)
STATIC_ERNIE_LOSS_RTOL = 2.0 ** -7


def phase_static_ernie(tpt, fa, dev):
    """ERNIE 1.0 base pretraining as its fluid script writes it
    (static_cases.ernie_program at ERNIE_BASE: 12 layers, hidden 768, 12
    heads, FFN 3072 relu, vocab 18,000, dropout 0.1, TruncatedNormal(0.02)
    weights, the tied masked-LM head and the next-sentence head, Adam
    1e-4 under static_amp.decorate in bf16 with dynamic loss scaling),
    batch 16 at seq 512, through CompiledProgram(main).with_data_parallel(
    loss_name=...) on the card: the rewrite's casts, the first loss
    against the CPU, K1-K3 12 launches a step each and the dtype that
    reaches them (the CPU run's), the masked-LM loss falling at each of
    the first four steps on one batch and the summed loss at the fourth
    under the first, the loss scale finite; step time, samples/s,
    tokens/s, peak memory, the launches, host syncs and device busy of a
    profiled step, and the host ms inside the executor's ops. Returns
    ({kernel: launches in the timed run}, the dtype that reached
    K1-K3)."""
    from paddle_tpu_torch.testing import static_cases as sc
    api = sc.port_api()
    tpt.set_device(dev)
    tpt.seed(0)
    cfg, run = sc.ERNIE_BASE, STATIC_ERNIE
    t0 = time.perf_counter()
    ernie = sc.ernie_program(api, cfg)
    ops = ernie.main.op_types()
    casts = ops.count("cast")
    names = list(ernie.startup.global_block().vars)
    params = [n for n in names if "@" not in n and not n.startswith((
        "learning_rate", "loss_scaling", "good_steps", "bad_steps"))]
    print(f"[static_ernie] program built in {time.perf_counter() - t0:.2f} "
          f"s: {len(ops)} ops ({sum(t.endswith('_grad') for t in ops)} grad "
          f"ops, {casts} casts from the AMP rewrite, "
          f"{ops.count('flash_attention')} flash_attention, "
          f"{ops.count('adam')} adam), {len(params)} parameters")
    check(casts > 0, "the static AMP rewrite wrote no cast")
    exe, scope = tpt.Executor(), tpt.Scope()
    t0 = time.perf_counter()
    exe.run(ernie.startup, scope=scope)
    torch.cuda.synchronize()
    n_params = sum(scope.find_var(n).get().value.numel() for n in params)
    print(f"[static_ernie] startup (TruncatedNormal(0.02) drawn on the CPU, "
          f"moved) {time.perf_counter() - t0:.2f} s: {n_params:,} "
          f"parameters (static_cases.ernie_param_count "
          f"{sc.ernie_param_count(cfg):,})")
    check(n_params == sc.ernie_param_count(cfg), "parameter count")

    # the first loss, card against CPU, from the same weights: the small
    # program's startup makes its own optimizer state (its unique names
    # differ), the full program's values replace every var they share
    small = sc.ernie_program(api, cfg, seq=run["check_seq"], dropout=0.0)
    small_names = list(small.startup.global_block().vars)
    small_start = tpt.Scope()
    tpt.Executor("cpu").run(small.startup, scope=small_start)
    shared = [n for n in small_names if scope.find_var(n) is not None]
    for n in shared:
        small_start.var(n).set(tpt.TpuTensor(
            scope.find_var(n).get().value.to("cpu", copy=True)))
    print(f"[static_ernie] {len(shared)} of the batch-{run['check_batch']} "
          f"program's {len(small_names)} startup vars copied from the full "
          f"program's")
    feed = sc.ernie_batch(cfg, run["check_batch"], run["check_seq"], seed=1)
    first, seen = {}, {}
    for where in ("cpu", dev):
        sscope = scope_copy(tpt, small_names, small_start,
                            torch.device(where))
        t0 = time.perf_counter()
        with op_dtypes() as dts:
            out = tpt.Executor(where).run(small.main, feed=feed,
                                          fetch_list=[small.loss],
                                          scope=sscope)
        first[str(where)], seen[str(where)] = float(out[0][0]), set(dts)
        print(f"[static_ernie] batch {run['check_batch']} seq "
              f"{run['check_seq']} dropout 0 on {where}: first loss "
              f"{first[str(where)]:.6f} in {time.perf_counter() - t0:.2f} "
              f"s, q/k/v dtypes at flash_attention {sorted(seen[str(where)])}")
        del sscope
    del small_start
    rel = abs(first[str(dev)] - first["cpu"]) / abs(first["cpu"])
    print(f"[static_ernie] first loss card against CPU: {rel:.3e} relative "
          f"(bound {STATIC_ERNIE_LOSS_RTOL:.3e})")
    check(rel <= STATIC_ERNIE_LOSS_RTOL, "first loss card against CPU")
    check(len(seen[str(dev)]) == 1 and seen[str(dev)] == seen["cpu"],
          "the dtype reaching flash_attention differs card against CPU")
    dtype = next(iter(seen[str(dev)]))[0]

    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in sc.ernie_batch(cfg, seed=0).items()}
    compiled = tpt.CompiledProgram(ernie.main).with_data_parallel(
        loss_name=ernie.loss)
    losses = []

    def step():
        out = exe.run(compiled, feed=batch,
                      fetch_list=[ernie.loss, ernie.mlm, ernie.nsp],
                      scope=scope, return_numpy=False)
        losses.append([t.value for t in out])

    for w in fa.WRAPPERS:
        w.launches = 0
    blockwise = fa.blockwise_route.calls
    with op_dtypes() as dts:
        times = _timed_steps(step, run["warmup"], run["steps"])
    launches = {w.__name__: w.launches for w in fa.WRAPPERS}
    n_steps = run["warmup"] + run["steps"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile_call(step)
    host_wall, host = executor_host_ms(step)
    loss_vals, mlm_vals, nsp_vals = (
        [float(v[i].reshape(-1)[0]) for v in losses] for i in range(3))
    scale = scope.find_var(ernie.opt.get_loss_scaling()).get().value
    med = sorted(times)[len(times) // 2]
    tokens = cfg["batch"] * cfg["seq"]
    card = card_line()
    print(f"[static_ernie] {card}: batch {cfg['batch']} seq {cfg['seq']} bf16 "
          f"AMP: step_ms median {med:.3f} range {min(times):.3f}-"
          f"{max(times):.3f} over {run['steps']} steps after "
          f"{run['warmup']} warm-up, samples/s "
          f"{cfg['batch'] / med * 1e3:.2f}, tokens/s "
          f"{tokens / med * 1e3:.0f}, peak_mem {peak:.3f} GiB")
    print(f"[static_ernie] profiled step {prof['wall_ms']:.3f} ms: device "
          f"busy {prof['busy_ms']:.3f} ms (idle "
          f"{1 - prof['busy_ms'] / prof['wall_ms']:.3f}), launches "
          f"{prof['launches']}, host syncs {prof['syncs']}; top kernels "
          + ", ".join(f"{k[:48]} {v:.3f}" for k, v in prof["top_kernels"]))
    fam = collections.Counter()
    for t, ms in host.items():
        fam["adam" if t == "adam" else "grad ops" if t.endswith("_grad")
            else "forward ops"] += ms
    print(f"[static_ernie] host ms inside the executor's ops over one step "
          f"of {host_wall:.3f} ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in fam.most_common())
          + f", outside them {host_wall - sum(fam.values()):.3f}; top types "
          + ", ".join(f"{k} {v:.3f}" for k, v in host.most_common(6)))
    print(f"[static_ernie] K1/K2/K3 launches over {n_steps} steps {launches} "
          f"on q/k/v {sorted(dts)}; loss scale "
          f"{float(scale.reshape(-1)[0])}")
    for what, vals in (("loss", loss_vals), ("masked-LM loss", mlm_vals),
                       ("next-sentence loss", nsp_vals)):
        print(f"[static_ernie] {what} by step: {[round(v, 4) for v in vals]}")
    check(all(math.isfinite(v) for v in loss_vals), "non-finite loss")
    # Adam's first steps move every weight by about lr: the next-sentence
    # head (16 random labels) overshoots at step 2 and the summed loss
    # rises there, in the JAX package too (scripts/ernie_first_steps.py);
    # the masked-LM loss falls at each step
    check(all(b < a for a, b in zip(mlm_vals[:3], mlm_vals[1:4])),
          "the masked-LM loss did not fall at each of the first four steps "
          "on one batch")
    check(loss_vals[3] < loss_vals[0], "the loss at step 4 is not under "
          "the first")
    check(bool(torch.isfinite(scale).all()), "the loss scale is not finite")
    check(all(n == cfg["layers"] * n_steps for n in launches.values()),
          f"K1-K3 did not launch {cfg['layers']} times a step each: "
          f"{launches}")
    check(fa.blockwise_route.calls == blockwise,
          "the static ERNIE step took the blockwise route")
    check(set(dts) == {(dtype,) * 3},
          f"the dtype reaching K1-K3 on the main path {sorted(dts)} is not "
          f"the CPU run's {dtype}")
    del scope, exe, compiled, batch
    torch.cuda.empty_cache()
    return launches, dtype


ERNIE_SHAPE = (16, 512, 12, 64, False)      # B, S, H, D: the ERNIE step's


def phase_ernie_kernels(fa, dev, dtype):
    """K1-K3 at the static ERNIE step's shape (ERNIE_SHAPE) in the dtype
    that reaches them there: against their plain versions, then
    phase_timing's times, bounds, plain and SDPA times. Returns (rows,
    largest error by wrapper)."""
    b, s, h, d, causal = ERNIE_SHAPE
    gen = torch.Generator(device=dev).manual_seed(29)
    q, k, v, g = (torch.randn(b, s, h, d, generator=gen, device=dev)
                  .to(dtype) for _ in range(4))
    print(f"[ernie_kernels] B{b} S{s} H{h} D{d} causal={causal} "
          f"{str(dtype).split('.')[-1]}")
    errs, _ = kernels_against_plain(fa, q, k, v, g, causal, dtype)
    del q, k, v, g
    return phase_timing(fa, dev, dtype, ERNIE_SHAPE), errs


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



# ------------------------------------------------------------- serving
# the attn tenant: BERT-base's self-attention sublayer as a static
# program (x -> q/k/v projections -> flash_attention -> output
# projection + residual -> layer_norm)
ATTN = dict(hidden=768, heads=12, seq=128)
ATTN_DTYPE = "bfloat16"                   # as STATIC_FLASH runs it
SERVE_RESNET = dict(px=224, class_dim=1000)
SERVE_BUCKETS = {"resnet50": [1, 8, 32], "attn": [4, 16]}
# each tenant's closed-loop clients as (threads, (fewest, most) rows a
# request): interactive clients send what the smaller buckets take; bulk
# clients send more rows than the middle bucket holds, so their requests
# head batches of the largest bucket (a batch's bucket is the smallest
# that fits its head request), which queued interactive requests fill
SERVE_CLIENTS = {"resnet50": [(6, (1, 8)), (2, (9, 16))],
                 "attn": [(2, (1, 4)), (1, (5, 8))]}
SERVE_SECONDS = 20.0          # every client sends until the window ends
SERVE_POOL = 16               # seeded requests a client cycles through
# served answers against their rows of a direct Predictor run of the
# batch that served them: the same kernels at the same shapes, so equal
# but for a kernel that picks another algorithm on another thread (fp32
# at the fp32 check's bound, bf16 at one bf16 ulp of the output's
# scale); the count of bit-equal answers is printed
SERVE_TOL = {"resnet50": (1e-5, 1e-5), "attn": (2.0 ** -7, 2.0 ** -7)}


def attn_program(api, hidden, heads, seq, dtype="float32"):
    """The attn tenant's program built with ``api`` (either package): a
    float32 feed "x" [-1, seq, hidden] (cast to ``dtype`` first when
    that is not float32), Wq/Wk/Wv ``mul`` + ``elementwise_add``,
    ``reshape`` to [B, seq, heads, hidden / heads], non-causal
    ``flash_attention``, ``reshape`` back, Wo ``mul`` + bias, the
    residual, ``layer_norm`` over the last axis, and a float32 fetch:
    (program, {parameter name: shape}, fetch name)."""
    prog = api.pt.Program()
    blk = prog.global_block()
    d = hidden // heads
    params = {}

    def op(type_, ins, outs, attrs=None):
        for names in outs.values():
            for n in names:
                blk.create_var(n)
        blk.append_op(type_, ins, outs, attrs or {})

    def param(name, shape):
        blk.create_var(name, shape=shape, dtype=dtype, persistable=True)
        params[name] = shape

    def linear(x, w, out):
        param(w, (hidden, hidden))
        param(w + "_b", (hidden,))
        op("mul", {"X": [x], "Y": [w]}, {"Out": [out + "_mul"]},
           {"x_num_col_dims": 2, "y_num_col_dims": 1})
        op("elementwise_add", {"X": [out + "_mul"], "Y": [w + "_b"]},
           {"Out": [out]}, {"axis": -1})

    blk.create_var("x", shape=(-1, seq, hidden), dtype="float32",
                   is_data=True)
    h = "x"
    if dtype != "float32":
        op("cast", {"X": ["x"]}, {"Out": ["x_in"]}, {"out_dtype": dtype})
        h = "x_in"
    for n in "qkv":
        linear(h, "w" + n, n + "_lin")
        op("reshape", {"X": [n + "_lin"]}, {"Out": [n]},
           {"shape": [0, 0, heads, d]})
    op("flash_attention", {"Q": ["q"], "K": ["k"], "V": ["v"]},
       {"Out": ["ctx4"]}, {"causal": False})
    op("reshape", {"X": ["ctx4"]}, {"Out": ["ctx"]},
       {"shape": [0, 0, hidden]})
    linear("ctx", "wo", "o_lin")
    op("elementwise_add", {"X": ["o_lin"], "Y": [h]}, {"Out": ["res"]},
       {"axis": -1})
    param("ln_scale", (hidden,))
    param("ln_bias", (hidden,))
    op("layer_norm", {"X": ["res"], "Scale": ["ln_scale"],
                      "Bias": ["ln_bias"]},
       {"Y": ["y"], "Mean": ["ln_mean"], "Variance": ["ln_var"]},
       {"begin_norm_axis": 2, "epsilon": 1e-12})
    fetch = "y"
    if dtype != "float32":
        op("cast", {"X": ["y"]}, {"Out": ["out"]}, {"out_dtype": "float32"})
        fetch = "out"
    return prog, params, fetch


def attn_values(params, seed):
    """Seeded float32 values for attn_program's parameters: weights
    N(0, 0.02) as BERT initializes them, small random biases, layer-norm
    scales near 1."""
    rs = np.random.RandomState(seed)
    out = {}
    for n, shape in sorted(params.items()):
        if n == "ln_scale":
            v = 1.0 + 0.1 * rs.randn(*shape)
        elif n.startswith("w") and len(shape) == 2:
            v = 0.02 * rs.randn(*shape)
        else:
            v = 0.1 * rs.randn(*shape)
        out[n] = v.astype(np.float32)
    return out


def save_attn(api, exe, path, hidden, heads, seq, dtype="float32", seed=0):
    """attn_program with attn_values(seed) saved by ``api``'s
    save_inference_model into ``path``; returns the values."""
    prog, params, fetch = attn_program(api, hidden, heads, seq, dtype)
    values = attn_values(params, seed)
    scope = api.pt.Scope()
    for n, v in values.items():
        if dtype == "bfloat16":      # numpy has no bfloat16: the port only
            v = torch.from_numpy(v).to(torch.bfloat16)
        scope.var(n).set(api.pt.TpuTensor(v))
    with api.pt.scope_guard(scope):
        api.io.save_inference_model(path, ["x"], [fetch], exe,
                                    main_program=prog, scope=scope)
    return values


def save_static_resnet(api, exe, path, px, class_dim, **kw):
    """static_resnet (batch -1) for inference: its startup run by ``exe``
    and the program saved by ``api``'s save_inference_model into
    ``path`` with "image" as the feed and the logits as the fetch."""
    prog, startup, fetch = static_resnet(api, -1, px, class_dim,
                                         train=False, **kw)
    scope = api.pt.Scope()
    exe.run(startup, scope=scope)
    with api.pt.scope_guard(scope):
        api.io.save_inference_model(path, [fetch["image"]],
                                    [fetch["logits"]], exe,
                                    main_program=prog, scope=scope)
    return fetch["logits"]


def serve_feed(name, rows, rs):
    """A seeded request of ``rows`` rows for the tenant ``name``."""
    if name == "resnet50":
        px = SERVE_RESNET["px"]
        return {"image": rs.rand(rows, 3, px, px).astype(np.float32)}
    return {"x": rs.randn(rows, ATTN["seq"],
                          ATTN["hidden"]).astype(np.float32)}


def predict(tpt, path, feed):
    """A direct Predictor run: create_predictor(Config(path)) on the
    current device, ``run`` on the feeds in order."""
    from paddle_tpu_torch import inference
    pred = inference.create_predictor(inference.Config(path))
    return pred, pred.run([feed[n] for n in pred.get_input_names()])


def resave_reference(tpt, src, dst, params_filename=None):
    """The JSON-IR inference model at ``src`` loaded through
    io.load_inference_model and written again at ``dst`` in the
    reference's layout (a protobuf ``__model__`` and LoDTensor parameter
    streams, one file a parameter unless ``params_filename``) by
    inference.proto_program.save_reference_inference_model: (feed names,
    fetch names)."""
    from paddle_tpu_torch import io
    from paddle_tpu_torch.inference.proto_program import (
        save_reference_inference_model)
    exe, scope = tpt.Executor(), tpt.Scope()
    prog, feeds, fetches = io.load_inference_model(src, exe, scope=scope)
    save_reference_inference_model(dst, feeds, fetches, prog, scope=scope,
                                   params_filename=params_filename)
    return feeds, fetches


def rel_err(got, want):
    return float(np.linalg.norm(got.astype(np.float64) - want) /
                 max(np.linalg.norm(want.astype(np.float64)), 1e-30))


def phase_predictor(tpt, fa, dev, workdir):
    """The saved resnet50 and attn artifacts through Predictor on the
    card: ``run(list)`` and the zero-copy handles, each bit for bit
    against Executor.run of the loaded program on the same inputs, and
    against a CPU Predictor within the bounds phase static_resnet_tiny
    (resnet50, fp32) and the kernels' bf16 check (attn) use. K1 launches
    once an attn run. Returns the artifacts' paths."""
    from paddle_tpu_torch import inference, io
    api = port_static_api()
    tpt.set_device(dev)
    paths = {n: f"{workdir}/{n}" for n in ("resnet50", "attn")}
    tpt.seed(0)
    t0 = time.perf_counter()
    save_static_resnet(api, api.pt.Executor(), paths["resnet50"],
                       **SERVE_RESNET)
    save_attn(api, api.pt.Executor(), paths["attn"], **ATTN,
              dtype=ATTN_DTYPE)
    print(f"[predictor] resnet50 and attn ({ATTN_DTYPE}) built, initialized "
          f"and saved in {time.perf_counter() - t0:.2f} s")
    rs = np.random.RandomState(7)
    batches = {"resnet50": 8, "attn": 4}
    for name, path in paths.items():
        feed = serve_feed(name, batches[name], rs)
        k1 = fa.flash_fwd.launches
        pred, (out,) = predict(tpt, path, feed)
        launches = fa.flash_fwd.launches - k1
        for n in pred.get_input_names():
            pred.get_input_handle(n).copy_from_cpu(feed[n])
        pred.zero_copy_run()
        handle = pred.get_output_handle(pred.get_output_names()[0])
        zc = handle.copy_to_cpu()
        exe, scope = api.pt.Executor(), api.pt.Scope()
        prog, feeds, fetches = io.load_inference_model(path, exe,
                                                       scope=scope)
        want, = exe.run(prog, feed=feed, fetch_list=fetches, scope=scope)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            pred.run([feed[n] for n in pred.get_input_names()])
            times.append((time.perf_counter() - t1) * 1e3)
        tpt.set_device("cpu")
        try:
            _, (cpu,) = predict(tpt, path, feed)
        finally:
            tpt.set_device(dev)
        err = rel_err(out, cpu)
        if name == "resnet50":      # fp32: static_resnet_tiny's loss bound
            bound = f"rel err bound {RESNET_TINY_TOL['loss'][0]:g}"
            close = err <= RESNET_TINY_TOL["loss"][0]
        else:                       # bf16: the kernels' bf16 bound on o
            rtol, atol = TOL[torch.bfloat16]["o"]
            bound = f"rtol/atol {rtol:g}/{atol:g}"
            close = bool(np.allclose(out, cpu, rtol=rtol, atol=atol))
        print(f"[predictor] {name}: batch {batches[name]} -> "
              f"{tuple(out.shape)} {out.dtype}, finite "
              f"{bool(np.isfinite(out).all())}; run(list) "
              f"{'equals' if np.array_equal(out, want) else 'DIFFERS FROM'} "
              f"Executor.run, zero-copy "
              f"{'equals' if np.array_equal(zc, out) else 'DIFFERS FROM'} "
              f"run(list); card vs CPU rel err {err:.3e} ({bound}) "
              f"{'ok' if close else 'FAIL'}; K1 launches a run {launches}; "
              f"predict ms median {sorted(times)[2]:.3f} over 5")
        check(np.isfinite(out).all(), f"{name}: non-finite output")
        check(np.array_equal(out, want),
              f"{name}: Predictor differs from Executor.run")
        check(np.array_equal(zc, out),
              f"{name}: the zero-copy run differs from run(list)")
        check(close, f"{name}: the card's prediction disagrees with the "
                     f"CPU's")
        check(launches == (1 if name == "attn" else 0),
              f"{name}: K1 launched {launches} times in one run")
    bf16_fetch_route(dev)
    return paths


def bf16_fetch_route(dev):
    """How a bfloat16 fetch comes to the host on the card: through
    ``core.dtype.host_array`` (Predictor) and the serving ``Readback``
    (pinned copies of the int16 words), as ml_dtypes' bfloat16 with the
    tensor's own bytes where ml_dtypes imports, else as float32."""
    from paddle_tpu_torch.core import dtype as dtypes
    from paddle_tpu_torch.serving.model import Readback
    t = (torch.arange(24, device=dev, dtype=torch.float32) / 7).reshape(
        4, 6).to(torch.bfloat16)
    direct = dtypes.host_array(t)
    served, = Readback([t]).wait()
    words = t.view(torch.int16).cpu().numpy().tobytes()
    if dtypes.NP_BFLOAT16 is None:
        route = "float32 (ml_dtypes does not import)"
        ok = all(a.dtype == np.float32 and np.array_equal(
            a, t.float().cpu().numpy()) for a in (direct, served))
    else:
        import ml_dtypes
        route = f"bfloat16 (ml_dtypes {ml_dtypes.__version__})"
        ok = all(a.dtype == dtypes.NP_BFLOAT16 and a.tobytes() == words
                 for a in (direct, served))
    print(f"[predictor] a bfloat16 fetch comes to the host as {route}: "
          f"Predictor and serving Readback "
          f"{'agree with' if ok else 'DIFFER FROM'} the tensor's bytes")
    check(ok, "bfloat16 fetch")


def _serve_tenants(srv, paths):
    """Both tenants added to ``srv`` with their buckets: the models and
    the seconds each ``add_tenant`` took (load, admission, prewarm)."""
    feed_name = {"resnet50": "image", "attn": "x"}
    shapes = {"resnet50": (3, SERVE_RESNET["px"], SERVE_RESNET["px"]),
              "attn": (ATTN["seq"], ATTN["hidden"])}
    models, secs = {}, {}
    for name, path in paths.items():
        t0 = time.perf_counter()
        models[name] = srv.add_tenant(name, path, buckets=[
            {feed_name[name]: ((b,) + shapes[name], "float32")}
            for b in SERVE_BUCKETS[name]])
        secs[name] = time.perf_counter() - t0
    return models, secs


def client_feeds(name, seed, rows):
    """One client's SERVE_POOL seeded requests of (fewest, most)
    ``rows`` rows, made before the timed window."""
    rs = np.random.RandomState(seed)
    return [serve_feed(name, int(rs.randint(rows[0], rows[1] + 1)), rs)
            for _ in range(SERVE_POOL)]


def _client(srv, name, feeds, stop_at, results):
    """One closed-loop client: sends its requests in turn, each when the
    previous one is answered, until ``stop_at``. It keeps a copy of each
    answer (the served rows are views of the batch's pinned buffer), or
    the error that ended it."""
    i = 0
    try:
        while time.perf_counter() < stop_at:
            feed = feeds[i % len(feeds)]
            i += 1
            fut = srv.submit(name, feed)
            got = [np.array(o) for o in fut.result(timeout=120)]
            results.append((name, feed, fut, got))
    except Exception as e:      # noqa: BLE001 - the phase fails on it
        results.append((name, None, None, e))


def _bucket_batch(key):
    """The batch size of a bucket key ("<feed>:<B>x...")."""
    return int(key.split(":")[1].split("x")[0])


class _K1Spy:
    """A stand-in for ``fa.flash_fwd`` that notes the thread and stream
    of each call and keeps the first q/k/v of each batch size. The
    wrapper counts its launches on the name ``flash_fwd``, which is this
    object while it stands in, so ``launches`` is the wrapper's own."""

    def __init__(self, fwd, seen):
        self.fwd, self.seen = fwd, seen

    launches = property(lambda self: self.fwd.launches,
                        lambda self, n: setattr(self.fwd, "launches", n))

    def __call__(self, q, k, v, causal, scale, block_size=512):
        import threading
        self.seen["calls"].append((
            threading.current_thread().name,
            torch.cuda.current_stream(q.device).cuda_stream))
        if q.shape[0] not in self.seen["inputs"]:
            self.seen["inputs"][q.shape[0]] = (q.clone(), k.clone(),
                                               v.clone(), causal, scale)
        return self.fwd(q, k, v, causal, scale, block_size)


def _batch_profile(model):
    """Launches and CUDA runtime calls of one batch of ``model`` on the
    path the worker thread takes (stage, the program, the readback's
    copies and event), profiled on this thread, per bucket."""
    out = {}
    for b in model.policy.buckets:
        feed = {n: np.zeros(shape, dt) for n, (shape, dt) in b.spec.items()}
        prof = profile_call(
            lambda: model.readback(model.run_padded(b, feed)).wait())
        out[b.batch] = prof
    return out


def serve_k1_check(fa, inputs):
    """K1 against its plain version on the q/k/v the attn program fed it
    while serving, for each batch size, at the bf16 bounds of phase
    kernels; and again with q scaled by 8. BERT-initialized weights give
    scores of std about 0.3, so the softmax is near uniform and the plain
    o lies near V's mean over the keys: that distance is printed, and K1
    must lie four times closer to the plain o than V's mean does. The
    scaled q makes the softmax sharp."""
    for b, (q, k, v, causal, scale) in sorted(inputs.items()):
        for q_mul in (1.0, 8.0):
            qm = (q.float() * q_mul).to(q.dtype)
            print(f"[serve] K1 on the attn tenant's q/k/v from a batch of "
                  f"{b}: B{b} S{q.shape[1]} H{q.shape[2]} D{q.shape[3]} "
                  f"{str(q.dtype).split('.')[-1]}, q x{q_mul:g}")
            o, lse = fa.flash_fwd(qm, k, v, causal, scale)
            o_r, lse_r = fa.blockwise_attention(qm, k, v, causal=causal,
                                                scale=scale)
            torch.cuda.synchronize()
            spread = (o_r.float() - v.float().mean(1, keepdim=True)
                      ).abs().max().item()
            err = err_of(o, o_r, *TOL[torch.bfloat16]["o"], "o")
            err_of(lse, lse_r, *LSE_TOL, "lse")
            print(f"    the plain o lies up to {spread:.3e} from V's mean "
                  f"over the keys")
            check(err < spread / 4, f"K1 at B{b} is no closer to the "
                                    f"plain o than V's mean is")


def phase_serve(tpt, fa, dev, paths, workdir):
    """Both tenants in one PredictorServer on the card, for a window of
    SERVE_SECONDS: interactive and bulk closed-loop clients (SERVE_CLIENTS)
    send seeded requests. Every batch the server ran is run again by a
    direct Predictor on the same padded rows, and each request's answer
    is held against its rows of that run. Every declared bucket above 1
    must have served a batch of several requests. 0 steady compiles
    after freeze; K1 launched once an attn batch, from the worker thread
    on the caller's stream, and K2 and K3 not at all; K1 against its
    plain version on the q/k/v it was fed. Prints latency percentiles,
    throughput, batches and occupancy by bucket, pipeline depth, launches
    and host syncs a batch, peak memory and add_tenant's time on an
    empty cache."""
    import threading
    from paddle_tpu_torch.observability import flight_recorder, metrics
    from paddle_tpu_torch.serving import PredictorServer
    tpt.set_device(dev)
    srv = PredictorServer(cache_dir=f"{workdir}/cache", max_linger_ms=2.0)
    models, boot = _serve_tenants(srv, paths)
    print("[serve] add_tenant on an empty cache directory (load, admission, "
          "prewarm): " + ", ".join(
              f"{n} {boot[n]:.3f} s, buckets "
              f"{[b.batch for b in m.policy.buckets]} compiles {m.compiles} "
              f"warm_loads {m.warm_loads}" for n, m in models.items()))
    srv.start()
    main_stream = torch.cuda.current_stream().cuda_stream
    seen = {"calls": [], "inputs": {}}
    fwd = fa.flash_fwd
    pools = [(name, client_feeds(name, 1000 * t + 100 * c + i, rows))
             for t, name in enumerate(SERVE_CLIENTS)
             for c, (n, rows) in enumerate(SERVE_CLIENTS[name])
             for i in range(n)]
    try:
        srv.freeze()
        # warm-up: one request per bucket size pays cuBLAS's and cuDNN's
        # first calls outside the window
        rs = np.random.RandomState(11)
        for name, sizes in SERVE_BUCKETS.items():
            for b in sizes:
                srv.predict(name, serve_feed(name, b, rs), timeout=300)
        torch.cuda.synchronize()
        metrics.reset()
        flight_recorder.reset()
        flight_recorder.enable(capacity=1 << 16)
        for w in fa.WRAPPERS:
            w.launches = 0
        torch.cuda.reset_peak_memory_stats()
        fa.flash_fwd = _K1Spy(fwd, seen)
        results = []
        t0 = time.perf_counter()
        threads = [threading.Thread(target=_client, args=(
            srv, name, feeds, t0 + SERVE_SECONDS, results))
            for name, feeds in pools]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=SERVE_SECONDS + 600)
        wall = time.perf_counter() - t0
        fa.flash_fwd = fwd
        launches = {w.__name__: w.launches for w in fa.WRAPPERS}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(not any(t.is_alive() for t in threads),
              "a client thread did not finish")
        snap = metrics.snapshot()
        events = [e for e in flight_recorder.events()
                  if e["kind"] == "serving_batch"]
        stats = srv.stats()
        depth = metrics.MetricRegistry.instance().get_histogram(
            "serving/pipeline_depth")
        depth_sum = depth.summary() if depth else {}
        depths = collections.Counter(depth.values() if depth else [])
    finally:
        fa.flash_fwd = fwd
        flight_recorder.disable()
        srv.stop()
    errors = [r[3] for r in results if r[2] is None]
    check(not errors, f"{len(errors)} clients failed: {errors[:1]!r}")
    batches = {n: int(snap.get(f"serving/batches/{n}", 0))
               for n in SERVE_CLIENTS}
    check(all(batches.values()), f"a tenant served no batch: {batches}")
    check(len(events) == sum(batches.values()),
          f"{len(events)} batch events for {batches} batches")
    by_id = {fut.request_id: r for r in results for fut in (r[2],)}
    check(sorted(by_id) == sorted(i for e in events
                                  for i in e["request_ids"]),
          "the batch events and the answers name different requests")
    # every batch again through a direct Predictor on the same padded
    # rows; each request's answer against its rows of that run
    preds = {name: predict(tpt, path, serve_feed(name, 1, rs))[0]
             for name, path in paths.items()}
    per = {n: dict(exact=0, worst=0.0, bad=[], lat=collections.defaultdict(
        list), batches=collections.Counter(), multi=collections.Counter(),
        reqs=collections.Counter(), rows=collections.Counter())
        for n in SERVE_CLIENTS}
    served = []
    for e in events:
        name, b = e["tenant"], _bucket_batch(e["bucket"])
        reqs = [by_id[i] for i in e["request_ids"]]
        x = np.concatenate([next(iter(r[1].values())) for r in reqs])
        padded = np.zeros((b,) + x.shape[1:], x.dtype)
        padded[:len(x)] = x
        want = preds[name].run([padded])[0]
        p = per[name]
        p["batches"][b] += 1
        p["multi"][b] += len(reqs) > 1
        p["reqs"][b] += len(reqs)
        p["rows"][b] += len(x)
        start = 0
        for _, feed, fut, (got,) in reqs:
            rows = next(iter(feed.values())).shape[0]
            w = want[start:start + rows]
            rtol, atol = SERVE_TOL[name]
            p["exact"] += bool(np.array_equal(got, w))
            p["worst"] = max(p["worst"], rel_err(got, w))
            if got.shape != w.shape or not np.allclose(
                    got, w, rtol=rtol, atol=atol * np.abs(w).max()):
                p["bad"].append(fut.request_id)
            t = fut.timing
            p["lat"][b].append((t["t_done"] - t["t_submit"]) * 1e3)
            served.append((name, feed, got, b, start))
            start += rows
    profs = {n: _batch_profile(m) for n, m in models.items()}
    card = card_line()
    for name in SERVE_CLIENTS:
        p = per[name]
        lat = np.asarray([t for v in p["lat"].values() for t in v])
        rows = sum(p["rows"].values())
        p50, p90, p99 = np.percentile(lat, [50, 90, 99])
        wait = snap.get(f"serving/queue_wait_ms/{name}") or {}
        clients = " and ".join(f"{n} clients of {lo}-{hi} rows"
                               for n, (lo, hi) in SERVE_CLIENTS[name])
        print(f"[serve] {name}: {len(lat)} requests ({rows} rows) in "
              f"{batches[name]} batches over {wall:.3f} s from {clients}, "
              f"closed loop: latency p50 {p50:.3f} ms p90 {p90:.3f} ms p99 "
              f"{p99:.3f} ms max {lat.max():.3f} ms; {len(lat) / wall:.2f} "
              f"requests/s, {rows / wall:.2f} rows/s; queue wait p50 "
              f"{wait.get('p50', 0):.3f} ms (last 2048 requests); answers "
              f"within rtol/atol {SERVE_TOL[name]} of the direct Predictor "
              f"run of their batch: {len(lat) - len(p['bad'])}/{len(lat)} "
              f"({p['exact']} bit-equal, worst rel err {p['worst']:.3e})")
        for b in sorted(p["batches"]):
            n = p["batches"][b]
            print(f"[serve] {name}: bucket {b}: {n} batches, {p['multi'][b]} "
                  f"of several requests, {p['reqs'][b] / n:.2f} requests "
                  f"and occupancy {p['rows'][b] / (n * b):.3f} a batch, "
                  f"latency p50 {np.percentile(p['lat'][b], 50):.3f} ms")
        for b, prof in profs[name].items():
            rt = prof["runtime"]
            print(f"[serve] {name}: one bucket-{b} batch on the worker's "
                  f"path: {prof['launches']} launches, host syncs "
                  f"{prof['syncs']} (cudaStreamSynchronize) + "
                  f"{rt.get('cudaEventSynchronize', 0)} "
                  f"(cudaEventSynchronize, the readback's wait), "
                  f"{rt.get('cudaMemcpyAsync', 0)} cudaMemcpyAsync; wall "
                  f"{prof['wall_ms']:.3f} ms, device busy "
                  f"{prof['busy_ms']:.3f} ms")
    stall = {n: snap.get(f"serving/dispatch_stall_ms/{n}") or {}
             for n in SERVE_CLIENTS}
    workers = collections.Counter(name for name, _ in seen["calls"])
    streams = {s for _, s in seen["calls"]}
    print(f"[serve] pipeline depth (batches in flight at dispatch, limit "
          f"{srv.tenant('attn').pipeline_depth}) over "
          f"{depth_sum.get('count', 0)} batches: mean "
          f"{depth_sum.get('mean', 0):.3f} max {depth_sum.get('max', 0):g}; "
          f"the last 2048: {dict(sorted(depths.items()))}; dispatch stall "
          f"p50 " + ", ".join(f"{n} {stall[n].get('p50', 0):.3f} ms"
                              for n in SERVE_CLIENTS))
    print(f"[serve] launches in the window {launches} against "
          f"{batches['attn']} attn batches; K1 launched from threads "
          f"{dict(workers)} on stream(s) {sorted(streams)} (the caller's "
          f"current stream {main_stream}); peak memory {peak:.3f} GiB; "
          f"compiles {stats['compiles']}, steady_compiles "
          f"{stats['steady_compiles']}; {card}")
    bad = {n: per[n]["bad"][:5] for n in SERVE_CLIENTS if per[n]["bad"]}
    check(not bad, f"served answers disagree with the Predictor: {bad}")
    lonely = [(n, b) for n in SERVE_CLIENTS for b in SERVE_BUCKETS[n]
              if b > 1 and not per[n]["multi"][b]]
    check(not lonely, f"no batch of several requests in buckets {lonely}")
    check(stats["steady_compiles"] == 0 and all(
        m.steady_compiles == 0 for m in models.values()),
        "steady compiles after freeze")
    check(launches["flash_fwd"] == batches["attn"] > 0,
          "K1 did not launch once an attn batch")
    check(launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == 0,
          "K2 or K3 launched while serving")
    check(set(workers) == {"pt-serve-attn"} and streams == {main_stream},
          "K1 launched off the attn worker or off the caller's stream")
    check(set(seen["inputs"]) == set(SERVE_BUCKETS["attn"]),
          f"K1 saw batch sizes {sorted(seen['inputs'])}")
    serve_k1_check(fa, seen["inputs"])
    return served, boot


def phase_serve_restart(tpt, dev, paths, workdir, served, cold):
    """A second server on phase serve's cache directory: every bucket
    warm-loads and nothing is compiled; it answers, alone, a request of
    each tenant that phase serve answered first in its batch, in the
    bucket such a request selects alone, with the same bits. Prints
    add_tenant's time here against phase serve's (``cold``), and the two
    costs a warm boot trades: the params digest its cache key needs and
    the shape probes the cache entries save."""
    from paddle_tpu_torch.serving import PredictorServer
    from paddle_tpu_torch.serving.buckets import signature_of
    from paddle_tpu_torch.serving.model import _params_digest
    tpt.set_device(dev)
    srv = PredictorServer(cache_dir=f"{workdir}/cache", max_linger_ms=0.0)
    models, warm = _serve_tenants(srv, paths)
    srv.start()
    try:
        again = {}
        for name, model in models.items():
            feed, first = next(
                (f, g) for n, f, g, b, start in served
                if n == name and start == 0 and
                model.policy.select(signature_of(f)).batch == b)
            again[name] = (srv.predict(name, feed, timeout=300)[0], first)
    finally:
        srv.stop()
    stats = srv.stats()
    digest, probe = {}, {}
    for name, model in models.items():
        t0 = time.perf_counter()
        _params_digest(model._params)
        digest[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for b in model.policy.buckets:
            model._probe(b)
        probe[name] = time.perf_counter() - t0
    print("[serve_restart] " + ", ".join(
        f"{n}: warm_loads {m.warm_loads} compiles {m.compiles}"
        for n, m in models.items())
        + f"; compiles in the store {stats['compiles']}; a repeated "
        f"request " + ", ".join(
            f"{n} {'equals' if np.array_equal(*a) else 'DIFFERS FROM'} "
            f"phase serve's answer" for n, a in again.items()))
    for n in models:
        print(f"[serve_restart] {n}: add_tenant warm {warm[n]:.3f} s, cold "
              f"{cold[n]:.3f} s (phase serve); of which both pay the params "
              f"digest, {digest[n]:.3f} s, and a cold boot the shape probes "
              f"of its {len(models[n].policy.buckets)} buckets, "
              f"{probe[n]:.3f} s")
    check(all(m.warm_loads == len(m.policy.buckets) and m.compiles == 0
              for m in models.values()), "the restart compiled")
    check(all(np.array_equal(*a) for a in again.values()),
          "the restarted server answers differently")



# ---------------------------------------------------- the eager tensor API
EAGER_BERT = dict(batch=16, seq=128, warmup=2, steps=5, lr=1e-4)
# the styles of the steps after the warm-up: 2.0 (backward, step,
# clear_grad) then 1.x (minimize, clear_gradients under dygraph.guard)
EAGER_STYLES = ("2.0", "2.0", "1.x", "1.x", "1.x")
# eager against TrainStep O0: the same kernels on the same inputs in the
# same order (TrainStep runs loss.backward() and the optimizer's own
# functional_step, as opt.step() does), so the losses are expected equal
# bit for bit; the bound leaves room for one reordered reduction
EAGER_VS_TRAINSTEP_RTOL = 1e-6
# paddle.grad and backward() walk the same graph: equal, expected bit for
# bit, held within 1e-6 of the gradient's largest element
EAGER_GRAD_RTOL = 1e-6


def port_eager_api():
    """The port's eager surface as the user script below takes it (the CPU
    test hands it the JAX package's)."""
    import types
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.text.models import BertForPretraining
    return types.SimpleNamespace(pt=pt, to_tensor=pt.to_tensor, grad=pt.grad,
                                 dygraph=dygraph, Momentum=Momentum,
                                 Bert=BertForPretraining)


def eager_batches(n, batch, seq, vocab, seed=0):
    """bench.py's synthetic batches from seeded numpy: int32 ids, 15% MLM
    labels (-1 elsewhere, at least one a row) and an NSP label."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rs.randint(0, vocab, (batch, seq)).astype(np.int32)
        labels = np.where(rs.rand(batch, seq) < 0.15, ids, -1).astype(
            np.int32)
        labels[:, 0] = ids[:, 0]
        out.append((ids, labels, rs.randint(0, 2, (batch, 1)).astype(
            np.int32)))
    return out


def eager_step(api, model, opt, batch, style, grad_of=None):
    """One training step written as Paddle users write eager training:
    ``to_tensor`` of the numpy batch, the loss, then ``loss.backward();
    opt.step(); opt.clear_grad()`` (style "2.0") or, under
    ``dygraph.guard()``, ``opt.minimize(loss); model.clear_gradients()``
    (style "1.x"). With ``grad_of`` (a parameter, 2.0 style) it first
    takes ``paddle.grad(loss, [grad_of], retain_graph=True)`` and returns
    it beside ``grad_of.gradient()`` from the backward on the same
    graph."""
    ids, labels, nsp = (api.to_tensor(a) for a in batch)
    if style == "1.x":
        with api.dygraph.guard():
            loss = model(ids, masked_lm_labels=labels,
                         next_sentence_label=nsp)
            opt.minimize(loss)
            model.clear_gradients()
        return loss, None
    loss = model(ids, masked_lm_labels=labels, next_sentence_label=nsp)
    pair = None
    if grad_of is not None:
        (g,) = api.grad(loss, [grad_of], retain_graph=True)
    loss.backward()
    if grad_of is not None:
        pair = (g.numpy(), grad_of.gradient())
    opt.step()
    opt.clear_grad()
    return loss, pair


def phase_eager_bert(tpt, fa, dev):
    """The main path of the eager slice: BERT-base (text.models widths,
    dropout 0) trained in fp32 at O0 through the eager tape, as a user
    script writes it (eager_step), at batch 16, seq 128: 2 warm-up steps,
    5 timed ones (2.0 then 1.x style), one step that also takes
    paddle.grad of the word embeddings, one profiled step; then the same
    batches through jit.TrainStep(amp_level="O0") from the same weights;
    then save_dygraph / load_dygraph into a fresh model."""
    from paddle_tpu_torch.jit import TrainStep
    cfg = EAGER_BERT
    api = port_eager_api()
    tpt.set_device(dev)
    tpt.seed(0)
    t0 = time.perf_counter()
    model = api.Bert(dropout=0.0)
    state0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = api.Momentum(learning_rate=cfg["lr"], momentum=0.9,
                       parameters=model.parameters())
    n_steps = cfg["warmup"] + cfg["steps"] + 1
    vocab = model.bert.embeddings.word.weight.shape[0]
    batches = eager_batches(n_steps + 2, cfg["batch"], cfg["seq"], vocab)
    styles = ["2.0"] * cfg["warmup"] + list(EAGER_STYLES) + ["2.0"]
    word = model.bert.embeddings.word.weight
    torch.cuda.synchronize()
    print(f"[eager_bert] BERT-base fp32 O0, built in "
          f"{time.perf_counter() - t0:.1f} s; step styles {styles}")
    for w in fa.WRAPPERS:
        w.launches = 0
    fa.blockwise_route.calls = 0
    torch.cuda.reset_peak_memory_stats()
    losses, pair = [], None
    for i in range(cfg["warmup"]):
        losses.append(eager_step(api, model, opt, batches[i], styles[i])[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(cfg["warmup"], cfg["warmup"] + cfg["steps"]):
        losses.append(eager_step(api, model, opt, batches[i], styles[i])[0])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / cfg["steps"]
    loss, pair = eager_step(api, model, opt, batches[n_steps - 1], "2.0",
                            grad_of=word)
    losses.append(loss)
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in fa.WRAPPERS}
    calls = fa.blockwise_route.calls
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(x.numpy()) for x in losses]
    prof = profile_call(lambda: losses.append(float(eager_step(
        api, model, opt, batches[n_steps], "2.0")[0].numpy())))
    g, wgrad = pair
    print(f"[eager_bert] losses {losses}")
    print(f"[eager_bert] step_ms {step_s * 1e3:.3f}  samples/s "
          f"{cfg['batch'] / step_s:.2f}  peak_mem {peak:.3f} GiB")
    print(f"[eager_bert] one profiled step: {prof['launches']} kernel "
          f"launches, {prof['syncs']} host syncs (cudaStreamSynchronize), "
          f"device busy {prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} ms "
          f"(idle share {1 - prof['busy_ms'] / prof['wall_ms']:.3f}); CUDA "
          f"runtime calls: " + ", ".join(
              f"{k} {v}" for k, v in prof["runtime"].most_common(6)))
    print(f"[eager_bert] launches over {n_steps} steps: {launches} "
          f"(expected K1 {12 * n_steps}, K2 and K3 {12 * n_steps + 12}: the "
          f"paddle.grad step runs a second backward); blockwise-route "
          f"calls {calls}")
    gerr = float(np.abs(g - wgrad).max())
    print(f"[eager_bert] paddle.grad of the word embeddings against its "
          f".gradient() from backward on the same graph: max abs diff "
          f"{gerr:.3e} (|grad| max {float(np.abs(wgrad).max()):.3e})")
    check(all(math.isfinite(x) for x in losses), "non-finite loss")
    check(abs(losses[0] - (math.log(vocab) + math.log(2))) < 2.0,
          "first loss far from ln(vocab) + ln(2)")
    check(launches == {"flash_fwd": 12 * n_steps,
                       "flash_bwd_dq": 12 * n_steps + 12,
                       "flash_bwd_dkv": 12 * n_steps + 12} and calls == 0,
          "K1-K3 not launched once a layer a pass, or the plain versions "
          "ran")
    check(g.shape == wgrad.shape and gerr <= EAGER_GRAD_RTOL * float(
        np.abs(wgrad).max()), "paddle.grad differs from backward's gradient")
    params = word.numpy()
    check(params.dtype == np.float32 and np.isfinite(params).all(),
          "param.numpy() on the card")

    # the same batches through TrainStep O0 from the same weights
    ref = api.Bert(dropout=0.0)
    ref.set_state_dict(state0)
    train = TrainStep(ref, step_fn, api.Momentum(
        learning_rate=cfg["lr"], momentum=0.9,
        parameters=ref.parameters()), amp_level="O0").ensure_state()
    want = [float(train(*batches[i]).numpy())
            for i in range(cfg["warmup"])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = [train(*batches[i]) for i in range(cfg["warmup"],
                                              cfg["warmup"] + cfg["steps"])]
    torch.cuda.synchronize()
    ts_s = (time.perf_counter() - t0) / cfg["steps"]
    want += [float(x.numpy()) for x in out]
    want += [float(train(*batches[i]).numpy())
             for i in range(n_steps - 1, n_steps + 1)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    print(f"[eager_bert] TrainStep O0 losses {want}")
    print(f"[eager_bert] TrainStep O0 step_ms {ts_s * 1e3:.3f} (eager "
          f"{step_s * 1e3:.3f}: {step_s / ts_s:.3f}x); losses eager against "
          f"TrainStep: {'equal bit for bit' if losses == want else 'DIFFER'}"
          f", max relative difference {rel:.3e} (bound "
          f"{EAGER_VS_TRAINSTEP_RTOL:g})")
    check(rel <= EAGER_VS_TRAINSTEP_RTOL, "eager losses off TrainStep's")

    # save_dygraph / load_dygraph into a fresh model: the next loss
    path = "build/eager_bert/params"
    api.dygraph.save_dygraph(model.state_dict(), path)
    state, _ = api.dygraph.load_dygraph(path)
    fresh = api.Bert(dropout=0.0)
    missing = fresh.set_state_dict(state)
    nxt = tuple(api.to_tensor(a) for a in batches[n_steps + 1])
    with api.dygraph.no_grad():
        a = model(nxt[0], masked_lm_labels=nxt[1], next_sentence_label=nxt[2])
        b = fresh(nxt[0], masked_lm_labels=nxt[1], next_sentence_label=nxt[2])
    print(f"[eager_bert] save_dygraph / load_dygraph: {len(state)} tensors, "
          f"missing {missing}; next loss {float(a.numpy())!r} original, "
          f"{float(b.numpy())!r} reloaded; {card_line()}")
    check(not missing and torch.equal(a, b),
          "the reloaded model's loss differs")
    shutil.rmtree("build/eager_bert", ignore_errors=True)
    return launches


@contextlib.contextmanager
def case_env(case, device):
    """A case's surroundings in the port on ``device``: its setup done,
    its Program published as the executing one, its ``{tmp}`` attrs
    resolved to a directory under build/ (yielded: the attrs)."""
    import importlib
    import os
    from paddle_tpu_torch.core.executor import program_ctx
    from paddle_tpu_torch.core.program import Program
    from paddle_tpu_torch.device import op_device
    tmp = os.path.abspath(os.path.join("build", "op_cases",
                                       torch.device(device).type))
    os.makedirs(tmp, exist_ok=True)
    if getattr(case, "setup", None) is not None:
        case.setup(lambda m: importlib.import_module(
            "paddle_tpu_torch.ops." + m), tmp)
    attrs = {k: v.replace("{tmp}", tmp) if isinstance(v, str) else v
             for k, v in case.attrs.items()}
    with contextlib.ExitStack() as stack:
        stack.enter_context(op_device(device))
        if getattr(case, "program", None) is not None:
            stack.enter_context(program_ctx(Program.from_json(case.program)))
        yield attrs


def _op_case_run(case, device):
    """One case of op_cases (or nn_cases, cf_cases) through the port's op
    on ``device``: its outputs and (``grad``) the gradients for seeded
    cotangents on its float outputs, all moved to the CPU."""
    from paddle_tpu_torch.core.registry import OpInfoMap, generic_vjp_grad
    opdef = OpInfoMap.instance().get(case.op)
    ins = {s: [torch.from_numpy(np.array(v)).to(device) for v in vs]
           for s, vs in case.inputs.items()}
    with case_env(case, device) as attrs:
        outs = opdef.compute(ins, dict(attrs))
        grads = {}
        if case.grad:
            rs = np.random.RandomState(99)
            cts = {s: [torch.from_numpy(np.asarray(
                rs.randn(*v.shape), np.float32)).to(device) for v in vs]
                for s, vs in outs.items()
                if s not in opdef.intermediate_outputs and s != "XShape"
                and any(v.is_floating_point() for v in vs)}
            grads = generic_vjp_grad(opdef, ins, {}, cts, dict(attrs))
    cpu = {s: [v.detach().cpu() for v in vs] for s, vs in outs.items()}
    cpu.update({"d" + s: [v.cpu() for v in vs if v is not None]
                for s, vs in grads.items()})
    return cpu


def hold_cases(cases, dev, worst):
    """Each op case (op_cases' or nn_cases') on the card against the port
    on the CPU: integer and bool outputs equal, float ones and the
    gradients at the case's bound ("draws" cases too: the port draws on
    the CPU and moves), random ones by their draws and range, empty by
    shape and dtype; the largest float errors go into ``worst``. Returns
    the op types seen."""
    types_seen = set()
    for case in cases:
        card, cpu = _op_case_run(case, dev), _op_case_run(case, "cpu")
        check(set(card) == set(cpu), f"{case.id}: slots differ")
        for slot, wants in cpu.items():
            check(len(card[slot]) == len(wants), f"{case.id}.{slot}")
            for got, want in zip(card[slot], wants):
                what = f"{case.id}.{slot}"
                check(got.shape == want.shape and got.dtype == want.dtype,
                      f"{what}: {got.shape} {got.dtype} on the card, "
                      f"{want.shape} {want.dtype} on the CPU")
                if case.kind == "shape":
                    continue
                if case.kind == "random":
                    check(torch.equal(got, want) and
                          case.check(want.numpy()), f"{what}: draws")
                elif want.is_floating_point():
                    rtol, atol = case.grad_tol if slot.startswith("d") \
                        else case.tol
                    ok = torch.allclose(got, want, rtol=rtol, atol=atol,
                                        equal_nan=True)
                    err = (got - want).abs().nan_to_num().max().item() \
                        if want.numel() else 0.0
                    worst[what] = err
                    check(ok, f"{what}: max abs {err:.3e} past rtol {rtol:g}"
                              f" atol {atol:g}")
                else:
                    check(torch.equal(got, want), f"{what} differs")
        types_seen.add(case.op)
    return types_seen


def phase_tensor_api(dev):
    """Every op type the 2.0 tensor API brought (153) on the card against
    the port on the CPU, at the CPU tests' shapes (op_cases), TF32 off:
    integer and bool outputs equal, float ones and the gradients at each
    case's bound; random ops draw on the CPU and move, so their draws
    are equal too, and each is held by its range and moments; empty by
    shape and dtype. Host syncs of the ops whose output length depends
    on the data are counted."""
    from paddle_tpu_torch.testing.op_cases import CASES
    worst = {}
    types_seen = hold_cases(CASES, dev, worst)
    sized_by_data = ("where_index", "masked_select", "unique",
                     "unique_with_counts")
    syncs = op_syncs([next(c for c in CASES if c.op == t)
                      for t in sized_by_data], dev)
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    print(f"[tensor_api] {len(CASES)} cases of {len(types_seen)} op types "
          f"on the card against the CPU: all agree; largest float errors "
          + ", ".join(f"{k} {v:.2e}" for k, v in top)
          + f"; host syncs of one call on inputs already on the card "
          f"{syncs}")
    check(len(types_seen) == 153, f"{len(types_seen)} op types checked")


def op_syncs(cases, dev):
    """Host syncs (cudaStreamSynchronize) of one call of each case's op
    on inputs already on the card, after a first call (which fills the
    per-device caches), by op type, from one profiled run of them all."""
    from paddle_tpu_torch.core.registry import OpInfoMap
    from paddle_tpu_torch.device import op_device
    ops = OpInfoMap.instance()
    calls = [(case.op, {s: [torch.from_numpy(np.array(v)).to(dev)
                            for v in vs] for s, vs in case.inputs.items()},
              case.attrs) for case in cases]
    with op_device(dev):
        for op, ins, attrs in calls:
            ops.get(op).compute(ins, dict(attrs))
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with op_ranges(), torch.profiler.profile(activities=acts) as prof:
            for op, ins, attrs in calls:
                ops.get(op).compute(ins, dict(attrs))
            torch.cuda.synchronize()
    syncs = collections.Counter(
        kernel_op(e) for e in prof.events()
        if e.name == "cudaStreamSynchronize" and kernel_op(e))
    return {t: syncs.get(t, 0) for t in sorted({c.op for c in cases})}


def phase_nn_api(dev):
    """The 63 op types the rest of paddle.nn brought (nn_ops, loss_ops,
    vision_ops, four of long_tail_ops), every case of nn_cases on the
    card against the port on the CPU, forward and gradient, index
    outputs (max_pool*_with_index's Mask, on tied maxima too) equal;
    then the host syncs of one call of each type."""
    from paddle_tpu_torch.testing.nn_cases import NN_CASES
    worst = {}
    types_seen = hold_cases(NN_CASES, dev, worst)
    syncs = op_syncs(NN_CASES, dev)
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    print(f"[nn_api] {len(NN_CASES)} cases of {len(types_seen)} op types "
          f"on the card against the CPU: all agree; largest float errors "
          + ", ".join(f"{k} {v:.2e}" for k, v in top)
          + "; host syncs of one call on inputs already on the card: "
          + (", ".join(f"{t} {n}" for t, n in syncs.items() if n)
             or "none") + f" (0 for the other {sum(1 for n in syncs.values() if not n)} types)")
    check(len(types_seen) == 63, f"{len(types_seen)} op types checked")


def _layer_run(model, inputs, call, device):
    """``model(*inputs)`` (or ``call(F, *inputs)``) on ``device``: the
    outputs and the gradients of sum(out * G), G seeded, of every
    parameter and float input, all on the CPU."""
    from paddle_tpu_torch.nn import functional as F
    ts = [torch.from_numpy(x.copy()).to(device).requires_grad_(
        np.issubdtype(x.dtype, np.floating)) for x in inputs]
    outs = model(*ts) if model is not None else call(F, *ts)
    outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    while any(isinstance(o, (list, tuple)) for o in outs):
        outs = [v for o in outs for v in
                (o if isinstance(o, (list, tuple)) else [o])]
    total = None
    for k, o in enumerate(outs):
        if o.is_floating_point() and o.requires_grad:
            g = torch.from_numpy(np.asarray(np.random.RandomState(
                99 + k).randn(*o.shape), np.float32)).to(device)
            term = (o * g).sum()
            total = term if total is None else total + term
    grads = {}
    if total is not None:
        total.backward()
        named = list(model.named_parameters()) if model is not None else []
        grads = {n: p.grad for n, p in named if p.grad is not None}
        grads.update({f"input {k}": t.grad for k, t in enumerate(ts)
                      if t.grad is not None})
    return ([o.detach().cpu() for o in outs],
            {k: v.cpu() for k, v in grads.items()})


def phase_nn_layers(tpt, dev):
    """One forward and backward of each nn class and nn.functional
    function of the slice (nn_cases' LAYER_CASES and FUNC_CASES, the CPU
    tests' sizes) on the card against the CPU from the same weights:
    outputs at rtol 1e-4 / atol 2e-5 and gradients at 1e-4 of their
    largest element (the CPU test's bounds against the JAX package)."""
    import types
    from paddle_tpu_torch import dygraph, nn
    from paddle_tpu_torch.convert import load_state_dict
    from paddle_tpu_torch.testing.nn_cases import FUNC_CASES, LAYER_CASES
    api = types.SimpleNamespace(nn=nn, dygraph=dygraph)
    worst = {}

    def hold(name, card, cpu):
        (co, cg), (wo, wg) = card, cpu
        check(len(co) == len(wo) and set(cg) == set(wg),
              f"{name}: outputs or gradients differ in number")
        for k, (got, want) in enumerate(zip(co, wo)):
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"{name} out {k}: {got.shape} {got.dtype} against "
                  f"{want.shape} {want.dtype}")
            if want.is_floating_point():
                check(torch.allclose(got, want, rtol=1e-4, atol=2e-5),
                      f"{name} out {k}: max abs "
                      f"{(got - want).abs().max().item():.3e}")
            else:
                check(torch.equal(got, want), f"{name} out {k} differs")
        for g, want in wg.items():
            err = ((cg[g] - want).abs().max() /
                   want.abs().max().clamp_min(1e-12)).item()
            worst[f"{name} d{g}"] = err
            check(err <= 1e-4, f"{name} d{g}: {err:.3e} of the largest")

    for name, make, inputs in LAYER_CASES:
        tpt.set_device("cpu")
        tpt.seed(0)
        cpu_model = make(api)
        want = _layer_run(cpu_model, inputs, None, "cpu")
        tpt.set_device(dev)
        card_model = load_state_dict(make(api), {
            k: v.detach().numpy() for k, v in cpu_model.state_dict().items()})
        hold(name, _layer_run(card_model, inputs, None, dev), want)
    for name, inputs, call in FUNC_CASES:
        tpt.set_device("cpu")
        want = _layer_run(None, inputs, call, "cpu")
        tpt.set_device(dev)
        hold(name, _layer_run(None, inputs, call, dev), want)
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:4]
    print(f"[nn_layers] {len(LAYER_CASES)} layer cases and "
          f"{len(FUNC_CASES)} function cases, forward and backward on the "
          f"card against the CPU: all agree; largest gradient errors (of "
          f"the largest element) " + ", ".join(f"{k} {v:.2e}"
                                              for k, v in top))


# ------------------------------------------------------------ CycleGAN
# the CycleGAN paper's (Zhu et al., ICCV 2017, appendix 7.2) widths and
# schedule, as PaddleCV/gan's CycleGAN trains it: 256 px, batch 1, Adam
# 2e-4 (0.5, 0.999), lambda 10, identity 0.5 lambda
CYCLEGAN = dict(ngf=64, ndf=64, blocks=9, px=256, batch=1, lr=2e-4,
                beta1=0.5, beta2=0.999, lam=10.0)


def cyclegan_nets(nn, ngf=64, ndf=64, blocks=9):
    """CycleGAN's two ResNet generators (c7s1-ngf, d2ngf, d4ngf, R4ngf x
    blocks, u2ngf, ungf, c7s1-3 and Tanh; reflection padding, instance
    norm) and two 70x70 PatchGAN discriminators (C ndf without norm, then
    2, 4, 8 ndf with instance norm, LeakyReLU(0.2), a last 4x4 conv to one
    channel), as a user writes them against ``nn`` (either package's).
    Weights are N(0, 0.02). A conv followed by instance norm has no bias:
    the norm subtracts each channel's mean, so such a bias has an exact
    gradient of 0 and never trains. Each block is built anew, so every
    parameter has a name of its own (the JAX package's eager optimizer
    keys its state by name)."""
    def attr():
        return nn.ParamAttr(initializer=nn.initializer.Normal(0.0, 0.02))

    def conv(cin, cout, k, stride=1, padding=0, bias=False):
        return nn.Conv2D(cin, cout, k, stride=stride, padding=padding,
                         weight_attr=attr(),
                         bias_attr=None if bias else False)

    def c_in_relu(cin, cout, k, **kw):
        return [conv(cin, cout, k, **kw), nn.InstanceNorm2D(cout), nn.ReLU()]

    class ResBlock(nn.Layer):
        def __init__(self, dim):
            super().__init__()
            self.body = nn.Sequential(
                nn.ReflectionPad2d(1), *c_in_relu(dim, dim, 3),
                nn.ReflectionPad2d(1), conv(dim, dim, 3),
                nn.InstanceNorm2D(dim))

        def forward(self, x):
            return x + self.body(x)

    def generator():
        layers = [nn.ReflectionPad2d(3), *c_in_relu(3, ngf, 7),
                  *c_in_relu(ngf, 2 * ngf, 3, stride=2, padding=1),
                  *c_in_relu(2 * ngf, 4 * ngf, 3, stride=2, padding=1)]
        layers += [ResBlock(4 * ngf) for _ in range(blocks)]
        for cin, cout in ((4 * ngf, 2 * ngf), (2 * ngf, ngf)):
            layers += [nn.Conv2DTranspose(cin, cout, 3, stride=2, padding=1,
                                          output_padding=1,
                                          weight_attr=attr(),
                                          bias_attr=False),
                       nn.InstanceNorm2D(cout), nn.ReLU()]
        layers += [nn.ReflectionPad2d(3), conv(ngf, 3, 7, bias=True),
                   nn.Tanh()]
        return nn.Sequential(*layers)

    def discriminator():
        layers = [conv(3, ndf, 4, stride=2, padding=1, bias=True),
                  nn.LeakyReLU(0.2)]
        ch = ndf
        for stride in (2, 2, 1):
            layers += [conv(ch, 2 * ch, 4, stride=stride, padding=1),
                       nn.InstanceNorm2D(2 * ch), nn.LeakyReLU(0.2)]
            ch *= 2
        layers.append(conv(ch, 1, 4, padding=1, bias=True))
        return nn.Sequential(*layers)

    return generator(), generator(), discriminator(), discriminator()


def cyclegan_opts(api, nets, lr=2e-4, beta1=0.5, beta2=0.999):
    """Adam over both generators and Adam over both discriminators."""
    g_a, g_b, d_a, d_b = nets
    return (api.Adam(learning_rate=lr, beta1=beta1, beta2=beta2,
                     parameters=g_a.parameters() + g_b.parameters()),
            api.Adam(learning_rate=lr, beta1=beta1, beta2=beta2,
                     parameters=d_a.parameters() + d_b.parameters()))


def cyclegan_images(rs, batch, px):
    """A batch of each domain: seeded normal noise clipped to [-1, 1]."""
    return [np.clip(rs.randn(batch, 3, px, px), -1.0, 1.0).astype(np.float32)
            for _ in range(2)]


def cyclegan_step(api, nets, opts, real_a, real_b, lam=10.0):
    """One CycleGAN training step as a user writes it eagerly: G_A maps A
    to B and G_B back, D_A judges B and D_B judges A. The generators'
    loss (LSGAN adversarial terms on their fakes, cycle L1 x lam,
    identity L1 x lam / 2: six generator forwards), backward, the G
    update; the gradients that loss left on the discriminators dropped;
    then each discriminator on real images and on the detached fakes
    (LSGAN, halved), backward, the D update. Returns the losses
    (adversarial, cycle, identity, discriminators)."""
    g_a, g_b, d_a, d_b = nets
    opt_g, opt_d = opts
    mse, l1 = api.nn.MSELoss(), api.nn.L1Loss()
    fake_b, fake_a = g_a(real_a), g_b(real_b)
    rec_a, rec_b = g_b(fake_b), g_a(fake_a)
    idt_b, idt_a = g_a(real_b), g_b(real_a)
    pred_b, pred_a = d_a(fake_b), d_b(fake_a)
    adv = mse(pred_b, api.ones_like(pred_b)) + \
        mse(pred_a, api.ones_like(pred_a))
    cyc = (l1(rec_a, real_a) + l1(rec_b, real_b)) * lam
    idt = (l1(idt_b, real_b) + l1(idt_a, real_a)) * (0.5 * lam)
    (adv + cyc + idt).backward()
    opt_g.step()
    opt_g.clear_grad()
    opt_d.clear_grad()
    halves = []
    for d, real, fake in ((d_a, real_b, fake_b.detach()),
                          (d_b, real_a, fake_a.detach())):
        p_real, p_fake = d(real), d(fake)
        halves.append((mse(p_real, api.ones_like(p_real)) +
                       mse(p_fake, api.zeros_like(p_fake))) * 0.5)
    d_loss = halves[0] + halves[1]
    d_loss.backward()
    opt_d.step()
    opt_d.clear_grad()
    return adv, cyc, idt, d_loss


def port_cyclegan_api():
    """The port's surface as cyclegan_step takes it (the CPU test hands it
    the JAX package's)."""
    import types
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.optimizer import Adam
    return types.SimpleNamespace(nn=nn, Adam=Adam, to_tensor=pt.to_tensor,
                                 ones_like=pt.ones_like,
                                 zeros_like=pt.zeros_like)


def cyclegan_state(nets):
    return [{k: v.detach().cpu().numpy().copy()
             for k, v in net.state_dict().items()} for net in nets]


def device_us_by_family(fn, families):
    """Device time (us) of the kernels that each family of aten ops
    launches in one call of fn, forward and backward, whatever the
    kernels are named (cuDNN's fp32 algorithms include FFT and Winograd
    ones). ``families`` maps a name to substrings of op names
    ("convolution" matches aten::convolution and
    aten::convolution_backward); a kernel goes to the family of its
    nearest matching op, or to "other"."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    total = dict.fromkeys([*families, "other"], 0.0)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        parent, fam = e, None
        while parent is not None and fam is None:
            fam = next((f for f, keys in families.items()
                        if any(k in parent.name for k in keys)), None)
            parent = parent.cpu_parent
        total[fam or "other"] += sum(k.duration for k in e.kernels)
    return total


def conv_device_us(fn):
    """Device time (us) of the kernels that convolution ops launch in one
    call of fn, forward and backward."""
    return device_us_by_family(fn, {"conv": ("convolution",)})["conv"]


def phase_cyclegan(tpt, dev):
    """The main path of this slice: CycleGAN (cyclegan_nets at the paper's
    widths, 9 blocks, 256 px, batch 1, fp32 NCHW, TF32 off,
    cudnn.benchmark on) trained by the eager user script cyclegan_step.
    The four networks are built from seed 0 on the CPU and carried to
    the card; the first step's
    losses on the card against the port on the CPU from the same weights
    and images (rtol 1e-3: some forty fp32 convolutions deep, cuDNN and
    the CPU's kernels sum in other orders, about 1e-5 of a loss; a wrong
    pad, norm or output_padding moves a loss by far more); the same step
    run twice on the card from the same state, equal bits or not (the
    update difference between the runs printed); each network's first
    update on the card within 0.15 of the CPU's (see the check); then
    2 warm-up and 5 timed steps (host clock, each ending in a
    synchronize), losses finite and every parameter
    moved; one profiled step: launches, host syncs, device busy and
    idle, device time of the forward conv2d_transpose, instance_norm and
    conv2d ops and of the step's convolution kernels."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.convert import load_state_dict
    cfg = CYCLEGAN
    api = port_cyclegan_api()
    rs = np.random.RandomState(0)
    batches = [cyclegan_images(rs, cfg["batch"], cfg["px"]) for _ in range(2)]

    def build(device, state):
        tpt.set_device(device)
        nets = cyclegan_nets(nn, cfg["ngf"], cfg["ndf"], cfg["blocks"])
        for net, st in zip(nets, state):
            load_state_dict(net, st)
        return nets, cyclegan_opts(api, nets, cfg["lr"], cfg["beta1"],
                                   cfg["beta2"])

    def step(nets, opts, images, device):
        a, b = (torch.from_numpy(x).to(device) for x in images)
        return [v.detach() for v in
                cyclegan_step(api, nets, opts, a, b, cfg["lam"])]

    tpt.set_device("cpu")
    tpt.seed(0)
    start = cyclegan_state(cyclegan_nets(nn, cfg["ngf"], cfg["ndf"],
                                         cfg["blocks"]))
    n_params = [sum(v.size for v in st.values()) for st in start]
    t0 = time.perf_counter()
    cpu_nets, cpu_opts = build("cpu", start)
    want = [v.item() for v in step(cpu_nets, cpu_opts, batches[0], "cpu")]
    cpu_s = time.perf_counter() - t0
    cpu_after = cyclegan_state(cpu_nets)
    del cpu_nets, cpu_opts
    names = ("adversarial", "cycle", "identity", "discriminators")
    # on from the first card step: torch keeps the first cuDNN plan it
    # makes for a shape, so a step with benchmark off first would leave
    # the heuristics' plans in place for the timed steps (an FFT
    # algorithm whose complex gemv took 100 ms a step)
    torch.backends.cudnn.benchmark = True
    runs = []
    for _ in range(2):
        nets, opts = build(dev, start)
        got = [v.item() for v in step(nets, opts, batches[0], dev)]
        runs.append((got, cyclegan_state(nets)))
    got, after = runs[0]
    rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    print(f"[cyclegan] parameters: G {n_params[0]:,} each, D {n_params[2]:,}"
          f" each; first step's losses on the card against the CPU (CPU "
          f"step {cpu_s:.1f} s): " + ", ".join(
              f"{n} {g!r} / {w!r} (rel {r:.2e})"
              for n, g, w, r in zip(names, got, want, rel)))
    check(all(r <= 1e-3 for r in rel), "the card's first-step losses differ "
          "from the CPU's past rtol 1e-3")

    def update_diffs(other):
        """Each network's ||update - other's update|| / ||update|| over
        all its parameters, and the worst single tensor's."""
        nets_err, worst = [], (0.0, "")
        for i, (x, y, s0) in enumerate(zip(after, other, start)):
            num = sum(float(np.sum((x[k] - y[k]) ** 2)) for k in x)
            den = sum(float(np.sum((x[k] - s0[k]) ** 2)) for k in x)
            nets_err.append((num / max(den, 1e-30)) ** 0.5)
            for k in x:
                e = update_error(torch.from_numpy(x[k]),
                                 torch.from_numpy(y[k]),
                                 torch.from_numpy(s0[k]))
                worst = max(worst, (e, f"{'GGDD'[i]}{'ABAB'[i]} {k}"))
        return nets_err, worst

    same_losses = runs[0][0] == runs[1][0]
    same_params = all(np.array_equal(x[k], y[k]) for x, y in
                      zip(runs[0][1], runs[1][1]) for k in x)
    twice, twice_worst = update_diffs(runs[1][1])
    vs_cpu, cpu_worst = update_diffs(cpu_after)
    print(f"[cyclegan] the first step twice on the card from the same state "
          f"(the same cuDNN plans): losses "
          f"{'equal' if same_losses else 'DIFFER'}, parameters "
          f"{'bit-equal' if same_params else 'not bit-equal'}; update "
          f"difference by network (G_A, G_B, D_A, D_B) between the runs "
          + ", ".join(f"{e:.2e}" for e in twice)
          + f" (worst tensor {twice_worst[1]} {twice_worst[0]:.2e}), card "
          f"against the CPU " + ", ".join(f"{e:.2e}" for e in vs_cpu)
          + f" (worst tensor {cpu_worst[1]} {cpu_worst[0]:.2e})")
    # Adam's first update is lr * g / (|g| + eps), about lr * sign(g) an
    # element: a gradient element within the rounding noise of 0 flips
    # its update between two summation orders (each flip 2 lr), so the
    # card is held to the CPU by each network's update difference, with
    # room for about 0.6% of the elements flipping; a wrong pad, norm or
    # optimizer term flips about half of them (a difference near 1.4)
    check(max(vs_cpu) <= 0.15, "the card's first update differs from the "
          "CPU's past 0.15 of a network's update")
    nets, opts = build(dev, start)
    it = iter(range(10 ** 6))

    def one():
        return step(nets, opts, batches[next(it) % 2], dev)

    losses = []
    times = _timed_steps(lambda: losses.append(one()), 2, 5)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(math.isfinite(v.item()) for ls in losses for v in ls),
          "a loss is not finite")
    now = cyclegan_state(nets)
    unmoved = [k for x, s in zip(now, start) for k in x
               if np.array_equal(x[k], s[k])]
    check(not unmoved, f"parameters not moved: {unmoved[:5]}")
    prof = profile_call(one)
    x = torch.from_numpy(batches[0][0]).to(dev)
    flops = 2 * 3 * 6 * (sum(conv_macs(nets[0], x)) +
                         sum(conv_macs(nets[2], x)))
    for net in nets:
        net.train()
    med = sorted(times)[len(times) // 2]
    conv_us = conv_device_us(one)
    torch.backends.cudnn.benchmark = False
    fwd = prof["by_op_ms"]
    print(f"[cyclegan] step_ms median {med:.3f} range {min(times):.3f}-"
          f"{max(times):.3f} over {len(times)} steps (2 warm-up), images/s "
          f"{2 * cfg['batch'] / med * 1e3:.3f} (an A and a B image a step), "
          f"peak memory {peak:.2f} GiB; conv FLOPs a step (6 G and 6 D "
          f"forwards' worth, x3 for the two gradients) {flops / 1e12:.3f} "
          f"TFLOP, {flops / med / 1e9:.2f} TFLOP/s; losses of the last step "
          + ", ".join(f"{n} {v.item():.5f}" for n, v in zip(names, losses[-1]))
          + f"; {card_line()}")
    print(f"[cyclegan] one profiled step: {prof['wall_ms']:.3f} ms, device "
          f"busy {prof['busy_ms']:.3f} ms (idle "
          f"{1 - prof['busy_ms'] / prof['wall_ms']:.3f}), launches "
          f"{prof['launches']}, host syncs {prof['syncs']}; forward device "
          f"ms by op (backward kernels run on autograd's thread, unlinked): "
          f"conv2d {fwd.get('conv2d', 0.0):.3f}, conv2d_transpose "
          f"{fwd.get('conv2d_transpose', 0.0):.3f}, instance_norm "
          f"{fwd.get('instance_norm', 0.0):.3f}, pad2d "
          f"{fwd.get('pad2d', 0.0):.3f}; convolution kernels of the whole "
          f"step (forward and both gradients) {conv_us / 1e3:.3f} ms; top "
          f"kernels " + ", ".join(f"{k[:60]} {v:.3f}"
                                  for k, v in prof["top_kernels"]))
    return med


# ------------------------------------------------------------ control flow
# tests/test_control_flow.py's programs, built by the same code in both
# packages (api: port_static_api() or the JAX package's namespace). Each
# builder returns dict(main, startup, feed, fetch, params): params are
# values to set in the scope after the startup run, by name.
def _cf_new(api):
    return api.static.Program(), api.static.Program()


def _name(v):
    return getattr(v, "name", v)


def cf_while_basic(api):
    st = api.static
    main, startup = _cf_new(api)
    with st.program_guard(main, startup):
        n = st.fill_constant([1], "int64", 10)
        i = st.fill_constant([1], "int64", 0)
        s = st.fill_constant([1], "float32", 0.0)
        i2, s2 = st.while_loop(lambda i, s: st.less_than(i, n),
                               lambda i, s: [i + 1, s + 2.0], [i, s])
    return dict(main=main, startup=startup, feed={},
                fetch=[i2.name, s2.name], params={})


def cf_while_nested(api):
    st = api.static
    main, startup = _cf_new(api)
    with st.program_guard(main, startup):
        n = st.fill_constant([1], "int64", 3)
        i = st.fill_constant([1], "int64", 0)
        s = st.fill_constant([1], "float32", 0.0)

        def outer_body(i, s):
            j = st.fill_constant([1], "int64", 0)
            _, s_in = st.while_loop(lambda j, s_: st.less_than(j, n),
                                    lambda j, s_: [j + 1, s_ + 1.0], [j, s])
            return [i + 1, s_in]

        _, s2 = st.while_loop(lambda i, s: st.less_than(i, n), outer_body,
                              [i, s])
    return dict(main=main, startup=startup, feed={}, fetch=[s2.name],
                params={})


def cf_while_grad(api, max_trip_count=8):
    """s = w * 2^5 through a while loop: ds/dw = 32. Bounded (the JAX
    package's masked scan) unless ``max_trip_count`` is None."""
    st = api.static
    main, startup = _cf_new(api)
    with st.program_guard(main, startup):
        w = st.create_parameter([1], "float32", name="w")
        n = st.fill_constant([1], "int64", 5)
        i = st.fill_constant([1], "int64", 0)
        s = st.assign(w)
        _, s2 = st.while_loop(lambda i, s: st.less_than(i, n),
                              lambda i, s: [i + 1, s * 2.0], [i, s],
                              max_trip_count=max_trip_count)
        loss = st.nn.mean(s2)
        pg = st.append_backward(loss, parameter_list=["w"], program=main)
    return dict(main=main, startup=startup, feed={},
                fetch=[loss.name, _name(pg[0][1])],
                params={"w": np.array([0.75], np.float32)})


def cf_while_block(api):
    """fluid's While mutating parent vars in place."""
    st = api.static
    main, startup = _cf_new(api)
    with st.program_guard(main, startup):
        limit = st.fill_constant([1], "int64", 4)
        i = st.fill_constant([1], "int64", 0)
        acc = st.fill_constant([1], "float32", 1.0)
        c = st.less_than(i, limit)
        w = st.While(c)
        with w.block():
            st.assign(acc * 3.0, acc)
            st.increment(i)
            st.less_than(i, limit, out=c)
    return dict(main=main, startup=startup, feed={},
                fetch=[acc.name, i.name], params={})


def cf_cond(api, pred_val):
    st = api.static
    main, startup = _cf_new(api)
    with st.program_guard(main, startup):
        x = st.fill_constant([2], "float32", 3.0)
        pred = st.fill_constant([1], "bool", pred_val)
        r = st.cond(pred, lambda: x * 2.0, lambda: x - 1.0)
    return dict(main=main, startup=startup, feed={}, fetch=[r.name],
                params={})


def cf_cond_grad(api):
    st = api.static
    main, startup = _cf_new(api)
    with st.program_guard(main, startup):
        w = st.create_parameter([2], "float32", name="w")
        pred = st.fill_constant([1], "bool", True)
        r = st.cond(pred, lambda: w * 5.0, lambda: w * 100.0)
        loss = st.nn.reduce_sum(r)
        pg = st.append_backward(loss, parameter_list=["w"], program=main)
    return dict(main=main, startup=startup, feed={},
                fetch=[_name(pg[0][1])],
                params={"w": np.array([0.5, -2.0], np.float32)})


def cf_cond_nan_untaken(api):
    """The untaken branch would give a NaN gradient (sqrt at -1): it
    must not reach w's."""
    st = api.static
    main, startup = _cf_new(api)
    with st.program_guard(main, startup):
        w = st.create_parameter([2], "float32", name="w")
        pred = st.fill_constant([1], "bool", True)
        r = st.cond(pred, lambda: w * 3.0,
                    lambda: st.nn.sqrt(w - 10.0))
        loss = st.nn.reduce_sum(r)
        pg = st.append_backward(loss, parameter_list=["w"], program=main)
    return dict(main=main, startup=startup, feed={},
                fetch=[r.name, _name(pg[0][1])],
                params={"w": np.array([0.5, -2.0], np.float32)})


def cf_case_chain(api):
    st = api.static
    main, startup = _cf_new(api)
    with st.program_guard(main, startup):
        x = st.fill_constant([1], "float32", 0.3)
        one = st.fill_constant([1], "float32", 1.0)
        two = st.fill_constant([1], "float32", 2.0)
        r = st.case([(st.greater_than(x, one), lambda: x * 10.0),
                     (st.less_than(x, two), lambda: x + 100.0)],
                    default=lambda: x * 0.0)
    return dict(main=main, startup=startup, feed={}, fetch=[r.name],
                params={})


def cf_switch_case(api, idx_val):
    """Index 0 and 1 pick their arm; any other (negative too) the
    default."""
    st = api.static
    main, startup = _cf_new(api)
    with st.program_guard(main, startup):
        x = st.fill_constant([2], "float32", 3.0)
        idx = st.fill_constant([1], "int32", idx_val)
        r = st.switch_case(idx, [lambda: x * 2.0, lambda: x * 10.0],
                           default=lambda: x * 0.0)
    return dict(main=main, startup=startup, feed={}, fetch=[r.name],
                params={})


def cf_static_rnn(api):
    st = api.static
    main, startup = _cf_new(api)
    with st.program_guard(main, startup):
        x = st.data("x", [4, 2, 3])
        h0 = st.fill_constant([2, 3], "float32", 1.0)
        rnn = st.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            h = rnn.memory(init=h0)
            nh = h * 0.5 + xt
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        hs = rnn()
    feed = {"x": np.random.RandomState(5).randn(4, 2, 3).astype(np.float32)}
    return dict(main=main, startup=startup, feed=feed, fetch=[hs.name],
                params={})


def cf_static_rnn_grad(api):
    """loss = sum_t h_t, h_t = h_{t-1} + w x_t: dw = sum_t (T - t) x_t."""
    st = api.static
    main, startup = _cf_new(api)
    with st.program_guard(main, startup):
        x = st.data("x", [4, 2, 1])
        w = st.create_parameter([1], "float32", name="w")
        h0 = st.fill_constant([2, 1], "float32", 0.0)
        rnn = st.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            h = rnn.memory(init=h0)
            nh = h + xt * w
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        hs = rnn()
        loss = st.nn.reduce_sum(hs)
        pg = st.append_backward(loss, parameter_list=["w"], program=main)
    feed = {"x": np.arange(8, dtype=np.float32).reshape(4, 2, 1)}
    return dict(main=main, startup=startup, feed=feed,
                fetch=[loss.name, _name(pg[0][1])],
                params={"w": np.array([1.5], np.float32)})


def cf_nmt_decode(api, vocab=7, hidden=5, max_len=6):
    """Greedy decode until EOS or max_len: embed the previous token,
    project, argmax (tests/book/test_machine_translation.py's shape)."""
    st = api.static
    rs = np.random.RandomState(0)
    emb_w = rs.randn(vocab, hidden).astype(np.float32)
    proj_w = rs.randn(hidden, vocab).astype(np.float32)
    main, startup = _cf_new(api)
    with st.program_guard(main, startup):
        emb = st.create_parameter([vocab, hidden], "float32", name="emb")
        proj = st.create_parameter([hidden, vocab], "float32", name="proj")
        bos = st.fill_constant([1], "int64", 1)
        eos = st.fill_constant([1], "int64", 0)
        step = st.fill_constant([1], "int64", 0)
        limit = st.fill_constant([1], "int64", max_len)
        tokens = st.fill_constant([max_len], "int64", 0)

        def cond_fn(step, tok, tokens):
            return st.logical_and(st.less_than(step, limit),
                                  st.not_equal(tok, eos))

        def body_fn(step, tok, tokens):
            logits = st.nn.matmul(st.nn.embedding_lookup(emb, tok), proj)
            nxt = st.nn.argmax(logits, axis=-1)
            return [step + 1, nxt, st.nn.scatter_write(tokens, step, nxt)]

        n_step, _, toks = st.while_loop(cond_fn, body_fn,
                                        [step, bos, tokens])
    return dict(main=main, startup=startup, feed={},
                fetch=[n_step.name, toks.name],
                params={"emb": emb_w, "proj": proj_w})


def cf_cond_outer_var(api, pred_val):
    """A branch returning an outer var verbatim."""
    st = api.static
    main, startup = _cf_new(api)
    with st.program_guard(main, startup):
        x = st.fill_constant([2], "float32", 3.0)
        y = st.fill_constant([2], "float32", 7.0)
        pred = st.fill_constant([1], "bool", pred_val)
        r = st.cond(pred, lambda: x, lambda: y)
    return dict(main=main, startup=startup, feed={}, fetch=[r.name],
                params={})


def cf_while_invariant(api):
    """The body hands back an untouched outer var as a loop var."""
    st = api.static
    main, startup = _cf_new(api)
    with st.program_guard(main, startup):
        n = st.fill_constant([1], "int64", 3)
        k = st.fill_constant([1], "float32", 5.0)
        i = st.fill_constant([1], "int64", 0)
        s = st.fill_constant([1], "float32", 0.0)
        _, s2 = st.while_loop(lambda i, s: st.less_than(i, n),
                              lambda i, s: [i + 1, k], [i, s])
    return dict(main=main, startup=startup, feed={}, fetch=[s2.name],
                params={})


def cf_case_no_default(api):
    """No default: the last pair's fn runs when no predicate holds."""
    st = api.static
    main, startup = _cf_new(api)
    with st.program_guard(main, startup):
        x = st.fill_constant([1], "float32", 5.0)
        one = st.fill_constant([1], "float32", 1.0)
        r = st.case([(st.less_than(x, one), lambda: x * 10.0),
                     (st.greater_than(x, one * 100.0), lambda: x + 100.0)])
    return dict(main=main, startup=startup, feed={}, fetch=[r.name],
                params={})


def cf_dynamic_rnn(api):
    """DynamicRNN's running sum on the dense path ([B, T, D] rows of one
    length, no @seq_len companion), sequence_last_step by pool."""
    st = api.static
    main, startup = _cf_new(api)
    with st.program_guard(main, startup):
        x = st.data("drx", [2, 3, 2])
        rnn = st.DynamicRNN()
        with rnn.block():
            w = rnn.step_input(x)
            prev = rnn.memory(shape=[2], value=0.0)
            cur = st.nn.elementwise_add(w, prev)
            rnn.update_memory(prev, cur)
            rnn.output(cur)
        out = rnn()
    feed = {"drx": np.array([[[1, 1], [2, 2], [3, 3]],
                             [[10, 10], [0, 0], [-4, 4]]], np.float32)}
    return dict(main=main, startup=startup, feed=feed, fetch=[out.name],
                params={})


def cf_dynamic_rnn_memory(api):
    """memory(shape=[7], value=1.5): the initial state's width and
    fill, seen at t=0."""
    st = api.static
    main, startup = _cf_new(api)
    with st.program_guard(main, startup):
        x = st.data("drx2", [1, 2, 4])
        rnn = st.DynamicRNN()
        with rnn.block():
            w = rnn.step_input(x)
            prev = rnn.memory(shape=[7], value=1.5)
            cur = st.nn.elementwise_add(st.nn.fc(w, size=7), prev)
            rnn.update_memory(prev, cur)
            rnn.output(prev)
        out = rnn()
    return dict(main=main, startup=startup,
                feed={"drx2": np.ones((1, 2, 4), np.float32)},
                fetch=[out.name], params={})


def cf_dynamic_rnn_ragged(api):
    """tests/test_control_flow.py's ragged DynamicRNN: a running sum
    over two sequences of lengths 3 and 1 fed as flat rows + a level-1
    LoD; the short row's state freezes after its length, and
    sequence_last_step takes each row's last valid step."""
    st = api.static
    main, startup = _cf_new(api)
    with st.program_guard(main, startup):
        x = st.data("drx", [-1, -1, 2], "float32", lod_level=1)
        rnn = st.DynamicRNN()
        with rnn.block():
            w = rnn.step_input(x)
            prev = rnn.memory(shape=[2], value=0.0)
            cur = st.nn.elementwise_add(w, prev)
            rnn.update_memory(prev, cur)
            rnn.output(cur)
        out = rnn()
        last = st.nn.sequence_last_step(out)
    rows = np.array([[1, 1], [2, 2], [3, 3], [10, 10]], np.float32)
    return dict(main=main, startup=startup, feed={"drx": (rows, [[0, 3, 4]])},
                fetch=[out.name, last.name], params={})


def cf_dynamic_rnn_memory_ragged(api):
    """memory(shape=[7], value=1.5) over a LoD feed of one sequence of 2
    steps: the initial state's width and fill, seen at t=0."""
    st = api.static
    main, startup = _cf_new(api)
    with st.program_guard(main, startup):
        x = st.data("drx2", [-1, -1, 4], "float32", lod_level=1)
        rnn = st.DynamicRNN()
        with rnn.block():
            w = rnn.step_input(x)
            prev = rnn.memory(shape=[7], value=1.5)
            cur = st.nn.elementwise_add(st.nn.fc(w, size=7), prev)
            rnn.update_memory(prev, cur)
            rnn.output(prev)
        out = rnn()
    return dict(main=main, startup=startup,
                feed={"drx2": (np.ones((2, 4), np.float32), [[0, 2]])},
                fetch=[out.name], params={})


def cf_array_decode(api, steps=5):
    """While in block form over a dense tensor array: write a value a
    step, read the last back into the carry, stack them all, and the
    array's length (its capacity on the dense path)."""
    st = api.static
    main, startup = _cf_new(api)
    with st.program_guard(main, startup):
        step = st.fill_constant([1], "int64", 0)
        limit = st.fill_constant([1], "int64", steps)
        v = st.fill_constant([1, 3], "float32", 1.0)
        arr = st.nn.array_write(v, step, max_size=steps + 2)
        c = st.less_than(step, limit)
        loop = st.While(c)
        with loop.block():
            last = st.nn.array_read(arr, step)
            st.nn.array_write(st.nn.scale(last, scale=2.0, bias=0.5),
                              step + 1, array=arr)
            st.increment(step)
            st.less_than(step, limit, out=c)
        stacked, index = st.nn.tensor_array_to_tensor(arr, axis=0,
                                                      use_stack=True)
        length = st.nn.array_length(arr)
    return dict(main=main, startup=startup, feed={},
                fetch=[stacked.name, index.name, length.name, step.name],
                params={})


def cf_static_rnn_dropout(api):
    """A dropout in a StaticRNN body draws one mask for all steps (a
    body traced once under lax.scan takes one key): x_t = 1 for every
    t, so every step's output is that mask."""
    st = api.static
    main, startup = _cf_new(api)
    with st.program_guard(main, startup):
        x = st.data("x", [6, 4, 16])
        rnn = st.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            rnn.step_output(st.nn.dropout(
                xt, 0.5, dropout_implementation="upscale_in_train"))
        hs = rnn()
    return dict(main=main, startup=startup,
                feed={"x": np.ones((6, 4, 16), np.float32)},
                fetch=[hs.name], params={})


# name -> builder(api) (test_control_flow.py's cases, then the port's)
CF_PROGRAMS = {
    "while_basic": cf_while_basic,
    "while_nested": cf_while_nested,
    "while_grad": cf_while_grad,
    "while_block": cf_while_block,
    "cond_true": functools.partial(cf_cond, pred_val=True),
    "cond_false": functools.partial(cf_cond, pred_val=False),
    "cond_grad": cf_cond_grad,
    "case_chain": cf_case_chain,
    **{f"switch_case_{i}": functools.partial(cf_switch_case, idx_val=i)
       for i in (0, 1, 7, -1, -7, 2, 100)},
    "static_rnn": cf_static_rnn,
    "static_rnn_grad": cf_static_rnn_grad,
    "nmt_decode": cf_nmt_decode,
    "cond_outer_true": functools.partial(cf_cond_outer_var, pred_val=True),
    "cond_outer_false": functools.partial(cf_cond_outer_var,
                                          pred_val=False),
    "while_invariant": cf_while_invariant,
    "case_no_default": cf_case_no_default,
    "dynamic_rnn": cf_dynamic_rnn,
    "dynamic_rnn_memory": cf_dynamic_rnn_memory,
    "dynamic_rnn_ragged": cf_dynamic_rnn_ragged,
    "dynamic_rnn_memory_ragged": cf_dynamic_rnn_memory_ragged,
    "array_decode": cf_array_decode,
    "cond_nan_untaken": cf_cond_nan_untaken,
}


def cf_feed(api, built):
    """A CF_PROGRAMS program's feed, a (rows, lod) entry as the
    package's TpuTensor."""
    return {k: api.pt.TpuTensor(*v) if isinstance(v, tuple) else v
            for k, v in built["feed"].items()}


def run_cf(api, built, exe, scope, start=None):
    """Run a CF_PROGRAMS program: its startup, then ``start`` (values by
    name; default the builder's params), then the main program once.
    Returns the fetches as numpy arrays."""
    feed = cf_feed(api, built)
    with api.pt.scope_guard(scope):
        exe.run(built["startup"], feed={}, fetch_list=[], scope=scope)
        for n, v in (built["params"] if start is None else start).items():
            scope.var(n).set(api.pt.TpuTensor(v))
        out = exe.run(built["main"], feed=feed,
                      fetch_list=built["fetch"], scope=scope)
    return [np.asarray(v) for v in out]


# ------------------------------------------------------------- PTB LM
# Zaremba, Sutskever and Vinyals 2014, section 4.1, the large model, as
# PaddlePaddle/models PaddleNLP/language_model ships it (--model_type
# large, the StaticRNN form): 2 layers, hidden 1500, 35 steps, batch 20,
# vocabulary 10,000, uniform init +-0.04, dropout 0.65, SGD at lr 1.0.
PTB_LARGE = dict(vocab=10000, hidden=1500, layers=2, steps=35, batch=20,
                 init_scale=0.04, dropout=0.65, lr=1.0)


def ptb_param_count(cfg):
    v, h, layers = cfg["vocab"], cfg["hidden"], cfg["layers"]
    return v * h + layers * (2 * h * 4 * h + 4 * h) + h * v + v


def _lstm_cell(nn, x, h_prev, c_prev, w, b):
    """One LSTM step as the PTB script writes it: concat([x, h]) . W + b,
    split into i, f, g, o (cuDNN's order), then c and h."""
    gates = nn.elementwise_add(nn.matmul(nn.concat([x, h_prev], axis=1), w),
                               b)
    i, f, g, o = nn.split(gates, num=4, axis=1)
    c = nn.elementwise_add(nn.elementwise_mul(nn.sigmoid(f), c_prev),
                           nn.elementwise_mul(nn.sigmoid(i), nn.tanh(g)))
    return nn.elementwise_mul(nn.sigmoid(o), nn.tanh(c)), c


def _ptb_lstm_params(api, cfg):
    st = api.static
    h = cfg["hidden"]
    uni = api.Uniform(-cfg["init_scale"], cfg["init_scale"])
    ws = [st.create_parameter([2 * h, 4 * h], "float32", name=f"lstm_w{k}",
                              default_initializer=uni)
          for k in range(cfg["layers"])]
    bs = [st.create_parameter([4 * h], "float32", name=f"lstm_b{k}",
                              is_bias=True) for k in range(cfg["layers"])]
    return ws, bs


def _ptb_softmax_params(api, cfg):
    st = api.static
    uni = api.Uniform(-cfg["init_scale"], cfg["init_scale"])
    sw = st.create_parameter([cfg["hidden"], cfg["vocab"]], "float32",
                             name="softmax_w", default_initializer=uni)
    sb = st.create_parameter([cfg["vocab"]], "float32", name="softmax_b",
                             is_bias=True)
    return sw, sb


def ptb_lm_program(api, cfg, dropout=0.0, route="static_rnn"):
    """The PTB LM training program: embedding, dropout, the 2-layer LSTM
    (``route`` "static_rnn": StaticRNN over the cells; "cudnn_lstm":
    static.nn.lstm), dropout on each layer's h, the softmax projection,
    softmax_with_cross_entropy, the mean over batch * steps tokens, and
    SGD(lr).minimize. Feeds: x and y [batch, steps] int64, init_h and
    init_c [layers, batch, hidden]. Returns (main, startup, loss)."""
    st = api.static
    nn = st.nn
    b, t, h = cfg["batch"], cfg["steps"], cfg["hidden"]
    layers = cfg["layers"]
    main, startup = st.Program(), st.Program()
    with st.program_guard(main, startup):
        x = st.data("x", [b, t], "int64")
        y = st.data("y", [b, t], "int64")
        h0 = st.data("init_h", [layers, b, h], "float32")
        c0 = st.data("init_c", [layers, b, h], "float32")
        uni = api.Uniform(-cfg["init_scale"], cfg["init_scale"])
        emb = nn.embedding(x, size=[cfg["vocab"], h], param_attr=api.ParamAttr(
            name="embedding_para", initializer=uni))
        if dropout:
            emb = nn.dropout(emb, dropout,
                             dropout_implementation="upscale_in_train")
        seq = nn.transpose(emb, axis=[1, 0, 2])                # [T, B, H]
        if route == "static_rnn":
            ws, bs = _ptb_lstm_params(api, cfg)
            sw, sb = _ptb_softmax_params(api, cfg)
            inits = [[nn.reshape(nn.slice(s0, axes=[0], starts=[k],
                                          ends=[k + 1]), shape=[b, h])
                      for k in range(layers)] for s0 in (h0, c0)]
            rnn = st.StaticRNN()
            with rnn.step():
                inp = rnn.step_input(seq)
                for k in range(layers):
                    h_prev = rnn.memory(init=inits[0][k])
                    c_prev = rnn.memory(init=inits[1][k])
                    hk, ck = _lstm_cell(nn, inp, h_prev, c_prev, ws[k], bs[k])
                    rnn.update_memory(h_prev, hk)
                    rnn.update_memory(c_prev, ck)
                    inp = hk
                    if dropout:
                        inp = nn.dropout(
                            hk, dropout,
                            dropout_implementation="upscale_in_train")
                rnn.step_output(inp)
            out = rnn()
        else:
            out, _, _ = nn.lstm(seq, h0, c0, max_len=t, hidden_size=h,
                                num_layers=layers, default_initializer=uni)
            if dropout:
                out = nn.dropout(out, dropout,
                                 dropout_implementation="upscale_in_train")
            sw, sb = _ptb_softmax_params(api, cfg)
        flat = nn.reshape(nn.transpose(out, axis=[1, 0, 2]), shape=[b * t, h])
        logits = nn.elementwise_add(nn.matmul(flat, sw), sb)
        loss = nn.mean(nn.softmax_with_cross_entropy(
            logits, nn.reshape(y, shape=[b * t, 1])))
        api.SGD(learning_rate=cfg["lr"]).minimize(loss)
    return main, startup, loss


def ptb_feeds(cfg, seed, device=None):
    """A batch of token ids and next-token labels from ``seed`` (the
    corpus is not in the repository) and zero initial states."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, cfg["vocab"], (cfg["batch"], cfg["steps"] + 1))
    state = np.zeros((cfg["layers"], cfg["batch"], cfg["hidden"]),
                     np.float32)
    feed = {"x": ids[:, :-1].astype(np.int64),
            "y": ids[:, 1:].astype(np.int64), "init_h": state,
            "init_c": state.copy()}
    if device is not None:
        feed = {k: torch.from_numpy(v).to(device) for k, v in feed.items()}
    return feed


def ptb_lstm_weights(main, cfg, values):
    """The cudnn_lstm route's WeightList values, by name, from the
    StaticRNN route's lstm_w{k} / lstm_b{k}: Wx = W[:in], Wh = W[in:],
    B = b."""
    op = next(o for o in main.global_block().ops if o.type == "cudnn_lstm")
    names = op.inputs["WeightList"]
    h = cfg["hidden"]
    out = {}
    for k in range(cfg["layers"]):
        w = values[f"lstm_w{k}"]
        out[names[3 * k]] = w[:w.shape[0] - h]
        out[names[3 * k + 1]] = w[w.shape[0] - h:]
        out[names[3 * k + 2]] = values[f"lstm_b{k}"]
    return out


def ptb_param_names(main):
    """The model's parameters of a PTB program (the learning rate
    aside), in the program's order."""
    return [n for n, v in main.global_block().vars.items()
            if v.persistable and not n.startswith("learning_rate")]


def ptb_train(api, exe, scope, program, start, feeds, fetch=()):
    """SGD steps of a PTB program (main, startup, loss) from ``start``
    (values by name), one a feed: the losses, the extra fetches of each
    step and the parameters after the last, as numpy."""
    main, startup, loss = program
    losses, extra = [], []
    with api.pt.scope_guard(scope):
        exe.run(startup, feed={}, fetch_list=[], scope=scope)
        for n, v in start.items():
            scope.var(n).set(api.pt.TpuTensor(v))
        for feed in feeds:
            out = exe.run(main, feed=feed, fetch_list=[loss, *fetch],
                          scope=scope)
            losses.append(float(np.asarray(out[0]).ravel()[0]))
            extra.append([np.asarray(v) for v in out[1:]])
        params = {n: scope.find_var(n).get().numpy() for n in start}
    return losses, extra, params


def ptb_decode(api, exe, scope, main, tokens, logits, values):
    """Run a ptb_decode_program on parameter ``values``: (tokens [n],
    logits [n, vocab]) as numpy."""
    with api.pt.scope_guard(scope):
        for n, v in values.items():
            scope.var(n).set(api.pt.TpuTensor(v))
        toks, logs = exe.run(main, fetch_list=[tokens, logits], scope=scope)
    return np.asarray(toks).reshape(-1), np.asarray(logs).reshape(
        np.asarray(toks).size, -1)


def ptb_decode_program(api, cfg, gen_len, prompt):
    """Greedy generation through While and a tensor array: the loop
    carries step, token, each layer's h and c, the token array and the
    logits array; a step embeds the token, runs the cells, projects,
    takes the argmax, writes it (array_write), reads it back as the next
    token (array_read). tensor_array_to_tensor stacks the tokens and the
    logits. Reads the training program's parameters by name. Returns
    (main, tokens, logits)."""
    st = api.static
    nn = st.nn
    h, layers = cfg["hidden"], cfg["layers"]
    main, startup = st.Program(), st.Program()
    with st.program_guard(main, startup):
        emb = st.create_parameter([cfg["vocab"], h], "float32",
                                  name="embedding_para")
        ws, bs = _ptb_lstm_params(api, cfg)
        sw, sb = _ptb_softmax_params(api, cfg)
        step = st.fill_constant([1], "int64", 0)
        limit = st.fill_constant([1], "int64", gen_len)
        tok = st.fill_constant([1], "int64", prompt)
        hs = [st.fill_constant([1, h], "float32", 0.0) for _ in range(layers)]
        cs = [st.fill_constant([1, h], "float32", 0.0) for _ in range(layers)]
        toks = nn.array_write(tok, step, max_size=gen_len)
        logit0 = st.fill_constant([1, cfg["vocab"]], "float32", 0.0)
        logs = nn.array_write(logit0, step, max_size=gen_len)
        c = st.less_than(step, limit)
        loop = st.While(c)
        with loop.block():
            inp = nn.embedding_lookup(emb, tok)
            for k in range(layers):
                hk, ck = _lstm_cell(nn, inp, hs[k], cs[k], ws[k], bs[k])
                st.assign(hk, hs[k])
                st.assign(ck, cs[k])
                inp = hk
            logits = nn.elementwise_add(nn.matmul(inp, sw), sb)
            nn.array_write(nn.argmax(logits, axis=-1), step, array=toks)
            nn.array_write(logits, step, array=logs)
            st.assign(nn.array_read(toks, step), tok)
            st.increment(step)
            st.less_than(step, limit, out=c)
        tokens, _ = nn.tensor_array_to_tensor(toks, axis=0, use_stack=True)
        all_logits, _ = nn.tensor_array_to_tensor(logs, axis=0,
                                                  use_stack=True)
    return main, tokens, all_logits


# the cases of data-dependent output shape or a host-read predicate
# whose host syncs phase cf_api prints (by case id)
CF_SYNC_CASES = (
    "while_loop_bounded", "while_loop_unbounded", "while_lowered",
    "conditional_block_True", "conditional_block_False",
    "conditional_block_infer_True", "switch_0", "switch_-3",
    "static_rnn", "split_lod_tensor", "merge_lod_tensor",
    "merge_lod_tensor_infer", "sequence_expand_as",
    "sequence_expand_as_max_len", "filter_by_instag", "tdm_sampler",
    "assert_true", "tree_conv", "cudnn_lstm", "cudnn_lstm_seq_len",
    "shuffle_batch", "sample_logits", "py_func", "save", "load",
    "run_program", "roi_pool", "write_to_array_past_end",
    "read_from_array_negative", "select_input_-1", "array_length")


def raise_cases(cases, dev):
    """The "error" cases among ``cases`` raise on the card, each the
    error its ``check`` names. Returns their op types."""
    from paddle_tpu_torch.core.registry import OpInfoMap
    seen = set()
    for case in cases:
        if case.kind != "error":
            continue
        ins = {s: [torch.from_numpy(np.array(v)).to(dev) for v in vs]
               for s, vs in case.inputs.items()}
        try:
            with case_env(case, dev) as attrs:
                OpInfoMap.instance().get(case.op).compute(ins, attrs)
            raised = ""
        except Exception as e:          # the op's own error
            raised = str(e)
        check(re.search(case.check, raised),
              f"{case.id}: did not raise {case.check!r} on the card")
        seen.add(case.op)
    return seen


def case_syncs(cases, ids, dev):
    """{case id: host syncs of one call of its op} for the cases named
    in ``ids``, on inputs already on the card."""
    from paddle_tpu_torch.core.registry import OpInfoMap
    syncs = {}
    for cid in ids:
        case = next(c for c in cases if c.id == cid)
        ins = {s: [torch.from_numpy(np.array(v)).to(dev) for v in vs]
               for s, vs in case.inputs.items()}
        with case_env(case, dev) as attrs:
            compute = OpInfoMap.instance().get(case.op).compute
            compute(ins, dict(attrs))
            syncs[cid] = profile_call(
                lambda: compute(ins, dict(attrs)))["syncs"]
    return syncs


def phase_cf_api(dev):
    """The 97 op types of the control-flow slice (control_flow_ops,
    array_ops, parity_ops, misc_ops, special_ops): every case of
    cf_cases on the card against the port on the CPU at each case's
    bound, forward and gradient (the control-flow ops on their published
    Program; shuffle_batch's and sample_logits' draws, made on the CPU,
    equal); the error cases raise on the card too; then the host syncs
    of one call of the cases whose output shape depends on the data or
    that read a predicate or an index on the host."""
    from paddle_tpu_torch.testing.cf_cases import CF_CASES
    worst = {}
    held = [c for c in CF_CASES if c.kind in ("value", "shape", "draws")]
    types_seen = hold_cases(held, dev, worst)
    types_seen |= raise_cases(CF_CASES, dev)
    for case in CF_CASES:
        if case.kind == "random":
            out = _op_case_run(case, dev)
            check(all(case.check(v.numpy()) for vs in out.values()
                      for v in vs), f"{case.id}: draws out of range")
            types_seen.add(case.op)
    syncs = case_syncs(CF_CASES, CF_SYNC_CASES, dev)
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    print(f"[cf_api] {len(CF_CASES)} cases of {len(types_seen)} op types on "
          f"the card against the CPU: all agree; largest float errors "
          + ", ".join(f"{k} {v:.2e}" for k, v in top)
          + "; host syncs of one call on inputs already on the card: "
          + ", ".join(f"{k} {n}" for k, n in syncs.items()))
    check(len(types_seen) == 97, f"{len(types_seen)} op types checked")


CF_CARD_TOL = dict(rtol=1e-5, atol=1e-6)


def phase_control_flow(tpt, dev):
    """tests/test_control_flow.py's programs (CF_PROGRAMS: while_loop
    nested and bounded with a gradient, While in block form, cond with a
    gradient, case, switch_case with negative and large indices,
    StaticRNN with a gradient, the greedy decode, DynamicRNN on the
    dense path and on LoD feeds, a While over a tensor array) on the
    card against the port on the CPU from the same parameters (rtol
    1e-5 / atol 1e-6, integers equal), each with the host syncs of its
    main run."""
    api = port_static_api()
    rows = []
    for name, builder in CF_PROGRAMS.items():
        built = builder(api)
        cpu_scope = api.pt.Scope()
        want = run_cf(api, built, api.pt.Executor("cpu"), cpu_scope)
        start = {n: cpu_scope.find_var(n).get().numpy()
                 for n, v in built["main"].global_block().vars.items()
                 if v.persistable and cpu_scope.find_var(n) is not None}
        exe, scope = api.pt.Executor(dev), api.pt.Scope()
        got = run_cf(api, built, exe, scope, start)
        check(len(got) == len(want), f"{name}: fetches")
        for g, w in zip(got, want):
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"{name}: {g.shape} {g.dtype} on the card, {w.shape} "
                  f"{w.dtype} on the CPU")
            ok = np.allclose(g, w, equal_nan=True, **CF_CARD_TOL) \
                if np.issubdtype(w.dtype, np.floating) \
                else np.array_equal(g, w)
            check(ok, f"{name}: the card disagrees with the CPU")
        with api.pt.scope_guard(scope):
            prof = profile_call(lambda: exe.run(
                built["main"], feed=cf_feed(api, built),
                fetch_list=built["fetch"], scope=scope,
                return_numpy=False))
        rows.append(f"{name} {prof['syncs']}")
    print(f"[control_flow] {len(CF_PROGRAMS)} programs on the card against "
          f"the CPU: all agree; host syncs of a run: " + ", ".join(rows))


PTB_LOSS_RTOL = 1e-5        # card against CPU, first step, dropout 0
PTB_UPDATE_TOL = 1e-3       # each parameter, of its update's norm
PTB_ROUTE_LOSS_RTOL = 1e-4  # cudnn_lstm against StaticRNN on the card
PTB_ROUTE_GRAD_TOL = 1e-3   # each gradient, of its norm
PTB_GEN = dict(tokens=35, prompt=42)


def _ptb_route_start(cprog, cfg, start):
    out = {n: v for n, v in start.items() if not n.startswith("lstm_")}
    out.update(ptb_lstm_weights(cprog[0], cfg, start))
    return out


def _ptb_time(api, dev, program, start, feeds, warmup=2, steps=5):
    """Timed SGD steps of a PTB program on the card (device feeds, the
    loss fetched as a device tensor), then one profiled step."""
    main, startup, loss = program
    exe, scope = api.pt.Executor(dev), api.pt.Scope()
    with api.pt.scope_guard(scope):
        exe.run(startup, feed={}, fetch_list=[], scope=scope)
        for n, v in start.items():
            scope.var(n).set(api.pt.TpuTensor(torch.from_numpy(v).to(dev)))
        losses = []
        it = iter(range(10 ** 6))

        def step():
            out = exe.run(main, feed=feeds[next(it) % len(feeds)],
                          fetch_list=[loss], scope=scope, return_numpy=False)
            losses.append(out[0].value)

        times = _timed_steps(step, warmup, steps)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        prof = profile_call(step)
    check(all(math.isfinite(float(v)) for v in losses), "a loss is not finite")
    return times, peak, prof, [float(v) for v in losses]


def phase_ptb_lm(tpt, dev):
    """The main path of this slice: the PTB-large LSTM language model
    (PTB_LARGE, 66,022,000 parameters, fp32, TF32 off) written as a
    fluid script (ptb_lm_program): StaticRNN over 35 steps of 2 LSTM
    layers, trained by SGD(1.0) through append_backward and Executor;
    the same model through static.nn.lstm (cudnn_lstm); greedy
    generation through While and tensor arrays (ptb_decode_program).
    Card against CPU: the first step from the same weights at dropout 0
    (loss within 1e-5 relative, each update within 1e-3 of its norm).
    Route against route on the card, dropout 0: cudnn_lstm's loss within
    1e-4 relative of StaticRNN's, each LSTM gradient within 1e-3 of its
    norm. Each route for 2 warm-up and 5 timed steps at dropout 0.65:
    step_ms, tokens/s, peak memory, and one profiled step's launches,
    host syncs, device busy and idle share. Generation: 35 greedy tokens
    from prompt id 42 with the weights after the first step, the same on
    the card as on the CPU (a mismatch prints the logit gap at the first
    token that differs), ms and host syncs a token."""
    api = port_static_api()
    cfg = PTB_LARGE
    n_params = ptb_param_count(cfg)
    tokens = cfg["batch"] * cfg["steps"]
    prog0 = ptb_lm_program(api, cfg, dropout=0.0)
    names = ptb_param_names(prog0[0])
    cpu_exe, cpu_scope = api.pt.Executor("cpu"), api.pt.Scope()
    with api.pt.scope_guard(cpu_scope):
        cpu_exe.run(prog0[1], feed={}, fetch_list=[], scope=cpu_scope)
    start = {n: cpu_scope.find_var(n).get().numpy() for n in names}
    check(sum(v.size for v in start.values()) == n_params,
          f"the program's parameters are not the {n_params:,} of the model")
    feed0 = ptb_feeds(cfg, 0)
    t0 = time.perf_counter()
    cl, _, cp = ptb_train(api, cpu_exe, api.pt.Scope(), prog0, start,
                          [feed0])
    cpu_s = time.perf_counter() - t0
    gl, _, gp = ptb_train(api, api.pt.Executor(dev), api.pt.Scope(), prog0,
                          start, [ptb_feeds(cfg, 0, dev)])
    loss_err = abs(gl[0] - cl[0]) / abs(cl[0])
    errs = update_errors(gp, cp, start)
    worst = max(errs, key=errs.get)
    print(f"[ptb_lm] PTB-large ({n_params:,} parameters), first step at "
          f"dropout 0: loss card {gl[0]!r} cpu {cl[0]!r} (ln "
          f"{cfg['vocab']} = {math.log(cfg['vocab']):.4f}), rel err "
          f"{loss_err:.3e} (bound "
          f"{PTB_LOSS_RTOL:g}); worst update error {errs[worst]:.3e} "
          f"({worst}, bound {PTB_UPDATE_TOL:g}); the CPU step took "
          f"{cpu_s:.2f} s")
    check(loss_err <= PTB_LOSS_RTOL, "card loss disagrees with the CPU")
    check(errs[worst] <= PTB_UPDATE_TOL, "card update disagrees with the CPU")

    # route against route on the card, dropout 0
    sgrads = [f"lstm_w{k}@GRAD" for k in range(cfg["layers"])] + \
        [f"lstm_b{k}@GRAD" for k in range(cfg["layers"])]
    cprog0 = ptb_lm_program(api, cfg, dropout=0.0, route="cudnn_lstm")
    weights = next(o for o in cprog0[0].global_block().ops
                   if o.type == "cudnn_lstm").inputs["WeightList"]
    feed_dev = ptb_feeds(cfg, 0, dev)
    sl, sg, _ = ptb_train(api, api.pt.Executor(dev), api.pt.Scope(), prog0,
                          start, [feed_dev], sgrads)
    rl, rg, _ = ptb_train(api, api.pt.Executor(dev), api.pt.Scope(), cprog0,
                          _ptb_route_start(cprog0, cfg, start), [feed_dev],
                          [n + "@GRAD" for n in weights])
    route_loss = abs(rl[0] - sl[0]) / abs(sl[0])
    gerrs = []
    for k in range(cfg["layers"]):
        w = np.concatenate([rg[0][3 * k], rg[0][3 * k + 1]], 0)
        for got, want in ((w, sg[0][k]), (rg[0][3 * k + 2],
                                          sg[0][cfg["layers"] + k])):
            gerrs.append(float(np.linalg.norm(got - want) /
                               np.linalg.norm(want)))
    print(f"[ptb_lm] cudnn_lstm route against the StaticRNN route on the "
          f"card, dropout 0: loss {rl[0]!r} vs {sl[0]!r}, rel err "
          f"{route_loss:.3e} (bound {PTB_ROUTE_LOSS_RTOL:g}); LSTM gradient "
          f"errors (of their norms) " + ", ".join(f"{e:.2e}" for e in gerrs)
          + f" (bound {PTB_ROUTE_GRAD_TOL:g})")
    check(route_loss <= PTB_ROUTE_LOSS_RTOL, "cudnn_lstm loss disagrees")
    check(max(gerrs) <= PTB_ROUTE_GRAD_TOL, "cudnn_lstm gradients disagree")

    # timing at dropout 0.65
    feeds = [ptb_feeds(cfg, s, dev) for s in range(2)]
    med = {}
    for route in ("static_rnn", "cudnn_lstm"):
        prog = ptb_lm_program(api, cfg, dropout=cfg["dropout"], route=route)
        st = start if route == "static_rnn" else \
            _ptb_route_start(prog, cfg, start)
        torch.cuda.empty_cache()
        times, peak, prof, losses = _ptb_time(api, dev, prog, st, feeds)
        med[route] = sorted(times)[len(times) // 2]
        print(f"[ptb_lm] {route} route, dropout {cfg['dropout']}: step_ms "
              f"median {med[route]:.3f} range {min(times):.3f}-"
              f"{max(times):.3f} over {len(times)} steps (2 warm-up), "
              f"tokens/s {tokens / med[route] * 1e3:.1f}, peak memory "
              f"{peak:.2f} GiB, losses {losses[0]:.4f} -> {losses[-1]:.4f}; "
              f"one profiled step {prof['wall_ms']:.3f} ms: launches "
              f"{prof['launches']}, host syncs {prof['syncs']}, device busy "
              f"{prof['busy_ms']:.3f} ms, idle share "
              f"{1 - prof['busy_ms'] / prof['wall_ms']:.3f}; top kernels "
              + ", ".join(f"{k[:50]} {v:.3f}" for k, v in prof["top_kernels"])
              + f"; {card_line()}")
    print(f"[ptb_lm] StaticRNN step over cudnn_lstm step: "
          f"{med['static_rnn'] / med['cudnn_lstm']:.2f}x")

    # greedy generation with the weights after the first (CPU) step
    gen = PTB_GEN
    dec = ptb_decode_program(api, cfg, gen["tokens"], gen["prompt"])
    ctok, clog = ptb_decode(api, api.pt.Executor("cpu"), api.pt.Scope(),
                            *dec, cp)
    exe, scope = api.pt.Executor(dev), api.pt.Scope()
    gtok, glog = ptb_decode(api, exe, scope, *dec, cp)
    differ = np.flatnonzero(gtok != ctok)
    if differ.size:
        i = int(differ[0])
        top = np.sort(clog[i])[-2:]
        print(f"[ptb_lm] generation differs at token {i}: card "
              f"{gtok[i]} cpu {ctok[i]}; logit gap between the CPU's top "
              f"two {top[1] - top[0]:.3e}, card-CPU logit error there "
              f"{np.abs(glog[i] - clog[i]).max():.3e}")
    check(not differ.size, "generated tokens differ between card and CPU")
    with api.pt.scope_guard(scope):
        def generate():
            exe.run(dec[0], fetch_list=[dec[1]], scope=scope,
                    return_numpy=False)
        generate()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            generate()
        torch.cuda.synchronize()
        gen_ms = (time.perf_counter() - t0) * 1e3 / 3
        prof = profile_call(generate)
    gaps = np.sort(clog, -1)
    print(f"[ptb_lm] greedy generation of {gen['tokens']} tokens from "
          f"prompt {gen['prompt']}: card equals CPU ({len(set(gtok))} "
          f"distinct, first {gtok[:8].tolist()}), smallest top-two logit "
          f"gap {np.min(gaps[:, -1] - gaps[:, -2]):.3e}; "
          f"{gen_ms / gen['tokens']:.3f} ms a token, host syncs a token "
          f"{prof['syncs'] / gen['tokens']:.2f}, launches a token "
          f"{prof['launches'] / gen['tokens']:.1f}")
    return med


# ------------------------------------------- sequences, LoD feeds, RNNs
# The book's understand_sentiment, stacked_lstm_net (PaddlePaddle/book
# 06.understand_sentiment): embedding 128, hid_dim 512, stacked_num 3
# (dynamic_lstm hidden 128, with peepholes), 2 classes, Adagrad at lr
# 0.002, batch 128. IMDB's text and dictionary are not in the
# repository: reviews are token ids from a seed, 32-512 tokens long, and
# the dictionary has 5,149 words (it sets only the embedding's rows).
SENTIMENT = dict(vocab=5149, emb=128, hid=512, stacked=3, classes=2,
                 lr=0.002, batch=128, min_len=32, max_len=512)


def sentiment_program(api, cfg):
    """stacked_lstm_net as the book writes it, over a LoD input: fc and
    dynamic_lstm stacked ``stacked`` deep, each fc reading the fc and
    the LSTM below it, the LSTMs alternating direction (the even ones
    reverse each review within its length), sequence_pool MAX of the
    last fc and LSTM, a softmax fc, cross_entropy, and
    Adagrad(lr).minimize. Feeds: words (flat rows [N, 1] int64 + a
    level-1 LoD), label [B, 1] int64. Returns (main, startup, loss)."""
    st = api.static
    nn = st.nn
    hid = cfg["hid"]
    main, startup = st.Program(), st.Program()
    with st.program_guard(main, startup):
        words = st.data("words", [-1, -1, 1], "int64", lod_level=1)
        label = st.data("label", [-1, 1], "int64")
        emb = nn.embedding(words, size=[cfg["vocab"], cfg["emb"]],
                           is_sparse=True)
        fc1 = nn.fc(emb, size=hid)
        lstm1, _ = nn.dynamic_lstm(fc1, size=hid)
        inputs = [fc1, lstm1]
        for i in range(2, cfg["stacked"] + 1):
            fc = nn.fc(inputs, size=hid)
            lstm, _ = nn.dynamic_lstm(fc, size=hid,
                                      is_reverse=(i % 2) == 0)
            inputs = [fc, lstm]
        pooled = [nn.sequence_pool(v, st.companion_length_of(v),
                                   pooltype="MAX") for v in inputs]
        pred = nn.fc(pooled, size=cfg["classes"], act="softmax")
        loss = nn.mean(nn.cross_entropy(pred, label))
        api.Adagrad(learning_rate=cfg["lr"]).minimize(loss)
    return main, startup, loss.name


def sentiment_batch(cfg, seed):
    """A batch of ``batch`` reviews from ``seed``: lengths uniform in
    [min_len, max_len], token ids uniform over the dictionary, labels
    uniform. Returns (rows [N, 1] int64, level-1 LoD, label [B, 1])."""
    rs = np.random.RandomState(seed)
    lens = rs.randint(cfg["min_len"], cfg["max_len"] + 1, cfg["batch"])
    rows = rs.randint(0, cfg["vocab"], (int(lens.sum()), 1)).astype(np.int64)
    lod = [[0] + np.cumsum(lens).tolist()]
    label = rs.randint(0, cfg["classes"], (cfg["batch"], 1)).astype(np.int64)
    return rows, lod, label


def sentiment_params(main):
    """The persistables of a sentiment program (parameters and Adagrad's
    moments), the learning rate aside."""
    return [n for n, v in main.global_block().vars.items()
            if v.persistable and not n.startswith("learning_rate")]


def sentiment_feed(api, batch, device=None):
    rows, lod, label = batch
    if device is not None:
        rows = torch.from_numpy(rows).to(device)
        label = torch.from_numpy(label).to(device)
    return {"words": api.pt.TpuTensor(rows, lod), "label": label}


def sentiment_train(api, exe, scope, program, start, batches):
    """Adagrad steps of a sentiment program from ``start`` (values by
    name), one a batch of ``sentiment_batch``: (losses, the persistables
    after the last step), as numpy."""
    main, startup, loss = program
    losses = []
    with api.pt.scope_guard(scope):
        exe.run(startup, feed={}, fetch_list=[], scope=scope)
        for n, v in start.items():
            scope.var(n).set(api.pt.TpuTensor(v))
        for batch in batches:
            out = exe.run(main, feed=sentiment_feed(api, batch),
                          fetch_list=[loss], scope=scope)
            losses.append(float(np.asarray(out[0]).ravel()[0]))
        params = {n: np.asarray(scope.find_var(n).get().numpy())
                  for n in start}
    return losses, params


SEQ_SYNC_CASES = ("sequence_mask", "sequence_mask_from_data",
                  "sequence_expand_from_data", "segment_pool_from_data",
                  "rnn_scan_lstm", "lstm_reverse_length")


def phase_seq_ops(dev):
    """The 19 op types of the sequence slice (sequence_ops, rnn_ops):
    every case of seq_cases on the card against the port on the CPU at
    each case's bound, forward and gradient (ragged rows of lengths 5, 0
    and 3; lstm reversed with and without Length; rnn_scan on cuDNN on
    the card, the plain loop on the CPU); the error cases raise on the
    card too; the fluid sequence_expand(x, y) form over a LoD and the
    executor's LoD-feed padding, card against CPU, equal; then the host
    syncs of one call of the cases that read their data's size."""
    from paddle_tpu_torch.core import lodctx
    from paddle_tpu_torch.core.executor import lod_to_padded
    from paddle_tpu_torch.core.program import OpDesc
    from paddle_tpu_torch.core.registry import OpInfoMap
    from paddle_tpu_torch.core.tensor import TpuTensor
    from paddle_tpu_torch.testing.seq_cases import SEQ_CASES
    worst = {}
    types_seen = hold_cases([c for c in SEQ_CASES if c.kind == "value"],
                            dev, worst)
    types_seen |= raise_cases(SEQ_CASES, dev)
    rs = np.random.RandomState(0)
    rows = rs.randn(9, 3).astype(np.float32)
    lod = [[0, 4, 4, 9]]                  # an empty row between two
    x = rs.randn(3, 2).astype(np.float32)
    got = []
    for device in (dev, "cpu"):
        padded, lens = lod_to_padded(TpuTensor(rows, lod, device=device),
                                     device)
        op = OpDesc("sequence_expand", {"X": ["x"], "Y": ["y"]},
                    {"Out": ["o"]}, {"ref_level": -1})
        with lodctx.lod_scope({"y": [[0, 2, 2, 5]]}), lodctx.op_scope(op):
            out = OpInfoMap.instance().get("sequence_expand").compute(
                {"X": [torch.from_numpy(x).to(device)],
                 "Y": [torch.zeros(5, 1, device=device)]},
                {"ref_level": -1})["Out"][0]
        got.append([v.cpu() for v in (padded, lens, out)])
    check(all(torch.equal(a, b) for a, b in zip(*got)),
          "LoD padding or sequence_expand(x, y) differs on the card")
    check(got[1][1].tolist() == [4, 0, 5] and
          tuple(got[1][0].shape) == (3, 5, 3), "LoD padding")
    syncs = case_syncs(SEQ_CASES, SEQ_SYNC_CASES, dev)
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    print(f"[seq_ops] {len(SEQ_CASES)} cases of {len(types_seen)} op types "
          f"on the card against the CPU: all agree; largest float errors "
          + ", ".join(f"{k} {v:.2e}" for k, v in top)
          + "; LoD-feed padding and sequence_expand(x, y) equal; host syncs "
          "of one call on inputs already on the card: "
          + ", ".join(f"{k} {n}" for k, n in syncs.items()))
    check(len(types_seen) == 19, f"{len(types_seen)} op types checked")


RNNLM_LOSS_RTOL = PTB_LOSS_RTOL      # card against CPU, first step
RNNLM_UPDATE_TOL = PTB_UPDATE_TOL    # each parameter, of its update's norm
RNNLM_CLIP = 10.0                    # the global norm the updates clip to


def rnnlm_model(nn, cfg, dropout):
    """PaddleNLP's 2.0 rnnlm (examples/language_model/rnnlm) at ``cfg``
    (PTB_LARGE): embedding, dropout, nn.LSTM of ``layers`` layers
    (dropout between them), dropout, the vocabulary projection. Its
    forward takes ids [B, T] and the (h, c) states and returns the
    logits [B, T, V] and the new states."""

    class RnnLm(nn.Layer):
        def __init__(self):
            super().__init__()
            v, h = cfg["vocab"], cfg["hidden"]
            self.embedder = nn.Embedding(v, h)
            self.lstm = nn.LSTM(h, h, num_layers=cfg["layers"],
                                dropout=dropout)
            self.fc = nn.Linear(h, v)
            self.dropout = nn.Dropout(dropout)

        def forward(self, ids, states):
            y = self.dropout(self.embedder(ids))
            y, states = self.lstm(y, states)
            return self.fc(self.dropout(y)), states

    return RnnLm()


def rnnlm_state(cfg, start):
    """The eager model's state dict from the static PTB program's
    parameters (``start``): the same weights in nn.LSTM's layout
    (convert.lstm_state_from_cells)."""
    from paddle_tpu_torch import convert
    layers = range(cfg["layers"])
    state = {"lstm." + k: v for k, v in convert.lstm_state_from_cells(
        [start[f"lstm_w{k}"] for k in layers],
        [start[f"lstm_b{k}"] for k in layers]).items()}
    state.update({"embedder.weight": start["embedding_para"],
                  "fc.weight": start["softmax_w"],
                  "fc.bias": start["softmax_b"]})
    return state


def rnnlm_step(paddle, model, opt, feed, states):
    """One training step of the user script: forward, the mean token
    cross entropy, backward, the clipped SGD update. Returns (loss,
    detached states)."""
    b, t = feed["x"].shape
    logits, states = model(feed["x"], states)
    loss = paddle.nn.functional.cross_entropy(
        logits.reshape([b * t, -1]), feed["y"].reshape([b * t, 1]))
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss, tuple(s.detach() for s in states)


def _rnnlm_setup(tpt, device, cfg, dropout, state):
    from paddle_tpu_torch.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.convert import load_state_dict
    tpt.set_device(device)
    model = rnnlm_model(tpt.nn, cfg, dropout)
    load_state_dict(model, state)
    opt = tpt.optimizer.SGD(
        learning_rate=cfg["lr"], parameters=model.parameters(),
        grad_clip=ClipGradByGlobalNorm(RNNLM_CLIP))
    return model, opt


def _rnnlm_feed(feed, device):
    return {k: torch.from_numpy(feed[k]).to(device) for k in ("x", "y")}


def _rnnlm_states(cfg, device):
    z = torch.zeros(cfg["layers"], cfg["batch"], cfg["hidden"],
                    device=device)
    return (z, z.clone())


def phase_rnnlm_eager(tpt, dev):
    """The eager language model of the sequence slice: PTB-large (PTB_LARGE, 66,022,000
    parameters, fp32, TF32 off) as PaddleNLP's 2.0 rnnlm writes it
    (rnnlm_model: paddle.nn.LSTM, eager), SGD(1.0) with the clip of 10
    on the global norm, from the weights of the static PTB program's
    startup. Card against CPU: the first step at dropout 0 (loss within
    1e-5 relative, each update within 1e-3 of its norm). Route against
    route on the card at dropout 0: the nn.LSTM loss against PTB
    StaticRNN's and cudnn_lstm's from the same weights (1e-4 relative),
    and the LSTM gradients before the clip against StaticRNN's (1e-3 of
    their norms). Then 2 warm-up and 5 timed steps at dropout 0.65,
    states carried across steps as the script does: step_ms, tokens/s,
    peak memory, and one profiled step's launches, host syncs and idle
    share."""
    api = port_static_api()
    cfg = PTB_LARGE
    tokens = cfg["batch"] * cfg["steps"]
    prog0 = ptb_lm_program(api, cfg, dropout=0.0)
    cpu_scope = api.pt.Scope()
    with api.pt.scope_guard(cpu_scope):
        api.pt.Executor("cpu").run(prog0[1], feed={}, fetch_list=[],
                                   scope=cpu_scope)
    start = {n: cpu_scope.find_var(n).get().numpy()
             for n in ptb_param_names(prog0[0])}
    state = rnnlm_state(cfg, start)
    feed0 = ptb_feeds(cfg, 0)
    results = []
    for device in ("cpu", dev):
        model, opt = _rnnlm_setup(tpt, device, cfg, 0.0, state)
        t0 = time.perf_counter()
        loss, _ = rnnlm_step(tpt, model, opt, _rnnlm_feed(feed0, device),
                             _rnnlm_states(cfg, device))
        results.append((float(loss.detach()), {
            k: v.detach().cpu().numpy()
            for k, v in model.state_dict().items()},
            time.perf_counter() - t0))
        del model, opt
    tpt.set_device(dev)
    (cl, cp, cpu_s), (gl, gp, _) = results
    loss_err = abs(gl - cl) / abs(cl)
    errs = update_errors(gp, cp, state)
    worst = max(errs, key=errs.get)
    n_params = sum(v.size for k, v in state.items())
    print(f"[rnnlm_eager] PTB-large through paddle.nn.LSTM ({n_params:,} "
          f"values, bias_hh included), first step at dropout 0: loss card "
          f"{gl!r} cpu {cl!r}, rel err {loss_err:.3e} (bound "
          f"{RNNLM_LOSS_RTOL:g}); worst update error {errs[worst]:.3e} "
          f"({worst}, bound {RNNLM_UPDATE_TOL:g}); the CPU step took "
          f"{cpu_s:.2f} s")
    check(loss_err <= RNNLM_LOSS_RTOL, "card loss disagrees with the CPU")
    check(errs[worst] <= RNNLM_UPDATE_TOL,
          "card update disagrees with the CPU")

    # route against route on the card, dropout 0
    feed_dev = ptb_feeds(cfg, 0, dev)
    sgrads = [f"lstm_w{k}@GRAD" for k in range(cfg["layers"])] + \
        [f"lstm_b{k}@GRAD" for k in range(cfg["layers"])]
    sl, sg, _ = ptb_train(api, api.pt.Executor(dev), api.pt.Scope(), prog0,
                          start, [feed_dev], sgrads)
    cprog0 = ptb_lm_program(api, cfg, dropout=0.0, route="cudnn_lstm")
    rl, _, _ = ptb_train(api, api.pt.Executor(dev), api.pt.Scope(), cprog0,
                         _ptb_route_start(cprog0, cfg, start), [feed_dev])
    model, opt = _rnnlm_setup(tpt, dev, cfg, 0.0, state)
    b, t = cfg["batch"], cfg["steps"]
    logits, _ = model(feed_dev["x"], _rnnlm_states(cfg, dev))
    loss = tpt.nn.functional.cross_entropy(
        logits.reshape([b * t, -1]), feed_dev["y"].reshape([b * t, 1]))
    loss.backward()
    el = float(loss.detach())
    gerrs = []
    for k in range(cfg["layers"]):
        lstm = model.lstm
        w = torch.cat([getattr(lstm, f"weight_ih_l{k}").grad.T,
                       getattr(lstm, f"weight_hh_l{k}").grad.T], 0)
        for got, want in (
                (w.cpu().numpy(), sg[0][k]),
                (getattr(lstm, f"bias_ih_l{k}").grad.cpu().numpy(),
                 sg[0][cfg["layers"] + k]),
                (getattr(lstm, f"bias_hh_l{k}").grad.cpu().numpy(),
                 sg[0][cfg["layers"] + k])):
            gerrs.append(float(np.linalg.norm(got - want) /
                               np.linalg.norm(want)))
    del model, opt
    route = {"static_rnn": abs(el - sl[0]) / abs(sl[0]),
             "cudnn_lstm": abs(el - rl[0]) / abs(rl[0])}
    print(f"[rnnlm_eager] nn.LSTM route against the static script's routes "
          f"on the card from the same weights, dropout 0: loss {el!r}, "
          f"StaticRNN "
          f"{sl[0]!r} (rel err {route['static_rnn']:.3e}), cudnn_lstm "
          f"{rl[0]!r} (rel err {route['cudnn_lstm']:.3e}; bound "
          f"{PTB_ROUTE_LOSS_RTOL:g}); LSTM gradients before the clip "
          f"against StaticRNN's (W, b_ih, b_hh a layer, of their norms) "
          + ", ".join(f"{e:.2e}" for e in gerrs)
          + f" (bound {PTB_ROUTE_GRAD_TOL:g})")
    check(max(route.values()) <= PTB_ROUTE_LOSS_RTOL,
          "nn.LSTM loss disagrees with the static routes")
    check(max(gerrs) <= PTB_ROUTE_GRAD_TOL, "nn.LSTM gradients disagree")

    # timing at dropout 0.65, with the clip
    torch.cuda.empty_cache()
    model, opt = _rnnlm_setup(tpt, dev, cfg, cfg["dropout"], state)
    feeds = [ptb_feeds(cfg, s, dev) for s in range(2)]
    carry = {"states": _rnnlm_states(cfg, dev), "i": 0}
    losses = []

    def step():
        loss, carry["states"] = rnnlm_step(
            tpt, model, opt, feeds[carry["i"] % 2], carry["states"])
        carry["i"] += 1
        losses.append(loss.detach())

    times = _timed_steps(step, 2, 5)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile_call(step)
    check(all(math.isfinite(float(v)) for v in losses), "a loss is not finite")
    med = sorted(times)[len(times) // 2]
    print(f"[rnnlm_eager] nn.LSTM, dropout {cfg['dropout']}, clip "
          f"{RNNLM_CLIP:g}: step_ms median {med:.3f} range {min(times):.3f}-"
          f"{max(times):.3f} over {len(times)} steps (2 warm-up), tokens/s "
          f"{tokens / med * 1e3:.1f}, peak memory {peak:.2f} GiB, losses "
          f"{float(losses[0]):.4f} -> {float(losses[-1]):.4f}; one profiled "
          f"step {prof['wall_ms']:.3f} ms: launches {prof['launches']}, host "
          f"syncs {prof['syncs']}, device busy {prof['busy_ms']:.3f} ms, idle "
          f"share {1 - prof['busy_ms'] / prof['wall_ms']:.3f}; top kernels "
          + ", ".join(f"{k[:50]} {v:.3f}" for k, v in prof["top_kernels"])
          + f"; {card_line()}")
    del model, opt
    torch.cuda.empty_cache()
    return med


SENTIMENT_LOSS_RTOL = 1e-5    # card against CPU, first step
SENTIMENT_GRAD_TOL = 1e-4     # each gradient, of its norm
# Adagrad's first update is about lr * sign(g): a gradient element at
# rounding noise can take either sign, so updates are held by norm
SENTIMENT_UPDATE_TOL = 1e-2


def phase_sentiment_lstm(tpt, dev):
    """The LoD-fed program of the sequence slice: the book's
    stacked_lstm_net at its widths (SENTIMENT; sentiment_program)
    trained by Adagrad(0.002).minimize through append_backward and
    Executor, fed a
    seeded ragged batch of 128 reviews of 32-512 tokens as flat rows + a
    level-1 LoD (the executor pads it beside words@seq_len; the three
    dynamic_lstm run their peepholes, the middle one reversed within
    each review). Card against CPU on the first step from the same
    startup values: loss within 1e-5 relative, each parameter's gradient
    within 1e-4 of its norm, each update within 1e-2 of its norm. Then
    2 warm-up and 5 timed steps on two batches: step_ms, tokens/s (real
    and padded), peak memory, and one profiled step's launches, host
    syncs and idle share."""
    api = port_static_api()
    cfg = SENTIMENT
    program = sentiment_program(api, cfg)
    main = program[0]
    lstm_ops = [o for o in main.global_block().ops if o.type == "lstm"]
    check(len(lstm_ops) == 3 and all(o.inputs.get("Length")
                                     for o in lstm_ops),
          "the LSTMs do not read the reviews' lengths")
    cpu_scope = api.pt.Scope()
    with api.pt.scope_guard(cpu_scope):
        api.pt.Executor("cpu").run(program[1], feed={}, fetch_list=[],
                                   scope=cpu_scope)
    start = {n: cpu_scope.find_var(n).get().numpy()
             for n in sentiment_params(main)}
    params = [n for n in start if n + "@GRAD" in main.global_block().vars]
    n_params = sum(start[n].size for n in params)
    batches = [sentiment_batch(cfg, s) for s in range(2)]
    real = [int(b[1][0][-1]) for b in batches]
    padded = [cfg["batch"] * int(np.diff(b[1][0]).max()) for b in batches]
    grads_of = [n + "@GRAD" for n in params]
    got = []
    for device in ("cpu", dev):
        exe, scope = api.pt.Executor(device), api.pt.Scope()
        t0 = time.perf_counter()
        with api.pt.scope_guard(scope):
            exe.run(program[1], feed={}, fetch_list=[], scope=scope)
            for n, v in start.items():
                scope.var(n).set(api.pt.TpuTensor(torch.from_numpy(v).to(
                    device)))
            out = exe.run(main, feed=sentiment_feed(api, batches[0], device),
                          fetch_list=[program[2]] + grads_of, scope=scope)
            after = {n: scope.find_var(n).get().numpy() for n in params}
        got.append((float(np.asarray(out[0]).ravel()[0]),
                    dict(zip(params, out[1:])), after,
                    time.perf_counter() - t0))
    (cl, cg, cp, cpu_s), (gl, gg, gp, _) = got
    loss_err = abs(gl - cl) / abs(cl)
    gerrs = {n: float(np.linalg.norm(gg[n] - cg[n]) /
                      max(np.linalg.norm(cg[n]), 1e-30)) for n in params}
    uerrs = update_errors(gp, cp, {n: start[n] for n in params})
    gw, uw = max(gerrs, key=gerrs.get), max(uerrs, key=uerrs.get)
    print(f"[sentiment_lstm] stacked_lstm_net (vocab {cfg['vocab']}, emb "
          f"{cfg['emb']}, hid {cfg['hid']}, {cfg['stacked']} LSTMs, "
          f"{n_params:,} parameters), batch {cfg['batch']} reviews of "
          f"{cfg['min_len']}-{cfg['max_len']} tokens ({real[0]} tokens, "
          f"padded to {padded[0]}), first step: loss card {gl!r} cpu {cl!r}, "
          f"rel err {loss_err:.3e} (bound {SENTIMENT_LOSS_RTOL:g}); worst "
          f"gradient error {gerrs[gw]:.3e} ({gw}, bound "
          f"{SENTIMENT_GRAD_TOL:g}); worst update error {uerrs[uw]:.3e} "
          f"({uw}, bound {SENTIMENT_UPDATE_TOL:g}); the CPU step took "
          f"{cpu_s:.2f} s")
    check(loss_err <= SENTIMENT_LOSS_RTOL, "card loss disagrees with the CPU")
    check(gerrs[gw] <= SENTIMENT_GRAD_TOL, "card gradients disagree")
    check(uerrs[uw] <= SENTIMENT_UPDATE_TOL, "card updates disagree")

    exe, scope = api.pt.Executor(dev), api.pt.Scope()
    feeds = [sentiment_feed(api, b, dev) for b in batches]
    losses = []
    with api.pt.scope_guard(scope):
        exe.run(program[1], feed={}, fetch_list=[], scope=scope)
        for n, v in start.items():
            scope.var(n).set(api.pt.TpuTensor(torch.from_numpy(v).to(dev)))
        it = iter(range(10 ** 6))

        def step():
            out = exe.run(main, feed=feeds[next(it) % 2],
                          fetch_list=[program[2]], scope=scope,
                          return_numpy=False)
            losses.append(out[0].value)

        times = _timed_steps(step, 2, 5)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        prof = profile_call(step)
    check(all(math.isfinite(float(v)) for v in losses), "a loss is not finite")
    med = sorted(times)[len(times) // 2]
    print(f"[sentiment_lstm] step_ms median {med:.3f} range "
          f"{min(times):.3f}-{max(times):.3f} over {len(times)} steps (2 "
          f"warm-up), tokens/s {sum(real) / 2 / med * 1e3:.1f} (padded "
          f"{sum(padded) / 2 / med * 1e3:.1f}), peak memory {peak:.2f} GiB, "
          f"losses {float(losses[0]):.4f} -> {float(losses[-1]):.4f}; one "
          f"profiled step {prof['wall_ms']:.3f} ms: launches "
          f"{prof['launches']}, host syncs {prof['syncs']}, device busy "
          f"{prof['busy_ms']:.3f} ms, idle share "
          f"{1 - prof['busy_ms'] / prof['wall_ms']:.3f}; top kernels "
          + ", ".join(f"{k[:50]} {v:.3f}" for k, v in prof["top_kernels"])
          + f"; {card_line()}")
    return med


def lod_beam_step(device):
    """decode_cases' true-LoD beam_search step through the port's op on
    ``device``: (selected ids, selected scores, their LoD)."""
    from paddle_tpu_torch.core import lodctx
    from paddle_tpu_torch.core import program as port_program
    from paddle_tpu_torch.core.registry import OpInfoMap
    from paddle_tpu_torch.testing import decode_cases as dc
    lod = dc.LOD_STEP["lod"]
    ins = {s: [torch.from_numpy(v).to(device) for v in vs]
           for s, vs in dc.LOD_STEP["inputs"].items()}
    with lodctx.lod_scope({"pi": lod, "ps": lod}), lodctx.op_scope(
            dc.lod_step_op(port_program)):
        out = OpInfoMap.instance().get("beam_search").compute(
            ins, dict(dc.LOD_STEP["attrs"]))
        return (out["selected_ids"][0], out["selected_scores"][0],
                lodctx.get_lod("si"))


def lod_backtrace(device):
    """beam_search_decode over decode_cases' tensor arrays of LoD entries
    through the port's op on ``device``: (sentence ids, scores, LoD)."""
    from paddle_tpu_torch.core import lodctx
    from paddle_tpu_torch.core import program as port_program
    from paddle_tpu_torch.core.registry import OpInfoMap
    from paddle_tpu_torch.ops.array_ops import LoDTensorArrayValue
    from paddle_tpu_torch.testing import decode_cases as dc
    ids, scores = dc.lod_arrays()
    desc = port_program.OpDesc(
        "beam_search_decode", {"Ids": ["ia"], "Scores": ["sa"]},
        {"SentenceIds": ["so"], "SentenceScores": ["sc"]},
        {"beam_size": 2, "end_id": 9})
    with lodctx.lod_scope({}), lodctx.op_scope(desc):
        out = OpInfoMap.instance().get("beam_search_decode").compute(
            {"Ids": [LoDTensorArrayValue(
                (torch.from_numpy(v).to(device), l) for v, l in ids)],
             "Scores": [LoDTensorArrayValue(
                 (torch.from_numpy(v).to(device), l) for v, l in scores)]},
            dict(desc.attrs))
        return (out["SentenceIds"][0], out["SentenceScores"][0],
                lodctx.get_lod("so"))


def phase_decode_ops(dev):
    """The 27 op types of the decoding slice (decode_ops, fusion_ops,
    long_tail_ops, fusion_seqpool_cvm_concat, deformable_conv_v1): every
    case of decode_cases on the card against the port on the CPU at each
    case's bound, forward and gradient (warpctc through torch's CTC,
    an infeasible label at the reference's floor; sampling_id and
    random_crop draw on the CPU, so their draws are equal); the true-LoD
    beam_search step and beam_search_decode over LoD tensor arrays; the
    book's beam decode program (While, beam_search over LoD arrays,
    beam_search_decode) through the Executor, ids and LoD equal; then
    the host syncs of one call of each type's first case."""
    from paddle_tpu_torch.testing import decode_cases as dc
    worst = {}
    types_seen = hold_cases(dc.DECODE_CASES, dev, worst)
    by_type = dict.fromkeys(sorted(types_seen), 0.0)   # integer ones: equal
    for k, v in worst.items():
        t = next(c.op for c in dc.DECODE_CASES if k.startswith(c.id + "."))
        by_type[t] = max(by_type[t], v)
    lod_syncs = {}
    for name, run in (("beam_search (LoD)", lod_beam_step),
                      ("beam_search_decode (arrays)", lod_backtrace)):
        (gi, gs, gl), (wi, ws, wl) = run(dev), run("cpu")
        check(torch.equal(gi.cpu(), wi) and gl == wl and torch.allclose(
            gs.cpu(), ws, rtol=1e-6, atol=0.0), f"{name} differs on the card")
        lod_syncs[name] = profile_call(lambda: run(dev))["syncs"]
    api = port_static_api()
    runs = []
    for device in (dev, "cpu"):
        def tensor(v, lod, device=device):
            return api.pt.TpuTensor(v, lod, device=device)
        runs.append(dc.mt_decode_run(api, api.pt.Executor(device),
                                     tensor)[2])
    ((gi, gl), (gs, _)), ((wi, wl), (ws, _)) = runs
    check(np.array_equal(gi, wi) and gl == wl and
          np.allclose(gs, ws, rtol=1e-5, atol=1e-6),
          "the beam decode program differs on the card")
    first = {}
    for c in dc.DECODE_CASES:
        first.setdefault(c.op, c.id)
    by_case = case_syncs(dc.DECODE_CASES, first.values(), dev)
    syncs = {op: by_case[cid] for op, cid in sorted(first.items())}
    print(f"[decode_ops] {len(dc.DECODE_CASES)} cases of {len(types_seen)} "
          f"op types on the card against the CPU: all agree; largest float "
          f"error by type "
          + ", ".join(f"{k} {v:.2e}" for k, v in by_type.items())
          + f"; the LoD beam step and array backtrace equal; the book's "
          f"beam decode {len(gl[0]) - 1} sources, {len(gl[1]) - 1} "
          f"sentences, {gi.size} tokens, equal; host syncs of one call of "
          f"each type's first case on inputs already on the card: "
          + ", ".join(f"{k} {n}" for k, n in {**syncs, **lod_syncs}.items()))
    check(len(types_seen) == 27, f"{len(types_seen)} op types checked")


# ------------------------------------------------------------ CRNN
# Shi, Bai and Yao, "An End-to-End Trainable Neural Network for
# Image-based Sequence Recognition" (arXiv:1507.05717), Table 1: gray
# 1x32x100 images, seven convolutions (the last 2x2 without padding),
# BatchNorm after the fifth and sixth, pools 2x2/2 twice then (2, 2)
# stride (2, 1) padding (0, 1) twice, so the map is 512x1x26 (T = 26);
# two bidirectional LSTMs of 256, a projection onto 36 alphanumerics and
# the blank; CTC; Adadelta (rho 0.9, lr 1.0, section 3.3); batch 256 as
# PaddleOCR's CTC recognizers train a card.
CRNN = dict(channels=(64, 128, 256, 256, 512, 512, 512), hidden=256,
            classes=37, height=32, width=100, batch=256, min_len=3,
            max_len=12, rho=0.9, epsilon=1e-6, lr=1.0)
CRNN_LOSS_RTOL = 1e-4        # card against CPU, first step
# each gradient and update of its norm: cuDNN's fp32 convolutions sum in
# other orders than the CPU's, and the batch norms amplify it; the first
# convolution's gradient and update read 1.8e-3 and 3.3e-3 on an H100,
# so the bound leaves 3x over the worst
CRNN_GRAD_TOL = 1e-2
CRNN_UPDATE_TOL = 1e-2
# the step's device time by aten op family (device_us_by_family)
CRNN_FAMILIES = {"conv": ("convolution",), "lstm": ("lstm", "_cudnn_rnn"),
                 "ctc": ("ctc",), "linear": ("linear", "mm", "matmul"),
                 "batch_norm": ("batch_norm",),
                 "pool": ("max_pool",)}


def crnn_model(nn, api, channels=CRNN["channels"], hidden=CRNN["hidden"],
               classes=CRNN["classes"]):
    """The CRNN of Table 1 as a user writes it against ``nn`` (either
    package's): its forward takes gray images [B, 1, 32, W] and gives
    the per-column class scores [B, T, classes] (raw; CTC applies the
    softmax). A convolution followed by BatchNorm has no bias (the norm
    cancels it). ``api`` supplies squeeze and transpose
    (port_crnn_api)."""
    c = channels

    def conv(cin, cout, k=3, pad=1, bn=False):
        layers = [nn.Conv2D(cin, cout, k, padding=pad,
                            bias_attr=False if bn else None)]
        if bn:
            layers.append(nn.BatchNorm2D(cout))
        return layers + [nn.ReLU()]

    class CRNN_(nn.Layer):
        def __init__(self):
            super().__init__()
            self.cnn = nn.Sequential(
                *conv(1, c[0]), nn.MaxPool2D(2, 2),
                *conv(c[0], c[1]), nn.MaxPool2D(2, 2),
                *conv(c[1], c[2]), *conv(c[2], c[3]),
                nn.MaxPool2D((2, 2), (2, 1), (0, 1)),
                *conv(c[3], c[4], bn=True), *conv(c[4], c[5], bn=True),
                nn.MaxPool2D((2, 2), (2, 1), (0, 1)),
                *conv(c[5], c[6], k=2, pad=0))
            self.rnn = nn.LSTM(c[6], hidden, num_layers=2,
                               direction="bidirectional")
            self.fc = nn.Linear(2 * hidden, classes)

        def forward(self, img):
            feat = api.squeeze(self.cnn(img), axis=[2])       # [B, C, T]
            seq, _ = self.rnn(api.transpose(feat, [0, 2, 1]))
            return self.fc(seq)

    return CRNN_()


def port_crnn_api():
    """The port's surface as the CRNN script takes it (the CPU test hands
    it the JAX package's)."""
    import types
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.dygraph.tracer import trace_op
    from paddle_tpu_torch.optimizer import Adadelta
    return types.SimpleNamespace(
        nn=nn, Adadelta=Adadelta, squeeze=pt.squeeze, full=pt.full,
        argmax=pt.argmax, to_tensor=pt.to_tensor, trace_op=trace_op,
        transpose=lambda x, perm: x.permute(perm))


def crnn_batch(rs, batch, cfg=CRNN):
    """A seeded batch: gray images [B, 1, 32, W] of noise, labels [B,
    max_len] of ids 1-36 (0, the blank, pads) with lengths min_len to
    max_len, each of which fits T with its repeats (checked)."""
    t = cfg["width"] // 4 + 1
    imgs = rs.uniform(-1.0, 1.0, (batch, 1, cfg["height"], cfg["width"])) \
        .astype(np.float32)
    lens = rs.randint(cfg["min_len"], cfg["max_len"] + 1, batch)
    labels = np.zeros((batch, cfg["max_len"]), np.int64)
    for i, n in enumerate(lens):
        labels[i, :n] = rs.randint(1, cfg["classes"], n)
        need = n + int((labels[i, 1:n] == labels[i, :n - 1]).sum())
        check(need <= t, f"label {i} needs {need} steps of {t}")
    return imgs, labels, lens.astype(np.int64)


def crnn_opt(api, model, cfg=CRNN):
    return api.Adadelta(learning_rate=cfg["lr"], rho=cfg["rho"],
                        epsilon=cfg["epsilon"],
                        parameters=model.parameters())


def crnn_step(api, model, loss_fn, opt, imgs, labels, lens, grads_of=None):
    """One training step of the user script: forward, CTC over every
    column (input lengths T), backward, the Adadelta update. With
    ``grads_of`` (a dict), each parameter's gradient before the update
    goes into it by name. Returns the loss."""
    logits = model(imgs)
    b, t = logits.shape[0], logits.shape[1]
    loss = loss_fn(logits, labels, api.full([b], t, dtype="int64"), lens)
    loss.backward()
    if grads_of is not None:
        for name, p in model.named_parameters():
            grads_of[name] = np.asarray(p.gradient())
    opt.step()
    opt.clear_grad()
    return loss


def crnn_decode(api, logits, labels, lens):
    """Greedy CTC decode and its metric through the eager op entry:
    argmax over the classes, ctc_align (InputLength T), edit_distance
    (HypsLength / RefsLength, normalized). Returns (decoded ids [B, T],
    their lengths [B, 1], normalized distances [B, 1])."""
    ids = api.argmax(logits, axis=-1)
    b, t = ids.shape[0], ids.shape[1]
    out, out_len = api.trace_op(
        "ctc_align", {"Input": [ids],
                      "InputLength": [api.full([b, 1], t, dtype="int64")]},
        {"blank": 0, "padding_value": 0}, out_slots=["Output",
                                                     "OutputLength"])
    dist = api.trace_op(
        "edit_distance", {"Hyps": [out], "Refs": [labels],
                          "HypsLength": [out_len], "RefsLength": [lens]},
        {"normalized": True}, out_slots=["Out"])[0]
    return out, out_len, dist


def crnn_label_bias(rs, labels, lens, t, classes):
    """A seeded bias [B, T, classes] that steers greedy decoding toward
    each label, so a decode of the biased logits keeps characters,
    merges repeats and misses some: label character j gets a weight of
    0.5-2 at column 2j; column 2j + 1 repeats it with probability 0.4
    (merged by ctc_align) or holds a random character with probability
    0.1 (an insertion). Scaled by the logits' range, a weight over 1
    always wins its column, one under 1 may lose it to the blank."""
    check(2 * max(lens) <= t, f"labels of {max(lens)} need {2 * max(lens)} "
                              f"columns of {t}")
    bias = np.zeros((len(labels), t, classes), np.float32)
    for i, n in enumerate(lens):
        for j in range(n):
            bias[i, 2 * j, labels[i, j]] = rs.uniform(0.5, 2.0)
            u = rs.rand()
            if u < 0.4:
                bias[i, 2 * j + 1, labels[i, j]] = rs.uniform(0.5, 2.0)
            elif u < 0.5:
                bias[i, 2 * j + 1, rs.randint(1, classes)] = \
                    rs.uniform(0.5, 2.0)
    return bias


def crnn_conv_flops(cfg=CRNN):
    """Multiply-adds x 2 of the convolutions for one image, forward."""
    h, w, cin, total = cfg["height"], cfg["width"], 1, 0
    for i, cout in enumerate(cfg["channels"]):
        k = 2 if i == 6 else 3
        oh, ow = (h - 1, w - 1) if i == 6 else (h, w)
        total += 2 * oh * ow * cout * cin * k * k
        h, w, cin = oh, ow, cout
        if i in (0, 1):
            h, w = h // 2, w // 2
        elif i in (3, 5):
            h, w = h // 2, w + 1
    return total


def _crnn_setup(tpt, device, state, cfg=CRNN):
    from paddle_tpu_torch.convert import load_state_dict
    api = port_crnn_api()
    tpt.set_device(device)
    model = crnn_model(api.nn, api, cfg["channels"], cfg["hidden"],
                       cfg["classes"])
    load_state_dict(model, state)
    return api, model, api.nn.CTCLoss(blank=0), crnn_opt(api, model, cfg)


def phase_crnn(tpt, dev):
    """The main path of the decoding slice: the CRNN text recognizer of
    Table 1 (crnn_model: 1x32x100 gray images, seven convolutions,
    BatchNorm after the fifth and sixth, two bidirectional LSTMs of 256,
    37 classes), trained eagerly with nn.CTCLoss and Adadelta(rho 0.9,
    lr 1.0) on seeded images and labels of 3-12 characters, fp32, TF32
    off, cudnn.benchmark on. Card against CPU at batch 32, one step from
    the same weights: the loss within 1e-4 relative, each gradient and
    update within 1e-2 of its norm. Then batch 256: 3 warm-up and 20
    timed steps (step_ms, images/s, peak memory), one profiled step's
    launches, host syncs, device busy and idle, and another step's
    device time by op family (the convolutions' FLOPs over their own
    device time). Then a held-out batch: greedy decode (argmax,
    ctc_align) and normalized edit distance through the eager op entry,
    of the network's logits and of the same with crnn_label_bias (which
    keeps characters, merges repeats and misses some), the decoded ids,
    lengths and distances equal on the card and the CPU from the same
    logits; the mean distance and the share of exact matches."""
    cfg = CRNN
    torch.backends.cudnn.benchmark = True
    tpt.set_device("cpu")
    tpt.seed(0)
    api = port_crnn_api()
    start = crnn_model(api.nn, api, cfg["channels"], cfg["hidden"],
                       cfg["classes"])
    state = {k: v.detach().numpy().copy()
             for k, v in start.state_dict().items()}
    n_params = sum(p.numel() for p in start.parameters())
    del start
    rs = np.random.RandomState(0)
    small = crnn_batch(rs, 32, cfg)
    got = []
    for device in ("cpu", dev):
        api, model, loss_fn, opt = _crnn_setup(tpt, device, state, cfg)
        grads = {}
        t0 = time.perf_counter()
        loss = crnn_step(api, model, loss_fn, opt,
                         *[torch.from_numpy(v).to(device) for v in small],
                         grads_of=grads)
        after = {k: v.detach().cpu().numpy()
                 for k, v in model.state_dict().items()}
        got.append((float(loss.detach()), grads, after,
                    time.perf_counter() - t0))
        del model, opt
    (cl, cg, cp, cpu_s), (gl, gg, gp, _) = got
    loss_err = abs(gl - cl) / abs(cl)
    gerrs = {n: float(np.linalg.norm(gg[n] - cg[n]) /
                      max(np.linalg.norm(cg[n]), 1e-30)) for n in cg}
    uerrs = update_errors({n: gp[n] for n in cg}, {n: cp[n] for n in cg},
                          state)
    gw, uw = max(gerrs, key=gerrs.get), max(uerrs, key=uerrs.get)
    print(f"[crnn] CRNN (arXiv:1507.05717 Table 1, {n_params:,} parameters)"
          f", batch 32, first step from the same weights: loss card {gl!r} "
          f"cpu {cl!r}, rel err {loss_err:.3e} (bound {CRNN_LOSS_RTOL:g}); "
          f"worst gradient error {gerrs[gw]:.3e} ({gw}, bound "
          f"{CRNN_GRAD_TOL:g}); worst update error {uerrs[uw]:.3e} ({uw}, "
          f"bound {CRNN_UPDATE_TOL:g}); the CPU step took {cpu_s:.2f} s")
    check(loss_err <= CRNN_LOSS_RTOL, "card loss disagrees with the CPU")
    check(gerrs[gw] <= CRNN_GRAD_TOL, "card gradients disagree")
    check(uerrs[uw] <= CRNN_UPDATE_TOL, "card updates disagree")

    # batch 256 on the card
    api, model, loss_fn, opt = _crnn_setup(tpt, dev, state, cfg)
    batches = [[torch.from_numpy(v).to(dev) for v in crnn_batch(
        np.random.RandomState(s), cfg["batch"], cfg)] for s in (1, 2)]
    losses, it = [], iter(range(10 ** 6))

    def step():
        losses.append(crnn_step(api, model, loss_fn, opt,
                                *batches[next(it) % 2]).detach())

    times = _timed_steps(step, 3, 20)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile_call(step)
    fams = {k: v / 1e3 for k, v in device_us_by_family(step, CRNN_FAMILIES)
            .items()}
    check(all(math.isfinite(float(v)) for v in losses), "a loss is not finite")
    med = sorted(times)[len(times) // 2]
    flops = 3 * crnn_conv_flops(cfg) * cfg["batch"]
    print(f"[crnn] batch {cfg['batch']}: step_ms median {med:.3f} range "
          f"{min(times):.3f}-{max(times):.3f} over {len(times)} steps (3 "
          f"warm-up), images/s {cfg['batch'] / med * 1e3:.1f}, peak memory "
          f"{peak:.2f} GiB, losses {float(losses[0]):.4f} -> "
          f"{float(losses[-1]):.4f}; one profiled step {prof['wall_ms']:.3f} "
          f"ms: launches {prof['launches']}, host syncs {prof['syncs']}, "
          f"device busy {prof['busy_ms']:.3f} ms, idle share "
          f"{1 - prof['busy_ms'] / prof['wall_ms']:.3f}; top kernels "
          + ", ".join(f"{k[:50]} {v:.3f}" for k, v in prof["top_kernels"])
          + f"; {card_line()}")
    print(f"[crnn] device ms of another step by op family (forward and "
          f"backward): " + ", ".join(f"{k} {v:.3f}" for k, v in fams.items())
          + f"; the convolutions' {flops / 1e12:.4f} TFLOP (3x the "
          f"forward's {crnn_conv_flops(cfg):,} FLOPs an image) run at "
          f"{flops / fams['conv'] / 1e9:.2f} TFLOP/s of their own device "
          f"time (fp32 peak 67, TF32 off); {card_line()}")

    # greedy decode of a held-out batch, card against CPU on the same
    # logits: the network's own, and the same with crnn_label_bias, since
    # a net trained a few steps on noise decodes every column to the blank
    rs = np.random.RandomState(3)
    imgs, labels, lens = crnn_batch(rs, cfg["batch"], cfg)
    model.eval()
    with tpt.dygraph.no_grad():
        logits = model(torch.from_numpy(imgs).to(dev))
    bias = crnn_label_bias(rs, labels, lens, logits.shape[1], cfg["classes"])
    biased = logits + (logits.max() - logits.min()) * torch.from_numpy(
        bias).to(dev)
    for name, lg in (("network", logits), ("label-biased", biased)):
        dec = []
        for device in (dev, "cpu"):
            tpt.set_device(device)
            dec.append([v.cpu() for v in crnn_decode(
                api, lg.to(device), torch.from_numpy(labels).to(device),
                torch.from_numpy(lens).to(device))])
        tpt.set_device(dev)
        same = all(torch.equal(a, b) for a, b in zip(*dec))
        ids = lg.argmax(-1).cpu()
        merged = int(((ids[:, 1:] == ids[:, :-1]) & (ids[:, 1:] != 0)).sum())
        kept, dist = dec[1][1].numpy().ravel(), dec[1][2].numpy().ravel()
        print(f"[crnn] held-out batch of {cfg['batch']}, {name} logits: "
              f"greedy decode (argmax, ctc_align) and edit_distance through "
              f"trace_op, card against CPU on the same logits: ids, lengths "
              f"and distances {'equal' if same else 'DIFFER'}; repeats "
              f"merged {merged}, characters kept {int(kept.sum())}, mean "
              f"normalized edit distance {dist.mean():.4f}, exact matches "
              f"{(dist == 0).mean():.4f}"
              + (f" (random weights after {len(losses)} steps on 2 batches "
                 f"of noise)" if name == "network" else ""))
        check(same, f"greedy decode of the {name} logits differs on the card")
    check(merged > 0 and (kept > 0).mean() > 0.5 and 0 < dist.mean() < 1,
          "the label-biased decode merges no repeat, keeps no character in "
          "most rows, or is all right or all wrong")
    del model, opt
    torch.cuda.empty_cache()
    return med

# ------------------------------------------------- two-stage detection
def host_call_ms(fn, n=5):
    """Mean wall ms of ``n`` calls of fn, each closed by a device sync,
    after one call (host-side ops read and wait: the host clock times
    them whole)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def phase_rcnn_ops(dev):
    """The 15 op types of the two-stage detection slice (rcnn_ops): every
    case of rcnn_cases on the card against the port on the CPU, index and
    label outputs equal, floats at each case's bound; then, for the
    first case of each type, the host syncs of one call on inputs
    already on the card and its ms a call (host clock, each call closed
    by a sync)."""
    from paddle_tpu_torch.core.registry import OpInfoMap
    from paddle_tpu_torch.testing import rcnn_cases as rc
    worst = {}
    types_seen = hold_cases(rc.RCNN_CASES, dev, worst)
    by_type = dict.fromkeys(sorted(types_seen), 0.0)   # integer ones: equal
    for k, v in worst.items():
        t = next(c.op for c in rc.RCNN_CASES if k.startswith(c.id + "."))
        by_type[t] = max(by_type[t], v)
    first = {}
    for c in rc.RCNN_CASES:
        first.setdefault(c.op, c)
    syncs = case_syncs(rc.RCNN_CASES, [c.id for c in first.values()], dev)
    ms = {}
    for op, case in sorted(first.items()):
        ins = {s: [torch.from_numpy(np.array(v)).to(dev) for v in vs]
               for s, vs in case.inputs.items()}
        with case_env(case, dev) as attrs:
            compute = OpInfoMap.instance().get(op).compute
            ms[op] = host_call_ms(lambda: compute(ins, dict(attrs)))
    print(f"[rcnn_ops] {len(rc.RCNN_CASES)} cases of {len(types_seen)} op "
          f"types on the card against the CPU: all agree; largest float "
          f"error by type " + ", ".join(f"{k} {v:.2e}"
                                        for k, v in by_type.items()))
    print("[rcnn_ops] first case of each type on inputs already on the "
          "card: host syncs and ms a call: "
          + ", ".join(f"{op} {syncs[c.id]} / {ms[op]:.3f}"
                      for op, c in sorted(first.items()))
          + f"; {card_line()}")
    check(len(types_seen) == 15, f"{len(types_seen)} op types checked")


FRCNN_LOSS_RTOL = 1e-3       # card against CPU, the first step's losses
FRCNN_FAMILIES = {"conv": ("convolution",), "roi_align": ("op:roi_align",),
                  "affine_channel": ("op:affine_channel",),
                  "rcnn_ops": tuple("op:" + t for t in (
                      "generate_proposals", "rpn_target_assign",
                      "generate_proposal_labels")),
                  "momentum": ("op:momentum",)}


def _op_io(program, op_type):
    """The first ``op_type`` op of the program: ({slot: input names},
    {slot: output names})."""
    op = next(o for o in program.global_block().ops if o.type == op_type)
    return ({s: list(v) for s, v in op.inputs.items()},
            {s: list(v) for s, v in op.outputs.items()})


def op_cpu_ms(fn, types):
    """Host ms inside each op type's "op:<type>" range (op_ranges) over
    one call of fn: what a host-side op costs the step whole, its reads
    and waits included."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    torch.cuda.synchronize()
    with op_ranges(), torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    total = dict.fromkeys(types, 0.0)
    for e in prof.events():
        if e.name.startswith("op:") and e.name[3:] in total:
            total[e.name[3:]] += (e.time_range.end - e.time_range.start) / 1e3
    return total


def phase_faster_rcnn(tpt, dev, cfg=None):
    """The main path of the two-stage detection slice: the fluid Faster
    R-CNN R50-C4 1x of PaddleDetection (rcnn_cases.FRCNN: ResNet-50 to
    res4 with frozen affine_channel norms, stem and res2 frozen, the RPN
    head over 15 anchors a cell, rpn_target_assign, generate_proposals
    (12,000 / 2,000, NMS 0.7), generate_proposal_labels (512 RoIs, 81
    classes), RoIAlign 14x14, the res5 head, Momentum 0.9 with L2 1e-4 at
    lr 0.01 / 3) at 800 x 1333, one image, fp32, TF32 off, cudnn.benchmark
    on, through static.Executor. Step 1 on the card against the CPU:
    rpn_target_assign's outputs equal on the card's inputs (its anchors
    come from anchor_generator, its gt is fed), generate_proposals and
    generate_proposal_labels run on the CPU on the card's own inputs give
    equal indices and boxes within 1e-5, and the four losses of the CPU's
    forward from the same weights within FRCNN_LOSS_RTOL. Then 2 warm-up
    and 10 timed steps on seeded images (step_ms, images/s, peak
    memory), a profiled step (launches, host syncs, busy and idle), the
    host ms of each rcnn op inside a step and the device ms by kernel
    family; then the test-settings forward (proposals 6,000 / 1,000,
    box_coder decode, multiclass_nms 0.05 / 100 / 0.5, detection_map
    against the gt), timed."""
    from paddle_tpu_torch.core.registry import OpInfoMap
    from paddle_tpu_torch.device import op_device
    from paddle_tpu_torch.testing import rcnn_cases as rc
    cfg = cfg or rc.FRCNN
    api = rc.port_api()
    tpt.set_device(dev)
    tpt.seed(0)
    torch.backends.cudnn.benchmark = True
    t0 = time.perf_counter()
    main, startup, names = rc.faster_rcnn_program(api, cfg)
    build_s = time.perf_counter() - t0
    exe, scope = api.pt.Executor(), api.pt.Scope()
    exe.run(startup, scope=scope)
    params = [n for n in startup.global_block().vars
              if main.global_block().vars[n].persistable and "@" not in n
              and not n.startswith("learning_rate")]
    n_params = sum(scope.find_var(n).get().value.numel() for n in params)
    start = {n: scope.find_var(n).get().value.detach().cpu() for n in params}
    feeds = [rc.frcnn_feed(cfg, s) for s in range(4)]

    # step 1, with the sampling ops' inputs and outputs
    io = {t: _op_io(main, t) for t in ("rpn_target_assign",
                                       "generate_proposals",
                                       "generate_proposal_labels")}
    extra = sorted({n for ins, outs in io.values()
                    for v in (*ins.values(), *outs.values()) for n in v})
    losses = [names[k] for k in ("loss", "rpn_cls", "rpn_reg", "rcnn_cls",
                                 "rcnn_reg")]
    out = exe.run(main, feed=feeds[0], fetch_list=losses + extra,
                  scope=scope, return_numpy=False)
    card = dict(zip(losses + extra, [v.value for v in out]))
    first = [float(card[n].reshape(-1)[0]) for n in losses]
    report = {}
    for t, (ins, outs) in io.items():
        cpu_in = {s: [card[n].cpu() for n in v] for s, v in ins.items()}
        op = next(o for o in main.global_block().ops if o.type == t)
        attrs = {k: v for k, v in op.attrs.items() if not k.startswith("__")}
        with op_device("cpu"):
            want = OpInfoMap.instance().get(t).compute(cpu_in, attrs)
        errs = []
        for slot, vs in outs.items():
            for n, w in zip(vs, want[slot]):
                g = card[n].cpu()
                check(g.shape == w.shape and g.dtype == w.dtype,
                      f"{t}.{slot}: {g.shape} {g.dtype} on the card, "
                      f"{w.shape} {w.dtype} on the CPU")
                if w.is_floating_point():
                    err = (g - w).abs().max().item() if w.numel() else 0.0
                    errs.append(err)
                    check(torch.allclose(g, w, rtol=1e-5, atol=1e-5),
                          f"{t}.{slot} differs on the card: {err:.3e}")
                else:
                    check(torch.equal(g, w), f"{t}.{slot} differs on the "
                                             f"card")
        report[t] = (max(errs) if errs else 0.0,
                     {s: tuple(card[v[0]].shape) for s, v in outs.items()})
    print(f"[faster_rcnn] Faster R-CNN R50-C4 (PaddleDetection "
          f"faster_rcnn_r50_1x, {n_params:,} parameters, 800 x 1333, 81 "
          f"classes): program built in {build_s:.2f} s, "
          f"{len(main.global_block().ops)} ops; step 1 on the card against "
          f"the CPU on the card's inputs: " + "; ".join(
              f"{t} indices and labels equal, floats max abs {e:.2e}, "
              + ", ".join(f"{s} {sh}" for s, sh in shapes.items())
              for t, (e, shapes) in report.items()))

    # the first step's losses on the CPU from the same weights and image
    tpt.set_device("cpu")
    cmain, cstart, cnames = rc.faster_rcnn_program(api, cfg, mode="loss")
    cscope = api.pt.Scope()
    for n, v in start.items():
        cscope.var(n).set(api.pt.TpuTensor(v))
    t0 = time.perf_counter()
    cpu = api.pt.Executor("cpu").run(
        cmain, feed=feeds[0], fetch_list=[cnames[k] for k in (
            "loss", "rpn_cls", "rpn_reg", "rcnn_cls", "rcnn_reg")],
        scope=cscope)
    cpu_s = time.perf_counter() - t0
    cpu = [float(np.asarray(v).reshape(-1)[0]) for v in cpu]
    tpt.set_device(dev)
    rel = [abs(g - c) / max(abs(c), 1e-12) for g, c in zip(first, cpu)]
    print(f"[faster_rcnn] step 1 losses (total, rpn_cls, rpn_reg, rcnn_cls, "
          f"rcnn_reg): card {first}, CPU forward {cpu} ({cpu_s:.1f} s), "
          f"rel err max {max(rel):.3e} (bound {FRCNN_LOSS_RTOL:g})")
    check(all(math.isfinite(v) for v in first), "a first loss is not finite")
    check(max(rel) <= FRCNN_LOSS_RTOL, "card losses disagree with the CPU")
    del cscope, cmain

    # timed steps
    it = iter(range(10 ** 6))
    step_losses = []

    def step():
        v = exe.run(main, feed=feeds[1 + next(it) % 3],
                    fetch_list=[names["loss"]], scope=scope,
                    return_numpy=False)[0]
        step_losses.append(v.value)

    times = _timed_steps(step, 2, 10)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile_call(step)
    host = op_cpu_ms(step, ("generate_proposals", "rpn_target_assign",
                            "generate_proposal_labels", "roi_align",
                            "anchor_generator"))
    with op_ranges():
        fams = {k: v / 1e3 for k, v in device_us_by_family(
            step, FRCNN_FAMILIES).items()}
    vals = [float(v.reshape(-1)[0]) for v in step_losses]
    check(all(math.isfinite(v) for v in vals), "a loss is not finite")
    med = sorted(times)[len(times) // 2]
    moved = [n for n in params
             if not torch.equal(start[n], scope.find_var(n).get().value.cpu())]
    frozen = ("conv1_weights", "res2a_branch2a_weights", "bn4a_branch2a_scale")
    print(f"[faster_rcnn] step_ms median {med:.3f} range {min(times):.3f}-"
          f"{max(times):.3f} over {len(times)} steps (2 warm-up), images/s "
          f"{1e3 / med:.3f}, peak memory {peak:.2f} GiB, losses "
          f"{[round(v, 4) for v in vals]}; one profiled step "
          f"{prof['wall_ms']:.3f} ms: launches {prof['launches']}, host "
          f"syncs {prof['syncs']}, device busy {prof['busy_ms']:.3f} ms, "
          f"idle share {1 - prof['busy_ms'] / prof['wall_ms']:.3f}; "
          f"{len(moved)} of {len(params)} parameters moved; {card_line()}")
    print("[faster_rcnn] host ms inside each op of another step: "
          + ", ".join(f"{k} {v:.3f}" for k, v in host.items())
          + "; device ms by family (forward and backward): "
          + ", ".join(f"{k} {v:.3f}" for k, v in fams.items()))
    check("conv_rpn_w" in moved and "cls_score_w" in moved and
          "res4a_branch2a_weights" in moved and "res5a_branch2a_weights" in
          moved and not set(frozen) & set(moved),
          "a trained parameter did not move, or a frozen one did")

    # the test settings' forward
    tmain, _, tnames = rc.faster_rcnn_program(api, cfg, mode="test")
    nms_in, _ = _op_io(tmain, "multiclass_nms")
    nms_names = [nms_in["BBoxes"][0], nms_in["Scores"][0]]
    outs = []

    def infer():
        outs[:] = exe.run(tmain, feed=feeds[0], fetch_list=[
            tnames["proposals"], tnames["dets"], tnames["num"],
            tnames["map"]] + nms_names, scope=scope, return_numpy=False)

    infer_ms = host_call_ms(infer, 3)
    iprof = profile_call(infer)
    rois, dets, num, mean_ap = [v.value.cpu() for v in outs[:4]]
    h, w = cfg["image"]
    print(f"[faster_rcnn] test forward: {infer_ms:.3f} ms a call (host clock,"
          f" 3 calls after one), launches {iprof['launches']}, host syncs "
          f"{iprof['syncs']}, busy {iprof['busy_ms']:.3f} ms; {rois.shape[0]} "
          f"proposals, {int(num.reshape(-1)[0])} detections kept of "
          f"{cfg['nms_keep']} at score {cfg['nms_score']}, mAP "
          f"{float(mean_ap.reshape(-1)[0]):.4f}; {card_line()}")
    # a net trained a few steps on noise scores every foreground class
    # under the config's threshold: the same NMS and mAP on the forward's
    # own boxes and scores at the threshold that leaves 2,000 candidates,
    # card against CPU
    boxes, scores = [v.value for v in outs[4:]]
    fg = scores[0, 1:].reshape(-1).cpu()
    thresh = float(fg.sort(descending=True).values[
        min(2000, fg.numel()) - 1])
    g = feeds[0]
    gt_rows = np.concatenate([g["gt_label"].astype(np.float32),
                              g["gt_box"]], 1)
    nms_attrs = {"score_threshold": thresh, "nms_top_k": -1,
                 "keep_top_k": cfg["nms_keep"],
                 "nms_threshold": cfg["nms_thresh"], "normalized": False,
                 "background_label": 0}
    got = []
    for device in (dev, "cpu"):
        with op_device(device):
            res = OpInfoMap.instance().get("multiclass_nms").compute(
                {"BBoxes": [boxes.to(device)],
                 "Scores": [scores.to(device)]}, dict(nms_attrs))
            m = OpInfoMap.instance().get("detection_map").compute(
                {"DetectRes": [res["Out"][0].reshape(-1, 6)],
                 "Label": [torch.from_numpy(gt_rows).to(device)]},
                {"overlap_threshold": 0.5})["MAP"][0]
        got.append([v.cpu() for v in (res["Out"][0], res["NmsedNum"][0], m)])
    (gd, gn, gm), (cd, cn, cm) = got
    print(f"[faster_rcnn] multiclass_nms on the forward's {boxes.shape[1]} "
          f"boxes x {scores.shape[1]} classes at score {thresh:.6f}: "
          f"{int(gn[0])} kept, mAP {float(gm):.6f} against {len(gt_rows)} gt "
          f"boxes; detections, count and mAP "
          f"{'equal' if torch.equal(gd, cd) and torch.equal(gn, cn) and torch.equal(gm, cm) else 'DIFFER'}"
          f" on the card and the CPU")
    check(torch.equal(gd, cd) and torch.equal(gn, cn) and
          torch.equal(gm, cm), "multiclass_nms or detection_map differs on "
                               "the card")
    check(int(gn[0]) > 0, "no detection at the lowered threshold")
    check(0 < rois.shape[0] <= cfg["test_post_nms"], "proposal count")
    check(bool((rois[:, 0::2] >= 0).all() and (rois[:, 0::2] <= w - 1).all()
               and (rois[:, 1::2] >= 0).all() and (rois[:, 1::2] <= h - 1)
               .all()), "a proposal lies outside the image")
    check(tuple(dets.shape) == (1, cfg["nms_keep"], 6) and
          0 <= int(num.reshape(-1)[0]) <= cfg["nms_keep"] and
          bool(torch.isfinite(dets).all()), "detections")
    check(0.0 <= float(mean_ap.reshape(-1)[0]) <= 1.0, "mAP out of range")
    torch.backends.cudnn.benchmark = False
    del exe, scope
    torch.cuda.empty_cache()
    return med


# The base Transformer of Vaswani et al. 2017 (arXiv:1706.03762, Table 3
# "base", sections 3.4 and 5.1): 6 encoder and 6 decoder layers, d_model
# 512, 8 heads (head dim 64), FFN 2048 with ReLU, post-norm, dropout 0.1
# (off here: eval), a source and target vocabulary of 37,000 shared, the
# embeddings tied to the pre-softmax projection and scaled by sqrt(512),
# sinusoid positions. Scoring takes teacher-forced pairs at batch 32,
# source and target 64 tokens; greedy decoding goes to 64 tokens (the
# paper: beam 4, length penalty 0.6). Ids are seeded random, weights
# seeded random, lengths fixed (no padding mask, so no attention takes
# the bias route).
NMT = dict(vocab=37000, d_model=512, heads=8, layers=6, ffn=2048,
           dropout=0.1, batch=32, src_len=64, tgt_len=64, max_len=64,
           bos=1, eos=2)
# Card against CPU (fp32, TF32 off): relative Frobenius error of the
# log-probabilities of 4 scored rows and of the first decode step's
# logits. K1's bound against float64 is 3e-5 (FP64_BOUND[1.0]) a call;
# a scored row passes through 18 attentions (6 encoder, 6 causal and 6
# cross), so 18 x 3e-5 = 5.4e-4, rounded up to 1e-3 for the GEMMs' and
# LayerNorms' fp32 rounding in another order on each device.
NMT_CPU_TOL = 1e-3
NMT_CPU_ROWS = 4
# the converted decode against the same function run eagerly, on the card
NMT_SCORE_TOL = 1e-6


def sinusoid_table(length, d_model):
    """The sinusoid position encoding of section 3.5: [length, d_model]
    fp32, sin on the even columns and cos on the odd ones."""
    pos = np.arange(length, dtype=np.float64)[:, None]
    rate = np.power(10000.0, np.arange(0, d_model, 2) / d_model)[None, :]
    table = np.zeros((length, d_model), np.float32)
    table[:, 0::2] = np.sin(pos / rate)
    table[:, 1::2] = np.cos(pos / rate)
    return table


def nmt_model(api, cfg=NMT):
    """The Transformer translation model as a user writes it against
    ``api`` (either package's: nn, F, matmul, to_tensor; port_nmt_api):
    one embedding for source and target, tied to the output projection;
    ``nn.Transformer`` for the stacks. ``forward(src, tgt)`` gives the
    log-probabilities [B, T, vocab] of the teacher-forced target;
    ``encode``, ``decode`` and ``logits`` are the pieces the greedy
    decoder calls."""
    nn, F = api.nn, api.F
    scale = math.sqrt(cfg["d_model"])
    length = max(cfg["src_len"], cfg["tgt_len"], cfg["max_len"])

    class TransformerNMT(nn.Layer):
        def __init__(self):
            super().__init__()
            # N(0, d_model^-1/2), as the paper's implementations start the
            # shared embedding: scaled by sqrt(d_model) it has unit
            # variance beside the positions
            self.embed = nn.Embedding(
                cfg["vocab"], cfg["d_model"], weight_attr=nn.ParamAttr(
                    initializer=nn.initializer.Normal(0.0, 1.0 / scale)))
            self.transformer = nn.Transformer(
                cfg["d_model"], cfg["heads"], cfg["layers"], cfg["layers"],
                cfg["ffn"], dropout=cfg["dropout"])
            self.pos = api.to_tensor(sinusoid_table(length, cfg["d_model"]))

        def embed_tokens(self, ids):
            return self.embed(ids) * scale + self.pos[:ids.shape[1]]

        def encode(self, src):
            return self.transformer.encoder(self.embed_tokens(src))

        def decode(self, tgt, memory):
            return self.transformer.decoder(self.embed_tokens(tgt), memory)

        def logits(self, h):
            return api.matmul(h, self.embed.weight, transpose_y=True)

        def forward(self, src, tgt):
            h = self.decode(tgt, self.encode(src))
            return F.log_softmax(self.logits(h), axis=-1)

    return TransformerNMT()


def nmt_greedy_fn(api, model, max_steps, bos, eos):
    """The greedy decoder as a user writes it in dygraph, to be converted
    by ``declarative`` (either package's ``api``; port_nmt_api). Its
    ``while`` runs on the tensor condition ``i < max_len and not
    finished``, the chosen ids go into a TensorArray, each step runs the
    causal decoder over the fixed [B, max_len] prefix buffer and projects
    only that step's row, and an ``if`` on a tensor freezes the finished
    rows (their id stays eos, their score stops growing). Returns one
    tensor [B, max_len + 1] fp32: the ids, then each row's summed
    log-probability (the reference's to_static returns one tensor)."""
    F = api.F
    TensorArray = api.TensorArray

    def greedy_decode(src):
        max_len = max_steps
        memory = model.encode(src)
        b = src.shape[0]
        buf = api.full([b, max_len], bos, "int64")
        pos = api.reshape(api.arange(max_len), [1, max_len])
        eos_ids = api.full([b], eos, "int64")
        no_score = api.zeros([b], "float32")
        ids = TensorArray((b,), max_size=max_len, dtype="int64")
        finished = api.zeros([b], "float32")
        score = api.zeros([b], "float32")
        i = 0
        while i < max_len and not finished.min():
            h = model.decode(buf, memory)
            sel = api.unsqueeze((pos == i).astype("float32"), [2])
            logp = F.log_softmax(model.logits(api.sum(h * sel, axis=1)),
                                 axis=-1)
            nxt = api.argmax(logp, axis=-1)
            best = api.max(logp, axis=-1)
            if finished.max() > 0:
                done = finished > 0.5
                nxt = api.where(done, eos_ids, nxt)
                best = api.where(done, no_score, best)
            ids = ids.write(i, nxt)
            score = score + best
            hit = (nxt == eos_ids).astype("float32")
            finished = finished + hit - finished * hit
            buf = api.where(pos == i + 1, api.unsqueeze(nxt, [1]), buf)
            i = i + 1
        return api.concat([api.transpose(ids.stack(), [1, 0])
                           .astype("float32"),
                           api.unsqueeze(score, [1])], axis=1)

    return greedy_decode


def port_nmt_api():
    """The port's surface as the NMT script takes it (the CPU test hands
    it the JAX package's)."""
    import types
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import dygraph, jit, nn
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.tensor_array import TensorArray
    return types.SimpleNamespace(
        nn=nn, F=F, jit=jit, dygraph=dygraph, TensorArray=TensorArray,
        to_tensor=pt.to_tensor, matmul=pt.matmul, full=pt.full,
        zeros=pt.zeros, arange=pt.arange, reshape=pt.reshape,
        unsqueeze=pt.unsqueeze, sum=pt.sum, max=pt.max, argmax=pt.argmax,
        where=pt.where, concat=pt.concat,
        transpose=lambda x, perm: x.permute(perm))


def nmt_first_logits(api, model, src, cfg=NMT):
    """The first greedy step's logits [B, vocab]: the causal decoder over
    the all-bos prefix buffer, row 0 projected."""
    b = src.shape[0]
    buf = api.full([b, cfg["max_len"]], cfg["bos"], "int64")
    h = model.decode(buf, model.encode(src))
    return model.logits(h[:, 0])


def nmt_steps(ids, eos, max_len):
    """The iterations the greedy loop ran: until every row has chosen eos
    (a row's first eos at step p finishes it after p + 1), or max_len;
    and whether it stopped on the finished rows."""
    firsts = [int(np.nonzero(row == eos)[0][0]) + 1 if (row == eos).any()
              else max_len + 1 for row in ids]
    steps = min(max(firsts), max_len)
    return steps, max(firsts) <= max_len


def nmt_freezing_eos(ids):
    """An eos for the decode whose ids [B, max_len] are ``ids`` when no
    row stops: the first id row 0 chose that some row had not chosen by
    that step (so row 0 stops there and that row goes on); row 0's first
    id when every row chose alike."""
    for j, tok in enumerate(ids[0]):
        if not (ids[:, :j + 1] == tok).any(1).all():
            return int(tok)
    return int(ids[0, 0])


def phase_nmt_kernels(fa, dev):
    """K1 (with K2 and K3 beside it) at the NMT's attention shape, B32 S64
    H8 D64 fp32, plain (encoder self- and cross-attention) and causal
    (decoder self-attention): against the plain versions, then
    phase_timing's CUDA-event times, bounds, plain and SDPA times.
    Returns ({causal: row of K1}, {causal: K1's largest error})."""
    rows, errs = {}, {}
    for causal in (False, True):
        shape = (NMT["batch"], NMT["src_len"], NMT["heads"],
                 NMT["d_model"] // NMT["heads"], causal)
        b, s, h, d, _ = shape
        gen = torch.Generator(device=dev).manual_seed(31 + causal)
        q, k, v, g = (torch.randn(b, s, h, d, generator=gen, device=dev)
                      for _ in range(4))
        print(f"[nmt_kernels] B{b} S{s} H{h} D{d} causal={causal} float32")
        found, _ = kernels_against_plain(fa, q, k, v, g, causal,
                                         torch.float32)
        errs[causal] = found["flash_fwd"]
        rows[causal] = phase_timing(fa, dev, torch.float32, shape)[
            "flash_fwd"]
    return rows, errs


def phase_dy2static_nmt(tpt, fa, dev):
    """The main path of the dy2static slice: the base Transformer (NMT:
    6 + 6 layers, d_model 512, 8 heads, FFN 2048, vocabulary 37,000 tied,
    fp32, TF32 off, eval) built from seed 0.

    Scoring: jit.to_static(model) on teacher-forced pairs (batch 32,
    source and target 64): the log-probabilities bit for bit against the
    eager forward under no_grad; K1 18 launches a call (12 plain, 6
    causal), K2 and K3 none, nothing on the blockwise route, no host
    sync; ms a call, tokens/s. Greedy decoding: nmt_greedy_fn through
    dygraph.declarative to 64 tokens: ids equal and scores within
    NMT_SCORE_TOL against the same
    function run without conversion; K1 6 + 12 launches a step, one host
    sync an iteration (the while's condition), plus one where the loop
    stops on its finished rows. First with an eos no row picks (all 64
    steps, timed: ms a step), then with an eos row 0 chose there and
    some other row had not (nmt_freezing_eos), so row 0 stops and the
    converted if freezes it. Peak memory. Card against
    CPU (the plain version of K1 there) from the same weights: the
    log-probabilities of NMT_CPU_ROWS scored rows and the first step's
    logits, by relative Frobenius error within NMT_CPU_TOL; ids are not
    compared across devices (near-ties of argmax under random weights
    would make that a flaky check). Returns K1-K3's launches over the
    counted scoring call and the two counted decodes, and K1's by
    route."""
    from paddle_tpu_torch.convert import load_state_dict
    cfg = NMT
    api = port_nmt_api()
    tpt.set_device(dev)
    tpt.seed(0)
    t0 = time.perf_counter()
    model = nmt_model(api, cfg)
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    b, s, t, max_len = cfg["batch"], cfg["src_len"], cfg["tgt_len"], \
        cfg["max_len"]
    gen = torch.Generator(device=dev).manual_seed(0)
    src = torch.randint(3, cfg["vocab"], (b, s), generator=gen, device=dev)
    tgt = torch.randint(3, cfg["vocab"], (b, t), generator=gen, device=dev)
    torch.cuda.synchronize()
    print(f"[dy2static_nmt] Transformer base (6 + 6 layers, d_model "
          f"{cfg['d_model']}, {cfg['heads']} heads, FFN {cfg['ffn']}, "
          f"vocabulary {cfg['vocab']} tied): {n_params} parameters "
          f"(Table 3: 65M) built in {time.perf_counter() - t0:.1f} s")
    scored = api.jit.to_static(model)
    check(isinstance(scored, api.jit.TracedLayer), "to_static(model)")
    with torch.no_grad():
        eager = model(src, tgt)
    scored(src, tgt)                         # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in fa.WRAPPERS:
        w.launches = 0
    blockwise = fa.blockwise_route.calls
    with op_causal() as routes:
        out = scored(src, tgt)
        torch.cuda.synchronize()
    score_launches = {w.__name__: w.launches for w in fa.WRAPPERS}
    score_routes = dict(routes)
    same = torch.equal(out, eager)
    print(f"[dy2static_nmt] scoring: log-probabilities "
          f"{tuple(out.shape)} {str(out.dtype).split('.')[-1]}, finite "
          f"{bool(torch.isfinite(out).all())}, "
          f"{'bit-equal to' if same else 'DIFFERENT FROM'} the eager "
          f"forward; launches {score_launches}, op routes {score_routes}")
    check(tuple(out.shape) == (b, t, cfg["vocab"]) and
          bool(torch.isfinite(out).all()), "scoring output")
    check(same, "to_static scoring differs from the eager forward")
    layers = cfg["layers"]
    check(score_launches == {"flash_fwd": 3 * layers, "flash_bwd_dq": 0,
                             "flash_bwd_dkv": 0},
          f"K1-K3 launches a scoring call: {score_launches}")
    check(score_routes == {"plain": 2 * layers, "causal": layers},
          f"flash_attention routes a scoring call: {score_routes}")
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        scored(src, tgt)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    score_ms = sorted(times)[len(times) // 2]
    prof = profile_call(lambda: scored(src, tgt))
    print(f"[dy2static_nmt] scoring ms a call (median of 10) {score_ms:.3f}"
          f"  tokens/s {b * t / score_ms * 1e3:.1f}  (target tokens; "
          f"{b * (s + t) / score_ms * 1e3:.1f} source + target); profiled "
          f"call: {prof['launches']} kernel launches, {prof['syncs']} host "
          f"syncs, device busy {prof['busy_ms']:.3f} of "
          f"{prof['wall_ms']:.3f} ms")
    check(prof["syncs"] == 0, f"scoring synced the host {prof['syncs']} "
                              f"times")
    # a decode with an eos no row picks runs all max_len steps; then eos
    # is an id row 0 chose there that some other row had not chosen by
    # then, so row 0 stops and the converted if freezes it while others
    # go on (random weights may make every row alike: then row 0's
    # first id, and all rows stop at once)
    with torch.no_grad():
        first = nmt_first_logits(api, model, src, cfg)
    dec_launches = {w.__name__: 0 for w in fa.WRAPPERS}
    dec_routes = collections.Counter()
    for eos in (-1, None):
        if eos is None:
            eos = nmt_freezing_eos(free_ids)
        fn = nmt_greedy_fn(api, model, max_len, cfg["bos"], eos)
        decode = api.dygraph.declarative(fn)
        decode(src)                          # warm-up
        before = {w.__name__: w.launches for w in fa.WRAPPERS}
        result = {}
        with op_causal() as routes:
            prof = profile_call(lambda: result.setdefault("out",
                                                          decode(src)))
        launched = {w.__name__: w.launches - before[w.__name__]
                    for w in fa.WRAPPERS}
        got = result["out"]
        ids = got[:, :-1].cpu().numpy().astype(np.int64)
        steps, stopped = nmt_steps(ids, eos, max_len)
        with torch.no_grad():
            plain = fn(src)
        plain_ids = plain[:, :-1].cpu().numpy().astype(np.int64)
        score_err = (got[:, -1] - plain[:, -1]).abs().max().item()
        want_syncs = steps + (1 if stopped else 0)
        print(f"[dy2static_nmt] greedy decode (declarative, max_len "
              f"{max_len}, eos {eos}): {steps} steps, rows finished "
              f"{int((ids == eos).any(1).sum())} of {b}; ids "
              f"{'equal' if np.array_equal(ids, plain_ids) else 'DIFFER'}"
              f" and scores max abs err {score_err:.3e} (bound "
              f"{NMT_SCORE_TOL:g}) against the unconverted function; "
              f"launches {launched}, op routes {dict(routes)}; host syncs "
              f"{prof['syncs']} (one an iteration"
              f"{', one more to stop' if stopped else ''}: {want_syncs}); "
              f"{prof['launches']} kernel launches, device busy "
              f"{prof['busy_ms']:.3f} of {prof['wall_ms']:.3f} ms")
        check(np.array_equal(ids, plain_ids),
              "the converted decode's ids differ from the unconverted run")
        check(score_err <= NMT_SCORE_TOL, "decode scores")
        if eos < 0:
            free_ids, free_steps, free_decode = ids, steps, decode
            print(f"[dy2static_nmt] rows alike: {len({tuple(r) for r in ids})} "
                  f"distinct of {b}; row 0 starts {ids[0, :8].tolist()}")
        else:
            at = int(np.nonzero(ids[0] == eos)[0][0])
            check(bool((ids[0, at:steps] == eos).all()),
                  "row 0 was not frozen at eos")
        check(launched == {"flash_fwd": layers * (1 + 2 * steps),
                           "flash_bwd_dq": 0, "flash_bwd_dkv": 0},
              f"K1-K3 launches a decode of {steps} steps: {launched}")
        check(dict(routes) == {"plain": layers * (1 + steps),
                               "causal": layers * steps},
              f"flash_attention routes a decode: {dict(routes)}")
        check(prof["syncs"] == want_syncs,
              f"decode host syncs {prof['syncs']}, not {want_syncs}")
        for name, n in launched.items():
            dec_launches[name] += n
        dec_routes.update(routes)
    check(free_steps == max_len,
          f"the eos-free decode ran {free_steps} steps")
    check(fa.blockwise_route.calls == blockwise,
          "the NMT took the blockwise route")
    steps = free_steps
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        free_decode(src)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    dec_ms = sorted(times)[1]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[dy2static_nmt] decode of {steps} steps, ms (median of 3) "
          f"{dec_ms:.3f}: {dec_ms / steps:.3f} ms a step, "
          f"{b * steps / dec_ms * 1e3:.1f} tokens/s; peak memory "
          f"{peak:.3f} GiB")
    # card against CPU from the same weights
    rows = NMT_CPU_ROWS
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    tpt.set_device("cpu")
    try:
        cpu_model = nmt_model(api, cfg)
        load_state_dict(cpu_model, state)
        cpu_model.eval()
        with torch.no_grad():
            cpu_lp = cpu_model(src[:rows].cpu(), tgt[:rows].cpu())
            cpu_first = nmt_first_logits(api, cpu_model, src[:rows].cpu(),
                                         cfg)
    finally:
        tpt.set_device(dev)
    errs = [rel_err(out[:rows].cpu().numpy(), cpu_lp.numpy()),
            rel_err(first[:rows].cpu().numpy(), cpu_first.numpy())]
    print(f"[dy2static_nmt] card vs CPU ({rows} rows; K1 against its plain "
          f"version): log-probabilities rel err {errs[0]:.3e}, first "
          f"step's logits rel err {errs[1]:.3e} (bound {NMT_CPU_TOL:g}: "
          f"18 attentions x K1's 3e-5, rounded up); ids not compared "
          f"across devices (argmax near-ties under random weights)")
    check(max(errs) <= NMT_CPU_TOL, "card against CPU")
    print(card_line())
    launches = {name: score_launches[name] + dec_launches[name]
                for name in score_launches}
    del model, scored, out, eager, cpu_model
    torch.cuda.empty_cache()
    return launches, {k: score_routes[k] + dec_routes[k]
                      for k in ("plain", "causal")}


DECODER_TOL = dict(rtol=1e-5, atol=1e-6)


def _close(got, want, what):
    """Equal integers and LoDs, floats within DECODER_TOL."""
    (g, glod), (w, wlod) = got, want
    ok = g.shape == w.shape and g.dtype == w.dtype and \
        [list(v) for v in (glod or [])] == [list(v) for v in (wlod or [])]
    if ok:
        ok = (np.allclose(g, w, **DECODER_TOL) if
              np.issubdtype(g.dtype, np.floating) else np.array_equal(g, w))
    check(ok, f"{what}: card against CPU")


def phase_static_decoders(tpt, dev):
    """The decoders slice's static programs on the card against the CPU,
    from the same startup values and feeds, at the CPU tests' sizes
    (paddle_tpu_torch/testing/decoder_cases.py): the contrib decoder's
    TrainingDecoder for 4 Adagrad steps (the losses) and
    BeamSearchDecoder on level-2 LoD feeds (the sentences, their LoD and
    scores); rnn / birnn with and without sequence_length and
    dynamic_decode; one case of each contrib_layers builder whose op type
    the port registers (random ones by what their seed does not
    decide). Floats within DECODER_TOL, integers and LoDs equal."""
    from paddle_tpu_torch.testing import decoder_cases as dc
    api = dc.port_api()
    t0 = time.perf_counter()

    def both(main, startup, fetch, feed, runs=1, params=None):
        values = dc.startup_values(startup)
        values.update(params or {})
        out = []
        for d in (dev, "cpu"):
            tpt.set_device(d)
            out.append(dc.run_program(
                api, tpt.Executor(d),
                lambda v, lod, d=d: tpt.TpuTensor(v, lod, device=d), main,
                values, feed, fetch, runs))
        tpt.set_device(dev)
        return out

    tpt.set_device(dev)
    main, startup, fetch = dc.training_decoder_program(api)
    card, cpu = both(main, startup, fetch, dc.training_feeds(),
                     dc.TRAIN_STEPS)
    losses = [float(r[0][0]) for r in card]
    for i, (c, w) in enumerate(zip(card, cpu)):
        _close(c[0], w[0], f"TrainingDecoder loss {i}")
    check(losses[-1] < losses[0], "the training decoder's loss")
    print(f"[static_decoders] TrainingDecoder, {dc.TRAIN_STEPS} Adagrad "
          f"steps: losses {losses} on the card, equal to the CPU's")
    main, startup, fetch = dc.beam_decoder_program(api)
    (card,), (cpu,) = both(main, startup, fetch, dc.beam_feeds())
    _close(card[0], cpu[0], "BeamSearchDecoder ids")
    _close(card[1], cpu[1], "BeamSearchDecoder scores")
    print(f"[static_decoders] BeamSearchDecoder: {card[0][0].size} ids on "
          f"LoD {card[0][1]}, equal to the CPU's")
    for kind in dc.RNN_KINDS:
        main, startup, fetch, feed = dc.rnn_program(api, kind)
        (card,), (cpu,) = both(main, startup, fetch, feed)
        for i, (c, w) in enumerate(zip(card, cpu)):
            _close(c, w, f"{kind} fetch {i}")
    print(f"[static_decoders] {', '.join(dc.RNN_KINDS)}: equal to the "
          f"CPU's")
    for name, case in dc.CONTRIB.items():
        main, startup, fetch = dc.contrib_program(api, name)
        card, cpu = both(main, startup, fetch, case["feed"], case["runs"],
                         case["params"])
        for c_run, w_run in zip(card, cpu):
            if case["check"] == "value":
                for i, (c, w) in enumerate(zip(c_run, w_run)):
                    _close(c, w, f"{name} fetch {i}")
            elif case["check"] == "rows":
                check(sorted(map(tuple, c_run[0][0])) == sorted(map(
                    tuple, case["feed"]["x"])), f"{name}: not a shuffle")
            else:
                for c, w in zip(c_run, w_run):
                    check(c[0].shape == w[0].shape, f"{name} shapes")
                check(c_run[0][0][:, 0].tolist() == [1, 2, 2],
                      f"{name}: the positive column")
    print(f"[static_decoders] {len(dc.CONTRIB)} contrib_layers builders "
          f"({', '.join(dc.CONTRIB)}): card equal to CPU; phase "
          f"{time.perf_counter() - t0:.1f} s")


def phase_proto_model(tpt, fa, dev, paths, workdir):
    """The reference's protobuf format on the card: the resnet50 (fp32)
    and attn (bf16) artifacts phase_predictor saved, written again by
    save_reference_inference_model (resave_reference; a protobuf
    __model__ and one LoDTensor stream a parameter), loaded through
    io.load_inference_model (Executor.run) and through a Predictor: each
    output bit-equal to the JSON route's Predictor on the same feed, the
    bf16 parameters bf16; K1 once an attn run."""
    from paddle_tpu_torch import io
    import os
    tpt.set_device(dev)
    rs = np.random.RandomState(11)
    rows = {"resnet50": 8, "attn": 4}
    for name, path in paths.items():
        dst = f"{workdir}/{name}_proto"
        t0 = time.perf_counter()
        feeds, fetches = resave_reference(tpt, path, dst)
        save_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(dst, f))
                   for f in os.listdir(dst))
        feed = serve_feed(name, rows[name], rs)
        _, (want,) = predict(tpt, path, feed)
        t0 = time.perf_counter()
        k1 = fa.flash_fwd.launches
        pred, (got,) = predict(tpt, dst, feed)
        launches = fa.flash_fwd.launches - k1
        load_s = time.perf_counter() - t0
        exe, scope = tpt.Executor(), tpt.Scope()
        prog, _, fetch = io.load_inference_model(dst, exe, scope=scope)
        direct, = exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
        dtypes_ = {str(scope.find_var(n).get().value.dtype).split(".")[-1]
                   for n, v in prog.global_block().vars.items()
                   if v.persistable and v.type == "LOD_TENSOR"}
        print(f"[proto_model] {name}: {len(os.listdir(dst))} files, "
              f"{size} bytes, written in {save_s:.2f} s; parameters "
              f"{sorted(dtypes_)}; feeds {feeds} fetches {fetches}; "
              f"Predictor (load and run {load_s:.2f} s) "
              f"{'bit-equal to' if np.array_equal(got, want) else 'DIFFERS FROM'}"
              f" the JSON route, Executor.run "
              f"{'bit-equal' if np.array_equal(direct, want) else 'DIFFERS'}"
              f"; K1 launches a run {launches}")
        check(np.array_equal(got, want) and np.array_equal(direct, want),
              f"{name}: the protobuf artifact predicts other bits")
        check(dtypes_ == ({"bfloat16"} if name == "attn" else {"float32"}),
              f"{name}: parameter dtypes {dtypes_}")
        check(launches == (1 if name == "attn" else 0),
              f"{name}: K1 launched {launches} times in one run")


# ---------------------------------------------------------------- data and IO
# Drive A: ResNet-50 fed by DataLoader workers. Seeded uint8 HWC images
# at one size stand in for decoded ImageNet JPEGs (the card machine may
# lack PIL, and there is no dataset); the transforms are the PaddleClas
# ImageNet training recipe's (RandCropImage 224, RandFlipImage,
# NormalizeImage with ImageNet's mean and std on HWC). A measured pass
# draws LOADER_ROUNDS batches a worker from the images with replacement
# (the loader keeps two a worker in flight), so its steady state, after
# each worker's first batch, is read apart from the fork and that first
# round.
LOADER = dict(images=1280, px=256, crop=224, batch=256)
LOADER_ROUNDS = 4
IMAGENET_MEAN = [0.485 * 255, 0.456 * 255, 0.406 * 255]
IMAGENET_STD = [0.229 * 255, 0.224 * 255, 0.225 * 255]


def imagenet_transform(transforms, crop):
    """The PaddleClas ImageNet training transforms over the package's
    ``vision.transforms``: uint8 HWC in, float32 HWC out."""
    return transforms.Compose([
        transforms.RandomResizedCrop(crop),
        transforms.RandomHorizontalFlip(),
        transforms.Normalize(IMAGENET_MEAN, IMAGENET_STD,
                             data_format="HWC")])


def loader_images(path, n, px, classes, seed=0):
    """n seeded uint8 images of px x px x 3 and int64 labels below
    ``classes``: written once to ``path`` (.npy), then memory-mapped."""
    import os
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, classes, (n,)).astype(np.int64)
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp.npy"
        out = np.lib.format.open_memmap(tmp, mode="w+", dtype=np.uint8,
                                        shape=(n, px, px, 3))
        for lo in range(0, n, 128):
            out[lo:lo + 128] = rs.randint(0, 256, out[lo:lo + 128].shape,
                                          dtype=np.uint8)
        out.flush()
        del out
        os.replace(tmp, path)
    return np.load(path, mmap_mode="r"), labels


def image_dataset(io, images, labels, transform):
    """A map-style ``io.Dataset`` of (transform(image), [label], [pid]):
    the pid of the process that made the sample, so a pass can count the
    workers that delivered batches."""
    import os

    class Images(io.Dataset):
        def __init__(self):
            self.transform = transform

        def __len__(self):
            return len(images)

        def __getitem__(self, i):
            return (self.transform(np.asarray(images[i])),
                    np.asarray([labels[i]], np.int64),
                    np.asarray([os.getpid()], np.int64))
    return Images()


class RecordedBatches:
    """A batch sampler that keeps the index lists it hands out, so the
    batches that arrive can be held against the indices sampled."""

    def __init__(self, inner):
        self.inner, self.batches = inner, []

    def __iter__(self):
        for idx in self.inner:
            self.batches.append(list(idx))
            yield idx

    def __len__(self):
        return len(self.inner)


def shm_left(prefix):
    """Names of the shared-memory segments that start with prefix."""
    import os
    return sorted(n for n in os.listdir("/dev/shm") if n.startswith(prefix))


class LoaderPass:
    """One pass of a DataLoader over ``image_dataset`` whose batch
    sampler is a RecordedBatches. ``take(count)`` checks that each batch
    holds the labels of the indices sampled for it, in sampler order,
    runs ``each(x, y)`` on it, and records its wait for the loader and
    its end (after ``each``) in s from the pass's start, and the pids
    that made it."""

    def __init__(self, loader, labels, what, each=None):
        loader.batch_sampler.batches.clear()
        self.sampled, self.labels = loader.batch_sampler.batches, labels
        self.what, self.each = what, each
        self.it = iter(loader)
        self.t0 = self.last = time.perf_counter()
        self.waits, self.ends, self.pids = [], [], set()

    def take(self, count=None):
        import itertools
        for x, y, pid in itertools.islice(self.it, count):
            k = len(self.ends)
            self.waits.append(time.perf_counter() - self.last)
            check(np.array_equal(y[:, 0], self.labels[self.sampled[k]]),
                  f"{self.what}: batch {k} is not the sampler's batch {k}")
            self.pids.update(pid[:, 0].tolist())
            if self.each is not None:
                self.each(x, y)
            self.last = time.perf_counter()
            self.ends.append(self.last - self.t0)
        return self

    def stats(self, first):
        """The batches taken so far, read apart at the first ``first``
        (the first round: one a worker): the first batch's wait and the
        first round's end (s), then the steady state after it, in ms a
        batch, with the wait p50 / p99 of its batches (ms, numpy's
        linear percentiles) and their count."""
        n = len(self.ends)
        steady = self.waits[first:]
        return dict(first_wait=self.waits[0], first_round=self.ends[first - 1],
                    batch_ms=(self.ends[-1] - self.ends[first - 1]) * 1e3
                    / (n - first), p50=np.percentile(steady, 50) * 1e3,
                    p99=np.percentile(steady, 99) * 1e3, steady=n - first,
                    workers=len(self.pids))


def phase_resnet_loader(tpt, dev):
    """Drive A: ResNet-50 (O1, NHWC, batch 256, 224 px, 1000 classes)
    fed by io.DataLoader workers that run vision.transforms on seeded
    uint8 images; the loader alone at 0, 4 and all cores' workers, then
    loader-fed steps beside device-fed ones in this process."""
    import multiprocessing as mp
    import os
    from paddle_tpu_torch import io
    from paddle_tpu_torch.io import dataloader as dl
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.vision import transforms
    cfg = LOADER
    b, classes = cfg["batch"], RESNET["classes"]
    t0 = time.perf_counter()
    images, labels = loader_images(
        f"build/loader/images_{cfg['images']}_{cfg['px']}.npy",
        cfg["images"], cfg["px"], classes)
    ds = image_dataset(io, images, labels,
                       imagenet_transform(transforms, cfg["crop"]))
    # the cores this process may run on (os.cpu_count() counts the
    # host's, which a container may not have)
    cores = len(os.sched_getaffinity(0))
    shm = os.statvfs("/dev/shm")
    print(f"[resnet_loader] {cfg['images']} uint8 images {cfg['px']} x "
          f"{cfg['px']} x 3 ({images.nbytes / 2 ** 20:.1f} MiB, memory-"
          f"mapped) ready in {time.perf_counter() - t0:.1f} s; host cores "
          f"{cores} (os.cpu_count() {os.cpu_count()}); /dev/shm free "
          f"{shm.f_bavail * shm.f_frsize / 2 ** 30:.1f} GiB; batch {b} of "
          f"{cfg['crop']} px float32 HWC = "
          f"{b * cfg['crop'] ** 2 * 3 * 4 / 1e6:.1f} MB")
    prefix = dl.shm_prefix_of()

    def loader(workers, batches):
        """``batches`` batches drawn with replacement, or the index lists
        given."""
        if isinstance(batches, int):
            batches = io.BatchSampler(sampler=io.RandomSampler(
                ds, replacement=True, num_samples=batches * b),
                batch_size=b, drop_last=True)
        return io.DataLoader(ds, num_workers=workers, use_shared_memory=True,
                             batch_sampler=RecordedBatches(batches))

    def no_leftovers(what):
        check(not shm_left(prefix), f"{what}: shared-memory segments left "
              f"{shm_left(prefix)[:4]}")
        check(not mp.active_children(),
              f"{what}: worker processes alive {mp.active_children()}")

    def rate(st):
        return b / st["batch_ms"] * 1e3

    # the loader alone: in this process over three batches, the first
    # apart, then forked workers over LOADER_ROUNDS batches each
    order = np.random.RandomState(1).permutation(len(ds))
    alone = {0: LoaderPass(loader(0, [order[k * b:(k + 1) * b]
                                      for k in range(3)]),
                           labels, "0 workers").take().stats(1)}
    for w in sorted({4, cores}):
        alone[w] = LoaderPass(loader(w, LOADER_ROUNDS * w), labels,
                              f"{w} workers").take().stats(w)
        no_leftovers(f"{w} workers")
        check(alone[w]["workers"] == w, f"{w} workers: "
              f"{alone[w]['workers']} delivered batches")
    parts = transform_ms(ds.transform, images)
    t = time.perf_counter()
    batch = dl.default_collate_fn([ds[i] for i in order[:b]])
    made = time.perf_counter() - t
    t = time.perf_counter()
    dl._release_shm(dl._batch_to_shm(batch, f"{prefix}probe_"))
    shm_s = time.perf_counter() - t
    print("[resnet_loader] the loader alone, steady state after each "
          "worker's first batch: " + "; ".join(
              (f"{w} workers ({st['workers']} delivered) " if w else
               "0 workers (this process) ") + f"{rate(st):.1f} "
              f"images/s, {st['batch_ms']:.1f} ms a batch over "
              f"{st['steady']} batches, wait p50 {st['p50']:.1f} p99 "
              f"{st['p99']:.1f} ms; first batch after "
              f"{st['first_wait']:.3f} s, first round done at "
              f"{st['first_round']:.3f} s" for w, st in alone.items()))
    print("[resnet_loader] in one process, ms an image: " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items())
        + f"; a batch made and collated in {made:.3f} s, written to "
        f"shared memory and unlinked in {shm_s:.3f} s")

    # ResNet-50 fed by device-resident batches, then by the loader
    torch.backends.cudnn.benchmark = True      # as training scripts run
    steps = LOADER_ROUNDS * cores
    try:
        model, train = resnet_train_step(tpt, dev, "NHWC")
        first = next(iter(loader(0, [order[:b]])))
        resident = [torch.from_numpy(a).to(dev) for a in first[:2]]
        losses = [float(train(*resident)) for _ in range(2)]
        resident_ms = _timed_steps(lambda: train(*resident), 0, steps)
        copies = []

        def fed_step(x, y):
            torch.cuda.synchronize()
            t = time.perf_counter()
            xd = torch.from_numpy(x).to(dev)
            yd = torch.from_numpy(y).to(dev)
            torch.cuda.synchronize()
            copies.append((time.perf_counter() - t) * 1e3)
            losses.append(float(train(xd, yd)))

        # one pass: `steps` timed, one more round profiled, then a break
        # with the last round in flight, its iterator still referenced
        # (as a profiler or a traceback may hold it)
        metrics.reset()
        p = LoaderPass(loader(cores, steps + 2 * cores), labels,
                       "loader-fed steps", each=fed_step)
        fed = p.take(steps).stats(cores)
        hist = metrics.snapshot()["dataloader/wait_ms"]
        prof = profile_call(lambda: p.take(cores))
        p.it.close()
        no_leftovers("a break with a round in flight")
        check(fed["workers"] == cores,
              f"loader-fed steps: {fed['workers']} workers delivered")
    finally:
        torch.backends.cudnn.benchmark = False
    med = lambda v: sorted(v)[len(v) // 2]          # noqa: E731
    print(f"[resnet_loader] NHWC O1, {steps} steps fed by {cores} loader "
          f"workers ({fed['workers']} delivered): steady state "
          f"{fed['batch_ms']:.3f} ms a step ({rate(fed):.2f} img/s) over "
          f"the {fed['steady']} steps after the first round, which ended "
          f"at {fed['first_round']:.3f} s (first wait "
          f"{fed['first_wait']:.3f} s); {steps} steps fed by a "
          f"device-resident batch: step_ms median {med(resident_ms):.3f} "
          f"range {min(resident_ms):.3f}-{max(resident_ms):.3f} (img/s "
          f"{b / med(resident_ms) * 1e3:.2f}); loader-fed over device-fed "
          f"{fed['batch_ms'] / med(resident_ms):.2f}x")
    copies = copies[:steps]         # the timed steps'
    print(f"[resnet_loader] host-to-device copy of a batch (pageable): "
          f"median {med(copies):.3f} ms range {min(copies):.3f}-"
          f"{max(copies):.3f} ({b * cfg['crop'] ** 2 * 3 * 4 / med(copies) / 1e6:.2f}"
          f" GB/s); wait of the {fed['steady']} steady steps p50 "
          f"{fed['p50']:.3f} p99 {fed['p99']:.3f} ms; dataloader/wait_ms "
          f"over all {hist['count']} batches p50 {hist['p50']:.3f} p99 "
          f"{hist['p99']:.3f} max {hist['max']:.3f}")
    print(f"[resnet_loader] a profiled steady-state stretch (the {cores} "
          f"loader-fed steps after the timed ones) "
          f"{prof['wall_ms']:.3f} ms: device busy {prof['busy_ms']:.3f} ms "
          f"(idle {1 - prof['busy_ms'] / prof['wall_ms']:.3f}), launches "
          f"{prof['launches'] / cores:.1f} and host syncs "
          f"{prof['syncs'] / cores:.1f} a step")
    print(f"[resnet_loader] losses {[round(x, 4) for x in losses]}; "
          f"ln(1000) = {math.log(classes):.4f}; no shared-memory segment of "
          f"{prefix}* and no worker process left after each pass and "
          f"after a break with a round in flight")
    check(hist["count"] == steps, f"dataloader/wait_ms counted "
          f"{hist['count']} of {steps} batches")
    check(all(math.isfinite(x) for x in losses), "non-finite loss")
    check(abs(losses[0] - math.log(classes)) < RESNET_LOSS0_TOL,
          f"first loss {losses[0]} far from ln({classes})")
    return {w: rate(st) for w, st in alone.items()}


def transform_ms(transform, images, n=16):
    """ms an image of each step of a Compose, and of the whole, over the
    first n images, in this process."""
    out = collections.Counter()
    for i in range(n):
        img = np.asarray(images[i])
        for t in transform.transforms:
            t0 = time.perf_counter()
            img = t(img)
            out[type(t).__name__] += (time.perf_counter() - t0) * 1e3 / n
    return out


# Drive B: the fluid CTR-DNN of PaddlePaddle/models
# PaddleRec/ctr/dnn/network_conf.py ctr_dnn_model with its train.py
# defaults, trained by Executor.train_from_dataset. Synthetic
# Criteo-like rows stand in for the Criteo corpus; the sparse slots are
# declared shape [-1, 1] with their "@LEN" lengths beside them instead
# of lod_level=1 (neither package feeds a lod_level=1 var from a
# dataset: its "@seq_len" stays unfed), so sequence_pool averages each
# slot over the lengths the dataset gives; the auc layer, which neither
# package registers, is left out.
CTR = dict(vocab=1_000_001, emb=10, hidden=(400, 400, 400), dense=13,
           sparse=26, batch=1000, lr=1e-4, files=8, rows=16_000, threads=8)
CTR_PARAMS = 10_431_212
CTR_CPU_RTOL = 1e-4         # card against CPU, the first batches' losses
CTR_CPU_BATCHES = 4
# criteo_reader.py's continuous-feature offsets and ranges
CTR_CONT_MIN = [0, -3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]
CTR_CONT_DIFF = [20, 603, 100, 50, 64000, 500, 100, 50, 500, 10, 10, 10, 50]


def ctr_dnn_program(api, vocab, emb, hidden, dense=13, sparse=26, lr=1e-4):
    """ctr_dnn_model built with ``api`` (either package): (main, startup,
    test program cloned before the optimizer, feed vars in file order,
    loss var)."""
    pt, static = api.pt, api.static
    nn = static.nn
    main, startup = pt.Program(), pt.Program()
    with static.program_guard(main, startup):
        dense_in = static.data("dense_input", [-1, dense], "float32")
        ids = [static.data(f"C{i}", [-1, 1], "int64")
               for i in range(1, sparse + 1)]
        lens = [static.data(f"C{i}@LEN", [-1], "int64")
                for i in range(1, sparse + 1)]
        label = static.data("label", [-1, 1], "int64")
        pooled = []
        for c, n in zip(ids, lens):
            e = nn.embedding(c, size=[vocab, emb], is_sparse=True,
                             param_attr=api.ParamAttr(
                                 name="SparseFeatFactors",
                                 initializer=api.I.Uniform()))
            pooled.append(nn.sequence_pool(nn.reshape(e, [-1, 1, emb]), n,
                                           pooltype="AVERAGE"))
        x = nn.concat(pooled + [dense_in], axis=1)
        for width in (*hidden, 2):
            x = nn.fc(x, size=width,
                      act="relu" if width != 2 else "softmax",
                      param_attr=api.ParamAttr(initializer=api.I.Normal(
                          0.0, 1 / math.sqrt(x.shape[1]))))
        loss = nn.mean(nn.cross_entropy(x, label))
        test = main.clone(for_test=True)
        api.Adam(learning_rate=lr).minimize(loss)
    return main, startup, test, [dense_in, *ids, label], loss


def ctr_params(test):
    """The model's parameters: the persistable vars of its test program
    (cloned before the optimizer added its state)."""
    return sorted(v.name for v in test.list_vars() if v.persistable)


def criteo_raw_lines(seed, n):
    """n seeded Criteo-like raw lines: label, 13 integer features and 26
    hashed categorical ones, tab-separated, about 1 in 8 missing."""
    rs = np.random.RandomState(seed)
    label = (rs.rand(n) < 0.25).astype(int)
    ints = np.minimum(rs.geometric(0.05, (n, 13)) - 1, 60000)
    cats = (rs.zipf(1.3, (n, 26)) * 2654435761 + np.arange(26)) % (1 << 32)
    miss_i, miss_c = rs.rand(n, 13) < 0.125, rs.rand(n, 26) < 0.125
    return ["\t".join([str(label[r])]
                      + ["" if miss_i[r, j] else str(ints[r, j])
                         for j in range(13)]
                      + ["" if miss_c[r, j] else format(cats[r, j], "08x")
                         for j in range(26)]) + "\n" for r in range(n)]


def criteo_generator(data_generator, vocab):
    """The source's criteo_reader as a MultiSlotDataGenerator of the
    given package: dense features scaled to [0, 1] by its ranges, each
    categorical feature hashed with zlib.crc32 (Python's str hash
    differs between processes) modulo ``vocab``."""
    import zlib

    class CriteoGenerator(data_generator.MultiSlotDataGenerator):
        def generate_sample(self, line):
            def reader():
                f = line.rstrip("\n").split("\t")
                dense = [0.0 if f[i] == "" else
                         (float(f[i]) - CTR_CONT_MIN[i - 1])
                         / CTR_CONT_DIFF[i - 1] for i in range(1, 14)]
                sparse = [[zlib.crc32((str(i) + f[i]).encode()) % vocab]
                          for i in range(14, 40)]
                names = ["dense_input"] + [f"C{i - 13}" for i in
                                           range(14, 40)] + ["label"]
                yield list(zip(names, [dense] + sparse + [[int(f[0])]]))
            return reader
    return CriteoGenerator()


def write_multislot(data_generator, vocab, path, seed, rows):
    """criteo_raw_lines(seed, rows) through criteo_generator into the
    MultiSlot file ``path``."""
    with open(path, "w") as out:
        criteo_generator(data_generator, vocab).run_from_stdin(
            out=out, lines=criteo_raw_lines(seed, rows))


def _write_ctr_file(args):
    from paddle_tpu_torch.incubate import data_generator
    write_multislot(data_generator, *args)


def phase_ctr_dataset(tpt, dev):
    """Drive B: the fluid CTR-DNN (CTR) trained by train_from_dataset on
    MultiSlot files a MultiSlotDataGenerator wrote, read by QueueDataset
    through the native feeder; the first batches card against CPU, a
    profiled stretch, then infer_from_dataset."""
    import multiprocessing as mp
    import os
    from paddle_tpu_torch import native
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.testing import static_cases
    cfg, workdir = CTR, "build/ctr"
    api = static_cases.port_api()
    tpt.set_device(dev)
    os.makedirs(workdir, exist_ok=True)
    t0 = time.perf_counter()
    files = [f"{workdir}/part-{i}.txt" for i in range(cfg["files"])]
    with mp.get_context("fork").Pool(min(cfg["files"], os.cpu_count())) as p:
        p.map(_write_ctr_file, [(cfg["vocab"], f, i, cfg["rows"])
                                for i, f in enumerate(files)])
    gen_s = time.perf_counter() - t0
    main, startup, test, feeds, loss = ctr_dnn_program(
        api, cfg["vocab"], cfg["emb"], cfg["hidden"], cfg["dense"],
        cfg["sparse"], cfg["lr"])
    params = ctr_params(test)
    exe, scope = tpt.Executor(), tpt.Scope()
    exe.run(startup, scope=scope)
    n_params = sum(scope.find_var(n).get().value.numel() for n in params)
    # the whole persistable state at the start, for the CPU run
    cpu_scope = scope_copy(tpt, [n for n, v in main.global_block().vars.items()
                                 if v.persistable], scope, "cpu")

    def dataset(files_):
        ds = api.pt.DatasetFactory().create_dataset("QueueDataset")
        ds.set_batch_size(cfg["batch"])
        ds.set_thread(cfg["threads"])
        ds.set_filelist(files_)
        ds.set_use_var(feeds)
        return ds

    rows = cfg["files"] * cfg["rows"]
    n_batches = cfg["files"] * -(-cfg["rows"] // cfg["batch"])
    print(f"[ctr_dataset] CTR-DNN {n_params} parameters; {cfg['files']} "
          f"MultiSlot files of {cfg['rows']} rows ({sum(os.path.getsize(f) for f in files) / 2 ** 20:.1f} MiB)"
          f" written by a MultiSlotDataGenerator in {gen_s:.1f} s")
    # the native feeder alone, built first
    t0 = time.perf_counter()
    native.ensure_built()
    print(f"[ctr_dataset] native feeder library {native.library_path()}, "
          f"ready in {time.perf_counter() - t0:.2f} s (g++ unless built "
          f"already)")
    ds = dataset(files)
    t0 = time.perf_counter()
    alone = sum(1 for _ in native.MultiSlotFeeder(
        ds.filelist, ds.batch_size, [(s.name, s.dtype, s.dim)
                                     for s in ds.slots],
        num_threads=ds.thread_num))
    feed_s = time.perf_counter() - t0
    # the training pass; the first batches are kept for the CPU run
    kept, inner = [], ds._batch_iter

    def keep():
        for batch in inner():
            if len(kept) < CTR_CPU_BATCHES:
                kept.append(batch)
            yield batch

    ds._batch_iter = keep
    native0 = metrics.metric_get("dataset/native_batches") or 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = exe.train_from_dataset(main, ds, scope=scope, fetch_list=[loss],
                                  print_period=1)
    torch.cuda.synchronize()
    pass_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    native = (metrics.metric_get("dataset/native_batches") or 0) - native0
    losses = hist[loss.name]
    print(f"[ctr_dataset] the native feeder alone: {alone} batches, "
          f"{rows / feed_s:.0f} rows/s; train_from_dataset: {len(losses)} "
          f"batches in {pass_s:.3f} s, {rows / pass_s:.0f} rows/s, "
          f"{pass_s / len(losses) * 1e3:.3f} ms a batch, peak memory "
          f"{peak:.3f} GiB; native batches {native}; losses first "
          f"{losses[:4]} last {losses[-4:]}")
    check(n_params == CTR_PARAMS, f"{n_params} parameters, not {CTR_PARAMS}")
    check(alone == n_batches and len(losses) == n_batches,
          f"{alone} / {len(losses)} batches, not {n_batches}")
    check(native == n_batches, f"the native feeder served {native} of "
          f"{n_batches} batches")
    check(all(math.isfinite(x) for x in losses), "non-finite loss")
    # card against CPU on the first batches, from the same start
    cpu_exe = tpt.Executor("cpu")
    block = main.global_block()
    cpu = []
    for batch in kept:
        feed = {k: v for k, v in batch.items()
                if not k.endswith("@LEN") or block.has_var(k)}
        cpu.append(float(cpu_exe.run(main, feed=feed, fetch_list=[loss],
                                     scope=cpu_scope)[0]))
    errs = [abs(g - c) / abs(c) for g, c in zip(losses, cpu)]
    print(f"[ctr_dataset] the first {len(cpu)} losses on the CPU {cpu}: "
          f"relative error {max(errs):.3e} (bound {CTR_CPU_RTOL:g})")
    check(max(errs) <= CTR_CPU_RTOL, "card and CPU losses disagree")
    # a profiled stretch: a pass over one file
    one = dataset(files[:1])
    prof = profile_call(lambda: exe.train_from_dataset(
        main, one, scope=scope, fetch_list=[loss], print_period=1))
    per = -(-cfg["rows"] // cfg["batch"])
    print(f"[ctr_dataset] a profiled pass over one file ({per} batches): "
          f"{prof['wall_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} ms "
          f"(idle {1 - prof['busy_ms'] / prof['wall_ms']:.3f}), launches "
          f"{prof['launches'] / per:.1f} and host syncs "
          f"{prof['syncs'] / per:.1f} a batch")
    # inference leaves the parameters as they were
    before = {n: scope.find_var(n).get().value.clone() for n in params}
    t0 = time.perf_counter()
    inf = exe.infer_from_dataset(test, dataset(files[:1]), scope=scope,
                                 fetch_list=[loss.name], print_period=1)
    same = all(torch.equal(before[n], scope.find_var(n).get().value)
               for n in params)
    print(f"[ctr_dataset] infer_from_dataset: {len(inf[loss.name])} batches "
          f"in {time.perf_counter() - t0:.3f} s, parameters "
          f"{'unchanged' if same else 'CHANGED'}")
    check(same, "infer_from_dataset changed the parameters")
    check(len(inf[loss.name]) == per and all(
        math.isfinite(x) for x in inf[loss.name]), "infer pass losses")


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
            for dt in (torch.float32, torch.bfloat16, torch.float16)}
    gpt_rows, gpt_errs = phase_gpt_kernels(fa, dev)
    phase_flash_route(fa, dev)
    phase_tiny(tpt, dev)
    fp16_launches = phase_tiny_o2(tpt, fa, dev)
    launches = {torch.float32: phase_bert(tpt, fa, dev),
                torch.bfloat16: phase_bert_o2(tpt, fa, dev),
                torch.float16: fp16_launches}
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
    phase_static_builders(tpt, dev)
    ernie_launches, ernie_dtype = phase_static_ernie(tpt, fa, dev)
    ernie_dt = getattr(torch, ernie_dtype)
    ernie_rows, ernie_errs = phase_ernie_kernels(fa, dev, ernie_dt)
    workdir = "build/serving"
    shutil.rmtree(workdir, ignore_errors=True)
    paths = phase_predictor(tpt, fa, dev, workdir)
    served, cold = phase_serve(tpt, fa, dev, paths, workdir)
    phase_serve_restart(tpt, dev, paths, workdir, served, cold)
    t_new = time.perf_counter()
    phase_proto_model(tpt, fa, dev, paths, workdir)
    new_phases_s = time.perf_counter() - t_new
    eager_launches = phase_eager_bert(tpt, fa, dev)
    phase_tensor_api(dev)
    phase_nn_api(dev)
    phase_nn_layers(tpt, dev)
    phase_cyclegan(tpt, dev)
    phase_cf_api(dev)
    phase_control_flow(tpt, dev)
    phase_ptb_lm(tpt, dev)
    phase_seq_ops(dev)
    phase_rnnlm_eager(tpt, dev)
    phase_sentiment_lstm(tpt, dev)
    phase_decode_ops(dev)
    phase_crnn(tpt, dev)
    phase_rcnn_ops(dev)
    phase_faster_rcnn(tpt, dev)
    t_new = time.perf_counter()
    _, nmt_routes = phase_dy2static_nmt(tpt, fa, dev)
    phase_static_decoders(tpt, dev)
    new_phases_s += time.perf_counter() - t_new
    print(f"[time] dy2static_nmt, static_decoders and proto_model: "
          f"{new_phases_s:.1f} s of command time")
    t_new = time.perf_counter()
    phase_resnet_loader(tpt, dev)
    torch.cuda.empty_cache()
    phase_ctr_dataset(tpt, dev)
    print(f"[time] resnet_loader and ctr_dataset: "
          f"{time.perf_counter() - t_new:.1f} s of command time")
    nmt_rows, nmt_errs = phase_nmt_kernels(fa, dev)
    # fp32 rows: launches on the O1 path (phase bert), beside those of the
    # eager path (phase eager_bert); bf16 rows: on the O2 path (phase
    # bert_o2); fp16 rows: in the fp16 eager loop of phase tiny_o2 (no
    # fp16 main path); _gpt rows: at GPT-3 1.3B's shape, launches on its
    # O2 path (phase gpt_o2); the rows of the dtype that reaches K1-K3 on
    # the static ERNIE step also count its launches (phase static_ernie),
    # and _ernie rows time them at its shape; flash_fwd_nmt rows time K1
    # at the NMT's shape, plain and causal, with the launches of each
    # route in phase dy2static_nmt
    suffix = {torch.float32: "", torch.bfloat16: "_bf16",
              torch.float16: "_fp16"}
    record = {"kernels": [
        dict(name=name + suffix[dt], route="cuda", source=SOURCE,
             replaces=REPLACES[name], launches=launches[dt][name],
             max_abs_err=errs[name, dt], **rows[dt][name],
             **({"launches_eager_bert": eager_launches[name]}
                if dt == torch.float32 else {}),
             **({"launches_static_ernie": ernie_launches[name]}
                if dt == ernie_dt else {}))
        for dt in suffix for name in REPLACES] + [
        dict(name=name + "_gpt", route="cuda", source=SOURCE,
             replaces=REPLACES[name], launches=gpt_launches[name],
             max_abs_err=gpt_errs[name], **gpt_rows[name])
        for name in REPLACES] + [
        dict(name=name + "_ernie", route="cuda", source=SOURCE,
             replaces=REPLACES[name], launches=ernie_launches[name],
             max_abs_err=ernie_errs[name], **ernie_rows[name])
        for name in REPLACES] + [
        dict(name="flash_fwd_nmt" + ("_causal" if causal else ""),
             route="cuda", source=SOURCE, replaces=REPLACES["flash_fwd"],
             launches=nmt_routes["causal" if causal else "plain"],
             max_abs_err=nmt_errs[causal], **nmt_rows[causal])
        for causal in (False, True)]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
