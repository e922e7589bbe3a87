"""The port's op registry covers every op type one BERT step and one
ResNet step run.

Wraps the JAX package's ``OpInfoMap.get`` (every eager op and the
optimizer's update are looked up there) during one JAX ``TrainStep`` of
BERT-tiny and of resnet18 at O1, as bench.py runs them, and fails if the
port's registry lacks any type it saw. Indexing (``hidden[:, 0]``) goes through
``trace_with_fn`` in the reference, not the registry, and is plain torch
indexing in the port.
"""
import jax
import numpy as np
import pytest
import torch

from paddle_tpu.core.registry import OpInfoMap as JaxOpInfoMap
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.optimizer import Momentum as JaxMomentum
from paddle_tpu.nn import functional as JaxF
from paddle_tpu.text.models import BertForPretraining as JaxBert
from paddle_tpu.vision.models import resnet18 as jax_resnet18
import paddle_tpu as jpt

import paddle_tpu_torch  # noqa: F401  (registers the port's ops)
from paddle_tpu_torch.core.registry import OpInfoMap


class _JaxTrainStep(JaxTrainStep):
    # the tied decoder weight sits under two names; donating its one
    # buffer twice fails on the CPU
    def _build_jit(self, pv, bv, raw_args):
        return jax.jit(self._step)


def test_port_registers_every_op_type_of_a_bert_step(monkeypatch):
    seen = set()
    real_get = JaxOpInfoMap.get

    def spy(self, op_type):
        seen.add(op_type)
        return real_get(self, op_type)

    monkeypatch.setattr(JaxOpInfoMap, "get", spy)
    jpt.seed(0)
    model = JaxBert(vocab_size=128, d_model=64, num_layers=1, nhead=2,
                    d_ffn=128, dropout=0.0)
    opt = JaxMomentum(learning_rate=1e-4, momentum=0.9,
                      parameters=model.parameters())
    step = _JaxTrainStep(
        model, lambda m, ids, lab, nsp: m(
            ids, masked_lm_labels=lab, next_sentence_label=nsp),
        opt, amp_level="O1")
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 128, (2, 16)).astype(np.int32)
    labels = np.where(rs.rand(2, 16) < 0.3, ids, -1).astype(np.int32)
    nsp = rs.randint(0, 2, (2, 1)).astype(np.int32)
    assert np.isfinite(float(step(ids, labels, nsp).numpy()))
    assert {"flash_attention", "matmul_v2", "layer_norm", "momentum",
            "softmax_with_cross_entropy", "lookup_table_v2"} <= seen
    missing = sorted(t for t in seen if not OpInfoMap.instance().has(t))
    assert not missing, f"port lacks op types {missing}"


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_port_registers_every_op_type_of_a_resnet_step(monkeypatch, layout):
    seen = set()
    real_get = JaxOpInfoMap.get

    def spy(self, op_type):
        seen.add(op_type)
        return real_get(self, op_type)

    monkeypatch.setattr(JaxOpInfoMap, "get", spy)
    jpt.seed(0)
    model = jax_resnet18(num_classes=10, data_format=layout)
    opt = JaxMomentum(learning_rate=0.1, momentum=0.9,
                      parameters=model.parameters())
    step = JaxTrainStep(model, lambda m, x, y: JaxF.cross_entropy(m(x), y),
                        opt, amp_level="O1")
    rs = np.random.RandomState(0)
    shape = (2, 32, 32, 3) if layout == "NHWC" else (2, 3, 32, 32)
    x = rs.rand(*shape).astype(np.float32)
    y = rs.randint(0, 10, (2, 1)).astype(np.int32)
    assert np.isfinite(float(step(x, y).numpy()))
    assert {"conv2d", "batch_norm", "pool2d", "relu", "momentum",
            "flatten_contiguous_range", "softmax_with_cross_entropy"} <= seen
    missing = sorted(t for t in seen if not OpInfoMap.instance().has(t))
    assert not missing, f"port lacks op types {missing}"


# ---------------------------------------------------------------------------
# op by op: the same numpy inputs through both registries, every output
# slot the port computes, at rtol / atol 1e-5 (fp32 math in two libraries
# that sum reductions and 64-term products in other orders).
# ---------------------------------------------------------------------------
def _f(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _bn_inputs(*shape, seed=3):
    """X of ``shape`` (channels last for NHWC), per-channel scale, bias,
    running mean and variance (positive)."""
    c = shape[1] if shape[1] == 3 else shape[-1]
    rs = np.random.RandomState(seed)
    return {"X": [rs.randn(*shape).astype(np.float32) * 2.0 + 0.5],
            "Scale": [rs.randn(c).astype(np.float32)],
            "Bias": [rs.randn(c).astype(np.float32)],
            "Mean": [rs.randn(c).astype(np.float32)],
            "Variance": [rs.rand(c).astype(np.float32) + 0.5]}


_IDS = np.random.RandomState(5).randint(0, 10, (3, 4)).astype(np.int32)
_LABELS = np.array([[1], [-1], [7], [3]], np.int32)
OP_CASES = {
    "elementwise_add": ({"X": [_f(2, 3, 4)], "Y": [_f(4, seed=1)]},
                        {"axis": -1}),
    "elementwise_sub": ({"X": [_f(2, 3, 4)], "Y": [_f(3, seed=1)]},
                        {"axis": 1}),
    "elementwise_mul": ({"X": [_f(2, 3)], "Y": [_f(2, 3, seed=1)]}, {}),
    "elementwise_div": ({"X": [_f(2, 3)], "Y": [_f(2, 3, seed=1) + 4.0]},
                        {}),
    "elementwise_max": ({"X": [_f(5)], "Y": [_f(5, seed=1)]}, {}),
    "scale": ({"X": [_f(3, 4)]}, {"scale": -2.5, "bias": 0.5}),
    "matmul_v2": ({"X": [_f(2, 5, 64)], "Y": [_f(7, 64, seed=1)]},
                  {"trans_y": True}),
    "reduce_sum": ({"X": [_f(2, 3, 4)]}, {"dim": [1], "keep_dim": True}),
    "mean": ({"X": [_f(4, 6)]}, {}),
    "gelu": ({"X": [_f(4, 6)]}, {"approximate": False}),
    "tanh": ({"X": [_f(4, 6)]}, {}),
    "cast": ({"X": [_f(4, 6)]}, {"out_dtype": "bfloat16"}),
    "not_equal": ({"X": [_LABELS], "Y": [np.array(-1, np.int64)]}, {}),
    "reshape": ({"X": [_f(2, 3, 4)]}, {"shape": [0, 12]}),
    "layer_norm": ({"X": [_f(2, 3, 64)], "Scale": [_f(64, seed=1)],
                    "Bias": [_f(64, seed=2)]},
                   {"epsilon": 1e-12, "begin_norm_axis": 2}),
    "softmax_with_cross_entropy": ({"Logits": [_f(4, 11)],
                                    "Label": [_LABELS]},
                                   {"ignore_index": -1}),
    "lookup_table_v2": ({"W": [_f(10, 8)], "Ids": [_IDS]},
                        {"padding_idx": 3}),
    "dropout": ({"X": [_f(4, 6)]}, {"dropout_prob": 0.1, "is_test": True,
                                    "dropout_implementation":
                                        "downgrade_in_infer"}),
    "momentum": ({"Param": [_f(6)], "Grad": [_f(6, seed=1)],
                  "Velocity": [_f(6, seed=2)],
                  "LearningRate": [np.array(0.1, np.float32)]},
                 {"mu": 0.9, "use_nesterov": True}),
    "sgd": ({"Param": [_f(6)], "Grad": [_f(6, seed=1)],
             "LearningRate": [np.array(0.1, np.float32)]}, {}),
    # further attrs of an op type: "<op type>[<what>]"
    "momentum[l2_decay, lr attr]": (
        {"Param": [_f(6)], "Grad": [_f(6, seed=1)],
         "Velocity": [_f(6, seed=2)]},
        {"mu": 0.9, "learning_rate": 0.1,
         "regularization_method": "l2_decay", "regularization_coeff": 0.01}),
    "softmax_with_cross_entropy[soft_label]": (
        {"Logits": [_f(4, 11)],
         "Label": [np.abs(_f(4, 11, seed=1)) / 11.0]},
        {"soft_label": True}),
    # ResNet's ops: conv, pool, batch norm, activations, flatten
    "conv2d": ({"Input": [_f(2, 3, 9, 9)], "Filter": [_f(4, 3, 3, 3, seed=1)]},
               {"strides": [1, 1], "paddings": [1, 1]}),
    "conv2d[NHWC, stride 2, groups 2]": (
        {"Input": [_f(2, 9, 8, 4)], "Filter": [_f(6, 2, 3, 3, seed=1)]},
        {"strides": [2, 2], "paddings": [1, 1], "groups": 2,
         "data_format": "NHWC"}),
    "conv2d[4-value padding, dilation]": (
        {"Input": [_f(2, 3, 9, 8)], "Filter": [_f(4, 3, 3, 2, seed=1)]},
        {"strides": [1, 2], "paddings": [0, 2, 1, 0], "dilations": [2, 1]}),
    "conv2d[SAME stride 2]": (
        {"Input": [_f(2, 3, 10, 9)], "Filter": [_f(4, 3, 4, 3, seed=1)]},
        {"strides": [2, 2], "padding_algorithm": "SAME"}),
    "conv2d[SAME stride 2, NHWC]": (
        {"Input": [_f(2, 10, 9, 3)], "Filter": [_f(4, 3, 4, 3, seed=1)]},
        {"strides": [2, 2], "padding_algorithm": "SAME",
         "data_format": "NHWC"}),
    "conv2d[VALID stride 3]": (
        {"Input": [_f(2, 3, 10, 9)], "Filter": [_f(4, 3, 3, 3, seed=1)]},
        {"strides": [3, 3], "paddings": [5, 5], "padding_algorithm": "VALID"}),
    "conv2d[f16 x, f32 filter: promotes]": (
        {"Input": [_f(2, 3, 9, 9).astype(np.float16)],
         "Filter": [_f(4, 3, 3, 3, seed=1)]}, {"paddings": [1, 1]}),
    "depthwise_conv2d": ({"Input": [_f(2, 4, 8, 8)],
                          "Filter": [_f(4, 1, 3, 3, seed=1)]},
                         {"strides": [2, 2], "paddings": [1, 1]}),
    "depthwise_conv2d[NHWC]": ({"Input": [_f(2, 8, 8, 4)],
                                "Filter": [_f(4, 1, 3, 3, seed=1)]},
                               {"paddings": [1, 1], "data_format": "NHWC"}),
    "pool2d": ({"X": [_f(2, 3, 9, 9)]},
               {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
                "paddings": [1, 1]}),
    "pool2d[max NHWC]": ({"X": [_f(2, 9, 9, 3)]},
                         {"pooling_type": "max", "ksize": [3, 3],
                          "strides": [2, 2], "paddings": [1, 1],
                          "data_format": "NHWC"}),
    "pool2d[max padding past half the window]": (
        {"X": [_f(2, 3, 7, 7)]}, {"pooling_type": "max", "ksize": [2, 2],
                                  "strides": [2, 2], "paddings": [2, 2]}),
    "pool2d[max ceil_mode, last window in the padding]": (
        {"X": [_f(2, 3, 7, 7)]}, {"pooling_type": "max", "ksize": [2, 2],
                                  "strides": [2, 2], "paddings": [1, 1],
                                  "ceil_mode": True}),
    "pool2d[avg exclusive ceil_mode]": (
        {"X": [_f(2, 3, 8, 8)]}, {"pooling_type": "avg", "ksize": [3, 3],
                                  "strides": [2, 2], "paddings": [1, 1],
                                  "ceil_mode": True, "exclusive": True}),
    "pool2d[avg exclusive ceil_mode NHWC, torch's windows]": (
        {"X": [_f(2, 9, 9, 3)]}, {"pooling_type": "avg", "ksize": [3, 3],
                                  "strides": [2, 2], "paddings": [1, 1],
                                  "ceil_mode": True, "exclusive": True,
                                  "data_format": "NHWC"}),
    "pool2d[avg inclusive padding]": (
        {"X": [_f(2, 3, 8, 8)]}, {"pooling_type": "avg", "ksize": [3, 3],
                                  "strides": [2, 2], "paddings": [1, 1],
                                  "exclusive": False}),
    "pool2d[avg inclusive ceil_mode, last window in the padding]": (
        {"X": [_f(2, 3, 7, 7)]}, {"pooling_type": "avg", "ksize": [2, 2],
                                  "strides": [2, 2], "paddings": [1, 1],
                                  "ceil_mode": True, "exclusive": False}),
    "pool2d[global max]": ({"X": [_f(2, 3, 5, 6)]},
                           {"pooling_type": "max", "global_pooling": True}),
    "pool2d[global avg NHWC]": ({"X": [_f(2, 5, 6, 3)]},
                                {"pooling_type": "avg", "ksize": [-1, -1],
                                 "data_format": "NHWC"}),
    "pool2d[adaptive avg]": ({"X": [_f(2, 3, 8, 6)]},
                             {"pooling_type": "avg", "ksize": [2, 3],
                              "adaptive": True}),
    "pool2d[adaptive max NHWC]": ({"X": [_f(2, 8, 6, 3)]},
                                  {"pooling_type": "max", "ksize": [4, 1],
                                   "adaptive": True, "data_format": "NHWC"}),
    "batch_norm": (_bn_inputs(2, 3, 5, 4), {"momentum": 0.9,
                                            "epsilon": 1e-5}),
    "batch_norm[NHWC]": (_bn_inputs(2, 5, 4, 3),
                         {"momentum": 0.8, "epsilon": 1e-3,
                          "data_layout": "NHWC"}),
    "batch_norm[test]": (_bn_inputs(2, 3, 5, 4), {"is_test": True}),
    "batch_norm[test NHWC]": (_bn_inputs(2, 5, 4, 3),
                              {"is_test": True, "data_layout": "NHWC"}),
    "batch_norm[use_global_stats]": (_bn_inputs(2, 3, 5, 4),
                                     {"use_global_stats": True}),
    "sync_batch_norm": (_bn_inputs(2, 3, 5, 4), {"momentum": 0.9}),
    "relu": ({"X": [_f(4, 6)]}, {}),
    "relu6": ({"X": [_f(4, 6) * 5.0]}, {}),
    "relu6[threshold]": ({"X": [_f(4, 6) * 5.0]}, {"threshold": 2.0}),
    "flatten_contiguous_range": ({"X": [_f(2, 3, 4, 5)]},
                                 {"start_axis": 1, "stop_axis": -1}),
    "flatten_contiguous_range[middle]": ({"X": [_f(2, 3, 4, 5)]},
                                         {"start_axis": 1, "stop_axis": 2}),
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_matches_reference(case):
    import jax.numpy as jnp
    op_type = case.split("[")[0]
    inputs, attrs = OP_CASES[case]
    want = JaxOpInfoMap.instance().get(op_type).compute(
        {s: [jnp.asarray(a) for a in v] for s, v in inputs.items()},
        dict(attrs))
    got = OpInfoMap.instance().get(op_type).compute(
        {s: [torch.from_numpy(np.array(a)) for a in v]
         for s, v in inputs.items()}, dict(attrs))
    for slot, vals in want.items():
        if slot in OpInfoMap.instance().get(op_type).intermediate_outputs \
                and slot not in got:
            continue
        w = np.asarray(jnp.asarray(vals[0]).astype(jnp.float32))
        g = got[slot][0]
        assert tuple(g.shape) == w.shape, slot
        np.testing.assert_allclose(g.float().numpy(), w, rtol=1e-5,
                                   atol=1e-5, err_msg=slot)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_batch_norm_takes_bf16_x_with_fp32_scale(layout):
    """Under O1 BN gets the bf16 output of a bf16 conv with fp32 scale,
    bias and running stats: statistics in fp32, Y in bf16 (one bf16
    rounding of the same value: rtol 2**-7), the stat slots fp32."""
    import jax.numpy as jnp
    inputs = _bn_inputs(2, 5, 4, 3) if layout == "NHWC" else \
        _bn_inputs(2, 3, 5, 4)
    x16 = torch.from_numpy(inputs["X"][0]).to(torch.bfloat16)
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "data_layout": layout}
    want = JaxOpInfoMap.instance().get("batch_norm").compute(
        dict({s: [jnp.asarray(v[0])] for s, v in inputs.items()},
             X=[jnp.asarray(x16.float().numpy()).astype(jnp.bfloat16)]),
        dict(attrs))
    got = OpInfoMap.instance().get("batch_norm").compute(
        dict({s: [torch.from_numpy(v[0])] for s, v in inputs.items()},
             X=[x16]), dict(attrs))
    assert got["Y"][0].dtype == torch.bfloat16
    np.testing.assert_allclose(
        got["Y"][0].float().numpy(),
        np.asarray(want["Y"][0].astype(jnp.float32)), rtol=2 ** -7,
        atol=2 ** -7)
    for slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        assert got[slot][0].dtype == torch.float32, slot
        np.testing.assert_allclose(got[slot][0].numpy(),
                                   np.asarray(want[slot][0]), rtol=1e-5,
                                   atol=1e-5, err_msg=slot)


def test_amp_lists_match_reference():
    from paddle_tpu.dygraph import tracer as jax_tracer
    from paddle_tpu_torch.dygraph import tracer
    assert tracer.AMP_WHITE_LIST == jax_tracer.AMP_WHITE_LIST
    assert tracer.AMP_BLACK_LIST == jax_tracer.AMP_BLACK_LIST


def test_dropout_draws_a_fresh_upscaled_mask():
    x = torch.ones(4000)
    attrs = {"dropout_prob": 0.25, "dropout_implementation":
             "upscale_in_train"}
    op = OpInfoMap.instance().get("dropout")
    a, b = (op.compute({"X": [x]}, dict(attrs)) for _ in range(2))
    kept = a["Mask"][0].bool()
    assert 0.7 < kept.float().mean().item() < 0.8
    assert torch.allclose(a["Out"][0][kept], torch.tensor(1 / 0.75))
    assert bool((a["Out"][0][~kept] == 0).all())
    assert not torch.equal(a["Mask"][0], b["Mask"][0])
    assert op.compute({"X": [x]}, {"dropout_prob": 0.0})["Out"][0] is x
