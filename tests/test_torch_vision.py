"""The vision models of the port against ``paddle_tpu.vision.models``.

Weights (and the BN running statistics) are drawn by the JAX model and
carried across with ``paddle_tpu_torch.convert.load_state_dict``; images
and labels come from numpy with a seed, as bench.py makes them (uniform
fp32 images, int32 labels). ResNet runs both layouts: NHWC images are
``[N, H, W, 3]``, NCHW ``[N, 3, H, W]``, and the filters are OIHW in both.

Tolerances, each measured on this CPU against the bound set here:
- Eval-mode logits: rtol / atol 1e-4 (fp32 convs summed in other orders;
  resnet18 reads 1.3e-5 at logits of size 16).
- Parameters are compared by their update: the error's Frobenius norm
  over the update's (``_update_errors``). A ReLU input that lies within
  rounding of 0 in one run moves one position's gradient, up to 12% of
  a weight gradient's largest element (seen between the port's own NHWC
  fp32 and float64 runs of resnet18) but little of its norm.
- O0 training, Momentum(0.1, 0.9), batch 4: losses at rtol 1e-5; every
  parameter within 2**-10 of its update after the first step (reads
  2.3e-5 to 2.7e-5) and 2**-5 after the second (reads up to 7.3e-3: at
  lr 0.1 a batch-4 BN net is ill-conditioned at step 2, where the JAX
  package's own fp32 gradient lies 1.4% of its largest element from the
  same computation in float64, the port's 2.6e-6, and the two packages
  in float64 agree to 3.5e-6); every ``_mean`` / ``_variance`` at rtol /
  atol 1e-5 after each step. A wrong gradient, off by its own size,
  fails the first-step bound by three orders.
- O1 (bf16 convs and matmuls, fp32 BN statistics), a bottleneck ResNet:
  the JAX package's own O1 lies from its O0 by a median of 0.30-0.31 and
  up to 0.37-0.41 of a parameter's update (bf16 gradients through batch-4
  BN), and its running statistics by up to 0.17. The port's O1 may lie
  from the JAX O1 no farther than twice that spread, measured in the
  test: the median and the largest update error over the parameters,
  and the largest buffer error (reads 1.05-1.3x the spread). Max-pool
  backward may also send a tied window's gradient to another element.
  Losses at rtol 1e-2 (2.6 bf16 ulps; the first reads up to 5.5e-3) and
  atol 3e-3: one step at lr 0.1 fits the 4 images, so the second loss is
  near 0.005, and there the JAX O1 lies up to 2.4e-3 from its O0 (the
  port's O1 from the JAX O1: 1.2e-3).

resnet50 and the rest of the zoo: ``tests/test_torch_vision_zoo.py``.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer import Momentum as JaxMomentum
from paddle_tpu.vision import models as jvm
import paddle_tpu as jpt

import paddle_tpu_torch as tpt
from paddle_tpu_torch import nn
from paddle_tpu_torch.convert import load_state_dict
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.initializer import KaimingNormal
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision import models as tvm

EVAL_TOL = dict(rtol=1e-4, atol=1e-4)
O0_LOSS_RTOL = 1e-5
BUF_TOL = dict(rtol=1e-5, atol=1e-5)
STEP1_UPDATE_TOL = 2.0 ** -10
STEP2_UPDATE_TOL = 2.0 ** -5
O1_LOSS_TOL = dict(rtol=1e-2, atol=3e-3)
O1_SPREAD_FACTOR = 2.0


class _JaxBottleneck14(jvm.ResNet):
    cfg = {14: (jvm.BottleneckBlock, [1, 1, 1, 1])}


class _Bottleneck14(tvm.ResNet):
    cfg = {14: (tvm.BottleneckBlock, [1, 1, 1, 1])}


def _images(layout, b, px, seed=0):
    rs = np.random.RandomState(seed)
    shape = (b, px, px, 3) if layout == "NHWC" else (b, 3, px, px)
    return (rs.rand(*shape).astype(np.float32),
            rs.randint(0, 10, (b, 1)).astype(np.int32))


def _pair(jax_cls, torch_cls, **kw):
    jpt.seed(0)
    jm = jax_cls(**kw)
    state = {k: v.numpy() for k, v in jm.state_dict().items()}
    tpt.set_device("cpu")
    return jm, load_state_dict(torch_cls(**kw), state), state


def _state(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _tstate(model):
    return {k: v.detach().numpy().copy() for k, v in
            model.state_dict().items()}


def _jax_step(model, amp):
    return JaxTrainStep(model, lambda m, x, y: JF.cross_entropy(m(x), y),
                        JaxMomentum(learning_rate=0.1, momentum=0.9,
                                    parameters=model.parameters()),
                        amp_level=amp)


def _torch_step(model, amp):
    return TrainStep(model, lambda m, x, y: F.cross_entropy(m(x), y),
                     Momentum(learning_rate=0.1, momentum=0.9,
                              parameters=model.parameters()),
                     amp_level=amp)


def _is_buffer(name):
    return name.endswith("._mean") or name.endswith("._variance")


def _update_errors(got, want, start):
    """name -> ||got - want|| / ||want - start|| (Frobenius: the error
    over the size of the update), for every parameter. A ReLU whose input
    lies within rounding of 0 in one run and not the other changes one
    position's gradient; its share of a norm is small where its share of
    the largest element is not."""
    return {n: np.linalg.norm(got[n] - want[n])
            / max(np.linalg.norm(want[n] - start[n]), 1e-12)
            for n in want if not _is_buffer(n)}


def _trajectory(step, model, x, y, n, snap):
    """n steps; the loss and a state snapshot after each."""
    losses, states = [], []
    for _ in range(n):
        losses.append(float(np.asarray(step(x, y).numpy())))
        states.append(snap(model))
    return losses, states


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_resnet18_eval_logits_match(layout):
    jm, tm, state = _pair(jvm.resnet18, tvm.resnet18, num_classes=10,
                          data_format=layout)
    x, _ = _images(layout, 4, 64)
    jm.eval()
    tm.eval()
    want = jm(jpt.to_tensor(x)).numpy()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **EVAL_TOL)


def _check_o0_steps(jax_cls, torch_cls, layout, b, px, n_steps, **kw):
    jm, tm, start = _pair(jax_cls, torch_cls, data_format=layout, **kw)
    x, y = _images(layout, b, px)
    j_loss, j_states = _trajectory(_jax_step(jm, "O0"), jm, x, y, n_steps,
                                   _state)
    t_loss, t_states = _trajectory(
        _torch_step(tm, "O0"), tm, torch.from_numpy(x), torch.from_numpy(y),
        n_steps, _tstate)
    np.testing.assert_allclose(t_loss, j_loss, rtol=O0_LOSS_RTOL)
    for i, (j, t) in enumerate(zip(j_states, t_states)):
        assert set(t) == set(j)
        for name in j:
            if _is_buffer(name):
                np.testing.assert_allclose(t[name], j[name], err_msg=name,
                                           **BUF_TOL)
        errs = _update_errors(t, j, start)
        bound = STEP1_UPDATE_TOL if i == 0 else STEP2_UPDATE_TOL
        worst = max(errs, key=errs.get)
        assert errs[worst] <= bound, (i + 1, worst, errs[worst])
    # the buffers really moved, by the reference's rule
    assert not np.allclose(t_states[-1]["bn1._mean"], start["bn1._mean"])
    return t_loss


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_resnet18_two_o0_steps_match(layout):
    losses = _check_o0_steps(jvm.resnet18, tvm.resnet18, layout, 4, 64, 2,
                             num_classes=10)
    assert losses[1] < losses[0]


def test_bottleneck_resnet_two_o0_steps_match():
    _check_o0_steps(_JaxBottleneck14, _Bottleneck14, "NHWC", 4, 64, 2,
                    depth=14, num_classes=10)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_bottleneck_resnet_o1_within_the_references_bf16_spread(layout):
    """The port's O1 against the JAX O1, measured against the JAX O1's
    own distance from its O0."""
    kw = dict(depth=14, num_classes=10, data_format=layout)
    x, y = _images(layout, 4, 64)
    runs = {}
    for amp in ("O0", "O1"):
        jm, _, start = _pair(_JaxBottleneck14, _Bottleneck14, **kw)
        runs[amp] = _trajectory(_jax_step(jm, amp), jm, x, y, 2, _state)
    _, tm, _ = _pair(_JaxBottleneck14, _Bottleneck14, **kw)
    t_loss, t_states = _trajectory(
        _torch_step(tm, "O1"), tm, torch.from_numpy(x), torch.from_numpy(y),
        2, _tstate)
    (_, j0_states), (j1_loss, j1_states) = runs["O0"], runs["O1"]
    np.testing.assert_allclose(t_loss, j1_loss, **O1_LOSS_TOL)
    for j0, j1, t in zip(j0_states, j1_states, t_states):
        ref = np.array(list(_update_errors(j1, j0, start).values()))
        got = np.array(list(_update_errors(t, j1, start).values()))
        for stat in (np.median, np.max):
            assert stat(got) <= O1_SPREAD_FACTOR * stat(ref), (
                stat.__name__, stat(got), stat(ref))
        bufs = [n for n in j1 if _is_buffer(n)]   # fp32 stats of bf16 data
        ref_buf = max(np.abs(j1[n] - j0[n]).max() for n in bufs)
        got_buf = max(np.abs(t[n] - j1[n]).max() for n in bufs)
        assert got_buf <= O1_SPREAD_FACTOR * ref_buf, (got_buf, ref_buf)


def test_load_state_dict_carries_bn_buffers():
    """convert.load_state_dict loads ``_mean`` / ``_variance`` with the
    parameters: eval logits then agree with running statistics that are
    not the initial zeros and ones."""
    jpt.seed(0)
    jm = jvm.resnet18(num_classes=10)
    rs = np.random.RandomState(4)
    state = {}
    for k, v in jm.state_dict().items():
        v = v.numpy()
        if k.endswith("._mean"):
            v = rs.randn(*v.shape).astype(np.float32) * 0.1
        elif k.endswith("._variance"):
            v = rs.rand(*v.shape).astype(np.float32) + 0.5
        state[k] = v
    assert jm.set_state_dict(state) == []
    tpt.set_device("cpu")
    tm = load_state_dict(tvm.resnet18(num_classes=10), state)
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), state[k], err_msg=k)
    x, _ = _images("NCHW", 2, 64)
    jm.eval()
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, jm(jpt.to_tensor(x)).numpy(), **EVAL_TOL)


def test_sequential_names_and_layer_options():
    tpt.set_device("cpu")
    seq = nn.Sequential(nn.Conv2D(3, 4, 3, bias_attr=False), nn.ReLU())
    assert [n for n, _ in seq.named_children()] == ["0", "1"]
    assert len(seq) == 2 and isinstance(seq[1], nn.ReLU)
    named = nn.Sequential([("conv", nn.Conv2D(3, 4, 1)), ("act", nn.ReLU6())])
    assert list(named.state_dict()) == ["conv.weight", "conv.bias"]
    assert nn.Linear(4, 3, bias_attr=False).bias is None
    bn = nn.BatchNorm2D(4)
    assert [n for n, _ in bn.named_buffers()] == ["_mean", "_variance"]


@pytest.mark.parametrize("cls", ["SyncBatchNorm", "BatchNorm"])
def test_other_batch_norm_layers_match(cls):
    """SyncBatchNorm on one device and fluid's BatchNorm(act=...): train
    then eval, output and running statistics against the JAX layers."""
    from paddle_tpu import nn as jnn
    kw = {"act": "relu"} if cls == "BatchNorm" else {}
    jl = getattr(jnn, cls)(3, momentum=0.8, **kw)
    tpt.set_device("cpu")
    tl = load_state_dict(getattr(nn, cls)(3, momentum=0.8, **kw),
                         {k: v.numpy() for k, v in jl.state_dict().items()})
    x = np.random.RandomState(2).randn(4, 3, 5, 5).astype(np.float32)
    for mode in ("train", "eval"):
        getattr(jl, mode)()
        getattr(tl, mode)()
        want = jl(jpt.to_tensor(x)).numpy()
        with torch.no_grad():
            got = tl(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, **BUF_TOL)
        for k, v in jl.state_dict().items():
            np.testing.assert_allclose(tl.state_dict()[k].numpy(),
                                       v.numpy(), err_msg=k, **BUF_TOL)


def test_kaiming_normal_draws_from_its_generator():
    draw = [KaimingNormal(fan_in=50, generator=torch.Generator().manual_seed(
        7))((256, 50), "float32") for _ in range(2)]
    assert torch.equal(draw[0], draw[1])
    assert abs(draw[0].std().item() / np.sqrt(2.0 / 50) - 1.0) < 0.02
