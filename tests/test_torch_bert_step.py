"""BERT-tiny through the port's TrainStep against the JAX package's.

Weights are drawn by the JAX model and carried across with
``paddle_tpu_torch.convert.load_state_dict``; ids and labels come from
numpy with a seed, as bench.py makes them (int32). The JAX step runs with
buffer donation off: its BertForPretraining lists the tied decoder weight
under two names, and donating one buffer twice fails on the CPU.

Tolerances. O0 (fp32 throughout): forward scores and losses at
rtol 1e-4 / atol 1e-5 and params after 3 steps at rtol 1e-4 / atol 2e-5
(the two frameworks sum in other orders). O1 (bf16 matmuls): the
reference sums the bf16 cotangents of a tensor read by several matmuls in
bf16, torch autograd in fp32, so gradients land up to one bf16 ulp
(2**-8 of their size) apart. Losses are held at rtol 4e-3 (one bf16 ulp);
each parameter's 3-step update at 2**-5 of that update's largest element
(about 1.6% is measured on this model: the ulps compound over the
steps), which a wrong gradient, off by its own size, cannot meet.
"""
import jax
import numpy as np
import pytest
import torch

from paddle_tpu.core.registry import OpInfoMap as JaxOpInfoMap
from paddle_tpu.dygraph.tracer import set_amp_level as jax_set_amp_level
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.optimizer import SGD as JaxSGD
from paddle_tpu.optimizer import Momentum as JaxMomentum
from paddle_tpu.text.models import BertForPretraining as JaxBert
import paddle_tpu as jpt

import paddle_tpu_torch as tpt
from paddle_tpu_torch.convert import load_state_dict
from paddle_tpu_torch.core.enforce import InvalidArgumentError
from paddle_tpu_torch.core.registry import OpInfoMap
from paddle_tpu_torch.dygraph.tracer import set_amp_level
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.dygraph.layers import LayerList
from paddle_tpu_torch.optimizer import SGD, Momentum
from paddle_tpu_torch.text.models import BertForPretraining

TINY = dict(vocab_size=512, d_model=64, num_layers=2, nhead=2, d_ffn=128,
            dropout=0.0)
LR = 1e-2   # large enough that 3 steps move every parameter visibly
O0_TOL = dict(rtol=1e-4, atol=1e-5)
O0_PARAM_TOL = dict(rtol=1e-4, atol=2e-5)
O1_LOSS_TOL = dict(rtol=4e-3, atol=1e-5)
O1_UPDATE_TOL = 2.0 ** -5


class _JaxTrainStep(JaxTrainStep):
    def _build_jit(self, pv, bv, raw_args):
        return jax.jit(self._step)


def _step_fn(m, ids, labels, nsp):
    return m(ids, masked_lm_labels=labels, next_sentence_label=nsp)


def _batch(seq, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, TINY["vocab_size"], (2, seq)).astype(np.int32)
    labels = np.where(rs.rand(2, seq) < 0.15, ids, -1).astype(np.int32)
    labels[:, 0] = ids[:, 0]          # at least one masked token a row
    nsp = rs.randint(0, 2, (2, 1)).astype(np.int32)
    return ids, labels, nsp


def _models():
    jpt.seed(0)
    jm = JaxBert(**TINY)
    state = {k: v.numpy() for k, v in jm.state_dict().items()}
    tpt.set_device("cpu")
    tm = load_state_dict(BertForPretraining(**TINY), state)
    return jm, tm


@pytest.mark.parametrize("seq", [32, 30])
def test_forward_scores_match(seq):
    jm, tm = _models()
    ids, _, _ = _batch(seq)
    j_mlm, j_nsp = jm(jpt.to_tensor(ids))
    with torch.no_grad():
        t_mlm, t_nsp = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(t_mlm.numpy(), j_mlm.numpy(), **O0_TOL)
    np.testing.assert_allclose(t_nsp.numpy(), j_nsp.numpy(), **O0_TOL)


def _opts(kind, jm, tm):
    if kind == "sgd":
        return (JaxSGD(learning_rate=LR, parameters=jm.parameters()),
                SGD(learning_rate=LR, parameters=tm.parameters()))
    return (JaxMomentum(learning_rate=LR, momentum=0.9,
                        parameters=jm.parameters()),
            Momentum(learning_rate=LR, momentum=0.9,
                     parameters=tm.parameters()))


@pytest.mark.parametrize("amp,seq,opt", [
    ("O0", 32, "momentum"), ("O0", 30, "momentum"), ("O1", 32, "momentum"),
    ("O1", 30, "momentum"), ("O0", 32, "sgd")])
def test_train_step_trajectory_and_params_match(amp, seq, opt):
    jm, tm = _models()
    j_opt, t_opt = _opts(opt, jm, tm)
    j_step = _JaxTrainStep(jm, _step_fn, j_opt, amp_level=amp)
    t_step = TrainStep(tm, _step_fn, t_opt, amp_level=amp)
    start = {k: v.numpy().copy() for k, v in jm.state_dict().items()}
    batch = _batch(seq)
    j_loss = [float(j_step(*batch).numpy()) for _ in range(3)]
    t_loss = [float(t_step(*batch)) for _ in range(3)]
    np.testing.assert_allclose(
        t_loss, j_loss, **(O0_TOL if amp == "O0" else O1_LOSS_TOL))
    assert len(set(j_loss)) == 3        # the steps really moved
    j_params = {k: v.numpy() for k, v in jm.state_dict().items()}
    t_params = {k: v.numpy() for k, v in tm.state_dict().items()}
    assert set(t_params) == set(j_params)
    for name, want in j_params.items():
        if amp == "O0":
            np.testing.assert_allclose(t_params[name], want, err_msg=name,
                                       **O0_PARAM_TOL)
            continue
        j_upd, t_upd = want - start[name], t_params[name] - start[name]
        bound = O1_UPDATE_TOL * np.abs(j_upd).max() + 1e-6
        assert np.abs(t_upd - j_upd).max() <= bound, name


def test_o1_attention_inputs_are_float32_in_both(monkeypatch):
    """Under O1 the bias add after each bf16 matmul promotes back to fp32,
    so q, k and v reach flash_attention as float32 in both packages."""
    seen = {"jax": [], "torch": []}
    for key, opmap in (("jax", JaxOpInfoMap), ("torch", OpInfoMap)):
        opdef = opmap.instance().get("flash_attention")
        real = opdef.compute

        def spy(inputs, attrs, _real=real, _key=key):
            seen[_key].append(tuple(str(inputs[s][0].dtype).split(".")[-1]
                                    for s in ("Q", "K", "V")))
            return _real(inputs, attrs)
        monkeypatch.setattr(opdef, "compute", spy)
    jm, tm = _models()
    ids, labels, nsp = _batch(32)
    jax_set_amp_level("O1")
    set_amp_level("O1")
    try:
        jm(jpt.to_tensor(ids), masked_lm_labels=jpt.to_tensor(labels),
           next_sentence_label=jpt.to_tensor(nsp))
        tm(torch.from_numpy(ids), masked_lm_labels=torch.from_numpy(labels),
           next_sentence_label=torch.from_numpy(nsp))
    finally:
        jax_set_amp_level("O0")
        set_amp_level("O0")
    assert seen["jax"] == [("float32",) * 3] * TINY["num_layers"]
    assert seen["torch"] == seen["jax"]


def test_encoder_layers_start_equal_and_decoder_is_tied():
    tpt.set_device("cpu")
    tpt.seed(0)
    m = BertForPretraining(**TINY)
    sd = m.state_dict()
    for name, val in sd.items():
        if ".layer_1." in name:
            assert torch.equal(val, sd[name.replace(".layer_1.",
                                                    ".layer_0.")])
    assert m.cls.decoder_weight is m.bert.embeddings.word.weight
    assert "cls.decoder_weight" in sd
    names = [n for n, _ in m.named_parameters()]
    assert "cls.decoder_weight" not in names    # one Parameter, one update


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "untied"])
def test_convert_rejects_bad_state(fault):
    jm, _ = _models()
    state = {k: v.numpy() for k, v in jm.state_dict().items()}
    if fault == "missing":
        del state["bert.pooler.dense.bias"]
    elif fault == "extra":
        state["bert.extra.weight"] = np.zeros(3, np.float32)
    elif fault == "shape":
        state["bert.pooler.dense.bias"] = np.zeros(3, np.float32)
    else:
        state["cls.decoder_weight"] = state["cls.decoder_weight"] + 1.0
    with pytest.raises(InvalidArgumentError):
        load_state_dict(BertForPretraining(**TINY), state)


def test_set_state_dict_and_layer_list():
    _, tm = _models()
    other = BertForPretraining(**TINY)
    state = {k: v.numpy() for k, v in tm.state_dict().items()}
    del state["cls.decoder_bias"]
    assert other.set_state_dict(state) == ["cls.decoder_bias"]
    for name, val in state.items():
        assert np.array_equal(other.state_dict()[name].numpy(), val), name
    layers = LayerList([tm.cls.transform]).append(tm.cls.seq_relationship)
    assert len(layers) == 2 and layers[1] is tm.cls.seq_relationship
    assert [n for n, _ in layers.named_parameters()] == [
        "0.weight", "0.bias", "1.weight", "1.bias"]
