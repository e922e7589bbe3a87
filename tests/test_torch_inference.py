"""The port's single-request predictor (paddle_tpu_torch.inference)
against the JAX package's, on artifacts the JAX package saved.

Three models go through ``save_inference_model`` in the JAX package: an
MLP, the tiny static ResNet of tests/test_torch_executor.py (batch -1,
for inference) and a narrow attn program (the serving slice's
self-attention tenant at hidden 64, 2 heads, S 16, fp32). The port's
``Predictor`` runs each, through ``run(list)`` and through the
zero-copy handles, beside the JAX ``Predictor`` on the same directory
and inputs. fp32 on the CPU on both sides: held at rtol 1e-5 and an
atol of 1e-5 of the output's largest magnitude.
"""
import types
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.static as jstatic
from paddle_tpu import inference as jinference
from paddle_tpu import io as jio
from paddle_tpu.nn import ParamAttr as JaxParamAttr
from paddle_tpu.nn.initializer import Uniform as JaxUniform
from paddle_tpu.optimizer import Momentum as JaxMomentum
from paddle_tpu.serving import model as jmodel

import chip_smoke
import paddle_tpu_torch as tpt
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch.core.enforce import InvalidArgumentError
from paddle_tpu_torch.serving import model as tmodel

JAX_API = types.SimpleNamespace(pt=jpt, static=jstatic, io=jio,
                                ParamAttr=JaxParamAttr, Uniform=JaxUniform,
                                Momentum=JaxMomentum)
PORT_API = chip_smoke.port_static_api()
RTOL, ATOL = 1e-5, 1e-5
NARROW_ATTN = dict(hidden=64, heads=2, seq=16)
# tests/test_torch_executor.py's TINY_RESNET, for inference (batch -1)
TINY_RESNET = dict(px=64, class_dim=10, depth=(1, 1, 1, 1),
                   num_filters=(8, 16, 32, 64))


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice._device
    tpt.set_device("cpu")
    yield
    tdevice._device = prev


def save_mlp(api, path, in_dim=4, out_dim=3, seed=3):
    """relu(x @ w + b) saved by ``api``'s save_inference_model."""
    prog = api.pt.Program()
    blk = prog.global_block()
    blk.create_var("x", shape=(-1, in_dim), dtype="float32", is_data=True)
    blk.create_var("w", shape=(in_dim, out_dim), dtype="float32",
                   persistable=True)
    blk.create_var("b", shape=(out_dim,), dtype="float32", persistable=True)
    for n in ("xw", "lin", "out"):
        blk.create_var(n)
    blk.append_op("mul", {"X": ["x"], "Y": ["w"]}, {"Out": ["xw"]},
                  {"x_num_col_dims": 1, "y_num_col_dims": 1})
    blk.append_op("elementwise_add", {"X": ["xw"], "Y": ["b"]},
                  {"Out": ["lin"]}, {})
    blk.append_op("relu", {"X": ["lin"]}, {"Out": ["out"]}, {})
    rs = np.random.RandomState(seed)
    w = rs.randn(in_dim, out_dim).astype(np.float32)
    b = rs.randn(out_dim).astype(np.float32)
    scope = api.pt.Scope()
    scope.var("w").set(api.pt.TpuTensor(w))
    scope.var("b").set(api.pt.TpuTensor(b))
    with api.pt.scope_guard(scope):
        api.io.save_inference_model(path, ["x"], ["out"], api.pt.Executor(),
                                    main_program=prog, scope=scope)
    return w, b


def _save(kind, path):
    """A JAX-saved artifact of ``kind``; returns one seeded input batch."""
    rs = np.random.RandomState(5)
    if kind == "mlp":
        save_mlp(JAX_API, path)
        return rs.rand(5, 4).astype(np.float32)
    if kind == "resnet":
        chip_smoke.save_static_resnet(JAX_API, jpt.Executor(), path,
                                      **TINY_RESNET)
        return rs.rand(3, 3, 64, 64).astype(np.float32)
    chip_smoke.save_attn(JAX_API, jpt.Executor(), path, **NARROW_ATTN)
    return rs.randn(3, NARROW_ATTN["seq"],
                    NARROW_ATTN["hidden"]).astype(np.float32)


def _assert_close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())


@pytest.mark.parametrize("kind", ["mlp", "resnet", "attn"])
def test_predictor_matches_the_jax_predictor(kind, tmp_path):
    x = _save(kind, str(tmp_path))
    jpred = jinference.create_predictor(jinference.Config(str(tmp_path)))
    want, = jpred.run([x])
    pred = tinference.create_predictor(tinference.Config(str(tmp_path)))
    assert pred.get_input_names() == jpred.get_input_names()
    assert pred.get_output_names() == jpred.get_output_names()
    got, = pred.run([x])
    assert got.shape == want.shape and got.dtype == np.float32
    _assert_close(got, np.asarray(want))
    # the zero-copy surface gives run(list)'s numbers
    name = pred.get_input_names()[0]
    pred.get_input_handle(name).copy_from_cpu(x)
    assert pred.zero_copy_run() is True
    out = pred.get_output_handle(pred.get_output_names()[0])
    assert out.shape() == list(want.shape)
    np.testing.assert_array_equal(out.copy_to_cpu(), got)
    np.testing.assert_array_equal(out.numpy(), got)


@pytest.mark.parametrize("kind", ["mlp", "resnet", "attn"])
def test_pure_fn_is_the_predictor(kind, tmp_path):
    """The serving closure (``_pure_fn`` over ``_model_params``) gives
    the Predictor's bits, and its meta twin the same shapes."""
    x = _save(kind, str(tmp_path))
    pred = tinference.create_predictor(tinference.Config(str(tmp_path)))
    want, = pred.run([x])
    params = tinference._model_params(pred._program, pred._scope)
    fn = tinference._pure_fn(pred._program, pred._scope,
                             pred.get_input_names(),
                             pred.get_output_names(), params=params)
    got, = fn(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    meta, = tinference._meta_fn(pred._program, pred.get_input_names(),
                                pred.get_output_names(), params)(
        torch.empty(x.shape, device="meta"))
    assert meta.shape == got.shape and meta.dtype == got.dtype


@pytest.mark.parametrize("kind", ["mlp", "resnet", "attn"])
def test_cache_key_parts_agree_across_packages(kind, tmp_path):
    """The program fingerprint and the parameter digest, the parts of
    the executable-cache key the packages share, are equal on one
    artifact."""
    _save(kind, str(tmp_path))
    jpred = jinference.Predictor(jinference.Config(str(tmp_path)))
    pred = tinference.Predictor(tinference.Config(str(tmp_path)))
    assert pred._program.fingerprint() == jpred._program.fingerprint()
    jparams = jinference._model_params(jpred._program, jpred._scope)
    params = tinference._model_params(pred._program, pred._scope)
    assert sorted(params) == sorted(jparams)
    assert tmodel._params_digest(params) == jmodel._params_digest(jparams)


def test_bfloat16_parameters_round_trip(tmp_path):
    """npz has no bfloat16: the port writes it as float32 (exact) and
    load_inference_model restores the dtype the program declares; the
    digest hashes bfloat16's own 2-byte words."""
    values = chip_smoke.save_attn(PORT_API, tpt.Executor(), str(tmp_path),
                                  **NARROW_ATTN, dtype="bfloat16")
    pred = tinference.Predictor(tinference.Config(str(tmp_path)))
    params = tinference._model_params(pred._program, pred._scope)
    assert set(values) <= set(params)
    for n, v in values.items():
        assert params[n].dtype == torch.bfloat16
        assert torch.equal(params[n],
                           torch.from_numpy(v).to(torch.bfloat16))
    w = params["wq"]
    dt, raw = tmodel._param_bytes(w)
    assert dt == "bfloat16" and len(raw) == 2 * w.numel()
    assert raw == w.view(torch.int16).numpy().tobytes()
    x = np.random.RandomState(1).randn(
        2, NARROW_ATTN["seq"], NARROW_ATTN["hidden"]).astype(np.float32)
    out, = pred.run([x])
    assert out.dtype == np.float32 and np.isfinite(out).all()


def test_predictor_contracts(tmp_path):
    save_mlp(JAX_API, str(tmp_path))
    with pytest.raises(InvalidArgumentError):
        tinference.Predictor(tinference.Config())
    pred = tinference.create_predictor(tinference.Config(str(tmp_path)))
    with pytest.raises(InvalidArgumentError, match="not set"):
        pred.run()
    with pytest.raises(InvalidArgumentError, match="not produced"):
        pred.get_output_tensor("out").copy_to_cpu()
    cfg = tinference.Config(str(tmp_path))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cfg.enable_use_gpu(100, 0)
        cfg.enable_tensorrt_engine(workspace_size=1)
    assert len(caught) == 2 and "no effect" in str(caught[0].message)
    cfg.switch_ir_optim(False)
    assert not cfg.ir_optim() and cfg.model_dir() == str(tmp_path)


def test_predictor_needs_a_card_or_the_cpu(tmp_path):
    """No fallback: with no card and no set_device("cpu") the predictor
    refuses to load."""
    save_mlp(JAX_API, str(tmp_path))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    tdevice._device = None
    with pytest.raises(tpt.core.enforce.UnavailableError):
        tinference.Predictor(tinference.Config(str(tmp_path)))
