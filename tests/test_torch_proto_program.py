"""The reference's protobuf ``__model__`` and LoDTensor parameter streams
(``paddle_tpu_torch/inference/proto_program.py``) in the port against
the JAX package, on the CPU.

The cases of ``tests/test_proto_import.py`` (an artifact round trip, a
combined parameter file, LoDTensor streams of each dtype, unmapped op
types raising), then across the packages:

- a ``__model__`` and its parameter streams written by the JAX package
  load in the port through ``io.load_inference_model`` and a
  ``Predictor``, and give the JAX executor's outputs (rtol 1e-5 /
  atol 1e-6: the same fp32 program on two frameworks);
- the port writes the JAX package's bytes, file for file, for the same
  Program JSON and parameter values;
- a bfloat16 parameter survives the round trip bit for bit, written by
  either package and read by the other, and a bf16 attention artifact
  (``chip_smoke.attn_program`` at hidden 64, 4 heads, seq 16) saved by
  ``save_inference_model`` and written again as a reference artifact
  (``chip_smoke.resave_reference``) predicts the JSON route's bits.
"""
import os
import types

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.static as jstatic
from paddle_tpu import io as jio
from paddle_tpu.inference import proto_program as jproto

import chip_smoke as cs
import paddle_tpu_torch as tpt
from paddle_tpu_torch import inference, io, static
from paddle_tpu_torch.core.enforce import NotFoundError
from paddle_tpu_torch.inference.proto_program import (
    program_from_bytes, program_to_bytes, read_lod_tensor,
    save_reference_inference_model, write_lod_tensor)
from paddle_tpu_torch.testing.decoder_cases import startup_values

JAX_API = types.SimpleNamespace(pt=jpt, static=jstatic)
PORT_API = types.SimpleNamespace(pt=tpt, static=static)
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")


def _toy_program(api):
    """test_proto_import's toy: fc(8, relu) then fc(3, softmax) on x
    [-1, 4]."""
    main, startup = api.pt.Program(), api.pt.Program()
    with api.pt.program_guard(main, startup):
        x = api.static.data("px", [-1, 4])
        h = api.static.nn.fc(x, 8, act="relu")
        out = api.static.nn.fc(h, 3, act="softmax")
    return main, startup, out.name


@pytest.fixture(scope="module")
def toy():
    """The toy built by both packages (JSON equal), startup values from
    the port's run, a seeded batch."""
    tpt.set_device("cpu")
    jmain, _, jout = _toy_program(JAX_API)
    pmain, pstart, pout = _toy_program(PORT_API)
    assert pmain.to_json() == jmain.to_json() and jout == pout
    xb = np.random.RandomState(0).randn(5, 4).astype(np.float32)
    return dict(jmain=jmain, pmain=pmain, out=pout, xb=xb,
                values=startup_values(pstart))


def _port_scope(values):
    scope = tpt.Scope()
    for k, v in values.items():
        scope.var(k).set(tpt.TpuTensor(v, device="cpu"))
    return scope


def _jax_scope(values):
    scope = jpt.Scope()
    for k, v in values.items():
        scope.var(k).set(jpt.TpuTensor(v))
    return scope


def test_reference_artifact_round_trip(toy, tmp_path):
    """test_reference_artifact_round_trip: save, then load in a fresh
    scope through io.load_inference_model."""
    exe = tpt.Executor("cpu")
    scope = _port_scope(toy["values"])
    want, = exe.run(toy["pmain"], feed={"px": toy["xb"]},
                    fetch_list=[toy["out"]], scope=scope)
    save_reference_inference_model(str(tmp_path), ["px"], [toy["out"]],
                                   toy["pmain"], scope=scope)
    assert os.path.exists(tmp_path / "__model__")
    scope2 = tpt.Scope()
    prog, feeds, fetches = io.load_inference_model(str(tmp_path), exe,
                                                   scope=scope2)
    assert feeds == ["px"] and fetches == [toy["out"]]
    got, = exe.run(prog, feed={"px": toy["xb"]}, fetch_list=fetches,
                   scope=scope2)
    np.testing.assert_array_equal(got, want)


def test_combined_params_file(toy, tmp_path):
    exe = tpt.Executor("cpu")
    scope = _port_scope(toy["values"])
    save_reference_inference_model(
        str(tmp_path), ["px"], [toy["out"]], toy["pmain"], scope=scope,
        model_filename="model.pdmodel", params_filename="params.pdparams")
    scope2 = tpt.Scope()
    prog, _, _ = io.load_inference_model(
        str(tmp_path), exe, model_filename="model.pdmodel",
        params_filename="params.pdparams", scope=scope2)
    names = [v.name for v in prog.global_block().vars.values()
             if v.persistable and v.type == "LOD_TENSOR"]
    assert names
    for n in names:
        assert torch.equal(scope.find_var(n).get().value,
                           scope2.find_var(n).get().value)


STREAMS = [np.arange(12, dtype=np.float32).reshape(3, 4),
           np.arange(5, dtype=np.int64), np.ones((2, 2), np.float64),
           np.array([True, False]), np.arange(6, dtype=np.int8),
           np.arange(4, dtype=np.uint8), np.arange(3, dtype=np.int16),
           np.linspace(-2, 2, 6).astype(np.float16),
           np.arange(7, dtype=np.int32), np.float32(2.5)]


@pytest.mark.parametrize("arr", STREAMS, ids=lambda a: a.dtype.name)
def test_lod_tensor_stream_round_trip(arr, tmp_path):
    """test_lod_tensor_stream_round_trip, each dtype of the VarType
    table: the port reads back what it wrote, and writes the JAX
    package's bytes."""
    p = tmp_path / "t.bin"
    with open(p, "wb") as f:
        write_lod_tensor(f, arr)
    with open(p, "rb") as f:
        back = read_lod_tensor(f)
    np.testing.assert_array_equal(back.numpy(), arr)
    assert back.numpy().dtype == np.asarray(arr).dtype
    with open(tmp_path / "j.bin", "wb") as f:
        jproto.write_lod_tensor(f, np.asarray(arr))
    assert p.read_bytes() == (tmp_path / "j.bin").read_bytes()


def test_bf16_stream_crosses_both_ways(tmp_path):
    """A bfloat16 parameter through the stream: the port writes its raw
    16-bit words, which the JAX package (ml_dtypes) reads bit for bit,
    and reads the JAX package's stream back to the same bits, with no
    ml_dtypes of its own."""
    t = (torch.arange(-8, 16, dtype=torch.float32) / 7).reshape(4, 6) \
        .to(torch.bfloat16)
    p = tmp_path / "port.bin"
    with open(p, "wb") as f:
        write_lod_tensor(f, t)
    with open(p, "rb") as f:
        j = jproto.read_lod_tensor(f)
    assert j.dtype.name == "bfloat16"
    assert j.tobytes() == t.view(torch.int16).numpy().tobytes()
    q = tmp_path / "jax.bin"
    with open(q, "wb") as f:
        jproto.write_lod_tensor(f, j)
    assert q.read_bytes() == p.read_bytes()
    with open(q, "rb") as f:
        back = read_lod_tensor(f)
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)


def test_unmapped_ops_raise_loudly():
    prog = tpt.Program()
    blk = prog.global_block()
    blk.create_var("a")
    blk.append_op("totally_bogus_op", {"X": ["a"]}, {"Out": ["a"]}, {})
    data = program_to_bytes(prog)
    with pytest.raises(NotFoundError, match="totally_bogus_op"):
        program_from_bytes(data)
    assert program_from_bytes(data, check_ops=False).op_types() == [
        "totally_bogus_op"]


def test_jax_written_artifact_loads_in_the_port(toy, tmp_path):
    """The JAX package writes the artifact; the port loads it through
    io.load_inference_model and through a Predictor, and gives the JAX
    executor's outputs."""
    jscope = _jax_scope(toy["values"])
    want, = jpt.Executor().run(toy["jmain"], feed={"px": toy["xb"]},
                               fetch_list=[toy["out"]], scope=jscope)
    jproto.save_reference_inference_model(str(tmp_path), ["px"],
                                          [toy["out"]], toy["jmain"],
                                          scope=jscope)
    exe = tpt.Executor("cpu")
    scope = tpt.Scope()
    prog, feeds, fetches = io.load_inference_model(str(tmp_path), exe,
                                                   scope=scope)
    got, = exe.run(prog, feed={"px": toy["xb"]}, fetch_list=fetches,
                   scope=scope)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    pred = inference.create_predictor(inference.Config(str(tmp_path)))
    assert pred.get_input_names() == ["px"]
    out, = pred.run([toy["xb"]])
    np.testing.assert_array_equal(out, got)


@pytest.mark.parametrize("params_filename", [None, "params.pdparams"])
def test_port_writes_the_jax_bytes(toy, tmp_path, params_filename):
    """For the same Program JSON and parameter values, the port's
    __model__ and parameter files are the JAX package's, byte for byte;
    the program bytes alone too."""
    assert program_to_bytes(toy["pmain"]) == \
        jproto.program_to_bytes(toy["jmain"])
    pdir, jdir = tmp_path / "port", tmp_path / "jax"
    save_reference_inference_model(str(pdir), ["px"], [toy["out"]],
                                   toy["pmain"],
                                   scope=_port_scope(toy["values"]),
                                   params_filename=params_filename)
    jproto.save_reference_inference_model(
        str(jdir), ["px"], [toy["out"]], toy["jmain"],
        scope=_jax_scope(toy["values"]), params_filename=params_filename)
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(pdir)) == names and "__model__" in names
    for n in names:
        assert (pdir / n).read_bytes() == (jdir / n).read_bytes(), n


def test_bf16_attention_artifact_predicts_the_json_route(tmp_path):
    """A bf16 attention program saved by save_inference_model (JSON IR,
    npz), written again as a reference artifact: its parameters come back
    bf16 bit for bit, and a Predictor over it (and io.load_inference_model
    with Executor.run) gives the JSON route's output bits; the JAX
    package loads the same artifact and agrees within the bf16 bound."""
    json_dir, ref_dir = str(tmp_path / "json"), str(tmp_path / "ref")
    shape = dict(hidden=64, heads=4, seq=16)
    cs.save_attn(cs.port_static_api(), tpt.Executor("cpu"), json_dir,
                 **shape, dtype="bfloat16")
    feeds, fetches = cs.resave_reference(tpt, json_dir, ref_dir)
    assert feeds == ["x"]
    x = np.random.RandomState(2).randn(2, 16, 64).astype(np.float32)
    _, (want,) = cs.predict(tpt, json_dir, {"x": x})
    _, (got,) = cs.predict(tpt, ref_dir, {"x": x})
    np.testing.assert_array_equal(got, want)
    exe, scope = tpt.Executor("cpu"), tpt.Scope()
    prog, _, fetch = io.load_inference_model(ref_dir, exe, scope=scope)
    assert scope.find_var("wq").get().value.dtype == torch.bfloat16
    jscope = tpt.Scope()
    io.load_inference_model(json_dir, exe, scope=jscope)
    for n in ("wq", "wo_b", "ln_scale"):
        assert torch.equal(scope.find_var(n).get().value,
                           jscope.find_var(n).get().value)
    again, = exe.run(prog, feed={"x": x}, fetch_list=fetch, scope=scope)
    np.testing.assert_array_equal(again, want)
    jexe, jsc = jpt.Executor(), jpt.Scope()
    jprog, _, jfetch = jio.load_inference_model(ref_dir, jexe, scope=jsc)
    jout, = jexe.run(jprog, feed={"x": x}, fetch_list=jfetch, scope=jsc)
    np.testing.assert_allclose(np.asarray(jout, np.float32), want,
                               rtol=2e-2, atol=2e-2)
