"""F2: a bfloat16 fetch comes back as bfloat16, with the reference's
bytes.

A program that fetches bf16 (``relu(x @ w + b)`` cast to bf16, on
integer-valued inputs and weights, so every value is exact in both
libraries and in bf16) is saved by the JAX package's
``save_inference_model`` and run by both packages' ``Predictor``
(``run(list)`` and the zero-copy handle) and both ``PredictorServer``s.
Every fetch must have the reference's dtype (``ml_dtypes.bfloat16``) and
the same bytes; before the repair the port's came back float32. The
serving plane's ``Readback`` gives the same array on the CPU; on the
card it copies the int16 words (``chip_smoke.py`` phase ``predictor``).
``Executor.run`` fetches bf16 the same way (F4, found beside F2).
"""
import numpy as np
import torch

import paddle_tpu as jpt
from paddle_tpu import inference as jinference
from paddle_tpu.core.tensor import TpuTensor as JaxTensor
from paddle_tpu.io import save_inference_model as jax_save

from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch.core import dtype as tdtype
from paddle_tpu_torch.serving import PredictorServer
from paddle_tpu_torch.serving.model import Readback
from test_torch_serving import (JaxServer, _mlp_program,  # noqa: F401
                                _pristine, serving)


def save_bf16_mlp(dirname):
    rs = np.random.RandomState(4)
    w = rs.randint(-3, 4, (4, 3)).astype(np.float32)
    b = rs.randint(-3, 4, (3,)).astype(np.float32)
    prog = _mlp_program(jpt, 4, 3)
    blk = prog.global_block()
    blk.create_var("out16", dtype="bfloat16")
    blk.append_op("cast", {"X": ["out"]}, {"Out": ["out16"]},
                  {"out_dtype": "bfloat16"})
    scope = jpt.Scope()
    scope.var("w").set(JaxTensor(w))
    scope.var("b").set(JaxTensor(b))
    with jpt.scope_guard(scope):
        jax_save(dirname, ["x"], ["out16"], jpt.Executor(), prog,
                 scope=scope)


def _x(rows, seed=0):
    return np.random.RandomState(seed).randint(-4, 5, (rows, 4)).astype(
        np.float32)


def _same_bf16(got, want):
    want = np.asarray(want)
    assert want.dtype.name == "bfloat16"
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_predictor_fetches_bfloat16_as_the_reference_does(tmp_path):
    save_bf16_mlp(str(tmp_path))
    x = _x(5)
    want, = jinference.Predictor(jinference.Config(str(tmp_path))).run([x])
    pred = tinference.Predictor(tinference.Config(str(tmp_path)))
    got, = pred.run([x])
    _same_bf16(got, want)
    _same_bf16(pred.get_output_tensor("out16").copy_to_cpu(), want)
    assert tdtype.NP_BFLOAT16 is not None      # ml_dtypes imports here


def test_server_and_readback_fetch_bfloat16(tmp_path):
    save_bf16_mlp(str(tmp_path / "m"))
    buckets = [{"x": (4, 4)}]
    jsrv = JaxServer(cache_dir=None)
    jsrv.add_tenant("m", str(tmp_path / "m"), buckets=buckets)
    srv = PredictorServer(cache_dir=None)
    srv.add_tenant("m", str(tmp_path / "m"), buckets=buckets)
    with serving(jsrv), serving(srv):
        for rows in (1, 3):
            x = _x(rows, rows)
            want, = jsrv.predict("m", {"x": x})
            got, = srv.predict("m", {"x": x})
            _same_bf16(got, want)
    t = torch.tensor([[1.5, -2.0], [3.0, 0.0]], dtype=torch.bfloat16)
    out, = Readback([t]).wait()
    _same_bf16(out, t.view(torch.int16).numpy().view(out.dtype))
    np.testing.assert_array_equal(out.astype(np.float32),
                                  t.float().numpy())


def test_executor_fetches_bfloat16_as_the_reference_does(tmp_path):
    """F4: ``Executor.run`` of the same program returns the bf16 fetch as
    ml_dtypes' bfloat16 too (before, float32), and takes a bf16 feed."""
    import paddle_tpu_torch as tpt
    from paddle_tpu import io as jio
    from paddle_tpu_torch import io as tio
    save_bf16_mlp(str(tmp_path))
    x = _x(3)
    jexe, jscope = jpt.Executor(), jpt.Scope()
    jprog, feeds, fetches = jio.load_inference_model(str(tmp_path), jexe,
                                                     scope=jscope)
    want, = jexe.run(jprog, feed={"x": x}, fetch_list=fetches, scope=jscope)
    exe, scope = tpt.Executor(), tpt.Scope()
    prog, feeds, fetches = tio.load_inference_model(str(tmp_path), exe,
                                                    scope=scope)
    got, = exe.run(prog, feed={"x": x}, fetch_list=fetches, scope=scope)
    _same_bf16(got, want)
    prog2 = tpt.Program()
    blk = prog2.global_block()
    blk.create_var("h", shape=(2,), dtype="bfloat16", is_data=True)
    blk.create_var("o")
    blk.append_op("scale", {"X": ["h"]}, {"Out": ["o"]}, {"scale": 2.0})
    h = np.asarray(want[:1, :2]).reshape(2)
    out, = exe.run(prog2, feed={"h": h}, fetch_list=["o"], scope=tpt.Scope())
    assert out.dtype == h.dtype
    np.testing.assert_array_equal(out.astype(np.float32),
                                  2 * h.astype(np.float32))
