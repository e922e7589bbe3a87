"""Static builders whose ops this slice brought to the port: a program
of ``nll_loss``, ``sigmoid_focal_loss``, ``smooth_l1``,
``sigmoid_cross_entropy_with_logits``, ``minus``, ``label_smooth``,
``log_softmax``, ``image_resize``, ``resize_nearest``,
``resize_bicubic``, ``affine_grid``, ``grid_sampler``,
``affine_channel`` and ``pixel_shuffle`` (before this slice the port
built them and failed at run time), with its backward, built by the JAX
package, written to JSON and its startup values to an npz, then run by
both executors from that JSON and npz on the same feed: every output
and every parameter's gradient within fp32 rounding (rtol 1e-5 / atol
1e-6; the gradients, sums over the resize and sampling taps, at rtol
1e-4 / atol 1e-5). The port's own builders write the same JSON.
"""
import types

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu.static as jstatic
from paddle_tpu import io as jio
from paddle_tpu.nn import ParamAttr as JaxParamAttr
from paddle_tpu.nn.initializer import Uniform as JaxUniform
from paddle_tpu.optimizer import Momentum as JaxMomentum

import chip_smoke
import paddle_tpu_torch as tpt
from paddle_tpu_torch.core.program import Program

JAX_API = types.SimpleNamespace(pt=jpt, static=jstatic, io=jio,
                                ParamAttr=JaxParamAttr, Uniform=JaxUniform,
                                Momentum=JaxMomentum)


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")


def _program(api):
    static, nn = api.static, api.static.nn
    prog, startup = api.pt.Program(), api.pt.Program()
    with static.program_guard(prog, startup):
        img = static.data("img", [2, 4, 5, 5], "float32")
        theta = static.data("theta", [2, 2, 3], "float32")
        x = static.data("x", [6, 3], "float32")
        y = static.data("y", [6, 3], "float32")
        cls = static.data("cls", [6, 1], "int32")
        lab = static.data("lab", [6], "int64")
        fg = static.data("fg", [1], "int32")
        scale = static.create_parameter([4], "float32", name="ac_scale")
        bias = static.create_parameter([4], "float32", name="ac_bias")
        ac = nn.affine_channel(img, scale, bias)
        up = nn.image_resize(ac, out_h=7, out_w=8)
        near = nn.resize_nearest(ac, out_h=9, out_w=3)
        cubic = nn.resize_bicubic(ac, out_h=6, out_w=6)
        grid = nn.affine_grid(theta, output_shape=[2, 4, 3, 3])
        sampled = nn.grid_sampler(up, grid)
        shuffled = nn.pixel_shuffle(ac, upscale_factor=2)
        logits = nn.fc(x, size=3)
        nll = nn.nll_loss(nn.log_softmax(logits), lab)
        focal = nn.sigmoid_focal_loss(logits, cls, fg)
        sm = nn.smooth_l1(logits, y)
        sce = nn.sigmoid_cross_entropy_with_logits(logits, y)
        diff = nn.minus(logits, y)
        smooth = nn.label_smooth(nn.softmax(logits), epsilon=0.1)
        parts = [nn.reduce_sum(v) for v in (up, near, cubic, sampled,
                                            shuffled, focal, sm, sce,
                                            diff, smooth)]
        loss = nn.sum(parts + [nll])
    outs = [up, near, cubic, grid, sampled, shuffled, logits, nll, focal, sm,
            sce, diff, smooth, loss]
    return prog, startup, loss, [v.name for v in outs]


def _feed():
    rs = np.random.RandomState(0)
    return {"img": rs.randn(2, 4, 5, 5).astype(np.float32),
            "theta": rs.randn(2, 2, 3).astype(np.float32) * 0.6,
            "x": rs.randn(6, 3).astype(np.float32),
            "y": rs.rand(6, 3).astype(np.float32),
            "cls": rs.randint(-1, 4, (6, 1)).astype(np.int32),
            "lab": rs.randint(0, 3, (6,)).astype(np.int64),
            "fg": np.array([4], np.int32)}


def test_builders_run_in_both_executors_from_one_json_and_npz(tmp_path):
    jmain, jstart, jloss, names = _program(JAX_API)
    grads = [n + "@GRAD" for n in sorted(jstart.global_block().vars)]
    jpt.append_backward(jloss)
    pmain, pstart, ploss, _ = _program(chip_smoke.port_static_api())
    tpt.append_backward(ploss)
    assert pmain.to_json() == jmain.to_json()
    jscope = jpt.Scope()
    with jpt.scope_guard(jscope):
        jpt.Executor().run(jstart, feed={}, fetch_list=[], scope=jscope)
    params = {n: np.asarray(jscope.find_var(n).get().value)
              for n in jstart.global_block().vars}
    path = tmp_path / "params.npz"
    np.savez(path, **params)
    (tmp_path / "main.json").write_text(jmain.to_json())
    want = jpt.Executor().run(jmain, feed=_feed(), fetch_list=names + grads,
                              scope=jscope)
    program = Program.from_json((tmp_path / "main.json").read_text())
    pscope = tpt.Scope()
    with np.load(path) as npz:
        for n in npz.files:
            pscope.var(n).set(tpt.TpuTensor(npz[n]))
    got = tpt.Executor().run(program, feed=_feed(),
                             fetch_list=names + grads, scope=pscope)
    assert len(grads) == 4
    for n, g, w in zip(names + grads, got, want):
        tol = (1e-4, 1e-5) if n.endswith("@GRAD") else (1e-5, 1e-6)
        np.testing.assert_allclose(g, np.asarray(w), rtol=tol[0],
                                   atol=tol[1], err_msg=n)


def test_state_of_the_new_ops_crosses_through_persistables(tmp_path):
    """The JAX package's builders that create state for this slice's ops
    (``data_norm``'s batch size, sum and square sum, ``spectral_norm``'s
    U and V, ``bilinear_tensor_product``'s weight) build a program whose
    persistables the JAX package saves; the port loads the program's
    JSON and the persistables by name and runs it as the JAX executor
    does (rtol 1e-5 / atol 1e-6)."""
    jmain, jstart = jpt.Program(), jpt.Program()
    with jstatic.program_guard(jmain, jstart):
        x = jstatic.data("x", [4, 3], "float32")
        y = jstatic.data("y", [4, 5], "float32")
        w = jstatic.create_parameter([6, 3, 2], "float32", name="sn_w")
        nn = jstatic.nn
        normed = nn.data_norm(x)
        sn = nn.spectral_norm(w, dim=1, power_iters=2)
        btp = nn.bilinear_tensor_product(normed, y, size=2)
    names = [normed.name, sn.name, btp.name]
    exe = jpt.Executor()
    jscope = jpt.Scope()
    with jpt.scope_guard(jscope):
        exe.run(jstart, feed={}, fetch_list=[], scope=jscope)
        jio.save_persistables(exe, str(tmp_path), jmain, scope=jscope)
    rs = np.random.RandomState(1)
    feed = {"x": rs.randn(4, 3).astype(np.float32),
            "y": rs.randn(4, 5).astype(np.float32)}
    want = exe.run(jmain, feed=feed, fetch_list=names, scope=jscope)
    program = Program.from_json(jmain.to_json())
    pexe, pscope = tpt.Executor("cpu"), tpt.Scope()
    tpt.io.load_persistables(pexe, str(tmp_path), program, scope=pscope)
    assert len(jstart.global_block().vars) == 8     # 3 + 2 + 2, and W
    got = pexe.run(program, feed=feed, fetch_list=names, scope=pscope)
    for n, g, w_ in zip(names, got, want):
        np.testing.assert_allclose(g, np.asarray(w_), rtol=1e-5, atol=1e-6,
                                   err_msg=n)
