"""The eager tensor, ``paddle.grad``, ``Layer``'s reference members and
the fluid.dygraph 1.x surface of the port, against the JAX dygraph.

F1's script first: ``to_variable``, ``stop_gradient = False``, a
``Linear`` (the port's weights copied from the JAX layer's) and
``backward()``; the port's ``x.gradient()`` must equal the reference's
(before the repair it was None). Then the rest of the ``VarBase``
contract side by side: gradients add up across ``backward()`` calls
until ``clear_gradient()``; ``stop_gradient = True`` on a tensor an op
made cuts the gradient for the ops that read it afterwards;
``paddle.grad``'s rules (a single output, first order, no ``.grad``
touched, an unused input raises unless ``allow_unused``);
``astype`` / ``cast`` / ``set_value`` / ``numpy()``. fp32 on the CPU:
values at rtol 1e-6 / atol 1e-6 (the same few products in both
libraries). Also F3 (``seed`` sets the default programs' seeds),
``Layer``'s members, and ``save_dygraph`` / ``load_dygraph`` and
``save`` / ``load`` of a small layer in both packages.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import dygraph as jdy
from paddle_tpu import nn as jnn

import paddle_tpu_torch as tpt
from paddle_tpu_torch import dygraph as tdy
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core.enforce import InvalidArgumentError

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")


def _linears(seed=0):
    """A JAX Linear(3, 2) and a port Linear(3, 2) with its weights."""
    jpt.seed(seed)
    jl = jnn.Linear(3, 2)
    tl = tnn.Linear(3, 2)
    tl.weight.set_value(jl.weight.numpy())
    tl.bias.set_value(jl.bias.numpy())
    return jl, tl


def test_f1_stop_gradient_false_makes_a_leaf_that_gathers_gradient():
    jl, tl = _linears()
    with jdy.guard():
        xr = jdy.to_variable(np.ones((2, 3), "f4"))
        xr.stop_gradient = False
        jl(xr).sum().backward()
    x = tdy.to_variable(np.ones((2, 3), "f4"))
    assert x.stop_gradient and x.gradient() is None
    x.stop_gradient = False
    assert not x.stop_gradient and x.requires_grad
    tl(x).sum().backward()
    assert x.gradient() is not None
    np.testing.assert_allclose(x.gradient(), xr.gradient(), **TOL)
    assert isinstance(x.grad, torch.Tensor)
    np.testing.assert_allclose(tl.weight.gradient(), jl.weight.gradient(),
                               **TOL)


def _accumulate_and_cut(dy, lin, tensor_cls_numpy):
    """Two backwards accumulate, then a cut: z reads y before y stops
    gradients, w after."""
    x = dy.to_variable(np.arange(6, dtype="f4").reshape(2, 3) / 5)
    x.stop_gradient = False
    lin(x).sum().backward()
    first = x.gradient().copy()
    y = lin(x)
    z = y * 2
    y.stop_gradient = True
    w = y * 3
    (z.sum() + w.sum()).backward()
    second = x.gradient().copy()
    x.clear_gradient()
    cleared = x.gradient()
    return first, second, cleared


def test_gradients_accumulate_and_stop_gradient_cuts_later_reads():
    jl, tl = _linears(1)
    with jdy.guard():
        want = _accumulate_and_cut(jdy, jl, None)
    got = _accumulate_and_cut(tdy, tl, None)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1], want[1], **TOL)
    np.testing.assert_allclose(got[1], 3 * got[0], **TOL)
    assert got[2] is None and want[2] is None


def _grad_rules(pkg, dy, lin):
    x = dy.to_variable(np.linspace(-1, 1, 6, dtype="f4").reshape(2, 3))
    x.stop_gradient = False
    u = dy.to_variable(np.ones((2, 3), "f4"))
    u.stop_gradient = False
    loss = (lin(x) * lin(x)).sum()
    (gx,) = pkg.grad(loss, [x], retain_graph=True)
    touched = x.gradient()
    with pytest.raises(Exception, match="unused"):
        pkg.grad(loss, [x, u], retain_graph=True)
    gx2, gu = pkg.grad(loss, [x, u], allow_unused=True, create_graph=True)
    loss.backward()
    return gx.numpy(), touched, gx2.numpy(), gu, x.gradient()


def test_paddle_grad_rules_match_the_reference():
    """Returned and detached, no ``.grad`` touched, an unused input raises
    unless ``allow_unused`` (None then), ``create_graph`` keeps the graph
    (the reference builds no graph of the gradients either)."""
    jl, tl = _linears(2)
    import paddle
    with jdy.guard():
        want = _grad_rules(paddle.framework, jdy, jl)
    got = _grad_rules(tpt, tdy, tl)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    assert got[1] is None and want[1] is None
    np.testing.assert_allclose(got[2], want[2], **TOL)
    assert got[3] is None and want[3] is None
    np.testing.assert_allclose(got[4], want[4], **TOL)
    x = torch.ones(2, requires_grad=True)
    (g,) = tpt.grad((x * x).sum(), [x])
    assert not g.requires_grad and x.grad is None
    with pytest.raises(InvalidArgumentError, match="single output"):
        tpt.grad([x.sum(), x.sum()], [x])
    with pytest.raises(InvalidArgumentError, match="does not require grad"):
        tpt.grad(torch.ones(2).sum(), [x])


def test_tensor_members():
    t = tdy.to_variable(np.array([[1.5, -2.25]], "f4"))
    assert t.astype("float64").dtype == torch.float64
    assert t.cast("int32").dtype == torch.int32
    assert t.astype(tpt.bfloat16).numpy().dtype.name == "bfloat16"
    np.testing.assert_array_equal(
        t.astype("bfloat16").numpy().astype(np.float32), t.numpy())
    t.set_value(np.array([[3.0, 4.0]], "f4"))
    np.testing.assert_array_equal(t.numpy(), [[3.0, 4.0]])
    t.set_value(np.arange(3, dtype="f8"))      # the value's own shape, dtype
    assert t.shape == (3,) and t.dtype == torch.float64
    leaf = torch.ones(3, requires_grad=True)
    np.testing.assert_array_equal(leaf.numpy(), np.ones(3))   # torch raises
    assert not t.persistable
    t.persistable = True
    assert t.persistable
    i = torch.arange(3)
    i.stop_gradient = False                   # no gradient for integers
    assert i.stop_gradient
    view = (leaf * 2)[:2]
    with pytest.raises(InvalidArgumentError, match="detach"):
        view.stop_gradient = True
    shared = torch.ones(2)
    assert shared.numpy().base is not None    # torch's own array: shared


def test_parameter_members():
    lin = tnn.Linear(3, 2)
    p = lin.weight
    assert isinstance(p, tdy.Parameter) and isinstance(p, torch.nn.Parameter)
    assert p.persistable and p.trainable and not p.stop_gradient
    assert p.name.startswith("linear") and p.optimize_attr == {
        "learning_rate": 1.0} and p.regularizer is None
    p.trainable = False
    assert p.stop_gradient
    out = lin(torch.ones(1, 3)).sum()
    out.backward()
    assert p.grad is None and lin.bias.grad is not None


class _Net(tdy.Layer):
    def __init__(self):
        super().__init__()
        self.a = tnn.Linear(3, 4)
        self.b = tdy.Sequential(tnn.Linear(4, 4), tnn.Linear(4, 2))

    def forward(self, x):
        return self.b(self.a(x))


class _JaxNet(jdy.Layer):
    def __init__(self):
        super().__init__()
        self.a = jnn.Linear(3, 4)
        self.b = jdy.Sequential(jnn.Linear(4, 4), jnn.Linear(4, 2))

    def forward(self, x):
        return self.b(self.a(x))


def test_layer_members_follow_the_reference():
    net, jnet = _Net(), _JaxNet()
    assert [n for n, _ in net.named_sublayers(include_self=True)] == \
        [n for n, _ in jnet.named_sublayers(include_self=True)]
    seen, jseen = [], []
    net.apply(lambda m: seen.append(type(m).__name__))
    jnet.apply(lambda m: jseen.append(type(m).__name__))
    assert seen == [n.replace("_JaxNet", "_Net") for n in jseen]
    assert isinstance(net.parameters(), list) and len(net.parameters()) == 6
    assert net.full_name() == "_net" or net.full_name().startswith("_net_")
    calls = []

    def pre(layer, args):
        calls.append("pre")
        return (args[0] * 2,)

    def post(layer, args, out):
        calls.append("post")
        return out + 1

    net.register_forward_pre_hook(pre)
    net.register_forward_post_hook(post)
    x = torch.ones(1, 3)
    with torch.no_grad():
        want = net.b(net.a(x * 2)) + 1
        np.testing.assert_allclose(net(x).numpy(), want.numpy(), **TOL)
    assert calls == ["pre", "post"]
    net(x).sum().backward()
    assert all(p.grad is not None for p in net.parameters())
    net.clear_gradients()
    assert all(p.grad is None for p in net.parameters())
    ids = [id(p) for p in net.parameters()]
    assert net.to(dtype="float64") is net
    assert all(p.dtype == torch.float64 for p in net.parameters())
    assert [id(p) for p in net.parameters()] == ids


def test_f3_seed_sets_the_default_programs_seeds():
    for pkg in (jpt, tpt):
        pkg.seed(1234)
        assert pkg.default_main_program().random_seed == 1234
        assert pkg.default_startup_program().random_seed == 1234
    a = tpt.uniform([4])
    tpt.seed(1234)
    b = tpt.uniform([4])
    tpt.seed(0)
    assert torch.equal(a, b)


def test_mode_and_parallel_surface():
    with tdy.guard():
        assert tdy.enabled()
    tdy.disable_dygraph()
    assert not tdy.enabled()
    tdy.enable_dygraph()
    assert tdy.enabled()
    env = tdy.prepare_context()
    assert (env.rank, env.nranks, env.local_rank) == (0, 1, 0)
    tdy.set_code_level(50)
    tdy.set_verbosity(1)
    cfg = tdy.SaveLoadConfig()
    assert cfg.model_filename is None and not cfg.separate_params
    tdy.start_gperf_profiler()
    from paddle_tpu_torch.observability import tracer
    assert tracer.enabled()
    tdy.stop_gperf_profiler()
    assert not tracer.enabled()


def test_save_and_load_dygraph_across_the_packages(tmp_path):
    """Each package's ``save_dygraph`` state loads into the other's
    layer: the files are the same npz layout."""
    jl, tl = _linears(3)
    jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "port")
    jdy.save_dygraph(jl.state_dict(), jpath)
    tdy.save_dygraph(tl.state_dict(), tpath)
    for path in (jpath, tpath):
        state, opt = tdy.load_dygraph(path)
        jstate, jopt = jdy.load_dygraph(path)
        assert opt is None and jopt is None
        fresh = tnn.Linear(3, 2)
        assert fresh.set_state_dict(state) == []
        for n, v in fresh.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jstate[n]))


class SavedNet(tdy.Layer):
    def __init__(self):
        super().__init__()
        self.fc = tnn.Linear(3, 2)

    def forward(self, x):
        return self.fc(x)


class JaxSavedNet(jdy.Layer):
    def __init__(self):
        super().__init__()
        self.fc = jnn.Linear(3, 2)

    def forward(self, x):
        return self.fc(x)


def test_save_and_load_a_layer_in_both_packages(tmp_path):
    x = np.random.RandomState(0).randn(4, 3).astype("f4")
    for dy, cls, out_of in ((jdy, JaxSavedNet, lambda o: o.numpy()),
                            (tdy, SavedNet, lambda o: o.detach().numpy())):
        layer = cls()
        path = str(tmp_path / cls.__name__)
        dy.save(layer, path, input_spec=[x])
        assert sorted(os.listdir(path)) == [
            "__layer__.pkl", "__meta__.json", "params.pdparams.npz"]
        back = dy.load(path)
        assert type(back) is cls
        np.testing.assert_array_equal(out_of(back(dy.to_variable(x))),
                                      out_of(layer(dy.to_variable(x))))
    with pytest.raises(InvalidArgumentError, match="input_spec"):
        tdy.save(SavedNet(), str(tmp_path / "x"))


def test_translated_layer_runs_a_saved_inference_model(tmp_path):
    """``load`` of a ``save_inference_model`` directory (saved by the JAX
    package) is a ``TranslatedLayer`` that answers as the JAX one does."""
    from test_torch_inference import JAX_API, save_mlp
    w, b = save_mlp(JAX_API, str(tmp_path / "mlp"))
    x = np.random.RandomState(1).randn(5, 4).astype("f4")
    layer = tdy.load(str(tmp_path / "mlp"))
    assert isinstance(layer, tdy.TranslatedLayer)
    want = jdy.load(str(tmp_path / "mlp"))(x).numpy()
    np.testing.assert_allclose(layer(x).numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(want, np.maximum(x @ w + b, 0), rtol=1e-5,
                               atol=1e-6)
