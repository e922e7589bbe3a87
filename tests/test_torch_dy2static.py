"""dy2static, ``jit.to_static`` / ``TracedLayer`` and the 1.x names over
them, in the port against the JAX package on the CPU.

Every case of ``tests/test_dy2static.py``, the ``TracedLayer`` and
function cases of ``tests/test_jit_io_vision.py:59-76`` and the
TensorArray decode loop of ``tests/test_tensor_array.py:57-76``: the same
Python function (or layer, its weights carried by
``convert.load_state_dict``) converted by each package, on the same
inputs. The JAX package traces under ``jax.jit``; the port runs eagerly
with the reference's traced semantics for tensor conditions
(``paddle_tpu_torch/jit/dy2static.py``). Then the ``TypeError`` cases,
a name that only one branch assigns, and a tiny Transformer NMT
(``chip_smoke.nmt_model``: 2 + 2 layers, d_model 32, 4 heads, vocab 64,
batch 2, length 8) scored through ``to_static`` and decoded by
``chip_smoke.nmt_greedy_fn`` through ``declarative``, in both packages
(the JAX package's ``to_static`` traces the decode loop as a
``lax.while_loop``).

Tolerances: the simple cases are exact arithmetic, held at rtol 1e-6;
the layers' and the NMT's outputs at rtol 1e-4 / atol 2e-5 (fp32, the
two frameworks' matmuls and attention sum in other orders, as in
``test_torch_transformer.py``); the decoded ids equal and their summed
log-probabilities at rtol 1e-4 / atol 2e-5. On the port, the converted
runs against the unconverted ones: bit for bit.
"""
import types

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import dygraph as jdygraph
from paddle_tpu import jit as jjit
from paddle_tpu import nn as jnn
from paddle_tpu.jit.dy2static import ast_transform as jax_ast_transform
from paddle_tpu.nn import functional as JF
from paddle_tpu.tensor_array import TensorArray as JaxTensorArray

import chip_smoke as cs
import paddle_tpu_torch as tpt
from paddle_tpu_torch import dygraph, jit, nn
from paddle_tpu_torch.convert import load_state_dict
from paddle_tpu_torch.jit.dy2static import ast_transform
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.tensor_array import TensorArray

OUT_TOL = dict(rtol=1e-4, atol=2e-5)
NMT_CFG = dict(cs.NMT, vocab=64, d_model=32, heads=4, layers=2, ffn=64,
               batch=2, src_len=8, tgt_len=8, max_len=8)


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")


def _np(out):
    """A JAX VarBase or a port tensor as a numpy array."""
    if isinstance(out, torch.Tensor):
        return out.detach().numpy()
    return np.asarray(out._value if hasattr(out, "_value") else out)


_CONVERTED = {}


def both(fn, *inputs):
    """``fn`` through each package's ``to_static`` (converted once a
    module, so the JAX package compiles it once a shape) on each of the
    numpy ``inputs``: [(JAX, port) outputs as numpy arrays]."""
    if fn not in _CONVERTED:
        _CONVERTED[fn] = jjit.to_static(fn), jit.to_static(fn)
    jfn, pfn = _CONVERTED[fn]
    return [(_np(jfn(x)), _np(pfn(x))) for x in inputs]


# ------------------------------------------- tests/test_dy2static.py cases
def f_ifelse(x):
    if x.sum() > 0:
        y = x * 2.0
    else:
        y = x - 1.0
    return y


def f_elif(x):
    if x.sum() > 10.0:
        y = x + 100.0
    elif x.sum() > 0:
        y = x + 10.0
    else:
        y = x
    return y


def f_while(x):
    s = x.sum()
    n = x * 0.0
    while s < 10.0:
        s = s * 2.0
        n = n + 1.0
    return n


def f_logical(x):
    if (x.sum() > 0) and (x.max() < 5.0):
        y = x + 1.0
    else:
        y = x - 1.0
    return y


def f_nested(x):
    if x.sum() > 0:
        i = x.sum() * 0.0
        while i < 3.0:
            i = i + 1.0
        y = x + i
    else:
        y = x
    return y


def f_write_only(x):
    s = x.sum()
    flag = s * 0.0
    while s < 10.0:
        s = s * 2.0
        flag = s * 0.0 + 99.0
    return flag


def f_read_modify_write(x):
    y = x
    if x.sum() > 0:
        y = y + 1.0
    else:
        y = y - 1.0
    return y


def f_or_not(x):
    if (x.sum() < 0) or not (x.max() > 1.0):
        y = x * 3.0
    else:
        y = x
    return y


CASES = {
    "ifelse": (f_ifelse, [np.ones(3, np.float32), -np.ones(3, np.float32)],
               [2.0, -2.0]),
    "elif_chain": (f_elif, [np.full(4, v, np.float32)
                            for v in (5.0, 0.5, -1.0)], [105.0, 10.5, -1.0]),
    "while": (f_while, [np.full(2, 0.5, np.float32),
                        np.full(2, 6.0, np.float32)], [4.0, 0.0]),
    "logical_and": (f_logical, [np.ones(2, np.float32),
                                np.full(2, 9.0, np.float32)], [2.0, 8.0]),
    "nested_while_in_if": (f_nested, [np.ones(2, np.float32),
                                      -np.ones(2, np.float32)], [4.0, -1.0]),
    "write_only_loop_var": (f_write_only, [np.ones(2, np.float32)], [99.0]),
    "read_modify_write": (f_read_modify_write,
                          [np.ones(2, np.float32), -np.ones(2, np.float32)],
                          [2.0, -2.0]),
    "logical_or_not": (f_or_not, [np.ones(2, np.float32),
                                  np.full(2, 4.0, np.float32)], [3.0, 4.0]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_converted_control_flow_matches_jax(name):
    """Data-dependent if/elif/while/and/or/not: the same function through
    both packages' to_static, each input against the other package and
    the expected value (the second input takes the other branch or trip
    count than the first)."""
    fn, inputs, want = CASES[name]
    for (jout, pout), w in zip(both(fn, *inputs), want):
        np.testing.assert_allclose(pout, jout, rtol=1e-6)
        np.testing.assert_allclose(pout, w, rtol=1e-6)


def f_host_bool(x):
    if float(x.sum()) > 0:       # forces a Python bool
        return x * 2.0
    return x - 1.0


def test_host_bool_condition():
    """test_trace_only_would_be_wrong: under the JAX package's jit a
    Python bool of a tensor cannot be taken (concretization error); the
    port has no tracer, so the host bool is read and both branches give
    the eager answer."""
    with pytest.raises(Exception):
        jjit.to_static(f_host_bool)(np.ones(3, np.float32))
    sf = jit.to_static(f_host_bool)
    np.testing.assert_allclose(sf(np.ones(3, np.float32)).numpy(), 2.0)
    np.testing.assert_allclose(sf(-np.ones(3, np.float32)).numpy(), -2.0)


def f_flag(x, flag):
    if flag:                     # python bool: stays python
        y = x * 3.0
    else:
        y = x
    return y


def f_early_return(x, training):
    if training:
        return x * 2.0
    return x


def f_or_idiom(x, scale, items):
    scale = scale or 2.0
    if items:
        y = x * scale
    else:
        y = x
    return y


@pytest.mark.parametrize("fn,args,want", [
    (f_flag, (True,), 3.0), (f_flag, (False,), 1.0),
    (f_early_return, (True,), 2.0), (f_early_return, (False,), 1.0),
    (f_or_idiom, (None, [1]), 2.0), (f_or_idiom, (3.0, []), 1.0)],
    ids=["flag_true", "flag_false", "early_return_true",
         "early_return_false", "or_default", "empty_list"])
def test_python_conditions_keep_python_semantics(fn, args, want):
    """test_python_static_condition_untouched, test_early_return_left_alone
    and test_python_or_idioms_survive: ``ast_transform`` of a function
    whose conditions are Python values, called on a tensor, in both
    packages."""
    x = np.ones(2, np.float32)
    jout = _np(jax_ast_transform(fn)(jpt.to_tensor(x), *args))
    pout = _np(ast_transform(fn)(tpt.to_tensor(x), *args))
    np.testing.assert_allclose(pout, jout, rtol=1e-6)
    np.testing.assert_allclose(pout, want, rtol=1e-6)


def _gate(nn_):
    class Gate(nn_.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn_.Linear(4, 4)

        def forward(self, x):
            h = self.fc(x)
            if h.sum() > 0:
                out = h * 2.0
            else:
                out = h * -1.0
            return out
    return Gate()


def _carried(jlayer, port_layer):
    load_state_dict(port_layer, {k: np.asarray(v.numpy()) for k, v in
                                 jlayer.state_dict().items()})
    return port_layer


@pytest.fixture(scope="module")
def gates():
    """The Gate layer built by the JAX package from seed 0 and carried
    into the port's: (the JAX package's to_static of it, the port's
    layer and its to_static)."""
    tpt.set_device("cpu")
    jpt.seed(0)
    jlayer = _gate(jnn)
    layer = _carried(jlayer, _gate(nn))
    with torch.no_grad():
        plain = {s: layer(tpt.to_tensor(s * GATE_X)).numpy()
                 for s in (1.0, -1.0)}
    return jjit.to_static(jlayer), jit.to_static(layer), plain


GATE_X = np.random.RandomState(0).rand(2, 4).astype(np.float32)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_layer_forward_conversion(gates, sign):
    """test_layer_forward_conversion: a Layer whose forward branches on a
    tensor, through to_static (the converted forward bound to the
    instance), against the JAX package and against the layer's eager
    call before conversion; each sign of the input takes one branch."""
    jtraced, traced, plain = gates
    x = sign * GATE_X
    eager = plain[sign]
    jout = _np(jtraced(x))
    assert isinstance(traced, jit.TracedLayer)
    pout = _np(traced(x))
    np.testing.assert_allclose(pout, jout, **OUT_TOL)
    np.testing.assert_array_equal(pout, eager)


def test_traced_layer_inference():
    """tests/test_jit_io_vision.py: TracedLayer of a Linear against its
    eager call and the JAX TracedLayer; the layer's mode is restored and
    the output carries no gradient."""
    jpt.seed(0)
    jlayer = jnn.Linear(4, 2)
    layer = _carried(jlayer, nn.Linear(4, 2))
    layer.train()
    x = np.random.RandomState(1).rand(3, 4).astype(np.float32)
    out = jit.TracedLayer(layer)(x)
    assert layer.training and not out.requires_grad
    np.testing.assert_allclose(out.numpy(),
                               layer(tpt.to_tensor(x)).detach().numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(out.numpy(),
                               _np(jjit.TracedLayer(jlayer)(x)), **OUT_TOL)


def test_to_static_function():
    """tests/test_jit_io_vision.py: a decorated function."""
    def f(x):
        return F.relu(x) * 2.0

    def jf(x):
        return JF.relu(x) * 2.0

    x = np.asarray([-1.0, 2.0], np.float32)
    np.testing.assert_allclose(jit.to_static(f)(x).numpy(), [0.0, 4.0])
    np.testing.assert_allclose(_np(jjit.to_static(jf)(x)), [0.0, 4.0])


def _decode_loop(tensor_array):
    def decode(x):
        ta = tensor_array((2,), max_size=6)
        i = x.sum() * 0.0
        state = x
        while i < 4.0:
            state = state * 0.5
            ta = ta.write(i.astype("int32"), state)
            i = i + 1.0
        return ta.stack()
    return decode


def test_tensor_array_decode_loop():
    """tests/test_tensor_array.py::test_dy2static_decode_loop: a
    TensorArray written in a converted while loop."""
    x = np.ones(2, np.float32)
    jout = _np(jjit.to_static(_decode_loop(JaxTensorArray))(x))
    pout = _np(jit.to_static(_decode_loop(TensorArray))(x))
    np.testing.assert_allclose(pout, jout, rtol=1e-6)
    np.testing.assert_allclose(pout[0], 0.5, rtol=1e-6)
    np.testing.assert_allclose(pout[3], 0.0625, rtol=1e-6)
    np.testing.assert_allclose(pout[4:], 0.0)


# ------------------------------------------------------- the error cases
def f_shape_mismatch(x):
    if x.sum() > 0:
        y = x
    else:
        y = x.sum()
    return y


class _Box:
    pass


def f_rebinds_static(x):
    box = _Box()
    i = x.sum() * 0.0
    while i < 2.0:
        box = _Box()
        i = i + 1.0
    return i


@pytest.mark.parametrize("fn", [f_shape_mismatch, f_rebinds_static],
                         ids=["if_shapes", "while_rebinds_object"])
def test_type_errors_match_jax(fn):
    """Branches giving one name two shapes, and a while body rebinding a
    loop variable that is not a tensor or a number: TypeError in both
    packages."""
    x = np.ones(3, np.float32)
    with pytest.raises(TypeError):
        jjit.to_static(fn)(x)
    with pytest.raises(TypeError):
        jit.to_static(fn)(x)


def f_one_branch(x):
    if x.sum() > 0:
        z = x * 5.0
    return z


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_name_assigned_in_one_branch(sign):
    """A name only the true branch assigns: the defined side wins under a
    tensor condition, in both packages, whichever branch the value
    picks."""
    x = np.full(3, sign, np.float32)
    (jout, pout), = both(f_one_branch, x)
    np.testing.assert_allclose(pout, jout, rtol=1e-6)
    np.testing.assert_allclose(pout, x * 5.0, rtol=1e-6)


def test_numbers_come_out_as_tensors():
    """A number carried through a loop on a tensor condition comes out as
    the reference's lax.while_loop gives it: a 0-d integer tensor, equal
    to the JAX package's."""
    def f(x):
        k = 0
        s = x.sum()
        while s < 8.0:
            s = s * 2.0
            k = k + 1
        return k

    jout = _np(jjit.to_static(f)(np.ones(2, np.float32)))
    pout = jit.to_static(f)(np.ones(2, np.float32))
    assert isinstance(pout, torch.Tensor) and pout.shape == ()
    assert pout.dtype == torch.int32
    np.testing.assert_array_equal(pout.numpy(), jout)
    assert int(pout) == 2


def test_one_x_names_resolve_to_jit():
    """dygraph.TracedLayer, declarative and dygraph_to_static_func, in
    both packages, are jit's."""
    assert dygraph.TracedLayer is jit.TracedLayer
    assert jdygraph.TracedLayer is jjit.TracedLayer
    assert dygraph.dygraph_to_static_func is dygraph.declarative
    assert jdygraph.dygraph_to_static_func is jdygraph.declarative
    x = np.ones(3, np.float32)
    np.testing.assert_allclose(
        dygraph.declarative(f_ifelse)(x).numpy(),
        _np(jdygraph.declarative(f_ifelse)(x)))
    np.testing.assert_allclose(
        dygraph.declarative()(f_ifelse)(-x).numpy(), -2.0)


# ------------------------------------------------------------- tiny NMT
def _jax_nmt_api():
    return types.SimpleNamespace(
        nn=jnn, F=JF, jit=jjit, dygraph=jdygraph, TensorArray=JaxTensorArray,
        to_tensor=jpt.to_tensor, matmul=jpt.matmul, full=jpt.full,
        zeros=jpt.zeros, arange=jpt.arange, reshape=jpt.reshape,
        unsqueeze=jpt.unsqueeze, sum=jpt.sum, max=jpt.max,
        argmax=jpt.argmax, where=jpt.where, concat=jpt.concat,
        transpose=lambda x, perm: x.transpose(perm))


@pytest.fixture(scope="module")
def nmt():
    """The tiny NMT built by the JAX package from seed 0 and carried into
    the port's; seeded source and target ids; eos the id the model
    first picks for row 0, so that row stops at once and the if freezes
    it."""
    tpt.set_device("cpu")
    japi, papi = _jax_nmt_api(), cs.port_nmt_api()
    jpt.seed(0)
    jmodel = cs.nmt_model(japi, NMT_CFG)
    pmodel = _carried(jmodel, cs.nmt_model(papi, NMT_CFG))
    rs = np.random.RandomState(3)
    shape = (NMT_CFG["batch"], NMT_CFG["src_len"])
    src = rs.randint(3, NMT_CFG["vocab"], shape).astype(np.int64)
    tgt = rs.randint(3, NMT_CFG["vocab"], shape).astype(np.int64)
    pmodel.eval()
    jmodel.eval()
    probe = cs.nmt_greedy_fn(papi, pmodel, 1, NMT_CFG["bos"], -1)
    with torch.no_grad():
        eos = int(probe(tpt.to_tensor(src))[0, 0])
    return dict(japi=japi, papi=papi, jmodel=jmodel, pmodel=pmodel,
                src=src, tgt=tgt, eos=eos)


def test_nmt_scoring_matches_jax(nmt):
    """to_static(model) on teacher-forced pairs: the log-probabilities
    against the JAX package's to_static, and bit for bit against the
    port's eager forward under no_grad."""
    src, tgt = nmt["src"], nmt["tgt"]
    jout = _np(jjit.to_static(nmt["jmodel"])(src, tgt))
    pout = jit.to_static(nmt["pmodel"])(src, tgt)
    with torch.no_grad():
        eager = nmt["pmodel"](tpt.to_tensor(src), tpt.to_tensor(tgt))
    assert tuple(pout.shape) == (2, 8, 64)
    np.testing.assert_allclose(pout.numpy(), jout, **OUT_TOL)
    assert torch.equal(pout, eager)


def test_nmt_greedy_decode_matches_jax(nmt):
    """The greedy decoder through declarative in both packages (the JAX
    package traces its while into a lax.while_loop): ids equal and
    scores within OUT_TOL; on the port, the converted run equals the
    unconverted one bit for bit. Row 0 ends at its first step."""
    cfg = NMT_CFG
    jfn = cs.nmt_greedy_fn(nmt["japi"], nmt["jmodel"], cfg["max_len"],
                           cfg["bos"], nmt["eos"])
    pfn = cs.nmt_greedy_fn(nmt["papi"], nmt["pmodel"], cfg["max_len"],
                           cfg["bos"], nmt["eos"])
    jout = _np(jdygraph.declarative(jfn)(nmt["src"]))
    pout = dygraph.declarative(pfn)(nmt["src"])
    with torch.no_grad():
        eager = pfn(tpt.to_tensor(nmt["src"]))
    assert torch.equal(pout, eager)
    ids, score = pout.numpy()[:, :-1], pout.numpy()[:, -1]
    np.testing.assert_array_equal(ids, jout[:, :-1])
    np.testing.assert_allclose(score, jout[:, -1], **OUT_TOL)
    assert (ids[0] == nmt["eos"]).all() and (ids[1] != nmt["eos"]).all()
