"""The 27 op types of the decoding slice, against the JAX package's ops:
the registry test of the slice, and here the 6 of ``ops/decode_ops.py``
(the 11 of ``fusion_ops`` / ``parity_ops`` / ``misc_ops`` in
``test_torch_fusion_ops.py``, the 10 of ``long_tail_ops`` in
``test_torch_long_tail_ops.py``), with ``nn.CTCLoss`` /
``nn.functional.ctc_loss`` and the decode builders.

Each case of ``paddle_tpu_torch/testing/decode_cases.py`` runs one op
through ``OpInfoMap`` in both packages on the same numpy inputs: the
forward outputs (integer outputs equal, float within the case's bound),
then the gradients for the same seeded cotangents, ``generic_vjp_grad``
on each side. ``warpctc``'s forward algorithm runs in float64 in the
JAX package under the tests' x64 mode (its floor constant is a Python
float), so its loss and the cotangent fed to its VJP are held in the
port's float32, at rtol 1e-4 / atol 2e-5 (sums of T products in log
space). An infeasible label's loss is the reference's floor, 1e30; its
gradient is 0 in the port, where the reference's AD runs along the
floor's paths (a gradient of no likelihood): the feasible rows'
gradients are held against the reference. The true-LoD ``beam_search``
step and ``beam_search_decode`` over tensor arrays run under each
package's LoD side channel: ids, LoD and scores (fp32 rtol 1e-6) equal.
The book's beam decode (``decode_cases.mt_decode_program``) is built by
both packages' builders into the same JSON and run by both executors
from the same weights: the sentences and their LoD equal, the scores at
rtol 1e-5.
"""
import collections
import importlib
import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.static as jstatic
from paddle_tpu import nn as jnn
from paddle_tpu.core import lodctx as jax_lodctx
from paddle_tpu.core import program as jax_program
from paddle_tpu.core.registry import OpInfoMap as JaxOpInfoMap
from paddle_tpu.core.registry import generic_vjp_grad as jax_vjp_grad
from paddle_tpu.nn import ParamAttr as JaxParamAttr
from paddle_tpu.ops.array_ops import LoDTensorArrayValue as JaxArray

import chip_smoke
import paddle_tpu_torch as tpt
from paddle_tpu_torch import nn
from paddle_tpu_torch.core.registry import OpInfoMap, generic_vjp_grad
from paddle_tpu_torch.device import op_device
from paddle_tpu_torch.testing import decode_cases as dc
from paddle_tpu_torch.testing.rcnn_cases import RCNN_TYPES
from test_torch_parity_ops import cf_check_forward
from test_torch_program import _first_difference
from test_torch_tensor_ops import _jax_in, _port_in, assert_same, ref_module

PORTED_BEFORE = 407
MODULES = ("paddle_tpu.ops.decode_ops",)
CASES = [c for c in dc.DECODE_CASES if ref_module(c.op) in MODULES]
VALUE = [c for c in CASES if c.kind == "value" and c.op != "warpctc"]
CTC = [c for c in CASES if c.op == "warpctc"]
JAX_API = chip_smoke.port_static_api().__class__(
    pt=jpt, static=jstatic, ParamAttr=JaxParamAttr)


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")


def test_registry_holds_the_slice_against_the_reference():
    """The port registers 407 + 27 = 434 types before the two-stage
    detection slice's, none that the reference lacks; the 27 are the cases' types, in the slice's counts by
    reference module (decode_ops, fusion_ops and long_tail_ops whole,
    the last type of parity_ops and of misc_ops), with the reference's
    intermediate outputs and non-differentiable inputs; no compute among
    them reaches ``pallas_call``."""
    for mod in ("ops", "vision", "text", "static", "inference", "serving"):
        importlib.import_module("paddle_tpu." + mod)
        importlib.import_module("paddle_tpu_torch." + mod)
    jops, pops = JaxOpInfoMap.instance()._ops, OpInfoMap.instance()._ops
    assert not set(pops) - set(jops)
    assert len(dc.DECODE_TYPES) == 27 and \
        len(set(pops) - RCNN_TYPES) == PORTED_BEFORE + 27 == 434
    assert dc.DECODE_TYPES <= set(pops)
    assert collections.Counter(ref_module(t) for t in dc.DECODE_TYPES) \
        == dc.SLICE
    for mod in dc.SLICE:
        whole = {t for t, d in jops.items() if d.compute.__module__ == mod}
        assert whole <= set(pops), (mod, sorted(whole - set(pops)))
    for t in dc.DECODE_TYPES:
        jdef, pdef = jops[t], pops[t]
        assert pdef.intermediate_outputs == jdef.intermediate_outputs, t
        assert set(pdef.non_differentiable_inputs) == \
            set(jdef.non_differentiable_inputs), t
        src = inspect.getsource(inspect.getmodule(jdef.compute))
        assert not re.search(r"pallas", src), t


@pytest.mark.parametrize("case", VALUE, ids=[c.id for c in VALUE])
def test_forward_matches_jax(case, tmp_path):
    cf_check_forward(case, tmp_path)


def _ctc_both(case):
    jdef = JaxOpInfoMap.instance().get("warpctc")
    pdef = OpInfoMap.instance().get("warpctc")
    jin, pin = _jax_in(case.inputs), _port_in(case.inputs)
    want = jdef.compute(jin, dict(case.attrs))["Loss"][0]
    with op_device("cpu"):
        got = pdef.compute(pin, dict(case.attrs))["Loss"][0]
    return jdef, pdef, jin, want, got


@pytest.mark.parametrize("case", CTC, ids=[c.id for c in CTC])
def test_warpctc_loss_matches_jax(case):
    _, _, _, want, got = _ctc_both(case)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert_same(got, np.asarray(want, np.float32), case.tol, case.id)
    if case.id == "warpctc_infeasible":
        assert float(np.asarray(want)[0, 0]) == pytest.approx(1e30)
        assert got[0, 0].item() == pytest.approx(1e30)
        assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("case", CTC, ids=[c.id for c in CTC])
def test_warpctc_gradient_matches_jax(case):
    """Logits@GRAD for seeded cotangents on the loss against JAX's AD
    through its scan; the infeasible row's gradient is 0 in the port."""
    jdef, pdef, jin, want_out, _ = _ctc_both(case)
    ct = np.random.RandomState(99).randn(*want_out.shape).astype(np.float32)
    want = jax_vjp_grad(jdef, jin, {"Loss": [want_out]},
                        {"Loss": [jnp.asarray(ct, want_out.dtype)]},
                        dict(case.attrs))["Logits"][0]
    with op_device("cpu"):
        got = generic_vjp_grad(pdef, _port_in(case.inputs), {},
                               {"Loss": [torch.from_numpy(ct)]},
                               dict(case.attrs))["Logits"][0]
    want = np.asarray(want)
    if case.id == "warpctc_infeasible":
        assert not got[0].any()
        got, want = got[1:], want[1:]
    assert_same(got, want, case.grad_tol, f"d{case.id}/dLogits")


def test_warpctc_gradient_is_the_logits_gradient():
    """The gradient of the mean loss against finite differences of the
    port's own loss in float64: torch's CTC backward is right only fed
    straight from log_softmax, which the op keeps."""
    case = CTC[0]
    ins = _port_in(case.inputs)
    logits = ins["Logits"][0].double().requires_grad_()
    op = OpInfoMap.instance().get("warpctc").compute

    def loss(lg):
        return op(dict(ins, Logits=[lg]), dict(case.attrs))["Loss"][0].sum()

    with op_device("cpu"):
        assert torch.autograd.gradcheck(loss, (logits,), eps=1e-6,
                                        atol=1e-5)


def test_ctc_loss_and_layer_match_jax():
    """``nn.functional.ctc_loss`` and ``nn.CTCLoss`` (blank 0, ``mean``:
    a plain mean of the [B, 1] losses, the reference's ``_reduce_loss``;
    ``sum``; ``none``) from the same logits and labels: the loss, and
    the logits' gradient of the mean."""
    case = CTC[0]
    x, lab = case.inputs["Logits"][0], case.inputs["Label"][0]
    il, ll = case.inputs["LogitsLength"][0], case.inputs["LabelLength"][0]
    for red in ("mean", "sum", "none"):
        jx = jpt.to_tensor(x, stop_gradient=False)
        jl = jnn.functional.ctc_loss(jx, jpt.to_tensor(lab),
                                     jpt.to_tensor(il), jpt.to_tensor(ll),
                                     reduction=red)
        tx = torch.from_numpy(x.copy()).requires_grad_()
        tl = nn.CTCLoss(blank=0, reduction=red)(
            tx, torch.from_numpy(lab), torch.from_numpy(il),
            torch.from_numpy(ll))
        tf = nn.functional.ctc_loss(tx, torch.from_numpy(lab),
                                    torch.from_numpy(il),
                                    torch.from_numpy(ll), reduction=red)
        want = np.asarray(jl.numpy(), np.float32)
        for got in (tl, tf):
            np.testing.assert_allclose(got.detach().numpy(), want,
                                       rtol=1e-4, atol=2e-5)
        if red == "mean":
            jl.backward()
            tl.backward()
            np.testing.assert_allclose(tx.grad.numpy(),
                                       np.asarray(jx.gradient(), np.float32),
                                       rtol=1e-4, atol=2e-5)


def _jax_lod_step():
    """:data:`LOD_STEP` through the JAX op under its LoD side channel:
    (ids, scores, the output LoD)."""
    lod = dc.LOD_STEP["lod"]
    with jax_lodctx.lod_scope({"pi": lod, "ps": lod}), jax_lodctx.op_scope(
            dc.lod_step_op(jax_program)):
        out = JaxOpInfoMap.instance().get("beam_search").compute(
            _jax_in(dc.LOD_STEP["inputs"]), dict(dc.LOD_STEP["attrs"]))
        return (np.asarray(out["selected_ids"][0]),
                np.asarray(out["selected_scores"][0]),
                jax_lodctx.get_lod("si"))


def test_beam_search_lod_route_matches_jax():
    """A finished parent gives its one frozen item, a live one its
    continuations; each source keeps its top beam_size (ties in the
    order the candidates come), grouped by parent row in the output
    LoD."""
    want, got = _jax_lod_step(), chip_smoke.lod_beam_step("cpu")
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=1e-6)
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[0].numpy().ravel(), [11, 9, 13, 14])
    assert got[2] == [[0, 2, 4], [0, 1, 2, 4, 4]]


def test_beam_search_decode_array_route_matches_jax():
    """``beam_search_decode`` over tensor arrays of (value, LoD) entries:
    each source's sentences backtraced through the level-1 LoD, the
    start token left out, with the 2-level output LoD."""
    ids, scores = dc.lod_arrays()
    op = jax_program.OpDesc(
        "beam_search_decode", {"Ids": ["ia"], "Scores": ["sa"]},
        {"SentenceIds": ["so"], "SentenceScores": ["sc"]},
        {"beam_size": 2, "end_id": 9})
    with jax_lodctx.lod_scope({}), jax_lodctx.op_scope(op):
        out = JaxOpInfoMap.instance().get("beam_search_decode").compute(
            {"Ids": [JaxArray((jnp.asarray(v), lod) for v, lod in ids)],
             "Scores": [JaxArray((jnp.asarray(v), lod)
                                 for v, lod in scores)]}, dict(op.attrs))
        want = (np.asarray(out["SentenceIds"][0]),
                np.asarray(out["SentenceScores"][0]),
                jax_lodctx.get_lod("so"))
    got = chip_smoke.lod_backtrace("cpu")
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=1e-6)
    assert got[2] == want[2]
    assert got[2][0][-1] == 4        # 2 sentences a source


def test_mt_beam_decode_program_matches_jax():
    """The book's beam decode over LoD tensor arrays (While, top_k,
    beam_search on the LoD route, array_write, is_empty, then
    beam_search_decode): the same JSON from both packages' builders, and
    the same sentences, LoD and scores from both executors."""
    jmain, jstart, want = dc.mt_decode_run(JAX_API, jpt.Executor(),
                                           jpt.TpuTensor)
    papi = chip_smoke.port_static_api()
    pmain, pstart, got = dc.mt_decode_run(
        papi, papi.pt.Executor("cpu"),
        lambda v, lod: papi.pt.TpuTensor(v, lod, device="cpu"))
    for jprog, pprog in ((jmain, pmain), (jstart, pstart)):
        assert pprog.to_json() == jprog.to_json(), _first_difference(
            pprog.to_json(), jprog.to_json())
    types_ = {o.type for b in pmain.blocks for o in b.ops}
    assert {"while_loop", "beam_search", "beam_search_decode", "is_empty",
            "top_k_v2", "sequence_expand", "lod_reset"} <= types_
    (gi, gl), (gs, _) = got
    (wi, wl), (ws, _) = want
    np.testing.assert_array_equal(gi, wi)
    assert [list(v) for v in gl] == [list(v) for v in wl]
    np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-6)
    assert len(gl[0]) == dc.MT["n_src"] + 1 and gi.size > 0


def test_decode_builders_write_the_jax_json():
    """``crf_decoding`` reusing the CRF's transition by name,
    ``beam_search`` with candidate ids and ``beam_search_decode`` on the
    dense route, and the table builders ``warpctc``, ``edit_distance``
    and ``ctc_greedy_decoder`` (which the port now runs): the same
    program op for op in both packages."""
    def build(api):
        st, nnb = api.static, api.static.nn
        main, startup = api.pt.Program(), api.pt.Program()
        with st.program_guard(main, startup):
            em = st.data("em", [3, 5, 4], "float32")
            lab = st.data("lab", [3, 5], "int64")
            nnb.linear_chain_crf(em, lab, param_attr=api.ParamAttr(
                name="crfw"))
            path = nnb.crf_decoding(em, param_attr=api.ParamAttr(
                name="crfw"))
            nnb.crf_decoding(em, label=lab, transition=main.global_block()
                             .var("crfw"))
            pre_ids = st.data("pre_ids", [4, 1], "int64")
            pre_sc = st.data("pre_sc", [4, 1], "float32")
            ids = st.data("ids", [4, 3], "int64")
            sc = st.data("sc", [4, 3], "float32")
            sid, ssc, par = nnb.beam_search(pre_ids, pre_sc, ids, sc, 2,
                                            end_id=0,
                                            return_parent_idx=True)
            steps = st.data("steps", [3, 2, 2], "int64")
            nnb.beam_search_decode(steps, st.data("ssc", [3, 2, 2],
                                                  "float32"), 2, 0)
            logits = st.data("logits", [3, 6, 5], "float32")
            nnb.warpctc(logits, lab)
            nnb.edit_distance(path, lab)
            nnb.ctc_greedy_decoder(path)
        return main, startup

    (jmain, jstart), (pmain, pstart) = build(JAX_API), build(
        chip_smoke.port_static_api())
    for jprog, pprog in ((jmain, pmain), (jstart, pstart)):
        assert pprog.to_json() == jprog.to_json(), _first_difference(
            pprog.to_json(), jprog.to_json())
    assert [o.type for o in pmain.global_block().ops].count(
        "crf_decoding") == 2


def test_decode_table_builders_run():
    """The table builders ``warpctc``, ``edit_distance`` and
    ``ctc_greedy_decoder`` run in the port's executor as in the JAX
    package's (the reference's builders pass no lengths, and
    ``ctc_greedy_decoder`` hands its input to ``ctc_align`` as ids, with
    no top-k first): the same fetches."""
    rs = np.random.RandomState(3)
    feed = {"logits": rs.randn(2, 6, 5).astype(np.float32),
            "lab": np.asarray([[1, 2], [3, 3]], np.int64),
            "hyp": rs.randint(0, 5, (2, 6)).astype(np.int64)}

    def run(api, exe):
        st, nnb = api.static, api.static.nn
        main, startup = api.pt.Program(), api.pt.Program()
        with st.program_guard(main, startup):
            logits = st.data("logits", [2, 6, 5], "float32")
            lab = st.data("lab", [2, 2], "int64")
            hyp = st.data("hyp", [2, 6], "int64")
            loss = nnb.warpctc(logits, lab)
            dist, num = nnb.edit_distance(hyp, lab)
            out, out_len = nnb.ctc_greedy_decoder(hyp)
        scope = api.pt.Scope()
        with api.pt.scope_guard(scope):
            return [np.asarray(v) for v in exe.run(
                main, feed=feed, fetch_list=[loss, dist, num, out, out_len],
                scope=scope)]

    want = run(JAX_API, jpt.Executor())
    got = run(chip_smoke.port_static_api(), tpt.Executor("cpu"))
    np.testing.assert_allclose(got[0], want[0].astype(np.float32),
                               rtol=1e-4, atol=2e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
