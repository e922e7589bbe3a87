"""The exported artifact on the CPU: ``inference.export_stablehlo`` /
``load_exported`` (a ``torch.export`` archive in the port, a
``jax.export`` blob in the JAX package), serving's load path B, the
C-API run of an inference ``CompiledProgram``, and K1 as the
``paddle_tpu_torch::flash_fwd`` custom op.

Two models in the layout both packages share, saved by the JAX package:
an MLP (relu(x @ w + b), batch 4) and the ERNIE 1.0 forward at
``ERNIE_TINY`` widths with its next-sentence head (2 layers, hidden 64,
``flash_attention``; batch 2, seq 16), ``static_cases.ernie_program``.
Each is exported by both packages and run on the same feeds: outputs
within 1e-5 relative, and the two ``.meta.json`` sidecars equal,
``out_batch_major`` included. Load path B in the port's
``PredictorServer`` answers as load path A does on the directory; a
declared bucket other than the export's is refused at load. The C-API
list-feed run equals ``Executor.run`` in both packages, and the port's
the JAX package's within 1e-5. ``torch.library.opcheck`` passes on the
custom op. An op that reads a value on the host fails the port's export
naming its type.
"""
import hashlib
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import inference as jinference
from paddle_tpu.inference import capi as jcapi
from paddle_tpu.io import load_inference_model as jax_load
from paddle_tpu.io import save_inference_model as jax_save

import chip_smoke
import paddle_tpu_torch as tpt
from paddle_tpu_torch import inference
from paddle_tpu_torch.core.enforce import (InvalidArgumentError,
                                           UnimplementedError)
from paddle_tpu_torch.inference import capi
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.serving import PredictorServer
from paddle_tpu_torch.static import CompiledProgram
from paddle_tpu_torch.testing import static_cases as sc
from test_torch_serving import save_mlp
from test_torch_static_builders import (JAX_API, _cpu,  # noqa: F401
                                        startup_scopes)

RTOL = 1e-5
CFG = sc.ERNIE_TINY
ERNIE_FEEDS = ["src_ids", "pos_ids", "sent_ids"]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """{name: (directory, input specs, dtypes, feeds)}: the MLP and the
    ERNIE-tiny forward, saved by the JAX package."""
    root = tmp_path_factory.mktemp("saved")
    save_mlp(str(root / "mlp"), jax=True)
    built = sc.ernie_program(JAX_API, CFG, dropout=0, amp=False,
                             optimize=False)
    jscope, _ = startup_scopes(built.startup)
    with jpt.scope_guard(jscope):
        jax_save(str(root / "ernie"), ERNIE_FEEDS, [built.nsp_logits],
                 jpt.Executor(), built.main, scope=jscope)
    x = np.random.RandomState(0).randn(4, 4).astype(np.float32)
    ernie = chip_smoke.ernie_serve_feeds(CFG, 2, CFG["seq"], 0)
    return {"mlp": (str(root / "mlp"), {"x": (4, 4)}, None, {"x": x}),
            "ernie": (str(root / "ernie"),
                      {n: (2, CFG["seq"]) for n in ERNIE_FEEDS},
                      {n: "int64" for n in ERNIE_FEEDS}, ernie)}


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("name", ["mlp", "ernie"])
def test_export_matches_the_jax_package(saved, tmp_path, name):
    path, specs, dtypes, feeds = saved[name]
    jblob = str(tmp_path / "model.jaxexport")
    jinference.export_stablehlo(path, specs, jblob, dtypes)
    want = jinference.load_exported(jblob)(*feeds.values())
    pt2 = str(tmp_path / "model.pt2")
    blob = inference.export_stablehlo(path, specs, pt2, dtypes)
    with open(pt2, "rb") as f:
        assert f.read() == blob
    k1 = fa.flash_fwd.launches
    # from the file fed tensors, from the bytes fed numpy arrays
    for call, args in ((inference.load_exported(pt2),
                        [torch.from_numpy(v) for v in feeds.values()]),
                       (inference.load_exported(blob), feeds.values())):
        got = call(*args)
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            assert _rel(g.numpy(), np.asarray(w)) <= RTOL
    # on the CPU the custom op runs K1's plain version: no launch
    assert fa.flash_fwd.launches == k1
    with open(pt2 + ".meta.json") as f, open(jblob + ".meta.json") as g:
        meta, jmeta = json.load(f), json.load(g)
    assert meta == jmeta and meta["out_batch_major"] == [True]


def test_the_archive_calls_k1_as_a_custom_op(saved, tmp_path):
    path, specs, dtypes, _ = saved["ernie"]
    pt2 = str(tmp_path / "ernie.pt2")
    inference.export_stablehlo(path, specs, pt2, dtypes)
    exported = torch.export.load(pt2)
    targets = [n.target for n in exported.graph.nodes
               if n.op == "call_function"]
    assert targets.count(torch.ops.paddle_tpu_torch.flash_fwd.default) == \
        CFG["layers"]
    kinds = {s.kind.name for s in exported.graph_signature.input_specs}
    assert kinds == {"BUFFER", "USER_INPUT"}


def test_path_b_serves_what_path_a_serves(saved, tmp_path):
    """Also without its sidecar: the archive's feeds are then arg0, arg1,
    ..., and the outputs whose leading dim is the bucket's batch are
    sliced per request."""
    path, specs, dtypes, feeds = saved["ernie"]
    pt2 = str(tmp_path / "ernie.pt2")
    inference.export_stablehlo(path, specs, pt2, dtypes)
    bare = tmp_path / "bare.pt2"
    bare.write_bytes((tmp_path / "ernie.pt2").read_bytes())
    srv = PredictorServer(cache_dir=None)
    try:
        a = srv.add_tenant("a", path, buckets=[
            {n: (specs[n], "int64") for n in ERNIE_FEEDS}])
        b = srv.add_tenant("b", pt2)
        c = srv.add_tenant("c", str(bare))
        assert c.feed_names == ["arg0", "arg1", "arg2"]
        assert c.out_slicing(c.policy.buckets[0]) == (True,)
        assert [x.key for x in b.policy.buckets] == \
            [x.key for x in a.policy.buckets]
        with open(pt2, "rb") as f:
            assert b.fingerprint == hashlib.sha256(f.read()).hexdigest()
        stats = b.stats()
        assert (stats["compiles"], stats["warm_loads"]) == (0, 0)
        assert stats["admission"]["checked"] is False
        srv.start()
        rows = {n: v[:1] for n, v in feeds.items()}    # padded to batch 2
        for feed in (feeds, rows):
            want = srv.predict("a", feed, timeout=30)
            got = srv.predict("b", feed, timeout=30)
            bare_got = srv.predict("c", {f"arg{i}": feed[n] for i, n in
                                         enumerate(ERNIE_FEEDS)}, timeout=30)
            assert got[0].shape == (len(feed["src_ids"]), 2)
            np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=0)
            np.testing.assert_array_equal(bare_got[0], got[0])
    finally:
        srv.stop()


def test_path_b_refuses_what_it_cannot_serve(saved, tmp_path):
    path, specs, dtypes, _ = saved["ernie"]
    pt2 = str(tmp_path / "ernie.pt2")
    inference.export_stablehlo(path, specs, pt2, dtypes)
    srv = PredictorServer(cache_dir=None)
    with pytest.raises(InvalidArgumentError, match="intrinsic bucket"):
        srv.add_tenant("b", pt2, buckets=[
            {n: ((4, CFG["seq"]), "int64") for n in ERNIE_FEEDS}])
    not_zip = tmp_path / "model.jaxexport"
    not_zip.write_bytes(b"\x00" * 64)
    with pytest.raises(InvalidArgumentError, match="load path B"):
        srv.add_tenant("c", str(not_zip))
    assert srv.tenants() == []


def _capi_run(pt, capi_mod, compiled_cls, load, path, feeds):
    """(the C-API run's outputs as arrays, Executor.run's)."""
    exe, scope = pt.Executor(), pt.Scope()
    prog, names, fetches = load(path, exe, scope=scope)
    compiled = compiled_cls(prog)._with_inference_optimize(
        capi_mod.AnalysisConfig(path))
    outs = exe.run(compiled, feed=[capi_mod.PaddleTensor(feeds[n], name=n)
                                   for n in names], scope=scope)
    assert all(isinstance(o, capi_mod.PaddleTensor) for o in outs)
    assert [o.name for o in outs] == fetches
    want = exe.run(prog, feed=feeds, fetch_list=fetches, scope=scope)
    return [o.as_ndarray() for o in outs], [np.asarray(w) for w in want]


def test_capi_list_feed_run_equals_executor_run(saved):
    path, _, _, feeds = saved["ernie"]
    jgot, jwant = _capi_run(jpt, jcapi, jpt.CompiledProgram, jax_load, path,
                            feeds)
    got, want = _capi_run(tpt, capi, CompiledProgram,
                          tpt.io.load_inference_model, path, feeds)
    for a, b in ((got, want), (jgot, jwant)):
        np.testing.assert_array_equal(a[0], b[0])
    assert _rel(got[0], jgot[0]) <= RTOL
    with pytest.raises(InvalidArgumentError, match="exactly 3 feeds"):
        exe, scope = tpt.Executor(), tpt.Scope()
        prog, _, _ = tpt.io.load_inference_model(path, exe, scope=scope)
        exe.run(CompiledProgram(prog)._with_inference_optimize(None),
                feed=[feeds["src_ids"]], scope=scope)


@pytest.mark.parametrize("d,causal", [(64, False), (128, True)])
def test_flash_fwd_custom_op_opcheck(d, causal):
    gen = torch.Generator().manual_seed(d)
    q, k, v = (torch.randn(2, 16, 2, d, generator=gen) for _ in range(3))
    args = (q, k, v, causal, d ** -0.5, 512)
    torch.library.opcheck(torch.ops.paddle_tpu_torch.flash_fwd.default,
                          args)
    o, lse = torch.ops.paddle_tpu_torch.flash_fwd(*args)
    want_o, want_lse = fa.blockwise_attention(q, k, v, causal=causal,
                                              scale=d ** -0.5)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)


def _save_range_program(pkg, path, end_is_feed):
    """x -> (range(0, End, 1), 2 x), saved by ``pkg``: ``range`` reads its
    End on the host, from the parameter ``n`` (5.0) or from a feed ``n``."""
    prog = pkg.Program()
    blk = prog.global_block()
    blk.create_var("x", shape=(-1, 4), dtype="float32", is_data=True)
    if end_is_feed:
        blk.create_var("n", shape=(), dtype="float32", is_data=True)
    else:
        blk.create_var("n", shape=(), dtype="float32", persistable=True)
    for v in ("r", "y"):
        blk.create_var(v)
    blk.append_op("range", {"End": ["n"]}, {"Out": ["r"]},
                  {"start": 0.0, "step": 1.0, "dtype": "float32"})
    blk.append_op("scale", {"X": ["x"]}, {"Out": ["y"]}, {"scale": 2.0})
    scope = pkg.Scope()
    if not end_is_feed:
        scope.var("n").set(pkg.TpuTensor(np.float32(5.0)))
    feeds = ["x", "n"] if end_is_feed else ["x"]
    with pkg.scope_guard(scope):
        pkg.io.save_inference_model(path, feeds, ["r", "y"], pkg.Executor(),
                                    prog, scope=scope)


def test_export_folds_the_op_that_reads_a_parameter_on_the_host(tmp_path):
    """``range`` over a parameter runs once at export (constant folding,
    as XLA's): the archive gives what the JAX package's export gives."""
    path = str(tmp_path / "m")
    _save_range_program(jpt, path, end_is_feed=False)
    x = np.random.RandomState(3).randn(2, 4).astype(np.float32)
    jblob = str(tmp_path / "m.jaxexport")
    jinference.export_stablehlo(path, {"x": (2, 4)}, jblob)
    want = jinference.load_exported(jblob)(x)
    pt2 = str(tmp_path / "m.pt2")
    inference.export_stablehlo(path, {"x": (2, 4)}, pt2)
    got = inference.load_exported(pt2)(torch.from_numpy(x))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[0].numpy(), np.arange(5.0))
    kinds = [s.kind.name for s in
             torch.export.load(pt2).graph_signature.input_specs]
    # range's output; the parameter only range reads is not kept
    assert kinds.count("BUFFER") == 1


def test_export_traces_what_reads_a_name_a_traced_op_rewrote(tmp_path):
    """y = 3 (x + 2 w), with ``a`` written first from the parameter ``w``
    and then again by an op over the feed: the op after the rewrite
    reads the feed's value, so it is traced, not folded."""
    prog = tpt.Program()
    blk = prog.global_block()
    blk.create_var("x", shape=(-1, 4), dtype="float32", is_data=True)
    blk.create_var("w", shape=(4,), dtype="float32", persistable=True)
    for v in ("a", "y"):
        blk.create_var(v)
    blk.append_op("scale", {"X": ["w"]}, {"Out": ["a"]}, {"scale": 2.0})
    blk.append_op("elementwise_add", {"X": ["x"], "Y": ["a"]},
                  {"Out": ["a"]}, {"axis": -1})
    blk.append_op("scale", {"X": ["a"]}, {"Out": ["y"]}, {"scale": 3.0})
    rng = np.random.RandomState(5)
    w = rng.randn(4).astype(np.float32)
    x = rng.randn(2, 4).astype(np.float32)
    scope = tpt.Scope()
    scope.var("w").set(tpt.TpuTensor(w))
    path, pt2 = str(tmp_path / "m"), str(tmp_path / "m.pt2")
    with tpt.scope_guard(scope):
        tpt.io.save_inference_model(path, ["x"], ["y"], tpt.Executor(),
                                    prog, scope=scope)
    inference.export_stablehlo(path, {"x": (2, 4)}, pt2)
    (got,) = inference.load_exported(pt2)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), 3 * (x + 2 * w), rtol=1e-6)


def test_export_names_the_op_that_reads_a_feed_on_the_host(tmp_path):
    """``range`` over a feed reads a traced value on the host: the export
    fails naming it."""
    path = str(tmp_path / "m")
    _save_range_program(tpt, path, end_is_feed=True)
    with pytest.raises(UnimplementedError, match="op 'range'"):
        inference.export_stablehlo(path, {"x": (2, 4), "n": ()})


@pytest.mark.parametrize("name", ["export_pjrt_artifact",
                                  "export_pjrt_train_artifact"])
def test_pjrt_exports_raise_naming_item_7b(name):
    with pytest.raises(UnimplementedError, match="item 7b"):
        getattr(inference, name)
