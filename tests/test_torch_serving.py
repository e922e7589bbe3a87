"""The port's serving plane (paddle_tpu_torch.serving): twins of the
load-path-A cases of tests/test_serving.py, on the CPU.

Bucket rules; admission that rejects (the same PTA codes as the JAX
server's on one artifact) and admission that surfaces hazards; numerics
and mixed request sizes against the JAX ``PredictorServer`` on an
artifact the JAX package saved (fp32, rtol 1e-5, atol 1e-5 of the
largest output); zero steady compiles after freeze; strict buckets;
coalescing; deadline expiry; EDF order; stop and restart; the
executable cache across a restart, key isolation, weights in the key
and a stale entry; batch-invariant fetches; the metrics; path B and a
missing card raise.

The tests order threads by events and polled conditions with timeouts
of 10 s or more, never by a fixed sleep: a stalled batch is the fault
plane's ``slow@ms=M,request=N``, and a test waits until the fault has
fired (the worker is inside the stalled batch) before it goes on.
Every server stops in ``finally`` and its worker and readback threads
are joined and checked dead. A fixture restores both packages' flags
and metrics stores, the port's fault spec and device, and checks that
neither global scope changed.
"""
import contextlib
import os
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.core import flags as jflags
from paddle_tpu.core.tensor import TpuTensor as JaxTensor
from paddle_tpu.inference import export_stablehlo
from paddle_tpu.io import save_inference_model as jax_save
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.serving import PredictorServer as JaxServer

import paddle_tpu_torch as tpt
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.enforce import (InvalidArgumentError,
                                           UnavailableError,
                                           UnimplementedError)
from paddle_tpu_torch.observability import flight_recorder
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability import tracer
from paddle_tpu_torch.serving import (AdmissionError, Bucket, BucketPolicy,
                                      DeadlineExceeded, PredictorServer,
                                      ServedModel, ServingMesh,
                                      signature_of)
from paddle_tpu_torch.serving.cache import (ARTIFACT_SUFFIX,
                                            ExecutableCache, cache_key)
from paddle_tpu_torch.serving.scheduler import ServingClosed
from paddle_tpu_torch.testing import faults

RTOL, ATOL = 1e-5, 1e-5
TIMEOUT = 30.0


# ------------------------------------------------------------- isolation
def _metrics_state(reg, scalar_names, scalar, hist_state):
    names = scalar_names(reg)
    with reg._lock:
        hists = dict(reg._hists)
    return ({n: scalar(reg, n).get() for n in names}, hists,
            {n: hist_state(h) for n, h in hists.items()})


def _hist_state(h):
    with h._lock:
        return h.count, h.total, h.min, h.max, list(h._buf)


def _restore_metrics(reg, state, scalar_names, scalar):
    values, hists, hstate = state
    for n in scalar_names(reg):
        scalar(reg, n).set(values.get(n, 0))
    with reg._lock:
        reg._hists.clear()
        reg._hists.update(hists)
    for n, (count, total, mn, mx, buf) in hstate.items():
        h = hists[n]
        with h._lock:
            h.count, h.total, h.min, h.max = count, total, mn, mx
            h._buf.clear()
            h._buf.extend(buf)


# (registry, its scalar names, one scalar) for each package's store
STORES = [
    (jmetrics.MetricRegistry.instance,
     lambda reg: reg._scalars.names(), lambda reg, n: reg._scalars.get(n)),
    (tmetrics.MetricRegistry.instance,
     lambda reg: list(reg._scalars), lambda reg, n: reg._scalar(n)),
]


@pytest.fixture(autouse=True)
def _pristine():
    prev_device = tdevice._device
    tpt.set_device("cpu")
    faults.reset()
    saved_flags = [(f, dict(f._REGISTRY)) for f in (jflags, tflags)]
    saved = [(inst(), names, scalar,
              _metrics_state(inst(), names, scalar, _hist_state))
             for inst, names, scalar in STORES]
    scopes = (jpt.global_scope(), tpt.global_scope())
    yield
    faults.reset()
    tracer.disable()
    tracer.reset()
    flight_recorder.disable()
    flight_recorder.reset()
    tdevice._device = prev_device
    for f, reg in saved_flags:
        f._REGISTRY.clear()
        f._REGISTRY.update(reg)
    for reg, names, scalar, state in saved:
        _restore_metrics(reg, state, names, scalar)
    assert (jpt.global_scope(), tpt.global_scope()) == scopes


def metric(name):
    return int(tmetrics.metric_get(name))


@contextlib.contextmanager
def serving(srv):
    """Start ``srv``; on exit stop it and check every worker and
    readback thread it ran has exited."""
    srv.start()
    try:
        yield srv
    finally:
        threads = [t for s in srv._schedulers()
                   for t in (s._thread, s._rb_thread) if t is not None]
        srv.stop()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not [t.name for t in threads if t.is_alive()]


def wait_until(cond, what, timeout=TIMEOUT):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.005)


def stall(request_id, ms):
    """Arm ``slow@ms=ms`` on the request after ``request_id`` and return
    a wait for the worker to be inside that stalled batch."""
    faults.arm(f"slow@ms={ms},request={request_id + 1}")

    def entered():
        wait_until(lambda: faults.fired() and faults.fired()[0]["fired"],
                   "the worker to enter the stalled batch")
    return entered


# ---------------------------------------------------------- artifacts
def _mlp_program(pt, in_dim, out_dim):
    prog = pt.Program()
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
    return prog


def save_mlp(dirname, in_dim=4, out_dim=3, seed=3, fetches=("out",),
             jax=False):
    """relu(x @ w + b) saved as an inference model (by the JAX package
    with ``jax``, else by the port); returns (w, b)."""
    rs = np.random.RandomState(seed)
    w = rs.randn(in_dim, out_dim).astype(np.float32)
    b = rs.randn(out_dim).astype(np.float32)
    pt = jpt if jax else tpt
    prog = _mlp_program(pt, in_dim, out_dim)
    scope = pt.Scope()
    scope.var("w").set(JaxTensor(w) if jax else tpt.TpuTensor(w))
    scope.var("b").set(JaxTensor(b) if jax else tpt.TpuTensor(b))
    save = jax_save if jax else tpt.io.save_inference_model
    with pt.scope_guard(scope):
        save(dirname, ["x"], list(fetches), pt.Executor(), prog,
             scope=scope)
    return w, b


def save_broken(dirname):
    """mul contracts 4 against 5: PTA102 at admission (saved by the JAX
    package)."""
    prog = jpt.Program()
    blk = prog.global_block()
    blk.create_var("x", shape=(8, 4), dtype="float32", is_data=True)
    blk.create_var("w", shape=(5, 3), dtype="float32", persistable=True)
    blk.create_var("out")
    blk.append_op("mul", {"X": ["x"], "Y": ["w"]}, {"Out": ["out"]},
                  {"x_num_col_dims": 1, "y_num_col_dims": 1})
    scope = jpt.Scope()
    scope.var("w").set(JaxTensor(np.zeros((5, 3), np.float32)))
    with jpt.scope_guard(scope):
        jax_save(dirname, ["x"], ["out"], jpt.Executor(), prog, scope=scope)


def mlp(x, w, b):
    return np.maximum(x @ w + b, 0)


def ones(rows):
    return {"x": np.ones((rows, 4), np.float32)}


# ---------------------------------------------------------- bucket policy
def test_bucket_selection_smallest_fitting_wins():
    policy = BucketPolicy(declared=[{"x": (16, 8)}, {"x": (4, 8)}])
    sig = signature_of({"x": np.zeros((3, 8), np.float32)})
    b = policy.select(sig)
    assert b is not None and b.batch == 4
    big = signature_of({"x": np.zeros((9, 8), np.float32)})
    assert policy.select(big).batch == 16


def test_bucket_fit_rules():
    b = Bucket({"x": ((4, 8), "float32")})
    assert b.fits(signature_of({"x": np.zeros((2, 5), np.float32)}))
    assert not b.fits(signature_of({"x": np.zeros((2, 5), np.float64)}))
    assert not b.fits(signature_of({"x": np.zeros((2, 5, 1),
                                                  np.float32)}))
    assert not b.fits(signature_of({"y": np.zeros((2, 5), np.float32)}))
    assert not b.fits(signature_of({"x": np.zeros((2, 9), np.float32)}))
    assert b.fits(signature_of({"x": np.zeros((1, 8), np.float32)}),
                  rows=4)
    assert not b.fits(signature_of({"x": np.zeros((1, 8), np.float32)}),
                      rows=5)


def test_bucket_learning_pow2_and_freeze():
    policy = BucketPolicy()
    sig = signature_of({"x": np.zeros((3, 5), np.float32)})
    b, learned = policy.resolve(sig)
    assert learned and b.spec["x"][0] == (4, 8)
    b2, learned2 = policy.resolve(sig)
    assert b2 is b and not learned2
    policy.freeze()
    miss = signature_of({"x": np.zeros((3, 9), np.float32)})
    assert policy.resolve(miss) == (None, False)


def test_bucket_padding_zero_fills():
    b = Bucket({"x": ((4, 6), "float32")})
    padded = b.pad({"x": np.ones((2, 3), np.float32)})
    assert padded["x"].shape == (4, 6)
    assert padded["x"][:2, :3].all() and not padded["x"][2:].any()


# ------------------------------------------------------------- admission
def test_admission_rejects_what_the_jax_server_rejects(tmp_path):
    save_broken(str(tmp_path / "broken"))
    with pytest.raises(Exception) as jerr:
        JaxServer(cache_dir=None).add_tenant("broken",
                                             str(tmp_path / "broken"))
    before = metric("serving/admission_rejected")
    srv = PredictorServer(cache_dir=None)
    with pytest.raises(AdmissionError) as err:
        srv.add_tenant("broken", str(tmp_path / "broken"))
    assert "PTA102" in str(err.value)
    assert [d.code for d in err.value.diagnostics] == \
        [d.code for d in jerr.value.diagnostics]
    assert "broken" not in srv.tenants()
    assert metric("serving/admission_rejected") == before + 1


def test_admission_surfaces_recompile_hazards(tmp_path):
    save_mlp(str(tmp_path / "m"))
    model = ServedModel("m", str(tmp_path / "m"))
    assert [d.code for d in model.admission.recompile_hazards] == ["PTA301"]
    assert model.admission.ok and model.admission.checked


# ---------------------------------------------------- end-to-end serving
def test_numerics_and_mixed_sizes_against_the_jax_server(tmp_path):
    w, b = save_mlp(str(tmp_path / "m"), jax=True)
    buckets = [{"x": (4, 4)}, {"x": (8, 4)}]
    jsrv = JaxServer(cache_dir=None)
    jsrv.add_tenant("m", str(tmp_path / "m"), buckets=buckets)
    srv = PredictorServer(cache_dir=None)
    model = srv.add_tenant("m", str(tmp_path / "m"), buckets=buckets)
    with serving(jsrv), serving(srv):
        for rows in (1, 3, 4, 6, 8, 2, 5):
            x = np.random.RandomState(rows).rand(rows, 4).astype(np.float32)
            want, = jsrv.predict("m", {"x": x})
            out, = srv.predict("m", {"x": x})
            assert out.shape == (rows, 3)
            np.testing.assert_allclose(out, np.asarray(want), rtol=RTOL,
                                       atol=ATOL)
            np.testing.assert_allclose(out, mlp(x, w, b), rtol=RTOL,
                                       atol=ATOL)
    assert model.compiles == 2 and model.steady_compiles == 0


def test_pipelined_and_serial_dispatch_give_the_same_bits(tmp_path):
    save_mlp(str(tmp_path / "m"))
    outs = {}
    for depth in (1, 2):
        srv = PredictorServer(cache_dir=None, pipeline_depth=depth)
        srv.add_tenant("m", str(tmp_path / "m"), buckets=[{"x": (8, 4)}])
        with serving(srv):
            futs = [srv.submit("m", {"x": np.random.RandomState(i).rand(
                i + 1, 4).astype(np.float32)}) for i in range(6)]
            outs[depth] = [f.result(TIMEOUT)[0] for f in futs]
    for a, b in zip(outs[1], outs[2]):
        np.testing.assert_array_equal(a, b)


def test_zero_steady_recompiles_after_freeze(tmp_path):
    save_mlp(str(tmp_path / "m"))
    srv = PredictorServer(cache_dir=None)
    model = srv.add_tenant("m", str(tmp_path / "m"))   # learned buckets
    with serving(srv):
        for rows in (2, 7):
            srv.predict("m", ones(rows))
        srv.freeze()
        c0 = model.compiles
        for rows in (1, 2, 3, 5, 8, 4, 6, 7):
            srv.predict("m", ones(rows))
        assert model.compiles == c0 and model.steady_compiles == 0
        before = metric("serving/buckets_learned_post_freeze")
        srv.predict("m", ones(9))
        assert model.steady_compiles == 1
        assert metric("serving/buckets_learned_post_freeze") == before + 1


def test_strict_buckets_reject_unbucketed(tmp_path):
    save_mlp(str(tmp_path / "m"))
    srv = PredictorServer(cache_dir=None)
    srv.add_tenant("m", str(tmp_path / "m"), buckets=[{"x": (4, 4)}],
                   strict_buckets=True)
    with serving(srv):
        err = srv.submit("m", ones(9)).exception(timeout=TIMEOUT)
        assert isinstance(err, InvalidArgumentError)
        assert "bucket" in str(err)


def test_batching_coalesces_requests_queued_behind_a_batch(tmp_path):
    """Four 2-row requests queued while the worker is inside another
    batch go out as ONE 8-row bucket batch."""
    save_mlp(str(tmp_path / "m"))
    srv = PredictorServer(cache_dir=None, max_linger_ms=0.0)
    model = srv.add_tenant("coalesce", str(tmp_path / "m"),
                           buckets=[{"x": (8, 4)}])
    with serving(srv):
        probe = srv.submit("coalesce", ones(1))
        probe.result(TIMEOUT)
        before = metric("serving/batches/coalesce")
        entered = stall(probe.request_id, 300)
        filler = srv.submit("coalesce", ones(1))
        entered()
        futs = [srv.submit("coalesce", ones(2)) for _ in range(4)]
        for f in futs:
            assert f.result(TIMEOUT)[0].shape == (2, 3)
        filler.result(TIMEOUT)
        assert metric("serving/batches/coalesce") == before + 2
        assert model.compiles == 1


def test_deadline_expiry_under_injected_slowness(tmp_path):
    """A request whose deadline passes while the worker is stalled in
    another batch expires with DeadlineExceeded and never executes."""
    save_mlp(str(tmp_path / "m"))
    srv = PredictorServer(cache_dir=None, max_linger_ms=0.0)
    srv.add_tenant("m", str(tmp_path / "m"), buckets=[{"x": (2, 4)}])
    with serving(srv):
        probe = srv.submit("m", ones(1))
        probe.result(TIMEOUT)
        before = metric("serving/deadline_expired/m")
        entered = stall(probe.request_id, 1000)
        slow = srv.submit("m", ones(2))
        entered()
        doomed = srv.submit("m", ones(1), deadline_ms=100)
        assert slow.result(TIMEOUT)[0].shape == (2, 3)
        assert isinstance(doomed.exception(timeout=TIMEOUT),
                          DeadlineExceeded)
        assert "t_exec" not in doomed.timing
        assert metric("serving/deadline_expired/m") == before + 1


def test_edf_serves_tight_deadline_first(tmp_path):
    save_mlp(str(tmp_path / "m"))
    srv = PredictorServer(cache_dir=None, max_linger_ms=0.0)
    srv.add_tenant("m", str(tmp_path / "m"), buckets=[{"x": (1, 4)}])
    with serving(srv):
        probe = srv.submit("m", ones(1))
        probe.result(TIMEOUT)
        entered = stall(probe.request_id, 300)
        filler = srv.submit("m", ones(1))
        entered()
        loose = srv.submit("m", ones(1), deadline_ms=60_000)
        tight = srv.submit("m", ones(1), deadline_ms=30_000)
        for f in (filler, loose, tight):
            f.result(TIMEOUT)
        assert tight.timing["t_exec"] < loose.timing["t_exec"]
        assert tight.timing["t_done"] <= loose.timing["t_done"]


def test_request_expiring_during_linger_never_executes(tmp_path):
    """A request whose deadline elapses while the worker lingers to
    fill an underfull bucket completes DeadlineExceeded; the request it
    lingered with executes."""
    save_mlp(str(tmp_path / "m"))
    srv = PredictorServer(cache_dir=None, max_linger_ms=1000.0)
    srv.add_tenant("m", str(tmp_path / "m"), buckets=[{"x": (4, 4)}])
    with serving(srv):
        live = srv.submit("m", ones(1), deadline_ms=60_000)
        doomed = srv.submit("m", ones(1), deadline_ms=200)
        assert live.result(TIMEOUT)[0].shape == (1, 3)
        assert isinstance(doomed.exception(timeout=TIMEOUT),
                          DeadlineExceeded)


def test_submit_after_stop_raises(tmp_path):
    save_mlp(str(tmp_path / "m"))
    srv = PredictorServer(cache_dir=None)
    srv.add_tenant("m", str(tmp_path / "m"), buckets=[{"x": (2, 4)}])
    with serving(srv):
        pass
    with pytest.raises(ServingClosed):
        srv.tenant("m").submit(ones(1))


def test_restart_after_stop_serves_again(tmp_path):
    save_mlp(str(tmp_path / "m"))
    srv = PredictorServer(cache_dir=None)
    srv.add_tenant("m", str(tmp_path / "m"), buckets=[{"x": (2, 4)}])
    with serving(srv):
        out1, = srv.predict("m", ones(1))
    with serving(srv):
        out2, = srv.predict("m", ones(1))
    np.testing.assert_array_equal(out2, out1)


def test_restart_during_timed_out_drain_revives_single_worker(tmp_path):
    """start() after a stop() whose drain outlived its join timeout
    revives the still-draining worker in place, and a storm of
    concurrent start() calls never races two loops onto one queue."""
    save_mlp(str(tmp_path / "m"))
    srv = PredictorServer(cache_dir=None, max_linger_ms=0.0)
    srv.add_tenant("revive", str(tmp_path / "m"), buckets=[{"x": (2, 4)}])
    sched = srv.tenant("revive")
    with serving(srv):
        probe = sched.submit(ones(1))
        probe.result(TIMEOUT)
        entered = stall(probe.request_id, 2000)
        futs = [sched.submit(ones(1)) for _ in range(3)]
        entered()
        sched.stop(drain=True, timeout=0.05)    # the join times out
        old = sched._thread
        assert old is not None and old.is_alive()
        sched.start()                           # revive, don't double
        assert sched._thread is old
        for f in futs:
            assert f.result(TIMEOUT)[0].shape == (1, 3)
        assert srv.predict("revive", ones(1))[0].shape == (1, 3)
        srv.stop()
        storm = [threading.Thread(target=sched.start) for _ in range(8)]
        for t in storm:
            t.start()
        for t in storm:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in storm)
        alive = [t for t in threading.enumerate()
                 if t.name == "pt-serve-revive" and t.is_alive()]
        assert len(alive) == 1, alive
        assert sched.submit(ones(1)).result(TIMEOUT)[0].shape == (1, 3)


def test_explicit_zero_deadline_expires_not_unbounded(tmp_path):
    save_mlp(str(tmp_path / "m"))
    srv = PredictorServer(cache_dir=None, max_linger_ms=0.0)
    srv.add_tenant("m", str(tmp_path / "m"), buckets=[{"x": (2, 4)}])
    with serving(srv):
        err = srv.submit("m", ones(1), deadline_ms=0).exception(
            timeout=TIMEOUT)
        assert isinstance(err, DeadlineExceeded)
    # the TENANT default keeps the flag's 0-means-disabled convention
    srv2 = PredictorServer(cache_dir=None)
    srv2.add_tenant("d", str(tmp_path / "m"), buckets=[{"x": (2, 4)}],
                    default_deadline_ms=0)
    with serving(srv2):
        assert srv2.predict("d", ones(1))[0].shape == (1, 3)


def test_swap_tenant_serves_the_new_weights(tmp_path):
    save_mlp(str(tmp_path / "a"), seed=3)
    w, b = save_mlp(str(tmp_path / "b"), seed=7)
    srv = PredictorServer(cache_dir=None)
    srv.add_tenant("m", str(tmp_path / "a"), buckets=[{"x": (4, 4)}])
    x = np.random.RandomState(0).rand(3, 4).astype(np.float32)
    with serving(srv):
        srv.predict("m", {"x": x})
        new = srv.swap_tenant("m", str(tmp_path / "b"))
        out, = srv.predict("m", {"x": x})
    np.testing.assert_allclose(out, mlp(x, w, b), rtol=RTOL, atol=ATOL)
    assert new.steady_armed and new.steady_compiles == 0


# ------------------------------------------------------ executable cache
def test_exec_cache_hit_across_restart(tmp_path):
    """A second server over the same cache directory warm-loads every
    bucket: no new compile."""
    save_mlp(str(tmp_path / "m"))
    cache_dir = str(tmp_path / "cache")
    buckets = [{"x": (4, 4)}, {"x": (8, 4)}]
    x = np.random.RandomState(0).rand(3, 4).astype(np.float32)
    srv1 = PredictorServer(cache_dir=cache_dir)
    m1 = srv1.add_tenant("m", str(tmp_path / "m"), buckets=buckets)
    with serving(srv1):
        out1, = srv1.predict("m", {"x": x})
    assert m1.compiles == 2 and m1.warm_loads == 0
    assert len(ExecutableCache(cache_dir).entries()) == 2
    before = metric("serving/compiles")
    srv2 = PredictorServer(cache_dir=cache_dir)
    m2 = srv2.add_tenant("m", str(tmp_path / "m"), buckets=buckets)
    with serving(srv2):
        out2, = srv2.predict("m", {"x": x})
    assert metric("serving/compiles") == before
    assert m2.compiles == 0 and m2.warm_loads == 2
    np.testing.assert_array_equal(out2, out1)


def test_cache_key_isolation():
    k = cache_key("fp1", "x:4x4:float32", ["out"], platform="cpu")
    assert k != cache_key("fp2", "x:4x4:float32", ["out"], platform="cpu")
    assert k != cache_key("fp1", "x:8x4:float32", ["out"], platform="cpu")
    assert k != cache_key("fp1", "x:4x4:float32", ["other"],
                          platform="cpu")
    assert k != cache_key("fp1", "x:4x4:float32", ["out"], platform="cuda")
    assert k == cache_key("fp1", "x:4x4:float32", ["out"], platform="cpu")
    assert k != cache_key("fp1", "x:4x4:float32", ["out"], platform="cpu",
                          params_digest="d1")
    assert cache_key("fp1", "x:4x4:float32", ["out"], params_digest="d1") \
        != cache_key("fp1", "x:4x4:float32", ["out"], params_digest="d2")


def test_same_graph_different_weights_do_not_share_cache(tmp_path):
    wa, ba = save_mlp(str(tmp_path / "a"), seed=3)
    wb, bb = save_mlp(str(tmp_path / "b"), seed=7)
    srv = PredictorServer(cache_dir=str(tmp_path / "cache"))
    ma = srv.add_tenant("a", str(tmp_path / "a"), buckets=[{"x": (4, 4)}])
    mb = srv.add_tenant("b", str(tmp_path / "b"), buckets=[{"x": (4, 4)}])
    assert ma.fingerprint == mb.fingerprint
    assert ma.params_digest != mb.params_digest
    assert mb.warm_loads == 0 and mb.compiles == 1
    x = np.random.RandomState(0).rand(2, 4).astype(np.float32)
    with serving(srv):
        out_a, = srv.predict("a", {"x": x})
        out_b, = srv.predict("b", {"x": x})
    np.testing.assert_allclose(out_a, mlp(x, wa, ba), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out_b, mlp(x, wb, bb), rtol=RTOL, atol=ATOL)


def test_retrained_weights_invalidate_warm_boot(tmp_path):
    cache_dir = str(tmp_path / "cache")
    save_mlp(str(tmp_path / "m"), seed=3)
    m1 = PredictorServer(cache_dir=cache_dir).add_tenant(
        "m", str(tmp_path / "m"), buckets=[{"x": (4, 4)}])
    assert m1.compiles == 1
    w2, b2 = save_mlp(str(tmp_path / "m"), seed=11)
    srv2 = PredictorServer(cache_dir=cache_dir)
    m2 = srv2.add_tenant("m", str(tmp_path / "m"), buckets=[{"x": (4, 4)}])
    assert m2.fingerprint == m1.fingerprint
    assert m2.warm_loads == 0 and m2.compiles == 1
    x = np.random.RandomState(2).rand(3, 4).astype(np.float32)
    with serving(srv2):
        out, = srv2.predict("m", {"x": x})
    np.testing.assert_allclose(out, mlp(x, w2, b2), rtol=RTOL, atol=ATOL)


def test_stale_cache_entry_is_a_miss_not_a_crash(tmp_path):
    save_mlp(str(tmp_path / "m"))
    cache_dir = str(tmp_path / "cache")
    m = PredictorServer(cache_dir=cache_dir).add_tenant(
        "m", str(tmp_path / "m"), buckets=[{"x": (4, 4)}])
    assert m.compiles == 1
    for fn in os.listdir(cache_dir):
        if fn.endswith(ARTIFACT_SUFFIX):
            with open(os.path.join(cache_dir, fn), "w") as f:
                f.write("garbage")
    m2 = PredictorServer(cache_dir=cache_dir).add_tenant(
        "m", str(tmp_path / "m"), buckets=[{"x": (4, 4)}])
    assert m2.compiles == 1 and m2.warm_loads == 0


def test_batch_invariant_fetch_returned_whole_not_missliced(tmp_path):
    """A fetch that does not depend on the batch (the weight table,
    whose leading dim equals the bucket batch) goes to every request
    whole: the shape probe decides, not shape[0] == bucket.batch."""
    w, _ = save_mlp(str(tmp_path / "m"), fetches=("out", "w"))
    srv = PredictorServer(cache_dir=None)
    model = srv.add_tenant("m", str(tmp_path / "m"),
                           buckets=[{"x": (4, 4)}])
    assert model.out_slicing(model.policy.buckets[0]) == (True, False)
    with serving(srv):
        out, table = srv.predict("m", ones(2))
    assert out.shape == (2, 3) and table.shape == (4, 3)
    np.testing.assert_array_equal(table, w)


def test_admission_suggestion_from_cache_provenance(tmp_path):
    """A second boot against the same cache: the PTA301 diagnostic
    carries the pow2-rounded buckets=[...] declaration derived from the
    first boot's stored entries."""
    save_mlp(str(tmp_path / "m"))
    cache_dir = str(tmp_path / "cache")
    srv = PredictorServer(cache_dir=cache_dir)
    srv.add_tenant("m", str(tmp_path / "m"))
    with serving(srv):
        srv.predict("m", ones(3))
    model = ServedModel("m", str(tmp_path / "m"),
                        cache=ExecutableCache(cache_dir))
    msg = [d for d in model.admission.diagnostics
           if d.code == "PTA301"][0].message
    assert "buckets=[" in msg and "(4, 4)" in msg
    assert "observed signature" in msg


def test_auto_buckets_applies_cache_provenance(tmp_path):
    save_mlp(str(tmp_path / "m"))
    cache_dir = str(tmp_path / "cache")
    m0 = PredictorServer(cache_dir=str(tmp_path / "cold")).add_tenant(
        "m", str(tmp_path / "m"), buckets="auto")
    assert not m0.auto_buckets_applied and not m0.policy.frozen
    srv1 = PredictorServer(cache_dir=cache_dir)
    srv1.add_tenant("m", str(tmp_path / "m"))
    with serving(srv1):
        srv1.predict("m", ones(3))
    srv2 = PredictorServer(cache_dir=cache_dir)
    m2 = srv2.add_tenant("m", str(tmp_path / "m"), buckets="auto")
    assert m2.auto_buckets_applied and m2.declared_at_load
    assert m2.policy.frozen
    assert [b.spec["x"] for b in m2.policy.buckets] == \
        [((4, 4), "float32")]
    assert m2.warm_loads >= 1 and m2.compiles == 0
    with serving(srv2):
        assert srv2.predict("m", ones(3))[0].shape == (3, 3)


# -------------------------------------------------- observability surface
def test_serving_metrics(tmp_path):
    save_mlp(str(tmp_path / "m"))
    srv = PredictorServer(cache_dir=None)
    srv.add_tenant("metrics", str(tmp_path / "m"), buckets=[{"x": (4, 4)}])
    before = metric("serving/requests/metrics")
    with serving(srv):
        for _ in range(3):
            srv.predict("metrics", ones(2))
    snap = tmetrics.snapshot()
    assert metric("serving/requests/metrics") == before + 3
    lat = snap["serving/request_latency_ms/metrics"]
    assert lat["count"] >= 3 and lat["p99"] >= lat["p50"] > 0
    occ = snap["serving/bucket_occupancy/metrics/x:4x4:float32"]
    assert occ["count"] >= 3 and occ["min"] <= 0.5 <= occ["max"]
    stats = srv.stats()
    assert stats["tenants"]["metrics"]["latency_ms"]["count"] >= 3
    assert stats["steady_compiles"] == metric("serving/steady_compiles")


def test_batch_span_and_flight_event_name_the_requests(tmp_path):
    save_mlp(str(tmp_path / "m"))
    srv = PredictorServer(cache_dir=None)
    srv.add_tenant("traced", str(tmp_path / "m"), buckets=[{"x": (4, 4)}])
    tracer.enable()
    flight_recorder.enable()
    with serving(srv):
        fut = srv.submit("traced", ones(2))
        fut.result(TIMEOUT)
    span, = [sp for sp in tracer.get_spans() if sp.name == "serving/batch"]
    assert span.args["tenant"] == "traced" and span.args["rows"] == 2
    assert span.args["request_ids"] == str(fut.request_id)
    assert span.dur_us > 0
    events = flight_recorder.events()
    batch, = [e for e in events if e["kind"] == "serving_batch"]
    assert batch["request_ids"] == [fut.request_id]
    assert batch["bucket"] == "x:4x4:float32"
    assert any(e["kind"] == "span" and e["name"] == "serving/batch"
               for e in events)


def test_stats_under_concurrent_add_tenant_hammer(tmp_path):
    save_mlp(str(tmp_path / "m"))
    srv = PredictorServer(cache_dir=None)
    srv.add_tenant("t0", str(tmp_path / "m"), buckets=[{"x": (2, 4)}])
    stop = threading.Event()
    failures = []

    def hammer():
        while not stop.is_set():
            try:
                for name, t in srv.stats()["tenants"].items():
                    assert "buckets" in t and "queue_depth" in t, name
            except Exception as e:      # noqa: BLE001 - the regression
                failures.append(repr(e))
                return

    threads = [threading.Thread(target=hammer) for _ in range(3)]
    with serving(srv):
        for t in threads:
            t.start()
        try:
            for i in range(1, 9):
                srv.add_tenant(f"t{i}", str(tmp_path / "m"),
                               buckets=[{"x": (2, 4)}], prewarm=False)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    assert not failures, failures
    assert len(srv.stats()["tenants"]) == 9


# ------------------------------------------------------ placement, refusals
def test_one_device_mesh_places_every_tenant_as_a_replica(tmp_path):
    w, b = save_mlp(str(tmp_path / "m"))
    srv = PredictorServer(cache_dir=None, mesh=ServingMesh())
    model = srv.add_tenant("m", str(tmp_path / "m"), buckets=[{"x": (4, 4)}])
    x = np.random.RandomState(0).rand(3, 4).astype(np.float32)
    with serving(srv):
        srv.freeze()
        out, = srv.predict("m", {"x": x})
    assert model.placement.kind == "replicated"
    assert model.stats()["placement"]["devices"] == [0]
    np.testing.assert_allclose(out, mlp(x, w, b), rtol=RTOL, atol=ATOL)
    with pytest.raises(UnimplementedError, match="item 8"):
        ServingMesh(model_ways=2)
    srv2 = PredictorServer(cache_dir=None, mesh=ServingMesh())
    srv2.add_tenant("mp", str(tmp_path / "m"), buckets=[{"x": (4, 4)}],
                    placement="model_parallel")
    with pytest.raises(UnimplementedError, match="item 8"):
        srv2.freeze()


def test_exported_artifact_path_b_raises(tmp_path):
    save_mlp(str(tmp_path / "m"), jax=True)
    blob = str(tmp_path / "model.jaxexport")
    export_stablehlo(str(tmp_path / "m"), {"x": (4, 4)}, output_path=blob)
    srv = PredictorServer(cache_dir=None)
    with pytest.raises(InvalidArgumentError, match="load path B"):
        srv.add_tenant("aot", blob)
    assert srv.tenants() == []


def test_add_tenant_needs_a_card_or_the_cpu(tmp_path):
    """No fallback: with no card and no set_device("cpu") a tenant
    cannot load."""
    save_mlp(str(tmp_path / "m"))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    tdevice._device = None
    srv = PredictorServer(cache_dir=None)
    with pytest.raises(UnavailableError):
        srv.add_tenant("m", str(tmp_path / "m"), buckets=[{"x": (4, 4)}])
    assert srv.tenants() == []


def test_fault_spec_slow_at_a_request():
    """The one ported kind parses with its fire budget; disarmed, the
    request hook does nothing."""
    spec = faults.arm("slow@ms=0,request=2;slow@ms=0,request=3,times=2")
    assert [(i.params["request"], i.times) for i in spec.injections] == \
        [(2, 1), (3, 2)]
    faults.on_request(3)
    faults.on_request(3)
    faults.on_request(3)
    assert [f["fired"] for f in faults.fired()] == [0, 2]
    faults.disarm()
    faults.on_request(2)
    assert faults.active() is None and faults.fired() == []


@pytest.mark.parametrize("text, match", [
    ("crash@step=3", "not ported"),
    ("hang@collective=all", "not ported"),
    ("rpc@drop=predict", "not ported"),
    ("slow@ms=5", "needs ms= and request="),
    ("slow@request=2", "needs ms= and request="),
    ("slow@ms=5,request=2,rank=1", "is not one of"),
    ("slow@ms=x,request=1", "not a number"),
    ("slow@ms=1,ms=2,request=1", "duplicate"),
    ("slow", "expected"),
    (" ; ", "empty"),
])
def test_fault_spec_rejects_unported_and_malformed(text, match):
    """A kind the port has no site for, or a malformed spec, raises at
    arm time instead of arming a spec that never fires."""
    with pytest.raises(faults.FaultSpecError, match=match):
        faults.arm(text)
    assert faults.active() is None
