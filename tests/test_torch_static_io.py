"""Inference-model interchange between the two packages.

``save_inference_model`` writes the pruned test program as JSON next to
a ``params.npz`` archive in both packages. A directory the JAX package
writes loads in the port and predicts the same, and the reverse; the
port's ``save_persistables`` / ``load_persistables`` and ``save`` /
``load`` round-trip. The model is fit_a_line's after a few SGD steps;
predictions are fp32 on the CPU on both sides, held at rtol 1e-5.
"""
import types

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.static as jstatic
from paddle_tpu import io as jio

import chip_smoke
import paddle_tpu_torch as tpt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core.enforce import NotFoundError

JAX_API = types.SimpleNamespace(pt=jpt, static=jstatic, io=jio)
STEPS = 20


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")


def _trained(api, exe):
    """fit_a_line after STEPS steps, in ``api``'s package."""
    program = chip_smoke.book_program(api, "fit_a_line")
    feeds, held_out = chip_smoke.book_feeds("fit_a_line")
    scope = api.pt.Scope()
    chip_smoke.train_book(api, "fit_a_line", exe, scope, program,
                          feeds[:STEPS])
    return program, scope, held_out


def _save(api, exe, program, scope, path):
    prog, _, fetch = program
    with api.pt.scope_guard(scope):
        api.io.save_inference_model(path, ["x"], [fetch["pred"]], exe,
                                    main_program=prog, scope=scope)


def _predict(api, exe, prog, scope, feed, fetches):
    with api.pt.scope_guard(scope):
        return np.asarray(exe.run(prog, feed=feed, fetch_list=fetches,
                                  scope=scope)[0])


def _load_and_predict(api, exe, path, x):
    scope = api.pt.Scope()
    with api.pt.scope_guard(scope):
        prog, feeds, fetches = api.io.load_inference_model(path, exe,
                                                           scope=scope)
    assert feeds == ["x"] and len(fetches) == 1
    return _predict(api, exe, prog, scope, {feeds[0]: x}, fetches)


def _predict_trained(api, exe, program, scope, x):
    prog, _, fetch = program
    return _predict(api, exe, prog, scope,
                    {"x": x, "y": np.zeros((16, 1), np.float32)},
                    [fetch["pred"]])


def test_jax_inference_model_loads_in_the_port(tmp_path):
    jexe = jpt.Executor()
    program, scope, held_out = _trained(JAX_API, jexe)
    _save(JAX_API, jexe, program, scope, str(tmp_path))
    want = _predict_trained(JAX_API, jexe, program, scope, held_out["x"])
    got = _load_and_predict(chip_smoke.port_static_api(), tpt.Executor(),
                            str(tmp_path), held_out["x"])
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_port_inference_model_loads_in_the_jax_package(tmp_path):
    api = chip_smoke.port_static_api()
    exe = tpt.Executor()
    program, scope, held_out = _trained(api, exe)
    _save(api, exe, program, scope, str(tmp_path))
    want = _predict_trained(api, exe, program, scope, held_out["x"])
    got = _load_and_predict(JAX_API, jpt.Executor(), str(tmp_path),
                            held_out["x"])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the saved program is the pruned test program: no grad or sgd op
    port_again = _load_and_predict(api, exe, str(tmp_path), held_out["x"])
    np.testing.assert_allclose(port_again, want, rtol=1e-5)


def test_saved_program_json_is_the_jax_packages(tmp_path):
    """Both packages write the same ``__model__.json`` for the same
    trained program (parameters aside)."""
    api = chip_smoke.port_static_api()
    for which, a, exe in (("jax", JAX_API, jpt.Executor()),
                          ("port", api, tpt.Executor())):
        program, scope, _ = _trained(a, exe)
        _save(a, exe, program, scope, str(tmp_path / which))
    assert (tmp_path / "jax" / "__model__.json").read_text() == \
        (tmp_path / "port" / "__model__.json").read_text()


def test_persistables_round_trip(tmp_path):
    api = chip_smoke.port_static_api()
    exe = tpt.Executor()
    program, scope, _ = _trained(api, exe)
    prog = program[0]
    tio.save_persistables(exe, str(tmp_path), main_program=prog,
                          scope=scope)
    scope2 = tpt.Scope()
    tio.load_persistables(exe, str(tmp_path), main_program=prog,
                          scope=scope2)
    names = chip_smoke.book_params(prog) + ["lr@book"]
    for n in names:
        np.testing.assert_array_equal(scope2.find_var(n).get().numpy(),
                                      scope.find_var(n).get().numpy())
    with np.load(tmp_path / "params.npz") as data:
        assert sorted(data.files) == sorted(names)


def test_state_dict_save_load_round_trip(tmp_path):
    state = {"w": torch.arange(6.0).reshape(2, 3), "step": np.int64(3),
             "sched": {"a/b": np.float32(0.5)}}
    tio.save(state, str(tmp_path / "model.pdparams"))
    back = tio.load(str(tmp_path / "model.pdparams"))
    np.testing.assert_array_equal(back["w"], state["w"].numpy())
    assert int(back["step"]) == 3 and float(back["sched"]["a/b"]) == 0.5
    # the JAX package reads the same archive
    jback = jio.load(str(tmp_path / "model.pdparams"))
    np.testing.assert_array_equal(jback["w"], state["w"].numpy())


def test_missing_inference_model_raises(tmp_path):
    with pytest.raises(NotFoundError):
        tio.load_inference_model(str(tmp_path), tpt.Executor())
