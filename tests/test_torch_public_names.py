"""Every public name of the reference's ``dygraph``, ``nn``, ``static``,
``static.nn``, ``static.detection``, ``tensor_api``, ``static.decoder``,
``static.contrib_layers``, ``static.nest_utils``, ``static.analysis``,
``inference.proto_program``, ``jit.dy2static``, ``io``,
``io.dataloader``, ``dataset``, ``trainer``, ``incubate.data_generator``,
``vision.transforms``, ``vision.datasets``, ``vision.image_utils``,
``text.datasets``, ``metric``, ``average``, ``hapi``, ``hapi.callbacks``,
``inference``, ``inference.capi`` and ``observability.step_timer``
exists in the port's module of the same name (F5:
``dygraph.VarBase`` was missing), less the names a named ROADMAP Queue 1
item still defers, which raise naming it or are absent until it lands,
and less the JAX tape's internals, which have no twin. ``io.download``
has no twin: nothing is downloaded.

A module's public names are its ``__all__`` where it has one, else the
names of ``dir()`` that are not private and not modules. The deferred
lists are exact: a name that the port gains leaves its list here in the
same PR.
"""
import importlib
import inspect

import pytest

import paddle_tpu_torch as tpt
from paddle_tpu_torch.core.enforce import UnimplementedError

# the JAX package's tape (``paddle_tpu/dygraph/tracer.py``): the port's
# tape is torch's autograd, so its node class and its tracing of a jax
# function have no twin
NO_TWIN = {"dygraph": {"TapeNode", "trace_with_fn"},
           # typing names the reference module imports and the port's
           # does not use
           "io.dataloader": {"Callable", "Iterable", "Optional"}}

# reference modules with no twin in the port
NO_TWIN_MODULES = ("io.download",)

# ROADMAP Queue 1 item 8 (the selected-rows ops the two selected-rows
# builders append)
DEFERRED = {
    "static.nn": {"get_tensor_from_selected_rows": "item 8",
                  "merge_selected_rows": "item 8"},
    # the PJRT C client's artifacts (ROADMAP Queue 1 item 7b)
    "inference": {"export_pjrt_artifact": "item 7b",
                  "export_pjrt_train_artifact": "item 7b"},
}

# (reference module, port module): static.nn is a namespace class
MODULES = {"dygraph": "dygraph", "nn": "nn", "static": "static",
           "static.nn": "static.nn", "static.detection": "static.detection",
           "tensor_api": "tensor_api", "static.decoder": "static.decoder",
           "static.contrib_layers": "static.contrib_layers",
           "static.nest_utils": "static.nest_utils",
           "static.analysis": "static.analysis",
           "inference.proto_program": "inference.proto_program",
           "jit.dy2static": "jit.dy2static", "io": "io",
           "io.dataloader": "io.dataloader", "dataset": "dataset",
           "trainer": "trainer",
           "incubate.data_generator": "incubate.data_generator",
           "vision.transforms": "vision.transforms",
           "vision.datasets": "vision.datasets",
           "vision.image_utils": "vision.image_utils",
           "text.datasets": "text.datasets", "metric": "metric",
           "average": "average", "hapi": "hapi",
           "hapi.callbacks": "hapi.callbacks", "inference": "inference",
           "inference.capi": "inference.capi",
           "observability.step_timer": "observability.step_timer"}


def _module(package, name):
    if name == "static.nn":
        return importlib.import_module(package + ".static").nn
    return importlib.import_module(f"{package}.{name}")


def _public(mod):
    names = getattr(mod, "__all__", None)
    if names is not None:
        return set(names)
    return {n for n in dir(mod) if not n.startswith("_")
            and not inspect.ismodule(getattr(mod, n))}


def _state(mod, name):
    """"present", "absent", or the message of the error it raises."""
    try:
        getattr(mod, name)
    except AttributeError:
        return "absent"
    except UnimplementedError as e:
        return str(e)
    return "present"


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")


@pytest.mark.parametrize("name", list(MODULES))
def test_port_module_has_the_reference_public_names(name):
    ref, port = _module("paddle_tpu", name), _module("paddle_tpu_torch", name)
    deferred = DEFERRED.get(name, {})
    no_twin = NO_TWIN.get(name, set())
    missing = {}
    for n in sorted(_public(ref) - no_twin):
        state = _state(port, n)
        if state != "present":
            missing[n] = state
    assert set(missing) == set(deferred), (
        sorted(set(missing) - set(deferred)),
        sorted(set(deferred) - set(missing)))
    for n, state in missing.items():
        assert state == "absent" or deferred[n] in state, (n, state)
    assert no_twin <= _public(ref)


def test_dygraph_varbase_is_the_eager_tensor():
    """F5: ``dygraph.VarBase`` is the port's eager tensor, the same
    class as ``nn.VarBase``, so a 1.x script's isinstance check holds."""
    import torch
    from paddle_tpu_torch import dygraph, nn
    assert dygraph.VarBase is nn.VarBase is torch.Tensor
    assert isinstance(tpt.to_tensor([1.0, 2.0]), dygraph.VarBase)


@pytest.mark.parametrize("name", NO_TWIN_MODULES)
def test_module_without_a_twin(name):
    importlib.import_module(f"paddle_tpu.{name}")
    with pytest.raises(ModuleNotFoundError):
        importlib.import_module(f"paddle_tpu_torch.{name}")
