"""Error taxonomy + enforce helpers.

A copy of ``paddle_tpu/core/enforce.py`` (pure Python), kept in the port
so that it never imports the JAX package. The analogue of the reference's
PADDLE_ENFORCE_* macros and typed error codes (ref:
paddle/fluid/platform/enforce.h, platform/errors.h).
Python-first: errors are exception classes carrying an error-code taxonomy
identical to the reference's ``platform::errors::*`` set, and enforce_*
helpers raise them with op provenance when available (the executor /
tracer attach the current op via `op_scope`).
"""
from __future__ import annotations

import contextlib
import threading


class EnforceNotMet(RuntimeError):
    """Base framework error (ref: enforce.h EnforceNotMet)."""

    code = "UNKNOWN"

    def __init__(self, message: str):
        op = _current_op()
        if op:
            message = f"{message}\n  [operator < {op} > error]"
        super().__init__(f"({self.code}) {message}")


class InvalidArgumentError(EnforceNotMet):
    code = "InvalidArgument"


class NotFoundError(EnforceNotMet):
    code = "NotFound"


class OutOfRangeError(EnforceNotMet):
    code = "OutOfRange"


class AlreadyExistsError(EnforceNotMet):
    code = "AlreadyExists"


class PermissionDeniedError(EnforceNotMet):
    code = "PermissionDenied"


class ResourceExhaustedError(EnforceNotMet):
    code = "ResourceExhausted"


class PreconditionNotMetError(EnforceNotMet):
    code = "PreconditionNotMet"


class ExecutionTimeoutError(EnforceNotMet):
    code = "ExecutionTimeout"


class UnimplementedError(EnforceNotMet):
    code = "Unimplemented"


class UnavailableError(EnforceNotMet):
    code = "Unavailable"


class FatalError(EnforceNotMet):
    code = "Fatal"


class ExternalError(EnforceNotMet):
    code = "External"


_tls = threading.local()


def _current_op():
    return getattr(_tls, "op_stack", None) and _tls.op_stack[-1]


@contextlib.contextmanager
def op_scope(op_type: str):
    """Attach op provenance to any error raised inside (ref: op_call_stack.cc)."""
    stack = getattr(_tls, "op_stack", None)
    if stack is None:
        stack = _tls.op_stack = []
    stack.append(op_type)
    try:
        yield
    finally:
        stack.pop()


def enforce(cond, message: str, exc=InvalidArgumentError):
    if not cond:
        raise exc(message)


def enforce_eq(a, b, message: str = ""):
    if a != b:
        raise InvalidArgumentError(f"expected {a!r} == {b!r}. {message}")


def enforce_not_none(v, message: str):
    if v is None:
        raise NotFoundError(message)
    return v


def eager_only(x, op_name: str):
    """Raise for a ``meta`` tensor (static shape inference): the op's
    output shapes depend on the data, as under the JAX package's jit."""
    if x.device.type == "meta":
        raise InvalidArgumentError(
            f"{op_name}: host-side / data-dependent op — eager only "
            "(its output shapes depend on the data)")


def host_only(x, op_name: str):
    """The value of a tensor that an op reads on the host (one
    device-to-host copy on the card), as a numpy array: the JAX
    package's guard for host-side, data-dependent ops. A ``meta`` tensor
    (static shape inference) has no value: the op is eager only, and its
    outputs' shapes stay unknown, as under the JAX package's jit.

    A list or tuple of tensors gives a list of arrays, read with one
    wait for the stream: each card tensor is copied into pinned memory
    asynchronously, then the stream is synchronized once."""
    if not isinstance(x, (list, tuple)):
        return host_only([x], op_name)[0]
    import torch
    for t in x:
        eager_only(t, op_name)
    bufs, streams = [], {}
    for t in x:
        t = t.detach()
        if t.device.type == "cuda":
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            streams[t.device] = torch.cuda.current_stream(t.device)
            t = buf
        bufs.append(t)
    for s in streams.values():
        s.synchronize()
    return [b.cpu().numpy() for b in bufs]
