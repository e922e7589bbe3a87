"""Seeding over explicit ``torch.Generator`` objects.

Port of ``paddle_tpu/core/rng.py``. The JAX package folds (seed, step,
op salt) into a PRNG key because a jitted block is traced once; torch
runs eagerly, so a generator that advances with every draw gives fresh
numbers each step by itself. Initializers draw on the CPU from
:func:`default_generator` and the layer moves the result to its device,
so one seed gives the same weights on every device.

The static executor runs a block once a step, like the JAX package's,
whose random ops fold (seed, step, op salt) into a key
(``paddle_tpu/core/rng.py:38-76``). Here :class:`step_scope` installs
the executor's step, :func:`set_op_salt` the place of the op about to
run among the block's :data:`RANDOM_OPS`, and :func:`random_generator`
seeds a generator from (seed attr or the global seed, step, that place):
fresh numbers every step, the same ones for the same seed and step,
whichever other ops of the block run, as each op's salt in the JAX
package is fixed by its place in the traced block.

torch's Philox and JAX's threefry never agree on numbers: tests make
their inputs with numpy and carry weights across by name
(``paddle_tpu_torch/convert.py``).
"""
from __future__ import annotations

import threading

import torch

_tls = threading.local()


def default_generator() -> torch.Generator:
    """The calling thread's CPU generator (created seeded with 0)."""
    gen = getattr(_tls, "generator", None)
    if gen is None:
        gen = _tls.generator = torch.Generator(device="cpu")
        gen.manual_seed(0)
    return gen


_default_seed = 0


def global_seed(seed: int):
    """paddle.seed parity: reseed this thread's generator and the static
    executor's step streams."""
    global _default_seed
    _default_seed = int(seed)
    default_generator().manual_seed(int(seed))


# the op types whose compute draws from random_generator, once a run
RANDOM_OPS = frozenset({"gaussian_random", "uniform_random", "dropout"})


class step_scope:
    """Context manager installing the executor's step for a block run."""

    def __init__(self, step: int):
        self._step = int(step)

    def __enter__(self):
        self._saved = (getattr(_tls, "step", None), getattr(_tls, "salt", 0))
        _tls.step, _tls.salt = self._step, 0
        return self

    def __exit__(self, *exc):
        _tls.step, _tls.salt = self._saved


def set_op_salt(salt: int):
    """Inside a :class:`step_scope`: the next op to draw is the block's
    random op number ``salt + 1``."""
    _tls.salt = int(salt)


def random_generator(seed: int, device="cpu") -> torch.Generator:
    """The generator a random op draws from, on ``device``: inside an
    executor run, seeded from (``seed`` or the global seed, step, op
    salt); outside, :func:`op_generator`'s."""
    step = getattr(_tls, "step", None)
    if step is None:
        return op_generator(seed, device)
    _tls.salt += 1
    mixed = ((int(seed) or _default_seed) * 0x9E3779B97F4A7C15
             + step * 0xBF58476D1CE4E5B9 + _tls.salt) % (2 ** 63)
    gen = torch.Generator(device=device)
    gen.manual_seed(mixed)
    return gen


def op_generator(seed: int, device) -> torch.Generator:
    """Generator for a random op (dropout). A nonzero ``seed`` attr gives
    the op a stream of its own; 0 draws a fresh seed from the global
    generator, so each call differs (the reference's seed=0 contract)."""
    if not seed:
        seed = int(torch.randint(0, 2 ** 62, (1,),
                                 generator=default_generator()).item())
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen
