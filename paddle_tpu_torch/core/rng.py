"""Seeding over explicit ``torch.Generator`` objects.

Port of ``paddle_tpu/core/rng.py``. The JAX package folds (seed, step,
op salt) into a PRNG key because a jitted block is traced once; torch
runs eagerly, so a generator that advances with every draw gives fresh
numbers each step by itself. Initializers draw on the CPU from
:func:`default_generator` and the layer moves the result to its device,
so one seed gives the same weights on every device.

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


def global_seed(seed: int):
    """paddle.seed parity: reseed this thread's generator."""
    default_generator().manual_seed(int(seed))


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
