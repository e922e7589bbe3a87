"""The eager CycleGAN user script (``chip_smoke.cyclegan_step`` over
``cyclegan_nets``, written once against either package's ``nn`` and
``optimizer``) in the port against the JAX package, on the CPU, at
ngf = ndf = 8, 2 residual blocks, 32 px, batch 1, for 2 steps: the four
networks built by the JAX package from seed 0 and carried into the
port's (``convert.load_state_dict``), the same seeded images.

Bounds (fp32): each step's four losses at rtol 1e-4 (the two frameworks
sum the convolutions and norms in other orders, about 1e-6 of a loss
after the first step); each parameter by the norm of its update error,
||port - JAX|| / ||JAX - start||, at 1e-2 (a ReLU or LeakyReLU input
within rounding of 0 moves a gradient element, and Adam scales a small
gradient element's noise up to the size of the learning rate; a wrong
pad, norm, output_padding or optimizer term moves an update by O(1)).
"""
import types

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import nn as jnn
from paddle_tpu.optimizer import Adam as JaxAdam

import chip_smoke as cs
import paddle_tpu_torch as tpt
from paddle_tpu_torch import nn
from paddle_tpu_torch.convert import load_state_dict

SIZE = dict(ngf=8, ndf=8, blocks=2)
PX, STEPS = 32, 2
LOSS_RTOL, UPDATE_TOL = 1e-4, 1e-2


def _jax_api():
    return types.SimpleNamespace(nn=jnn, Adam=JaxAdam,
                                 to_tensor=jpt.to_tensor,
                                 ones_like=jpt.ones_like,
                                 zeros_like=jpt.zeros_like)


@pytest.fixture(scope="module")
def runs():
    jpt.seed(0)
    jnets = cs.cyclegan_nets(jnn, **SIZE)
    start = [{k: v.numpy().copy() for k, v in n.state_dict().items()}
             for n in jnets]
    tpt.set_device("cpu")
    tnets = cs.cyclegan_nets(nn, **SIZE)
    for net, st in zip(tnets, start):
        load_state_dict(net, st)
    japi, tapi = _jax_api(), cs.port_cyclegan_api()
    jopts, topts = cs.cyclegan_opts(japi, jnets), cs.cyclegan_opts(tapi,
                                                                   tnets)
    rs = np.random.RandomState(0)
    images = [cs.cyclegan_images(rs, 1, PX) for _ in range(STEPS)]
    jl, tl = [], []
    for a, b in images:
        jl.append([float(v.numpy()) for v in cs.cyclegan_step(
            japi, jnets, jopts, jpt.to_tensor(a), jpt.to_tensor(b))])
        tl.append([v.item() for v in cs.cyclegan_step(
            tapi, tnets, topts, torch.from_numpy(a), torch.from_numpy(b))])
    jend = [{k: v.numpy() for k, v in n.state_dict().items()} for n in jnets]
    tend = [{k: v.detach().numpy() for k, v in n.state_dict().items()}
            for n in tnets]
    return start, jl, tl, jend, tend, tnets


def test_networks_have_the_papers_layout(runs):
    """Generator: reflection pad, c7s1, two stride-2 downs, the residual
    blocks, two stride-2 transposed ups (output_padding 1), c7s1-3, Tanh;
    discriminator 32 px -> 2 x 2 patches."""
    *_, tnets = runs
    g, d = tnets[0], tnets[2]
    kinds = [type(m).__name__ for m in g]
    assert kinds[:4] == ["ReflectionPad2d", "Conv2D", "InstanceNorm2D",
                         "ReLU"]
    assert kinds.count("ResBlock") == SIZE["blocks"]
    assert kinds.count("Conv2DTranspose") == 2 and kinds[-1] == "Tanh"
    x = torch.zeros(1, 3, PX, PX)
    with torch.no_grad():
        assert tuple(g(x).shape) == (1, 3, PX, PX)
        assert tuple(d(x).shape) == (1, 1, 2, 2)


def test_losses_match_jax(runs):
    _, jl, tl, *_ = runs
    for step, (j, t) in enumerate(zip(jl, tl)):
        assert all(np.isfinite(t))
        np.testing.assert_allclose(t, j, rtol=LOSS_RTOL,
                                   err_msg=f"step {step}")


def test_parameters_match_jax_by_update_error(runs):
    start, _, _, jend, tend, _ = runs
    errs = {}
    for i, (s, j, t) in enumerate(zip(start, jend, tend)):
        for k in s:
            moved = np.linalg.norm(j[k] - s[k])
            assert moved > 0, (i, k)
            errs[i, k] = float(np.linalg.norm(t[k] - j[k]) / moved)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= UPDATE_TOL, (worst, errs[worst])
