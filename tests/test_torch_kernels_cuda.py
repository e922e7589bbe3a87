"""The flash kernels K1-K3 against their plain PyTorch versions on a CUDA
card (needs a card; skips where there is none).

This file imports torch, the port and chip_smoke.py (for its float64
check) only, so it runs on a machine without JAX:

    python -m pytest tests/test_torch_kernels_cuda.py -m gpu --noconftest

Tolerances: fp32 o, lse and delta at rtol 1e-4 / atol 1e-5 and gradients
at rtol 2e-3 / atol 3e-4 (both sides hold fp32 accuracy: the kernels in
3xTF32, and TF32 is off for the plain version's matmuls); bf16 outputs
round to 8 mantissa bits, so rtol / atol 2e-2, and fp16 outputs to 11,
so 4e-3 (a few fp16 ulps of values near 1); lse is fp32 from the same
widened products in both. Beside the plain version, K1's fp32 o and lse
and K2/K3's fp32 gradients are held against float64 within bounds that
the same kernels in plain TF32 fail.

The static executor's grad ops on the card close the file: the flash
op's reaches K2 and K3, and dropout's reads the mask its forward drew.
"""
import math
import sys
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch.core.enforce import InvalidArgumentError
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import kernels

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (its float64 check and bounds)

BERT_BASE = (16, 128, 128, 12, 64, False)
CASES = [
    # (b, sq, sk, h, d, causal): BERT-base, then tests/test_flash_tpu.py's
    BERT_BASE,
    (1, 256, 256, 4, 64, True),
    (2, 100, 100, 3, 64, False),
    (1, 512, 512, 8, 128, True),
    (2, 100, 100, 3, 64, True),
    (1, 130, 130, 2, 128, False),
    # Sq != Sk, and S that is not a multiple of 16 or 8
    (1, 64, 192, 4, 64, False),
    (1, 64, 192, 4, 64, True),
    (2, 130, 60, 3, 64, False),
    (2, 130, 60, 3, 64, True),
    (1, 130, 60, 2, 128, True),
    (2, 17, 17, 3, 64, True),
    (2, 65, 65, 2, 64, False),
]
TOL = {torch.float32: (dict(rtol=1e-4, atol=1e-5), dict(rtol=2e-3, atol=3e-4)),
       torch.bfloat16: (dict(rtol=2e-2, atol=2e-2), dict(rtol=2e-2, atol=2e-2)),
       torch.float16: (dict(rtol=4e-3, atol=4e-3), dict(rtol=4e-3, atol=4e-3))}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, b, sq, sk, h, d, dtype, seed=11):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, g = (torch.randn(b, sq, h, d, generator=gen, device=dev)
            for _ in range(2))
    k, v = (torch.randn(b, sk, h, d, generator=gen, device=dev)
            for _ in range(2))
    return tuple(t.to(dtype) for t in (q, k, v, g))


def _check_against_plain(q, k, v, g, causal, dtype, o_exact=None):
    """K1-K3 against the plain versions; K1's o against ``o_exact`` where
    given (float64), and so is the plain version's."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    tol_o, tol_g = TOL[dtype]
    launches = fa.flash_fwd.launches
    o, lse = fa.flash_fwd(q, k, v, causal, scale)
    assert fa.flash_fwd.launches == launches + 1
    o_r, lse_r = fa.blockwise_attention(q, k, v, causal=causal, scale=scale)
    if o_exact is None:
        torch.testing.assert_close(o.float(), o_r, **tol_o)
    else:
        for got in (o, o_r):
            torch.testing.assert_close(got.double(), o_exact, **tol_o)
    torch.testing.assert_close(lse, lse_r, rtol=1e-4, atol=1e-5)
    o_r = o_r.to(dtype)
    dq, delta = fa.flash_bwd_dq(q, k, v, o_r, g, lse_r, causal, scale)
    dk, dv = fa.flash_bwd_dkv(q, k, v, g, lse_r, delta, causal, scale)
    dq_r, dk_r, dv_r, delta_r = fa.blockwise_attention_backward(
        q, k, v, o_r, lse_r, g, causal, scale)
    torch.testing.assert_close(delta, delta_r, **tol_o)
    for got, want in ((dq, dq_r), (dk, dk_r), (dv, dv_r)):
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), **tol_g)


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,d,causal", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_kernels_match_plain(cuda, b, sq, sk, h, d, causal, dtype):
    q, k, v, g = _inputs(cuda, b, sq, sk, h, d, dtype)
    _check_against_plain(q, k, v, g, causal, dtype)


@pytest.mark.gpu
def test_sharp_softmax_matches_plain(cuda):
    """q scaled by 8 at BERT-base: scores of spread ~8, so P is nearly
    one-hot and an error in S shows as an error of exp(S). An fp32 o is
    then only as exact as its scores: the plain version's (cuBLAS's FMA
    order) lies up to 0.9 of the o tolerance from float64 here, and K1's
    (3xTF32, its own order) up to 0.5, so each is held to float64 at that
    tolerance rather than one to the other; lse and the gradients to the
    plain version, as in every case."""
    b, sq, sk, h, d, causal = BERT_BASE
    q, k, v, g = _inputs(cuda, b, sq, sk, h, d, torch.float32, seed=5)
    q = q * 8.0
    o_exact, _ = chip_smoke.attention_fp64(q, k, v, causal,
                                           1.0 / math.sqrt(d))
    _check_against_plain(q, k, v, g, causal, torch.float32, o_exact)


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,d,causal",
                         [BERT_BASE, (2, 130, 60, 3, 64, True),
                          (1, 130, 60, 2, 128, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_backward_kernels_bitwise_deterministic(cuda, b, sq, sk, h, d,
                                                causal, dtype):
    """No atomics: two launches on the same inputs give the same bits, K1's
    as well as K2's and K3's (the 3xTF32 kernels on fp32, the wgmma ones
    on bf16 and fp16)."""
    q, k, v, g = _inputs(cuda, b, sq, sk, h, d, dtype)
    scale = 1.0 / math.sqrt(d)
    o, lse = fa.flash_fwd(q, k, v, causal, scale)
    o2, lse2 = fa.flash_fwd(q, k, v, causal, scale)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    runs = []
    for _ in range(2):
        dq, delta = fa.flash_bwd_dq(q, k, v, o, g, lse, causal, scale)
        dk, dv = fa.flash_bwd_dkv(q, k, v, g, lse, delta, causal, scale)
        runs.append((dq, delta, dk, dv))
    for first, second in zip(*runs):
        assert torch.equal(first, second)


@pytest.mark.gpu
def test_16bit_backward_runs_wgmma(cuda):
    """K2 and K3 on bf16 and fp16, D 64 and 128: wgmma (HGMMA) in their
    SASS and no TF32 product; the fp32 instances keep their TF32 HMMA."""
    kernels.library("flash_attention")             # built
    counts = chip_smoke.hmma_counts(kernels._target("flash_attention"))
    for wrapper in ("flash_bwd_dq", "flash_bwd_dkv"):
        for d in (64, 128):
            for dname in ("bf16", "f16"):
                hmma, hgmma, tf32, _ = counts[
                    (chip_smoke.kernel_fn(wrapper, dname), dname, d)]
                assert hgmma > 0 and tf32 == 0, (wrapper, dname, d)
            assert counts[(chip_smoke.KERNEL_FN[wrapper], "f32", d)][2] > 0


# mma3's two lo passes: without them K1-K3 compute in plain TF32
LO_PASSES = ("  if constexpr (A_LO) mma_tf32(c, a.lo, b.hi);\n"
             "  if constexpr (B_LO) mma_tf32(c, a.hi, b.lo);\n")


def _within_fp64_bounds(cuda, q_mul, names):
    errs = chip_smoke.fp64_errors(fa, cuda, q_mul)
    print(f"3xTF32 q*{q_mul:g}: relative Frobenius error {errs}")
    for name in names:
        assert errs[name] <= chip_smoke.fp64_bound(name, q_mul), errs


@pytest.mark.gpu
@pytest.mark.parametrize("q_mul", sorted(chip_smoke.FP64_BOUND))
def test_backward_kernels_hold_fp32_accuracy(cuda, q_mul):
    """K2/K3 against float64 at BERT-base, within a bound that plain TF32
    does not meet (test_fp64_bound_rejects_plain_tf32)."""
    _within_fp64_bounds(cuda, q_mul, ("dq", "dk", "dv"))


@pytest.mark.gpu
@pytest.mark.parametrize("q_mul", sorted(chip_smoke.FP64_BOUND))
def test_forward_kernel_holds_fp32_accuracy(cuda, q_mul):
    """K1's o and lse against float64 at BERT-base, within bounds that
    plain TF32 does not meet."""
    _within_fp64_bounds(cuda, q_mul, ("o", "lse"))


@pytest.mark.gpu
def test_fp64_bound_rejects_plain_tf32(cuda, tmp_path):
    """The same source with mma3's lo passes taken out (plain TF32) fails
    the float64 bound on K1's o and lse and on every gradient: the bounds
    tell 3xTF32 from TF32."""
    src = (kernels.CSRC / "flash_attention.cu").read_text()
    assert src.count(LO_PASSES) == 1
    variant = tmp_path / "flash_attention.cu"
    variant.write_text(src.replace(LO_PASSES, ""))
    kernels.build(sources={"flash_attention": variant})
    try:
        errs = {m: chip_smoke.fp64_errors(fa, cuda, m)
                for m in sorted(chip_smoke.FP64_BOUND)}
    finally:
        kernels.build(["flash_attention"])      # the wrappers' own again
    print(f"plain TF32: relative Frobenius error {errs}")
    for q_mul, by_name in errs.items():
        for name, err in by_name.items():
            assert err > chip_smoke.fp64_bound(name, q_mul), errs


@pytest.mark.gpu
def test_wrapper_raises_instead_of_falling_back(cuda):
    q = torch.zeros(1, 8, 2, 32, device=cuda)      # head dim 32: no kernel
    with pytest.raises(InvalidArgumentError):
        fa.flash_fwd(q, q, q, False, 1.0)
    # contiguous, but 4 bytes past 16-byte alignment: K2 and K3 copy rows
    # 16 bytes at a time
    q = torch.zeros(8 * 2 * 64 + 1, device=cuda)[1:].view(1, 8, 2, 64)
    lse = torch.zeros(1, 2, 8, device=cuda)
    with pytest.raises(InvalidArgumentError):
        fa.flash_bwd_dkv(q, q, q, q, lse, lse, False, 1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", chip_smoke.FLASH_ROUTE_CASES,
                         ids=lambda c: c[0].replace(" ", "_"))
def test_op_feeds_the_kernels_on_the_card(cuda, case):
    """What K1-K3 take only after the op pads or copies it (head dims 32
    and 96, a q that is a view with gaps, an unaligned q), and fp16, goes
    through K1-K3 on the card, each launched once and nothing on the
    blockwise route, and equals the op on the CPU (at the dtype's bounds
    above)."""
    _, b, s, h, d, dtype, layout = case
    gen = torch.Generator().manual_seed(17)
    ts = [torch.randn(b, s, h, d, generator=gen).to(dtype)
          for _ in range(4)]
    o_tol, g_tol = TOL[dtype]
    for causal in (False, True):
        want, cpu_calls, _ = chip_smoke._flash_op(
            fa, torch.device("cpu"), ts, causal, layout)
        got, calls, launches = chip_smoke._flash_op(fa, cuda, ts, causal,
                                                    layout)
        assert (calls, cpu_calls, launches) == (0, 0, [1, 1, 1])
        for name, x, y, tol in zip(("o", "dq", "dk", "dv"), got, want,
                                   (o_tol, g_tol, g_tol, g_tol)):
            torch.testing.assert_close(x, y, msg=name, **tol)


@pytest.mark.gpu
def test_kernels_at_gpt_shape(cuda):
    """Causal, head dim 128, bf16, at GPT-3 1.3B's sequence of 2048 (B1
    H2): K1's grid and lse run over 32 row tiles and the causal skip
    over 32 key tiles. K2/K3's gradients also by relative Frobenius
    error against the plain backward in fp32, within a bound that the
    same backward with its last key tile left out fails."""
    q, k, v, g = _inputs(cuda, 1, 2048, 2048, 2, 128, torch.bfloat16)
    _check_against_plain(q, k, v, g, True, torch.bfloat16)
    scale = 1.0 / math.sqrt(q.shape[-1])
    o, lse = fa.flash_fwd(q, k, v, True, scale)
    dq, delta = fa.flash_bwd_dq(q, k, v, o, g, lse, True, scale)
    got = (dq,) + fa.flash_bwd_dkv(q, k, v, g, lse, delta, True, scale)
    frob, control = chip_smoke.bwd_frobenius(fa, q, k, v, o, lse, g, True,
                                             got)
    assert max(frob.values()) <= chip_smoke.GRAD_FROB_BOUND, frob
    assert min(control.values()) > chip_smoke.GRAD_FROB_BOUND, control


def _block_pair(cuda):
    """A GPTDecoderBlock (head dim 128) on the card and its copy on the
    CPU, from the same weights."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.convert import load_state_dict
    from paddle_tpu_torch.text.models import GPTDecoderBlock
    tpt.set_device("cpu")
    tpt.seed(0)
    cpu = GPTDecoderBlock(256, 2, 512)
    state = {k: v.numpy() for k, v in cpu.state_dict().items()}
    tpt.set_device(cuda)
    return load_state_dict(GPTDecoderBlock(256, 2, 512), state), cpu


@pytest.mark.gpu
def test_gpt_block_launches_the_kernels(cuda):
    """The flash_attention op in a GPTDecoderBlock on the card: K1-K3 once
    each, nothing on the blockwise route, and the block's output and
    gradients equal its CPU copy's (fp32 bounds above)."""
    card, cpu = _block_pair(cuda)
    x = torch.randn(2, 256, 256, generator=torch.Generator().manual_seed(3))
    launches = [w.launches for w in fa.WRAPPERS]
    calls = fa.blockwise_route.calls
    got = []
    for model, dev in ((card, cuda), (cpu, torch.device("cpu"))):
        xi = x.to(dev).requires_grad_()
        out = model(xi)
        (out * out).sum().backward()
        got.append([t.detach().cpu() for t in
                    (out, xi.grad, model.attn.q_weight.grad)])
    assert [w.launches - n for w, n in zip(fa.WRAPPERS, launches)] == \
        [1, 1, 1]
    assert fa.blockwise_route.calls == calls
    tol_o, tol_g = TOL[torch.float32]
    torch.testing.assert_close(got[0][0], got[1][0], **tol_o)
    for a, b in zip(got[0][1:], got[1][1:]):
        torch.testing.assert_close(a, b, **tol_g)


@pytest.mark.gpu
def test_cached_decode_on_the_card(cuda):
    """gpt_tiny on the card: a prompt of 16 through the blocks with
    fresh caches, then 8 single-token steps on the q_offset route, equal
    to the uncached forward on the card (fp32 bounds above)."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.text import gpt_tiny
    tpt.set_device(cuda)
    tpt.seed(0)
    model = gpt_tiny().eval()
    ids = torch.randint(0, 1024, (2, 24), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(4))
    calls = fa.blockwise_route.calls
    with torch.no_grad():
        cached = chip_smoke.gpt_cached_logits(model, ids, 16)
        full = model(ids)
    assert fa.blockwise_route.calls == calls + 8 * 2
    torch.testing.assert_close(cached, full, **TOL[torch.float32][0])


@pytest.mark.gpu
def test_static_grad_op_reaches_the_kernels(cuda):
    """chip_smoke phase static_flash: a static program of one
    flash_attention op (BERT-base shape, bf16) and mean, with
    append_backward on q, k and v: K1 launches in the forward op and K2
    and K3 in its grad op, once each a run, and o, dq, dk and dv equal
    the dygraph op's bit for bit."""
    import paddle_tpu_torch as tpt
    tpt.set_device("cuda")
    deltas, static, dygraph = chip_smoke.static_flash_run(tpt, cuda)
    assert deltas == [[1, 1, 1], [1, 1, 1]]
    for got, want in zip(static, dygraph):
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 7])
def test_static_dropout_grad_uses_the_forward_mask(cuda, seed):
    """A static dropout on the card, by the grad-op record route and the
    recompute route: W@GRAD and b@GRAD are the gradients of the mask the
    forward drew (rtol 1e-5 against float64; TF32 is off), the two routes
    draw the same mask and give the same gradients, and the next step
    draws another mask."""
    import numpy as np
    import paddle_tpu_torch as tpt
    tpt.set_device("cuda")
    x = np.random.RandomState(1).randn(8, 16).astype(np.float32)
    got = {}
    for route in ("record", "recompute"):
        prog, startup, names = chip_smoke.static_dropout_program(
            chip_smoke.port_static_api(), seed, "upscale_in_train")
        tpt.seed(3)
        scope, exe = tpt.Scope(), tpt.Executor()
        exe._force_recompute = route == "recompute"
        exe.run(startup, scope=scope)
        got[route] = [chip_smoke.static_dropout_step(
            lambda *a, **k: exe.run(*a, scope=scope, **k), prog, names, x,
            "upscale_in_train") for _ in range(2)]
    for steps in got.values():
        assert not np.array_equal(steps[0][0], steps[1][0])
        for m, grads, want in steps:
            assert 0 < m.sum() < m.size
            for g, w in zip(grads, want):
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)
    for (rm, rg, _), (cm, cg, _) in zip(got["record"], got["recompute"]):
        np.testing.assert_array_equal(rm, cm)
        for a, b in zip(rg, cg):
            np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_native_feeder_builds_into_build_and_feeds_the_card(cuda, tmp_path):
    """The port's native MultiSlot feeder on the card machine: g++ builds
    it from the port's own source into build/paddle_tpu_torch/ (nothing
    beside the source), a QueueDataset reads a small file through it
    (each batch counted), and the executor's run on the card sums what it
    fed, equal to the file's numbers."""
    import numpy as np
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch import native, static
    from paddle_tpu_torch.observability import metrics
    path = tmp_path / "part-0.txt"
    path.write_text("".join(f"2 {i}.5 -{i} 2 {i} {i + 7} 1 {i % 2}\n"
                            for i in range(10)))
    assert native.available()
    lib = native.library_path()
    assert lib.exists() and lib.parent == native.BUILD_DIR
    assert not list(native._SRC.parent.parent.rglob("*.so"))
    tpt.set_device("cuda")
    main = tpt.Program()
    with static.program_guard(main, tpt.Program()):
        d = static.data("d", [-1, 2], "float32")
        s = static.data("s", [-1, 2], "int64")
        lab = static.data("l", [-1, 1], "int64")
        total = static.nn.reduce_sum(d)
    ds = tpt.DatasetFactory().create_dataset("QueueDataset")
    ds.set_batch_size(4)
    ds.set_filelist([str(path)])
    ds.set_use_var([d, s, lab])
    before = metrics.metric_get("dataset/native_batches") or 0
    hist = tpt.Executor().train_from_dataset(main, ds, scope=tpt.Scope(),
                                             fetch_list=[total],
                                             print_period=1)
    assert metrics.metric_get("dataset/native_batches") - before == 3
    want = [sum(i + 0.5 - i for i in range(lo, min(lo + 4, 10)))
            for lo in (0, 4, 8)]
    np.testing.assert_allclose(hist[total.name], want, rtol=1e-6)


@pytest.mark.gpu
def test_exported_ernie_launches_k1(cuda, tmp_path):
    """chip_smoke phase export_serve at ERNIE_TINY: the forward saved by
    save_inference_model, exported on the card by
    inference.export_stablehlo into a torch.export archive and loaded by
    load_exported: a call launches K1 once a layer (the archive's graph
    calls the paddle_tpu_torch::flash_fwd custom op), nothing takes the
    blockwise route, and the outputs equal Predictor's run of the
    directory within 1e-5 relative."""
    import numpy as np
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch import inference, io
    from paddle_tpu_torch.testing import static_cases as sc
    cfg = sc.ERNIE_TINY
    tpt.set_device("cuda")
    built = sc.ernie_program(sc.port_api(), cfg, dropout=0, amp=False,
                             optimize=False)
    exe, scope = tpt.Executor(), tpt.Scope()
    exe.run(built.startup, scope=scope)
    feeds = ["src_ids", "pos_ids", "sent_ids"]
    path = str(tmp_path / "ernie")
    with tpt.scope_guard(scope):
        io.save_inference_model(
            path, feeds, [built.main.global_block().var(built.nsp_logits)],
            exe, main_program=built.main, scope=scope)
    feed = chip_smoke.ernie_serve_feeds(cfg, 2, cfg["seq"], 0)
    pt2 = str(tmp_path / "ernie.pt2")
    inference.export_stablehlo(path, {n: (2, cfg["seq"]) for n in feeds},
                               pt2, {n: "int64" for n in feeds})
    call = inference.load_exported(pt2)
    launches, calls = fa.flash_fwd.launches, fa.blockwise_route.calls
    got = call(*[torch.from_numpy(feed[n]).to(cuda) for n in feeds])
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches - launches == cfg["layers"]
    assert fa.blockwise_route.calls == calls
    want, = inference.create_predictor(inference.Config(path)).run(
        [feed[n] for n in feeds])
    np.testing.assert_allclose(got[0].cpu().numpy(), want, rtol=1e-5,
                               atol=1e-7)
