"""Cases of the static training surface: one a ``static.nn`` builder
that the static training slice brought to the port, and one a ``nets``
function, each a builder call on seeded ``static.data`` inputs, its feed
and its tolerance; and the ERNIE 1.0 pretraining script.

``tests/test_torch_static_builders.py`` builds each case with both
packages' static API on the CPU (the two programs' JSON must be equal),
runs the JAX package's startup program, carries its values into the
port by name, and runs both executors on the feed. ``chip_smoke.py``
phase ``static_builders`` runs the port's program on the card against
the port on the CPU from the same startup values.

A case is a :class:`BuilderCase`; ``build(api)`` runs inside
``program_guard`` and returns the vars to fetch. Its ``kind`` says how
the fetches are held:

- ``"value"``: integer and bool fetches equal, float fetches within
  ``tol`` (rtol, atol); with ``grad``, also the gradients of the
  parameters the builder created for the mean of the first fetch;
- ``"random"``: a random op whose draws the two packages make from
  different generators (threefry and Philox): the fetches' shapes and
  dtypes and ``check`` (a function of the fetched numpy arrays), across
  the packages and on the card against the CPU (some of these ops key
  their draws on the process's count of their calls, as the JAX
  package's do, so two runs draw differently);
- ``"raises"``: both packages build the program and its run raises
  ``NotFoundError`` (the op type is registered in neither package);
- ``"unbuilt"``: building raises in both packages (``npair_loss`` calls
  ``nn.equal``, which neither package's ``nn`` has: the JAX package's
  builder then meets a name it never imported, the port's raises the
  ``UnimplementedError`` the JAX builder means).

fp32 cases hold at rtol 1e-5 / atol 1e-6, the two libraries differing
only in the order of their sums; a case with another bound says why.

The ERNIE script (:func:`ernie_program`) is written once against an
``api`` namespace (``pt``, ``static``, ``ParamAttr``, ``I`` the
initializer module, ``Adam``, ``static_amp``), so the same code builds
the program in either package: ERNIE 1.0's post-norm encoder with the
``flash_attention`` op in [B, S, H, D], its masked-LM head tied to the
word embedding and its next-sentence head, Adam under the static AMP
``decorate``.
"""
from __future__ import annotations

import types
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from .op_cases import f32, ints, uniform

FP32 = (1e-5, 1e-6)
# a convolution's or a norm's outputs and gradients: sums over the taps
# and the batch in another order (XLA's, torch's CPU kernels, cuDNN's)
CONV = (1e-4, 1e-5)


class BuilderCase(NamedTuple):
    name: str
    build: Callable
    feed: Dict[str, np.ndarray]
    tol: Tuple[float, float] = FP32
    kind: str = "value"
    grad: bool = False
    check: Optional[Callable] = None
    # attrs whose values the two packages number on their own (a
    # py_func callable's registry id), left out of the JSON comparison
    own_attrs: Tuple[str, ...] = ()


def port_api():
    """The port's static training surface as the cases and the ERNIE
    script take it (the CPU tests build the JAX package's)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import static
    from paddle_tpu_torch.amp import static_amp
    from paddle_tpu_torch.nn import ParamAttr
    from paddle_tpu_torch.nn import initializer
    from paddle_tpu_torch.optimizer import Adam
    return types.SimpleNamespace(pt=pt, static=static, ParamAttr=ParamAttr,
                                 I=initializer, Adam=Adam,
                                 static_amp=static_amp)


def build_case(api, case: BuilderCase):
    """(main, startup, fetch names) of ``case`` built with ``api``: the
    builder's fetches, then, with ``grad``, the gradients of the
    parameters for the mean of the first fetch."""
    main, startup = api.pt.Program(), api.pt.Program()
    with api.static.program_guard(main, startup):
        outs = case.build(api)
        fetch = [v.name for v in outs]
        if case.grad:
            loss = api.static.nn.mean(outs[0])
            pgs = api.pt.append_backward(loss)
            fetch += [g if isinstance(g, str) else g.name for _, g in pgs]
    return main, startup, fetch


def _d(api, name, arr):
    """A static.data var of ``arr``'s shape and dtype."""
    return api.static.data(name, list(arr.shape), arr.dtype.name)


def _case(name, build, feed, **kw):
    """A case whose builder takes the data vars of ``feed``, in order."""
    def b(api):
        vs = [_d(api, k, v) for k, v in feed.items()]
        out = build(api.static.nn, api, *vs)
        return list(out) if isinstance(out, (list, tuple)) else [out]
    return BuilderCase(name, b, feed, **kw)


def _py_double(x):
    return np.asarray(x) * 2.0


def _param_cases() -> List[BuilderCase]:
    """``_param_layer_ns``: the weight-creating convolutions and norms
    (``paddle_tpu/static/__init__.py:1216-1350``)."""
    return [
        _case("conv2d_transpose", lambda nn, a, x: nn.conv2d_transpose(
            x, num_filters=4, filter_size=3, stride=2, padding=1, act="relu"),
            {"x": f32(1, 2, 3, 5, 5)}, tol=CONV, grad=True),
        _case("conv3d", lambda nn, a, x: nn.conv3d(
            x, num_filters=3, filter_size=3, padding=1),
            {"x": f32(2, 2, 2, 4, 4, 4)}, tol=CONV),
        _case("layer_norm", lambda nn, a, x: nn.layer_norm(
            x, begin_norm_axis=2, epsilon=1e-12),
            {"x": f32(3, 4, 6, 8, scale=2.0, shift=0.5)}, tol=CONV,
            grad=True),
        _case("group_norm", lambda nn, a, x: nn.group_norm(x, groups=2),
              {"x": f32(4, 2, 4, 3, 3)}, tol=CONV),
        _case("instance_norm", lambda nn, a, x: nn.instance_norm(x),
              {"x": f32(5, 2, 3, 4, 4)}, tol=CONV),
        _case("prelu", lambda nn, a, x: nn.prelu(x, mode="channel"),
              {"x": f32(6, 2, 3, 4)}, grad=True),
    ]


def _simple_cases() -> List[BuilderCase]:
    """``_SIMPLE_LAYERS_2`` (less the two selected-rows builders), the
    ``size`` entry of ``_SIMPLE_LAYERS_3`` and ``cross_entropy2`` of
    ``_SIMPLE_LAYERS_4``."""
    a_ = ints(10, 0, 2, 3, 4).astype(bool)
    b_ = ints(11, 0, 2, 3, 4).astype(bool)
    tags = ints(12, 0, 5, 2, 7)
    probs = np.asarray([[0.1, 0.6, 0.3], [0.0, 0.0, 1.0], [0.5, 0.5, 0.0]],
                       np.float32)
    return [
        _case("logical_and", lambda nn, a, x, y: nn.logical_and(x, y),
              {"x": a_, "y": b_}),
        _case("logical_or", lambda nn, a, x, y: nn.logical_or(x, y),
              {"x": a_, "y": b_}),
        _case("logical_xor", lambda nn, a, x, y: nn.logical_xor(x, y),
              {"x": a_, "y": b_}),
        _case("reduce_all", lambda nn, a, x: nn.reduce_all(x),
              {"x": a_}, kind="raises"),
        _case("reduce_any", lambda nn, a, x: nn.reduce_any(x, dim=[1]),
              {"x": b_}, kind="raises"),
        _case("maxout", lambda nn, a, x: nn.maxout(x, groups=2),
              {"x": f32(13, 2, 4, 3, 3)}),
        _case("im2sequence", lambda nn, a, x: nn.im2sequence(
            x, kernels=[2, 3], strides=[1, 2], paddings=[1, 0, 1, 1]),
            {"x": f32(14, 2, 2, 5, 5)}),
        _case("adaptive_pool2d", lambda nn, a, x: nn.adaptive_pool2d(
            x, pool_size=[2, 3], pool_type="avg"),
            {"x": f32(15, 2, 3, 6, 7)}),
        _case("adaptive_pool3d", lambda nn, a, x: nn.adaptive_pool3d(
            x, pool_size=[2, 2, 3]), {"x": f32(16, 1, 2, 4, 5, 6)}),
        _case("brelu", lambda nn, a, x: nn.brelu(x, t_min=-1.0, t_max=2.0),
              {"x": f32(17, 3, 5, scale=2.0)}),
        _case("soft_relu", lambda nn, a, x: nn.soft_relu(x, threshold=3.0),
              {"x": f32(18, 3, 5, scale=3.0)}),
        _case("hash", lambda nn, a, x: nn.hash(x, num_hash=3, mod_by=1000),
              {"x": np.asarray([[1, -7], [123456789, 2 ** 40 + 5], [0, 0]],
                               np.int64)}),
        _case("sampling_id", lambda nn, a, x: nn.sampling_id(x, seed=5),
              {"x": probs}, kind="random",
              check=lambda o: bool(((o[0] >= 0) & (o[0] < 3)).all()
                                   and o[0][1] == 2 and o[0][2] != 2)),
        _case("mean_iou", lambda nn, a, x, y: nn.mean_iou(
            x, y, num_classes=5),
            {"pred": np.asarray([[0, 1, 1, 3], [3, 3, 0, 1]], np.int32),
             "label": np.asarray([[0, 1, 0, 3], [1, 3, 0, 1]], np.int32)}),
        _case("add_position_encoding",
              lambda nn, a, x: nn.add_position_encoding(x, alpha=0.5,
                                                        beta=2.0),
              {"x": f32(19, 2, 5, 8)}),
        _case("unique", lambda nn, a, x: nn.unique(x),
              {"x": np.asarray([3, 1, 3, 7, 1, 2], np.int64)}),
        _case("unique_with_counts", lambda nn, a, x: nn.unique_with_counts(
            x), {"x": np.asarray([3, 1, 3, 7, 1, 2], np.int64)}),
        _case("random_crop", lambda nn, a, x: nn.random_crop(
            x, shape=[3, 3], seed=7), {"x": f32(20, 2, 5, 5)},
            kind="random", check=lambda o: o[0].shape == (2, 3, 3)),
        _case("similarity_focus", lambda nn, a, x: nn.similarity_focus(
            x, axis=1, indexes=[0, 2]), {"x": f32(21, 2, 3, 4, 5)}),
        _case("scatter_nd", lambda nn, a, i, u: nn.scatter_nd(
            i, u, shape=[3, 3, 3]),
            {"index": np.asarray([[0, 1], [2, 2], [0, 1], [1, 0]], np.int64),
             "updates": f32(22, 4, 3)}),
        _case("filter_by_instag", lambda nn, a, x, t, f: nn.filter_by_instag(
            x, t, f), {"ins": f32(23, 4, 3),
                       "ins_tag": np.asarray([1, 2, 3, 2], np.int64),
                       "filter_tag": np.asarray([2], np.int64)}),
        _case("continuous_value_model",
              lambda nn, a, x: nn.continuous_value_model(x),
              {"x": uniform(24, 0, 5, 4, 5)}),
        _case("uniform_random_batch_size_like",
              lambda nn, a, x: nn.uniform_random_batch_size_like(
                  x, shape=[-1, 6], min=-2.0, max=3.0),
              {"x": f32(25, 5, 2)}, kind="random",
              check=lambda o: o[0].shape == (5, 6) and bool(
                  ((o[0] >= -2.0) & (o[0] <= 3.0)).all())),
        _case("gaussian_random_batch_size_like",
              lambda nn, a, x: nn.gaussian_random_batch_size_like(
                  x, shape=[-1, 400], mean=1.0, std=0.5),
              {"x": f32(26, 3, 2)}, kind="random",
              check=lambda o: o[0].shape == (3, 400)
              and abs(float(o[0].mean()) - 1.0) < 0.1
              and abs(float(o[0].std()) - 0.5) < 0.1),
        _case("chunk_eval", lambda nn, a, x, y: nn.chunk_eval(
            x, y, num_chunk_types=2, chunk_scheme="IOB"),
            {"inference": tags, "label": np.roll(tags, 1, axis=1)}),
        _case("size", lambda nn, a, x: nn.size(x), {"x": f32(27, 3, 4, 2)}),
        _case("cross_entropy2", lambda nn, a, x, y: nn.cross_entropy2(x, y),
              {"x": uniform(28, 0.05, 1.0, 4, 5),
               "y": ints(29, 0, 5, 4, 1)}),
    ]


def _param_2_cases() -> List[BuilderCase]:
    """``_param_layer_ns_2`` (``deformable_roi_pooling`` aside, a
    detection builder) and ``_last_builders``' ``conv3d_transpose`` and
    ``inplace_abn``."""
    lens = np.asarray([2, 3], np.int64)

    def counter(api):
        c = api.static.nn.autoincreased_step_counter(begin=5, step=2)
        return [c]

    def py_func(api):
        x = api.static.data("x", [3, 2], "float32")
        out = api.static.nn.create_tensor("float32", name="py_out")
        api.static.nn.py_func(_py_double, x, out)
        return [out]

    return [
        _case("bilinear_tensor_product",
              lambda nn, a, x, y: nn.bilinear_tensor_product(x, y, size=3),
              {"x": f32(30, 4, 5), "y": f32(31, 4, 2)}, grad=True),
        _case("spectral_norm", lambda nn, a, w: nn.spectral_norm(
            w, dim=1, power_iters=2), {"w": f32(32, 4, 3, 2, 2)}),
        _case("data_norm", lambda nn, a, x: nn.data_norm(x),
              {"x": f32(33, 4, 5)}),
        _case("deformable_conv", lambda nn, a, x, o, m: nn.deformable_conv(
            x, o, m, num_filters=4, filter_size=3, padding=1),
            {"x": f32(34, 1, 3, 6, 6), "offset": f32(35, 1, 18, 6, 6,
                                                     scale=1.5),
             "mask": uniform(36, 0.0, 1.0, 1, 9, 6, 6)}, tol=CONV),
        _case("dice_loss", lambda nn, a, x, y: nn.dice_loss(x, y),
              {"x": uniform(37, 0.0, 1.0, 4, 3), "y": ints(38, 0, 3, 4, 1)}),
        BuilderCase("autoincreased_step_counter", counter, {}),
        _case("rank", lambda nn, a, x: nn.rank(x), {"x": f32(39, 2, 3, 4)}),
        _case("image_resize_short", lambda nn, a, x: nn.image_resize_short(
            x, out_short_len=6), {"x": f32(40, 1, 2, 4, 5)}),
        _case("resize_linear", lambda nn, a, x: nn.resize_linear(
            x, out_shape=[7]), {"x": f32(41, 2, 3, 5)}),
        _case("lod_append", lambda nn, a, x, n: nn.lod_append(x, n),
              {"x": f32(42, 5, 3), "lens": lens}),
        BuilderCase("uniform_random", lambda api: [
            api.static.nn.uniform_random([50, 4], min=-0.5, max=2.0,
                                         seed=3)], {}, kind="random",
            check=lambda o: o[0].shape == (50, 4)
            and bool(((o[0] >= -0.5) & (o[0] <= 2.0)).all())),
        BuilderCase("gaussian_random", lambda api: [
            api.static.nn.gaussian_random([400, 4], mean=-1.0, std=2.0,
                                          seed=4)], {}, kind="random",
            check=lambda o: o[0].shape == (400, 4)
            and abs(float(o[0].mean()) + 1.0) < 0.3
            and abs(float(o[0].std()) - 2.0) < 0.3),
        BuilderCase("py_func", py_func, {"x": f32(43, 3, 2)},
                    own_attrs=("forward_callable_id",)),
        _case("conv3d_transpose", lambda nn, a, x: nn.conv3d_transpose(
            x, num_filters=2, filter_size=2, stride=2),
            {"x": f32(44, 1, 3, 2, 3, 3)}, tol=CONV),
        _case("inplace_abn", lambda nn, a, x: nn.inplace_abn(
            x, act="leaky_relu", act_alpha=0.1),
            {"x": f32(45, 2, 3, 4, 4)}, tol=CONV),
    ]


def _tensor_and_loss_cases() -> List[BuilderCase]:
    """``_module_parity_builders``: the tensor builders and the losses
    from ``square_error_cost`` to ``sampled_softmax_with_cross_entropy``
    (``paddle_tpu/static/__init__.py:2091-2362``)."""

    def create_tensor(api):
        x = api.static.data("x", [2, 3], "float32")
        t = api.static.nn.create_tensor("float32", name="ct_out")
        api.static.assign(x, t)
        return [t]

    def create_global_var(api):
        g = api.static.nn.create_global_var([2, 3], 1.5, "float32",
                                            persistable=True, name="gvar")
        x = api.static.data("x", [2, 3], "float32")
        return [api.static.nn.elementwise_add(g, x)]

    def constants(api):
        nn = api.static.nn
        return [nn.zeros([2, 3], "int64"), nn.ones([3], "float32"),
                nn.eye(3, 4, batch_shape=[2]), nn.range(1, 7, 1.5, "float32")]

    return [
        BuilderCase("create_tensor", create_tensor, {"x": f32(50, 2, 3)}),
        BuilderCase("create_global_var", create_global_var,
                    {"x": f32(51, 2, 3)}),
        BuilderCase("zeros_ones_eye_range", constants, {}),
        _case("fill_constant_batch_size_like",
              lambda nn, a, x: nn.fill_constant_batch_size_like(
                  x, shape=[-1, 4], dtype="float32", value=2.5),
              {"x": f32(52, 3, 2)}),
        _case("square_error_cost", lambda nn, a, x, y: nn.square_error_cost(
            x, y), {"x": f32(53, 4, 3), "y": f32(54, 4, 3)}),
        _case("npair_loss", lambda nn, a, x, y, lab: nn.npair_loss(
            x, y, lab), {"anchor": f32(55, 4, 3), "positive": f32(56, 4, 3),
                         "labels": np.asarray([0, 1, 0, 2], np.float32)},
            kind="unbuilt"),
        _case("center_loss", lambda nn, a, x, y: nn.center_loss(
            x, y, num_classes=3, alpha=0.5),
            {"x": f32(57, 4, 3), "label": ints(58, 0, 3, 4, 1)}),
        _case("hsigmoid", lambda nn, a, x, y: nn.hsigmoid(x, y,
                                                          num_classes=6),
              {"x": f32(59, 4, 3), "label": ints(60, 0, 6, 4, 1)},
              grad=True),
        _case("nce", lambda nn, a, x, y: nn.nce(
            x, y, num_total_classes=10, num_neg_samples=5, seed=7),
            {"x": f32(61, 4, 3), "label": ints(62, 0, 10, 4, 1)},
            kind="random", check=lambda o: o[0].shape == (4, 1)
            and bool(np.isfinite(o[0]).all() and (o[0] > 0).all())),
        _case("sampled_softmax_with_cross_entropy",
              lambda nn, a, x, y: nn.sampled_softmax_with_cross_entropy(
                  x, y, num_samples=4, seed=11),
              {"logits": f32(63, 3, 6), "label": ints(64, 0, 6, 3, 1)},
              kind="random", check=lambda o: o[0].shape == (3, 1)
              and bool(np.isfinite(o[0]).all() and (o[0] >= 0).all())),
    ]


def _nets_cases() -> List[BuilderCase]:
    """``static.nets``: the five composites."""
    def glu(nn, a, x):
        return a.static.nets.glu(x, dim=-1)

    def sdpa(nn, a, q, k, v):
        return a.static.nets.scaled_dot_product_attention(q, k, v,
                                                          num_heads=2)

    return [
        _case("simple_img_conv_pool",
              lambda nn, a, x: a.static.nets.simple_img_conv_pool(
                  x, num_filters=4, filter_size=3, pool_size=2,
                  pool_stride=2, act="relu"),
              {"x": f32(70, 2, 3, 8, 8)}, tol=CONV),
        _case("img_conv_group",
              lambda nn, a, x: a.static.nets.img_conv_group(
                  x, conv_num_filter=[4, 4], pool_size=2, conv_act="relu",
                  conv_with_batchnorm=[True, False], pool_stride=2),
              {"x": f32(71, 2, 3, 6, 6)}, tol=CONV),
        _case("sequence_conv_pool",
              lambda nn, a, x, n: a.static.nets.sequence_conv_pool(
                  x, num_filters=4, filter_size=3, length=n),
              {"x": f32(72, 2, 5, 3), "lens": np.asarray([5, 3], np.int64)},
              grad=True),
        _case("glu", glu, {"x": f32(73, 3, 8)}),
        _case("scaled_dot_product_attention", sdpa,
              {"q": f32(74, 2, 5, 8), "k": f32(75, 2, 5, 8),
               "v": f32(76, 2, 5, 8)}),
    ]


CASES: List[BuilderCase] = (_param_cases() + _simple_cases()
                            + _param_2_cases() + _tensor_and_loss_cases()
                            + _nets_cases())


# ------------------------------------------------------------ ERNIE 1.0
# ERNIE 1.0 base as published in its ernie_config.json
# (PaddlePaddle/ERNIE): 12 layers, hidden 768, 12 heads, FFN 3072 relu,
# vocab 18,000, 513 positions, 2 sentence types, dropout 0.1,
# TruncatedNormal(0.02) for every weight; pretraining batch 16 at seq 512
# with 15% of the tokens masked, Adam at a constant 1e-4 (the static
# optimizer's learning rate is one variable: the warm-up is left out)
ERNIE_BASE = dict(layers=12, hidden=768, heads=12, ffn=3072, act="relu",
                  vocab=18000, positions=513, sent_types=2, dropout=0.1,
                  init_range=0.02, batch=16, seq=512, lr=1e-4)
# the CPU tests' size
ERNIE_TINY = dict(ERNIE_BASE, layers=2, hidden=64, heads=4, ffn=256,
                  vocab=128, positions=32, batch=2, seq=16)
MASK_ID = 3                       # the [MASK] token's id in ERNIE's vocab


def masked_per_seq(seq: int) -> int:
    """15% of a sequence's tokens: 76 at seq 512."""
    return int(0.15 * seq)


def ernie_program(api, cfg, seq=None, dropout=None, amp=True, optimize=True):
    """ERNIE 1.0 pretraining as a fluid script, built with ``api``
    (either package): word, position and sentence embeddings, layer_norm
    and dropout; ``cfg["layers"]`` post-norm blocks (q, k, v ``fc``, the
    non-causal ``flash_attention`` op on [B, S, H, D] with no mask, the
    output ``fc``, dropout, residual, ``layer_norm``, ``fc`` ``ffn`` with
    ``act``, ``fc``, dropout, residual, ``layer_norm``); the masked-LM
    head (the masked rows gathered from the flat [B * S, H] output,
    ``fc`` with ``act``, ``layer_norm``, the output projection tied to
    the word embedding plus a bias, ``softmax_with_cross_entropy``) and
    the next-sentence head (the first token, ``fc`` tanh, ``fc`` 2); the
    loss their sum, minimized by ``Adam(cfg["lr"])``, wrapped by
    ``static_amp.decorate`` (bf16, dynamic loss scaling) when ``amp``;
    with ``optimize`` False, the forward alone. Parameter names are
    ERNIE's. Returns a namespace of the programs, the loss, the two head
    losses, the next-sentence logits (``nsp_logits``, what a served
    export fetches) and the optimizer."""
    seq = seq or cfg["seq"]
    p = cfg["dropout"] if dropout is None else dropout
    st, nn = api.static, api.static.nn
    h, heads = cfg["hidden"], cfg["heads"]
    main, startup = api.pt.Program(), api.pt.Program()

    def attr(name):
        return api.ParamAttr(name=name, initializer=api.I.TruncatedNormal(
            0.0, cfg["init_range"]))

    def drop(x):
        if not p:
            return x
        return nn.dropout(x, dropout_prob=p,
                          dropout_implementation="upscale_in_train")

    def fc(x, size, name, act=None, nfd=2):
        return nn.fc(x, size=size, num_flatten_dims=nfd, act=act,
                     param_attr=attr(name + ".w_0"), bias_attr=name + ".b_0")

    def ln(x, name):
        return nn.layer_norm(
            x, begin_norm_axis=len(x.shape) - 1,
            param_attr=api.ParamAttr(name=name + "_layer_norm_scale",
                                     initializer=api.I.Constant(1.0)),
            bias_attr=api.ParamAttr(name=name + "_layer_norm_bias",
                                    initializer=api.I.Constant(0.0)))

    with st.program_guard(main, startup):
        src = st.data("src_ids", [-1, seq], "int64")
        pos = st.data("pos_ids", [-1, seq], "int64")
        sent = st.data("sent_ids", [-1, seq], "int64")
        mask_pos = st.data("mask_pos", [-1], "int64")
        mask_label = st.data("mask_label", [-1, 1], "int64")
        labels = st.data("labels", [-1, 1], "int64")
        emb = nn.embedding(src, size=[cfg["vocab"], h],
                           param_attr=attr("word_embedding"))
        emb = emb + nn.embedding(pos, size=[cfg["positions"], h],
                                 param_attr=attr("pos_embedding"))
        emb = emb + nn.embedding(sent, size=[cfg["sent_types"], h],
                                 param_attr=attr("sent_embedding"))
        x = drop(ln(emb, "pre_encoder"))
        for i in range(cfg["layers"]):
            name = f"encoder_layer_{i}"
            qkv = []
            for part in ("query", "key", "value"):
                t = fc(x, h, f"{name}_multi_head_att_{part}_fc")
                qkv.append(nn.reshape(t, shape=[0, 0, heads, h // heads]))
            ctx = st._new_tmp(x.block, "flash_attn")
            st._op(x.block, "flash_attention",
                   {"Q": [qkv[0].name], "K": [qkv[1].name],
                    "V": [qkv[2].name]}, {"Out": [ctx.name]},
                   {"causal": False})
            attn = fc(nn.reshape(ctx, shape=[0, 0, h]), h,
                      f"{name}_multi_head_att_output_fc")
            x = ln(x + drop(attn), f"{name}_post_att")
            ffn = fc(x, cfg["ffn"], f"{name}_ffn_fc_0", act=cfg["act"])
            ffn = fc(ffn, h, f"{name}_ffn_fc_1")
            x = ln(x + drop(ffn), f"{name}_post_ffn")
        # masked LM: the masked rows of the flat output, tied decoder
        feat = nn.gather(nn.reshape(x, shape=[-1, h]), mask_pos)
        feat = ln(fc(feat, h, "mask_lm_trans_fc", act=cfg["act"], nfd=1),
                  "mask_lm_trans")
        word = st.create_parameter([cfg["vocab"], h], "float32",
                                   attr="word_embedding")
        bias = st.create_parameter(
            [cfg["vocab"]], "float32", is_bias=True,
            attr=api.ParamAttr(name="mask_lm_out_fc.b_0",
                               initializer=api.I.Constant(0.0)))
        logits = nn.matmul(feat, word, transpose_y=True) + bias
        mlm = nn.mean(nn.softmax_with_cross_entropy(logits, mask_label))
        # next sentence: the first token
        first = nn.reshape(nn.slice(x, axes=[1], starts=[0], ends=[1]),
                           shape=[-1, h])
        pooled = fc(first, h, "pooled_fc", act="tanh", nfd=1)
        nsp_logits = fc(pooled, 2, "next_sent_fc", nfd=1)
        nsp = nn.mean(nn.softmax_with_cross_entropy(nsp_logits, labels))
        loss = mlm + nsp
        opt = api.Adam(learning_rate=cfg["lr"]) if optimize else None
        if amp and optimize:
            opt = api.static_amp.decorate(opt)
        if optimize:
            opt.minimize(loss)
    return types.SimpleNamespace(main=main, startup=startup, loss=loss.name,
                                 mlm=mlm.name, nsp=nsp.name,
                                 nsp_logits=nsp_logits.name, opt=opt)


def ernie_batch(cfg, batch=None, seq=None, seed=0):
    """A seeded pretraining batch as numpy arrays: token ids drawn from
    the vocabulary (all real, no padding), positions 0..seq-1, sentence
    ids 0 then 1 from a random split, ``masked_per_seq`` distinct masked
    positions a sequence (never the first token) replaced by the [MASK]
    id, their flat indices into [batch * seq] and their labels, and a
    next-sentence label a sequence."""
    batch, seq = batch or cfg["batch"], seq or cfg["seq"]
    rs = np.random.RandomState(seed)
    src = rs.randint(5, cfg["vocab"], (batch, seq)).astype(np.int64)
    pos = np.tile(np.arange(seq, dtype=np.int64), (batch, 1))
    split = rs.randint(seq // 4, 3 * seq // 4, batch)
    sent = (np.arange(seq)[None, :] >= split[:, None]).astype(np.int64)
    m = masked_per_seq(seq)
    rows = [np.sort(rs.choice(np.arange(1, seq), m, replace=False))
            for _ in range(batch)]
    mask_pos = np.concatenate([b * seq + r for b, r in enumerate(rows)])
    mask_label = src.reshape(-1)[mask_pos][:, None].copy()
    src.reshape(-1)[mask_pos] = MASK_ID
    labels = rs.randint(0, 2, (batch, 1)).astype(np.int64)
    return {"src_ids": src, "pos_ids": pos, "sent_ids": sent,
            "mask_pos": mask_pos.astype(np.int64),
            "mask_label": mask_label.astype(np.int64), "labels": labels}


def ernie_param_count(cfg) -> int:
    """The parameters of :func:`ernie_program` (the tied decoder counted
    once)."""
    h, f = cfg["hidden"], cfg["ffn"]
    emb = (cfg["vocab"] + cfg["positions"] + cfg["sent_types"]) * h + 2 * h
    block = 4 * (h * h + h) + (h * f + f) + (f * h + h) + 4 * h
    heads = (h * h + h) + 2 * h + cfg["vocab"] + (h * h + h) + (2 * h + 2)
    return emb + cfg["layers"] * block + heads
