"""Static programs of the decoders slice, built by either package.

The builders take an ``api`` namespace (:func:`port_api` gives the
port's; the CPU tests hand them the JAX package's) and write the same
program JSON in both packages:

- :func:`training_decoder_program` and :func:`beam_decoder_program`: the
  contrib decoder's two programs of ``tests/test_contrib_decoder.py``
  (the reference's own usage, ``test_beam_search_decoder.py``, at tiny
  dims): one ``StateCell`` drives the teacher-forced ``TrainingDecoder``
  (over ``DynamicRNN`` on ragged LoD feeds, trained by Adagrad) and the
  ``BeamSearchDecoder`` (a ``While`` over tensor arrays,
  ``sequence_expand``, ``lod_reset``, ``topk`` and ``beam_search`` on
  level-2 LoD feeds, then ``beam_search_decode``);
- :func:`rnn_program`: the ``rnn``, ``birnn`` and ``dynamic_decode``
  programs of ``tests/test_module_builders.py:134-290``, with and
  without ``sequence_length``;
- :data:`CONTRIB`: one case of each ``contrib_layers`` builder whose op
  type the port registers (the cases of ``tests/test_contrib_layers.py``).

:func:`run_program` runs a built program from given startup values in a
package's executor, so the tests and ``chip_smoke.py`` hold one run
against another.
"""
from __future__ import annotations

import types

import numpy as np

DICT, WORD_DIM, HIDDEN, BATCH, BEAM, MAX_LEN, END_ID = 40, 8, 8, 2, 2, 5, 1
TRAIN_STEPS = 4
# (source ids, target ids, next-word labels), two sentences of a batch
TRAIN_DATA = [([2, 3, 4], [7, 8], [8, 1]),
              ([5, 6], [9, 10, 11], [10, 11, 1])]


def port_api():
    """The port's static surface as the builders take it."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import static
    from paddle_tpu_torch.nn import ParamAttr
    from paddle_tpu_torch.optimizer import Adagrad
    from paddle_tpu_torch.static import contrib_layers, decoder
    return types.SimpleNamespace(pt=pt, static=static, decoder=decoder,
                                 contrib_layers=contrib_layers,
                                 ParamAttr=ParamAttr, Adagrad=Adagrad)


def _lod(lengths):
    out = [0]
    for n in lengths:
        out.append(out[-1] + n)
    return out


# ------------------------------------------------------ contrib decoder
def _encoder(api):
    """The source sentences (ragged scalar steps, declared [batch, time]
    as fluid's ``layers.data(shape=[1], lod_level=1)`` does) through an
    embedding, a tanh fc, ``dynamic_lstm`` and its last step."""
    nn = api.static.nn
    src = api.static.data("src_word", [-1, -1], "int64", lod_level=1)
    emb = nn.embedding(input=src, size=[DICT, WORD_DIM], dtype="float32")
    fc1 = nn.fc(input=emb, size=HIDDEN * 4, act="tanh")
    h, _ = nn.dynamic_lstm(input=fc1, size=HIDDEN * 4)
    return nn.sequence_last_step(input=h)


def _state_cell(api, context):
    dec = api.decoder
    h = dec.InitState(init=context, need_reorder=True)
    cell = dec.StateCell(inputs={"x": None}, states={"h": h},
                         out_state="h")

    @cell.state_updater
    def updater(cell):
        cur = cell.get_input("x")
        prev = cell.get_state("h")
        cell.set_state("h", api.static.nn.fc(input=[prev, cur],
                                             size=HIDDEN, act="tanh"))

    return cell


def training_decoder_program(api):
    """The teacher-forced decoder over the encoder's last state, its
    cross-entropy mean and an Adagrad(1e-2) update: (main, startup,
    [loss name])."""
    st, nn = api.static, api.static.nn
    main, startup = api.pt.Program(), api.pt.Program()
    with st.program_guard(main, startup):
        cell = _state_cell(api, _encoder(api))
        trg = st.data("trg_word", [-1, -1], "int64", lod_level=1)
        trg_emb = nn.embedding(input=trg, size=[DICT, WORD_DIM],
                               dtype="float32")
        decoder = api.decoder.TrainingDecoder(cell)
        with decoder.block():
            cur = decoder.step_input(trg_emb)
            decoder.state_cell.compute_state(inputs={"x": cur})
            score = nn.fc(input=decoder.state_cell.get_state("h"),
                          size=DICT, act="softmax")
            decoder.state_cell.update_states()
            decoder.output(score)
        rnn_out = decoder()
        label = st.data("next_word", [-1, -1], "int64", lod_level=1)
        avg = nn.mean(x=nn.cross_entropy(input=rnn_out, label=label))
        api.Adagrad(learning_rate=1e-2).minimize(avg)
    return main, startup, [avg.name]


def training_feeds():
    """The LoD feeds of :data:`TRAIN_DATA`: {name: (ids [N, 1], LoD)}."""
    out = {}
    for j, name in enumerate(("src_word", "trg_word", "next_word")):
        seqs = [row[j] for row in TRAIN_DATA]
        out[name] = (np.concatenate(seqs).reshape(-1, 1).astype(np.int64),
                     [_lod([len(s) for s in seqs])])
    return out


def beam_decoder_program(api):
    """The beam-search decoder over the same StateCell: (main, startup,
    [sentence ids, sentence scores])."""
    st = api.static
    main, startup = api.pt.Program(), api.pt.Program()
    with st.program_guard(main, startup):
        cell = _state_cell(api, _encoder(api))
        init_ids = st.data("init_ids", [-1, 1], "int64", lod_level=2)
        init_scores = st.data("init_scores", [-1, 1], "float32",
                              lod_level=2)
        decoder = api.decoder.BeamSearchDecoder(
            state_cell=cell, init_ids=init_ids, init_scores=init_scores,
            target_dict_dim=DICT, word_dim=WORD_DIM, input_var_dict={},
            topk_size=10, sparse_emb=False, max_len=MAX_LEN,
            beam_size=BEAM, end_id=END_ID)
        decoder.decode()
        ids, scores = decoder()
    return main, startup, [ids.name, scores.name]


def beam_feeds():
    """The source sentences and each source's start (id 0, score 1) on a
    level-2 LoD, as the reference test feeds them."""
    lod = [list(range(BATCH + 1)), list(range(BATCH + 1))]
    src = np.array([[2], [3], [4], [5], [6]], np.int64)
    return {"src_word": (src, [_lod([3, 2])]),
            "init_ids": (np.zeros((BATCH, 1), np.int64), lod),
            "init_scores": (np.ones((BATCH, 1), np.float32), lod)}


# ------------------------------------------------ rnn / birnn / decode
RNN_D = 4


def _add_cell(api, d, act):
    nn = api.static.nn

    def cell(x_t, states, **kw):
        if states is None:
            states = nn.fill_constant_batch_size_like(
                x_t, [-1, d], "float32", 0.0)
        h = nn.elementwise_add(x_t, states)
        h = nn.tanh(h) if act else h
        return h, h
    return cell


class _ChainDecoder:
    """test_dynamic_decode_greedy's Decoder: an argmax chain over a fed
    transition matrix."""

    def __init__(self, api, vocab):
        self.api, self.vocab = api, vocab

    def initialize(self, inits):
        start = self.api.static.fill_constant([2, 1], "int64", 1)
        return start, inits, None

    def step(self, time, inputs, states, **kw):
        nn = self.api.static.nn
        emb = nn.one_hot(inputs, depth=self.vocab)
        logits = nn.matmul(nn.reshape(emb, shape=[2, self.vocab]), states)
        nxt = nn.reshape(nn.argmax(logits, axis=-1), shape=[2, 1])
        return nxt, states, nxt, None


RNN_KINDS = ("rnn", "rnn_sequence_length", "birnn",
             "birnn_sequence_length", "dynamic_decode")


def rnn_program(api, kind):
    """One of :data:`RNN_KINDS`: (main, startup, fetch names, feed)."""
    st, nn = api.static, api.static.nn
    main, startup = api.pt.Program(), api.pt.Program()
    rs = np.random.RandomState(1)
    with st.program_guard(main, startup):
        if kind == "dynamic_decode":
            vocab = 5
            trans = st.data("dd_t", [vocab, vocab], "float32")
            outs, _ = nn.dynamic_decode(_ChainDecoder(api, vocab),
                                        inits=trans, max_step_num=3)
            tm = np.zeros((vocab, vocab), np.float32)
            for i in range(vocab):
                tm[i, (i + 2) % vocab] = 1.0       # 1 -> 3 -> 0 -> 2
            return main, startup, [outs.name], {"dd_t": tm}
        x = st.data("rc_x", [2, 4, RNN_D], "float32")
        feed = {"rc_x": rs.randn(2, 4, RNN_D).astype(np.float32)}
        kw = {}
        if kind.endswith("sequence_length"):
            kw["sequence_length"] = st.data("rc_len", [2], "int64")
            feed["rc_len"] = np.array([4, 2], np.int64)
        if kind.startswith("birnn"):
            seq, (fw, bw) = nn.birnn(_add_cell(api, RNN_D, True),
                                     _add_cell(api, RNN_D, False), x, **kw)
            fetch = [seq.name, fw.name, bw.name]
        else:
            seq, last = nn.rnn(_add_cell(api, RNN_D, True), x, **kw)
            fetch = [seq.name, last.name]
    return main, startup, fetch, feed


# --------------------------------------------------- contrib_layers
def _contrib(kind, build, feed, params=None, runs=1, check="value"):
    return dict(kind=kind, build=build, feed=feed, params=params or {},
                runs=runs, check=check)


def _c_fused_elemwise(api):
    st, cl = api.static, api.contrib_layers
    x = st.data("x", [-1, 4], "float32")
    y = st.data("y", [-1, 4], "float32")
    return [cl.fused_elemwise_activation(x, y, ["elementwise_add",
                                                "relu"])]


def _c_partial(api):
    st, cl = api.static, api.contrib_layers
    a = st.data("a", [-1, 4], "float32")
    b = st.data("b", [-1, 4], "float32")
    return [cl.partial_concat([a, b], start_index=1, length=2),
            cl.partial_sum([a, b], start_index=1, length=2)]


def _c_shuffle(api):
    x = api.static.data("x", [-1, 2], "float32")
    return [api.contrib_layers.shuffle_batch(x, seed=5)]


def _c_batch_fc(api):
    x = api.static.data("x", [1, 3, 4], "float32")
    return [api.contrib_layers.batch_fc(
        x, param_size=[1, 4, 2], param_attr="w2", bias_size=[1, 2],
        bias_attr="b2")]


def _c_match_topk(api):
    st, nn, cl = api.static, api.static.nn, api.contrib_layers
    x = st.data("x", [5, 3], "float32")
    y = st.data("y", [4, 3], "float32")
    row = st.data("row", [1], "int32")
    col = st.data("col", [1], "int32")
    mm, _ = cl.match_matrix_tensor(nn.reshape(x, [1, 5, 3]),
                                   nn.reshape(y, [1, 4, 3]), channel_num=2)
    return [mm, cl.sequence_topk_avg_pooling(mm, row, col, topks=[1, 3],
                                             channel_num=2)]


def _c_var_conv(api):
    st = api.static
    x = st.data("x", [2, 1, 6, 6], "float32")
    row = st.data("row", [2], "int32")
    col = st.data("col", [2], "int32")
    return [api.contrib_layers.var_conv_2d(x, row, col, input_channel=1,
                                           output_channel=3,
                                           filter_size=3)]


def _c_tree_conv(api):
    st = api.static
    nodes = st.data("nodes", [1, 4, 3], "float32")
    edges = st.data("edges", [1, 3, 2], "int32")
    return [api.contrib_layers.tree_conv(nodes, edges, output_size=5,
                                         num_filters=2, max_depth=2)]


def _c_fused_emb(api):
    ids = api.static.data("ids", [-1, 4], "int64")
    return [api.contrib_layers.fused_embedding_seq_pool(
        ids, size=[10, 3], param_attr="emb_w")]


def _c_nms2(api):
    st = api.static
    boxes = st.data("boxes", [1, 6, 4], "float32")
    scores = st.data("scores", [1, 3, 6], "float32")
    return list(api.contrib_layers.multiclass_nms2(
        boxes, scores, score_threshold=0.1, nms_top_k=5, keep_top_k=5,
        background_label=-1, return_index=True))


def _c_sparse_emb(api):
    ids = api.static.data("ids", [-1, 1], "int64")
    return [api.contrib_layers.sparse_embedding(ids, size=[20, 4])]


def _c_tdm_child(api):
    x = api.static.data("x", [2], "int32")
    return list(api.contrib_layers.tdm_child(x, node_nums=6, child_nums=2,
                                             param_attr="tree_info"))


def _c_tdm_sampler(api):
    x = api.static.data("x", [3], "int32")
    outs, labels, masks = api.contrib_layers.tdm_sampler(
        x, neg_samples_num_list=[2, 2], layer_node_num_list=[2, 4],
        leaf_node_num=4, tree_travel_attr="travel",
        tree_layer_attr="layer_tab", seed=7)
    return [outs[0], outs[1], labels[0], masks[0]]


def _c_rank_attention(api):
    st = api.static
    x = st.data("x", [2, 3], "float32")
    offset = st.data("rank_offset", [2, 7], "int32")
    return [api.contrib_layers.rank_attention(
        x, offset, rank_param_shape=[27, 2], rank_param_attr="rank_w",
        max_rank=3)]


def _c_bilateral(api):
    st = api.static
    x = st.data("x", [1, 2, 4, 4], "float32")
    guide = st.data("guide", [1, 4, 4], "float32")
    grid = st.data("grid", [1, 6, 2, 2, 2], "float32")
    return [api.contrib_layers.bilateral_slice(x, guide, grid,
                                               has_offset=True)]


def _c_correlation(api):
    st = api.static
    x = st.data("x", [1, 2, 5, 5], "float32")
    y = st.data("y", [1, 2, 5, 5], "float32")
    return [api.contrib_layers.correlation(
        x, y, pad_size=1, kernel_size=1, max_displacement=1, stride1=1,
        stride2=1)]


def _c_fused_bn(api):
    st = api.static
    x = st.data("x", [2, 3, 4, 4], "float32")
    y = st.data("y", [2, 3, 4, 4], "float32")
    return [api.contrib_layers.fused_bn_add_act(x, y)]


def _c_ctr(api):
    st = api.static
    p = st.data("p", [-1, 1], "float32")
    lbl = st.data("l", [-1, 1], "float32")
    return list(api.contrib_layers.ctr_metric_bundle(p, lbl))


def _contrib_cases():
    rs = np.random.RandomState(0)

    def r(*shape):
        return rs.rand(*shape).astype(np.float32)

    info = np.array([[0, 0, 0, 1, 2], [1, 1, 0, 3, 4], [2, 1, 0, 5, 0],
                     [3, 2, 1, 0, 0], [4, 2, 1, 0, 0], [5, 2, 2, 0, 0]],
                    np.int32)
    offset = np.array([[1, 0, 0, 1, 1, 2, 0], [2, 0, 0, 1, 1, -1, -1]],
                      np.int32)
    return {
        "fused_elemwise_activation": _contrib(
            "value", _c_fused_elemwise, {"x": r(2, 4) - 0.5,
                                         "y": r(2, 4) - 0.5}),
        "partial_concat_and_sum": _contrib(
            "value", _c_partial,
            {"a": np.arange(8, dtype=np.float32).reshape(2, 4),
             "b": np.arange(8, dtype=np.float32).reshape(2, 4) + 10}),
        "shuffle_batch": _contrib(
            "random", _c_shuffle,
            {"x": np.arange(12, dtype=np.float32).reshape(6, 2)},
            check="rows"),
        "batch_fc": _contrib("value", _c_batch_fc, {"x": r(1, 3, 4)}),
        "match_matrix_topk_pooling": _contrib(
            "value", _c_match_topk,
            {"x": r(5, 3), "y": r(4, 3), "row": np.array([5], np.int32),
             "col": np.array([4], np.int32)}),
        "var_conv_2d": _contrib(
            "value", _c_var_conv,
            {"x": r(2, 1, 6, 6), "row": np.array([6, 3], np.int32),
             "col": np.array([6, 2], np.int32)}),
        "tree_conv": _contrib(
            "value", _c_tree_conv,
            {"nodes": r(1, 4, 3),
             "edges": np.array([[[0, 1], [0, 2], [1, 3]]], np.int32)}),
        "fused_embedding_seq_pool": _contrib(
            "value", _c_fused_emb,
            {"ids": np.array([[1, 2, 0, 0], [3, 0, 0, 0]], np.int64)}),
        "multiclass_nms2": _contrib(
            "value", _c_nms2, {"boxes": r(1, 6, 4) * 10,
                               "scores": r(1, 3, 6)}),
        "sparse_embedding": _contrib(
            "value", _c_sparse_emb,
            {"ids": np.array([[1], [2]], np.int64)}),
        "tdm_child": _contrib(
            "value", _c_tdm_child, {"x": np.array([0, 1], np.int32)},
            params={"tree_info": info}),
        "tdm_sampler": _contrib(
            "random", _c_tdm_sampler, {"x": np.array([0, 2, 3], np.int32)},
            params={"travel": np.array([[1, 3], [1, 4], [2, 5], [2, 6]],
                                       np.int32),
                    "layer_tab": np.arange(1, 7, dtype=np.int32)},
            check="tdm"),
        "rank_attention": _contrib(
            "value", _c_rank_attention,
            {"x": r(2, 3), "rank_offset": offset}),
        "bilateral_slice": _contrib(
            "value", _c_bilateral, {"x": r(1, 2, 4, 4),
                                    "guide": r(1, 4, 4),
                                    "grid": r(1, 6, 2, 2, 2)}),
        "correlation": _contrib(
            "value", _c_correlation, {"x": r(1, 2, 5, 5),
                                      "y": r(1, 2, 5, 5)}),
        "fused_bn_add_act": _contrib(
            "value", _c_fused_bn, {"x": r(2, 3, 4, 4), "y": r(2, 3, 4, 4)}),
        "ctr_metric_bundle": _contrib(
            "value", _c_ctr, {"p": np.array([[0.2], [0.8]], np.float32),
                              "l": np.array([[0.0], [1.0]], np.float32)},
            runs=2),
    }


CONTRIB = _contrib_cases()


def contrib_program(api, name):
    """:data:`CONTRIB` case ``name`` built with ``api``: (main, startup,
    fetch names)."""
    main, startup = api.pt.Program(), api.pt.Program()
    with api.static.program_guard(main, startup):
        outs = CONTRIB[name]["build"](api)
    return main, startup, [v.name for v in outs]


# ---------------------------------------------------------------- runs
def startup_values(startup):
    """The port's CPU run of a startup program (either package's, by its
    JSON): {var name: numpy array}."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.program import Program
    prog = Program.from_json(startup.to_json())
    scope = pt.Scope()
    pt.Executor("cpu").run(prog, scope=scope)
    out = {}
    for n in prog.global_block().vars:
        var = scope.find_var(n)
        if var is not None and var.is_initialized():
            out[n] = var.get().value.numpy()
    return out


def run_program(api, exe, tensor, main, values, feed, fetch, runs=1):
    """``main`` in ``exe`` (either package's) ``runs`` times on ``feed``
    in a fresh scope holding ``values`` ({name: array}); ``tensor(value,
    lod)`` makes the package's TpuTensor on the executor's device, and a
    feed given as (value, LoD) is fed with its LoD. Returns, for each
    run, the fetches as (numpy array, LoD) pairs."""
    scope = api.pt.Scope()
    feed = {k: tensor(*v) if isinstance(v, tuple) else tensor(v, None)
            for k, v in feed.items()}
    out = []
    with api.pt.scope_guard(scope):
        for k, v in values.items():
            scope.var(k).set(tensor(v, None))
        for _ in range(runs):
            got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                          return_numpy=False)
            # a JAX fetch's lod is a method, the port's an attribute
            out.append([(np.asarray(v.numpy()),
                         v.lod() if callable(v.lod) else v.lod)
                        for v in got])
    return out
