"""The port's ``dataset.py``, ``native/`` MultiSlot feeder,
``incubate/data_generator.py``, ``trainer.py`` and
``Executor.train_from_dataset`` / ``infer_from_dataset`` against the JAX
package's, on the CPU.

Tolerances: batches, records, generated text and trainer descs are
compared exactly (a parser or a shuffle computes no float); the loss
histories of ``train_from_dataset`` at rtol 1e-5 and the parameters
after a pass by the norm of their update error at 1e-4 (fp32, two
frameworks summing in other orders; Adam turns a gradient's rounding
noise into up to a learning rate of update); an inference pass leaves
the parameters bit for bit.

The tiny CTR-DNN is ``chip_smoke.ctr_dnn_program`` (the card's Drive B)
at a 1,001 x 4 embedding and one fc of 16, its data written by
``chip_smoke.criteo_generator``. Both executors start from the port's
startup values, carried into the JAX scope by name, so no JAX startup
program compiles.
"""
import io as _io
import types

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu.static as jstatic
from paddle_tpu import dataset as jdataset
from paddle_tpu import trainer as jtrainer
from paddle_tpu.core.enforce import EnforceNotMet as JaxEnforceNotMet
from paddle_tpu.incubate import data_generator as jdg
from paddle_tpu.nn import ParamAttr as JaxParamAttr
from paddle_tpu.nn import initializer as jinit
from paddle_tpu.optimizer import Adam as JaxAdam

import chip_smoke
import paddle_tpu_torch as tpt
from paddle_tpu_torch import dataset as pdataset
from paddle_tpu_torch import static as pstatic
from paddle_tpu_torch import trainer as ptrainer
from paddle_tpu_torch.core.enforce import EnforceNotMet as PortEnforceNotMet
from paddle_tpu_torch.incubate import data_generator as pdg
from paddle_tpu_torch.observability import metrics as pmetrics
from paddle_tpu_torch.testing import static_cases

JAX_API = types.SimpleNamespace(pt=jpt, static=jstatic,
                                ParamAttr=JaxParamAttr, I=jinit, Adam=JaxAdam)
PORT_API = static_cases.port_api()
DATASETS = {"jax": jdataset, "port": pdataset}
LOSS_RTOL = 1e-5
UPDATE_TOL = 1e-4
TINY_CTR = dict(vocab=1001, emb=4, hidden=(16,), batch=20, rows=60, files=2)


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")


def multislot_file(path, rows=18, seed=0):
    """Lines of a dense slot of 2, a sparse slot of 0-5 feasigns (its
    declared dim 3 truncates and pads) and a label."""
    rs = np.random.RandomState(seed)
    with open(path, "w") as f:
        for _ in range(rows):
            k = rs.randint(0, 6)
            f.write("2 %s %s %d%s 1 %d\n" % (
                "%.6f" % rs.randn(), "%.6f" % rs.rand(), k,
                "".join(" %d" % rs.randint(0, 10 ** 6) for _ in range(k)),
                rs.randint(0, 2)))
    return str(path)


SLOTS = [("d", "float32", 2), ("s", "int64", 3), ("l", "int64", 1)]


def dataset(mod, kind, files, threads=1, batch=4, pipe=None, slots=SLOTS):
    ds = mod.DatasetFactory().create_dataset(kind)
    ds.set_batch_size(batch)
    ds.set_thread(threads)
    ds.set_filelist(files)
    ds.set_use_var(slots)
    if pipe:
        ds.set_pipe_command(pipe)
    return ds


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            assert np.array_equal(g[k], w[k]), k


def test_native_python_and_reference_batches_bit_equal(tmp_path):
    """QueueDataset takes the native feeder (counted), InMemoryDataset
    the Python parser: both packages give the same batches, the sparse
    slot truncated at its declared dim with its @LEN."""
    path = multislot_file(tmp_path / "a.txt")
    runs = {}
    for name, mod in DATASETS.items():
        runs[name, "native"] = list(dataset(mod, "QueueDataset",
                                            [path])._batch_iter())
        mem = dataset(mod, "InMemoryDataset", [path])
        mem.load_into_memory()
        runs[name, "python"] = list(mem._batch_iter())
    want = runs["jax", "native"]
    for key, got in runs.items():
        assert_batches_equal(got, want)
    assert [len(b["l"]) for b in want] == [4, 4, 4, 4, 2]
    lens = np.concatenate([b["s@LEN"] for b in want])
    assert lens.max() == 3 and lens.min() == 0
    before = pmetrics.metric_get("dataset/native_batches") or 0
    list(dataset(pdataset, "QueueDataset", [path])._batch_iter())
    assert pmetrics.metric_get("dataset/native_batches") - before == 5


def test_native_library_is_built_into_build():
    from paddle_tpu_torch import native
    assert native.available()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "paddle_tpu_torch")
    assert not list(native._SRC.parent.parent.glob("*.so"))


@pytest.mark.parametrize("line, kind", [
    ("3 1.0 2.0 1 5 1 0\n", "QueueDataset"),
    ("3 1.0 2.0 1 5 1 0\n", "InMemoryDataset"),
    ("2 1.0 x 1 5 1 0\n", "QueueDataset"),
    ("2 1.0 2.0 1 5\n", "InMemoryDataset")])
def test_a_malformed_line_raises_as_the_reference(tmp_path, line, kind):
    path = tmp_path / "bad.txt"
    path.write_text("2 1.0 2.0 1 5 1 0\n" + line)
    errors = []
    for mod, exc in ((jdataset, JaxEnforceNotMet),
                     (pdataset, PortEnforceNotMet)):
        ds = dataset(mod, kind, [str(path)])
        with pytest.raises(exc) as e:
            if kind == "InMemoryDataset":
                ds.load_into_memory()
            list(ds._batch_iter())
        errors.append((type(e.value).__name__, str(e.value)))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("threads", [1, 3])
def test_pipe_command_shuffle_and_load_order(tmp_path, threads):
    files = [multislot_file(tmp_path / f"p{i}.txt", rows=7, seed=i)
             for i in range(4)]
    got = {}
    for name, mod in DATASETS.items():
        ds = dataset(mod, "InMemoryDataset", files, threads=threads,
                     pipe="tr 9 8")
        ds.load_into_memory()
        ds.local_shuffle(seed=4)
        mem = list(ds._batch_iter())
        parts = []
        for tid in range(2):
            g = dataset(mod, "InMemoryDataset", files, threads=threads)
            g.load_into_memory()
            barriers = []
            g.global_shuffle(types.SimpleNamespace(barrier=barriers.append),
                             trainer_id=tid, num_trainers=2, seed=3)
            parts += list(g._batch_iter()) + [{"barriers": np.array(
                barriers)}]
        queue = list(dataset(mod, "QueueDataset", files[:1],
                             pipe="tr 9 8")._batch_iter())
        got[name] = mem + parts + queue
    assert_batches_equal(got["port"], got["jax"])


def word_generator(dg, string=False):
    base = dg.MultiSlotStringDataGenerator if string else \
        dg.MultiSlotDataGenerator

    class G(base):
        def generate_sample(self, line):
            def gen():
                toks = (line or "4 5 6 1").split()
                ids = [t if string else int(t) for t in toks[:-1]]
                lab = [toks[-1] if string else int(toks[-1])]
                yield [("words", ids), ("label", lab)]
                if not string:
                    yield [("words", ids[:1]), ("label", [0.5])]
            return gen

        def generate_batch(self, samples):
            def batch():
                for s in reversed(samples):
                    yield s
            return batch
    return G()


def test_data_generators_write_the_same_bytes(tmp_path):
    lines = ["1 2 3 0\n", "7 8 1\n", "9 1\n"]
    outs = {}
    for name, dg in (("jax", jdg), ("port", pdg)):
        text = []
        for string in (False, True):
            for limit in (None, 2):
                g = word_generator(dg, string)
                g.set_batch(2)
                if limit:
                    g._set_line_limit(limit)
                out = _io.StringIO()
                g.run_from_stdin(out=out, lines=lines)
                g2 = word_generator(dg, string)
                g2.run_from_memory(out=out)
                text.append(out.getvalue())
        path = tmp_path / f"criteo-{name}.txt"
        chip_smoke.write_multislot(dg, 1001, str(path), 7, 40)
        text.append(path.read_bytes())
        outs[name] = text
    assert outs["port"] == outs["jax"]
    # the slot contract: the count, the order and the kinds of values
    for dg, exc in ((jdg, JaxEnforceNotMet), (pdg, PortEnforceNotMet)):
        g = word_generator(dg)
        g._gen_str([("words", [1]), ("label", [0])])
        for bad in ([("words", [1])], [("label", [1]), ("words", [0])],
                    [("words", ["a"]), ("label", [0])]):
            with pytest.raises(exc):
                g._gen_str(bad)


def linreg_program(pt, batch):
    """tests/test_dataset_trainer.py's linear regression, raw block API."""
    prog = pt.Program()
    blk = prog.global_block()
    blk.create_var("x", shape=(batch, 3), is_data=True)
    blk.create_var("w", shape=(3, 1), persistable=True)
    blk.create_var("label", shape=(batch, 1), is_data=True,
                   stop_gradient=True)
    blk.append_op("mul", {"X": ["x"], "Y": ["w"]}, {"Out": ["pred"]},
                  {"x_num_col_dims": 1, "y_num_col_dims": 1})
    blk.create_var("pred")
    blk.append_op("elementwise_sub", {"X": ["pred"], "Y": ["label"]},
                  {"Out": ["d"]}, {})
    blk.create_var("d")
    blk.append_op("square", {"X": ["d"]}, {"Out": ["sq"]}, {})
    blk.create_var("sq")
    blk.append_op("mean", {"X": ["sq"]}, {"Out": ["loss"]}, {})
    blk.create_var("loss", shape=())
    pgs = pt.append_backward("loss", parameter_list=["w"], program=prog)
    blk.create_var("lr", persistable=True)
    for p, g in pgs:
        blk.append_op("sgd", {"Param": [p], "Grad": [g],
                              "LearningRate": ["lr"]},
                      {"ParamOut": [p]}, {})
    return prog


def test_train_from_dataset_linear_regression(tmp_path):
    rs = np.random.RandomState(1)
    true_w = np.array([0.5, -1.0, 2.0], np.float32)
    path = tmp_path / "reg.txt"
    with open(path, "w") as f:
        for _ in range(48):
            x = rs.randn(3).astype(np.float32)
            f.write("3 " + " ".join("%.6f" % v for v in x)
                    + " 1 %.6f\n" % float(x @ true_w))
    w0 = rs.randn(3, 1).astype(np.float32)
    got = {}
    for name, (pt, mod) in {"jax": (jpt, jdataset),
                            "port": (tpt, pdataset)}.items():
        ds = dataset(mod, "InMemoryDataset", [str(path)], batch=16,
                     slots=[("x", "float32", 3), ("label", "float32", 1)])
        ds.load_into_memory()
        scope = pt.Scope()
        scope.var("w").set(pt.TpuTensor(w0.copy()))
        scope.var("lr").set(pt.TpuTensor(np.float32(0.1)))
        exe, hist = pt.Executor(), []
        for epoch in range(3):
            ds.local_shuffle(seed=epoch)
            hist += exe.train_from_dataset(program=linreg_program(pt, 16),
                                           dataset=ds, scope=scope,
                                           fetch_list=["loss"],
                                           print_period=1)["loss"]
        got[name] = hist, np.asarray(scope.find_var("w").get().numpy())
    np.testing.assert_allclose(got["port"][0], got["jax"][0], rtol=LOSS_RTOL)
    assert len(got["port"][0]) == 9
    update = got["jax"][1] - w0
    assert np.linalg.norm(got["port"][1] - got["jax"][1]) <= \
        UPDATE_TOL * np.linalg.norm(update)


def tiny_ctr_files(tmp_path, cfg=TINY_CTR):
    files = [str(tmp_path / f"ctr-{i}.txt") for i in range(cfg["files"])]
    for i, f in enumerate(files):
        chip_smoke.write_multislot(pdg, cfg["vocab"], f, i, cfg["rows"])
    return files


def test_train_and_infer_from_dataset_tiny_ctr(tmp_path):
    cfg = TINY_CTR
    files = tiny_ctr_files(tmp_path)
    built = {name: chip_smoke.ctr_dnn_program(
        api, cfg["vocab"], cfg["emb"], cfg["hidden"])
        for name, api in (("jax", JAX_API), ("port", PORT_API))}
    assert built["port"][0].to_json() == built["jax"][0].to_json()
    main, startup, test, feeds, loss = built["port"]
    pexe, pscope = tpt.Executor(), tpt.Scope()
    pexe.run(startup, scope=pscope)
    state = {n: pscope.find_var(n).get().numpy().copy()
             for n, v in main.global_block().vars.items() if v.persistable}
    jscope = jpt.Scope()
    for n, v in state.items():
        jscope.var(n).set(jpt.TpuTensor(v.copy()))
    params = chip_smoke.ctr_params(test)
    got = {}
    for name, (pt, mod, scope, exe) in {
            "jax": (jpt, jdataset, jscope, jpt.Executor()),
            "port": (tpt, pdataset, pscope, pexe)}.items():
        main, _, test, feeds, loss = built[name]
        ds = dataset(mod, "QueueDataset", files, batch=cfg["batch"],
                     slots=feeds)
        handled = []
        hist = exe.train_from_dataset(main, ds, scope=scope,
                                      fetch_list=[loss], print_period=2,
                                      fetch_handler=handled.append)
        after = {n: np.asarray(scope.find_var(n).get().numpy()).copy()
                 for n in params}
        inf = exe.infer_from_dataset(test, dataset(
            mod, "QueueDataset", files[:1], batch=cfg["batch"],
            slots=feeds), scope=scope, fetch_list=[loss.name],
            print_period=1)
        unchanged = all(np.array_equal(
            after[n], np.asarray(scope.find_var(n).get().numpy()))
            for n in params)
        got[name] = (hist[loss.name], handled, after, inf[loss.name],
                     unchanged)
    (phist, phand, pafter, pinf, punch) = got["port"]
    (jhist, jhand, jafter, jinf, junch) = got["jax"]
    assert len(phist) == 3 and punch and junch
    np.testing.assert_allclose(phist, jhist, rtol=LOSS_RTOL)
    np.testing.assert_allclose(pinf, jinf, rtol=LOSS_RTOL)
    assert [sorted(h) for h in phand] == [sorted(h) for h in jhand]
    np.testing.assert_allclose([h[loss.name] for h in phand],
                               [h[loss.name] for h in jhand],
                               rtol=LOSS_RTOL)
    for n in params:
        update = np.linalg.norm(jafter[n] - state[n])
        assert np.linalg.norm(pafter[n] - jafter[n]) <= UPDATE_TOL * update, n


def test_len_is_fed_only_to_a_program_that_declares_it(tmp_path):
    """A batch's ``<name>@LEN`` reaches the program only where it declares
    a var of that name (the tiny CTR-DNN's ``C<i>@LEN``). A fluid
    ``data(lod_level=1)`` pairs with ``<name>@seq_len``, which the
    dataset does not produce: both packages stop at it alike."""
    path = multislot_file(tmp_path / "a.txt", rows=8)
    results = {}
    for name, (pt, static, mod, attr) in {
            "jax": (jpt, jstatic, jdataset, JaxParamAttr),
            "port": (tpt, pstatic, pdataset, PORT_API.ParamAttr)}.items():
        out = []
        for lod in (False, True):
            main = pt.Program()
            with static.program_guard(main, pt.Program()):
                d = static.data("d", [-1, 2], "float32")
                if lod:
                    s = static.data("s", [-1, -1], "int64", lod_level=1)
                    e = static.nn.embedding(s, size=[10 ** 6, 1],
                                            param_attr=attr(name="emb_w"))
                    fetch = static.nn.reduce_sum(static.nn.sequence_pool(
                        e, static.companion_length_of(e), pooltype="SUM"))
                else:
                    s = static.data("s", [-1, 3], "int64")
                    n = static.data("s@LEN", [-1], "int64")
                    fetch = static.nn.reduce_sum(n)
                lab = static.data("l", [-1, 1], "int64")
            ds = dataset(mod, "QueueDataset", [path], slots=[d, s, lab])
            scope, exe = pt.Scope(), pt.Executor()
            scope.var("emb_w").set(pt.TpuTensor(np.ones((10 ** 6, 1),
                                                        np.float32)))
            try:
                h = exe.train_from_dataset(
                    main, ds, scope=scope, fetch_list=[fetch],
                    print_period=1)
                out.append(h[fetch.name])
            except Exception as e:                     # noqa: BLE001
                out.append((type(e).__name__, str(e)))
        results[name] = out
    assert results["port"] == results["jax"]
    lens, lod_error = results["port"]
    assert len(lens) == 2 and lens[0] > 0
    assert lod_error[0] == "PreconditionNotMetError" and \
        "s@seq_len" in lod_error[1]


def test_trainer_descs_and_datafeed_desc(tmp_path):
    proto = tmp_path / "feed.proto"
    proto.write_text('name: "MultiSlotDataFeed"\nbatch_size: 2\n'
                     'multi_slot_desc {\n  slots {\n    name: "words"\n'
                     '    type: "uint64"\n    is_dense: false\n'
                     '    is_used: false\n  }\n  slots {\n'
                     '    name: "label"\n    type: "uint64"\n'
                     '    is_dense: false\n    is_used: false\n  }\n}\n')
    out = {}
    for name, tr in (("jax", jtrainer), ("port", ptrainer)):
        descs = []
        for info in ({}, {"trainer": "DistMultiTrainer",
                          "device_worker": "DownpourSGD", "thread": 4,
                          "dense_vars": ["w"], "fleet_desc": {"a": 1}}):
            t = tr.TrainerFactory()._create_trainer(info)
            t._set_fetch_var_and_info(["loss"], None, 5)
            t._set_infer(True)
            descs.append(t._desc())
        with pytest.raises(Exception, match="unknown trainer"):
            tr.TrainerFactory()._create_trainer({"trainer": "Nope"})
        d = tr.DataFeedDesc(str(proto))
        d.set_batch_size(8)
        d.set_dense_slots(["label"])
        d.set_use_slots(["words", "label"])
        descs.append(d.desc())
        ds = dataset(DATASETS[name], "QueueDataset", [str(proto)])
        descs.append(str(ds.desc()))
        out[name] = descs
    assert out["port"] == out["jax"]
