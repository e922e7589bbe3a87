"""The port's ``io/dataloader.py`` against the JAX package's, on the CPU.

The same seeded numpy datasets go through both packages' DataLoaders,
samplers, ``from_generator`` loaders and ``PyReader``s: every batch is
bit-equal (tolerance 0: a loader moves bytes, it computes nothing), at
0 and 2 workers, with shared memory on and off. Also: a worker's error
reaches the parent; ``worker_init_fn`` runs once in each worker; workers
are not reseeded, so two workers draw the same random numbers, as in
the reference (the caveat ROADMAP Queue 3 lists); the ``batch`` fault
site; and the port's own guarantees: no shared-memory segment or worker
left after a pass, a ``break`` or an error, a dead worker raised, and a
fork while another thread holds an observability lock.
"""
import os
import random
import threading
import time

import multiprocessing as mp

import numpy as np
import pytest

import paddle_tpu.io as jio
from paddle_tpu.testing import faults as jfaults

import paddle_tpu_torch as tpt
import paddle_tpu_torch.io as pio
from paddle_tpu_torch.io import dataloader as pdl
from paddle_tpu_torch.testing import faults as pfaults

PACKAGES = {"jax": jio, "port": pio}


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")
    yield
    pfaults.disarm()
    jfaults.disarm()


def arrays(n=37, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 3, 4).astype(np.float32),
            rs.randint(0, 10, (n,)).astype(np.int64))


class DictSet:
    """A map-style dataset of dict samples (collate by key)."""

    def __init__(self, x, y):
        self.x, self.y = x, y

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return {"x": self.x[i], "y": self.y[i]}


def as_list(batches):
    out = []
    for b in batches:
        if isinstance(b, dict):
            out.append([b[k] for k in sorted(b)])
        else:
            out.append(list(b))
    return out


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(as_list(got), as_list(want)):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)


def shm_left(prefix):
    return [n for n in os.listdir("/dev/shm") if n.startswith(prefix)]


@pytest.mark.parametrize("workers, shm, kind", [
    (0, False, "tuple"), (0, True, "dict"), (2, False, "dict"),
    (2, True, "tuple")])
def test_batches_bit_equal(workers, shm, kind):
    x, y = arrays()
    got = {}
    for name, io in PACKAGES.items():
        ds = io.TensorDataset([x, y]) if kind == "tuple" else DictSet(x, y)
        loader = io.DataLoader(ds, batch_size=5, num_workers=workers,
                               use_shared_memory=shm)
        got[name] = list(loader)
        assert len(loader) == 8
    assert_same(got["port"], got["jax"])
    assert not mp.active_children()
    assert not shm_left(pdl.shm_prefix_of())


@pytest.mark.parametrize("drop_last", [False, True])
def test_samplers_same_indices(drop_last):
    x, _ = arrays(23)
    for replacement in (False, True):
        seqs = []
        for io in PACKAGES.values():
            s = io.RandomSampler(x, replacement=replacement, num_samples=17)
            s._rng = np.random.RandomState(3)
            bs = io.BatchSampler(sampler=s, batch_size=4,
                                 drop_last=drop_last)
            seqs.append((list(bs), len(bs)))
        assert seqs[0] == seqs[1]
    runs = []
    for io in PACKAGES.values():
        seq = list(io.BatchSampler(x, batch_size=5, drop_last=drop_last))
        dist = []
        for rank in range(3):
            d = io.DistributedBatchSampler(x, 4, num_replicas=3, rank=rank,
                                           shuffle=True, drop_last=drop_last)
            d.set_epoch(2)
            dist.append((list(d), len(d)))
        runs.append((seq, dist))
    assert runs[0] == runs[1]


def test_distributed_batch_sampler_reads_the_process_group(monkeypatch):
    """Without a process group the port shards as one JAX process does
    (1 rank, rank 0); with one it takes torch.distributed's world size
    and rank."""
    x, _ = arrays(10)
    ref = jio.DistributedBatchSampler(x, 3)
    alone = pio.DistributedBatchSampler(x, 3)
    assert (alone.nranks, alone.rank) == (ref.nranks, ref.rank) == (1, 0)
    assert list(alone) == list(ref)
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    monkeypatch.setattr(dist, "get_rank", lambda: 2)
    grouped = pio.DistributedBatchSampler(x, 3)
    assert (grouped.nranks, grouped.rank) == (4, 2)
    assert list(grouped) == list(jio.DistributedBatchSampler(
        x, 3, num_replicas=4, rank=2))


class Failing:
    def __len__(self):
        return 12

    def __getitem__(self, i):
        if i == 7:
            raise ValueError("sample 7 is broken")
        return np.float32(i)


@pytest.mark.parametrize("shm", [False, True])
def test_worker_error_reaches_the_parent(shm):
    """The error raises at the first result that carries it: after batch
    0, or before it when worker 1's error arrives first."""
    for io in PACKAGES.values():
        seen = []
        with pytest.raises(RuntimeError,
                           match="worker failed on batch 1(.|\n)*sample 7"):
            for b in io.DataLoader(Failing(), batch_size=5, num_workers=2,
                                   use_shared_memory=shm):
                seen.append(b)
        assert [np.asarray(b).ravel().tolist() for b in seen] in (
            [], [[0, 1, 2, 3, 4]])
    assert not mp.active_children()
    assert not shm_left(pdl.shm_prefix_of())


def test_worker_init_fn_runs_once_per_worker(tmp_path):
    x, y = arrays(20)
    for name, io in PACKAGES.items():
        d = tmp_path / name
        d.mkdir()

        def init(wid, d=d):
            (d / f"{wid}-{os.getpid()}").write_text("")

        list(io.DataLoader(io.TensorDataset([x, y]), batch_size=2,
                           num_workers=3, worker_init_fn=init))
        calls = sorted(p.name.split("-") for p in d.iterdir())
        assert [c[0] for c in calls] == ["0", "1", "2"]
        pids = {int(c[1]) for c in calls}
        assert len(pids) == 3 and os.getpid() not in pids


class Draws:
    """Each sample draws from numpy's global state and Python's random."""

    def __init__(self, source):
        self.source = source

    def __len__(self):
        return 12

    def __getitem__(self, i):
        if self.source == "numpy":
            return np.random.rand(2)
        return np.array([random.random(), random.random()])


def test_workers_inherit_the_numpy_random_state():
    """The loader reseeds no worker. Under one parent seed the port's
    numpy draws equal the reference's bit for bit, and the first
    batches of two workers hold the same draws (the reference's
    caveat, kept); Python's random is reseeded from the OS in each
    forked child by the interpreter, in both packages, so its draws
    follow neither the parent's seed nor the other worker's."""
    got = {}
    for name, io in PACKAGES.items():
        np.random.seed(5)
        got[name] = list(io.DataLoader(Draws("numpy"), batch_size=3,
                                       num_workers=2))
    assert_same(got["port"], got["jax"])
    port = [np.asarray(b) for b in got["port"]]
    assert np.array_equal(port[0], port[1])
    assert np.array_equal(port[2], port[3])
    assert not np.array_equal(port[0], port[2])
    for io in PACKAGES.values():
        random.seed(5)
        parent = [random.random() for _ in range(6)]
        random.seed(5)
        b = [np.asarray(x).ravel() for x in io.DataLoader(
            Draws("python"), batch_size=3, num_workers=2)]
        assert not np.array_equal(b[0], b[1])
        assert not np.array_equal(b[0], parent)


@pytest.mark.parametrize("shm", [False, True])
def test_a_break_leaves_no_segment_and_no_worker(shm):
    x, y = arrays(60)
    got = {}
    for name, io in PACKAGES.items():
        it = iter(io.DataLoader(io.TensorDataset([x, y]), batch_size=4,
                                num_workers=2, use_shared_memory=shm,
                                prefetch_factor=3))
        got[name] = [next(it), next(it)]
        time.sleep(0.05)       # let the workers put batches in flight
        it.close()
    assert_same(got["port"], got["jax"])
    assert not mp.active_children()
    assert not shm_left(pdl.shm_prefix_of())


def test_close_ends_the_pass_while_its_generator_is_referenced():
    """Closing the loader's iterator stops the workers and unlinks the
    segments at once, also while something (a profiler, a traceback)
    still references the generator it wraps, which the JAX package
    leaves to the garbage collector."""
    x, y = arrays(60)
    it = iter(pio.DataLoader(pio.TensorDataset([x, y]), batch_size=4,
                             num_workers=2, prefetch_factor=3))
    inner = it.gi_frame.f_locals["gen"]
    next(it)
    time.sleep(0.05)
    it.close()
    assert inner.gi_frame is None
    assert not mp.active_children()
    assert not shm_left(pdl.shm_prefix_of())


class DiesAt:
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            os._exit(3)
        return np.float32(i)


def test_a_dead_worker_raises():
    """A worker that dies (os._exit, as an OOM kill) surfaces at the
    next 5 s poll while the other worker lives; the JAX package raises
    only once every worker has died, so only the port runs here."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match=r"\(0, 3\)(.|\n)*died"):
        list(pio.DataLoader(DiesAt(), batch_size=2, num_workers=2))
    assert time.perf_counter() - t0 < 30
    assert not mp.active_children()
    assert not shm_left(pdl.shm_prefix_of())


def test_fork_while_a_lock_is_held():
    """The workers touch no lock of the port's observability modules: a
    pass completes while another thread holds the flight recorder's."""
    from paddle_tpu_torch.observability import flight_recorder
    x, y = arrays(20)
    held, release = threading.Event(), threading.Event()

    def hold():
        with flight_recorder._lock:
            held.set()
            release.wait(30)

    t = threading.Thread(target=hold)
    t.start()
    try:
        held.wait(5)
        got = list(pio.DataLoader(pio.TensorDataset([x, y]), batch_size=4,
                                  num_workers=2))
    finally:
        release.set()
        t.join()
    assert_same(got, list(jio.DataLoader(jio.TensorDataset([x, y]),
                                         batch_size=4)))


def test_from_generator_and_pyreader():
    import paddle_tpu as jpt
    from paddle_tpu import static as jstatic
    from paddle_tpu_torch import static as pstatic
    rs = np.random.RandomState(1)
    samples = [(rs.rand(3).astype(np.float32),
                rs.randint(0, 5, (rs.randint(1, 4),)).astype(np.int64))
               for _ in range(7)]
    batches = [(rs.rand(2, 3).astype(np.float32),) for _ in range(3)]
    got = {}
    for name, (pt, static, io) in {"jax": (jpt, jstatic, jio),
                                   "port": (tpt, pstatic, pio)}.items():
        out = []
        gl = io.DataLoader.from_generator(capacity=4)
        gl.set_batch_generator(lambda: iter(batches))
        out += [list(b) for b in gl]
        gl.set_sample_list_generator(lambda: iter([samples[:2]]))
        out += [[np.asarray(s[0]) for s in b] for b in gl]
        main = pt.Program()
        with static.program_guard(main, pt.Program()):
            a = static.data("a", [-1, 3], "float32")
            ids = static.data("ids", [-1, -1], "int64", lod_level=1)
        for return_list in (False, True):
            r = io.dataloader.PyReader(feed_list=[a, ids],
                                       return_list=return_list)
            r.decorate_sample_generator(lambda: iter(samples), 3,
                                        drop_last=False)
            for f in r():
                out.append([f[k] for k in sorted(f)] if isinstance(f, dict)
                           else list(f))
            r = io.dataloader.PyReader(feed_list=["a"], return_list=True)
            r.decorate_batch_generator(lambda: iter(batches))
            out += [list(f) for f in r]
        got[name] = out
    assert_same(got["port"], got["jax"])
    # the lod_level 1 slot: padded ids beside their @seq_len lengths
    lens = [len(s[1]) for s in samples[:3]]
    a, ids, seq_len = got["port"][4]
    assert ids.shape == (3, max(lens)) and seq_len.tolist() == lens


def test_slow_fault_fires_at_batch_n():
    """``slow@ms=M,batch=N`` sleeps before the Nth batch of a pass
    reaches the consumer, once, in both packages."""
    x, y = arrays(30)
    for io, faults in ((jio, jfaults), (pio, pfaults)):
        faults.arm("slow@ms=60,batch=3")
        waits, fired = [], []
        it = iter(io.DataLoader(io.TensorDataset([x, y]), batch_size=5,
                                use_buffer_reader=False))
        while True:
            t0 = time.perf_counter()
            try:
                next(it)
            except StopIteration:
                break
            waits.append(time.perf_counter() - t0)
            fired.append(faults.fired()[0]["fired"])
        assert fired == [0, 0, 1, 1, 1, 1]
        assert waits[2] >= 0.06 and max(waits[:2] + waits[3:]) < 0.06
        faults.disarm()


@pytest.mark.parametrize("text", ["crash@batch=2", "sigterm@batch=2",
                                  "slow@ms=5,batch=2,request=2"])
def test_batch_site_kinds_the_port_lacks_raise(text):
    jfaults.FaultSpec.parse(text.replace(",request=2", ""))
    with pytest.raises(pfaults.FaultSpecError,
                       match="item 9|exactly one"):
        pfaults.arm(text)


def test_the_batch_metrics():
    """``dataloader/batches`` counts, and ``wait_ms`` / ``step_ms``
    observe, each batch, as in the reference."""
    from paddle_tpu.observability import metrics as jm
    from paddle_tpu_torch.observability import metrics as pm
    x, y = arrays(20)
    for io, m in ((jio, jm), (pio, pm)):
        before = m.metric_get("dataloader/batches") or 0
        w0 = m.snapshot().get("dataloader/wait_ms", {}).get("count", 0)
        for _ in io.DataLoader(io.TensorDataset([x, y]), batch_size=6):
            pass
        assert m.metric_get("dataloader/batches") - before == 4
        snap = m.snapshot()
        assert snap["dataloader/wait_ms"]["count"] - w0 == 4
        assert snap["dataloader/step_ms"]["count"] >= 4


def test_file_dataloader_matches(tmp_path):
    rs = np.random.RandomState(2)
    path = tmp_path / "dense.txt"
    path.write_text("".join(
        f"{rs.randint(0, 2)} " + " ".join(f"{v:.5f}" for v in rs.rand(6))
        + "\n" for _ in range(23)))
    got = [list(io.dataloader.FileDataLoader([str(path)], batch_size=5,
                                             dim=6, num_threads=1))
           for io in (jio, pio)]
    assert_same(got[1], got[0])
    assert len(got[1]) == 5
