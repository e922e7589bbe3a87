"""DataGenerator family (ref:
python/paddle/fluid/incubate/data_generator/__init__.py:21) — the
user-subclassed ETL stage of Dataset/DataFeed training: a generator
script turns raw input lines into MultiSlot-format text the feed
plane parses (the port's native/src/datafeed.cc MultiSlotFeeder reads
the same "<n> v1 ... vn" per-slot records). A copy of
``paddle_tpu/incubate/data_generator.py``.

Subclass and override ``generate_sample(line)`` (and optionally
``generate_batch(samples)``), then drive with ``run_from_stdin()``
inside a pipe — exactly the reference's PS-training ETL contract —
or ``run_from_memory()`` for tests.
"""
from __future__ import annotations

import sys
from typing import Iterable, List, Optional, Tuple

from ..core.enforce import InvalidArgumentError, enforce

__all__ = ["DataGenerator", "MultiSlotDataGenerator",
           "MultiSlotStringDataGenerator"]


class DataGenerator:
    """ref: data_generator/__init__.py:21."""

    def __init__(self):
        self._proto_info: Optional[List[Tuple[str, str]]] = None
        self.batch_size_ = 32
        self._line_limit = None

    def _set_line_limit(self, line_limit: int):
        enforce(isinstance(line_limit, int) and line_limit > 0,
                "line_limit must be a positive int",
                InvalidArgumentError)
        self._line_limit = line_limit

    def set_batch(self, batch_size: int):
        """Batch size used by ``generate_batch`` grouping."""
        self.batch_size_ = int(batch_size)

    # -- the user contract --
    def generate_sample(self, line):
        """Override: return a callable iterating samples for one raw
        input line (``None`` line means memory/EOF mode)."""
        raise NotImplementedError(
            "Please rewrite this function to return a generator of "
            "[(name, value_list), ...] samples")

    def generate_batch(self, samples):
        """Override for batch-level shuffles/negatives; default yields
        each sample unchanged."""

        def local_iter():
            for sample in samples:
                yield sample

        return local_iter

    # -- drivers --
    def _emit(self, out, samples):
        batch = []
        for sample in samples:
            batch.append(sample)
            if len(batch) == self.batch_size_:
                for processed in self.generate_batch(batch)():
                    out.write(self._gen_str(processed))
                batch = []
        if batch:
            for processed in self.generate_batch(batch)():
                out.write(self._gen_str(processed))

    def run_from_memory(self, out=None):
        """ref :67 — generate_sample(None) supplies everything."""
        out = out or sys.stdout

        def samples():
            gen = self.generate_sample(None)
            for s in gen():
                yield s

        self._emit(out, samples())

    def run_from_stdin(self, out=None, lines: Optional[Iterable] = None):
        """ref :101 — one generate_sample() per raw input line
        (``lines`` overrides stdin for tests/pipes)."""
        out = out or sys.stdout
        src = lines if lines is not None else sys.stdin

        def samples():
            for n, line in enumerate(src):
                if self._line_limit and n >= self._line_limit:
                    break
                for s in self.generate_sample(line)():
                    yield s

        self._emit(out, samples())

    def _gen_str(self, line) -> str:
        raise NotImplementedError(
            "please use MultiSlotDataGenerator or "
            "MultiSlotStringDataGenerator")

    def _check_shape(self, line):
        enforce(isinstance(line, (list, tuple)),
                "process() output must be a list/tuple of "
                "(name, values) pairs", InvalidArgumentError)
        if self._proto_info is None:
            self._proto_info = [(name, "d") for name, _ in line]
        else:
            enforce(len(line) == len(self._proto_info),
                    f"slot count changed: {len(line)} vs "
                    f"{len(self._proto_info)}", InvalidArgumentError)


class MultiSlotStringDataGenerator(DataGenerator):
    """ref :230 — values already strings; fastest path."""

    def _gen_str(self, line) -> str:
        self._check_shape(line)
        parts = []
        for _name, elements in line:
            parts.append(str(len(elements)))
            parts.extend(str(e) for e in elements)
        return " ".join(parts) + "\n"


class MultiSlotDataGenerator(DataGenerator):
    """ref :290 — numeric values; the slot dtype (int feasign vs float
    value) is pinned by the first record and enforced after."""

    def _gen_str(self, line) -> str:
        enforce(isinstance(line, (list, tuple)),
                "process() output must be a list/tuple of "
                "(name, values) pairs", InvalidArgumentError)
        if self._proto_info is None:
            self._proto_info = []
            for name, elements in line:
                kind = "d" if any(isinstance(e, float)
                                  for e in elements) else "u"
                self._proto_info.append((name, kind))
        else:
            enforce(len(line) == len(self._proto_info),
                    f"slot count changed: {len(line)} vs "
                    f"{len(self._proto_info)}", InvalidArgumentError)
        parts = []
        for (name, elements), (pname, kind) in zip(line,
                                                   self._proto_info):
            enforce(name == pname,
                    f"slot order changed: {name!r} vs {pname!r}",
                    InvalidArgumentError)
            parts.append(str(len(elements)))
            for e in elements:
                enforce(isinstance(e, (int, float)),
                        f"slot {name!r}: values must be int/float",
                        InvalidArgumentError)
                parts.append(str(e))
        return " ".join(parts) + "\n"
