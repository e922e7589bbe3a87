"""C-inference-API compat structs (ref: paddle/fluid/inference/capi/ and
pybind's PaddleTensor/PaddleBuf/PaddleDType/NativeConfig —
paddle_api.h). Verbatim fluid scripts build these to drive an
inference-optimized CompiledProgram through Executor.run; here they are
thin containers over numpy with the same field/method surface.

A copy of ``paddle_tpu/inference/capi.py`` (pure Python).
"""
from __future__ import annotations

import enum

import numpy as np


class PaddleDType(enum.IntEnum):
    """ref: paddle_api.h PaddleDType."""
    FLOAT32 = 0
    INT64 = 1
    INT32 = 2
    UINT8 = 3
    INT8 = 4
    FLOAT16 = 5

    @classmethod
    def from_numpy(cls, dt) -> "PaddleDType":
        return {
            "float32": cls.FLOAT32, "int64": cls.INT64,
            "int32": cls.INT32, "uint8": cls.UINT8, "int8": cls.INT8,
            "float16": cls.FLOAT16,
        }.get(np.dtype(dt).name, cls.FLOAT32)

    def to_numpy(self):
        return {
            self.FLOAT32: np.float32, self.INT64: np.int64,
            self.INT32: np.int32, self.UINT8: np.uint8,
            self.INT8: np.int8, self.FLOAT16: np.float16,
        }[self]


class PaddleBuf:
    """ref: paddle_api.h PaddleBuf — a typed flat buffer with
    ``float_data()`` / ``int64_data()`` / ``int32_data()`` accessors."""

    def __init__(self, data=None):
        self._arr = (np.asarray(data).reshape(-1)
                     if data is not None else np.zeros(0, np.float32))

    def resize(self, n):
        self._arr = np.zeros(int(n), self._arr.dtype)

    def reset(self, data):
        self._arr = np.asarray(data).reshape(-1)

    def length(self):
        return int(self._arr.nbytes)

    def float_data(self):
        return [float(v) for v in self._arr.astype(np.float32)]

    def int64_data(self):
        return [int(v) for v in self._arr.astype(np.int64)]

    def int32_data(self):
        return [int(v) for v in self._arr.astype(np.int32)]

    def tolist(self):
        return self._arr.tolist()


class PaddleTensor:
    """ref: paddle_api.h PaddleTensor: name/shape/dtype/data/lod."""

    def __init__(self, data=None, name=""):
        self.name = name
        self.lod = []
        if data is not None:
            arr = np.asarray(data)
            self.shape = list(arr.shape)
            self.dtype = PaddleDType.from_numpy(arr.dtype)
            self.data = PaddleBuf(arr)
        else:
            self.shape = []
            self.dtype = PaddleDType.FLOAT32
            self.data = PaddleBuf()

    def as_ndarray(self) -> np.ndarray:
        np_dtype = (self.dtype.to_numpy() if isinstance(
            self.dtype, PaddleDType) else self.dtype)
        arr = np.asarray(self.data._arr, np_dtype)
        return arr.reshape(self.shape) if self.shape else arr


class NativeConfig:
    """ref: paddle_api.h NativeConfig — inference engine knobs. The
    port's executor runs the program op by op on its device in place of
    the native engine; the fields are honored as metadata (model_dir
    drives loading) and the rest are recorded no-ops."""

    def __init__(self):
        self.model_dir = ""
        self.prog_file = ""
        self.param_file = ""
        self.use_gpu = False
        self.device = 0
        self.fraction_of_gpu_memory = -1.0
        self.specify_input_name = False


class AnalysisConfig(NativeConfig):
    """ref: paddle_analysis_config.h — superset accepted for parity."""

    def __init__(self, model_dir=""):
        super().__init__()
        self.model_dir = model_dir

    def enable_use_gpu(self, *a, **kw):
        pass

    def disable_gpu(self):
        pass

    def switch_ir_optim(self, *a, **kw):
        pass
