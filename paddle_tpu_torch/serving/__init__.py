"""Serving plane: multi-tenant continuous-batching prediction.

Port of ``paddle_tpu/serving/``, the server built on
``paddle_tpu_torch.inference``:

- :mod:`.admission` (copied): the static analyzer as the model-load
  gate (reject on PTA errors, surface PTA3xx recompile hazards);
- :mod:`.buckets` (copied): pad-to-bucket shape quantization, declared
  or learned, then frozen;
- :mod:`.cache`: the fingerprint-keyed persistent cache of each
  bucket's preparation, so a reboot probes nothing;
- :mod:`.scheduler`: per-tenant queues, EDF dequeue, continuous batch
  fill and pipelined dispatch (host staging of batch k+1 overlaps the
  card's work on batch k; a readback thread completes futures);
- :mod:`.placement`: the one-device ``ServingMesh``;
- :mod:`.server`: :class:`PredictorServer` tying it together.

Both load paths: A, a ``save_inference_model`` directory; B, a
``torch.export`` archive that ``inference.export_stablehlo`` wrote (the
port's twin of the reference's serialized ``jax.export`` blob, which
the port refuses).
"""
from __future__ import annotations

from .admission import (AdmissionError, AdmissionReport,  # noqa: F401
                        admit_program)
from .buckets import Bucket, BucketPolicy, signature_of  # noqa: F401
from .cache import ExecutableCache, cache_key  # noqa: F401
from .model import ServedModel  # noqa: F401
from .placement import (Placement, ServingMesh,  # noqa: F401
                        TenantSpec)
from .scheduler import (DeadlineExceeded, PredictionFuture,  # noqa: F401
                        Request, ServingClosed, TenantScheduler)
from .server import PredictorServer  # noqa: F401
