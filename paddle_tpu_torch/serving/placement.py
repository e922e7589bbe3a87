"""Tenant placement: the one-device case.

Port of the one-device half of ``paddle_tpu/serving/placement.py``.
The reference packs tenants over a 2-D ``(replica, model)`` mesh of
local devices: model-parallel tenants claim a row and shard their
feeds, small tenants pack as per-device replicas, weighted by the cost
the perf ledger measured. The port's mesh is 1x1 on
:func:`paddle_tpu_torch.device.get_device`: every tenant is a replica
on that device, weighted by its padded feed volume (the reference's
ledger-less fallback). More than one device, ``model_ways > 1`` or a
model-parallel request raises: those wait for the distributed plane
(ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

from ..core.enforce import (InvalidArgumentError, UnimplementedError,
                            enforce)
from ..device import get_device
from ..observability import flight_recorder as _flight

__all__ = ["ServingMesh", "Placement", "TenantSpec", "measured_cost",
           "pack", "record_decisions"]

_MULTI = ("multi-device serving placement (model-parallel rows, "
          "replicas over several devices) is not ported: it waits for "
          "the distributed plane (ROADMAP Queue 1 item 8)")


class ServingMesh:
    """The serving plane's ``(replica, model)`` mesh: 1x1 on one
    device."""

    AXES = ("replica", "model")

    def __init__(self, model_ways: int = 1,
                 devices: Optional[Sequence] = None):
        devices = list(devices if devices is not None else [get_device()])
        enforce(int(model_ways) >= 1,
                f"model_ways must be >= 1, got {model_ways}",
                InvalidArgumentError)
        if int(model_ways) != 1 or len(devices) != 1:
            raise UnimplementedError(
                f"ServingMesh(model_ways={model_ways}, {len(devices)} "
                f"device(s)): {_MULTI}")
        self.model_ways = 1
        self.devices = devices
        self.rows = 1

    def describe(self) -> dict:
        return {"axes": {"replica": self.rows, "model": self.model_ways},
                "n_devices": len(self.devices)}

    def __repr__(self):
        return f"ServingMesh(replica={self.rows}, model={self.model_ways})"


class TenantSpec:
    """One tenant's placement request (the reference's fields)."""

    __slots__ = ("name", "kind", "replicas", "partition_spec", "cost",
                 "batches", "rows")

    def __init__(self, name: str, *, kind: str = "auto",
                 replicas: int = 1,
                 partition_spec: Optional[Dict[str, tuple]] = None,
                 cost: Optional[dict] = None,
                 batches: Optional[Sequence[int]] = None,
                 rows: int = 1):
        enforce(kind in ("auto", "replicated", "model_parallel"),
                f"tenant {name!r}: unknown placement kind {kind!r}",
                InvalidArgumentError)
        self.name = str(name)
        self.kind = kind
        self.replicas = max(int(replicas), 1)
        self.rows = max(int(rows), 1)
        self.partition_spec = dict(partition_spec or {})
        self.cost = dict(cost or {})
        self.batches = tuple(int(b) for b in (batches or ()))


class Placement:
    """One tenant's placement decision."""

    __slots__ = ("tenant", "kind", "devices", "device_ids", "cost")

    def __init__(self, tenant: str, kind: str, devices: Sequence,
                 cost: Optional[dict] = None):
        self.tenant = tenant
        self.kind = kind
        self.devices = list(devices)
        self.device_ids = [int(d.index or 0) for d in self.devices]
        self.cost = dict(cost or {})

    @property
    def replicas(self) -> int:
        return len(self.devices)

    def to_dict(self) -> dict:
        return {"tenant": self.tenant, "kind": self.kind,
                "devices": list(self.device_ids),
                "replicas": self.replicas, "cost": dict(self.cost)}

    def __repr__(self):
        return (f"Placement({self.tenant!r}, {self.kind}, "
                f"devices={self.device_ids})")


def measured_cost(label: str, buckets: Sequence) -> dict:
    """The tenant's per-batch weight: its worst padded feed volume
    (elements), the reference's ledger-less fallback (no perf ledger is
    ported)."""
    volume = 0
    for b in buckets:
        volume = max(volume, sum(
            int(math.prod(shape or (1,))) for shape, _ in b.spec.values()))
    return {"flops": 0.0, "bytes": 0.0, "volume": volume,
            "weight": float(volume), "source": "volume"}


def pack(mesh: ServingMesh,
         tenants: Sequence[TenantSpec]) -> Dict[str, Placement]:
    """Every tenant a replica on the mesh's one device."""
    out: Dict[str, Placement] = {}
    for t in tenants:
        if t.kind == "model_parallel" or t.replicas > 1 or t.rows > 1 \
                or t.partition_spec:
            raise UnimplementedError(
                f"tenant {t.name!r} asks for kind={t.kind!r}, "
                f"replicas={t.replicas}, rows={t.rows}: {_MULTI}")
        out[t.name] = Placement(t.name, "replicated", mesh.devices,
                                cost=t.cost)
    return out


def record_decisions(mesh: ServingMesh,
                     placements: Dict[str, Placement]) -> List[dict]:
    """The decisions as records, into the flight recorder's ring."""
    recs = [p.to_dict() for _, p in sorted(placements.items())]
    _flight.record("serving_placement", mesh=mesh.describe(),
                   decisions=recs)
    return recs
