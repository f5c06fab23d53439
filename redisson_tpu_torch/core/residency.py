"""The residency plane's two helpers that the serializers read through.

A port of ``redisson_tpu/core/residency.py``'s ``record_host_arrays`` and
``no_promote`` in their residency-off forms: every record is HOT (its
tensors live on its device), so a record's host view is one device-to-host
copy a tensor and ``no_promote`` has nothing to hold back.  The tiers
themselves (WARM host stashes, COLD spills, the budgets and the sweep) come
with the residency part of the operations slice (ROADMAP M11 part 5).

A tensor comes to the host as the numpy array of its dtype and shape, the
reference's ``np.asarray`` of the same record: the expanded one-uint8-per-bit
planes, uint8 registers, int32 and float32 rows.  A ``ShardedPlane`` comes
gathered whole (dp replica 0's shards joined), as the reference's
``np.asarray`` of a mesh-sharded array does.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


class no_promote:
    """Context: observe records without faulting them in.  With every
    record HOT there is nothing to fault in, so it holds nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def host_array(value) -> np.ndarray:
    """One record array as a host numpy array of its own dtype and shape."""
    from redisson_tpu_torch.parallel.sharded import ShardedPlane

    if isinstance(value, ShardedPlane):
        return value.numpy()
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def record_host_arrays(rec) -> Dict[str, Any]:
    """Host-side numpy view of a record's named arrays: the one seam the
    checkpoint, DUMP and COPY serializers read through."""
    return {k: host_array(v) for k, v in rec.arrays.items()}
