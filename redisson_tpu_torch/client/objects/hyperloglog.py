"""HyperLogLog handle: PFADD (add/add_all), PFCOUNT (count, count_with) and
PFMERGE (merge_with) over one counter's registers on the device, with the
replies of ``redisson_tpu/client/objects/hyperloglog.py``."""
from __future__ import annotations

import numpy as np

from redisson_tpu_torch.client.objects.base import RExpirable
from redisson_tpu_torch.core import kernels as K
from redisson_tpu_torch.core.store import StateRecord
from redisson_tpu_torch.ops import hll as hll_ops
from redisson_tpu_torch.utils import hashing as H


def _spans_devices(regs_list) -> bool:
    """True when the register banks live on more than one device."""
    return len({r.device for r in regs_list}) > 1


class HyperLogLog(RExpirable):
    def _rec_or_create(self) -> StateRecord:
        def factory():
            return StateRecord(
                kind="hll",
                meta={"p": hll_ops.DEFAULT_P, "hash": H.HASH_NAME},
                arrays={"regs": hll_ops.make(hll_ops.DEFAULT_P, self._home)},
            )

        return self._engine.store.get_or_create(self._name, "hll", factory)

    def create_if_absent(self) -> None:
        """Create the (empty) register bank if absent (PFADD with no args)."""
        self._rec_or_create()

    def add(self, obj) -> bool:
        """PFADD semantics: True if any register may have changed."""
        return self.add_all([obj] if not isinstance(obj, np.ndarray) else obj)

    def add_all(self, objs) -> bool:
        kind, arrays, n = self._engine.pack_keys(objs, self._codec, device=self._home)
        if n == 0:
            return False
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            p = rec.meta["p"]
            arrays = self._engine.on_card(arrays, rec.arrays["regs"])
            if kind == "u64":
                K.hll_add_packed(rec.arrays["regs"], arrays, n, p)
            else:
                words, nbytes = arrays
                K.hll_add_bytes(rec.arrays["regs"], words, nbytes, n, p)
            self._touch_version(rec)
        # as in the reference: report True on any add rather than pay for an
        # exact register-delta check
        return True

    def count(self) -> int:
        with self._engine.locked(self._name):
            rec = self._engine.store.get(self._name)
            if rec is None:
                return 0
            est = K.hll_estimate(rec.arrays["regs"])
        return int(round(float(est)))

    def count_with(self, *other_names: str) -> int:
        """PFCOUNT over the union of this and other counters, non-destructive."""
        names = (self._name, *other_names)
        with self._engine.locked_many(names):
            all_regs = []
            for nm in names:
                rec = self._engine.store.get(nm)
                if rec is not None:
                    all_regs.append(rec.arrays["regs"])
            if not all_regs:
                return 0
            if _spans_devices(all_regs):
                # counters on several cards merge on the cards: a fold a
                # card, then peer copies (K13), never a host gather
                from redisson_tpu_torch.parallel.manager import merge_across_devices

                regs = merge_across_devices(all_regs)
            else:
                regs = all_regs[0]
                for r in all_regs[1:]:
                    regs = K.hll_merge(regs, r)  # a new tensor: records stay as they are
            est = K.hll_estimate(regs)
        return int(round(float(est)))

    def merge_with(self, *other_names: str) -> None:
        """PFMERGE other counters into this one."""
        with self._engine.locked_many((self._name, *other_names)):
            rec = self._rec_or_create()
            regs = rec.arrays["regs"]
            sources = []
            for nm in other_names:
                if nm == self._name:  # self-merge is a no-op
                    continue
                other = self._engine.store.get(nm)
                if other is None:
                    continue
                if other.kind != "hll":
                    raise TypeError(f"'{nm}' is not a HyperLogLog")
                sources.append(other.arrays["regs"])
            if sources and _spans_devices([regs, *sources]):
                # cross-card sources merge on the cards (K13) and the
                # result lands on this record's card
                from redisson_tpu_torch.parallel.manager import merge_across_devices

                regs = merge_across_devices([regs, *sources], dest_device=regs.device)
            else:
                for src in sources:
                    regs = K.hll_merge(regs, src)
            rec.arrays["regs"] = regs
            self._touch_version(rec)
