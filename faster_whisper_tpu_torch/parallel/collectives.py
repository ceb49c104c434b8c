"""The collectives of a model-axis group (tensor parallelism).

A group is the N shards of one data-axis row of a mesh
(``parallel/mesh.py``), driven by one host thread as one SPMD program is
driven: each sublayer launches every shard's column-parallel products and
attention on that shard's device, reduces the row-parallel partials here,
then adds the replicated bias on each shard (``models/model.py``).  The
reduction is the counterpart of the all-reduce that XLA inserts after each
row-parallel product of the JAX package's Megatron layouts; it is a
library collective, not a port of a TPU kernel.

The transport is chosen once, from the layout, when the group is built:

  * ``"nccl"``: shards on distinct cards.  ``torch.cuda.nccl.all_reduce``
    over the group's tensors (one process, several devices), on each
    card's current stream, so that the speculative encode's side streams
    carry it.  The communicator is built with the group.
  * ``"local"``: shards that share a card (``device_index=[0, 0]``) or the
    host.  NCCL refuses a device listed twice in one communicator, so the
    sum is explicit: in shard order, once per device, on that device.

With two shards the sum of two bf16 or int32 partials is one rounding of a
commutative sum, so both transports give equal bits.  Each reduction is
the span ``fwt.all_reduce`` (``tracing``).
"""

import functools

from typing import Callable, List, Sequence

import torch

from faster_whisper_tpu_torch.tracing import span

_NCCL_SUM, _NCCL_MAX = 0, 2  # ncclRedOp_t


class ShardGroup:
    """The devices of a model-axis group, shard 0 (the lead) first, and
    their collectives.  Every method takes and returns one tensor per
    shard, in shard order."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        kinds = {d.type for d in self.devices}
        if len(kinds) != 1 or kinds - {"cuda", "cpu"}:
            raise ValueError(f"a model-axis group needs one kind of device, got {self.devices}")
        # the first shard on each shard's device: a replicated value is
        # computed once per device and shared by that device's shards
        self.first = [self.devices.index(d) for d in self.devices]
        distinct = len(set(self.devices)) == self.size
        self.transport = "nccl" if self.size > 1 and distinct and "cuda" in kinds else "local"
        if self.transport == "nccl":
            if not hasattr(torch._C, "_nccl_all_reduce"):
                raise RuntimeError(
                    f"shards on distinct cards {self.devices} need NCCL, and this "
                    "PyTorch is built without it"
                )
            # builds (and caches) the communicator of these devices
            self._nccl([torch.zeros(1, device=d) for d in self.devices], _NCCL_SUM)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    def __repr__(self) -> str:
        return f"ShardGroup({[str(d) for d in self.devices]}, transport={self.transport!r})"

    def replicated(self, fn: Callable, *per_shard) -> list:
        """``fn`` of each shard's arguments, computed once per device: a
        shard on a device already done takes that result (its arguments
        hold the same values)."""
        out = []
        for i, j in enumerate(self.first):
            out.append(fn(*(a[i] for a in per_shard)) if i == j else out[j])
        return out

    def broadcast(self, t: torch.Tensor) -> list:
        """The lead's ``t`` on every shard's device (the same tensor on the
        lead's device)."""
        return [t if d == t.device else t.to(d) for d in self.devices]

    def gather(self, parts: Sequence[torch.Tensor]) -> list:
        """Every shard's tensor on the lead's device, in shard order."""
        return [p.to(self.lead) for p in parts]

    def all_reduce_sum(self, parts: Sequence[torch.Tensor]) -> list:
        """The sum over the shards of ``parts``, on every shard."""
        return self._reduce(parts, _NCCL_SUM, torch.add)

    def all_reduce_max(self, parts: Sequence[torch.Tensor]) -> list:
        """The elementwise max over the shards of ``parts``, on every shard."""
        return self._reduce(parts, _NCCL_MAX, torch.maximum)

    def _reduce(self, parts, op: int, combine) -> list:
        parts = list(parts)
        if self.size == 1:
            return parts
        with span("fwt.all_reduce"):
            if self.transport == "nccl":
                parts = [p.contiguous() for p in parts]
                self._nccl(parts, op)
                return parts
            done = {}
            for d in self.devices:
                if d not in done:
                    acc = parts[0].to(d)
                    for p in parts[1:]:
                        acc = combine(acc, p.to(d))
                    done[d] = acc
            return [done[d] for d in self.devices]

    @staticmethod
    def _nccl(parts, op: int) -> None:
        import torch.cuda.nccl as nccl

        nccl.all_reduce(parts, op=op)


@functools.lru_cache(maxsize=None)
def single(device: torch.device) -> ShardGroup:
    """The group of one shard on ``device``: every reduction is the
    identity."""
    return ShardGroup([device])
