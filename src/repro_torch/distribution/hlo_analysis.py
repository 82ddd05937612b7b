"""What a traced step costs: FLOPs, bytes and collective traffic.

The JAX package parses XLA's optimized HLO text for its collectives.
PyTorch has no HLO; its counterpart is the step itself, traced with fake
tensors on a fake process group (``launch/dryrun.py``).  A
:class:`StepRecorder` (a ``TorchDispatchMode``) lets DTensor turn each op
into its per-device local ops and collectives first, then sees those:

* each local op's FLOPs (``torch.utils.flop_counter``'s formulas), so
  the count is per device by construction;
* each local op's input plus output bytes, views excluded: a no-fusion
  upper bound, as XLA's "bytes accessed" is;
* each collective of ``torch.ops._c10d_functional`` /
  ``c10d_functional`` / ``c10d`` as a :class:`CollectiveRecord`.

:func:`collective_bytes` prices the records with the JAX package's
per-device transfer conventions.  The port's layers are a Python loop,
traced unrolled, so the scan trip count is 1.
"""
from __future__ import annotations

import dataclasses
import sys
import traceback
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# op name (functional or c10d) -> collective kind
_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional",
                  "_c10d_functional_autograd", "c10d")


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    """One collective of a traced step: its kind, the op that ran it,
    its operand and output bytes on one device, the device type the
    step was traced for (the CPU's fake group runs all-to-all as an
    all-gather) and the model line that caused it."""

    kind: str
    op: str
    in_bytes: int
    out_bytes: int
    device_type: str = ""
    site: str = ""


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(x)[0]
               if isinstance(t, torch.Tensor))


def transfer_bytes(rec: CollectiveRecord) -> int:
    """Per-device transferred bytes of one collective (ring algorithms,
    n large): all-gather ~ output bytes, reduce-scatter ~ operand bytes,
    all-reduce ~ 2 x output bytes, all-to-all and permute ~ output
    bytes."""
    if rec.kind == "reduce-scatter":
        return rec.in_bytes or rec.out_bytes
    if rec.kind == "all-reduce":
        return 2 * rec.out_bytes
    return rec.out_bytes


def collective_bytes(records, scan_trip_count: int = 1) -> dict:
    """Per-kind transferred bytes of ``records`` and their ``total``;
    ``scan_trip_count`` scales them all (1: the port's layer loop is
    traced unrolled)."""
    total: dict = defaultdict(int)
    for rec in records:
        total[rec.kind] += transfer_bytes(rec) * scan_trip_count
    out = dict(total)
    out["total"] = sum(total.values())
    return out


def bytes_by_site(records, top: int | None = None) -> dict:
    """Transferred bytes per model line, largest first."""
    per: dict = defaultdict(int)
    for rec in records:
        per[rec.site] += transfer_bytes(rec)
    items = sorted(per.items(), key=lambda kv: -kv[1])
    return dict(items[:top] if top else items)


def _in_sharding_propagation() -> bool:
    """Whether the op runs inside DTensor's sharding propagation, which
    runs ops on global-shape fake tensors to infer output shapes."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, type) and issubclass(t, DTensor)


class StepRecorder(TorchDispatchMode):
    """Counts a traced step's per-device FLOPs and bytes and records its
    collectives (see the module docstring).  DTensor ops are passed back
    (``NotImplemented``) so DTensor runs first and this mode sees the
    local ops and collectives it turns into."""

    def __init__(self, device_type: str = ""):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.device_type = device_type
        self.flops = 0
        self.bytes_accessed = 0
        self.ops = 0
        self.collectives: list[CollectiveRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_sharding_propagation():
            return out      # DTensor's shape inference, not device work
        name = func.__name__.split(".")[0]
        if func.namespace in _COLLECTIVE_NS:
            kind = _KIND.get(name)
            if kind is not None:
                self.collectives.append(CollectiveRecord(
                    kind, f"{func.namespace}.{name}", _nbytes(args),
                    _nbytes(out), self.device_type, _model_site()))
            return out
        self.ops += 1
        packet = func._overloadpacket
        if packet in self._flop_registry:
            self.flops += int(self._flop_registry[packet](
                *args, **kwargs, out_val=out))
        rets = func._schema.returns
        if not (rets and rets[0].alias_info is not None
                and not rets[0].alias_info.is_write):
            self.bytes_accessed += _nbytes(args) + _nbytes(kwargs) \
                + _nbytes(out)
        return out


def _model_site() -> str:
    """``file:line`` of the innermost model frame on the stack."""
    for fr in reversed(traceback.extract_stack()):
        if "/repro_torch/models/" in fr.filename.replace("\\", "/"):
            return f"{fr.filename.rsplit('repro_torch/', 1)[-1]}:{fr.lineno}"
    return "backward/optimizer"
