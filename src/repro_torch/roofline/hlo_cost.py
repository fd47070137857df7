"""Op-level cost analysis of a traced run (the port's twin of
``repro/roofline/hlo_cost.py``).

PyTorch has no compiled module to parse, so the source of counts is a trace
of the aten ops one device runs: :class:`CostMode`, a ``TorchDispatchMode``,
records each op's name, its tensor operands' and results' shapes and dtypes,
and for a collective its kind and group size.  Under DTensor the mode sees
the ops on the local shards and the collectives that DTensor's sharding
propagation inserts (the part XLA's partitioner plays in the reference), so
the counts are per device.  :func:`analyze` prices a trace with the
reference's conventions:

    flops:  a dot (mm, bmm, addmm, baddbmm, ...) = 2 * |out| * K (K the
            contracted length); a convolution 2 * |out| * (kernel / out
            channels); elementwise ops (bitwise, shift and logical ops
            among them) ~ |out|; reductions ~ |in|; data movement (copies,
            casts, concatenation, gathers, compares, selects, padding) 0.
    bytes:  per op, sum(|operands|) + |out|; views are free (``bitcast``); a
            slice update (``copy_`` into a view, ``slice_scatter``,
            ``index_put_``, ``scatter``) touches only the slice; a gather
            touches the rows it reads; allocation without a fill is free.
    collectives: result bytes x wire factor (all-reduce 2, all the others 1).

Two things differ from the reference by construction.  Eager PyTorch
unrolls every loop, so "loop-aware" pricing falls out of the trace: an op in
a Python loop is recorded once per trip.  And eager PyTorch has no fusion:
every op reads its operands from memory and writes its result, so the bytes
exceed XLA's, which count only fusion boundaries.
"""
from __future__ import annotations

import dataclasses
import gzip
import json
import math
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

#: bytes per element, by torch dtype name (the port's copy of the reference's
#: table, which is keyed by XLA's type names)
_DTYPE_BYTES = {
    "float64": 8, "float32": 4, "float16": 2, "bfloat16": 2, "float8_e4m3fn": 1,
    "float8_e5m2": 1, "int64": 8, "uint64": 8, "int32": 4, "uint32": 4, "int16": 2,
    "uint16": 2, "int8": 1, "uint8": 1, "bool": 1, "complex64": 8, "complex128": 16,
}

_WIRE_FACTOR = {
    "all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
    "all-to-all": 1.0, "collective-permute": 1.0, "broadcast": 1.0,
}

#: functional / c10d collective op -> the reference's collective kind
_COLLECTIVE_KIND = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced":
    "reduce-scatter", "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_":
    "reduce-scatter", "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}

#: ops that move no data (layout / bookkeeping / allocation without a fill)
_FREE = frozenset({
    "empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided", "detach",
    "alias", "lift_fresh", "wait_tensor", "_wrap_tensor_autograd", "_local_scalar_dense",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "set_", "resize_",
})

_DOTS = frozenset({"mm", "bmm", "matmul", "dot", "mv", "vdot", "addmm", "baddbmm", "addbmm",
                   "addmv", "_scaled_mm"})
_CONVS = frozenset({"convolution", "_convolution", "conv2d", "conv1d", "conv3d"})
#: in-place slice writes priced like XLA's dynamic-update-slice (2 x update)
_SLICE_WRITES = frozenset({"copy_", "slice_scatter", "select_scatter", "diagonal_scatter",
                           "as_strided_scatter", "copy"})
#: scatters priced like XLA's scatter (3 x update)
_SCATTERS = frozenset({"index_put_", "index_put", "_index_put_impl_", "scatter", "scatter_",
                       "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_",
                       "index_copy", "index_copy_", "index_add", "index_add_", "index_fill_",
                       "masked_scatter", "masked_scatter_"})
_GATHERS = frozenset({"gather", "index_select", "embedding", "index", "take",
                      "take_along_dim", "_embedding_bag"})
_REDUCTIONS = frozenset({"sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
                         "var", "std", "var_mean", "std_mean", "norm", "linalg_vector_norm",
                         "argmax", "argmin", "any", "all", "cumsum", "cumprod", "_softmax",
                         "_log_softmax", "softmax", "log_softmax", "topk", "sort", "kthvalue",
                         "nansum", "count_nonzero", "aminmax", "_foreach_norm"})
#: data movement: bytes, no flops (the reference's copy/convert/concatenate/
#: pad/select/compare/iota/broadcast class).  Bitwise, shift and logical ops
#: are elementwise there (and, or, not, xor, shift-left, shift-right-*), so
#: they are not here: they count |out| flops
_MOVES = frozenset({
    "_to_copy", "clone", "contiguous", "cat", "stack", "constant_pad_nd", "pad", "where",
    "eq", "ne", "lt", "le", "gt", "ge", "flip", "roll", "repeat", "repeat_interleave",
    "expand_copy", "masked_fill", "masked_fill_", "fill", "fill_", "zero_", "zeros",
    "zeros_like", "ones", "ones_like", "full", "full_like", "new_zeros", "new_ones",
    "new_full", "scalar_tensor", "arange", "tril", "triu", "isnan", "isinf",
    "_unsafe_index", "unfold_copy", "view_copy", "permute_copy", "transpose_copy", "t_copy",
    "unsqueeze_copy", "squeeze_copy", "slice_copy", "select_copy", "split_copy",
    "unbind_copy",
})


def _base(op: str) -> str:
    """``aten.mm.default`` -> ``mm``; ``_c10d_functional.all_reduce.default`` -> ``all_reduce``."""
    parts = op.split(".")
    return parts[1] if len(parts) >= 2 else parts[0]


def _elems(shape) -> float:
    return float(math.prod(shape)) if shape else 1.0


def _nbytes(t) -> float:
    shape, dtype = t
    return _elems(shape) * _DTYPE_BYTES.get(dtype, 4)


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    coll_count: dict = dataclasses.field(default_factory=lambda: defaultdict(float))

    def add(self, other: "Cost") -> None:
        self.flops += other.flops
        self.bytes += other.bytes
        for k, v in other.coll_bytes.items():
            self.coll_bytes[k] += v
        for k, v in other.coll_count.items():
            self.coll_count[k] += v

    @property
    def coll_wire_bytes(self) -> float:
        return sum(v * _WIRE_FACTOR[k] for k, v in self.coll_bytes.items())


def op_cost(rec: dict) -> Cost:
    """The cost of one recorded op (see the module docstring)."""
    c = Cost()
    base = _base(rec["op"])
    ins, outs = rec["in"], rec["out"]
    in_bytes = sum(_nbytes(t) for t in ins)
    out_bytes = sum(_nbytes(t) for t in outs)
    out_elems = sum(_elems(t[0]) for t in outs)
    kind = rec.get("coll")
    if kind:
        c.coll_bytes[kind] += out_bytes
        c.coll_count[kind] += 1
        c.bytes += in_bytes + out_bytes
        return c
    if rec.get("view") or base in _FREE:
        return c
    if base in _DOTS:
        lhs = ins[1] if base in ("addmm", "baddbmm", "addbmm", "addmv") else ins[0]
        k = lhs[0][-1] if lhs[0] else 1
        c.flops += 2.0 * out_elems * k
        c.bytes += in_bytes + out_bytes
        return c
    if base in _CONVS:
        kern = ins[1][0] if len(ins) > 1 else ()
        per_out = _elems(kern[1:]) if len(kern) > 1 else 1.0
        c.flops += 2.0 * out_elems * per_out
        c.bytes += in_bytes + out_bytes
        return c
    if base in _SLICE_WRITES:
        upd = _nbytes(ins[1]) if len(ins) > 1 else out_bytes
        c.bytes += 2 * upd + 64
        return c
    if base in _SCATTERS:
        upd = _nbytes(ins[-1]) if len(ins) >= 2 else out_bytes
        c.bytes += 3 * upd + 64
        return c
    if base in _GATHERS:
        c.bytes += 2 * out_bytes
        return c
    if base in _REDUCTIONS:
        c.flops += _elems(ins[0][0]) if ins else out_elems
        c.bytes += in_bytes + out_bytes
        return c
    if base in _MOVES:
        c.bytes += in_bytes + out_bytes
        return c
    # generic elementwise / everything else: 1 flop per output element
    c.flops += out_elems
    c.bytes += in_bytes + out_bytes
    return c


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Trace:
    """The ops one device ran, in order, and what the recording mode saw of
    memory: ``peak_live_bytes`` is the largest sum of the storages that ops
    inside the mode created and that were alive together."""

    records: list = dataclasses.field(default_factory=list)
    peak_live_bytes: float = 0.0
    meta: dict = dataclasses.field(default_factory=dict)

    def save(self, path: str) -> None:
        with gzip.open(path, "wt") as f:
            json.dump({"records": self.records, "peak_live_bytes": self.peak_live_bytes,
                       "meta": self.meta}, f)

    @classmethod
    def load(cls, path: str) -> "Trace":
        with gzip.open(path, "rt") as f:
            d = json.load(f)
        return cls(d["records"], d["peak_live_bytes"], d.get("meta", {}))


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _desc(t: torch.Tensor) -> list:
    return [list(t.shape), str(t.dtype).removeprefix("torch.")]


def _storage_key(t: torch.Tensor):
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return None


def _group_size(base: str, args) -> int:
    ints = [a for a in args if isinstance(a, int) and not isinstance(a, bool)]
    names = [a for a in args if isinstance(a, str)]
    if base.startswith(("all_gather", "reduce_scatter")) and ints:
        return ints[-1]
    if names:
        from torch.distributed.distributed_c10d import _resolve_process_group

        try:
            return _resolve_process_group(names[-1]).size()
        except (KeyError, ValueError, RuntimeError):  # a name this process cannot resolve
            return 0
    return 0


class CostMode(TorchDispatchMode):
    """Records every aten op run inside it into :attr:`trace`.

    Ops on a tensor subclass (``DTensor``, a functional collective's async
    result) are handed back to the subclass, which runs its local ops on
    plain tensors under this mode: the trace holds one device's work.  Ops
    that DTensor's sharding propagation runs on fake tensors (global shapes,
    no work) are not recorded, nor, given ``device``, ops that touch no
    tensor of that device type (DTensor plans a redistribution over a mesh of
    three dims with index tensors on the CPU, while the dry-run's work is on
    ``meta``).
    """

    def __init__(self, device: str | None = None):
        super().__init__()
        self.device = device
        self.last_op = ""              # the op dispatched last (a failed step's op)
        self.trace = Trace()
        self._live: dict[int, float] = {}
        self._holders: dict[int, int] = defaultdict(int)
        self._live_bytes = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor

        kwargs = kwargs or {}
        self.last_op = str(func)
        if any(t is not torch.Tensor and not issubclass(t, FakeTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        seen = ins + outs
        if (not any(isinstance(t, FakeTensor) for t in seen)
                and (self.device is None or any(t.device.type == self.device for t in seen))):
            self._record(func, args, ins, outs)
        return out

    def _record(self, func, args, ins, outs) -> None:
        name = str(func)
        base = _base(name)
        rec = {"op": name, "in": [_desc(t) for t in ins], "out": [_desc(t) for t in outs]}
        if getattr(func, "is_view", False):
            rec["view"] = True
        ns = name.split(".")[0]
        if ns in ("_c10d_functional", "c10d") and base in _COLLECTIVE_KIND:
            rec["coll"] = _COLLECTIVE_KIND[base]
            rec["group"] = _group_size(base, args)
        self.trace.records.append(rec)
        seen = {_storage_key(t) for t in ins}
        for t in outs:
            self._hold(t, seen)

    def _hold(self, t: torch.Tensor, inputs: set) -> None:
        """Count a result's storage as live while any result on it lives; a
        storage an input already had (a view, an in-place result) is new only
        if an earlier op inside the mode made it."""
        key = _storage_key(t)
        if key is None or (key in inputs and key not in self._live):
            return
        if key not in self._live:
            self._live[key] = float(t.untyped_storage().nbytes())
            self._live_bytes += self._live[key]
            self.trace.peak_live_bytes = max(self.trace.peak_live_bytes, self._live_bytes)
        self._holders[key] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        self._holders[key] -= 1
        if self._holders[key] == 0:
            self._live_bytes -= self._live.pop(key, 0.0)
            del self._holders[key]


def analyze(trace: Trace | list) -> Cost:
    """Price a trace (a :class:`Trace` or its list of records) op by op."""
    total = Cost()
    for rec in getattr(trace, "records", trace):
        total.add(op_cost(rec))
    return total
