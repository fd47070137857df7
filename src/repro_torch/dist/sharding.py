"""Sharding rule engine: head-gated TP, divisibility fallback, batch specs
(port of ``repro/dist/sharding.py``).

One layout policy shared by the dry-run, training and the elastic example:

  * **FSDP**: the in-features dim of every quantizable weight is sharded
    over the batch axes ("data", widened to ("pod", "data") when
    ``fsdp_pod``) whenever divisible.
  * **TP**: the out-features dim goes over "model", *gated*: attention
    projections shard only when the relevant head count divides the model
    axis (a head is never split), composite-packed projections (Mamba2
    ``in_proj``) and embeddings never TP-shard, and anything indivisible
    falls back to replicated rather than erroring.
  * **Experts**: stacked (E, d_in, d_out) expert weights shard E over
    "model" (expert parallelism) and d_in over the FSDP axes.
  * **Batch/activations**: leading dim over ("pod", "data") when divisible,
    otherwise fully replicated (odd smoke-test batches).
  * **KV caches**: heads over "model" when divisible, else the *sequence*
    dim (flash-decoding layout); never the head_dim.

The rules read only mesh axis names and sizes, so tests drive them with fake
mesh objects (``axis_names`` and a ``shape`` mapping, as a JAX mesh has) as
well as with a ``torch.distributed.device_mesh.DeviceMesh``.  A spec is the
port's own :class:`PartitionSpec`: a tuple with one entry per tensor dim,
``None``, an axis name or a tuple of names, entry for entry the reference's
``jax.sharding.PartitionSpec``.  :func:`to_named` turns specs into DTensor
placements over a ``DeviceMesh`` and :func:`distribute` places a tree of
meta tensors by them.  ``shard_batch_act`` is the in-model hook: the identity unless an
``activation_axes(mesh)`` scope is active, and inside one it redistributes a
DTensor's batch dim to :func:`batch_spec`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import torch
from torch.utils._pytree import GetAttrKey, MappingKey, SequenceKey

#: leaf -> cfg attribute whose head count gates tensor parallelism
_HEAD_GATED = {"wq": "n_heads", "wo": "n_heads", "wk": "n_kv_heads", "wv": "n_kv_heads"}
#: leaves whose out dim never TP-shards (composite packs / embeddings)
_NO_TP = frozenset({"in_proj", "embed"})
#: leaves the rule engine shards at all (mirrors quant.apply.QUANT_KEYS)
_WEIGHT_LEAVES = frozenset({
    "wq", "wk", "wv", "wo", "wqkv", "w_gate", "w_up", "w_gu", "w_down",
    "in_proj", "out_proj", "embed", "lm_head",
})
#: stacked per-layer subtrees (train layout)
_STACKED_KEYS = ("layers", "enc_layers", "dec_layers")


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name, or
    a tuple of names (the dim sharded over their product, the first major).
    A one-name tuple is stored as the name, as ``jax.sharding.PartitionSpec``
    stores it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of a mesh-like object
    with ``axis_names`` and a ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: int(n) for a, n in dict(mesh.shape).items()}


def _axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 0)


def _fsdp_axes(mesh, fsdp_pod: bool) -> tuple[str, ...]:
    wanted = ("pod", "data") if fsdp_pod else ("data",)
    return tuple(a for a in wanted if a in axis_sizes(mesh))


def _batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))


def _axes_size(mesh, axes: tuple[str, ...]) -> int:
    return math.prod(_axis_size(mesh, a) for a in axes) if axes else 1


def _tp_heads_ok(leaf: str, cfg, model_size: int) -> bool:
    """A head is the atomic TP unit: gate on head-count divisibility."""
    attr = _HEAD_GATED.get(leaf)
    if attr is None:
        return True
    return getattr(cfg, attr) % model_size == 0


def _weight_spec(leaf: str, shape: tuple[int, ...], mesh, *, stacked: bool,
                 fsdp: bool, fsdp_pod: bool, cfg=None) -> PartitionSpec:
    """PartitionSpec for one (possibly layer-stacked) weight leaf."""
    offset = 1 if stacked else 0
    core = shape[offset:]
    model = _axis_size(mesh, "model")
    fsdp_axes = _fsdp_axes(mesh, fsdp_pod) if fsdp else ()
    fsdp_size = _axes_size(mesh, fsdp_axes)

    def fsdp_dim(d: int):
        return fsdp_axes if fsdp_axes and d % fsdp_size == 0 else None

    if len(core) == 3:  # stacked experts (E, d_in, d_out): EP over model
        e, d_in, _ = core
        ep = ("model",) if model and e % model == 0 else None
        spec = [ep, fsdp_dim(d_in), None]
    else:
        d_in, d_out = core
        tp_ok = (model and d_out % model == 0 and leaf not in _NO_TP
                 and (cfg is None or _tp_heads_ok(leaf, cfg, model)))
        spec = [fsdp_dim(d_in), ("model",) if tp_ok else None]
    return P(*([None] * offset + spec))


def batch_spec(mesh, shape: tuple[int, ...]) -> PartitionSpec:
    """Batch-leading arrays: dim 0 over (pod, data) when divisible."""
    axes = _batch_axes(mesh)
    ok = axes and shape and shape[0] % _axes_size(mesh, axes) == 0
    return P(*((axes if ok else None,) + (None,) * (len(shape) - 1)))


def kv_cache_spec(mesh, shape: tuple[int, ...]) -> PartitionSpec:
    """(B, S, n_kv, hd) cache: heads over model if divisible, else sequence."""
    b, s, n_kv, _ = shape
    axes = _batch_axes(mesh)
    bspec = axes if axes and b % _axes_size(mesh, axes) == 0 else None
    model = _axis_size(mesh, "model")
    if model and n_kv % model == 0:
        return P(bspec, None, ("model",), None)
    if model and s % model == 0:
        return P(bspec, ("model",), None, None)
    return P(bspec, None, None, None)


# ---------------------------------------------------------------------------
# tree -> spec-tree builders
# ---------------------------------------------------------------------------


def map_with_path(fn, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over the port's parameter and state trees, the
    paths made of ``torch.utils._pytree`` key entries: dict keys
    (``MappingKey``), list / tuple indices (``SequenceKey``) and the tensor
    fields of a dataclass such as ``QuantizedTensor`` (``GetAttrKey``, as
    the reference's registered dataclasses flatten).  ``None`` stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (MappingKey(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        return type(tree)(map_with_path(fn, v, path + (SequenceKey(i),))
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_with_path(fn, getattr(tree, f.name), path + (GetAttrKey(f.name),))
            for f in dataclasses.fields(tree) if isinstance(getattr(tree, f.name), torch.Tensor)})
    return fn(path, tree)


def spec_leaves(spec_tree: Any) -> list:
    """The specs of a spec tree in the order of ``train.optimizer.leaves``
    (sorted dict keys)."""
    if isinstance(spec_tree, PartitionSpec):
        return [spec_tree]
    if isinstance(spec_tree, dict):
        return [x for k in sorted(spec_tree) for x in spec_leaves(spec_tree[k])]
    if isinstance(spec_tree, (list, tuple)):
        return [x for v in spec_tree for x in spec_leaves(v)]
    if dataclasses.is_dataclass(spec_tree) and not isinstance(spec_tree, type):
        return [x for f in dataclasses.fields(spec_tree)
                for x in spec_leaves(getattr(spec_tree, f.name))]
    return []


def _leaf_name(path) -> str:
    """Last dict-key / attribute name along a key path (skips list indices)."""
    for entry in reversed(path):
        if isinstance(entry, MappingKey):
            return str(entry.key)
        if isinstance(entry, GetAttrKey):
            return str(entry.name)
    return ""


def _shape(leaf) -> tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def params_specs(params: Any, mesh, cfg=None, *, fsdp: bool = True,
                 fsdp_pod: bool = False) -> Any:
    """Spec tree mirroring ``params``.

    Serve-layout packed weights (``fsdp=False``) are replicated: SigmaQuant
    compression is what makes full replication affordable, and it is what
    the sequence-parallel prefill assumes.
    """

    def spec(path, leaf):
        shape = _shape(leaf)
        name = _leaf_name(path)
        if not fsdp or name not in _WEIGHT_LEAVES or len(shape) < 2:
            return P()
        stacked = bool(path) and isinstance(path[0], MappingKey) \
            and str(path[0].key) in _STACKED_KEYS and len(shape) >= 3
        return _weight_spec(name, shape, mesh, stacked=stacked, fsdp=fsdp,
                            fsdp_pod=fsdp_pod, cfg=cfg)

    return map_with_path(spec, params)


def batch_specs(batch: Any, mesh) -> Any:
    """Spec tree for input batches: batch-dim sharding per leaf."""
    return map_with_path(lambda _, leaf: batch_spec(mesh, _shape(leaf)), batch)


def decode_state_specs(state: Any, mesh) -> Any:
    """Decode states: KV caches get the flash-decoding layout, SSM/conv
    states shard their batch dim only."""

    def spec(path, leaf):
        shape = _shape(leaf)
        if _leaf_name(path) in ("k", "v") and len(shape) == 4:
            return kv_cache_spec(mesh, shape)
        return batch_spec(mesh, shape)

    return map_with_path(spec, state)


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------


#: the dim name of a mesh view whose batch axes ("pod", "data") are one dim
BATCH_DIM = "pod_data"


def _dim_axes(name: str) -> tuple[str, ...]:
    return ("pod", "data") if name == BATCH_DIM else (name,)


def placement_mesh(mesh):
    """The mesh a tree laid out over ``mesh`` lives on as DTensors: ``mesh``
    itself, or, where it has both batch axes, its view with ("pod", "data")
    flattened into one dim (pod major: the same ranks in the same order), on
    which a tensor dim over both is one ``Shard``.  DTensor plans the
    redistributions of a dim held by two shards with a graph search that
    takes tens of minutes a cell; the layout is the same.  The view is built
    once and kept on ``mesh`` itself, so it lives and dies with it (equal
    meshes of two process groups each get their own)."""
    names = tuple(mesh.mesh_dim_names)
    if not {"pod", "data"} <= set(names):
        return mesh
    view = getattr(mesh, "_placement_view", None)
    if view is None:
        from torch.distributed.device_mesh import DeviceMesh

        i = names.index("pod")
        if names[i + 1] != "data":
            raise ValueError(f"mesh {names}: the batch axes must be adjacent, pod first")
        shape = list(mesh.shape)
        ranks = mesh.mesh.reshape(shape[:i] + [shape[i] * shape[i + 1]] + shape[i + 2:])
        view = DeviceMesh(mesh.device_type, ranks,
                          mesh_dim_names=names[:i] + (BATCH_DIM,) + names[i + 2:])
        mesh._placement_view = view
    return view


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a ``DeviceMesh``: :attr:`placements` gives, for each mesh
    dim, ``Shard(d)`` where tensor dim ``d``'s entry names that dim's axes,
    else ``Replicate()``.  A dim over ("pod", "data") is ``Shard(d)`` on both
    mesh dims, the first of them major, as the reference's entry orders them
    (on a :func:`placement_mesh` view, ``Shard(d)`` on their one dim)."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard

        groups = [_dim_axes(n) for n in self.mesh.mesh_dim_names]
        out = [Replicate() for _ in groups]
        for d, entry in enumerate(self.spec):
            axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
            dims = [i for i, g in enumerate(groups) if set(g) <= set(axes)]
            if [a for i in dims for a in groups[i]] != list(axes):
                raise ValueError(f"spec {self.spec}: dim {d}'s axes {axes} are not whole dims "
                                 f"of the mesh {tuple(self.mesh.mesh_dim_names)} in its order")
            for i in dims:
                out[i] = Shard(d)
        return tuple(out)


def to_named(spec_tree: Any, mesh) -> Any:
    """PartitionSpec tree -> :class:`NamedSharding` tree over ``mesh``."""
    if isinstance(spec_tree, PartitionSpec):
        return NamedSharding(mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: to_named(v, mesh) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(to_named(v, mesh) for v in spec_tree)
    if dataclasses.is_dataclass(spec_tree) and not isinstance(spec_tree, type):
        return dataclasses.replace(spec_tree, **{
            f.name: to_named(getattr(spec_tree, f.name), mesh)
            for f in dataclasses.fields(spec_tree)
            if isinstance(getattr(spec_tree, f.name), PartitionSpec)})
    return spec_tree


def local_shape(shape: tuple[int, ...], spec: PartitionSpec, mesh) -> tuple[int, ...]:
    """One device's shard shape of a ``shape`` tensor laid out by ``spec``."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        n = math.prod(sizes[a] for a in axes)
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide over {axes}")
        out[d] //= n
    return tuple(out)


def distribute(tree: Any, spec_tree: Any, mesh) -> Any:
    """Each (meta) tensor of ``tree`` as a ``DTensor`` of meta shards over
    ``placement_mesh(mesh)``, laid out by the matching spec of ``spec_tree`` (a tree of the
    same structure): the dry-run's placement, nothing allocated.  Non-tensor
    leaves pass through."""
    from torch.distributed.tensor import DTensor

    if isinstance(spec_tree, PartitionSpec):
        if not isinstance(tree, torch.Tensor):
            return tree
        if not tree.is_meta:
            raise ValueError("distribute places meta tensors (the dry-run's)")
        shard = torch.empty(local_shape(tuple(tree.shape), spec_tree, mesh), dtype=tree.dtype,
                            device="meta")
        pmesh = placement_mesh(mesh)
        return DTensor.from_local(shard, pmesh, NamedSharding(pmesh, spec_tree).placements,
                                  run_check=False, shape=tree.shape, stride=tree.stride())
    if isinstance(tree, dict):
        return {k: distribute(v, spec_tree[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute(v, s, mesh) for v, s in zip(tree, spec_tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: distribute(getattr(tree, f.name), getattr(spec_tree, f.name), mesh)
            for f in dataclasses.fields(tree) if isinstance(getattr(tree, f.name), torch.Tensor)})
    return tree


def keep_heads_whole(x: torch.Tensor, n_groups: int, dim: int = -1) -> torch.Tensor:
    """A head is the atomic TP unit: before ``dim`` is split into ``n_groups``
    leading groups (heads x head_dim, or KV groups x query heads), a DTensor
    whose ``dim`` is sharded over mesh dims whose size does not divide
    ``n_groups`` is replicated over those dims (DTensor may shard a
    projection's output over "model" on its own, and cannot then unflatten
    the dim).  Any other tensor passes through."""
    if type(x) is torch.Tensor:
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    dims = [i for i, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == dim]
    if not dims or n_groups % math.prod(x.device_mesh.size(i) for i in dims) == 0:
        return x
    return x.redistribute(x.device_mesh, [Replicate() if i in dims else p
                                          for i, p in enumerate(x.placements)])


def whole_dim(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Before a reduction over ``dim`` whose result meets ``x`` again (a
    LayerNorm's mean and variance), a DTensor whose ``dim`` is sharded is
    replicated over those mesh dims: the statistics are then whole on every
    rank, where DTensor would keep them as ``Partial(avg)`` and meet the
    ``Partial(sum)`` gradient of a sharded matmul in the backward, which it
    cannot redistribute.  Any other tensor passes through."""
    return keep_heads_whole(x, 1, dim)


def batch_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)``.  Two DTensors sharded only on dims that
    both operands and the result carry (attention's batch and heads), each
    mesh dim on the same dim or on one operand only (the other is sliced to
    match, no data moves), are multiplied shard by shard: the result is exact,
    and some PyTorch versions' DTensor einsum flattens those dims together
    and refuses to flatten a sharded one.  Any other pair goes to
    ``torch.einsum``."""
    if type(a) is torch.Tensor and type(b) is torch.Tensor:
        return torch.einsum(eq, a, b)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not (isinstance(a, DTensor) and isinstance(b, DTensor)) or a.device_mesh != b.device_mesh:
        return torch.einsum(eq, a, b)
    ins, out = eq.replace(" ", "").split("->")
    sa, sb = ins.split(",")

    def letters(x, subs):
        if not all(isinstance(p, (Replicate, Shard)) for p in x.placements):
            return None
        return [subs[p.dim] if isinstance(p, Shard) else None for p in x.placements]

    la, lb = letters(a, sa), letters(b, sb)
    if la is None or lb is None or any(x and y and x != y for x, y in zip(la, lb)):
        return torch.einsum(eq, a, b)
    sharded = [x or y for x, y in zip(la, lb)]
    if all(c is None for c in sharded) or any(
            c and (c not in sa or c not in sb or c not in out
                   or a.shape[sa.index(c)] != b.shape[sb.index(c)]) for c in sharded):
        return torch.einsum(eq, a, b)
    mesh = a.device_mesh
    a_l = a.redistribute(mesh, [Shard(sa.index(c)) if c else Replicate() for c in sharded])
    b_l = b.redistribute(mesh, [Shard(sb.index(c)) if c else Replicate() for c in sharded])
    # contiguous, as the global stride below says (later reshapes view it)
    y = torch.einsum(eq, a_l.to_local(), b_l.to_local()).contiguous()
    size = {**dict(zip(sb, b.shape)), **dict(zip(sa, a.shape))}
    shape = torch.Size(size[c] for c in out)
    return DTensor.from_local(y, mesh, [Shard(out.index(c)) if c else Replicate()
                                        for c in sharded],
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


class _OnGrad(torch.autograd.Function):
    """The identity, whose backward passes the gradient through ``fn``."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def _on_grad(x: torch.Tensor, fn) -> torch.Tensor:
    if type(x) is torch.Tensor:
        return x
    from torch.distributed.tensor import DTensor

    return _OnGrad.apply(x, fn) if isinstance(x, DTensor) else x


def _contiguous_shard(g):
    from torch.distributed.tensor import DTensor

    if isinstance(g, DTensor) and not g.to_local().is_contiguous():
        return DTensor.from_local(g.to_local().contiguous(), g.device_mesh, g.placements,
                                  run_check=False, shape=g.shape, stride=g.stride())
    return g


def contiguous_grad(x: torch.Tensor) -> torch.Tensor:
    """A matmul's output whose gradient may arrive as a DTensor with a padded,
    non-contiguous local shard (a dim sharded unevenly, gathered and cut back
    to size, as whisper's 1500 frames over 16 ranks are): the backward makes
    the shard contiguous before the matmul's own backward views it flat, which
    DTensor's metadata says it may.  Plain tensors pass through untouched."""
    return _on_grad(x, _contiguous_shard)


def grad_heads_whole(x: torch.Tensor, n_groups: int, dim: int = -1) -> torch.Tensor:
    """The backward's twin of :func:`keep_heads_whole`, for a tensor whose
    ``dim`` was flattened from ``n_groups`` leading groups (attention's KV
    groups x query heads): its gradient is unflattened there, and DTensor may
    hand it sharded over a mesh dim (an FSDP axis of the next projection) that
    does not divide the groups.  Plain tensors pass through untouched."""
    return _on_grad(x, lambda g: keep_heads_whole(g, n_groups, dim))


def write_positions(buf, pos: torch.Tensor, val) -> None:
    """``buf[b, pos[b]] = val[b]`` for every row b of a (B, S, ...) DTensor,
    in place and shard-locally: each rank writes the rows and the position
    its shard holds and leaves the rest (DTensor has no in-place
    ``index_put_`` on a sharded dim; this is what XLA's dynamic-update-slice
    on a sharded operand does).  ``pos`` is (B,) and in range."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = buf.device_mesh
    local = buf.to_local()
    lshape, off = compute_local_shape_and_global_offset(buf.shape, mesh, buf.placements)
    (bl, sl), (b0, s0) = lshape[:2], off[:2]
    if isinstance(pos, DTensor):
        pos = pos.full_tensor()
    pos_l = pos[b0:b0 + bl] - s0
    inside = (pos_l >= 0) & (pos_l < sl)
    pos_l = pos_l.clamp(0, sl - 1)
    # val is buf without the sequence dim: buf's dim d > 1 is val's d - 1
    if isinstance(val, DTensor):
        like = tuple(Shard(p.dim - (p.dim > 1)) if isinstance(p, Shard) and p.dim != 1
                     else Replicate() for p in buf.placements)
        val = val.redistribute(mesh, like).to_local()
    else:
        val = val[tuple(slice(o, o + n) for o, n in zip(off[:1] + off[2:],
                                                         lshape[:1] + lshape[2:]))]
    rows = torch.arange(bl, device=local.device)
    keep = inside.reshape(-1, *([1] * (val.ndim - 1)))
    local[rows, pos_l] = torch.where(keep, val.to(local.dtype), local[rows, pos_l])


# ---------------------------------------------------------------------------
# in-model activation constraints
# ---------------------------------------------------------------------------

_ACT_MESH: list[Any] = []


@contextlib.contextmanager
def activation_axes(mesh):
    """Enable ``shard_batch_act`` constraints against ``mesh`` within scope."""
    _ACT_MESH.append(mesh)
    try:
        yield mesh
    finally:
        _ACT_MESH.pop()


def shard_batch_act(x: torch.Tensor) -> torch.Tensor:
    """Pin an activation's batch sharding.

    The identity when no ``activation_axes`` scope is active (so single-device
    code pays nothing) and for a plain tensor; a DTensor is redistributed, on
    its own mesh, to :func:`batch_spec`'s layout over the scope's mesh.
    """
    if not _ACT_MESH:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    spec = batch_spec(_ACT_MESH[-1], tuple(x.shape))
    placements = NamedSharding(x.device_mesh, spec).placements
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)
