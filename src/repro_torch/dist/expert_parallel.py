"""The MoE layer's dispatch and combine on DTensors: global semantics, the
capacity buffer written and read shard-locally, the experts split as their
weights are.

``models.moe.moe_mlp`` hands its routed half here when its tokens are a
``DTensor`` (the dry-run's mesh); plain tensors never reach this module.
What the reference's ``moe_mlp`` does under XLA's partitioner, this does in
four steps:

  * **Global dispatch.** The routing ids ``(t, k)`` are made ``Replicate``
    (an all-gather of the batch shards) and every rank runs the plain
    ``dispatch`` on all ``t * k`` assignments: the capacity is taken over
    the global batch, the sort is the global stable sort, and the same
    assignments fall past capacity as on one device.
  * **Shard-local buffer.** Each rank writes the kept assignments of the
    tokens it holds into its own ``(E, C, d)`` buffer and leaves the other
    rows zero.  The expert MLP maps a row to a row and a zero row to zero, so
    the buffers of the batch shards are ``Partial(sum)`` pieces of the
    global buffer, and each shard's rows of the output are its own.
  * **Experts.** Where the stacked ``(E, d_in, d_out)`` weights are whole
    (serving), each rank runs every expert on its own buffer, with no
    collective, as XLA runs the reference's.  Where E is sharded over a mesh
    dim ("model": expert parallelism, training's layout), the pieces are
    summed and scattered over C across the batch dims (a reduce-scatter), the
    weights keep E sharded and gather FSDP's ``d_in``, and each rank runs its
    own experts on its share of the capacity; the outputs are all-gathered.
  * **Combine.** Each rank reads back its own tokens' k rows and sums them
    from zero in ascending expert order, as the plain layer does.

The gradients follow from the placements: a weight that every batch shard
uses is ``Partial`` in the backward (summed over the shards), a token's rows
are ``Shard`` like the token.  A layout outside these (tokens sharded over an
expert dim, a weight sharded on another dim) is redistributed to one inside
them, never guessed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch


def is_distributed(x) -> bool:
    """True for a ``DTensor``; plain tensors take the MoE layer's own path."""
    if type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _expert_dims(w) -> list[int]:
    """The mesh dims that shard a stack's expert dim (0)."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(w, DTensor):
        return []
    return [i for i, p in enumerate(w.placements) if isinstance(p, Shard) and p.dim == 0]


def _stack_of(w):
    """A stack's tensor that carries E: the float stack, or a packed one's bytes."""
    return getattr(w, "packed", w)


def _local_stack(w, ep_dims: list[int], tok_dims: list[int]):
    """One rank's experts of a stacked weight (a tensor, or a ``QuantizedTensor``
    of DTensors): E stays sharded over ``ep_dims``, every other dim is
    gathered.  The backward sums the gradient over ``tok_dims`` (each batch
    shard used the weight on its own tokens) and takes it whole where the
    tokens were whole."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if dataclasses.is_dataclass(w):
        local = dataclasses.replace(w, **{
            f.name: _local_stack(getattr(w, f.name), ep_dims, tok_dims)
            for f in dataclasses.fields(w) if isinstance(getattr(w, f.name), torch.Tensor)})
        return dataclasses.replace(local, shape=(local.packed.shape[0], *w.shape[1:]))
    if not isinstance(w, DTensor):
        return w
    # a packed stack's scale has no E to split: it is gathered whole
    ep = [i for i in ep_dims if w.placements[i] == Shard(0)]
    n = w.device_mesh.ndim
    target = [Shard(0) if i in ep else Replicate() for i in range(n)]
    grads = [Shard(0) if i in ep else Partial() if i in tok_dims else Replicate()
             for i in range(n)]
    return w.redistribute(w.device_mesh, target).to_local(grad_placements=grads)


def routed_experts(x, gates, eidx, *, n_experts: int, capacity: int, weights: tuple,
                   dispatch: Callable, experts: Callable):
    """The routed experts' sum for every token of ``x`` (a ``(B, S, d)``
    DTensor), as a DTensor of ``x``'s shape laid out along the batch as ``x``
    is (whole where the batch does not divide over its mesh dims, as
    ``sharding.batch_spec`` lays it out).

    ``gates`` / ``eidx`` are the router's ``(B * S, k)`` outputs, ``weights``
    the three stacks as the expert linears take them (float, fake-quantized,
    or packed), ``dispatch(ids, n_experts, c)`` the layer's plain dispatch
    and ``experts(buf, weights)`` its plain expert MLP on an ``(E_l, C, d)``
    buffer."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = x.device_mesh
    ep_dims = _expert_dims(_stack_of(weights[0]))
    # the tokens: the batch over the mesh dims that shard it and hold no experts
    b, s, d = x.shape
    tok_dims = [i for i, p in enumerate(x.placements)
                if isinstance(p, Shard) and p.dim == 0 and i not in ep_dims]
    if b % math.prod(mesh.size(i) for i in tok_dims):
        tok_dims = []
    tok = [Shard(0) if i in tok_dims else Replicate() for i in range(mesh.ndim)]
    t, k, c = b * s, eidx.shape[1], capacity
    x_l = x.redistribute(mesh, tok).to_local()
    (b_l,), (b0,) = compute_local_shape_and_global_offset((b,), mesh, tok)
    t_l, t0 = b_l * s, b0 * s
    x_l = x_l.reshape(t_l, d)
    g_l = gates.redistribute(mesh, tok).to_local()

    # global dispatch: every rank sorts all t * k assignments
    ids = eidx.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
    order, e_s, t_s, pos, keep = dispatch(ids, n_experts, c)

    # this rank's tokens into its slab of the buffer (the rest stay zero)
    mine = (t_s >= t0) & (t_s < t0 + t_l)
    slot = torch.where(keep & mine, e_s * c + pos, n_experts * c)
    buf = torch.zeros((n_experts * c + 1, d), dtype=x_l.dtype, device=x_l.device)
    buf[slot] = x_l[(t_s - t0).clamp(0, max(t_l - 1, 0))]
    buf = buf[:n_experts * c].view(n_experts, c, d)

    # the experts: where their weights are split (E over "model", FSDP's
    # d_in over the batch axes) the slabs are summed and scattered over C,
    # so each rank runs its experts on its share of the global buffer; where
    # they are whole, each rank runs every expert on its own slab
    ws = tuple(_local_stack(w, ep_dims, tok_dims) for w in weights)
    if ep_dims:
        n = mesh.ndim
        part = [Partial() if i in tok_dims else Replicate() for i in range(n)]
        work = [Shard(1) if i in tok_dims else Shard(0) if i in ep_dims else Replicate()
                for i in range(n)]
        shape, stride = buf.shape, buf.stride()
        share = DTensor.from_local(buf, mesh, part, run_check=False, shape=shape, stride=stride)
        y_e = experts(share.redistribute(mesh, work).to_local(), ws)
        y_e = DTensor.from_local(y_e, mesh, work, run_check=False, shape=shape, stride=stride)
        # each batch shard reads back only its own tokens' rows
        y_e = y_e.redistribute(mesh, [Replicate()] * n).to_local(grad_placements=part)
    else:
        y_e = experts(buf, ws)

    # combine this rank's tokens: assignment a = token * k + j sits at sorted
    # position inv[a]; its k rows summed from zero in ascending expert order
    inv = torch.empty_like(order)
    inv[order] = torch.arange(t * k, device=order.device)
    a_l = torch.arange(t0 * k, (t0 + t_l) * k, device=order.device)
    i_l = inv[a_l]
    keep_l = keep[i_l]
    y_tok = y_e[e_s[i_l], torch.where(keep_l, pos[i_l], 0)] \
        * (g_l.reshape(-1) * keep_l)[:, None].to(x_l.dtype)
    per_tok = y_tok.view(t_l, k, d)
    by_expert = torch.argsort(ids[t0:t0 + t_l], dim=1)
    rows = torch.arange(t_l, device=x_l.device)
    y = torch.zeros((t_l, d), dtype=x_l.dtype, device=x_l.device)
    for j in range(k):
        y = y + per_tok[rows, by_expert[:, j]]
    return DTensor.from_local(y.view(b_l, s, d), mesh, tok, run_check=False, shape=x.shape,
                              stride=(s * d, d, 1))
