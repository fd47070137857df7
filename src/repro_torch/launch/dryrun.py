"""Multi-pod dry-run (port of ``repro/launch/dryrun.py``): run every
(architecture x input-shape x mesh) cell once against the production mesh
without data, and price it with the op-level cost analysis.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --out artifacts/dryrun

A cell brings up PyTorch's fake process group of 256 (or 512) ranks in this
process (``launch.mesh.fake_world``), builds abstract parameters on the
``meta`` device (packed under ``dryrun_policy`` for the serve cells, with
Adam state for training), places them as DTensors by the spec trees of
``dist.sharding``, and runs the step once (forward, and backward for
training) under ``roofline.hlo_cost.CostMode``.  DTensor's sharding
propagation plays the part of XLA's partitioner and inserts the collectives;
the mode records the ops one rank runs.  Nothing is allocated and no data
moves, as the reference's ``ShapeDtypeStruct`` cells compile on CPU
placeholder devices.  The step runs the plain (``impl="torch"``) bodies: the
hand-written kernels take neither a DTensor nor a meta tensor.

Per cell this prints the argument bytes a device holds, the live peak, the
flops, bytes and collectives of one rank's trace and the three-term roofline
priced on ``roofline.H100_SXM``, and writes one JSON record (the reference's
keys) and the trace (``<out>/trace/<tag>.json.gz``, which
``roofline.reprice`` re-prices).  A cell whose step uses an op that DTensor
has no sharding rule for, or a data-dependent op that a meta tensor cannot
run (``.item()``, ``nonzero``, boolean indexing), fails with that op's name;
it is never quietly replicated.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import time
import traceback

import torch

from repro_torch.configs import ARCH_MODULES, applicable_shapes, get_config
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec
from repro_torch.core.policy import BitPolicy
from repro_torch.dist import sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import specs as specs_mod
from repro_torch.models import registry
from repro_torch.quant import apply as qapply
from repro_torch.roofline import hlo_cost
from repro_torch.roofline.model import H100_SXM
from repro_torch.roofline.reprice import roofline_fields
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_step import TrainConfig, make_train_step


# ---------------------------------------------------------------------------
# policies for the serve cells (no weights exist in a dry-run, so the mixed
# policy is the *representative* SigmaQuant output shape: first/embedding
# layers high-bit, bulk at 4, periodic 6-bit risers)
# ---------------------------------------------------------------------------


def dryrun_policy(specs, scheme: str) -> BitPolicy:
    if scheme.startswith("uniform"):
        return BitPolicy.uniform(specs, int(scheme.removeprefix("uniform")))
    if scheme != "mixed":
        raise ValueError(f"unknown policy scheme {scheme!r}")
    pattern = (4, 4, 6, 4)
    bits = {}
    for s in specs:
        m = re.search(r"layer(\d+)", s.name)
        if s.kind == "embedding":
            bits[s.name] = 8
        elif m and int(m.group(1)) == 0:
            bits[s.name] = 8
        else:
            bits[s.name] = pattern[(int(m.group(1)) if m else 0) % len(pattern)]
    return BitPolicy.from_bits(specs, bits)


# ---------------------------------------------------------------------------
# step builders, one per step kind: each returns (step, args)
# ---------------------------------------------------------------------------


def _abstract_params(cfg: ArchConfig) -> dict:
    """Train-layout parameters on the ``meta`` device (no allocation)."""
    return registry.get_api(cfg).init(cfg, torch.Generator(), device="meta")


def build_train(cfg: ArchConfig, shape: ShapeSpec, mesh, *, qat: bool = True,
                microbatches: int = 8, state_dtype: str = "bfloat16",
                fsdp_pod: bool = True, remat: bool = True):
    """One QAT training step (8-bit uniform fake-quant), FSDP + TP layout.
    ``remat`` is accepted and dropped, as the reference's ``build_train``
    drops it: the loss calls the forwards with their default, so each layer
    body and each loss chunk is recomputed in the backward."""
    del remat
    api = registry.get_api(cfg)
    params = _abstract_params(cfg)
    tcfg = TrainConfig(microbatches=microbatches,
                       optimizer=opt_mod.OptimizerConfig(state_dtype=state_dtype))
    opt_state = opt_mod.init(tcfg.optimizer, params)
    batch = specs_mod.train_batch(cfg, shape, abstract=True)
    bits = None
    if qat:
        policy = BitPolicy.uniform(qapply.layer_specs(params, cfg), 8)
        bits = qapply.bits_for_scan(policy, params, cfg)

    def loss_fn(p, b, bb):
        return api.loss(p, cfg, b, bits=bb, impl="torch")

    step = make_train_step(cfg, tcfg, loss_fn)
    pspec = sharding.params_specs(params, mesh, cfg, fsdp=True, fsdp_pod=fsdp_pod)
    ospec = opt_mod.state_specs(opt_state, pspec)
    args = (sharding.distribute(params, pspec, mesh),
            sharding.distribute(opt_state, ospec, mesh),
            sharding.distribute(batch, sharding.batch_specs(batch, mesh), mesh), bits)
    return step, args


def _abstract_serve_params(cfg: ArchConfig, policy: BitPolicy) -> dict:
    api = registry.get_api(cfg)
    return qapply.quantize_for_serve(api.unstack(_abstract_params(cfg), cfg), policy, cfg)


def build_prefill(cfg: ArchConfig, shape: ShapeSpec, mesh, scheme: str = "mixed", *,
                  sp: bool = False):
    api = registry.get_api(cfg)
    policy = dryrun_policy(qapply.layer_specs(_abstract_params(cfg), cfg), scheme)
    sparams = _abstract_serve_params(cfg, policy)
    inputs = specs_mod.prefill_inputs(cfg, shape, abstract=True)

    if sp:  # sequence-parallel variant: replicated weights, seq over model
        from repro_torch.models import decoder

        batch_axes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)

        def prefill_step(p, inp):
            return decoder.prefill_sp(p, cfg, inp["tokens"], mesh=mesh, impl="torch")

        ispec = {"tokens": sharding.P(batch_axes, ("model",))}
        return prefill_step, (sparams, sharding.distribute(inputs, ispec, mesh))

    def prefill_step(p, inp):
        return api.prefill(p, cfg, **inp, impl="torch")

    pspec = sharding.params_specs(sparams, mesh, cfg, fsdp=False)
    return prefill_step, (sharding.distribute(sparams, pspec, mesh),
                          sharding.distribute(inputs, sharding.batch_specs(inputs, mesh), mesh))


def build_decode(cfg: ArchConfig, shape: ShapeSpec, mesh, scheme: str = "mixed"):
    api = registry.get_api(cfg)
    policy = dryrun_policy(qapply.layer_specs(_abstract_params(cfg), cfg), scheme)
    sparams = _abstract_serve_params(cfg, policy)
    inputs = specs_mod.decode_inputs(cfg, shape, abstract=True)

    def serve_step(p, state, token, pos):
        return api.decode_step(p, cfg, state, token, pos, impl="torch")

    pspec = sharding.params_specs(sparams, mesh, cfg, fsdp=False)
    sspec = sharding.decode_state_specs(inputs["state"], mesh)
    tspec = sharding.batch_specs(inputs["token"], mesh)
    # the encoder-decoder step takes its one position as a host integer
    pos = (shape.seq_len - 1 if cfg.family in ("audio", "encdec")
           else sharding.distribute(inputs["pos"], sharding.P(), mesh))
    return serve_step, (sharding.distribute(sparams, pspec, mesh),
                        sharding.distribute(inputs["state"], sspec, mesh),
                        sharding.distribute(inputs["token"], tspec, mesh), pos)


# ---------------------------------------------------------------------------
# cell runner
# ---------------------------------------------------------------------------


def local_bytes(tree) -> int:
    """The bytes one device holds of a tree's tensors: a DTensor's local
    shard, a plain tensor whole (replicated)."""
    from torch.distributed.tensor import DTensor

    total = 0

    def add(_, x):
        nonlocal total
        if isinstance(x, DTensor):
            x = x.to_local()
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()

    sharding.map_with_path(add, tree)
    return total


@contextlib.contextmanager
def _meta_equal():
    """Give ``aten.equal`` a meta kernel for the duration of one traced step.
    DTensor's vocab-sharded lookups and gathers share a mask buffer whose
    reuse checks ``torch.equal(old, new)``; meta tensors hold no values to
    compare, and the masks of one step are the same by construction, so two
    tensors of one shape and dtype are equal.  The kernel goes when the step
    ends."""
    lib = torch.library.Library("aten", "IMPL")
    try:
        lib.impl("equal", lambda a, b: a.shape == b.shape and a.dtype == b.dtype, "Meta")
    except RuntimeError:      # this PyTorch has a meta kernel of its own
        pass
    try:
        yield
    finally:
        lib._destroy()


def _cell_mesh(multi_pod: bool, mesh_shape):
    if mesh_shape is not None:
        shape, axes = mesh_shape
        mesh_mod.fake_world(math.prod(shape))
        return mesh_mod.make_mesh_for(shape, axes, device_type="cpu")
    mesh_mod.fake_world(512 if multi_pod else 256)
    return mesh_mod.make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             scheme: str = "mixed", verbose: bool = True, variant: str = "",
             save_trace_dir: str | None = None, cfg: ArchConfig | None = None,
             shape: ShapeSpec | None = None, mesh_shape=None, **overrides) -> dict:
    """One cell -> its record.  ``cfg``, ``shape`` and ``mesh_shape`` (a
    ``(shape, axes)`` pair, over a fake world of that many ranks) replace the
    named config, the named shape and the production mesh (tests run reduced
    configs on small meshes); ``overrides`` go to the step builder (``sp=True``
    for the sequence-parallel prefill)."""
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh = _cell_mesh(multi_pod, mesh_shape)
    if shape.kind == "train":
        step, args = build_train(cfg, shape, mesh, **overrides)
    elif shape.kind == "prefill":
        step, args = build_prefill(cfg, shape, mesh, scheme, **overrides)
    else:
        step, args = build_decode(cfg, shape, mesh, scheme)
    arg_bytes = local_bytes(args)
    t0 = time.perf_counter()
    mode = hlo_cost.CostMode(device="meta")
    try:
        # plain tensors the model makes (positions, masks) count as replicated
        with sharding.activation_axes(mesh), implicit_replication(), _meta_equal(), mode:
            step(*args)
    except Exception as e:      # a cell fails with the op it stopped at
        raise RuntimeError(f"{arch} x {shape_name}: the step failed at {mode.last_op}: "
                           f"{type(e).__name__}: {e}") from e
    compile_s = time.perf_counter() - t0          # the traced run's wall time

    trace = mode.trace
    trace.meta.update(arch=arch, shape=shape_name, argument_bytes=arg_bytes)
    cost = hlo_cost.analyze(trace)
    n_chips = mesh.size()
    record = {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "mesh": "x".join(map(str, mesh.shape)), "n_chips": n_chips,
        "multi_pod": multi_pod, "scheme": scheme if shape.kind != "train" else "qat8",
        "variant": variant, "hw": H100_SXM.name,
        "compile_s": round(compile_s, 1), "ops": len(trace.records),
        **roofline_fields(cost, cfg, shape, n_chips),
        # eager PyTorch unrolls every loop: "once" is the whole trace
        "xla_flops_once": cost.flops, "xla_bytes_once": cost.bytes,
        "peak_bytes_per_device": float(arg_bytes + trace.peak_live_bytes),
        "arg_bytes_per_device": float(arg_bytes),
    }
    if verbose:
        print(f"--- {arch} x {shape_name} on {record['mesh']} "
              f"({'multi-pod' if multi_pod else 'single-pod'})"
              f"{' [' + variant + ']' if variant else ''} ---")
        print(f"  traced {len(trace.records)} ops in {compile_s:.1f}s | per device: "
              f"args={arg_bytes / 2**30:.2f}GiB live peak={trace.peak_live_bytes / 2**30:.2f}GiB "
              f"(tensors the step made; no allocator rounding, workspaces or comm buffers)")
        print(f"  cost: flops={cost.flops:.3e} bytes={cost.bytes:.3e} (eager: no fusion)")
        print(f"  collectives: { {k: f'{v / 2**20:.1f}MiB x{int(cost.coll_count[k])}' for k, v in cost.coll_bytes.items()} }")
        print(f"  roofline on {H100_SXM.name}: compute={record['compute_s'] * 1e3:.2f}ms "
              f"memory={record['memory_s'] * 1e3:.2f}ms "
              f"collective={record['collective_s'] * 1e3:.2f}ms -> dominant={record['dominant']}")
        print(f"  model_flops/flops={record['useful_flops_ratio']:.3f} "
              f"roofline_fraction={record['roofline_fraction']:.3f}")
    if save_trace_dir:
        os.makedirs(save_trace_dir, exist_ok=True)
        tag = f"{arch}_{shape_name}_{'pod2' if multi_pod else 'pod1'}"
        tag += f"_{variant}" if variant else ""
        trace.save(os.path.join(save_trace_dir, tag + ".json.gz"))
    return record


def cells(arch_filter=None, shape_filter=None):
    for arch in ARCH_MODULES:
        if arch_filter and arch != arch_filter:
            continue
        cfg = get_config(arch)
        for spec in applicable_shapes(cfg):
            if shape_filter and spec.name != shape_filter:
                continue
            yield arch, spec.name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=sorted(ARCH_MODULES), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--all", action="store_true", help="every applicable cell")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--scheme", default="mixed",
                    choices=["mixed", "uniform2", "uniform4", "uniform6", "uniform8"])
    ap.add_argument("--out", default=None, help="directory for JSON records and traces")
    args = ap.parse_args(argv)

    if not args.all and not args.arch:
        ap.error("pass --arch (and optionally --shape), or --all")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    todo = list(cells(args.arch, args.shape))
    failures = []
    for arch, shape_name in todo:
        for mp in meshes:
            try:
                rec = run_cell(arch, shape_name, multi_pod=mp, scheme=args.scheme,
                               save_trace_dir=os.path.join(args.out, "trace")
                               if args.out else None)
            except Exception:
                traceback.print_exc()
                failures.append((arch, shape_name, mp))
                continue
            print(json.dumps(rec))
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                tag = f"{arch}_{shape_name}_{'pod2' if mp else 'pod1'}_{args.scheme}.json"
                with open(os.path.join(args.out, tag), "w") as f:
                    json.dump(rec, f, indent=1)
    print(f"\n{len(todo) * len(meshes) - len(failures)}/{len(todo) * len(meshes)} cells OK")
    for f_ in failures:
        print("FAILED:", f_)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
