"""Production-mesh dry run: trace one step of every (arch x shape) cell on
the 16x16 mesh and the 2x16x16 multi-pod mesh and record its per-rank
memory, flops, bytes and collectives (the reference's ``launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape train_4k [--multi-pod] [--out results/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]

Runs on the CPU in one process.  The reference lowers and compiles on 512
forced XLA host devices; here one process stands for one rank of a fake
process group of 256 / 512 ranks (``torch.testing._internal.distributed.
fake_pg``, whose collectives move nothing), and every tensor is on the
``meta`` device: shapes and dtypes, no memory.  Parameters, moments,
batch and caches are placed by ``launch.sharding`` as DTensors, and the
cell's train, prefill or decode step runs once eagerly under the
activation rules, inside a :class:`CellRecord`, which sees each op that
runs on the rank's local tensors:

* ``memory_analysis.argument_size_in_bytes`` / ``output_size_in_bytes``:
  the placed inputs' / the step's outputs' local bytes, and
  ``argument_parts``: the arguments' bytes by part (params, moments,
  batch or token, caches);
* ``cost_analysis.flops``: the rank's flops, by ``torch.utils.flop_counter``'s
  formulas over the local ops (matmuls, attention);
* ``cost_analysis.bytes accessed``: the eager path's memory term, each
  local op's input plus output bytes summed (views excluded): every op
  reads and writes HBM, as an eager step does, where XLA's figure is of
  the fused program;
* ``collective_bytes`` (``hlo_analysis``) and the eight DTensor ops that
  issued the most collective bytes, ``roofline`` (H100 constants),
  ``model_flops``, ``params_total``/``params_active``;
* ``skipped`` cells, and ``error`` with the traceback.

Importing this module initialises no process group; ``run_cell`` does, once
per mesh size, and the group lives until the process ends.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Optional

import torch

from ..configs import ARCHS, SHAPES, get_config, get_shape
from ..configs.registry import shape_applicable
from ..models import model as M
from ..models import shardctx
from ..models.flops import (count_active_analytic, count_params_analytic,
                            model_flops)
from ..train import pytree
from ..train.optimizer import AdamWConfig
from ..train.train_step import TrainConfig, build_train_step
from . import hlo_analysis, sharding, specs

META = torch.device("meta")

# Baseline per-arch training knobs (the reference's dry-run baselines).
TRAIN_OVERRIDES = {
    "command-r-plus-104b": dict(microbatches=8, remat="full",
                                moment_dtype="float32"),
    "jamba-1.5-large-398b": dict(microbatches=8, remat="full",
                                 moment_dtype="bfloat16"),
    "llama-3.2-vision-90b": dict(microbatches=8, remat="full",
                                 moment_dtype="float32"),
    "_default": dict(microbatches=4, remat="dots_no_batch",
                     moment_dtype="float32"),
}


def _train_cfg(arch: str) -> TrainConfig:
    ov = TRAIN_OVERRIDES.get(arch, TRAIN_OVERRIDES["_default"])
    return TrainConfig(
        optimizer=AdamWConfig(moment_dtype=ov["moment_dtype"]),
        remat=ov["remat"], microbatches=ov["microbatches"])


def fake_world(world: int) -> None:
    """A fake process group of ``world`` ranks as the default group (this
    process is rank 0); one already of that size is kept."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def CellRecord():
    """A :func:`hlo_analysis.CollectiveRecord` that also sums the rank's
    flops and the input+output bytes of every non-view local op."""
    from torch.utils.flop_counter import flop_registry

    rec = hlo_analysis.CollectiveRecord()
    rec.flops = 0
    rec.op_bytes = 0
    rec.n_ops = 0

    def local_op(func, args, kwargs, out):
        packet = func._overloadpacket
        rec.n_ops += 1
        if packet in flop_registry:
            rec.flops += int(flop_registry[packet](*args, **kwargs,
                                                   out_val=out))
        if func.is_view or hlo_analysis.kind_of(
                str(packet).split(".")[-1]) != "other":
            return
        rec.op_bytes += sum(_local_bytes(x) for x in
                            pytree.leaves([list(args), out]))

    rec.local_op = local_op
    return rec


def _local_bytes(x) -> int:
    if not isinstance(x, torch.Tensor):
        return 0
    if shardctx.is_dtensor(x):
        x = x.to_local()
    return x.numel() * x.element_size()


def tree_local_bytes(tree) -> int:
    """Bytes of ``tree``'s leaves as one rank holds them."""
    return sum(_local_bytes(x) for x in pytree.leaves(tree))


def lower_cell(arch: str, shape_name: str, mesh, *, tcfg=None,
               constraints: bool = True, cfg=None):
    """One step of the cell traced on ``mesh`` with meta tensors.  Returns
    ``(record, argument bytes, output bytes)`` of one rank.  ``cfg``
    overrides the arch's config (reduced configs in tests)."""
    cfg = cfg or get_config(arch)
    shp = get_shape(shape_name)
    tcfg = tcfg or _train_cfg(arch)
    rules = (shardctx.make_rules(mesh, batch_shardable=shp.global_batch > 1,
                                 n_heads=cfg.n_heads)
             if constraints else None)
    shard_batch = shp.global_batch > 1
    params = M.init_model(cfg, 0, META, place=sharding.placer(mesh))
    rec = CellRecord()

    if shp.kind == "train":
        init_fn, step_fn = build_train_step(cfg, tcfg)
        _, opt = init_fn(0, META, place=sharding.placer(mesh))
        opt["step"] = sharding.place(opt["step"], shardctx.P(), mesh)
        batch = specs.batch_specs(cfg, seq_len=shp.seq_len,
                                  global_batch=shp.global_batch)
        batch = sharding.place(batch, sharding.batch_shardings(
            batch, mesh, shard_batch=shard_batch), mesh)
        args = (M.trainable(params), opt, batch)
        rec.argument_parts = {"params": tree_local_bytes(args[0]),
                              "opt": tree_local_bytes(opt),
                              "inputs": tree_local_bytes(batch)}
        with shardctx.use_rules(rules), rec:
            out = step_fn(params, opt, batch)
        out = (M.trainable(out[0]), out[1])
        return rec, tree_local_bytes(args), tree_local_bytes(out)

    if shp.kind == "prefill":
        batch = specs.batch_specs(cfg, seq_len=shp.seq_len,
                                  global_batch=shp.global_batch,
                                  with_labels=False)
        batch = sharding.place(batch, sharding.batch_shardings(batch, mesh),
                               mesh)
        args = (M.trainable(params), batch)
        rec.argument_parts = {"params": tree_local_bytes(args[0]),
                              "inputs": tree_local_bytes(batch)}
        with shardctx.use_rules(rules), shardctx.mixed(), rec:
            logits, caches, _ = M.prefill(cfg, params, batch)
            # The reference pins the prefill caches' out-shardings.
            caches = _constrained(caches, sharding.cache_shardings(
                caches, mesh, batch=shp.global_batch))
        return rec, tree_local_bytes(args), tree_local_bytes((logits,
                                                              caches))

    caches = specs.cache_specs(cfg, global_batch=shp.global_batch,
                               kv_len=shp.seq_len)
    caches = sharding.place(caches, sharding.cache_shardings(
        caches, mesh, batch=shp.global_batch), mesh)
    token = specs.decode_token_spec(cfg, shp.global_batch)
    token = sharding.place(token, sharding.batch_shardings(
        token, mesh, shard_batch=shard_batch), mesh)
    args = (M.trainable(params), token, caches)
    rec.argument_parts = {"params": tree_local_bytes(args[0]),
                          "inputs": tree_local_bytes(token),
                          "caches": tree_local_bytes(caches)}
    with shardctx.use_rules(rules), shardctx.mixed(), rec:
        out = M.decode_step(cfg, params, token, caches)
    return rec, tree_local_bytes(args), tree_local_bytes(out)


def _constrained(c, spec):
    """``c`` redistributed to ``spec`` leaf by leaf (the reference's
    ``out_shardings``)."""
    flat, skel = pytree.flatten(c)
    specs_ = sharding.spec_list(spec)
    out = []
    for x, s in zip(flat, specs_):
        if shardctx.is_dtensor(x):
            x = x.redistribute(x.device_mesh,
                               shardctx.to_placements(s, x.device_mesh))
        out.append(x)
    return pytree.unflatten(skel, out)


def production_mesh(multi_pod: bool):
    """The production mesh on a fake process group of its size."""
    from .mesh import make_production_mesh
    fake_world(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             out_dir: str = "results/dryrun", tcfg=None, tag: str = "",
             constraints: bool = True, cfg=None, write: bool = True):
    mesh_name = "2x16x16" if multi_pod else "16x16"
    cell = f"{arch}__{shape_name}__{mesh_name}{tag}"
    skip = shape_applicable(arch, shape_name)
    path = os.path.join(out_dir, cell + ".json")

    def done(rec):
        if write:
            os.makedirs(out_dir, exist_ok=True)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
        return rec

    if skip:
        print(f"[dryrun] {cell}: SKIP ({skip})")
        return done({"arch": arch, "shape": shape_name, "mesh": mesh_name,
                     "status": "skipped", "reason": skip})

    t0 = time.time()
    try:
        mesh = production_mesh(multi_pod)
        cfg = cfg or get_config(arch)
        record, arg_bytes, out_bytes = lower_cell(
            arch, shape_name, mesh, tcfg=tcfg, constraints=constraints,
            cfg=cfg)
        t_trace = time.time() - t0
        coll = hlo_analysis.collective_bytes(record)
        shp = get_shape(shape_name)
        chips = 512 if multi_pod else 256
        flops = float(record.flops)
        bytes_ = float(record.op_bytes)
        terms = hlo_analysis.roofline_terms(
            flops=flops, bytes_=bytes_, coll_bytes=float(coll["total"]),
            chips=chips)
        mf = model_flops(cfg, seq_len=shp.seq_len,
                         global_batch=shp.global_batch, kind=shp.kind)
        rec = {
            "arch": arch, "shape": shape_name, "mesh": mesh_name,
            "status": "ok", "t_trace_s": round(t_trace, 1),
            "memory_analysis": {"argument_size_in_bytes": arg_bytes,
                                "output_size_in_bytes": out_bytes,
                                "argument_parts": record.argument_parts},
            "cost_analysis": {"flops": flops, "bytes accessed": bytes_,
                              "local_ops": record.n_ops},
            "collective_bytes": coll,
            "collectives_by_op": dict(sorted(
                record.by_op.items(), key=lambda kv: -kv[1])[:8]),
            "roofline": terms,
            "model_flops": mf,
            "model_flops_ratio": (mf / (flops * chips)) if flops else None,
            "params_total": count_params_analytic(cfg),
            "params_active": count_active_analytic(cfg),
        }
        print(f"[dryrun] {cell}: OK trace={t_trace:.0f}s "
              f"args/rank={arg_bytes:.3e}B flops/rank={flops:.3e} "
              f"coll={coll['total']:.3e}B dominant={terms['dominant']}")
        return done(rec)
    except Exception as e:  # noqa: BLE001 - recorded per cell
        print(f"[dryrun] {cell}: ERROR {type(e).__name__}: {e}")
        return done({"arch": arch, "shape": shape_name, "mesh": mesh_name,
                     "status": "error", "error": f"{type(e).__name__}: {e}",
                     "traceback": traceback.format_exc()[-4000:]})


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--analysis", action="store_true",
                    help="no effect: the reference's unrolled-scan costing "
                    "has no meaning in an eager port, whose every layer and "
                    "microbatch runs and is counted (kept as an alias of "
                    "the default)")
    ap.add_argument("--no-constraints", action="store_true",
                    help="disable activation sharding anchors (baseline)")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    meshes = (False, True) if args.both_meshes else (args.multi_pod,)
    if args.all:
        cells = [(a, s, mp) for a in ARCHS for s in SHAPES for mp in meshes]
    else:
        cells = [(args.arch, args.shape, mp) for mp in meshes]

    out = []
    for arch, shape, mp in cells:
        mesh_name = "2x16x16" if mp else "16x16"
        path = os.path.join(args.out, f"{arch}__{shape}__{mesh_name}.json")
        if args.skip_done and os.path.exists(path):
            try:
                with open(path) as f:
                    rec = json.load(f)
                if rec.get("status") in ("ok", "skipped"):
                    print(f"[dryrun] {arch}__{shape}__{mesh_name}: cached")
                    out.append(rec)
                    continue
            except (OSError, ValueError):
                pass
        out.append(run_cell(arch, shape, multi_pod=mp, out_dir=args.out,
                            constraints=not args.no_constraints))
    return out


if __name__ == "__main__":
    main()
