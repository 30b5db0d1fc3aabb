"""Training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        [--smoke] [--steps 20 --batch 8 --seq 64] [--remat dots] \\
        [--microbatches K] [--ckpt DIR --ckpt-every N] [--eval-every N] \\
        [--device cpu]

Runs on the card unless ``--device cpu`` is given; without a card it exits
and says so.  ``--smoke`` trains the reduced same-family config.  Weights
are random, drawn on the device from ``--seed``; batch ``k`` is
``data.pipeline.batch_for_step(k)``, a function of ``k`` alone, so a run
resumed from a checkpoint (``--ckpt``: the latest step there, saved every
``--ckpt-every`` steps by the asynchronous checkpointer) sees the batches
an uninterrupted run would.  A straggler watchdog times each step up to
the synchronising read of its loss.  ``--eval-every N`` certifies the
per-domain eval loss with MISS (``integration.miss_eval``) every N steps.

``--mesh local`` covers the ranks of the default process group as a
``("data", "model")`` mesh (``launch.mesh.make_local_mesh``; with no group
initialised, a one-rank group made for the run and torn down after it);
``--mesh prod``/``prod2`` take the 16x16 / 2x16x16 production mesh and
exit unless the group has 256 / 512 ranks.  On a mesh of several ranks
the parameters are placed by ``param_shardings`` as ``init_model`` draws
them (each rank holds one full part at most beyond its shards), the
moments follow them (``opt_shardings``), each batch is placed by
``batch_shardings``, and the step runs under the activation rules
(``shardctx.make_rules``).  On a one-device mesh every spec is trivial:
the step runs on the same plain tensors as without a mesh -- an
identity, not a fallback.  Checkpoints hold whole tensors, so a run
resumes on any mesh.  Every rank prints; each loss is the global one.
"""
from __future__ import annotations

import argparse

import torch
import torch.distributed as dist

from ..configs import get_config
from ..data import pipeline
from ..models import model as M
from ..models import shardctx
from ..models.config import reduced_for_smoke
from ..train import checkpoint as ckpt
from ..train.elastic import StepWatchdog
from ..train.optimizer import AdamWConfig
from ..train.train_step import TrainConfig, build_train_step
from . import sharding
from .mesh import make_local_mesh, make_production_mesh


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default=None,
                    choices=sorted(M.REMAT_POLICIES))
    ap.add_argument("--mesh", choices=("local", "prod", "prod2"),
                    default="local")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--eval-every", type=int, default=0,
                    help="MISS-certified eval cadence (0 = off)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(argv=None) -> dict:
    """Train as ``main`` does; returns ``{"loss": last loss, "losses":
    per step, "step_s": per step seconds, "evals": MISS traces, "params"
    and "opt_state": the trained state (DTensors on a mesh of several
    ranks), "start_step": the first step run, "mesh": the mesh}``."""
    args = parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --device cpu to train on the "
                         "CPU")
    own_group = args.mesh == "local" and not dist.is_initialized()
    try:
        if args.mesh == "local":
            mesh = make_local_mesh(device_type=dev.type)
        else:
            mesh = make_production_mesh(multi_pod=args.mesh == "prod2",
                                        device_type=dev.type)
    except ValueError as e:
        raise SystemExit(f"--mesh {args.mesh}: {e}")
    try:
        return _train(args, dev, mesh)
    finally:
        if own_group:
            dist.destroy_process_group()


def _train(args, dev, mesh) -> dict:
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced_for_smoke(cfg)

    tcfg = TrainConfig(
        optimizer=AdamWConfig(lr_peak=args.lr, warmup_steps=5,
                              total_steps=max(args.steps, 10)),
        remat=args.remat, microbatches=args.microbatches)
    init_fn, step_fn = build_train_step(cfg, tcfg)
    sharded = sharding.ranks(mesh) > 1
    params, opt_state = init_fn(args.seed, dev, place=(
        sharding.placer(mesh) if sharded else None))
    params_sh = sharding.param_shardings(M.trainable(params), mesh)
    opt_sh = sharding.opt_shardings(opt_state, params_sh, mesh)
    opt_state = dict(opt_state, step=sharding.place(
        opt_state["step"], opt_sh["step"], mesh))
    rules = (shardctx.make_rules(mesh, batch_shardable=args.batch > 1,
                                 n_heads=cfg.n_heads) if sharded else None)

    start_step = 0
    saver = None
    if args.ckpt:
        saver = ckpt.AsyncCheckpointer(args.ckpt)
        last = ckpt.latest_step(args.ckpt)
        if last is not None:
            state = ckpt.restore(args.ckpt, last,
                                 {"params": M.trainable(params),
                                  "opt": opt_state},
                                 {"params": params_sh, "opt": opt_sh},
                                 mesh=mesh)
            params, opt_state = state["params"], state["opt"]
            if cfg.tie_embeddings:
                M.attach_tied_head(cfg, params)
            start_step = last + 1
            print(f"[train] resumed from step {last}")

    batch_kw = pipeline.batch_kwargs_for(cfg, args.seq)
    dog = StepWatchdog()
    out = {"losses": [], "step_s": [], "evals": [], "start_step": start_step,
           "mesh": mesh}
    try:
        for step in range(start_step, args.steps):
            dog.start()
            batch = pipeline.batch_for_step(
                step, global_batch=args.batch, seq_len=args.seq,
                vocab=cfg.vocab_size, seed=args.seed, device=dev,
                **batch_kw)
            batch = sharding.place(batch, sharding.batch_shardings(
                batch, mesh, shard_batch=args.batch > 1), mesh)
            with shardctx.use_rules(rules):
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch)
            del batch
            loss = float(metrics["loss"])        # waits for the step
            slow = dog.stop()
            out["losses"].append(loss)
            out["step_s"].append(dog.last)
            print(f"[train] step={step} loss={loss:.4f} "
                  f"lr={float(metrics['lr']):.2e}"
                  + (" STRAGGLER" if slow else ""))
            if saver and (step + 1) % args.ckpt_every == 0:
                saver.save(step, {"params": M.trainable(params),
                                  "opt": opt_state})
            if args.eval_every and (step + 1) % args.eval_every == 0:
                # The eval reads whole weights (gathered on a mesh).
                out["evals"].append(_run_miss_eval(
                    cfg, sharding.full(params), args, dev))
    finally:
        if saver:
            saver.wait()
    out["loss"] = out["losses"][-1] if out["losses"] else float("nan")
    out["params"], out["opt_state"] = params, opt_state
    return out


def main(argv=None) -> float:
    """Train; returns the last step's loss."""
    return run(argv)["loss"]


def _run_miss_eval(cfg, params, args, dev):
    from ..integration.miss_eval import MissEvalConfig, MissEvaluator

    domains = pipeline.eval_domains(cfg.vocab_size, n_domains=3,
                                    n_per=256, seq_len=args.seq, device=dev)

    def per_example_loss(tokens):
        with torch.no_grad():
            batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
            logits, _ = M.train_logits(cfg, params, batch)
            lf = logits.float()
            del logits
            logz = torch.logsumexp(lf, dim=-1)
            gold = torch.gather(lf, -1,
                                batch["labels"][..., None].long())[..., 0]
            return torch.mean(logz - gold, dim=-1)

    ev = MissEvaluator(per_example_loss, domains,
                       MissEvalConfig(epsilon=0.5, delta=0.1, B=100),
                       device=dev)
    tr = ev.certify()
    saved = tr.info["full_eval_forwards"] - tr.info["model_forwards"]
    print(f"[miss-eval] loss/domain="
          f"{tr.theta[:, 0] if tr.theta is not None else None} "
          f"err<={tr.error:.4f} forwards={tr.info['model_forwards']} "
          f"(saved {saved} vs full eval)")
    return tr


if __name__ == "__main__":
    main()
