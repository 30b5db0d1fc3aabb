"""LM serving entry point: continuous-batching decode of random prompts.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        [--smoke] [--layers N] [--device cpu] [--requests 6 --slots 2]
        [--prompt-len N]

``--arch`` is any arch of ``configs.ARCHS``: dense (qwen2-1.5b, qwen3-1.7b,
h2o-danube-3-4b, command-r-plus-104b), MoE (granite-moe-1b-a400m,
deepseek-moe-16b), SSM (rwkv6-7b) and hybrid (jamba-1.5-large-398b); the
encoder-decoder and vision archs (seamless-m4t-large-v2,
llama-3.2-vision-90b) are refused, as the reference's serve demo refuses
them: the batcher carries no cross-attention memory.  Runs
on the card unless ``--device cpu`` is given; ``--smoke`` serves the reduced
same-family config, ``--layers N`` the full width cut to N layers (a
multiple of the layer pattern's length: 8 for Jamba).  A model whose
weights do not fit the card's memory (command-r-plus-104b: 208 GB of bf16
weights at full depth; jamba-1.5-large-398b: ~800 GB) is refused unless
cut.  Prompts are random, 4-11 tokens or ``--prompt-len`` each; a length
that breaks the chunk rule of the Mamba or RWKV scans (a multiple of the
chunk, or shorter) is refused with a message.  Weights are random, drawn on
the device from a ``torch.Generator`` seeded with ``--seed``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import get_config
from ..kernels.decode_attention import ops as da_ops
from ..models import flops
from ..models import model as M
from ..models.config import reduced_for_smoke
from ..serve.batching import ContinuousBatcher, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=None,
                    help="tokens a prompt (default: 4-11 at random)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced_for_smoke(cfg)
    if cfg.is_encdec or cfg.family == "vision":
        raise SystemExit("serve demo targets decoder-only archs")
    if args.layers is not None:
        pat = len(cfg.layer_pattern)
        if args.layers < 1 or args.layers % pat:
            raise SystemExit(f"{cfg.name}: --layers {args.layers} is not a "
                             f"positive multiple of its layer pattern "
                             f"{cfg.layer_pattern} ({pat} layers)")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA card: pass --device cpu to serve on "
                             "the CPU")
        need = flops.weight_bytes(cfg)
        have = torch.cuda.get_device_properties(dev).total_memory
        if need > have:
            raise SystemExit(
                f"{cfg.name}: {need / 1e9:.0f} GB of weights at "
                f"{cfg.n_layers} layers do not fit the card's "
                f"{have / 1e9:.0f} GB; pass --smoke or --layers N")

    params = M.init_model(cfg, args.seed, device=dev)
    batcher = ContinuousBatcher(cfg, params, slots=args.slots, s_max=128)
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        n = args.prompt_len or rng.integers(4, 12)
        prompt = rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
        try:
            batcher.submit(Request(rid=rid, prompt=prompt,
                                   max_new_tokens=args.max_new))
        except ValueError as e:
            raise SystemExit(f"prompt {rid} refused: {e}") from None
    da_ops.counter.reset()
    t0 = time.perf_counter()
    done = batcher.run()
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.out_tokens) for r in done)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[serve] {cfg.name} on {where}: {len(done)} requests, "
          f"{total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens / max(dt, 1e-9):.1f} tok/s), decode-attention "
          f"kernel launches {da_ops.counter.launches}")
    for r in sorted(done, key=lambda r: r.rid):
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.out_tokens}")
    return done


if __name__ == "__main__":
    main()
