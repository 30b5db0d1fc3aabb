#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs a CUDA
card and exits non-zero without one.  Phases, in order; any failure exits
non-zero and nothing falls back to the CPU:

1. card and build: print the card's name and power limit, build the three
   kernel libraries from ``src/repro_torch/csrc`` with nvcc, one process per
   source, all started together, and count the two bootstrap kernels'
   instructions a (element, replicate) pair in their SASS, by pipe: the
   operation bound of both (the 30-integer-op estimate printed beside it);
2. Poisson-bootstrap kernel against its plain PyTorch version on the card at
   the serve phase's tier shape (4 lanes x 4 groups, B = 300) on every rung
   of the width ladder and on stacked init-probe windows at w = 8192: rtol
   1e-5 (bit-exact expected: same summation order), gated == ungated and
   narrow == wide bucket bit-exact, two calls and two graph replays
   bit-equal, one device kernel a call; kernel and plain times from CUDA
   events against the kernel's operation bound, the kernel's both eagerly
   back to back and from a CUDA graph of 20 calls;
3. segment-bootstrap kernel at the grouped serve phase's block (9 lanes of
   lineitem SF10 GROUP BY TAX, B = 300) on packed streams of live windows at
   every ``seg_ladder`` rung: against its plain version (rtol 1e-5, bit-exact
   expected) and against the Poisson-bootstrap kernel on the same windows
   (bit-exact: same order); a masked-out (gated) lane adds nothing; kernel
   times (eager and from a CUDA graph) against the operation bound, the
   plain version's at L = 8192; then the serve's own streams (stacked init
   probes and the 2000-wide probes after them, and L = 9000 with the
   windows at slot 0 and at the end of the buffer), bit-exact and timed
   from graphs; two calls and two graph replays bit-equal, one device kernel
   a call;
4. exact segment-aggregate kernel over the whole 60 M-row table GROUP BY
   TAX: against its plain version (bit-exact expected) and numpy float64
   (sums rtol 1e-4, min/max exact); kernel, plain and library (index_add_
   of the five powers plus two scatter_reduce_) times against the byte
   bound;
5. the card against the CPU at the CPU tests' size: ``fused_l2miss``, a small
   ``LanePool`` and ``fused_grouped`` with the same seeds; integer
   trajectories exact, theta rtol 1e-5, error rtol 1e-4, beta norm-wise rtol
   1e-4; a pool lane equal to its solo run and a pool block equal to
   ``fused_grouped`` bit for bit on the card;
6. solo serve at real size: TPC-H ``lineitem`` at scale factor 10 (60 M rows
   of f32 EXTENDEDPRICE resident on the card, GROUP BY SHIPINSTRUCT: 4
   groups), an ``AQPSession`` with the reference defaults (B=300, n_min=1000,
   n_max=2000, max_iters=24, n_cap=65536, forced POOL with 8 lanes in 2
   tiers) answers 16 avg/sum/var/std requests, then one singleton on the
   LOOP route; every request must succeed, 14 of 16 must lie within epsilon
   of the exact answer, and the Poisson-bootstrap kernel must have launched;
   every launch's arguments are kept (device copies, no sync) for phase 8;
7. grouped serve at real size: ``lineitem`` SF10 GROUP BY TAX (9 groups), one
   session as in phase 6 answers 8 GROUP BY requests (avg/sum at epsilon 1 %
   and 2 %, var at 3 % and 4 %, std at 1.5 % and 2 % of the smallest exact
   per-group answer) and the 4 solo requests of phase 6's first wave, in the
   same pool; every grouped request succeeds with every group's error within
   epsilon, 64 of the 72 per-group answers lie within epsilon of numpy's
   exact answer, every solo request succeeds, and both bootstrap kernels
   launched; every segment launch's arguments are kept for phase 8;
8. both bootstrap kernels on the serves' own calls: one recorded call of
   each length (segment, up to 20 000) and width (Poisson, up to 16 384)
   against the plain version bit for bit, then one CUDA graph of the calls
   at the most used length or width and one of all calls in order: device
   ms a call and a serve beside the operation bound summed over the same
   calls; then the segment-bootstrap kernel checked and timed once more,
   with its plain version, on phase 3's random stream at the length phase 7
   launched most;
9. decode-attention kernel against its plain version on the card at the LM
   serve's shape (8 rows, 12 query heads over 2 KV heads, d = 128, S_max =
   2048, bf16, per-row lengths in the serve's range, positions past each
   length poisoned), in f32 at the same shape, at the edge lengths (0, 1,
   63, 64, 65, S_max, S_max + 1) in both types, at a grid-bound shape (264
   pairs, S = 2112), and at the four shapes of the reference's kernel test
   in both types: f32 at rtol 1e-5 / atol 1e-6,
   bf16 within one bf16 ulp (beyond that atol) of the plain version's f32
   result; int32, int64 and int lengths give the same output, two calls and
   two CUDA-graph replays the eager output bit for bit, and a trace of 16
   calls, half of them with a window, holds 16 device kernels and nothing
   else; kernel, plain and
   library (``scaled_dot_product_attention`` with a length mask and
   ``enable_gqa``) times over eight rotating caches (colder than L2) at the
   serve's lengths, at full length (2048) and at 64, from a CUDA graph of
   64 calls (the device's time; eager back-to-back times, which the host's
   enqueue rate bounds, are printed beside them) against the byte bound;
10. the LM port on the card against the CPU at the CPU tests' size: reduced
   ``qwen2-1.5b`` (f32) with the same seeded weights and prompts; the
   batcher's tokens equal (6 requests through 2 slots, retires at EOS and
   at s_max - 1), prefill and decode logits at rtol/atol 2e-4;
11. full-width consistency: Qwen2-1.5B in f32 (TF32 off), ``prefill`` then
   four ``decode_step``s through the kernel against ``train_logits`` over
   the extended sequence: rtol/atol 2e-4, argmax equal where the top-2
   margin exceeds 2e-4;
12. LM serve at full width: Qwen2-1.5B in bf16, weights from a seeded
   generator on the card, ``ContinuousBatcher(slots=8, s_max=2048)``
   answers 16 requests (prompts of 32-1024 random tokens, 32 new tokens
   each); every request completes with its 32 tokens, and the
   decode-attention kernel launched 28 times per decode step;
13. the host route on the card against the CPU at the CPU tests' size:
   ``run_l2miss`` and every metric extension through the moments entry,
   median and min through the generic bootstrap: integers exact, theta and
   error within the CPU tests' rtol; the moments entry card == cpu bit for
   bit; ``AQPEngine.exact`` against numpy float64;
14. host serve at real size: 12 host-route requests (every metric,
   relative bounds, predicates, quantiles, GROUP BY with a predicate) on
   phase 6's table, ``AQPEngine.exact`` of the moment requests (the
   segment-aggregate kernel), and an ``AQPService`` batch sent twice;
15. warm and SLO lanes at the CPU tests' size: warm ``fused_l2miss`` runs
   (right, stale and garbage-coefficient predictions) and a warm
   ``fused_grouped`` block card == cpu (phase 5's tolerances); on the card,
   a warm pool lane and block equal their solo warm runs, a degraded lane a
   solo run at its delivered epsilon, and a migrated lane (the move
   asserted) its solo run, bit for bit; one shed pilot card == cpu within
   phase 13's tolerance;
16. warm and overload serve at real size: (a) one warm-cache session sends
   phase 6's 16 requests cold, again (each exact repeat bit-equal with 0
   dispatches and 0 kernel launches), and at epsilon / 1.1 (the WARM
   route); a second one on phase 7's table sends its 8 GROUP BY requests
   cold and at epsilon / 1.1 (warm blocks); (b) one session with degrade,
   fair queueing (tenants dash 3 : batch 1) and migration sends 8 priming
   requests, then a burst of 32 with deadlines at 4x, 0.5x and 0.05x the
   priming wave's median latency (the 4x ones plus the time the burst's
   20 tight requests take to be answered by pilot at submit, measured
   just before on the same requests): every error within its delivered
   epsilon, shed answers without an iteration, the 4x requests neither
   shed nor degraded;
17. the sharded path at the CPU tests' size (tests/test_torch_shard.py's
   table, n_cap = 4096): ``ShardLayout`` slot tables, solo sharded
   ``fused_l2miss`` at S = 2 and 4 and a ``mesh=False`` pool at S = 4 card
   == cpu (integers exact, theta and error bit-equal), each pool lane == its
   solo sharded run on the card, ``sharded_group_stats`` (segment-aggregate
   kernel) card vs cpu, every Poisson-bootstrap call of the phase replayed
   through its plain version on the card bit for bit; then 4 gloo ranks
   (this script with ``--mesh-rank``, one process each) sharing the card
   drain the same pool over a ``DataMesh``, bit-equal to ``mesh=False``,
   one collective a tick;
18. sharded serve at real size: phase 6's table and 16 requests through
   ``AQPSession(data_shards=4, mesh=False)`` (forced POOL, the reference
   defaults, so a segment holds 16 384 slots): every request succeeds with
   error <= epsilon, 14 of 16 within epsilon of numpy; then 2 of phase 7's
   GROUP BY requests on the TAX table take the HOST route;
19. the baselines at real size (paper Figures 3 and 4): on phase 6's table,
   avg at epsilon = 1 % of the L2 norm of the exact answers
   (``AQPEngine.exact``, the segment-aggregate kernel), delta 0.05,
   ``run_l2miss`` (B 200, n_min 1000, n_max 2000, the Poisson kernel's
   moments entry), ``run_blk``, ``run_sps`` at epsilon_rel 1 % and
   ``run_minibatch`` (step 2000, B 200), each printed with its success,
   rows touched, iterations, wall and L2 error against the exact answers:
   L2Miss and BLK within 2 epsilon, SPS's rows at least its full scan,
   L2Miss under SPS's rows; then lineitem SF10 GROUP BY LINESTATUS with a
   5 % group bias: ``run_ordermiss`` and ``run_ifocus`` both order the
   groups as the exact answers do; every Poisson-bootstrap and
   segment-aggregate call of the phase is recorded, and one of each shape
   is held against its plain version afterwards (Poisson bit for bit, the
   aggregate as in phase 4);
20. MISS for the LM at full width: Qwen3-1.7B (QK norm, bf16, seeded
   weights) and the pipeline's ``eval_domains(151936, 3 x 512 x 64)`` on
   the card; ``MissEvaluator`` (delta 0.1, B 200, n_min 32, n_max 64) at
   epsilon = 2 sigma sqrt(3/256) from a pilot of 64 losses a domain must
   succeed with fewer model forwards than the full eval (run after it),
   within 2 epsilon of it; ``mixture_statistics`` on 3 lognormal domains of
   4 M documents (rtol 0.06 against numpy's means, fewer documents scanned
   than held, through the Poisson kernel); ``estimate_router_load`` with the
   reference test's synthetic router (E = 8) at epsilon 0.01 within 2
   epsilon of the true load; one recorded Poisson-bootstrap call of each
   shape is held against its plain version bit for bit afterwards;
21. the dense variants: (a) the decode-attention kernel with a sliding
   window against its plain version as in phase 9: rotating caches at
   h2o-danube's decode shape (8 rows, 32 query over 8 KV heads, d = 120,
   window 4096, S_max 8192, lengths in the serve's range), the edge
   lengths (below, at and past the window) at d = 120 and 128, positions
   outside each window poisoned; Command R+'s decode shape (96 query over
   8 KV heads, d = 128, S_max 64) at its serve's lengths and the edge
   lengths; the windowed kernel timed from a CUDA graph against the byte
   bound over the windows' rows, the plain version and SDPA with the window
   mask; (b) reduced qwen3-1.7b, h2o-danube-3-4b (window 16) and
   command-r-plus-104b card == cpu as phase 10; (c) h2o-danube-3-4b in f32
   at full width and depth: 16 greedy steps past a 4 200-token prompt
   against teacher forcing's logits (phase 11's tolerance); (d) the
   h2o-danube bf16 serve: 16 prompts of 4 100-6 000 tokens, 32 new tokens
   each (every one decodes past the window), through
   ``ContinuousBatcher(slots=8, s_max=8192)``; (e) Qwen3-1.7B bf16 at
   phase 12's serve shape; (f) command-r-plus-104b at full width cut to 4
   of its 64 layers, 8 requests of 16 tokens;
22. the MoE, RWKV6 and Mamba-hybrid decoders: (a) the decode-attention
   kernel against its plain version as in phase 9 at Granite-MoE's decode
   shape (8 rows, 16 query over 8 KV heads, d = 64, S_max 2048) and
   DeepSeek-MoE's (16 over 16, d = 128: one query head a KV head), timed
   from a CUDA graph beside the byte bound and SDPA; (b) reduced
   granite-moe-1b-a400m, deepseek-moe-16b, rwkv6-7b and
   jamba-1.5-large-398b (f32) card == cpu as phase 10, teacher forcing
   (aux at rtol 1e-5) and prefill states at phase 11's tolerance, two card
   calls of ``moe`` bit-equal; (c) Granite-MoE (capacity factor E / k:
   nothing drops) and RWKV6-7B in f32 at full width and depth, 32 greedy
   steps after a 992-token prefill against teacher forcing, and one Mamba
   mixer at Jamba's published widths (forward 1 024 + 128 decode steps
   against a forward over 1 152); (d) bf16 serves at full width and depth,
   16 requests of 32 new tokens through ``ContinuousBatcher(slots=8,
   s_max=2048)``: Granite-MoE-1B-A400M, DeepSeek-MoE-16B, RWKV6-7B (prompts
   multiples of 32 in 32-1 024), row 4 launched once per attention layer
   and step (0 on RWKV6); (e) reduced Jamba (bf16) through the batcher on
   the card, prompts of at most 16 tokens or multiples of 16; (f)
   ``estimate_router_load`` over Granite's layer-0 router (the port's
   ``route`` after layer 0's attention block) on a pool of 4 096 x 16
   pipeline tokens, within 2 epsilon of the pool's exact load, and a zero
   hidden row routed to experts 0..k-1 (``lax.top_k``'s order among tied
   probabilities);
23. cross-attention, the encoder-decoder stack and the vision layers: (a)
   reduced seamless-m4t-large-v2 and llama-3.2-vision-90b card == cpu on
   one seeded tree and memory, in f32 (phase 11's tolerance) and bf16
   (2e-2 relative L2, 0.15 max abs): ``train_logits``, ``prefill`` (logits
   and the returned memory) and 8 decode steps, the decode's self- and
   cross-attention through the kernel on the card; (b) their f32 decode
   after ``caches_from_prefill`` against teacher forcing (phase 11's
   tolerance); (c) the decode-attention kernel against its plain version
   as in phase 9 at SeamlessM4T's decode shapes (8 rows, 16 over 16 heads
   of 64: self-attention at lengths 65-96, cross-attention over 4 096
   frames) and Llama-3.2-Vision's (64 over 8 heads of 128: self-attention
   at 17-96, cross-attention over 1 600 image tokens), the cross-attention
   with an int length, timed from a CUDA graph beside the byte bound, the
   plain version and SDPA; (d) SeamlessM4T-large-v2 in bf16 at full width
   and depth (24 + 24 layers, d 1024, vocab 256 206) on 8 rows of 4 096
   pipeline frames with decoder prompts of 16-64 tokens: each row's
   prefill, then 32 greedy decode steps of the 8 rows, 48 kernel launches
   a step; (e) Llama-3.2-Vision-90B at full width cut to two 5-layer units
   (10 of 100 layers: 175 GB of weights at full depth) on 8 rows of 1 600
   pipeline image embeddings, the same run, 10 launches a step;
24. training (no kernel lies on its path: it attends through the f32
   einsums, as the reference does): (a) one train step (remat "dots", lr
   1e-5) of every arch at ``reduced_for_smoke`` size in f32, card against
   CPU from one seeded tree and pipeline batch: loss and params within
   rtol 2e-4 / atol 2e-5 (the reference's microbatch tolerance), the AdamW
   moments within 2e-4 of each leaf's largest magnitude, TF32 off; (b) Qwen2-1.5B in bf16 at full width and depth
   (28 layers, d 1536, vocab 151 936, tied head) trained through
   ``launch.train.run``: 10 steps of 8 x 512 pipeline tokens under remat
   "dots", every loss finite and the last below the first, step time
   (median of steps 2-9, each ended by its loss's host read), tokens/s,
   peak memory, ``model_flops(kind="train")`` over the step time as a
   share of the 989 TFLOP/s dense bf16 peak, then the MISS-certified eval
   (the generic bootstrap: no kernel) against a full eval's forwards; (c) at
   ``--smoke`` size, ``--steps 8`` against ``--steps 6`` with checkpoints
   every 3 then ``--steps 8`` resumed at step 6, within (a)'s tolerance,
   bit equality reported, the checkpoint directory deleted; (d) 4
   microbatches against 1 at lr 1e-5 within (a)'s tolerances; (e) ``quantize_int8`` /
   ``ef_quantize`` card == CPU bit for bit, and ``compressed_psum`` over 4
   gloo ranks sharing the card (this script with ``--compress-rank``)
   bit-equal to a numpy transcription of the reference's; then the result
   lines: a JSON object of phase 24's training numbers, a JSON object of
   kernel measurements, then ``{"ok": true, "device": {...}}`` as the last
   line.

Phases 6, 7, 12, 14, 16, 18, 19, 20, 21(d-f), 22(d-f) and 23(d-e) are the
main paths: every
kernel's launch count is set to 0 just before each and read just after; the launches of the
other phases (the comparisons with the plain versions) count nowhere, but
phase 15's and phase 17's are printed and kept in the kernels line.  Phase
24(b), the training path, is read the same way and its counts printed: no
kernel lies on it.

``python3 chip_smoke.py --mesh-rank RANK WORLD STORE OUT`` runs one rank of
phase 17's mesh; phase 17 starts them itself.  ``--compress-rank RANK WORLD
STORE OUT`` runs one rank of phase 24(e).
"""
import collections
import dataclasses
import gc
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

B = 300
N_CAP = 1 << 16
N_MAX = 2000
N_MIN = 1000
SERVE = dict(B=B, n_min=N_MIN, n_max=N_MAX, max_iters=24, n_cap=N_CAP, seed=0)
OPS_PER_PAIR = 30       # the earlier estimate: integer ops a (slot, replicate)
INT32_LANES_PER_SM = 64
FP32_LANES_PER_SM = 128
ISSUE_PER_SM = 128      # 4 schedulers x one warp instruction a clock
BOOT_UNROLL = 8         # pairs a thread draws an iteration (boot::kUnroll)
H100_SMS = 132
HBM_BYTES_PER_S = 3.35e12


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _counters():
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.poisson_bootstrap import ops as pb_ops
    from repro_torch.kernels.segment_agg import ops as seg_ops
    return {"poisson_bootstrap": pb_ops.counter,
            "segment_bootstrap": seg_ops.boot_counter,
            "segment_aggregate": seg_ops.agg_counter,
            "decode_attention": da_ops.counter}


def reset_counts() -> None:
    """Every kernel's launch count to 0, just before a main path runs."""
    for c in _counters().values():
        c.reset()


def read_counts() -> dict:
    """Every kernel's launches since :func:`reset_counts`."""
    return {k: c.launches for k, c in _counters().items()}


def add_counts(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


def cuda_ms(fn, reps: int, rounds: int) -> float:
    """Median over ``rounds`` of the mean CUDA-event time of ``reps``
    back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times)


def graph_ms(fn, reps: int, rounds: int) -> float:
    """Median over ``rounds`` of the CUDA-event time of one replay of a CUDA
    graph holding ``reps`` calls, over ``reps``: the device's time for a
    call without the host's enqueue rate, which back-to-back eager calls of
    a few-microsecond op measure instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# the bootstrap kernels' operation bound, from their SASS
# ---------------------------------------------------------------------------

_SASS_LINE = re.compile(r"^\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                        r"([A-Z][A-Z0-9_.]*)([^;]*);")
_FP32 = ("FADD", "FMUL", "FFMA")
_INT = ("IMAD", "IADD", "VIADD", "LOP", "SHF", "ISETP", "LEA", "SEL",
        "IMNMX", "VIMNMX", "PRMT", "IABS", "MOV", "I2F")


def sass_ops_per_pair(lib: Path, kernel: str):
    """Instructions a (element, replicate) pair in ``kernel``'s draw loop,
    from ``cuobjdump -sass`` of the built library: the loop closed by a
    backward branch that holds the most of the ladder's FADD.SAT steps, over
    the BOOT_UNROLL pairs an iteration draws, split into the INT pipe (64 lanes an SM a clock),
    the FP32 pipe (128) and the rest (shared loads, the branch), and the
    rarely taken tail of the ladder apart.  None when the dump or the loop
    cannot be read."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        dump = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, timeout=300, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    for body in dump.split("Function : ")[1:]:
        if kernel not in body.splitlines()[0]:
            continue
        ins = [(int(m[1], 16), m[2], m[3]) for m in
               map(_SASS_LINE.match, body.splitlines()) if m]

        def branches(forward: bool):
            out = []
            for a, op, arg in ins:
                if op == "BRA" and arg.strip().startswith("0x"):
                    t = int(arg.split()[0], 16)
                    if (t > a) == forward:
                        out.append((min(a, t), max(a, t)))
            return out

        def sats(lo, hi, const=""):
            return sum(1 for a, op, arg in ins if lo <= a <= hi
                       and op.startswith("FADD.SAT") and const in arg)

        loops = [r for r in branches(False) if sats(*r)]
        if not loops:
            return None
        lo, hi = max(loops, key=lambda r: sats(*r))
        # The ladder's tail (its first step subtracts g(K_5 - 1)) sits behind
        # a warp-uniform branch taken about one iteration in seven: it is
        # left out of the count and reported beside it.
        tails = [r for r in branches(True) if lo < r[0] and r[1] <= hi
                 and sats(r[0], r[1], "33534492")]
        tail = min(tails, key=lambda r: r[1] - r[0], default=(0, 0))
        ops = [op.split(".")[0] for a, op, _ in ins
               if lo <= a <= hi and not tail[0] < a < tail[1]]
        n_fp = sum(op in _FP32 for op in ops)
        n_int = sum(op.startswith(_INT) for op in ops)
        n_tail = sum(1 for a, _, _ in ins if tail[0] < a < tail[1])
        return {"int": n_int / BOOT_UNROLL, "fp32": n_fp / BOOT_UNROLL,
                "other": (len(ops) - n_fp - n_int) / BOOT_UNROLL,
                "tail_branch": n_tail / BOOT_UNROLL}
    return None


def pair_clocks(per_pair) -> float:
    """SM clocks a pair needs at least: the busier of the INT and FP32
    pipes, or the issue of all its instructions (the 30-integer-op estimate
    where the SASS was not read)."""
    if per_pair is None:
        return OPS_PER_PAIR / INT32_LANES_PER_SM
    total = per_pair["int"] + per_pair["fp32"] + per_pair["other"]
    return max(per_pair["int"] / INT32_LANES_PER_SM,
               per_pair["fp32"] / FP32_LANES_PER_SM, total / ISSUE_PER_SM)


def op_bound_ms(pairs: int, per_pair, clock_hz: float) -> float:
    return pairs * pair_clocks(per_pair) / (H100_SMS * clock_hz) * 1e3


def old_bound_ms(pairs: int, clock_hz: float) -> float:
    """The bound at the earlier estimate of 30 integer operations a pair."""
    return op_bound_ms(pairs, None, clock_hz)


def replays_equal(fn) -> bool:
    """Two eager calls and two replays of a CUDA graph of one call give the
    same result bit for bit (the arrival counters are left at zero)."""
    first = fn()
    again = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    once = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    return (torch.equal(first, again) and torch.equal(once, first)
            and torch.equal(out, once))


def device_kernels(fn, n: int) -> dict:
    """The device work that ``n`` calls of ``fn`` enqueue, by name: the nodes
    of one CUDA graph that captures the ``n`` calls (after an eager call on
    a side stream), read from the DOT dump of the kept, uninstantiated
    graph.  A kernel node is keyed
    by its function's mangled name, any other node (a copy, a memset) by its
    type.  A capture records every operation the calls put on the stream;
    profiler traces on the card dropped some kernels of a step."""
    import tempfile

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "calls.dot"
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            graph.debug_dump(str(path))
        check(path.exists(), f"the graph of {n} calls wrote no DOT dump")
        text = path.read_text()
    del graph
    nodes = re.findall(r'(?ms)^"graph_\d+_node_\d+"\s*\[(.*?)\];\s*$', text)
    check(bool(nodes), f"the graph of {n} calls dumped no nodes: {text[:400]}")
    found = collections.Counter()
    for body in nodes:
        name = (re.search(r"_Z\w+", body)
                or re.search(r"\b\w*kernel\w*", body))
        kind = re.search(r"\b(MEMCPY|MEMSET|HOST|GRAPH|EMPTY|WAIT_EVENT|"
                         r"EVENT_RECORD|MEM_ALLOC|MEM_FREE|[A-Z_]{4,})\b",
                         body)
        found[name.group(0) if name else
              kind.group(1) if kind else body[:80]] += 1
    return dict(found)


def graph_seq_ms(fns, rounds: int) -> float:
    """Median CUDA-event time of one replay of a CUDA graph holding one call
    of each of ``fns`` in order (each warmed eagerly first): the device's
    time for the sequence."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    del graph
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 2: the kernel against its plain version
# ---------------------------------------------------------------------------

def pb_sets(data):
    """Phase 2's inputs at the solo serve's tier shape: the tier's carried
    buffer (4 lanes x m groups x N_CAP, each lane's groups filled through
    its own slot table), seeds, a gate with lane 2 off, and ``(label, w,
    mask)`` sets -- a window [0, hi) with hi in [w/2, w] on every rung of
    the width ladder, then stacked init-probe windows [1000k, 1000k + n)
    (k < 7, n = n_min or n_max) at w = 8192, as the serve's ticks read
    them."""
    from repro_torch.core import keys, sampling
    from repro_torch.core.fused import bucket_ladder

    dev = data.values.device
    q, m = 4, data.num_groups
    rng = np.random.default_rng(11)
    starts, sizes = data.offsets[:-1], np.diff(data.offsets)
    buf = torch.stack([
        data.values[sampling.counter_slot_table(
            keys.prng_key(100 + lane), starts, sizes, N_CAP,
            device=dev).long(), 0] for lane in range(q)])      # (q, m, N_CAP)
    seeds = torch.as_tensor(rng.integers(0, 2**32, (q, m)), device=dev)
    act = torch.tensor([True, True, False, True], device=dev)[:, None]
    act = act.expand(q, m)
    sets = []
    for w in bucket_ladder(N_CAP, N_MAX):
        hi = torch.as_tensor(rng.integers(w // 2, w + 1, (q, m)), device=dev)
        pos = torch.arange(w, device=dev)
        sets.append((f"w={w}", w, (pos < hi[..., None]).to(torch.float32)))
    w = 8192
    lo = torch.as_tensor(rng.integers(0, 7, (q, m)) * N_MIN, device=dev)
    n = torch.as_tensor(rng.choice([N_MIN, N_MAX], (q, m)), device=dev)
    pos = torch.arange(w, device=dev)
    sets.append(("stacked w=8192", w, ((pos >= lo[..., None])
                                       & (pos < (lo + n)[..., None])).float()))
    return buf, seeds, act, sets


def pb_pairs(mask: torch.Tensor, act, B_: int) -> int:
    """(live slot, replicate) pairs of a call: the kernel's work."""
    live = mask != 0
    if act is not None:
        live = live & act[..., None]
    return int(live.sum().item()) * B_


def pb_graph_times(buf, seeds, act, sets) -> dict:
    """Graph ms a call (20 calls a graph, median of 5) of every set."""
    from repro_torch.kernels.poisson_bootstrap import ops

    return {label: graph_ms(lambda: ops.bootstrap_moments_masked(
        buf[..., :w], mask, seeds, B, lane_active=act), reps=20, rounds=5)
        for label, w, mask in sets}


def phase_kernel(data, clock_hz: float, per_pair):
    from repro_torch.kernels.poisson_bootstrap import ops, ref

    buf, seeds, act, sets = pb_sets(data)
    rows = {}
    max_err = 0.0
    g_ms = pb_graph_times(buf, seeds, act, sets)
    for label, w, mask in sets:
        x = buf[..., :w]                       # strided bucket slice
        got = ops.bootstrap_moments_masked(x, mask, seeds, B, lane_active=act)
        want = ref.bootstrap_moments_masked_ref(x, mask, seeds, B,
                                                lane_active=act)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        check(torch.allclose(got, want, rtol=1e-5, atol=0.0),
              f"kernel != plain at {label} (max abs err {err})")
        ungated = ops.bootstrap_moments_masked(x, mask, seeds, B)
        check(torch.equal(ungated[act], got[act]), f"gated != ungated at {label}")
        check(not got[~act].any(), f"inactive groups not zero at {label}")
        wide = ops.bootstrap_moments_masked(
            buf, torch.nn.functional.pad(mask, (0, N_CAP - w)), seeds, B,
            lane_active=act)
        check(torch.equal(wide, got), f"narrow != wide bucket at {label}")

        def call():
            return ops.bootstrap_moments_masked(x, mask, seeds, B,
                                                lane_active=act)
        k_ms = cuda_ms(call, reps=20, rounds=5)
        p_ms = cuda_ms(lambda: ref.bootstrap_moments_masked_ref(
            x, mask, seeds, B, lane_active=act), reps=1, rounds=3)
        pairs = pb_pairs(mask, act, B)
        ops_ms = op_bound_ms(pairs, per_pair, clock_hz)
        G = mask.numel() // w
        n_bytes = 2 * G * w * 4 + G * (8 + 1) + G * B * 5 * 4
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        rows[label] = dict(ms=k_ms, graph_ms=g_ms[label], plain_ms=p_ms,
                           bound_ms=max(ops_ms, bytes_ms),
                           bound_30ops_ms=old_bound_ms(pairs, clock_hz),
                           bound_by="operations" if ops_ms >= bytes_ms
                           else "bytes", pairs=pairs,
                           exact=torch.equal(got, want))
        r = rows[label]
        print(f"  {label:15s} pairs={pairs:10d} kernel {k_ms:.4f} ms (graph "
              f"{r['graph_ms']:.4f} ms)  plain {p_ms:.3f} ms  bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}; 30-op bound "
              f"{r['bound_30ops_ms']:.4f})  bit-exact={r['exact']}")
    x, mask = buf[..., :8192], sets[-1][2]

    def stacked():
        return ops.bootstrap_moments_masked(x, mask, seeds, B, lane_active=act)
    check(replays_equal(stacked), "repeat calls or graph replays differ")
    dev_ops = device_kernels(stacked, 8)
    check(sum(dev_ops.values()) == 8 and all("pb_kernel" in k for k in dev_ops),
          f"8 calls ran {dev_ops} on the device")
    print(f"  two calls and two graph replays bit-equal; 8 calls ran 8 device"
          f" kernels ({next(iter(dev_ops))[:40]}...) and nothing else")
    print("  library: no single PyTorch call computes Poisson-bootstrap "
          "moment sums with counter-hash weights; no library yardstick")
    return rows, max_err


# ---------------------------------------------------------------------------
# phase 3: the segment-bootstrap kernel at the grouped block's shape
# ---------------------------------------------------------------------------

def _split(total: int, k: int, cap: int, rng) -> np.ndarray:
    """``k`` window widths, each at most ``cap``, summing to ``total``."""
    w = np.minimum(np.floor(rng.dirichlet(np.ones(k)) * total), cap)
    w = w.astype(np.int64)
    while w.sum() < total:
        i = rng.choice(np.flatnonzero(w < cap))
        w[i] += min(cap - w[i], total - w.sum())
    return w


def seg_block(data):
    """The grouped serve's block on lineitem GROUP BY TAX: each lane's
    buffer through its stratified slot table (9 lanes x N_CAP), the lanes'
    seeds, and the generator phase 3 draws its random streams from."""
    from repro_torch.core import keys, sampling

    dev = data.values.device
    rng = np.random.default_rng(12)
    tables = sampling.stratified_slot_tables(keys.prng_key(77), data.offsets,
                                             N_CAP, device=dev)
    buf = data.values[tables[:, 0].long(), 0]                  # (q, N_CAP)
    seeds = torch.as_tensor(rng.integers(0, 2**32, data.num_groups),
                            device=dev)
    return buf, seeds, rng


def seg_stream(buf, seeds, lo, w):
    """``segment_bootstrap_sorted``'s arguments for the packed stream of
    the lanes' windows ``[lo[g], lo[g] + w[g])`` in lane order."""
    dev = buf.device
    lo, w = np.asarray(lo, np.int64), np.asarray(w, np.int64)
    gid = torch.as_tensor(np.repeat(np.arange(len(w)), w), device=dev)
    slot = torch.as_tensor(np.concatenate(
        [np.arange(a, a + b) for a, b in zip(lo, w)]), dtype=torch.int32,
        device=dev)
    x = buf[gid, slot.long()]
    off = torch.as_tensor(np.concatenate([[0], np.cumsum(w)]), device=dev)
    return (x, torch.ones_like(x), slot,
            seeds[gid], off, B, int((lo + w).max()))


GATED_LANE = 4          # phase 3's frozen lane: no window while others fit


def seg_random_stream(buf, seeds, rng, L: int):
    """Phase 3's stream of L elements: the live lanes' window widths split
    at random (at most N_CAP each), each window at a random offset."""
    q = buf.shape[0]
    live = [g for g in range(q) if g != GATED_LANE or L > (q - 1) * N_CAP]
    w = np.zeros(q, np.int64)
    w[live] = _split(L, len(live), N_CAP, rng)
    lo = rng.integers(0, N_CAP - w + 1)
    return seg_stream(buf, seeds, lo, w), live


def seg_serve_sets(buf, seeds):
    """The grouped serve's own streams, no serve needed: a TAX block's 9
    lanes reading stacked init probes [1000k, 1000k + 1000), k = 0..6 (L =
    9000), then the 2000-wide probes that follow (L = 18000); and the L =
    9000 stream with its windows at slot 0 and at the end of the buffer."""
    q = buf.shape[0]
    sets = [(f"probe [{N_MIN * k},+{N_MIN})",
             seg_stream(buf, seeds, [N_MIN * k] * q, [N_MIN] * q))
            for k in range(7)]
    sets += [(f"probe [{7 * N_MIN + N_MAX * k},+{N_MAX})",
              seg_stream(buf, seeds, [7 * N_MIN + N_MAX * k] * q,
                         [N_MAX] * q)) for k in range(4)]
    sets += [(f"L=9000 at {lo}", seg_stream(buf, seeds, [lo] * q, [N_MIN] * q))
             for lo in (0, N_CAP - N_MIN)]
    return sets


def seg_graph_ms(args) -> float:
    from repro_torch.kernels.segment_agg import ops

    return graph_ms(lambda: ops.segment_bootstrap_sorted(*args), reps=20,
                    rounds=5)


def phase_segment_boot(data, clock_hz: float, per_pair):
    """Kernel vs plain and vs the Poisson-bootstrap kernel on packed streams
    of live windows at every seg_ladder rung (plain version timed at one),
    then the serve's own streams (``seg_serve_sets``); returns the rung rows,
    the serve rows and ``measure(L, plain)``, which checks and times one
    more random stream of ``L`` elements (the grouped serve's length)."""
    from repro_torch.core import fused
    from repro_torch.kernels.poisson_bootstrap import ops as pb_ops
    from repro_torch.kernels.segment_agg import ops, ref

    dev = data.values.device
    buf, seeds, rng = seg_block(data)
    q = buf.shape[0]

    def bound(L):
        pairs = L * B
        ops_ms = op_bound_ms(pairs, per_pair, clock_hz)
        bytes_ms = (20 * L + 8 * (q + 1) + q * B * 3 * 4) / HBM_BYTES_PER_S * 1e3
        return dict(bound_ms=max(ops_ms, bytes_ms),
                    bound_30ops_ms=old_bound_ms(pairs, clock_hz),
                    bound_by="operations" if ops_ms >= bytes_ms else "bytes")

    def measure(L: int, plain: bool) -> dict:
        args, live = seg_random_stream(buf, seeds, rng, L)
        x, off = args[0], args[4]
        got = ops.segment_bootstrap_sorted(*args)
        want = ref.segment_bootstrap_sorted_ref(*args)
        pos = torch.arange(N_CAP, device=dev)
        lo_t = args[2][off[:-1].clamp(max=L - 1)].long()
        n_t = off[1:] - off[:-1]
        mask = ((pos >= lo_t[:, None]) & (pos < (lo_t + n_t)[:, None])).float()
        pb = pb_ops.bootstrap_moments_masked(buf, mask, seeds, B)[..., :3]
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=1e-5, atol=0.0),
              f"segment kernel != plain at L={L} (max abs err {err})")
        check(torch.equal(got, pb),
              f"segment kernel != Poisson-bootstrap kernel at L={L}")
        if GATED_LANE not in live:
            check(not got[GATED_LANE].any(), f"frozen lane not zero at L={L}")
        # A masked-out lane's elements in the stream add nothing.
        gid = torch.repeat_interleave(torch.arange(q, device=dev), n_t)
        mk = torch.ones_like(x)
        mk[gid == live[0]] = 0.0
        masked = ops.segment_bootstrap_sorted(x, mk, *args[2:])
        check(not masked[live[0]].any() and torch.equal(
            masked[live[1:]], got[live[1:]]), f"gated lane added at L={L}")
        k_ms = cuda_ms(lambda: ops.segment_bootstrap_sorted(*args),
                       reps=20, rounds=5)
        p_ms = (cuda_ms(lambda: ref.segment_bootstrap_sorted_ref(*args),
                        reps=1, rounds=3) if plain else None)
        row = dict(ms=k_ms, graph_ms=seg_graph_ms(args), plain_ms=p_ms,
                   max_abs_err=err, exact=torch.equal(got, want), **bound(L))
        print(f"  L={L:7d} pairs={L * B:11d} kernel {k_ms:.4f} ms (graph "
              f"{row['graph_ms']:.4f} ms)  bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}; 30-op {row['bound_30ops_ms']:.4f})  plain "
              f"{'-' if p_ms is None else f'{p_ms:.3f} ms'}  "
              f"bit-exact={row['exact']} == poisson_bootstrap")
        return row

    seg_cap = fused.grouped_seg_cap(data.offsets, N_CAP)
    rows = {L: measure(L, plain=L == 8192)
            for L in fused.seg_ladder(seg_cap, N_MAX)}
    print("  the grouped serve's own streams (9 lanes of stacked probes):")
    serve = {}
    for label, args in seg_serve_sets(buf, seeds):
        got = ops.segment_bootstrap_sorted(*args)
        check(torch.equal(got, ref.segment_bootstrap_sorted_ref(*args)),
              f"segment kernel != plain on {label}")
        L = args[0].shape[0]
        serve[label] = dict(L=L, graph_ms=seg_graph_ms(args), **bound(L))
        print(f"  {label:22s} L={L:6d} graph {serve[label]['graph_ms']:.4f} ms"
              f"  bound {serve[label]['bound_ms']:.4f} ms  bit-exact=True")
    near0, near_end = (serve[f"L=9000 at {lo}"]["graph_ms"]
                       for lo in (0, N_CAP - N_MIN))
    print(f"  windows at slot 0 vs at {N_CAP - N_MIN}: {near0:.4f} vs "
          f"{near_end:.4f} ms ({abs(near0 - near_end) / min(near0, near_end):.1%}"
          f" apart)")
    args = seg_serve_sets(buf, seeds)[3][1]
    check(replays_equal(lambda: ops.segment_bootstrap_sorted(*args)),
          "segment kernel: repeat calls or graph replays differ")
    dev_ops = device_kernels(lambda: ops.segment_bootstrap_sorted(*args), 8)
    check(sum(dev_ops.values()) == 8
          and all("seg_boot_kernel" in k for k in dev_ops),
          f"8 segment calls ran {dev_ops} on the device")
    print(f"  two calls and two graph replays bit-equal; 8 calls ran 8 device"
          f" kernels ({next(iter(dev_ops))[:40]}...) and nothing else")
    print("  library: no single PyTorch call computes segment Poisson-bootstrap"
          " moment sums with counter-hash weights; no library yardstick")
    return rows, serve, measure


# ---------------------------------------------------------------------------
# phase 4: the exact segment-aggregate kernel over the whole table
# ---------------------------------------------------------------------------

def phase_segment_agg(data, gid_host: np.ndarray):
    from repro_torch.kernels.segment_agg import ops, ref

    dev = data.values.device
    m, n = data.num_groups, data.values.shape[0]
    # The table in its generated (unsorted) row order: GROUP BY input.
    gid = torch.as_tensor(gid_host, device=dev)
    order = torch.sort(gid, stable=True).indices
    x = torch.empty(n, dtype=torch.float32, device=dev)
    x[order] = data.values[:, 0]
    gen = torch.Generator(device=dev).manual_seed(5)
    mask = (torch.rand(n, generator=gen, device=dev) > 0.05).float()
    gid32 = gid.to(torch.int32)
    got = ops.segment_aggregate(gid32, x, mask, m)
    want = ref.segment_aggregate_ref(gid32, x, mask, m)
    torch.cuda.synchronize()
    max_err = max(float((got[k] - want[k]).abs().max()) for k in want)
    exact_plain = all(torch.equal(got[k], want[k]) for k in want)
    for k in ref.AGG_KEYS:
        check(torch.allclose(got[k], want[k], rtol=1e-5, atol=0.0),
              f"aggregate kernel != plain on {k}")
    for k in ("min", "max"):
        check(torch.equal(got[k], want[k]), f"aggregate kernel != plain on {k}")
    xh, mh = x.cpu().numpy(), mask.cpu().numpy()
    x64, w64 = xh.astype(np.float64), mh.astype(np.float64)
    for p, k in enumerate(ref.AGG_KEYS):
        ex = np.bincount(gid_host, weights=w64 * x64 ** p, minlength=m)
        check(np.allclose(got[k].cpu().numpy(), ex, rtol=1e-4, atol=0.0),
              f"aggregate {k} vs numpy float64")
    xs, ms = data.values[:, 0].cpu().numpy(), mh[order.cpu().numpy()]
    for g in range(m):
        a, b = data.offsets[g], data.offsets[g + 1]
        live = xs[a:b][ms[a:b] > 0]
        check(float(got["min"][g]) == live.min()
              and float(got["max"][g]) == live.max(), f"min/max of group {g}")
    k_ms = cuda_ms(lambda: ops.segment_aggregate(gid32, x, mask, m),
                   reps=10, rounds=5)
    g_ms = graph_ms(lambda: ops.segment_aggregate(gid32, x, mask, m),
                    reps=10, rounds=5)
    p_ms = cuda_ms(lambda: ref.segment_aggregate_ref(gid32, x, mask, m),
                   reps=1, rounds=3)
    feats = ref.aggregate_features(x, mask)
    lo_in = torch.where(mask > 0, x, ref.BIG)
    hi_in = torch.where(mask > 0, x, -ref.BIG)

    def library():
        out = torch.zeros((m, 5), dtype=torch.float32, device=dev)
        out.index_add_(0, gid, feats)
        torch.full((m,), ref.BIG, device=dev).scatter_reduce_(
            0, gid, lo_in, "amin")
        torch.full((m,), -ref.BIG, device=dev).scatter_reduce_(
            0, gid, hi_in, "amax")

    l_ms = cuda_ms(library, reps=5, rounds=3)
    bound_ms = 12 * n / HBM_BYTES_PER_S * 1e3
    print(f"  n={n} m={m}: kernel {k_ms:.4f} ms (graph {g_ms:.4f} ms)  plain "
          f"{p_ms:.3f} ms  library {l_ms:.4f} ms  bound {bound_ms:.4f} ms "
          f"(bytes)  bit-exact={exact_plain}; sums vs numpy float64 rtol "
          f"1e-4, min/max exact")
    return dict(ms=k_ms, graph_ms=g_ms, plain_ms=p_ms, library_ms=l_ms,
                bound_ms=bound_ms, max_abs_err=max_err)


# ---------------------------------------------------------------------------
# phase 5: the card against the CPU at the CPU tests' size
# ---------------------------------------------------------------------------

KW = dict(B=100, n_min=300, n_max=600, l=6, max_iters=16, n_cap=1 << 13,
          ext_cap=1 << 10)


def _np(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _same_answer(a, b, what: str) -> None:
    """Integers exact; theta rtol 1e-5, error rtol 1e-4, beta norm-wise
    rtol 1e-4 (f32 normal equations of condition ~1e4)."""
    for f in ("n", "iterations", "success", "failed", "rows_sampled"):
        va, vb = _np(getattr(a, f)), _np(getattr(b, f))
        check(np.array_equal(va, vb), f"{what}: {f} differs {va} vs {vb}")
    check(np.allclose(_np(a.theta), _np(b.theta), rtol=1e-5, atol=0),
          f"{what}: theta")
    ea, eb = float(a.error), float(b.error)
    check(abs(ea - eb) <= 1e-4 * abs(eb), f"{what}: error {ea} vs {eb}")
    ba, bb = _np(a.beta), _np(b.beta)
    check(np.linalg.norm(ba - bb) <= 1e-4 * np.linalg.norm(bb),
          f"{what}: beta {ba} vs {bb}")


def phase_card_vs_cpu():
    from repro_torch.aqp.query import Query
    from repro_torch.core import keys
    from repro_torch.core.fused import fused_l2miss
    from repro_torch.data import make_grouped
    from repro_torch.serve import LanePool

    args = (["normal", "exp"], 60_000)
    kw = dict(seed=1, biases=[5.0, 3.0])
    dc, dh = make_grouped(*args, **kw, device="cuda"), \
        make_grouped(*args, **kw, device="cpu")
    for est, key, eps in (("avg", 3, 0.1), ("var", 3, 0.1), ("std", 4, 0.08)):
        res = [fused_l2miss(d.values, d.offsets, np.ones(2, np.float32),
                            keys.prng_key(key), eps, 0.05,
                            **{**KW, "est_name": est}) for d in (dc, dh)]
        check(bool(res[0].success), f"fused_l2miss {est} did not converge")
        _same_answer(res[0], res[1], f"fused_l2miss {est}")
        print(f"  fused_l2miss {est}: n={res[0].n.tolist()} "
              f"iters={int(res[0].iterations)} card == cpu")
    skey = keys.prng_key(42)
    specs = [("avg", 0.06), ("var", 0.25), ("avg", 0.25), ("std", 0.3)]
    qkeys = keys.split(keys.prng_key(11), len(specs))
    out = []
    for d in (dc, dh):
        pool = LanePool(d, lanes=2, tiers=1, sample_key=skey, seed=5, **KW)
        for (f, e), k in zip(specs, qkeys):
            pool.submit(Query(func=f, epsilon=e), key=k)
        out.append(pool.drain())
    for a, b in zip(*out):
        _same_answer(a, b, f"pool {a.func}")
    for (f, e), k, r in zip(specs, qkeys, out[0]):
        solo = fused_l2miss(dc.values, dc.offsets, np.ones(2, np.float32), k,
                            e, 0.05, sample_key=skey,
                            **{**KW, "est_name": f, "l": pool._spec["l"]})
        check(np.array_equal(r.n, solo.n.cpu().numpy())
              and r.error == float(solo.error)
              and np.array_equal(r.theta, solo.theta.cpu().numpy()),
              f"pool lane != solo run on the card ({f}, {e})")
    print(f"  lane pool: {len(specs)} answers card == cpu; "
          f"pool lane == solo bit-exact on the card")
    phase_card_vs_cpu_grouped()


GSPEC = dict(B=64, n_min=200, n_max=400, max_iters=16, n_cap=1 << 12)
GPOOL = dict(l=6, ext_cap=1 << 9, **GSPEC)


def phase_card_vs_cpu_grouped():
    """``fused_grouped`` card == cpu, and a pool block == ``fused_grouped``
    under the pool's sample key on the card (tests/test_torch_serve_groupby
    's table)."""
    from repro_torch.aqp.query import Query
    from repro_torch.core import keys
    from repro_torch.core.fused import fused_grouped
    from repro_torch.core.sampling import GroupedData
    from repro_torch.serve import LanePool

    G = 8
    rng = np.random.default_rng(7)
    sizes = rng.integers(1200, 6000, size=G)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    vals = np.empty((int(offsets[-1]), 1), np.float32)
    for g in range(G):
        vals[offsets[g]:offsets[g + 1], 0] = rng.normal(
            rng.normal(5.0, 2.0), rng.uniform(0.5, 1.5), size=sizes[g])
    key = keys.prng_key(99)
    for est, eps in (("avg", 0.1), ("std", 0.1)):
        res = [fused_grouped(torch.from_numpy(vals).to(d), offsets,
                             np.ones(G), key, eps, 0.05, est_name=est,
                             **GPOOL) for d in ("cuda", "cpu")]
        for f in ("n", "iterations", "success", "failed", "rows_sampled"):
            check(torch.equal(res[0].__getattribute__(f).cpu(),
                              res[1].__getattribute__(f)),
                  f"fused_grouped {est}: {f} card != cpu")
        check(np.allclose(_np(res[0].theta), _np(res[1].theta), rtol=1e-5,
                          atol=0), f"fused_grouped {est}: theta card != cpu")
        check(np.allclose(_np(res[0].error), _np(res[1].error), rtol=1e-4,
                          atol=0), f"fused_grouped {est}: error card != cpu")
        print(f"  fused_grouped {est}: n={res[0].n.tolist()} card == cpu")
    dc = GroupedData(torch.from_numpy(vals), offsets, device="cuda")
    pool = LanePool(dc, lanes=2, seed=0, sample_key=keys.prng_key(42),
                    **GPOOL)
    pool.submit_group(Query(func="avg", epsilon=0.1, group_by=True), key=key)
    (blk,) = pool.drain()
    ref = fused_grouped(dc.values, offsets, np.ones(G), key, 0.1, 0.05,
                        sample_key=pool._sample_key, est_name=None,
                        est_fids=np.zeros(G, np.int32), **GPOOL)
    check(np.array_equal(blk.n, _np(ref.n))
          and np.array_equal(blk.error, _np(ref.error))
          and np.array_equal(blk.theta, _np(ref.theta[:, 0]))
          and np.array_equal(blk.beta, _np(ref.beta)),
          "pool block != fused_grouped on the card")
    print("  pool block == fused_grouped bit-exact on the card")


# ---------------------------------------------------------------------------
# phase 6: solo serve at real size
# ---------------------------------------------------------------------------

def _exact(values: np.ndarray, offsets: np.ndarray, func: str) -> np.ndarray:
    out = []
    for g in range(len(offsets) - 1):
        x = values[offsets[g]:offsets[g + 1]].astype(np.float64)
        mu = x.mean()
        out.append({"avg": mu, "sum": x.sum(), "var": x.var(),
                    "std": x.std()}[func])
    return np.asarray(out)


def serve_requests(data):
    """The 16 (func, epsilon) requests of the serve phase, epsilon 1-3 % of
    the L2 norm of the func's exact per-group answers, and those answers."""
    host = data.values[:, 0].cpu().numpy()
    fracs = {"avg": (0.01, 0.015, 0.02, 0.025),
             "sum": (0.01, 0.015, 0.02, 0.025),
             "var": (0.015, 0.02, 0.025, 0.03),
             "std": (0.01, 0.015, 0.02, 0.025)}
    exact = {f: _exact(host, data.offsets, f) for f in fracs}
    reqs = [(f, fracs[f][i] * float(np.linalg.norm(exact[f])))
            for i in range(4) for f in ("avg", "sum", "var", "std")]
    return reqs, exact


def phase_serve(data):
    from repro_torch.aqp.query import Query, Request
    from repro_torch.kernels.poisson_bootstrap import ops
    from repro_torch.serve import AQPSession, Planner, Route

    reqs, exact = serve_requests(data)
    widths = collections.Counter()
    calls = []
    launch = ops.bootstrap_moments_masked

    def recording(x, mask, seeds, B_, *, lane_active=None):
        # Device copies of the arguments (the carried buffer changes in
        # place) and host metadata: no sync.
        widths[x.shape[-1]] += 1
        calls.append((x.clone(), mask.clone(), seeds.clone(), B_,
                      None if lane_active is None else lane_active.clone()))
        return launch(x, mask, seeds, B_, lane_active=lane_active)

    sess = AQPSession(data, planner=Planner(mode=Route.POOL, pool_lanes=8),
                      **SERVE)
    check(sess.use_kernel, "the session did not select the CUDA kernel")
    ops.bootstrap_moments_masked = recording
    reset_counts()
    t0 = time.perf_counter()
    for f, e in reqs:
        sess.submit(Request(query=Query(func=f, epsilon=e)))
    res = sess.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pool_counts = read_counts()
    pool_launches = pool_counts["poisson_bootstrap"]
    loop = AQPSession(data, **SERVE)          # auto planner: cold singleton
    reset_counts()
    t1 = time.perf_counter()
    loop.submit(Request(query=Query(func="avg", epsilon=reqs[0][1])))
    (lres,) = loop.drain()
    loop_wall = time.perf_counter() - t1
    loop_counts = read_counts()
    loop_launches = loop_counts["poisson_bootstrap"]
    ops.bootstrap_moments_masked = launch
    check(len(res) == 16, f"{len(res)} of 16 requests answered")
    within = 0
    for r, (f, e) in zip(res, reqs):
        check(r.route is Route.POOL, f"request on route {r.route}")
        check(r.success and r.error <= e,
              f"{f} eps={e:.4g}: success={r.success} error={r.error:.4g}")
        dev = float(np.linalg.norm(r.theta.ravel() - exact[f]))
        within += dev <= e
        print(f"  {f:4s} eps={e:12.4f} error={r.error:12.4f} "
              f"|theta-exact|={dev:12.4f} n={r.n.tolist()} "
              f"latency={r.latency_s * 1e3:8.2f} ms")
    check(within >= 14, f"only {within} of 16 answers within epsilon")
    check(lres.route is Route.LOOP and lres.success
          and lres.error <= reqs[0][1], "LOOP singleton failed")
    check(pool_launches > 0 and loop_launches > 0,
          "the kernel never launched on the main path")
    lat = np.asarray([r.latency_s for r in res]) * 1e3
    p50 = float(np.percentile(lat, 50))
    st = sess.stats()
    print(f"  serve: wall {wall:.3f} s, latency p50 {np.percentile(lat, 50):.2f}"
          f" ms p99 {np.percentile(lat, 99):.2f} ms, dispatches "
          f"{st['fused_dispatches']}, pool ticks {st['pool']['ticks']}, rows "
          f"touched {st['rows_touched']}, kernel launches {pool_launches}, "
          f"{within}/16 within epsilon")
    print(f"  loop singleton: wall {loop_wall:.3f} s, n={lres.n.tolist()}, "
          f"kernel launches {loop_launches}")
    print(f"  launches by bucket width: {dict(sorted(widths.items()))}")
    return add_counts(pool_counts, loop_counts), widths, calls, p50


# ---------------------------------------------------------------------------
# phase 7: grouped serve at real size
# ---------------------------------------------------------------------------

GROUPED_FRACS = {"avg": (0.01, 0.02), "sum": (0.01, 0.02),
                 "var": (0.03, 0.04), "std": (0.015, 0.02)}


def grouped_requests(data):
    """The grouped serve phase's 12 ``(func, epsilon, group_by)`` requests
    in submit order -- 8 GROUP BY requests at fractions of the smallest
    exact per-group answer, a solo request of phase 6's first wave after
    every second one -- and the exact per-group answers of both kinds."""
    host = data.values[:, 0].cpu().numpy()
    exact = {f: _exact(host, data.offsets, f) for f in GROUPED_FRACS}
    grouped = [(f, frac * float(np.abs(exact[f]).min()))
               for f, fr in GROUPED_FRACS.items() for frac in fr]
    solo, solo_exact = serve_requests(data)
    reqs = []
    for i, (f, e) in enumerate(grouped):
        reqs.append((f, e, True))
        if i % 2:
            reqs.append(solo[i // 2] + (False,))
    return reqs, exact, solo_exact


def phase_grouped_serve(data):
    """8 GROUP BY requests and 4 solo requests in one pool on lineitem SF10
    GROUP BY TAX; returns every kernel's launches in that run and the
    packed-stream lengths the segment kernel ran at."""
    from repro_torch.aqp.query import Query, Request
    from repro_torch.kernels.segment_agg import ops as seg_ops
    from repro_torch.serve import AQPSession, Planner, Route

    reqs, exact, solo_exact = grouped_requests(data)
    grouped = [r[:2] for r in reqs if r[2]]
    solo = [r[:2] for r in reqs if not r[2]]
    lengths = collections.Counter()
    calls = []
    launch = seg_ops.segment_bootstrap_sorted

    def recording(x, mask, slot, seed, lane_off, B_, n_slots):
        # Device copies of the arguments (slots as the kernel reads them,
        # int32) and host metadata: no sync.
        lengths[x.shape[0]] += 1
        calls.append((x.clone(), mask.clone(), slot.to(torch.int32),
                      seed.clone(), lane_off.clone(), B_, n_slots))
        return launch(x, mask, slot, seed, lane_off, B_, n_slots)

    sess = AQPSession(data, planner=Planner(mode=Route.POOL, pool_lanes=8),
                      **SERVE)
    seg_ops.segment_bootstrap_sorted = recording
    reset_counts()
    t0 = time.perf_counter()
    for f, e, g in reqs:
        sess.submit(Request(query=Query(func=f, epsilon=e, group_by=g)))
    res = sess.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    seg_launches = counts["segment_bootstrap"]
    pb_launches = counts["poisson_bootstrap"]
    seg_ops.segment_bootstrap_sorted = launch
    check(len(res) == 12, f"{len(res)} of 12 requests answered")
    gres = [r for r in res if r.group_by]
    sres = [r for r in res if not r.group_by]
    within = 0
    for r, (f, e) in zip(gres, grouped):
        check(r.route is Route.POOL, f"grouped request on route {r.route}")
        check(r.success and bool((r.group_error <= e).all()),
              f"grouped {f} eps={e:.4g}: success={r.success} "
              f"errors={r.group_error}")
        dev = np.abs(np.asarray(r.theta, np.float64) - exact[f])
        within += int((dev <= e).sum())
        print(f"  GROUP BY {f:4s} eps={e:14.4f} max error="
              f"{float(np.max(r.group_error)):14.4f} max |theta-exact|="
              f"{dev.max():14.4f} n={np.asarray(r.n).tolist()} "
              f"latency={r.latency_s * 1e3:8.2f} ms")
    check(within >= 64, f"only {within} of 72 per-group answers within "
                        f"epsilon")
    for r, (f, e) in zip(sres, solo):
        check(r.route is Route.POOL and r.success and r.error <= e,
              f"solo {f} eps={e:.4g}: success={r.success} error={r.error}")
        dev = float(np.linalg.norm(r.theta.ravel() - solo_exact[f]))
        print(f"  solo {f:4s} eps={e:14.4f} error={r.error:14.4f} "
              f"|theta-exact|={dev:14.4f} n={r.n.tolist()} "
              f"latency={r.latency_s * 1e3:8.2f} ms")
    check(seg_launches > 0 and pb_launches > 0,
          f"a bootstrap kernel never launched on the grouped path "
          f"(segment {seg_launches}, poisson {pb_launches})")
    lat = np.asarray([r.latency_s for r in res]) * 1e3
    st = sess.stats()
    print(f"  grouped serve: wall {wall:.3f} s, latency p50 "
          f"{np.percentile(lat, 50):.2f} ms p99 {np.percentile(lat, 99):.2f}"
          f" ms, dispatches {st['fused_dispatches']}, pool ticks "
          f"{st['pool']['ticks']}, block ticks {st['pool']['block_ticks']}, "
          f"rows touched {st['rows_touched']}, {within}/72 per-group answers"
          f" within epsilon; launches: segment {seg_launches}, "
          f"poisson_bootstrap {pb_launches}")
    print(f"  segment launches by stream length: "
          f"{dict(sorted(lengths.items()))}")
    return counts, lengths, calls


# ---------------------------------------------------------------------------
# phase 8: the bootstrap kernels on the serves' own calls
# ---------------------------------------------------------------------------

def replay_calls(name: str, calls, key, fn, plain, pairs_of, per_pair,
                 clock_hz: float, check_upto: int) -> dict:
    """Check one recorded call of each ``key`` up to ``check_upto`` against
    the plain version bit for bit, then replay from one CUDA graph the calls
    at the most used key and all calls in order; the device's ms a call and
    a serve beside the operation bound summed over the same calls."""
    by_key = collections.defaultdict(list)
    for c in calls:
        by_key[key(c)].append(c)
    checked = []
    for k in sorted(by_key):
        if k <= check_upto:
            c = by_key[k][0]
            check(torch.equal(fn(*c), plain(*c)),
                  f"{name}: recorded call at {k} != plain")
            checked.append(k)
    main = max(by_key, key=lambda k: len(by_key[k]))
    fns = [lambda c=c: fn(*c) for c in calls]
    main_fns = [lambda c=c: fn(*c) for c in by_key[main]]
    main_ms = graph_seq_ms(main_fns, rounds=5)
    serve_ms = graph_seq_ms(fns, rounds=5)
    b_main = sum(op_bound_ms(pairs_of(c), per_pair, clock_hz)
                 for c in by_key[main])
    b_serve = sum(op_bound_ms(pairs_of(c), per_pair, clock_hz) for c in calls)
    n_main = len(by_key[main])
    print(f"  {name}: {n_main} calls at {main}: {main_ms / n_main:.4f} ms a "
          f"call (bound {b_main / n_main:.4f}); all {len(calls)} calls in "
          f"order: {serve_ms:.4f} ms of device time a serve (bound "
          f"{b_serve:.4f}); recorded calls at {checked} == plain bit-exact")
    return dict(calls=len(calls), main=main, main_calls=n_main,
                ms_a_call=main_ms / n_main, bound_ms_a_call=b_main / n_main,
                device_ms_a_serve=serve_ms, bound_ms_a_serve=b_serve)


def phase_serve_replays(pb_calls, seg_calls, pb_pp, seg_pp, clock_hz: float):
    from repro_torch.kernels.poisson_bootstrap import ops as pb_ops
    from repro_torch.kernels.poisson_bootstrap import ref as pb_ref
    from repro_torch.kernels.segment_agg import ops as seg_ops
    from repro_torch.kernels.segment_agg import ref as seg_ref

    def pb(x, mask, seeds, B_, act):
        return pb_ops.bootstrap_moments_masked(x, mask, seeds, B_,
                                               lane_active=act)

    def pb_plain(x, mask, seeds, B_, act):
        return pb_ref.bootstrap_moments_masked_ref(x, mask, seeds, B_,
                                                   lane_active=act)

    seg = replay_calls(
        "segment bootstrap, grouped serve", seg_calls,
        lambda c: c[0].shape[0], seg_ops.segment_bootstrap_sorted,
        seg_ref.segment_bootstrap_sorted_ref,
        lambda c: int((c[1] > 0).sum().item()) * c[5], seg_pp, clock_hz,
        check_upto=20000)
    pbr = replay_calls(
        "Poisson bootstrap, solo serve", pb_calls, lambda c: c[0].shape[-1],
        pb, pb_plain, lambda c: pb_pairs(c[1], c[4], c[3]), pb_pp, clock_hz,
        check_upto=16384)
    return pbr, seg


# ---------------------------------------------------------------------------
# phases 9-12: the LM serving path (dense decoder, Qwen2-1.5B)
# ---------------------------------------------------------------------------

LM_ARCH = "qwen2-1.5b"
LM_SLOTS, LM_S_MAX, LM_REQUESTS, LM_NEW = 8, 2048, 16, 32
LM_PROMPT = (32, 1024)          # prompt lengths, inclusive
LM_TOL = dict(rtol=2e-4, atol=2e-4)
F32_FLOPS = 67e12               # H100 SXM f32 outside the tensor cores
DECODE_SHAPES = [               # tests/test_kernels.py's decode shapes
    (1, 8, 2, 128, 1024), (2, 4, 4, 64, 600), (1, 16, 8, 128, 512),
    (2, 8, 1, 128, 768)]


def _bf16_ulps(got: torch.Tensor, want_f32: torch.Tensor) -> float:
    """Largest |got - bf16(want)| beyond the f32 atol (1e-6), in bf16 ulps of
    the larger magnitude: an output that cancels to ~1e-6 carries f32
    rounding of ~1e-8 from either summation order, more than a bf16 ulp of
    so small a value."""
    want = want_f32.to(torch.bfloat16).float()
    g = got.float()
    mag = torch.maximum(g.abs(), want.abs())
    ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
    return float(((g - want).abs() - 1e-6).clamp_min(0.0).div(ulp).max())


def _decode_inputs(B, Hq, Hkv, d, S, dtype, gen, lens, window=None):
    """q, and a cache poisoned outside each row's range: past its length,
    and before ``length - window`` under a window."""
    dev = "cuda"
    q = torch.randn(B, Hq, d, generator=gen, device=dev).to(dtype) * 0.3
    k = (torch.randn(B, S, Hkv, d, generator=gen, device=dev) * 0.3).to(dtype)
    v = torch.randn(B, S, Hkv, d, generator=gen, device=dev).to(dtype)
    for b, L in enumerate(lens.tolist()):
        lo = max(L - window, 0) if window else 0
        for at in (slice(L, None), slice(0, lo)):
            k[b, at] = 100.0
            v[b, at] = 1e4
    return q, k, v


DECODE_SERVE = (LM_SLOTS, 12, 2, 128, LM_S_MAX)     # B, Hq, Hkv, d, S
DECODE_EDGE_LENS = [0, 1, 63, 64, 65, LM_S_MAX, LM_S_MAX + 1, 700]
# 264 (row, KV head) pairs, one block each on 132 SMs, and chunks past the
# kernel's 32 candidates (its bisect path).
DECODE_GRID_BOUND = (264, 4, 1, 32, 2112)
DECODE_ROT = 8              # 8 x 16.8 MB of cache: colder than L2


def decode_sets(kind: str, seed: int = 13, shape=DECODE_SERVE,
                prompt=LM_PROMPT, window=None):
    """``DECODE_ROT`` rotating bf16 caches at ``shape``, with their (B,)
    int32 lengths: ``serve`` draws them in a serve's range (``prompt``
    lengths plus the new tokens), ``full`` sets every length to S_max,
    ``short`` to 64; positions outside each row's range are poisoned."""
    B, Hq, Hkv, d, S = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.default_rng(seed)
    sets = []
    for _ in range(DECODE_ROT):
        if kind == "serve":
            lens = rng.integers(prompt[0] + 1, prompt[1] + LM_NEW + 1, B)
        else:
            lens = np.full(B, S if kind == "full" else 64)
        lens = torch.as_tensor(lens, dtype=torch.int32, device="cuda")
        sets.append((*_decode_inputs(B, Hq, Hkv, d, S, torch.bfloat16, gen,
                                     lens, window), lens))
    return sets


def _cache_rows(lens: torch.Tensor, S: int, window=None) -> int:
    """Cache positions the lengths make the kernel read, all rows summed."""
    hi = lens.long().clamp(0, S)
    lo = (lens.long() - window).clamp(min=0) if window else 0
    return int((hi - lo).clamp(min=0).sum())


def decode_timing(kind: str, sets, window=None, int_len: bool = False
                  ) -> dict:
    """Kernel, plain and library (``scaled_dot_product_attention`` with the
    rows' range as its mask and ``enable_gqa``) times over the rotating
    ``sets``: from a CUDA graph of 64 calls (the device's time) and eagerly
    back to back (the host's enqueue rate included), beside the byte bound
    of the rows the ranges hold.  ``int_len``: every row's length is the
    cache's S_max, passed to the kernel as an int (the cross-attention
    decode's call)."""
    from repro_torch.kernels.decode_attention import ops, ref

    B, S, Hkv, d = sets[0][1].shape
    Hq = sets[0][0].shape[1]
    it = iter(range(1 << 30))
    pos = torch.arange(S, device="cuda")[None, :]
    masks = []
    for s in sets:
        m = pos < s[3][:, None]
        if window:
            m &= pos >= s[3][:, None] - window
        masks.append(m[:, None, None])

    def library(i):
        q, k, v, _ = sets[i]
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=masks[i], enable_gqa=True)

    times = {}
    def kernel(i):
        q, k, v, lens = sets[i]
        return ops.decode_attention(q, k, v, S if int_len else lens,
                                    window=window)

    for name, fn in (
            ("ms", kernel),
            ("plain_ms", lambda i: ref.decode_attention_ref(*sets[i],
                                                            window)),
            ("library_ms", library)):
        def call(fn=fn):
            return fn(next(it) % len(sets))
        times[name] = graph_ms(call, reps=64, rounds=5)
        times["eager_" + name] = cuda_ms(call, reps=64, rounds=5)
    rows = sum(_cache_rows(s[3], S, window) for s in sets) / len(sets)
    n_bytes = rows * Hkv * d * 2 * 2 + 2 * B * Hq * d * 2 + 4 * B
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = rows * Hq * d * 4 / F32_FLOPS * 1e3
    row = dict(times, bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               mb=n_bytes / 1e6, cache_rows=rows)
    print(f"  {kind:5s} lengths ({rows:.0f} cache rows a call on the mean"
          f"{f', window {window}' if window else ''}, {row['mb']:.2f} MB), "
          f"CUDA graph of 64 calls: kernel {row['ms']:.5f} ms  library "
          f"{row['library_ms']:.5f} ms  plain {row['plain_ms']:.4f} ms  "
          f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}; kernel at "
          f"{row['bound_ms'] / row['ms']:.1%} of it); eager back to back: "
          f"kernel {row['eager_ms']:.4f}  library "
          f"{row['eager_library_ms']:.4f}  plain {row['eager_plain_ms']:.4f} "
          f"ms")
    return row


def _check_shape(shape, lens, gen, window=None) -> float:
    """The kernel against its plain version at one shape, in f32 (rtol 1e-5,
    atol 1e-6) and bf16 (one ulp beyond that atol of the plain version's f32
    result), the cache poisoned outside each row's range.  ``lens`` is one
    int (the same lengths as a tensor give the same output) or one length a
    row (int64 lengths give int32's output); rows of length 0 read zeros.
    Returns the largest abs error against the plain version in the kernel's
    type."""
    from repro_torch.kernels.decode_attention import ops, ref

    B, Hq, Hkv, d, S = shape
    one = isinstance(lens, int)
    t = torch.as_tensor(np.broadcast_to(lens, (B,)).copy(), dtype=torch.int32,
                        device="cuda")
    err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = _decode_inputs(B, Hq, Hkv, d, S, dt, gen, t.clamp(max=S),
                                 window)
        got = ops.decode_attention(q, k, v, lens if one else t, window=window)
        same = ops.decode_attention(q, k, v, t if one else t.long(),
                                    window=window)
        want = ref.decode_attention_ref(q.float(), k.float(), v.float(), t,
                                        window)
        torch.cuda.synchronize()
        what = f"{shape} window {window} {dt}"
        check(torch.equal(got, same), f"{what}: int, int32 and int64 lengths "
                                      f"differ")
        check(not got[t == 0].any(), f"{what}: a row of length 0 is not zero")
        if dt == torch.float32:
            e = float((got - want).abs().max())
            check(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
                  f"{what}: f32 kernel != plain (max abs err {e})")
        else:
            ulps = _bf16_ulps(got, want)
            check(ulps <= 1.0, f"{what}: bf16 kernel {ulps} ulps off")
            e = float((got.float() - ref.decode_attention_ref(
                q, k, v, t, window).float()).abs().max())
        err = max(err, e)
    return err


def _check_cases(cases, window=None, seed: int = 9) -> float:
    """:func:`_check_shape` on each ``(label, shape, lens)``; returns the
    largest abs error."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    err = 0.0
    for label, shape, lens in cases:
        err = max(err, _check_shape(shape, lens, gen, window))
        print(f"  {label} (B, Hq, Hkv, d, S) = {shape}"
              f"{f', window {window}' if window else ''}, lengths "
              f"{lens if np.size(lens) <= 8 else f'{len(lens)} drawn'}: f32 "
              f"and bf16 pass, int / int32 / int64 lengths alike")
    return err


def _decode_checks(sets, window=None) -> float:
    """The kernel against its plain version on the rotating ``sets`` (bf16)
    and in f32 on the first; repeat calls and graph replays bit-equal.
    Returns the largest abs error against the plain version in the kernel's
    type."""
    from repro_torch.kernels.decode_attention import ops, ref

    max_err, worst_ulps = 0.0, 0.0
    for q, k, v, lens in sets:
        got = ops.decode_attention(q, k, v, lens, window=window)
        again = ops.decode_attention(q, k, v, lens, window=window)
        plain = ref.decode_attention_ref(q, k, v, lens, window)
        f32 = ref.decode_attention_ref(q.float(), k.float(), v.float(), lens,
                                       window)
        torch.cuda.synchronize()
        check(torch.equal(got, again), "two calls differ")
        max_err = max(max_err, float((got.float() - plain.float()).abs().max()))
        worst_ulps = max(worst_ulps, _bf16_ulps(got, f32))
    check(worst_ulps <= 1.0, f"bf16 kernel {worst_ulps} ulps from the plain "
                             f"version's f32 result")
    q, k, v, lens = sets[0]
    qf, kf, vf = q.float(), k.float(), v.float()
    got = ops.decode_attention(qf, kf, vf, lens, window=window)
    want = ref.decode_attention_ref(qf, kf, vf, lens, window)
    torch.cuda.synchronize()
    f32_err = float((got - want).abs().max())
    max_err = max(max_err, f32_err)
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
          f"f32 kernel != plain on the rotating caches' first (max abs err "
          f"{f32_err})")
    # A CUDA graph of one call replays the eager result twice over: the
    # arrival counters were left zero.
    q, k, v, lens = sets[1]
    eager = ops.decode_attention(q, k, v, lens, window=window)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.decode_attention(q, k, v, lens, window=window)
    graph.replay()
    torch.cuda.synchronize()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    check(torch.equal(first, eager) and torch.equal(out, first),
          "graph replay != eager call")
    print(f"  rotating caches {tuple(sets[0][0].shape)} / "
          f"{tuple(sets[0][1].shape)}{f', window {window}' if window else ''}"
          f": bf16 within {worst_ulps:.2f} ulp of plain f32 (max abs err vs "
          f"plain bf16 {max_err:.3g}), f32 max abs err {f32_err:.3g}; repeat "
          f"calls and graph replays bit-equal")
    return max_err


def _one_kernel_a_call(sets, window: int) -> None:
    """Every device op of 16 calls in a trace, alternately without and with
    a window: 16 decode-attention kernels and nothing else (the window's
    lower bound is formed inside the kernel)."""
    from repro_torch.kernels.decode_attention import ops

    n = 16
    it = iter(range(1 << 30))

    def call():
        i = next(it)
        return ops.decode_attention(*sets[i % len(sets)],
                                    window=window if i % 2 else None)

    dev_ops = device_kernels(call, n)
    check(sum(dev_ops.values()) == n
          and all("decode_attn_kernel" in k for k in dev_ops),
          f"{n} calls ran {dev_ops} on the device")
    print(f"  {n} calls, half of them with a window of {window}, ran {n} "
          f"device kernels ({next(iter(dev_ops))[:48]}...) and nothing else")


def phase_decode_kernel():
    """Kernel vs plain at the serve's shape (bf16 and f32), the edge lengths,
    a grid-bound shape and the reference test's shapes; then timed at the
    serve's, full and short lengths.  Returns the serve row for the result
    line."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sets = decode_sets("serve")
    max_err = _decode_checks(sets)
    _one_kernel_a_call(sets, 256)
    glen = np.random.default_rng(7).integers(0, DECODE_GRID_BOUND[4] + 1,
                                             DECODE_GRID_BOUND[0])
    max_err = max(max_err, _check_cases(
        [("edge lengths", DECODE_SERVE, DECODE_EDGE_LENS),
         ("grid-bound shape (one block a pair, chunks past 32 tiles)",
          DECODE_GRID_BOUND, glen)]
        + [("reference test shape", s, s[4]) for s in DECODE_SHAPES]))
    rows = {"serve": decode_timing("serve", sets)}
    del sets
    for kind in ("full", "short"):
        rows[kind] = decode_timing(kind, decode_sets(kind))
    torch.cuda.empty_cache()
    return dict(rows["serve"], max_abs_err=max_err, rows=rows)


LM_CPU_SPECS = [(6, 8), (6, 12), (6, 8), (6, 8), (16, 16), (6, 16)]
LM_CPU_S_MAX, LM_CPU_SLOTS, LM_CPU_EOS_RID = 24, 2, 1


def _lm_small_serve(cfg, params, prompts, eos):
    """tests/test_torch_lm_serve.py's batcher run: 6 requests, 2 slots."""
    from repro_torch.serve.batching import ContinuousBatcher, Request

    b = ContinuousBatcher(cfg, params, slots=LM_CPU_SLOTS, s_max=LM_CPU_S_MAX)
    for rid, (p, (_, new)) in enumerate(zip(prompts, LM_CPU_SPECS)):
        b.submit(Request(rid=rid, prompt=p, max_new_tokens=new,
                         eos_id=eos if rid == LM_CPU_EOS_RID else None))
    return {r.rid: list(map(int, r.out_tokens)) for r in b.run()}


def row4_per_step(cfg) -> int:
    """Row-4 launches a decode step: one an attention or xonly layer, two a
    cross layer (its self- and cross-attention)."""
    from repro_torch.models import model as M

    per = {"attn": 1, "xonly": 1, "cross": 2}
    return sum(per.get(M.parse_kind(k)[0], 0) for k in M.layer_kinds(cfg))


def phase_lm_card_vs_cpu(arch: str = LM_ARCH, window=None):
    """The reduced LM on the card (kernel) against the CPU (plain version):
    the CPU serve test's weights and prompts (``window`` overrides the
    config's sliding window)."""
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy, lm_tree_from_seed
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.models import model as M
    from repro_torch.models.config import reduced_for_smoke

    cfg = reduced_for_smoke(get_config(arch))
    if window is not None:
        cfg = dataclasses.replace(cfg, sliding_window=window)
    tree = lm_tree_from_seed(cfg, 2)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n, _ in LM_CPU_SPECS]
    pc = lm_params_from_numpy(cfg, tree, device="cuda")
    ph = lm_params_from_numpy(cfg, tree, device="cpu")
    free = _lm_small_serve(cfg, ph, prompts, None)
    eos = free[LM_CPU_EOS_RID][3]
    n0 = da_ops.counter.launches
    card = _lm_small_serve(cfg, pc, prompts, eos)
    launched = da_ops.counter.launches - n0
    cpu = _lm_small_serve(cfg, ph, prompts, eos)
    check(card == cpu, f"batcher tokens card != cpu: {card} vs {cpu}")
    check((launched > 0) == (row4_per_step(cfg) > 0),
          f"the card's batcher launched the kernel {launched} times with "
          f"{row4_per_step(cfg)} attention layers")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 12))
    logs = []
    for p, dev in ((pc, "cuda"), (ph, "cpu")):
        seq = torch.as_tensor(tokens, device=dev)
        last, raw, _ = M.prefill(cfg, p, {"tokens": seq})
        caches = M.caches_from_prefill(cfg, raw, S_max=16)
        out = [last]
        for t in range(3):
            last, caches = M.decode_step(cfg, p, seq[:, t:t + 1], caches)
            out.append(last)
        logs.append(torch.cat(out, dim=1).cpu().numpy())
    err = float(np.abs(logs[0] - logs[1]).max())
    check(np.allclose(logs[0], logs[1], **LM_TOL),
          f"LM logits card != cpu (max abs err {err})")
    print(f"  reduced {arch}: batcher tokens card == cpu for "
          f"{len(card)} requests ({launched} kernel launches on the card), "
          f"prefill + 3 decode logits max abs err {err:.3g}")


def phase_lm_full_width_f32():
    """Qwen2-1.5B in f32: prefill -> decode_step (the kernel) against
    train_logits over the extended sequence."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float32")
    t = time.perf_counter()
    params = M.init_model(cfg, seed=1, device="cuda")
    torch.cuda.synchronize()
    n_params = M.count_params(params)
    print(f"  {LM_ARCH} f32: {n_params / 1e9:.3f} B params, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, built "
          f"in {time.perf_counter() - t:.1f} s")
    seq = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 64)), device="cuda")
    last, raw, _ = M.prefill(cfg, params, {"tokens": seq})
    caches = M.caches_from_prefill(cfg, raw, S_max=128)
    worst, clear_n = 0.0, 0
    for _ in range(4):
        nxt = last[:, -1].argmax(-1)[:, None]
        seq = torch.cat([seq, nxt], dim=1)
        last, caches = M.decode_step(cfg, params, nxt, caches)
        full, _ = M.train_logits(cfg, params, {"tokens": seq})
        a, b = last[:, 0], full[:, -1]
        err = float((a - b).abs().max())
        worst = max(worst, err)
        check(torch.allclose(a, b, **LM_TOL),
              f"full-width decode != train_logits (max abs err {err})")
        top2 = torch.topk(b, 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > LM_TOL["atol"]
        clear_n += int(clear.sum())
        check(torch.equal(a.argmax(-1)[clear], b.argmax(-1)[clear]),
              "full-width argmax differs")
    print(f"  prefill(64) + 4 decode steps vs train_logits: max abs err "
          f"{worst:.3g} (rtol/atol 2e-4), argmax equal on {clear_n} of 8 "
          f"clear rows")
    del params, caches, last, full
    torch.cuda.empty_cache()


def lm_requests(cfg):
    """The full-width serve's 16 prompts (numpy seed 0)."""
    rng = np.random.default_rng(0)
    lens = rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, LM_REQUESTS)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]


def run_lm_serve(cfg, params, prompts, *, slots: int = LM_SLOTS,
                 s_max: int = LM_S_MAX, new: int = LM_NEW) -> dict:
    """One ContinuousBatcher serve of ``prompts``; host-clock times around
    work that ends in a host read (each splice and step reads tokens)."""
    from repro_torch.serve.batching import ContinuousBatcher, Request

    batcher = ContinuousBatcher(cfg, params, slots=slots, s_max=s_max)
    splice_s, step_s, steps = [], [], [0]
    splice, decode = batcher._splice, batcher._decode

    def timed_splice(slot, req):
        t = time.perf_counter()
        splice(slot, req)
        splice_s.append(time.perf_counter() - t)

    def counted_decode(*a):
        steps[0] += 1
        return decode(*a)

    batcher._splice, batcher._decode = timed_splice, counted_decode
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        batcher.submit(r)
    done_s = {}
    while batcher.queue or batcher.active:
        n_spl, n_steps = len(splice_s), steps[0]
        t = time.perf_counter()
        batcher.step()
        dt = time.perf_counter() - t
        if steps[0] > n_steps:
            step_s.append(dt - sum(splice_s[n_spl:]))
        now = time.perf_counter()
        for r in batcher.completed:
            done_s.setdefault(r.rid, now - t0)
    wall = time.perf_counter() - t0
    return dict(wall=wall, done=batcher.completed, splice_s=splice_s,
                step_s=step_s, steps=steps[0], latency_s=done_s)


def phase_lm_serve(arch: str = LM_ARCH, *, n_layers=None, prompts=None,
                   warm=None, slots: int = LM_SLOTS, s_max: int = LM_S_MAX,
                   new: int = LM_NEW, cfg=None) -> dict:
    """An LM in bf16 at full width (``n_layers`` cuts the depth; ``cfg``
    replaces the arch's config): by default phase 12's 16 requests through
    8 slots; ``warm`` prompts (default the first two) run first, outside
    the count.  Row 4 must launch once per attention layer and decode step.
    Returns every kernel's launches in the counted serve."""
    from repro_torch.configs import get_config
    from repro_torch.models import flops
    from repro_torch.models import model as M

    cfg = get_config(arch) if cfg is None else cfg
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    t = time.perf_counter()
    params = M.init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"  {arch} bf16, {cfg.n_layers} of {get_config(arch).n_layers} "
          f"layers: {M.count_params(params) / 1e9:.3f} B params, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, built "
          f"in {time.perf_counter() - t:.1f} s")
    prompts = lm_requests(cfg) if prompts is None else prompts
    kw = dict(slots=slots, s_max=s_max, new=new)
    run_lm_serve(cfg, params, prompts[:2] if warm is None else warm, **kw)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    st = run_lm_serve(cfg, params, prompts, **kw)
    counts = read_counts()
    n_da = counts["decode_attention"]
    done = st["done"]
    check(len(done) == len(prompts), f"{len(done)} of {len(prompts)} "
                                     f"requests completed")
    for r in done:
        check(len(r.out_tokens) == new,
              f"request {r.rid} has {len(r.out_tokens)} tokens")
        check(all(0 <= x < cfg.vocab_size for x in r.out_tokens),
              f"request {r.rid}: token out of the vocabulary")
    n_attn = row4_per_step(cfg)
    check(n_da == n_attn * st["steps"] and (n_da > 0) == (n_attn > 0),
          f"decode-attention launches {n_da} != {n_attn} attention layers x "
          f"{st['steps']} decode steps")
    tokens = sum(len(r.out_tokens) for r in done)
    lat = np.asarray(list(st["latency_s"].values())) * 1e3
    step_ms = np.asarray(st["step_s"]) * 1e3
    print(f"  serve: {len(done)} requests, {tokens} tokens in "
          f"{st['wall']:.3f} s = {tokens / st['wall']:.1f} tokens/s; "
          f"{st['steps']} decode steps, decode step mean "
          f"{step_ms.mean():.2f} ms p50 {np.percentile(step_ms, 50):.2f} ms; "
          f"prefill (+splice) mean {np.mean(st['splice_s']) * 1e3:.2f} ms "
          f"over {len(st['splice_s'])} prompts of "
          f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens; "
          f"latency (submit -> last token) p50 "
          f"{np.percentile(lat, 50):.2f} ms p99 {np.percentile(lat, 99):.2f} "
          f"ms; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB;"
          f" decode-attention launches {n_da} ({n_attn} attention layers); "
          f"a decode step's byte bound (every weight read once) "
          f"{flops.weight_bytes(cfg) / HBM_BYTES_PER_S * 1e3:.3f} ms")
    del params, st
    gc.collect()                # the serve's batcher sits in a cycle
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 13: the host route on the card against the CPU
# ---------------------------------------------------------------------------

HOST_CFG = dict(delta=0.05, B=150, n_min=400, n_max=800, l=6, seed=0,
                max_iters=40)
HOST_EPS = {"avg": 0.05, "sum": 5000.0, "var": 0.1, "std": 0.05,
            "median": 0.05, "min": 0.5}
HOST_METRICS = ("l2", "linf", "l1", "lp3", "diff", "order")


def _host_run(data, func, metric, use_kernel):
    """One host-route run (``run_l2miss`` or its extension) at the CPU
    tests' configuration."""
    from repro_torch.core import extensions as X
    from repro_torch.core.l2miss import MissConfig, run_l2miss

    cfg = MissConfig(epsilon=HOST_EPS[func], use_kernel=use_kernel,
                     **HOST_CFG)
    run = {"l2": run_l2miss, "linf": X.run_maxmiss, "diff": X.run_diffmiss,
           "order": X.run_ordermiss,
           "l1": lambda d, f, c: X.run_lpmiss(d, f, c, p=1),
           "lp3": lambda d, f, c: X.run_lpmiss(d, f, c, p=3)}[metric]
    return run(data, func, cfg)


def _same_trace(a, b, what: str, cancels: bool) -> None:
    """Integers exact; theta rtol 1e-5 and error rtol 1e-4 (1e-4 and 2e-3
    for var/std), the CPU tests' tolerances."""
    for f in ("iterations", "status", "total_sampled"):
        check(getattr(a, f) == getattr(b, f),
              f"{what}: {f} {getattr(a, f)} vs {getattr(b, f)}")
    check(np.array_equal(a.n, b.n) and np.array_equal(a.profile_n,
                                                      b.profile_n),
          f"{what}: n {a.n} vs {b.n}")
    rt, re = (1e-4, 2e-3) if cancels else (1e-5, 1e-4)
    check(np.allclose(np.asarray(a.theta, np.float64),
                      np.asarray(b.theta, np.float64), rtol=rt, atol=0),
          f"{what}: theta {a.theta.ravel()} vs {b.theta.ravel()}")
    check(abs(a.error - b.error) <= re * abs(b.error),
          f"{what}: error {a.error} vs {b.error}")


_CPU_TABLE = {}


def _host_run_cpu(func, metric, entry):
    """``_host_run`` on the CPU table, in a worker process of one thread;
    returns the trace and its seconds."""
    from repro_torch.data import make_grouped

    torch.set_num_threads(1)
    if "data" not in _CPU_TABLE:
        _CPU_TABLE["data"] = make_grouped(["normal", "exp"], 150_000, seed=1,
                                          biases=[5.0, 3.0], device="cpu")
    t = time.perf_counter()
    tr = _host_run(_CPU_TABLE["data"], func, metric, entry)
    return tr, time.perf_counter() - t


def phase_host_vs_cpu():
    """``run_l2miss`` and every extension with the moments entry on the card
    (the CUDA kernel) and on the CPU (its plain version), median and min on
    the generic route; the entry itself card == cpu bit for bit; and
    ``AQPEngine.exact`` (the segment-aggregate kernel) against numpy
    float64.  The CPU runs go to worker processes (one thread each), since
    the plain bootstrap's weight hashing is their cost."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.aqp import AQPEngine, Query
    from repro_torch.core import sampling
    from repro_torch.data import make_grouped
    from repro_torch.kernels.poisson_bootstrap import ops as pb_ops

    args = (["normal", "exp"], 150_000)
    kw = dict(seed=1, biases=[5.0, 3.0])
    dc, dh = make_grouped(*args, **kw, device="cuda"), \
        make_grouped(*args, **kw, device="cpu")
    # OrderMiss first: on this table var and std have equal group values,
    # so their order bound is ~0 and those runs scan every row (minutes on
    # the CPU, under a second on the card).
    runs = [(f, m, True) for m in HOST_METRICS[::-1]
            for f in ("avg", "sum", "var", "std")]
    runs += [("median", "l2", False), ("min", "l2", False)]
    t0 = time.perf_counter()
    launches = pb_ops.counter.launches
    workers = max(1, min(8, (os.cpu_count() or 2) - 1))
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        cpu = [ex.submit(_host_run_cpu, *r) for r in runs]
        card, card_s = [], []
        for r in runs:
            t = time.perf_counter()
            card.append(_host_run(dc, *r))
            card_s.append(time.perf_counter() - t)
        t_card = time.perf_counter() - t0
        cpu, cpu_s = zip(*[f.result() for f in cpu])
    for (func, metric, _), a, b in zip(runs, card, cpu):
        _same_trace(a, b, f"host {func}/{metric}", func in ("var", "std"))
    print(f"  seconds a run, card: {' '.join(f'{x:.2f}' for x in card_s)}"
          f" ({t_card:.1f} s in all); CPU worker: "
          f"{' '.join(f'{x:.1f}' for x in cpu_s)}")
    check(pb_ops.counter.launches > launches,
          "the moments entry never launched the kernel on the card")
    print(f"  {len(runs)} host runs (avg/sum/var/std x "
          f"{'/'.join(HOST_METRICS)} through the moments entry, median and "
          f"min generic): card == cpu integers, theta/error within the CPU "
          f"tests' rtol; {pb_ops.counter.launches - launches} kernel "
          f"launches; {time.perf_counter() - t0:.1f} s ({workers} CPU "
          f"workers)")
    n_vec = np.asarray([700, 1500])
    sh, mh = sampling.stratified_sample(sampling.root_key(2), dh.values,
                                        dh.offsets, n_vec, 2048)
    key = sampling.root_key(3)
    for func in ("avg", "var", "sum"):
        scale = torch.as_tensor(np.asarray(
            dh.scale if func == "sum" else np.ones(2), np.float32))
        ec, tc = pb_ops.estimate_error_moments(func, sh.cuda(), mh.cuda(),
                                               scale.cuda(), key, 0.05, B=B)
        eh, th = pb_ops.estimate_error_moments(func, sh, mh, scale, key,
                                               0.05, B=B)
        check(float(ec) == float(eh) and torch.equal(tc.cpu(), th),
              f"estimate_error_moments {func}: card != cpu")
    print("  estimate_error_moments card == cpu bit for bit (avg, var, sum)")
    eng = AQPEngine(dc)
    host = dc.values[:, 0].cpu().numpy()
    for func in ("avg", "sum", "var", "std"):
        got = eng.exact(Query(func=func, epsilon=1.0))[:, 0]
        want = _exact(host, dc.offsets, func)
        check(np.allclose(got, want, rtol=1e-5 if func in ("avg", "sum")
                          else 1e-4, atol=0),
              f"AQPEngine.exact {func}: {got} vs {want}")
    print("  AQPEngine.exact (segment-aggregate kernel) vs numpy float64: "
          "avg/sum rtol 1e-5, var/std rtol 1e-4")


# ---------------------------------------------------------------------------
# phase 14: the host serve at real size
# ---------------------------------------------------------------------------

PRED_HI = (">", ("col", 0), 20000.0)
PRED_LO = ("<", ("col", 0), 5000.0)


def _exact_host(host: np.ndarray, offsets: np.ndarray, func: str,
                pred=None) -> np.ndarray:
    """numpy float64 exact answers a group (a predicate folds into a 0/1
    measure, as the engine folds it)."""
    out = []
    for g in range(len(offsets) - 1):
        x = host[offsets[g]:offsets[g + 1]].astype(np.float64)
        if pred is not None:
            x = ((x > pred[2]) if pred[0] == ">" else (x < pred[2])).astype(
                np.float64)
        if func in ("median", "maxq"):
            q = 0.5 if func == "median" else 0.99
            k = int(np.ceil(q * len(x))) - 1      # first cum. count >= q n
            out.append(np.partition(x, k)[k])
        elif func == "count":
            out.append(x.sum())
        else:
            out.append(_exact(x, np.asarray([0, len(x)]),
                              "avg" if func == "proportion" else func)[0])
    return np.asarray(out)


def host_requests(data):
    """Phase 14's 12 requests ``(label, Query kwargs, metric, exact)``:
    epsilon a fraction of the L2 norm of the exact answers (as phase 6
    sizes it), or per group for GROUP BY."""
    host = data.values[:, 0].cpu().numpy()
    off = data.offsets
    ex = {f: _exact_host(host, off, f) for f in
          ("avg", "sum", "var", "std", "median", "maxq")}
    cnt = _exact_host(host, off, "count", PRED_HI)
    prop = _exact_host(host, off, "proportion", PRED_LO)
    gprop = _exact_host(host, off, "proportion", PRED_HI)
    nrm = {f: float(np.linalg.norm(v)) for f, v in ex.items()}
    return [
        ("avg linf 1%", dict(func="avg", epsilon=0.01 * nrm["avg"],
                             metric="linf"), "linf", ex["avg"]),
        ("sum l1 2%", dict(func="sum", epsilon=0.02 * nrm["sum"],
                           metric="l1"), "l1", ex["sum"]),
        ("var lp3 2%", dict(func="var", epsilon=0.02 * nrm["var"],
                            metric="lp", lp=3.0), "lp3", ex["var"]),
        ("std diff 1.5%", dict(func="std", epsilon=0.015 * nrm["std"],
                               metric="diff"), "diff", ex["std"]),
        ("avg order", dict(func="avg", metric="order"), "order", ex["avg"]),
        ("avg rel 0.01", dict(func="avg", epsilon_rel=0.01), "l2",
         ex["avg"]),
        ("count >20000 1%", dict(func="count",
                                 epsilon=0.01 * float(np.linalg.norm(cnt)),
                                 predicate=PRED_HI), "l2", cnt),
        ("proportion <5000", dict(func="proportion", epsilon=0.005,
                                  predicate=PRED_LO), "l2", prop),
        ("median 1%", dict(func="median", epsilon=0.01 * nrm["median"]),
         "l2", ex["median"]),
        ("maxq 1%", dict(func="maxq", epsilon=0.01 * nrm["maxq"]), "l2",
         ex["maxq"]),
        ("GROUP BY avg >20000", dict(func="avg", epsilon=0.005,
                                     predicate=PRED_HI, group_by=True),
         "group", gprop),
        ("GROUP BY sum rel 0.02", dict(func="sum", epsilon_rel=0.02,
                                       group_by=True), "group", ex["sum"]),
    ]


def _metric(name: str, theta, exact) -> float:
    from repro_torch.core.extensions import metric_value

    d = np.ravel(np.asarray(theta, np.float64)) - np.ravel(exact)
    if name == "lp3":
        return float(np.sum(np.abs(d) ** 3) ** (1.0 / 3.0))
    if name == "group":
        return float(np.abs(d).max())
    return metric_value(name, np.ravel(theta), np.ravel(exact))


def phase_host_serve(data):
    """12 host-route requests through ``AQPSession`` (auto planner, B = 300)
    on lineitem SF10 GROUP BY SHIPINSTRUCT, the engine's exact answers of
    the moment requests through the segment-aggregate kernel, then one
    ``AQPService`` batch (fused avg, host median, predicate count) twice.
    Returns every kernel's launches in that run and row 3's timings."""
    from repro_torch.aqp.query import Query, Request
    from repro_torch.kernels.segment_agg import ops as seg_ops
    from repro_torch.serve import AQPService, AQPSession, Route

    reqs = host_requests(data)
    sess = AQPSession(data, **SERVE)
    traces = {}
    execute = sess.engine.execute

    def recording(q):
        tr = execute(q)
        traces[id(q)] = tr
        return tr

    sess.engine.execute = recording
    queries = [Query(**kw) for _, kw, _, _ in reqs]
    moment, moment_exact = zip(*[
        (q, r[3]) for q, r in zip(queries, reqs)
        if q.func in ("avg", "sum", "var", "std", "count", "proportion")])
    reset_counts()
    t0 = time.perf_counter()
    for q in queries:
        sess.submit(Request(query=q))
    res = sess.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    exacts = [sess.engine.exact(q) for q in moment]
    exact_wall = (time.perf_counter() - t1) / len(moment)
    svc = AQPService(data, **SERVE)
    batch = [Query(func="avg", epsilon=reqs[0][1]["epsilon"]),
             Query(func="median", epsilon=reqs[8][1]["epsilon"]),
             Query(func="count", epsilon=reqs[6][1]["epsilon"],
                   predicate=PRED_HI)]
    new_rows = []
    for _ in range(2):
        before = svc.rows_touched
        out = svc.answer(batch)
        check(all(r.success for r in out),
              f"a service batch request failed: "
              f"{[(q.func, r.success, r.error) for q, r in zip(batch, out)]}")
        new_rows.append(svc.rows_touched - before)
    torch.cuda.synchronize()
    total_wall = time.perf_counter() - t0
    counts = read_counts()
    check(len(res) == len(reqs), f"{len(res)} of {len(reqs)} answered")
    within = 0
    for r, q, (label, kw, metric, exact) in zip(res, queries, reqs):
        tr = traces[id(q)]
        check(r.route is Route.HOST, f"{label}: route {r.route}")
        if metric == "order":
            eps = tr.info["order_bound_eps"]
        elif q.epsilon is None:
            eps = q.epsilon_rel * sess.engine._pilot_scale(q)
        else:
            eps = q.epsilon
        if q.group_by:
            ok = bool(r.success) and bool((r.group_error <= eps).all())
            iters = int(np.asarray(tr.iterations.cpu()).max())
        else:
            ok = bool(r.success) and r.error <= eps
            iters = tr.iterations
        check(ok, f"{label}: success={r.success} error={r.error:.6g} "
                  f"eps={eps:.6g}")
        dev = _metric(metric, r.theta, exact)
        hit = dev == 0.0 if metric == "order" else dev <= eps
        within += hit
        print(f"  {label:22s} eps={eps:14.6g} error={r.error:14.6g} "
              f"{metric} vs exact={dev:14.6g} within={hit} n="
              f"{np.asarray(r.n).tolist()} iterations={iters} "
              f"latency={r.latency_s * 1e3:9.2f} ms")
    check(within >= 9, f"only {within} of {len(reqs)} answers within "
                       f"epsilon of the exact answer")
    for q, got, exact in zip(moment, exacts, moment_exact):
        check(np.allclose(got[:, 0], exact, rtol=1e-4, atol=0),
              f"AQPEngine.exact {q.func}: {got[:, 0]} vs {exact}")
    check(new_rows[1] < new_rows[0],
          f"the second service batch touched {new_rows[1]} new rows, the "
          f"first {new_rows[0]}")
    check(counts["poisson_bootstrap"] > 0 and counts["segment_aggregate"] > 0,
          f"a kernel never launched on the host path: {counts}")
    st = sess.stats()
    lat = np.asarray([r.latency_s for r in res]) * 1e3
    print(f"  host serve: wall {wall:.3f} s for {len(reqs)} requests, latency "
          f"p50 {np.percentile(lat, 50):.2f} ms p99 {np.percentile(lat, 99):.2f}"
          f" ms; rows touched {st['rows_touched']} (store {st['store_rows']}, "
          f"fused {st['fused_rows']}); {within}/{len(reqs)} within epsilon")
    print(f"  AQPEngine.exact: {len(moment)} calls, {exact_wall * 1e3:.2f} ms "
          f"a call (host clock, one segment-aggregate launch each), vs numpy "
          f"float64 rtol 1e-4")
    print(f"  service batch (fused avg, host median, predicate count) twice:"
          f" new rows {new_rows[0]} then {new_rows[1]}; phase wall "
          f"{total_wall:.3f} s; launches {counts}")
    x = data.values[:, 0]
    gid = sess.engine._group_ids()
    ones = torch.ones_like(x)
    m = data.num_groups
    agg_ms = cuda_ms(lambda: seg_ops.segment_aggregate(gid, x, ones, m),
                     reps=10, rounds=5)
    agg_graph = graph_ms(lambda: seg_ops.segment_aggregate(gid, x, ones, m),
                         reps=10, rounds=5)
    print(f"  segment aggregate inside exact (n={x.shape[0]}, m={m}): "
          f"{agg_ms:.4f} ms eager, {agg_graph:.4f} ms from a graph, bound "
          f"{12 * x.shape[0] / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes)")
    return counts, dict(exact_ms=agg_ms, exact_graph_ms=agg_graph,
                        exact_wall_ms=exact_wall * 1e3)


# ---------------------------------------------------------------------------
# phase 15: warm and SLO lanes, the card against the CPU
# ---------------------------------------------------------------------------

def _bits_equal(a, b) -> bool:
    return (_np(a.theta).tobytes() == _np(b.theta).tobytes()
            and _np(a.error).tobytes() == _np(b.error).tobytes())


def _same_lane(r, solo, what: str) -> None:
    """A pool response equal to a solo run on the same device, bit for
    bit."""
    check(np.array_equal(r.n, _np(solo.n))
          and r.iterations == int(solo.iterations)
          and _np(r.theta).tobytes() == _np(solo.theta).tobytes()
          and np.float32(r.error).tobytes() == _np(solo.error).tobytes(),
          f"{what}: pool lane != solo run on the card")


def phase_warm_slo_vs_cpu():
    """Warm solo lanes (right, stale and garbage-coefficient predictions)
    and a warm grouped block card == CPU at the CPU tests' size (phase 5's
    tolerances); on the card, a warm pool lane and block equal their solo
    warm runs, a degraded lane a solo run at its delivered epsilon, a
    migrated lane its solo run (the move asserted), bit for bit; one shed
    pilot card == CPU within phase 13's tolerance.  Returns the launches of
    the card's runs."""
    from repro_torch.aqp.query import Query
    from repro_torch.core import keys
    from repro_torch.core.fused import fused_grouped, fused_l2miss
    from repro_torch.data import make_grouped
    from repro_torch.serve import LanePool

    args = (["normal", "exp"], 60_000)
    kw = dict(seed=1, biases=[5.0, 3.0])
    dc, dh = make_grouped(*args, **kw, device="cuda"), \
        make_grouped(*args, **kw, device="cpu")
    ones = np.ones(2, np.float32)
    skey, key = keys.prng_key(42), keys.prng_key(3)
    spec = {**KW, "est_name": "avg"}
    reset_counts()
    cold = fused_l2miss(dc.values, dc.offsets, ones, key, 0.05, 0.05,
                        sample_key=skey, **spec)
    cases = [("right", _np(cold.n), _np(cold.beta)),
             ("stale", np.full(2, KW["n_min"], np.int32), _np(cold.beta)),
             ("garbage beta", np.full(2, 500, np.int32),
              np.asarray([0.0, 0.05, 0.05], np.float32))]
    bit = 0
    for name, wn0, wb in cases:
        res = [fused_l2miss(d.values, d.offsets, ones, key, 0.05, 0.05,
                            sample_key=skey, warm_n0=wn0, warm_beta=wb,
                            **spec) for d in (dc, dh)]
        check(bool(res[0].success) and float(res[0].error) <= 0.05,
              f"warm {name}: the contract failed on the card")
        _same_answer(res[0], res[1], f"warm lane {name}")
        bit += _bits_equal(*res)
        print(f"  warm lane {name}: n={res[0].n.tolist()} iters="
              f"{int(res[0].iterations)} (cold {int(cold.iterations)}) "
              f"card == cpu")
    # A warm lane beside a cold one in a pool == its solo warm run.
    qkeys = keys.split(keys.prng_key(9), 2)
    pool = LanePool(dc, lanes=2, tiers=1, seed=0, sample_key=skey, **KW)
    wn0, wb = cases[0][1], cases[0][2]
    qc = pool.submit(Query("avg", epsilon=0.05), key=qkeys[0])
    qw = pool.submit(Query("avg", epsilon=0.05), key=qkeys[1], warm_n0=wn0,
                     warm_beta=wb)
    out = {r.qid: r for r in pool.drain()}
    _same_lane(out[qw], fused_l2miss(dc.values, dc.offsets, ones, qkeys[1],
                                     0.05, 0.05, sample_key=skey,
                                     warm_n0=wn0, warm_beta=wb, **spec),
               "warm lane")
    _same_lane(out[qc], fused_l2miss(dc.values, dc.offsets, ones, qkeys[0],
                                     0.05, 0.05, sample_key=skey, **spec),
               "cold neighbour of a warm lane")
    # A warm grouped block: card == cpu, and the pool's == fused_grouped.
    G, gkey = 2, keys.prng_key(17)
    gwn0 = np.asarray([2200, 1800])
    gwb = np.asarray([[-1.5, 0.45], [-1.2, 0.5]], np.float32)
    res = [fused_grouped(d.values, d.offsets, np.ones(G), gkey, 0.05, 0.05,
                         sample_key=skey, warm_n0=gwn0, warm_beta=gwb,
                         **spec) for d in (dc, dh)]
    for f in ("n", "iterations", "success", "failed", "rows_sampled"):
        check(np.array_equal(_np(getattr(res[0], f)),
                             _np(getattr(res[1], f))),
              f"warm block: {f} card != cpu")
    check(np.allclose(_np(res[0].theta), _np(res[1].theta), rtol=1e-5,
                      atol=0)
          and np.allclose(_np(res[0].error), _np(res[1].error), rtol=1e-4,
                          atol=0), "warm block: theta or error card != cpu")
    bit += (_np(res[0].theta).tobytes() == _np(res[1].theta).tobytes()
            and _np(res[0].error).tobytes() == _np(res[1].error).tobytes())
    pool = LanePool(dc, lanes=2, seed=0, sample_key=skey, **KW)
    pool.submit_group(Query("avg", epsilon=0.05, group_by=True), key=gkey,
                      warm_n0=gwn0, warm_beta=gwb)
    (blk,) = pool.drain()
    check(blk.warm and np.array_equal(blk.n, _np(res[0].n))
          and blk.error.tobytes() == _np(res[0].error).tobytes()
          and blk.theta.tobytes() == _np(res[0].theta[:, 0]).tobytes(),
          "warm pool block != warm fused_grouped on the card")
    print(f"  warm block: n={res[0].n.tolist()} iters="
          f"{res[0].iterations.tolist()} card == cpu; pool block == "
          f"fused_grouped bit-exact on the card; {bit} of 4 warm runs "
          f"bit-equal card vs cpu in theta and error")
    # Degraded lane == solo at the delivered epsilon.
    eps_req = 0.03
    pool = LanePool(dc, lanes=2, tiers=1, degrade=True, seed=0,
                    sample_key=keys.prng_key(11), **KW)
    cm = pool._slo.cost
    for w in cm.widths:
        cm._tick_s[w] = 1e-5 if w <= 2048 else 1e3
    cm._tick_s_any, cm._ticks = 1e-5, 4.0
    cm._coef["avg"] = eps_req * float(np.sqrt(KW["n_cap"]))
    qid = pool.submit(Query("avg", epsilon=eps_req), key=keys.prng_key(5),
                      deadline_at=time.perf_counter() + 60.0)
    r = next(o for o in pool.drain() if o.qid == qid)
    check(r.degraded and r.success and r.error <= r.delivered_epsilon,
          f"degrade: degraded={r.degraded} success={r.success}")
    _same_lane(r, fused_l2miss(dc.values, dc.offsets, ones,
                               keys.prng_key(5), r.delivered_epsilon, 0.05,
                               sample_key=keys.prng_key(11), **spec),
               "degraded lane")
    print(f"  degraded lane: eps {eps_req} -> {r.delivered_epsilon:.5f}, "
          f"== solo at the delivered epsilon bit-exact on the card")
    # Migration: tests/test_torch_slo.py's scenario, the move asserted.
    mkey = keys.prng_key(21)
    mkeys = [keys.prng_key(31 + i) for i in range(5)]
    pool = LanePool(dc, lanes=4, tiers=2, migrate=True, seed=0,
                    sample_key=mkey, **KW)
    qids = [pool.submit(Query("avg", epsilon=e), key=k)
            for e, k in zip([0.03, 0.12, 0.05, 0.05, 0.05], mkeys)]
    out = {o.qid: o for o in pool.drain()}
    moved = out[qids[0]]
    check(pool.migrations >= 1 and moved.migrations >= 1,
          f"no migration happened ({pool.migrations})")
    for q, e, k in ((qids[0], 0.03, mkeys[0]), (qids[4], 0.05, mkeys[4])):
        _same_lane(out[q], fused_l2miss(dc.values, dc.offsets, ones, k, e,
                                        0.05, sample_key=mkey, **spec),
                   "migrated lane" if q == qids[0] else "its old tier-mate")
    print(f"  migration: {pool.migrations} move(s), the straggler ended in "
          f"tier {moved.tier}; == solo bit-exact on the card")
    # One shed pilot, card vs cpu.
    shed = []
    for d in (dc, dh):
        pool = LanePool(d, lanes=2, tiers=1, degrade=True, seed=0,
                        sample_key=skey, **KW)
        qid = pool.submit(Query("var", epsilon=0.01), key=key,
                          deadline_at=-1.0)
        shed.append(pool.results.pop(qid))
    a, b = shed
    check(a.shed and b.shed and np.array_equal(a.n, b.n)
          and np.allclose(a.theta, b.theta, rtol=1e-4, atol=0)
          and abs(a.error - b.error) <= 2e-3 * abs(b.error)
          and a.error <= a.delivered_epsilon,
          f"shed pilot card {a.error} {a.theta.ravel()} vs cpu {b.error} "
          f"{b.theta.ravel()}")
    print(f"  shed pilot (var, B={a.delivered_B}): error {a.error:.6g} card "
          f"vs {b.error:.6g} cpu, within phase 13's rtol")
    counts = read_counts()
    check(counts["poisson_bootstrap"] > 0 and counts["segment_bootstrap"] > 0,
          f"a bootstrap kernel never launched in phase 15: {counts}")
    print(f"  launches on the card in phase 15: {counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 16: warm and overload serve at real size
# ---------------------------------------------------------------------------

def _record_iterations(sess) -> dict:
    """Record every pool response's iterations (max over groups) by request
    id as the session harvests it: ``SessionResponse`` carries none."""
    seen = {}
    harvest = sess._harvest_pool

    def recording():
        pool = sess._pool
        if pool is not None:
            for qid, r in pool.results.items():
                rid = sess._pool_rids.get(qid)
                if rid is not None:
                    seen[rid] = int(np.max(r.iterations))
        harvest()

    sess._harvest_pool = recording
    return seen


def _wave(sess, reqs, label: str, exact, its: dict, grouped=False):
    """Submit ``reqs`` ((func, epsilon) pairs) at once, drain, and print
    the wave: latency, iterations a lane, rows, dispatches, launches of
    rows 1 and 2, warm verify failures.  Returns the responses, the
    launches, the dispatches and the answers within epsilon of numpy."""
    from repro_torch.aqp.query import Query, Request

    d0, rows0 = sess.fused_dispatches, sess.rows_touched
    its.clear()
    reset_counts()
    t0 = time.perf_counter()
    for f, e in reqs:
        sess.submit(Request(query=Query(func=f, epsilon=e,
                                        group_by=grouped)))
    res = sess.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check(len(res) == len(reqs), f"{label}: {len(res)} of {len(reqs)}")
    lat = np.asarray([r.latency_s for r in res]) * 1e3
    within = 0
    for r, (f, e) in zip(res, reqs):
        err = r.group_error if grouped else np.asarray([r.error])
        check(r.success and bool((err <= e).all()),
              f"{label} {f} eps={e:.4g}: success={r.success} error={err}")
        dev = (np.abs(np.asarray(r.theta, np.float64) - exact[f])
               if grouped else
               [float(np.linalg.norm(r.theta.ravel() - exact[f]))])
        within += int((np.asarray(dev) <= e).sum())
    routes = collections.Counter(r.route.value for r in res)
    it = np.asarray(list(its.values()) or [0])
    pools = sess.stats().get("pool", {})
    print(f"  {label}: wall {wall:.3f} s, latency p50 "
          f"{np.percentile(lat, 50):.2f} ms p99 {np.percentile(lat, 99):.2f} "
          f"ms, routes {dict(routes)}, iterations a lane mean "
          f"{it.mean():.2f} max {it.max()} ({len(its)} pooled), rows "
          f"touched {sess.rows_touched - rows0}, dispatches "
          f"{sess.fused_dispatches - d0}, launches: poisson "
          f"{counts['poisson_bootstrap']} segment "
          f"{counts['segment_bootstrap']}; warm_verify_failures "
          f"{sess.warm_verify_failures}, warm lanes spliced "
          f"{pools.get('warm_spliced', 0)}; {within} answers within epsilon "
          f"of numpy")
    return res, counts, sess.fused_dispatches - d0, within


def phase_warm_serve(data, tax):
    """(a) one warm-cache session on lineitem SF10 GROUP BY SHIPINSTRUCT:
    phase 6's 16 requests cold, again (exact repeats: bit-equal, 0
    dispatches, 0 launches), then at epsilon / 1.1 over the WARM route;
    phase 7's 8 GROUP BY requests on the TAX table cold, then at epsilon /
    1.1 as warm blocks.  Returns the phase's launches."""
    from repro_torch.serve import AQPSession, Planner, Route

    reqs, exact = serve_requests(data)
    sess = AQPSession(data, warm_cache=True,
                      planner=Planner(mode=Route.POOL, pool_lanes=8),
                      **SERVE)
    its = _record_iterations(sess)
    total = {k: 0 for k in _counters()}
    cold, c, _, within = _wave(sess, reqs, "cold wave (16)", exact, its)
    total = add_counts(total, c)
    check(within >= 13, f"cold wave: {within} of 16 within epsilon")
    d_pool = sess._pool.dispatches
    rep, c, d, _ = _wave(sess, reqs, "exact repeats (16)", exact, its)
    total = add_counts(total, c)
    check(d == 0 and sess._pool.dispatches == d_pool
          and not any(c.values()),
          f"exact repeats dispatched {d} times, launches {c}")
    for a, b in zip(cold, rep):
        check(b.route is Route.WARM and b.rows_sampled == 0
              and a.theta.tobytes() == b.theta.tobytes()
              and a.error == b.error and np.array_equal(a.n, b.n),
              "an exact repeat is not the cold answer bit for bit")
    near = [(f, e / 1.1) for f, e in reqs]
    res, c, _, within = _wave(sess, near, "near repeats at eps/1.1 (16)",
                              exact, its)
    total = add_counts(total, c)
    check(all(r.route is Route.WARM for r in res),
          "a near repeat missed the WARM route")
    check(within >= 13, f"near repeats: {within} of 16 within epsilon")
    check(c["poisson_bootstrap"] > 0, "no warm lane launched the kernel")
    greqs, gexact, _ = grouped_requests(tax)
    grouped = [(f, e) for f, e, g in greqs if g]
    gsess = AQPSession(tax, warm_cache=True,
                       planner=Planner(mode=Route.POOL, pool_lanes=8),
                       **SERVE)
    gits = _record_iterations(gsess)
    _, c, _, within = _wave(gsess, grouped, "GROUP BY cold (8)", gexact,
                            gits, True)
    total = add_counts(total, c)
    check(within >= 62, f"GROUP BY cold: {within} of 72 within epsilon")
    gnear = [(f, e / 1.1) for f, e in grouped]
    res, c, _, within = _wave(gsess, gnear, "GROUP BY near repeats as warm "
                              "blocks (8)", gexact, gits, True)
    total = add_counts(total, c)
    check(within >= 62, f"GROUP BY near: {within} of 72 within epsilon")
    check(all(r.route is Route.WARM for r in res)
          and c["segment_bootstrap"] > 0,
          "a warm block missed the WARM route or the segment kernel")
    st = sess.stats()
    print(f"  cache: {st['warm_cache']['exact_hits']} exact hits, "
          f"{st['warm_cache']['warm_hits']} warm hits, "
          f"{st['warm_cache']['entries']} entries; warm_verify_failures "
          f"{st['warm_verify_failures']} solo, "
          f"{gsess.warm_verify_failures} grouped")
    return total


def phase_overload_serve(data):
    """(b) one session with degrade, wfq and migrate on, tenants dash
    (weight 3) and batch (1): 8 priming requests with no deadline, then a
    burst of 32, 16 a tenant, with deadlines at 4x (12), 0.5x (12) and
    0.05x (8) the priming wave's median latency.  The tight 20 are shed at
    submit, each answered there by a pilot on the card before the next
    submit, so the 4x requests pay that time before the last of them can
    take a lane: it is measured first, on the same 20 requests with blown
    deadlines (a third tenant, so the two tenants' fair-queue tags are
    untouched), and added to the 4x deadlines.  Every answer's error <=
    its delivered epsilon, shed answers took no iteration, the 4x requests
    were neither shed nor degraded.  Returns the burst's launches."""
    from repro_torch.aqp.query import Query, Request
    from repro_torch.serve import AQPSession, Planner, Route

    reqs, exact = serve_requests(data)
    sess = AQPSession(
        data, degrade=True, wfq=True, migrate=True,
        tenant_weights={"dash": 3.0, "batch": 1.0},
        planner=Planner(mode=Route.POOL, pool_lanes=8, slo_native=True),
        **SERVE)
    its = _record_iterations(sess)
    prime, _, _, _ = _wave(sess, reqs[:8], "priming wave (8)", exact, its)
    its.clear()
    med = float(np.median([r.latency_s for r in prime]))
    burst = []
    for i in range(32):
        f, e = reqs[i % 16]
        mult = 4.0 if i < 12 else (0.5 if i < 24 else 0.05)
        burst.append((f, e, mult, "dash" if i % 2 else "batch"))
    t0 = time.perf_counter()
    for f, e, mult, _ in burst:
        if mult < 4.0:
            sess.submit(Request(query=Query(func=f, epsilon=e),
                                deadline_s=1e-9, tenant="pilots"))
    pilots = sess.drain()
    pilots_s = time.perf_counter() - t0
    check(len(pilots) == 20 and all(r.shed for r in pilots),
          "the 20 pilot answers were not all shed at submit")
    pool = sess._pool
    shed0, degraded0 = pool.shed, pool.degraded
    reset_counts()
    t0 = time.perf_counter()
    tickets = [sess.submit(Request(
        query=Query(func=f, epsilon=e), tenant=t,
        deadline_s=mult * med + (pilots_s if mult == 4.0 else 0.0)))
        for f, e, mult, t in burst]
    res = {r.rid: r for r in sess.drain()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check(len(res) == 32, f"burst: {len(res)} of 32 answered")
    within, admitted, met = 0, collections.Counter(), collections.Counter()
    for tk, (f, e, mult, t) in zip(tickets, burst):
        r = res[tk.rid]
        check(r.error <= r.delivered_epsilon,
              f"{f} x{mult}: error {r.error} > delivered "
              f"{r.delivered_epsilon}")
        check(not r.shed or its[tk.rid] == 0,
              f"{f} x{mult}: a shed answer took {its[tk.rid]} iterations")
        if mult == 4.0:
            check(not r.shed and not r.degraded,
                  f"{f} x4: shed={r.shed} degraded={r.degraded}")
        within += float(np.linalg.norm(r.theta.ravel() - exact[f])) \
            <= r.delivered_epsilon
        admitted[t] += not r.shed
        met[t] += bool(r.slo_met)
    print(f"  burst of 32 (deadlines 4x/0.5x/0.05x of {med * 1e3:.2f} ms, "
          f"the 4x ones plus {pilots_s * 1e3:.2f} ms for the 20 pilot "
          f"answers): wall {wall:.3f} s, shed {pool.shed - shed0}, degraded "
          f"{pool.degraded - degraded0}, "
          f"migrations {pool.migrations}; slo_met dash "
          f"{met['dash']}/16 batch {met['batch']}/16; admitted to a lane "
          f"dash {admitted['dash']} batch {admitted['batch']}; "
          f"{within}/32 within their delivered epsilon of numpy; launches "
          f"{counts}")
    check(within >= 24, f"only {within} of 32 burst answers within their "
                        f"delivered epsilon of the exact answer")
    check(counts["poisson_bootstrap"] > 0, "the burst never launched row 1")
    return counts


# ---------------------------------------------------------------------------
# phase 17: the sharded path, the card against the CPU
# ---------------------------------------------------------------------------

SHARD_KW = dict(B=60, n_min=100, n_max=256, max_iters=8, n_cap=1 << 12)
SHARD_SOLO = [(2, "avg", 0.08, 3), (2, "std", 0.08, 5), (4, "avg", 0.06, 5),
              (4, "var", 0.15, 3), (4, "std", 0.08, 3)]
SHARD_POOL = [("avg", 0.25), ("var", 0.3), ("avg", 0.08), ("std", 0.08),
              ("avg", 0.06), ("var", 0.15)]
MESH_RANKS = 4


def _shard_table(device):
    """tests/test_torch_shard.py's table: 2 groups of 12 000 rows."""
    from repro_torch.data import make_grouped
    return make_grouped(["normal", "exp"], 12_000, seed=3, biases=[4.0, 2.0],
                        device=device)


def _shard_pool(d, mesh):
    """The 4-shard pool of phase 17 (4 lanes in 2 tiers, so the queue
    refills mid-drain): its responses in submit order, the pool and the
    query keys."""
    from repro_torch.aqp.query import Query
    from repro_torch.core import keys
    from repro_torch.serve import LanePool

    pool = LanePool(d, lanes=4, tiers=2, data_shards=MESH_RANKS, mesh=mesh,
                    seed=0, sample_key=keys.prng_key(9), **SHARD_KW)
    qkeys = keys.split(keys.prng_key(4), len(SHARD_POOL))
    qids = [pool.submit(Query(func=f, epsilon=e), key=qkeys[i])
            for i, (f, e) in enumerate(SHARD_POOL)]
    out = {r.qid: r for r in pool.drain()}
    return [out[q] for q in qids], pool, qkeys


def _answers(rs) -> dict:
    return {"n": np.stack([np.ravel(r.n) for r in rs]),
            "it": np.asarray([r.iterations for r in rs]),
            "err": np.asarray([r.error for r in rs], np.float32),
            "theta": np.stack([np.ravel(r.theta) for r in rs]
                              ).astype(np.float32)}


def mesh_rank_main(argv) -> None:
    """One rank of phase 17's mesh: a gloo group of ``MESH_RANKS`` processes
    sharing the card drains :func:`_shard_pool` and writes its answers,
    collectives and launches to an ``.npz``."""
    import torch.distributed as dist
    from repro_torch.core.mesh import make_data_mesh

    rank, world, store, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    mesh = make_data_mesh(world, device="cuda")
    d = _shard_table("cuda")
    reset_counts()
    rs, pool, _ = _shard_pool(d, mesh)
    torch.cuda.synchronize()
    np.savez(out, **_answers(rs), gathers=mesh.gathers,
             ticks=pool.dispatches * pool.ticks_per_sync,
             launches=read_counts()["poisson_bootstrap"],
             shard_rows=np.asarray(pool.stats()["shard_rows"]))
    dist.barrier()
    dist.destroy_process_group()


def _run_mesh_ranks(tmp: Path) -> list:
    """Launch the ranks (this script with ``--mesh-rank``), all sharing the
    card; every process is stopped before this returns."""
    import os

    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mesh-rank",
         str(r), str(MESH_RANKS), str(tmp / "store"), str(tmp / f"r{r}.npz")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(MESH_RANKS)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=300)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        check(p.returncode == 0, f"mesh rank {r} failed: {errs[r][-3000:]}")
    return [dict(np.load(tmp / f"r{r}.npz")) for r in range(MESH_RANKS)]


def phase_sharded_vs_cpu():
    """The sharded layout's tables, solo sharded ``fused_l2miss`` at S = 2
    and 4, and a ``mesh=False`` pool at S = 4 card == CPU (integers exact,
    theta and error bit-equal); a pool lane == its solo run on the card;
    ``sharded_group_stats`` (row 3) card vs CPU; every row-1 call replayed
    through the plain version on the card bit for bit; 4 gloo ranks sharing
    the card drain the pool bit-equal to ``mesh=False``, one collective a
    tick.  Returns the launches of the card's runs (the ranks' apart)."""
    import tempfile

    from repro_torch.aqp import distributed as D
    from repro_torch.core import keys
    from repro_torch.core.fused import fused_l2miss
    from repro_torch.core.sampling import ShardLayout, sharded_slot_tables
    from repro_torch.kernels.poisson_bootstrap import ops, ref

    dc, dh = _shard_table("cuda"), _shard_table("cpu")
    skey = keys.prng_key(9)
    for S in (2, 4):
        lay = ShardLayout.build(dc.offsets, n_cap=SHARD_KW["n_cap"],
                                num_shards=S)
        for local in (True, False):
            tc, th = (sharded_slot_tables(skey, lay, local_rows=local,
                                          device=dev) for dev in ("cuda",
                                                                  "cpu"))
            check(torch.equal(tc.cpu(), th),
                  f"sharded slot tables card != cpu (S={S}, local={local})")
    print("  sharded slot tables (S = 2, 4; local and global rows): card == "
          "cpu")
    calls = []
    launch = ops.bootstrap_moments_masked

    def recording(x, mask, seeds, B_, *, lane_active=None):
        out = launch(x, mask, seeds, B_, lane_active=lane_active)
        calls.append((x.clone(), mask.clone(), seeds.clone(), B_,
                      None if lane_active is None else lane_active.clone(),
                      out.clone()))
        return out

    ops.bootstrap_moments_masked = recording
    reset_counts()
    try:
        for S, est, eps, k in SHARD_SOLO:
            res = [fused_l2miss(d.values, d.offsets, np.ones(2, np.float32),
                                keys.prng_key(k), eps, 0.05, sample_key=skey,
                                est_name=est, data_shards=S, l=4, **SHARD_KW)
                   for d in (dc, dh)]
            _same_answer(res[0], res[1], f"sharded fused_l2miss S={S} {est}")
            check(_bits_equal(*res), f"sharded fused_l2miss S={S} {est}: "
                                     f"theta or error card != cpu")
            print(f"  sharded fused_l2miss S={S} {est} eps={eps}: n="
                  f"{res[0].n.tolist()} iters={int(res[0].iterations)} "
                  f"success={bool(res[0].success)}; card == cpu bit-exact")
        card, pool, qkeys = _shard_pool(dc, False)
        cpu, _, _ = _shard_pool(dh, False)
        for a, b in zip(card, cpu):
            check(np.array_equal(a.n, b.n) and a.iterations == b.iterations
                  and a.success == b.success
                  and a.rows_sampled == b.rows_sampled
                  and a.theta.tobytes() == b.theta.tobytes()
                  and np.float32(a.error) == np.float32(b.error),
                  f"sharded pool {a.func}: card != cpu")
        for (f, e), k, r in zip(SHARD_POOL, qkeys, card):
            solo = fused_l2miss(dc.values, dc.offsets, np.ones(2, np.float32),
                                k, e, 0.05, sample_key=skey, est_name=f,
                                data_shards=MESH_RANKS, l=pool._spec["l"],
                                **SHARD_KW)
            _same_lane(r, solo, f"sharded pool {f} eps={e}")
        st = pool.stats()
        print(f"  mesh=False pool S=4: {len(card)} answers card == cpu "
              f"bit-exact, each == its solo sharded run on the card; "
              f"ticks {st['ticks']}, shard rows {st['shard_rows']}")
    finally:
        ops.bootstrap_moments_masked = launch
    rng = np.random.default_rng(0)
    gid = rng.integers(0, 4, 40_000)
    x = rng.standard_normal(40_000).astype(np.float32) + gid
    gs = [D.sharded_group_stats(None, *D.shard_dataset(None, gid, x,
                                                       device=dev), 4)
          for dev in ("cuda", "cpu")]
    for k in ("count", "min", "max"):
        check(torch.equal(gs[0][k].cpu(), gs[1][k]),
              f"sharded_group_stats {k} card != cpu")
    for k in ("sum", "sumsq"):
        check(np.allclose(_np(gs[0][k]), _np(gs[1][k]), rtol=1e-6, atol=0),
              f"sharded_group_stats {k} card != cpu")
    stats_bits = all(torch.equal(gs[0][k].cpu(), gs[1][k]) for k in gs[1])
    counts = read_counts()
    bad = 0
    for x_, m_, s_, B_, act, out in calls:
        plain = ref.bootstrap_moments_masked_ref(x_, m_, s_, B_,
                                                 lane_active=act)
        bad += not torch.equal(plain, out)
    check(bad == 0, f"{bad} of {len(calls)} row-1 calls differ from the "
                    f"plain version on the card")
    print(f"  sharded_group_stats (row 3): card == cpu (bit-equal: "
          f"{stats_bits}); {len(calls)} row-1 calls replayed through the "
          f"plain version on the card, bit-exact")
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        ranks = _run_mesh_ranks(Path(tmp))
        wall = time.perf_counter() - t
    ref_ans = _answers(card)
    for r, got in enumerate(ranks):
        for f in ("n", "it", "err", "theta"):
            check(got[f].tobytes() == ref_ans[f].tobytes(),
                  f"mesh rank {r}: {f} != the mesh=False pool on the card")
        check(int(got["gathers"]) == int(got["ticks"]) > 0,
              f"mesh rank {r}: {int(got['gathers'])} collectives for "
              f"{int(got['ticks'])} ticks")
        check(int(got["launches"]) > 0, f"mesh rank {r} never launched row 1")
        check(got["shard_rows"].tolist() == st["shard_rows"],
              f"mesh rank {r}: shard rows {got['shard_rows']}")
    print(f"  mesh: {MESH_RANKS} gloo ranks sharing the card drain the pool "
          f"bit-equal to mesh=False; {int(ranks[0]['gathers'])} collectives "
          f"for {int(ranks[0]['ticks'])} ticks; row-1 launches a rank "
          f"{[int(r['launches']) for r in ranks]}; {wall:.1f} s with start-up")
    check(counts["poisson_bootstrap"] > 0 and counts["segment_aggregate"] > 0,
          f"row 1 or row 3 never launched in phase 17: {counts}")
    print(f"  launches on the card in phase 17: {counts}")
    return counts, int(ranks[0]["launches"])


# ---------------------------------------------------------------------------
# phase 18: sharded serve at real size
# ---------------------------------------------------------------------------

def phase_sharded_serve(data, tax, p50_solo: float):
    """Phase 6's 16 requests through ``AQPSession(data_shards=4,
    mesh=False)``, forced POOL, on lineitem SF10 GROUP BY SHIPINSTRUCT, then
    2 of phase 7's GROUP BY requests on the TAX table, which a sharded
    session sends to the HOST route.  Returns the launches."""
    from repro_torch.aqp.query import Query, Request
    from repro_torch.serve import AQPSession, Planner, Route

    reqs, exact = serve_requests(data)
    sess = AQPSession(data, data_shards=4, mesh=False,
                      planner=Planner(mode=Route.POOL, pool_lanes=8,
                                      data_shards=4), **SERVE)
    check(sess.use_kernel, "the session did not select the CUDA kernel")
    reset_counts()
    t0 = time.perf_counter()
    for f, e in reqs:
        sess.submit(Request(query=Query(func=f, epsilon=e)))
    res = sess.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pool_counts = read_counts()
    check(len(res) == 16, f"{len(res)} of 16 requests answered")
    within = 0
    for r, (f, e) in zip(res, reqs):
        check(r.route is Route.POOL, f"request on route {r.route}")
        check(r.success and r.error <= e,
              f"sharded {f} eps={e:.4g}: success={r.success} "
              f"error={r.error:.4g}")
        dev = float(np.linalg.norm(r.theta.ravel() - exact[f]))
        within += dev <= e
        print(f"  {f:4s} eps={e:12.4f} error={r.error:12.4f} "
              f"|theta-exact|={dev:12.4f} n={r.n.tolist()} "
              f"latency={r.latency_s * 1e3:8.2f} ms")
    lat = np.asarray([r.latency_s for r in res]) * 1e3
    st = sess.stats()
    pst = st["pool"]
    print(f"  sharded serve (S=4, mesh=False): wall {wall:.3f} s, latency "
          f"p50 {np.percentile(lat, 50):.2f} ms p99 "
          f"{np.percentile(lat, 99):.2f} ms (phase 6 p50 {p50_solo:.2f} ms), "
          f"pool rounds {pst['ticks']}, dispatches {st['fused_dispatches']}, "
          f"shard rows {pst['shard_rows']}, rows touched "
          f"{st['rows_touched']}, {within}/16 within epsilon of numpy; "
          f"launches {pool_counts}")
    check(within >= 14, f"only {within} of 16 answers within epsilon")
    check(pool_counts["poisson_bootstrap"] > 0,
          "the sharded serve never launched row 1")
    greqs, gexact, _ = grouped_requests(tax)
    grouped = [r[:2] for r in greqs if r[2]][:2]
    gsess = AQPSession(tax, data_shards=4, mesh=False, **SERVE)
    reset_counts()
    t0 = time.perf_counter()
    for f, e in grouped:
        gsess.submit(Request(query=Query(func=f, epsilon=e, group_by=True)))
    gres = gsess.drain()
    torch.cuda.synchronize()
    gwall = time.perf_counter() - t0
    host_counts = read_counts()
    gwithin = 0
    for r, (f, e) in zip(gres, grouped):
        check(r.route is Route.HOST and r.group_by,
              f"sharded GROUP BY on route {r.route}")
        check(r.success and bool((r.group_error <= e).all()),
              f"sharded GROUP BY {f} eps={e:.4g}: errors {r.group_error}")
        gwithin += int((np.abs(np.asarray(r.theta, np.float64) - gexact[f])
                        <= e).sum())
    print(f"  GROUP BY TAX on the sharded session: {len(gres)} requests on "
          f"the HOST route, wall {gwall:.3f} s, {gwithin}/"
          f"{9 * len(gres)} per-group answers within epsilon of numpy; "
          f"launches {host_counts}")
    check(host_counts["segment_bootstrap"] > 0,
          "the sharded session's GROUP BY never launched row 2")
    return add_counts(pool_counts, host_counts)


# ---------------------------------------------------------------------------
# phase 19: the baselines at real size (paper Figures 3 and 4)
# ---------------------------------------------------------------------------

BASE_CFG = dict(delta=0.05, B=200, n_min=1000, n_max=2000, max_iters=60,
                seed=0)          # benchmarks/bench_efficiency.py's L2Miss


def _l2(theta, exact) -> float:
    return float(np.linalg.norm(np.ravel(theta) - np.ravel(exact)))


def _copy(a):
    if isinstance(a, torch.Tensor):
        return a.clone()
    if isinstance(a, dict):
        return {k: _copy(v) for k, v in a.items()}
    return a


def record_calls(module, name: str):
    """Route ``module.name`` through a recorder that keeps device copies of
    each call's arguments and result (no sync), for :func:`hold_recorded`;
    the wrapper itself still counts each launch.  Returns the list of calls
    and the function that puts the wrapper back."""
    launch, calls = getattr(module, name), []

    def recorder(*args, **kw):
        out = launch(*args, **kw)
        calls.append((_copy(args), _copy(kw), _copy(out)))
        return out

    setattr(module, name, recorder)
    return calls, lambda: setattr(module, name, launch)


def _pb_same(got, want) -> float:
    check(torch.equal(got, want), "Poisson bootstrap != plain")
    return 0.0


def _agg_same(got, want) -> float:
    """Phase 4's tolerance: sums at rtol 1e-5, min and max exact."""
    from repro_torch.kernels.segment_agg import ref

    for k in ref.AGG_KEYS:
        check(torch.allclose(got[k], want[k], rtol=1e-5, atol=0.0),
              f"segment aggregate != plain on {k}")
    for k in ("min", "max"):
        check(torch.equal(got[k], want[k]), f"segment aggregate != plain on "
                                            f"{k}")
    return max(float((got[k] - want[k]).abs().max()) for k in want)


def hold_recorded(name: str, calls, key, plain, same) -> float:
    """One recorded call of each ``key`` (a shape) through the plain version,
    held to the kernel's recorded result by ``same``; returns the largest
    abs error."""
    first = {}
    for c in calls:
        first.setdefault(key(c), c)
    err = 0.0
    for args, kw, out in first.values():
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        err = max(err, same(out, want))
    print(f"  {name}: {len(calls)} calls recorded, one of each of the "
          f"{len(first)} shapes {sorted(first)} held against the plain "
          f"version (max abs err {err:.3g})")
    return err


def _pb_key(c):
    args, kw, _ = c
    return tuple(args[0].shape), args[3]


def hold_pb(name: str, calls) -> float:
    from repro_torch.kernels.poisson_bootstrap import ref

    return hold_recorded(f"Poisson bootstrap, {name}", calls, _pb_key,
                         ref.bootstrap_moments_masked_ref, _pb_same)


def phase_baselines(data):
    """Fig. 3 on phase 6's table (GROUP BY SHIPINSTRUCT, avg at epsilon = 1 %
    of the exact answers' L2 norm, delta 0.05): L2Miss through the moments
    entry, BLK, SPS at epsilon_rel 1 % and MiniBatch (step 2000, B 200),
    scored against ``AQPEngine.exact``; Fig. 4 on lineitem SF10 GROUP BY
    LINESTATUS with a 5 % group bias: OrderMiss against IFocus.  Every
    Poisson-bootstrap and segment-aggregate call is recorded, and one of
    each shape is held against its plain version after the counts are read.
    Returns every kernel's launches in the phase and the largest abs error
    of those replays."""
    from repro_torch.aqp import AQPEngine, Query
    from repro_torch.core import baselines as bl
    from repro_torch.core.extensions import run_ordermiss
    from repro_torch.core.l2miss import MissConfig, run_l2miss
    from repro_torch.data import add_group_bias
    from repro_torch.kernels.poisson_bootstrap import ops as pb_ops
    from repro_torch.kernels.segment_agg import ops as seg_ops
    from repro_torch.kernels.segment_agg import ref as seg_ref

    pb_calls, pb_stop = record_calls(pb_ops, "bootstrap_moments_masked")
    agg_calls, agg_stop = record_calls(seg_ops, "segment_aggregate")
    reset_counts()
    t0 = time.perf_counter()
    exact = AQPEngine(data).exact(Query(func="avg", epsilon=1.0))[:, 0]
    eps = 0.01 * float(np.linalg.norm(exact))
    rows = {}

    def run(name, fn):
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        theta = res.theta if res.theta is not None else np.zeros_like(exact)
        rows[name] = dict(success=bool(res.success),
                          rows=int(res.total_sampled),
                          iterations=int(res.iterations), wall_s=wall,
                          l2_err=_l2(theta, exact),
                          n=np.asarray(res.n).tolist())
        r = rows[name]
        print(f"  fig3 {name:9s} success={r['success']} rows touched "
              f"{r['rows']:>10d} iterations {r['iterations']:>3d} wall "
              f"{wall:8.3f} s  L2 error vs exact {r['l2_err']:10.3f} "
              f"(eps {eps:.3f})  n={r['n']}")
        return res

    run("L2Miss", lambda: run_l2miss(data, "avg", MissConfig(epsilon=eps,
                                                             **BASE_CFG)))
    run("BLK", lambda: bl.run_blk(data, "avg", eps, 0.05))
    run("SPS", lambda: bl.run_sps(data, "avg", 0.01, 0.05))
    run("MiniBatch", lambda: bl.run_minibatch(data, "avg", eps, 0.05,
                                              step=2000, B=200))
    check(rows["L2Miss"]["success"] and rows["L2Miss"]["l2_err"] <= 2 * eps,
          f"L2Miss: {rows['L2Miss']}")
    check(rows["BLK"]["success"] and rows["BLK"]["l2_err"] <= 2 * eps,
          f"BLK: {rows['BLK']}")
    check(rows["SPS"]["rows"] >= data.values.shape[0],
          f"SPS touched {rows['SPS']['rows']} rows, less than its full scan")
    check(rows["L2Miss"]["rows"] < rows["SPS"]["rows"],
          "L2Miss touched no fewer rows than SPS")
    ls, _ = _lineitem("linestatus")
    biased = add_group_bias(ls, 0.05)
    del ls
    truth = AQPEngine(biased).exact(Query(func="avg", epsilon=1.0))[:, 0]
    t = time.perf_counter()
    om = run_ordermiss(biased, "avg", MissConfig(epsilon=0.0, **BASE_CFG))
    torch.cuda.synchronize()
    om_s = time.perf_counter() - t
    t = time.perf_counter()
    ifo = bl.run_ifocus(biased, "avg", 0.05)
    if_s = time.perf_counter() - t
    check(om.success, f"OrderMiss failed: {om.status}")
    check(ifo.success and np.array_equal(np.argsort(ifo.theta[:, 0]),
                                         np.argsort(truth)),
          f"IFocus order {ifo.theta[:, 0]} vs exact {truth}")
    check(np.array_equal(np.argsort(om.theta[:, 0]), np.argsort(truth)),
          f"OrderMiss order {om.theta[:, 0]} vs exact {truth}")
    print(f"  fig4 (LINESTATUS, bias 5 %, exact {truth.round(2).tolist()}): "
          f"OrderMiss n={np.asarray(om.n).tolist()} (sum "
          f"{int(np.sum(om.n))}, rows touched {om.total_sampled}, "
          f"{om.iterations} iterations, {om_s:.3f} s); IFocus n="
          f"{ifo.n.tolist()} (sum {int(np.sum(ifo.n))}, rows touched "
          f"{ifo.total_sampled}, {ifo.iterations} rounds, {if_s:.3f} s); "
          f"both order the groups as the exact answers")
    del biased
    counts = read_counts()
    pb_stop()
    agg_stop()
    check(counts["poisson_bootstrap"] > 0 and counts["segment_aggregate"] > 0,
          f"a kernel of the baselines' path never launched: {counts}")
    print(f"  phase 19 wall {time.perf_counter() - t0:.1f} s; launches "
          f"{counts}")
    errs = {"poisson_bootstrap": hold_pb("phase 19", pb_calls),
            "segment_aggregate": hold_recorded(
                "segment aggregate, phase 19", agg_calls,
                lambda c: (tuple(c[0][1].shape), c[0][3]),
                seg_ref.segment_aggregate_ref, _agg_same)}
    return counts, errs


# ---------------------------------------------------------------------------
# phase 20: MISS for the LM at full width
# ---------------------------------------------------------------------------

EVAL_ARCH = "qwen3-1.7b"
EVAL_DOMAINS, EVAL_PER, EVAL_SEQ = 3, 512, 64
EVAL_PILOT = 64
MIX_DOCS = 4_000_000
ROUTER_P = np.asarray([0.3, 0.2, 0.15, 0.1, 0.1, 0.05, 0.05, 0.05])


def _per_example_loss(cfg, params):
    """tests/test_aqp_serve_integration.py's per-example loss: the mean
    over positions of logsumexp - gold, in f32 over train_logits."""
    from repro_torch.models import model as M

    def loss(tokens):
        logits, _ = M.train_logits(cfg, params, {"tokens": tokens[:, :-1]})
        lf = logits.float()
        gold = torch.gather(lf, -1, tokens[:, 1:, None].long())[..., 0]
        return torch.mean(torch.logsumexp(lf, -1) - gold, -1)
    return loss


def phase_miss_lm():
    """``MissEvaluator`` certifying Qwen3-1.7B's (bf16, seeded weights)
    per-domain eval loss on the pipeline's ``eval_domains``, then the full
    eval; ``mixture_statistics`` on 3 lognormal domains of 4 M documents;
    ``estimate_router_load`` with the reference test's synthetic router.
    Every Poisson-bootstrap call is recorded, and one of each shape is held
    against its plain version after the counts are read.  Returns every
    kernel's launches in the phase and the largest abs error of those
    replays."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import eval_domains
    from repro_torch.integration import (estimate_router_load,
                                         mixture_statistics)
    from repro_torch.integration.miss_eval import (MissEvalConfig,
                                                   MissEvaluator)
    from repro_torch.kernels.poisson_bootstrap import ops as pb_ops
    from repro_torch.models import model as M

    cfg = get_config(EVAL_ARCH)
    t = time.perf_counter()
    params = M.init_model(cfg, seed=3, device="cuda")
    domains = eval_domains(cfg.vocab_size, n_domains=EVAL_DOMAINS,
                           n_per=EVAL_PER, seq_len=EVAL_SEQ, device="cuda")
    loss = _per_example_loss(cfg, params)
    with torch.no_grad():
        pilot = [loss(d[:EVAL_PILOT]).cpu().numpy() for d in domains]
    sigma = float(np.sqrt(np.mean([np.var(p, ddof=1) for p in pilot])))
    eps = 2.0 * sigma * np.sqrt(EVAL_DOMAINS / 256.0)
    print(f"  {EVAL_ARCH} bf16 ({M.count_params(params) / 1e9:.3f} B "
          f"params, QK norm) and eval_domains({cfg.vocab_size}, "
          f"{EVAL_DOMAINS} x {EVAL_PER} x {EVAL_SEQ}) built in "
          f"{time.perf_counter() - t:.1f} s; pilot of {EVAL_PILOT} losses a "
          f"domain: means {[round(float(p.mean()), 4) for p in pilot]}, "
          f"pooled std {sigma:.5f} -> eps = 2 sigma sqrt({EVAL_DOMAINS}/256)"
          f" = {eps:.5f} (sizes near 256 a domain: between n_max 64 and "
          f"{EVAL_PER})")
    calls, stop = record_calls(pb_ops, "bootstrap_moments_masked")
    reset_counts()
    t0 = time.perf_counter()
    ev = MissEvaluator(loss, domains, MissEvalConfig(
        epsilon=eps, delta=0.1, B=200, n_min=32, n_max=64))
    tr = ev.certify()
    torch.cuda.synchronize()
    miss_s = time.perf_counter() - t0
    t = time.perf_counter()
    with torch.no_grad():
        full = np.asarray([float(torch.cat([
            loss(d[i:i + 32]) for i in range(0, len(d), 32)]).mean())
            for d in domains])
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t
    gap = _l2(tr.theta, full)
    fw, total = tr.info["model_forwards"], tr.info["full_eval_forwards"]
    print(f"  MissEvaluator: success={tr.success} n={np.asarray(tr.n)} "
          f"after {tr.iterations} iterations, error {tr.error:.5f} (eps "
          f"{eps:.5f}), model forwards {fw} of {total}; wall {miss_s:.3f} s"
          f" (full eval {full_s:.3f} s); |theta - full eval|_2 = {gap:.5f}")
    check(tr.success, f"MissEvaluator failed: {tr.status}")
    check(fw < total, f"{fw} model forwards, no fewer than the full eval")
    check(gap <= 2 * eps, f"certified loss {gap} from the full eval's")
    del params, domains
    torch.cuda.empty_cache()
    rng = np.random.default_rng(2)
    docs = [rng.lognormal(5.0 + 0.3 * d, 0.4, MIX_DOCS) for d in range(3)]
    t = time.perf_counter()
    mix = mixture_statistics(docs, epsilon_rel=0.01, delta=0.1,
                             device="cuda")
    mix_s = time.perf_counter() - t
    truth = np.asarray([d.mean() for d in docs])
    check(np.allclose(mix["mean_len"], truth, rtol=0.06),
          f"mixture means {mix['mean_len']} vs {truth}")
    check(mix["docs_scanned"] < mix["docs_total"],
          f"mixture scanned {mix['docs_scanned']} of {mix['docs_total']}")
    check(abs(float(mix["weights"].sum()) - 1.0) <= 1e-6,
          "mixture weights do not sum to 1")
    print(f"  mixture_statistics (3 x {MIX_DOCS} documents, eps_rel 1 %): "
          f"mean_len {np.round(mix['mean_len'], 3).tolist()} vs numpy "
          f"{np.round(truth, 3).tolist()}, weights "
          f"{np.round(mix['weights'], 5).tolist()}, {mix['trace'].iterations}"
          f" iterations, docs scanned {mix['docs_scanned']} of "
          f"{mix['docs_total']}, {mix_s:.3f} s")
    del docs
    rr = np.random.default_rng(3)

    def route_fn(tokens):
        return rr.choice(len(ROUTER_P), size=tokens.shape[0] * tokens.shape[1],
                         p=ROUTER_P)

    def token_source(n):
        return rr.integers(0, 100, (n, 8)).astype(np.int32)

    t = time.perf_counter()
    rl = estimate_router_load(route_fn, token_source, len(ROUTER_P),
                              epsilon=0.01, delta=0.1, device="cuda")
    rl_s = time.perf_counter() - t
    rgap = float(np.linalg.norm(rl.load - ROUTER_P))
    check(rl.success and rgap <= 0.02,
          f"router load {rl.load} (|load - p| {rgap}, success {rl.success})")
    print(f"  estimate_router_load (E = 8, eps 0.01): {rl.n_tokens} token "
          f"rows, {rl.iterations} iterations, error {rl.error:.5f}, "
          f"|load - p|_2 = {rgap:.5f}, {rl_s:.3f} s")
    counts = read_counts()
    stop()
    check(counts["poisson_bootstrap"] > 0,
          f"mixture_statistics never launched the Poisson kernel: {counts}")
    print(f"  launches in phase 20: {counts}")
    return counts, hold_pb("phase 20", calls)


# ---------------------------------------------------------------------------
# phase 21: the dense variants (sliding window, QK norm, untied head)
# ---------------------------------------------------------------------------

H2O_ARCH, H2O_WINDOW = "h2o-danube-3-4b", 4096
H2O_DECODE = (8, 32, 8, 120, 8192)          # B, Hq, Hkv, d, S (serve shape)
H2O_EDGE_LENS = [H2O_WINDOW - 1, H2O_WINDOW, H2O_WINDOW + 1, 1, 5000, 8192,
                 6000, 4200]
# Prompts whose decode crosses the window: every one longer than W - 32.
H2O_PROMPT = (4100, 6000)
H2O_F32_PROMPT, H2O_F32_STEPS = 4200, 16
CR_ARCH, CR_LAYERS = "command-r-plus-104b", 4
CR_PROMPTS, CR_PROMPT_LEN, CR_NEW, CR_S_MAX = 8, 16, 16, 64
CR_DECODE = (CR_PROMPTS, 96, 8, 128, CR_S_MAX)   # G = 12 query heads a KV head
# The lengths the serve's decode steps pass: prompt + 1 .. prompt + new.
CR_DECODE_LENS = list(range(CR_PROMPT_LEN + 1, CR_PROMPT_LEN + CR_NEW + 1, 2))
CR_EDGE_LENS = [0, 1, 16, 17, 32, 63, 64, 65]


def phase_window_kernel():
    """Row 4 with the window against its plain version at h2o-danube's
    decode shape (d = 120, window 4096, S_max 8192) on rotating caches in
    the serve's range, at the edge lengths (window - 1, window, window + 1
    among them) at d = 120 and 128, and at one int length; Command R+'s
    decode shape (12 query heads a KV head) at its serve's lengths and at
    the edge lengths, without a window; then the windowed kernel timed from
    a CUDA graph against the byte bound over the windows' rows, the plain
    version and SDPA with the window mask.  Returns the row of the result
    line."""
    W = H2O_WINDOW
    B, Hq, Hkv, d, S = H2O_DECODE
    sets = decode_sets("serve", seed=21, shape=H2O_DECODE, prompt=H2O_PROMPT,
                       window=W)
    max_err = _decode_checks(sets, W)
    d128 = (B, Hq, Hkv, 128, S)
    max_err = max(max_err, _check_cases(
        [("edge lengths", H2O_DECODE, H2O_EDGE_LENS),
         ("edge lengths", d128, H2O_EDGE_LENS),
         ("one int length", H2O_DECODE, W + 1),
         ("one int length", d128, W + 1)], W, seed=5))
    cr_err = _check_cases(
        [("Command R+ serve lengths", CR_DECODE, CR_DECODE_LENS),
         ("Command R+ edge lengths", CR_DECODE, CR_EDGE_LENS),
         ("Command R+ one int length", CR_DECODE, CR_DECODE[4])], seed=6)
    row = decode_timing("h2o", sets, W)
    del sets
    torch.cuda.empty_cache()
    return dict(row, max_abs_err=max(max_err, cr_err), cr_max_abs_err=cr_err,
                shape=list(H2O_DECODE), window=W)


def f32_decode_vs_teacher_forcing(cfg, params, prompt: int, steps: int,
                                  label: str, extra=None) -> float:
    """Prefill of ``prompt`` random tokens (with the ``extra`` batch
    entries: a cross-attention memory), then ``steps`` greedy
    ``decode_step``s, against one ``train_logits`` over the whole sequence:
    every step's logits at phase 11's tolerance, argmax equal where the
    top-2 margin exceeds it; row 4 launched :func:`row4_per_step` times a
    step.  Returns the largest abs error."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.models import model as M

    extra = extra or {}
    seq = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, prompt)), device="cuda")
    n0 = da_ops.counter.launches
    last, raw, _ = M.prefill(cfg, params, {"tokens": seq, **extra})
    caches = M.caches_from_prefill(cfg, raw, S_max=prompt + steps + 8)
    del raw
    outs = [last[:, 0]]
    for _ in range(steps):
        nxt = last[:, -1].argmax(-1)[:, None]
        seq = torch.cat([seq, nxt], dim=1)
        last, caches = M.decode_step(cfg, params, nxt, caches)
        outs.append(last[:, 0])
    launched = da_ops.counter.launches - n0
    del caches
    full, _ = M.train_logits(cfg, params, {"tokens": seq, **extra})
    want = full[0, prompt - 1:]
    got = torch.cat(outs)
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, **LM_TOL),
          f"{label} f32 decode != teacher forcing (max abs err {err})")
    top2 = torch.topk(want, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > LM_TOL["atol"]
    check(torch.equal(got.argmax(-1)[clear], want.argmax(-1)[clear]),
          f"{label} f32 argmax differs")
    check(launched == row4_per_step(cfg) * steps,
          f"{label}: {launched} decode-attention launches")
    print(f"  prefill({prompt}) + {steps} greedy steps vs train_logits over "
          f"{seq.shape[1]} tokens: max abs err {err:.3g} (rtol/atol 2e-4), "
          f"argmax equal on {int(clear.sum())} of {len(clear)} clear rows; "
          f"{launched} decode-attention launches")
    return err


def _build_f32(cfg, seed: int = 1):
    """``cfg``'s model in f32 on the card (TF32 off), with a line on its
    size."""
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    params = M.init_model(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    print(f"  {cfg.name} f32: {M.count_params(params) / 1e9:.3f} B params"
          f"{'' if cfg.tie_embeddings else ' (untied head)'}, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, built "
          f"in {time.perf_counter() - t:.1f} s")
    return params


def phase_h2o_f32():
    """h2o-danube-3-4b in f32 at full width and depth: 16 greedy steps
    past a 4 200-token prompt (past the window) against teacher forcing's
    logits under the window mask."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(H2O_ARCH), dtype="float32")
    params = _build_f32(cfg)
    f32_decode_vs_teacher_forcing(cfg, params, H2O_F32_PROMPT,
                                  H2O_F32_STEPS, H2O_ARCH)
    del params
    torch.cuda.empty_cache()


def phase_dense_variants():
    """(a) row 4 with the window; (b) card == CPU for the three reduced
    archs; (c) h2o-danube f32 against teacher forcing; (d) the h2o-danube
    bf16 serve (16 prompts of 4 100-6 000 tokens, 8 slots, S_max 8192);
    (e) Qwen3-1.7B bf16 at phase 12's serve shape; (f) command-r-plus-104b
    at full width cut to 4 of its 64 layers, 8 requests of 16 tokens.
    Returns the windowed kernel's row and the launches of (d)-(f)."""
    from repro_torch.configs import get_config

    print("  (a) windowed decode attention vs plain at h2o-danube's shape")
    row = phase_window_kernel()
    print("  (b) reduced archs, card vs cpu (h2o window cut to 16)")
    for arch, window in (("qwen3-1.7b", None), (H2O_ARCH, 16),
                         (CR_ARCH, None)):
        phase_lm_card_vs_cpu(arch, window)
    print(f"  (c) {H2O_ARCH} f32 at full width and depth")
    phase_h2o_f32()
    print(f"  (d) {H2O_ARCH} bf16 serve, window {H2O_WINDOW}")
    rng = np.random.default_rng(4)
    lens = rng.integers(H2O_PROMPT[0], H2O_PROMPT[1] + 1, LM_REQUESTS)
    vocab = get_config(H2O_ARCH).vocab_size
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in lens]
    past = int(np.sum(lens + LM_NEW > H2O_WINDOW))
    print(f"  prompts of {lens.min()}-{lens.max()} tokens: {past} of "
          f"{len(lens)} requests decode past the window")
    check(past == len(lens), "a request never decodes past the window")
    h2o = phase_lm_serve(H2O_ARCH, prompts=prompts, warm=[p[:256] for p in
                                                          prompts[:2]],
                         s_max=H2O_DECODE[4])
    print(f"  (e) {EVAL_ARCH} bf16 serve at phase 12's shape")
    q3 = phase_lm_serve(EVAL_ARCH)
    print(f"  (f) {CR_ARCH} bf16, {CR_LAYERS} of 64 layers (a depth cut: "
          f"208 GB of weights at full depth)")
    cr_prompts = [np.random.default_rng(6 + i).integers(
        0, get_config(CR_ARCH).vocab_size, CR_PROMPT_LEN).astype(np.int32)
        for i in range(CR_PROMPTS)]
    cr = phase_lm_serve(CR_ARCH, n_layers=CR_LAYERS, prompts=cr_prompts,
                        s_max=CR_S_MAX, new=CR_NEW)
    counts = add_counts(add_counts(h2o, q3), cr)
    row["launches"] = h2o["decode_attention"]
    print(f"  launches on phase 21's serves (d-f): {counts}")
    return row, counts


# ---------------------------------------------------------------------------
# phase 22: the MoE, RWKV6 and Mamba-hybrid decoders
# ---------------------------------------------------------------------------

GRANITE, DEEPSEEK = "granite-moe-1b-a400m", "deepseek-moe-16b"
RWKV, JAMBA = "rwkv6-7b", "jamba-1.5-large-398b"
FAMILY_ARCHS = (GRANITE, DEEPSEEK, RWKV, JAMBA)
GRANITE_DECODE = (LM_SLOTS, 16, 8, 64, LM_S_MAX)     # B, Hq, Hkv, d, S
DEEPSEEK_DECODE = (LM_SLOTS, 16, 16, 128, LM_S_MAX)  # G = 1
FAM_F32_PROMPT, FAM_F32_STEPS = 992, 32
MAMBA_PROMPT, MAMBA_STEPS = 1024, 128
ROUTER_POOL = (4096, 16)        # pipeline rows x tokens a row


def phase_family_kernel():
    """Row 4 against its plain version at Granite-MoE's decode shape (16
    query over 8 KV heads, d 64) and DeepSeek-MoE's (16 over 16, d 128: G
    = 1), as phase 9: rotating bf16 caches in the serve's range, f32 on
    the first, repeat calls and graph replays, the edge lengths in both
    types; then timed from a CUDA graph against the byte bound, the plain
    version and SDPA.  Returns the two timing rows and the largest abs
    error."""
    rows, err = {}, 0.0
    for label, shape, seed in (("granite", GRANITE_DECODE, 31),
                               ("deepseek", DEEPSEEK_DECODE, 32)):
        sets = decode_sets("serve", seed=seed, shape=shape)
        err = max(err, _decode_checks(sets))
        err = max(err, _check_cases(
            [(f"{label} edge lengths", shape, DECODE_EDGE_LENS),
             (f"{label} one int length", shape, 700)], seed=seed))
        rows[label] = dict(decode_timing(label, sets), shape=list(shape))
        del sets
    torch.cuda.empty_cache()
    return rows, err


def _state_leaves(node):
    """The tensors of a cache list (KV pairs, Mamba and RWKV states)."""
    if isinstance(node, dict):
        for key in sorted(node):
            yield from _state_leaves(node[key])
    elif isinstance(node, (tuple, list)):
        for v in node:
            yield from _state_leaves(v)
    else:
        yield node


def phase_family_card_vs_cpu(arch: str):
    """Phase 10 on a reduced MoE/SSM/hybrid arch (f32), then teacher
    forcing over 32 tokens (logits at phase 11's tolerance, aux at rtol
    1e-5) and a 16-token prefill's caches and states (phase 11's
    tolerance) card == CPU; two card calls of ``moe`` bit-equal."""
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy, lm_tree_from_seed
    from repro_torch.models import mlp
    from repro_torch.models import model as M
    from repro_torch.models.config import reduced_for_smoke

    phase_lm_card_vs_cpu(arch)
    cfg = reduced_for_smoke(get_config(arch))
    tree = lm_tree_from_seed(cfg, 2)
    tokens = np.random.default_rng(10).integers(0, cfg.vocab_size, (2, 32))
    got = {}
    for dev in ("cuda", "cpu"):
        p = lm_params_from_numpy(cfg, tree, device=dev)
        seq = torch.as_tensor(tokens, device=dev)
        logits, aux = M.train_logits(cfg, p, {"tokens": seq})
        _, raw, _ = M.prefill(cfg, p, {"tokens": seq[:, :16]})
        got[dev] = (logits.cpu(), float(aux),
                    [t.float().cpu() for t in _state_leaves(raw)])
        if dev == "cuda" and cfg.moe is not None:
            j = next(i for i, k in enumerate(M.layer_kinds(cfg))
                     if M.parse_kind(k)[1] == "moe")
            x = torch.randn((4, 32, cfg.d_model), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(3))
            a, _ = mlp.moe(p["layers"][j]["ff"], cfg, x)
            b, _ = mlp.moe(p["layers"][j]["ff"], cfg, x)
            check(torch.equal(a, b), f"{arch}: two card calls of moe differ")
    (lc, ac, sc), (lh, ah, sh) = got["cuda"], got["cpu"]
    err = float((lc - lh).abs().max())
    check(torch.allclose(lc, lh, **LM_TOL),
          f"{arch}: teacher forcing card != cpu (max abs err {err})")
    check(abs(ac - ah) <= 1e-5 * abs(ah), f"{arch}: aux {ac} vs {ah}")
    s_err = max(float((a - b).abs().max()) for a, b in zip(sc, sh))
    check(len(sc) == len(sh) and all(
        a.shape == b.shape and torch.allclose(a, b, **LM_TOL)
        for a, b in zip(sc, sh)),
        f"{arch}: prefill caches/states card != cpu (max abs err {s_err})")
    print(f"  reduced {arch}: teacher forcing (2 x 32) max abs err "
          f"{err:.3g}, aux {ac:.6g} vs {ah:.6g}, {len(sc)} cache/state "
          f"tensors max abs err {s_err:.3g}"
          f"{'; two card calls of moe bit-equal' if cfg.moe else ''}")


def phase_mamba_full_width():
    """One Mamba mixer at Jamba-1.5-Large's published widths (d 8192, d_in
    16 384, 256 heads of 64, N 16, chunk 128) in f32: ``mamba_forward``
    over 1 024 tokens, then 128 ``mamba_decode`` steps, against
    ``mamba_forward`` over the 1 152 tokens (outputs and final SSM state at
    phase 11's tolerance)."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm

    cfg = dataclasses.replace(get_config(JAMBA), dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(4)
    p = ssm.init_mamba(gen, cfg, torch.float32, "cuda")
    n = MAMBA_PROMPT + MAMBA_STEPS
    x = torch.randn((1, n, cfg.d_model), generator=gen, device="cuda")
    t = time.perf_counter()
    y, st = ssm.mamba_forward(p, cfg, x[:, :MAMBA_PROMPT])
    outs = [y]
    for i in range(MAMBA_PROMPT, n):
        o, st = ssm.mamba_decode(p, cfg, x[:, i:i + 1], st)
        outs.append(o)
    whole, st_all = ssm.mamba_forward(p, cfg, x)
    torch.cuda.synchronize()
    got = torch.cat(outs, dim=1)
    err = float((got - whole).abs().max())
    s_err = float((st.ssm - st_all.ssm).abs().max())
    check(torch.allclose(got, whole, **LM_TOL),
          f"Mamba decode != forward at Jamba's widths (max abs err {err})")
    check(torch.allclose(st.ssm, st_all.ssm, **LM_TOL),
          f"Mamba final state differs (max abs err {s_err})")
    d_in, H = cfg.ssm.expand * cfg.d_model, (cfg.ssm.expand * cfg.d_model
                                             // cfg.ssm.head_dim)
    print(f"  Mamba mixer (d {cfg.d_model}, d_in {d_in}, {H} heads of "
          f"{cfg.ssm.head_dim}, N {cfg.ssm.d_state}) f32: forward "
          f"{MAMBA_PROMPT} + {MAMBA_STEPS} decode steps vs forward over {n}:"
          f" max abs err {err:.3g} (output scale "
          f"{float(whole.abs().max()):.3g}), final state {s_err:.3g}; "
          f"{time.perf_counter() - t:.1f} s")
    del p, x, outs, whole
    torch.cuda.empty_cache()


def phase_router_load():
    """``estimate_router_load`` over Granite-MoE's real layer-0 router (bf16,
    phase 22(d)'s seeded weights): the port's own ``route`` after layer
    0's attention block, on a pool of ``data.pipeline`` token rows; the
    estimate within 2 epsilon of the exact load over the pool; a zero
    hidden row (every probability tied) routed to experts 0..k-1.  Every
    Poisson-bootstrap call is recorded and one of each shape held against
    its plain version.  Returns the kernels' launches and that error."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.integration import estimate_router_load
    from repro_torch.kernels.poisson_bootstrap import ops as pb_ops
    from repro_torch.models import attention, mlp, nn
    from repro_torch.models import model as M

    cfg = get_config(GRANITE)
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    params = M.init_model(cfg, seed=0, device="cuda")
    lay = params["layers"][0]

    def route_fn(tokens):
        with torch.no_grad():
            x = params["embed"][torch.as_tensor(tokens, device="cuda").long()]
            h = nn.rms_norm(lay["ln1"], x, cfg.rms_eps)
            x = x + attention.self_attention(lay["mixer"], cfg, h)[0]
            h2 = nn.rms_norm(lay["ln2"], x, cfg.rms_eps)
            _, _, choice = mlp.route(lay["ff"], cfg,
                                     h2.reshape(-1, cfg.d_model))
        return choice.reshape(-1).cpu().numpy()

    rows, S = ROUTER_POOL
    pool = batch_for_step(0, global_batch=rows, seq_len=S,
                          vocab=cfg.vocab_size, device="cuda")[
                              "tokens"].cpu().numpy()
    exact = np.bincount(np.concatenate(
        [route_fn(pool[i:i + 512]) for i in range(0, rows, 512)]),
        minlength=E) / (rows * S * k)
    rr = np.random.default_rng(11)

    def token_source(n):
        return pool[rr.integers(0, rows, n)]

    calls, stop = record_calls(pb_ops, "bootstrap_moments_masked")
    reset_counts()
    t = time.perf_counter()
    rl = estimate_router_load(route_fn, token_source, E, epsilon=0.01,
                              delta=0.1, device="cuda")
    rl_s = time.perf_counter() - t
    counts = read_counts()
    stop()
    gap = float(np.linalg.norm(rl.load - exact))
    check(rl.success and gap <= 0.02,
          f"router load {rl.load} (|load - exact| {gap}, success "
          f"{rl.success})")
    print(f"  estimate_router_load over {GRANITE}'s layer-0 router (E = {E},"
          f" top-{k}, eps 0.01) on a pool of {rows} x {S} pipeline tokens: "
          f"exact load in [{exact.min():.4f}, {exact.max():.4f}], "
          f"{rl.n_tokens} token rows, {rl.iterations} iterations, error "
          f"{rl.error:.5f}, |load - exact|_2 = {gap:.5f}, {rl_s:.3f} s; "
          f"launches {counts}")
    tied = mlp.route(lay["ff"], cfg, torch.zeros((2, cfg.d_model),
                                                 device="cuda"))[2]
    check(torch.equal(tied.cpu(), torch.arange(k).expand(2, k)),
          f"a zero hidden row (all {E} probabilities tied) routed to "
          f"{tied.tolist()}, not experts 0..{k - 1}")
    print(f"  a zero hidden row (all {E} probabilities tied) routes to "
          f"experts 0..{k - 1}, as lax.top_k orders ties")
    err = hold_pb("phase 22(f)", calls) if calls else 0.0
    if not calls:
        print("  no Poisson-bootstrap call: the router load's ESTIMATE is "
              "the generic bootstrap (threefry weights on the card)")
    del params
    torch.cuda.empty_cache()
    return counts, err


def phase_families():
    """(a) row 4 at Granite-MoE's and DeepSeek-MoE's decode shapes; (b) the
    four reduced archs card == CPU; (c) Granite-MoE and RWKV6-7B in f32 at
    full width and depth, 32 greedy steps after a 992-token prefill against
    teacher forcing, and one Mamba mixer at Jamba's widths; (d) bf16 serves
    at full width and depth (16 requests, 8 slots, S_max 2048): Granite-MoE,
    DeepSeek-MoE-16B, RWKV6-7B; (e) reduced Jamba through the batcher on
    the card; (f) the router load over Granite's real router.  Returns row
    4's timing rows, the launches of (d)-(f) and the largest abs errors."""
    from repro_torch.configs import get_config
    from repro_torch.models import flops
    from repro_torch.models.config import reduced_for_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("  (a) decode attention vs plain at the MoE decoders' shapes")
    rows, err = phase_family_kernel()
    print("  (b) reduced archs, card vs cpu")
    for arch in FAMILY_ARCHS:
        phase_family_card_vs_cpu(arch)
    print("  (c) full width in f32 against teacher forcing")
    g = get_config(GRANITE)
    g = dataclasses.replace(g, dtype="float32", moe=dataclasses.replace(
        g.moe, capacity_factor=g.moe.num_experts / g.moe.top_k))
    print(f"  {GRANITE}: capacity factor {g.moe.capacity_factor} (an expert "
          f"receives at most one entry a token, so C >= T: nothing drops)")
    for cfg in (g, dataclasses.replace(get_config(RWKV), dtype="float32")):
        params = _build_f32(cfg)
        f32_decode_vs_teacher_forcing(cfg, params, FAM_F32_PROMPT,
                                      FAM_F32_STEPS, cfg.name)
        del params
        torch.cuda.empty_cache()
    phase_mamba_full_width()
    print("  (d) bf16 serves at full width and depth")
    serve = {}
    for arch in (GRANITE, DEEPSEEK, RWKV):
        cfg = get_config(arch)
        print(f"  {arch}: {flops.count_params_analytic(cfg) / 1e9:.3f} B "
              f"params ({flops.count_active_analytic(cfg) / 1e9:.3f} B "
              f"active), {flops.weight_bytes(cfg) / 1e9:.2f} GB of weights")
        prompts = None
        if arch == RWKV:        # multiples of the chunk (32) in 32-1024
            rng = np.random.default_rng(12)
            prompts = [rng.integers(0, cfg.vocab_size, 32 * n).astype(
                np.int32) for n in rng.integers(1, 33, LM_REQUESTS)]
        serve[arch] = phase_lm_serve(arch, prompts=prompts)
    print(f"  (e) reduced {JAMBA} (bf16) through the batcher on the card")
    jcfg = dataclasses.replace(reduced_for_smoke(get_config(JAMBA)),
                               dtype="bfloat16")
    rng = np.random.default_rng(13)
    lens = [*rng.integers(1, 17, LM_REQUESTS // 2),
            *(16 * rng.integers(2, 33, LM_REQUESTS // 2))]
    serve[JAMBA] = phase_lm_serve(JAMBA, cfg=jcfg, prompts=[
        rng.integers(0, jcfg.vocab_size, n).astype(np.int32) for n in lens])
    print(f"  (f) router load over {GRANITE}'s layer-0 router")
    serve["router"], pb_err = phase_router_load()
    counts = serve[GRANITE]
    for key in (DEEPSEEK, RWKV, JAMBA, "router"):
        counts = add_counts(counts, serve[key])
    print(f"  launches on phase 22's main paths (d-f): "
          f"{ {k: v['decode_attention'] for k, v in serve.items()} } "
          f"decode attention; all {counts}")
    return rows, counts, err, pb_err


# ---------------------------------------------------------------------------
# phase 23: cross-attention, the encoder-decoder stack and the vision layers
# ---------------------------------------------------------------------------

SEAMLESS, VISION = "seamless-m4t-large-v2", "llama-3.2-vision-90b"
VISION_LAYERS = 10              # two whole 5-layer units (four dense, xonly)
X_ROWS, X_PROMPT, X_NEW, X_S_MAX = 8, (16, 64), 32, 128
X_CPU_PROMPT, X_CPU_STEPS, X_MEM = 12, 8, 16
X_F32_PROMPT, X_F32_STEPS = 16, 16
# bf16 card == CPU: logits within 2e-2 relative L2 and 0.15 max abs, about
# the reduced models' own bf16-vs-f32 gap on the CPU (1.35e-2, 0.073).
X_BF16_REL, X_BF16_ABS = 2e-2, 0.15
# Row 4 at the new decode shapes, (B, Hq, Hkv, d, S): self-attention caches
# and the cross-attention memories (every row reads all S positions).
X_DECODE = {
    "seamless_self": ((X_ROWS, 16, 16, 64, X_S_MAX), (64, 64)),
    "seamless_cross": ((X_ROWS, 16, 16, 64, 4096), None),
    "vision_self": ((X_ROWS, 64, 8, 128, X_S_MAX), X_PROMPT),
    "vision_cross": ((X_ROWS, 64, 8, 128, 1600), None),
}


def _mem_key(cfg) -> str:
    return "frames" if cfg.is_encdec else "image_embeds"


def phase_cross_kernel():
    """Row 4 against its plain version at the cross decoders' four decode
    shapes, as phase 9: rotating bf16 caches (self-attention: lengths in
    the serve's range, poisoned past them; cross-attention: every row at
    the memory's length), f32 on the first, repeat calls and graph
    replays, int / int32 / int64 lengths alike; then timed from a CUDA
    graph beside the byte bound, the plain version and SDPA (the
    cross-attention's kernel calls take the int length, as the model's).
    Returns the four timing rows and the largest abs error."""
    rows, err = {}, 0.0
    for seed, (label, (shape, prompt)) in enumerate(X_DECODE.items(), 41):
        cross = prompt is None
        sets = decode_sets("full" if cross else "serve", seed=seed,
                           shape=shape, prompt=prompt)
        err = max(err, _decode_checks(sets))
        cases = [(f"{label} one int length", shape, shape[4])]
        if not cross:
            cases.append((f"{label} edge lengths", shape,
                          [0, 1, 63, 64, 65, 96, shape[4], shape[4] + 1]))
        err = max(err, _check_cases(cases, seed=seed))
        rows[label] = dict(decode_timing(label, sets, int_len=cross),
                           shape=list(shape))
        del sets
        torch.cuda.empty_cache()
    return rows, err


def _cross_batch(cfg, tokens, mem, dev):
    return {"tokens": torch.as_tensor(tokens, device=dev),
            _mem_key(cfg): torch.as_tensor(mem, device=dev)}


def phase_cross_card_vs_cpu(arch: str):
    """(a) reduced ``arch`` in f32 and bf16 on the same seeded tree, card
    (row 4) against CPU (plain version): ``train_logits`` over 20 tokens,
    ``prefill`` of 12 (logits and memory), 8 decode steps; f32 at phase
    11's tolerance, bf16 within ``X_BF16_REL``/``X_BF16_ABS``.  (b) f32
    decode against teacher forcing on the card after ``caches_from_prefill``
    (phase 11's tolerance)."""
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy, lm_tree_from_seed
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.models import model as M
    from repro_torch.models.config import reduced_for_smoke

    base = reduced_for_smoke(get_config(arch))
    rng = np.random.default_rng(23)
    n = X_CPU_PROMPT + X_CPU_STEPS
    tokens = rng.integers(0, base.vocab_size, (2, n))
    mem = rng.standard_normal((2, X_MEM, base.d_model)).astype(np.float32)
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype)
        tree = lm_tree_from_seed(cfg, 3)
        out = {}
        for dev in ("cuda", "cpu"):
            p = lm_params_from_numpy(cfg, tree, device=dev)
            full, _ = M.train_logits(cfg, p, _cross_batch(cfg, tokens, mem,
                                                          dev))
            batch = _cross_batch(cfg, tokens[:, :X_CPU_PROMPT], mem, dev)
            last, raw, memory = M.prefill(cfg, p, batch)
            caches = M.caches_from_prefill(cfg, raw, S_max=n + 4)
            outs = [last]
            n0 = da_ops.counter.launches
            for t in range(X_CPU_PROMPT, n):
                last, caches = M.decode_step(
                    cfg, p, torch.as_tensor(tokens[:, t:t + 1], device=dev),
                    caches)
                outs.append(last)
            launched = da_ops.counter.launches - n0
            check(launched == (row4_per_step(cfg) * X_CPU_STEPS
                               if dev == "cuda" else 0),
                  f"reduced {arch} on {dev}: {launched} kernel launches")
            out[dev] = [x.float().cpu() for x in
                        (full, torch.cat(outs, dim=1), memory)]
        errs = []
        for what, a, b in zip(("teacher forcing", "prefill + decode",
                               "memory"), out["cuda"], out["cpu"]):
            e = float((a - b).abs().max())
            rel = float((a - b).norm() / b.norm())
            errs.append(f"{what} {e:.3g}" + (f" (rel {rel:.3g})"
                                             if dtype != "float32" else ""))
            ok = (torch.allclose(a, b, **LM_TOL) if dtype == "float32" else
                  rel <= X_BF16_REL and e <= X_BF16_ABS)
            check(ok, f"reduced {arch} {dtype}: {what} card != cpu (max abs "
                      f"err {e}, rel {rel})")
        print(f"  reduced {arch} {dtype}: card == cpu, max abs err "
              f"{', '.join(errs)}")
    cfg = dataclasses.replace(base, dtype="float32")
    params = lm_params_from_numpy(cfg, lm_tree_from_seed(cfg, 4),
                                  device="cuda")
    extra = {_mem_key(cfg): torch.as_tensor(
        rng.standard_normal((1, X_MEM, cfg.d_model)).astype(np.float32),
        device="cuda")}
    f32_decode_vs_teacher_forcing(cfg, params, X_F32_PROMPT, X_F32_STEPS,
                                  f"reduced {arch}", extra)


def _cat_caches(nodes):
    """One batch of decode caches from rows' caches of batch 1: every
    tensor (K/V, lengths, cross-KV) concatenated along its row axis."""
    first = nodes[0]
    if isinstance(first, dict):
        return {k: _cat_caches([n[k] for n in nodes]) for k in first}
    if isinstance(first, (tuple, list)):
        parts = [_cat_caches(list(x)) for x in zip(*nodes)]
        return (type(first)(*parts) if hasattr(first, "_fields")
                else type(first)(parts))
    return torch.cat(nodes, dim=0)


def _step_bytes(cfg, params, caches) -> int:
    """Bytes a decode step must read at the least: the decoder's weight
    matrices and the head once (``flops.weight_bytes`` without the
    encoder), every cross-KV and the self K/V rows below each length."""
    from repro_torch.models import model as M

    layers = params["dec"] if cfg.is_encdec else params["layers"]
    head = params["unembed"] if "unembed" in params else params["tied_head"]
    n = head.numel() * head.element_size() + sum(
        t.numel() * t.element_size() for _, t in M._leaves(layers)
        if t.dim() > 1)
    for c in caches:
        kv = c.get("mixer") if isinstance(c, dict) else c
        if kv is not None:
            row = kv.k[0, 0].numel() * kv.k.element_size()
            n += 2 * row * int(kv.length.clamp(max=kv.k.shape[1]).sum())
        if isinstance(c, dict):
            n += sum(t.numel() * t.element_size() for t in c["xkv"])
    return n


def phase_cross_serve(arch: str, n_layers=None) -> dict:
    """``arch`` in bf16 at full width (``n_layers`` cuts the depth), seeded
    weights on the card: 8 rows of the pipeline's memory extra (frames or
    image embeddings, the config's ``n_frontend_tokens`` each) and decoder
    prompts of 16-64 tokens; each row's ``prefill`` (batch 1, its own
    memory; the encoder's f32 scores stay at one row's), the rows' caches
    stacked, then 32 greedy ``decode_step``s of all 8 rows.  Every row its
    32 tokens, logits finite, row 4 launched ``row4_per_step`` times a
    step.  Returns the kernels' launches over the decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import batch_for_step, batch_kwargs_for
    from repro_torch.models import flops
    from repro_torch.models import model as M

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    t = time.perf_counter()
    params = M.init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"  {arch} bf16, {cfg.n_layers} of {get_config(arch).n_layers} "
          f"layers{' a stack' if cfg.is_encdec else ''}: "
          f"{M.count_params(params) / 1e9:.3f} B params "
          f"({flops.count_params_analytic(cfg) / 1e9:.3f} B analytic), "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, built "
          f"in {time.perf_counter() - t:.1f} s")
    kw = batch_kwargs_for(cfg, cfg.n_frontend_tokens)
    mem = batch_for_step(0, global_batch=X_ROWS, seq_len=1,
                         vocab=cfg.vocab_size, device="cuda", **kw)[kw["extra"]]
    rng = np.random.default_rng(24)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in
               rng.integers(X_PROMPT[0], X_PROMPT[1] + 1, X_ROWS)]
    key = _mem_key(cfg)

    def prefill_rows():
        lasts, raws = [], []
        for i, p in enumerate(prompts):
            last, raw, _ = M.prefill(cfg, params, {
                "tokens": torch.as_tensor(p[None], device="cuda"),
                key: mem[i:i + 1]})
            lasts.append(last)
            raws.append(M.caches_from_prefill(cfg, raw, X_S_MAX))
        return torch.cat(lasts), _cat_caches(raws)

    prefill_rows()                              # warm: allocator, kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    last, caches = prefill_rows()
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    step_bytes = _step_bytes(cfg, params, caches)
    reset_counts()
    step_s, toks = [], []
    t0 = time.perf_counter()
    for _ in range(X_NEW):
        nxt = last[:, -1].argmax(-1)[:, None]
        toks.append(nxt)
        t = time.perf_counter()
        last, caches = M.decode_step(cfg, params, nxt, caches)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    decode_s = time.perf_counter() - t0
    counts = read_counts()
    out = torch.cat(toks, dim=1).cpu().numpy()
    check(out.shape == (X_ROWS, X_NEW) and bool(
        ((out >= 0) & (out < cfg.vocab_size)).all()),
        f"{arch}: tokens {out.shape} out of the vocabulary")
    check(bool(torch.isfinite(last).all()), f"{arch}: non-finite logits")
    per = row4_per_step(cfg)
    n_da = counts["decode_attention"]
    check(n_da == per * X_NEW and n_da > 0,
          f"{arch}: {n_da} decode-attention launches != {per} x {X_NEW}")
    step_ms = np.asarray(step_s) * 1e3
    kinds = [M.parse_kind(k)[0] for k in M.layer_kinds(cfg)]
    n_cross = sum(k in ("cross", "xonly") for k in kinds)
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    print(f"  {X_ROWS} rows x {cfg.n_frontend_tokens} memory tokens, "
          f"prompts of {min(map(len, prompts))}-{max(map(len, prompts))}: "
          f"prefill {prefill_s * 1e3:.2f} ms ({prefill_s * 1e3 / X_ROWS:.2f} "
          f"ms a row); {X_NEW} decode steps mean {step_ms.mean():.2f} ms p50 "
          f"{np.percentile(step_ms, 50):.2f} ms = {X_ROWS / step_ms.mean() * 1e3:.1f} "
          f"tokens/s ({X_ROWS * X_NEW / (prefill_s + decode_s):.1f} with the "
          f"prefill); peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
          f"a step's byte bound {bound_ms:.3f} ms ({step_bytes / 1e9:.3f} GB:"
          f" decoder weights and head, {n_cross} cross-KV, self K/V; all "
          f"weights {flops.weight_bytes(cfg) / 1e9:.3f} GB); decode-attention "
          f"launches {n_da} ({per} a step: {per - n_cross} self, {n_cross} "
          f"cross); first row's tokens {out[0, :8].tolist()}")
    del params, caches, last, mem
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_cross():
    """(a)-(b) the reduced archs card == CPU and f32 decode == teacher
    forcing; (c) row 4 at the new decode shapes; (d) SeamlessM4T-large-v2
    at full width and depth; (e) Llama-3.2-Vision-90B cut to two 5-layer
    units.  Returns row 4's timing rows, the launches of (d)-(e) and the
    largest abs error."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("  (a)-(b) reduced archs: card vs cpu (f32, bf16), f32 decode vs "
          "teacher forcing")
    for arch in (SEAMLESS, VISION):
        phase_cross_card_vs_cpu(arch)
    print("  (c) decode attention vs plain at the cross decoders' shapes")
    rows, err = phase_cross_kernel()
    print(f"  (d) {SEAMLESS} bf16 at full width and depth")
    seam = phase_cross_serve(SEAMLESS)
    print(f"  (e) {VISION} bf16, {VISION_LAYERS} of 100 layers (a depth cut: "
          f"175 GB of weights at full depth)")
    vis = phase_cross_serve(VISION, VISION_LAYERS)
    counts = add_counts(seam, vis)
    print(f"  launches on phase 23's main paths (d-e): {counts}")
    return rows, counts, err, {SEAMLESS: seam["decode_attention"],
                               VISION: vis["decode_attention"]}


# ---------------------------------------------------------------------------
# phase 24: training
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen2-1.5b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 10, 8, 512
TRAIN_MAIN = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
              str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--remat", "dots",
              "--eval-every", str(TRAIN_STEPS), "--seed", "0"]
TRAIN_SMOKE = ["--arch", TRAIN_ARCH, "--smoke", "--batch", "8", "--seq",
               "64", "--seed", "0"]
TRAIN_TOL = dict(rtol=2e-4, atol=2e-5)    # the reference's microbatch test
# Adam's first steps move each element by about lr * sign(g), so an element
# whose gradient lies within f32 noise of zero may move either way: params
# are compared after steps at TRAIN_LR (a move of ~1e-5, inside TRAIN_TOL
# even when its sign flips), the gradients through the first moment
# mu = (1 - b1) g, each leaf within MOMENT_TOL of its largest magnitude.
TRAIN_LR = 1e-5
MOMENT_TOL = 2e-4
# One H100 SXM's dense bf16 tensor-core peak (NVIDIA's data sheet, at the
# 700 W limit): the yardstick of the step's share of peak.
BF16_PEAK_FLOPS = 989e12
COMPRESS_N = 1 << 22                      # a 4 M-element gradient leaf
COMPRESS_RANKS = 4


def _trees_close(got, want, what: str, leaf_tol=None) -> float:
    """Every leaf of ``got`` within ``TRAIN_TOL`` of ``want``'s, or with
    ``leaf_tol`` within that fraction of the leaf's largest magnitude;
    returns the largest abs difference."""
    from repro_torch.train import pytree
    a, b = pytree.leaves(got), pytree.leaves(want)
    check(len(a) == len(b), f"{what}: {len(a)} leaves against {len(b)}")
    worst = 0.0
    for x, y in zip(a, b):
        x, y = x.detach().float().cpu(), y.detach().float().cpu()
        d = float((x - y).abs().max())
        ok = (d <= leaf_tol * float(y.abs().max()) if leaf_tol is not None
              else torch.allclose(x, y, **TRAIN_TOL))
        check(x.shape == y.shape and ok, f"{what}: max abs err {d}")
        worst = max(worst, d)
    return worst


def _trees_bits_equal(got, want) -> bool:
    from repro_torch.train import pytree
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in
               zip(pytree.leaves(got), pytree.leaves(want)))


def phase_train_card_vs_cpu() -> float:
    """(a) One ``step_fn`` (remat "dots", lr ``TRAIN_LR``) of every arch
    at ``reduced_for_smoke`` size in f32 on the card against the CPU, from
    one seeded tree and pipeline batch 0: loss and params within
    ``TRAIN_TOL``, the moments (the gradients) within ``MOMENT_TOL``, TF32
    off.  Returns the largest abs difference."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.convert import lm_params_from_numpy, lm_tree_from_seed
    from repro_torch.data import pipeline
    from repro_torch.models import model as M
    from repro_torch.models.config import reduced_for_smoke
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_step import TrainConfig, build_train_step

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    tcfg = TrainConfig(optimizer=AdamWConfig(lr_peak=TRAIN_LR,
                                             warmup_steps=1), remat="dots")
    worst = 0.0
    for arch in ARCHS:
        cfg = reduced_for_smoke(get_config(arch))
        tree = lm_tree_from_seed(cfg, 0)
        _, step = build_train_step(cfg, tcfg)
        out = {}
        for dev in ("cpu", "cuda"):
            params = lm_params_from_numpy(cfg, tree, device=dev)
            opt = adamw_init(tcfg.optimizer, M.trainable(params))
            batch = pipeline.batch_for_step(
                0, global_batch=4, seq_len=32, vocab=cfg.vocab_size, seed=0,
                device=dev, **pipeline.batch_kwargs_for(cfg, 32))
            out[dev] = step(params, opt, batch)
        (pc, oc, mc), (pg, og, mg) = out["cpu"], out["cuda"]
        lc, lg = float(mc["loss"]), float(mg["loss"])
        check(abs(lg - lc) <= 2e-4 * abs(lc),
              f"{arch}: train loss card {lg} != cpu {lc}")
        err = max(_trees_close(pg, pc, f"{arch} params"),
                  _trees_close(og["mu"], oc["mu"], f"{arch} mu", MOMENT_TOL),
                  _trees_close(og["nu"], oc["nu"], f"{arch} nu", MOMENT_TOL))
        worst = max(worst, err)
        print(f"  (a) {arch}: loss card {lg:.6f} cpu {lc:.6f}; params and "
              f"moments max abs err {err:.3e}")
    return worst


def phase_train_full_width(card: str) -> dict:
    """(b) Qwen2-1.5B (bf16, 28 layers, d 1536, vocab 151 936, tied head)
    trained through ``launch.train.run``: 10 steps of 8 x 512 pipeline
    tokens under remat "dots", then the MISS-certified eval.  Every loss
    finite, the last below the first; step time (median of steps 2-9, each
    ended by its loss's host read), tokens/s, peak memory and the share of
    the bf16 peak that ``model_flops(kind="train")`` over the step time
    gives.  The launch counts are set to 0 just before and read just after
    and printed: no kernel lies on this path (the forward and backward
    attend through ``_sdpa``'s einsums, the eval's ESTIMATE is the generic
    bootstrap)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as T
    from repro_torch.models import flops

    cfg = get_config(TRAIN_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    reset_counts()
    out = T.run(TRAIN_MAIN)
    torch.cuda.synchronize()
    counts = read_counts()
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"full-width training losses {losses}")
    check(losses[-1] < losses[0],
          f"full-width training loss did not fall: {losses}")
    step_s = statistics.median(out["step_s"][1:TRAIN_STEPS - 1])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    fl = flops.model_flops(cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                           kind="train")
    (tr,) = out["evals"]
    check(tr.theta is not None and np.all(np.isfinite(tr.theta))
          and np.isfinite(tr.error), "full-width eval gave no finite loss")
    row = {"step_ms": step_s * 1e3,
           "step_ms_all": [s * 1e3 for s in out["step_s"]],
           "tokens_per_s": tokens / step_s, "model_flops": fl,
           "bound_ms": fl / BF16_PEAK_FLOPS * 1e3,
           "bf16_peak_share": fl / step_s / BF16_PEAK_FLOPS,
           "peak_gb": peak / 1e9, "losses": losses,
           "eval_forwards": tr.info["model_forwards"],
           "full_eval_forwards": tr.info["full_eval_forwards"],
           "eval_success": bool(tr.success), "eval_error": float(tr.error),
           "wall_s": wall, "card": card}
    print(f"  (b) {TRAIN_ARCH} bf16 full width, {TRAIN_STEPS} steps of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}: losses "
          f"{[round(x, 4) for x in losses]}; step {row['step_ms']:.1f} ms "
          f"(median of steps 2-{TRAIN_STEPS - 1}), {row['tokens_per_s']:.0f} "
          f"tokens/s, model flops {fl:.3e} a step = "
          f"{100 * row['bf16_peak_share']:.1f} % of the {BF16_PEAK_FLOPS:.3g} "
          f"FLOP/s dense bf16 peak (bound {row['bound_ms']:.1f} ms), peak "
          f"memory {row['peak_gb']:.1f} GB; MISS eval {tr.status} in "
          f"{row['eval_forwards']} of {row['full_eval_forwards']} forwards "
          f"(err {tr.error:.4f}); launches {counts}; {wall:.1f} s on {card}")
    row["launches"] = counts
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_train_resume_and_micro() -> dict:
    """(c) ``--steps 8`` uninterrupted against ``--steps 6 --ckpt D
    --ckpt-every 3`` then ``--steps 8 --ckpt D`` (resumes at step 6), at
    ``--smoke`` size on the card: losses and params within ``TRAIN_TOL``,
    bit equality reported; D deleted.  (d) ``--microbatches 4`` against 1
    for one step at ``--lr TRAIN_LR``: loss and params within
    ``TRAIN_TOL``, the moments within ``MOMENT_TOL``."""
    import tempfile

    from repro_torch.launch import train as T

    full = T.run(TRAIN_SMOKE + ["--steps", "8"])
    with tempfile.TemporaryDirectory() as d:
        first = T.run(TRAIN_SMOKE + ["--steps", "6", "--ckpt", d,
                                     "--ckpt-every", "3"])
        again = T.run(TRAIN_SMOKE + ["--steps", "8", "--ckpt", d])
    check(again["start_step"] == 6, f"resumed at {again['start_step']}")
    got = first["losses"] + again["losses"]
    check(np.allclose(got, full["losses"], rtol=2e-4, atol=0),
          f"resumed losses {got} != {full['losses']}")
    err = _trees_close(again["params"], full["params"], "resumed params")
    bits = got == full["losses"] and _trees_bits_equal(again["params"],
                                                        full["params"])
    print(f"  (c) resume at step 6: losses {[round(x, 5) for x in got]}, "
          f"params max abs err {err:.3e}, bit-equal: {bits}")
    lr = ["--steps", "1", "--lr", str(TRAIN_LR)]
    one = T.run(TRAIN_SMOKE + lr)
    four = T.run(TRAIN_SMOKE + lr + ["--microbatches", "4"])
    check(abs(one["loss"] - four["loss"]) <= 2e-4 * abs(one["loss"]),
          f"microbatched loss {four['loss']} != {one['loss']}")
    merr = max(_trees_close(four["params"], one["params"],
                            "microbatch params"),
               _trees_close(four["opt_state"]["mu"], one["opt_state"]["mu"],
                            "microbatch mu", MOMENT_TOL))
    print(f"  (d) 4 microbatches vs 1: loss {four['loss']:.6f} vs "
          f"{one['loss']:.6f}, params max abs err {merr:.3e}")
    return {"resume_bits_equal": bits, "resume_max_abs_err": err,
            "micro_max_abs_err": merr}


def _compress_inputs(rank: int):
    """Rank ``rank``'s gradient and residual (f32, mixed magnitudes across
    ranks, so the shared scale is another rank's)."""
    g = np.random.default_rng(300 + rank)
    x = (g.standard_normal(COMPRESS_N) * 10.0 ** (rank - 2)).astype(
        np.float32)
    r = (g.standard_normal(COMPRESS_N) * 10.0 ** (rank - 4)).astype(
        np.float32)
    return x, r


def _numpy_compressed_psum(xs, rs):
    """The reference's ``compressed_psum`` (train/compression.py), in numpy
    for every rank at once (``np.round`` rounds half to even, as
    ``jnp.round``): (sum, residual of each rank)."""
    f32 = np.float32
    tgt = [x + r for x, r in zip(xs, rs)]
    scale = np.max(np.asarray([np.maximum(np.max(np.abs(t)) / f32(127.0),
                                          f32(1e-12)) for t in tgt], f32))
    qs = [np.clip(np.round(t / scale), -127, 127).astype(np.int8)
          for t in tgt]
    resid = [t - q.astype(f32) * scale for t, q in zip(tgt, qs)]
    total = np.sum([q.astype(np.int32) for q in qs], axis=0, dtype=np.int32)
    return total.astype(f32) * scale, resid


def compress_rank_main(argv) -> None:
    """One rank of phase 24(e): a gloo group of ``COMPRESS_RANKS``
    processes sharing the card runs ``compressed_psum`` on card tensors and
    writes the sum and its residual to an ``.npz``."""
    import torch.distributed as dist
    from repro_torch.core.mesh import make_data_mesh
    from repro_torch.train import compression as comp

    rank, world, store, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    mesh = make_data_mesh(world, device="cuda")
    x, r = _compress_inputs(rank)
    s, nr = comp.compressed_psum(torch.from_numpy(x).cuda(),
                                 torch.from_numpy(r).cuda(), mesh)
    check(s.is_cuda and nr.is_cuda, "compressed_psum left the card")
    np.savez(out, sum=s.cpu().numpy(), resid=nr.cpu().numpy(),
             reduces=mesh.reduces)
    dist.barrier()
    dist.destroy_process_group()


def phase_train_compression() -> None:
    """(e) ``quantize_int8`` / ``ef_quantize`` on a card tensor equal to the
    CPU's bit for bit; ``compressed_psum`` over 4 gloo ranks sharing the
    card bit-equal to the numpy transcription of the reference's."""
    import os
    import tempfile

    from repro_torch.train import compression as comp

    x, r = _compress_inputs(0)
    for name, fn, args in (
            ("quantize_int8", comp.quantize_int8, (x,)),
            ("ef_quantize", comp.ef_quantize, (x, r))):
        cpu = fn(*(torch.from_numpy(a) for a in args))
        card = fn(*(torch.from_numpy(a).cuda() for a in args))
        for a, b in zip(cpu, card):
            check(a.dtype == b.dtype and
                  a.numpy().tobytes() == b.cpu().numpy().tobytes(),
                  f"{name}: card != cpu")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--compress-rank", str(k), str(COMPRESS_RANKS),
             str(tmp / "store"), str(tmp / f"c{k}.npz")],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
            for k in range(COMPRESS_RANKS)]
        errs = []
        try:
            for p in procs:
                errs.append(p.communicate(timeout=300)[1])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for k, p in enumerate(procs):
            check(p.returncode == 0,
                  f"compression rank {k} failed: {errs[k][-3000:]}")
        ranks = [dict(np.load(tmp / f"c{k}.npz"))
                 for k in range(COMPRESS_RANKS)]
    xs, rs = zip(*(_compress_inputs(k) for k in range(COMPRESS_RANKS)))
    want, want_r = _numpy_compressed_psum(xs, rs)
    for k, got in enumerate(ranks):
        check(got["sum"].tobytes() == want.tobytes(),
              f"compressed_psum rank {k}: sum != numpy")
        check(got["resid"].tobytes() == want_r[k].tobytes(),
              f"compressed_psum rank {k}: residual != numpy")
        check(int(got["reduces"]) == 2, f"rank {k}: {got['reduces']} "
              f"all-reduces, expected 2")
    print(f"  (e) quantize_int8 / ef_quantize card == cpu bit for bit on "
          f"{COMPRESS_N} elements; compressed_psum over {COMPRESS_RANKS} "
          f"gloo ranks sharing the card bit-equal to numpy, 2 all-reduces "
          f"a rank")


def phase_train(card: str) -> dict:
    """Phase 24: (a)-(e); returns (b)'s row with (a), (c) and (d)'s
    errors."""
    t = time.perf_counter()
    a_err = phase_train_card_vs_cpu()
    row = phase_train_full_width(card)
    row.update(phase_train_resume_and_micro(), card_vs_cpu_max_abs_err=a_err)
    phase_train_compression()
    row["phase_s"] = time.perf_counter() - t
    print(f"  phase 24: {row['phase_s']:.1f} s")
    return row


def _lineitem(group_by: str):
    from repro_torch.data import make_lineitem

    t = time.perf_counter()
    data, gid = make_lineitem(scale_factor=10, group_by=group_by,
                              device="cuda")
    torch.cuda.synchronize()
    print(f"lineitem SF10 GROUP BY {group_by}: {data.values.shape[0]} rows, "
          f"groups {np.diff(data.offsets).tolist()}, built in "
          f"{time.perf_counter() - t:.1f} s")
    return data, gid


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: a CUDA card is required")
    if len(sys.argv) > 1 and sys.argv[1] == "--mesh-rank":
        mesh_rank_main(sys.argv[2:])
        return
    if len(sys.argv) > 1 and sys.argv[1] == "--compress-rank":
        compress_rank_main(sys.argv[2:])
        return
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.poisson_bootstrap import ops as pb_ops
    from repro_torch.kernels.segment_agg import ops as seg_ops

    t_start = time.perf_counter()
    # -- phase 1 --
    card = nvidia_smi("name,power.limit")
    print(card)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}; max SM clock {clock_mhz:.0f} MHz")
    t = time.perf_counter()
    builds = (pb_ops.build, seg_ops.build, da_ops.build)
    with ThreadPoolExecutor(max_workers=len(builds)) as ex:
        list(ex.map(lambda b: b(verbose=True), builds))
    pb_ops.library()
    seg_ops.library()
    da_ops.library()
    print(f"phase 1: the three kernel libraries built in "
          f"{time.perf_counter() - t:.1f} s")
    pb_pp = sass_ops_per_pair(pb_ops.build(), "pb_kernel")
    seg_pp = sass_ops_per_pair(seg_ops.build(), "seg_boot_kernel")
    for name, pp in (("poisson_bootstrap", pb_pp), ("segment_bootstrap",
                                                    seg_pp)):
        print(f"  {name}: instructions a (element, replicate) pair in the "
              f"draw loop (SASS): {pp}; {pair_clocks(pp):.4f} SM clocks a "
              f"pair at the least (the 30-integer-op estimate: "
              f"{OPS_PER_PAIR / INT32_LANES_PER_SM:.4f})")
    data, _ = _lineitem("shipinstruct")
    tax, tax_gid = _lineitem("tax")
    # -- phase 2 --
    print("phase 2: Poisson-bootstrap kernel vs plain on the card "
          "(tier 4x4, B=300)")
    pb_rows, pb_err = phase_kernel(data, clock_mhz * 1e6, pb_pp)
    # -- phase 3 --
    print("phase 3: segment-bootstrap kernel vs plain on the card "
          "(9-lane block, B=300)")
    seg_rows, seg_serve, seg_measure = phase_segment_boot(
        tax, clock_mhz * 1e6, seg_pp)
    # -- phase 4 --
    print("phase 4: exact segment-aggregate kernel over lineitem SF10 "
          "GROUP BY TAX")
    agg = phase_segment_agg(tax, tax_gid)
    # -- phase 5 --
    print("phase 5: card vs cpu at the CPU tests' size")
    phase_card_vs_cpu()
    # -- phase 6 --
    print("phase 6: solo serve, lineitem SF10 GROUP BY SHIPINSTRUCT")
    solo_counts, widths, pb_calls, p50_solo = phase_serve(data)
    # -- phase 7 --
    print("phase 7: grouped serve, lineitem SF10 GROUP BY TAX")
    grouped_counts, lengths, seg_calls = phase_grouped_serve(tax)
    launches = add_counts(solo_counts, grouped_counts)
    print(f"  launches on the main paths (phases 6 + 7): {launches}")
    # -- phase 8 --
    w_main = widths.most_common(1)[0][0]
    r = pb_rows[f"w={w_main}"]
    L_main = lengths.most_common(1)[0][0]
    print("phase 8: both bootstrap kernels on the serves' own calls, then "
          "the segment bootstrap on phase 3's stream at the grouped serve's "
          "most used length")
    pb_serve, seg_replay = phase_serve_replays(pb_calls, seg_calls, pb_pp,
                                               seg_pp, clock_mhz * 1e6)
    s = seg_measure(L_main, plain=True)
    seg_err = max(row["max_abs_err"] for row in [s, *seg_rows.values()])
    del tax_gid, pb_calls, seg_calls
    torch.cuda.empty_cache()
    # -- phase 9 --
    print("phase 9: decode-attention kernel vs plain on the card")
    da = phase_decode_kernel()
    # -- phase 10 --
    print("phase 10: LM card vs cpu at the CPU tests' size")
    phase_lm_card_vs_cpu()
    # -- phase 11 --
    print(f"phase 11: {LM_ARCH} full width in f32, prefill -> decode_step vs "
          f"train_logits")
    phase_lm_full_width_f32()
    # -- phase 12 --
    print(f"phase 12: LM serve, {LM_ARCH} bf16 at full width")
    lm_counts = phase_lm_serve()
    launches = add_counts(launches, lm_counts)
    # -- phase 13 --
    print("phase 13: host route card vs cpu at the CPU tests' size")
    phase_host_vs_cpu()
    # -- phase 14 --
    print("phase 14: host serve, lineitem SF10 GROUP BY SHIPINSTRUCT")
    host_counts, host_agg = phase_host_serve(data)
    launches = add_counts(launches, host_counts)
    # -- phase 15 --
    print("phase 15: warm and SLO lanes, card vs cpu at the CPU tests' size")
    warm_cpu_counts = phase_warm_slo_vs_cpu()
    # -- phase 16 --
    print("phase 16: warm and overload serve, lineitem SF10")
    warm_counts = phase_warm_serve(data, tax)
    over_counts = phase_overload_serve(data)
    serve16 = add_counts(warm_counts, over_counts)
    launches = add_counts(launches, serve16)
    print(f"  launches in phase 16: warm {warm_counts}, overload "
          f"{over_counts}")
    # -- phase 17 --
    print("phase 17: the sharded path, card vs cpu at the CPU tests' size, "
          "and a 4-rank mesh on the card")
    shard_cpu_counts, mesh_rank_launches = phase_sharded_vs_cpu()
    # -- phase 18 --
    print("phase 18: sharded serve (S = 4), lineitem SF10")
    shard_counts = phase_sharded_serve(data, tax, p50_solo)
    launches = add_counts(launches, shard_counts)
    del tax
    # -- phase 19 --
    print("phase 19: the baselines at real size (paper Figures 3 and 4), "
          "lineitem SF10")
    base_counts, base_errs = phase_baselines(data)
    launches = add_counts(launches, base_counts)
    del data
    torch.cuda.empty_cache()
    # -- phase 20 --
    print(f"phase 20: MISS for the LM at full width ({EVAL_ARCH}), mixture "
          f"statistics, router load")
    lm20_counts, lm20_err = phase_miss_lm()
    launches = add_counts(launches, lm20_counts)
    # -- phase 21 --
    print("phase 21: the dense variants (sliding window, QK norm, untied "
          "head)")
    window_row, dense_counts = phase_dense_variants()
    launches = add_counts(launches, dense_counts)
    # -- phase 22 --
    print("phase 22: the MoE, RWKV6 and Mamba-hybrid decoders")
    fam_rows, fam_counts, fam_err, fam_pb_err = phase_families()
    launches = add_counts(launches, fam_counts)
    # -- phase 23 --
    print("phase 23: cross-attention, the encoder-decoder stack and the "
          "vision layers")
    x_rows, x_counts, x_err, x_launches = phase_cross()
    launches = add_counts(launches, x_counts)
    # -- phase 24 --
    print(f"phase 24: training: every arch's train step card vs cpu, "
          f"{TRAIN_ARCH} at full width through launch.train, checkpoint "
          f"resume, microbatches, int8 gradient compression")
    train_row = phase_train(card)
    print(json.dumps({"train": train_row}))
    print(f"  launches on the main paths (phases 6 + 7 + 12 + 14 + 16 + 18 + "
          f"19 + 20 + 21 + 22 + 23): {launches}")
    print(f"  result rows: Poisson bootstrap at the solo serve's most used "
          f"width w={w_main}; segment bootstrap at L={L_main}; aggregate over "
          f"the whole table GROUP BY TAX with a random mask (phase 4; its "
          f"launches are AQPEngine.exact's in phase 14); decode attention at "
          f"the LM serve's shape; total "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "poisson_bootstrap", "route": "cuda",
        "source": "src/repro_torch/csrc/poisson_bootstrap.cu",
        "replaces": "src/repro/kernels/poisson_bootstrap/kernel.py:51",
        "launches": launches["poisson_bootstrap"],
        "max_abs_err": max(pb_err, base_errs["poisson_bootstrap"], lm20_err,
                           fam_pb_err),
        "ms": r["ms"], "graph_ms": r["graph_ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": None, "bound_30ops_ms": r["bound_30ops_ms"],
        "ops_per_pair": pb_pp, "stacked_w8192_graph_ms":
            pb_rows["stacked w=8192"]["graph_ms"], "serve_replay": pb_serve,
        "host_serve_launches": host_counts["poisson_bootstrap"],
        "baselines_launches": base_counts["poisson_bootstrap"],
        "miss_lm_launches": lm20_counts["poisson_bootstrap"],
        "family_launches": fam_counts["poisson_bootstrap"],
        "warm_slo_launches": {
            "phase15": warm_cpu_counts["poisson_bootstrap"],
            "phase16": serve16["poisson_bootstrap"]},
        "sharded_launches": {
            "phase17": shard_cpu_counts["poisson_bootstrap"],
            "phase17_mesh_rank0": mesh_rank_launches,
            "phase18": shard_counts["poisson_bootstrap"]}},
        {
        "name": "segment_bootstrap", "route": "cuda",
        "source": "src/repro_torch/csrc/segment_agg.cu",
        "replaces": "src/repro/kernels/segment_agg/kernel.py:66",
        "launches": launches["segment_bootstrap"], "max_abs_err": seg_err,
        "ms": s["ms"], "graph_ms": s["graph_ms"],
        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
        "bound_by": s["bound_by"], "library_ms": None,
        "bound_30ops_ms": s["bound_30ops_ms"], "ops_per_pair": seg_pp,
        "serve_streams_graph_ms": {k: v["graph_ms"]
                                   for k, v in seg_serve.items()},
        "serve_replay": seg_replay, "warm_slo_launches": {
            "phase15": warm_cpu_counts["segment_bootstrap"],
            "phase16": serve16["segment_bootstrap"]},
        "sharded_launches": {
            "phase17": shard_cpu_counts["segment_bootstrap"],
            "phase18": shard_counts["segment_bootstrap"]}}, {
        "name": "segment_aggregate", "route": "cuda",
        "source": "src/repro_torch/csrc/segment_agg.cu",
        "replaces": "src/repro/kernels/segment_agg/kernel.py:37",
        "launches": launches["segment_aggregate"],
        "max_abs_err": max(agg["max_abs_err"],
                           base_errs["segment_aggregate"]),
        "ms": agg["ms"], "graph_ms": agg["graph_ms"],
        "plain_ms": agg["plain_ms"],
        "bound_ms": agg["bound_ms"], "bound_by": "bytes",
        "library_ms": agg["library_ms"],
        "host_serve_launches": host_counts["segment_aggregate"],
        "baselines_launches": base_counts["segment_aggregate"],
        "exact_ms": host_agg["exact_ms"],
        "exact_graph_ms": host_agg["exact_graph_ms"],
        "exact_call_wall_ms": host_agg["exact_wall_ms"],
        "sharded_launches": {
            "phase17": shard_cpu_counts["segment_aggregate"],
            "phase18": shard_counts["segment_aggregate"]}}, {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:33",
        "launches": launches["decode_attention"],
        "max_abs_err": max(da["max_abs_err"], window_row["max_abs_err"],
                           fam_err, x_err),
        "ms": da["ms"],
        "plain_ms": da["plain_ms"], "bound_ms": da["bound_ms"],
        "bound_by": da["bound_by"], "library_ms": da["library_ms"],
        "dense_variant_launches": dense_counts["decode_attention"],
        "family_launches": fam_counts["decode_attention"],
        "window_h2o": window_row, "granite": fam_rows["granite"],
        "deepseek": fam_rows["deepseek"],
        "cross_decoder_launches": x_launches, **x_rows}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
