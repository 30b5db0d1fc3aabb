#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs a CUDA
card and exits non-zero without one.  Phases, in order; any failure exits
non-zero and nothing falls back to the CPU:

1. card and build: print the card's name and power limit, build the
   Poisson-bootstrap kernel from ``src/repro_torch/csrc`` with nvcc;
2. kernel against its plain PyTorch version on the card at the serve
   phase's tier shape (4 lanes x 4 groups, B = 300) on every rung of the
   width ladder: rtol 1e-5 (bit-exact expected: same summation order),
   gated == ungated and narrow == wide bucket bit-exact; kernel and plain
   times from CUDA events against the kernel's operation bound;
3. the card against the CPU at the CPU tests' size: ``fused_l2miss`` and a
   small ``LanePool`` with the same seeds; integer trajectories exact,
   theta rtol 1e-5, error rtol 1e-4, beta norm-wise rtol 1e-4; a pool lane
   equal to its solo run bit for bit on the card;
4. serve at real size: TPC-H ``lineitem`` at scale factor 10 (60 M rows of
   f32 EXTENDEDPRICE resident on the card, GROUP BY SHIPINSTRUCT: 4 groups),
   an ``AQPSession`` with the reference defaults (B=300, n_min=1000,
   n_max=2000, max_iters=24, n_cap=65536, forced POOL with 8 lanes in 2
   tiers) answers 16 avg/sum/var/std requests, then one singleton on the
   LOOP route; every request must succeed, 14 of 16 must lie within epsilon
   of the exact answer, and the kernel must have launched;
5. the result lines: a JSON object of kernel measurements, then
   ``{"ok": true, "device": {...}}`` as the last line.
"""
import collections
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

B = 300
N_CAP = 1 << 16
N_MAX = 2000
SERVE = dict(B=B, n_min=1000, n_max=N_MAX, max_iters=24, n_cap=N_CAP, seed=0)
OPS_PER_PAIR = 30       # integer ops per (slot, replicate): hash + ladder
INT32_LANES_PER_SM = 64
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


# ---------------------------------------------------------------------------
# phase 2: the kernel against its plain version
# ---------------------------------------------------------------------------

def phase_kernel(data, clock_hz: float):
    from repro_torch.core import keys, sampling
    from repro_torch.core.fused import bucket_ladder
    from repro_torch.kernels.poisson_bootstrap import ops, ref

    dev = data.values.device
    q, m = 4, data.num_groups
    rng = np.random.default_rng(11)
    starts, sizes = data.offsets[:-1], np.diff(data.offsets)
    # The tier's carried buffer: each lane's groups filled through its own
    # slot table from the resident table, as the serve phase fills them.
    buf = torch.stack([
        data.values[sampling.counter_slot_table(
            keys.prng_key(100 + lane), starts, sizes, N_CAP,
            device=dev).long(), 0] for lane in range(q)])      # (q, m, N_CAP)
    seeds = torch.as_tensor(rng.integers(0, 2**32, (q, m)), device=dev)
    act = torch.tensor([True, True, False, True], device=dev)[:, None]
    act = act.expand(q, m)
    rows = {}
    max_err = 0.0
    for w in bucket_ladder(N_CAP, N_MAX):
        hi = torch.as_tensor(rng.integers(w // 2, w + 1, (q, m)), device=dev)
        pos = torch.arange(w, device=dev)
        mask = (pos < hi[..., None]).to(torch.float32)
        x = buf[..., :w]                       # strided bucket slice
        got = ops.bootstrap_moments_masked(x, mask, seeds, B, lane_active=act)
        want = ref.bootstrap_moments_masked_ref(x, mask, seeds, B,
                                                lane_active=act)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        check(torch.allclose(got, want, rtol=1e-5, atol=0.0),
              f"kernel != plain at w={w} (max abs err {err})")
        ungated = ops.bootstrap_moments_masked(x, mask, seeds, B)
        check(torch.equal(ungated[act], got[act]), f"gated != ungated at {w}")
        check(not got[~act].any(), f"inactive groups not zero at {w}")
        wide = ops.bootstrap_moments_masked(
            buf, torch.nn.functional.pad(mask, (0, N_CAP - w)), seeds, B,
            lane_active=act)
        check(torch.equal(wide, got), f"narrow != wide bucket at w={w}")
        k_ms = cuda_ms(lambda: ops.bootstrap_moments_masked(
            x, mask, seeds, B, lane_active=act), reps=20, rounds=5)
        p_ms = cuda_ms(lambda: ref.bootstrap_moments_masked_ref(
            x, mask, seeds, B, lane_active=act), reps=1, rounds=3)
        pairs = int((mask * act[..., None]).sum().item()) * B
        ops_ms = pairs * OPS_PER_PAIR / (
            H100_SMS * INT32_LANES_PER_SM * clock_hz) * 1e3
        n_bytes = 2 * q * m * w * 4 + q * m * (8 + 4) + q * m * B * 5 * 4
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        rows[w] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=max(ops_ms, bytes_ms),
                       bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                       pairs=pairs, exact=torch.equal(got, want))
        print(f"  w={w:6d} pairs={pairs:10d} kernel {k_ms:.4f} ms  plain "
              f"{p_ms:.3f} ms  bound {rows[w]['bound_ms']:.4f} ms "
              f"({rows[w]['bound_by']})  bit-exact={rows[w]['exact']}")
    print("  library: no single PyTorch call computes Poisson-bootstrap "
          "moment sums with counter-hash weights; no library yardstick")
    return rows, max_err


# ---------------------------------------------------------------------------
# phase 3: the card against the CPU at the CPU tests' size
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


# ---------------------------------------------------------------------------
# phase 4: serve at real size
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
    launch = ops.bootstrap_moments_masked

    def recording(x, *a, **k):          # host metadata only: no sync
        widths[x.shape[-1]] += 1
        return launch(x, *a, **k)

    sess = AQPSession(data, planner=Planner(mode=Route.POOL, pool_lanes=8),
                      **SERVE)
    check(sess.use_kernel, "the session did not select the CUDA kernel")
    ops.bootstrap_moments_masked = recording
    ops.counter.reset()
    t0 = time.perf_counter()
    for f, e in reqs:
        sess.submit(Request(query=Query(func=f, epsilon=e)))
    res = sess.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pool_launches = ops.counter.launches
    loop = AQPSession(data, **SERVE)          # auto planner: cold singleton
    ops.counter.reset()
    t1 = time.perf_counter()
    loop.submit(Request(query=Query(func="avg", epsilon=reqs[0][1])))
    (lres,) = loop.drain()
    loop_wall = time.perf_counter() - t1
    loop_launches = ops.counter.launches
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
    st = sess.stats()
    print(f"  serve: wall {wall:.3f} s, latency p50 {np.percentile(lat, 50):.2f}"
          f" ms p99 {np.percentile(lat, 99):.2f} ms, dispatches "
          f"{st['fused_dispatches']}, pool ticks {st['pool']['ticks']}, rows "
          f"touched {st['rows_touched']}, kernel launches {pool_launches}, "
          f"{within}/16 within epsilon")
    print(f"  loop singleton: wall {loop_wall:.3f} s, n={lres.n.tolist()}, "
          f"kernel launches {loop_launches}")
    print(f"  launches by bucket width: {dict(sorted(widths.items()))}")
    return pool_launches + loop_launches, widths


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: a CUDA card is required")
    from repro_torch.data import make_lineitem
    from repro_torch.kernels.poisson_bootstrap import ops

    t_start = time.perf_counter()
    # -- phase 1 --
    card = nvidia_smi("name,power.limit")
    print(card)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}; max SM clock {clock_mhz:.0f} MHz")
    t = time.perf_counter()
    ops.build(verbose=True)
    ops.library()
    print(f"phase 1: kernel built in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    data, _ = make_lineitem(scale_factor=10, group_by="shipinstruct",
                            device="cuda")
    torch.cuda.synchronize()
    print(f"lineitem SF10: {data.values.shape[0]} rows, groups "
          f"{np.diff(data.offsets).tolist()}, built in "
          f"{time.perf_counter() - t:.1f} s")
    # -- phase 2 --
    print("phase 2: kernel vs plain version on the card (tier 4x4, B=300)")
    rows, max_err = phase_kernel(data, clock_mhz * 1e6)
    # -- phase 3 --
    print("phase 3: card vs cpu at the CPU tests' size")
    phase_card_vs_cpu()
    # -- phase 4 --
    print("phase 4: serve lineitem SF10 on the card")
    launches, widths = phase_serve(data)
    w_main = widths.most_common(1)[0][0]
    r = rows[w_main]
    print(f"phase 5: kernel row at the serve phase's most used width "
          f"w={w_main}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "poisson_bootstrap", "route": "cuda",
        "source": "src/repro_torch/csrc/poisson_bootstrap.cu",
        "replaces": "src/repro/kernels/poisson_bootstrap/kernel.py:51",
        "launches": launches, "max_abs_err": max_err, "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
