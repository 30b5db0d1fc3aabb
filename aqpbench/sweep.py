"""Find the highest Poisson rate an open-loop cell sustains, once, on the card.

    python3 aqpbench/sweep.py --workload <open-loop cell> --seed <n> \
        --seconds <s> --rates 16 24 32 ...

One table serves every rate; each rate gets a fresh session, warmed up at
that rate as a run of the cell is, then ``--seconds`` of arrivals and a
drain.  A rate is sustained when the window's answers keep up with its
arrivals (at least 95 %) and the requests still in flight at its close are
fewer than a second's arrivals.  The cell's mix then runs at about four
fifths of the highest sustained rate.
"""
import time

T_START = time.perf_counter()

import argparse                                             # noqa: E402
import json                                                 # noqa: E402
import sys                                                  # noqa: E402
from pathlib import Path                                    # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)

    import dataclasses

    import numpy as np
    import torch
    from aqpbench.cell import load_cell
    from aqpbench.harness import (GRACE_S, drive, make_data, make_session,
                                  prepare_kernels, settle, warm_up)

    cell = load_cell(args.workload)
    if cell.mix["loop"] != "open" or not torch.cuda.is_available():
        print("an open-loop cell on a CUDA card is needed", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    prepare_kernels(dev)
    data = make_data(cell, args.seed, dev)
    rows = []
    for i, rate in enumerate(args.rates):
        mix = dict(cell.mix, rate_per_s=rate)
        at_rate = dataclasses.replace(cell, mix=mix)
        traffic = cell.kind.make_traffic(at_rate, data, args.seed + i)
        client = cell.kind.Client(make_session(at_rate, data, args.seed + i),
                                  dev)
        warm_up(client, traffic, mix, GRACE_S)
        t0 = drive(client, traffic, mix, seconds=args.seconds,
                   first_stream=0)
        t_end = t0 + args.seconds
        backlog = len(client.outstanding)
        pool = client.sess.stats().get("pool", {})
        settle(client, GRACE_S)
        recs = client.records
        done = [r for r in recs if r["t_done"] is not None]
        lat = np.asarray([r["t_done"] - r["t_sent"] for r in done]) * 1e3
        inwin = sum(r["t_done"] <= t_end for r in done)
        row = {"rate": rate, "sent": len(recs), "answered_in_window": inwin,
               "in_flight_at_close": backlog,
               "answers_per_s": inwin / args.seconds,
               "p50_ms": float(np.percentile(lat, 50)),
               "p95_ms": float(np.percentile(lat, 95)),
               "lanes": pool.get("lanes"),
               "rebuilds": client.sess.pool_rebuilds,
               "sustained": bool(inwin >= 0.95 * len(recs)
                                 and backlog < rate)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    ok = [r["rate"] for r in rows if r["sustained"]]
    print(json.dumps({"knee": max(ok) if ok else None,
                      "device": torch.cuda.get_device_name(dev),
                      "setup_and_sweep_s": time.perf_counter() - T_START}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
