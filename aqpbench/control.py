"""Run the control of a cell: the plain reference in the program's place at
twice the stated bound (``reference/control.py``), judged as a run is.

    python3 aqpbench/control.py --workload <name> --seeds <n> <n> ... \
        --requests K

For each seed it makes the cell's table, draws the first ``K`` requests of
the cell's traffic (as many as a run compares), answers them and prints
the numbers compared, each beside the cell's limit.  ``correct`` has to come out false.
"""
import argparse
import itertools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT)]


def specs(traffic, k: int):
    """The first ``k`` requests a run's window sends."""
    return list(itertools.islice(traffic.stream(0), k))


def control_run(cell, seed: int, k: int, device) -> dict:
    """The control's answers to the first ``k`` requests, judged by the
    cell's kind as a run's are."""
    import numpy as np
    import torch
    from aqpbench.data import lineitem
    from aqpbench.reference import control
    from aqpbench.traffic.generator import Traffic

    cfg = cell.config
    if cfg.get("kind", "tpch_lineitem") != "tpch_lineitem":
        raise SystemExit("the control answers tpch_lineitem cells")
    values, offsets = lineitem.make_table(cfg, seed, device)
    traffic = Traffic(cell.mix, cfg, np.diff(offsets), seed)
    reqs = specs(traffic, k)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63) ^ 0xC0)
    s = cfg["session"]
    answers = [control.control_answer(values, offsets, r, gen, B=s["B"],
                                      n_min=s["n_min"], n_cap=s["n_cap"])
               for r in reqs]
    del values
    judged = cell.kind.judge(cell, seed, device, list(zip(reqs, answers)),
                             None)
    return {"seed": seed, "requests": len(reqs),
            "correct": judged["correct"], "verdict": judged["verdict"],
            "checks": judged["checks"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--requests", type=int, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch
    from aqpbench.cell import load_cell

    cell = load_cell(args.workload)
    k = args.requests
    for seed in args.seeds:
        t = time.perf_counter()
        out = control_run(cell, seed, k, torch.device(args.device))
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
