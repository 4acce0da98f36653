"""The readings that a cell's limits are set from: for each seed, a short
window at the cell's own size and load, the program's numbers of the
check, and on the control seeds the control's numbers read at the same
frames (benchmark/reference/check.py).  One process, one Simulation:
the graphs are captured once and replayed for every seed.  The
benchmark's own runs never run this.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,...
        [--control-seeds 1,2,3] [--seconds 3] [--out FILE]

One JSON line a seed on standard output (and in FILE):
{"seed", "program": {number: worst over the frames},
"force_err_p50_segment", "control": {...} on the control seeds}.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    import torch

    from benchmark import harness
    from nbody_tpu_torch.models.simulation import Simulation

    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    dev = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    cfg = harness.sim_config(cell, dev)
    tr = cell.traffic
    sim = Simulation(cfg, device=dev)
    out = open(args.out, "a") if args.out else None
    for seed in seeds:
        t0 = time.perf_counter()
        start = harness.start_state(cell, cfg, seed, dev)
        sim.run(start, tr["segment_steps"], lambda *_: None,
                callback_every=tr["frame_steps"])
        win = harness.run_window(sim, start, cell, seed, args.seconds)
        torch.cuda.synchronize(dev)
        rec = {"seed": seed, "workload": args.workload,
               "frames": len(win.ends)}
        chk = harness.check_window(win, cell, cfg, seed, dev)
        rec["program"] = chk["numbers"]
        rec["force_err_p50_segment"] = chk["force_err_p50"]
        if seed in controls:
            rec["control"] = harness.check_window(
                win, cell, cfg, seed, dev, control=True)["numbers"]
        rec["seconds"] = time.perf_counter() - t0
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del win, start
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
