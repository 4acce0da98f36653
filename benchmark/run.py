"""Run one cell of the benchmark of nbody_tpu_torch once, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cells are the `workloads` of BENCHMARK.json.  Progress goes to
standard error; the last line of standard output is one JSON object
with `correct`, `attempted`, `failed` (frames), `metrics` (the cell's
end-to-end metrics, or with --trace 1 its per-layer metrics), `device`,
with --trace 1 `breakdown`, and last `checks`: each number that decides
`correct` beside its limit, which also end standard error.  Without a
CUDA card, or if a module of JAX or of the JAX package is loaded, the
run fails and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "benchmark" / ".cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's kernel caches at fixed paths inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    # the repository root, in place of this script's folder
    sys.path[0] = str(ROOT)
    from benchmark import harness

    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"[bench] forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"[check] correct {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
