"""A copy of BENCHMARK.json and benchmark/ in a temporary directory, with
its cells cut to a size the CPU runs in seconds: the same files, only
the body count, the tile and the step counts made small."""

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SMALL = {"n": 4096, "force_tile": 128}
SMALL_TRAFFIC = {"segment_steps": 8, "frame_steps": 4, "trace_steps": 8,
                 "check_bodies": 512}


def copy(dst: Path) -> Path:
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    return dst


def small(dst: Path) -> Path:
    """copy() with every configuration and traffic mix cut to size."""
    copy(dst)
    for kind, over in (("configs", SMALL), ("traffic", SMALL_TRAFFIC)):
        for p in (dst / "benchmark" / kind).glob("*.json"):
            d = json.loads(p.read_text())
            d.update(over)
            p.write_text(json.dumps(d))
    return dst
