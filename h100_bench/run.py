"""One run of one benchmark cell of the PyTorch/CUDA port on the cards.

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Reads BENCHMARK.json at the root of the checkout, finds the cell's
configuration (`h100_bench/configs/<config>.json`), its traffic
(`h100_bench/traffic/<traffic>.json`) and, with --trace 1, its per-layer
metrics (`h100_bench/metrics/<metric>.py`) by name, makes the weights and
inputs from the seed, warms up the cell's own shapes, measures for
--seconds, checks the outputs against the plain reference
(`h100_bench/reference.py`) and prints one JSON line last on standard
output. Exits non-zero without a CUDA card (or fewer than the cell asks
for), and when JAX, flax or the JAX package is loaded once the window has
closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "morphablediffusion_tpu")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name, whole, is JAX's, flax's or the
    JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names if n.split(".")[0] in FORBIDDEN})


def load_cell(workload: str, bench_dir: Path = BENCH, root: Path = ROOT):
    """(cell, configuration file, traffic file, per-layer metric entries)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells are {sorted(cells)}")
    cell = cells[workload]
    cfg = json.loads((bench_dir / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{cell['traffic']}.json").read_text())
    per_layer = [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    return cell, cfg, traffic, e2e, per_layer


def set_cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths; no
    library loads flax on its own."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    set_cache_dirs()
    sys.path.insert(0, str(ROOT))
    cell, cfg, traffic, e2e, per_layer = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from h100_bench import driver

    result = driver.run_cell(cell, cfg, traffic, e2e, per_layer, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda"), T0)
    found = forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
