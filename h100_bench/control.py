"""The control of the correctness check: readings that must come out as not
correct, for setting each limit between the program's readings and these.

    python3 h100_bench/control.py --workload <name> --seeds 1 2 3 [--seconds 1]

Serving: the program's own lower-precision path, W8A8 int8 convolutions
in the UNet (`cfg.model.unet.w8a8`), run through a short window and
checked as a run is; and, for the numbers that path does not touch, the
reference itself computed on float8 e4m3 operands (`reference.Quant`) put
in the program's place against the float32 reference, on the same call.
Training: the float8 reference's three steps against the float32
reference's, and the fault of half the batch left out (the loss the mean
over the other half), planted in the reference. Prints one JSON line per
seed. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def fp8_serving_readings(cfgdoc, traffic, seed, got, keep, device):
    """The float8 reference in the program's place, on the program's call."""
    import torch

    from h100_bench import check, reference

    tables = reference.ddim_tables(cfgdoc["sampler"]["steps"], cfgdoc["sampler"]["eta"])
    t_of = lambda s, B: torch.full((B,), int(tables[0][s]), dtype=torch.int64, device=device)
    reference.set_tf32(False)
    ref = check.served_reference(cfgdoc["model"], seed, device)
    want = check.reference_serving(ref, cfgdoc, got["batch"], got, keep, t_of)
    reference.Quant.mode = "fp8"
    try:
        low = check.reference_serving(ref, cfgdoc, got["batch"], got, keep, t_of)
    finally:
        reference.Quant.mode = None
    fake = {"prep": {"clip_embed": low["clip"], "x_input": low["x_input"]},
            "volume": low["volume"], "unet": {"out": low["unet"]}, "images": low["images"]}
    return check.gaps(fake, want, keep, lambda s: low["eps"][s])


def serving_control(cell, cfgdoc, traffic, e2e, per_layer, seed, seconds, device):
    from h100_bench import check, driver

    seen = {}
    real = check.serving

    def both(cfgdoc, traffic, seed, got, keep, device, limits):
        seen["w8a8"] = real(cfgdoc, traffic, seed, got, keep, device, limits)
        seen["fp8"] = check.with_limits(
            fp8_serving_readings(cfgdoc, traffic, seed, got, keep, device), limits)
        return seen["w8a8"]

    check.serving = both
    try:
        driver.run_cell(cell, cfgdoc, traffic, e2e, per_layer, seed, seconds, False, device,
                        time.perf_counter(), control="w8a8")
    finally:
        check.serving = real
    return seen


def training_control(cfgdoc, traffic, seed, device):
    """The float8 reference, and the fault of half the batch left out
    planted in the reference, each against the float32 reference."""
    from h100_bench import check, reference

    steps = traffic["check"]["steps"]
    want = check.reference_training(cfgdoc, traffic, seed, device, steps)
    half = check.reference_training(cfgdoc, traffic, seed, device, steps,
                                    rows=traffic["batch"] // 2)
    reference.Quant.mode = "fp8"
    try:
        low = check.reference_training(cfgdoc, traffic, seed, device, steps)
    finally:
        reference.Quant.mode = None
    return {"fp8": check.training_gaps(*low, *want),
            "half_batch": check.training_gaps(*half, *want)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from h100_bench.run import load_cell, set_cache_dirs

    set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell, cfgdoc, traffic, e2e, per_layer = load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        if traffic["kind"] == "train":
            out = training_control(cfgdoc, traffic, seed, torch.device("cuda"))
        else:
            out = serving_control(cell, cfgdoc, traffic, e2e, per_layer, seed, args.seconds,
                                  torch.device("cuda"))
        print(json.dumps({"workload": args.workload, "seed": seed, "control": out,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
