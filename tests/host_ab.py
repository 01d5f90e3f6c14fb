"""Host-clock figures of `chip_smoke.py` on one tree, to compare two trees
in one call on a CUDA card (not a test; about 2 minutes a tree).

    python tests/host_ab.py [--root TREE]

TREE is a checkout whose `chip_smoke.py` and `morphablediffusion_torch/`
are timed (default: this one). It prints, by that tree's own code:

  * a FLAME fit at FLAME2020's widths (phase 11's inputs, the input
    photo's landmarks), fitted three times: LM iterations per second over
    the second and third fits' stages;
  * train_vae's 40 steps (phase 9b, which logs its ms a step);
  * two ranks sharing the card under gloo (phase 12 (b), (c)): each rank's
    avatar by CUDA events, its collectives' host ms a step, its train ms.

Run it on the two trees one after the other in one call, A B B A, and
compare the trees within that call only: the host's speed moves between
calls.
"""

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke
    from morphablediffusion_torch.fitting import fit
    from morphablediffusion_torch.ops import _cuda

    if not torch.cuda.is_available():
        raise SystemExit("host_ab: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    kernels = chip_smoke.all_kernels()
    _cuda.build(kernels)
    card = chip_smoke.card_line()
    print(f"host_ab {root}: {card}", flush=True)
    with tempfile.TemporaryDirectory(prefix="host_ab_") as tmp:
        tmp = Path(tmp)
        f, model, K, _ = chip_smoke.flame_inputs(tmp / "flame", device)
        lmk = np.load(f["input_landmarks"])
        stages = []
        with chip_smoke.lm_stages(stages):
            for _ in range(3):
                fit.fit_landmarks(model, lmk, K, fit.FitConfig())
        warm = stages[len(stages) // 3:]
        rate = sum(s["steps"] for s in warm) / sum(s["seconds"] for s in warm)
        print(f"host_ab fit: {rate:.1f} LM iterations/s over {len(warm)} stages, seconds "
              f"{[round(s['seconds'], 3) for s in warm]}", flush=True)
        del model
        chip_smoke.synthetic_tree(tmp / "synth")
        chip_smoke.vae_phase(tmp / "synth" / "data", tmp / "vae" / "vae.pt", device, kernels,
                             card)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = chip_smoke.spawn_ranks(chip_smoke.PAR_RANKS, "gloo", tmp)
        for r, res in enumerate(ranks):
            st = res["collectives"]
            print(f"host_ab rank {r}: avatar {res['avatar_s']:.3f} s (CUDA events), "
                  f"collectives {st['seconds'] * 1e3 / 50:.3f} ms a step (host clock), train "
                  f"{res['train_ms']:.1f} ms a step", flush=True)
        print(f"host_ab ranks: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
