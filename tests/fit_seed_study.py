"""How phase 11's FLAME fit lands for a few ground-truth seeds, in both
packages, on the CPU (not a test: about a minute a seed).

    JAX_PLATFORMS=cpu python tests/fit_seed_study.py [--seeds 11 12 13 14 15]

For each seed, `chip_smoke.flame_inputs` draws the two photos' ground truth
and noisy landmarks at FLAME2020's widths; each photo is fitted at the
default 40 LM iterations a stage by the JAX package once and by the port
four times (the landmarks as drawn, then moved by 1e-3 px with three
seeds), and every mean reprojection error is printed, with the spread of
the port's fits (vertices of `fit_two_photos`, flat canonical parameters,
reprojection error) between the four. The LM paths part in fp32 (ROADMAP
Queue C): this shows where they land.
"""

import argparse
import itertools
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from morphablediffusion_torch.fitting import fit as Tfit  # noqa: E402
from morphablediffusion_tpu.fitting import fit as Jfit  # noqa: E402
from morphablediffusion_tpu.fitting import flame as Jflame  # noqa: E402


def rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def study(seed: int, root: Path):
    chip_smoke.FIT_SEED = seed
    f, model, K, _ = chip_smoke.flame_inputs(root, torch.device("cpu"))
    jm = Jflame.load_model(str(f["flame"]), str(f["lmk_embedding"]))
    lmk = {n: np.load(f[f"{n}_landmarks"]) for n in ("input", "exp")}
    for n in lmk:
        print(f"seed {seed} {n}: JAX {Jfit.fit_landmarks(jm, lmk[n], K)[1]['mean_px_err']:.3f} px",
              flush=True)
    runs = []
    fit_landmarks = Tfit.fit_landmarks
    for k in range(4):
        moved = {n: l + (np.random.default_rng(k).normal(size=l.shape) * 1e-3 if k else 0)
                 for n, l in lmk.items()}
        params = []

        def recorded(*args, **kwargs):
            p, i = fit_landmarks(*args, **kwargs)
            params.append(np.concatenate([np.asarray(p[q]).reshape(-1) for q in Tfit.KEYS]))
            return p, i

        Tfit.fit_landmarks = recorded
        try:
            verts, info = Tfit.fit_two_photos(model, moved["input"], moved["exp"], K)
        finally:
            Tfit.fit_landmarks = fit_landmarks
        runs.append((verts, params, info))
        print(f"seed {seed} port, landmarks moved by {1e-3 if k else 0} px (draw {k}): input "
              f"{info['input_mean_px_err']:.3f} px, exp {info['exp_mean_px_err']:.3f} px",
              flush=True)
    spread = {"verts": 0.0, "params": 0.0, "px": 0.0}
    for (va, pa, ia), (vb, pb, ib) in itertools.combinations(runs, 2):
        spread["verts"] = max(spread["verts"], rel(va, vb))
        spread["params"] = max(spread["params"], rel(pa[0], pb[0]), rel(pa[1], pb[1]))
        spread["px"] = max(spread["px"], *(abs(ia[f"{n}_mean_px_err"] - ib[f"{n}_mean_px_err"])
                                           for n in ("input", "exp")))
    print(f"seed {seed} port spread over the four fits: "
          f"{', '.join(f'{k} {v:.3f}' for k, v in spread.items())}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", type=int, nargs="+", default=[11, 12, 13, 14, 15])
    args = ap.parse_args()
    torch.cuda.synchronize = lambda *a, **k: None  # flame_inputs times its steps
    for seed in args.seeds:
        with tempfile.TemporaryDirectory() as tmp:
            study(seed, Path(tmp))


if __name__ == "__main__":
    main()
