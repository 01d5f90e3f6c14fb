"""Calibrate the Re-ID distance threshold for a descriptor backend.

Counterpart of the JAX package's `apps/calibrate_reid.py`, with the same
flags plus `--device`. The reference's Re-ID rate counts generated views
whose dlib descriptor distance to ground truth is < 0.6
(eval/eval_2d_facescape.py:97-108), a threshold calibrated for dlib's
ResNet. The in-repo backend is IR-SE50 (`eval/irse.py`), whose distance
scale differs, so absolute Re-ID rates are only comparable after
re-calibration. This CLI measures same-identity vs different-identity
descriptor distance distributions on a multi-view dataset tree and reports
the equal-error-rate threshold to pass as ``eval_2d --reid_threshold``.

    python -m morphablediffusion_torch.apps.calibrate_reid \\
        --data_dir /tmp/synth/data --reid_weights model_ir_se50.pth \\
        --out runs/reid_calibration.json [--device cpu]

Pair construction: same = two random views (possibly different expressions)
of one subject; different = views of two subjects. ``--pairing same_view``
holds the CAMERA fixed within each pair (same = one subject, same view id,
different expression; different = two subjects, same view id): the
deployed metric's geometry, since eval_2d compares each generated view
against ground truth at the same camera. With ``--embedder landmark`` the
descriptor is the spatially-pooled penultimate feature map of a trained
landmark net (``--weights``, the port's `.pt`): the output of its last head
GroupNorm before SiLU (`LandmarkNet.trunk`), a weights-free fallback that
demonstrates the calibration pipeline end to end on synthetic data.

Both embedders run on the CUDA card and raise without one unless `--device
cpu` is given. Outputs a JSON artifact: per-class distance stats, the EER
threshold, the separation (d-prime), and a text histogram; add ``--plot
out.png`` for a matplotlib figure when matplotlib is installed.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def _collect_views(data_dir: Path):
    """{subject: [image paths]} for facescape-layout trees
    (<subject>/<exp>/view_*/rgba_colorcalib.png or any nested pngs)."""
    subjects = {}
    for sub in sorted(p for p in data_dir.iterdir() if p.is_dir()):
        imgs = sorted(sub.rglob("*.png"))
        if imgs:
            subjects[sub.name] = imgs
    if len(subjects) < 2:
        raise SystemExit(f"need >= 2 subject dirs under {data_dir}")
    return subjects


def _load(paths, size):
    from morphablediffusion_torch.data.common import load_rgba_white

    return np.stack([(load_rgba_white(p, size) + 1.0) / 2.0 for p in paths]).astype(np.float32)


def _irse_descriptors(imgs, weights: str, device):
    from morphablediffusion_torch.eval.irse import face_descriptors, load_irse50, seeded_irse50

    if weights:
        net = load_irse50(weights, device)
    else:
        print("# WARNING: no --reid_weights; IR-SE50 at RANDOM init: the "
              "procedure is demonstrated but the threshold is only valid "
              "for these weights")
        net = seeded_irse50(0).to(device)
    return face_descriptors(imgs, net)


def _landmark_descriptors(imgs, weights: str, device):
    """Penultimate-feature descriptor from a trained landmark net: spatially
    pooled pre-head activations, l2-normalized. Weights-free alternative for
    synthetic calibration runs."""
    import torch

    from morphablediffusion_torch.eval.keypoint_net import load_params

    net = load_params(weights, device)
    # the last head GroupNorm's output before SiLU: unlike the landmark
    # COORDS, which are near-identical across identities by design, these
    # activations encode the appearance the net used to find the landmarks,
    # which is where identity lives. Spatially pooled and l2-normalized.
    with torch.no_grad():
        x = torch.as_tensor(imgs, device=device).permute(0, 3, 1, 2).contiguous()
        d = net.trunk(x).mean((2, 3)).float().cpu().numpy()  # (B, C)
    d = d - d.mean(axis=1, keepdims=True)
    return d / (np.linalg.norm(d, axis=1, keepdims=True) + 1e-9)


def eer_threshold(same: np.ndarray, diff: np.ndarray):
    """Threshold where false-reject rate == false-accept rate."""
    grid = np.unique(np.concatenate([same, diff]))
    frr = np.asarray([(same >= t).mean() for t in grid])
    far = np.asarray([(diff < t).mean() for t in grid])
    i = int(np.argmin(np.abs(frr - far)))
    return float(grid[i]), float((frr[i] + far[i]) / 2)


def main(argv=None):
    """Calibrate and write the artifact; returns the result dict."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--embedder", type=str, default="irse",
                        choices=["irse", "landmark"])
    parser.add_argument("--reid_weights", type=str, default="")
    parser.add_argument("--weights", type=str, default="",
                        help="landmark-net weights for --embedder landmark")
    parser.add_argument("--pairs", type=int, default=200)
    parser.add_argument("--pairing", type=str, default="any_view",
                        choices=["any_view", "same_view"])
    parser.add_argument("--image_size", type=int, default=112)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--plot", type=str, default="")
    parser.add_argument("--device", type=str, default=None,
                        help="default: the CUDA card (raises without one); 'cpu' "
                             "runs on the CPU")
    flags = parser.parse_args(argv)

    from morphablediffusion_torch.utils import resolve_device

    device = resolve_device(flags.device)
    rng = np.random.default_rng(flags.seed)
    subjects = _collect_views(Path(flags.data_dir))
    names = sorted(subjects)

    # sample image paths for pairs
    def pick(sub):
        paths = subjects[sub]
        return paths[rng.integers(len(paths))]

    same_pairs, diff_pairs = [], []
    if flags.pairing == "same_view":
        # {subject: {view_dir_name: [paths across expressions]}}
        by_view = {
            s: {} for s in names
        }
        for s in names:
            for p in subjects[s]:
                by_view[s].setdefault(p.parent.name, []).append(p)
        # only subjects with at least one multi-image view can supply a
        # same-identity pair; a subject sampled without one would crash on
        # rng.integers(0)
        multi = [s for s in names
                 if any(len(ps) > 1 for ps in by_view[s].values())]
        if not multi:
            raise SystemExit(
                "--pairing same_view needs a subject with >1 image in one "
                "view directory (different expressions, same camera); none "
                f"found under {flags.data_dir}")
        for _ in range(flags.pairs):
            s = multi[rng.integers(len(multi))]
            views = [v for v, ps in by_view[s].items() if len(ps) > 1]
            v = views[rng.integers(len(views))]
            a, b = rng.choice(len(by_view[s][v]), size=2, replace=False)
            same_pairs.append((by_view[s][v][a], by_view[s][v][b]))
            # different-identity pair at a shared camera: resample subject
            # pairs until their view-id sets intersect
            for _attempt in range(64):
                s1, s2 = rng.choice(len(names), size=2, replace=False)
                shared = sorted(set(by_view[names[s1]]) & set(by_view[names[s2]]))
                if shared:
                    break
            else:
                raise SystemExit(
                    "--pairing same_view found no subject pair sharing a "
                    f"view id under {flags.data_dir}")
            v = shared[rng.integers(len(shared))]
            diff_pairs.append((
                by_view[names[s1]][v][rng.integers(len(by_view[names[s1]][v]))],
                by_view[names[s2]][v][rng.integers(len(by_view[names[s2]][v]))],
            ))
    else:
        for _ in range(flags.pairs):
            s = names[rng.integers(len(names))]
            a = pick(s)
            b = pick(s)
            while len(subjects[s]) > 1 and b == a:
                b = pick(s)
            same_pairs.append((a, b))
            s1, s2 = rng.choice(len(names), size=2, replace=False)
            diff_pairs.append((pick(names[s1]), pick(names[s2])))

    paths = sorted({p for ab in same_pairs + diff_pairs for p in ab})
    idx = {p: i for i, p in enumerate(paths)}
    imgs = _load(paths, flags.image_size)
    if flags.embedder == "irse":
        desc = _irse_descriptors(imgs, flags.reid_weights, device)
    else:
        desc = _landmark_descriptors(imgs, flags.weights, device)

    dist = lambda ab: float(np.linalg.norm(desc[idx[ab[0]]] - desc[idx[ab[1]]]))
    same = np.asarray([dist(ab) for ab in same_pairs])
    diff = np.asarray([dist(ab) for ab in diff_pairs])

    thresh, eer = eer_threshold(same, diff)
    pooled_sd = np.sqrt((same.var() + diff.var()) / 2) + 1e-9
    dprime = float((diff.mean() - same.mean()) / pooled_sd)

    lo, hi = float(min(same.min(), diff.min())), float(max(same.max(), diff.max()))
    bins = np.linspace(lo, hi, 25)
    hist_same, _ = np.histogram(same, bins)
    hist_diff, _ = np.histogram(diff, bins)

    result = {
        "embedder": flags.embedder,
        "pairing": flags.pairing,
        "weights": flags.reid_weights or flags.weights or "RANDOM-INIT",
        "n_pairs": flags.pairs,
        "same": {"mean": float(same.mean()), "std": float(same.std())},
        "diff": {"mean": float(diff.mean()), "std": float(diff.std())},
        "eer_threshold": thresh,
        "eer": eer,
        "d_prime": dprime,
        "hist_bins": bins.tolist(),
        "hist_same": hist_same.tolist(),
        "hist_diff": hist_diff.tolist(),
    }
    out = Path(flags.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))

    scale = max(1, max(hist_same.max(), hist_diff.max()) // 40 + 1)
    print(f"same-identity  mean {same.mean():.4f} +- {same.std():.4f}")
    print(f"diff-identity  mean {diff.mean():.4f} +- {diff.std():.4f}")
    print(f"EER threshold {thresh:.4f}  (EER {eer:.3f}, d' {dprime:.2f})")
    print("distance histogram  [#=same  o=diff]")
    for i in range(len(bins) - 1):
        print(f"  {bins[i]:7.3f} {'#' * (hist_same[i] // scale)}"
              f"{'o' * (hist_diff[i] // scale)}")
    print(f"-> pass `--reid_threshold {thresh:.4f}` to eval_2d "
          f"(artifact: {out})")

    if flags.plot:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(6, 3.5))
            c = (bins[:-1] + bins[1:]) / 2
            w = bins[1] - bins[0]
            ax.bar(c, hist_same, width=w, alpha=0.6, label="same identity")
            ax.bar(c, hist_diff, width=w, alpha=0.6, label="different identity")
            ax.axvline(thresh, color="k", ls="--",
                       label=f"EER threshold {thresh:.3f}")
            ax.set_xlabel("descriptor distance")
            ax.set_ylabel("pairs")
            ax.legend()
            fig.tight_layout()
            fig.savefig(flags.plot, dpi=120)
            print(f"plot -> {flags.plot}")
        except ImportError:
            print("matplotlib not installed; skipped --plot")
    return result


if __name__ == "__main__":
    main()
