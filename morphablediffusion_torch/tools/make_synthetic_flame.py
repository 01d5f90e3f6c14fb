"""Write synthetic FLAME2020-format assets (no licensed data).

The PyTorch port's own copy of the repository's
`tools/make_synthetic_flame.py`: the same files for the same flags and seed.

Produces a `generic_model.pkl` + `landmark_embedding.npy` byte-compatible
with the real FLAME2020 release (the exact files `fitting/flame.py
load_model` and the reference's MICA/metrical-tracker consume:
the reference's third_party/metrical-tracker/flame/FLAME.py) but built from
random smooth bases on a sphere template — so the in-tree fitting stages of
`generate_face.sh` can be exercised end to end on a machine without the
FLAME registration download.

  python -m morphablediffusion_torch.tools.make_synthetic_flame \
      --out assets/FLAME2020_synth \
      [--vertices 512 --faces 1024 --seed 0]

writes <out>/generic_model.pkl and <out>/landmark_embedding.npy; pass them
to `apps/fit_face.py` as --flame and --lmk_embedding.
"""

import argparse
import pickle
from pathlib import Path

import numpy as np

N_JOINTS = 5  # FLAME: global, neck, jaw, left eye, right eye


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True)
    ap.add_argument("--vertices", type=int, default=512)
    ap.add_argument("--faces", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    V, F, J = args.vertices, args.faces, N_JOINTS

    u = rng.normal(size=(V, 3))
    v_template = (u / np.linalg.norm(u, axis=1, keepdims=True)) * 0.1

    # FLAME packs 300 shape + 100 expression columns into one (V, 3, 400)
    # tensor; smooth small bases keep the fitted meshes non-degenerate.
    # Each block gets a PCA-like DECAYING spectrum (the real model's
    # components are variance-ranked): with a flat spectrum, codes beyond
    # the ~136 landmark constraints are unidentifiable yet carry as much
    # geometry as the leading ones, making single-photo vertex recovery
    # impossible by construction — a property no real morphable model has.
    shapedirs = rng.normal(size=(V, 3, 400)).astype(np.float64) * 0.002
    decay = np.concatenate([
        (1.0 + np.arange(300)) ** -0.85, (1.0 + np.arange(100)) ** -0.85,
    ])
    shapedirs *= decay[None, None, :]
    posedirs = rng.normal(size=(V, 3, (J - 1) * 9)).astype(np.float64) * 5e-4

    jr = np.abs(rng.normal(size=(J, V)))
    jr /= jr.sum(axis=1, keepdims=True)
    joints = jr @ v_template
    d = np.linalg.norm(v_template[:, None] - joints[None], axis=-1)
    weights = np.exp(-d / 0.05)
    weights /= weights.sum(axis=1, keepdims=True)

    kintree = np.stack([np.asarray([4294967295, 0, 0, 1, 1], np.uint32),
                        np.arange(J, dtype=np.uint32)])
    faces = rng.integers(0, V, size=(F, 3)).astype(np.uint32)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "generic_model.pkl", "wb") as f:
        pickle.dump(
            {
                "v_template": v_template,
                "shapedirs": shapedirs,
                "posedirs": posedirs,
                "J_regressor": jr,
                "weights": weights,
                "kintree_table": kintree,
                "f": faces,
            },
            f, protocol=2,
        )

    # the real embedding: 51 static (ibug 18-68) + 79 yaw-bucketed rows of
    # the 17 jaw-contour points -> flame_landmarks yields contour-first 68.
    # The dynamic rows must vary SMOOTHLY with the yaw bucket like the
    # published table (the contour slides along the jaw): per-bucket random
    # rows make the fitting cost violently discontinuous in yaw — an
    # artifact no real asset has, and one that traps any local optimizer
    # (tools/eval_flame_fit.py converges exactly without it).
    lmk_faces = rng.integers(0, F, size=51).astype(np.int64)
    bary = rng.uniform(0.1, 1.0, size=(51, 3))
    bary /= bary.sum(axis=1, keepdims=True)
    dyn_faces = np.broadcast_to(
        rng.integers(0, F, size=17).astype(np.int64), (79, 17)
    ).copy()
    # barycentric coords glide between two random simplex points across the
    # yaw range (buckets 0..39 = 0..39 deg, 40..78 = -1..-39 deg)
    b0 = rng.uniform(0.1, 1.0, size=(17, 3))
    b1 = rng.uniform(0.1, 1.0, size=(17, 3))
    yaw_deg = np.concatenate([np.arange(0, 40), -np.arange(1, 40)])
    t = ((yaw_deg + 39) / 78.0)[:, None, None]
    dyn_bary = b0[None] * (1 - t) + b1[None] * t
    dyn_bary /= dyn_bary.sum(axis=2, keepdims=True)
    np.save(
        out / "landmark_embedding.npy",
        {
            "static_lmk_faces_idx": lmk_faces,
            "static_lmk_bary_coords": bary,
            "dynamic_lmk_faces_idx": dyn_faces,
            "dynamic_lmk_bary_coords": dyn_bary,
        },
        allow_pickle=True,
    )
    print(f"synthetic FLAME assets ({V} verts, {F} faces) -> {out}/")


if __name__ == "__main__":
    main()
