"""Pick 68 landmark vertex ids for the synthetic FaceScape dataset.

The PyTorch port's own copy of the repository's
`tools/make_synthetic_landmarks.py`: the same file for the same flags. The
synthetic meshes (`tools/make_synthetic_facescape.py`) share one
fibonacci-sphere topology, so a fixed set of vertex indices is a consistent
68-landmark annotation across every subject and expression, the synthetic
stand-in for the reference's mmpose 68-point facial landmarks. Landmarks are
drawn from the camera-facing (+z) hemisphere so most views see most points,
spread evenly in azimuth like a face's landmark ring.

    python -m morphablediffusion_torch.tools.make_synthetic_landmarks \\
        --out /tmp/synth/landmarks.json [--mesh_vertices 1600 --count 68]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from morphablediffusion_torch.tools.make_synthetic_facescape import fibonacci_sphere


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True)
    ap.add_argument("--mesh_vertices", type=int, default=1600)
    ap.add_argument("--count", type=int, default=68)
    args = ap.parse_args(argv)

    u = fibonacci_sphere(args.mesh_vertices)
    front = np.where(u[:, 2] > 0.3)[0]
    azim = np.arctan2(u[front, 0], u[front, 2])
    order = front[np.argsort(azim)]
    sel = order[np.linspace(0, len(order) - 1, args.count).round().astype(int)]
    Path(args.out).write_text(json.dumps([int(i) for i in sel]))
    print(f"{args.count} landmark vertex ids -> {args.out}")


if __name__ == "__main__":
    main()
