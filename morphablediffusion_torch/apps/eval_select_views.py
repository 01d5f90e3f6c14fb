"""Eval stage 1: deterministic input/target view selection for FaceScape.

The PyTorch port's own copy of the JAX package's
`apps/eval_select_views.py` (numpy and scipy only; it runs on the host).
Parity target: eval/get_input_target_views_facescape.py: input view = the
min-azimuth frontal view (azimuth & elevation < 15 deg, roll not flipped);
target views = all azimuth < 90 deg non-flipped views. The output JSON
{subject: {expression: {input_view, target_views}}} is byte-compatible.

    python -m morphablediffusion_torch.apps.eval_select_views \\
        --data_dir <facescape_root> --output eval/facescape_input_target_views.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
from scipy.spatial.transform import Rotation as Rot

TEST_SUBJECTS = [str(i) for i in [122, 212] + list(range(326, 360))]
TEST_EXPS = [str(i).zfill(2) for i in range(1, 21)]


def _upright(camera_dict, view):
    RT = np.asarray(camera_dict[view]["extrinsics"])
    return abs(Rot.from_matrix(RT[:3, :3]).as_euler("xyz", True)[-1]) <= 90


def select_views(data_dir: str, subjects=None, expressions=None):
    metadata = {}
    for subject in (subjects or TEST_SUBJECTS):
        metadata[subject] = {}
        for exp in (expressions or TEST_EXPS):
            metadata[subject][exp] = {}
            d = Path(data_dir) / subject / exp
            if not list(d.glob("view_*")):
                continue
            camera_dict = json.loads((d / "cameras.json").read_text())
            inputs = sorted(
                (camera_dict[v]["angles"]["azimuth"], v)
                for v in camera_dict
                if camera_dict[v]["angles"]["azimuth"] < 15
                and camera_dict[v]["angles"]["elevation"] < 15
                and (d / f"view_{str(v).zfill(5)}").is_dir()
                and _upright(camera_dict, v)
            )
            targets = [
                v for v in camera_dict
                if camera_dict[v]["angles"]["azimuth"] < 90
                and (d / f"view_{str(v).zfill(5)}").is_dir()
                and _upright(camera_dict, v)
            ]
            metadata[subject][exp]["input_view"] = inputs[0][1]
            metadata[subject][exp]["target_views"] = targets
    return metadata


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--output", type=str,
                        default="./eval/facescape_input_target_views.json")
    parser.add_argument("--subjects", type=str, nargs="*", default=None,
                        help="override the reference test-subject list "
                             "(e.g. held-out synthetic subjects)")
    parser.add_argument("--expressions", type=str, nargs="*", default=None)
    flags = parser.parse_args(argv)
    metadata = select_views(flags.data_dir, flags.subjects, flags.expressions)
    Path(flags.output).parent.mkdir(parents=True, exist_ok=True)
    Path(flags.output).write_text(json.dumps(metadata))
    print(f"wrote {flags.output}")


if __name__ == "__main__":
    main()
