"""The port's synthetic FaceScape tool (step 1 of the from-scratch recipe)
writes the same bytes as the repository's `tools/make_synthetic_facescape.py`
for the same flags, at a tiny size, and its self-check reads the tree with
the port's FaceScapeDataset."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
FLAGS = ["--subjects", "2", "--expressions", "2", "--views", "4", "--image_size", "32",
         "--points", "2000", "--mesh_vertices", "60", "--seed", "3"]


def _files(root: Path):
    return {p.relative_to(root): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def test_port_tool_writes_the_same_files(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    runs = {"jax": [sys.executable, str(REPO / "tools" / "make_synthetic_facescape.py")],
            "port": [sys.executable, "-m",
                     "morphablediffusion_torch.tools.make_synthetic_facescape"]}
    for name, cmd in runs.items():
        r = subprocess.run(cmd + ["--out", str(tmp_path / name), *FLAGS], capture_output=True,
                           text=True, env=env, timeout=300, cwd=tmp_path)
        assert r.returncode == 0, r.stderr[-3000:]
        assert "dataset self-check ok" in r.stdout
    jax_files, port_files = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert len(port_files) == 2 * 2 * (4 + 2)  # 4 views, cameras.json and mesh.obj each
    assert port_files.keys() == jax_files.keys()
    for k in jax_files:
        assert port_files[k] == jax_files[k], k
