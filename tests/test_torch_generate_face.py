"""The port's generate_face CLI (`morphablediffusion_torch/apps/generate_face.py`)
and what it reads (`utils/mesh_io.py`, `preprocessing/matting.py`) against
the JAX package's on the CPU: the camera, alignment and batch helpers, the
strip and NeuS2 writers, the fine-conditioner auto-select, the mesh
readers, the native matting, and the CLI itself in a subprocess with
`--device cpu` on tests/test_cli_integration.py's tiny YAML and a tiny
reference checkpoint exported from JAX parameters."""

import json
import os
import struct
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from morphablediffusion_torch.apps import generate_face as T
from morphablediffusion_torch.preprocessing import matting as Tmat
from morphablediffusion_torch.utils import config as port_config
from morphablediffusion_torch.utils import mesh_io as Tio
from morphablediffusion_tpu.apps import generate_face as J
from morphablediffusion_tpu.preprocessing import matting as Jmat
from morphablediffusion_tpu.utils import mesh_io as Jio
from morphablediffusion_tpu.utils.config import Config as JConfig
from morphablediffusion_tpu.utils.config import load_config as jload_config
from tests.test_cli_integration import _tiny_inputs
from tests.tiny import tiny_batch
from tests.torch_parity import _init_inference, seeded_tree

REPO = Path(__file__).resolve().parents[1]


def test_cameras_alignment_and_batch_match_jax(rng):
    for n in (16, 2):
        for a, b in zip(T.generate_camera_trajectory(n), J.generate_camera_trajectory(n)):
            assert a.dtype == b.dtype == np.float64
            np.testing.assert_array_equal(a, b)
    verts = Jio.load_obj_vertices(REPO / "demo" / "mesh.obj")
    np.testing.assert_array_equal(T.align_mica_mesh(verts), J.align_mica_mesh(verts))
    img = rng.uniform(-1, 1, (64, 64, 3)).astype(np.float32)
    Ks, RTs = J.generate_camera_trajectory(2)
    ours = T.build_inference_batch(img, Ks, RTs, verts[:40], 64)
    ref = J.build_inference_batch(img, Ks, RTs, verts[:40], 64)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(ours[k], ref[k])


def test_real_trajectory_matches_jax(tmp_path, rng):
    cams = {"intrinsics": [rng.normal(size=(3, 3)) for _ in range(3)],
            "extrinsics": [rng.normal(size=(4, 4)) for _ in range(3)]}
    Tio.save_pickle(cams, tmp_path / "traj.pkl")
    Ks, RTs = T.real_camera_trajectory(tmp_path / "traj.pkl", 2)
    assert Ks.shape == (2, 4, 4) and RTs.shape == (2, 3, 4)
    np.testing.assert_array_equal(Ks[:, :3, :3], np.stack(cams["intrinsics"][:2]))
    np.testing.assert_array_equal(RTs, np.stack(cams["extrinsics"][:2])[:, :3])
    assert Jio.read_pickle(tmp_path / "traj.pkl").keys() == cams.keys()


def test_strip_and_neus2_match_jax(tmp_path, rng):
    img = rng.uniform(-1.1, 1.1, (64, 64, 3)).astype(np.float32)
    views = list(rng.uniform(-1.1, 1.1, (3, 64, 64, 3)).astype(np.float32))
    views[1][:20] = 1.0  # a white band, masked out of the NeuS2 alpha
    Ks, RTs = J.generate_camera_trajectory(3)
    for side, mod in (("port", T), ("jax", J)):
        mod.save_strip(img, views, tmp_path / f"{side}.png")
        mod.export_neus2(tmp_path / side, views, Ks, RTs)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port.png")),
                                  np.asarray(Image.open(tmp_path / "jax.png")))
    assert np.asarray(Image.open(tmp_path / "port.png")).shape == (64, 256, 3)
    assert (tmp_path / "port" / "transform.json").read_text() == \
        (tmp_path / "jax" / "transform.json").read_text()
    for i in range(3):
        a = np.asarray(Image.open(tmp_path / "port" / "images" / f"0{i}.png"))
        np.testing.assert_array_equal(
            a, np.asarray(Image.open(tmp_path / "jax" / "images" / f"0{i}.png")))
        assert a.shape == (64, 64, 4)
    assert (np.asarray(Image.open(tmp_path / "port" / "images" / "01.png"))[:20, :, 3]
            == 0).all()


def test_autoselect_fine_conditioner():
    """The three cases of tests/test_cli_integration.py, on the port's Config."""
    sd = {"spatial_volume.xyzc_net.conv0.0.weight": np.zeros(1)}
    verts = np.asarray([[0.0, 0.0, 0.0], [0.1, 0.2, 0.4]], np.float32)
    for mod, Config in ((T, port_config.Config), (J, JConfig)):
        cfg = Config()
        assert mod.autoselect_fine_conditioner(cfg.model, sd, verts)
        assert cfg.model.mesh_voxel_mode == "fine"
        assert cfg.model.fine_grid_shape == (84, 44, 24)
        cfg = Config()
        assert not mod.autoselect_fine_conditioner(cfg.model, {}, verts)
        assert cfg.model.mesh_voxel_mode == "coarse"
        cfg = Config()
        cfg.model.mesh_voxel_mode = "fine"
        shape = cfg.model.fine_grid_shape
        assert not mod.autoselect_fine_conditioner(cfg.model, sd, verts)
        assert cfg.model.fine_grid_shape == shape


def _binary_ply(path, verts, faces):
    """Binary little-endian PLY with an extra uchar vertex property."""
    head = (f"ply\nformat binary_little_endian 1.0\nelement vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\nproperty uchar red\n"
            f"element face {len(faces)}\nproperty list uchar int vertex_indices\n"
            "end_header\n").encode("ascii")
    body = b"".join(struct.pack("<fffB", *v, i % 256) for i, v in enumerate(verts))
    body += b"".join(struct.pack("<B3i", 3, *f) for f in faces)
    Path(path).write_bytes(head + body)


def test_mesh_readers_match_jax(tmp_path, rng):
    verts = rng.normal(size=(30, 3)).astype(np.float32)
    faces = rng.integers(0, 30, (20, 3)).astype(np.int32)
    Jio.save_ply(tmp_path / "ascii.ply", verts, faces)
    Tio.save_ply(tmp_path / "ascii_port.ply", verts, faces)
    assert (tmp_path / "ascii.ply").read_bytes() == (tmp_path / "ascii_port.ply").read_bytes()
    Jio.save_ply(tmp_path / "points.ply", verts)
    _binary_ply(tmp_path / "binary.ply", verts, faces)
    np.save(tmp_path / "verts.npy", verts.astype(np.float64))
    np.savetxt(tmp_path / "verts.txt", verts)
    artifact = REPO / "artifacts" / "real_photo" / "real_input_fitted_mesh.ply"
    paths = [tmp_path / n for n in ("ascii.ply", "points.ply", "binary.ply")] + [artifact]
    for path in paths:
        for fn in ("load_ply_vertices", "load_mesh_vertices"):
            np.testing.assert_array_equal(getattr(Tio, fn)(path), getattr(Jio, fn)(path))
        for a, b in zip(Tio.load_mesh(path), Jio.load_mesh(path)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(Tio.load_ply_vertices(tmp_path / "binary.ply"), verts)
    np.testing.assert_array_equal(Tio.load_ply(tmp_path / "binary.ply")[1], faces)
    assert Tio.load_ply_vertices(artifact).shape[0] > 1000
    for name in ("verts.npy", "verts.txt"):
        np.testing.assert_array_equal(Tio.load_mesh_vertices(tmp_path / name),
                                      Jio.load_mesh_vertices(tmp_path / name))
    obj = REPO / "demo" / "mesh.obj"
    for a, b in zip(Tio.load_mesh(obj), Jio.load_mesh(obj)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unsupported mesh format"):
        Tio.load_mesh_vertices(tmp_path / "mesh.stl")


def test_native_matting_matches_jax():
    """matte(..., 'native') bit-equal to JAX's on demo/real_input.png at
    1/4 of its size (the color models then run at full resolution)."""
    img = Image.open(REPO / "demo" / "real_input.png").convert("RGB")
    rgb = np.asarray(img.resize((img.width // 4, img.height // 4), Image.BICUBIC))
    ours = Tmat.matte(rgb, backend="native")
    ref = Jmat.matte(rgb, backend="native")
    assert ours.shape == rgb.shape[:2] + (4,) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, ref)
    assert 0 < (ours[..., 3] > 127).mean() < 1  # a subject and a background
    np.testing.assert_array_equal(Tmat.matte(rgb, "none"), Jmat.matte(rgb, "none"))


def test_cli_on_the_cpu(tmp_path):
    """The CLI in a subprocess with --device cpu on the tiny YAML, a tiny
    reference checkpoint exported from JAX parameters and a photo without
    alpha (native matting): the files, the import line JAX's importer gives
    for the same file, and the strip against the port's own sampler called
    directly with the same imported weights and seed."""
    from morphablediffusion_torch.models.diffusion import MorphableDiffusion
    from morphablediffusion_torch.sampling import SyncDDIMSampler
    from morphablediffusion_torch.weights import cast_for_serving
    from morphablediffusion_tpu.models.diffusion import MorphableDiffusion as JModel
    from morphablediffusion_tpu.utils import torch_import as jti

    cfg_path, img, mesh = _tiny_inputs(tmp_path)
    jcfg = jload_config(cfg_path)
    jmodel = JModel(jcfg.model)
    params = seeded_tree(jax.eval_shape(
        lambda b: jmodel.init(jax.random.key(0), b, method=_init_inference),
        tiny_batch(jcfg, with_targets=False)))
    ckpt = tmp_path / "ref.ckpt"
    jti.export_torch_checkpoint(params, str(ckpt), jcfg.model)
    _, j_report = jti.import_state_dict(jti.load_torch_state_dict(str(ckpt)), params,
                                        clip_layers=jcfg.model.clip.layers)

    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS=str(torch.get_num_threads()))
    r = subprocess.run(
        [sys.executable, "-m", "morphablediffusion_torch.apps.generate_face",
         "--input_img", str(img), "--mesh", str(mesh), "--cfg", str(cfg_path),
         "--ckpt", str(ckpt), "--output_dir", str(out), "--sample_steps", "2",
         "--prepare_neus2_data", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert (f"imported {j_report['filled']} tensors; 0 torch keys unused; 0 model paths "
            "unmatched") in r.stdout
    strip = np.asarray(Image.open(out / "in_mesh.png"))
    assert strip.shape == (64, 64 * 3, 3)
    neus = out / "neus2_data" / "in_mesh"
    assert len(json.loads((neus / "transform.json").read_text())["frames"]) == 2
    for i in range(2):
        assert np.asarray(Image.open(neus / "images" / f"0{i}.png")).shape == (64, 64, 4)

    # the same avatar from the port's sampler, called directly
    cfg = port_config.load_config(cfg_path)
    input_img = T.load_input_image(img, cfg.model.image_size)
    model = MorphableDiffusion(cfg.model, device="cpu")
    T.load_params(model, str(ckpt))
    cast_for_serving(model).eval()
    Ks, RTs = T.generate_camera_trajectory(cfg.model.view_num)
    verts = T.align_mica_mesh(Tio.load_mesh_vertices(mesh))
    batch = {k: torch.as_tensor(v) for k, v in
             T.build_inference_batch(input_img, Ks, RTs, verts, cfg.model.max_vertices).items()}
    images, _ = SyncDDIMSampler(model, sample_steps=2).sample(
        batch, 2.0, generator=torch.Generator("cpu").manual_seed(6033))
    direct = np.concatenate([T.to_uint8(input_img)] + [T.to_uint8(v) for v in
                                                       images[0].numpy()], axis=1)
    np.testing.assert_array_equal(strip, direct)


def test_cli_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.main(["--input_img", "x.png", "--mesh", "x.obj", "--ckpt", "random",
                "--output_dir", str(tmp_path)])
