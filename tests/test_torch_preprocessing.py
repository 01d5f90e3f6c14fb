"""The port's host-side preprocessing against the JAX package's, on the CPU:

  * the rasterizer: the port builds `native/rasterizer.cpp` with g++ into
    `build/native/` (a hash of the source in the name) and raises when it
    cannot; its native z-buffer against its numpy plain version and the
    JAX package's (coverage equal but for pixels on a triangle's edge,
    depth 1e-5 relative), and `render_depth_cv` (1e-5 relative);
  * color calibration, FaceScape processing (helpers 1e-12, and
    `process_subject` on a tiny raw capture written here: cameras equal,
    calibrated RGBA within one level), the SMPL-X stats, the fan-out's
    process pool and the Blender script's bpy-free functions (equal).
"""

import json
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from morphablediffusion_torch.preprocessing import color_calib as Tcc
from morphablediffusion_torch.preprocessing import facescape_process as Tfp
from morphablediffusion_torch.preprocessing import fanout as Tfan
from morphablediffusion_torch.preprocessing import raster as Traster
from morphablediffusion_torch.preprocessing import thuman_blender as Tblend
from morphablediffusion_torch.preprocessing import thuman_smplx_scale as Tsmplx
from morphablediffusion_tpu.preprocessing import color_calib as Jcc
from morphablediffusion_tpu.preprocessing import facescape_process as Jfp
from morphablediffusion_tpu.preprocessing import fanout as Jfan
from morphablediffusion_tpu.preprocessing import raster as Jraster
from morphablediffusion_tpu.preprocessing import thuman_blender as Jblend
from morphablediffusion_tpu.preprocessing import thuman_smplx_scale as Jsmplx

REPO = Path(__file__).resolve().parents[1]
EYE_RT = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)


def random_px_mesh(rng, n=60, m=90, size=64):
    v = rng.uniform(-4, size + 4, (n, 3)).astype(np.float32)
    v[:, 2] = rng.uniform(0.5, 3.0, n)
    return v, rng.integers(0, n, (m, 3)).astype(np.int32)


def test_rasterizer_builds_from_source_and_matches_numpy_and_jax(rng):
    lib = Traster.build()
    assert lib.parent == Traster.ROOT / "build" / "native" and lib.exists()
    assert lib.name.startswith("librasterizer_") and lib == Traster.lib_path()
    v, f = random_px_mesh(rng)
    native = Traster.rasterize_depth_px(v, f, 64, 64)
    plain = Traster.rasterize_depth_numpy(v, f, 64, 64)
    np.testing.assert_array_equal(plain, Jraster._rasterize_depth_numpy(v, f, 64, 64))
    for other in (plain, Jraster.rasterize_depth_px(v, f, 64, 64)):
        covered = (native > 0) != (other > 0)
        assert covered.sum() <= 3  # pixels on a triangle's edge
        both = (native > 0) & (other > 0)
        np.testing.assert_allclose(native[both], other[both], rtol=1e-5)
    assert (native > 0).sum() > 500


def test_rasterizer_raises_without_its_library(tmp_path, monkeypatch):
    """No fallback: a compiler that fails leaves rasterize_depth_px raising."""
    monkeypatch.setattr(Traster, "_LIB", None)
    monkeypatch.setattr(Traster, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(Traster, "lib_path", lambda: tmp_path / "librasterizer_x.so")
    monkeypatch.setenv("CXX", "false")
    v, f = random_px_mesh(np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="failed"):
        Traster.rasterize_depth_px(v, f, 16, 16)


def square(z=2.0, half=0.5):
    v = np.asarray([[-half, -half, z], [half, -half, z], [half, half, z], [-half, half, z]])
    return v, np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)


def test_render_depth_cv_matches_jax():
    (v1, f1), (v2, f2) = square(2.0), square(1.0, 0.2)
    verts, faces = np.concatenate([v1, v2]), np.concatenate([f1, f2 + 4])
    K = np.asarray([[32.0, 0, 16], [0, 32.0, 16], [0, 0, 1]])
    got = Traster.render_depth_cv(verts, faces, K, EYE_RT, (32, 32))
    want = Jraster.render_depth_cv(verts, faces, K, EYE_RT, (32, 32))
    # the near square's diagonal runs through pixel centres: there the edge
    # test rounds either way (the prebuilt library the JAX package loads
    # uses FMA), and the far square shows through
    edge = ~np.isclose(got, want, rtol=1e-5)
    assert edge.sum() <= 4 and all(abs(y - x) <= 1 for y, x in zip(*np.nonzero(edge)))
    assert abs(got[16, 16] - 1.0) < 1e-4 and abs(got[16, 23] - 2.0) < 1e-4


def test_facescape_helpers_match_jax(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    rt = np.concatenate([q, rng.normal(size=(3, 1))], 1)[None]
    np.testing.assert_array_equal(Tfp.homogeneous(rt), Jfp.homogeneous(rt))
    h = Jfp.homogeneous(rt)
    np.testing.assert_allclose(Tfp.invert_rt(h), Jfp.invert_rt(h), atol=1e-12)
    for view in ([0.3, 0.9, 0.1], [-0.5, 0.7, -0.2]):
        r = EYE_RT.copy()
        r[2, :3] = view
        assert Tfp.camera_angles(r) == Jfp.camera_angles(r)
    mask = np.zeros((100, 120), bool)
    mask[30:70, 40:90] = True
    for side in (-1.0, 1.0):
        pose = np.eye(4)
        pose[0, 3] = side
        assert Tfp.side_aware_crop(mask, pose, 100, 120) == Jfp.side_aware_crop(
            mask, pose, 100, 120)
    colors = rng.uniform(0.1, 0.9, (300, 3))
    target = colors * 1.1 - 0.02 + rng.normal(0, 0.01, colors.shape)
    np.testing.assert_allclose(Tcc._fit_affine_correction(colors, target),
                               Jcc._fit_affine_correction(colors, target), atol=1e-12)


def grid(n=8, z=2.0, half=0.45):
    lin = np.linspace(-half, half, n)
    xx, yy = np.meshgrid(lin, lin)
    verts = np.stack([xx, yy, np.full_like(xx, z)], -1).reshape(-1, 3)
    faces = [[r * n + c, r * n + c + 1, r * n + c + n] for r in range(n - 1) for c in range(n - 1)]
    faces += [[r * n + c + 1, r * n + c + n + 1, r * n + c + n]
              for r in range(n - 1) for c in range(n - 1)]
    return verts, np.asarray(faces, np.int32)


def test_calibrate_colors_matches_jax(tmp_path):
    """Two views of a colored plane, one with a red cast: the calibrated
    views equal the JAX package's (within one level)."""
    verts, faces = grid()
    K = [[32.0, 0, 16], [0, 32.0, 16], [0, 0, 1]]
    base = np.full((32, 32, 4), 255, np.uint8)
    base[..., :3] = (128, 100, 80)
    base[:, :16, 1] = 120
    cast = base.copy()
    cast[..., 0] = np.clip(cast[..., 0].astype(int) + 40, 0, 255)
    for pkg in ("jax", "port"):
        cams = {}
        for i, img in ((0, base), (1, cast)):
            d = tmp_path / pkg / f"view_{i:05d}"
            d.mkdir(parents=True)
            Image.fromarray(img, "RGBA").save(d / "rgba.png")
            cams[str(i)] = dict(intrinsics=K, extrinsics=EYE_RT.tolist(), angles={})
        (tmp_path / pkg / "cameras.json").write_text(json.dumps(cams))
    Jcc.calibrate_colors(tmp_path / "jax", verts, faces)
    Tcc.calibrate_colors(tmp_path / "port", verts, faces)
    for i in (0, 1):
        name = f"view_{i:05d}/rgba_colorcalib.png"
        a = np.asarray(Image.open(tmp_path / "jax" / name), np.int16)
        b = np.asarray(Image.open(tmp_path / "port" / name), np.int16)
        assert np.abs(a - b).max() <= 1
    out = [np.asarray(Image.open(tmp_path / "port" / f"view_{i:05d}/rgba_colorcalib.png"))
           for i in (0, 1)]
    assert np.abs(out[0][..., :3].astype(int) - out[1][..., :3].astype(int)).mean() < 10


def look_at(eye):
    """cv world->cam (3, 4) looking at the origin with +z up."""
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd])
    return np.concatenate([R, (-R @ eye)[:, None]], 1)


def raw_capture(root: Path):
    """A FaceScape raw capture of subject 1, expression 1: two valid cameras
    in front of a plane mesh, 160 x 120 photos, Rt_scale_dict.json. The
    aligned (CAPSTUDIO, metres) scene is built first and mapped back to the
    raw (millimetre) frame."""
    F2C = Jfp.FACESCAPE_2_CAPSTUDIO
    lin = np.linspace(-0.08, 0.08, 9)
    xx, zz = np.meshgrid(lin, lin)
    verts = np.stack([xx, np.zeros_like(xx) + 0.01 * xx ** 2, zz], -1).reshape(-1, 3)
    faces = [[r * 9 + c, r * 9 + c + 9, r * 9 + c + 1] for r in range(8) for c in range(8)]
    faces += [[r * 9 + c + 1, r * 9 + c + 9, r * 9 + c + 10] for r in range(8) for c in range(8)]
    subject = root / "1"
    (subject / "1_neutral").mkdir(parents=True)
    with open(subject / "1_neutral.ply", "w") as f:
        f.write(f"ply\nformat ascii 1.0\nelement vertex {len(verts)}\nproperty float x\n"
                f"property float y\nproperty float z\nelement face {len(faces)}\n"
                "property list uchar int vertex_indices\nend_header\n")
        for v in verts @ F2C * 1000.0:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for t in faces:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")
    params, rng = {}, np.random.default_rng(0)
    for i, eye in enumerate(([0.1, -0.45, 0.02], [-0.15, -0.4, -0.03])):
        final = Jfp.invert_rt(Jfp.homogeneous(look_at(np.asarray(eye))[None]))[0]
        pose_raw = np.eye(4)
        pose_raw[:3, :3], pose_raw[:3, 3] = F2C.T @ final[:3, :3], F2C.T @ final[:3, 3] * 1000
        params.update({f"{i}_Rt": Jfp.invert_rt(pose_raw[None])[0, :3].tolist(),
                       f"{i}_K": [[200.0, 0, 80], [0, 200.0, 60], [0, 0, 1]],
                       f"{i}_distortion": [0.0] * 5, f"{i}_width": 160, f"{i}_height": 120,
                       f"{i}_valid": True})
        img = rng.integers(60, 200, (120, 160, 3)).astype(np.uint8)
        img[40:80, 50:110] = (90 + 20 * i, 120, 150)
        Image.fromarray(img).save(subject / "1_neutral" / f"{i}.png")
    (subject / "1_neutral" / "params.json").write_text(json.dumps(params))
    align = root / "Rt_scale_dict.json"
    align.write_text(json.dumps({"1": {"1": [1.0, EYE_RT.tolist()]}}))
    return subject, align


def test_process_subject_matches_jax(tmp_path):
    subject, align = raw_capture(tmp_path / "raw")
    Jfp.process_subject(subject, tmp_path / "jax", align, crop_out=64)
    Tfp.main(["--dir_in", str(subject), "--dir_out", str(tmp_path / "port"),
              "--rt_scale_dict", str(align), "--crop_out", "64"])
    want = json.loads((tmp_path / "jax" / "01" / "cameras.json").read_text())
    got = json.loads((tmp_path / "port" / "01" / "cameras.json").read_text())
    assert sorted(got) == sorted(want) == ["0", "1"]
    for cam in want:
        for key in ("intrinsics", "extrinsics"):
            np.testing.assert_allclose(got[cam][key], want[cam][key], atol=1e-9)
        for key in ("azimuth", "elevation"):
            assert got[cam]["angles"][key] == pytest.approx(want[cam]["angles"][key], abs=1e-9)
    pngs = sorted((tmp_path / "port" / "01").rglob("*.png"))
    assert [p.name for p in pngs] == ["rgba_colorcalib.png"] * 2
    for p in pngs:
        a = np.asarray(Image.open(p), np.int16)
        b = np.asarray(Image.open(tmp_path / "jax" / p.relative_to(tmp_path / "port")), np.int16)
        assert a.shape == (64, 64, 4) and np.abs(a - b).max() <= 1
        assert 0 < (a[..., 3] > 0).mean() < 1


def test_thuman_smplx_scale_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    for uid in ("0001", "0002"):
        d = tmp_path / "smplx" / uid
        d.mkdir(parents=True)
        with open(d / "smplx_param.pkl", "wb") as f:
            pickle.dump({"scale": np.asarray([[rng.uniform(0.8, 1.2)]])}, f)
        v = rng.normal(size=(20, 3))
        (d / "mesh_smplx.obj").write_text("".join(f"v {a} {b} {c}\n" for a, b, c in v))
    Jsmplx.main(["--smplx_dir", str(tmp_path / "smplx"), "--out_dir", str(tmp_path / "jax")])
    Tsmplx.main(["--smplx_dir", str(tmp_path / "smplx"), "--out_dir", str(tmp_path / "port")])
    for uid in ("0001", "0002"):
        np.testing.assert_array_equal(np.load(tmp_path / "port" / f"{uid}.npy"),
                                      np.load(tmp_path / "jax" / f"{uid}.npy"))


def test_fanout_process_pool_matches_jax(tmp_path):
    """mpi4py is absent, so both take the local pool: every item runs once,
    the return code is the largest. The JAX package's pool forks, so it
    runs in a fresh interpreter (forking this JAX-threaded process can
    deadlock); the port's spawns its workers and runs here."""
    script = ("import sys, pathlib; p = pathlib.Path(sys.argv[1]); "
              "p.write_text(sys.argv[2]); sys.exit(3 if sys.argv[2] == 'c' else 0)")

    def argv(out):
        out.mkdir()
        return ["--items", "a", "b", "c", "--workers", "2", "--", sys.executable, "-c", script,
                str(out / "{item}.txt"), "{item}"]

    rcs = {"jax": subprocess.run([sys.executable, "-m", Jfan.__name__, *argv(tmp_path / "jax")],
                                 cwd=REPO, capture_output=True, timeout=120).returncode,
           "port": Tfan.main(argv(tmp_path / "port"))}
    for name in rcs:
        assert {p.name: p.read_text() for p in (tmp_path / name).iterdir()} == {
            f"{i}.txt": i for i in "abc"}
    assert rcs["port"] == rcs["jax"] == 3
    assert Tfan.main(["--items", "a"]) == 2  # no "--": usage


def test_thuman_blender_bpy_free_functions_match_jax():
    assert Tblend.bpy is None  # imported outside Blender: the API only
    n = 16
    az = (np.arange(n) / n * 2 * np.pi).astype(np.float32)
    el = np.deg2rad(np.linspace(-20, 20, n)).astype(np.float32)
    dist = np.full(n, 1.5, np.float32)
    np.testing.assert_array_equal(Tblend.spherical_to_cartesian(az, el, 1.5),
                                  Jblend.spherical_to_cartesian(az, el, 1.5))
    np.testing.assert_array_equal(Tblend.camera_poses_for(az, el, 1.5),
                                  Jblend.camera_poses_for(az, el, 1.5))
    # main() passes one distance a view: the JAX function cannot broadcast
    # (n, 3) by (n,) (ROADMAP Queue C); the port's gives the scalar's result
    with pytest.raises(ValueError, match="broadcast"):
        Jblend.camera_poses_for(az, el, dist)
    np.testing.assert_array_equal(Tblend.camera_poses_for(az, el, dist),
                                  Tblend.camera_poses_for(az, el, np.float32(1.5)))

    class Cam:  # Blender's camera: its world matrix's inverse as a 4x4
        def __init__(self, m):
            self.matrix_world = self
            self.m = m

        def inverted(self):
            return self.m

    m = np.linalg.inv(np.vstack([Jblend.camera_poses_for(az[:1], el[:1], dist[:1])[0],
                                 [0, 0, 0, 1]]))
    np.testing.assert_array_equal(Tblend._blender_rt(Cam(m)), Jblend._blender_rt(Cam(m)))
    with pytest.raises(SystemExit):
        sys_argv = sys.argv
        sys.argv = ["thuman_blender.py", "--", "--object_path", "x.obj", "--output_dir", "o",
                    "--smplx_stats_path", "s.npy"]
        try:
            Tblend.main()
        finally:
            sys.argv = sys_argv
