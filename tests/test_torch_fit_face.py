"""The port's fit_face CLI (`apps/fit_face.py`) against the JAX package's on
the CPU, both landmark backends, on synthetic FLAME assets (256 vertices,
8 shape and 4 expression codes, 5 LM iterations a stage):

  * precomputed landmarks (.npy for the input photo, .json for the
    expression photo) of ground-truth codes, with `--overlay`: the PLYs'
    vertices within 1e-4 relative L2, the faces equal, each reported cost
    1e-3 relative, the overlay PNGs equal but for 2 dots' pixels;
  * `--kpt_weights`: a seeded JAX LandmarkNet carried across by
    `from_jax_params` into the port's `.pt` file, the same tree fed to the
    JAX CLI through a patched `load_params`: the detections 1e-3 px, the
    PLYs 1e-4.

A seeded net's detections are no face (a blob of ~6 px), and a fit to
landmarks the model cannot match is where LM paths part in fp32 (see
tests/test_torch_fitting.py). So the second test writes FLAME assets that
the detections fit: 68 added vertex triples, each a degenerate landmark
triangle, placed where ground-truth codes project them onto the detected
pixels.
"""

import json
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from morphablediffusion_torch.apps import fit_face as Tcli
from morphablediffusion_torch.eval import keypoint_net as Tkn
from morphablediffusion_torch.tools import make_synthetic_flame
from morphablediffusion_torch.utils.mesh_io import load_ply
from morphablediffusion_torch.weights import flatten_tree
from morphablediffusion_tpu.apps import fit_face as Jcli
from morphablediffusion_tpu.eval import keypoint_net as Jkn
from morphablediffusion_tpu.fitting import flame as Jflame
from tests.torch_parity import seeded_tree

S = 256  # photo size; the CLI's focal is 1.2 S
K = np.asarray([[1.2 * S, 0, S / 2], [0, 1.2 * S, S / 2], [0, 0, 1]], np.float32)
CODES = ["--n_shape", "8", "--n_exp", "4", "--steps", "5"]


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def flame(tmp_path_factory):
    d = tmp_path_factory.mktemp("flame")
    make_synthetic_flame.main(["--out", str(d), "--vertices", "256", "--faces", "512"])
    return d


def flame_args(d):
    return ["--flame", str(d / "generic_model.pkl"), "--lmk_embedding",
            str(d / "landmark_embedding.npy")]


def photo(path, seed=0):
    img = np.random.default_rng(seed).uniform(0, 255, (S, S, 3)).astype(np.uint8)
    Image.fromarray(img).save(path)
    return np.asarray(img, np.float32) / 255.0


def jax_info(stderr: str) -> dict:
    """The JAX CLI's fit report ("  key: value" lines on stderr)."""
    return {k: float(v) for k, v in re.findall(r"^  (\w+): ([-\d.enaif]+)$", stderr, re.M)}


def run_both(capsys, argv, out, jax_extra=(), port_extra=()):
    Jcli.main(argv + ["--out", str(out / "j.ply"), *jax_extra])
    jinfo = jax_info(capsys.readouterr().err)
    tinfo = Tcli.main(argv + ["--out", str(out / "t.ply"), "--device", "cpu", *port_extra])
    (jv, jf), (tv, tf) = load_ply(out / "j.ply"), load_ply(out / "t.ply")
    np.testing.assert_array_equal(tf, jf)
    assert rel_l2(tv, jv) < 1e-4
    for k, v in jinfo.items():
        assert tinfo[k] == pytest.approx(v, rel=1e-3, abs=1e-4), k
    return jinfo, tinfo


def test_fit_face_precomputed_landmarks_match_jax(flame, tmp_path, capsys):
    jm = Jflame.load_model(*(str(flame / n) for n in ("generic_model.pkl",
                                                      "landmark_embedding.npy")),
                           n_shape=8, n_exp=4)
    rng = np.random.default_rng(1)
    shape, exp = rng.normal(size=8) * 0.5, rng.normal(size=4) * 0.5
    pose = jnp.zeros(15)

    def render(e):
        v = Jflame.flame_forward(jm, jnp.asarray(shape, jnp.float32), jnp.asarray(e, jnp.float32),
                                 pose)
        return np.array(Jflame.project_points(Jflame.flame_landmarks(jm, v, pose), jnp.zeros(3),
                                              jnp.asarray([0.0, 0.0, 1.0]), jnp.asarray(K)))

    np.save(tmp_path / "a.npy", render(np.zeros(4)))
    (tmp_path / "b.json").write_text(json.dumps({"exp": render(exp).tolist()}))
    photo(tmp_path / "in.png", 0)
    photo(tmp_path / "exp.png", 1)
    argv = ["--input_img", str(tmp_path / "in.png"), "--exp_img", str(tmp_path / "exp.png"),
            *flame_args(flame), "--input_landmarks", str(tmp_path / "a.npy"),
            "--exp_landmarks", str(tmp_path / "b.json"), *CODES]
    jinfo, tinfo = run_both(capsys, argv, tmp_path, ["--overlay", str(tmp_path / "j.png")],
                            ["--overlay", str(tmp_path / "t.png")])
    assert set(jinfo) == set(tinfo) - {"overlay_mean_px_err"}
    assert tinfo["exp_mean_px_err"] < 0.1
    ja, ta = (np.asarray(Image.open(tmp_path / n)) for n in ("j.png", "t.png"))
    assert ja.shape == ta.shape == (S, S, 3)
    assert (ja != ta).any(-1).sum() <= 18  # two 3x3 dots a pixel apart at most
    assert ((ta[..., 1] == 255) & (ta[..., 0] == 0)).any()  # detected: green
    assert ((ta[..., 0] == 255) & (ta[..., 1] == 0)).any()  # reprojected: red


def fitted_assets(src, out, lmk2d, rng):
    """FLAME assets whose 68 landmarks, at ground-truth codes and the
    camera (0, 0, 1), project onto lmk2d: 68 degenerate triangles (three
    equal vertices, so any barycentric weights give the vertex) appended
    to the synthetic model, each vertex triple sharing one source vertex's
    blendshapes and skinning weights, at depths 1 +- 0.05."""
    with open(src / "generic_model.pkl", "rb") as f:
        m = pickle.load(f)
    V, F = m["v_template"].shape[0], m["f"].shape[0]
    src_v = np.repeat(rng.integers(0, V, size=68), 3)
    beta = np.zeros(400)
    beta[:8], beta[300:304] = rng.normal(size=8) * 0.5, rng.normal(size=4) * 0.5
    depth = 1.0 + 0.05 * rng.normal(size=68)
    cam = np.linalg.solve(K.astype(np.float64), np.c_[lmk2d, np.ones(68)].T).T * depth[:, None]
    target = np.repeat(cam - [0.0, 0.0, 1.0], 3, axis=0)  # model frame (camera at z = 1)
    shapedirs = m["shapedirs"][src_v]
    m["v_template"] = np.concatenate([m["v_template"], target - shapedirs @ beta])
    m["shapedirs"] = np.concatenate([m["shapedirs"], shapedirs])
    m["posedirs"] = np.concatenate([m["posedirs"], m["posedirs"][src_v]])
    m["weights"] = np.concatenate([m["weights"], m["weights"][src_v]])
    m["J_regressor"] = np.concatenate([m["J_regressor"], np.zeros((5, 68 * 3))], axis=1)
    m["f"] = np.concatenate([m["f"], (V + np.arange(68 * 3)).reshape(68, 3).astype(np.uint32)])
    out.mkdir()
    with open(out / "generic_model.pkl", "wb") as f:
        pickle.dump(m, f, protocol=2)
    third = np.full((68, 3), 1.0 / 3)
    np.save(out / "landmark_embedding.npy", {
        "static_lmk_faces_idx": F + 17 + np.arange(51), "static_lmk_bary_coords": third[17:],
        "dynamic_lmk_faces_idx": np.broadcast_to(F + np.arange(17), (79, 17)).copy(),
        "dynamic_lmk_bary_coords": np.broadcast_to(third[:17], (79, 17, 3)).copy()},
        allow_pickle=True)


def test_fit_face_kpt_weights_match_jax(flame, tmp_path, capsys, monkeypatch):
    size = 64
    tree = seeded_tree(jax.eval_shape(lambda: Jkn.LandmarkNet().init(
        jax.random.key(0), jnp.zeros((1, size, size, 3)))), 3)
    net = Tkn.LandmarkNet()
    net.load_state_dict(Tkn.from_jax_params(flatten_tree(tree["params"])), strict=True)
    Tkn.save_params(tmp_path / "net.pt", net)
    monkeypatch.setattr(Jkn, "load_params", lambda path, image_size=256: (Jkn.LandmarkNet(), tree))
    img = photo(tmp_path / "in.png", 2)
    want = Jcli._detect(img, "", str(tmp_path / "net.pt"), size)
    got = Tcli._detect(img, "", str(tmp_path / "net.pt"), size, torch.device("cpu"))
    assert got.shape == (68, 2)
    np.testing.assert_allclose(got, want, atol=1e-3)

    fitted_assets(flame, tmp_path / "flame", want, np.random.default_rng(4))
    argv = ["--input_img", str(tmp_path / "in.png"), *flame_args(tmp_path / "flame"),
            "--kpt_weights", str(tmp_path / "net.pt"), "--kpt_size", str(size), *CODES]
    _, tinfo = run_both(capsys, argv, tmp_path)
    assert tinfo["input_mean_px_err"] < 0.1 and tinfo["exp_mean_px_err"] < 0.1
