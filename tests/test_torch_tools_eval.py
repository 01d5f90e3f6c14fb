"""The port's quality tools against their JAX twins in `tools/` on the CPU:

  * eval_flame_fit on noise-free, well-determined fits (8 shape and 4
    expression columns, 68 landmarks): the port's tool against the JAX
    tool with its own forward and fitter. Both fits end below a pixel, but
    the two LM paths part in fp32 (the forwards differ by ~1e-6): read at
    20 steps per stage over seeds 0 - 2, the px errors differed by up to
    0.114 px (0.16 at 40 steps), the relative vertex RMS by up to 0.0065,
    the code cosines by up to 0.0024; held within 0.25 px, 0.015 and 0.01;
  * eval_flame_fit at 0.5 px of landmark noise, where the LM paths part
    further (see test_torch_fitting.py): the tool's protocol (ground-truth
    draws, landmark noise, camera-space metrics, the retarget, the JSON)
    against the JAX tool's, with the JAX tool's FLAME forward, landmarks,
    projection and fits routed to the port's: every number within 1e-5
    relative; the port's own fits on noise-free landmarks within 1 px;
  * eval_landmark_net: the shipped net on a 128^2 tree, plain and shifted:
    the JSON's PCKs within one landmark of the JAX tool's, the pixel errors
    within 2e-3 px (the two nets' keypoints differ by ~5e-5 px);
  * eval_matting and eval_anchors: the JSON of the JAX tool (1e-6)."""

import functools
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import jax_tool


REPO = Path(__file__).resolve().parents[1]


# tool 8 ---------------------------------------------------------------------

FLAME_SMALL = dict(n_shape=8, n_exp=4)
# the noise-free fits, port against JAX (readings in the module docstring)
FIT_PX_TOL, FIT_RMS_REL_TOL, FIT_COS_TOL = 0.25, 0.015, 0.01


def small_flame_assets(tmp_path, monkeypatch):
    """Synthetic FLAME assets of 300 vertices; both packages' load_model
    cut to FLAME_SMALL's columns."""
    import morphablediffusion_tpu.fitting.flame as Jflame
    from morphablediffusion_torch.fitting import flame as Tflame
    from morphablediffusion_torch.tools import make_synthetic_flame

    assets = tmp_path / "assets"
    make_synthetic_flame.main(["--out", str(assets), "--vertices", "300", "--faces", "600"])
    monkeypatch.setattr(Jflame, "load_model", functools.partial(Jflame.load_model,
                                                                **FLAME_SMALL))
    monkeypatch.setattr(Tflame, "load_model", functools.partial(Tflame.load_model,
                                                                **FLAME_SMALL))
    return assets


def test_eval_flame_fit_noise_free_matches_jax(tmp_path, monkeypatch):
    from morphablediffusion_torch.tools import eval_flame_fit as T

    assets = small_flame_assets(tmp_path, monkeypatch)
    argv = ["--assets", str(assets), "--trials", "2", "--noise_px", "0", "--steps", "20"]
    jax_tool("eval_flame_fit").main(argv + ["--out", str(tmp_path / "jax.json")])
    want = json.loads((tmp_path / "jax.json").read_text())
    got = T.main(argv + ["--out", str(tmp_path / "port.json"), "--device", "cpu"])
    assert got["per_noise"].keys() == want["per_noise"].keys() == {"0.0"}
    pairs = list(zip(got["per_noise"]["0.0"]["trials"], want["per_noise"]["0.0"]["trials"]))
    assert len(pairs) == 2
    for a, b in pairs:
        assert a.keys() == b.keys()
        assert a["px_err"] < 1.0 and b["px_err"] < 1.0
        assert abs(a["px_err"] - b["px_err"]) <= FIT_PX_TOL
        assert abs(a["vertex_rms_rel"] - b["vertex_rms_rel"]) <= FIT_RMS_REL_TOL
        for k in ("shape_cos", "exp_cos"):
            assert abs(a[k] - b[k]) <= FIT_COS_TOL, k
    assert len(got["retarget"]) == len(want["retarget"]) == 2
    for a, b in zip(got["retarget"], want["retarget"]):
        assert a.keys() == b.keys()
        assert abs(a["vertex_rms_rel"] - b["vertex_rms_rel"]) <= FIT_RMS_REL_TOL
        for k in ("input_px_err", "exp_px_err"):
            assert a[k] < 1.0 and b[k] < 1.0 and abs(a[k] - b[k]) <= FIT_PX_TOL, k


def test_eval_flame_fit_protocol_matches_jax(tmp_path, monkeypatch):
    import morphablediffusion_tpu.fitting.fit as Jfit
    import morphablediffusion_tpu.fitting.flame as Jflame
    from morphablediffusion_torch.fitting import fit as Tfit
    from morphablediffusion_torch.fitting import flame as Tflame
    from morphablediffusion_torch.tools import eval_flame_fit as T

    assets = small_flame_assets(tmp_path, monkeypatch)
    tm = Tflame.load_model(str(assets / "generic_model.pkl"),
                           str(assets / "landmark_embedding.npy"), device="cpu")
    tcfg = lambda cfg: Tfit.FitConfig(**vars(cfg))
    # the JAX tool's FLAME forward, landmarks, projection and fits, routed to
    # the port's on the same model: what is left is the tool's protocol
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    j = lambda f: lambda *a: jnp.asarray(f(*a).numpy())
    monkeypatch.setattr(Jflame, "flame_forward", j(lambda model, *a: Tflame.flame_forward(
        tm, *map(t, a))))
    monkeypatch.setattr(Jflame, "flame_landmarks", j(lambda model, *a: Tflame.flame_landmarks(
        tm, *map(t, a))))
    monkeypatch.setattr(Jflame, "project_points", j(lambda *a: Tflame.project_points(
        *map(t, a))))
    monkeypatch.setattr(Jfit, "fit_landmarks", lambda model, lmk, K, cfg, **kw:
                        Tfit.fit_landmarks(tm, np.asarray(lmk), K, tcfg(cfg), **kw))
    monkeypatch.setattr(Jfit, "fit_two_photos", lambda model, a, b, K, cfg, **kw:
                        Tfit.fit_two_photos(tm, np.asarray(a), np.asarray(b), K, tcfg(cfg), **kw))
    argv = ["--assets", str(assets), "--trials", "1", "--noise_px", "0.5", "--steps", "6"]
    jax_tool("eval_flame_fit").main(argv + ["--out", str(tmp_path / "jax.json")])
    want = json.loads((tmp_path / "jax.json").read_text())
    got = T.main(argv + ["--out", str(tmp_path / "port.json"), "--device", "cpu"])
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(json.dumps(got))
    want["config"]["out"] = got["config"]["out"]
    assert got["config"] == want["config"]
    assert got["per_noise"].keys() == want["per_noise"].keys() == {"0.5"}
    for noise, agg in want["per_noise"].items():
        for a, b in zip(got["per_noise"][noise]["trials"], agg["trials"]):
            assert a.keys() == b.keys()
            for k in a:
                if k != "fit_seconds":
                    assert a[k] == pytest.approx(b[k], rel=1e-5, abs=1e-7), (noise, k)
    assert len(got["retarget"]) == len(want["retarget"]) == 2
    for a, b in zip(got["retarget"], want["retarget"]):
        assert a == pytest.approx(b, rel=1e-5, abs=1e-7)


def test_eval_flame_fit_own_fits(tmp_path):
    """The port's tool with its own fitter (and the silhouette stage) on
    noise-free landmarks: every key of the JAX artifact, errors within
    1 px."""
    from morphablediffusion_torch.tools import eval_flame_fit as T

    got = T.main(["--vertices", "300", "--trials", "1", "--noise_px", "0", "--steps", "20",
                  "--seed", "1", "--silhouette", "--out", str(tmp_path / "f.json"), "--device", "cpu"])
    ref = json.loads((REPO / "artifacts/flame_fit_eval.json").read_text())
    assert got["per_noise"]["0.0"].keys() == ref["per_noise"]["0.0"].keys()
    assert got["retarget"][0].keys() == ref["retarget"][0].keys()
    assert got["per_noise"]["0.0"]["px_err"] < 1.0
    assert got["per_noise"]["0.0"]["sil_px_err"] < 1.5


# tools 9 - 11 -----------------------------------------------------------------

@pytest.fixture(scope="module")
def kp_tree(tmp_path_factory):
    """A 128^2 synthetic tree with landmarks painted (2 subjects x 1
    expression x 4 views), and its stage-1 JSON."""
    from morphablediffusion_torch.apps import eval_select_views
    from morphablediffusion_torch.tools import make_synthetic_facescape, make_synthetic_landmarks

    root = tmp_path_factory.mktemp("kp_tree")
    make_synthetic_landmarks.main(["--out", str(root / "landmarks.json")])
    make_synthetic_facescape.main([
        "--out", str(root), "--subjects", "2", "--expressions", "2", "--views", "4",
        "--image_size", "128", "--points", "6000",
        "--mark_landmarks", str(root / "landmarks.json")])
    eval_select_views.main(["--data_dir", str(root / "data"), "--output",
                            str(root / "views.json"), "--subjects", "001", "002",
                            "--expressions", "01", "02"])
    return root


@pytest.mark.parametrize("shifted", [False, True])
def test_eval_landmark_net_matches_jax(kp_tree, tmp_path, shifted):
    from morphablediffusion_torch.tools import eval_landmark_net as T

    argv = ["--weights", str(REPO / "artifacts/landmark_net_synth.msgpack"),
            "--image_dir", str(kp_tree / "data"), "--landmarks", str(kp_tree / "landmarks.json"),
            "--mesh", str(kp_tree / "flame/{subject}/{exp}/mesh.obj"), "--image_size", "128"]
    argv += ["--shifted"] if shifted else []
    jax_tool("eval_landmark_net").main(argv + ["--out", str(tmp_path / "jax.json")])
    want = json.loads((tmp_path / "jax.json").read_text())
    got = T.main(argv + ["--out", str(tmp_path / "port.json"), "--device", "cpu"])
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert got.keys() == want.keys() and got["n_views"] == want["n_views"] == 16
    for k in ("weights", "condition", "image_size"):
        assert got[k] == want[k]
    one = 1.0 / (68 * got["n_views"])
    for k in ("pck_0.2", "pck_0.5"):
        assert abs(got[k] - want[k]) <= one + 1e-4, k
    for k in ("mean_px", "median_px"):
        assert abs(got[k] - want[k]) <= 2e-3, k
    assert 0 <= got["pck_0.2"] <= got["pck_0.5"] <= 1


def _close_json(got, want, tol=1e-6):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            _close_json(got[k], want[k], tol)
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _close_json(a, b, tol)
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=tol, abs=tol)
    else:
        assert got == want


def test_eval_matting_matches_jax(kp_tree, tmp_path):
    from morphablediffusion_torch.tools import eval_matting as T

    argv = ["--data_dir", str(kp_tree / "data"), "--samples", "3"]
    jax_tool("eval_matting").main(argv + ["--out", str(tmp_path / "jax.json")])
    T.main(argv + ["--out", str(tmp_path / "port.json")])
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert set(got["summary"]) == {"uniform", "gradient", "clutter"}
    _close_json(got, want)


def test_eval_anchors_matches_jax(kp_tree, tmp_path, capsys):
    from morphablediffusion_torch.tools import eval_anchors as T

    argv = ["--data_dir", str(kp_tree / "data"), "--views_json", str(kp_tree / "views.json"),
            "--image_size", "128"]
    jax_tool("eval_anchors").main(argv + ["--out", str(tmp_path / "jax.json")])
    got = T.main(argv + ["--out", str(tmp_path / "port.json")])
    want = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(json.dumps(got))
    assert got["pairs_scored"] == want["pairs_scored"] > 0
    _close_json(got, want)
