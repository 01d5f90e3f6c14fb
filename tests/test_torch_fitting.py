"""Port parity of FLAME fitting (`fitting/flame.py`, `fit.py`,
`silhouette.py`) against the JAX package on the CPU, fp32, on the same
models (`random_model` from one seed, the synthetic FLAME assets of both
tools, and JAX models carried across by `model_from_jax`).

Tolerances: the model's constants and the host-side numpy/scipy steps
equal; rodrigues, the forward, the landmarks and the projection 1e-5;
the residuals and their Jacobian 1e-4 of their largest entry; one LM
iteration: the accept decision equal, the linearized residual change
J·delta 1e-4 relative, the cost after it 1e-4 of the cost it removed; short fits (5 LM
iterations a stage) on noise-free landmarks of a well-determined problem:
parameters 2e-4, costs 1e-4 relative, vertices 1e-4 relative L2.

The LM parity trap (ROADMAP Queue C): the rigid and full stages have an
exact 3-dimensional null space (cam_r against pose[:3], with cam_t), so the
component of each step along it is fp32 rounding of J^T r over lambda. On
landmarks the model cannot match (noise, garbage detections) that is
~0.1 rad a step, and the two packages' paths part after a few iterations,
as JAX's jitted and eager loops part from each other; the head yaw bucket
of the jaw contour adds jumps. Where r goes to 0 (noise-free landmarks of
the model) the paths agree, so the fits below use such landmarks.
"""

import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphablediffusion_torch.fitting import fit as Tfit
from morphablediffusion_torch.fitting import flame as Tflame
from morphablediffusion_torch.fitting import silhouette as Tsil
from morphablediffusion_torch.tools import make_synthetic_flame
from morphablediffusion_tpu.fitting import fit as Jfit
from morphablediffusion_tpu.fitting import flame as Jflame
from morphablediffusion_tpu.fitting import silhouette as Jsil

REPO = Path(__file__).resolve().parents[1]
K256 = np.asarray([[300.0, 0, 128], [0, 300.0, 128], [0, 0, 1]], np.float32)


def t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float32)


def j(x):
    return jnp.asarray(np.asarray(x, np.float32))


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def assert_models_equal(port: Tflame.FlameModel, jm):
    for k in Tflame._TENSORS:
        np.testing.assert_array_equal(getattr(port, k).numpy(), np.asarray(getattr(jm, k)), k)
    assert port.parents == tuple(int(p) for p in np.asarray(jm.parents))
    assert (port.n_shape, port.n_exp) == (jm.n_shape, jm.n_exp)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """Synthetic FLAME assets (256 vertices, 512 faces) from the port's tool,
    loaded by both packages at 8 shape and 4 expression codes."""
    d = tmp_path_factory.mktemp("flame")
    make_synthetic_flame.main(["--out", str(d), "--vertices", "256", "--faces", "512"])
    pkl, emb = str(d / "generic_model.pkl"), str(d / "landmark_embedding.npy")
    jm = Jflame.load_model(pkl, emb, n_shape=8, n_exp=4)
    return jm, Tflame.load_model(pkl, emb, n_shape=8, n_exp=4, device="cpu")


def models(kind, synth):
    if kind == "synthetic":
        return synth
    jm = Jflame.random_model(np.random.default_rng(0), n_landmarks=24)
    return jm, Tflame.random_model(np.random.default_rng(0), n_landmarks=24, device="cpu")


def test_random_model_and_carried_model_equal_jax():
    jm = Jflame.random_model(np.random.default_rng(7), n_verts=64, n_landmarks=17)
    port = Tflame.random_model(np.random.default_rng(7), n_verts=64, n_landmarks=17,
                               device="cpu")
    assert_models_equal(port, jm)
    assert_models_equal(Tflame.model_from_jax(jm, device="cpu"), jm)
    assert not port.has_dynamic_contour and port.num_joints == 5
    assert port.to("cpu").device == torch.device("cpu")


def test_synthetic_tools_and_load_model_equal(tmp_path):
    """Both tools write the same arrays for one seed; both loaders read
    them into equal models, as does `model_from_jax`."""
    flags = ["--vertices", "96", "--faces", "160", "--seed", "3"]
    subprocess.run([sys.executable, str(REPO / "tools/make_synthetic_flame.py"), "--out",
                    str(tmp_path / "jax"), *flags], check=True, capture_output=True)
    make_synthetic_flame.main(["--out", str(tmp_path / "port"), *flags])
    for name in ("generic_model.pkl", "landmark_embedding.npy"):
        a, b = (tmp_path / "jax" / name).read_bytes(), (tmp_path / "port" / name).read_bytes()
        assert a == b, name
    with open(tmp_path / "port" / "generic_model.pkl", "rb") as f:
        assert pickle.load(f)["shapedirs"].shape == (96, 3, 400)
    d = tmp_path / "jax"
    args = (str(d / "generic_model.pkl"), str(d / "landmark_embedding.npy"))
    for n_shape, n_exp in ((100, 50), (7, 3)):
        jm = Jflame.load_model(*args, n_shape=n_shape, n_exp=n_exp)
        port = Tflame.load_model(*args, n_shape=n_shape, n_exp=n_exp, device="cpu")
        assert_models_equal(port, jm)
        assert_models_equal(Tflame.model_from_jax(jm, device="cpu"), jm)
        assert port.has_dynamic_contour and port.dyn_lmk_faces.shape == (79, 17, 3)
    # without the embedding file: the one-row placeholders
    assert_models_equal(Tflame.load_model(args[0], device="cpu"), Jflame.load_model(args[0]))


def test_rodrigues_matches_jax_and_scipy(rng):
    from scipy.spatial.transform import Rotation

    rvecs = rng.normal(size=(10, 3)).astype(np.float32)
    rvecs[0] = 0.0
    rvecs[1] = 1e-7
    got = Tflame.rodrigues(t(rvecs)).numpy()
    np.testing.assert_allclose(got, np.asarray(Jflame.rodrigues(j(rvecs))), atol=1e-6)
    np.testing.assert_allclose(got, Rotation.from_rotvec(rvecs).as_matrix(), atol=1e-5)
    for r in (np.zeros(3, np.float32), rvecs[2]):  # finite and equal derivatives, at 0 too
        jt = torch.func.jacfwd(Tflame.rodrigues)(t(r)).numpy()
        assert np.isfinite(jt).all()
        np.testing.assert_allclose(jt, np.asarray(jax.jit(jax.jacfwd(Jflame.rodrigues))(j(r))),
                                   atol=1e-5)


@pytest.mark.parametrize("kind", ["random", "synthetic"])
def test_flame_forward_matches_jax(kind, synth, rng):
    jm, tm = models(kind, synth)
    shape, exp = rng.normal(size=tm.n_shape), rng.normal(size=tm.n_exp)
    pose = rng.normal(size=tm.num_joints * 3) * 0.3
    want = np.asarray(Jflame.flame_forward(jm, j(shape), j(exp), j(pose)))
    got = Tflame.flame_forward(tm, t(shape), t(exp), t(pose)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    zero = Tflame.flame_forward(tm, torch.zeros(tm.n_shape), torch.zeros(tm.n_exp),
                                torch.zeros(15))
    np.testing.assert_allclose(zero.numpy(), tm.v_template.numpy(), atol=1e-6)


# (global yaw, neck yaw) in degrees: both signs, a bucket near 0, and beyond
# +-39 (clamped to bucket 39 or 78)
YAWS = [(-50.0, 0.0), (-25.0, -10.0), (-0.7, 0.0), (0.0, 0.0), (12.0, 0.0), (25.0, 10.0),
        (33.0, 20.0), (60.0, -5.0)]


@pytest.fixture(scope="module")
def jax_landmarks(synth):
    """The JAX landmarks of the synthetic model as a function of (shape,
    exp, pose), and its Jacobian in the pose, each jitted once."""
    jm = synth[0]

    def ref(shape, exp, p):
        return Jflame.flame_landmarks(jm, Jflame.flame_forward(jm, shape, exp, p), p)

    return jax.jit(ref), jax.jit(jax.jacfwd(ref, argnums=2))


@pytest.mark.parametrize("yaw", YAWS, ids=[f"{g:+g}{n:+g}" for g, n in YAWS])
def test_flame_landmarks_and_contour_bucket_match_jax(yaw, synth, jax_landmarks, rng):
    """The jaw-contour bucket at both yaw signs and beyond +-39 deg, the 68
    landmarks, and their Jacobian in the pose under `torch.func.jacfwd`
    (the bucket from the primal: its derivative is 0, as in JAX)."""
    jm, tm = synth
    pose = np.zeros(15, np.float32)
    pose[1], pose[4] = np.radians(yaw[0]), np.radians(yaw[1])
    pose[6:9] = rng.normal(size=3) * 0.1  # jaw
    bucket = int(Tflame._dyn_contour_index(t(pose)))
    assert bucket == int(Jflame._dyn_contour_index(j(pose)))
    total = yaw[0] + yaw[1]  # a turn about +y reads as yaw -total (atan2(R[2,0], ...))
    if abs(total) > 39.5:
        assert bucket == (78 if total > 0 else 39)
    shape, exp = rng.normal(size=8), rng.normal(size=4)

    def port(p):
        return Tflame.flame_landmarks(tm, Tflame.flame_forward(tm, t(shape), t(exp), p), p)

    ref, ref_jac = jax_landmarks
    got = port(t(pose))
    assert got.shape == (68, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref(j(shape), j(exp), j(pose))),
                               atol=1e-5)
    np.testing.assert_allclose(torch.func.jacfwd(port)(t(pose)).numpy(),
                               np.asarray(ref_jac(j(shape), j(exp), j(pose))), atol=1e-5)


def test_project_points_matches_jax(rng):
    pts = rng.normal(size=(30, 3)) * 0.1
    rvec, tvec = rng.normal(size=3) * 0.2, np.asarray([0.01, -0.02, 0.7])
    want = np.asarray(Jflame.project_points(j(pts), j(rvec), j(tvec), j(K256)))
    got = Tflame.project_points(t(pts), t(rvec), t(tvec), t(K256)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)  # pixels ~ 1e2


def gt_landmarks(jm, rng, n_codes_scale=0.5, cam_t=(0.0, 0.0, 0.9), K=K256):
    """Noise-free landmarks of ground-truth codes: (params, landmarks)."""
    J = jm.num_joints
    gt = {"shape": rng.normal(size=jm.n_shape) * n_codes_scale,
          "exp": rng.normal(size=jm.n_exp) * n_codes_scale,
          "pose": np.zeros(J * 3), "cam_r": np.zeros(3), "cam_t": np.asarray(cam_t)}
    gt = {k: np.asarray(v, np.float32) for k, v in gt.items()}
    v = Jflame.flame_forward(jm, j(gt["shape"]), j(gt["exp"]), j(gt["pose"]))
    lmk = Jflame.project_points(Jflame.flame_landmarks(jm, v, j(gt["pose"])), j(gt["cam_r"]),
                                j(gt["cam_t"]), j(K))
    return gt, np.array(lmk)


def problem(jm, tm, params, lmk, cfg=None):
    """Both packages' flat residual functions at `params` (JAX's
    ravel_pytree order and the port's `ravel` must agree)."""
    cfg = cfg or Jfit.FitConfig()
    w = np.ones(len(lmk), np.float32)
    if len(lmk) == 68:
        w[:17] = cfg.w_contour
    jflat, unravel = jax.flatten_util.ravel_pytree({k: j(v) for k, v in params.items()})
    tflat, tunravel = Tfit.ravel({k: t(v) for k, v in params.items()})
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    tcfg = Tfit.FitConfig(**vars(cfg))
    jres = jax.jit(lambda f: Jfit._residuals(unravel(f), jm, j(lmk), j(K256), cfg, j(w)))
    tres = lambda f: Tfit._residuals(tunravel(f), tm, t(lmk), t(K256), tcfg, t(w))
    return jflat, tflat, jres, tres


@pytest.mark.parametrize("kind", ["random", "synthetic"])
def test_residuals_and_jacobian_match_jax(kind, synth, rng):
    jm, tm = models(kind, synth)
    gt, lmk = gt_landmarks(jm, rng)
    start = {k: v + rng.normal(size=v.shape).astype(np.float32) * 0.05 for k, v in gt.items()}
    jflat, tflat, jres, tres = problem(jm, tm, start, lmk + rng.normal(size=lmk.shape) * 2)
    want_r, want_J = np.asarray(jres(jflat)), np.asarray(jax.jit(jax.jacfwd(jres))(jflat))
    got_r, got_J = tres(tflat).numpy(), torch.func.jacfwd(tres)(tflat).numpy()
    np.testing.assert_allclose(got_r, want_r, atol=1e-4 * np.abs(want_r).max())
    np.testing.assert_allclose(got_J, want_J, atol=1e-4 * np.abs(want_J).max())
    # the stage masks, flattened in the same order
    for freeze in (False, True):
        jm_ = Jfit._stage_masks({k: j(v) for k, v in start.items()}, freeze_shape=freeze)
        tm_ = Tfit._stage_masks({k: t(v) for k, v in start.items()}, freeze_shape=freeze)
        for stage in ("rigid", "expression", "full"):
            np.testing.assert_array_equal(Tfit.ravel(tm_[stage])[0].numpy(),
                                          np.asarray(jax.flatten_util.ravel_pytree(
                                              jm_[stage])[0]), stage)


@pytest.fixture(scope="module")
def lm_problem():
    """A perturbed start of the random model's noise-free problem, with both
    packages' residual functions and LM runners, and the JAX Jacobian."""
    rng = np.random.default_rng(0)
    jm, tm = models("random", None)
    gt, lmk = gt_landmarks(jm, rng)
    start = {k: v + rng.normal(size=v.shape).astype(np.float32) * 0.05 for k, v in gt.items()}
    jflat, tflat, jres, tres = problem(jm, tm, start, lmk)
    r0 = np.asarray(jres(jflat))
    return dict(start=start, jflat=jflat, tflat=tflat, c0=0.5 * float(np.sum(r0.astype(
        np.float64) ** 2)), jrun=Jfit._lm_stage_runner(jres, len(jflat)),
        trun=Tfit._lm_stage_runner(tres, len(tflat)),
        J=np.asarray(jax.jit(jax.jacfwd(jres))(jflat), np.float64))


@pytest.mark.parametrize("stage", ["rigid", "expression", "full"])
def test_one_lm_iteration_matches_jax(stage, lm_problem):
    """One iteration of each stage's runner from a perturbed start: the
    accept decision (and so lambda: x0.5 or x4), the step through J (J·delta,
    the linearized residual change, 1e-4 relative: the component of delta in
    the gauge null space is rounding noise in both packages), and the cost
    after it, within 1e-4 of the cost the step removed (that noise moves it
    at second order)."""
    p = lm_problem
    mask = Jfit._stage_masks({k: j(v) for k, v in p["start"].items()})[stage]
    jmask = jax.flatten_util.ravel_pytree(mask)[0]
    jp, jc = p["jrun"](p["jflat"], jmask, 1)
    tp, tc = p["trun"](p["tflat"], t(jmask), 1)
    c0 = p["c0"]
    assert (float(jc) < c0 * (1 - 1e-6)) == (float(tc) < c0 * (1 - 1e-6)) == True  # noqa: E712
    assert abs(float(tc) - float(jc)) <= 1e-4 * (c0 - float(jc))
    d_j, d_t = np.asarray(jp) - np.asarray(p["jflat"]), tp.numpy() - p["tflat"].numpy()
    assert rel_l2(p["J"] @ d_t, p["J"] @ d_j) < 1e-4
    np.testing.assert_array_equal(d_t[np.asarray(jmask) == 0], 0.0)


def test_fit_landmarks_matches_jax(rng):
    """Five LM iterations a stage from a perturbed start on noise-free
    landmarks: the canonical parameters, each stage's cost and the mean
    reprojection error."""
    jm, tm = models("random", None)
    gt, lmk = gt_landmarks(jm, rng)
    init = {k: v + np.float32(0.05) for k, v in gt.items()}
    jp, ji = Jfit.fit_landmarks(jm, lmk, K256, Jfit.FitConfig(steps_per_stage=5),
                                init={k: j(v) for k, v in init.items()})
    tp, ti = Tfit.fit_landmarks(tm, lmk, K256, Tfit.FitConfig(steps_per_stage=5),
                                init=dict(init))
    assert ti.keys() == ji.keys() == {"loss_rigid", "loss_expression", "loss_full",
                                      "mean_px_err"}
    for k in ("loss_rigid", "loss_expression", "loss_full"):
        assert ti[k] == pytest.approx(ji[k], rel=1e-4), k
    assert ti["mean_px_err"] == pytest.approx(ji["mean_px_err"], abs=1e-4)
    assert ti["mean_px_err"] < 0.05
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], atol=2e-4, err_msg=k)
    assert tp["pose"][:3].tolist() == [0.0, 0.0, 0.0]  # canonical


def test_fit_two_photos_matches_jax(rng):
    """Identity from photo A, expression from photo B (the same identity,
    noise-free), five iterations a stage from the default start."""
    jm = Jflame.random_model(np.random.default_rng(0), n_landmarks=40)
    tm = Tflame.model_from_jax(jm, device="cpu")
    gt, lmk_b = gt_landmarks(jm, rng)
    v = Jflame.flame_forward(jm, j(gt["shape"]), jnp.zeros(jm.n_exp), j(gt["pose"]))
    lmk_a = np.array(Jflame.project_points(Jflame.flame_landmarks(jm, v, j(gt["pose"])),
                                           j(gt["cam_r"]), j(gt["cam_t"]), j(K256)))
    jv, ji = Jfit.fit_two_photos(jm, lmk_a, lmk_b, K256, Jfit.FitConfig(steps_per_stage=5))
    tv, ti = Tfit.fit_two_photos(tm, lmk_a, lmk_b, K256, Tfit.FitConfig(steps_per_stage=5))
    assert tv.shape == (jm.v_template.shape[0], 3)
    assert rel_l2(tv, jv) < 1e-4
    assert ti.keys() == ji.keys()
    for k in ji:
        assert ti[k] == pytest.approx(ji[k], rel=1e-3, abs=1e-4), k


def test_canonicalize_global_matches_jax(rng):
    jm, tm = models("random", None)
    p = {"shape": rng.normal(size=8), "exp": rng.normal(size=4),
         "pose": rng.normal(size=15) * 0.2, "cam_r": rng.normal(size=3) * 0.1,
         "cam_t": np.asarray([0.02, -0.01, 0.8])}
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    want, got = Jfit.canonicalize_global(jm, dict(p)), Tfit.canonicalize_global(tm, dict(p))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)

    def uv(q):  # the fold keeps every projection
        v = Tflame.flame_forward(tm, t(q["shape"]), t(q["exp"]), t(q["pose"]))
        return Tflame.project_points(v, t(q["cam_r"]), t(q["cam_t"]), t(K256)).numpy()

    np.testing.assert_allclose(uv(got), uv(p), atol=1e-3)
    assert got["pose"][:3].tolist() == [0.0, 0.0, 0.0]


# --------------------------------------------------------------------- #
# the silhouette term


@pytest.fixture(scope="module")
def sil_scene():
    """The JAX package's silhouette setup: random model of 256 vertices, a
    128^2 photo at f = 1.2 S, the ground truth's rendered matte."""
    rng = np.random.default_rng(0)
    jm = Jflame.random_model(rng, n_verts=256, n_landmarks=24)
    tm = Tflame.model_from_jax(jm, device="cpu")
    S = 128
    K = np.asarray([[1.2 * S, 0, S / 2], [0, 1.2 * S, S / 2], [0, 0, 1]], np.float32)
    gt = {"shape": rng.normal(size=8).astype(np.float32),
          "exp": rng.normal(size=4).astype(np.float32),
          "pose": np.zeros(15, np.float32), "cam_r": np.zeros(3, np.float32),
          "cam_t": np.asarray([0, 0, 0.9], np.float32)}
    return jm, tm, S, K, gt


def test_silhouette_host_steps_match_jax(sil_scene):
    """Rendering (the port's C++ rasterizer against the JAX package's),
    visibility, the distance transform, contours, correspondences, normals
    and the vertex spacing: equal on the same inputs."""
    jm, tm, S, K, gt = sil_scene
    np.testing.assert_allclose(Tsil._verts_px(tm, gt, K), Jsil._verts_px(jm, gt, K),
                               rtol=1e-5, atol=1e-4)
    mask = Tsil.render_silhouette(tm, gt, K, S)
    assert 0.02 < mask.mean() < 0.9
    jmask = Jsil.render_silhouette(jm, gt, K, S)
    assert (mask != jmask).sum() <= 2  # pixels on a triangle's edge
    np.testing.assert_array_equal(Tsil.vertex_visibility(tm, gt, K, S),
                                  Jsil.vertex_visibility(jm, gt, K, S))
    vis = Jsil.vertex_visibility(jm, gt, K, S)
    vpx = Jsil._verts_px(jm, gt, K)[:, :2]
    np.testing.assert_array_equal(Tsil.mask_to_dt(jmask), Jsil.mask_to_dt(jmask))
    contour = Jsil.mask_contour(jmask, 48)
    np.testing.assert_array_equal(Tsil.mask_contour(jmask, 48), contour)
    got = Tsil.contour_correspondences(contour, jmask, vpx, vis, 0.15 * S, target_mask=jmask)
    want = Jsil.contour_correspondences(contour, jmask, vpx, vis, 0.15 * S, target_mask=jmask)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert want[3].sum() > 24
    assert Tsil.vertex_spacing_px(vpx, vis) == Jsil.vertex_spacing_px(vpx, vis)
    assert [len(x) for x in Tsil.contour_correspondences(
        np.zeros((0, 2), np.float32), jmask, vpx, vis, 10.0, jmask)] == [0, 0, 0, 0]


def test_silhouette_residuals_match_jax(sil_scene, rng):
    """sample_dt and both residual blocks, and their Jacobian in the
    projected vertices (bilinear, clamped at the border)."""
    jm, tm, S, K, gt = sil_scene
    dt = Jsil.mask_to_dt(Jsil.render_silhouette(jm, gt, K, S))
    uv = rng.uniform(-10, S + 10, size=(64, 2)).astype(np.float32)
    np.testing.assert_allclose(Tsil.sample_dt(t(dt), t(uv)).numpy(),
                               np.asarray(jax.jit(Jsil.sample_dt)(j(dt), j(uv))), rtol=1e-6,
                               atol=1e-5)
    vis = (rng.uniform(size=64) > 0.3).astype(np.float32)
    corr = (np.arange(0, 64, 3), rng.uniform(0, S, size=(22, 2)),
            rng.normal(size=(22, 2)), (rng.uniform(size=22) > 0.2))
    jcorr = (jnp.asarray(corr[0], jnp.int32),) + tuple(j(c) for c in corr[1:])
    tcorr = (torch.as_tensor(corr[0]),) + tuple(t(c) for c in corr[1:])
    for c_j, c_t in ((jcorr, tcorr), (tuple(c[:0] for c in jcorr), tuple(c[:0] for c in tcorr))):
        def port(x):
            return torch.cat(Tsil.silhouette_residuals(x, t(vis), t(dt), *c_t, 0.5, 0.05, 0.2,
                                                       deadband_px=1.5))

        def ref(x):
            return jnp.concatenate(Jsil.silhouette_residuals(x, j(vis), j(dt), *c_j, 0.5, 0.05,
                                                             0.2, deadband_px=1.5))

        np.testing.assert_allclose(port(t(uv)).numpy(), np.asarray(jax.jit(ref)(j(uv))),
                                   atol=1e-5)
        np.testing.assert_allclose(torch.func.jacfwd(port)(t(uv)).numpy(),
                                   np.asarray(jax.jit(jax.jacfwd(ref))(j(uv))), atol=1e-5)


def test_silhouette_stage_and_unobserved_landmarks_match_jax(sil_scene):
    """The silhouette stage alone (every landmark confidence 0, so the
    landmark stages are skipped), five iterations a round from a rigid
    perturbation of the ground truth: its cost (1e-5 relative) and the
    fitted mesh's projection (0.01 px, against a move of ~4.6 px; the gauge
    split of the rigid parameters is compared through it); and the mean
    reprojection error over no observed landmark is 0/0 = NaN in both
    packages."""
    jm, tm, S, K, gt = sil_scene
    mask = Jsil.render_silhouette(jm, gt, K, S)
    init = dict(gt)
    init["cam_r"] = np.asarray([0.04, -0.03, 0.02], np.float32)
    init["cam_t"] = gt["cam_t"] + np.asarray([0.025, -0.02, 0.0], np.float32)
    cfg = dict(steps_per_stage=5, sil_rounds=2)
    lmk, conf = np.zeros((24, 2), np.float32), np.zeros(24, np.float32)
    jp, ji = Jfit.fit_landmarks(jm, lmk, K, Jfit.FitConfig(**cfg), image_size=S, mask=mask,
                                init={k: j(v) for k, v in init.items()}, lmk_conf=conf)
    tp, ti = Tfit.fit_landmarks(tm, lmk, K, Tfit.FitConfig(**cfg), image_size=S, mask=mask,
                                init=dict(init), lmk_conf=conf)
    assert ti.keys() == ji.keys() == {"loss_silhouette", "mean_px_err"}
    assert np.isnan(ji["mean_px_err"]) and np.isnan(ti["mean_px_err"])
    assert ti["loss_silhouette"] == pytest.approx(ji["loss_silhouette"], rel=1e-5)
    want = Jsil._verts_px(jm, jp, K)[:, :2]
    assert np.abs(Jsil._verts_px(jm, tp, K)[:, :2] - want).max() < 0.01
    assert np.abs(Jsil._verts_px(jm, init, K)[:, :2] - want).max() > 2.0
