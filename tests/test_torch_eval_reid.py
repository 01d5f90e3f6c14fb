"""The port's Re-ID calibration and eval stage 4 against the JAX package's on
the CPU, and the eval apps' device rule:

  * calibrate_reid: the landmark descriptors (the last head GroupNorm's
    output before SiLU, pooled) within 1e-5, and both CLIs' artifacts with
    both embedders and both pairings (distances' statistics and the EER
    threshold within 1e-5, the histograms equal);
  * eval_2d: the whole result dict of all five metrics on
    tests/test_eval_cli.py's fixture (generated == GT), on the GT as eval_2d
    loads it, and on a perturbed strip: SSIM, PSNR, PCK and Re-ID equal, LPIPS within 1e-5 relative, FID
    within 1e-4; IR-SE50 weights from the port's own module, LPIPS from
    seeded files in the published namings, CLIP from a reference-named
    checkpoint;
  * every app that runs a network raises without a CUDA card unless given
    `--device cpu`; the numpy-only paths need no card.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from morphablediffusion_torch.apps import calibrate_reid as Tcal
from morphablediffusion_torch.apps import eval_2d as T2d
from morphablediffusion_torch.apps import eval_generate as Tgen
from morphablediffusion_torch.apps import eval_keypoints as Tkp
from morphablediffusion_torch.apps import train_keypoints as Ttrain
from morphablediffusion_torch.eval import irse as Tirse
from morphablediffusion_torch.eval import keypoint_net as Tkn
from morphablediffusion_torch.weights import flatten_tree
from morphablediffusion_tpu.apps import calibrate_reid as Jcal
from morphablediffusion_tpu.apps import eval_2d as J2d
from morphablediffusion_tpu.eval import irse as Jirse
from morphablediffusion_tpu.eval import keypoint_net as Jkn
from tests.test_eval_cli import eval_fixture  # noqa: F401  (a fixture)
from tests.test_torch_eval_modules import _lpips_files
from tests.torch_parity import seeded_tree

SIZE = 32


@pytest.fixture(scope="module")
def views_tree(tmp_path_factory):
    """2 subjects x 2 expressions x 3 shared view ids of 32^2 RGBA views, a
    subject-specific base colour (test_eval_cli.py's calibration layout)."""
    root = tmp_path_factory.mktemp("reid") / "data"
    rng = np.random.default_rng(0)
    for sub in ("001", "002"):
        base = rng.integers(40, 200, 3)
        for exp in ("01", "02"):
            for v in range(3):
                img = np.clip(base + rng.integers(-20, 20, (SIZE, SIZE, 3)), 0, 255)
                rgba = np.concatenate([img, np.full((SIZE, SIZE, 1), 255)], -1).astype(np.uint8)
                vd = root / sub / exp / f"view_{v:05d}"
                vd.mkdir(parents=True)
                Image.fromarray(rgba, "RGBA").save(vd / "rgba_colorcalib.png")
    return root


@pytest.fixture(scope="module")
def landmark_files(tmp_path_factory):
    """The same seeded landmark net as a flax msgpack and as the port's .pt."""
    d = tmp_path_factory.mktemp("landmark")
    params = seeded_tree(jax.eval_shape(
        lambda: Jkn.LandmarkNet().init(jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)))), 2)
    Jkn.save_params(str(d / "net.msgpack"), params)
    net = Tkn.LandmarkNet()
    net.load_state_dict(Tkn.from_jax_params(flatten_tree(params["params"])), strict=True)
    Tkn.save_params(d / "net.pt", net)
    return d / "net.msgpack", d / "net.pt"


@pytest.fixture(scope="module")
def irse_file(tmp_path_factory):
    """A reference-named IR-SE50 state_dict: the port's own module, seeded,
    with non-trivial running statistics."""
    net = Tirse.seeded_irse50(2)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, Tirse.FrozenBatchNorm):
                mod.running_mean.normal_(0, 0.2, generator=g)
                mod.running_var.uniform_(0.5, 2.0, generator=g)
    path = tmp_path_factory.mktemp("irse") / "ir_se50.pth"
    torch.save(net.state_dict(), path)
    return path


def test_landmark_descriptors_match_jax(views_tree, landmark_files):
    paths = sorted(views_tree.rglob("*.png"))
    imgs = Tcal._load(paths, SIZE)
    np.testing.assert_array_equal(imgs, Jcal._load(paths, SIZE))
    want = Jcal._landmark_descriptors(imgs, str(landmark_files[0]), SIZE)
    got = Tcal._landmark_descriptors(imgs, str(landmark_files[1]), "cpu")
    assert got.shape == want.shape == (12, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("embedder,pairing", [("landmark", "same_view"),
                                              ("landmark", "any_view"),
                                              ("irse", "same_view")])
def test_calibrate_reid_matches_jax(views_tree, landmark_files, irse_file, tmp_path,
                                    monkeypatch, embedder, pairing):
    """JAX's irse path keeps `import_irse_state_dict`'s (params, report)
    pair as its parameters and cannot apply them; the JAX side is patched
    to take the pair's first element (ROADMAP Queue C)."""
    importer = Jirse.import_irse_state_dict
    monkeypatch.setattr(Jirse, "import_irse_state_dict", lambda sd, like: importer(sd, like)[0])
    args = ["--data_dir", str(views_tree), "--embedder", embedder, "--pairs", "12",
            "--pairing", pairing, "--image_size", str(SIZE), "--seed", "3"]
    if embedder == "landmark":
        jw, tw = ["--weights", str(landmark_files[0])], ["--weights", str(landmark_files[1])]
    else:
        jw = tw = ["--reid_weights", str(irse_file)]
    Jcal.main(args + jw + ["--out", str(tmp_path / "jax.json")])
    result = Tcal.main(args + tw + ["--out", str(tmp_path / "port.json"), "--device", "cpu"])
    ref = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == result
    assert result.keys() == ref.keys()
    for k in ("embedder", "pairing", "n_pairs", "hist_same", "hist_diff"):
        assert result[k] == ref[k], k
    for k in ("eer_threshold", "eer"):
        assert result[k] == pytest.approx(ref[k], abs=1e-5), k
    # d' divides the gap between the classes' means by their pooled spread,
    # which is small next to it: d' ~ 40 carries the distances' rounding x 1e2
    assert result["d_prime"] == pytest.approx(ref["d_prime"], rel=1e-4)
    for cls in ("same", "diff"):
        for stat in ("mean", "std"):
            assert result[cls][stat] == pytest.approx(ref[cls][stat], abs=1e-5)
    np.testing.assert_allclose(result["hist_bins"], ref["hist_bins"], rtol=0, atol=1e-5)


def _five_metric_args(root, gen_dir, views_json, gt_kpts, pred_kpts, tmp_path, irse_file):
    """eval_2d's flags for all five metrics, with the weight files written
    under tmp_path: a reference-named checkpoint holding exactly the CLIP
    tower (as tests/test_eval_cli.py writes it), and seeded LPIPS files."""
    from morphablediffusion_tpu.models.clip import CLIPImageEncoder
    from morphablediffusion_tpu.utils import torch_import as ti
    from test_torch_import import _get, _torch_shape

    cfg_path = tmp_path / "eval.yaml"
    cfg_path.write_text(
        "model:\n  image_size: 32\n  max_vertices: 16\n  view_num: 2\n"
        "  clip:\n    width: 32\n    layers: 1\n    num_heads: 2\n"
        "    patch_size: 14\n    output_dim: 16\n")
    enc = CLIPImageEncoder(width=32, layers=1, num_heads=2, patch_size=14, output_dim=16)
    like = jax.eval_shape(lambda: enc.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3))))
    rng = np.random.default_rng(3)
    sd = {}
    for tkey, opath, kind in ti.clip_mapping(layers=1):
        leaf = _get(like["params"], opath.split("/", 1)[1])
        if leaf is not None:
            sd[tkey] = torch.from_numpy(rng.normal(0, 0.05, _torch_shape(
                kind, opath.rsplit("/", 1)[-1], leaf.shape)).astype(np.float32))
    torch.save({"state_dict": sd}, tmp_path / "clip.ckpt")
    vgg, lins = _lpips_files(np.random.default_rng(4), "linN")
    torch.save({k: torch.from_numpy(v) for k, v in vgg.items()}, tmp_path / "vgg.pth")
    torch.save({k: torch.from_numpy(v) for k, v in lins.items()}, tmp_path / "lin.pth")
    return ["--data_dir", str(root / "data"), "--generated_dir", str(gen_dir),
            "--views_json", str(views_json), "--image_size", "32",
            "--pred_kpts", str(pred_kpts), "--gt_kpts", str(gt_kpts),
            "--ckpt", str(tmp_path / "clip.ckpt"), "--cfg", str(cfg_path),
            "--reid_weights", str(irse_file), "--reid_threshold", "0.6",
            "--lpips_vgg", str(tmp_path / "vgg.pth"), "--lpips_lin", str(tmp_path / "lin.pth")]


@pytest.mark.parametrize("generated", ["ground_truth", "as_loaded", "perturbed"])
def test_eval_2d_all_five_metrics_match_jax(eval_fixture, irse_file, tmp_path,  # noqa: F811
                                            generated):
    """ground_truth: the fixture's strip, the GT views' pixels; as_loaded:
    the GT views as eval_2d loads them, rounded to uint8 (`load_rgba_white`
    truncates rgb * 255, so a GT pixel can load one level below the file's);
    perturbed: the fixture's strip plus noise."""
    root, views_json, gen_dir, gt_kpts, pred_kpts = eval_fixture
    strip = sorted(gen_dir.glob("*.png"))[0]
    if generated == "perturbed":
        img = np.asarray(Image.open(strip)).astype(np.int16)
        noise = np.random.default_rng(7).integers(-40, 40, img.shape)
        Image.fromarray(np.clip(img + noise, 0, 255).astype(np.uint8)).save(strip)
    elif generated == "as_loaded":
        subject, exp = strip.stem.split("_")
        views = json.loads(views_json.read_text())[subject][exp]["target_views"]
        tiles = [T2d._load_gt(root / "data" / subject / exp / f"view_{int(v):05d}", 32)[0]
                 for v in views]
        Image.fromarray(np.round(np.concatenate(tiles, axis=1) * 255).astype(np.uint8)).save(
            strip)
    args = _five_metric_args(root, gen_dir, views_json, gt_kpts, pred_kpts, tmp_path, irse_file)
    ref = J2d.main(args)
    ours = T2d.main(args + ["--device", "cpu"])
    assert ours.keys() == ref.keys() and "unavailable_backends" not in ours
    for k in ("pairs", "ssim", "psnr", "pck@0.2", "re_id"):
        assert ours[k] == ref[k], k
    assert ours["lpips"] == pytest.approx(ref["lpips"], rel=1e-5)
    assert ours["fid"] == pytest.approx(ref["fid"], abs=1e-4)
    if generated != "perturbed":  # JAX's perfect-case test
        assert ours["ssim"] > 0.99 and ours["fid"] < 1e-3
        assert ours["re_id"] == 1.0 and ours["pck@0.2"] == 1.0
        # one level at some pixels is 7e-6 of LPIPS on these seeded weights
        assert ours["lpips"] < (1e-6 if generated == "as_loaded" else 1e-4)
    else:
        assert ours["lpips"] > 1e-3 and ours["ssim"] < 0.99

    with pytest.raises(SystemExit, match="morphablediffusion_torch.apps.calibrate_reid"):
        T2d.main(args[:args.index("--reid_threshold")] + ["--device", "cpu"])


def test_eval_2d_reports_why_metrics_are_missing(eval_fixture):  # noqa: F811
    """Without network flags: SSIM, PSNR and PCK on the host, no card
    needed, and the same self-describing nulls as the JAX app's."""
    root, views_json, gen_dir, gt_kpts, pred_kpts = eval_fixture
    args = ["--data_dir", str(root / "data"), "--generated_dir", str(gen_dir),
            "--views_json", str(views_json), "--image_size", "32",
            "--pred_kpts", str(pred_kpts), "--gt_kpts", str(gt_kpts)]
    ref = J2d.main(args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        ours = T2d.main(args)
    assert ours == ref
    assert set(ours["unavailable_backends"]) == {"lpips", "re_id", "fid"}


def test_network_apps_raise_without_cuda(monkeypatch, views_tree, landmark_files, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    meta = tmp_path / "views.json"
    meta.write_text(json.dumps({}))
    runs = [
        (Tgen.main, ["--data_dir", str(views_tree), "--mode", "nes", "--ckpt", "random"]),
        (Ttrain.main, ["--image_dir", str(views_tree), "--labels", "none.json",
                       "--out", str(tmp_path / "n.pt")]),
        (Tkp.main, ["--image_dir", str(views_tree), "--output", str(tmp_path / "k.json"),
                    "--weights", str(landmark_files[1])]),
        (Tcal.main, ["--data_dir", str(views_tree), "--out", str(tmp_path / "c.json")]),
        (Tcal.main, ["--data_dir", str(views_tree), "--out", str(tmp_path / "c.json"),
                     "--embedder", "landmark", "--weights", str(landmark_files[1])]),
        (T2d.main, ["--data_dir", str(views_tree), "--generated_dir", str(tmp_path),
                    "--views_json", str(meta), "--ckpt", "x.ckpt"]),
        (T2d.main, ["--data_dir", str(views_tree), "--generated_dir", str(tmp_path),
                    "--views_json", str(meta), "--lpips_vgg", "a", "--lpips_lin", "b"]),
    ]
    for main, argv in runs:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)


def test_eval_2d_reads_the_clip_tower_of_a_whole_model_checkpoint(tmp_path, rng):
    """The JAX app's `_load_clip_params` raises KeyError: 'unet' on a
    whole-model checkpoint (its importer pads the UNet's input conv, which
    the tower's tree lacks); the port imports the tower's keys alone, and
    its features are the model's own tower's."""
    from morphablediffusion_torch.models.diffusion import MorphableDiffusion
    from morphablediffusion_torch.utils.config import load_config
    from morphablediffusion_torch.utils.torch_import import export_torch_checkpoint
    from morphablediffusion_torch.weights import seeded_params
    from tests.test_cli_integration import TINY_YAML

    (tmp_path / "tiny.yaml").write_text(TINY_YAML)
    cfg = load_config(tmp_path / "tiny.yaml")
    model = seeded_params(MorphableDiffusion(cfg.model, device="cpu"), 0).eval()
    export_torch_checkpoint(model, tmp_path / "model.ckpt")
    with pytest.raises(KeyError, match="unet"):
        J2d._load_clip_params(str(tmp_path / "model.ckpt"), str(tmp_path / "tiny.yaml"))
    enc = T2d._load_clip_encoder(str(tmp_path / "model.ckpt"), str(tmp_path / "tiny.yaml"), "cpu")
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        want = model.clip_image_encoder(torch.from_numpy(x).permute(0, 3, 1, 2) * 2 - 1)[:, 0]
    np.testing.assert_array_equal(T2d._clip_features(list(x), enc), want.numpy())
