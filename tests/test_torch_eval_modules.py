"""Port parity of the eval harness's modules against the JAX package on the
CPU, fp32, on weights carried across: the metrics (numpy copies, 1e-12),
CLIP features (1e-4), LPIPS at 64^2 (1e-5 relative), IR-SE50 descriptors
(B=2, 112^2; 1e-4) from a JAX tree and from a reference-named state_dict,
the landmark net at 64^2 (coordinates 1e-3 px, heatmaps 1e-5 relative L2),
and the port's copies of `data/common.py::load_mask` and the synthetic
landmark tool (equal)."""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from morphablediffusion_torch.data import common as Tcommon
from morphablediffusion_torch.eval import irse as Tirse
from morphablediffusion_torch.eval import keypoint_net as Tkn
from morphablediffusion_torch.eval import lpips_vgg as Tlpips
from morphablediffusion_torch.eval import metrics as TM
from morphablediffusion_torch.models import clip as Tclip
from morphablediffusion_torch.weights import flatten_tree
from morphablediffusion_tpu.data import common as Jcommon
from morphablediffusion_tpu.eval import irse as Jirse
from morphablediffusion_tpu.eval import keypoint_net as Jkn
from morphablediffusion_tpu.eval import lpips_vgg as Jlpips
from morphablediffusion_tpu.eval import metrics as JM
from morphablediffusion_tpu.models import clip as Jclip
from morphablediffusion_tpu.utils.config import ModelConfig
from tests.torch_parity import assert_close, cf, load_into, seeded_tree

REPO = Path(__file__).resolve().parents[1]


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_metrics_match_jax(rng):
    a = rng.uniform(0, 1, (24, 20, 3))
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1)
    mask = rng.uniform(0, 1, (24, 20))
    fa, fb = rng.normal(size=(40, 6)), rng.normal(0.3, 1.2, (40, 6))
    kp = rng.uniform(0, 32, (5, 68, 2))
    kg = kp + rng.normal(0, 1.5, kp.shape)
    dists = rng.uniform(0, 1.2, 50)
    for name, args in (("psnr", (a, b)), ("ssim", (a, b)), ("ssim", (a[..., 0], b[..., 0])),
                       ("frechet_distance", (fa, fb)), ("pck", (kp, kg)),
                       ("reid_rate", (dists, 0.55))):
        want = getattr(JM, name)(*args)
        assert getattr(TM, name)(*args) == pytest.approx(want, rel=1e-12, abs=1e-12), name
    assert TM.psnr(a, a) == JM.psnr(a, a) == float("inf")
    np.testing.assert_array_equal(TM.masked(a, mask), JM.masked(a, mask))


def test_clip_features_match_jax(rng):
    """eval_2d's FID features: the port's CLIPImageEncoder on [0, 1] images."""
    mcfg = ModelConfig()
    mcfg.clip.width, mcfg.clip.layers, mcfg.clip.num_heads = 32, 1, 2
    mcfg.clip.patch_size, mcfg.clip.output_dim = 14, 16
    c = mcfg.clip
    kw = dict(width=c.width, layers=c.layers, num_heads=c.num_heads, patch_size=c.patch_size,
              output_dim=c.output_dim)
    images = rng.uniform(0, 1, (3, 32, 32, 3)).astype(np.float32)
    params = seeded_tree(jax.eval_shape(
        lambda: Jclip.CLIPImageEncoder(**kw).init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))))
    want = JM.clip_features(images, params, mcfg)
    got = TM.clip_features(images, load_into(Tclip.CLIPImageEncoder(**kw), params))
    assert got.shape == want.shape == (3, 16)
    assert_close(got, want, 1e-4)


def _lpips_files(rng, lin_naming: str):
    """Seeded weights under the published namings: torchvision's
    `features.N.*` (plus a classifier key the importer skips) and the lpips
    calibration's `linN.model.1.weight` or `lins.N.model.1.weight`."""
    vgg, cin = {"classifier.0.weight": rng.normal(size=(4, 4)).astype(np.float32)}, 3
    for idx, width in Jlpips.VGG_CONVS:
        vgg[f"features.{idx}.weight"] = rng.normal(
            0, (9 * cin) ** -0.5, (width, cin, 3, 3)).astype(np.float32)
        vgg[f"features.{idx}.bias"] = rng.normal(0, 0.02, width).astype(np.float32)
        cin = width
    widths = dict(Jlpips.VGG_CONVS)
    lins = {(f"lin{s}.model.1.weight" if lin_naming == "linN" else f"lins.{s}.model.1.weight"):
            rng.uniform(0, 0.1, (1, widths[i], 1, 1)).astype(np.float32)
            for s, i in enumerate(Jlpips.STAGE_ENDS)}
    return vgg, lins


@pytest.mark.parametrize("lin_naming", ["linN", "lins.N"])
def test_lpips_matches_jax(rng, lin_naming, tmp_path):
    vgg, lins = _lpips_files(rng, lin_naming)
    a = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), 0, 1).astype(np.float32)
    jparams, jreport = Jlpips.import_lpips_weights(vgg, lins)
    want = Jlpips.lpips_distance(a, b, jparams)
    sd, report = Tlpips.import_lpips_weights(vgg, lins)
    assert report == jreport
    net = Tlpips.LPIPSVGG()
    net.load_state_dict(sd, strict=True)
    got = Tlpips.lpips_distance(a, b, net.eval())
    assert got.shape == (2,) and rel_l2(got, want) <= 1e-5, (got, want)
    # the CLI's loader: the two files as published, one pair at a time (eval_2d)
    torch.save({k: torch.from_numpy(v) for k, v in vgg.items()}, tmp_path / "vgg.pth")
    torch.save({k: torch.from_numpy(v) for k, v in lins.items()}, tmp_path / "lin.pth")
    dist = Tlpips.load_lpips(str(tmp_path / "vgg.pth"), str(tmp_path / "lin.pth"), "cpu")
    assert next(dist.keywords["net"].parameters()).device.type == "cpu"
    for i in range(2):
        assert float(dist([a[i]], [b[i]])[0]) == pytest.approx(float(want[i]), rel=1e-5)


def _irse_tree():
    """A seeded JAX IRSE50 tree with non-trivial BatchNorm statistics."""
    rng = np.random.default_rng(5)
    tree = seeded_tree(jax.eval_shape(
        lambda: Jirse.IRSE50().init(jax.random.key(0), jnp.zeros((1, 112, 112, 3)))))

    def leaf(path, v):
        name = str(path[-1].key)
        if name == "mean":
            return rng.normal(0, 0.2, v.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        if name == "weight":  # PReLU slopes
            return rng.uniform(0.1, 0.4, v.shape).astype(np.float32)
        return v
    return jax.tree_util.tree_map_with_path(leaf, tree)


def test_irse50_from_jax_tree(rng):
    params = _irse_tree()
    x = (rng.normal(size=(2, 112, 112, 3)) * 0.5).astype(np.float32)
    want = jax.jit(Jirse.IRSE50().apply)(params, jnp.asarray(x))
    net = Tirse.IRSE50()
    sd = Tirse.from_jax_params(flatten_tree(params["params"]))
    missing, unexpected = net.load_state_dict(sd, strict=False)
    assert unexpected == [] and all(k.endswith("num_batches_tracked") for k in missing)
    assert len(sd) == len(flatten_tree(params["params"]))
    with torch.no_grad():
        got = net.eval()(cf(x))
    assert got.shape == (2, 512)
    assert_close(got, want, 1e-4)


@pytest.mark.parametrize("prefix", ["", "facenet."])
def test_irse50_reference_state_dict(rng, tmp_path, prefix):
    """A reference-named state_dict (the port's own module's, seeded, with
    non-trivial running statistics) loads strictly into the port and through
    the JAX importer; both give the same descriptors, also through the
    host-side front end (resize 256, crop, resize 112)."""
    ref = Tirse.seeded_irse50(3)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for mod in ref.modules():
            if isinstance(mod, Tirse.FrozenBatchNorm):
                mod.running_mean.normal_(0, 0.2, generator=g)
                mod.running_var.uniform_(0.5, 2.0, generator=g)
    torch.save({prefix + k: v for k, v in ref.state_dict().items()}, tmp_path / "ir_se50.pth")
    net = Tirse.load_irse50(tmp_path / "ir_se50.pth", "cpu")
    sd = {k: v.numpy() for k, v in ref.state_dict().items()}
    like = Jirse.IRSE50().init(jax.random.key(0), jnp.zeros((1, 112, 112, 3)))
    params, report = Jirse.import_irse_state_dict(
        {prefix + k: v for k, v in sd.items()}, like)
    assert not report["unmatched_model_paths"] and not report["unused_torch_keys"]
    x = (rng.normal(size=(2, 112, 112, 3)) * 0.5).astype(np.float32)
    want = jax.jit(Jirse.IRSE50().apply)(params, jnp.asarray(x))
    with torch.no_grad():
        assert_close(net(cf(x)), want, 1e-4)
    images = rng.uniform(0, 1, (2, 96, 96, 3)).astype(np.float32)
    assert_close(Tirse.face_descriptors(images, net), Jirse.face_descriptors(images, params),
                 1e-4)


def _landmark_tree(S: int, seed: int = 0):
    return seeded_tree(jax.eval_shape(
        lambda: Jkn.LandmarkNet().init(jax.random.key(0), jnp.zeros((1, S, S, 3)))), seed)


def test_landmark_net_matches_jax(rng):
    """Coordinates, heatmaps, the loss, and the head's pre-SiLU feature
    (flax's GroupNorm_1 output: calibrate_reid's landmark descriptor)."""
    S = 64
    params = _landmark_tree(S)
    x = rng.uniform(0, 1, (2, S, S, 3)).astype(np.float32)
    kpts = rng.uniform(0, S, (2, 68, 2)).astype(np.float32)
    (coords, maps), state = Jkn.LandmarkNet().apply(
        params, jnp.asarray(x),
        capture_intermediates=lambda mdl, _: type(mdl).__name__ == "GroupNorm")
    loss = Jkn.keypoint_loss(params, Jkn.LandmarkNet().apply, jnp.asarray(x), jnp.asarray(kpts))
    net = Tkn.LandmarkNet()
    net.load_state_dict(Tkn.from_jax_params(flatten_tree(params["params"])), strict=True)
    net.eval()
    with torch.no_grad():
        t_coords, t_maps = net(cf(x))
        feats = net.trunk(cf(x))
        t_loss = Tkn.keypoint_loss(net, cf(x), torch.from_numpy(kpts))
    assert t_coords.shape == (2, 68, 2) and t_maps.shape == (2, 68, S // 4, S // 4)
    np.testing.assert_allclose(t_coords.numpy(), np.asarray(coords), rtol=0, atol=1e-3)
    assert rel_l2(t_maps.numpy(), maps) <= 1e-5
    assert float(t_loss) == pytest.approx(float(loss), rel=1e-5)
    pre_silu = state["intermediates"]["GroupNorm_1"]["__call__"][0]
    assert rel_l2(feats.permute(0, 2, 3, 1).numpy(), pre_silu) <= 1e-5
    # detect() in chunks, as eval_keypoints calls it
    np.testing.assert_allclose(Tkn.detect(net, x, chunk=1), np.asarray(coords), rtol=0,
                               atol=1e-3)


def test_soft_argmax_matches_jax(rng):
    maps = rng.normal(0, 3, (2, 5, 6, 8)).astype(np.float32)
    want = Jkn.soft_argmax(jnp.asarray(maps))
    np.testing.assert_allclose(Tkn.soft_argmax(torch.from_numpy(maps)).numpy(),
                               np.asarray(want), rtol=0, atol=1e-5)


def test_landmark_params_round_trip(tmp_path):
    net = Tkn.seeded_net(1)
    Tkn.save_params(tmp_path / "net.pt", net)
    back = Tkn.load_params(tmp_path / "net.pt", "cpu")
    assert back.num_keypoints == 68
    for (k, v), (k2, v2) in zip(net.state_dict().items(), back.state_dict().items()):
        assert k == k2 and torch.equal(v, v2)
    assert not torch.equal(Tkn.seeded_net(2).Conv_0.weight, net.Conv_0.weight)


@pytest.mark.parametrize("mode", ["RGBA", "RGB"])
def test_load_mask_matches_jax(rng, tmp_path, mode):
    img = rng.integers(0, 255, (40, 30, len(mode)), dtype=np.uint8)
    Image.fromarray(img, mode).save(tmp_path / "v.png")
    for size in (32, 64):
        np.testing.assert_array_equal(Tcommon.load_mask(tmp_path / "v.png", size),
                                      Jcommon.load_mask(tmp_path / "v.png", size))


@pytest.mark.parametrize("flags", [[], ["--mesh_vertices", "200", "--count", "20"]])
def test_landmark_tool_writes_the_same_file(tmp_path, flags):
    from morphablediffusion_torch.tools import make_synthetic_landmarks as port_tool

    spec = importlib.util.spec_from_file_location(
        "jax_landmark_tool", REPO / "tools" / "make_synthetic_landmarks.py")
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    jax_tool.main(["--out", str(tmp_path / "jax.json"), *flags])
    port_tool.main(["--out", str(tmp_path / "port.json"), *flags])
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert len(json.loads((tmp_path / "port.json").read_text())) == (20 if flags else 68)
