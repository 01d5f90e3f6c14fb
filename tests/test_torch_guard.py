"""Guards of the PyTorch port's boundaries.

  * the package imports neither JAX nor the JAX package, and no file of it
    names the JAX package;
  * `from_jax_params` + `load_state_dict(strict=True)` covers the whole
    tiny parameter tree of the served model;
  * the entry points raise without a CUDA card unless the CPU is asked for;
  * `chip_smoke.py` fails without a card and prints no result, and the main
    path it counts launches on is the serving avatar's (500 + 250), also
    through the generate_face CLI (phase 8).
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

import chip_smoke
from morphablediffusion_torch import weights
from morphablediffusion_torch.models.diffusion import MorphableDiffusion as TModel
from morphablediffusion_torch.utils import config as port_config
from morphablediffusion_torch.utils import resolve_device
from morphablediffusion_tpu.models.diffusion import MorphableDiffusion as JModel
from tests.torch_parity import _init_inference
from tests.tiny import tiny_batch, tiny_config
from tests.torch_parity import port_model_config, seeded_tree

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "morphablediffusion_torch"


def _run(code: str, cwd=REPO, **env):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=300, env={**os.environ, **env})


def test_package_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import morphablediffusion_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'morphablediffusion_tpu'))\n"
        "print('BAD', bad)\n"
        "print('MODULES', sorted(n for n in sys.modules if n.startswith(p.__name__)))\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout
    for name in ("apps.generate_face", "apps.train", "apps.train_vae", "data.thuman",
                 "ops.int8", "preprocessing.matting", "tools.make_synthetic_facescape",
                 "utils.mesh_io", "utils.torch_import", "eval.metrics", "eval.lpips_vgg",
                 "eval.irse", "eval.keypoint_net", "apps.eval_select_views",
                 "apps.eval_generate", "apps.eval_keypoints", "apps.eval_2d",
                 "apps.train_keypoints", "apps.calibrate_reid",
                 "tools.make_synthetic_landmarks"):
        assert f"'morphablediffusion_torch.{name}'" in r.stdout, name


def test_no_file_names_the_jax_package():
    files = [f for f in PKG.rglob("*") if f.is_file() and "__pycache__" not in f.parts]
    assert any(f.suffix == ".cu" for f in files)
    named = [str(f) for f in files if b"morphablediffusion_tpu" in f.read_bytes()]
    assert named == []


def test_bridge_covers_the_whole_tiny_tree():
    cfg = tiny_config(view_num=2)
    jmodel = JModel(cfg.model)
    batch = tiny_batch(cfg, with_targets=False)
    params = seeded_tree(jax.eval_shape(
        lambda b: jmodel.init(jax.random.key(0), b, method=_init_inference), batch))
    flat = weights.flatten_tree(params["params"])
    port = TModel(port_model_config(cfg.model), device="cpu")
    sd = weights.from_jax_params(flat, device="cpu")
    assert len(sd) == len(flat)
    port.load_state_dict(sd, strict=True)  # raises on a missing or extra key
    assert any(k.startswith("spatial_volume.mesh_voxel.conv6") for k in sd)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    cfg = port_config.ModelConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TModel(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        weights.from_jax_params({})
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_fails_without_cuda():
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "kernels" not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    (tmp_path / "chip_smoke.py").write_bytes((REPO / "chip_smoke.py").read_bytes())
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_main_path_counts():
    k1, k2 = chip_smoke.main_path_shapes(port_config.Config())
    assert [(s["W"], s["D"], s["Cc"], s["Ci"], s["per_step"]) for s in k1] == [
        (4, 6, 512, 1024, 1), (8, 12, 256, 512, 2), (16, 24, 128, 256, 3),
        (32, 48, 64, 128, 4)]
    assert (k2["B"], k2["L"], k2["heads"], k2["hd"], k2["per_step"]) == (32, 1024, 8, 40, 5)
    assert 50 * sum(s["per_step"] for s in k1) == 500 and 50 * k2["per_step"] == 250
    # of K1's 500 launches per avatar, W=32 and W=16 take the Hopper design,
    # W=8 and W=4 the cluster design, none the WMMA design
    assert {n: 50 * c for n, c in chip_smoke.k1_launches(k1).items()} == {
        "depth_attention_ctx_wgmma": 350, "depth_attention_ctx_cluster": 150,
        "depth_attention_ctx": 0}
    # phase 8, the generate_face CLI: demo/mesh.obj selects the fine grid
    # (112, 120, 116) at 0.005 m, whose avatar launches K1 and K2 as the
    # main path does; the W8A8 drift gate is twice the JAX study's error
    from morphablediffusion_torch.apps.generate_face import autoselect_fine_conditioner
    from morphablediffusion_torch.utils.mesh_io import load_mesh_vertices

    fine = port_config.Config()
    assert autoselect_fine_conditioner(fine.model, {"spatial_volume.xyzc_net.w": None},
                                       load_mesh_vertices(REPO / chip_smoke.CLI_MESH))
    assert tuple(fine.model.fine_grid_shape) == chip_smoke.CLI_FINE_GRID == (112, 120, 116)
    assert chip_smoke.main_path_shapes(fine) == (k1, k2)
    study = json.loads((REPO / "artifacts" / "int8_trajectory.json").read_text())
    assert chip_smoke.W8A8_MAX_REL_L2 == pytest.approx(2 * study["final_rel_l2"], abs=1e-6)
    assert chip_smoke.W8A8_MIN_PSNR == 37.0 < study["final_image_psnr_bf16_vs_w8a8"]
    assert (chip_smoke.W8A8_SEED, chip_smoke.W8A8_STEPS) == (study["seed"], study["sample_steps"])
    for path in (chip_smoke.CLI_INPUT, chip_smoke.CLI_MESH, chip_smoke.CLI_PHOTO,
                 chip_smoke.CLI_PLY, chip_smoke.CLI_CONFIG):
        assert (REPO / path).is_file(), path


def test_chip_smoke_training_counts():
    """The training path's shapes and launches per step (remat on: every
    forward twice): K1 at the DepthTransformers of width >= 8, K3 at the
    W=4 middle block, K2 at the five ds=1 self-attentions, one target view
    per sample."""
    shapes = chip_smoke.train_shapes(port_config.Config(), 8)
    assert [(s["B"], s["W"], s["D"], s["Cc"], s["Ci"], s["per_step"])
            for s in shapes["k1"]] == [(8, 8, 12, 256, 512, 4), (8, 16, 24, 128, 256, 6),
                                       (8, 32, 48, 64, 128, 8)]
    assert [(s["B"], s["W"], s["D"], s["C"], s["per_step"]) for s in shapes["k3"]] == [
        (8, 4, 6, 1024, 2), (8, 8, 12, 512, 0), (8, 16, 24, 256, 0), (8, 32, 48, 128, 0)]
    k2 = shapes["k2"]
    assert (k2["B"], k2["L"], k2["heads"], k2["hd"], k2["per_step"], k2["bwd_per_step"]) == (
        8, 1024, 8, 40, 10, 5)
    launches = chip_smoke.train_expected_launches(shapes)
    assert launches == {
        "depth_attention_ctx_wgmma": 14, "depth_attention_ctx_cluster": 4,
        "depth_attention_ctx": 0, "depth_attention": 2,
        "flash_attention": 10, "flash_attention_bwd_dkv": 5, "flash_attention_bwd_dq": 5}
    # K1's 18 launches per step, over its three designs (W=16 and 32; W=8; none)
    assert (launches["depth_attention_ctx_wgmma"] + launches["depth_attention_ctx_cluster"]
            + launches["depth_attention_ctx"]) == 18


def test_chip_smoke_batch_is_the_bench_batch():
    """The smoke batch is tests/tiny.py's generator at the flagship sizes,
    which is what bench.py feeds the JAX package."""
    jcfg = tiny_config(view_num=3)
    pcfg = port_config.Config()
    pcfg.model = port_model_config(jcfg.model)
    ours = chip_smoke.flagship_batch(pcfg, "cpu")
    ref = tiny_batch(jcfg, B=1, with_targets=False)
    assert ours.keys() == ref.keys()
    for k in ref:
        torch.testing.assert_close(ours[k], torch.tensor(jax.device_get(ref[k])), rtol=0,
                                   atol=0)


def test_chip_smoke_synth_scratch_counts():
    """Phase 9's synth_scratch path under the JAX gate: in training (batch 8,
    remat) K1 at W=8 only (the Hopper design, G=2), K3 at W=16, 4 and 2, no
    K2 (L=256 takes SDPA); at serving (a chunk of 2 samples x 4 views) K1 at
    W=8 and W=4 (the WMMA design) and K3 at W=16 and 2."""
    cfg = port_config.load_config(chip_smoke.SYNTH_CONFIG)
    shapes = chip_smoke.train_shapes(cfg, 8)
    assert [(s["W"], s["Cc"], s["per_step"]) for s in shapes["k1"]] == [(8, 64, 6)]
    assert [(s["W"], s["C"], s["D"], s["per_step"]) for s in shapes["k3"]] == [
        (2, 512, 6, 2), (4, 256, 12, 4), (8, 128, 24, 0), (16, 64, 48, 8)]
    assert shapes["k2"]["per_step"] == shapes["k2"]["bwd_per_step"] == 0
    assert chip_smoke.train_expected_launches(shapes) == {
        "depth_attention_ctx_wgmma": 6, "depth_attention_ctx_cluster": 0,
        "depth_attention_ctx": 0, "depth_attention": 14,
        "flash_attention": 0, "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0}
    B = cfg.model.output_num * cfg.model.batch_view_num
    k1 = [s for s in chip_smoke.depth_blocks(cfg, B, train=False) if s["fused"]]
    assert chip_smoke.k1_launches(k1) == {
        "depth_attention_ctx_wgmma": 3, "depth_attention_ctx_cluster": 0,
        "depth_attention_ctx": 2}
    assert [(s["W"], s["C"], s["per_step"]) for s in chip_smoke.serving_k3_shapes(cfg, B)] == [
        (2, 512, 1), (16, 64, 4)]
    # Config()'s serving path has no unfused block
    assert chip_smoke.serving_k3_shapes(port_config.Config(), 16) == []


def test_chip_smoke_eval_counts():
    """Phase 10: eval_generate's 20 targets at Config()'s 16 views make 2
    view groups, so a sampler call runs at B=2: K1 at 32 views (350 + 150 +
    0 launches a call, by design, as the avatar's) and K2 at B=64 (250);
    LandmarkNet launches K4 once per GroupNorm, 14 a forward."""
    from morphablediffusion_torch.eval.keypoint_net import LandmarkNet
    from morphablediffusion_torch.models.layers import GroupNorm

    cfg = port_config.Config()
    groups = math.ceil(chip_smoke.EVAL_VIEWS / cfg.model.view_num)
    assert groups == chip_smoke.EVAL_LIMIT == 2
    k1 = [s for s in chip_smoke.depth_blocks(cfg, groups * cfg.model.view_num, train=False)
          if s["fused"]]
    assert [(s["B"], s["W"]) for s in k1] == [(32, 4), (32, 8), (32, 16), (32, 32)]
    assert {n: 50 * c for n, c in chip_smoke.k1_launches(k1).items()} == {
        "depth_attention_ctx_wgmma": 350, "depth_attention_ctx_cluster": 150,
        "depth_attention_ctx": 0}
    assert 50 * chip_smoke.main_path_shapes(cfg)[1]["per_step"] == 250
    assert sum(isinstance(m, GroupNorm) for m in LandmarkNet().modules()) == (
        chip_smoke.LANDMARK_NORMS)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_chip_smoke_group_norm_fp64_gate(dtype):
    """K4's accuracy gate in chip_smoke.py: `gn_exact` is GroupNorm in fp64
    (torch's own on doubles, 1e-12), the plain version passes the gate
    against itself and lies within its dtype's rounding of the exact
    result, and eps x 10 fails the gate at a shape of 131 072 outputs."""
    import torch.nn.functional as F

    from morphablediffusion_torch.ops import group_norm as gn

    key = ((2, 64, 32, 32), dtype, 8, "silu", True, 1e-6)
    args = chip_smoke.gn_inputs(key, torch.Generator().manual_seed(0), "cpu")
    x, shift, gamma, beta = args[:4]
    exact = chip_smoke.gn_exact(*args)
    want = F.silu(F.group_norm(x.double() + shift.double()[..., None, None], 8,
                               gamma.double(), beta.double(), 1e-6))
    assert float((exact - want).abs().max()) < 1e-12
    dist = lambda y: float((y.double() - exact).norm() / exact.norm())
    plain = dist(gn._reference(*args))
    assert plain < {torch.bfloat16: 3e-3, torch.float32: 3e-7}[dtype]
    margin = chip_smoke.K4_MARGIN[dtype] + chip_smoke.K4_FLIPS / x.numel()
    assert dist(gn._reference(*args)) / plain - 1 <= margin
    assert dist(gn._reference(*args[:5], 1e-5, "silu")) / plain - 1 > margin
