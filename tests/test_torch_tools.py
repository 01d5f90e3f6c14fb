"""The port's measurement tools (`morphablediffusion_torch/tools/`) against
their JAX twins in `tools/`, on the CPU at tiny sizes, and the serving
path's ordered mesh-voxel scatter:

  * make_flagship_ckpt: the leaves equal the JAX tool's draws bit for bit
    (coarse and fine trees), and the exported file goes through the JAX
    package's importer with no unused key and no unmatched path;
  * profile_step: chip_smoke.py's profiles are the tool's code;
  * memory_report --tiny: the parameter bytes by label and the AdamW
    moment bytes equal the JAX trainer's state tree, exactly;
  * every tool given the card and finding none raises;
  * `scatter_mean_voxels` gives the same grid ordered and unordered, the
    serving step asks for the ordered one and training does not.
The int8 trajectory is `test_torch_tools_int8.py`, the quality tools
`test_torch_tools_eval.py`."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphablediffusion_torch.tools import common
from tests.tiny import tiny_batch, tiny_config
from tests.torch_parity import jax_tool, port_model_config

REPO = Path(__file__).resolve().parents[1]


def test_tiny_config_is_the_tests_tiny_config():
    assert common.tiny_config(3).model == port_model_config(tiny_config(view_num=3).model)


# tool 4 ---------------------------------------------------------------------

@pytest.mark.parametrize("fine", [False, True])
def test_make_flagship_ckpt_matches_jax(tmp_path, fine):
    from morphablediffusion_torch.tools import make_flagship_ckpt as T
    from morphablediffusion_torch.utils.torch_import import export_torch_checkpoint
    from morphablediffusion_tpu.models.diffusion import MorphableDiffusion as JModel
    from morphablediffusion_tpu.utils import torch_import as jti
    from morphablediffusion_torch.weights import flatten_tree

    J = jax_tool("make_flagship_ckpt")
    cfg = tiny_config(view_num=2)
    if fine:
        cfg.model.mesh_voxel_mode = "fine"
    jmodel = JModel(cfg.model)
    names = ["params", "time", "noise", "view", "vae", "drop"]
    rngs = dict(zip(names, jax.random.split(jax.random.key(0), len(names))))
    abstract = jax.eval_shape(lambda r, b: jmodel.init(r, b, method="init_fn"), rngs,
                              tiny_batch(cfg, B=1))
    # the JAX tool's draws (make_flagship_ckpt.py's loop)
    rng = np.random.default_rng(3)
    flat, tree_def = jax.tree_util.tree_flatten_with_path(abstract)
    leaves = [J.leaf_init(str(getattr(p[-1], "key", p[-1])), s.shape, rng) for p, s in flat]
    want = flatten_tree(jax.tree_util.tree_unflatten(tree_def, leaves)["params"])

    pcfg = common.tiny_config(2)
    pcfg.model = port_model_config(cfg.model)
    model, n = T.flagship_model(pcfg, 3, "cpu")
    from morphablediffusion_torch.weights import to_jax_layout

    got = to_jax_layout(model, dict(model.named_parameters()))
    assert got.keys() == want.keys() and n == sum(v.size for v in want.values())
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)

    path = tmp_path / "flagship.ckpt"
    count = export_torch_checkpoint(model, path, torch.float16)
    like = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), abstract)
    _, report = jti.import_state_dict(jti.load_torch_state_dict(str(path)), like,
                                      clip_layers=cfg.model.clip.layers)
    assert report["filled"] == count > 0
    assert report["unused_torch_keys"] == [] and report["unmatched_model_paths"] == []


def test_tools_refuse_cuda_without_a_card(tmp_path, monkeypatch):
    from morphablediffusion_torch.tools import (eval_flame_fit, eval_landmark_net,
                                                int8_trajectory, make_flagship_ckpt,
                                                memory_report, profile_step)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "x")
    for main, argv in ((make_flagship_ckpt.main, ["--out", out]),
                       (int8_trajectory.main, ["--ckpt", "random", "--out", out]),
                       (memory_report.main, ["--tiny", "--device", "cuda"]),
                       (profile_step.main, []),
                       (eval_flame_fit.main, ["--out", out]),
                       (eval_landmark_net.main, ["--weights", out, "--image_dir", out,
                                                 "--landmarks", out, "--mesh", out])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)


# tool 5 ---------------------------------------------------------------------

def test_profile_step_is_chip_smokes():
    """chip_smoke.py's phase 5 (and its training and W8A8 profiles) use the
    tool's code; no copy is left there."""
    import chip_smoke
    from morphablediffusion_torch.tools import profile_step as P

    assert chip_smoke.profile_step is P.profile_step
    assert chip_smoke.profile_report is P.profile_report
    assert chip_smoke.device_events is P.device_events
    src = (REPO / "chip_smoke.py").read_text()
    assert "def kernel_group" not in src and "def profile_report" not in src
    assert chip_smoke.flagship_batch is common.flagship_batch
    assert P.kernel_group("void md_group_norm_kernel<float, 4>(...)") == "K4 group_norm"
    assert P.kernel_group("md_ctx_cluster_kernel<256, 2>") == "K1 depth_attention_ctx (cluster)"
    assert P.kernel_group("sm90_xmma_fprop_implicit_gemm") == "convolution (cuDNN)"
    assert P.kernel_group("pytorch_flash::flash_fwd_kernel") == "SDPA (PyTorch)"
    assert P.kernel_group("vectorized_elementwise_kernel") == "elementwise and other"


# tool 7 ---------------------------------------------------------------------

def test_memory_report_tiny_matches_the_jax_state():
    from morphablediffusion_torch.tools import memory_report as T
    from morphablediffusion_tpu.training.trainer import Trainer, param_labels

    ours = T.main(["--tiny", "--device", "cpu", "--views", "4"])
    cfg = tiny_config(view_num=4)
    state = Trainer(cfg).abstract_state(tiny_batch(cfg, B=1))
    labels = param_labels(state.params, cfg.model.finetune_unet)
    params = {}
    for (_, s), (_, lab) in zip(jax.tree_util.tree_flatten_with_path(state.params)[0],
                                jax.tree_util.tree_flatten_with_path(labels)[0]):
        params[lab] = params.get(lab, 0) + s.size * s.dtype.itemsize
    moments = {}
    for p, s in jax.tree_util.tree_flatten_with_path(state.opt_state)[0]:
        key = jax.tree_util.keystr(p)
        if ".mu" in key or ".nu" in key:
            lab = key.split("'")[1]
            moments[lab] = moments.get(lab, 0) + s.size * s.dtype.itemsize
    assert ours["train"]["parameters"] == params
    assert ours["train"]["adamw_moments"] == moments
    assert ours["train"]["gradients"] == {k: v for k, v in params.items() if k != "frozen"}
    assert ours["train"]["peak_bytes"] is None and ours["sample"]["peak_bytes"] is None


# the repair: a reproducible serving avatar ------------------------------------

def test_scatter_ordered_equals_unordered_and_serving_orders(monkeypatch):
    from morphablediffusion_torch.models import mesh_voxel
    from morphablediffusion_torch.models.diffusion import MorphableDiffusion as TModel
    from morphablediffusion_torch.weights import seeded_params

    g = torch.Generator().manual_seed(0)
    feats = torch.randn(2, 500, 8, generator=g)
    idx = torch.randint(-1, 9, (2, 500, 3), generator=g)  # some out of the grid
    mask = (torch.rand(2, 500, generator=g) > 0.1).float()
    a = mesh_voxel.scatter_mean_voxels(feats, idx, mask, (8, 8, 8), ordered=False)
    b = mesh_voxel.scatter_mean_voxels(feats, idx, mask, (8, 8, 8), ordered=True)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)

    calls = []
    real = mesh_voxel.scatter_mean_voxels
    monkeypatch.setattr(mesh_voxel, "scatter_mean_voxels",
                        lambda *a, **k: calls.append(a[4] if len(a) > 4 else k.get("ordered"))
                        or real(*a, **k))
    cfg = common.tiny_config(2)
    model = seeded_params(TModel(cfg.model, device="cpu"), 0).eval()
    batch = common.flagship_batch(cfg, "cpu", with_targets=True)
    m = cfg.model
    x = torch.randn((1, m.view_num, m.latent_size, m.latent_size, 4), generator=g)
    with torch.no_grad():
        prep = model.prepare_inference(batch)
        model.predict_eps_cfg(x, torch.tensor([500]), prep["clip_embed"], prep["x_input"],
                              prep["v_embed"], batch, 2.0)
        assert calls == [True]  # serving: in index order
        model.training_loss(batch, generator=torch.Generator().manual_seed(1))
    assert calls == [True, False]  # training keeps the atomics
