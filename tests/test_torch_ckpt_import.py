"""The port's reference-checkpoint importer and exporter
(`morphablediffusion_torch/utils/torch_import.py`) against the JAX package's
(`morphablediffusion_tpu/utils/torch_import.py`) on the CPU: the mapping
tables entry for entry; a checkpoint exported by JAX from seeded parameters
of tests/tiny.py's config (coarse and fine conditioner), imported by both
sides into the same template (bit-equal parameters, equal reports); the
export bit for bit; and the importer's special cases."""

import functools

import jax
import numpy as np
import pytest
import torch

from morphablediffusion_torch import weights
from morphablediffusion_torch.models.diffusion import MorphableDiffusion as TModel
from morphablediffusion_torch.utils import torch_import as pti
from morphablediffusion_tpu.models.diffusion import MorphableDiffusion as JModel
from morphablediffusion_tpu.utils import torch_import as jti
from tests.tiny import tiny_batch, tiny_config
from tests.torch_parity import _init_inference, port_model_config, seeded_tree

# extra checkpoint keys: two that the unused-key filter drops, one that
# nothing maps (unused), and a mapped key whose path the model lacks (the
# skip conv of a ResBlock whose channels do not change: unmatched)
EXTRA = {
    "betas": np.zeros(4, np.float32),
    "alphas_cumprod": np.zeros(4, np.float32),
    "model_ema.decay": np.zeros((), np.float32),
    "model.diffusion_model.input_blocks.2.0.skip_connection.weight":
        np.zeros((32, 32, 1, 1), np.float32),
}


def _cfg(mode: str):
    cfg = tiny_config(view_num=2)
    if mode == "fine":
        cfg.model.mesh_voxel_mode = "fine"
        cfg.model.fine_grid_shape = (16, 16, 16)
        cfg.model.fine_voxel_size = 0.05
    return cfg


@functools.lru_cache(maxsize=None)
def _abstract(mode: str):
    """The JAX model's parameter shapes (tracing the init takes seconds)."""
    cfg = _cfg(mode)
    jmodel = JModel(cfg.model)
    batch = tiny_batch(cfg, with_targets=False)
    return jax.eval_shape(
        lambda b: jmodel.init(jax.random.key(0), b, method=_init_inference), batch)


def _params(cfg, seed: int):
    """Seeded numpy parameter tree {'params': ...} of the JAX model."""
    return seeded_tree(_abstract(cfg.model.mesh_voxel_mode), seed)


def _port(cfg, params):
    model = TModel(port_model_config(cfg.model), device="cpu")
    model.load_state_dict(weights.from_jax_params(weights.flatten_tree(params["params"]),
                                                  device="cpu"), strict=True)
    return model


def _save(sd, path):
    torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in sd.items()}}, path)


def test_mapping_tables_equal_jax():
    for layers in (2, 24):
        assert pti.full_mapping(layers) == jti.full_mapping(layers)
    assert len(pti.full_mapping(24)) == 1538
    assert pti.xyzc_mapping() == jti.xyzc_mapping()
    assert len(pti.xyzc_mapping()) == 45


@pytest.mark.parametrize("mode", ["coarse", "fine"])
def test_import_matches_jax(tmp_path, capsys, mode):
    """JAX params -> JAX export_state_dict -> an fp32 torch file -> the
    port's import into a model holding other weights (seed 1): every
    parameter bit-equal to from_jax_params of the JAX import into the same
    seed-1 template, mapped ones equal to the exported weights, and the
    report equal to JAX's."""
    cfg = _cfg(mode)
    src, template = _params(cfg, 0), _params(cfg, 1)
    sd = dict(jti.export_state_dict(src, clip_layers=cfg.model.clip.layers), **EXTRA)
    path = tmp_path / "ref.ckpt"
    _save(sd, path)

    model = _port(cfg, template)
    report = pti.import_torch_checkpoint(path, model)
    j_params, j_report = jti.import_state_dict(jti.load_torch_state_dict(path), template,
                                               clip_layers=cfg.model.clip.layers)
    assert report == j_report
    # a key whose path the model lacks is reported both ways, as by JAX
    skip = "model.diffusion_model.input_blocks.2.0.skip_connection.weight"
    assert report["unused_torch_keys"] == [skip, "model_ema.decay"]
    assert report["unmatched_model_paths"] == ["unet/in_2_res/skip/kernel"]
    assert report["filled"] == len(sd) - len(EXTRA)
    assert (f"imported {report['filled']} tensors; 2 torch keys unused; 1 model paths "
            "unmatched") in capsys.readouterr().out

    expected = weights.from_jax_params(weights.flatten_tree(j_params["params"]), device="cpu")
    got = model.state_dict()
    assert got.keys() == expected.keys()
    for k, v in expected.items():
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], v), k
    # the mapped parameters came from the checkpoint, the others kept seed 1
    src_sd = weights.from_jax_params(weights.flatten_tree(src["params"]), device="cpu")
    tmpl_sd = weights.from_jax_params(weights.flatten_tree(template["params"]), device="cpu")
    imported = sum(torch.equal(got[k], src_sd[k]) for k in got)
    kept = [k for k in got if torch.equal(got[k], tmpl_sd[k])]
    assert imported == report["filled"] and imported + len(kept) == len(got)
    if mode == "fine":
        assert any(k.startswith("spatial_volume.mesh_voxel.net.") for k in got)
        assert not any(k.startswith("spatial_volume.mesh_voxel.net.") for k in kept)


@pytest.mark.parametrize("mode", ["coarse", "fine"])
def test_export_matches_jax(mode):
    cfg = _cfg(mode)
    params = _params(cfg, 0)
    ours = pti.export_state_dict(_port(cfg, params), clip_layers=cfg.model.clip.layers)
    ref = jti.export_state_dict(params, clip_layers=cfg.model.clip.layers)
    assert list(ours) == list(ref)
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype == np.float32
        np.testing.assert_array_equal(ours[k], v, err_msg=k)
    assert (mode == "fine") == any(k.startswith("spatial_volume.xyzc_net.") for k in ours)


def test_export_torch_checkpoint_round_trip(tmp_path):
    """export_torch_checkpoint writes the state_dict in the asked dtype;
    fp16 comes back as the fp16-rounded weights."""
    cfg = _cfg("fine")
    model = _port(cfg, _params(cfg, 0))
    path = tmp_path / "half.ckpt"
    n = pti.export_torch_checkpoint(model, path, dtype=torch.float16)
    sd = pti.load_torch_state_dict(path)
    assert n == len(sd) and all(v.dtype == np.float16 for v in sd.values())
    other = _port(cfg, _params(cfg, 1))
    report = pti.import_state_dict(sd, other, clip_layers=cfg.model.clip.layers)
    assert report["filled"] == n and not report["unused_torch_keys"]
    ref = model.state_dict()
    for k, v in other.state_dict().items():
        assert torch.equal(v, ref[k].half().float()), k


def test_spconv_1x_layout():
    """xyzc_net kernels stored spatial-first (spconv 1.x) import as the
    KRSC ones (2.x) do."""
    cfg = _cfg("fine")
    sd = jti.export_state_dict(_params(cfg, 0), clip_layers=cfg.model.clip.layers)
    old = {k: (v.transpose(1, 2, 3, 4, 0) if k.startswith("spatial_volume.xyzc_net")
               and v.ndim == 5 else v) for k, v in sd.items()}
    assert any(v.shape[:3] == (3, 3, 3) for k, v in old.items() if "xyzc" in k)
    a, b = _port(cfg, _params(cfg, 1)), _port(cfg, _params(cfg, 1))
    ra = pti.import_state_dict(sd, a, clip_layers=2)
    rb = pti.import_state_dict(old, b, clip_layers=2)
    assert ra == rb
    sb = b.state_dict()
    for k, v in a.state_dict().items():
        assert torch.equal(v, sb[k]), k
    with pytest.raises(ValueError, match="spconv kernel layout"):
        pti.import_state_dict({"spatial_volume.xyzc_net.conv0.0.weight":
                               np.zeros((2, 3, 3, 2, 3), np.float32)}, b, clip_layers=2)


def test_input_conv_surgery_and_shape_mismatch():
    """A 4-channel input conv (plain SD weights) is zero-padded to the
    model's 8 input channels, as by JAX; any other mismatch raises."""
    cfg = _cfg("coarse")
    template = _params(cfg, 1)
    rng = np.random.default_rng(3)
    w4 = rng.standard_normal((32, 4, 3, 3)).astype(np.float32)
    sd = {pti.INPUT_CONV_KEY: w4}
    model = _port(cfg, template)
    report = pti.import_state_dict(sd, model, clip_layers=2)
    j_params, j_report = jti.import_state_dict(sd, template, clip_layers=2)
    assert report == j_report and report["filled"] == 1
    w = model.unet.input_conv.weight.detach()
    assert torch.equal(w[:, :4], torch.from_numpy(w4))
    assert torch.equal(w[:, 4:], torch.zeros_like(w[:, 4:]))
    assert torch.equal(w, weights.from_jax_params(
        {"k/kernel": j_params["params"]["unet"]["input_conv"]["kernel"]}, device="cpu")
        ["k.weight"])
    with pytest.raises(ValueError, match="shape mismatch at unet/input_conv/kernel"):
        pti.import_state_dict({pti.INPUT_CONV_KEY: np.zeros((32, 8, 1, 1), np.float32)},
                              model, clip_layers=2)


def test_partial_checkpoint(tmp_path, capsys):
    """The two-tensor checkpoint of tests/test_cli_integration.py: only the
    VAE's quant_conv is loaded; every other parameter keeps its value."""
    cfg = _cfg("coarse")
    model = _port(cfg, _params(cfg, 1))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    path = tmp_path / "weights.ckpt"
    torch.manual_seed(0)
    w, b = torch.randn(8, 8, 1, 1), torch.randn(8)
    torch.save({"state_dict": {"first_stage_model.quant_conv.weight": w,
                               "first_stage_model.quant_conv.bias": b}}, path)
    pti.import_torch_checkpoint(path, model)
    assert "imported 2 tensors; 0 torch keys unused; 0 model paths unmatched" in \
        capsys.readouterr().out
    sd = model.state_dict()
    assert torch.equal(sd["first_stage.quant_conv.weight"], w)
    assert torch.equal(sd["first_stage.quant_conv.bias"], b)
    changed = [k for k in sd if not torch.equal(sd[k], before[k])]
    assert sorted(changed) == ["first_stage.quant_conv.bias", "first_stage.quant_conv.weight"]
