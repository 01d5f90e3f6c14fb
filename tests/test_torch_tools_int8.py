"""`morphablediffusion_torch/tools/int8_trajectory.py` against the
repository's `tools/int8_trajectory.py` on the CPU: on tests/tiny.py's
config with the well-conditioned weights of test_torch_int8.py (int8 flips,
ROADMAP Queue C) and the JAX noise stream, the tool's `trajectory` of the
fp32 and the W8A8 model against the JAX sampler (fp32 1e-4; W8A8 a tenth of
JAX's own W8A8-to-fp32 distance), `drift_report` equal to the JAX tool's
formulas on the same arrays (1e-6: it computes in fp64, the JAX tool in
fp32), so the drift within a tenth of the JAX drift; `run` end to end."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphablediffusion_torch.tools import common
from tests.tiny import tiny_batch, tiny_config
from tests.torch_parity import load_into, port_model_config, seeded_tree, tt, well_conditioned

REPO = Path(__file__).resolve().parents[1]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# tool 6 ---------------------------------------------------------------------

def test_int8_trajectory_matches_jax():
    import copy

    from morphablediffusion_torch.models.diffusion import MorphableDiffusion as TModel
    from morphablediffusion_torch.tools import int8_trajectory as T
    from morphablediffusion_tpu.models.diffusion import MorphableDiffusion as JModel
    from morphablediffusion_tpu.sampling import SyncDDIMSampler as JSampler
    from tests.torch_parity import _init_inference

    cfg = tiny_config(view_num=2)
    cfg8 = copy.deepcopy(cfg)
    cfg8.model.unet.w8a8 = True
    m = cfg.model
    batch = tiny_batch(cfg, with_targets=False)
    params = well_conditioned(seeded_tree(jax.eval_shape(
        lambda b: JModel(m).init(jax.random.key(0), b, method=_init_inference), batch)))
    rng = jax.random.key(7)
    shape = (1, m.view_num, m.latent_size, m.latent_size, 4)
    step_rng, init_rng = jax.random.split(rng)
    x_init = tt(jax.random.normal(init_rng, shape, jnp.float32))
    noises = [tt(jax.random.normal(jax.random.fold_in(step_rng, i), shape, jnp.float32))
              for i in range(m.sample_steps)]
    tb = {k: tt(v) for k, v in batch.items()}

    trajs, images, j_trajs, j_images = {}, {}, {}, {}
    for tag, c in (("bf16", cfg), ("w8a8", cfg8)):  # the JAX tool's tags; fp32 here
        jmodel = JModel(c.model)
        sampler = JSampler(jmodel, sample_steps=m.sample_steps)
        prep = jmodel.apply(params, batch, method="prepare_inference")
        lat, traj = jax.jit(lambda p, b, pr, r: sampler.denoise_latents(
            p, b, pr, r, 2.0, collect_trajectory=True))(params, batch, prep, rng)
        j_trajs[tag] = np.asarray(traj)
        j_images[tag] = np.asarray(jmodel.apply(params, lat, 0, method="decode_views"))
        port = load_into(TModel(port_model_config(c.model), device="cpu"), params)
        trajs[tag], images[tag], _ = T.trajectory(port, tb, 7, m.sample_steps,
                                                  x_init=x_init, noises=noises)
    gap = _rel(j_trajs["w8a8"], j_trajs["bf16"])
    assert gap > 1e-3  # the quantization is there to be seen
    assert _rel(trajs["bf16"].numpy(), j_trajs["bf16"]) < 1e-4
    assert _rel(trajs["w8a8"].numpy(), j_trajs["w8a8"]) <= 0.1 * gap
    assert _rel(images["w8a8"].numpy(), np.clip(j_images["w8a8"], -1, 1)) <= 0.1 * _rel(
        j_images["w8a8"], j_images["bf16"])

    # drift_report is the JAX tool's arithmetic (tools/int8_trajectory.py:134-146)
    a, b = j_trajs["bf16"], j_trajs["w8a8"]
    denom = np.sqrt((a.reshape(len(a), -1) ** 2).mean(axis=1))
    drift = np.sqrt(((a - b).reshape(len(a), -1) ** 2).mean(axis=1)) / denom
    ia, ib = np.clip(j_images["bf16"], -1, 1), np.clip(j_images["w8a8"], -1, 1)
    mse = float(((ia - ib) ** 2).mean())
    rep = T.drift_report(j_trajs, j_images, m.sample_steps, 7)  # in fp64; JAX's in fp32
    assert rep["per_step_rel_l2"] == pytest.approx([round(float(d), 5) for d in drift],
                                                   abs=1e-5)
    assert rep["final_rel_l2"] == pytest.approx(float(drift[-1]), rel=1e-6)
    assert rep["final_image_psnr_bf16_vs_w8a8"] == pytest.approx(
        float(10 * np.log10(4.0 / mse)), rel=1e-6)
    assert rep["final_image_max_abs"] == pytest.approx(float(np.abs(ia - ib).max()), rel=1e-6)
    ours = T.drift_report(trajs, images, m.sample_steps, 7)
    assert set(ours) == set(json.loads((REPO / "artifacts/int8_trajectory.json").read_text()))
    assert ours["final_rel_l2"] == pytest.approx(rep["final_rel_l2"], rel=0.1)


def test_int8_trajectory_run_writes_the_json(tmp_path, monkeypatch):
    """`run` end to end on seeded weights (the tiny config: 2 steps)."""
    from morphablediffusion_torch.tools import int8_trajectory as T

    cfg = common.tiny_config(2)
    report, seconds = T.run(cfg, "random", torch.device("cpu"), sample_steps=2, seed=7)
    assert len(report["per_step_rel_l2"]) == 2 and report["final_rel_l2"] > 0
    assert np.isfinite(report["final_image_psnr_bf16_vs_w8a8"]) and set(seconds) == {
        "bf16", "w8a8"}
