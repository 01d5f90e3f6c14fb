"""The check fails what it must: the control (the program's W8A8 path and
the float8 reference) reads far above the sound program, and a run with
the timed path broken underneath comes out not correct, once for each
fault the cells can have (a step that returns its state unchanged; half
the batch left out, the mean taken over the rest; an answer altered where
it is produced). The cells run on one card: there is no exchange between
cards to leave out."""

from __future__ import annotations

import time

import torch

from h100_bench import control, driver, run
from h100_bench.tests import bench_tiny

SERVE, FINE, TRAIN = ("facescape_coarse.avatars_b4", "facescape_fine.avatars_b4",
                      "facescape_coarse.train_b70")


def tiny_run(workload, dtype="float32"):
    cell, cfg, traffic, e2e, per_layer = run.load_cell(workload)
    doc = bench_tiny.config(cfg["model"]["mesh_voxel_mode"])
    doc["model"]["dtype"] = dtype
    return driver.run_cell(cell, doc, bench_tiny.traffic(cell["traffic"]), e2e, per_layer,
                           99, 0.1, False, torch.device("cpu"), time.perf_counter())


def test_control_reads_above_the_program():
    cell, cfg, traffic, e2e, per_layer = run.load_cell(SERVE)
    doc = bench_tiny.config("coarse")
    doc["model"]["dtype"] = "bfloat16"
    sound = tiny_run(SERVE, "bfloat16")["checks"]
    low = control.serving_control(cell, doc, bench_tiny.traffic("avatars_b4"), e2e, per_layer,
                                  99, 0.1, torch.device("cpu"))
    assert low["w8a8"]["step_gap"]["value"] > 2 * sound["step_gap"]["value"]
    for k in ("prep_gap", "volume_gap", "step_gap", "decode_gap"):
        assert low["fp8"][k]["value"] > 3 * sound[k]["value"], k
    tr = control.training_control(bench_tiny.config("coarse"), bench_tiny.traffic("train_b70"),
                                  99, torch.device("cpu"))
    assert tr["fp8"]["grad_gap"] > 0.1


def test_state_left_unchanged_by_the_step(monkeypatch):
    from morphablediffusion_torch.ops import schedules

    monkeypatch.setattr(schedules, "ddim_step", lambda x, eps, *a, **k: x)
    out = tiny_run(SERVE)
    assert out["correct"] is False and out["checks"]["step_gap"]["value"] > 0.5


def test_optimizer_step_left_out(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, *a, **k: None)
    out = tiny_run(TRAIN)
    assert out["correct"] is False
    assert out["checks"]["change_gap"]["value"] > 0.5


def test_half_the_batch_left_out(monkeypatch):
    from morphablediffusion_torch.models.diffusion import MorphableDiffusion

    real = MorphableDiffusion.predict_eps_cfg

    def half(self, x, *a, **k):
        eps = real(self, x, *a, **k)
        h = eps.shape[0] // 2
        return torch.cat([eps[:h], eps[:h].mean(0, keepdim=True).expand_as(eps[h:])])

    monkeypatch.setattr(MorphableDiffusion, "predict_eps_cfg", half)
    out = tiny_run(FINE)
    assert out["correct"] is False and out["checks"]["step_gap"]["value"] > 0.05


def test_half_the_training_batch_left_out(monkeypatch):
    from morphablediffusion_torch.models.diffusion import MorphableDiffusion

    real = MorphableDiffusion.training_loss

    def half(self, batch, draws=None, generator=None):
        B = batch["target_image"].shape[0]
        h, N = B // 2, batch["target_image"].shape[1]
        sub = {k: v[:h] for k, v in batch.items()}
        d = {k: (v[:h * N] if k == "vae_target" else v[:h]) for k, v in draws.items()}
        return real(self, sub, d)

    monkeypatch.setattr(MorphableDiffusion, "training_loss", half)
    out = tiny_run(TRAIN)
    assert out["correct"] is False and out["checks"]["grad_gap"]["value"] > 0.06


def test_answer_altered_where_it_is_produced(monkeypatch):
    from morphablediffusion_torch.models.diffusion import MorphableDiffusion

    real = MorphableDiffusion.decode_views

    def altered(self, *a, **k):
        img = real(self, *a, **k)
        img[:, 0] = -img[:, 0]
        return img

    monkeypatch.setattr(MorphableDiffusion, "decode_views", altered)
    out = tiny_run(SERVE)
    assert out["correct"] is False and out["checks"]["decode_gap"]["value"] > 0.1
