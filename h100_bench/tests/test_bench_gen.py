"""The traffic generator: every seed the same shapes and amount of work."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from h100_bench import gen

BENCH = Path(__file__).resolve().parents[1]
MODEL = json.loads((BENCH / "configs" / "facescape_coarse.json").read_text())["model"]


@pytest.mark.parametrize("traffic", ["avatars_b4", "train_b70"])
def test_every_seed_gives_the_same_shapes(traffic):
    t = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    t["batch"] = 2  # the shapes' rule, at a batch the CPU holds
    batches = [gen.make_batch(MODEL, t, s, i, "cpu", with_targets=t["kind"] == "train")
               for s, i in ((1, 0), (2**31 + 7, 3), (987654321987, 1))]
    for b in batches[1:]:
        assert {k: v.shape for k, v in b.items()} == {k: v.shape for k, v in batches[0].items()}
        assert torch.equal(b["vertex_mask"], batches[0]["vertex_mask"])
        assert not torch.equal(b["input_image"], batches[0]["input_image"])
    assert int(batches[0]["vertex_mask"][0].sum()) == t["head"]["vertices"] == 5023
    assert batches[0]["vertices"].shape[1] == MODEL["max_vertices"] == 5120


def test_the_same_seed_gives_the_same_batch():
    t = json.loads((BENCH / "traffic" / "avatars_b4.json").read_text())
    a = gen.make_batch(MODEL, t, 2**33 + 5, 2, "cpu")
    b = gen.make_batch(MODEL, t, 2**33 + 5, 2, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_the_head_is_a_closed_surface_of_head_size():
    t = json.loads((BENCH / "traffic" / "avatars_b4.json").read_text())
    b = gen.make_batch(MODEL, t, 11, 0, "cpu")
    v = b["vertices"][0, :5023]
    extent = v.amax(0) - v.amin(0)
    assert ((extent > 0.14) & (extent < 0.26)).all()
    r = (v / torch.tensor(t["head"]["semi_axes_m"])).norm(dim=1)
    assert (r - 1).abs().max() < 0.2  # jitter and offset are small
    n = gen.occupied_fine_voxels(b, MODEL["fine_voxel_size"])
    assert 4 * 2000 < n < 4 * 5023


def test_training_draws_have_fixed_shapes():
    a = gen.training_draws(MODEL, 3, 5, 0, "cpu")
    b = gen.training_draws(MODEL, 3, 2**40, 9, "cpu")
    assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in b.items()}
    assert a["vae_target"].dtype == torch.bfloat16
