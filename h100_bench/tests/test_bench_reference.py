"""The plain reference against the port at a tiny size, float32 on the CPU:
the same weights give the same numbers stage by stage."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from h100_bench import gen, reference, seeded
from h100_bench.tests import bench_tiny


def rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("mode", ["coarse", "fine"])
def test_reference_matches_the_port(mode):
    from morphablediffusion_torch.models.diffusion import MorphableDiffusion
    from morphablediffusion_torch.utils.config import Config

    doc = bench_tiny.config(mode)
    m = doc["model"]
    cfg = Config()
    for k, v in m.items():
        cur = getattr(cfg.model, k)
        if dataclasses.is_dataclass(cur):
            for kk, vv in v.items():
                setattr(cur, kk, tuple(vv) if isinstance(vv, list) else vv)
        else:
            setattr(cfg.model, k, tuple(v) if isinstance(v, list) else v)
    state = seeded.make_state(m, 5, "cpu")
    port = MorphableDiffusion(cfg.model, device="cpu")
    port.load_state_dict(state, strict=True)
    ref = reference.build(m, "cpu")
    ref.load_state_dict(state, strict=True)
    batch = gen.make_batch(m, bench_tiny.traffic("avatars_b4"), 7, 0, "cpu")
    x = torch.randn(2, 4, 8, 8, 4, generator=torch.Generator().manual_seed(0))
    t = torch.tensor([501, 21])
    with torch.no_grad():
        prep = port.prepare_inference(batch)
        clip, xin = ref.clip(batch["input_image"]), ref.encode(batch["input_image"])
        assert rel(prep["clip_embed"], clip) < 1e-5 and rel(prep["x_input"], xin) < 1e-5
        v = ref.viewpoints(batch)
        te = ref.time_embed(reference.timestep_embedding(t, m["time_embed_dim"]))
        vol_p = port._volume(x.permute(0, 1, 4, 2, 3), port.embed_time(t), prep["v_embed"],
                             batch, ordered=True)
        assert rel(vol_p, ref.spatial_volume_of(x, te, v, batch)) < 1e-5
        eps_p = port.predict_eps_cfg(x, t, prep["clip_embed"], prep["x_input"],
                                     prep["v_embed"], batch, 2.0)
        assert rel(eps_p, ref.eps_cfg(x, t, clip, xin, v, batch, 2.0, 2)) < 1e-4
        img = port.decode_views(x)
        assert rel(img, ref.decode(x.reshape(-1, 8, 8, 4)).reshape(img.shape)) < 1e-5


def test_ddim_update_inverts():
    from h100_bench import check

    tables = reference.ddim_tables(50, 1.0)
    g = torch.Generator().manual_seed(1)
    x, eps, noise = (torch.randn(2, 3, 4, generator=g) for _ in range(3))
    for s, n in ((37, noise), (0, None)):
        nxt = reference.ddim_update(x, eps, s, tables, n)
        assert torch.allclose(check.implied_eps(x, nxt, s, tables, n), eps, atol=1e-4)
