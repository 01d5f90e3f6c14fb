"""Eval stage 2: generate all test views for FaceScape (nvs / nes modes).

Counterpart of the JAX package's `apps/eval_generate.py`, with the same
flags and defaults plus `--device`. Parity target:
eval/generate_all_facescape.py: per (subject, expression), read the stage-1
JSON, pad the target views up to a multiple of the model's view count
(:107-108), batch the view groups through ONE sampler call (B = the number
of groups) sharing one input image and mesh, and save a horizontal strip
named `{subject}_{exp}.png` whose i-th tile is target view i (deduplicated
after padding).

Modes: 'nvs' (same-expression input, all 20 expressions) / 'nes' (input from
another expression, drawn by `random.Random(seed)`; the held-out expression
06 only unless --nes_exp says otherwise) (:77-81, 109-114).

    python -m morphablediffusion_torch.apps.eval_generate --data_dir <root> \\
        --mode nes --ckpt ckpt/facescape_flame.ckpt --output_dir eval_out \\
        [--views_json ...] [--w8a8] [--device cpu]

`--ckpt` takes what the port's `generate_face` takes: a reference
.ckpt/.pt/.pth (one that ships the spconv `xyzc_net` weights selects the
fine conditioner at the config's dataset-max grid, since meshes vary per
(subject, expression)), `random` (seeded weights), or a checkpoint
directory of the port's or the JAX package's train CLI (the JAX one's Orbax
params export is read without JAX). The model runs on the CUDA card and raises without one unless
`--device cpu` is given; weights are cast to the config's compute dtype.
"""

from __future__ import annotations

import argparse
import json
import math
import random
from pathlib import Path

import numpy as np


def group_batch(ds, camera_dict, groups, input_img, verts, max_vertices):
    """The sampler's batch (numpy) for view groups of one (subject,
    expression): one sample per group, sharing the input image and mesh."""
    from morphablediffusion_torch.data.common import pad_vertices

    n, N = len(groups), len(groups[0])
    vpad, vmask = pad_vertices(verts, max_vertices)
    batch = {
        "input_image": np.repeat(input_img[None], n, 0),
        "input_elevation": np.zeros((n, 1), np.float32),
        "input_azimuth": np.zeros((n, 1), np.float32),
        "target_elevation": np.zeros((n, N), np.float32),
        "target_azimuth": np.zeros((n, N), np.float32),
        "vertices": np.repeat(vpad[None], n, 0),
        "vertex_mask": np.repeat(vmask[None], n, 0),
    }
    cams = [[ds._camera(camera_dict, v) for v in g] for g in groups]
    batch["target_K"] = np.stack([np.stack([K for K, _ in g]) for g in cams]).astype(np.float32)
    batch["target_RT"] = np.stack([np.stack([RT for _, RT in g]) for g in cams]).astype(
        np.float32)
    return batch


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--mode", type=str, required=True, choices=["nvs", "nes"])
    parser.add_argument("--cfg", type=str, default="configs/facescape.yaml")
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--output_dir", type=str, default="./eval_output")
    parser.add_argument("--views_json", type=str,
                        default="./eval/facescape_input_target_views.json")
    parser.add_argument("--cfg_scale", type=float, default=2.0)
    parser.add_argument("--seed", type=int, default=6033)
    parser.add_argument("--sample_steps", type=int, default=50)
    parser.add_argument("--eta", type=float, default=1.0,
                        help="DDIM eta (reference uses 1.0; 0 = deterministic)")
    parser.add_argument("--batch_view_num", type=int, default=0,
                        help="0 = all views in one batch; >0 chunks the "
                        "sampler's view axis (memory knob)")
    parser.add_argument("--limit", type=int, default=0,
                        help="stop after N (subject, expression) pairs (smoke)")
    parser.add_argument("--nes_exp", type=str, nargs="*", default=["06"],
                        help="expressions to synthesize in nes mode (the "
                        "reference hardcodes the heldout expression '06', "
                        "generate_all_facescape.py:79; override for datasets "
                        "with a different heldout layout)")
    parser.add_argument("--w8a8", action="store_true",
                        help="serve the UNet's internal convs in W8A8 int8 "
                             "(ops/int8.py)")
    parser.add_argument("--device", type=str, default=None,
                        help="default: the CUDA card (raises without one); 'cpu' "
                             "runs on the CPU")
    flags = parser.parse_args(argv)

    import torch
    from PIL import Image

    from morphablediffusion_torch.apps.eval_select_views import TEST_SUBJECTS
    from morphablediffusion_torch.apps.generate_face import (
        REFERENCE_SUFFIXES,
        autoselect_fine_conditioner,
        load_params,
        to_uint8,
    )
    from morphablediffusion_torch.data.facescape import FaceScapeDataset
    from morphablediffusion_torch.models.diffusion import MorphableDiffusion
    from morphablediffusion_torch.sampling import SyncDDIMSampler
    from morphablediffusion_torch.utils import resolve_device, torch_dtype
    from morphablediffusion_torch.utils.config import load_config
    from morphablediffusion_torch.weights import cast_for_serving

    device = resolve_device(flags.device)
    cfg = load_config(flags.cfg)
    if flags.w8a8:
        cfg.model.unet.w8a8 = True
    state_dict = None
    if str(flags.ckpt).endswith(REFERENCE_SUFFIXES):
        # trained spconv weights select the fine-grid conditioner; the grid
        # stays at the config's dataset-max extent (meshes vary per item)
        from morphablediffusion_torch.utils.torch_import import load_torch_state_dict

        state_dict = load_torch_state_dict(flags.ckpt)
        autoselect_fine_conditioner(cfg.model, state_dict)
    model = MorphableDiffusion(cfg.model, device=device)
    load_params(model, flags.ckpt, state_dict=state_dict)
    del state_dict
    cast_for_serving(model, torch_dtype(cfg.model.dtype)).eval()
    N = cfg.model.view_num
    rng = random.Random(flags.seed)

    metadata = json.loads(Path(flags.views_json).read_text())
    exps = (list(flags.nes_exp) if flags.mode == "nes"
            else [str(i).zfill(2) for i in range(1, 21)])

    # dataset object reused for its loading/transform helpers
    ds = FaceScapeDataset(
        flags.data_dir, uids=[], image_size=cfg.model.image_size,
        num_views=N, max_vertices=cfg.model.max_vertices,
        mesh_topology=cfg.data.mesh_topology, shuffled_expression=False,
        **(
            {"flame_assets_dir": cfg.data.flame_assets_dir}
            if cfg.data.flame_assets_dir else {}
        ),
    )

    out = Path(flags.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    sampler = SyncDDIMSampler(model, sample_steps=flags.sample_steps,
                              batch_view_num=flags.batch_view_num, eta=flags.eta)

    done = 0
    # iterate the stage-1 JSON's subjects (== TEST_SUBJECTS for reference
    # data; --subjects overrides there flow through here automatically)
    for subject in sorted(metadata, key=lambda s: TEST_SUBJECTS.index(s)
                          if s in TEST_SUBJECTS else len(TEST_SUBJECTS)):
        for exp in exps:
            d = Path(flags.data_dir) / subject / exp
            submeta = metadata.get(subject.zfill(3), metadata.get(subject, {}))
            meta = submeta.get(exp, {})
            if not meta or not d.exists():
                continue
            camera_dict = json.loads((d / "cameras.json").read_text())
            targets = list(meta["target_views"])
            n_groups = math.ceil(len(targets) / N)
            padded = targets + targets[: n_groups * N - len(targets)]

            if flags.mode == "nes":
                # the reference draws from range(1, 21) (generate_all_facescape
                # .py:110); restricted to expressions stage 1 found, so sparse
                # datasets never pick an input expression that was not rendered
                cands = sorted(e for e in submeta if e != exp and submeta[e])
                if not cands:
                    raise SystemExit(
                        f"nes mode: no alternate input expression for "
                        f"{subject}/{exp} (stage 1 found only this expression;"
                        f" pass --nes_exp or rerun stage 1 with more)"
                    )
                input_exp = rng.choice(cands)
            else:
                input_exp = exp
            input_dir = Path(flags.data_dir) / subject / input_exp
            input_img = ds._load_view(input_dir, submeta[input_exp]["input_view"])

            groups = [padded[i * N : (i + 1) * N] for i in range(n_groups)]
            batch = group_batch(ds, camera_dict, groups, input_img,
                                ds._vertices(subject, exp), cfg.model.max_vertices)
            gen = torch.Generator(device).manual_seed(flags.seed)
            images, _ = sampler.sample(
                {k: torch.as_tensor(v, device=device) for k, v in batch.items()},
                flags.cfg_scale, generator=gen)  # (n_groups, N, H, W, 3)
            images = images.float().cpu().numpy()
            flat = images.reshape(-1, *images.shape[2:])[: len(targets)]
            strip = np.concatenate([to_uint8(im) for im in flat], axis=1)
            Image.fromarray(strip).save(out / f"{subject}_{exp}.png")
            print(f"wrote {subject}_{exp}.png ({len(targets)} views)")
            done += 1
            if flags.limit and done >= flags.limit:
                return


if __name__ == "__main__":
    main()
