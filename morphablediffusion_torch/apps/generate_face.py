"""Face avatar generation CLI of the PyTorch port.

Counterpart of the JAX package's `apps/generate_face.py`, with the same
flags and defaults plus `--device`: the virtual hemisphere trajectory
(radius 4.5, y-angle -90..90, f=1545.24) or a real trajectory pickle, the
hard-coded MICA -> FaceScape mesh alignment, in-pipeline matting of photos
without alpha (`preprocessing/matting.py`), the 17-tile output strip and
the NeuS2 export (transform.json with y/z-flipped c2w and white-thresholded
RGBA views).

    python -m morphablediffusion_torch.apps.generate_face \\
        --input_img demo/input.png --mesh demo/mesh.obj \\
        --ckpt ckpt/facescape_flame.ckpt --output_dir out/ [--device cpu]

`--ckpt` takes a reference .ckpt/.pt/.pth (imported by
`utils/torch_import.py`; one that ships the spconv `xyzc_net` weights
selects the fine conditioner, cropped to the mesh), `random` (seeded
weights, seed 0), or a checkpoint directory: the port's train CLI's or the
JAX package's (its newest Orbax params export, read without JAX by
`utils/orbax_reader.py`), or one Orbax params tree (`params/<step>`). It runs on the CUDA card and raises without one unless `--device cpu` is
given. `--view_parallel` under torchrun shares the views among the ranks
(one process a card, the JAX CLI's view sharding; rank 0 writes the files):

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m morphablediffusion_torch.apps.generate_face --view_parallel ... \
        [--dist_backend nccl|gloo]

In one process it shards nothing, as the JAX CLI on one device.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch
from scipy.spatial.transform import Rotation as Rot

# MICA->FaceScape alignment constants (generate_face.py:206-211)
MICA_SCALE = 1.087
MICA_POSE = np.asarray(
    [1.6811e00, -2.6845e-02, -2.8883e-02, 8.5418e-04, -3.4041e-03, 1.0564e-02]
)
CAPSTUDIO_AXES = np.asarray([[1.0, 0, 0], [0, 0, 1.0], [0, -1.0, 0]])
VIRTUAL_FOCAL = 1545.23757707405
REFERENCE_SUFFIXES = (".ckpt", ".pt", ".pth")


def generate_camera_trajectory(num_cameras=16, radius=4.5):
    """Hemisphere sweep: y-angle -90..90 deg, x-angle -180 (generate_face.py:25-45)."""
    Ks, RTs = [], []
    for y_angle in np.linspace(-90, 90, num_cameras):
        y = np.radians(y_angle)
        position = np.asarray([radius * np.sin(y), 0.0, radius * np.cos(y)])
        R = Rot.from_euler("xyz", (-180.0, y_angle, 0.0), degrees=True).as_matrix()
        RT = np.zeros((3, 4))
        RT[:3, :3] = R
        RT[:3, 3] = (-R @ position.reshape(3, 1)).reshape(3)
        K = np.eye(4)
        K[:3, :3] = np.asarray(
            [[VIRTUAL_FOCAL, 0, 128.0], [0, VIRTUAL_FOCAL, 128.0], [0, 0, 1.0]]
        )
        Ks.append(K)
        RTs.append(RT)
    return np.stack(Ks), np.stack(RTs)


def real_camera_trajectory(path, view_num):
    """(Ks (N, 4, 4), RTs (N, 3, 4)) of the first view_num cameras of a
    trajectory pickle {"intrinsics": [3x3], "extrinsics": [3x4 or 4x4]}."""
    from morphablediffusion_torch.utils.mesh_io import read_pickle

    cams = read_pickle(path)
    Ks = np.stack(
        [np.block([[np.asarray(k), np.zeros((3, 1))], [np.zeros((1, 3)), np.ones((1, 1))]])
         for k in cams["intrinsics"][:view_num]]
    )
    RTs = np.stack([np.asarray(rt)[:3] for rt in cams["extrinsics"][:view_num]])
    return Ks, RTs


def align_mica_mesh(verts: np.ndarray) -> np.ndarray:
    """Hard-coded SE(3)+scale alignment of MICA/metrical-tracker FLAME meshes
    to the FaceScape training world (generate_face.py:203-212)."""
    v = verts * MICA_SCALE
    R = Rot.from_rotvec(MICA_POSE[:3]).as_matrix()
    v = (R @ v.T).T + MICA_POSE[3:]
    v = v * 2.5
    return (CAPSTUDIO_AXES @ v.T).T


def load_input_image(path, image_size=256, matting="auto"):
    """RGB(A) file -> white-composited [-1,1] float (S, S, 3).

    An alpha channel is used as it is; other inputs are matted in-pipeline
    (`preprocessing/matting.py`'s backend ladder); matting='none' treats the
    photo as already clean."""
    from PIL import Image

    from morphablediffusion_torch.data.common import load_rgba_white

    has_alpha = np.asarray(Image.open(path)).shape[-1] == 4
    if has_alpha or matting == "none":
        return load_rgba_white(path, image_size)

    from morphablediffusion_torch.preprocessing.matting import matte

    rgb = np.asarray(Image.open(path).convert("RGB"))
    rgba = matte(rgb, backend=matting)
    img = rgba.astype(np.float32) / 255.0
    alpha = img[..., 3:]
    comp = np.uint8((img[..., :3] * alpha + 1.0 - alpha) * 255.0)
    pil = Image.fromarray(comp).resize((image_size,) * 2, Image.BICUBIC)
    return np.asarray(pil).astype(np.float32) / 255.0 * 2.0 - 1.0


def build_inference_batch(input_img, Ks, RTs, vertices, max_vertices):
    """The model's batch (numpy, B=1) for one input view and N cameras."""
    from morphablediffusion_torch.data.common import pad_vertices

    N = Ks.shape[0]
    verts, mask = pad_vertices(vertices.astype(np.float32), max_vertices)
    return {
        "input_image": input_img[None].astype(np.float32),
        "input_elevation": np.zeros((1, 1), np.float32),
        "input_azimuth": np.zeros((1, 1), np.float32),
        "target_elevation": np.zeros((1, N), np.float32),
        "target_azimuth": np.zeros((1, N), np.float32),
        "target_K": Ks[None].astype(np.float32),
        "target_RT": RTs[None].astype(np.float32),
        "vertices": verts[None],
        "vertex_mask": mask[None],
    }


def to_uint8(img):
    return ((np.clip(img, -1, 1) + 1) * 0.5 * 255).astype(np.uint8)


def save_strip(input_img, views, path):
    """17-tile horizontal strip: input | view 0..15 (generate_face.py:243-253)."""
    from PIL import Image

    tiles = [to_uint8(input_img)] + [to_uint8(v) for v in views]
    Image.fromarray(np.concatenate(tiles, axis=1)).save(path)


def export_neus2(root, views, Ks, RTs):
    """NeuS2-format dataset: transform.json + RGBA views with >240-white
    background masked out (generate_face.py:145-192,255-262)."""
    from PIL import Image

    root = Path(root)
    (root / "images").mkdir(parents=True, exist_ok=True)
    d = {"w": 256, "h": 256, "aabb_scale": 1.0, "scale": 1.0,
         "offset": [0.5, 0.5, 0.5], "frames": []}
    for idx in range(len(views)):
        E = np.eye(4)
        E[:3, :4] = RTs[idx]
        c2w = np.linalg.inv(E)
        c2w[:, 1] *= -1
        c2w[:, 2] *= -1
        d["frames"].append(
            {
                "file_path": f"images/{str(idx).zfill(2)}.png",
                "transform_matrix": c2w.tolist(),
                "intrinsic_matrix": np.asarray(Ks[idx])[:3, :3].tolist(),
            }
        )
        img = to_uint8(views[idx])
        alpha = (~np.all(img > 240, axis=-1)).astype(np.uint8) * 255
        rgba = np.concatenate([img, alpha[..., None]], axis=-1)
        Image.fromarray(rgba, "RGBA").save(root / "images" / f"{str(idx).zfill(2)}.png")
    (root / "transform.json").write_text(json.dumps(d, indent=4))


def autoselect_fine_conditioner(model_cfg, state_dict, verts=None) -> bool:
    """Switch `mesh_voxel_mode` to 'fine' when the checkpoint carries trained
    spconv weights (`spatial_volume.xyzc_net.*`, in every published
    morphable-diffusion .ckpt) and the config left the conditioner at its
    default: the coarse dense conditioner cannot use those weights, the
    fine one reproduces the reference's field.

    With a known mesh the static fine grid is cropped to the mesh's own
    `out_sh` (ceil(extent/voxel) rounded up to a multiple of 4 via (sh|3)+1,
    facescape.py:170-175): the scatter indices stay strictly below it, so
    the crop is exact, and compute scales with the mesh."""
    if model_cfg.mesh_voxel_mode != "coarse":
        return False
    if not any(k.startswith("spatial_volume.xyzc_net.") for k in state_dict):
        return False
    model_cfg.mesh_voxel_mode = "fine"
    if verts is not None:
        ext_dhw = (verts.max(axis=0) - verts.min(axis=0))[::-1]
        sh = np.ceil(ext_dhw / model_cfg.fine_voxel_size).astype(np.int64)
        model_cfg.fine_grid_shape = tuple(int(s | 3) + 1 for s in sh)
    print(
        "checkpoint ships xyzc_net weights: using the fine-grid conditioner "
        f"(grid {model_cfg.fine_grid_shape} @ {model_cfg.fine_voxel_size} m)"
    )
    return True


def load_params(model, ckpt_path, state_dict=None):
    """Fill `model` from `ckpt_path`: 'random' gives seeded weights (seed
    0); a reference .ckpt/.pt/.pth is imported over seeded weights (the
    parameters it does not map keep them; `state_dict`, if given, is the
    file already read); else a checkpoint directory, the port's or the JAX
    package's (`utils.checkpoint.load_params_dir`). Returns the import
    report, or None."""
    from morphablediffusion_torch.weights import seeded_params

    if ckpt_path == "random":
        seeded_params(model, 0)
        return None
    if str(ckpt_path).endswith(REFERENCE_SUFFIXES):
        from morphablediffusion_torch.utils.torch_import import import_torch_checkpoint

        seeded_params(model, 0)
        return import_torch_checkpoint(ckpt_path, model, state_dict=state_dict)
    from morphablediffusion_torch.utils.checkpoint import load_params_dir

    load_params_dir(model, ckpt_path)
    return None


class _Clock:
    """Seconds of a span: CUDA events on the card, the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def __enter__(self):
        if self.cuda:
            self.ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            self.ev[0].record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.ev[1].record()
            torch.cuda.synchronize()
            self.seconds = self.ev[0].elapsed_time(self.ev[1]) / 1e3
        else:
            self.seconds = time.perf_counter() - self.t0


def run(cfg, input_img, Ks, RTs, verts, ckpt, *, state_dict=None, seed=6033,
        cfg_scale=2.0, sample_steps=50, batch_view_num=0, eta=1.0, f32_params=False,
        device=None, mesh=None):
    """Everything between the CLI's inputs and its files: build the model of
    `cfg` (a Config), load `ckpt` (see load_params), cast it for serving
    unless f32_params, and sample one avatar of the input image (S, S, 3)
    in [-1, 1] under the cameras Ks (N, 4, 4), RTs (N, 3, 4) and the mesh
    vertices (V, 3), with a torch.Generator seeded `seed`.

    Returns (views (N, S, S, 3) float32 in [-1, 1], report): report holds
    the import report (None unless a reference checkpoint was imported),
    the conditioner and its grid, and the seconds of the model build, the
    weight load, the serving cast and the sampling (CUDA events on the card).
    mesh: a `parallel.Mesh` whose ranks share the views (on mesh.device);
    every rank returns all the views."""
    from morphablediffusion_torch.models.diffusion import MorphableDiffusion
    from morphablediffusion_torch.sampling import SyncDDIMSampler
    from morphablediffusion_torch.utils import resolve_device
    from morphablediffusion_torch.weights import cast_for_serving

    device = mesh.device if mesh is not None else resolve_device(device)
    m = cfg.model
    seconds = {}
    t0 = time.perf_counter()
    model = MorphableDiffusion(m, device=device)
    seconds["build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    imported = load_params(model, ckpt, state_dict=state_dict)
    seconds["load"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not f32_params:
        cast_for_serving(model)
    model.eval()
    seconds["cast"] = time.perf_counter() - t0

    batch = {k: torch.as_tensor(v, device=device)
             for k, v in build_inference_batch(input_img, Ks, RTs, verts,
                                               m.max_vertices).items()}
    sampler = SyncDDIMSampler(model, sample_steps=sample_steps, eta=eta,
                              batch_view_num=batch_view_num, mesh=mesh)
    gen = torch.Generator(device).manual_seed(seed)
    with _Clock(device) as clock:
        images, _ = sampler.sample(batch, cfg_scale, generator=gen)
        views = images[0].float().cpu().numpy()
    seconds["sample"] = clock.seconds
    report = {"import": imported, "mesh_voxel_mode": m.mesh_voxel_mode,
              "fine_grid_shape": tuple(m.fine_grid_shape), "w8a8": m.unet.w8a8,
              "seconds": seconds}
    return views, report


def main(argv=None):
    """Parse the flags, read the inputs, `run`, write the strip (and the
    NeuS2 data). Returns run's (views, report), its seconds completed by
    the checkpoint read and the writes."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--input_img", type=str, required=True)
    parser.add_argument("--exp_img", type=str, default="")
    parser.add_argument("--mesh", type=str, required=True)
    parser.add_argument("--cfg", type=str, default="configs/facescape.yaml")
    parser.add_argument("--ckpt", type=str, default="ckpt/facescape_flame.ckpt",
                        help="a reference .ckpt/.pt/.pth, 'random' (seeded weights), or "
                             "a checkpoint directory of the port's or the JAX package's "
                             "train CLI (its params export)")
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--cfg_scale", type=float, default=2.0)
    # reference default 8 (a memory knob); 0 = all 16 views in one batch
    parser.add_argument("--batch_view_num", type=int, default=0)
    parser.add_argument("--seed", type=int, default=6033)
    parser.add_argument("--sampler", type=str, default="ddim")
    parser.add_argument("--sample_steps", type=int, default=50)
    parser.add_argument("--eta", type=float, default=1.0,
                        help="DDIM eta (reference uses 1.0; 0 = deterministic)")
    parser.add_argument("--camera_trajectory", type=str, default="virtual",
                        choices=["real", "virtual"])
    parser.add_argument("--trajectory_pkl", type=str,
                        default="./assets/facescape_test_traj.pkl")
    parser.add_argument("--prepare_neus2_data", action="store_true")
    parser.add_argument("--no_mica_alignment", action="store_true",
                        help="skip the hard-coded MICA->FaceScape alignment "
                             "(mesh already in training world coordinates)")
    parser.add_argument("--view_parallel", action="store_true",
                        help="under torchrun: share the views among the ranks; a no-op "
                             "in one process")
    parser.add_argument("--dist_backend", type=str, default=None, choices=["nccl", "gloo"],
                        help="with --view_parallel under torchrun: the process group's "
                             "backend (default nccl on the card, gloo on the CPU)")
    parser.add_argument("--f32_params", action="store_true",
                        help="keep fp32 weights (default: bf16 serving cast)")
    parser.add_argument("--w8a8", action="store_true",
                        help="serve the UNet's internal convs in W8A8 int8 "
                             "(ops/int8.py); same checkpoints")
    parser.add_argument("--matting", type=str, default="auto",
                        choices=["auto", "native", "none"],
                        help="background removal for non-alpha inputs: "
                             "auto = carvekit/rembg if installed else the "
                             "in-repo color-model matting; none = treat the "
                             "photo as already clean")
    parser.add_argument("--device", type=str, default=None,
                        help="default: the CUDA card (raises without one); 'cpu' "
                             "runs on the CPU")
    flags = parser.parse_args(argv)

    from morphablediffusion_torch.utils import resolve_device
    from morphablediffusion_torch.utils.config import load_config
    from morphablediffusion_torch.utils.mesh_io import load_mesh_vertices

    mesh = None
    if flags.view_parallel:
        from morphablediffusion_torch.parallel import create_mesh

        mesh = create_mesh(flags.dist_backend, flags.device)
        device = mesh.device
    else:
        device = resolve_device(flags.device)
    writes = mesh is None or mesh.rank == 0
    img_name = Path(flags.input_img).stem
    exp_name = Path(flags.exp_img).stem if flags.exp_img else "mesh"

    cfg = load_config(flags.cfg)
    if flags.w8a8:
        cfg.model.unet.w8a8 = True
    input_img = load_input_image(flags.input_img, cfg.model.image_size,
                                 matting=flags.matting)
    if flags.camera_trajectory == "real":
        Ks, RTs = real_camera_trajectory(flags.trajectory_pkl, cfg.model.view_num)
    else:
        Ks, RTs = generate_camera_trajectory(cfg.model.view_num)

    verts = load_mesh_vertices(flags.mesh)
    if not flags.no_mica_alignment:
        verts = align_mica_mesh(verts)

    # a checkpoint that ships trained spconv (`xyzc_net`) weights selects
    # the fine conditioner, cropped to this mesh: the model is built only
    # after a peek at the checkpoint
    state_dict, t0 = None, time.perf_counter()
    if str(flags.ckpt).endswith(REFERENCE_SUFFIXES):
        from morphablediffusion_torch.utils.torch_import import load_torch_state_dict

        state_dict = load_torch_state_dict(flags.ckpt)
        autoselect_fine_conditioner(cfg.model, state_dict, verts)
    read_s = time.perf_counter() - t0

    views, report = run(cfg, input_img, Ks, RTs, verts, flags.ckpt, state_dict=state_dict,
                        seed=flags.seed, cfg_scale=flags.cfg_scale,
                        sample_steps=flags.sample_steps,
                        batch_view_num=flags.batch_view_num, eta=flags.eta,
                        f32_params=flags.f32_params, device=device, mesh=mesh)
    del state_dict

    t0 = time.perf_counter()
    if writes:
        out = Path(flags.output_dir)
        out.mkdir(parents=True, exist_ok=True)
        save_strip(input_img, list(views), out / f"{img_name}_{exp_name}.png")
        print(f"wrote {out / f'{img_name}_{exp_name}.png'}")
        if flags.prepare_neus2_data:
            neus2_root = out / "neus2_data" / f"{img_name}_{exp_name}"
            export_neus2(neus2_root, list(views), Ks, RTs)
            print(f"wrote NeuS2 data to {neus2_root}")
    report["seconds"] = dict(read=read_s, **report["seconds"],
                             write=time.perf_counter() - t0)
    if writes:
        print("seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in report["seconds"].items()),
              flush=True)
    if mesh is not None:
        from morphablediffusion_torch.parallel import close_mesh

        close_mesh(mesh)
    return views, report


if __name__ == "__main__":
    main()
