"""Dataclass config system with YAML loading (the PyTorch port's own copy).

The same dataclasses, defaults and YAML loader as the JAX package's
`utils/config.py`, kept as a copy so that the port imports nothing from the
JAX package. Every knob of the reference's OmegaConf YAML configs
(configs/facescape.yaml, configs/thuman.yaml) is preserved, plus the compute
dtype, the static voxel-grid shape and the static vertex padding.

`load_config` reads either the flat YAML schema or a reference-style YAML
(model/params nesting); both map onto the same dataclasses.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Tuple


@dataclasses.dataclass
class UNetConfig:
    in_channels: int = 8
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    attention_ds: Tuple[int, ...] = (1, 2, 4)
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_heads: int = 8
    transformer_depth: int = 1
    context_dim: int = 768
    volume_dims: Tuple[int, ...] = (64, 128, 256, 512)
    # gradient checkpointing of UNet blocks during training (the reference's
    # use_checkpoint, configs/facescape.yaml unet_config); inference never
    # rematerializes regardless.
    use_checkpoint: bool = True
    # W8A8 int8 serving of the UNet's internal convs (ops/int8.py): ResBlocks,
    # Up/Downsample, SpatialTransformer 1x1s, DepthTransformer projections;
    # input_conv and out_conv stay in the compute dtype. Parameters unchanged.
    w8a8: bool = False


@dataclasses.dataclass
class CLIPConfig:
    width: int = 1024
    layers: int = 24
    num_heads: int = 16
    patch_size: int = 14
    output_dim: int = 768


@dataclasses.dataclass
class ModelConfig:
    view_num: int = 16
    image_size: int = 256
    cfg_scale: float = 2.0
    output_num: int = 8
    # Sampler memory knob (reference morphable_diffusion.py:723): chunk the
    # per-view frustum+UNet work. Serving runs all views in one batch (0);
    # mid-train validation keeps 4 because the card also holds fp32 params
    # and optimizer moments.
    batch_view_num: int = 4
    finetune_unet: bool = True
    finetune_projection: bool = True
    drop_conditions: bool = False
    drop_scheme: str = "default"
    projection: str = "perspective"
    use_spatial_volume: bool = False
    sample_type: str = "ddim"
    sample_steps: int = 50
    target_elevation: float = 0.0
    time_embed_dim: int = 256
    viewpoint_dim: int = 4
    # spatial volume geometry (morphable_diffusion.py:152-180)
    spatial_volume_size: int = 32
    spatial_volume_length: float = 0.5
    frustum_volume_depth: int = 48
    frustum_volume_length: float = 0.86603  # sqrt(3)/2
    # VAE architecture (fixed in the reference at _init_first_stage
    # :399-422; configurable here so tiny test configs stay cheap)
    vae_ch: int = 128
    vae_ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    vae_num_res_blocks: int = 2
    # compute dtype of the modules (norm statistics stay fp32)
    dtype: str = "bfloat16"
    # chunk size for streaming large batches through the frozen VAE encoder
    # (bounds transient HBM during training prepare; 0 = no chunking)
    vae_encode_chunk: int = 16
    voxel_grid_shape: Tuple[int, int, int] = (48, 48, 48)
    coarse_voxel_size: float = 0.02
    # mesh conditioner (spconv replacement) mode:
    #   'coarse' — 0.02 m dense grid (models/mesh_voxel.py MeshVoxelNet);
    #              trains from scratch. Published xyzc_net weights do NOT apply.
    #   'fine'   — dense emulation of the reference's spconv SparseConvNet at
    #              0.005 m, which takes published `spatial_volume.xyzc_net.*`
    #              checkpoints (models/mesh_voxel.py FineMeshVoxelNet).
    mesh_voxel_mode: str = "coarse"
    fine_grid_shape: Tuple[int, int, int] = (128, 144, 128)
    fine_voxel_size: float = 0.005
    max_vertices: int = 5120  # FLAME=5023; SMPL-X needs 10496; bilinear 26496
    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    clip: CLIPConfig = dataclasses.field(default_factory=CLIPConfig)

    @property
    def latent_size(self) -> int:
        return self.image_size // 8


@dataclasses.dataclass
class DataConfig:
    dataset: str = "facescape"  # facescape | thuman
    data_dir: str = ""
    smplx_dir: str = ""
    flame_assets_dir: str = ""  # tracked-FLAME meshes root (topology 'flame')
    mesh_topology: str = "flame"  # flame | bilinear (facescape.yaml:48)
    shuffled_expression: bool = True
    batch_size: int = 70  # per host, matching reference per-GPU batch
    num_workers: int = 4
    seed: int = 0
    # optional explicit uid lists ("subject/expression"); empty = the
    # reference train/val split tables. Used for subset debugging and the
    # CLI smoke tests.
    uids: Tuple[str, ...] = ()
    val_uids: Tuple[str, ...] = ()


@dataclasses.dataclass
class TrainConfig:
    base_learning_rate: float = 5e-5
    max_steps: int = 6000
    warm_up_steps: int = 100
    cycle_length: int = 100000
    f_start: float = 0.02
    f_max: float = 1.0
    f_min: float = 1.0
    val_check_interval: int = 250
    checkpoint_every: int = 2000
    rolling_checkpoint_every: int = 1000
    seed: int = 6033
    cond_lr_mult: float = 10.0  # conditioning nets at 10x base LR (:638-639)
    log_every: int = 20
    # ZeRO-1: shard AdamW moments over the data axis (numerically identical;
    # ~7 GB fp32 of moments for the trainable set split across the mesh)
    shard_opt_state: bool = True
    # store strictly-frozen params (VAE + CLIP, ~390M) in bf16 during
    # training — halves their HBM and matches the bf16 serving cast; the
    # compute path already runs them in bf16
    frozen_params_bf16: bool = True
    # micro-batch gradient accumulation (reference accumulate_grad_batches,
    # facescape.yaml:66): optimizer steps every k micro-steps with averaged
    # grads — the reference's global batch 140 on an 8-chip v5e slice is
    # batch_size 4/chip x 8 chips x k=4 ~= 128, or 5/chip x 7 = 140 exactly
    accumulate_grad_batches: int = 1


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


def _apply(dc, d: dict):
    for k, v in d.items():
        if not hasattr(dc, k):
            continue
        cur = getattr(dc, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _apply(cur, v)
        elif isinstance(v, list):
            setattr(dc, k, tuple(v))
        else:
            setattr(dc, k, v)


_THUMAN_DEFAULTS = dict(
    projection="orthographic",
    voxel_grid_shape=(80, 48, 80),
    fine_grid_shape=(256, 144, 256),  # SMPL-X at 0.005 m (SURVEY hard parts)
    max_vertices=10496,
)


def load_config(path: str | Path) -> Config:
    import yaml  # only the YAML loader needs PyYAML

    raw = yaml.safe_load(Path(path).read_text())
    cfg = Config()

    if "model" in raw and isinstance(raw["model"], dict) and "params" in raw["model"]:
        # reference-style YAML (target/params nesting)
        params = dict(raw["model"]["params"])
        unet_params = params.pop("unet_config", {}).get("params", {})
        sched = params.pop("scheduler_config", {}).get("params", {})
        _apply(cfg.model, params)
        _apply(
            cfg.model.unet,
            {
                k: v
                for k, v in unet_params.items()
                if k in {f.name for f in dataclasses.fields(UNetConfig)}
            },
        )
        if "attention_resolutions" in unet_params:
            cfg.model.unet.attention_ds = tuple(unet_params["attention_resolutions"])
        if sched:
            for src, dst in [
                ("warm_up_steps", "warm_up_steps"),
                ("cycle_lengths", "cycle_length"),
                ("f_start", "f_start"),
                ("f_max", "f_max"),
                ("f_min", "f_min"),
            ]:
                if src in sched:
                    v = sched[src]
                    setattr(cfg.train, dst, v[0] if isinstance(v, list) else v)
        if "base_learning_rate" in raw["model"]:
            cfg.train.base_learning_rate = raw["model"]["base_learning_rate"]
        data = raw.get("data", {})
        target = data.get("target", "")
        dparams = data.get("params", {})
        if "thuman" in target.lower():
            cfg.data.dataset = "thuman"
            _apply(cfg.model, _THUMAN_DEFAULTS)
        _apply(cfg.data, dparams)
        lightning = raw.get("lightning", {})
        trainer = lightning.get("trainer", {})
        if "max_steps" in trainer:
            cfg.train.max_steps = trainer["max_steps"]
        if "val_check_interval" in trainer:
            cfg.train.val_check_interval = trainer["val_check_interval"]
        mc = lightning.get("modelcheckpoint", {}).get("params", {})
        if "every_n_train_steps" in mc:
            cfg.train.checkpoint_every = mc["every_n_train_steps"]
    else:
        # native flat schema
        _apply(cfg, raw)
        if cfg.data.dataset == "thuman":
            defaults = dict(_THUMAN_DEFAULTS)
            overrides = raw.get("model", {})
            for k, v in defaults.items():
                if k not in overrides:
                    _apply(cfg.model, {k: v})
    return cfg
