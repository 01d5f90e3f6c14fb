"""First-stage (AutoencoderKL) pre-training CLI of the PyTorch port.

Counterpart of the JAX package's `apps/train_vae.py`. The reference never
trains its VAE: it inherits Stable Diffusion's, frozen. Without that
download, the from-scratch recipe needs a first stage that works, so this
CLI trains the `models.vae.AutoencoderKL` that the diffusion model embeds
(the same module tree, so `train.py --vae_from` grafts it into
`first_stage`) on the images of a FaceScape-layout tree: posterior-sampled
reconstructions, MSE plus kl_weight x KL, Adam (eps 1e-8) under a linear
warm-up and cosine decay to a tenth of the rate, bf16 compute on fp32
parameters, noise from an explicit `torch.Generator`.

Latent-scale contract: the diffusion side multiplies latents by the fixed
Stable-Diffusion constant 0.18215 (`models.diffusion.FIRST_STAGE_SCALE`) and
expects the scaled latents to be about unit-variance. After training, the
latent std is measured over 4 batches with the posterior mean and the
correction is folded into the parameters (`fold_latent_scale`), so that
`decode(encode(x))` is unchanged and z * 0.18215 is about unit-variance.

The output is the port's own format: `torch.save` of {"state_dict", "meta"}
with the JAX CLI's meta keys (ch, ch_mult, num_res_blocks, image_size,
latent_std_raw, fold_scale). `load_vae` (so `train.py --vae_from`) also
reads the JAX CLI's `.msgpack` ({"params": {"params": tree}, "meta"})
without flax (`utils/flax_msgpack.py`). Both CLIs fold the latent scale
the same way, into the parameters before the file is written, so a JAX
file is grafted as it is, with no second fold; its meta carries across
unchanged (`fold_scale` records the fold, it is not applied again).

    python -m morphablediffusion_torch.apps.train_vae --data_dir /tmp/synth/data \
        --image_size 128 --out runs/synth_vae/vae.pt --steps 3000 [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import time
from pathlib import Path

import numpy as np
import torch


class ImageFolderDataset:
    """Every `rgba_colorcalib.png` (else every png) under a dataset tree,
    loaded by the white composite and bicubic resize of the diffusion data
    (`data.common.load_rgba_white`), (S, S, 3) in [-1, 1]."""

    def __init__(self, data_dir: str, image_size: int):
        root = Path(data_dir)
        self.paths = sorted(root.rglob("rgba_colorcalib.png")) or sorted(root.rglob("*.png"))
        if not self.paths:
            raise SystemExit(f"no pngs under {data_dir}")
        self.image_size = image_size

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        from morphablediffusion_torch.data.common import load_rgba_white

        return {"image": load_rgba_white(self.paths[i], self.image_size)}


def build_vae(meta: dict, device=None, dtype=torch.bfloat16):
    """The AutoencoderKL of a train_vae file's meta: fp32 parameters,
    computing in `dtype`."""
    from morphablediffusion_torch.models.vae import AutoencoderKL

    return AutoencoderKL(ch=meta["ch"], ch_mult=tuple(meta["ch_mult"]),
                         num_res_blocks=meta["num_res_blocks"], dtype=dtype).to(device)


def fold_latent_scale(state_dict: dict, s: float) -> dict:
    """A copy of an AutoencoderKL state_dict with the latent rescale z -> s z
    folded into the quant convs: the mean rows of quant_conv scale by s, its
    logvar bias shifts by 2 ln s, post_quant_conv's weight divides by s.
    `decode(encode(x))` is unchanged; the latents are s times larger."""
    sd = dict(state_dict)
    w, b = sd["quant_conv.weight"], sd["quant_conv.bias"]
    emb = w.shape[0] // 2  # mean channels
    sd["quant_conv.weight"] = torch.cat([w[:emb] * s, w[emb:]])
    sd["quant_conv.bias"] = torch.cat([b[:emb] * s, b[emb:] + 2.0 * math.log(s)])
    sd["post_quant_conv.weight"] = sd["post_quant_conv.weight"] / s
    return sd


def save_vae(path: str, state_dict: dict, meta: dict) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"state_dict": {k: v.detach().cpu() for k, v in state_dict.items()},
                "meta": meta}, p)


def load_vae(path: str):
    """-> (AutoencoderKL state_dict on the CPU, meta dict) of the port's
    file (`save_vae`) or of the JAX CLI's `.msgpack`, told apart by content
    (a torch zip starts `PK\\x03\\x04`). Graft it into a diffusion model's
    `first_stage` (`apps.train --vae_from`)."""
    from morphablediffusion_torch.utils import flax_msgpack
    from morphablediffusion_torch.weights import from_jax_params

    if flax_msgpack.is_torch_file(path):
        blob = torch.load(path, map_location="cpu", weights_only=True)
        return blob["state_dict"], blob["meta"]
    blob = flax_msgpack.restore(path)
    state = from_jax_params(flax_msgpack.flatten(blob["params"]["params"]), device="cpu")
    return state, blob["meta"]


def vae_loss(vae, x, eps, kl_weight: float):
    """The training objective: x (B, 3, H, W) in [-1, 1], eps the posterior
    draw, shaped like the latent (B, 4, h, w). Returns (mse + kl_weight * kl, {"mse", "kl",
    "latent_std"}); the KL is per sample, summed over the latent, averaged
    over the batch, in the posterior's dtype."""
    from morphablediffusion_torch.models.vae import sample_diagonal_gaussian

    mean, logvar = vae.encode_moments(x)
    z = sample_diagonal_gaussian(mean, logvar, eps)
    recon = vae.decode(z).float()
    mse = torch.mean((recon - x) ** 2)
    kl = 0.5 * torch.mean(torch.sum(mean**2 + torch.exp(logvar) - 1.0 - logvar, dim=(1, 2, 3)))
    loss = mse + kl_weight * kl
    aux = {"mse": mse.detach(), "kl": kl.detach(),
           "latent_std": torch.std(mean.detach().float(), correction=0)}
    return loss, aux


def make_schedule(lr: float, steps: int):
    """optax.warmup_cosine_decay_schedule(0, lr, min(100, steps // 10),
    steps, lr / 10) as a function of the optimizer's update count (0 for
    the first update): linear from 0 over the warm-up, then cosine decay to
    a tenth of lr over the rest."""
    warmup = min(100, steps // 10)
    decay = steps - warmup
    if decay <= 0:
        raise ValueError(f"train_vae: {steps} steps leave no decay after a {warmup}-step warm-up")
    alpha = 0.0 if lr == 0.0 else 0.1

    def schedule(count: int) -> float:
        if count < warmup:
            return lr * count / warmup
        c = min(count - warmup, decay)
        return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay)) + alpha)

    return schedule


def to_images(batch, device) -> torch.Tensor:
    """A loader batch's (B, S, S, 3) images -> (B, 3, S, S) fp32 on device."""
    return torch.as_tensor(np.asarray(batch["image"], np.float32), device=device).permute(
        0, 3, 1, 2).contiguous()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--out", type=str, required=True,
                        help="output file (torch.save of state_dict + arch meta)")
    parser.add_argument("--image_size", type=int, default=128)
    parser.add_argument("--ch", type=int, default=32)
    parser.add_argument("--ch_mult", type=str, default="1,2,2,4")
    parser.add_argument("--num_res_blocks", type=int, default=1)
    parser.add_argument("--steps", type=int, default=3000)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--kl_weight", type=float, default=1e-6)
    parser.add_argument("--log_every", type=int, default=50)
    parser.add_argument("--save_every", type=int, default=500)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--device", type=str, default=None,
                        help="default: the CUDA card (raises without one); 'cpu' "
                             "runs on the CPU")
    flags = parser.parse_args(argv)

    from morphablediffusion_torch.data.loader import PrefetchLoader
    from morphablediffusion_torch.models.diffusion import FIRST_STAGE_SCALE
    from morphablediffusion_torch.utils import resolve_device
    from morphablediffusion_torch.weights import seeded_params

    device = resolve_device(flags.device)
    ch_mult = tuple(int(x) for x in flags.ch_mult.split(","))
    meta = dict(ch=flags.ch, ch_mult=list(ch_mult), num_res_blocks=flags.num_res_blocks,
                image_size=flags.image_size)
    vae = seeded_params(build_vae(meta, device), flags.seed)

    ds = ImageFolderDataset(flags.data_dir, flags.image_size)
    print(f"{len(ds)} images under {flags.data_dir}")
    loader = PrefetchLoader(ds, flags.batch_size, seed=flags.seed,
                            num_workers=flags.num_workers)
    batches = loader.epochs()
    n_params = sum(p.numel() for p in vae.parameters())
    print(f"VAE params: {n_params / 1e6:.2f} M "
          f"(ch={flags.ch}, mult={ch_mult}, blocks={flags.num_res_blocks})")

    sched = make_schedule(flags.lr, flags.steps)
    opt = torch.optim.Adam(vae.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    gen = torch.Generator(device).manual_seed(flags.seed)
    down = 2 ** (len(ch_mult) - 1)  # the encoder's downsampling
    out = Path(flags.out)
    try:
        t_last = time.perf_counter()
        x = to_images(next(batches), device)
        for step in range(1, flags.steps + 1):
            for group in opt.param_groups:
                group["lr"] = sched(step - 1)  # optax: the count before this update
            opt.zero_grad(set_to_none=True)
            eps = torch.randn((x.shape[0], 4, x.shape[2] // down, x.shape[3] // down),
                              generator=gen, device=device)
            loss, aux = vae_loss(vae, x, eps, flags.kl_weight)
            loss.backward()
            opt.step()
            x = to_images(next(batches), device)
            if step % flags.log_every == 0:
                mse = float(aux["mse"])
                psnr = -10.0 * np.log10(max(mse, 1e-12) / 4.0)  # range [-1, 1]
                dt = (time.perf_counter() - t_last) / flags.log_every
                t_last = time.perf_counter()
                print(f"step {step} loss {float(loss.detach()):.5f} mse {mse:.5f} "
                      f"psnr {psnr:.1f} dB kl {float(aux['kl']):.1f} "
                      f"latent_std {float(aux['latent_std']):.3f} {dt * 1000:.0f} ms/step",
                      flush=True)
            if step % flags.save_every == 0 or step == flags.steps:
                save_vae(str(out), vae.state_dict(), meta)

        # fold the latent rescale (module docstring), measured with the
        # posterior mean, which is what inference encodes
        stds = []
        with torch.no_grad():
            for _ in range(4):
                mean, _ = vae.encode_moments(x)
                stds.append(float(torch.std(mean.float(), correction=0)))
                x = to_images(next(batches), device)
    finally:
        batches.close()  # stops the producer thread
    std = float(np.mean(stds))
    s = (1.0 / FIRST_STAGE_SCALE) / max(std, 1e-6)
    meta["latent_std_raw"] = std
    meta["fold_scale"] = s
    save_vae(str(out), fold_latent_scale(vae.state_dict(), s), meta)
    print(f"latent std {std:.3f} -> folded x{s:.3f} so that z*{FIRST_STAGE_SCALE} is "
          f"~unit-variance; saved {out}")


if __name__ == "__main__":
    main()
