"""What decides `correct`: the timed path's outputs against the plain
float32 reference (`reference.py`), which works everything out again from
the seed: its own weights, inputs and noise, nothing the program made.

Serving, one sampler call of the window drawn from the seed (the reference
follows the program step by step from the program's own latents, since a
float32 replay of 50 steps would part from a bfloat16 one by chaos alone):
  prep_gap    CLIP embedding and VAE posterior mode of the input portraits;
  volume_gap  the spatial volume (target encoder, unprojection, mesh
              conditioner) at the checked steps;
  step_gap    the noise prediction that the program's DDIM update implies
              (its next latent, its input latent and the seed's noise)
              against the reference's CFG noise prediction at the checked
              steps: the volume, frustum volumes, UNet and K1, K2, K4, the
              guidance and the update together;
  decode_gap  the returned avatars against the reference's decode of the
              call's final latents.
Each is a relative L2 distance, the worst over what it covers.

Training, the three steps of set-up that the reference follows from the
same weights, batches and draws:
  grad_gap    worst leaf's gap between the norms of the first gradient as
              AdamW holds it (exp_avg / (1 - beta1) after one step);
  change_gap  the median leaf's gap between the norms of the parameters'
              change over the three steps (the worst leaf's is printed, not
              compared: AdamW's first steps move a leaf of tiny gradients by
              about lr per element whatever the gradient, so its rounding
              shows as a gap of a fifth or more on every seed);
a leaf's gap taken against the larger of its reference norm and the median
leaf's. Leaves whose first reference gradient is under a thousandth of the
median leaf's (a single key's query and key maps, whose gradient is zero)
move by weight decay alone and are left out of change_gap. The steps'
losses are printed and not compared: sound runs read under 3e-3, and
neither the float8 reference nor half the batch left out reads three
times that on every seed.
"""

from __future__ import annotations

import math
import sys

import torch

from h100_bench import gen, reference, seeded

BETAS, EPS, WEIGHT_DECAY = (0.9, 0.999), 1e-8, 1e-4


def rel(a, b) -> float:
    a, b = a.float(), b.float().to(a.device)
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def served_reference(m: dict, seed: int, device):
    """The reference with the served weights (rounded to the served dtype)
    in float32."""
    dtype = gen.DTYPES[m["dtype"]]
    ref = reference.build(m, device)
    ref.load_state_dict(seeded.as_float32(seeded.make_state(m, seed, device,
                                                            served_dtype=dtype)))
    return ref


def checked_steps(seed: int, steps: int, n: int):
    """The DDIM indices checked in a run, drawn from the seed."""
    g = torch.Generator().manual_seed(gen.stream_seed(seed, "check") & 0xFFFFFFFF)
    return sorted(int(i) for i in torch.randperm(steps, generator=g)[:n])


def noise_stream(m, B, seed, call, steps, device):
    """The seed's draws of one sampler call, in the sampler's order: the
    initial latent, then the noise of each DDIM index steps-1 ... 1."""
    g = gen.generator(device, seed, "noise", call)
    shape = (B, m["view_num"], m["image_size"] // 8, m["image_size"] // 8, 4)
    x0 = torch.randn(shape, generator=g, device=device)
    return x0, {s: torch.randn(shape, generator=g, device=device)
                for s in range(steps - 1, 0, -1)}


def implied_eps(x, x_next, index, tables, noise):
    """The noise prediction that takes x to x_next by the DDIM update of
    `index` (inverting `reference.ddim_update`)."""
    _, a, a_prev, sig = tables
    a, ap, s = float(a[index]), float(a_prev[index]), float(sig[index])
    c2 = math.sqrt(max(1 - ap - s * s, 1e-7)) - math.sqrt(ap) * math.sqrt(1 - a) / math.sqrt(a)
    rest = x_next - math.sqrt(ap) / math.sqrt(a) * x
    if noise is not None:
        rest = rest - s * noise
    return rest / c2


@torch.no_grad()
def reference_serving(ref, cfgdoc, batch, got, keep, t_of):
    """The reference's outputs for the program's checked call: prep; at each
    checked step the spatial volume of the program's latents and the CFG
    noise prediction from the program's spatial volume (the volume's own
    gap is volume_gap's); the UNet on the program's UNet inputs; the decode
    of the program's final latents."""
    m, smp = cfgdoc["model"], cfgdoc["sampler"]
    clip, xin = ref.clip(batch["input_image"]), ref.encode(batch["input_image"])
    v_embed = ref.viewpoints(batch)
    out = {"clip": clip, "x_input": xin, "volume": {}, "eps": {}}
    for s in keep:
        x = got["x"][s].float()
        t = t_of(s, x.shape[0])
        t_embed = ref.time_embed(reference.timestep_embedding(t, m["time_embed_dim"]))
        out["volume"][s] = ref.spatial_volume_of(x, t_embed, v_embed, batch)
        out["eps"][s] = ref.eps_cfg(x, t, clip, xin, v_embed, batch, smp["cfg_scale"],
                                    volume=got["volume"][s].float())
    out["unet"] = unet_on(ref, got["unet"])
    lat = got["latents"]
    B, N = lat.shape[:2]
    out["images"] = ref.decode(lat.reshape(B * N, *lat.shape[2:]).float()).reshape(
        B, N, m["image_size"], m["image_size"], 3)
    return out


def unet_on(ref, u, chunk: int = 16):
    """The reference UNet on the program's UNet inputs: x (2B, 8, h, w), the
    conditional half first; under the doubled-batch contract the frustum
    volumes are the conditional half's and the unconditional half's are
    zero."""
    x, t, ctx = u["x"].float(), u["t"], u["context"].float()
    B = x.shape[0] // 2 if u["cfg_doubled"] else x.shape[0]
    vols = {w: v.float() for w, v in u["vols"].items()}
    outs = []
    for lo, hi in ((0, B), (B, x.shape[0])):
        for i in range(lo, hi, chunk):
            j = min(i + chunk, hi)
            if lo:
                v = {w: torch.zeros_like(a[:j - i]) for w, a in vols.items()}
            else:
                v = {w: a[i:j] for w, a in vols.items()}
            outs.append(ref.unet(x[i:j], t[i:j], ctx[i:j], v))
    return torch.cat(outs)


def gaps(got, want, keep, eps_of):
    """The serving numbers of `got` (the program's, or the control's)
    against `want` (the reference's)."""
    return {
        "prep_gap": max(rel(got["prep"]["clip_embed"], want["clip"]),
                        rel(got["prep"]["x_input"], want["x_input"])),
        "volume_gap": max(rel(got["volume"][s], want["volume"][s]) for s in keep),
        "unet_gap": rel(got["unet"]["out"], want["unet"]),
        "step_gap": max(rel(eps_of(s), want["eps"][s]) for s in keep),
        "decode_gap": rel(got["images"], want["images"]),
    }


def serving_readings(cfgdoc, traffic, seed, got, keep, device):
    """The serving numbers of the program's checked call."""
    m, smp = cfgdoc["model"], cfgdoc["sampler"]
    steps = smp["steps"]
    tables = reference.ddim_tables(steps, smp["eta"])
    reference.set_tf32(False)
    ref = served_reference(m, seed, device)
    t_of = lambda s, B: torch.full((B,), int(tables[0][s]), dtype=torch.int64, device=device)
    want = reference_serving(ref, cfgdoc, got["batch"], got, keep, t_of)
    _, noises = noise_stream(m, traffic["batch"], seed, got["call"], steps, device)

    def eps_of(s):
        nxt = got["x"][s - 1] if s > 0 else got["latents"]
        return implied_eps(got["x"][s].float(), nxt.float(), s, tables, noises.get(s))

    return gaps(got, want, keep, eps_of)


def with_limits(readings: dict, limits: dict) -> dict:
    return {k: {"value": v, "limit": limits.get(k, 0.0)} for k, v in readings.items()}


def serving(cfgdoc, traffic, seed, got, keep, device, limits):
    return with_limits(serving_readings(cfgdoc, traffic, seed, got, keep, device), limits)


# ---------------------------------------------------------------- training


def first_grad_norms(trainer) -> dict:
    """{name: norm of the first gradient} as AdamW holds it after one step."""
    out = {}
    for name, p in trainer.model.named_parameters():
        st = trainer.optimizer.state.get(p)
        if st and "exp_avg" in st:
            out[name] = float((st["exp_avg"].float() / (1 - BETAS[0])).norm())
    return out


def change_norms(trainer, m, seed, device) -> dict:
    """{name: norm of the change of a trained leaf since the seed's weights}."""
    start = seeded.make_state(m, seed, device)
    out = {}
    with torch.no_grad():
        for name, p in trainer.model.named_parameters():
            if p.requires_grad:
                out[name] = float((p.float() - start[name].float()).norm())
    del start
    return out


def trainable(name: str) -> str | None:
    """'base', 'cond' or None (frozen), as the recipe labels the leaves."""
    if name.startswith(seeded.FROZEN_PREFIXES):
        return None
    if name.startswith("spatial_volume.") or name.startswith("time_embed."):
        return "cond"
    return "base"


def lr_at(train: dict, k: int) -> float:
    """The recipe's LambdaLinear schedule at optimizer step k."""
    if k < train["warm_up_steps"]:
        f = train["f_start"] + (train["f_max"] - train["f_start"]) / train["warm_up_steps"] * k
    else:
        c = train["cycle_length"]
        f = train["f_min"] + (train["f_max"] - train["f_min"]) * (c - k) / c
    return train["base_learning_rate"] * f


def reference_training(cfgdoc, traffic, seed, device, steps: int, chunk: int = 10,
                       rows: int = 0):
    """The reference's losses, first gradient norms and change norms over
    `steps` AdamW steps from the seed's weights (the frozen VAE and CLIP
    rounded to bfloat16, as the recipe stores them). rows > 0 takes the
    loss over the batch's first `rows` rows only (a fault: the rest of the
    batch left out, the mean taken over these)."""
    m, tr = cfgdoc["model"], cfgdoc["train"]
    B, N = traffic["batch"], m["view_num"]
    used = rows or B
    reference.set_tf32(False)
    ref = reference.build(m, device)
    start = seeded.make_state(m, seed, device,
                              frozen_dtype=torch.bfloat16 if tr["frozen_params_bf16"] else None)
    ref.load_state_dict(seeded.as_float32(start))
    del start
    params = {n: p for n, p in ref.named_parameters()}
    for n, p in params.items():
        p.requires_grad_(trainable(n) is not None)
    trained = {n: p for n, p in params.items() if p.requires_grad}
    p0 = {n: p.detach().clone() for n, p in trained.items()}
    m1 = {n: torch.zeros_like(p) for n, p in trained.items()}
    m2 = {n: torch.zeros_like(p) for n, p in trained.items()}
    losses, g1 = [], {}
    make = gen.BatchMaker(m, traffic, seed, device)
    for k in range(steps):
        batch = make(k, with_targets=True)
        draws = gen.training_draws(m, B, seed, k, device)
        for p in trained.values():
            p.grad = None
        total = 0.0
        for i in range(0, used, chunk):
            j = min(used, i + chunk)
            sub = {key: v[i:j] for key, v in batch.items()}
            sd = {key: (v[i * N:j * N] if key == "vae_target" else v[i:j])
                  for key, v in draws.items()}
            loss = ref.training_loss(sub, sd) * ((j - i) / used)
            loss.backward()
            total += loss.item()
        losses.append(total)
        with torch.no_grad():
            lr = lr_at(tr, k)
            for n, p in trained.items():
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                if k == 0:
                    g1[n] = float(g.norm())
                step_lr = lr * (tr["cond_lr_mult"] if trainable(n) == "cond" else 1.0)
                p.mul_(1 - step_lr * WEIGHT_DECAY)
                m1[n].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                m2[n].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                mh = m1[n] / (1 - BETAS[0] ** (k + 1))
                vh = m2[n] / (1 - BETAS[1] ** (k + 1))
                p.sub_(step_lr * mh / (vh.sqrt() + EPS))
    change = {n: float((p.detach() - p0[n]).norm()) for n, p in trained.items()}
    return losses, g1, change


def leaf_gaps(got: dict, want: dict, names) -> dict:
    """{leaf: |got - want| / max(want, the median leaf's want)}."""
    base = sorted(want[n] for n in names)[len(names) // 2]
    return {n: abs(got[n] - want[n]) / max(want[n], base) for n in names}


def training_gaps(losses, g1, change, ref_losses, ref_g1, ref_change) -> dict:
    names = sorted(ref_g1)
    med = sorted(ref_g1[n] for n in names)[len(names) // 2]
    moved = [n for n in names if ref_g1[n] >= 1e-3 * med]
    changes = leaf_gaps(change, ref_change, moved)
    worst = max(changes, key=changes.get)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    print(f"not compared: loss gap {loss_gap:.4e}, worst leaf's change gap "
          f"{changes[worst]:.4e} ({worst})", file=sys.stderr)
    return {
        "grad_gap": max(leaf_gaps(g1, ref_g1, names).values()),
        "change_gap": sorted(changes.values())[len(changes) // 2],
    }


def training(cfgdoc, traffic, seed, losses, grad_norms, change, device, limits):
    ref_losses, ref_g1, ref_change = reference_training(cfgdoc, traffic, seed, device,
                                                        len(losses))
    # a leaf that AdamW holds no state for has not been stepped: gradient 0
    grads = {n: grad_norms.get(n, 0.0) for n in ref_g1}
    return with_limits(training_gaps(losses, grads, change, ref_losses, ref_g1, ref_change),
                       limits)
