"""Trainer of the PyTorch port.

Counterpart of the JAX package's `training/trainer.py`:

  * parameters labelled frozen / base / cond (`param_labels`): VAE and CLIP
    frozen; the spatial-volume net and the model-level time MLP at
    `cond_lr_mult` x the base LR; the UNet at the base LR, or only its
    DepthTransformers with `finetune_unet=False`;
  * AdamW with optax.adamw's defaults (weight decay 1e-4 on every trainable
    parameter, eps 1e-8, betas 0.9 / 0.999), the LambdaLinear schedule
    evaluated at the number of optimizer steps taken so far (0 for the
    first update, as optax does);
  * frozen parameters get no update and no decay; VAE and CLIP are kept out
    of the optimizer and of autograd, stored in bf16 with their norms in fp32
    (`cast_frozen`). With `finetune_unet=False` the frozen UNet parameters
    still get gradients, as in the JAX package, where they count towards
    the reported grad_norm;
  * gradient accumulation with optax.MultiSteps semantics: the running mean
    of k micro-step gradients drives one optimizer step every k micro-steps;
  * `train_step` returns loss, grad_norm and step (micro-steps before this
    one), and draws its noise from the trainer's own `torch.Generator`;
  * data parallel on a `parallel.Mesh` with a group (the JAX "data" axis):
    each rank takes its rows of the global batch (the loader's shard, or
    `shard_batch`), draws the GLOBAL batch's noise from the one generator and
    slices its rows, so that a step on W ranks is the one-process step on
    the global batch; the loss is the global mean, the gradients are
    reduced into flat fp32 buffers and AdamW runs on them
    (`training/zero.py`), its moments and the accumulator sharded over the
    ranks with `config.train.shard_opt_state` (ZeRO-1; the numbers are the
    same without). Checkpoints hold torch.optim.AdamW's state dict whatever
    the world.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from morphablediffusion_torch.models.diffusion import MorphableDiffusion, TrainingDraws
from morphablediffusion_torch.parallel.collectives import all_reduce_sum
from morphablediffusion_torch.parallel.mesh import shard_batch
from morphablediffusion_torch.training.lr import lambda_linear_schedule
from morphablediffusion_torch.training.zero import ShardedAdamW
from morphablediffusion_torch.utils.config import Config
from morphablediffusion_torch.utils.spans import span
from morphablediffusion_torch.weights import NORM_MODULES, seeded_params

FROZEN, BASE, COND = "frozen", "base", "cond"
# optax.adamw's defaults
WEIGHT_DECAY, EPS, BETAS = 1e-4, 1e-8, (0.9, 0.999)


def param_label(name: str, finetune_unet: bool) -> str:
    """frozen / base / cond for a parameter name (the JAX package's rules on
    the flax path, which the port's names follow)."""
    if "first_stage" in name or "clip_image_encoder" in name:
        return FROZEN
    if "spatial_volume" in name:
        return COND
    if name.startswith("unet."):
        if finetune_unet or "_cond" in name or "middle_conditions" in name:
            return BASE
        return FROZEN
    if "time_embed" in name:
        return COND  # the model-level time MLP; the UNet's is matched above
    return BASE


def param_labels(model: torch.nn.Module, finetune_unet: bool) -> Dict[str, str]:
    return {n: param_label(n, finetune_unet) for n, _ in model.named_parameters()}


@torch.no_grad()
def cast_frozen(model: MorphableDiffusion) -> None:
    """Store the VAE and CLIP in bf16, their norm parameters in fp32, and
    take them out of autograd."""
    for part in (model.first_stage, model.clip_image_encoder):
        for module in part.modules():
            for p in module.parameters(recurse=False):
                if not isinstance(module, NORM_MODULES):
                    p.data = p.data.to(torch.bfloat16)
                p.requires_grad_(False)


class Trainer:
    """The model, its optimizer and generator, and the training step.

        trainer = Trainer(config, device="cuda", seed=6033)
        metrics = trainer.train_step(batch)   # {"loss", "grad_norm", "step"}
    """

    def __init__(self, config: Config, device=None, seed: Optional[int] = None,
                 model: Optional[MorphableDiffusion] = None, mesh=None):
        """model: the MorphableDiffusion to train (its weights as given);
        else a new one with weights made from `seed` (default
        config.train.seed). mesh: a `parallel.Mesh`; with a group the step
        is data parallel over its ranks (the model then lives on
        mesh.device)."""
        self.config = config
        self.mesh = mesh if mesh is not None and mesh.group is not None else None
        t = config.train
        seed = t.seed if seed is None else seed
        if self.mesh is not None:
            device = self.mesh.device
        if model is None:
            model = seeded_params(MorphableDiffusion(config.model, device=device), seed)
        self.model = model.train()
        self.device = self.model.device
        if t.frozen_params_bf16:
            cast_frozen(self.model)
        else:
            for p in list(self.model.first_stage.parameters()) + list(
                    self.model.clip_image_encoder.parameters()):
                p.requires_grad_(False)
        self.labels = param_labels(self.model, config.model.finetune_unet)
        params = dict(self.model.named_parameters())
        groups = [{"params": [p for n, p in params.items() if self.labels[n] == g],
                   "lr_mult": mult, "name": g}
                  for g, mult in ((BASE, 1.0), (COND, t.cond_lr_mult))]
        self.optimizer = torch.optim.AdamW(groups, lr=0.0, betas=BETAS, eps=EPS,
                                           weight_decay=WEIGHT_DECAY)
        self.zero = None
        if self.mesh is not None:
            # the flat buffers of the mesh: base, cond, and the frozen
            # parameters that get a gradient (they count in grad_norm)
            named = self.grad_params()
            self.zero = ShardedAdamW(
                [(g, [(n, p) for n, p in named if self.labels[n] == g], mult, g != FROZEN)
                 for g, mult in ((BASE, 1.0), (COND, t.cond_lr_mult), (FROZEN, 0.0))
                 if any(self.labels[n] == g for n, _ in named)],
                self.mesh, t.shard_opt_state, BETAS, EPS, WEIGHT_DECAY)
        self.schedule = lambda_linear_schedule(t.base_learning_rate, t.warm_up_steps,
                                               t.cycle_length, t.f_start, t.f_max, t.f_min)
        self.accumulate = max(1, t.accumulate_grad_batches)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.step = 0      # micro-steps taken
        self.opt_step = 0  # optimizer steps taken
        self._acc: Optional[Dict[str, torch.Tensor]] = None

    def lr_at(self, step: int) -> float:
        """Base learning rate at an optimizer step; the cond group runs at
        cond_lr_mult x this."""
        return self.schedule(step)

    def grad_params(self):
        """(name, parameter) of every parameter that gets a gradient."""
        return [(n, p) for n, p in self.model.named_parameters() if p.requires_grad]

    def train_step(self, batch, draws: Optional[TrainingDraws] = None) -> Dict:
        """One micro-step: loss, backward, and an optimizer step every
        `accumulate_grad_batches` micro-steps. draws: the step's random draws
        injected (tests), else they come from the trainer's generator; on a
        mesh the GLOBAL batch's draws, of which this rank takes its rows."""
        with span("md.train_step"):
            self.model.zero_grad(set_to_none=True)
            if self.zero is not None:
                if draws is None:
                    B = batch["target_image"].shape[0] * self.mesh.world
                    draws = self.model.draw_training_noise(B, self.generator)
                draws = self.local_draws(draws)
            with span("md.forward"):
                loss = self.model.training_loss(batch, draws=draws, generator=self.generator)
            with span("md.backward"):
                loss.backward()
            with span("md.update"):
                return self.apply_gradients(loss)

    def apply_gradients(self, loss) -> Dict:
        """After `loss.backward()`: grad_norm, accumulation and the optimizer
        step; returns the step's metrics. On a mesh the gradients and the
        loss are reduced over the ranks first."""
        if self.zero is not None:
            grads = self.zero.reduce_grads()
            grad_norm = torch.sqrt(self.zero.sq_norm(grads))
            loss = all_reduce_sum(loss, self.mesh) / self.mesh.world
        else:
            named = self.grad_params()
            for _, p in named:
                # a parameter this forward did not use (the single-key
                # cross-attentions' q and k) gets a zero gradient: torch's
                # AdamW skips a None gradient, optax.adamw still decays it
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = {n: p.grad for n, p in named}
            grad_norm = torch.sqrt(sum(g.float().pow(2).sum() for g in grads.values()))

        if self.accumulate > 1:
            mini = self.step % self.accumulate
            if self._acc is None:
                self._acc = {n: torch.zeros_like(g) for n, g in grads.items()}
            for n, g in grads.items():  # optax.MultiSteps' running mean
                self._acc[n] += (g - self._acc[n]) / (mini + 1)
            if mini == self.accumulate - 1:
                self._apply_update(self._acc)
                self._acc = None
        else:  # in one process the optimizer reads the parameters' gradients
            self._apply_update(grads if self.zero is not None else None)
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm.detach(), "step": self.step}
        self.step += 1
        return metrics

    def local_draws(self, draws: TrainingDraws) -> TrainingDraws:
        """This rank's rows of the global batch's draws (vae_target's N rows
        a sample are sample-major, so its equal shards are the samples')."""
        return {k: v.to(self.device) for k, v in shard_batch(draws, self.mesh).items()}

    def optimizer_bytes(self) -> int:
        """Bytes of AdamW moments this rank holds (fp32)."""
        if self.zero is not None:
            return 4 * self.zero.moment_elements()
        return sum(t.numel() * t.element_size() for st in self.optimizer.state.values()
                   for k, t in st.items() if k != "step")

    def _apply_update(self, grads) -> None:
        """The optimizer step at this step's learning rate on `grads` (on a
        mesh this rank's shards; in one process {name: gradient}, or None
        for the parameters' own)."""
        lr = self.lr_at(self.opt_step)
        if self.zero is not None:
            self.zero.step(grads, lr)
        else:
            if grads is not None:
                for n, p in self.grad_params():
                    p.grad = grads[n].clone()
            for group in self.optimizer.param_groups:
                group["lr"] = lr * group["lr_mult"]
            self.optimizer.step()
        self.opt_step += 1

    # checkpoint state

    def state_dict(self) -> Dict:
        """The whole training state, the same whatever the world (on a mesh
        the moments and the accumulator are gathered: every rank must
        call it)."""
        optimizer, acc = self.optimizer.state_dict(), self._acc
        if self.zero is not None:
            optimizer = self.zero.state_dict(optimizer)
            acc = None if acc is None else self.zero.gathered(acc)
        return {"model": self.model.state_dict(), "optimizer": optimizer,
                "step": self.step, "opt_step": self.opt_step,
                "generator": self.generator.get_state(), "acc": acc}

    def load_state_dict(self, state: Dict) -> None:
        """Load a state_dict written at any world (on a mesh this rank
        takes its shards)."""
        self.model.load_state_dict(state["model"])
        self.step, self.opt_step = state["step"], state["opt_step"]
        self.generator.set_state(state["generator"].cpu())
        acc = state["acc"]
        if self.zero is not None:
            self.zero.load_state_dict(state["optimizer"])
            self._acc = None if acc is None else self.zero.shards_of(acc)
            return
        self.optimizer.load_state_dict(state["optimizer"])
        self._acc = None if acc is None else {n: t.to(self.device) for n, t in acc.items()}
