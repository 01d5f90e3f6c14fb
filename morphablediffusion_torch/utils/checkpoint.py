"""Checkpoints of the PyTorch port: rolling "last" + permanent snapshots, a
params export, and resume.

Counterpart of the JAX package's `utils/checkpoint.py` (the reference's
save_last every `rolling_every` steps, a permanent snapshot every
`snapshot_every` steps, `--resume`, and the refusal to overwrite an existing
run), written with `torch.save`. A checkpoint holds the trainer's whole
state: parameters, optimizer state, step counters, the generator's state and
any partly accumulated gradients; the params export holds the model's
state_dict alone.

    ckpt_dir/last/state.pt          newest rolling checkpoint
    ckpt_dir/last/step              its step, as text
    ckpt_dir/snapshots/<step>.pt    permanent snapshots
    ckpt_dir/params/params.pt       params export of the newest rolling step

On a `parallel.Mesh` with a group every rank builds the state (the trainer
gathers its sharded optimizer state), rank 0 alone writes it, and the other
ranks wait for it at a barrier; every rank restores. Rank 0 decides whether
a run would be overwritten, and every rank raises on its verdict.

It also reads the JAX package's run directories (`utils/orbax_reader.py`),
whose orbax managers write `last/<step>/` (the TrainState) and
`params/<step>/` (the params export) in the same `ckpt_dir`. Where the
port's own file is missing, `restore_params` reads the newest JAX params
export and `restore` the newest JAX TrainState (`jax_train_state`); the
port then writes its own layout beside JAX's step directories and prefers
it from then on. `latest_step` counts either.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from morphablediffusion_torch.parallel.collectives import all_reduce_sum, barrier
from morphablediffusion_torch.utils import orbax_reader
from morphablediffusion_torch.weights import from_jax_params


def _save(obj, path: Path) -> None:
    """torch.save through a temporary file and a rename, so a run that is
    cut off never leaves a half-written checkpoint under the final name."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, ckpt_dir, rolling_every: int = 1000, snapshot_every: int = 2000,
                 mesh=None):
        self.mesh = mesh
        self.writer = mesh is None or mesh.rank == 0
        self.ckpt_dir = Path(ckpt_dir).absolute()
        self.rolling_every = rolling_every
        self.snapshot_every = snapshot_every
        self.last = self.ckpt_dir / "last" / "state.pt"
        self.params = self.ckpt_dir / "params" / "params.pt"

    def assert_fresh_or_resume(self, resume: bool) -> None:
        """Refuse to overwrite an existing run unless it is resumed."""
        exists = self.writer and self.latest_step() is not None
        if self.mesh is not None and self.mesh.group is not None:  # rank 0's verdict
            exists = bool(all_reduce_sum(torch.tensor([float(exists)], device=self.mesh.device),
                                        self.mesh) > 0)
        if not resume and exists:
            raise RuntimeError(f"checkpoints exist under {self.ckpt_dir}; pass --resume "
                               "to continue or choose a new run directory")

    def maybe_save(self, trainer, step: int, force: bool = False) -> None:
        """Save at the rolling and snapshot cadences of `step` (or now, with
        force)."""
        rolling = force or (self.rolling_every and step % self.rolling_every == 0)
        snapshot = self.snapshot_every and step > 0 and step % self.snapshot_every == 0
        if not (rolling or snapshot):
            return
        state = {"step": step, "trainer": trainer.state_dict()}
        if self.writer:
            if rolling:
                _save(state, self.last)
                _save(trainer.model.state_dict(), self.params)
                self.last.with_name("step").write_text(str(step))
            if snapshot:
                _save(state, self.ckpt_dir / "snapshots" / f"{step}.pt")
        barrier(self.mesh)

    def latest_step(self) -> Optional[int]:
        """The step of the port's rolling checkpoint, else of the newest JAX
        TrainState, else None."""
        step_file = self.last.with_name("step")
        if step_file.is_file():
            return int(step_file.read_text())
        return self.jax_step("last")

    def jax_step(self, kind: str) -> Optional[int]:
        """The newest finished step of the JAX package's `kind` manager
        ('last', 'params' or 'snapshots'), or None."""
        return orbax_reader.latest_step(self.ckpt_dir / kind)

    def restore(self, trainer) -> int:
        """Load the newest rolling checkpoint into `trainer` (the port's, else
        the JAX package's TrainState); returns its step."""
        if not self.last.is_file():
            step = self.jax_step("last")
            if step is None:
                raise FileNotFoundError(f"no checkpoint under {self.ckpt_dir}")
            trainer.load_state_dict(jax_train_state(self.ckpt_dir / "last" / str(step), trainer))
            if self.writer:
                print(f"resumed the JAX TrainState {self.ckpt_dir / 'last' / str(step)}: its "
                      "threefry key cannot become a torch.Generator state; the generator is "
                      f"seeded from (train.seed, step) = ({trainer.config.train.seed}, {step})")
            return step
        state = torch.load(self.last, map_location=trainer.device, weights_only=False)
        trainer.load_state_dict(state["trainer"])
        return state["step"]

    def restore_params(self, model: torch.nn.Module) -> torch.nn.Module:
        """Load the params export into `model` (inference side): the port's,
        else the JAX package's newest (`load_state_dict(strict=True)`)."""
        return load_params_dir(model, self.ckpt_dir)


def _holds_tree(path: Path) -> bool:
    return any((d / "_METADATA").is_file() for d in (path, path / "default"))


def params_source(path) -> Path:
    """Where the parameters of a directory are: the directory itself if it
    holds one Orbax tree (a JAX `params/<step>` directory, or the JAX
    tools' native cache, a PyTreeCheckpointer directory); else, for a run's
    ckpt directory, the port's params export (`params/params.pt`), else the
    JAX package's newest (`params/<step>`). Raises FileNotFoundError if it
    holds none."""
    path = Path(path)
    if _holds_tree(path):
        return path
    port = path / "params" / "params.pt"
    if port.is_file():
        return port
    step = orbax_reader.latest_step(path / "params")
    if step is None:
        raise FileNotFoundError(f"no params export under {path} (neither the port's "
                                "params/params.pt nor a JAX params/<step>/ or Orbax tree)")
    return path / "params" / str(step)


def params_state_dict(source: Path, device, module: str = "") -> Dict[str, torch.Tensor]:
    """The port's state_dict of the parameters at `source` (`params_source`)
    on `device`, or of the submodule `module` alone, its keys relative to
    it (an Orbax tree: only that subtree's leaves are read)."""
    if source.suffix == ".pt":
        sd = torch.load(source, map_location=device, weights_only=True)
        pre = module + "." if module else ""
        return {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
    prefix = ("params",) + (tuple(module.split(".")) if module else ())
    tree = orbax_reader.read_tree(source, prefix)
    return from_jax_params(orbax_reader.flat_params(tree, prefix), device=device)


def load_params_dir(model: torch.nn.Module, path) -> torch.nn.Module:
    """Fill `model` (`load_state_dict(strict=True)`) from a directory
    (`params_source`): one Orbax params tree, or a run's ckpt directory
    (the port's params export, else the JAX package's newest)."""
    model.load_state_dict(params_state_dict(params_source(path), model.device), strict=True)
    return model


def resume_seed(seed: int, step: int) -> int:
    """The port's generator seed on resuming a JAX TrainState at `step`."""
    return (seed << 32) + step


def jax_train_state(step_dir, trainer) -> Dict:
    """The JAX Trainer's TrainState (a `last/<step>` directory) as
    `trainer.state_dict()` would hold it:

      * step -> the micro-step counter; params -> the model
        (`weights.from_jax_params`);
      * opt_state: optax.MultiSteps (accumulate_grad_batches > 1) holds
        mini_step, gradient_step, inner_opt_state and acc_grads, else the
        inner state stands at the top; `inner_states[base|cond]
        .inner_state[0]` is each AdamW's {count, mu, nu} (`frozen` has no
        moments): count -> AdamW's step and the optimizer-step counter,
        mu / nu -> exp_avg / exp_avg_sq in the port's layout; acc_grads ->
        the accumulator (None at a step that starts a new accumulation);
      * rng, a threefry key, cannot become a torch.Generator state: the
        generator is seeded `resume_seed(config.train.seed, step)`.

    Each subtree (the parameters, each group's mu and nu, the accumulator)
    is read, moved to `trainer.device` in the port's layout and dropped
    before the next is read: the host holds one subtree at a time.
    """
    tree = orbax_reader.StepTree(step_dir)
    dev = trainer.device

    def scalar(*path):
        return int(np.asarray(tree.read(path)[path]))

    def on_device(*prefix):  # {port name: tensor} of one subtree of the tree
        return from_jax_params(orbax_reader.flat_params(tree.read(prefix), prefix), device=dev)

    step = scalar("step")
    k = trainer.accumulate
    multi = ("opt_state", "mini_step") in tree
    if multi != (k > 1):
        raise ValueError(f"the JAX optimizer state {'holds' if multi else 'lacks'} "
                         f"optax.MultiSteps, but accumulate_grad_batches is {k}")
    if multi and scalar("opt_state", "mini_step") != step % k:
        raise ValueError(f"mini_step {scalar('opt_state', 'mini_step')} is not step {step} "
                         f"mod {k}")
    inner = ("opt_state", "inner_opt_state") if multi else ("opt_state",)

    template = trainer.optimizer.state_dict()
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    order = [names[id(p)] for g in trainer.optimizer.param_groups for p in g["params"]]
    index = {n: i for i, n in enumerate(order)}
    state, counts = {}, set()
    for group in trainer.optimizer.param_groups:
        adam = inner + ("inner_states", group["name"], "inner_state", 0)
        count = scalar(*adam, "count")
        counts.add(count)
        mu, nu = on_device(*adam, "mu", "params"), on_device(*adam, "nu", "params")
        for p in group["params"]:
            n = names[id(p)]
            state[index[n]] = {"step": torch.tensor(float(count)), "exp_avg": mu.pop(n),
                               "exp_avg_sq": nu.pop(n)}
        del mu, nu
    if len(counts) > 1:
        raise ValueError(f"the AdamW counts differ between the groups: {sorted(counts)}")

    acc = None
    if multi and step % k:
        grads = on_device("opt_state", "acc_grads", "params")
        acc = {n: grads.pop(n).to(p.dtype) for n, p in trainer.grad_params()}
        del grads
    params = on_device("params", "params")
    generator = torch.Generator(trainer.device).manual_seed(
        resume_seed(trainer.config.train.seed, step))
    return {"model": params,
            "optimizer": {"state": state, "param_groups": template["param_groups"]},
            "step": step, "opt_step": counts.pop() if counts else 0,
            "generator": generator.get_state(), "acc": acc}
