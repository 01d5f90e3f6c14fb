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
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import torch

from morphablediffusion_torch.parallel.collectives import all_reduce_sum, barrier


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
        step_file = self.last.with_name("step")
        return int(step_file.read_text()) if step_file.is_file() else None

    def restore(self, trainer) -> int:
        """Load the newest rolling checkpoint into `trainer`; returns its step."""
        if not self.last.is_file():
            raise FileNotFoundError(f"no checkpoint under {self.ckpt_dir}")
        state = torch.load(self.last, map_location=trainer.device, weights_only=False)
        trainer.load_state_dict(state["trainer"])
        return state["step"]

    def restore_params(self, model: torch.nn.Module) -> torch.nn.Module:
        """Load the params export into `model` (inference side)."""
        if not self.params.is_file():
            raise FileNotFoundError(f"no params export under {self.ckpt_dir}")
        model.load_state_dict(torch.load(self.params, map_location=model.device))
        return model
