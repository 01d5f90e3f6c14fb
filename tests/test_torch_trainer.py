"""The port's checkpoints on the CPU, at tests/tiny.py's config: a run
resumed from a checkpoint is bit-exact, and an existing run is refused
without resume. (The trainer's step against the JAX package's is in
test_torch_train.py.)"""

import pytest
import torch

from morphablediffusion_torch.models.diffusion import MorphableDiffusion as TModel
from morphablediffusion_torch.training import trainer as t_trainer
from morphablediffusion_torch.utils.checkpoint import CheckpointManager
from morphablediffusion_torch.weights import seeded_params
from tests.tiny import tiny_batch, tiny_config
from tests.torch_parity import port_train_config, tt

B = 2


def _tiny_port_trainer():
    cfg = port_train_config(tiny_config(view_num=2))
    return t_trainer.Trainer(cfg, device="cpu", seed=3)


def test_checkpoint_resume_is_bit_exact(tmp_path):
    """Two straight steps == one step, save, resume in a new trainer, one
    step; an existing run is refused without resume."""
    batch = {k: tt(v) for k, v in tiny_batch(tiny_config(view_num=2), B=B).items()}
    straight = _tiny_port_trainer()
    for _ in range(2):
        straight.train_step(batch)

    first = _tiny_port_trainer()
    first.train_step(batch)
    mgr = CheckpointManager(tmp_path / "ckpt", rolling_every=1, snapshot_every=1)
    mgr.assert_fresh_or_resume(False)
    mgr.maybe_save(first, first.step)
    assert mgr.latest_step() == 1 and (tmp_path / "ckpt" / "snapshots" / "1.pt").is_file()
    with pytest.raises(RuntimeError, match="--resume"):
        mgr.assert_fresh_or_resume(False)
    mgr.assert_fresh_or_resume(True)

    resumed = t_trainer.Trainer(port_train_config(tiny_config(view_num=2)), device="cpu", seed=99)
    assert CheckpointManager(tmp_path / "ckpt").restore(resumed) == 1
    resumed.train_step(batch)
    assert (resumed.step, resumed.opt_step) == (2, 2)
    for (k, a), b in zip(straight.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(straight.optimizer.state_dict()["state"].values(),
                    resumed.optimizer.state_dict()["state"].values()):
        assert all(torch.equal(a[n], b[n]) for n in a)
    model = seeded_params(TModel(resumed.model.cfg, device="cpu"), 5)
    mgr.restore_params(model)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 first.model.state_dict().values()))
