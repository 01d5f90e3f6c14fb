"""`train --resume` of a JAX run in the port, against the JAX package on the
CPU.

Resume: the JAX Trainer (`Trainer._train_step` jitted, on a one-device
mesh) takes micro-steps at `torch_parity.train_config` (B=2) from
`train_setup`'s parameters and step key, and the JAX package's
CheckpointManager saves its TrainState: two steps with
accumulate_grad_batches 1, three with 2 (the state then holds optax.MultiSteps'
half-full accumulator). The port's CheckpointManager.restore fills a port
Trainer (`utils/checkpoint.py::jax_train_state`), one process and on a
one-rank gloo group (ZeRO-1's flat buffers), and it takes the next
micro-step on the JAX step's draws (`step_rngs(rng, step)`, injected): an
AdamW step on the resumed moments. Held to the JAX Trainer's same step with
tests/test_torch_train.py's training tolerances: loss and grad norm 1e-4,
every parameter after the step `_assert_params` (AdamW at eps 1e-2 in both
packages, base LR 5e-2, so that a step is well above the parameter
tolerance). The committed fixture's regeneration is test_torch_orbax_fixture.py."""

import jax
import pytest
import torch

from morphablediffusion_torch.parallel import close_mesh, create_mesh as t_create_mesh
from morphablediffusion_torch.training import trainer as t_trainer
from morphablediffusion_torch.utils.checkpoint import CheckpointManager as TManager
from morphablediffusion_torch.utils.checkpoint import resume_seed
from morphablediffusion_tpu.utils.checkpoint import CheckpointManager as JManager
from tests.test_torch_train import adam_eps  # noqa: F401 (a fixture)
from tests.test_torch_train import _assert_params, _jax_state, _optimizer_config
from tests.torch_parity import assert_close, port_train_model, step_rngs, torch_draws, train_setup


@pytest.fixture(scope="module")
def setup():
    return train_setup(2)


@pytest.mark.parametrize("accumulate, steps", [(1, 2), (2, 3)])
def test_port_resumes_a_jax_train_state(setup, adam_eps, tmp_path, accumulate, steps):
    s = setup
    jcfg = _optimizer_config()
    jcfg.train.accumulate_grad_batches = accumulate
    jt, state = _jax_state(s, jcfg)
    train_step = jax.jit(jt._train_step)
    for _ in range(steps):
        state, _ = train_step(state, s["batch"])
    mgr = JManager(tmp_path / "ckpt")
    mgr.maybe_save(state, steps, force=True)
    mgr.wait()
    new_state, metrics = train_step(state, s["batch"])
    draws = torch_draws(s["jmodel"], s["params"], s["batch"], step_rngs(s["rng"], steps))

    mesh = t_create_mesh("gloo", "cpu", rank=0, world=1,
                         init_method=f"file://{tmp_path / 'store'}")
    try:
        for on_mesh in (False, True):
            port, pcfg = port_train_model(s, jcfg)
            tr = t_trainer.Trainer(pcfg, model=port, mesh=mesh if on_mesh else None)
            assert (tr.zero is not None) == on_mesh
            assert TManager(tmp_path / "ckpt").restore(tr) == steps
            assert (tr.step, tr.opt_step) == (steps, steps // accumulate)
            assert torch.equal(tr.generator.get_state(), torch.Generator().manual_seed(
                resume_seed(pcfg.train.seed, steps)).get_state())
            assert (tr._acc is None) == (steps % accumulate == 0)
            m = tr.train_step(s["tb"], draws=draws)
            assert m["step"] == steps and tr.opt_step == (steps + 1) // accumulate
            assert_close(m["loss"], metrics["loss"], 1e-4)
            assert_close(m["grad_norm"], metrics["grad_norm"], 1e-4)
            _assert_params(port, new_state.params, state.params)
    finally:
        close_mesh(mesh)
