"""Training under the other model configurations: the fine mesh-voxel
conditioner (`mesh_voxel_mode='fine'`), `use_spatial_volume` and THuman's
orthographic cameras on a non-cubic grid. For each, the port's training
loss, every gradient leaf and one optimizer step of its Trainer against the
JAX package, on the CPU in fp32, at `torch_parity.train_config` (tiny.py
widened; B=2, two views) with the configuration's change.

Tolerances, as tests/test_torch_train.py holds the default configuration:
the loss 1e-4; every gradient leaf 1e-4 of its largest magnitude; every
parameter after one AdamW step 1e-5, and each leaf's step 1e-2 of its
largest (both optimizers at eps ADAM_EPS, see `adam_eps`). The JAX step is
the JAX Trainer's optimizer (`make_optimizer`) applied to the JAX gradients,
which is `Trainer._train_step` without compiling the loss twice.

The step key keeps the ReLU inputs of the mesh-voxel net clear of 0 as
well as the UNet's (`train_setup(mesh_voxel=True)`): its ReLUs see ~1.5M
active inputs at this size, and on a key where one lies within rounding
(~3e-7) of 0 the JAX package's jitted gradients of that net differ from its
own op-by-op gradients by up to 1.1e-4 of a leaf's largest.

Under the fine conditioner the BatchNorm running statistics (`BNActive`'s
`mean` and `var`) are ordinary parameters of the spatial-volume net in the
JAX package: labelled `cond` (the conditioner's 10x learning rate), moved
and decayed by AdamW. The port keeps that, and the test holds it."""

import jax
import numpy as np
import optax
import pytest
import torch

from morphablediffusion_torch.training import trainer as t_trainer
from morphablediffusion_torch.weights import flatten_tree, to_jax_layout
from morphablediffusion_tpu.training import trainer as j_trainer
from tests.test_torch_fine import _with_running_stats
from tests.test_torch_train import (_assert_grads_close, _assert_params, _optimizer_config,
                                    _port_grads, adam_eps)  # noqa: F401 (fixture)
from tests.torch_parity import (assert_close, port_train_model, step_rngs, torch_draws,
                                train_config, train_setup)

B = 2


def _fine(jcfg):
    jcfg.model.mesh_voxel_mode = "fine"
    jcfg.model.fine_grid_shape = (16, 16, 16)
    jcfg.model.fine_voxel_size = 0.05


def _spatial_volume(jcfg):
    jcfg.model.use_spatial_volume = True


def _orthographic(jcfg):
    jcfg.model.projection = "orthographic"
    jcfg.model.voxel_grid_shape = (24, 16, 24)  # THuman's (80, 48, 80), cut to size


# configuration -> (change of the config, change of the seeded parameters)
CONFIGS = {
    "fine": (_fine, lambda p: _with_running_stats(p, np.random.default_rng(5))),
    "spatial_volume": (_spatial_volume, None),
    "orthographic": (_orthographic, None),
}


def _config(name, base):
    jcfg = base()
    CONFIGS[name][0](jcfg)
    return jcfg


@pytest.mark.parametrize("name", list(CONFIGS))
def test_training_step_matches_jax(name, adam_eps):
    s = train_setup(B, _config(name, train_config), CONFIGS[name][1], mesh_voxel=True)
    rngs = step_rngs(s["rng"], 0)
    loss_fn = lambda p: s["jmodel"].apply(p, s["batch"], method="training_loss", rngs=rngs)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(s["params"])
    draws = torch_draws(s["jmodel"], s["params"], s["batch"], rngs)

    # the loss and every gradient leaf
    port, _ = port_train_model(s)
    got = port.training_loss(s["tb"], draws=draws)
    assert_close(got.detach(), loss, 1e-4)
    got.backward()
    ref = flatten_tree(grads["params"])
    port_grads = _port_grads(port)
    _assert_grads_close(port_grads, ref)
    nonzero = {k for k, v in ref.items() if np.abs(v).max() > 0}
    assert nonzero <= set(port_grads)
    assert any(k.startswith("spatial_volume/") for k in nonzero)

    # one optimizer step of the Trainer against the JAX Trainer's optimizer
    jcfg = _config(name, _optimizer_config)
    tx, _ = j_trainer.make_optimizer(jcfg, s["params"])
    upd, _ = jax.jit(tx.update)(grads, tx.init(s["params"]), s["params"])
    jparams = optax.apply_updates(s["params"], upd)
    port, pcfg = port_train_model(s, jcfg)
    labels = dict(zip(to_jax_layout(port, dict(port.named_parameters())),
                      t_trainer.param_labels(port, jcfg.model.finetune_unet).values()))
    j_labels = flatten_tree(j_trainer.param_labels(s["params"], jcfg.model.finetune_unet)
                            ["params"])
    assert labels == {k: str(v) for k, v in j_labels.items()}
    tr = t_trainer.Trainer(pcfg, model=port)
    m = tr.train_step(s["tb"], draws=draws)
    assert_close(m["loss"], loss, 1e-4)
    assert_close(m["grad_norm"], optax.global_norm(grads), 1e-4)
    _assert_params(port, jparams, s["params"])
    if name == "fine":
        # BNActive's running statistics train at the conditioner's rate
        stats = [k for k in labels if k.endswith(("/mean", "/var")) and "/net/" in k]
        assert stats and all(labels[k] == "cond" for k in stats)
        before = flatten_tree(s["params"]["params"])
        after = to_jax_layout(port, dict(port.named_parameters()))
        assert all(not np.array_equal(after[k], before[k]) for k in stats)
        with torch.no_grad():
            assert all(torch.isfinite(p).all() for p in port.parameters())
