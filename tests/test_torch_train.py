"""The training slice: the port's training_loss, its gradients, one step of
its Trainer against the JAX Trainer._train_step on a one-device mesh,
gradient accumulation, the finetune_unet=False labels, the LR schedule and
view chunking against the JAX package, at `torch_parity.train_config`
(tiny.py widened; B=2, two views) on the CPU in fp32. The checkpoints are in
test_torch_trainer.py; the data pipeline and the train CLI in
test_torch_train_cli.py.

The JAX random stream of a training step (`fold_in(rng, step)`, `split(5)`
into time/noise/view/vae/drop, then `make_rng` in the order vae, vae, time,
noise, view, drop) is regenerated by a method applied to the JAX model and
injected into the port. Weights: `seeded_tree` made well-conditioned (see
`torch_parity.well_conditioned`), with the frozen VAE and CLIP stored in bf16
as both trainers store them. Tolerances: the loss 1e-4, and every gradient
leaf 1e-4 of its largest magnitude (fp32 through the whole network; the
port's fused depth-context chain at W >= 8 against JAX's unfused chain on
the CPU differs by rounding; `torch_parity.train_config` widens tiny.py so
that no gradient is zero up to rounding, and `train_setup` keeps every ReLU
input clear of its kink). Parameters after an optimizer step: 1e-5, and
each leaf's step 1e-2 of its largest (see `adam_eps` and `_assert_params`).
The JAX gradients are computed once per step key by one jitted function."""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from morphablediffusion_torch.models.diffusion import MorphableDiffusion as TModel
from morphablediffusion_torch.training import trainer as t_trainer
from morphablediffusion_torch.training.lr import lambda_linear_schedule as t_schedule
from morphablediffusion_torch.weights import flatten_tree, to_jax_layout
from morphablediffusion_tpu.models.diffusion import MorphableDiffusion as JModel
from morphablediffusion_tpu.parallel.mesh import create_mesh
from morphablediffusion_tpu.training import trainer as j_trainer
from morphablediffusion_tpu.training.lr import lambda_linear_schedule as j_schedule
from tests.torch_parity import (assert_close, port_train_model, step_rngs, torch_draws, train_config,
                                train_setup)

B = 2


def _port_grads(model) -> dict:
    named = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    return to_jax_layout(model, named)


def _assert_grads_close(port: dict, ref: dict):
    """Every port gradient leaf against the JAX leaf of the same path (see
    the module docstring for the bounds)."""
    assert port
    for path, got in port.items():
        want = np.asarray(ref[path], np.float32)
        bound = 1e-4 * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=bound, err_msg=path)


ADAM_EPS = 1e-2  # the optimizer tests' AdamW eps, in both packages


@pytest.fixture
def adam_eps(monkeypatch):
    """AdamW with eps ADAM_EPS in both trainers, after holding the port's
    defaults (eps, weight decay, betas) to optax.adamw's. At optax's 1e-8 a
    first step moves each element by lr * g / (|g| + eps), about lr whatever
    the gradient: an element whose gradient is rounding (|g| near eps) steps
    either way, in either package. With eps above every gradient the step is
    about lr * g / eps, and a gradient's rounding moves it by as little."""
    sig = inspect.signature(optax.adamw).parameters
    assert (t_trainer.EPS, t_trainer.WEIGHT_DECAY, t_trainer.BETAS) == (
        sig["eps"].default, sig["weight_decay"].default, (sig["b1"].default, sig["b2"].default))
    monkeypatch.setattr(optax, "adamw", functools.partial(optax.adamw, eps=ADAM_EPS))
    monkeypatch.setattr(t_trainer, "EPS", ADAM_EPS)


def _optimizer_config():
    """train_config at base_learning_rate 5e-2: with the schedule's first
    factor (f_start 0.02) 1e-3 at step 0, 1e-2 in the cond group, so that
    the step of a leaf's largest gradient is well above the 1e-5 parameter
    tolerance (at the config's own 5e-5 every step would be below it)."""
    jcfg = train_config()
    jcfg.train.base_learning_rate = 5e-2
    return jcfg


def _assert_params(port, jparams, before):
    """Every parameter after an AdamW step against the JAX package's, 1e-5
    on every element; and each leaf's step (after - before) against JAX's,
    1e-2 of the leaf's largest step plus 3e-7 for the rounding of the fp32
    parameters, so that an element stepping the wrong way fails however
    small its step."""
    after = to_jax_layout(port, dict(port.named_parameters()))
    ref, start = flatten_tree(jparams["params"]), flatten_tree(before["params"])
    assert set(after) == set(ref)
    largest = 0.0
    for k, v in after.items():
        want, v0 = np.asarray(ref[k], np.float32), np.asarray(start[k], np.float32)
        np.testing.assert_allclose(v, want, rtol=1e-5, atol=1e-5, err_msg=k)
        step = want - v0
        bound = 1e-2 * float(np.abs(step).max()) + 3e-7
        np.testing.assert_allclose(v - v0, step, rtol=0, atol=bound, err_msg=k)
        largest = max(largest, float(np.abs(step).max()))
    assert largest >= 100 * 1e-5


@pytest.fixture(scope="module")
def setup():
    s = train_setup(B)
    loss_fn = lambda p, r: s["jmodel"].apply(p, s["batch"], method="training_loss", rngs=r)
    value_and_grad = jax.jit(lambda p, r: jax.value_and_grad(loss_fn)(p, r))
    # the JAX loss and gradients of micro-step 0
    s["loss"], s["grads"] = value_and_grad(s["params"], step_rngs(s["rng"], 0))
    return s


@pytest.mark.parametrize("drop_conditions", [False, True])
def test_training_loss(setup, drop_conditions):
    """The loss with injected draws; with drop_conditions the key drops a
    condition of sample 0 and none of sample 1."""
    s = setup
    jcfg = train_config()
    jcfg.model.drop_conditions = drop_conditions
    jmodel = JModel(jcfg.model)
    rngs = step_rngs(s["rng"], 0)
    if drop_conditions:
        loss = jax.jit(lambda p: jmodel.apply(p, s["batch"], method="training_loss",
                                              rngs=rngs))(s["params"])
    else:
        loss = s["loss"]
    port, _ = port_train_model(s, jcfg)
    draws = torch_draws(jmodel, s["params"], s["batch"], rngs)
    keep = [m.numpy() for m in TModel.drop_masks(draws["r"])]
    assert min(k[0] for k in keep) == 0.0 and all(k[1] == 1.0 for k in keep)
    with torch.no_grad():
        assert_close(port.training_loss(s["tb"], draws=draws), loss, 1e-4)


def test_training_gradients(setup):
    """Every trainable gradient leaf against jax.grad of the JAX loss."""
    s = setup
    port, _ = port_train_model(s)
    draws = torch_draws(s["jmodel"], s["params"], s["batch"], step_rngs(s["rng"], 0))
    port.training_loss(s["tb"], draws=draws).backward()
    ref = flatten_tree(s["grads"]["params"])
    got = _port_grads(port)
    _assert_grads_close(got, ref)
    # every JAX leaf with a gradient has one in the port (VAE and CLIP are
    # frozen in both: zero in JAX, absent in the port)
    nonzero = {k for k, v in ref.items() if np.abs(v).max() > 0}
    assert nonzero <= set(got) and len(got) > 100


def test_remat_gives_the_same_gradients(setup):
    """use_checkpoint recomputes the blocks in the backward pass and changes
    no number."""
    s = setup
    draws = torch_draws(s["jmodel"], s["params"], s["batch"], step_rngs(s["rng"], 0))
    out = []
    for remat in (False, True):
        port, _ = port_train_model(s)
        port.cfg.unet.use_checkpoint = remat
        port.training_loss(s["tb"], draws=draws).backward()
        out.append(_port_grads(port))
    for k in out[0]:
        np.testing.assert_allclose(out[1][k], out[0][k], rtol=1e-6, atol=1e-9, err_msg=k)


def _jax_state(s, jcfg):
    jt = j_trainer.Trainer(jcfg, mesh=create_mesh(jax.devices()[:1]))
    params = s["params"]  # VAE and CLIP already cast_frozen
    state = j_trainer.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                 opt_state=jt.tx(params).init(params), rng=s["rng"])
    return jt, state


def test_one_optimizer_step_matches_jax_trainer(setup, adam_eps):
    """Trainer.train_step against the JAX Trainer._train_step on a
    one-device mesh: loss, grad_norm and every parameter after the step."""
    s = setup
    jcfg = _optimizer_config()
    jt, state = _jax_state(s, jcfg)
    new_state, metrics = jax.jit(jt._train_step)(state, s["batch"])

    port, pcfg = port_train_model(s, jcfg)
    tr = t_trainer.Trainer(pcfg, model=port)
    draws = torch_draws(s["jmodel"], s["params"], s["batch"], step_rngs(s["rng"], 0))
    m = tr.train_step(s["tb"], draws=draws)
    assert m["step"] == 0 and tr.step == 1 and tr.opt_step == 1
    # optax.adamw decays every trainable leaf, also one the forward did not
    # use; torch's AdamW skips a parameter whose gradient is None
    assert all(p.grad is not None for g in tr.optimizer.param_groups for p in g["params"])
    assert_close(m["loss"], metrics["loss"], 1e-4)
    assert_close(m["grad_norm"], metrics["grad_norm"], 1e-4)
    _assert_params(port, new_state.params, state.params)
    ref = flatten_tree(new_state.params["params"])
    before = flatten_tree(state.params["params"])
    moved = [k for k in ref if not np.array_equal(np.asarray(ref[k]), before[k])]
    assert any(k.startswith("unet/") for k in moved)
    assert not any(k.startswith(("first_stage/", "clip_image_encoder/")) for k in moved)


def test_accumulation_and_frozen_unet_match_optax(setup, adam_eps):
    """accumulate_grad_batches=2 (optax.MultiSteps: no update on the first
    micro-step, then one AdamW step on the running mean of both, here two
    micro-steps on the same draws) and
    finetune_unet=False (only the DepthTransformers of the UNet move), each
    against the JAX package's optimizer on the JAX gradients."""
    s = setup
    params, g0 = s["params"], s["grads"]
    draws = torch_draws(s["jmodel"], s["params"], s["batch"], step_rngs(s["rng"], 0))

    jcfg = _optimizer_config()
    jcfg.train.accumulate_grad_batches = 2
    tx, _ = j_trainer.make_optimizer(jcfg, params)
    opt, update = tx.init(params), jax.jit(tx.update)
    for _ in range(2):  # two micro-steps on the same draws: their mean is g0
        upd, opt = update(g0, opt, params)
        params_acc = optax.apply_updates(params, upd)
    port, pcfg = port_train_model(s, jcfg)
    tr = t_trainer.Trainer(pcfg, model=port)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    tr.train_step(s["tb"], draws=draws)
    assert all(torch.equal(v, port.state_dict()[k]) for k, v in before.items())
    tr.train_step(s["tb"], draws=draws)
    assert (tr.step, tr.opt_step) == (2, 1)
    _assert_params(port, params_acc, params)

    jcfg = _optimizer_config()
    jcfg.model.finetune_unet = False
    tx, _ = j_trainer.make_optimizer(jcfg, params)
    upd, _ = jax.jit(tx.update)(g0, tx.init(params), params)
    params_ft = optax.apply_updates(params, upd)
    port, pcfg = port_train_model(s, jcfg)
    labels = to_jax_layout(port, dict(port.named_parameters()))
    j_labels = flatten_tree(j_trainer.param_labels(params, finetune_unet=False)["params"])
    port_labels = dict(zip(labels, t_trainer.param_labels(port, False).values()))
    assert port_labels == {k: str(v) for k, v in j_labels.items()}
    tr = t_trainer.Trainer(pcfg, model=port)
    tr.train_step(s["tb"], draws=draws)
    _assert_params(port, params_ft, params)


def test_lambda_linear_schedule():
    args = (5e-5, 100, 1000, 0.02, 1.0, 0.5)
    t, j = t_schedule(*args), j_schedule(*args)
    for step in range(201):
        np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-6)


def test_predict_eps_cfg_view_chunks_equal_one_batch(setup):
    """batch_view_num=1 (one view per UNet call) gives the numbers of all
    views at once, and so does the chunked VAE decode."""
    s = setup
    port, _ = port_train_model(s)
    tb = s["tb"]
    g = torch.Generator().manual_seed(0)
    x = torch.randn((B, 2, 8, 8, 4), generator=g)
    t = torch.tensor([10, 500])
    with torch.no_grad():
        prep = port.prepare_inference(tb)
        args = (x, t, prep["clip_embed"], prep["x_input"], prep["v_embed"], tb, 2.0)
        whole = port.predict_eps_cfg(*args, batch_view_num=0)
        chunked = port.predict_eps_cfg(*args, batch_view_num=1)
        assert_close(chunked, whole, 1e-5)
        assert_close(port.decode_views(x, 1), port.decode_views(x, 0), 1e-5)
