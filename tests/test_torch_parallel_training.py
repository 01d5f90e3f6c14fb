"""Data-parallel training on the port (`Trainer(mesh=...)`, the JAX
Trainer's "data" axis with ZeRO-1 `shard_opt_state`), with 2 ranks spawned
as processes on the CPU under gloo (tests/torch_ranks.py), at
`torch_parity.train_config` with `train_setup`'s global batch B=2 (one row
a rank) and step key, fp32.

Every rank draws the global batch's noise (here injected: the JAX draws of
the step) and slices its rows, so a step on 2 ranks is the one-process step
on the global batch. Cases: one AdamW step; `accumulate_grad_batches=2`;
`finetune_unet=False` (the frozen UNet leaves' gradients count in
grad_norm); `shard_opt_state` off (replicated moments). Each is held to

  * the JAX package at the global batch: the loss and grad_norm within
    1e-4, every parameter after the step as
    `test_torch_train._assert_params` holds the one-card step (AdamW eps
    1e-2 and base LR 5e-2 in both packages, as there);
  * the port in one process: loss and grad_norm within relative 1e-6, the
    trainable parameters as one vector within relative L2 1e-6 and each
    leaf within 1e-4 (see `_assert_same_params`);
  * the moments a rank holds: at most ceil(n / 2) of each group's n
    elements with ZeRO-1, all of them without.

A checkpoint does not depend on the world: one step in one process, saved;
resumed on 2 ranks for a second step, saved by them; resumed in one
process for a third, which equals three steps in one process (relative L2
1e-6).
"""

import functools
import math

import jax
import numpy as np
import optax
import pytest
import torch

from morphablediffusion_torch.training import trainer as t_trainer
from morphablediffusion_torch.weights import flatten_tree
from morphablediffusion_tpu.training import trainer as j_trainer
from tests.test_torch_train import ADAM_EPS, _assert_params, _optimizer_config
from tests.torch_parity import port_train_model, step_rngs, torch_draws, train_setup
from tests.torch_ranks import run_ranks, training_rank

B, WORLD, TOL_WORLD_ONE, TOL_LEAF = 2, 2, 1e-6, 1e-4
# name: (accumulate_grad_batches, finetune_unet, shard_opt_state)
CASES = {"step": (1, True, True), "accumulate": (2, True, True),
         "frozen_unet": (1, False, True), "replicated": (1, True, False)}


def rel_l2(a, b) -> float:
    a, b = (torch.as_tensor(x).detach().double().numpy() for x in (a, b))
    n = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / n) if n else float(np.abs(a).max())


@pytest.fixture(scope="module")
def setup():
    s = train_setup(B)
    loss_fn = lambda p, r: s["jmodel"].apply(p, s["batch"], method="training_loss", rngs=r)
    s["loss"], s["grads"] = jax.jit(lambda p, r: jax.value_and_grad(loss_fn)(p, r))(
        s["params"], step_rngs(s["rng"], 0))
    s["draws"] = [torch_draws(s["jmodel"], s["params"], s["batch"], step_rngs(s["rng"], k))
                  for k in range(3)]
    return s


@pytest.fixture
def adam_eps(monkeypatch):
    monkeypatch.setattr(optax, "adamw", functools.partial(optax.adamw, eps=ADAM_EPS))
    monkeypatch.setattr(t_trainer, "EPS", ADAM_EPS)


def _config(s, accumulate=1, finetune_unet=True, shard=True):
    jcfg = _optimizer_config()
    jcfg.train.accumulate_grad_batches = accumulate
    jcfg.model.finetune_unet = finetune_unet
    jcfg.train.shard_opt_state = shard
    return jcfg


_updates = {}


def _jitted_update(s, finetune_unet: bool):
    """The parameters after the JAX package's first AdamW step at
    finetune_unet, as a jitted function of the gradients (one compile each;
    neither shard_opt_state nor accumulation changes it, see above)."""
    if finetune_unet not in _updates:
        jcfg = _optimizer_config()
        jcfg.model.finetune_unet = finetune_unet
        params = s["params"]
        tx, _ = j_trainer.make_optimizer(jcfg, params)
        opt = tx.init(params)
        _updates[finetune_unet] = jax.jit(
            lambda g: optax.apply_updates(params, tx.update(g, opt, params)[0]))
    return _updates[finetune_unet]


def _one_process(s, jcfg, draws, resume=None):
    port, pcfg = port_train_model(s, jcfg)
    tr = t_trainer.Trainer(pcfg, model=port)
    if resume is not None:
        tr.load_state_dict(resume)
    metrics = [tr.train_step(s["tb"], draws=d) for d in draws]
    return tr, metrics


def _ranks(s, jcfg, draws, tmp, resume=None, save_state=False):
    """The ranks' results (rank 0's with its parameters and, with
    save_state, the gathered state_dict); the files are removed once read."""
    port, pcfg = port_train_model(s, jcfg)
    payload, state_file = tmp / "payload.pt", None
    if resume is not None:
        state_file = tmp / "resume.pt"
        torch.save(resume, state_file)
    torch.save(dict(cfg=pcfg, state=port.state_dict(), batch=s["tb"], draws=draws,
                    eps=t_trainer.EPS, resume=state_file and str(state_file),
                    save_state=save_state), payload)
    run_ranks(training_rank, WORLD, tmp, str(payload), str(tmp))
    out = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    for f in [payload, state_file] + [tmp / f"rank{r}.pt" for r in range(WORLD)]:
        if f is not None:
            f.unlink()
    return out


def _assert_same_params(got: dict, want: dict):
    """The trainable parameters as one vector within relative L2 1e-6, and
    each leaf within TOL_LEAF: a leaf that starts at 0 (a bias) is its own
    step, whose relative error is the gradient's rounding, ~1e-5 apart
    between one process and two (measured 1.4e-5 at most; the whole vector
    1.6e-8)."""
    flat = lambda d: torch.cat([d[n].detach().double().reshape(-1) for n in want])
    assert rel_l2(flat(got), flat(want)) <= TOL_WORLD_ONE
    for name, p in want.items():
        assert rel_l2(got[name], p) <= TOL_LEAF, name


@pytest.mark.parametrize("case", list(CASES))
def test_data_parallel_step_matches_jax_and_one_process(setup, adam_eps, tmp_path, case):
    s = setup
    accumulate, finetune_unet, shard = CASES[case]
    jcfg = _config(s, accumulate, finetune_unet, shard)
    draws = [s["draws"][0]] * accumulate  # accumulation: two micro-steps on one draw

    # the JAX optimizer on the JAX gradients of the global batch: with both
    # micro-steps on one draw, optax.MultiSteps' mean is that gradient and
    # its step is the plain AdamW step (test_torch_train holds the port's
    # accumulation to MultiSteps itself)
    params, g0 = s["params"], s["grads"]
    jparams = _jitted_update(s, finetune_unet)(g0)

    one, one_metrics = _one_process(s, jcfg, draws)
    ranks = _ranks(s, jcfg, draws, tmp_path)
    r = ranks[0]
    for other in ranks[1:]:  # the ranks hold the same parameters, to the bit
        assert other["digest"] == r["digest"]
        assert [float(m["loss"]) for m in other["metrics"]] == [
            float(m["loss"]) for m in r["metrics"]]
    m = r["metrics"][-1]
    np.testing.assert_allclose(float(m["loss"]), float(s["loss"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jax.jit(optax.global_norm)(g0)),
                               rtol=1e-4, atol=1e-4)
    for got, want in zip(r["metrics"], one_metrics):
        assert rel_l2(got["loss"], want["loss"]) <= TOL_WORLD_ONE
        assert rel_l2(got["grad_norm"], want["grad_norm"]) <= TOL_WORLD_ONE
    assert (r["step"], r["opt_step"]) == (accumulate, 1)
    port, _ = port_train_model(s, jcfg)
    port.load_state_dict({k: v.detach() for k, v in r["params"].items()}, strict=False)
    _assert_params(port, jparams, params)
    _assert_same_params(r["params"], dict(one.model.named_parameters()))

    # the moments a rank holds: ceil(n / 2) of each group's n with ZeRO-1
    sizes = [sum(p.numel() for p in g["params"]) for g in one.optimizer.param_groups]
    assert one.optimizer_bytes() == 4 * 2 * sum(sizes)
    for r in ranks:
        if shard:
            assert r["moments"] == sum(2 * math.ceil(n / WORLD) for n in sizes)
        else:
            assert r["moments"] == 2 * sum(sizes)


def test_checkpoint_does_not_depend_on_the_world(setup, adam_eps, tmp_path):
    s = setup
    jcfg = _config(s)
    straight, _ = _one_process(s, jcfg, s["draws"])
    first, _ = _one_process(s, jcfg, s["draws"][:1])
    ranks = _ranks(s, jcfg, s["draws"][1:2], tmp_path, resume=first.state_dict(),
                   save_state=True)
    state = ranks[0]["state"]
    assert (state["step"], state["opt_step"]) == (2, 2)
    third, _ = _one_process(s, jcfg, s["draws"][2:], resume=state)
    assert (third.step, third.opt_step) == (3, 3)
    _assert_same_params(dict(third.model.named_parameters()),
                        dict(straight.model.named_parameters()))
    for a, b in zip(third.optimizer.state_dict()["state"].values(),
                    straight.optimizer.state_dict()["state"].values()):
        for n in ("exp_avg", "exp_avg_sq"):
            assert rel_l2(a[n], b[n]) <= 1e-5
