"""The port's `apps/train_vae.py` against the JAX package's, on the CPU in
fp32, with a standalone AutoencoderKL (ch 64, ch_mult (1, 2), one block:
every GroupNorm group holds two channels, see `torch_parity.train_config`)
whose seeded JAX parameters are carried across with `weights.from_jax_params`:

  * `fold_latent_scale` equals the JAX one (1e-6), and `decode(encode(x))`
    is unchanged by the fold (1e-4 relative L2);
  * `vae_loss` and every gradient leaf against the JAX CLI's `loss_fn`
    (apps/train_vae.py:157-169, written out below: it is a closure of its
    `main`) on the same posterior draw: the loss 1e-5, each leaf 1e-4 of
    its largest magnitude, but the attention key biases, whose gradient is
    exactly 0, within 1e-6 of the largest gradient on both sides;
  * `make_schedule` equals optax.warmup_cosine_decay_schedule at every
    count, the first update's included (1e-6 of the peak rate: optax
    evaluates it in fp32);
  * three Adam steps of `torch.optim.Adam` under that schedule equal
    optax.adam's on the same gradients (1e-6);
  * the CLI end to end (`--steps 3`) on a synthetic PNG tree writes the JAX
    CLI's meta keys, and the train CLI's --vae_from grafts it into the
    frozen first stage and refuses a file of another architecture."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from morphablediffusion_torch.apps import train as t_train
from morphablediffusion_torch.apps import train_vae as t_vae
from morphablediffusion_torch.weights import flatten_tree, from_jax_params, to_jax_layout
from morphablediffusion_tpu.apps import train_vae as j_vae
from morphablediffusion_tpu.models.vae import AutoencoderKL, sample_diagonal_gaussian
from tests.torch_parity import assert_close, seeded_tree, tt
from tests.test_torch_train_cli import TRAIN_YAML

META = dict(ch=64, ch_mult=[1, 2], num_res_blocks=1, image_size=16)
KL_WEIGHT = 1e-2  # the KL term weighs in the gradients (the CLI's 1e-6 would hide it)


@pytest.fixture(scope="module")
def vae_pair():
    """The JAX VAE, its seeded parameters, the port's VAE on them, images x
    (B, H, W, 3) and a posterior draw key."""
    jvae = AutoencoderKL(ch=64, ch_mult=(1, 2), num_res_blocks=1)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    params = seeded_tree(jax.eval_shape(lambda a: jvae.init(jax.random.key(0), a),
                                        jnp.asarray(x)))
    port = t_vae.build_vae(META, "cpu", dtype=torch.float32)
    port.load_state_dict(from_jax_params(flatten_tree(params["params"]), device="cpu"),
                         strict=True)
    return jvae, jax.tree.map(jnp.asarray, params), port, x


def _jax_loss_fn(vae, kl_weight):
    """The JAX CLI's loss_fn (apps/train_vae.py:157-169)."""
    def loss_fn(p, x, step_rng):
        mean, logvar = vae.apply(p, x, method="encode_moments")
        z = sample_diagonal_gaussian(step_rng, mean, logvar)
        recon = vae.apply(p, z, method="decode").astype(jnp.float32)
        mse = jnp.mean((recon - x) ** 2)
        kl = 0.5 * jnp.mean(jnp.sum(mean**2 + jnp.exp(logvar) - 1.0 - logvar, axis=(1, 2, 3)))
        aux = {"mse": mse, "kl": kl, "latent_std": jnp.std(mean.astype(jnp.float32))}
        return mse + kl_weight * kl, aux
    return loss_fn


def _cf(x):
    return tt(x).permute(0, 3, 1, 2).contiguous()


def test_fold_latent_scale_matches_jax(vae_pair):
    jvae, params, port, x = vae_pair
    s = 3.7
    want = from_jax_params(flatten_tree(j_vae.fold_latent_scale(params, s)["params"]),
                           device="cpu")
    got = t_vae.fold_latent_scale(port.state_dict(), s)
    assert got.keys() == want.keys()
    for k in want:
        assert_close(got[k], want[k], 1e-6)
    folded = t_vae.build_vae(META, "cpu", dtype=torch.float32)
    folded.load_state_dict(got)
    with torch.no_grad():
        xs = _cf(x)
        before = port.decode(port.encode_moments(xs)[0])
        mean, _ = folded.encode_moments(xs)
        after = folded.decode(mean)
    assert float((after - before).norm() / before.norm()) < 1e-4
    assert_close(mean, port.encode_moments(xs)[0] * s, 1e-4)


def test_loss_and_gradients_match_jax(vae_pair):
    jvae, params, port, x = vae_pair
    rng = jax.random.key(5)
    loss_fn = _jax_loss_fn(jvae, KL_WEIGHT)
    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, jnp.asarray(x), rng)
    mean, _ = jvae.apply(params, jnp.asarray(x), method="encode_moments")
    eps = jax.random.normal(rng, mean.shape, mean.dtype)  # sample_diagonal_gaussian's draw
    port.zero_grad(set_to_none=True)
    got, got_aux = t_vae.vae_loss(port, _cf(x), tt(eps).permute(0, 3, 1, 2), KL_WEIGHT)
    got.backward()
    assert_close(got.detach(), loss, 1e-5)
    for k in ("mse", "kl", "latent_std"):
        np.testing.assert_allclose(float(got_aux[k]), float(aux[k]), rtol=1e-5, err_msg=k)
    ref = flatten_tree(grads["params"])
    port_grads = to_jax_layout(port, {n: p.grad for n, p in port.named_parameters()})
    assert port_grads.keys() == ref.keys()
    largest = max(float(np.abs(np.asarray(v)).max()) for v in ref.values())
    for path, g in port_grads.items():
        want = np.asarray(ref[path])
        if path.endswith("attn_1/k/bias"):
            # a softmax does not move when a constant is added to every key:
            # this gradient is 0, and both sides hold it to rounding
            assert max(np.abs(g).max(), np.abs(want).max()) < 1e-6 * largest, path
            continue
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=path)


@pytest.mark.parametrize("steps", [3, 50, 250, 3000])
def test_schedule_matches_optax(steps):
    lr = 1e-3
    want = optax.warmup_cosine_decay_schedule(0.0, lr, warmup_steps=min(100, steps // 10),
                                              decay_steps=steps, end_value=lr * 0.1)
    got = t_vae.make_schedule(lr, steps)
    for count in range(steps + 5):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=0, atol=1e-6 * lr,
                                   err_msg=str(count))
    if steps >= 10:
        assert got(0) == 0.0  # the first update of a warm-up takes no step


def test_adam_steps_match_optax(vae_pair):
    """Three updates on the same gradients (the JAX loss's at three draws):
    torch.optim.Adam at optax.adam's defaults, the lr set to the schedule at
    the count before each update, against optax.adam(schedule)."""
    sig = inspect.signature(optax.adam).parameters
    assert (sig["b1"].default, sig["b2"].default, sig["eps"].default,
            sig["eps_root"].default) == (0.9, 0.999, 1e-8, 0.0)
    jvae, params, port, x = vae_pair
    steps, lr = 30, 1e-3  # warm-up of 3: the counts 0, 1, 2 of the run
    tx = optax.adam(optax.warmup_cosine_decay_schedule(0.0, lr, 3, steps, lr * 0.1))
    grad_fn = jax.jit(jax.grad(lambda p, r: _jax_loss_fn(jvae, KL_WEIGHT)(p, jnp.asarray(x),
                                                                            r)[0]))
    grads = [grad_fn(params, jax.random.key(k)) for k in range(3)]
    jp, opt = params, tx.init(params)
    for g in grads:
        upd, opt = tx.update(g, opt, jp)
        jp = optax.apply_updates(jp, upd)

    model = t_vae.build_vae(META, "cpu", dtype=torch.float32)
    model.load_state_dict(port.state_dict())
    sched = t_vae.make_schedule(lr, steps)
    torch_opt = torch.optim.Adam(model.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    named = dict(model.named_parameters())
    for count, g in enumerate(grads):
        sd = from_jax_params(flatten_tree(g["params"]), device="cpu")
        for n, p in named.items():
            p.grad = sd[n].clone()
        for group in torch_opt.param_groups:
            group["lr"] = sched(count)
        torch_opt.step()
    got = to_jax_layout(model, named)
    want = flatten_tree(jp["params"])
    start = flatten_tree(params["params"])
    assert any(not np.array_equal(want[k], start[k]) for k in want)
    for k, v in got.items():
        np.testing.assert_allclose(v, np.asarray(want[k]), rtol=0, atol=1e-6, err_msg=k)


def _png_tree(root):
    from morphablediffusion_torch.tools import make_synthetic_facescape

    make_synthetic_facescape.main(["--out", str(root), "--subjects", "2", "--expressions", "1",
                                   "--views", "5", "--image_size", "64", "--points", "3000",
                                   "--mesh_vertices", "40"])
    return root / "data", root / "flame"


def _vae_cli(data, out, *extra):
    t_vae.main(["--data_dir", str(data), "--out", str(out), "--image_size", "64",
                "--ch", "32", "--ch_mult", "1,1,1,1", "--batch_size", "2", "--steps", "3",
                "--log_every", "1", "--num_workers", "1", "--device", "cpu", *extra])


def test_cli_then_train_vae_from(tmp_path, capsys):
    data, flame = _png_tree(tmp_path / "synth")
    out = tmp_path / "vae" / "vae.pt"
    _vae_cli(data, out)
    log = capsys.readouterr().out
    assert "step 3 loss" in log and "folded x" in log
    state, meta = t_vae.load_vae(str(out))
    assert set(meta) == {"ch", "ch_mult", "num_res_blocks", "image_size", "latent_std_raw",
                         "fold_scale"}
    assert (meta["ch"], meta["ch_mult"], meta["num_res_blocks"]) == (32, [1, 1, 1, 1], 1)
    assert all(torch.isfinite(v).all() for v in state.values())

    cfg = tmp_path / "train.yaml"
    uids = ["001/01", "002/01"]
    cfg.write_text(TRAIN_YAML.replace(
        "  dataset: facescape\n",
        f"  dataset: facescape\n  data_dir: {data}\n  flame_assets_dir: {flame}\n"
        f"  uids: {uids}\n  val_uids: ['002/01']\n"))
    args = ["-b", str(cfg), "-l", str(tmp_path / "runs"), "--device", "cpu"]
    t_train.main(args + ["-n", "graft", "--vae_from", str(out)])
    assert f"grafting first_stage from {out}" in capsys.readouterr().out
    params = torch.load(tmp_path / "runs" / "graft" / "ckpt" / "params" / "params.pt")
    for k, v in state.items():
        got = params[f"first_stage.{k}"]
        assert torch.equal(got, v.to(got.dtype)), k  # frozen: as grafted, in its dtype
    assert any(params[f"first_stage.{k}"].dtype == torch.bfloat16 for k in state)

    other = tmp_path / "vae" / "other.pt"
    t_vae.save_vae(str(other), t_vae.build_vae(dict(META, ch=32), "cpu").state_dict(), META)
    with pytest.raises(ValueError, match="VAE arch mismatch"):
        t_train.main(args + ["-n", "mismatch", "--vae_from", str(other)])
