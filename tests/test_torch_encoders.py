"""Port parity of the frozen encoders against the JAX package on the CPU,
fp32, at tests/tiny.py's sizes: the VAE (encode_moments, decode), the CLIP
image tower, and `preprocess_clip` against `jax.image.resize(..., "cubic")`
(Keys a=-0.5, antialiased when downscaling). Tolerance 1e-4 for the
networks (chained fp32 convs, norms and attention) and 1e-5 for the
resize."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphablediffusion_torch.models import clip as Tclip
from morphablediffusion_torch.models import vae as Tvae
from morphablediffusion_tpu.models import clip as Jclip
from morphablediffusion_tpu.models import vae as Jvae
from tests.torch_parity import assert_close, cf, cl, load_into, seeded_tree


def _init(mod, *args, method=None):
    return seeded_tree(jax.eval_shape(
        lambda *a: mod.init(jax.random.key(0), *a, method=method), *args))


@pytest.mark.parametrize("size", [64, 256, 200])
def test_preprocess_clip_matches_jax_resize(rng, size):
    """64 -> 224 upsamples; 256 -> 224 (the flagship) and 200 -> 224 cover
    the antialiased downscale and a non-integer ratio."""
    x = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    ref = Jclip.preprocess_clip(jnp.asarray(x))
    assert_close(cl(Tclip.preprocess_clip(cf(x))), ref, 1e-5)


def test_vae_encode_decode(rng):
    kw = dict(ch=32, ch_mult=(1, 1, 1, 1), num_res_blocks=1)
    jmod = Jvae.AutoencoderKL(**kw)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    params = _init(jmod, jnp.asarray(x))
    mean, logvar = jax.jit(lambda p, a: jmod.apply(p, a, method="encode_moments"))(
        params, jnp.asarray(x))
    z = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    img = jax.jit(lambda p, a: jmod.apply(p, a, method="decode"))(params, jnp.asarray(z))
    port = load_into(Tvae.AutoencoderKL(4, **kw), params)
    with torch.no_grad():
        t_mean, t_logvar = port.encode_moments(cf(x))
        t_img = port.decode(cf(z))
    assert_close(cl(t_mean), mean, 1e-4)
    assert_close(cl(t_logvar), logvar, 1e-4)
    assert_close(cl(t_img), img, 1e-4)


def test_clip_image_encoder(rng):
    kw = dict(width=64, layers=2, num_heads=2, patch_size=14, output_dim=768)
    jmod = Jclip.CLIPImageEncoder(**kw)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    params = _init(jmod, jnp.asarray(x))
    ref = jax.jit(jmod.apply)(params, jnp.asarray(x))
    port = load_into(Tclip.CLIPImageEncoder(**kw), params)
    with torch.no_grad():
        out = port(cf(x))
    assert out.shape == (2, 1, 768)
    assert_close(out, ref, 1e-4)
