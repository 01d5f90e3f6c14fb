"""The slice as a whole: the port's SyncDDIMSampler against the JAX package's,
at tests/tiny.py's config on the CPU in fp32.

The JAX noise stream (`split`, then `fold_in(rng, index)` per step,
sampling/ddim.py:75-96) is regenerated and injected into the port, and the
port is held to `denoise_latents(collect_trajectory=True)` after every step,
to the prepared encodings, and to the decoded images. Tolerance 1e-4 (fp32
through two CFG denoising steps of the whole network, with the fused
depth-context fold in the port against the unfused chain in JAX).

Weights: kernels are seeded N(0, 1/fan_in); biases 0 and norm scales 1 as
in the JAX init; the frustum net's time/view projections (t_conv, v_conv)
are zero. With them on, their per-channel offsets dominate the frustum
features in the empty part of the frustum, and the one-pass fp32 GroupNorm
variance of both packages cancels to ~1e-3: the JAX package then disagrees
with itself (jit vs eager) by more than with the port. Those projections are
held to 1e-4 on well-conditioned inputs in test_torch_conditioning.py."""

import pytest
import torch

from tests.tiny import tiny_config
from tests.torch_parity import assert_close, sampler_run

TOL = 1e-4


@pytest.fixture(scope="module")
def slice_run():
    return sampler_run(tiny_config(view_num=2))


def test_prepared_encodings(slice_run):
    r = slice_run
    for k in ("x_input", "clip_embed", "v_embed"):
        assert_close(r["t_prep"][k], r["prep"][k], TOL)


def test_trajectory_every_step(slice_run):
    r = slice_run
    assert len(r["t_traj"]) == r["traj"].shape[0] == 2
    for step, (t_x, j_x) in enumerate(zip(r["t_traj"], r["traj"])):
        assert_close(t_x, j_x, TOL)
    assert_close(r["t_lat"], r["latents"], TOL)


def test_decoded_images(slice_run):
    r = slice_run
    assert r["t_images"].shape == (1, 2, 64, 64, 3)
    assert torch.isfinite(r["t_images"]).all()
    assert_close(r["t_images"], r["images"], TOL)
    assert torch.equal(r["t_lat2"], r["t_lat"])  # sample() == denoise + decode


def test_cpu_run_launches_no_kernel(slice_run):
    assert slice_run["launches"] == (0,) * 4  # K1, K3, K2 and K4
