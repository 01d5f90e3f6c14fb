"""The THuman configuration in the port, against the JAX package on the CPU,
fp32: its config (orthographic cameras, the (80, 48, 80) coarse grid, 10 496
SMPL-X vertices) loads alike in both packages, and the slice as a whole runs
orthographic cameras on a non-cubic voxel grid (a tiny sampler trajectory,
as tests/test_torch_sampler.py runs it and under its stated known limit;
tolerance 1e-4, as there)."""

import dataclasses
from pathlib import Path

import pytest

from morphablediffusion_torch.utils import config as t_config
from morphablediffusion_tpu.utils import config as j_config
from tests.tiny import tiny_config
from tests.torch_parity import assert_slice_matches, port_model_config, sampler_run

TOL = 1e-4
THUMAN_YAML = Path(__file__).resolve().parents[1] / "configs" / "thuman.yaml"


def test_thuman_config_loads_as_in_jax():
    port, jax_cfg = t_config.load_config(THUMAN_YAML), j_config.load_config(THUMAN_YAML)
    assert port.model == port_model_config(jax_cfg.model)
    assert dataclasses.asdict(port.train) == dataclasses.asdict(jax_cfg.train)
    m = port.model
    assert (m.projection, m.voxel_grid_shape, m.max_vertices) == (
        "orthographic", (80, 48, 80), 10496)


@pytest.fixture(scope="module")
def thuman_run():
    cfg = tiny_config(view_num=2, projection="orthographic")
    cfg.model.voxel_grid_shape = (24, 16, 24)  # THuman's (80, 48, 80), cut to size
    return sampler_run(cfg)


def test_orthographic_sampler_trajectory(thuman_run):
    assert_slice_matches(thuman_run)
