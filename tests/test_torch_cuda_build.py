"""The kernels' build cache on the CPU (no nvcc is run): a library's name
follows its source, the headers beside it and the flags, so an edited
header, which several sources may include, leads to a new build rather than
a stale library under build/torch_kernels/."""

import re
import shutil

import pytest

from morphablediffusion_torch.ops import _cuda


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of the kernel sources, which new CudaKernels read."""
    src = tmp_path / "csrc"
    shutil.copytree(_cuda.CSRC, src)
    monkeypatch.setattr(_cuda, "CSRC", src)
    return src


def _kernel(source):
    return _cuda.CudaKernel("k", source, "entry", [])


@pytest.mark.parametrize("source", ["flash_attention.cu", "flash_attention_bwd.cu",
                                    "depth_attention_ctx.cu"])
def test_lib_path_follows_the_shared_header(csrc, source):
    kernel = _kernel(source)
    before = kernel.lib_path()
    assert kernel.lib_path() == before and before.parent == _cuda.BUILD_DIR
    header = csrc / "flash_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert kernel.lib_path() != before


@pytest.mark.parametrize("header", ["flash_common.cuh", "cluster_common.cuh"])
def test_cluster_design_follows_both_headers(csrc, header):
    """K1's cluster design includes cluster_common.cuh, which includes
    flash_common.cuh: an edit to either rebuilds it."""
    kernel = _kernel("depth_attention_ctx_cluster.cu")
    before = kernel.lib_path()
    path = csrc / header
    path.write_text(path.read_text() + "\n// edited\n")
    assert kernel.lib_path() != before


def test_lib_path_follows_the_source(csrc):
    kernel = _kernel("flash_attention_bwd.cu")
    before = kernel.lib_path()
    other = _kernel("group_norm.cu").lib_path()
    src = csrc / "flash_attention_bwd.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert kernel.lib_path() != before
    assert _kernel("group_norm.cu").lib_path() == other


def test_every_included_header_is_hashed():
    """Each quoted #include of a source names a *.cuh beside it, which
    `lib_path` hashes."""
    for src in sorted(_cuda.CSRC.glob("*.cu")):
        for name in re.findall(r'#include "([^"]+)"', src.read_text()):
            assert name.endswith(".cuh") and (_cuda.CSRC / name).is_file(), (src.name, name)
