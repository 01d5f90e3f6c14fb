"""The harness end to end on the CPU at a tiny size, and its contract."""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from h100_bench import driver, run
from h100_bench.tests import bench_tiny

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def tiny_run(workload: str, traced: bool = False, seed: int = 2**31 + 12345):
    cell, cfg, traffic, e2e, per_layer = run.load_cell(workload)
    mode = cfg["model"]["mesh_voxel_mode"]
    return driver.run_cell(cell, bench_tiny.config(mode), bench_tiny.traffic(cell["traffic"]),
                           e2e, per_layer, seed, 0.2, traced, torch.device("cpu"),
                           time.perf_counter())


@pytest.mark.parametrize("workload", CELLS)
def test_contract_line_per_cell(workload):
    out = tiny_run(workload)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    names = {m["name"] for m in BENCH["end_to_end"] if workload in m.get("workloads", CELLS)}
    assert set(out["metrics"]) == names
    assert all(m["value"] > 0 for m in out["metrics"].values())
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]
    print(json.dumps(out))


def test_traced_run_on_the_cpu_reads_no_device_metric():
    out = tiny_run(CELLS[0], traced=True)
    assert out["metrics"] == {}
    assert out["device"]["busy_s"] == 0.0 and out["device"]["window_s"] > 0
    assert out["correct"] is True


def test_forbidden_modules_compares_whole_top_level_names():
    loaded = {"jax": 1, "jaxlib.xla_client": 1, "flax.linen": 1, "jaxtyping": 1,
              "morphablediffusion_tpu.ops": 1, "morphablediffusion_torch.ops": 1,
              "flaxen": 1}
    assert run.forbidden_modules(loaded) == ["flax", "jax", "jaxlib", "morphablediffusion_tpu"]


def test_the_harness_and_the_port_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from h100_bench import check, control, counts, driver, gen, reference, run, "
            "seeded, trace\n"
            "counts.program_kernels()\n"
            "from morphablediffusion_torch.sampling import SyncDDIMSampler\n"
            "from morphablediffusion_torch.training.trainer import Trainer\n"
            "print(run.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True, env={"PATH": "/usr/bin:/bin",
                                                       "USE_FLAX": "0"})
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_main_exits_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_benchmark_files_are_found_by_name():
    for w in BENCH["workloads"]:
        cell, cfg, traffic, e2e, per_layer = run.load_cell(w["name"])
        assert cfg["model"] and traffic["kind"] in ("sampler", "train")
        assert (ROOT / "h100_bench" / "limits" / f"{w['name']}.json").exists()
    for m in BENCH["per_layer"]:
        assert callable(driver.load_reader(m["name"]))
        assert {e["name"] for e in BENCH["end_to_end"]} >= {m["moves"]}


@pytest.mark.cuda
def test_one_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, str(ROOT / "h100_bench" / "run.py"), "--workload",
                          CELLS[0], "--seed", "7", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
