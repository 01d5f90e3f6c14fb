"""`--finetune_from` of the port's train CLI on the CPU: a tiny reference
checkpoint exported from JAX parameters, loaded by the CLI before step 0,
gives the parameters that the JAX importer gives into the same tree (the
port's initial parameters, frozen ones in bf16), and a resumed run ignores
it."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import torch

from morphablediffusion_torch import weights
from morphablediffusion_torch.training.trainer import Trainer
from morphablediffusion_torch.utils.config import load_config
from morphablediffusion_tpu.models.diffusion import MorphableDiffusion as JModel
from morphablediffusion_tpu.utils import torch_import as jti
from morphablediffusion_tpu.utils.config import load_config as jload_config
from tests.test_torch_train_cli import TRAIN_YAML, UIDS, _facescape_layout
from tests.tiny import tiny_batch
from tests.torch_parity import _init_inference, seeded_tree

REPO = Path(__file__).resolve().parents[1]


def _nest(flat):
    tree = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def test_finetune_from(tmp_path):
    data, flame = _facescape_layout(tmp_path)
    cfg_path = tmp_path / "train.yaml"
    cfg_path.write_text(TRAIN_YAML.replace("max_steps: 1", "max_steps: 0").replace(
        "  dataset: facescape\n",
        f"  dataset: facescape\n  data_dir: {data}\n  flame_assets_dir: {flame}\n"
        f"  uids: {UIDS}\n  val_uids: ['002/02']\n"))
    jcfg = jload_config(cfg_path)
    jmodel = JModel(jcfg.model)
    abstract = jax.eval_shape(lambda b: jmodel.init(jax.random.key(0), b,
                                                    method=_init_inference),
                              tiny_batch(jcfg, with_targets=False))
    ckpts = []
    for seed in (0, 1):
        ckpts.append(tmp_path / f"ref{seed}.ckpt")
        jti.export_torch_checkpoint(seeded_tree(abstract, seed), str(ckpts[-1]), jcfg.model)

    args = ["-b", str(cfg_path), "-l", str(tmp_path / "runs"), "-n", "ft", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    run = lambda *extra: subprocess.run(
        [sys.executable, "-m", "morphablediffusion_torch.apps.train", *args, *extra],
        capture_output=True, text=True, env=env, timeout=300)
    r = run("--finetune_from", str(ckpts[0]))
    assert r.returncode == 0, r.stderr[-3000:]
    export = tmp_path / "runs" / "ft" / "ckpt" / "params" / "params.pt"
    got = torch.load(export)

    # the JAX importer into the port's initial parameters (the CLI's Trainer
    # at its seed), each leaf in the dtype the port stores it in
    cfg = load_config(cfg_path)
    cfg.train.seed = 6033
    model = Trainer(cfg, device="cpu").model
    params = dict(model.named_parameters())
    flat = weights.to_jax_layout(model, params)
    dtypes = dict(zip(flat, (p.dtype for p in params.values())))
    like = {"params": _nest({k: v.astype(jnp.bfloat16) if dtypes[k] == torch.bfloat16 else v
                             for k, v in flat.items()})}
    sd = jti.load_torch_state_dict(str(ckpts[0]))
    imported, report = jti.import_state_dict(sd, like, clip_layers=jcfg.model.clip.layers)
    assert f"imported {report['filled']} tensors" in r.stdout and report["filled"] == len(sd)
    expected = weights.from_jax_params(weights.flatten_tree(imported["params"]), device="cpu")
    assert got.keys() == expected.keys()
    changed = 0
    for k, v in expected.items():
        assert got[k].dtype == params[k].dtype
        assert torch.equal(got[k].float(), v), k
        changed += not torch.equal(got[k], params[k].detach())
    assert changed > 0.9 * len(got)

    # on --resume the run's checkpoint supersedes the import
    r = run("--resume", "--finetune_from", str(ckpts[1]))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "resumed from step 0" in r.stdout and "imported" not in r.stdout
    resumed = torch.load(export)
    for k, v in got.items():
        assert torch.equal(resumed[k], v), k
