"""The port's eval stages 1 - 3 against the JAX package's on the CPU, on a
tiny synthetic FaceScape tree (the port's tool: 2 subjects x 3 expressions x
5 views at 64^2, 60-vertex meshes) and tests/test_cli_integration.py's tiny
YAML, with weights carried across:

  * eval_select_views: the same JSON, byte for byte;
  * eval_generate: what each sampler call is handed (the padded view groups'
    target_K/target_RT, the input image of the chosen nes expression, the
    padded vertices), captured by patching both samplers' `sample` with
    `jax.jit` as the identity, and the strips' names and tile counts;
  * train_keypoints: three Adam steps from the same init on the same
    batches: every printed loss within 1e-5, every leaf within 1e-5
    relative L2, the loss of the final weights within 1e-5;
  * eval_keypoints --backend native, on the GT tree and on strips: the same
    keys, coordinates within 1e-3 px.
"""

import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from morphablediffusion_torch.apps import eval_generate as Tgen
from morphablediffusion_torch.apps import eval_keypoints as Tkp
from morphablediffusion_torch.apps import eval_select_views as Tsel
from morphablediffusion_torch.apps import train_keypoints as Ttrain
from morphablediffusion_torch.eval import keypoint_net as Tkn
from morphablediffusion_torch.sampling import SyncDDIMSampler as TSampler
from morphablediffusion_torch.tools import make_synthetic_facescape, make_synthetic_landmarks
from morphablediffusion_torch.weights import flatten_tree
from morphablediffusion_tpu.apps import eval_generate as Jgen
from morphablediffusion_tpu.apps import eval_keypoints as Jkp
from morphablediffusion_tpu.apps import eval_select_views as Jsel
from morphablediffusion_tpu.apps import train_keypoints as Jtrain
from morphablediffusion_tpu.eval import keypoint_net as Jkn
from morphablediffusion_tpu.sampling import SyncDDIMSampler as JSampler
from tests.test_cli_integration import TINY_YAML
from tests.torch_parity import seeded_tree

SIZE, SUBJECTS, EXPRESSIONS, VIEWS = 64, 2, 3, 5


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The synthetic tree with landmarks painted, its landmark file, the
    stage-1 JSON (both subjects) and the tiny YAML pointed at its meshes."""
    root = tmp_path_factory.mktemp("eval_tree")
    make_synthetic_landmarks.main(["--out", str(root / "landmarks.json"),
                                   "--mesh_vertices", "60"])
    make_synthetic_facescape.main([
        "--out", str(root), "--subjects", str(SUBJECTS), "--expressions", str(EXPRESSIONS),
        "--views", str(VIEWS), "--image_size", str(SIZE), "--points", "3000",
        "--mesh_vertices", "60", "--mark_landmarks", str(root / "landmarks.json")])
    (root / "views.json").write_text(json.dumps(
        Jsel.select_views(str(root / "data"), ["001", "002"])))
    (root / "tiny.yaml").write_text(TINY_YAML.replace(
        "data:\n", f"data:\n  flame_assets_dir: {root / 'flame'}\n"))
    return root


def test_select_views_json_equal(tree, tmp_path):
    argv = lambda name: ["--data_dir", str(tree / "data"), "--output", str(tmp_path / name),
                         "--subjects", "001", "002", "003"]
    Jsel.main(argv("jax.json"))
    Tsel.main(argv("port.json"))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    meta = json.loads((tmp_path / "port.json").read_text())
    assert meta["003"] == {f"{e:02d}": {} for e in range(1, 21)}  # no such subject
    assert len(meta["001"]["01"]["target_views"]) == VIEWS


@pytest.mark.parametrize("mode", ["nes", "nvs"])
def test_eval_generate_hands_the_sampler_the_same_batch(tree, tmp_path, monkeypatch, mode):
    """2 views a sample and 5 targets: 3 groups, the last padded with the
    first target; nes draws each input expression from the other two."""
    calls = {"jax": [], "port": []}

    def jax_sample(self, params, batch, key, cfg_scale):
        calls["jax"].append({k: np.asarray(v) for k, v in batch.items()})
        B, N = batch["target_K"].shape[:2]
        return (jnp.zeros((B, N, SIZE, SIZE, 3)),)

    def port_sample(self, batch, cfg_scale=2.0, generator=None, **kw):
        calls["port"].append({k: v.numpy() for k, v in batch.items()})
        B, N = batch["target_K"].shape[:2]
        return torch.zeros((B, N, SIZE, SIZE, 3)), None

    monkeypatch.setattr(jax, "jit", lambda f, **kw: f)
    monkeypatch.setattr(Jgen, "_ensure_params", lambda *a: None)
    monkeypatch.setattr(JSampler, "sample", jax_sample)
    monkeypatch.setattr(TSampler, "sample", port_sample)
    common = ["--data_dir", str(tree / "data"), "--mode", mode, "--cfg", str(tree / "tiny.yaml"),
              "--ckpt", "random", "--views_json", str(tree / "views.json"),
              "--nes_exp", "01", "02", "03", "--seed", "11"]
    Jgen.main(common + ["--output_dir", str(tmp_path / "jax")])
    Tgen.main(common + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert len(calls["port"]) == len(calls["jax"]) == SUBJECTS * EXPRESSIONS
    for ours, ref in zip(calls["port"], calls["jax"]):
        assert ours.keys() == ref.keys()
        assert ref["target_K"].shape[:2] == (3, 2)
        for k in ref:
            assert ours[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    # the input expression differs from the target's in nes mode only
    first = calls["port"][0]["input_image"][0]
    same_exp = np.array_equal(first, calls["port"][1]["input_image"][0])
    assert not same_exp or mode == "nes"
    strips = sorted(p.name for p in (tmp_path / "jax").glob("*.png"))
    assert strips == sorted(p.name for p in (tmp_path / "port").glob("*.png"))
    assert len(strips) == SUBJECTS * EXPRESSIONS
    for name in strips:
        assert Image.open(tmp_path / "port" / name).size == (VIEWS * SIZE, SIZE)


# the heatmap conv's bias, whose gradient is exactly 0 (see below)
ZERO_GRADIENT = "Conv_1.bias"
ADAM_EPS = 1e-2


def _carried(params) -> Tkn.LandmarkNet:
    net = Tkn.LandmarkNet()
    net.load_state_dict(Tkn.from_jax_params(flatten_tree(params["params"])), strict=True)
    return net


def test_train_keypoints_adam_steps_match_jax(tree, tmp_path, monkeypatch, capsys):
    """Both CLIs from flax's init of the same seed, on the same batches.
    Both optimizers run at eps 1e-2 (optax.adam and torch.optim.Adam patched
    alike): at eps 1e-8 an element whose gradient is within rounding of eps
    (seen: 2.5e-9, 1.2e-8) takes a step that differs by up to lr / 4 x the
    relative rounding of its gradient, which moves whole leaves that start
    at 0 by ~1e-4 of their norm after three steps."""
    import optax

    init = Jkn.LandmarkNet().init(jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)))
    adam, optax_adam = torch.optim.Adam, optax.adam
    monkeypatch.setattr(optax, "adam", lambda lr: optax_adam(lr, eps=ADAM_EPS))
    monkeypatch.setattr(torch.optim, "Adam", lambda params, lr: adam(params, lr=lr, eps=ADAM_EPS))
    monkeypatch.setattr(Tkn, "seeded_net", lambda seed, num_keypoints=68: _carried(init))
    argv = lambda out: ["--image_dir", str(tree / "data"),
                        "--labels", f"mesh:{tree / 'landmarks.json'}",
                        "--mesh", str(tree / "flame" / "{subject}" / "{exp}" / "mesh.obj"),
                        "--out", str(out), "--steps", "3", "--batch", "4", "--lr", "1e-2",
                        "--image_size", str(SIZE), "--log_every", "1"]
    Jtrain.main(argv(tmp_path / "jax.msgpack"))
    jax_losses = [float(v) for v in re.findall(r"step \d+ loss ([\d.]+)", capsys.readouterr().out)]
    losses = Ttrain.main(argv(tmp_path / "port.pt") + ["--device", "cpu"])
    assert len(losses) == len(jax_losses) == 3
    np.testing.assert_allclose(losses, jax_losses, rtol=0, atol=1e-5)
    assert losses[0] > 0

    _, jparams = Jkn.load_params(str(tmp_path / "jax.msgpack"), SIZE)
    want = Tkn.from_jax_params(flatten_tree(jparams["params"]))
    net = Tkn.load_params(tmp_path / "port.pt", "cpu")
    got = net.state_dict()
    start = Tkn.from_jax_params(flatten_tree(init["params"]))
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k == ZERO_GRADIENT:
            # a bias added to every logit of a heatmap: the softmax cancels
            # it, so its gradient is rounding noise (~1e-10) in both
            # packages and neither moves it beyond that
            for leaf in (v, got[k]):
                assert float((leaf - start[k]).abs().max()) <= 1e-8
            continue
        assert not torch.equal(v, start[k]), k
        err = float((got[k] - v).norm() / v.norm())
        step_err = float((got[k] - v).norm() / (v - start[k]).norm())
        assert err <= 1e-5 and step_err <= 1e-3, (k, err, step_err)
    x = np.stack([np.asarray(Image.open(p).convert("RGB"), np.float32) / 255.0
                  for p in sorted((tree / "data").rglob("*.png"))[:4]])
    kpts = np.random.default_rng(1).uniform(0, SIZE, (4, 68, 2)).astype(np.float32)
    jloss = Jkn.keypoint_loss(jparams, Jkn.LandmarkNet().apply, jnp.asarray(x), jnp.asarray(kpts))
    with torch.no_grad():
        tloss = Tkn.keypoint_loss(net, torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                                  torch.from_numpy(kpts))
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)


def test_eval_keypoints_native_matches_jax(tree, tmp_path):
    params = seeded_tree(jax.eval_shape(
        lambda: Jkn.LandmarkNet().init(jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)))))
    Jkn.save_params(str(tmp_path / "net.msgpack"), params)
    Tkn.save_params(tmp_path / "net.pt", _carried(params))
    # strips of the first three views (eval_generate's output layout)
    strips = tmp_path / "strips"
    strips.mkdir()
    for s, e in (("001", "01"), ("002", "03")):
        views = [np.asarray(Image.open(tree / "data" / s / e / f"view_{v:05d}" /
                                       "rgba_colorcalib.png").convert("RGB")) for v in range(3)]
        Image.fromarray(np.concatenate(views, axis=1)).save(strips / f"{s}_{e}.png")
    for extra, image_dir, n in (([], tree / "data", SUBJECTS * EXPRESSIONS * VIEWS),
                                (["--strips"], strips, 6)):
        common = ["--image_dir", str(image_dir), "--backend", "native",
                  "--views_json", str(tree / "views.json"), "--image_size", str(SIZE), *extra]
        Jkp.main(common + ["--output", str(tmp_path / "jax.json"),
                           "--weights", str(tmp_path / "net.msgpack")])
        Tkp.main(common + ["--output", str(tmp_path / "port.json"),
                           "--weights", str(tmp_path / "net.pt"), "--device", "cpu"])
        ref = json.loads((tmp_path / "jax.json").read_text())
        ours = json.loads((tmp_path / "port.json").read_text())
        assert list(ours) == list(ref) and len(ours) == n
        np.testing.assert_allclose(np.asarray(list(ours.values())),
                                   np.asarray(list(ref.values())), rtol=0, atol=1e-3)


def test_eval_keypoints_host_backends(tree, tmp_path):
    """precomputed passes a valid JSON through and refuses one without 68
    points a view; command runs the user's command; neither needs a card."""
    kpts = {"a": np.zeros((68, 2)).tolist()}
    (tmp_path / "in.json").write_text(json.dumps(kpts))
    Tkp.main(["--image_dir", "unused", "--output", str(tmp_path / "out.json"),
              "--backend", "precomputed", "--precomputed", str(tmp_path / "in.json")])
    assert json.loads((tmp_path / "out.json").read_text()) == kpts
    (tmp_path / "bad.json").write_text(json.dumps({"a": [[0, 0]] * 5}))
    with pytest.raises(SystemExit, match="68"):
        Tkp.main(["--image_dir", "unused", "--output", str(tmp_path / "o2.json"),
                  "--backend", "precomputed", "--precomputed", str(tmp_path / "bad.json")])
    Tkp.main(["--image_dir", str(tree), "--output", str(tmp_path / "cmd.json"),
              "--backend", "command", "--command", f"cp {tmp_path / 'in.json'} {{output}}"])
    assert json.loads((tmp_path / "cmd.json").read_text()) == kpts
