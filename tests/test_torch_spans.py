"""The port's `md.*` spans (utils/spans.py) on the CPU, at tests/tiny.py's
config: none is recorded without a profiler, and under one the sampler
and the trainer record each span of their layers the expected number of
times, nested in its parent, as host ranges and never as user
annotations; the benchmark's own module spans keep their CPU ops; no
number changes."""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from h100_bench import trace
from morphablediffusion_torch.models.diffusion import MorphableDiffusion as TModel
from morphablediffusion_torch.models.layers import ResBlock, SpatialTransformer
from morphablediffusion_torch.models.unet import DepthTransformer
from morphablediffusion_torch.sampling import SyncDDIMSampler
from morphablediffusion_torch.training import trainer as t_trainer
from morphablediffusion_torch.utils import spans
from morphablediffusion_torch.weights import seeded_params
from tests.tiny import tiny_batch, tiny_config
from tests.torch_parity import port_train_config, tt

STEPS = 2


def _config(remat=False):
    jcfg = tiny_config(view_num=2)
    jcfg.model.unet.use_checkpoint = remat
    return port_train_config(jcfg)


@pytest.fixture(scope="module")
def served():
    cfg = _config()
    model = seeded_params(TModel(cfg.model, device="cpu"), 5).eval()
    batch = {k: tt(v) for k, v in tiny_batch(tiny_config(view_num=2), B=1,
                                             with_targets=False).items()}
    return model, SyncDDIMSampler(model, sample_steps=STEPS), batch


@pytest.fixture(scope="module")
def train_batch():
    return {k: tt(v) for k, v in tiny_batch(tiny_config(view_num=2), B=2).items()}


def _sample(served):
    _, sampler, batch = served
    return sampler.sample(batch, generator=torch.Generator().manual_seed(11))


def _train_step(batch, remat=False):
    trainer = t_trainer.Trainer(_config(remat), device="cpu", seed=3)
    out = trainer.train_step(batch)
    return trainer, out


def _blocks(unet):
    """(ResBlocks, SpatialTransformers, DepthTransformers) of one UNet call."""
    kids = list(unet.children())
    return tuple(sum(isinstance(m, kind) for m in kids)
                 for kind in (ResBlock, SpatialTransformer, DepthTransformer))


def _events(prof):
    """Every host record: (name, start, end, thread, user annotation)."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id(),
             e.is_user_annotation())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CPU]


def _md(events):
    return [e for e in events if e[0].startswith("md.")]


def _count(events, name):
    return sum(e[0] == name for e in events)


def _inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


def _each_nested(events, child, parent):
    parents = [e for e in events if e[0] == parent]
    kids = [e for e in events if e[0] == child]
    return bool(kids) and all(any(_inside(k, p) for p in parents) for k in kids)


def _raising(name):
    raise AssertionError(f"a record function ({name}) was constructed without a profiler")


def test_no_record_without_a_profiler(served, train_batch, monkeypatch):
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _raising)
    assert spans.span("md.a") is spans.span("md.b")
    _sample(served)
    _train_step(train_batch)


def test_sampler_spans(served):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _sample(served)
    ev = _md(_events(prof))
    assert not any(e[4] for e in ev)
    res, attn, cond = _blocks(served[0].unet)
    expected = {"md.sample": 1, "md.prepare": 1, "md.decode": 1, "md.step": STEPS,
                "md.ddim": STEPS, "md.volume": STEPS, "md.mesh_voxel": STEPS,
                "md.frustum": STEPS, "md.unet": STEPS, "md.unet.res": STEPS * res,
                "md.unet.attn": STEPS * attn, "md.unet.cond": STEPS * cond}
    assert {n: _count(ev, n) for n in expected} == expected
    assert {e[0] for e in ev} == set(expected)
    for child, parent in (("md.prepare", "md.sample"), ("md.step", "md.sample"),
                          ("md.ddim", "md.sample"), ("md.decode", "md.sample"),
                          ("md.volume", "md.step"), ("md.mesh_voxel", "md.volume"),
                          ("md.frustum", "md.step"), ("md.unet", "md.step"),
                          ("md.unet.res", "md.unet"), ("md.unet.attn", "md.unet"),
                          ("md.unet.cond", "md.unet")):
        assert _each_nested(ev, child, parent), (child, parent)
    steps = sorted(e for e in ev if e[0] == "md.step")
    ddims = sorted(e for e in ev if e[0] == "md.ddim")
    for s, d in zip(steps, ddims):  # the update follows its noise prediction
        assert s[2] <= d[1] and not _inside(d, s)
    assert steps[-1][2] <= [e for e in ev if e[0] == "md.decode"][0][1]


@pytest.mark.parametrize("remat", [False, True])
def test_trainer_spans(train_batch, remat):
    trainer = t_trainer.Trainer(_config(remat), device="cpu", seed=3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_step(train_batch)
    ev = _md(_events(prof))
    assert not any(e[4] for e in ev)
    res, attn, cond = _blocks(trainer.model.unet)
    expected = {"md.train_step": 1, "md.forward": 1, "md.encode": 1, "md.backward": 1,
                "md.update": 1, "md.volume": 1, "md.mesh_voxel": 1, "md.frustum": 1,
                "md.unet": 1, "md.unet.res": res, "md.unet.attn": attn, "md.unet.cond": cond}
    assert {n: _count(ev, n) for n in expected} == expected
    assert {e[0] for e in ev} == set(expected)
    for child, parent in (("md.forward", "md.train_step"), ("md.backward", "md.train_step"),
                          ("md.update", "md.train_step"), ("md.encode", "md.forward"),
                          ("md.volume", "md.forward"), ("md.mesh_voxel", "md.volume"),
                          ("md.unet", "md.forward"), ("md.unet.res", "md.unet"),
                          ("md.unet.attn", "md.unet"), ("md.unet.cond", "md.unet")):
        assert _each_nested(ev, child, parent), (child, parent)
    fwd, bwd, upd = ([e for e in ev if e[0] == n][0]
                     for n in ("md.forward", "md.backward", "md.update"))
    assert fwd[2] <= bwd[1] and bwd[2] <= upd[1]


def _annotated_ops(events):
    """For each user annotation in order: the names of the CPU ops it
    encloses on its thread, the port's spans left out."""
    notes = sorted((e for e in events if e[4]), key=lambda e: e[1])
    ops = [e for e in events if not e[4] and not e[0].startswith("md.")]
    return [(n[0], [o[0] for o in sorted(ops, key=lambda o: o[1])
                    if o[3] == n[3] and _inside(o, n)]) for n in notes]


def test_harness_module_spans_keep_their_ops(served, train_batch, monkeypatch):
    model = served[0]

    def traced_calls():
        hooks = trace.module_spans({"unet": model.unet, "decode": model.first_stage.decoder},
                                   True)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _sample(served)
        hooks.remove()
        trainer = t_trainer.Trainer(_config(), device="cpu", seed=3)
        hooks = trace.module_spans({"unet": trainer.model.unet}, True)
        with profile(activities=[ProfilerActivity.CPU]) as prof_train:
            trainer.train_step(train_batch)
        hooks.remove()
        return _events(prof), _events(prof_train)

    with_spans = traced_calls()
    with monkeypatch.context() as m:
        m.setattr(torch._C._profiler, "_RecordFunctionFast",
                  lambda name: contextlib.nullcontext())
        without = traced_calls()
    for ev, ev0, names in zip(with_spans, without, ({"unet", "decode"}, {"unet"})):
        notes = {e[0] for e in ev if e[4]}
        assert notes >= names and notes == {e[0] for e in ev0 if e[4]}
        assert not any(n.startswith("md.") for n in notes)
        assert _md(ev) and not _md(ev0)
        assert _annotated_ops(ev) == _annotated_ops(ev0)


def test_numbers_are_the_same_with_the_profiler(served, train_batch):
    images, latents = _sample(served)
    trainer, out = _train_step(train_batch)
    with profile(activities=[ProfilerActivity.CPU]):
        images_p, latents_p = _sample(served)
        trainer_p, out_p = _train_step(train_batch)
    assert torch.equal(images, images_p) and torch.equal(latents, latents_p)
    assert torch.equal(out["loss"], out_p["loss"])
    assert torch.equal(out["grad_norm"], out_p["grad_norm"])
    for a, b in zip(trainer.model.parameters(), trainer_p.model.parameters()):
        assert torch.equal(a, b)


def test_counters_keys():
    c = spans.counters()
    assert set(c) == {"cuda_malloc", "cuda_free", "alloc_retries"}
    assert all(isinstance(v, int) for v in c.values())
    if not torch.cuda.is_available():
        assert set(c.values()) == {0}
