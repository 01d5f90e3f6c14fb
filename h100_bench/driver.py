"""Set-up, measured window, traced window and output check of one cell.

The system under test is the port's public entry points:
`sampling.SyncDDIMSampler.sample` (serving) and
`training.trainer.Trainer.train_step` (training), built from
`utils.config.Config` with the weights this benchmark makes
(`seeded.make_state`). A window is a whole number of calls back to back
from one closed-loop client: a call that starts before `seconds` have
passed runs to its end and counts, none starts after.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from h100_bench import check, counts, gen, seeded, trace

BENCH = Path(__file__).resolve().parent
LIMITS = BENCH / "limits"


def port_config(doc: dict):
    """The port's Config with the configuration file's model and train
    objects."""
    from morphablediffusion_torch.utils.config import Config

    cfg = Config()

    def apply(dc, d):
        for k, v in d.items():
            cur = getattr(dc, k)
            if dataclasses.is_dataclass(cur):
                apply(cur, v)
            else:
                setattr(dc, k, tuple(v) if isinstance(v, list) else v)

    apply(cfg.model, doc["model"])
    apply(cfg.train, doc["train"])
    return cfg


def limits_of(cell_name: str) -> dict:
    path = LIMITS / f"{cell_name}.json"
    return json.loads(path.read_text())["limits"] if path.exists() else {}


def load_reader(name: str):
    spec = importlib.util.spec_from_file_location(f"h100_bench_metric_{name}",
                                                  BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def device_info(device, count: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StepRecorder:
    """Wraps the served model's `prepare_inference`, `predict_eps_cfg` and
    spatial volume on the instance: opens the benchmark's spans when
    tracing, and keeps for the check one call of the window, drawn from
    the seed as it runs (a reservoir of one: call i replaces the kept one
    with probability 1 / (i + 1)): its prep, the latents, noise predictions
    and spatial volumes of the DDIM indices `keep` (and the latents that
    follow them), and the UNet's inputs and output at the first of them."""

    def __init__(self, model, steps: int, keep, spans: bool, seed: int):
        self.steps, self.keep, self.spans = steps, sorted(keep), spans
        self.draw = torch.Generator().manual_seed(gen.stream_seed(seed, "reservoir") & 0xFFFFFFFF)
        self.armed, self.calls, self.index, self.rec, self.kept = False, 0, steps, None, None
        eps_fn, prep_fn = model.predict_eps_cfg, model.prepare_inference
        sv = model.spatial_volume
        vol_fn, fr_fn = sv.construct_spatial_volume, sv.construct_view_frustum_volume

        def prepare(batch):
            self.index, self.rec = self.steps, None
            if self.armed:
                if float(torch.rand(1, generator=self.draw)) * (self.calls + 1) < 1.0:
                    self.rec = self.kept = {"call": self.calls, "x": {}, "eps": {},
                                            "volume": {}}
                self.calls += 1
            with trace.span("prepare", self.spans):
                out = prep_fn(batch)
            if self.rec is not None:
                self.rec["prep"] = {k: v.clone() for k, v in out.items()}
            return out

        def predict(x, t, *a, **k):
            self.index -= 1
            if self.rec is not None and (self.index in keep or self.index + 1 in keep):
                self.rec["x"][self.index] = x.clone()
            with trace.span("step", self.spans):
                eps = eps_fn(x, t, *a, **k)
            if self.rec is not None and self.index in keep:
                self.rec["eps"][self.index] = eps.clone()
            return eps

        def volume(*a, **k):
            with trace.span("volume", self.spans):
                out = vol_fn(*a, **k)
            if self.rec is not None and self.index in keep:
                self.rec["volume"][self.index] = out.clone()
            return out

        def frustum(*a, **k):
            with trace.span("volume", self.spans):
                return fr_fn(*a, **k)

        def unet_in(_m, args, kwargs):
            if self.rec is not None and self.index == self.keep[0] and "unet" not in self.rec:
                x, t, context, vols = args[:4]
                self.rec["unet"] = {"x": x.clone(), "t": t.clone(), "context": context.clone(),
                                    "vols": {w: v.clone() for w, v in vols.items()},
                                    "cfg_doubled": kwargs.get("cfg_doubled", False)}

        def unet_out(_m, _args, out):
            if self.rec is not None and self.index == self.keep[0] and "out" not in self.rec.get(
                    "unet", {"out": 0}):
                self.rec["unet"]["out"] = out.clone()

        model.prepare_inference, model.predict_eps_cfg = prepare, predict
        sv.construct_spatial_volume, sv.construct_view_frustum_volume = volume, frustum
        self.hooks = [model.unet.register_forward_pre_hook(unet_in, with_kwargs=True),
                      model.unet.register_forward_hook(unet_out)]


def run_cell(cell, cfgdoc, traffic, e2e, per_layer, seed, seconds, traced, device, t0,
             control=None):
    """One run; returns the result line's object. `control` ('w8a8') runs
    the program's own lower-precision path (control.py)."""
    kind = traffic["kind"]
    if kind == "sampler":
        return run_serving(cell, cfgdoc, traffic, e2e, per_layer, seed, seconds, traced,
                           device, t0, control)
    if kind == "train":
        return run_training(cell, cfgdoc, traffic, e2e, per_layer, seed, seconds, traced,
                            device, t0)
    raise ValueError(f"traffic kind {kind!r}: sampler or train")


def window(call, seconds: float, device):
    """Calls back to back until `seconds` have passed; returns (calls,
    seconds of the window)."""
    sync(device)
    start = time.perf_counter()
    n = 0
    while n == 0 or time.perf_counter() - start < seconds:
        call(n)
        n += 1
    sync(device)
    return n, time.perf_counter() - start


def run_serving(cell, cfgdoc, traffic, e2e, per_layer, seed, seconds, traced, device, t0,
                control=None):
    from morphablediffusion_torch.models.diffusion import MorphableDiffusion
    from morphablediffusion_torch.ops import schedules
    from morphablediffusion_torch.sampling import SyncDDIMSampler
    from morphablediffusion_torch.weights import cast_for_serving

    cfg = port_config(cfgdoc)
    m, smp = cfgdoc["model"], cfgdoc["sampler"]
    if control == "w8a8":
        cfg.model.unet.w8a8 = True
    B, steps = traffic["batch"], smp["steps"]
    dtype = gen.DTYPES[m["dtype"]]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model = MorphableDiffusion(cfg.model, device="meta").to_empty(device=device)
    cast_for_serving(model, dtype)
    model.load_state_dict(seeded.make_state(m, seed, device, served_dtype=dtype), strict=True)
    model.eval()
    sampler = SyncDDIMSampler(model, sample_steps=steps, eta=smp["eta"],
                              batch_view_num=traffic["views_per_call"])
    make = gen.BatchMaker(m, traffic, seed, device)
    pool = [make(i) for i in range(traffic["pool"])]
    if m["mesh_voxel_mode"] == "fine":
        print(f"occupied fine voxels, batch 0: "
              f"{gen.occupied_fine_voxels(pool[0], m['fine_voxel_size'])}", file=sys.stderr)
    keep = check.checked_steps(seed, steps, traffic["check"]["steps"])
    rec = StepRecorder(model, steps, keep, traced, seed)
    hooks = trace.module_spans({"unet": model.unet, "decode": model.first_stage.decoder},
                               traced)

    with torch.inference_mode():  # warm up this cell's shapes: prepare, two steps, decode
        b = pool[0]
        prep = model.prepare_inference(b)
        g = gen.generator(device, seed, "warmup")
        x = torch.randn((B, m["view_num"], m["image_size"] // 8, m["image_size"] // 8, 4),
                        generator=g, device=device)
        for index in (steps - 1, steps - 2):
            t = torch.full((B,), int(sampler.timesteps[index]), dtype=torch.int64, device=device)
            eps = model.predict_eps_cfg(x, t, prep["clip_embed"], prep["x_input"],
                                        prep["v_embed"], b, smp["cfg_scale"],
                                        traffic["views_per_call"])
            x = schedules.ddim_step(x, eps, index, sampler.ddim, torch.randn_like(x))
        model.decode_views(x, traffic["views_per_call"])
        del prep, x, eps
    sync(device)
    rec.armed = True
    setup_s = time.perf_counter() - t0
    launches0 = counts.launch_counts()

    def call(i):
        with trace.span("call", traced):
            img, lat = sampler.sample(pool[i % len(pool)], cfg_scale=smp["cfg_scale"],
                                      generator=gen.generator(device, seed, "noise", i))
        img = img.cpu()  # the client receives the avatars
        if rec.kept is not None and rec.kept["call"] == i:
            rec.kept["images"], rec.kept["latents"] = img, lat

    recorder = counts.LaunchRecorder(traced)
    with trace.profiled(traced) as prof:
        n_calls, window_s = window(call, seconds, device)
    recorder.close()
    hooks.remove()
    launches = {k: v - launches0.get(k, 0) for k, v in counts.launch_counts().items()}
    info = device_info(device, cell["chips"])

    metrics, breakdown = {}, None
    if traced:
        summary = trace.summarize(prof, window_s, device)
        summary.update(kind="serve", steps=n_calls * steps, calls=n_calls, batch=B,
                       launches=launches, records=recorder.records,
                       flops_per_call=counts.serving_flops(m, traffic, pool[0], steps),
                       peak_flops=counts.PEAK_BF16)
        trace.report_launch_mismatch(summary)
        metrics = read_metrics(per_layer, summary)
        info.update(busy_s=summary["busy_s"], window_s=window_s)
        breakdown = summary["breakdown"]
    else:
        metrics = {"avatars_per_s": {"value": n_calls * B / window_s, "unit": "avatars/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        metrics = {k: v for k, v in metrics.items() if k in {e["name"] for e in e2e}}

    # the check: the program's state goes first, then the reference runs
    got = rec.kept
    got["batch"] = pool[got["call"] % len(pool)]
    for h in rec.hooks:
        h.remove()
    del model, sampler, rec, pool
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = check.serving(cfgdoc, traffic, seed, got, keep, device, limits_of(cell["name"]))
    print(f"checked call {got['call']} of {n_calls}, DDIM indices {keep}, in "
          f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    out = {"correct": correct, "attempted": n_calls * B, "failed": 0, "metrics": metrics,
           "device": info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def read_metrics(per_layer, summary):
    out = {}
    for m in per_layer:
        v = load_reader(m["name"])(summary)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run_training(cell, cfgdoc, traffic, e2e, per_layer, seed, seconds, traced, device, t0):
    from morphablediffusion_torch.models.diffusion import MorphableDiffusion
    from morphablediffusion_torch.training.trainer import Trainer

    cfg = port_config(cfgdoc)
    m = cfgdoc["model"]
    B = traffic["batch"]
    n_check = traffic["check"]["steps"]
    last = [t0]

    def stamp(what):
        sync(device)
        now = time.perf_counter()
        print(f"set-up {what}: {now - last[0]:.2f} s", file=sys.stderr)
        last[0] = now

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model = MorphableDiffusion(cfg.model, device="meta").to_empty(device=device)
    model.load_state_dict(seeded.make_state(m, seed, device), strict=True)
    trainer = Trainer(cfg, device=device, seed=gen.stream_seed(seed, "trainer") & 0xFFFFFFFF,
                      model=model)
    hooks = trace.module_spans({"unet": model.unet}, traced)
    make = gen.BatchMaker(m, traffic, seed, device)
    stamp("trainer")

    def step(i):
        batch = make(i, with_targets=True)
        draws = gen.training_draws(m, B, seed, i, device)
        with trace.span("train_step", traced):
            return trainer.train_step(batch, draws=draws)

    # set-up: the first steps, which the reference follows, are the warm-up
    losses, grad_norms = [], None
    for i in range(n_check):
        losses.append(float(step(i)["loss"]))
        if i == 0:
            grad_norms = check.first_grad_norms(trainer)
        stamp(f"step {i}")
    change_norms = check.change_norms(trainer, m, seed, device)
    stamp("change norms")
    sync(device)
    setup_s = time.perf_counter() - t0
    launches0 = counts.launch_counts()
    recorder = counts.LaunchRecorder(traced)
    with trace.profiled(traced) as prof:
        n_steps, window_s = window(lambda i: step(n_check + i), seconds, device)
    recorder.close()
    hooks.remove()
    launches = {k: v - launches0.get(k, 0) for k, v in counts.launch_counts().items()}
    info = device_info(device, cell["chips"])
    metrics, breakdown = {}, None
    if traced:
        summary = trace.summarize(prof, window_s, device)
        summary.update(kind="train", steps=n_steps, calls=n_steps, batch=B, launches=launches,
                       records=recorder.records,
                       flops_per_call=counts.training_flops(m, traffic),
                       peak_flops=counts.PEAK_BF16)
        trace.report_launch_mismatch(summary)
        metrics = read_metrics(per_layer, summary)
        info.update(busy_s=summary["busy_s"], window_s=window_s)
        breakdown = summary["breakdown"]
    else:
        metrics = {"train_samples_per_s": {"value": n_steps * B / window_s, "unit": "samples/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        metrics = {k: v for k, v in metrics.items() if k in {e["name"] for e in e2e}}
    del trainer, model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = check.training(cfgdoc, traffic, seed, losses, grad_norms, change_norms,
                            device, limits_of(cell["name"]))
    print(f"checked {len(losses)} training steps in {time.perf_counter() - t_check:.1f} s",
          file=sys.stderr)
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    out = {"correct": correct, "attempted": n_steps * B, "failed": 0, "metrics": metrics,
           "device": info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out
