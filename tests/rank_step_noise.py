"""How far `chip_smoke.py` phase 12 (c)'s two train steps on 2 ranks land
from one process's, against the gate's bound (not a test: it needs a CUDA
card, about 6 minutes).

    python tests/rank_step_noise.py [--repeats 4] [--rank_runs 4] [--out rank_step_noise.json]

Phase 12 (c) holds the loss and grad norm of Trainer step i to
NOISE_FACTOR x step i's run-to-run gap plus a floor (`chip_smoke.step_bounds`:
the largest gap between one process's three runs of the two steps).
Training scatters its mesh voxels with `index_add_` atomics in one process
and in index order on a mesh, so each run of either differs. This runs, on
`Config()` at phase 6's batch and phase 12 (c)'s draws:

  * `--repeats` times in this process: `chip_smoke.one_process_references`
    (two Trainer steps with the kernels, and twice with the plain versions:
    each step's plain-vs-plain gap, and the gate's bounds);
  * `--rank_runs` times: two spawned ranks sharing the card under gloo,
    each `chip_smoke.rank_training`.

It prints every run's losses and grad norms, each step's gaps, and for
every (ranks, one process) pair whether phase 12 (c)'s loss and norm gates
hold; the same as JSON to `--out`.
"""

import argparse
import json
import multiprocessing
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def rel(a, b):
    return abs(a - b) / abs(b)


def train_rank(rank: int, world: int, init_file: str, out: str) -> None:
    """One spawned rank: its mesh under gloo and chip_smoke.rank_training;
    the losses and grad norms to out/rank<r>.json."""
    from morphablediffusion_torch.parallel import close_mesh, create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = create_mesh("gloo", "cuda", rank=rank, world=world, init_method=f"file://{init_file}")
    try:
        res = chip_smoke.rank_training(mesh)
        Path(out, f"rank{rank}.json").write_text(json.dumps(
            {k: res[k] for k in ("train_loss", "grad_norm")}))
    finally:
        close_mesh(mesh)


def rank_run(tmp: Path):
    """Two spawned ranks of rank_training; rank 0's losses and grad norms."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=train_rank, args=(r, chip_smoke.PAR_RANKS, str(tmp / "init"),
                                                  str(tmp)))
             for r in range(chip_smoke.PAR_RANKS)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(chip_smoke.PAR_TIMEOUT)
        if p.is_alive():
            p.kill()
            p.join()
    if any(p.exitcode != 0 for p in procs):
        raise SystemExit(f"a rank failed: {[p.exitcode for p in procs]}")
    return json.loads((tmp / "rank0.json").read_text())


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--repeats", type=int, default=4)
    ap.add_argument("--rank_runs", type=int, default=4)
    ap.add_argument("--out", default="rank_step_noise.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("rank_step_noise: no CUDA device is available")
    from morphablediffusion_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    _cuda.build(chip_smoke.all_kernels())
    print(chip_smoke.card_line(), flush=True)

    ones, plains = [], []
    for i in range(args.repeats):
        t0 = time.perf_counter()
        ref = chip_smoke.one_process_references(device)
        pair = [dict(train_loss=loss, grad_norm=norm)
                for loss, norm in (ref["plain_steps"], ref["plain_steps_r"])]
        one = dict(train_loss=ref["train_loss"], grad_norm=ref["grad_norm"])
        one["plain_vs_plain"] = {k: [rel(a, b) for a, b in zip(pair[1][k], pair[0][k])]
                                 for k in ("train_loss", "grad_norm")}
        one["loss_bound"], one["norm_bound"] = chip_smoke.step_bounds(ref)
        ones.append(one)
        plains += pair
        print(f"one process {i}: losses {one['train_loss']}, grad norms {one['grad_norm']}; "
              f"bounds by step loss {one['loss_bound']}, norm {one['norm_bound']}; plain vs "
              f"plain, two steps: {one['plain_vs_plain']} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    ranks = []
    for i in range(args.rank_runs):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="rank_step_noise_") as tmp:
            ranks.append(rank_run(Path(tmp)))
        print(f"2 ranks {i}: losses {ranks[-1]['train_loss']}, grad norms "
              f"{ranks[-1]['grad_norm']} ({time.perf_counter() - t0:.1f} s)", flush=True)

    def gaps(a, b):
        return {k: [rel(x, y) for x, y in zip(a[k], b[k])] for k in ("train_loss", "grad_norm")}

    one_vs_one = [gaps(a, b) for i, a in enumerate(ones) for b in ones[i + 1:]]
    pairs, fails = [], [0, 0]
    for i, r in enumerate(ranks):
        for j, one in enumerate(ones):
            g = gaps(r, one)
            held = [g["train_loss"][s] <= one["loss_bound"][s]
                    and g["grad_norm"][s] <= one["norm_bound"][s] for s in range(2)]
            fails = [f + (not h) for f, h in zip(fails, held)]
            pairs.append(dict(ranks=i, one=j, gaps=g, held=held))
            print(f"ranks {i} vs one process {j}: loss gaps {g['train_loss']} (bounds "
                  f"{one['loss_bound']}), norm gaps {g['grad_norm']} (bounds "
                  f"{one['norm_bound']}); gate held at steps 1, 2: {held}", flush=True)
    for k in ("train_loss", "grad_norm"):
        for s in range(2):
            print(f"{k} step {s + 1}: one process vs one process max "
                  f"{max(g[k][s] for g in one_vs_one):.3e}; plain vs plain max "
                  f"{max(o['plain_vs_plain'][k][s] for o in ones):.3e}; ranks vs one process "
                  f"max {max(p['gaps'][k][s] for p in pairs):.3e}", flush=True)
    print(f"pairs failing phase 12 (c)'s gate at steps 1, 2: {fails} of {len(pairs)}", flush=True)
    Path(args.out).write_text(json.dumps(dict(card=chip_smoke.card_line(), one_process=ones,
                                              plain=plains, ranks=ranks, pairs=pairs,
                                              one_vs_one=one_vs_one, fails=fails), indent=1))


if __name__ == "__main__":
    main()
