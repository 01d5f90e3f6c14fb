"""Host-side fan-out for offline preprocessing.

The PyTorch port's own copy of the JAX package's `preprocessing/fanout.py`
(its local pool starts its workers with `spawn`).

The reference chunks subjects across MPI ranks (process_all_mpi.py,
render_batch_mpi.py). Same contract here, with a fallback to a local
process pool when mpi4py is absent: every rank/worker takes the strided
slice `items[rank::size]` and runs the per-item command.

Usage (MPI):
    mpirun -n 16 python -m morphablediffusion_torch.preprocessing.fanout \
        --list subjects.txt -- \
        python -m morphablediffusion_torch.preprocessing.facescape_process \
        --dir_in {item} --dir_out out/{item}

Usage (local pool):
    python -m morphablediffusion_torch.preprocessing.fanout --workers 8 ...
"""

from __future__ import annotations

import argparse
import multiprocessing
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path


def _run_item(cmd_template, item):
    cmd = [tok.replace("{item}", item) for tok in cmd_template]
    print(f"[fanout] {' '.join(cmd)}", flush=True)
    return subprocess.call(cmd)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" not in argv:
        print("usage: fanout [--list F|--items a b c] [--workers N] -- CMD "
              "(use {item} as the placeholder)", file=sys.stderr)
        return 2
    split = argv.index("--")
    p = argparse.ArgumentParser()
    p.add_argument("--list", type=Path, help="file with one item per line")
    p.add_argument("--items", nargs="*", default=None)
    p.add_argument("--workers", type=int, default=1,
                   help="local pool size (ignored under MPI)")
    args = p.parse_args(argv[:split])
    cmd_template = argv[split + 1 :]

    items = args.items or [
        ln.strip() for ln in args.list.read_text().splitlines() if ln.strip()
    ]

    try:
        from mpi4py import MPI  # noqa: PLC0415

        comm = MPI.COMM_WORLD
        rank, size = comm.Get_rank(), comm.Get_size()
        mine = items[rank::size]
        rc = 0
        for item in mine:
            rc |= _run_item(cmd_template, item)
        return rc
    except ImportError:
        pass

    if args.workers <= 1:
        rc = 0
        for item in items:
            rc |= _run_item(cmd_template, item)
        return rc
    with ProcessPoolExecutor(args.workers,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        rcs = list(pool.map(_run_item, [cmd_template] * len(items), items))
    return max(rcs) if rcs else 0


if __name__ == "__main__":
    sys.exit(main())
