"""Sum of the bounds of the port's own kernels (symbols md_*) over the sum of
their device time, in %: each launch's bound from its shapes
(counts.launch_bound_s). Kernels whose trace records do not match the
launches the program counted are left out; none left, no reading."""

from h100_bench import counts


def read(s):
    if s["kind"] != "train":
        return None
    bound = busy = 0.0
    for kernel, ok in s.get("matched", {}).items():
        if not ok:
            continue
        key = counts.SYMBOLS[kernel]
        busy += sum(float(e - b) for n, b, e in zip(s["names"], s["start"], s["end"])
                    if key in n) / 1e9
        bound += sum(counts.launch_bound_s(k, a) for k, a in s["records"] if k == kernel)
    return 100.0 * bound / busy if busy > 0 else None
