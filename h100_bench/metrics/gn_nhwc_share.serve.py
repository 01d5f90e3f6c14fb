"""Share of the window's GroupNorm kernel (K4) records that ran its
channels-last design (symbol md_group_norm_kernel_nhwc), in %: the maps K4
took in place rather than after a copy to NCHW. No K4 record, no reading."""

from h100_bench import counts


def read(s):
    if s["kind"] != "serve":
        return None
    k4 = [n for n in s["names"] if counts.SYMBOLS["group_norm"] in n]
    return 100.0 * sum("md_group_norm_kernel_nhwc" in n for n in k4) / len(k4) if k4 else None
