"""Kernel 1's share of its roofline, %: over every ``kernels.gj_inverse``
call in the profiled segment, the least time the card could take for its
work (2 b n^3 flop at the f32 peak, 8 b n^2 bytes at the bandwidth;
``roofline.py``) over the device time of the kernels launched inside the
call's range, whatever kernels those are."""

import re

from benchmark import roofline


def read(record):
    t = record.traced
    if not t:
        return None
    need = spent = 0.0
    for name, seconds in t["ranges"].get("gj_inverse", []):
        m = re.search(r"b=(\d+) n=(\d+)", name)
        need += roofline.gj_inverse_min_seconds(int(m[1]), int(m[2]))
        spent += seconds
    if spent <= 0.0:
        return None
    return 100.0 * need / spent
