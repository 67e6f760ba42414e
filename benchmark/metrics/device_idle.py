"""The device's idle share of the profiled segment, %: one less the union
of its device activity over the segment's synced wall time."""


def read(record):
    t = record.traced
    if not t or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["wall_s"])
