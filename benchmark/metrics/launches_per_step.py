"""Device kernels launched a step in the profiled segment."""


def read(record):
    t = record.traced
    if not t or not t["kernels"]:
        return None
    return t["kernels"] / t["steps"]
