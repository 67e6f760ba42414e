"""Poisson re-solve, ms a window step (0 on the steps that skip it): a
synced host-clock span around the harness's call."""


def read(record):
    if not record.poisson_s:
        return None
    return 1e3 * sum(record.poisson_s) / len(record.poisson_s)
