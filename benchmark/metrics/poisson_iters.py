"""Poisson iterations or refinements a window step (0 on the steps that
skip the re-solve): the count ``poisson_solve`` returns."""


def read(record):
    if not record.poisson_its:
        return None
    return sum(record.poisson_its) / len(record.poisson_its)
