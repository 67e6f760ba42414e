"""Phase C's Poisson set-up, s: ``PnpSystem.poisson_setup_seconds`` (host
clock, device synced)."""


def read(record):
    return record.poisson_setup_s
