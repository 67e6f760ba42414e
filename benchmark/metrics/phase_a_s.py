"""Phase A, the PB bootstrap, s: ``PnpSystem.pb_seconds`` (host clock,
device synced)."""


def read(record):
    return record.pb_s
