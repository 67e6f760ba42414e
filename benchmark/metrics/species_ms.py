"""Species stages (factor on its refresh + both species' stages), ms a
window step: a synced host-clock span around the harness's call."""


def read(record):
    if not record.species_s:
        return None
    return 1e3 * sum(record.species_s) / len(record.species_s)
