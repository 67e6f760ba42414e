"""Species stage iterations a window step (BiCGSTAB iterations on
block-RAS, refinements on the dense tier, both stages and both species):
the count ``species_step(_reuse)`` returns."""


def read(record):
    if not record.species_its:
        return None
    return sum(record.species_its) / len(record.species_its)
