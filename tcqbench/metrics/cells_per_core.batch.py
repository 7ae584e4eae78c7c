"""Schedule cells peeled (``QueryStats.cells_evaluated``) per distinct core
returned: the scheduler's work per useful result."""


def read(rec):
    batches = rec.get("batches", ())
    cores = sum(b["cores"] for b in batches)
    cells = sum(b["cells_evaluated"] for b in batches)
    return cells / cores if cores else None
