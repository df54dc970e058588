"""One module per kind of cell, `cells/<kind>.py`, found by the `kind` of
the cell's traffic file (`spec.cell_kind`). Each gives `run(cell, seed,
seconds, trace, device, wrap=None)`, which runs the cell once on `device`
and returns the result's dict with its `check` key last (`run.py` prints
it)."""
