"""Proving across processes: chained continuation segments (`segments.py`),
the row-sharded prover on torch.distributed (`sharded.py`) and the
column-sharded building blocks (`mesh.py`)."""
