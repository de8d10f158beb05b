"""Proving across processes: chained continuation segments (`segments.py`)."""
