"""Lie-point-symmetry augmentation of NS windows (``lie.py``)."""
