"""Port of ``repro.core``: the baseline slice (Algorithms 1-3, Eq. 5/6)."""
