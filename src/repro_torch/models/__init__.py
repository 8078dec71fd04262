"""The LM serving path's model code (port of ``repro.models``, dense
attention-only family)."""
