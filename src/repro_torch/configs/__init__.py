"""Architecture configs of the LM serving path (port of ``repro.configs``):
the dense attention-only models that ``models/`` runs."""
