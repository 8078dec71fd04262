"""Seeded-violation fixtures for ``repro_torch.analysis --self-check``.

Every ``*_case.py`` here is *parsed, never imported*: each marked line is a
deliberate invariant violation its rule must report (``# expect[RULE]``),
next to clean idioms the rule must stay silent on and one
``# repro: allow[RULE]`` line proving suppression works. ``atomics_case.cu``
does the same for the CUDA sources (``// expect[DET]``). The engine's tree
walk excludes this whole package, so the fixtures never pollute a real run.
"""
