"""Deprecated alias: ``repro_torch.launch.serve`` is ``serve_decode``.

As in the reference, "serve" used to name the batched LM prefill + decode
demo, which lives at ``repro_torch.launch.serve_decode`` now that the
pipeline has a serving surface of its own (``repro_torch.launch.serve_pdf``
driving ``repro_torch.serve.PDFServer``). This shim keeps old imports and
``python -m repro_torch.launch.serve`` working.
"""

from __future__ import annotations

import warnings

from repro_torch.launch.serve_decode import *  # noqa: F401,F403
from repro_torch.launch.serve_decode import generate, main  # noqa: F401

warnings.warn(
    "repro_torch.launch.serve has been renamed to repro_torch.launch.serve_decode "
    "(the LM decode demo); 'serve' now refers to the PDF query server — "
    "see repro_torch.launch.serve_pdf and repro_torch.serve.PDFServer",
    DeprecationWarning,
    stacklevel=2,
)

if __name__ == "__main__":
    main()
