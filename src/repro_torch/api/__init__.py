"""Public API: one declarative ``PipelineSpec`` + ``PDFSession`` runner.

    from repro_torch.api import PipelineSpec, MethodSpec, PDFSession

    spec = PipelineSpec(method=MethodSpec(name="grouping_ml"))
    for result in PDFSession(spec).run(slices=[0, 1]):
        print(result.slice_i, result.avg_error)

Port of ``repro.api``. Specs round-trip through JSON (``to_json``/
``from_json``, the reference's format), carry a stable content hash
(``content_hash``) stamped into persisted watermarks and result-cache
entries, and generate the CLI surface of every launcher (``api.cli``). A
session runs on ``cuda`` unless the caller passes ``device="cpu"``. See
DESIGN.md §API.
"""

from repro_torch.api.cache import ResultCache
from repro_torch.api.cli import add_spec_args, explicit_fields, spec_from_args
from repro_torch.api.session import PDFSession, SessionReport
from repro_torch.api.spec import (
    HASH_IMPL,
    SPEC_VERSION,
    ComputeSpec,
    ExecSpec,
    MethodSpec,
    PipelineSpec,
    PlacementSpec,
    ServeSpec,
    SourceSpec,
    StreamSpec,
    TreeSpec,
    build_source,
    source_spec_for,
    spec_from_config,
)

__all__ = [
    "HASH_IMPL",
    "SPEC_VERSION",
    "ComputeSpec",
    "ExecSpec",
    "MethodSpec",
    "PDFSession",
    "PipelineSpec",
    "PlacementSpec",
    "ResultCache",
    "ServeSpec",
    "SessionReport",
    "SourceSpec",
    "StreamSpec",
    "TreeSpec",
    "add_spec_args",
    "build_source",
    "explicit_fields",
    "source_spec_for",
    "spec_from_args",
    "spec_from_config",
]
