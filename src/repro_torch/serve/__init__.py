"""``repro_torch.serve``: the long-lived PDF query server (DESIGN.md §13),
port of ``repro.serve``.

    from repro_torch.api import PipelineSpec
    from repro_torch.serve import PDFServer, PointQuery

    with PDFServer(PipelineSpec()) as server:
        ans = server.query(PointQuery(slice_i=0, line=3, point=7))
        print(ans.type_idx, ans.error)

The server owns warm per-shard executors and the lazily-trained tree for
one ``PipelineSpec``, accepts point / window / region queries through a
thread-safe queue, and coalesces whatever is pending each tick into a
single batched launch — answers are bitwise-identical to
running each query through the batch pipeline serially.
"""

from repro_torch.serve.server import (
    PDFServer,
    PointQuery,
    QueryAnswer,
    RegionQuery,
    ServerOverloadedError,
    ServerStats,
    WindowQuery,
)

__all__ = [
    "PDFServer",
    "PointQuery",
    "QueryAnswer",
    "RegionQuery",
    "ServerOverloadedError",
    "ServerStats",
    "WindowQuery",
]
