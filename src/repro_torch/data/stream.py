"""Host data layout shared by the distributed engine and (later) the host
streams: copy of ``repro.data.stream.padded_rows``.

The sources, ``BlockStream``, ``prefetch`` and ``stage_to_device`` come
with host streaming (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations


def padded_rows(n: int, mult: int) -> int:
    """Padded leading dim: the next multiple of ``mult`` >= max(n, 1), the
    single source of the padded n that ``core.distributed.pad_and_shard``
    builds.  n = 0 still yields one full multiple (an all-padding block)
    rather than empty arrays."""
    return max(n + (-n) % mult, mult)
