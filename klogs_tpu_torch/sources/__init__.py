"""Pluggable log sources: replay of local files, backfill of rotated
archives, a newline-delimited socket listener, and the cluster adapter.

Counterpart of ``klogs_tpu/sources/__init__.py``. Only ``base`` is
imported here; ``make_source`` imports the implementation it builds.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from klogs_tpu_torch.sources.base import (
    Source,
    SourceConfigError,
    SourceError,
    SourceMetrics,
    SourceRef,
    SourceStream,
    safe_group_name,
)

if TYPE_CHECKING:
    from klogs_tpu_torch.cli import Options

__all__ = [
    "Source",
    "SourceConfigError",
    "SourceError",
    "SourceMetrics",
    "SourceRef",
    "SourceStream",
    "make_source",
    "safe_group_name",
]


def make_source(opts: "Options") -> "Source | None":
    """The Source that ``--source``/``--backfill`` select, or None on the
    cluster path. Knobs: KLOGS_SOURCE_READAHEAD_MB (archive read-ahead),
    KLOGS_REPLAY_RATE (replay pacing, 0 = as fast as the disk goes;
    ``--replay-rate`` overrides), KLOGS_SOCKET_MAX_CONNS (the listener's
    accept cap)."""
    from klogs_tpu_torch.utils.env import nonneg_float, warn_positive_int

    backfill = getattr(opts, "backfill", None)
    spec = getattr(opts, "source", None)
    if backfill:
        from klogs_tpu_torch.sources.archive import ArchiveSource

        readahead = warn_positive_int("KLOGS_SOURCE_READAHEAD_MB", 8)
        return ArchiveSource(list(backfill), readahead_mb=readahead)
    if not spec:
        return None
    if spec.startswith("replay:"):
        from klogs_tpu_torch.sources.replay import ReplaySource

        paths = [p for p in spec[len("replay:"):].split(",") if p]
        if not paths:
            raise SourceConfigError(
                "--source replay: needs at least one path "
                "(replay:PATH[,PATH...])")
        rate = getattr(opts, "replay_rate", None)
        if rate is None:
            rate = nonneg_float("KLOGS_REPLAY_RATE", 0.0)
        return ReplaySource(paths, rate_lps=rate if rate > 0 else None)
    if spec.startswith("socket:"):
        from klogs_tpu_torch.sources.socket import SocketSource

        target = spec[len("socket:"):]
        if not target:
            raise SourceConfigError(
                "--source socket: needs a listen address "
                "(socket:HOST:PORT or socket:unix:/path.sock)")
        max_conns = warn_positive_int("KLOGS_SOCKET_MAX_CONNS", 64)
        return SocketSource(target, max_conns=max_conns)
    raise SourceConfigError(
        f"unknown --source {spec!r}: expected replay:PATH[,PATH...], "
        "socket:HOST:PORT, or socket:unix:/path.sock")
