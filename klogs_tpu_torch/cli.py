"""CLI flag surface of the port.

Counterpart of ``klogs_tpu/cli.py``. The flags keep the JAX CLI's names,
shorthands, defaults, choices and checks:

  -n/--namespace    select namespace ("" -> the context's namespace)
  -l/--label        repeatable; union of per-label results
  -p/--logpath      default ``logs/<YYYY-MM-DDTHH-MM>``
  --kubeconfig      default: $KUBECONFIG, else ``~/.kube/config``, else
                    the in-cluster service account
  -a/--all          every Ready pod (else the interactive pod picker)
  -s/--since        Go duration; server-side SinceSeconds
  -t/--tail         default -1 = unlimited
  -f/--follow       stream until q (on /dev/tty) or Ctrl-C
  -v/--version      print the version, exit 0
  -i/--init         include init containers
  -c/--container    only containers whose name matches this regex
  -E/--exclude-container  drop containers whose name matches this regex
  --match           repeatable regex; only matching lines are written
  --exclude         repeatable regex; drop matching lines
  -I/--ignore-case  case-insensitive --match/--exclude patterns
  --watch-new       with -f and -a/-l: stream pods created mid-follow
  -o/--output       files | stdout (prefixed console stream) | both
  --format          console format: text | json
  --previous        logs of the previous terminated container instance
  --since-time      only logs after an absolute RFC3339 time
  --timestamps      server-side RFC3339 timestamp before each line
  --backend         filter engine: cuda (batch NFA on the GPU, the
                    default) | cpu (the host engines: indexed, DFA,
                    combined re, re; never touches the card)
  --remote          filter through remote filterd service(s) (HOST:PORT;
                    the port's ``python -m klogs_tpu_torch.service`` or
                    the JAX package's) instead of an in-process engine:
                    the collector then builds no engine and needs no
                    card. A comma-separated list shards batches across
                    the fleet with per-endpoint breakers, hedged
                    dispatch and /readyz-driven drain
  --shard-mode      multi-endpoint --remote routing: round-robin
                    (rotate per batch) | hash (pin by pattern-set
                    fingerprint on a consistent-hash ring)
  --resolver        live fleet membership for --remote: KIND:SPEC
                    (static:HOST:PORT[,...] | file:/path | dns:HOST:PORT
                    | kube:NAMESPACE/NAME[:PORT]); polled on
                    KLOGS_RESOLVER_INTERVAL_S, joiners verified before
                    their first batch
  --on-filter-error with --remote: what a batch gets while the service
                    stays unavailable: pass | drop | abort (default)
  --stats           print lines/sec, matched %, batch-latency summary
  --metrics-port    serve Prometheus /metrics + /healthz (and /readyz,
                    /traces, /profile) for this run
  --stats-json      one-shot JSON metrics dump at exit
  --trace-json      per-batch trace spans as JSON lines (tracing +
                    flight recorder)
  --profile-json    continuous pipeline utilization profiler: one JSON
                    snapshot per tick (per-stage busy-seconds and
                    utilization, queue/in-flight samples); same doc as
                    /profile on --metrics-port
  --profile         write a torch.profiler trace of the run to DIR
  --cluster         cluster backend: kube | fake (hermetic demo)
  --source          non-kube log source: replay:PATH[,PATH...] streams
                    local files/dirs/globs with rotation handling;
                    socket:HOST:PORT or socket:unix:/path.sock listens
                    for newline-delimited ingest (requires -f)
  --backfill        archive backfill: read rotated/gzip/zstd logs under
                    the given paths through the filter to completion,
                    then exit with match/shed accounting (incompatible
                    with -f and --source)
  --replay-rate     pace replay at N lines/s (default: as fast as the
                    disk goes; KLOGS_REPLAY_RATE sets a default)
"""

import argparse
import re
import sys
from dataclasses import dataclass, field
from datetime import datetime

from klogs_tpu_torch.ui import term
from klogs_tpu_torch.utils.naming import default_log_path
from klogs_tpu_torch.version import BUILD_VERSION


@dataclass
class Options:
    namespace: str = ""
    labels: list[str] = field(default_factory=list)
    log_path: str = ""
    kubeconfig: str = ""
    all_pods: bool = False
    since: str = ""
    tail: int = -1
    follow: bool = False
    print_version: bool = False
    init_containers: bool = False
    container: str = ""
    exclude_container: str = ""
    match: list[str] = field(default_factory=list)
    exclude: list[str] = field(default_factory=list)
    ignore_case: bool = False
    backend: str = "cuda"
    remote: str | None = None
    shard_mode: str = "round-robin"
    resolver: str | None = None
    on_filter_error: str = "abort"
    stats: bool = False
    cluster: str = "kube"
    watch_new: bool = False
    output: str = "files"
    previous: bool = False
    timestamps: bool = False
    format: str = "text"
    since_time: str = ""
    source: str = ""
    backfill: list[str] = field(default_factory=list)
    replay_rate: float | None = None
    metrics_port: int | None = None
    stats_json: str | None = None
    trace_json: str | None = None
    profile_json: str | None = None
    profile: str | None = None


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="klogs-torch",
        description="Get logs from Kubernetes Pods, filtered on the GPU.")
    p.add_argument("-n", "--namespace", default="", help="Select namespace")
    p.add_argument("-l", "--label", action="append", default=[],
                   dest="labels", help="Select label")
    p.add_argument("-p", "--logpath", default=None, dest="log_path",
                   help="Custom log path")
    p.add_argument("--kubeconfig", default="",
                   help="(optional) Absolute path to the kubeconfig file")
    p.add_argument("-a", "--all", action="store_true", dest="all_pods",
                   help="Get logs for all pods in the namespace")
    p.add_argument("-s", "--since", default="",
                   help="Only return logs newer than a relative duration "
                   "like 5s, 2m, or 3h. Defaults to all logs.")
    p.add_argument("-t", "--tail", type=int, default=-1,
                   help="Lines of the most recent log to save")
    p.add_argument("-f", "--follow", action="store_true",
                   help="Specify if the logs should be streamed")
    p.add_argument("-v", "--version", action="store_true",
                   dest="print_version", help="Print the version of the tool")
    p.add_argument("-i", "--init", action="store_true",
                   dest="init_containers", help="Get logs for init containers")
    p.add_argument("--match", action="append", default=[],
                   help="Only save log lines matching this regex (repeatable; "
                   "a line is kept if ANY pattern matches)")
    p.add_argument("-I", "--ignore-case", action="store_true",
                   dest="ignore_case",
                   help="Case-insensitive --match/--exclude patterns")
    p.add_argument("--backend", choices=["cuda", "cpu"], default="cuda",
                   help="Line-filter engine: batch NFA on the GPU (cuda) "
                   "or the host engines (cpu: indexed, DFA, combined "
                   "re, re)")
    p.add_argument("--remote", default=None,
                   metavar="HOST:PORT[,HOST:PORT...]",
                   help="Filter via remote klogs-filterd service(s) "
                   "(python -m klogs_tpu_torch.service, or the JAX "
                   "package's) instead of an in-process engine. A "
                   "comma-separated list shards batches across the fleet "
                   "(--shard-mode) with per-endpoint circuit breakers, "
                   "hedged dispatch, and /readyz-driven drain: one dead "
                   "or draining server is routed around, not an outage")
    p.add_argument("--shard-mode", choices=["round-robin", "hash"],
                   default="round-robin", dest="shard_mode",
                   help="With a multi-endpoint --remote list: rotate "
                   "batches across the fleet (round-robin) or pin this "
                   "collector's pattern-set fingerprint to one owner on "
                   "a consistent-hash ring (hash; keys move minimally "
                   "when an endpoint dies)")
    p.add_argument("--resolver", default=None, metavar="KIND:SPEC",
                   help="Live fleet membership for the filterd tier: "
                   "static:HOST:PORT[,...], file:/path (one endpoint per "
                   "line, re-read each poll), dns:HOST:PORT (re-resolve "
                   "every A/AAAA record), or kube:NAMESPACE/NAME[:PORT] "
                   "(watch an Endpoints object). Joining endpoints pass "
                   "the pattern-set handshake before their first batch; "
                   "--remote (optional with this flag) is only the "
                   "initial seed")
    p.add_argument("--on-filter-error", choices=["pass", "drop", "abort"],
                   default="abort", dest="on_filter_error",
                   help="With --match/--exclude: how sinks degrade when the "
                   "filter service stays unavailable (retries exhausted, "
                   "circuit breaker open): write lines UNFILTERED (pass), "
                   "discard them (drop), or end the run with one clear "
                   "error (abort, default)")
    p.add_argument("--stats", action="store_true",
                   help="Print lines/sec, matched %%, and batch-latency summary")
    p.add_argument("--metrics-port", type=int, default=None,
                   metavar="PORT",
                   help="Serve Prometheus /metrics and /healthz for this run "
                   "on an HTTP sidecar port (0 = ephemeral; binds "
                   "127.0.0.1)")
    p.add_argument("--stats-json", default=None, dest="stats_json",
                   metavar="PATH",
                   help="Write a one-shot JSON dump of all pipeline metrics "
                   "to PATH at exit (the scrapeless option for batch runs)")
    p.add_argument("--trace-json", default=None, dest="trace_json",
                   metavar="PATH",
                   help="Write every finished trace span as one JSON line "
                   "to PATH (batch tracing across fanout/coalescer/device/"
                   "sink; implies KLOGS_TRACE_SAMPLE=1 unless that variable "
                   "is set). The same spans serve /traces on --metrics-port "
                   "and feed the degrade flight recorder")
    p.add_argument("--profile-json", default=None, dest="profile_json",
                   metavar="PATH",
                   help="Continuous pipeline utilization profiling: append "
                   "one JSON snapshot per tick (per-stage busy-seconds and "
                   "rolling utilization folded from trace spans, plus "
                   "queue-depth/in-flight/executor samples) to PATH. The "
                   "same snapshot serves /profile on the --metrics-port "
                   "sidecar; KLOGS_PROFILE_SAMPLE pins the span-sampling "
                   "rate (0 disables)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="Write a torch.profiler trace of the run to DIR "
                   "(the card's CUDA activity; CPU activity too when the "
                   "filter runs on the CPU); open it in Perfetto or "
                   "chrome://tracing")
    p.add_argument("-o", "--output", choices=["files", "stdout", "both"],
                   default="files",
                   help="Where log lines go: per-container files (reference "
                   "behavior), a pod/container-prefixed stdout stream "
                   "(stern-style), or both")
    p.add_argument("--format", choices=["text", "json"], default="text",
                   help="Console stream format with -o stdout|both: prefixed "
                   "text lines or one JSON object per line ({pod, container, "
                   "line})")
    p.add_argument("-c", "--container", default="", metavar="REGEX",
                   help="Only stream containers whose name matches this regex")
    p.add_argument("-E", "--exclude-container", default="",
                   dest="exclude_container", metavar="REGEX",
                   help="Drop containers whose name matches this regex")
    p.add_argument("--previous", action="store_true",
                   help="Get logs of the PREVIOUS terminated container "
                   "instance (kubectl logs -p); incompatible with -f")
    p.add_argument("--since-time", default="", dest="since_time",
                   metavar="RFC3339",
                   help="Only return logs after an absolute time, e.g. "
                   "2026-07-31T06:00:00Z (kubectl logs --since-time; "
                   "mutually exclusive with -s/--since)")
    p.add_argument("--timestamps", action="store_true",
                   help="Prefix each log line with its server-side RFC3339 "
                   "timestamp (kubectl logs --timestamps)")
    p.add_argument("--exclude", action="append", default=[], metavar="REGEX",
                   help="Drop lines matching this pattern even when --match "
                   "keeps them (repeatable; alone = keep everything EXCEPT "
                   "matches)")
    p.add_argument("--watch-new", action="store_true", dest="watch_new",
                   help="With -f and -a/-l: keep watching for NEW pods "
                   "matching the selection and stream them as they appear")
    p.add_argument("--cluster", choices=["kube", "fake"], default="kube",
                   help="Cluster backend: real Kubernetes API or hermetic "
                   "fake (demo/test)")
    p.add_argument("--source", default="", metavar="SPEC",
                   help="Non-kube log source: replay:PATH[,PATH...] (local "
                   "files/dirs/globs with rotation handling) or "
                   "socket:HOST:PORT / socket:unix:/path.sock "
                   "(newline-delimited listener, needs -f)")
    p.add_argument("--backfill", nargs="+", default=[], metavar="PATH",
                   help="Read rotated/gzip/zstd archives under PATH(s) "
                   "through the full pipeline to completion, then exit "
                   "with match/shed accounting (incompatible with -f and "
                   "--source)")
    p.add_argument("--replay-rate", type=float, default=None,
                   dest="replay_rate", metavar="LPS",
                   help="Pace a replay source at LPS lines/s (default: "
                   "unpaced; KLOGS_REPLAY_RATE sets a default)")
    return p


def parse_args(argv: list[str] | None = None) -> Options:
    ns = build_parser().parse_args(argv)
    return Options(
        namespace=ns.namespace,
        labels=list(ns.labels),
        log_path=ns.log_path if ns.log_path is not None else default_log_path(),
        kubeconfig=ns.kubeconfig,
        all_pods=ns.all_pods,
        since=ns.since,
        tail=ns.tail,
        follow=ns.follow,
        print_version=ns.print_version,
        init_containers=ns.init_containers,
        container=ns.container,
        exclude_container=ns.exclude_container,
        match=list(ns.match),
        exclude=list(ns.exclude),
        ignore_case=ns.ignore_case,
        backend=ns.backend,
        remote=ns.remote,
        shard_mode=ns.shard_mode,
        resolver=ns.resolver,
        on_filter_error=ns.on_filter_error,
        stats=ns.stats,
        cluster=ns.cluster,
        watch_new=ns.watch_new,
        output=ns.output,
        previous=ns.previous,
        timestamps=ns.timestamps,
        format=ns.format,
        since_time=ns.since_time,
        source=ns.source,
        backfill=list(ns.backfill),
        replay_rate=ns.replay_rate,
        metrics_port=ns.metrics_port,
        stats_json=ns.stats_json,
        trace_json=ns.trace_json,
        profile_json=ns.profile_json,
        profile=ns.profile,
    )


def check_options(opts: Options) -> "str | None":
    """The message of the first statically invalid flag combination, or
    None; rejected before any cluster work, as the JAX CLI does. A flag
    that does not apply (``--replay-rate`` without a replay source)
    warns and is ignored."""
    if opts.previous and opts.follow:
        return ("--previous is incompatible with -f/--follow "
                "(a terminated instance cannot stream)")
    if opts.since and opts.since_time:
        return ("at most one of -s/--since and --since-time may be "
                "given (kubectl parity)")
    if opts.since_time:
        try:
            dt = datetime.fromisoformat(opts.since_time.replace("Z", "+00:00"))
        except ValueError:
            dt = None
        # fromisoformat also takes date-only and zone-less forms, which
        # are not RFC3339 (a naive cutoff would be read in local time).
        if dt is None or dt.tzinfo is None:
            return (f"invalid --since-time {opts.since_time!r} (want RFC3339 "
                    "with a timezone, e.g. 2026-07-31T06:00:00Z)")
    if opts.source and opts.backfill:
        return ("--source and --backfill are mutually exclusive "
                "(backfill IS a source)")
    if opts.backfill and opts.follow:
        return ("--backfill is a run-to-completion mode and cannot "
                "be combined with -f/--follow")
    if opts.source:
        if not opts.source.startswith(("replay:", "socket:")):
            return (f"invalid --source {opts.source!r}: expected "
                    "replay:PATH[,PATH...], socket:HOST:PORT, or "
                    "socket:unix:/path.sock")
        if opts.source.startswith("socket:") and not opts.follow:
            return ("--source socket: is a live listener and "
                    "requires -f/--follow")
    if opts.replay_rate is not None:
        if opts.replay_rate <= 0:
            return "--replay-rate must be a positive lines/s value"
        if not opts.source.startswith("replay:"):
            term.warning("--replay-rate only applies to a replay "
                         "source; ignoring")
    if opts.resolver is not None:
        from klogs_tpu_torch.service.resolver import split_spec

        try:
            split_spec(opts.resolver)
        except ValueError as e:
            return str(e)
        if not opts.match and not opts.exclude:
            term.warning("--resolver without --match/--exclude builds "
                         "no filter pipeline; ignoring")
    if opts.shard_mode != "round-robin" and opts.resolver is None and (
            opts.remote is None or "," not in opts.remote):
        # One endpoint is the plain client, below the routing layer.
        term.warning("--shard-mode only applies with a multi-endpoint "
                     "--remote list; ignoring")
    for flag, pat in (("-c/--container", opts.container),
                      ("-E/--exclude-container", opts.exclude_container)):
        if pat:
            try:
                re.compile(pat)
            except re.error as e:
                return f"invalid {flag} pattern {pat!r}: {e}"
    return None


def main(argv: list[str] | None = None, device=None) -> int:
    """Process entry point. ``device=None`` means ``"cuda"``."""
    opts = parse_args(argv)
    if opts.print_version:
        term.info("Version: %s", BUILD_VERSION)
        return 0
    problem = check_options(opts)
    if problem is not None:
        term.error("%s", problem)
        return 1

    from klogs_tpu_torch.app import run
    from klogs_tpu_torch.cluster.backend import ClusterError
    from klogs_tpu_torch.sources import SourceError
    from klogs_tpu_torch.ui.interactive import NotInteractive

    try:
        return run(opts, device=device)
    except term.FatalError:
        return 1
    except (ClusterError, SourceError, NotInteractive) as e:
        # One line for control-plane failures (401/403, an unreachable
        # apiserver), a source that cannot be read (a damaged archive,
        # a busy listen address) and a picker without a terminal.
        term.error("%s", e)
        return 1
    except KeyboardInterrupt:
        return 130
    except Exception as e:
        # --remote: a pattern handshake mismatch or a bad transport
        # security setting, as one line.
        if not _remote_config_error(e):
            raise
        term.error("%s", e)
        return 1


def _remote_config_error(e: Exception) -> bool:
    """Whether ``e`` is the remote client's PatternMismatch or
    ServiceConfigError (grpc is imported only here, so a missing grpc
    does not hide ``e``)."""
    try:
        from klogs_tpu_torch.service.client import (
            PatternMismatch,
            ServiceConfigError,
        )
    except ImportError:
        return False
    return isinstance(e, (PatternMismatch, ServiceConfigError))


if __name__ == "__main__":
    sys.exit(main())
