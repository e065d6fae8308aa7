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
  --backend         filter engine: cuda (batch NFA on the GPU)
  --stats           print lines/sec, matched %, batch-latency summary
  --cluster         cluster backend: kube | fake (hermetic demo)

The sources, the remote filter service and the observability flags of
the JAX CLI are not ported yet.
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
    stats: bool = False
    cluster: str = "kube"
    watch_new: bool = False
    output: str = "files"
    previous: bool = False
    timestamps: bool = False
    format: str = "text"
    since_time: str = ""


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
    p.add_argument("--backend", choices=["cuda"], default="cuda",
                   help="Line-filter engine: batch NFA on the GPU")
    p.add_argument("--stats", action="store_true",
                   help="Print lines/sec, matched %%, and batch-latency summary")
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
        stats=ns.stats,
        cluster=ns.cluster,
        watch_new=ns.watch_new,
        output=ns.output,
        previous=ns.previous,
        timestamps=ns.timestamps,
        format=ns.format,
        since_time=ns.since_time,
    )


def check_options(opts: Options) -> "str | None":
    """The message of the first statically invalid flag combination, or
    None; rejected before any cluster work, as the JAX CLI does."""
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
    from klogs_tpu_torch.ui.interactive import NotInteractive

    try:
        return run(opts, device=device)
    except term.FatalError:
        return 1
    except (ClusterError, NotInteractive) as e:
        # One line for control-plane failures (401/403, an unreachable
        # apiserver) and a picker without a terminal.
        term.error("%s", e)
        return 1
    except KeyboardInterrupt:
        return 130


if __name__ == "__main__":
    sys.exit(main())
