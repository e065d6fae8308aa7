"""CLI flag surface of the port (the non-follow path).

Counterpart of ``klogs_tpu/cli.py``. The flags keep the JAX CLI's names,
shorthands, defaults and meaning:

  -n/--namespace    select namespace ("" -> the context's namespace)
  -l/--label        repeatable; union of per-label results
  -p/--logpath      default ``logs/<YYYY-MM-DDTHH-MM>``
  -a/--all          every Ready pod in the namespace
  -s/--since        Go duration; server-side SinceSeconds
  -t/--tail         default -1 = unlimited
  -i/--init         include init containers
  -c/--container    only containers whose name matches this regex
  -E/--exclude-container  drop containers whose name matches this regex
  --match           repeatable regex; only matching lines are written
  --exclude         repeatable regex; drop matching lines
  -I/--ignore-case  case-insensitive --match/--exclude patterns
  --backend         filter engine: cuda (batch NFA on the GPU)
  --stats           print lines/sec, matched %, batch-latency summary
  --cluster         cluster backend: kube | fake (hermetic demo)

Follow mode, the interactive pickers, the kube backend and the other
JAX CLI options are not ported yet.
"""

import argparse
import re
import sys
from dataclasses import dataclass, field

from klogs_tpu_torch.ui import term
from klogs_tpu_torch.utils.naming import default_log_path


@dataclass
class Options:
    namespace: str = ""
    labels: list[str] = field(default_factory=list)
    log_path: str = ""
    all_pods: bool = False
    since: str = ""
    tail: int = -1
    init_containers: bool = False
    container: str = ""
    exclude_container: str = ""
    match: list[str] = field(default_factory=list)
    exclude: list[str] = field(default_factory=list)
    ignore_case: bool = False
    backend: str = "cuda"
    stats: bool = False
    cluster: str = "kube"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="klogs-torch",
        description="Get logs from Kubernetes Pods, filtered on the GPU.")
    p.add_argument("-n", "--namespace", default="", help="Select namespace")
    p.add_argument("-l", "--label", action="append", default=[],
                   dest="labels", help="Select label")
    p.add_argument("-p", "--logpath", default=None, dest="log_path",
                   help="Custom log path")
    p.add_argument("-a", "--all", action="store_true", dest="all_pods",
                   help="Get logs for all pods in the namespace")
    p.add_argument("-s", "--since", default="",
                   help="Only return logs newer than a relative duration "
                   "like 5s, 2m, or 3h. Defaults to all logs.")
    p.add_argument("-t", "--tail", type=int, default=-1,
                   help="Lines of the most recent log to save")
    p.add_argument("-i", "--init", action="store_true",
                   dest="init_containers", help="Get logs for init containers")
    p.add_argument("-c", "--container", default="", metavar="REGEX",
                   help="Only stream containers whose name matches this regex")
    p.add_argument("-E", "--exclude-container", default="",
                   dest="exclude_container", metavar="REGEX",
                   help="Drop containers whose name matches this regex")
    p.add_argument("--match", action="append", default=[],
                   help="Only save log lines matching this regex (repeatable; "
                   "a line is kept if ANY pattern matches)")
    p.add_argument("--exclude", action="append", default=[], metavar="REGEX",
                   help="Drop lines matching this pattern even when --match "
                   "keeps them (repeatable; alone = keep everything EXCEPT "
                   "matches)")
    p.add_argument("-I", "--ignore-case", action="store_true",
                   dest="ignore_case",
                   help="Case-insensitive --match/--exclude patterns")
    p.add_argument("--backend", choices=["cuda"], default="cuda",
                   help="Line-filter engine: batch NFA on the GPU")
    p.add_argument("--stats", action="store_true",
                   help="Print lines/sec, matched %%, and batch-latency summary")
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
        all_pods=ns.all_pods,
        since=ns.since,
        tail=ns.tail,
        init_containers=ns.init_containers,
        container=ns.container,
        exclude_container=ns.exclude_container,
        match=list(ns.match),
        exclude=list(ns.exclude),
        ignore_case=ns.ignore_case,
        backend=ns.backend,
        stats=ns.stats,
        cluster=ns.cluster,
    )


def main(argv: list[str] | None = None, device=None) -> int:
    """Process entry point. ``device=None`` means ``"cuda"``."""
    opts = parse_args(argv)
    for flag, pat in (("-c/--container", opts.container),
                      ("-E/--exclude-container", opts.exclude_container)):
        if pat:
            try:
                re.compile(pat)
            except re.error as e:
                term.error("invalid %s pattern %r: %s", flag, pat, e)
                return 1

    from klogs_tpu_torch.app import run
    from klogs_tpu_torch.cluster.backend import ClusterError

    try:
        return run(opts, device=device)
    except term.FatalError:
        return 1
    except ClusterError as e:
        term.error("%s", e)
        return 1
    except KeyboardInterrupt:
        return 130


if __name__ == "__main__":
    sys.exit(main())
