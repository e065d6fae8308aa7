"""Top-level run orchestration (the non-follow path).

Counterpart of ``klogs_tpu/app.py``: splash, namespace resolution, pod
selection (label union or every Ready pod), the per-container fan-out
through the --match/--exclude filter pipeline, and the final size
table. ``run_async`` takes an injected ClusterBackend (tests pass a
FakeCluster) and the filter's ``device`` (None means ``"cuda"``).
"""

import asyncio
import os
import re

from klogs_tpu_torch.cli import Options
from klogs_tpu_torch.cluster.backend import ClusterBackend, ClusterError
from klogs_tpu_torch.cluster.types import LogOptions, PodInfo
from klogs_tpu_torch.runtime.fanout import FanoutRunner, StreamJob, plan_jobs
from klogs_tpu_torch.ui import term, widgets
from klogs_tpu_torch.utils import convert_bytes, parse_duration, split_log_file_name
from klogs_tpu_torch.utils.duration import DurationError
from klogs_tpu_torch.utils.env import read as env_read


def make_backend(opts: Options) -> ClusterBackend:
    if opts.cluster == "fake":
        from klogs_tpu_torch.cluster.fake import FakeCluster

        fc = FakeCluster.synthetic(
            n_pods=int(env_read("KLOGS_FAKE_PODS", "6")),
            n_containers=int(env_read("KLOGS_FAKE_CONTAINERS", "2")),
            lines_per_container=int(env_read("KLOGS_FAKE_LINES", "300")))
        fc.add_namespace("kube-system")
        return fc
    raise ClusterError("the kube backend is not ported yet; use --cluster fake")


async def resolve_namespace(backend: ClusterBackend, opts: Options) -> str:
    """Explicit -n, else the context's namespace; it must exist (the
    interactive namespace picker is not ported)."""
    namespace = opts.namespace
    if not namespace:
        context, namespace = backend.current_context()
        term.info("Using Context %s", term.green(context))
    if not await backend.namespace_exists(namespace):
        term.fatal("Namespace %s not found", namespace)
    term.info("Using Namespace %s", term.green(namespace))
    return namespace


async def select_pods(backend: ClusterBackend, namespace: str,
                      opts: Options) -> list[PodInfo]:
    """Label union (no dedup across labels) or every Ready pod (-a)."""
    if opts.labels:
        pods: list[PodInfo] = []
        for label in opts.labels:
            term.info("Getting Pods with label %s\n", term.green(label))
            found = await backend.list_pods(namespace, label_selector=label)
            if not found:
                term.error("No pods found in namespace %s with label %s\n",
                           namespace, label)
            pods.extend(found)
        return pods
    if not opts.all_pods:
        term.fatal("the interactive pod picker is not ported yet; pass -a "
                   "or -l")
    ready = [p for p in await backend.list_pods(namespace) if p.ready]
    if not ready:
        term.error("No pods found in namespace %s", namespace)
    return ready


def build_log_options(opts: Options) -> LogOptions:
    lo = LogOptions()
    if opts.since:
        try:
            lo.since_seconds = int(parse_duration(opts.since))
        except DurationError as e:
            term.fatal("%s", e)
    if opts.tail != -1:
        lo.tail_lines = opts.tail
    return lo


def print_plan(pods: list[PodInfo], jobs: list[StreamJob]) -> None:
    term.info("Found %s Pod(s) %s Container(s)",
              term.green(str(len(pods))), term.green(str(len(jobs))))
    jobs_by_pod: dict[str, list[StreamJob]] = {}
    for j in jobs:
        jobs_by_pod.setdefault(j.pod, []).append(j)
    for i, pod in enumerate(pods):
        children = [j.container + (term.gray(" [init]") if j.init else "")
                    for j in jobs_by_pod.get(pod.name, [])]
        widgets.render_tree(f"{pod.name} {term.blue(f'[Pod #{i + 1}]')}",
                            children)
    term.info("Acquiring logs \U0001f680")


def print_log_size(log_files: list[str], log_path: str) -> None:
    if not log_files:
        term.error("No logs saved")
        return
    term.info("Logs saved to %s", term.green(log_path))
    table = [["Pod", "Container", "Size"]]
    previous_pod = ""
    for path in log_files:
        try:
            size = os.stat(path).st_size
        except OSError:
            continue
        pod, container = split_log_file_name(path)
        label = term.gray(pod) if pod == previous_pod else pod
        table.append([label, container, convert_bytes(size)])
        previous_pod = pod
    widgets.render_table(table)


def make_pipeline_for(opts: Options, device=None):
    """The --match/--exclude filter pipeline (None = unfiltered)."""
    if not opts.match and not opts.exclude:
        return None
    from klogs_tpu_torch.filters.compiler.parser import RegexSyntaxError
    from klogs_tpu_torch.filters.sink import make_pipeline

    try:
        return make_pipeline(opts.match, opts.backend,
                             ignore_case=opts.ignore_case,
                             exclude=opts.exclude, device=device)
    except re.error as e:
        term.fatal("invalid --match/--exclude pattern %r: %s", e.pattern, e)
    except RegexSyntaxError as e:
        term.fatal("unsupported --match/--exclude pattern: %s", e)


async def run_async(opts: Options, backend: ClusterBackend | None = None,
                    device=None) -> int:
    widgets.splash_screen()
    backend = backend or make_backend(opts)
    try:
        namespace = await resolve_namespace(backend, opts)
        pods = await select_pods(backend, namespace, opts)
        container_re = (re.compile(opts.container) if opts.container
                        else None)
        exclude_container_re = (re.compile(opts.exclude_container)
                                if opts.exclude_container else None)
        jobs = plan_jobs(pods, opts.log_path, opts.init_containers,
                         container_re=container_re,
                         exclude_container_re=exclude_container_re)
        if (container_re or exclude_container_re) and pods and not jobs:
            term.error("No containers left after -c/-E filtering in %d "
                       "selected pod(s)", len(pods))
        if jobs:
            streaming = {j.pod for j in jobs}
            print_plan([p for p in pods if p.name in streaming], jobs)
        log_opts = build_log_options(opts)
        pipeline = make_pipeline_for(opts, device=device)
        try:
            runner = FanoutRunner(
                backend, namespace, log_opts,
                sink_factory=pipeline.sink_factory if pipeline else None)
            await runner.run(jobs)
            print_log_size([j.path for j in jobs], opts.log_path)
            if pipeline is not None and opts.stats:
                pipeline.print_summary()
            return 0
        finally:
            if pipeline is not None:
                await pipeline.aclose()
    finally:
        await backend.close()


def run(opts: Options, device=None) -> int:
    return asyncio.run(run_async(opts, device=device))
