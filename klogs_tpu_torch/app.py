"""Top-level run orchestration.

Counterpart of ``klogs_tpu/app.py``: splash, namespace resolution (with
the interactive picker on a miss), pod selection (label union, every
Ready pod, or the interactive multiselect), the per-container fan-out
through the --match/--exclude filter pipeline, follow mode (the
deadline flusher, q-to-quit on /dev/tty, Ctrl-C as a graceful stop,
``--watch-new``) and the final size table. With ``--source`` or
``--backfill`` a Source (``sources/``) replaces the cluster: no
namespace, no pod selection, no kube client; in follow mode the source
is always re-discovered, and a backfill ends with its match/shed
account. ``run_async`` takes an injected ClusterBackend (tests pass a
FakeCluster), a ``stop`` event for library callers of follow mode, and
the filter's ``device`` (None means ``"cuda"``; ``--backend cpu`` runs
the host engines of filters/cpu.py, which read no device and never
touch the card, and its ``--stats`` prints the indexed engine's
groups, engine kinds, narrowing ratio and stage seconds). With
``--remote`` the
filter is a filterd elsewhere, or a fleet of them (a list,
``--shard-mode``, ``--resolver``): its pattern set is checked against
the run's before any stream opens, no engine is built and no card is
needed, and ``--on-filter-error`` says what a batch gets while the
service is unavailable.

Observability, as in the JAX app: ``--metrics-port`` and
``--stats-json`` build a registry for the run (a fresh one each run, so
a second run in one process starts at zero) that backs the filter's
stats, the fan-out, the sources, the kube retries and the fault
counters; ``--metrics-port`` serves it (with /healthz, /readyz, /traces
and /profile) while the run lasts, and ``--stats-json`` dumps it at the
end. ``--trace-json`` samples every trace (unless
``KLOGS_TRACE_SAMPLE`` pins a rate) and appends each finished span to
the file; ``--profile-json`` (or ``KLOGS_PROFILE_SAMPLE``) runs the
pipeline profiler's ticker. ``KLOGS_FAULTS`` arms the fault points for
the run. ``--profile DIR`` writes a torch.profiler trace where the JAX
CLI writes an xprof one. ``KLOGS_TUNE=auto`` runs the operating-point
controller (``ops/tune.py``) over the in-process pipeline's service for
the run, with the profiler's ticker feeding it.
"""

import asyncio
import os
import re
import signal
import sys
import threading
from datetime import datetime
from typing import Iterable

from klogs_tpu_torch.cli import Options
from klogs_tpu_torch.cluster.backend import ClusterBackend
from klogs_tpu_torch.cluster.types import LogOptions, PodInfo
from klogs_tpu_torch.runtime.fanout import (
    FanoutRunner,
    StreamJob,
    plan_jobs,
    plan_source_jobs,
)
from klogs_tpu_torch.ui import interactive, term, widgets
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
    from klogs_tpu_torch.cluster.kube import KubeBackend

    return KubeBackend.from_kubeconfig(opts.kubeconfig)


async def resolve_namespace(backend: ClusterBackend, opts: Options,
                            select_keys: Iterable[str] | None = None) -> str:
    """Explicit -n, else the context's namespace; on a miss, warn and
    fall into the interactive picker (its choice is not re-checked, as
    in the reference)."""
    namespace = opts.namespace
    if not namespace:
        context, namespace = backend.current_context()
        term.info("Using Context %s", term.green(context))
    if not await backend.namespace_exists(namespace):
        term.warning("Namespace %s not found", namespace)
        names = await backend.list_namespaces()
        namespace = interactive.interactive_select(
            names, "Select a Namespace", keys=select_keys)
    term.info("Using Namespace %s", term.green(namespace))
    return namespace


async def select_noninteractive(backend: ClusterBackend, namespace: str,
                                opts: Options,
                                quiet: bool = False) -> list[PodInfo]:
    """Label union (no dedup across labels) or every Ready pod: the part
    of pod selection that can run again, shared by startup and the
    --watch-new poll. ``quiet`` drops the per-call chatter."""
    if opts.labels:
        pods: list[PodInfo] = []
        for label in opts.labels:
            if not quiet:
                term.info("Getting Pods with label %s\n", term.green(label))
            found = await backend.list_pods(namespace, label_selector=label)
            if not found and not quiet:
                term.error("No pods found in namespace %s with label %s\n",
                           namespace, label)
            pods.extend(found)
        return pods
    return [p for p in await backend.list_pods(namespace) if p.ready]


async def select_pods(backend: ClusterBackend, namespace: str, opts: Options,
                      select_keys: Iterable[str] | None = None
                      ) -> list[PodInfo]:
    """The label union, every Ready pod (-a), or the Ready pods the
    interactive multiselect picks."""
    if opts.labels:
        return await select_noninteractive(backend, namespace, opts)
    ready = await select_noninteractive(backend, namespace, opts)
    if not ready:
        term.error("No pods found in namespace %s", namespace)
        return []
    if not opts.all_pods:
        by_name = {p.name: p for p in ready}
        chosen = interactive.interactive_multiselect(
            [p.name for p in ready], "Select Pods to get logs",
            keys=select_keys)
        if not chosen:
            term.error("No pods selected")
            return []
        return [by_name[n] for n in chosen]
    return ready


def build_log_options(opts: Options) -> LogOptions:
    """The server-side log options; the invalid combinations are fatal
    here too, for library callers (``cli.main`` rejects them first)."""
    if opts.previous and opts.follow:
        term.fatal("--previous is incompatible with -f/--follow "
                   "(a terminated instance cannot stream)")
    if opts.since and opts.since_time:
        term.fatal("at most one of -s/--since and --since-time may be "
                   "given (kubectl parity)")
    lo = LogOptions(follow=opts.follow, previous=opts.previous,
                    timestamps=opts.timestamps)
    if opts.since:
        try:
            lo.since_seconds = int(parse_duration(opts.since))
        except DurationError as e:
            term.fatal("%s", e)
    if opts.since_time:
        try:
            dt = datetime.fromisoformat(opts.since_time.replace("Z", "+00:00"))
            if dt.tzinfo is None:
                raise ValueError("missing timezone offset")
        except ValueError:
            term.fatal("invalid --since-time %r (want RFC3339 with a "
                       "timezone)", opts.since_time)
        lo.since_time = opts.since_time
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


def _print_backfill_summary(pipeline) -> None:
    """``--backfill``'s closing account of matched and shed lines,
    printed with or without ``--stats``. The port has no degrade path,
    so nothing is shed."""
    if pipeline is None:
        term.info("Backfill complete (no --match/--exclude: every line "
                  "written)")
        return
    s = pipeline.stats
    term.info(
        "Backfill complete: %s lines in, %s matched (%.2f%%), %s shed",
        f"{s.lines_in:,}", f"{s.lines_matched:,}", s.matched_pct(), "0")


async def _watch_for_quit(stop: asyncio.Event, message: str,
                          done: "threading.Event",
                          spinner: bool = True) -> None:
    """q-to-quit: read keys from the controlling terminal (/dev/tty, not
    stdin) in cbreak mode until q/Q, then set ``stop``. Without a
    terminal it warns and stops at once. The reader polls ``done`` so
    its thread ends (restoring the terminal) when the run ends first.
    With ``-o stdout|both`` the spinner is one static line."""
    loop = asyncio.get_running_loop()

    def read_q() -> None:
        import select
        import termios
        import tty

        with open("/dev/tty", "rb", buffering=0) as t:
            fd = t.fileno()
            old = termios.tcgetattr(fd)
            try:
                tty.setcbreak(fd)
                while not done.is_set():
                    r, _, _ = select.select([fd], [], [], 0.2)
                    if r and t.read(1) in (b"q", b"Q"):
                        return
            finally:
                termios.tcsetattr(fd, termios.TCSADRAIN, old)

    try:
        if spinner:
            async with widgets.Spinner(message):
                await loop.run_in_executor(None, read_q)
        else:
            term.info("%s", message)
            await loop.run_in_executor(None, read_q)
    except Exception as e:  # no controlling tty, termios failure
        term.warning("No controlling terminal for q-to-quit (%s); stopping", e)
    stop.set()


def make_inner_sink_factory(opts: Options):
    """Where lines land under ``-o``: None = files; ``stdout`` = the
    prefixed (or JSON) console stream; ``both`` = file and console."""
    if opts.output == "files":
        if opts.format != "text":
            term.warning("--format %s only applies with -o stdout|both; "
                         "ignoring", opts.format)
        return None
    from klogs_tpu_torch.runtime.sink import FileSink
    from klogs_tpu_torch.runtime.stdout import (
        JsonStdoutSink,
        StdoutSink,
        TeeSink,
        compile_highlights,
    )

    if opts.format == "json":
        def console(job):
            return JsonStdoutSink(job.pod, job.container)
    else:
        hl = compile_highlights(opts.match, opts.ignore_case)

        def console(job):
            return StdoutSink(job.pod, job.container, highlight=hl)
    if opts.output == "stdout":
        return console
    return lambda job: TeeSink(FileSink(job.path), console(job))


def make_pipeline_for(opts: Options, device=None, registry=None):
    """The --match/--exclude filter pipeline (None = unfiltered);
    ``registry`` backs its stats when the run has one. With --remote or
    --resolver the pipeline asks filterd and builds no engine
    (``device`` is unused)."""
    if not opts.match and not opts.exclude:
        return None
    from klogs_tpu_torch.filters.compiler.parser import RegexSyntaxError
    from klogs_tpu_torch.filters.sink import make_pipeline

    try:
        return make_pipeline(opts.match, opts.backend,
                             ignore_case=opts.ignore_case,
                             exclude=opts.exclude, device=device,
                             registry=registry, remote=opts.remote,
                             on_filter_error=opts.on_filter_error,
                             shard_mode=opts.shard_mode,
                             resolver=opts.resolver,
                             kubeconfig=opts.kubeconfig or None)
    except re.error as e:
        term.fatal("invalid --match/--exclude pattern %r: %s", e.pattern, e)
    except RegexSyntaxError as e:
        term.fatal("unsupported --match/--exclude pattern: %s", e)
    except ImportError as e:
        term.fatal("--backend %s is unavailable: %s", opts.backend, e)


def _write_stats_json(path: str, registry, pipeline) -> None:
    """--stats-json: the run's registry snapshot and the --stats summary
    numbers (read from the same metric objects), written at exit."""
    import json

    from klogs_tpu_torch.obs import snapshot
    from klogs_tpu_torch.obs.profiler import refresh_process_metrics

    refresh_process_metrics(registry)
    doc: dict = {"metrics": snapshot(registry)}
    if pipeline is not None:
        s = pipeline.stats
        doc["summary"] = {
            "lines_in": s.lines_in,
            "lines_matched": s.lines_matched,
            "matched_pct": s.matched_pct(),
            "lines_per_sec": s.lines_per_sec(),
            "batches": s.batches,
            "batch_latency_p50_s": s.percentile_latency_s(50),
            "batch_latency_p90_s": s.percentile_latency_s(90),
            "batch_latency_p99_s": s.percentile_latency_s(99),
        }
        if s.has_service_latencies:
            doc["summary"].update({
                "queue_p50_s": s.percentile_queue_s(50),
                "queue_p90_s": s.percentile_queue_s(90),
                "queue_p99_s": s.percentile_queue_s(99),
                "device_p50_s": s.percentile_device_s(50),
                "device_p90_s": s.percentile_device_s(90),
                "device_p99_s": s.percentile_device_s(99),
            })
    try:
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        term.info("Metrics dump written to %s", term.green(path))
    except OSError as e:
        term.error("cannot write --stats-json %s: %s", path, e)


def _start_torch_profiler(opts: Options, device):
    """--profile DIR: a torch.profiler recording of the run, written to
    DIR at its end. It records the card's CUDA activity, and the CPU's
    only when the caller asked for the CPU."""
    import torch

    if opts.backend == "cpu" and opts.remote is None and opts.resolver is None:
        dev = torch.device("cpu")  # the host engines: no card
    else:
        dev = (torch.device(device) if device is not None
               else torch.device("cuda"))
    activity = (torch.profiler.ProfilerActivity.CPU if dev.type == "cpu"
                else torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=[activity],
        on_trace_ready=torch.profiler.tensorboard_trace_handler(
            opts.profile))
    prof.start()
    term.info("Profiling to %s", term.green(opts.profile))
    return prof


def _watch_interval() -> float:
    raw = env_read("KLOGS_WATCH_INTERVAL_S", "5")
    try:
        # A floor of 0.2 s: zero would busy-poll the apiserver.
        return max(0.2, float(raw))
    except ValueError:
        term.fatal("KLOGS_WATCH_INTERVAL_S must be a number, got %r", raw)


async def run_async(opts: Options, backend: ClusterBackend | None = None,
                    stop: asyncio.Event | None = None,
                    select_keys: Iterable[str] | None = None,
                    device=None) -> int:
    if opts.output != "files":
        # Log lines own stdout; the UI moves to stderr, so a piped
        # `-o stdout | grep` sees only log lines.
        term.set_ui_stream(sys.stderr)
    try:
        return await _run_async_inner(opts, backend, stop, select_keys,
                                      device)
    finally:
        if opts.output != "files":
            term.set_ui_stream(None)


def _start_obs(opts: Options, backend, source):
    """The run's registry (None without --metrics-port/--stats-json),
    the tracer's and profiler's settings, and the fault counters; returns
    (registry, whether the profiler's ticker should run)."""
    obs_registry = None
    if opts.metrics_port is not None or opts.stats_json is not None:
        from klogs_tpu_torch import obs
        from klogs_tpu_torch.version import BUILD_VERSION

        obs_registry = obs.Registry()
        obs.register_all(obs_registry)
        obs_registry.family("klogs_build_info").labels(
            version=BUILD_VERSION).set(1)
    from klogs_tpu_torch.obs import trace as _trace
    from klogs_tpu_torch.obs.profiler import PROFILER
    from klogs_tpu_torch.resilience import FAULTS

    if opts.trace_json is not None:
        _trace.TRACER.enable_default()
        _trace.TRACER.set_json_path(opts.trace_json)
    if obs_registry is not None:
        _trace.TRACER.bind_registry(obs_registry)
        _trace.RECORDER.bind_registry(obs_registry)
    # KLOGS_PROFILE_SAMPLE alone enables the profiler too; =0 keeps it
    # off even against --profile-json.
    PROFILER.maybe_enable()
    if opts.profile_json is not None and PROFILER.enable():
        PROFILER.set_json_path(opts.profile_json)
    if PROFILER.enabled and obs_registry is not None:
        PROFILER.bind_registry(obs_registry)
    FAULTS.bind_registry(obs_registry)
    if obs_registry is not None:
        bind = getattr(backend, "bind_registry", None)
        if bind is not None:
            bind(obs_registry)
        if source is not None:
            source.bind_registry(obs_registry)
    return obs_registry, PROFILER.enabled


async def _start_sidecar(opts: Options, registry, runner):
    """--metrics-port: the run's /metrics, /healthz, /readyz, /traces and
    /profile. The collector is ready once streaming is set up."""
    from klogs_tpu_torch import obs

    health = obs.Health()
    health.set_ready()
    health.add_live_check("runner", lambda: not runner._stopping)
    srv = obs.MetricsHTTPServer(registry, health=health,
                                port=opts.metrics_port)
    try:
        port = await srv.start()
    except OSError as e:
        term.fatal("cannot bind --metrics-port %s: %s", opts.metrics_port, e)
    term.info("Metrics on %s",
              term.green(f"http://127.0.0.1:{port}/metrics"))
    return srv


async def _plan_cluster(backend: ClusterBackend, opts: Options,
                        select_keys: Iterable[str] | None):
    """The cluster path's plan: the namespace, the pods and their jobs
    (printed as the plan tree), and the -c/-E patterns that
    ``--watch-new`` re-applies."""
    namespace = await resolve_namespace(backend, opts, select_keys)
    pods = await select_pods(backend, namespace, opts, select_keys)
    # Backstops for library callers; cli.main rejects these earlier.
    container_re = exclude_container_re = None
    if opts.container:
        try:
            container_re = re.compile(opts.container)
        except re.error as e:
            term.fatal("invalid -c/--container pattern %r: %s",
                       opts.container, e)
    if opts.exclude_container:
        try:
            exclude_container_re = re.compile(opts.exclude_container)
        except re.error as e:
            term.fatal("invalid -E/--exclude-container pattern %r: %s",
                       opts.exclude_container, e)
    jobs = plan_jobs(pods, opts.log_path, opts.init_containers,
                     container_re=container_re,
                     exclude_container_re=exclude_container_re)
    filtered = container_re is not None or exclude_container_re is not None
    if filtered and pods and not jobs:
        term.error("No containers left after -c/-E filtering in %d "
                   "selected pod(s)", len(pods))
    if jobs:
        if filtered:
            streaming = {j.pod for j in jobs}
            print_plan([p for p in pods if p.name in streaming], jobs)
        else:
            print_plan(pods, jobs)
    return namespace, jobs, container_re, exclude_container_re


async def _plan_source(source, opts: Options) -> list[StreamJob]:
    """The source path's plan: one job per discovered stream, listed."""
    await source.start()
    jobs = plan_source_jobs(await source.discover(), opts.log_path)
    mode = "backfilling" if opts.backfill else "streaming"
    term.info("Found %s %s stream(s), %s",
              term.green(str(len(jobs))), source.kind, mode)
    for j in jobs[:12]:
        term.info("  %s", j.pod)
    if len(jobs) > 12:
        term.info("  … and %d more", len(jobs) - 12)
    return jobs


async def _run_async_inner(opts: Options, backend: ClusterBackend | None,
                           stop: asyncio.Event | None,
                           select_keys: Iterable[str] | None,
                           device) -> int:
    widgets.splash_screen()
    # KLOGS_FAULTS scripts the fault points for this run, loudly.
    from klogs_tpu_torch.resilience import FAULTS, FaultSpecError

    fault_spec = env_read("KLOGS_FAULTS")
    if fault_spec:
        try:
            FAULTS.load_spec(fault_spec)
        except FaultSpecError as e:
            term.fatal("invalid KLOGS_FAULTS: %s", e)
        term.warning("Fault injection ACTIVE (KLOGS_FAULTS=%s)", fault_spec)
    from klogs_tpu_torch.sources import SourceError, make_source

    # --source/--backfill: a Source replaces the cluster (no namespace,
    # no pod selection, no kube client).
    try:
        source = make_source(opts)
    except SourceError as e:
        term.fatal("%s", e)
    if source is None:
        backend = backend or make_backend(opts)
    profiler = (_start_torch_profiler(opts, device)
                if opts.profile else None)
    try:
        log_opts = build_log_options(opts)
        if source is not None:
            namespace = "local"
            jobs = await _plan_source(source, opts)
        else:
            namespace, jobs, container_re, exclude_container_re = \
                await _plan_cluster(backend, opts, select_keys)
        log_files = [j.path for j in jobs]
        if opts.timestamps and (opts.match or opts.exclude):
            term.info("note: --timestamps prefixes are part of the line "
                      "--match/--exclude see (anchor accordingly)")

        from klogs_tpu_torch.obs import trace as _trace
        from klogs_tpu_torch.obs.profiler import PROFILER

        obs_registry, prof_on = _start_obs(opts, backend, source)
        pipeline = None
        prof_stop: asyncio.Event | None = None
        prof_task: asyncio.Task | None = None
        tune_stop: asyncio.Event | None = None
        tune_task: asyncio.Task | None = None
        metrics_srv = None
        try:
            # Inside this try, so the finally reaps the ticker and undoes
            # the run's trace and profile files even when the engine
            # cannot be built.
            pipeline = make_pipeline_for(opts, device=device,
                                         registry=obs_registry)
            inner_factory = make_inner_sink_factory(opts)
            if prof_on:
                prof_stop = asyncio.Event()
                prof_task = asyncio.create_task(
                    PROFILER.run_ticker(prof_stop))
            if pipeline is not None:
                # --remote: the server's pattern set is checked against
                # this run's before any stream opens.
                await pipeline.start()
                pipeline.inner_factory = inner_factory
                # KLOGS_TUNE=auto: the operating-point controller moves
                # the coalescer's group size and the in-flight depth
                # from the profiler's live signals. Off by default:
                # nothing is built, the flags hold.
                from klogs_tpu_torch.ops.tune import maybe_controller

                try:
                    ctrl = maybe_controller(pipeline.service,
                                            registry=obs_registry)
                except ValueError as e:
                    term.fatal("%s", e)
                if ctrl is not None:
                    if not PROFILER.enabled and not PROFILER.enable():
                        term.warning(
                            "KLOGS_TUNE=auto needs profiler signals but "
                            "KLOGS_PROFILE_SAMPLE=0 disables them; the "
                            "controller will hold the fixed flags")
                    elif prof_task is None:
                        # Tuning enabled the profiler: it needs the
                        # ticker for live samples.
                        if obs_registry is not None:
                            PROFILER.bind_registry(obs_registry)
                        prof_stop = asyncio.Event()
                        prof_task = asyncio.create_task(
                            PROFILER.run_ticker(prof_stop))
                    tune_stop = asyncio.Event()
                    tune_task = asyncio.create_task(ctrl.run(tune_stop))
            runner = FanoutRunner(
                backend, namespace, log_opts,
                sink_factory=(pipeline.sink_factory if pipeline
                              else inner_factory),
                create_files=opts.output != "stdout",
                registry=obs_registry, source=source)
            if opts.metrics_port is not None:
                metrics_srv = await _start_sidecar(opts, obs_registry, runner)
            plan_new = None
            if source is not None:
                if opts.follow:
                    # New files and connections join by discovery: in
                    # follow mode a source is always watched.
                    async def plan_new() -> list[StreamJob]:
                        return plan_source_jobs(await source.discover(),
                                                opts.log_path)
                elif opts.watch_new:
                    term.warning("--watch-new only applies with -f; "
                                 "ignoring")
            elif opts.watch_new and opts.follow:
                # --watch-new re-runs a NON-interactive selection only.
                if opts.all_pods or opts.labels:
                    async def plan_new() -> list[StreamJob]:
                        found = await select_noninteractive(
                            backend, namespace, opts, quiet=True)
                        return plan_jobs(
                            found, opts.log_path, opts.init_containers,
                            container_re=container_re,
                            exclude_container_re=exclude_container_re)
                else:
                    term.warning(
                        "--watch-new needs -a or -l (an interactive pod "
                        "pick cannot be re-run); ignoring")
            elif opts.watch_new:
                term.warning("--watch-new only applies with -f; ignoring")
            interrupted = False
            # With discovery on, an empty first selection still waits.
            if opts.follow and (jobs or plan_new is not None):
                own_stop = stop is None
                if own_stop:
                    stop = asyncio.Event()
                flusher = (
                    asyncio.create_task(pipeline.run_deadline_flusher(stop))
                    if pipeline is not None else None)
                sigint_installed = False
                watcher = watcher_done = None
                if own_stop:
                    # First Ctrl-C: the graceful stop (streams closed,
                    # sinks flushed, the size table), exit 130; a second
                    # one dies by the signal at once.
                    loop = asyncio.get_running_loop()

                    def on_sigint() -> None:
                        nonlocal interrupted
                        if interrupted:
                            signal.signal(signal.SIGINT, signal.SIG_DFL)
                            os.kill(os.getpid(), signal.SIGINT)
                            return
                        interrupted = True
                        term.warning("Interrupt: stopping streams (Ctrl-C "
                                     "again to force quit)")
                        stop.set()

                    try:
                        loop.add_signal_handler(signal.SIGINT, on_sigint)
                        sigint_installed = True
                    except (NotImplementedError, RuntimeError):
                        pass  # not the main thread, or no support
                    watcher_done = threading.Event()
                    if opts.output == "stdout":
                        quit_msg = (f"Press {term.green('q')} to stop "
                                    "streaming logs")
                    else:
                        quit_msg = (f"Press {term.green('q')} to stop "
                                    "streaming logs in "
                                    f"{term.green(opts.log_path)}")
                    watcher = asyncio.create_task(_watch_for_quit(
                        stop, quit_msg, watcher_done,
                        spinner=opts.output == "files"))
                try:
                    interval = (_watch_interval() if plan_new is not None
                                else 5.0)
                    results = await runner.run(
                        jobs, stop=stop, plan_new=plan_new,
                        discover_interval_s=interval)
                    # Late-discovered streams belong in the size table.
                    log_files = [r.job.path for r in results]
                finally:
                    if sigint_installed:
                        asyncio.get_running_loop().remove_signal_handler(
                            signal.SIGINT)
                    if watcher is not None:
                        # Unblock the /dev/tty reader so the terminal is
                        # restored.
                        watcher_done.set()
                        await watcher
                    # The workers have closed their sinks (the final
                    # flush): only now does the flusher go.
                    if flusher is not None:
                        flusher.cancel()
                        try:
                            await flusher
                        except asyncio.CancelledError:
                            pass
            else:
                await runner.run(jobs)
                if opts.backfill:
                    # A run to completion owes its account, --stats or
                    # not.
                    _print_backfill_summary(pipeline)
            if opts.output != "stdout":
                print_log_size(log_files, opts.log_path)
            if pipeline is not None and opts.stats:
                pipeline.print_summary()
            if opts.stats_json is not None:
                # A fleet's last capacity sweep, so the dump holds its
                # offered and admitted lines (a short run ends before
                # the prober's refresh).
                refresh = getattr(getattr(pipeline, "service", None),
                                  "refresh_capacity", None)
                if refresh is not None:
                    await refresh()
                _write_stats_json(opts.stats_json, obs_registry, pipeline)
            return 130 if interrupted else 0
        finally:
            if tune_task is not None:
                tune_stop.set()
                try:
                    await tune_task
                except (asyncio.CancelledError, Exception):  # noqa: BLE001
                    pass
            if prof_task is not None:
                # The ticker's last tick ends the --profile-json file.
                prof_stop.set()
                try:
                    await prof_task
                except (asyncio.CancelledError, Exception):  # noqa: BLE001
                    pass
            if opts.profile_json is not None:
                PROFILER.set_json_path(None)
            if metrics_srv is not None:
                await metrics_srv.stop()
            # Drains the in-flight device batches, or closes a remote
            # client's channel, inside the loop.
            if pipeline is not None:
                await pipeline.aclose()
            # A degrade trigger armed near the end may have no root span
            # left to ride: write it now; stop appending spans.
            _trace.RECORDER.flush()
            if opts.trace_json is not None:
                _trace.TRACER.set_json_path(None)
    finally:
        if profiler is not None:
            try:
                profiler.stop()
            except Exception as e:  # noqa: BLE001
                # A trace that cannot be written must not skip the
                # cleanup below or mask an error in flight.
                term.warning("Failed to write profiler trace: %s", e)
        if backend is not None:
            await backend.close()
        if source is not None:
            await source.close()


def run(opts: Options, device=None) -> int:
    return asyncio.run(run_async(opts, device=device))
