"""Top-level run orchestration.

Counterpart of ``klogs_tpu/app.py``: splash, namespace resolution (with
the interactive picker on a miss), pod selection (label union, every
Ready pod, or the interactive multiselect), the per-container fan-out
through the --match/--exclude filter pipeline, follow mode (the
deadline flusher, q-to-quit on /dev/tty, Ctrl-C as a graceful stop,
``--watch-new``) and the final size table. ``run_async`` takes an
injected ClusterBackend (tests pass a FakeCluster), a ``stop`` event
for library callers of follow mode, and the filter's ``device`` (None
means ``"cuda"``).
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
from klogs_tpu_torch.runtime.fanout import FanoutRunner, StreamJob, plan_jobs
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


async def _run_async_inner(opts: Options, backend: ClusterBackend | None,
                           stop: asyncio.Event | None,
                           select_keys: Iterable[str] | None,
                           device) -> int:
    widgets.splash_screen()
    backend = backend or make_backend(opts)
    try:
        log_opts = build_log_options(opts)
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
        log_files = [j.path for j in jobs]
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
        if opts.timestamps and (opts.match or opts.exclude):
            term.info("note: --timestamps prefixes are part of the line "
                      "--match/--exclude see (anchor accordingly)")

        pipeline = make_pipeline_for(opts, device=device)
        inner_factory = make_inner_sink_factory(opts)
        try:
            if pipeline is not None:
                pipeline.inner_factory = inner_factory
            runner = FanoutRunner(
                backend, namespace, log_opts,
                sink_factory=(pipeline.sink_factory if pipeline
                              else inner_factory),
                create_files=opts.output != "stdout")
            # --watch-new re-runs a NON-interactive selection only.
            plan_new = None
            if opts.watch_new and opts.follow:
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
            if opts.output != "stdout":
                print_log_size(log_files, opts.log_path)
            if pipeline is not None and opts.stats:
                pipeline.print_summary()
            return 130 if interrupted else 0
        finally:
            # Drains the in-flight device batches, inside the loop.
            if pipeline is not None:
                await pipeline.aclose()
    finally:
        await backend.close()


def run(opts: Options, device=None) -> int:
    return asyncio.run(run_async(opts, device=device))
