"""The metric inventory: every metric name the port can register.

Counterpart of ``klogs_tpu/obs/inventory.py``: the same 95 families,
with the same names, types, label names and buckets, because operators'
dashboards read them, then the port's own (``PORT_FAMILIES``: filterd's
fetch threads, event loop and RPC receive, which the JAX package does
not count). Instrumented modules obtain a family through
``registry.family(name)``, which resolves here, so a name used anywhere
carries the type, help and buckets of this table. Every family is
updated by some layer of the port. Where a help text described the TPU,
it says what the port counts.

Labels are bounded by deployment shape (method names, the pod set,
client hosts), never by traffic content.
"""

from typing import TYPE_CHECKING

from klogs_tpu_torch.obs.metrics import LATENCY_BUCKETS

if TYPE_CHECKING:
    from klogs_tpu_torch.obs.metrics import Registry

# Power-of-two ladders matching the engine's bucketing discipline.
WIDTH_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192,
                 16384, 32768, 65536, 131072)
GROUP_MEMBER_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
GROUP_LINE_BUCKETS = (64, 256, 1024, 4096, 8192, 16384,
                      65536, 262144, 1048576)
# Index-build extraction counts (clauses/factors per pattern) and the
# candidate-narrowing ratio ladder (fractions of lines x groups).
PATTERN_EXTRACT_BUCKETS = (0, 1, 2, 4, 8, 16, 32)
RATIO_BUCKETS = (0.001, 0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 1.0)


def _m(mtype: str, help: str, labels: tuple = (),
       buckets: "tuple | None" = None,
       bounds: "dict | None" = None) -> dict:
    """``bounds`` says, per label, how its values are bounded: ``enum``
    (literals the code chooses), ``config`` (deployment shape: flags,
    fleet membership, the pod set) or ``evictable:<KLOGS_VAR>`` (runtime
    input, the live series capped by that variable, with a remove path
    for evicted entities)."""
    spec = {"type": mtype, "help": help}
    if labels:
        spec["labels"] = tuple(labels)
    if buckets is not None:
        spec["buckets"] = tuple(buckets)
    if bounds is not None:
        spec["bounds"] = dict(bounds)
    return spec


SPECS: dict[str, dict] = {
    # -- process ------------------------------------------------------
    "klogs_build_info": _m(
        "gauge", "Constant 1, labeled with the build version.",
        labels=("version",), bounds={"version": "config"}),
    "klogs_process_uptime_seconds": _m(
        "gauge", "Seconds since this process started (refreshed per "
        "/metrics scrape, --stats-json dump, and profiler tick — no "
        "node exporter needed for headroom math)."),
    "klogs_process_rss_bytes": _m(
        "gauge", "Current resident set size of this process in bytes "
        "(refreshed like klogs_process_uptime_seconds)."),

    # -- pipeline profiler (obs/profiler.py) --------------------------
    # The `stage` label is the fixed span-name catalog
    # (obs.profiler.STAGES), a code-chosen enum.
    "klogs_profile_stage_busy_seconds_total": _m(
        "counter", "Cumulative busy-seconds folded from finished "
        "spans per pipeline stage (the profiler's utilization "
        "numerator; synced once per tick).", labels=("stage",),
        bounds={"stage": "enum"}),
    "klogs_profile_stage_spans_total": _m(
        "counter", "Finished spans folded per pipeline stage by the "
        "profiler.", labels=("stage",), bounds={"stage": "enum"}),
    "klogs_profile_stage_utilization": _m(
        "gauge", "Rolling per-stage utilization over the last profiler "
        "tick window: busy-seconds per wall-second, unbiased by the "
        "trace sampling rate. May exceed 1.0 for stages that run "
        "concurrently (N in-flight RPCs).", labels=("stage",),
        bounds={"stage": "enum"}),

    # -- fleet capacity (the autoscaling signal) ----------------------
    # Server-side (filterd): unlabeled totals + the advertised
    # headroom. Collector-side: the sharded client re-exports what each
    # endpoint's Hello advertised, labeled by endpoint (the --remote
    # fleet — deployment shape).
    "klogs_fleet_offered_lines_total": _m(
        "counter", "Lines that entered a match RPC on this filterd "
        "(before tenancy admission) — the demand signal."),
    "klogs_fleet_admitted_lines_total": _m(
        "counter", "Lines that produced verdicts on this filterd "
        "(past quota shed and the fair gate). offered - admitted is "
        "the shed pressure an autoscaler should add capacity for."),
    "klogs_fleet_headroom": _m(
        "gauge", "This filterd's advertised headroom estimate in "
        "[0, 1], by signal trust: 1 - admitted rate / envelope when "
        "KLOGS_FLEET_CAPACITY_LPS calibrates one, else 1 - peak stage "
        "utilization from the live profiler. Advertised through "
        "Hello."),
    "klogs_fleet_endpoint_headroom": _m(
        "gauge", "Headroom last advertised by each filterd endpoint's "
        "Hello, re-exported by the sharded client for an HPA to "
        "consume.", labels=("endpoint",), bounds={"endpoint": "config"}),
    "klogs_fleet_endpoint_offered_lines_total": _m(
        "counter", "Offered-lines total last advertised by each "
        "endpoint's Hello, re-exported collector-side (advanced by "
        "observed deltas; a restarted server restarts its series).",
        labels=("endpoint",), bounds={"endpoint": "config"}),
    "klogs_fleet_endpoint_admitted_lines_total": _m(
        "counter", "Admitted-lines total last advertised by each "
        "endpoint's Hello, re-exported collector-side like the "
        "offered twin.", labels=("endpoint",),
        bounds={"endpoint": "config"}),

    # -- sink layer (FilteredSink / FilterStats view) -----------------
    "klogs_sink_lines_total": _m(
        "counter", "Lines that entered the filter stage."),
    "klogs_sink_lines_matched_total": _m(
        "counter", "Lines the filter kept (written to the sink)."),
    "klogs_sink_bytes_in_total": _m(
        "counter", "Raw bytes entering the filter stage."),
    "klogs_sink_bytes_out_total": _m(
        "counter", "Bytes written after filtering."),
    "klogs_sink_batches_total": _m(
        "counter", "Filter batches flushed."),
    "klogs_sink_batch_latency_seconds": _m(
        "histogram", "End-to-end batch latency: enqueue to verdicts, "
        "sink-observed.", buckets=LATENCY_BUCKETS),
    "klogs_sink_deadline_flush_total": _m(
        "counter", "Flushes forced by the follow-mode deadline rather "
        "than batch-size."),

    # -- coalescer layer (AsyncFilterService) -------------------------
    "klogs_coalescer_queue_depth": _m(
        "gauge", "Caller batches waiting to coalesce into a group."),
    "klogs_coalescer_pending_lines": _m(
        "gauge", "Lines waiting to coalesce into a group."),
    "klogs_coalescer_queue_wait_seconds": _m(
        "histogram", "Per-caller wait from enqueue to device dispatch "
        "(coalesce window + backpressure).", buckets=LATENCY_BUCKETS),
    "klogs_coalescer_groups_total": _m(
        "counter", "Coalesced groups dispatched to the engine."),
    "klogs_coalescer_group_members": _m(
        "histogram", "Caller batches merged per coalesced group.",
        buckets=GROUP_MEMBER_BUCKETS),
    "klogs_coalescer_group_lines": _m(
        "histogram", "Lines per coalesced group.",
        buckets=GROUP_LINE_BUCKETS),
    "klogs_coalescer_group_splits_total": _m(
        "counter", "Groups split because the combined payload would "
        "exceed int32 offsets (2 GiB)."),
    "klogs_coalescer_backpressure_wait_seconds": _m(
        "histogram", "Wait for an in-flight slot (max_in_flight "
        "semaphore) before dispatch.", buckets=LATENCY_BUCKETS),
    "klogs_coalescer_dispatch_seconds": _m(
        "histogram", "Device dispatch (enqueue) cost per group — NOT "
        "the round trip; see klogs_engine_device_batch_seconds.",
        buckets=LATENCY_BUCKETS),

    # -- engine layer (NFAEngineFilter / tune) ------------------------
    "klogs_engine_device_batch_seconds": _m(
        "histogram", "Dispatch-to-verdicts-fetched device round trip "
        "per group.", buckets=LATENCY_BUCKETS),
    "klogs_engine_compile_total": _m(
        "counter", "CUDA kernel libraries (one per ops/csrc source) "
        "that the engine's launches built with nvcc or loaded from "
        "the build directory during this run: the port's cold-start "
        "cost. The kernels take any batch geometry, so nothing is "
        "compiled per (width, rows); a CPU run counts none."),
    "klogs_engine_bucket_width_bytes": _m(
        "histogram", "Padded line-width bucket per dispatched "
        "sub-batch.", buckets=WIDTH_BUCKETS),
    "klogs_engine_pad_bytes_total": _m(
        "counter", "Padding waste: bucketed tensor bytes minus payload "
        "bytes."),
    "klogs_engine_payload_bytes_total": _m(
        "counter", "Useful payload bytes packed into device batches."),
    "klogs_engine_prefilter_lines_total": _m(
        "counter", "Lines through the gated (prefiltered) kernel."),
    "klogs_engine_prefilter_candidates_total": _m(
        "counter", "Prefilter candidate lines (tiles ran the scan)."),
    "klogs_engine_prefilter_tiles_total": _m(
        "counter", "Kernel tiles considered by the prefilter gate."),
    "klogs_engine_prefilter_tiles_live_total": _m(
        "counter", "Kernel tiles that actually ran the scan loop."),
    "klogs_engine_tune_runs_total": _m(
        "counter", "Autotune sweeps completed (ops.tune.tune_grouped)."),
    "klogs_engine_tune_best_lines_per_second": _m(
        "gauge", "Winning configuration's measured throughput from the "
        "last autotune sweep."),

    # -- regex index (IndexedFilter / compiler grouping) --------------
    "klogs_prefilter_pattern_clauses": _m(
        "histogram", "Mandatory pair-CNF clauses extracted per pattern "
        "at index build (0 = pattern contributes no clause gating).",
        buckets=PATTERN_EXTRACT_BUCKETS),
    "klogs_prefilter_pattern_factors": _m(
        "histogram", "Mandatory literal factors extracted per pattern "
        "at index build (0 = pattern rides the always-candidate path).",
        buckets=PATTERN_EXTRACT_BUCKETS),
    "klogs_prefilter_narrowing_ratio": _m(
        "histogram", "Per-batch candidate-narrowing ratio: candidate "
        "(line, group) scan units over lines x groups — 1.0 means the "
        "index ruled nothing out, lower is better.",
        buckets=RATIO_BUCKETS),
    "klogs_prefilter_groups": _m(
        "gauge", "Pattern groups compiled by the thousand-pattern "
        "index (grouping bounds per-group DFA construction)."),
    "klogs_prefilter_reguard_total": _m(
        "counter", "Guard factors banned by the adaptive re-guard: an "
        "IndexedFilter measured these factors in more than "
        "KLOGS_INDEX_DENSE_RATIO of swept lines after its probation "
        "window and rebuilt the index on next-best guard clauses."),
    "klogs_prefilter_table_cache_events_total": _m(
        "counter", "On-disk DFA table cache outcomes during index "
        "compiles: hit (table loaded), miss (determinized fresh), "
        "evict (LRU removal past KLOGS_DFA_CACHE_MB).",
        labels=("event",), bounds={"event": "enum"}),

    # -- literal sweep (device/host narrowing stage) ------------------
    "klogs_sweep_batches_total": _m(
        "counter", "Batches narrowed by the literal sweep, by which "
        "stage ran: device (fused on-device sweep, ops/sweep.py) or "
        "host (host factor sweep).", labels=("path",),
        bounds={"path": "enum"}),
    "klogs_sweep_lines_total": _m(
        "counter", "Lines swept by the literal sweep, by stage.",
        labels=("path",), bounds={"path": "enum"}),
    "klogs_sweep_candidate_lines_total": _m(
        "counter", "Lines the sweep could NOT rule out (at least one "
        "candidate group), by stage. candidate/swept is the live "
        "narrowing ratio.", labels=("path",), bounds={"path": "enum"}),
    "klogs_sweep_seconds": _m(
        "histogram", "Sweep-stage latency per batch, by stage.",
        labels=("path",), buckets=LATENCY_BUCKETS,
        bounds={"path": "enum"}),
    "klogs_sweep_impl_batches_total": _m(
        "counter", "Batches narrowed by the literal sweep, by "
        "IMPLEMENTATION: device (fused on-device sweep), native (SIMD "
        "kernel in the C extension, the host default), or numpy (the "
        "vectorized fallback when no toolchain or KLOGS_NATIVE_SIMD="
        "off).", labels=("impl",), bounds={"impl": "enum"}),
    "klogs_sweep_fallback_total": _m(
        "counter", "Device-sweep degrades: build or kernel failures "
        "that dropped a batch (and every later one) to the fallback "
        "path."),

    # -- batched group scan (indexed engine confirm stage) ------------
    "klogs_groupscan_batches_total": _m(
        "counter", "Slabs that ran the candidate group-scan (confirm) "
        "stage, by implementation: native (one batched MultiDFA "
        "group_scan call for every DFA-backed group) or python (the "
        "per-group dispatch loop — the KLOGS_NATIVE_GROUPSCAN=off / "
        "no-toolchain fallback and parity oracle).",
        labels=("impl",), bounds={"impl": "enum"}),
    "klogs_groupscan_rows_total": _m(
        "counter", "Rows entering the group-scan stage with at least "
        "one candidate DFA-backed group, by implementation.",
        labels=("impl",), bounds={"impl": "enum"}),
    "klogs_groupscan_cells_total": _m(
        "counter", "Candidate (row, group) cells the confirm stage "
        "actually scanned, by implementation — below the sweep's "
        "candidate-cell count when early-out skipped cells whose row "
        "an earlier group already accepted.",
        labels=("impl",), bounds={"impl": "enum"}),
    "klogs_groupscan_seconds": _m(
        "histogram", "Group-scan stage latency per slab, by "
        "implementation.", labels=("impl",), buckets=LATENCY_BUCKETS,
        bounds={"impl": "enum"}),
    "klogs_groupscan_fallback_total": _m(
        "counter", "Batched group-scan degrades: a native kernel "
        "failure dropped this process permanently to the per-group "
        "Python loop."),
    "klogs_sweep_bypass_total": _m(
        "counter", "Adaptive sweep bypasses: an IndexedFilter observed "
        "a narrowing ratio above KLOGS_INDEX_BYPASS_RATIO after its "
        "probation window and switched itself to scan-all."),

    # -- fanout layer (FanoutRunner) ----------------------------------
    "klogs_fanout_active_streams": _m(
        "gauge", "Log streams currently open."),
    "klogs_fanout_stream_bytes_total": _m(
        "counter", "Bytes received per container stream.",
        labels=("pod", "container"),
        bounds={"pod": "config", "container": "config"}),
    "klogs_fanout_reconnects_total": _m(
        "counter", "Follow-mode stream reconnect attempts.",
        labels=("pod", "container"),
        bounds={"pod": "config", "container": "config"}),
    "klogs_fanout_stream_errors_total": _m(
        "counter", "Streams that ended with a terminal error."),
    "klogs_fanout_backpressure_stalls_total": _m(
        "counter", "Sink writes that blocked longer than the stall "
        "threshold (downstream backpressure)."),

    # -- source layer (sources/*: replay, archive, socket) ------------
    "klogs_source_bytes_total": _m(
        "counter", "Bytes delivered by non-kube sources, by source "
        "kind (file, archive, socket).", labels=("kind",),
        bounds={"kind": "enum"}),
    "klogs_source_rotations_total": _m(
        "counter", "File rotations/truncations detected by the replay "
        "source (inode change or shrink at the watched path)."),
    "klogs_source_archive_members_total": _m(
        "counter", "Archive members (rotated/compressed files) fully "
        "decoded by the backfill source."),
    "klogs_source_errors_total": _m(
        "counter", "Source open/read failures (SourceError), by "
        "source kind.", labels=("kind",), bounds={"kind": "enum"}),
    "klogs_source_connections_total": _m(
        "counter", "Connections accepted by the socket source "
        "(KLOGS_SOCKET_MAX_CONNS bounds the concurrent set)."),

    # -- resilience layer (retry/breaker/faults/degrade) --------------
    "klogs_retry_attempts_total": _m(
        "counter", "Retries performed by the shared resilience policy, "
        "by call site (kube, fanout, rpc@endpoint — RPC sites carry "
        "the endpoint so a sharded fleet's servers stay "
        "distinguishable).", labels=("site",), bounds={"site": "config"}),
    "klogs_breaker_state": _m(
        "gauge", "Circuit-breaker state: 0=closed, 1=open, 2=half-open.",
        labels=("breaker",), bounds={"breaker": "config"}),
    "klogs_faults_injected_total": _m(
        "counter", "Chaos faults fired, by registered fault point "
        "(test API or KLOGS_FAULTS).", labels=("point",),
        bounds={"point": "config"}),
    "klogs_filter_degraded_batches_total": _m(
        "counter", "Sink flushes degraded because the filter service "
        "was unavailable, by --on-filter-error action.",
        labels=("action",), bounds={"action": "enum"}),
    "klogs_filter_degraded_lines_total": _m(
        "counter", "Lines written unfiltered (action=pass) or dropped "
        "(action=drop) while the filter service was unavailable.",
        labels=("action",), bounds={"action": "enum"}),

    # -- shard tier (ShardedFilterClient over N filterds) -------------
    # Endpoint labels are the --remote fleet: deployment shape (a
    # handful of servers), never traffic content.
    "klogs_shard_batches_total": _m(
        "counter", "Batches resolved by each filterd endpoint (the "
        "winning attempt only — hedge losers are cancelled, never "
        "counted).", labels=("endpoint",),
        bounds={"endpoint": "config"}),
    "klogs_shard_hedges_total": _m(
        "counter", "Hedged duplicate dispatches launched against a "
        "sibling after the primary exceeded the hedge deadline, by "
        "sibling endpoint.", labels=("endpoint",),
        bounds={"endpoint": "config"}),
    "klogs_shard_reroutes_total": _m(
        "counter", "Batches routed away from an endpoint: skipped as "
        "primary (breaker open / not ready) or failed over after a "
        "terminal attempt error.", labels=("endpoint", "reason"),
        bounds={"endpoint": "config", "reason": "enum"}),
    "klogs_shard_endpoint_ready": _m(
        "gauge", "Endpoint readiness as last observed by the /readyz "
        "prober (1 ready, 0 draining or unreachable).",
        labels=("endpoint",), bounds={"endpoint": "config"}),
    "klogs_shard_endpoint_weight": _m(
        "gauge", "Effective routing weight (headroom-learned, "
        "staleness-decayed toward 1.0) the weighted round-robin "
        "actually uses for each endpoint right now.",
        labels=("endpoint",), bounds={"endpoint": "config"}),
    "klogs_fleet_membership_events_total": _m(
        "counter", "Live-membership changes applied by the endpoint "
        "resolver: add (endpoint joined, unverified), remove "
        "(endpoint retired), error (poll failed or snapshot rejected "
        "— fleet kept as-is).", labels=("action",),
        bounds={"action": "enum"}),
    "klogs_fleet_membership_size": _m(
        "gauge", "Endpoints currently in the sharded client's fleet "
        "(verified or not; quarantined endpoints still count until "
        "the resolver removes them)."),

    # -- adaptive tuning (ops/tune.py AdaptiveController) -------------
    "klogs_tune_steps_total": _m(
        "counter", "Operating-point adjustments the adaptive "
        "controller applied, by parameter (coalesce_lines, "
        "max_in_flight) and direction (up, down).",
        labels=("param", "direction"),
        bounds={"param": "enum", "direction": "enum"}),
    "klogs_tune_value": _m(
        "gauge", "Current value of each controller-managed parameter "
        "(equals the fixed flag value while KLOGS_TUNE=off).",
        labels=("param",), bounds={"param": "enum"}),

    # -- tenancy (multi-set registry, service/tenancy.py) -------------
    # The `set` label is a pattern-set fingerprint: bounded by the
    # registry capacity KLOGS_TENANT_MAX_SETS (a deployment knob), so
    # per-set series obey the deployment-shape cardinality rule even
    # though fingerprints derive from collector invocations.
    "klogs_tenant_sets": _m(
        "gauge", "Pattern sets currently registered (compiled engines "
        "live in this process)."),
    "klogs_tenant_registrations_total": _m(
        "counter", "Register RPC outcomes: new (engine built) or "
        "shared (content-addressed reuse of a live engine).",
        labels=("outcome",), bounds={"outcome": "enum"}),
    "klogs_tenant_engine_builds_total": _m(
        "counter", "Engines compiled by the registry. Two tenants "
        "registering the same fingerprint advance this ONCE — the "
        "content-addressed-sharing acceptance counter."),
    "klogs_tenant_evictions_total": _m(
        "counter", "Registered sets evicted, by reason: idle (past "
        "KLOGS_TENANT_IDLE_S), capacity (LRU past "
        "KLOGS_TENANT_MAX_SETS), shutdown.", labels=("reason",),
        bounds={"reason": "enum"}),
    "klogs_tenant_shed_total": _m(
        "counter", "Batches shed over the per-set pending-line quota "
        "(KLOGS_TENANT_QUOTA_LINES); the client degrades them through "
        "--on-filter-error — never a silent drop.", labels=("set",),
        bounds={"set": "evictable:KLOGS_TENANT_MAX_SETS"}),
    "klogs_tenant_pending_lines": _m(
        "gauge", "Lines admitted or awaiting admission per set lane "
        "(the quota accounting the shed decision reads).",
        labels=("set",),
        bounds={"set": "evictable:KLOGS_TENANT_MAX_SETS"}),
    "klogs_tenant_lines_total": _m(
        "counter", "Lines admitted (past quota + fair gate) per set "
        "lane.", labels=("set",),
        bounds={"set": "evictable:KLOGS_TENANT_MAX_SETS"}),
    "klogs_tenant_admission_wait_seconds": _m(
        "histogram", "Wait for a weighted-fair admission slot before a "
        "batch may dispatch — the fairness latency an abusive sibling "
        "inflicts.", buckets=LATENCY_BUCKETS),

    # -- tracing / flight recorder (obs.trace) ------------------------
    "klogs_trace_spans_total": _m(
        "counter", "Finished sampled spans recorded by the tracer "
        "(KLOGS_TRACE_SAMPLE head sampling)."),
    "klogs_flight_dumps_total": _m(
        "counter", "Flight-recorder dumps written, by trigger reason "
        "(breaker-open, filter-degrade, sweep-fallback, "
        "abort-escalation).", labels=("reason",), bounds={"reason": "enum"}),

    # -- RPC layer (filterd gRPC server) ------------------------------
    "klogs_rpc_requests_total": _m(
        "counter", "RPCs received, by method.", labels=("method",),
        bounds={"method": "enum"}),
    "klogs_rpc_errors_total": _m(
        "counter", "RPCs that failed (including aborts), by method.",
        labels=("method",), bounds={"method": "enum"}),
    "klogs_rpc_request_seconds": _m(
        "histogram", "Server-side RPC handling latency, by method.",
        labels=("method",), buckets=LATENCY_BUCKETS,
        bounds={"method": "enum"}),
    "klogs_rpc_client_requests_total": _m(
        "counter", "RPCs per client HOST (peer address normalized to "
        "drop the per-connection port).", labels=("client",),
        bounds={"client": "config"}),

    # -- the port's own (filterd's host path) -------------------------
    "klogs_fetch_wait_seconds_total": _m(
        "counter", "Seconds the coalescer's fetch threads spent in the "
        "engine's fetch (the wait for a batch's verdicts and their "
        "read), summed over batches."),
    "klogs_fetch_cpu_seconds_total": _m(
        "counter", "CPU seconds the fetch threads used in those fetches "
        "(their thread time): over klogs_fetch_wait_seconds_total, the "
        "share of the wait spent spinning."),
    "klogs_loop_lag_seconds": _m(
        "histogram", "How late filterd's event-loop timer fired, re-armed "
        "every 50 ms: the loop's delay in running work that is ready.",
        buckets=LATENCY_BUCKETS),
    "klogs_rpc_receive_seconds": _m(
        "histogram", "From an RPC's arrival (its handler looked up, "
        "before the request message is read) to the handler's entry: "
        "the request's transfer and the loop's delay, by method.",
        labels=("method",), buckets=LATENCY_BUCKETS,
        bounds={"method": "enum"}),
}

# The families the JAX package has no counterpart of (the last of SPECS).
PORT_FAMILIES: "tuple[str, ...]" = (
    "klogs_fetch_wait_seconds_total", "klogs_fetch_cpu_seconds_total",
    "klogs_loop_lag_seconds", "klogs_rpc_receive_seconds",
)


def register_all(registry: "Registry") -> None:
    """Instantiate every inventory family in ``registry`` so a scrape
    exposes the full instrument panel (zero-valued where idle) from the
    first request — an operator's dashboard never has to guess whether
    a missing series means 'no traffic yet' or 'not instrumented'."""
    for name in SPECS:
        registry.family(name)
