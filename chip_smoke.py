#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (klogs_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper
card and nvcc (``/usr/local/cuda`` or CUDA_HOME):

    python3 chip_smoke.py

It builds the CUDA kernels from ``klogs_tpu_torch/ops/csrc`` (one nvcc
per source, all at once) and runs these phases, each printing one JSON
line. Every phase that drives an entry point (engine, cli and their
fused and thousand-pattern variants) fails unless its short rows and
long-line chunks went through the device packer
(``pack_classify_rows``): the payload crosses to the card once per batch
and is cut into rows, stripped of trailing newlines and classified
there.

1. card: the card's name and power limit (nvidia-smi), torch and CUDA.
   Then build (every kernel source at once) and native: the port's
   host library, built from ``klogs_tpu_torch/native/_hostops.c`` at
   first use (its path, the build's seconds); each of its four
   functions (``find_newlines``, ``join_kept_framed``, ``frame_lines``,
   ``split_frame``) byte for byte its plain numpy version, both timed,
   on 256 FakeCluster streams cut in 4 KiB chunks (most end mid-line),
   one stream carrying a 180 KiB line.
2. grouped_nfa_kernel against its plain PyTorch version on the
   32-pattern program (4 groups x 128 states, 64 classes): 131072 rows
   at the 128-byte width bucket and 4096 rows at the 4096 bucket, plus a
   256-state group and a program wider than 1024 states (the wide
   shift kernel, ``grouped_shift_wide_kernel``). Exact equality.
3. chunk_nfa_kernel against its plain version on the 512-state union
   program: 1024 lines of 4 KiB to 128 KiB chained chunk by chunk (some
   ending exactly on a chunk edge), a 640-state union program (run
   padded to 1024 states) and one wider than 1024 states. Matched flags
   and carries must be equal; each case prints ms per launch and µs per
   step.
4. engine: GpuEngineFilter on 512k synthetic log lines and 500 long
   lines (4 KiB to 192 KiB); verdicts equal a Python ``re`` oracle.
5. pack: pack_classify_rows against its plain version, element for
   element, on what the engine stages for the engine phase's first
   frame (every width bucket) and for its long frame (every 4096-byte
   chunk), both timed, with the bound, beside the ``pack_rows`` +
   ``classify_chunk`` pair it replaced on the same lines (equal class
   ids); ``pack_rows`` held against its plain version on the buckets.
6. cli: the user's entry point, ``app.run_async`` over a 256-pod
   FakeCluster (4000 lines each, plus long lines) with ``--match`` on
   the 32 patterns and ``-p`` a temporary directory; every file must
   hold exactly the oracle's lines. This is the main path: the launch
   counts are zeroed just before it and read just after. After it,
   grouped_nfa_kernel is held against its plain version and timed on
   the run's own class batches, at its two most frequent shapes, and
   chunk_nfa_kernel on the long lines' own chunk batch (with its
   carry) at its most frequent shape. The run is repeated under
   cProfile for the host's top functions.

The fused-groups path, under ``KLOGS_TPU_FUSED_GROUPS=1`` (set and
restored around these two phases):

7. engine_fused: the fused engine on the engine phase's frames; its
   verdicts equal the K1 engine's on every line, short lines run
   grouped_nfa_fused_kernel (K4) and never K1, long ones K2; short
   lines/s and the device-busy share.
8. cli_fused: the cli phase again under the variable, this path's main
   run (counts zeroed just before, read just after; K4 must launch, K1
   must not); every file equal to the oracle's lines. Then K4 is held
   against its plain version and K1, and timed with its plain version,
   on the run's own batches, and K2 as in cli.
9. tune: ``ops/tune.py`` ``tune_grouped`` times K1 and K4 on the fused
   engine's 131072 x 131 batch and caches the winner (in a temporary
   ``XDG_CACHE_HOME``); both lines/s and the winner are printed.
   Then tune_auto (``KLOGS_TUNE=auto``, the operating-point controller
   of ``ops/tune.py`` on ``ops/operating_point.json``'s envelope): (a)
   one AsyncFilterService over the engine, from 4 in flight, under 256
   concurrent callers of 4000-line frames for 5 s with 0.2 s ticks: at
   least one step up of ``max_in_flight``, every value in its bounds,
   every verdict equal to a fixed-flag engine's, and after the load a
   step down and a clean close; (b) the cli cell under the variable
   (0.25 s ticks): every file equal to the oracle's, the steps and
   values beside the fixed-flag cli lines/s, K1, K2 and
   ``pack_classify_rows`` held against their plain versions on its
   batches.

The thousand-pattern path, on ``make_patterns(1024)`` (``bench.py``'s
K axis: 156 groups of 128 states, 64 classes):

10. sweep: the device literal sweep's tables (920 factors, 5 group
   words) over 131072 FakeCluster rows at the 128-byte bucket, 1% with
   a minted-family needle; the card's mask equals the same function on
   the CPU, exactly.
11. grouped_nfa_gated_kernel (K3) against its plain version on 8192 of
   those rows under the sweep's gate and under a seeded random gate,
   and against ungated K1 on all 131072, under the sweep's gate and
   under that gate kept on 3% of the lines; on each batch the card's
   pair list (``gate_pairs``) equals its plain version, and K3's launch
   alone, its pair builder, its whole wrapper and K1 are timed.
12. grouped_nfa_fused_kernel (K4) against its plain version and K1,
   K4 and K1 timed in turns: 8192 rows and all 131072 of K1's w128
   batch, the 4096 bucket, the 1280-state wide program, and at K = 1024
   (156 groups in chunks, ungated) the sweep's 131072 x 131 batch and
   the engine's 256-byte bucket (2048 x 259).
   wide: K1 and K2g past 32 words, on the 32 patterns and the watch
   list (``WATCH``, one alternation of 128 pods: 5 groups of 1152
   states), run by the wide shift-and-exceptions kernels
   (``grouped_shift_wide_kernel``, ``grouped_chunk_wide_kernel``): (a)
   K1 against its plain version and beside K4's wide kernel
   (``grouped_fused_wide_kernel``), timed in turns, on K1's
   s1280 batch (512 x 2051, row 0 dense) and on 131072 FakeCluster rows
   at the 128-byte bucket, with the register K1 on the same rows under
   the 32 patterns; (b) K2g against its plain version on each chunk,
   the carry chained, beside ``chunk_nfa_wide`` on the set's
   1536-state union on the same 8 x 4096 chunks; (c) the cli cell (256
   pods x 4000 lines, 16 long
   lines) with ``--match`` x33, this path's main run (counts zeroed
   just before, read just after: both wide kernels launch, K1's and
   K2g's register kernels and ``chunk_nfa_kernel`` do not), every file
   equal to the ``re`` oracle's, both kernels held on the run's own
   most frequent batches.
   wide160: K1, K2g, K3 and K4 past 160 words, run by the shared-memory
   kernels (``grouped_shift_smem_kernel``, ``grouped_chunk_smem_kernel``,
   ``grouped_gated_smem_kernel``, ``grouped_fused_smem_kernel``), on
   the 32 patterns and a watch list of 700 pods (``WATCH700``: 5 groups
   of 176 words): the same checks as wide's at smaller depth, the cli
   cell at 64 pods, K3 on ``make_patterns(64) + [WATCH700]`` under the
   sweep with its cli cell, and the fused cli cell (``wide160_phase``).
   grouped_chunk_kernel (K2g, the long lines' kernel of a set whose
   union is wider than 1024 states) against its plain version, every
   4096-byte chunk chained, carries and verdicts exactly equal: the
   K = 1024 engine's grouped program (156 groups) over 1, 8 and 33
   lines of 4-96 KiB (some ending on a chunk edge), and a 5-group set
   over 8 lines of 4-64 KiB; then K2g and K2's wide variant
   (``chunk_nfa_wide``, on the 18,878-state union of the same patterns)
   on the same 8 x 4096 chunks, each timed, verdicts equal, with K2g's
   bound and plain time. The sweep line before them carries the K = 1024
   engine's construction seconds and card bytes.
   seqscan (``ops/seqscan.py``, the JAX engine's route for lines over
   128 KiB; no kernel of its own, the products are ``torch.matmul`` in
   fp16): (a) ``classify_line`` and ``tile_transfer_matrices`` on the
   card equal to the same functions on the CPU, bit for bit, on 4 tiles
   at S = 128 (512 classes a tile) and S = 512 (64); (b) the grid: at
   S = 128 and 256 (one pattern, four), one line of 192
   KiB, one of 1 MiB and eight of 128-192 KiB, the tree
   (``match_lines_scan``) and K2 (the engine's ``_match_long`` on the
   same lines) warmed up, then timed by CUDA events in turns, with the
   tree's dense bound (2 S^3 (tile_t - 1) a tile over the fp16 peak)
   and, where the module pads chunk counts to a power of two (eight
   lines at S <= 256), the tree unpadded beside it; every verdict equal
   to ``re``'s; (c) ``match_line_sharded`` over the card listed four
   times on each set's 192 KiB line, verdicts equal to (b)'s (not a
   scaling figure). The engine does not route to it: it lost to K2 at
   every point.
13. engine_k1024: GpuEngineFilter on 512k FakeCluster lines (1% needles)
   and 256 lines of 4-64 KiB; verdicts equal a K1-only engine's on the
   short lines (that engine timed too) and a Python ``re`` oracle (one
   alternation of the 1024 patterns) on the first 32768 lines and all
   long ones; the long lines launch K2g and never K2, and K2g is held
   against its plain version on their most frequent chunk batch.
14. cli_k1024: ``app.run_async`` over 256 pods x 250 lines plus 8 long
   lines with ``--match`` x1024, ``--stats`` and ``-p`` a temporary
   directory: this path's main run (counts zeroed just before, read
   just after; K3 and K2g must launch, K2 must not), every file equal
   to the oracle's lines and the ``prefilter:`` stats line printed.
   Then K3 is held against its plain version and timed on the run's own
   most frequent batch (its pair list held against the plain one there
   too), and K2g on its most frequent chunk batch.

The mesh engine (``klogs_tpu_torch/parallel/``), after them, on the one
card listed several times (it shows the split, each shard's kernels and
the OR across pattern shards, not multi-card scaling); four ``mesh``
lines:

   (a) ``GpuEngineFilter(PATTERNS, engine=MeshEngine(...))`` over grids
   (1,1), (4,1), (2,2) and (1,4) on the engine phase's first frame and
   16 long lines: verdicts equal the single engine's, K1 and
   ``pack_classify_rows`` launched once a shard a width bucket (and K2
   and it on the long lines), lines/s beside the single engine's, K1
   and ``pack_classify_rows`` held against their plain versions on one
   shard's batches; (b) the 1024 patterns on a (2,2) grid: each shard's
   sweep tables on the card, verdicts equal the single K = 1024 engine's, K3
   and its pair list held on one shard's batch; (c) ``app.run_async``
   with the engine factory's device list patched to the card four
   times (the engine asserted a ``MeshEngine``, counts zeroed just
   before and read just after): the cli_k1024 cell (files equal to its
   oracle's) and BASELINE config 5's shape, 4096 pods x 64 lines and 8
   long lines (files equal to the single engine's verdicts, that engine
   held to ``re`` on the first 4096 lines), each launching K2g and never
   K2, K2g held on its own batches; (d) two processes over
   gloo, both ranks on the card, a (1,2) grid over the world's two
   devices, then a world of one over NCCL: every rank's verdicts equal
   the single engine's on 8192 lines.

The observability and fault layers, after them:

15. obs: the cli cell (256 pods x 4000 lines, 16 long lines, --match
   x32) run three times, with ``--stats-json``, ``--trace-json``,
   ``--profile-json`` and ``--metrics-port`` off, on, off: every
   file equal to the oracle's in every run, lines/s of each run and the
   overhead % of "on" beside the layer's design budget (2%, not a
   gate); then once on without ``--trace-json`` (what the JSON-lines
   file costs). In each "on" run the dump's ``lines_in`` and
   ``lines_matched`` equal the oracle's counts, the lines and bytes
   written under ``sink.write`` spans equal the kept ones, the last
   profile line holds the pipeline's stages (and a tick or the scrape
   the fan-out's probe), and one /metrics (all 95 families) and one
   /profile scrape taken mid-run parse. Then the cli_k1024 cell once
   "on" (files exact, every short-line ``device.kernel`` span
   ``swept``); ``dispatch_framed`` on the engine phase's first frame
   under ``torch.cuda.set_sync_debug_mode`` untraced and traced (traced
   may not synchronise more); the cli cell in follow mode under
   ``KLOGS_FAULTS=kube.log_stream:error*8`` (files exact after the
   reconnects, 8 faults fired and 8 retries counted); a short run with
   ``--profile DIR`` whose torch.profiler trace names
   ``grouped_shift_kernel``, ``chunk_nfa_kernel`` and
   ``pack_classify_kernel``.

Follow mode (BASELINE config 4), after them:

16. follow: ``app.run_async`` with ``-a -f --match`` x32 ``--stats``
   over 1000 fixed-clock FakeCluster streams offering a line every 10
   ms each (100,000 lines/s in all; 8 backlogs hold a 5-180 KiB line),
   stopped after 12 s through ``stop``: every file
   equal to the oracle's selection of exactly the lines its stream sent (regenerated
   from ``next_seq``); offered and sustained lines/s, the --stats
   latencies, the deadline flushes, device batches and lines a batch,
   the device busy share of one profiled second, and each matching
   line's emission-to-file latency on 8 tailed streams. K1 is held
   against its plain version on 8 of the run's batches, K2 and
   ``pack_classify_rows`` on one each (counts zeroed just before the
   run).
17. kube_follow: the same entry point on the default ``--cluster kube``
   (``-a -f --timestamps --kubeconfig``) against a fake apiserver in a
   process of its own: 64 pods, 4000 backlog lines each in 4 KiB pieces,
   then a line every 10 ms; 8 streams drop once after 1 s. Every file
   equal to the oracle over the bytes the server sent on that pod's
   connections; every reconnect asks for ``follow`` and ``sinceSeconds``
   without ``tailLines``; every request carries the token.

The log sources, after them (a corpus in a temporary directory,
removed at the end):

18. backfill: ``tools/bench_backfill.py``'s deployment, 8 rotated sets
   (``app-NN.log.2.gz``, ``.1.gz`` at gzip level 1, a plain live
   ``app-NN.log``) of 4,000,000 FakeCluster lines (~126 B, from a
   seeded pool of 16,384 distinct bodies, 1% with a needle) and two
   lines of 4-64 and 128-192 KiB each, through ``app.run_async
   --backfill DIR --match … --stats -p``: (a) the 32 patterns over the
   gzip sets, (b) over the same sets uncompressed, (c) the 1024
   patterns over the gzip sets (the gated path, long lines on K2g).
   Each run: every file equal to the ``re`` oracle's selection in
   rotated order, lines/s, device batches, K1 (or K3), K2 (or K2g) and
   ``pack_classify_rows`` held against their plain versions on the
   run's own batches (counts zeroed just before the run), then a
   backfill of each of its sets' oldest generation under cProfile with a 1 s
   torch.profiler window (the device's busy share).
   Beside them the source alone: the sets drained through
   ``ArchiveStream``.
19. sources: ``--source replay:`` over each set's stream as one file
   (its files equal to run (b)'s), ``-f --source socket:127.0.0.1:0``
   with 8 peer processes of 50,000 lines each (no line lost or
   doubled), and ``-f --source replay:`` with a rename rotation
   mid-run.

The remote filter service, last:

20. filterd: ``python -m klogs_tpu_torch.service --backend cuda``
   --match x32 deployed as its own process (ports read from its banner,
   /readyz awaited). (a) the cli cell as its collector (``--remote``):
   files equal to the oracle, lines/s beside the in-process cli
   phase's, RPCs by method, lines a device batch and the fleet's
   offered and admitted lines from its /metrics; (b) 262,144 FakeCluster
   lines in framed RPCs of 8192 at concurrency 1, 4 and 16 on one
   channel (``tools/bench_service.py``'s shape), 1.5 s each, every
   verdict equal to the in-process engine's: lines/s and lines a device
   batch; (c) an in-process filterd on the card with one collector (32
   pods x 4000 lines + 4 long lines): K1, K2 and ``pack_classify_rows``
   held against their plain versions on the batches it built, then at the
   1024 patterns Hello's ``device_sweep``, a collector of 64 pods x 250
   lines (files = oracle) and K3 with its pair list held on its most
   frequent batch; (d) a collector under
   ``KLOGS_FAULTS=rpc.match:error*2`` (exact files, 2 faults and 2
   retries in its --stats-json), then a collector process whose
   filterd is killed mid-run (a filterd for each, both started at
   once): ``--on-filter-error abort`` exits 1 with one error line,
   ``pass`` writes the lines after the kill unfiltered and counts them.
21. fleet: the sharded tier and the multi-set registry. Three filterd
   processes of the 32 patterns (``KLOGS_FLEET_CAPACITY_LPS`` 2M, 40k
   and 10k) and one ``--multi-set`` one with no ``--match``, started
   at once. (a) the cli cell as one collector of ``--remote A,B,C``,
   round-robin, round-robin again on the first pass's load, and then
   ``--shard-mode hash``: files equal to the oracle, lines/s beside the
   filterd phase's one endpoint, each endpoint's MatchFramed RPCs
   adding up to the collector's ``klogs_shard_batches_total`` (all
   three serve; on the second pass A more than B more than C, as
   their headroom; under hash only the ring's owner); (b) ``--resolver
   file:`` seeded with A and B, 64 slow pods: B killed once it served,
   C written into the file, B started again on its ports, files exact
   with no line degraded, the restarted B serving, and the membership
   events, reroutes and hedges counted; (c) three
   collectors of the multi-set filterd at once (the 32 patterns twice,
   the 1024 on 64 pods x 250 lines and 4 long lines): files exact, 2
   engine builds, Hello's ``multi_set``, and ``nvidia-smi``'s compute
   apps; then a multi-set filterd in this process: K1, K2 and
   ``pack_classify_rows`` held on the 32-pattern set's batches, the
   sweep, K3 (with its pair list) and K2g on the 1024 set's, and
   ``torch.cuda.memory_allocated`` back within
   5% of its level before that set registered once it is evicted; (d)
   a collector over ``KLOGS_TENANT_QUOTA_LINES`` with
   ``--on-filter-error pass`` (its sheds counted and written as
   degraded) beside a sibling set whose files stay exact.

The host engines (``--backend cpu``), after them, in a temporary
``XDG_CACHE_HOME``; every figure of theirs is the host CPU's (its model
and thread count are printed beside the card's):

22. host_engines: (a) ``app.run_async --backend cpu`` on the cli cell
   (the 32 patterns: the DFA engine) and on the cli_k1024 cell (the
   1024: the indexed engine with the host sweep, as a plain
   ``--backend cpu`` run has it): files equal to the oracle's, lines/s
   beside the cuda cli and cli_k1024 phases', the engine kinds, the
   narrowing ratio, the stage seconds and the resolved SIMD tier; (b)
   ``IndexedFilter(sweep="device")`` at K = 1024 on the card over that
   cell's lines: its candidate matrix equal to the host sweep's on
   every 16384-line slab, bit for bit, the sweep's ms a slab on the card
   and on the host, its verdicts equal to the host sweep's filter and
   the oracle's, and ``pack_rows``' launches on this path (zeroed just
   before, read just after); (c) ``python -m klogs_tpu_torch.service
   --backend cpu`` with one ``--remote`` collector (files exact), and a
   ``--multi-set`` server with ``KLOGS_TENANT_QUOTA_LINES`` set whose
   indexed set, evicted and registered again, loads its DFA tables
   from the cache on disk (a ``hit`` a table; files exact both times);
   (d) ``dfa_scan``, ``sweep_candidates`` (every tier the CPU has, 8
   and 16 buckets) and ``group_scan`` of the library the loader built
   in this run, against their plain versions (0 mismatches), C and
   plain ms.

Every phase line carries ``phase_s``, the seconds since the line
before it. Then a ``kernels`` line (each kernel's time beside its bound
and its plain version's time, with its launches on its main path, on
the backfill, in the fleet's registry, on the mesh (K1 on (a)'s (2,2)
grid, K3, K2g and ``pack_classify_rows`` on (c)'s cli_k1024 cell): the
four NFA kernels, K2g, the wide route's two kernels (their main path
the ``wide`` phase's cli cell, K1's time the watch-list batch beside
K4's generic wide kernel, K2g's the 8 x 4096 chunks beside
``chunk_nfa_wide``), ``pack_classify_rows`` and ``pack_rows`` (whose
main path is the host engines' device sweep); K2g's main path is
cli_k1024, its time the
8 x 4096 chunks of the 1024 patterns, beside ``chunk_nfa_wide``'s),
the card line, and
last ``{"ok": true,
"device": {...}}``. Any failed phase exits
non-zero without that line, as does a run with no CUDA device or
outside a checkout.
"""

import asyncio
import concurrent.futures
import contextlib
import functools
import gc
import io
import json
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback

# bench.PATTERNS: the repository's 32-pattern north-star set.
PATTERNS = [
    "panic:", "oom-killer", "segfault", "kernel:", "watchdog",
    "connection refused", "deadline exceeded", "unauthorized", "forbidden",
    "disk .*full", r"timeout|timed out", "TRACE", "FATAL", "backoff",
    r"retry \d+/\d+", r"GET /api/v\d+ 404", r"x-request-id: [0-9a-f]+",
    r"uid=\d{5,}", r"latency=49\dms", r"code=50[34]", r"seq=99999",
    r"ERROR.*path=/api/v2/admin", r"WARN.*latency=4[89]\dms",
    r"c[0-9]+ seq=123456", "failed path=/api/v9", r"5[12]\d [A-Z]{4,}",
    r"\d+ms code=418", "ECONNRESET", "EPIPE", "broken pipe",
    r"(?:FATAL|CRIT).*code=\d+", r"msg=\"request failed path=/api/v1/items\"",
]
NEEDLES = [b"panic: x", b"oom-killer", b"code=503", b"retry 3/5",
           b"uid=1234567", b"FATAL a code=9", b"latency=495ms", b"EPIPE",
           b"GET /api/v2 404", b"x-request-id: 9f0a", b"disk is full",
           b"timed out", b"517 ABCDE", b"broken pipe"]


def watch_list(n: int) -> str:
    """A watch list of ``n`` pods written as one alternation: "the lines
    of any of pods pod-0001, pod-0003, ...", 8 positions a pod."""
    return ("pod=(?:" + "|".join(f"pod-{p:04d}" for p in range(1, 2 * n, 2))
            + ")")


# A watch list of 128 pods ("the lines of any of these 128 pods"): 1,028
# Glushkov positions, so every group of a set that holds it runs at 1152
# states (36 words), past the register widths. 700 pods (5,604
# positions) put every group at 5632 states, 176 words: past 160, the
# shared-memory route (under KLOGS_MAX_PATTERN_POSITIONS past 4096).
WATCH = watch_list(128)
WATCH700 = watch_list(700)


def make_patterns(k: int) -> "list[str]":
    """bench.make_patterns: the 32 patterns plus minted alerting-rule
    families, k in all."""
    out = list(PATTERNS)
    fam = [
        lambda i: f"svc-{i:04d} unreachable",
        lambda i: rf"errcode={i:05d}\b",
        lambda i: f"tenant-{i:04d}.*quota exceeded",
        lambda i: rf"CRIT{i:05d}",
        lambda i: rf"trace=[0-9a-f]+ span={i:06d}",
        lambda i: f"deploy/rel-{i:04d} failed",
        lambda i: rf"(?:FATAL|PANIC) job-{i:05d}",
        lambda i: rf"user=u{i:06d} denied",
    ]
    i = 0
    while len(out) < k:
        out.append(fam[i % len(fam)](i))
        i += 1
    return out[:k]


def minted_needle(i: int) -> bytes:
    """A line fragment of minted family member i (i >= 992 is not in the
    1024 set: a near miss that shares the family's literals)."""
    return [f"svc-{i:04d} unreachable", f"errcode={i:05d}",
            f"tenant-{i:04d} over quota exceeded", f"CRIT{i:05d}",
            f"trace=9f{i % 7} span={i:06d}", f"deploy/rel-{i:04d} failed",
            f"PANIC job-{i:05d}", f"user=u{i:06d} denied"][i % 8].encode()


SEED = 20261016
CLOCK = 1_753_800_000.0
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and dense int8 ops/s.
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1.979e15
SOURCE = "klogs_tpu_torch/ops/csrc/nfa_kernels.cu"


# When the last phase line was printed: each phase line carries the
# seconds since (``phase_s``), its phase's time, for the next budget.
_LAST_EMIT = [time.perf_counter()]


def emit(obj: dict) -> None:
    if "phase" in obj:
        now = time.perf_counter()
        obj = {**obj, "phase_s": now - _LAST_EMIT[0]}
        _LAST_EMIT[0] = now
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def env_set(name: str, value: str):
    """``os.environ[name] = value`` for the block, restored after."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it)."""
    tb, to = n_bytes / HBM_BYTES_S, n_ops / INT8_OPS_S
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


def step_bounds(n_bytes: int, S: int, C: int, steps: int, active: int) -> dict:
    """Bounds of ``steps`` (line, group, step) updates of an S-state,
    C-class automaton. The step as int8 products (followT.v, maskT.onehot)
    counts 2*S*(S+C) operations each when dense; the data needs only the
    nonzero terms: S per set state bit read (``active`` in all) plus S
    for the one class row, which is what the bitset kernels do. The
    sparse count is the bound; the dense one is reported beside it."""
    b_ms, b_by = bound(n_bytes, 2 * S * (active + steps))
    d_ms, d_by = bound(n_bytes, 2 * steps * S * (S + C))
    return dict(bound_ms=b_ms, bound_by=b_by, dense_bound_ms=d_ms,
                dense_bound_by=d_by, bytes_ms=n_bytes / HBM_BYTES_S * 1e3)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` runs, by CUDA events, after one
    warm-up run."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rows_with_needles(np, rng, B: int, width: int, lo: int, printable: bool):
    """[B, width] uint8 rows with lengths in [lo, width] and a needle
    planted in every third row."""
    lens = rng.integers(lo, width + 1, size=B)
    if printable:
        rows = rng.integers(32, 127, size=(B, width), dtype=np.uint8)
    else:
        rows = rng.integers(0, 256, size=(B, width), dtype=np.uint8)
    for i in range(0, B, 3):
        nd = NEEDLES[(i // 3) % len(NEEDLES)]
        if lens[i] >= len(nd):
            p = int(rng.integers(0, lens[i] - len(nd) + 1))
            rows[i, p:p + len(nd)] = np.frombuffer(nd, dtype=np.uint8)
    return rows, lens.astype(np.int32)


def oracle_fn():
    union = re.compile(b"|".join(b"(?:" + p.encode() + b")" for p in PATTERNS))
    return lambda body: union.search(body) is not None


@functools.lru_cache(maxsize=2)
def _alternation(patterns: tuple) -> "re.Pattern":
    return re.compile(b"|".join(b"(?:" + p.encode() + b")" for p in patterns))


def _oracle_chunk(patterns: tuple, bodies: list) -> list:
    union = _alternation(patterns)
    return [union.search(b) is not None for b in bodies]


def oracle_verdicts(patterns: list, bodies: list, step: int = 2048) -> list:
    """``re`` verdicts of one alternation of ``patterns`` over
    ``bodies``, ``step`` bodies a task over worker processes (a 1024-way
    alternation costs about 1 ms a line); the pool is shut down before
    returning."""
    pats = tuple(patterns)
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1), mp_context=ctx) as ex:
        parts = ex.map(_oracle_chunk, [pats] * (-(-len(bodies) // step)),
                       [bodies[i:i + step] for i in range(0, len(bodies), step)])
        return [v for part in parts for v in part]


def build_phase(nk, pack, build):
    """Every kernel source compiled at once (one nvcc each, in parallel),
    then loaded."""
    t0 = time.perf_counter()
    names = sorted(f[:-3] for f in os.listdir(build.CSRC) if f.endswith(".cu"))
    with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        list(ex.map(build.build, names))
    nk._library()
    pack._library()
    seconds = time.perf_counter() - t0
    regs = []
    for name in names:
        for m in re.finditer(
                r"entry function '([^']+)'.*?Used (\d+) registers",
                build.build_logs.get(name, ""), re.S):
            regs.append({"kernel": m.group(1), "registers": int(m.group(2))})
    emit({"phase": "build", "sources": names, "seconds": seconds,
          "ptxas": regs})


def card_phase(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return card


def k1_check(torch, nk, dp, live, acc, cls, reps: int,
             plain_rows: "int | None" = None) -> dict:
    """Kernel vs plain on one cls batch, timed, with its bounds. With
    ``plain_rows`` the kernel runs and is timed (``ms``) on the whole
    batch and the plain version on its first ``plain_rows`` rows, which
    the kernel's verdicts there are held to; the bounds are then those
    rows', beside the kernel's time on them (``held_ms``)."""
    got = nk.match_cls_grouped(dp, live, acc, cls)
    B, T = cls.shape
    held = min(plain_rows or B, B)
    work: dict = {}
    torch.cuda.synchronize()
    exp, plain_ms = timed_call(torch, lambda: nk.match_cls_grouped_plain(
        dp, live, acc, cls[:held], work=work))
    err = int((got[:held].int() - exp.int()).abs().max()) if held else 0
    ms = cuda_ms(torch, lambda: nk.match_cls_grouped(dp, live, acc, cls), reps)
    held_ms = ms if held == B else cuda_ms(
        torch, lambda: nk.match_cls_grouped(dp, live, acc, cls[:held]), reps)
    G, C, S = dp.char_mask.shape
    n_bytes = held * T * 2 + G * (S + C) * (S // 32) * 4 + held
    return dict(rows=B, T=T, states=S, groups=G, max_abs_err=err, ms=ms,
                plain_rows=held, held_ms=held_ms, plain_ms=plain_ms,
                matched=int(exp.sum()),
                active_per_step=work["active"] / (held * G * T),
                exc_per_step=work["exc"] / (held * G * T),
                **step_bounds(n_bytes, S, C, held * G * T, work["active"]))


def k4_check(torch, nk, dp, live, acc, cls, reps: int,
             time_plain: bool = False, step: "int | None" = None,
             plain_rows: "int | None" = None) -> dict:
    """K4 against its plain version (over slices of ``step`` rows) and
    against K1 on one cls batch; K1 and K4 timed in turns, each beside
    the bounds of K1's function (K4 computes it over the same bytes).
    ``plain_ms`` only with ``time_plain``. With ``plain_rows`` the plain
    version runs on the first ``plain_rows`` rows only, and the bounds
    are those rows', beside K4's time on them (``held_ms``)."""
    got = nk.match_cls_grouped_fused(dp, live, acc, cls)
    k1 = nk.match_cls_grouped(dp, live, acc, cls)
    B, T = cls.shape
    held = min(plain_rows or B, B)
    step = step or held
    work: dict = {}
    err = 0
    for i in range(0, held, step):
        j = min(i + step, held)
        exp = nk.match_cls_grouped_fused_plain(dp, live, acc, cls[i:j],
                                               work=work)
        err = max(err, int((got[i:j].int() - exp.int()).abs().max()))
    torch.cuda.synchronize()
    k1_ms = cuda_ms(torch, lambda: nk.match_cls_grouped(dp, live, acc, cls),
                    reps)
    ms = cuda_ms(torch, lambda: nk.match_cls_grouped_fused(dp, live, acc,
                                                           cls), reps)
    held_ms = ms if held == B else cuda_ms(
        torch, lambda: nk.match_cls_grouped_fused(dp, live, acc, cls[:held]),
        reps)
    G, C, S = dp.char_mask.shape
    n_bytes = held * T * 2 + G * (S + C) * (S // 32) * 4 + held * 4
    res = dict(rows=B, T=T, states=S, groups=G, max_abs_err=err,
               k1_mismatches=int((got != k1).sum()), ms=ms, k1_ms=k1_ms,
               plain_rows=held, held_ms=held_ms,
               matched=int(got.sum()), active_per_step=work["active"]
               / (held * G * T), exc_per_step=work["exc"] / (held * G * T),
               **step_bounds(n_bytes, S, C, held * G * T, work["active"]))
    if time_plain:
        res["plain_ms"] = cuda_ms(torch, lambda: (
            nk.match_cls_grouped_fused_plain(dp, live, acc, cls)), 1)
    return res


def k1_phase(torch, np, nfa, nk, synthetic_line, dev, rows_128=131072,
             rows_4096=4096):
    """K1's cases; returns (results, {case: (program, live, acc, cls)})
    for the K4 phase to reuse."""
    rng = np.random.default_rng(SEED)
    dp, live, acc = nfa.compile_grouped(PATTERNS, device=dev)
    results, batches = {}, {}
    # rows_128 rows at the 128-byte bucket: half synthetic log lines,
    # half random bytes with planted needles.
    B, W = rows_128, 128
    rows, lens = rows_with_needles(np, rng, B, W, 0, printable=False)
    for i in range(B // 2):
        ln = synthetic_line(f"pod-{i % 256:04d}", f"c{i % 3}", i,
                            CLOCK + i).rstrip(b"\n")
        rows[i, :len(ln)] = np.frombuffer(ln, dtype=np.uint8)
        lens[i] = len(ln)
    cls = nfa.classify_chunk(dp, torch.from_numpy(rows).to(dev),
                             torch.from_numpy(lens).to(dev), True, True)
    results["w128"] = k1_check(torch, nk, dp, live, acc, cls, 20)
    batches["w128"] = (dp, live, acc, cls)
    # rows_4096 rows at the 4096 bucket.
    B, W = rows_4096, 4096
    rows, lens = rows_with_needles(np, rng, B, W, 2049, printable=False)
    cls = nfa.classify_chunk(dp, torch.from_numpy(rows).to(dev),
                             torch.from_numpy(lens).to(dev), True, True)
    results["w4096"] = k1_check(torch, nk, dp, live, acc, cls, 5)
    batches["w4096"] = (dp, live, acc, cls)
    # A 256-state group (register path, W=8) and a 1280-state group (40
    # words: the wide shift kernel).
    for name, pats in (("s256", ["a" * 200 + "b", r"x\d+y"]),
                       ("s1280", ["q" * 1200 + "z", "panic:"])):
        dpx, lx, ax = nfa.compile_grouped(pats, device=dev)
        rows, lens = rows_with_needles(np, rng, 512, 2048, 0, printable=True)
        rows[0, :len(pats[0])] = np.frombuffer(pats[0].encode(), np.uint8)
        lens[0] = max(lens[0], len(pats[0]))
        cls = nfa.classify_chunk(dpx, torch.from_numpy(rows).to(dev),
                                 torch.from_numpy(lens).to(dev), True, True)
        results[name] = k1_check(torch, nk, dpx, lx, ax, cls, 1)
        batches[name] = (dpx, lx, ax, cls)
    emit({"phase": "grouped_nfa_kernel", **results})
    worst = max(r["max_abs_err"] for r in results.values())
    if worst != 0 or results["s1280"]["matched"] == 0:
        raise AssertionError(f"grouped_nfa_kernel disagrees: {results}")
    return results, batches


def chunk_chain(torch, np, nfa, nk, prog, live, acc, rows, lens, L, dev):
    """Chain kernel and plain over all chunks, each timed; returns the
    per-launch means with the bounds."""
    B = rows.shape[0]
    n_chunks = -(-int(lens.max()) // L)
    C, S = prog.char_mask.shape
    v = nk.initial_state(prog, live, B)
    vp = v.clone()
    rows_d = torch.from_numpy(rows).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    err, k_ms, p_ms, n_bytes, steps = 0, 0.0, 0.0, 0, 0
    work: dict = {}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    # One untimed launch first: the program's bit tables are built, and
    # the kernel loaded, at its first call.
    nk.match_chunk_cls(prog, acc, nfa.classify_chunk(
        prog, rows_d[:, :L].contiguous(), lens_d, True, False), v, False)
    for k in range(n_chunks):
        final = k == n_chunks - 1
        cls = nfa.classify_chunk(prog, rows_d[:, k * L:(k + 1) * L].contiguous(),
                                 lens_d - k * L, k == 0, final)
        T = cls.shape[1]
        ev[0].record()
        v, m = nk.match_chunk_cls(prog, acc, cls, v, final)
        ev[1].record()
        vp, mp = nk.match_chunk_cls_plain(prog, acc, cls, vp, work=work)
        if final and prog.match_all:
            mp = torch.ones_like(mp)
        ev[2].record()
        ev[2].synchronize()
        k_ms += ev[0].elapsed_time(ev[1])
        p_ms += ev[1].elapsed_time(ev[2])
        err = max(err, int((v.int() - vp.int()).abs().max()),
                  int((m.int() - mp.int()).abs().max()))
        n_bytes += B * T * 2 + 2 * B * S + B + (S + C) * (S // 32) * 4
        steps += B * T
    n = n_chunks
    res = dict(lines=B, chunks=n, states=S, max_abs_err=err, ms=k_ms / n,
               us_per_step=k_ms * 1e3 / (steps / B), plain_ms=p_ms / n,
               matched=int(m.sum()), active_per_step=work["active"] / steps,
               **step_bounds(n_bytes, S, C, steps, work["active"]))
    # Per launch, like ms.
    for k in ("bound_ms", "dense_bound_ms", "bytes_ms"):
        res[k] /= n
    return res


def k2_check(torch, nk, prog, acc, cls, v0, final, reps: int) -> dict:
    """K2 against its plain version (carry and matched) on one chunk
    batch, timed, with its bounds."""
    v, m = nk.match_chunk_cls(prog, acc, cls, v0, final)
    work: dict = {}
    torch.cuda.synchronize()
    (vp, mp), plain_ms = timed_call(torch, lambda: nk.match_chunk_cls_plain(
        prog, acc, cls, v0, work=work))
    if final and prog.match_all:
        mp = torch.ones_like(mp)
    err = max(int((v.int() - vp.int()).abs().max()),
              int((m.int() - mp.int()).abs().max()))
    ms = cuda_ms(torch, lambda: nk.match_chunk_cls(prog, acc, cls, v0, final),
                 reps)
    B, T = cls.shape
    C, S = prog.char_mask.shape
    n_bytes = B * T * 2 + 2 * B * S + B + (S + C) * (S // 32) * 4
    return dict(rows=B, T=T, states=S, final=final, max_abs_err=err, ms=ms,
                us_per_step=ms * 1e3 / T, plain_ms=plain_ms,
                matched=int(m.sum()), active_per_step=work["active"] / (B * T),
                **step_bounds(n_bytes, S, C, B * T, work["active"]))


def k2_phase(torch, np, nfa, nk, compile_patterns, dev, lines=1024,
             chunk=4096, max_chunks=32) -> dict:
    rng = np.random.default_rng(SEED + 1)
    union = compile_patterns(PATTERNS)
    prog = nfa.pack_program(nfa.augment(union), device=dev)
    live, acc = union.n_states, union.n_states + 1
    L, B, K = chunk, lines, max_chunks
    rows, lens = rows_with_needles(np, rng, B, K * L, L, printable=False)
    lens[:B // 16] = L * rng.integers(1, K + 1, size=B // 16)  # END on an edge
    lens[1] = K * L
    rows[1, K * L - 6:] = np.frombuffer(b"EPIPE!", np.uint8)
    res = {"s512": chunk_chain(torch, np, nfa, nk, prog, live, acc, rows,
                               lens, L, dev)}
    # A 640-state union program (run padded to 1024 states) and one wider
    # than 1024 states (the "wide" kernel).
    for name, pats in (("s640", ["q" * 600 + "z", "panic:"]),
                       ("s1536", ["q" * 700 + "z", "w" * 700 + "k",
                                  "panic:"])):
        union = compile_patterns(pats)
        uprog = nfa.pack_program(nfa.augment(union), device=dev)
        urows, ulens = rows_with_needles(np, rng, 64, 3 * 1024, 1025,
                                         printable=True)
        needle = pats[0].encode()
        urows[2, 100:100 + len(needle)] = np.frombuffer(needle, np.uint8)
        res[name] = chunk_chain(torch, np, nfa, nk, uprog, union.n_states,
                                union.n_states + 1, urows, ulens, 1024, dev)
    emit({"phase": "chunk_nfa_kernel", **res})
    if any(r["max_abs_err"] or not r["matched"] for r in res.values()):
        raise AssertionError(f"chunk_nfa_kernel disagrees: {res}")
    return res


def k2g_check(torch, nk, prog, live, acc, cls, v0, final, reps: int) -> dict:
    """K2g against its plain version (carry and matched) on one chunk
    batch, timed, with its bounds."""
    v, m = nk.match_chunk_cls_grouped(prog, live, acc, cls, v0, final)
    work: dict = {}
    torch.cuda.synchronize()
    (vp, mp), plain_ms = timed_call(
        torch, lambda: nk.match_chunk_cls_grouped_plain(
            prog, live, acc, cls, v0, work=work))
    if final and prog.match_all:
        mp = torch.ones_like(mp)
    err = max(int((v.long() - vp.long()).abs().max()),
              int((m.int() - mp.int()).abs().max()))
    ms = cuda_ms(torch, lambda: nk.match_chunk_cls_grouped(
        prog, live, acc, cls, v0, final), reps)
    B, T = cls.shape
    G, C, S = prog.char_mask.shape
    W, steps = S // 32, B * G * T
    # Class ids, the carry in and out, the verdicts, and the group
    # tables (follow rows and constants, mask rows with the zero row).
    n_bytes = (B * T * 2 + 2 * B * G * W * 4 + B
               + G * (S * W + (C + 2) * W + 4 * W) * 4)
    return dict(rows=B, T=T, states=S, groups=G, final=final,
                max_abs_err=err, ms=ms, us_per_step=ms * 1e3 / T,
                plain_ms=plain_ms, matched=int(m.sum()),
                active_per_step=work["active"] / steps,
                exc_per_step=work["exc"] / steps,
                **step_bounds(n_bytes, S, C, steps, work["active"]))


def held_k2g(torch, nk, calls: dict) -> list:
    """K2g against its plain version on the run's most frequent chunk
    batch shape (``launches``: the run's count of that shape)."""
    out = []
    for count, seen in sorted(calls.get("match_chunk_cls_grouped", {})
                              .values(), key=lambda e: -e[0])[:1]:
        a, kw = seen[0]
        final = kw.get("final", a[5] if len(a) > 5 else True)
        out.append(dict(launches=count,
                        **k2g_check(torch, nk, *a[:5], final, 5)))
    return out


def long_rows(np, rng, B: int, L: int, lo: int, hi: int, needles: list):
    """[B, hi] printable rows with lengths in [lo, hi] (a third of them
    on a chunk edge of L bytes, row 0 the longest) and ``needles``
    planted: in every other row, one row's on a chunk edge, one row's
    across one."""
    lens = rng.integers(lo, hi + 1, size=B)
    for i in range(1, B, 3):
        lens[i] = L * int(rng.integers(-(-lo // L), hi // L + 1))
    lens[0] = hi
    rows = rng.integers(32, 127, size=(B, hi), dtype=np.uint8)
    for i in range(0, B, 2):
        nd = needles[int(rng.integers(0, len(needles)))]
        p = int(rng.integers(0, lens[i] - len(nd) + 1))
        rows[i, p:p + len(nd)] = np.frombuffer(nd, np.uint8)
    if B > 2:
        nd = needles[0]
        p = int(lens[1]) - len(nd)  # ends on the line's last chunk edge
        rows[1, p:p + len(nd)] = np.frombuffer(nd, np.uint8)
        p = L - len(nd) // 2  # across the first edge
        rows[2, p:p + len(nd)] = np.frombuffer(nd, np.uint8)
    return rows, lens.astype(np.int32)


def k2g_chain(torch, nfa, nk, prog, live, acc, rows, lens, L, dev,
              sizes: tuple) -> dict:
    """K2g chained over every chunk of the first b rows, for each b in
    ``sizes`` (row 0 the longest, so each runs every chunk), and its
    plain version once over all rows (a row's steps depend on that row
    alone): each size's carries and verdicts equal the plain version's
    first b after each chunk. Per size: the launch's mean ms, and the
    plain version's over all rows."""
    B = rows.shape[0]
    n = -(-int(lens.max()) // L)
    if -(-int(lens[0]) // L) != n:
        raise ValueError("row 0 must be the longest")
    rows_d = torch.from_numpy(rows).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    v = {b: nk.initial_state_grouped(prog, live, b) for b in sizes}
    vp = nk.initial_state_grouped(prog, live, B)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    err = dict.fromkeys(sizes, 0)
    k_ms = dict.fromkeys(sizes, 0.0)
    p_ms, steps = 0.0, 0
    # One untimed launch first: the program's tables are built at its
    # first call.
    nk.match_chunk_cls_grouped(prog, live, acc, nfa.classify_chunk(
        prog, rows_d[:, :L].contiguous(), lens_d, True, False), vp, False)
    for k in range(n):
        final = k == n - 1
        cls = nfa.classify_chunk(
            prog, rows_d[:, k * L:(k + 1) * L].contiguous(), lens_d - k * L,
            k == 0, final)
        m = {}
        for b in sizes:
            ev[0].record()
            v[b], m[b] = nk.match_chunk_cls_grouped(prog, live, acc,
                                                    cls[:b], v[b], final)
            ev[1].record()
            ev[1].synchronize()
            k_ms[b] += ev[0].elapsed_time(ev[1])
        ev[0].record()
        vp, mp = nk.match_chunk_cls_grouped_plain(prog, live, acc, cls, vp)
        ev[1].record()
        ev[1].synchronize()
        p_ms += ev[0].elapsed_time(ev[1])
        if final and prog.match_all:
            mp = torch.ones_like(mp)
        for b in sizes:
            err[b] = max(err[b], int((v[b].long() - vp[:b].long()).abs().max()),
                         int((m[b].int() - mp[:b].int()).abs().max()))
        steps += cls.shape[1]
    return {b: dict(lines=b, chunks=n, groups=int(prog.follow.shape[0]),
                    max_abs_err=err[b], ms=k_ms[b] / n,
                    us_per_step=k_ms[b] * 1e3 / steps, plain_ms=p_ms / n,
                    plain_lines=B, matched=int(m[b].sum()),
                    longest=int(lens[:b].max()),
                    edge_lines=int((lens[:b] % L == 0).sum()))
            for b in sizes}


def k2g_against_wide(torch, np, nfa, nk, compile_patterns, pats, long, rng,
                     dev, B=8, n_chunks=4, L=4096, reps=20,
                     needles=None) -> dict:
    """K2g on the grouped program and K2's wide variant
    (``chunk_nfa_wide``) on the augmented union of the same patterns,
    over the same B x L chunks of B lines n_chunks chunks long, each
    chunk timed; K2g held against its plain version there (its bounds),
    and the two kernels' verdicts equal. ``needles`` default to minted
    family members and the 32 patterns' needles."""
    gp, live, acc = long
    union = compile_patterns(pats)
    up = nfa.pack_program(nfa.augment(union), device=dev)
    if nk.kernel_states(up.n_states) <= 1024:
        raise AssertionError("the union fits the register K2")
    if needles is None:
        needles = [minted_needle(int(i)) for i in
                   rng.integers(0, 992, size=8)] + NEEDLES
    rows, lens = long_rows(np, rng, B, L, (n_chunks - 1) * L + 1,
                           n_chunks * L, needles)
    rows_d = torch.from_numpy(rows).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    vg = nk.initial_state_grouped(gp, live, B)
    vu = nk.initial_state(up, union.n_states, B)
    per = []
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    # One untimed launch of the union's kernel first, as K2g's timing
    # warms K2g up (the program's tables are built at its first call).
    nk.match_chunk_cls(up, union.n_states + 1, nfa.classify_chunk(
        up, rows_d[:, :L].contiguous(), lens_d, True, False), vu, False)
    for k in range(n_chunks):
        final = k == n_chunks - 1
        chunk = rows_d[:, k * L:(k + 1) * L].contiguous()
        cg = nfa.classify_chunk(gp, chunk, lens_d - k * L, k == 0, final)
        cu = nfa.classify_chunk(up, chunk, lens_d - k * L, k == 0, final)
        r = k2g_check(torch, nk, gp, live, acc, cg, vg, final, reps)
        vg, mg = nk.match_chunk_cls_grouped(gp, live, acc, cg, vg, final)
        ev[0].record()
        vu, mu = nk.match_chunk_cls(up, union.n_states + 1, cu, vu, final)
        ev[1].record()
        ev[1].synchronize()
        r["wide_ms"] = ev[0].elapsed_time(ev[1])
        per.append(r)
    torch.cuda.synchronize()
    n = len(per)
    mean = {key: sum(r[key] for r in per) / n
            for key in ("ms", "us_per_step", "plain_ms", "wide_ms",
                        "bound_ms", "dense_bound_ms", "bytes_ms")}
    bounds = [r["bound_by"] for r in per]
    return dict(lines=B, chunks=n, union_states=up.n_states,
                groups=int(gp.follow.shape[0]), **mean,
                bound_by=max(set(bounds), key=bounds.count),
                wide_us_per_step=mean["wide_ms"] * 1e3 / per[0]["T"],
                max_abs_err=max(r["max_abs_err"] for r in per),
                verdict_mismatches=int((mg != mu).sum()),
                matched=int(mg.sum()), per_chunk=per)


def grouped_chunk_phase(torch, np, nfa, nk, compile_patterns, eng1024,
                        dev, L=4096) -> dict:
    """K2g (``grouped_chunk_kernel``) against its plain version, every
    chunk chained, carries and verdicts exactly equal: the K = 1024
    engine's grouped program (156 groups) over the first 1, 8 and 33 of
    33 long lines of 4-96 KiB, and a 5-group set; then K2g and
    ``chunk_nfa_wide`` timed on the same 8 x 4096 chunks of the 1024
    patterns."""
    rng = np.random.default_rng(SEED + 16)
    pats = make_patterns(1024)
    long = eng1024._long
    if long is None or eng1024._aug is not None:
        raise AssertionError("the K = 1024 engine is not on the grouped "
                             "route")
    needles = [minted_needle(int(i)) for i in
               rng.integers(0, 992, size=16)] + NEEDLES
    rows, lens = long_rows(np, rng, 33, L, 4 * 1024, 96 * 1024, needles)
    res = {f"k1024_b{b}": r for b, r in k2g_chain(
        torch, nfa, nk, *long, rows, lens, L, dev, (1, 8, 33)).items()}
    pats5 = make_patterns(40)
    g5 = nfa.compile_grouped(pats5, device=dev)
    rows, lens = long_rows(np, rng, 8, L, 4 * 1024, 64 * 1024,
                           [minted_needle(i) for i in range(8)] + NEEDLES)
    res["g5_b8"] = k2g_chain(torch, nfa, nk, *g5, rows, lens, L, dev,
                             (8,))[8]
    res["vs_wide"] = k2g_against_wide(torch, np, nfa, nk, compile_patterns,
                                      pats, long, rng, dev)
    emit({"phase": "grouped_chunk_kernel", **res})
    if (any(r["max_abs_err"] or not r["matched"] for r in res.values())
            or res["g5_b8"]["groups"] != 5
            or res["vs_wide"]["verdict_mismatches"]):
        raise AssertionError(f"grouped_chunk_kernel disagrees: {res}")
    return res


# ---- past 32 words: K1's and K2g's wide shift kernels ---------------------

WATCH_NEEDLES = [b"pod=pod-0001", b"pod=pod-0255", b"pod=pod-0129",
                 b"pod=pod-0002", b"pod=pod-025"]


def watch_rows(np, synthetic_line, B: int, width: int):
    """[B, width] FakeCluster rows (pods pod-0000 to pod-0255, so every
    other pod is on the watch list), each line cut to ``width``."""
    rows = np.zeros((B, width), dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for i in range(B):
        ln = synthetic_line(f"pod-{i % 256:04d}", f"c{i % 3}", i,
                            CLOCK + i).rstrip(b"\n")[:width]
        rows[i, :len(ln)] = np.frombuffer(ln, dtype=np.uint8)
        lens[i] = len(ln)
    return rows, lens


def wide_k1_check(torch, nk, dp, live, acc, cls, reps: int, k4_reps: int,
                  step: int, plain_rows: "int | None" = None) -> dict:
    """K1's wide kernel (``grouped_shift_wide_kernel``; past 160 words
    ``grouped_shift_smem_kernel``) against its plain version, over
    slices of ``step`` rows of the first ``plain_rows`` (all by
    default), on one batch; beside K4's (``grouped_fused_wide_kernel``,
    ``grouped_fused_smem_kernel``: K1's schedule, a zeroed word a line)
    on the same batch, against the same plain version and K1's verdicts.
    K1 and K4 timed in turns (K1, K4, K4, K1) by CUDA events around the
    wrappers on the whole batch, each kernel alone by torch.profiler;
    the bounds of K1's function (which K4 computes too) are those of the
    rows held (``step_bounds`` from the state bits the plain version
    read there, ``plain_ms`` on them), beside K1's and K4's times on
    the same rows (``held_ms``, ``held_k4_ms``)."""
    got = nk.match_cls_grouped(dp, live, acc, cls)
    k4 = nk.match_cls_grouped_fused(dp, live, acc, cls)
    B, T = cls.shape
    held = plain_rows or B
    work: dict = {}
    err = k4_err = 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    for i in range(0, held, step):
        j = min(i + step, held)
        exp = nk.match_cls_grouped_plain(dp, live, acc, cls[i:j], work=work)
        err = max(err, int((got[i:j].int() - exp.int()).abs().max()))
        k4_err = max(k4_err, int((k4[i:j].int() - exp.int()).abs().max()))
    ev[1].record()
    ev[1].synchronize()
    plain_ms = ev[0].elapsed_time(ev[1])

    def k1():
        return nk.match_cls_grouped(dp, live, acc, cls)

    def k4f():
        return nk.match_cls_grouped_fused(dp, live, acc, cls)

    def k1_held():
        return nk.match_cls_grouped(dp, live, acc, cls[:held])

    def k4_held():
        return nk.match_cls_grouped_fused(dp, live, acc, cls[:held])

    turns = [cuda_ms(torch, k1, reps), cuda_ms(torch, k4f, k4_reps),
             cuda_ms(torch, k4f, k4_reps), cuda_ms(torch, k1, reps)]
    held_turns = turns if held == B else [
        cuda_ms(torch, k1_held, reps), cuda_ms(torch, k4_held, k4_reps),
        cuda_ms(torch, k4_held, k4_reps), cuda_ms(torch, k1_held, reps)]
    G, C, S = dp.char_mask.shape
    names = nk._NAMES[nk._route(nk.kernel_states(S) // 32)]
    n_bytes = held * T * 2 + G * (S + C) * (S // 32) * 4 + held
    return dict(rows=B, T=T, states=S, groups=G, plain_rows=held,
                max_abs_err=err, k4_max_abs_err=k4_err,
                k4_mismatches=int((got != k4).sum()),
                ms=min(turns[0], turns[3]), k4_ms=min(turns[1], turns[2]),
                turns_ms=turns,
                held_ms=min(held_turns[0], held_turns[3]),
                held_k4_ms=min(held_turns[1], held_turns[2]),
                kernel_ms=kernel_alone_ms(torch, k1, reps, names["k1"]),
                k4_kernel_ms=kernel_alone_ms(torch, k4f, k4_reps,
                                             names["k4"]),
                plain_ms=plain_ms, matched=int(got.sum()),
                active_per_step=work["active"] / (held * G * T),
                exc_per_step=work["exc"] / (held * G * T),
                **step_bounds(n_bytes, S, C, held * G * T, work["active"]))


def wide_cli(torch, np, nk, app, cli, term, FakeCluster, dev, n_pods=256,
             lines_per_pod=4000, fused=False, pats=None, n_long=16,
             check_rows=None) -> dict:
    """(c) The user's entry point on the wide set: ``app.run_async`` over
    the cli cell's FakeCluster (256 pods x 4000 lines, 16 long lines of
    5-180 KiB) with ``--match`` x33 (the 32 patterns and the watch list);
    this path's main run (counts zeroed just before, read just after:
    K1's and K2g's wide kernels launch, K1's and K2g's register kernels
    and K2, whose wide variant is ``chunk_nfa_wide``, do not); every file
    equal to the ``re`` oracle's. Then K1's wide kernel is held against
    its plain version on the run's most frequent batch, and K2g's on its
    most frequent chunk batch. (f) With ``fused`` (the caller sets
    ``KLOGS_TPU_FUSED_GROUPS=1``) the short lines take K4's wide kernel
    instead of K1's, held against its plain version and K1 there. With
    ``pats`` (past 160 words: ``PATTERNS + [WATCH700]``) the kernels are
    that width's (the shared-memory ones), the cluster has ``n_long``
    long lines, and the short-line batch (run and timed whole) is held
    to the plain version on its first ``check_rows`` rows."""
    fc, n_lines = cli_cluster(np, FakeCluster, n_pods, lines_per_pod, n_long)
    pods = fc.namespaces["default"]
    pats = pats or PATTERNS + [WATCH]
    argv = ["-n", "default", "-a", "-p", ""]
    for p in pats:
        argv += ["--match", p]
    short = "match_cls_grouped_fused" if fused else "match_cls_grouped"
    with tempfile.TemporaryDirectory() as out_dir, \
            recording_wrappers(nk, None, [short,
                                          "match_chunk_cls_grouped"]) as calls:
        argv[4] = out_dir
        opts = cli.parse_args(argv)
        term.set_ui_stream(io.StringIO())
        try:
            torch.cuda.synchronize()
            nk.reset_launches()
            t0 = time.perf_counter()
            rc = asyncio.run(app.run_async(opts, backend=fc, device=dev))
            seconds = time.perf_counter() - t0
            launches = dict(nk.LAUNCHES)
        finally:
            term.set_ui_stream(None)
        want = oracle_files_for(pods, pats)
        bad = []
        kept = 0
        for name, exp in want.items():
            kept += exp.count(b"\n")
            with open(os.path.join(out_dir, name), "rb") as f:
                if f.read() != exp:
                    bad.append(name)
        files = len(os.listdir(out_dir))
    shapes = sorted(calls[short].items(), key=lambda e: -e[1][0])
    check = k4_check if fused else k1_check
    short_batches = [dict(launches=count, shape=list(key[-1]),
                          **check(torch, nk, *seen[0][0][:4], 10,
                                  plain_rows=check_rows))
                     for key, (count, seen) in shapes[:1]]
    k2g_batches = held_k2g(torch, nk, calls)
    del calls
    res = dict(rc=rc, pods=len(pods), files=files, lines=n_lines,
               kept_lines=kept, seconds=seconds,
               lines_per_s=n_lines / seconds, mismatched_files=bad,
               launches=launches, k2g_batches=k2g_batches,
               **{"k4_batches" if fused else "k1_batches": short_batches})
    # The route's K1 (or K4) and K2g launch; no other route's K1, K4 or
    # K2g, and not K2 (the union, the wide variant included).
    words = nk.kernel_states(short_batches[0]["states"]) // 32 \
        if short_batches else 0
    names = nk._NAMES[nk._route(words)]
    ran = names["k4" if fused else "k1"]
    idle = [r[k] for r in nk._NAMES.values() for k in ("k1", "k4", "k2g")
            if r[k] not in (ran, names["k2g"])]
    if (rc != 0 or bad or files != len(pods) or not kept
            or launches[ran] == 0 or any(launches[n] for n in idle)
            or launches[names["k2g"]] == 0
            or launches[nk.PACK_CLS] == 0 or launches[nk.CHUNK] != 0
            or not short_batches or not k2g_batches
            or any(b["max_abs_err"] or b.get("k1_mismatches")
                   for b in short_batches + k2g_batches)):
        raise AssertionError(f"wide ({'f' if fused else 'c'}) failed: {res}")
    return res


def wide_k3(torch, np, nk, bits, gpu, synthetic_line, dev, rows=131072,
            reps=5, pats=None, plain_rows=None) -> dict:
    """(d) K3's wide kernel (``grouped_gated_wide_kernel``) on the
    thousand-pattern set with the watch list (``make_patterns(1024) +
    [WATCH]``: 157 groups of 1152 states) under the engine's sweep gate,
    over ``rows`` rows of ``k1024_rows`` at the 128-byte bucket (1%
    minted needles): the pair list against its plain version, the
    verdicts against the plain version (which steps the gated cells
    only; timed once by CUDA events, with the state bits its steps read
    for the bound) and against ungated K1 (the wide kernel); the launch
    alone on the list (events, and the kernel by torch.profiler), the
    pair builder and the whole wrapper by events. Returns the figures
    and the engine (its construction timed). With ``pats`` (past 160
    words: ``make_patterns(64) + [WATCH700]``) the kernel is that
    width's, and the plain version runs on the first ``plain_rows``
    rows, and the bounds are those rows' (their cells' state bits),
    beside the launch's time on their pair list (``held_ms``)."""
    pats = pats or make_patterns(1024) + [WATCH]
    t0 = time.perf_counter()
    eng = gpu.GpuEngineFilter(pats, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if eng._sweep_tables is None or eng._long is None:
        raise AssertionError("the K = 1025 engine is not swept or keeps K2")
    from klogs_tpu_torch.ops import nfa, sweep

    dp, live, acc = eng._grouped, eng._g_live, eng._g_acc
    r, lens = k1024_rows(np, synthetic_line, rows, 128, SEED + 4)
    batch, lens = torch.from_numpy(r).to(dev), torch.from_numpy(lens).to(dev)
    cls = nfa.classify_chunk(dp, batch, lens, True, True)
    words = sweep.sweep_group_bits(eng._sweep_tables, batch, lens)
    got, stats = nk.match_cls_grouped_gated(dp, live, acc, cls, words,
                                            want_stats=True)
    k1 = nk.match_cls_grouped(dp, live, acc, cls)
    held = plain_rows or cls.shape[0]
    work: dict = {}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    exp = nk.match_cls_grouped_gated_plain(dp, live, acc, cls[:held],
                                           words[:held], work=work)
    ev[1].record()
    ev[1].synchronize()
    parts = k3_parts(torch, nk, dp, live, acc, cls, words, reps)
    G = int(dp.follow.shape[0])
    pairs, n_pairs, _ = nk.gate_pairs(words, G)

    def launch():
        return nk.launch_gated(dp, live, acc, cls, pairs, n_pairs)

    B, T = cls.shape
    S, C, GW = dp.n_states, dp.n_classes, words.shape[1]
    cells = gate_cells(bits, nk, words, G)
    held_pairs = gate_cells(bits, nk, words[:held], G)["pairs"]
    hpairs, hn_pairs, _ = nk.gate_pairs(words[:held], G)

    def launch_held():
        return nk.launch_gated(dp, live, acc, cls[:held], hpairs, hn_pairs)

    n_bytes = (held * T * 2 + held * GW * 4 + G * (S + C) * (S // 32) * 4
               + held + 4 * held_pairs + 4)
    name = nk._NAMES[nk._route(nk.kernel_states(S) // 32)]["k3"]
    res = dict(rows=B, T=T, groups=G, states=S, engine_build_s=build_s,
               plain_rows=held, held_pairs=held_pairs,
               held_ms=parts["ms"] if held == B else cuda_ms(
                   torch, launch_held, reps),
               max_abs_err=int((got[:held].int() - exp.int()).abs().max()),
               k3_vs_k1_mismatches=int((got != k1).sum()), **parts,
               kernel_ms=kernel_alone_ms(torch, launch, reps, name),
               wrapper_ms=cuda_ms(torch, lambda: nk.match_cls_grouped_gated(
                   dp, live, acc, cls, words), reps),
               plain_ms=ev[0].elapsed_time(ev[1]), matched=int(exp.sum()),
               candidate_lines=int(stats[0]), **cells,
               warp_steps=cells["pairs"] * T,
               active_per_step=work["active"] / max(held_pairs * T, 1),
               exc_per_step=work["exc"] / max(held_pairs * T, 1),
               **step_bounds(n_bytes, S, C, held_pairs * T, work["active"]))
    return res, eng


def wide_phase(torch, np, nfa, nk, bits, gpu, compile_patterns, app, cli,
               term, FakeCluster, synthetic_line, s1280, dev, rows=131072,
               L=4096, cli_pods=256, k1025_pods=64, fused_pods=64,
               plain_rows=16384) -> dict:
    """K1, K2g, K3 and K4 past 32 words (``grouped_shift_wide_kernel``,
    ``grouped_chunk_wide_kernel``, ``grouped_gated_wide_kernel``,
    ``grouped_fused_wide_kernel``) on the set of the 32 patterns and the
    watch list (5 groups of 1152 states): (a) K1 and K4 against their
    plain version, in turns, on the s1280 batch (K1's 512 x 2051, row 0
    dense) and on 131072 FakeCluster rows at the 128-byte bucket under
    the watch-list set, with the register K1 on the same rows under the
    32 patterns; (b) K2g against its plain version on each chunk, the
    carry chained, beside ``chunk_nfa_wide`` on the set's 1536-state
    union on the same 8 x 4096 chunks of 8 lines of 12-16 KiB; (c) the
    cli cell (``wide_cli``); then the thousand-pattern path with a wide
    group: (d) K3 on the K = 1025 batch (``wide_k3``), (e) the
    ``cli_k1024`` cell with ``--match`` x1025 at ``k1025_pods`` pods and
    4 long lines (files = ``re`` oracle; K3's and K2g's wide kernels
    launch, the register K3 and K2 do not), K3 held against its plain
    version on the run's most frequent batch; (f) (c) under
    ``KLOGS_TPU_FUSED_GROUPS=1`` at ``fused_pods`` pods (K4's wide
    kernel launches, K1's does not). The plain versions of (a) and (d)
    run on the first ``plain_rows`` of the 131072 rows."""
    rng = np.random.default_rng(SEED + 19)
    pats = PATTERNS + [WATCH]
    res = {"s1280": wide_k1_check(torch, nk, *s1280, 5, 5, 512)}
    wp = nfa.compile_grouped(pats, device=dev)
    rb, lb = watch_rows(np, synthetic_line, rows, 128)
    rows_d, lens_d = torch.from_numpy(rb).to(dev), torch.from_numpy(lb).to(dev)
    cls = nfa.classify_chunk(wp[0], rows_d, lens_d, True, True)
    res["watch_w128"] = wide_k1_check(torch, nk, *wp, cls, 10, 10, 16384,
                                      plain_rows=plain_rows)
    bp = nfa.compile_grouped(PATTERNS, device=dev)
    bcls = nfa.classify_chunk(bp[0], rows_d, lens_d, True, True)

    def k1_reg():
        return nk.match_cls_grouped(*bp, bcls)

    res["watch_w128"]["register_ms"] = cuda_ms(torch, k1_reg, 20)
    res["watch_w128"]["register_kernel_ms"] = kernel_alone_ms(
        torch, k1_reg, 20, "grouped_shift_kernel")
    del rows_d, lens_d, cls, bcls
    res["k2g_vs_wide"] = k2g_against_wide(
        torch, np, nfa, nk, compile_patterns, pats, wp, rng, dev, L=L,
        needles=WATCH_NEEDLES + NEEDLES)
    res["cli"] = wide_cli(torch, np, nk, app, cli, term, FakeCluster, dev,
                          n_pods=cli_pods)
    res["k1025"], eng = wide_k3(torch, np, nk, bits, gpu, synthetic_line, dev,
                                rows=rows, plain_rows=plain_rows)
    del eng
    cli3 = cli_k1024_run(torch, np, nk, bits, app, cli, term, FakeCluster,
                         dev, make_patterns(1024) + [WATCH], k1025_pods, 250,
                         4)
    cli3.pop("want")
    res["cli_k1025"] = cli3
    with env_set("KLOGS_TPU_FUSED_GROUPS", "1"):
        res["cli_fused"] = wide_cli(torch, np, nk, app, cli, term,
                                    FakeCluster, dev, n_pods=fused_pods,
                                    fused=True)
    emit({"phase": "wide", **res})
    k2g, k3, la = res["k2g_vs_wide"], res["k1025"], cli3["launches"]
    if (any(r["max_abs_err"] or r["k4_max_abs_err"] or r["k4_mismatches"]
            or not r["matched"] for r in (res["s1280"], res["watch_w128"]))
            or k2g["max_abs_err"] or not k2g["matched"]
            or k2g["verdict_mismatches"] or k2g["groups"] != 5
            or k3["max_abs_err"] or k3["k3_vs_k1_mismatches"]
            or k3["pairs_mismatches"] or not k3["matched"]
            or k3["groups"] != 157
            or cli3["rc"] != 0 or cli3["mismatched_files"]
            or cli3["files"] != cli3["pods"] or not cli3["kept_lines"]
            or la[nk.GATED_WIDE] == 0 or la[nk.PAIRS] == 0
            or la[nk.GROUPED_CHUNK_WIDE] == 0 or la[nk.GATED] != 0
            or la[nk.CHUNK] != 0 or la[nk.GROUPED] != 0
            or la[nk.GROUPED_WIDE] != 0 or not cli3["k3_batches"]
            or not cli3["k2g_batches"]
            or any(b["max_abs_err"] or b.get("pairs_mismatches")
                   for b in cli3["k3_batches"] + cli3["k2g_batches"])):
        raise AssertionError(f"wide phase failed: {res}")
    return res


WATCH700_NEEDLES = [b"pod=pod-0001", b"pod=pod-1399", b"pod=pod-0641",
                    b"pod=pod-0642", b"pod=pod-14"]


def wide160_phase(torch, np, nfa, nk, bits, gpu, compile_patterns, app, cli,
                  term, FakeCluster, synthetic_line, dev, rows=131072,
                  check_rows=8192, L=4096, cli_pods=64, k3_pods=64,
                  fused_pods=16) -> dict:
    """Past 160 words, the shared-memory kernels (``grouped_shift_smem``,
    ``grouped_chunk_smem``, ``grouped_gated_smem``, ``grouped_fused_smem``
    ``_kernel``), on the 32 patterns and a watch list of 700 pods
    (``WATCH700``: 5 groups of 5632 states, 176 words, C = 64: the tables
    read through L1): (a) K1 and K4 against their plain version on the
    first ``check_rows`` of 131072 FakeCluster rows at the 128-byte
    bucket, timed in turns on all of them and on the rows held; (b) K2g against its plain
    version on each chunk, the carry chained, beside ``chunk_nfa_wide``
    on the set's union over the same 8 x 4096 chunks; (c) the cli cell
    (``wide_cli``) with ``--match`` x33 at ``cli_pods`` pods and 8 long
    lines (files = ``re`` oracle; K1's and K2g's shared-memory kernels
    launch, ``chunk_nfa_kernel`` and every other route's K1/K2g/K4 do
    not); (d) K3 on ``make_patterns(64) + [WATCH700]`` under the sweep
    (``wide_k3``: the pair list and the plain version on
    ``check_rows`` rows, ungated K1 on all); (e) its cli cell
    (``cli_k1024_run``) at ``k3_pods`` pods with 2 long lines; (f) (c)
    under ``KLOGS_TPU_FUSED_GROUPS=1`` at ``fused_pods`` pods (K4's
    kernel launches, K1's does not). The caller sets
    ``KLOGS_MAX_PATTERN_POSITIONS`` past the list's 5,604 positions."""
    rng = np.random.default_rng(SEED + 21)
    pats = PATTERNS + [WATCH700]
    wp = nfa.compile_grouped(pats, device=dev)
    words = nk.grouped_state_words(wp[0])
    names = nk._NAMES[nk._route(words)]
    if words != 176 or wp[0].follow.shape[0] != 5:
        raise AssertionError("the 700-pod set is not 5 groups of 176 words")
    rb, lb = watch_rows(np, synthetic_line, rows, 128)
    cls = nfa.classify_chunk(wp[0], torch.from_numpy(rb).to(dev),
                             torch.from_numpy(lb).to(dev), True, True)
    res = {"watch_w128": wide_k1_check(torch, nk, *wp, cls, 3, 3, 2048,
                                       plain_rows=check_rows)}
    del cls
    res["k2g_vs_wide"] = k2g_against_wide(
        torch, np, nfa, nk, compile_patterns, pats, wp, rng, dev, L=L,
        reps=5, needles=WATCH700_NEEDLES + NEEDLES)
    res["cli"] = wide_cli(torch, np, nk, app, cli, term, FakeCluster, dev,
                          n_pods=cli_pods, pats=pats, n_long=8,
                          check_rows=2048)
    res["k64w"], eng = wide_k3(torch, np, nk, bits, gpu, synthetic_line, dev,
                               rows=rows, reps=3,
                               pats=make_patterns(64) + [WATCH700],
                               plain_rows=check_rows)
    del eng
    cli3 = cli_k1024_run(torch, np, nk, bits, app, cli, term, FakeCluster,
                         dev, make_patterns(64) + [WATCH700], k3_pods, 250, 2)
    cli3.pop("want")
    res["cli_k64w"] = cli3
    with env_set("KLOGS_TPU_FUSED_GROUPS", "1"):
        res["cli_fused"] = wide_cli(torch, np, nk, app, cli, term,
                                    FakeCluster, dev, n_pods=fused_pods,
                                    fused=True, pats=pats, n_long=8,
                                    check_rows=2048)
    emit({"phase": "wide160", **res})
    ww, k2g, k3, la = (res["watch_w128"], res["k2g_vs_wide"], res["k64w"],
                       cli3["launches"])
    if (ww["max_abs_err"] or ww["k4_max_abs_err"] or ww["k4_mismatches"]
            or not ww["matched"]
            or k2g["max_abs_err"] or not k2g["matched"]
            or k2g["verdict_mismatches"] or k2g["groups"] != 5
            or k3["max_abs_err"] or k3["k3_vs_k1_mismatches"]
            or k3["pairs_mismatches"] or not k3["matched"]
            or k3["states"] != 32 * words
            or cli3["rc"] != 0 or cli3["mismatched_files"]
            or cli3["files"] != cli3["pods"] or not cli3["kept_lines"]
            or la[names["k3"]] == 0 or la[nk.PAIRS] == 0
            or la[names["k2g"]] == 0 or la[nk.CHUNK] != 0
            or any(la[r[k]] for r in nk._NAMES.values()
                   for k in ("k1", "k2g", "k3", "k4")
                   if r[k] not in (names["k3"], names["k2g"]))
            or not cli3["k3_batches"] or not cli3["k2g_batches"]
            or any(b["max_abs_err"] or b.get("pairs_mismatches")
                   for b in cli3["k3_batches"] + cli3["k2g_batches"])):
        raise AssertionError(f"wide160 phase failed: {res}")
    return res


# The seq-scan's grid: (name, patterns, needles) at S = 128, 256 and
# 512 augmented union states, and (name, lines, KiB from, KiB to).
SEQ_SETS = (
    ("s128", ["needle"], [b"needle"]),
    ("s256", [r'msg=\"request failed path=/api/v1/items\"',
              "ERROR.*path=/api/v2/admin",
              r"(?:FATAL|CRIT).*code=\d+ at [a-z_]+\.go:\d+",
              r"connection refused by upstream [a-z.]+:\d+"],
     [b'msg="request failed path=/api/v1/items"',
      b"ERROR x path=/api/v2/admin", b"CRIT y code=7 at main_loop.go:12",
      b"connection refused by upstream db.local:5432"]),
    ("s512", PATTERNS, NEEDLES),
)
SEQ_LINES = (("1x192k", 1, 192, 192), ("1x1m", 1, 1024, 1024),
             ("8x128-192k", 8, 128, 192))
# H100 SXM dense fp16/bf16 tensor-core peak (NVIDIA data sheet).
FP16_FLOPS_S = 989e12


def seq_lines(np, rng, n: int, lo_kib: int, hi_kib: int, needles) -> list:
    """``n`` printable lines of lo..hi KiB (each over 128 KiB), a needle
    planted in the first and every other one after."""
    out = []
    for i in range(n):
        size = int(rng.integers(lo_kib * 1024 + 1, hi_kib * 1024 + 2))
        body = bytearray(rng.integers(32, 127, size=size, dtype=np.uint8))
        if i % 2 == 0:
            nd = needles[(i // 2) % len(needles)]
            p = int(rng.integers(0, size - len(nd)))
            body[p:p + len(nd)] = nd
        out.append(bytes(body))
    return out


def tree_bound_ms(S: int, tiles: int, tile_t: int) -> float:
    """The tree's dense bound: 2 S^3 operations for each of a tile's
    tile_t - 1 products, over the fp16 peak."""
    return 2 * S ** 3 * (tile_t - 1) * tiles / FP16_FLOPS_S * 1e3


def seqscan_tiles(torch, np, nfa, seqscan, compile_patterns, pats, line,
                  tile_t: int, n_tiles: int, dev) -> dict:
    """``classify_line`` and ``tile_transfer_matrices`` on the card against
    the same functions on the CPU, over the first ``n_tiles`` tiles of
    ``line``."""
    union = compile_patterns(pats)
    on = {d: nfa.pack_program(nfa.augment(union), device=d)
          for d in ("cpu", dev)}
    cls = {d: seqscan.classify_line(p, line, tile_t) for d, p in on.items()}
    tiles = cls["cpu"][:n_tiles * tile_t].view(n_tiles, tile_t)
    t0 = time.perf_counter()
    want = seqscan.tile_transfer_matrices(on["cpu"], tiles)
    cpu_s = time.perf_counter() - t0
    got = seqscan.tile_transfer_matrices(on[dev], tiles.to(dev)).cpu()
    return dict(states=on[dev].n_states, tile_t=tile_t, tiles=n_tiles,
                cls_mismatches=int((cls[dev].cpu() != cls["cpu"]).sum()),
                mismatches=int((got != want).sum()), ones=int(want.sum()),
                dtype=str(got.dtype), cpu_s=cpu_s)


def timed_call(torch, fn) -> tuple:
    """(fn's result, ms by CUDA events around it)."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    out = fn()
    ev[1].record()
    ev[1].synchronize()
    return out, ev[0].elapsed_time(ev[1])


def seqscan_point(torch, np, seqscan, eng, prog, live, acc, S, lines,
                  want: list, turns: int, dev) -> dict:
    """The tree (``match_lines_scan``) and the engine's chunk path
    (``_match_long``: K2, on the lines staged beforehand) on the same
    lines, both warmed up, then timed by CUDA events, in turns (tree,
    K2, K2, tree with ``turns`` 2; tree, K2 with 1); both verdicts held
    to ``want``. Where the module pads the chunk counts to a power of
    two (a fold holds several lines), the tree again unpadded
    (``tree_exact``)."""
    n = len(lines)
    host_lens = np.array([len(x) for x in lines], dtype=np.int64)
    payload = torch.from_numpy(
        np.frombuffer(b"".join(lines), np.uint8).copy()).to(dev)
    lens = torch.from_numpy(host_lens).to(dev)
    starts = torch.from_numpy(np.cumsum(host_lens) - host_lens).to(dev)
    tile_t = seqscan.DEFAULT_TILE_T
    n_tiles = -(-(host_lens + 3) // tile_t)
    tpc, max_n = seqscan._plan(S, n, int(n_tiles.max()), tile_t,
                               seqscan.DEFAULT_STEP_BYTES_BUDGET,
                               seqscan._elem_bytes(dev))
    pad = max_n > 1
    counts = seqscan._chunk_counts(n_tiles, tpc, pad)

    def tree():
        return seqscan.match_lines_scan(prog, live, acc, lines)

    def k2():
        return eng._match_long(payload, starts, lens, int(host_lens.max()))[:n]

    def exact():
        real = seqscan._chunk_counts
        seqscan._chunk_counts = lambda t, c, _: real(t, c, False)
        try:
            return tree()
        finally:
            seqscan._chunk_counts = real

    runs = {"tree": tree, "k2": k2, **({"tree_exact": exact} if pad else {})}
    ms = {k: [] for k in runs}
    bad = {}
    for k, fn in runs.items():  # warm-up, and the verdicts
        got = fn().cpu().tolist()
        bad[k] = sum(g != w for g, w in zip(got, want))
    for k in (list(runs) + list(runs)[::-1])[:turns * len(runs)]:
        ms[k].append(timed_call(torch, runs[k])[1])
    return dict(lines=n, kib=int(host_lens.sum()) // 1024,
                tiles=int(n_tiles.sum()), tiles_per_chunk=tpc,
                lines_per_fold=max_n, pow2_chunks=pad,
                groups=len(np.unique(counts)),
                tiles_computed=int((counts * tpc).sum()),
                **{f"{k}_ms": min(v) for k, v in ms.items()},
                **{f"{k}_ms_all": v for k, v in ms.items()},
                bound_ms=tree_bound_ms(S, int(n_tiles.sum()), tile_t),
                matched=int(sum(want)), mismatches=bad)


def seqscan_phase(torch, np, nfa, seqscan, compile_patterns, GpuEngineFilter,
                  dev) -> dict:
    """The sequence-parallel scan (``ops/seqscan.py``): (a) the card's
    class ids and transfer matrices against the CPU's, bit for bit, at
    S = 128 and 512; (b) the grid: the tree against K2 (the engine's
    chunk path) at each set of S = 128 and 256 and each line shape (not
    at S = 512, where the tree loses to K2 by two orders of magnitude:
    left out to keep the run's time), times and the tree's
    dense bound, every verdict held to ``re``; (c) ``match_line_sharded`` over
    the card listed four times on each set's 192 KiB line (not a scaling
    figure), verdicts equal to (b)'s."""
    rng = np.random.default_rng(SEED + 17)
    text = seq_lines(np, rng, 1, 8, 8, NEEDLES)[0]
    res = {"tiles": {
        "s128": seqscan_tiles(torch, np, nfa, seqscan, compile_patterns,
                              ["needle"], b"needle " + text, 512, 4, dev),
        "s512": seqscan_tiles(torch, np, nfa, seqscan, compile_patterns,
                              PATTERNS, text, 64, 4, dev)}}
    grid, sharded = {}, {}
    for set_name, pats, needles in SEQ_SETS[:2]:
        union = compile_patterns(pats)
        prog = nfa.pack_program(nfa.augment(union), device=dev)
        live, acc, S = union.n_states, union.n_states + 1, prog.n_states
        eng = GpuEngineFilter(pats, device=dev)
        for shape, n, lo, hi in SEQ_LINES:
            lines = seq_lines(np, rng, n, lo, hi, needles)
            want = _oracle_chunk(tuple(pats), lines)
            key = f"{set_name}_{shape}"
            grid[key] = dict(states=S, **seqscan_point(
                torch, np, seqscan, eng, prog, live, acc, S, lines, want,
                turns=1 if S > 256 else 2, dev=dev))
            if shape == SEQ_LINES[0][0]:  # the single 192 KiB line
                got, ms = timed_call(torch, lambda: seqscan.match_line_sharded(
                    prog, live, acc, lines[0], devices=[dev] * 4))
                sharded[key] = dict(devices=4, verdict=got, want=want[0],
                                    ms=ms)
        del eng, prog
    res.update(grid=grid, sharded=sharded, peak_fp16_flops=FP16_FLOPS_S,
               peak_source="H100 SXM data sheet, dense fp16/bf16")
    emit({"phase": "seqscan", **res})
    if (any(t["mismatches"] or t["cls_mismatches"] or not t["ones"]
            for t in res["tiles"].values())
            or any(any(p["mismatches"].values()) or not p["matched"]
                   for p in grid.values())
            or any(s["verdict"] != s["want"] for s in sharded.values())):
        raise AssertionError(f"seqscan disagrees: {res}")
    return res


def host_top(cp, n: int) -> list:
    """The ``n`` functions of a cProfile run with the most own time."""
    import pstats

    st = pstats.Stats(cp)
    top = sorted(((f"{os.path.basename(fn)}:{name}", v[2] * 1e3)
                  for (fn, _, name), v in st.stats.items()),
                 key=lambda r: -r[1])[:n]
    return [{"fn": k[:60], "own_ms": ms} for k, ms in top]


def profile_batch(torch, eng, frame) -> dict:
    """One batch under torch.profiler (device side: wall time, summed
    kernel and copy time, the largest of them, and the device time of
    any ``klogs.*`` named range) and under cProfile (host side: the
    functions with the most own time)."""
    import cProfile

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.fetch_framed(eng.dispatch_framed(*frame))
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == cuda and not e.key.startswith("klogs.")]
    device_ms = sum(ms for _, ms in rows)
    # A klogs.* range shows on the device timeline as a span from its
    # first kernel to its last (idle gaps included); its busy time is
    # the kernel time inside that span.
    spans: dict = {}
    busy: dict = {}
    events = [e for e in prof.events() if e.device_type == cuda]
    for a in (e for e in events if e.name.startswith("klogs.")):
        lo, hi = a.time_range.start, a.time_range.end
        spans[a.name] = spans.get(a.name, 0.0) + (hi - lo) / 1e3
        busy[a.name] = busy.get(a.name, 0.0) + sum(
            (k.time_range.end - k.time_range.start) / 1e3 for k in events
            if not k.name.startswith("klogs.")
            and lo <= k.time_range.start and k.time_range.end <= hi)
    top = sorted(rows, key=lambda r: -r[1])[:6]
    kernels: dict = {}
    for k, ms in rows:  # the hand-written kernels, by template instance
        m = re.search(r"\w*(?:nfa|gate_pairs|pack_rows|pack_classify)\w*"
                      r"(?:<[^>]*>)?", k)
        if m:
            kernels[m.group(0)] = kernels.get(m.group(0), 0.0) + ms
    cp = cProfile.Profile()
    cp.enable()
    eng.fetch_framed(eng.dispatch_framed(*frame))
    cp.disable()
    return dict(wall_ms=wall * 1e3, device_ms=device_ms,
                device_busy=device_ms / (wall * 1e3),
                device_top=[{"op": k[:60], "ms": ms} for k, ms in top],
                nfa_kernels_ms=kernels, range_span_ms=spans, range_busy_ms=busy,
                range_busy_share={k: v / device_ms if device_ms else 0.0
                                  for k, v in busy.items()},
                host_top=host_top(cp, 8))


def engine_phase(torch, np, nk, GpuEngineFilter, frame_lines, synthetic_line,
                 dev, n_short=1 << 19, n_long=500, batch=131072) -> dict:
    rng = np.random.default_rng(SEED + 2)
    ora = oracle_fn()
    short = [synthetic_line(f"pod-{i % 512:04d}", f"c{i % 2}", i, CLOCK + i)
             for i in range(n_short)]
    for i in range(0, len(short), 97):  # plant needles in ~1% of lines
        nd = NEEDLES[i % len(NEEDLES)]
        short[i] = short[i][:40] + nd + short[i][40:]
    long_lines = []
    for i in range(n_long):
        n = int(rng.integers(4097, 192 * 1024))
        body = bytearray(rng.integers(32, 127, size=n, dtype=np.uint8))
        if i % 2:
            nd = NEEDLES[i % len(NEEDLES)]
            p = int(rng.integers(0, n - len(nd)))
            body[p:p + len(nd)] = nd
        long_lines.append(bytes(body) + b"\n")
    frames = [frame_lines(short[i:i + batch], strip_nl=False)[:2]
              for i in range(0, len(short), batch)]
    long_frame = frame_lines(long_lines, strip_nl=False)[:2]
    eng = GpuEngineFilter(PATTERNS, device=dev)
    eng.fetch_framed(eng.dispatch_framed(*frames[0]))  # warm-up
    torch.cuda.synchronize()
    nk.reset_launches()
    verdicts, t_dispatch, t_fetch = [], 0.0, 0.0
    for f in frames:
        t0 = time.perf_counter()
        handle = eng.dispatch_framed(*f)  # host packing + enqueue
        t1 = time.perf_counter()
        verdicts.append(eng.fetch_framed(handle))  # wait for the device
        t_dispatch += t1 - t0
        t_fetch += time.perf_counter() - t1
    t_short = t_dispatch + t_fetch
    t0 = time.perf_counter()
    long_v = eng.fetch_framed(eng.dispatch_framed(*long_frame))
    t_long = time.perf_counter() - t0
    launches = dict(nk.LAUNCHES)
    got = np.concatenate(verdicts).tolist() + long_v.tolist()
    exp = [ora(ln.rstrip(b"\n")) for ln in short + long_lines]
    bad = sum(g != e for g, e in zip(got, exp))
    res = dict(short_lines=len(short), long_lines=len(long_lines),
               batch_lines=batch, short_lines_per_s=len(short) / t_short,
               dispatch_s=t_dispatch, fetch_s=t_fetch,
               profile=profile_batch(torch, eng, frames[0]),
               long_lines_per_s=len(long_lines) / t_long,
               long_bytes_per_s=sum(map(len, long_lines)) / t_long,
               matched=int(sum(exp)), mismatches=bad, launches=launches,
               grouped_launches_per_batch=launches[nk.GROUPED] / len(frames))
    emit({"phase": "engine", **res})
    if (bad or len(got) != len(exp) or launches[nk.GROUPED] == 0
            or launches[nk.CHUNK] == 0 or launches[nk.PACK_CLS] == 0):
        raise AssertionError(f"engine phase failed: {res}")
    return dict(res, frames=frames, long_frame=long_frame,
                verdicts=np.asarray(got))


def pack_check(torch, pack, payload, starts, lens, width: int, rows: int,
               skip: int, reps: int) -> dict:
    """pack_rows against its plain version on one sub-batch, both timed,
    with the bound: the bytes the rows hold read once, their starts and
    lengths read once, rows x width written once."""
    got = pack.pack_rows(payload, starts, lens, width, rows, skip)
    exp = pack.pack_rows_plain(payload, starts, lens, width, rows, skip)
    bad = int((got != exp).sum())
    ms = cuda_ms(torch, lambda: pack.pack_rows(payload, starts, lens, width,
                                               rows, skip), reps)
    plain_ms = cuda_ms(torch, lambda: pack.pack_rows_plain(
        payload, starts, lens, width, rows, skip), 1)
    n_bytes = (int((lens - skip).clamp(0, width).sum()) + 16 * len(starts)
               + rows * width)
    b_ms, b_by = bound(n_bytes, 0)
    return dict(rows=rows, width=width, skip=skip, mismatches=bad, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                n_bytes=n_bytes)


def kernel_alone_ms(torch, fn, reps: int, name: str) -> float:
    """Mean device ms of the kernels whose name holds ``name`` over
    ``reps`` calls of ``fn``, by torch.profiler: the kernel alone, where
    CUDA events around back-to-back calls time the launch path when the
    host is the slower."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # The first of two sessions is thrown away: one that follows another
    # phase's profiler has come back without the kernels it ran.
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if name in e.key) / reps / 1e3


def pack_cls_check(torch, pack, payload, starts, lens, width: int, rows: int,
                   prog, skip: int = 0, first: bool = True,
                   final: bool = True, want_bytes: bool = False,
                   reps: int = 10, alone: bool = False) -> dict:
    """pack_classify_rows against its plain version on one sub-batch or
    chunk (class ids, stripped lengths and byte rows, element for
    element), both timed, beside the pair it replaced on the same lines:
    ``pack_rows`` + ``classify_chunk`` on the stripped lengths (which the
    host computed before), whose class ids must equal the kernel's; and
    the kernel's flat schedule, held equal and timed; with ``alone``,
    both schedules' kernels alone too (torch.profiler). The bound: the
    kept bytes read once, starts and lengths read once, the class ids,
    lengths (and byte rows) written once."""
    from klogs_tpu_torch.ops import nfa

    args = (payload, starts, lens, width, rows, prog, skip, first, final,
            want_bytes)
    got = pack.pack_classify_rows(*args)
    exp = pack.pack_classify_rows_plain(*args)
    bad = sum(int((g != e).sum()) for g, e in zip(got, exp) if g is not None)
    ms = cuda_ms(torch, lambda: pack.pack_classify_rows(*args), reps)
    plain_ms = cuda_ms(torch, lambda: pack.pack_classify_rows_plain(*args), 1)
    stripped = got[1]

    def pair():
        b = pack.pack_rows(payload, starts, stripped[:len(starts)], width,
                           rows, skip)
        return nfa.classify_chunk(prog, b, stripped - skip, first, final)

    pair_bad = int((pair() != got[0]).sum())
    pair_ms = cuda_ms(torch, pair, reps)
    # The kernel's flat schedule (rows past 1024 bytes take it) on the
    # same inputs.
    flat = pack._launch_classify(*args, flat=True)
    flat_bad = sum(int((g != e).sum()) for g, e in zip(flat, got)
                   if g is not None)
    flat_ms = cuda_ms(torch, lambda: pack._launch_classify(*args, flat=True),
                      reps)
    extra = {}
    if alone:
        extra = dict(
            kernel_ms=kernel_alone_ms(torch, lambda: pack.pack_classify_rows(
                *args), reps, "pack_classify"),
            flat_kernel_ms=kernel_alone_ms(
                torch, lambda: pack._launch_classify(*args, flat=True), reps,
                "pack_classify"))
    T = width + int(first) + 2 * int(final)
    n_bytes = (int((lens - skip).clamp(0, width).sum()) + 16 * len(starts)
               + 8 * rows + 2 * rows * T + (rows * width if want_bytes else 0))
    b_ms, b_by = bound(n_bytes, 0)
    return dict(rows=rows, width=width, T=T, skip=skip, bytes_out=want_bytes,
                mismatches=bad + flat_bad, pair_mismatches=pair_bad, ms=ms,
                plain_ms=plain_ms, pair_ms=pair_ms, flat_ms=flat_ms,
                bound_ms=b_ms, bound_by=b_by, n_bytes=n_bytes, **extra)


def pack_phase(torch, nk, pack, GpuEngineFilter, base, dev) -> dict:
    """The device packer against its plain version on what the engine
    phase staged: every width bucket of its first frame, and every chunk
    of its long frame, on the engine's own metadata, device payload and
    programs. ``pack_classify_rows`` (the main path's) is timed beside the
    ``pack_rows`` + ``classify_chunk`` pair it replaced; ``pack_rows``
    (the indexed engine's device sweep) is held on the same cuts with the
    stripped lengths. Any mismatch fails. ``launches`` are the engine
    phase's."""
    eng = GpuEngineFilter(PATTERNS, device=dev)
    L = eng._chunk_bytes
    buckets, chunks, rows_cuts = [], [], []
    for frame in (base["frames"][0], base["long_frame"]):
        layout, meta = eng._layout(*frame)
        meta_d, payload_d = eng._stage(frame[0], meta)
        at = 0
        for idx, width, rows, longest in layout:
            starts, lens = meta_d[at:at + rows], meta_d[at + rows:at + 2 * rows]
            at += 2 * rows
            if width is not None:
                buckets.append(dict(lines=len(idx), **pack_cls_check(
                    torch, pack, payload_d, starts, lens, width, rows,
                    eng._grouped, reps=20, alone=True)))
                stripped = pack.pack_classify_rows_plain(
                    payload_d, starts, lens, width, rows, eng._grouped)[1]
                rows_cuts.append(pack_check(torch, pack, payload_d, starts,
                                            stripped, width, rows, 0, 20))
                continue
            n_chunks = -(-longest // L)
            prog = eng._long[0] if eng._long is not None else eng._aug
            for k in range(n_chunks):
                chunks.append(pack_cls_check(
                    torch, pack, payload_d, starts, lens, L, rows, prog,
                    k * L, k == 0, k == n_chunks - 1, reps=5,
                    alone=k in (0, 1, n_chunks - 1)))
    long_sum = {key + "_sum": sum(c[key] for c in chunks)
                for key in ("mismatches", "pair_mismatches", "ms",
                            "plain_ms", "pair_ms", "flat_ms", "bound_ms")}
    timed = [c for c in chunks if "kernel_ms" in c]
    long_sum.update(alone_chunks=len(timed), **{
        key + "_mean": sum(c[key] for c in timed) / len(timed)
        for key in ("kernel_ms", "flat_kernel_ms", "bound_ms")})
    main = max(buckets, key=lambda b: b["rows"])
    rmain = max(rows_cuts, key=lambda b: b["rows"])
    held = buckets + chunks
    res = dict(name=nk.PACK_CLS, route="cuda",
               source="klogs_tpu_torch/ops/csrc/pack_kernels.cu",
               replaces="klogs_tpu/native/_hostops.c:593",
               launches=base["launches"][nk.PACK_CLS],
               max_abs_err=float(max(b["mismatches"] for b in held)),
               pair_mismatches=max(b["pair_mismatches"] for b in held),
               ms=main["ms"], plain_ms=main["plain_ms"],
               pair_ms=main["pair_ms"], flat_ms=main["flat_ms"],
               kernel_ms=main["kernel_ms"],
               flat_kernel_ms=main["flat_kernel_ms"],
               bound_ms=main["bound_ms"],
               bound_by=main["bound_by"], library_ms=None, buckets=buckets,
               long_chunks=dict(rows=chunks[0]["rows"], width=L,
                                chunks=len(chunks), **long_sum),
               pack_rows=dict(
                   name=nk.PACK, max_abs_err=float(max(
                       b["mismatches"] for b in rows_cuts)),
                   ms=rmain["ms"], plain_ms=rmain["plain_ms"],
                   bound_ms=rmain["bound_ms"], bound_by=rmain["bound_by"],
                   buckets=rows_cuts))
    emit({"phase": "pack", **res})
    if (res["max_abs_err"] or res["pair_mismatches"] or not chunks
            or res["pack_rows"]["max_abs_err"]):
        raise AssertionError(f"pack phase failed: {res}")
    return res


def engine_fused_phase(torch, np, nk, GpuEngineFilter, base, dev) -> dict:
    """GpuEngineFilter(PATTERNS) under KLOGS_TPU_FUSED_GROUPS=1 (the
    caller sets it) on the engine phase's frames: its verdicts equal the
    K1 engine's on every line, short lines go through K4 only, long ones
    through K2. Returns the run's most frequent class batch (131072 x
    131: the 128-byte bucket of a whole frame) for the tune phase."""
    frames, long_frame = base["frames"], base["long_frame"]
    eng = GpuEngineFilter(PATTERNS, device=dev)
    fused = nk.match_cls_grouped_fused
    batches: dict = {}

    def recording(prog, live, acc, cls):
        entry = batches.setdefault(tuple(cls.shape),
                                   [0, (prog, live, acc, cls)])
        entry[0] += 1
        return fused(prog, live, acc, cls)

    eng.fetch_framed(eng.dispatch_framed(*frames[0]))  # warm-up
    torch.cuda.synchronize()
    nk.match_cls_grouped_fused = recording
    try:
        nk.reset_launches()
        t0 = time.perf_counter()
        verdicts = [eng.fetch_framed(eng.dispatch_framed(*f)) for f in frames]
        t_short = time.perf_counter() - t0
        t0 = time.perf_counter()
        long_v = eng.fetch_framed(eng.dispatch_framed(*long_frame))
        t_long = time.perf_counter() - t0
        launches = dict(nk.LAUNCHES)
    finally:
        nk.match_cls_grouped_fused = fused
    got = np.concatenate(verdicts + [long_v])
    n_short = sum(len(v) for v in verdicts)
    bad = int((got != base["verdicts"]).sum()) if len(got) == len(
        base["verdicts"]) else -1
    prof = profile_batch(torch, eng, frames[0])
    res = dict(fused=eng._fused, short_lines=n_short,
               short_lines_per_s=n_short / t_short,
               k1_engine_short_lines_per_s=base["short_lines_per_s"],
               long_lines=len(long_v), long_lines_per_s=len(long_v) / t_long,
               mismatches_vs_k1_engine=bad, matched=int(got.sum()),
               device_busy=prof["device_busy"], launches=launches,
               k4_shapes={f"{B}x{T}": e[0] for (B, T), e in batches.items()},
               profile=prof)
    emit({"phase": "engine_fused", **res})
    main_shape = max(batches, key=lambda k: batches[k][0]) if batches else None
    if (bad or not eng._fused or launches[nk.FUSED] == 0
            or launches[nk.GROUPED] != 0 or launches[nk.CHUNK] == 0
            or launches[nk.PACK_CLS] == 0
            or main_shape is None or main_shape[1] != 131):
        raise AssertionError(f"engine_fused phase failed: {res}")
    return dict(res, batch=batches[main_shape][1])


def tune_phase(torch, tune, batch) -> dict:
    """The port's tune_grouped with its own timing on the card, on the
    fused engine's 131072 x 131 class batch at K = 32, the cache in a
    temporary directory."""
    dp, live, acc, cls = batch
    with tempfile.TemporaryDirectory() as cache, \
            env_set("XDG_CACHE_HOME", cache):
        best = tune.tune_grouped(dp, live, acc, cls, quiet=True)
        cached = tune.load_cached(dp, cls.shape, tune.device_kind(cls.device))
    seen = {"fused" if r.get("fused") else "plain": r["lines_per_s"]
            for r in best["results"]}
    res = dict(rows=cls.shape[0], T=cls.shape[1], groups=dp.follow.shape[0],
               plain_lines_per_s=seen.get("plain"),
               fused_lines_per_s=seen.get("fused"),
               winner="fused" if best.get("fused") else "plain",
               cached=cached == best)
    emit({"phase": "tune", **res})
    if len(seen) != 2 or cached != best:
        raise AssertionError(f"tune phase failed: {res}")
    return res


# ---- the collector's host C and the operating-point controller --------

NATIVE_FUNCTIONS = ("find_newlines", "join_kept_framed", "frame_lines",
                    "split_frame")


def native_phase(np, FakeCluster, n_streams=256, lines_per_stream=400,
                 chunk=4096) -> dict:
    """The port's host library, built from ``native/_hostops.c`` at its
    first use (here, unless an earlier call built it): its path and the
    build's seconds. Each of its four functions is held byte for byte
    against its plain numpy version, and both timed, on 256 FakeCluster
    streams cut in 4 KiB chunks (most end mid-line), the first stream
    carrying a 180 KiB line: the newline sweep on every chunk and the
    batcher over each stream, the framing of each stream's lines, its
    split, and the join of the lines the ``re`` oracle keeps."""
    from klogs_tpu_torch import native
    from klogs_tpu_torch.filters import base, framer

    t0 = time.perf_counter()
    host = native.hostops()
    load_s = time.perf_counter() - t0
    info = dict(native.build_info)
    fc, _ = cli_cluster(np, FakeCluster, n_streams, lines_per_stream,
                        n_long=0)
    pods = fc.namespaces["default"]
    streams = [[ln for _, ln in pods[n].containers["c0"].lines]
               for n in sorted(pods)]
    rng = np.random.default_rng(SEED + 30)
    big = rng.integers(32, 127, size=180 * 1024, dtype=np.uint8).tobytes()
    streams[0].insert(len(streams[0]) // 2, big + b"\n")
    ora = oracle_fn()
    ms = {f: [0.0, 0.0] for f in NATIVE_FUNCTIONS}
    bad = {f: 0 for f in NATIVE_FUNCTIONS}

    def both(name, c_fn, plain_fn, c_args, plain_args, same=None):
        t = time.perf_counter()
        got = c_fn(*c_args)
        t1 = time.perf_counter()
        exp = plain_fn(*plain_args)
        t2 = time.perf_counter()
        ms[name][0] += (t1 - t) * 1e3
        ms[name][1] += (t2 - t1) * 1e3
        bad[name] += (got != exp) if same is None else not same(got, exp)
        return got

    n_chunks = mid = long_chunks = 0
    for k, lines in enumerate(streams):
        data = b"".join(lines)
        batchers = (framer.FramedBatcher(),
                    framer.FramedBatcher(find_newlines=framer.find_newlines_plain))
        for at in range(0, len(data), chunk):
            ch = data[at:at + chunk]
            n_chunks += 1
            mid += not ch.endswith(b"\n")
            long_chunks += k == 0 and b"\n" not in ch
            both("find_newlines", host.find_newlines,
                 framer.find_newlines_plain, (ch, at), (ch, at))
            for b in batchers:
                b.feed(ch)
        got, exp = (b.take(final=True) for b in batchers)
        bad["find_newlines"] += (got[0], got[1].tobytes(), got[2]) != (
            exp[0], exp[1].tobytes(), exp[2]) or got[0] != data
        strip = k % 2
        payload, offs, raw = both(
            "frame_lines", host.frame_lines, base.frame_lines_plain,
            (lines, strip), (lines, bool(strip)),
            same=lambda g, e: (g[0], g[1], g[2]) == (e[0], e[1].tobytes(),
                                                     e[2]))
        o = np.frombuffer(offs, dtype=np.int32)
        split = both("split_frame", host.split_frame, base.split_frame_plain,
                     (payload, o, len(lines)), (payload, o))
        bad["split_frame"] += split != (
            [ln.rstrip(b"\n") for ln in lines] if strip else lines)
        if strip:
            continue
        mask = np.array([ora(ln.rstrip(b"\n")) for ln in lines])
        joined = both("join_kept_framed", host.join_kept_framed,
                      framer.join_kept_framed_plain,
                      (payload, o, len(lines), mask.view(np.uint8)),
                      (payload, o, mask))
        bad["join_kept_framed"] += joined != b"".join(
            ln for ln, m in zip(lines, mask) if m)
    path = info.get("path", "")
    res = dict(source=os.path.relpath(native.SOURCE, os.path.dirname(
        os.path.abspath(__file__))), library=os.path.basename(str(path)),
        compiled_here=info.get("compiled"), build_s=info.get("seconds"),
        load_s=load_s, streams=len(streams), chunks=n_chunks,
        chunks_ending_mid_line=mid, chunks_inside_the_long_line=long_chunks,
        long_line_bytes=len(big) + 1, lines=sum(map(len, streams)),
        bytes=sum(len(b) for lines in streams for b in lines),
        functions={f: dict(c_ms=ms[f][0], plain_ms=ms[f][1],
                           mismatches=bad[f]) for f in NATIVE_FUNCTIONS})
    emit({"phase": "native", **res})
    if (any(bad.values()) or not mid or not long_chunks
            or not str(path).startswith(native.BUILD_DIR)
            or host.__file__ != path):
        raise AssertionError(f"native phase failed: {res}")
    return res


def tune_auto_service(torch, np, nk, tune, FakeCluster, GpuEngineFilter,
                      FilterStats, frame_lines, dev, seconds=5.0,
                      idle_s=4.0, n_callers=256, frame_n=4000) -> dict:
    """(a) One ``AsyncFilterService(GpuEngineFilter(PATTERNS))``, started
    at the surface's floor of 4 in flight (an operator's
    ``KLOGS_MAX_IN_FLIGHT=4``), under 256 concurrent callers of their own
    4000-line FakeCluster frame for ``seconds``, with the controller
    ``maybe_controller`` builds under ``KLOGS_TUNE=auto`` and
    ``KLOGS_TUNE_INTERVAL_S=0.2`` (the committed surface, the profiler
    ticking every 0.1 s); then idle until the controller steps back
    down. Every verdict must equal a fixed-flag engine's on the same
    frame, every step stay in its bounds, and the service close."""
    from klogs_tpu_torch.filters.async_service import AsyncFilterService
    from klogs_tpu_torch.obs.profiler import PROFILER

    fc = FakeCluster.synthetic(n_pods=n_callers, n_containers=1,
                               lines_per_container=frame_n,
                               clock=lambda: CLOCK)
    pods = fc.namespaces["default"]
    frames = [frame_lines([ln for _, ln in pods[n].containers["c0"].lines],
                          strip_nl=False)[:2] for n in sorted(pods)]
    del fc, pods
    fixed = GpuEngineFilter(PATTERNS, device=dev)
    ref = [fixed.fetch_framed(fixed.dispatch_framed(p, o)) for p, o in frames]
    obs_reset()
    svc = AsyncFilterService(GpuEngineFilter(PATTERNS, device=dev),
                             max_in_flight=4, stats=FilterStats())
    with env_set("KLOGS_TUNE", "auto"), env_set("KLOGS_TUNE_INTERVAL_S",
                                                 "0.2"):
        ctrl = tune.maybe_controller(svc)
    bounds = dict(ctrl.bounds)
    steps: list = []
    real_apply = svc.apply_tuning
    t0 = time.perf_counter()

    def apply(**kw):
        steps.append(dict(t=time.perf_counter() - t0, **kw))
        real_apply(**kw)

    svc.apply_tuning = apply
    counts = dict(calls=0, lines=0, wrong=0)

    async def go() -> dict:
        PROFILER.enable(1.0)
        stop_prof, stop_tune = asyncio.Event(), asyncio.Event()
        prof_task = asyncio.create_task(PROFILER.run_ticker(stop_prof,
                                                            interval_s=0.1))
        tune_task = asyncio.create_task(ctrl.run(stop_tune))
        deadline = time.perf_counter() + seconds

        async def caller(i: int) -> None:
            p, o = frames[i]
            while time.perf_counter() < deadline:
                v = await svc.match_framed(p, o)
                counts["calls"] += 1
                counts["lines"] += len(o) - 1
                counts["wrong"] += not np.array_equal(v, ref[i])

        t = time.perf_counter()
        await asyncio.gather(*[caller(i) for i in range(len(frames))])
        load_s = time.perf_counter() - t
        loaded_at = time.perf_counter() - t0
        values_loaded = dict(ctrl.values)
        # Idle: the controller walks back down after its idle streak.
        while (time.perf_counter() - t0 - loaded_at < idle_s
               and not any(st["t"] > loaded_at for st in steps)):
            await asyncio.sleep(0.05)
        stop_tune.set()
        await tune_task
        stop_prof.set()
        await prof_task
        t = time.perf_counter()
        await asyncio.wait_for(svc.aclose(), 60)
        return dict(load_s=load_s, loaded_at=loaded_at,
                    values_after_load=values_loaded,
                    close_s=time.perf_counter() - t)

    torch.cuda.synchronize()
    nk.reset_launches()
    try:
        out = asyncio.run(go())
    finally:
        obs_reset()
    launches = dict(nk.LAUNCHES)
    depth, ups = 4, 0
    for st in steps:
        if "max_in_flight" in st:
            ups += st["max_in_flight"] > depth
            depth = st["max_in_flight"]
    downs = [st for st in steps if st["t"] > out["loaded_at"]]
    in_bounds = all(bounds[k][0] <= v <= bounds[k][1] for st in steps
                    for k, v in st.items() if k != "t")
    res = dict(callers=n_callers, frame_lines=frame_n, seconds=seconds,
               bounds=bounds, steps=steps, in_bounds=in_bounds,
               max_in_flight_ups=ups, steps_after_load=len(downs),
               final=dict(ctrl.values), permits_at_close=svc._sem._value,
               lines_per_s=counts["lines"] / out["load_s"],
               launches=launches, **counts, **out)
    res["ok"] = bool(ups and downs and in_bounds and counts["wrong"] == 0
                     and counts["calls"] >= n_callers
                     and svc._sem._value == svc.max_in_flight
                     and launches[nk.GROUPED] > 0
                     and launches[nk.PACK_CLS] > 0)
    return res


def tune_auto_cli(torch, np, nk, pack, app, cli, term, FakeCluster, dev,
                  fixed_lps: float) -> dict:
    """(b) The cli cell (256 pods x 4000 lines + 16 long) through
    ``app.run_async`` under ``KLOGS_TUNE=auto`` and
    ``KLOGS_TUNE_INTERVAL_S=0.25`` with ``--stats-json``: every file
    equal to the ``re`` oracle; the controller's steps and final values,
    lines/s beside the fixed-flag cli run's; K1, K2 and ``pack_classify_rows``
    held against their plain versions on this run's own batches (counts
    zeroed just before the run). A run of a few seconds may show no two
    pressure ticks in a row, so no step is required here."""
    fc, n_lines = cli_cluster(np, FakeCluster)
    pods = fc.namespaces["default"]
    want = oracle_files(pods)
    names = ["match_cls_grouped", "match_chunk_cls", "pack_classify_rows"]
    with tempfile.TemporaryDirectory() as tmp, \
            env_set("KLOGS_TUNE", "auto"), \
            env_set("KLOGS_TUNE_INTERVAL_S", "0.25"), \
            captured_pipeline() as made, \
            recording_wrappers(nk, pack, names) as calls:
        out_dir, stats = os.path.join(tmp, "out"), os.path.join(tmp, "s.json")
        argv = ["-n", "default", "-a", "-p", out_dir, "--stats-json", stats]
        for p in PATTERNS:
            argv += ["--match", p]
        term.set_ui_stream(io.StringIO())
        obs_reset()
        try:
            torch.cuda.synchronize()
            nk.reset_launches()
            t0 = time.perf_counter()
            rc = asyncio.run(app.run_async(cli.parse_args(argv), backend=fc,
                                           device=dev))
            seconds = time.perf_counter() - t0
            launches = dict(nk.LAUNCHES)
        finally:
            term.set_ui_stream(None)
            obs_reset()
        bad = sorted(f for f, exp in want.items()
                     if open(os.path.join(out_dir, f), "rb").read() != exp)
        with open(stats) as f:
            metrics = json.load(f)["metrics"]
        res = dict(rc=rc, lines=n_lines, seconds=seconds,
                   lines_per_s=n_lines / seconds,
                   fixed_flag_lines_per_s=fixed_lps,
                   mismatched_files=bad, launches=launches,
                   steps={"{param}:{direction}".format(**s["labels"]):
                          s["value"] for s in
                          metrics["klogs_tune_steps_total"]["samples"]},
                   values={s["labels"]["param"]: s["value"] for s in
                           metrics["klogs_tune_value"]["samples"]},
                   service_final=dict(
                       coalesce_lines=made[0].service.coalesce_lines,
                       max_in_flight=made[0].service.max_in_flight))
        res.update(held_batches(torch, nk, pack, calls, 2))
    held = res["k1_batches"] + res["k2_batches"] + res["pack_batches"]
    res["ok"] = bool(
        rc == 0 and not bad and len(res["values"]) == 2
        and all(launches[k] > 0 for k in (nk.GROUPED, nk.CHUNK, nk.PACK_CLS))
        and res["k1_batches"] and res["k2_batches"] and res["pack_batches"]
        and not any(h.get("max_abs_err", 0) or h.get("mismatches", 0)
                    for h in held))
    return res


def tune_auto_phase(torch, np, nk, pack, tune, app, cli, term, FakeCluster,
                    GpuEngineFilter, FilterStats, frame_lines, dev,
                    fixed_lps: float, card: str = "") -> dict:
    """KLOGS_TUNE=auto on the card: (a) the controller over the service
    it tunes, (b) the cli cell through the app's wiring."""
    res = dict(card=card, surface=tune.operating_surface())
    res["a"] = tune_auto_service(torch, np, nk, tune, FakeCluster,
                                 GpuEngineFilter, FilterStats, frame_lines,
                                 dev)
    res["b"] = tune_auto_cli(torch, np, nk, pack, app, cli, term,
                             FakeCluster, dev, fixed_lps)
    emit({"phase": "tune_auto", **res})
    if not (res["a"]["ok"] and res["b"]["ok"]):
        raise AssertionError(f"tune_auto phase failed: {res}")
    return res


def cli_profile(app, cli, term, fc, argv: list, dev) -> dict:
    """``app.run_async`` on ``argv`` (its ``-p`` replaced by a temporary
    directory) under cProfile: seconds and the host's top functions."""
    import cProfile

    with tempfile.TemporaryDirectory() as out_dir:
        argv = list(argv)
        argv[argv.index("-p") + 1] = out_dir
        opts = cli.parse_args(argv)
        term.set_ui_stream(io.StringIO())
        cp = cProfile.Profile()
        try:
            t0 = time.perf_counter()
            cp.enable()
            asyncio.run(app.run_async(opts, backend=fc, device=dev))
            cp.disable()
            seconds = time.perf_counter() - t0
        finally:
            term.set_ui_stream(None)
    return dict(seconds=seconds, host_top=host_top(cp, 12))


def cli_cluster(np, FakeCluster, n_pods=256, lines_per_pod=4000,
                n_long=16, **kw):
    """The cli cell's fixed-clock FakeCluster (one container a pod, a
    long line of 5-180 KiB in each of the first ``n_long`` pods, half
    with a needle) and its line count."""
    rng = np.random.default_rng(SEED + 3)
    fc = FakeCluster.synthetic(n_pods=n_pods, n_containers=1,
                               lines_per_container=lines_per_pod,
                               clock=lambda: CLOCK, **kw)
    pods = fc.namespaces["default"]
    for j, name in enumerate(sorted(pods)[:n_long]):
        n = int(rng.integers(5000, 180 * 1024))
        body = bytearray(rng.integers(32, 127, size=n, dtype=np.uint8))
        if j % 2:
            body[n // 2:n // 2 + 8] = b"code=504"
        pods[name].containers["c0"].lines.insert(
            100 + j, (CLOCK - 3000, bytes(body) + b"\n"))
    n_lines = sum(len(c.lines) for p in pods.values()
                  for c in p.containers.values())
    return fc, n_lines


def oracle_files(pods: dict) -> dict:
    """Each pod's file as the ``re`` oracle selects it."""
    ora = oracle_fn()
    return {f"{name}__c0.log": b"".join(
        ln for _, ln in pods[name].containers["c0"].lines
        if ora(ln.rstrip(b"\n"))) for name in sorted(pods)}


def cli_phase(torch, np, nk, app, cli, term, FakeCluster, dev, n_pods=256,
              lines_per_pod=4000, fused=False) -> dict:
    """The K = 32 main path through ``app.run_async``; with ``fused``
    (KLOGS_TPU_FUSED_GROUPS=1, set by the caller) its short lines must
    run K4 and never K1, and K4 is held against its plain version and K1
    on the run's own batches."""
    fc, n_lines = cli_cluster(np, FakeCluster, n_pods, lines_per_pod)
    pods = fc.namespaces["default"]
    argv = ["-n", "default", "-a", "-p", ""]
    for p in PATTERNS:
        argv += ["--match", p]
    # The [B, T] class batches the main path hands its kernel (K1, or
    # K4): per shape, its launches and the first such batch, to time the
    # kernel on after the run.
    shapes: dict = {}
    wrapper = "match_cls_grouped_fused" if fused else "match_cls_grouped"
    grouped = getattr(nk, wrapper)

    def recording(prog, live, acc, cls):
        entry = shapes.setdefault(tuple(cls.shape),
                                  [0, (prog, live, acc, cls)])
        entry[0] += 1
        return grouped(prog, live, acc, cls)

    # Likewise the [B, T] chunk batches (and carries) the long lines hand
    # K2.
    chunks: dict = {}
    chunk = nk.match_chunk_cls

    def recording_chunk(prog, acc, cls, v0, final=True):
        entry = chunks.setdefault(tuple(cls.shape),
                                  [0, (prog, acc, cls, v0, final)])
        entry[0] += 1
        return chunk(prog, acc, cls, v0, final)

    with tempfile.TemporaryDirectory() as out_dir:
        argv[4] = out_dir
        opts = cli.parse_args(argv)
        ui = io.StringIO()
        term.set_ui_stream(ui)
        setattr(nk, wrapper, recording)
        nk.match_chunk_cls = recording_chunk
        try:
            torch.cuda.synchronize()
            nk.reset_launches()
            t0 = time.perf_counter()
            rc = asyncio.run(app.run_async(opts, backend=fc, device=dev))
            seconds = time.perf_counter() - t0
            launches = dict(nk.LAUNCHES)
        finally:
            setattr(nk, wrapper, grouped)
            nk.match_chunk_cls = chunk
            term.set_ui_stream(None)
        files = sorted(os.listdir(out_dir))
        bad = []
        kept = 0
        for name, exp in oracle_files(pods).items():
            kept += exp.count(b"\n")
            with open(os.path.join(out_dir, name), "rb") as f:
                if f.read() != exp:
                    bad.append(name)
    # What sets the run's pace on the host: the same run again under
    # cProfile (the event loop's thread: framing, dispatch, writes).
    profile = None if fused else cli_profile(app, cli, term, fc, argv, dev)
    # The kernel timed (and held against its plain version, K4 against
    # K1 too) on the main path's own batches, its two most frequent
    # shapes.
    key = "k4" if fused else "k1"
    batches = []
    for n, args in sorted(shapes.values(), key=lambda e: -e[0])[:2]:
        check = (k4_check(torch, nk, *args, 20, time_plain=True) if fused
                 else k1_check(torch, nk, *args, 20))
        batches.append(dict(launches=n, **check))
    # K2 held against its plain version and timed on its most frequent
    # chunk shape.
    k2 = [dict(launches=n, **k2_check(torch, nk, *args, 10))
          for n, args in sorted(chunks.values(), key=lambda e: -e[0])[:1]]
    res = dict(rc=rc, pods=len(pods), files=len(files), lines=n_lines,
               kept_lines=kept, seconds=seconds, lines_per_s=n_lines / seconds,
               mismatched_files=bad, launches=launches,
               **{f"{key}_shapes": {f"{B}x{T}": e[0]
                                    for (B, T), e in shapes.items()},
                  f"{key}_batches": batches},
               k2_shapes={f"{B}x{T}": e[0] for (B, T), e in chunks.items()},
               k2_batches=k2, profile=profile)
    name = "cli_fused" if fused else "cli"
    emit({"phase": name, **res})
    ran, idle = (nk.FUSED, nk.GROUPED) if fused else (nk.GROUPED, nk.FUSED)
    if (rc != 0 or bad or len(files) != len(pods) or not batches or not k2
            or launches[ran] == 0 or launches[idle] != 0
            or launches[nk.CHUNK] == 0 or launches[nk.PACK_CLS] == 0
            or any(b["max_abs_err"] or b.get("k1_mismatches")
                   for b in batches + k2)):
        raise AssertionError(f"{name} phase failed: {res}")
    return res


# ---- the observability and fault layers ----------------------------------

# The design budget of the whole observability layer
# (klogs_tpu/obs/profiler.py): under 2% of a run's throughput. Printed
# beside the measured overhead; not a gate.
OBS_BUDGET_PCT = 2.0
OBS_STAGES = ("fanout.read", "coalescer.dispatch", "device.kernel",
              "device.fetch", "sink.write")


def obs_reset() -> None:
    """The process-wide tracer, profiler and fault script back to off:
    the tracer keeps the rate ``--trace-json`` gave it after a run."""
    from klogs_tpu_torch.obs import trace
    from klogs_tpu_torch.obs.profiler import PROFILER
    from klogs_tpu_torch.resilience import FAULTS

    PROFILER.reset()
    trace.reset(None)
    FAULTS.clear()
    FAULTS.bind_registry(None)


def parse_metrics(text: str) -> dict:
    """Prometheus text format 0.0.4 -> families, samples and the sink's
    line count; raises on a line that does not parse."""
    fams, samples, lines_in = {}, 0, None
    for ln in text.splitlines():
        if ln.startswith("# TYPE "):
            _, _, name, typ = ln.split(" ", 3)
            fams[name] = typ
        elif ln and not ln.startswith("#"):
            m = re.fullmatch(r"([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})? (\S+)", ln)
            if m is None:
                raise ValueError(f"bad /metrics line {ln!r}")
            value = float(m.group(3))
            samples += 1
            if m.group(1) == "klogs_sink_lines_total":
                lines_in = value
    return dict(families=len(fams), samples=samples, lines_in=lines_in)


async def http_get(port: int, path: str) -> tuple:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    await writer.drain()
    raw = await reader.read()
    writer.close()
    await writer.wait_closed()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), body


def span_docs(path: str) -> list:
    with open(path) as f:
        return [json.loads(ln) for ln in f]


def files_equal(out_dir: str, want: dict) -> list:
    """The names of the files in ``out_dir`` that differ from ``want``."""
    bad = sorted(set(os.listdir(out_dir)) ^ set(want))
    for name, exp in want.items():
        path = os.path.join(out_dir, name)
        if os.path.exists(path):
            with open(path, "rb") as f:
                if f.read() != exp:
                    bad.append(name)
    return bad


def obs_run(torch, app, cli, term, obs, fc, argv: list, dev, on: bool,
            root: str, label: str, trace_file: bool = True) -> dict:
    """One run of a cell through ``app.run_async``. ``on``: with
    ``--stats-json``, ``--trace-json`` (unless not ``trace_file``),
    ``--profile-json`` and ``--metrics-port`` on a free port, and one
    /metrics and one /profile scrape taken while the run's sink is
    counting lines."""
    out = os.path.join(root, label)
    os.makedirs(out)
    argv = argv + ["-p", os.path.join(out, "logs")]
    if on:
        argv += ["--stats-json", os.path.join(out, "s.json"),
                 "--profile-json", os.path.join(out, "p.jsonl"),
                 "--metrics-port", "0"]
        if trace_file:
            argv += ["--trace-json", os.path.join(out, "t.jsonl")]
    opts = cli.parse_args(argv)
    ports, scrapes = [], {}
    orig_start = obs.MetricsHTTPServer.start

    async def start_and_record(self):
        ports.append(await orig_start(self))
        return ports[-1]

    async def scrape(done) -> None:
        while not done.is_set():
            if ports:
                try:
                    status, body = await http_get(ports[0], "/metrics")
                    parsed = parse_metrics(body.decode())
                    if status == 200 and parsed["lines_in"]:
                        status_p, body_p = await http_get(ports[0],
                                                          "/profile")
                        scrapes.update(metrics=parsed,
                                       profile_status=status_p,
                                       profile=json.loads(body_p),
                                       mid_run=not done.is_set())
                        return
                except ConnectionError:
                    return  # the run ended first: no mid-run scrape
            # Every 50 ms: each scrape's render takes the loop's time,
            # which the run's lines/s include.
            await asyncio.sleep(0.05)

    async def main() -> int:
        done = asyncio.Event()
        task = asyncio.create_task(scrape(done)) if on else None
        try:
            return await app.run_async(opts, backend=fc, device=dev)
        finally:
            done.set()
            if task is not None:
                await task

    obs_reset()
    obs.MetricsHTTPServer.start = start_and_record
    term.set_ui_stream(io.StringIO())
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = asyncio.run(main())
        seconds = time.perf_counter() - t0
    finally:
        obs.MetricsHTTPServer.start = orig_start
        term.set_ui_stream(None)
        obs_reset()
    return dict(rc=rc, seconds=seconds, out=out, scrapes=scrapes)


def obs_files(run: dict, n_lines: int, kept: int, kept_bytes: int) -> dict:
    """What an "on" run's files hold: --stats-json's counts, the spans by
    name with the lines and bytes written under sink.write, and the last
    --profile-json line's stages and probes."""
    out = run["out"]
    with open(os.path.join(out, "s.json")) as f:
        stats = json.load(f)
    spans = span_docs(os.path.join(out, "t.jsonl"))
    names: dict = {}
    for d in spans:
        names[d["name"]] = names.get(d["name"], 0) + 1
    writes = [d["attrs"] for d in spans if d["name"] == "sink.write"]
    with open(os.path.join(out, "p.jsonl")) as f:
        profile = [json.loads(ln) for ln in f]
    last = profile[-1]
    wall = last["wall_s"]
    summary = stats["summary"]
    res = dict(
        lines_in=summary["lines_in"], lines_matched=summary["lines_matched"],
        span_counts=names,
        sink_write_lines=sum(a.get("lines", 0) for a in writes),
        sink_write_bytes=sum(a.get("bytes", 0) for a in writes),
        profile_lines=len(profile), wall_s=wall,
        stages={k: dict(v, busy_share=v["busy_s"] / wall if wall else None)
                for k, v in last["stages"].items()},
        probes=last["samples"], bottleneck=last["bottleneck"],
        families=len(stats["metrics"]))
    # The fan-out's probe goes with its run, before the last tick: an
    # earlier tick or the mid-run /profile scrape shows it.
    probes_seen = set(run["scrapes"].get("profile", {}).get("samples", {}))
    for doc in profile:
        probes_seen |= set(doc["samples"])
    res["files_ok"] = (
        res["lines_in"] == n_lines and res["lines_matched"] == kept
        and res["sink_write_lines"] == kept
        and res["sink_write_bytes"] == kept_bytes
        and set(OBS_STAGES) <= set(last["stages"])
        and {"coalescer.queue_depth", "device.in_flight_used"}
        <= set(res["probes"]) and "fanout.active_streams" in probes_seen)
    return res


def sync_check(torch, GpuEngineFilter, FilterStats, obs, frame, dev) -> dict:
    """``dispatch_framed`` on the engine phase's first frame with tracing
    and the profiler off, then on: host synchronisations counted under
    ``set_sync_debug_mode("warn")``, then each call once under
    ``"error"`` (does it raise?). "On" may not do more than "off"."""
    import warnings

    from klogs_tpu_torch.obs import trace
    from klogs_tpu_torch.obs.profiler import PROFILER

    eng = GpuEngineFilter(PATTERNS, device=dev,
                          stats=FilterStats(registry=obs.Registry()))
    exp = eng.fetch_framed(eng.dispatch_framed(*frame))  # warm-up
    res = {}
    for mode in ("off", "on"):
        obs_reset()
        if mode == "on":
            trace.reset(1.0)
            PROFILER.enable(1.0)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with trace.TRACER.span("coalescer.dispatch"):
                    handle = eng.dispatch_framed(*frame)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        got = eng.fetch_framed(handle)
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        raised = None
        try:
            with trace.TRACER.span("coalescer.dispatch"):
                handle = eng.dispatch_framed(*frame)
        except RuntimeError as e:
            raised = str(e)[:200]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if raised is None:
            eng.fetch_framed(handle)
        spans = sorted({d["name"] for d in trace.TRACER.finished_spans()})
        res[mode] = dict(syncs=syncs, raised=raised, spans=spans,
                         equal=got.tolist() == exp.tolist())
    obs_reset()
    res["ok"] = (res["on"]["syncs"] <= res["off"]["syncs"]
                 and (res["on"]["raised"] is None
                      or res["off"]["raised"] is not None)
                 and res["off"]["equal"] and res["on"]["equal"]
                 and "device.kernel" in res["on"]["spans"])
    return res


def fault_run(torch, app, cli, term, FakeCluster, np, dev, root: str,
              n_faults: int = 8, limit_s: float = 120.0) -> dict:
    """The cli cell's fake in follow mode (no line made after the
    backlog) with ``KLOGS_FAULTS=kube.log_stream:error*N``: the first N
    stream opens fail, the fan-out reconnects them, and the run is
    stopped once every file equals the oracle's. The counters of
    ``--stats-json`` must show N faults fired and N retries."""
    fc, n_lines = cli_cluster(np, FakeCluster, follow_interval_s=3600.0)
    want = oracle_files(fc.namespaces["default"])
    out = os.path.join(root, "faults")
    logs = os.path.join(out, "logs")
    argv = ["-n", "default", "-a", "-f", "-p", logs, "--stats-json",
            os.path.join(out, "s.json")]
    for p in PATTERNS:
        argv += ["--match", p]
    opts = cli.parse_args(argv)

    async def main() -> tuple:
        stop = asyncio.Event()
        task = asyncio.create_task(app.run_async(opts, backend=fc, stop=stop,
                                                 device=dev))
        t0 = time.perf_counter()
        done_at = None
        while time.perf_counter() - t0 < limit_s and not task.done():
            await asyncio.sleep(0.25)
            if os.path.isdir(logs) and sum(
                    os.path.getsize(os.path.join(logs, n))
                    for n in os.listdir(logs)) == sum(map(len, want.values())):
                done_at = time.perf_counter() - t0
                break
        stop.set()
        return await task, done_at

    obs_reset()
    term.set_ui_stream(io.StringIO())
    try:
        with env_set("KLOGS_FAULTS", f"kube.log_stream:error*{n_faults}"):
            rc, done_at = asyncio.run(main())
    finally:
        term.set_ui_stream(None)
        obs_reset()
    with open(os.path.join(out, "s.json")) as f:
        metrics = json.load(f)["metrics"]

    def value(name: str, **labels) -> float:
        return sum(s["value"] for s in metrics[name]["samples"]
                   if s.get("labels", {}) == labels)

    res = dict(rc=rc, lines=n_lines, faults=n_faults, complete_s=done_at,
               mismatched_files=files_equal(logs, want),
               faults_injected=value("klogs_faults_injected_total",
                                     point="kube.log_stream"),
               retry_attempts=value("klogs_retry_attempts_total",
                                    site="fanout"),
               reconnects=sum(s["value"] for s in metrics[
                   "klogs_fanout_reconnects_total"]["samples"]))
    res["ok"] = (rc == 0 and not res["mismatched_files"]
                 and res["faults_injected"] == n_faults
                 and res["retry_attempts"] == n_faults)
    return res


def profile_run(torch, app, cli, term, FakeCluster, np, dev,
                root: str) -> dict:
    """A short cli run with ``--profile DIR``: the torch.profiler trace
    must exist and its kernel events name the hand-written kernels."""
    fc, n_lines = cli_cluster(np, FakeCluster, n_pods=32, lines_per_pod=1000,
                              n_long=4)
    want = oracle_files(fc.namespaces["default"])
    out = os.path.join(root, "profile")
    argv = ["-n", "default", "-a", "-p", os.path.join(out, "logs"),
            "--profile", os.path.join(out, "trace")]
    for p in PATTERNS:
        argv += ["--match", p]
    obs_reset()
    term.set_ui_stream(io.StringIO())
    try:
        rc = asyncio.run(app.run_async(cli.parse_args(argv), backend=fc,
                                       device=dev))
    finally:
        term.set_ui_stream(None)
    traces = sorted(os.listdir(os.path.join(out, "trace")))
    kernels: dict = {}
    for name in traces:
        with open(os.path.join(out, "trace", name)) as f:
            doc = json.load(f)
        for ev in doc.get("traceEvents", []):
            if ev.get("cat") == "kernel":
                kernels[ev["name"]] = kernels.get(ev["name"], 0) + 1
    named = {k: sum(n for name, n in kernels.items() if k in name)
             for k in ("grouped_shift_kernel", "chunk_nfa_kernel",
                       "pack_classify")}
    res = dict(rc=rc, lines=n_lines, trace_files=traces,
               kernel_events=sum(kernels.values()), named=named,
               mismatched_files=files_equal(os.path.join(out, "logs"), want))
    res["ok"] = (rc == 0 and bool(traces) and all(named.values())
                 and not res["mismatched_files"])
    return res


def obs_phase(torch, np, nk, app, cli, term, FakeCluster, GpuEngineFilter,
              FilterStats, frame, dev, card: str, want_k: dict) -> dict:
    """The observability and fault layers on the card: the cli cell run
    with the flags off, on, off (lines/s and the overhead); what the
    files of the "on" run hold, and a mid-run scrape; the K = 1024 cell
    once "on" (its device.kernel spans swept; ``want_k``: its files as
    the oracle selects them, from the cli_k1024 phase); dispatch under
    the sync debug mode untraced and traced; a fault-recovery run; a
    --profile run."""
    from klogs_tpu_torch import obs

    fc, n_lines = cli_cluster(np, FakeCluster)
    want = oracle_files(fc.namespaces["default"])
    kept = sum(v.count(b"\n") for v in want.values())
    kept_bytes = sum(map(len, want.values()))
    argv = ["-n", "default", "-a"]
    for p in PATTERNS:
        argv += ["--match", p]
    root = tempfile.mkdtemp(prefix="klogs-obs-")
    try:
        runs = []
        for i, on in enumerate((False, True, False)):
            r = obs_run(torch, app, cli, term, obs, fc, argv, dev, on, root,
                        f"run{i}")
            r["lines_per_s"] = n_lines / r["seconds"]
            r["mismatched_files"] = files_equal(
                os.path.join(r["out"], "logs"), want)
            if on:
                r["files"] = obs_files(r, n_lines, kept, kept_bytes)
            runs.append(r)
        off = [r["lines_per_s"] for r in runs if "files" not in r]
        on_ = [r["lines_per_s"] for r in runs if "files" in r]
        off_lps = sum(off) / len(off)
        overhead = 100.0 * (1.0 - (sum(on_) / len(on_)) / off_lps)
        # Where the cost sits: the flags on but --trace-json (the spans
        # are still made, sampled and folded by the profiler, but not
        # appended to a file).
        nf = obs_run(torch, app, cli, term, obs, fc, argv, dev, True, root,
                     "no_trace_file", trace_file=False)
        no_file = dict(rc=nf["rc"], seconds=nf["seconds"],
                       lines_per_s=n_lines / nf["seconds"],
                       mismatched_files=files_equal(
                           os.path.join(nf["out"], "logs"), want))
        no_file["overhead_pct"] = 100.0 * (
            1.0 - no_file["lines_per_s"] / off_lps)
        # The K = 1024 cell once with the flags on.
        pats = make_patterns(1024)
        kept_k = sum(v.count(b"\n") for v in want_k.values())
        with env_set("KLOGS_MAX_PATTERN_POSITIONS", "65536"):
            fck, _ = k1024_cluster(np, FakeCluster)
            argv_k = ["-n", "default", "-a"]
            for p in pats:
                argv_k += ["--match", p]
            rk = obs_run(torch, app, cli, term, obs, fck, argv_k, dev, True,
                         root, "k1024")
        spans_k = span_docs(os.path.join(rk["out"], "t.jsonl"))
        kernels_k = [d["attrs"] for d in spans_k
                     if d["name"] == "device.kernel"
                     and "chunks" not in d["attrs"]]
        k1024 = dict(rc=rk["rc"], seconds=rk["seconds"],
                     mismatched_files=files_equal(
                         os.path.join(rk["out"], "logs"), want_k),
                     kept_lines=kept_k,
                     short_kernel_spans=len(kernels_k),
                     swept_spans=sum(bool(a.get("swept")) for a in kernels_k))
        sync = sync_check(torch, GpuEngineFilter, FilterStats, obs, frame,
                          dev)
        faults = fault_run(torch, app, cli, term, FakeCluster, np, dev, root)
        prof = profile_run(torch, app, cli, term, FakeCluster, np, dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for r in runs:
        r.pop("out")
    on_run = runs[1]["files"]
    res = dict(card=card, lines=n_lines, kept_lines=kept,
               runs=[dict(on="files" in r, rc=r["rc"], seconds=r["seconds"],
                          lines_per_s=r["lines_per_s"],
                          mismatched_files=r["mismatched_files"])
                     for r in runs],
               overhead_pct=overhead, budget_pct=OBS_BUDGET_PCT,
               on_without_trace_file=no_file,
               on_files=[r["files"] for r in runs if "files" in r],
               scrapes=[dict(metrics=r["scrapes"].get("metrics"),
                             profile_status=r["scrapes"].get(
                                 "profile_status"),
                             profile_stages=sorted(r["scrapes"].get(
                                 "profile", {}).get("stages", {})),
                             profile_samples=r["scrapes"].get(
                                 "profile", {}).get("samples"),
                             mid_run=r["scrapes"].get("mid_run"))
                        for r in runs if "files" in r],
               stage_utilization={k: v["busy_share"] for k, v in
                                  on_run["stages"].items()},
               k1024=k1024, sync=sync, faults=faults, profile=prof)
    emit({"phase": "obs", **res})
    scrapes_ok = all(
        s["mid_run"] and s["metrics"]["families"] == 95
        and s["profile_status"] == 200 and s["profile_samples"]
        for s in res["scrapes"])
    if (any(r["rc"] != 0 or r["mismatched_files"]
            for r in res["runs"] + [no_file])
            or not all(f["files_ok"] for f in res["on_files"])
            or not scrapes_ok or k1024["rc"] != 0
            or k1024["mismatched_files"] or not k1024["short_kernel_spans"]
            or k1024["swept_spans"] != k1024["short_kernel_spans"]
            or not sync["ok"] or not faults["ok"] or not prof["ok"]):
        raise AssertionError(f"obs phase failed: {res}")
    return res


# ---- the thousand-pattern path ------------------------------------------


def k1024_rows(np, synthetic_line, B: int, width: int, seed: int):
    """[B, width] FakeCluster rows, 1% of them with a minted-family
    needle written over their middle (lengths unchanged)."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((B, width), dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for i in range(B):
        ln = synthetic_line(f"pod-{i % 256:04d}", "c0", i,
                            CLOCK + i).rstrip(b"\n")[:width]
        if i % 100 == 7:
            nd = minted_needle(int(rng.integers(0, 1200)))
            ln = (ln[:30] + nd + ln[30 + len(nd):])[:width]
        rows[i, :len(ln)] = np.frombuffer(ln, dtype=np.uint8)
        lens[i] = len(ln)
    return rows, lens


def gate_cells(bits, nk, words, G: int) -> dict:
    """The gate as K3 meets it: its (line, group) pairs, the candidate
    lines' share, their groups (mean, most), and the share of GATE_TILE
    tiles that the candidates fill once clustered (the stats' live
    tiles)."""
    per_line = bits.unpack_bits(words.long(), G).sum(1)  # [B]
    cand = per_line > 0
    B, n = len(per_line), int(cand.sum())
    return dict(pairs=int(per_line.sum()), candidate_share=n / max(B, 1),
                groups_per_candidate=float(per_line[cand].float().mean())
                if n else 0.0,
                groups_per_line_max=int(per_line.max()) if B else 0,
                live_tile_share=-(-n // nk.GATE_TILE)
                / max(-(-B // nk.GATE_TILE), 1))


def k3_parts(torch, nk, dp, live, acc, cls, words, reps: int) -> dict:
    """K3's two parts apart, on one batch: the card's pair list against
    its plain version (``pairs_mismatches``: count, entries and stats
    that differ), the pair builder's ms (``gate_pairs``: its count, scan
    and scatter kernels) and the launch alone on its list (``ms``:
    ``launch_gated``, the verdicts' zeroing and the kernel), by CUDA
    events."""
    G = int(dp.follow.shape[0])
    pairs, n_pairs, stats = nk.gate_pairs(words, G)
    exp_pairs, exp_n, exp_stats = nk.gate_pairs(words.cpu(), G)
    n, m = int(n_pairs), min(int(n_pairs), int(exp_n))
    bad = (abs(n - int(exp_n)) + int((pairs[:m].cpu() != exp_pairs[:m]).sum())
           + int((stats.cpu() != exp_stats).sum()))
    return dict(
        pairs_mismatches=bad,
        pairs_ms=cuda_ms(torch, lambda: nk.gate_pairs(words, G), reps),
        ms=cuda_ms(torch, lambda: nk.launch_gated(dp, live, acc, cls, pairs,
                                                  n_pairs), reps))


def k3_check(torch, bits, nk, dp, live, acc, cls, words, reps: int) -> dict:
    """K3 against its plain version on one batch, with the bound over
    the gated (line, group) cells. ``ms`` times the launch alone on its
    pair list, ``pairs_ms`` the pair builder, ``wrapper_ms`` the whole
    wrapper (pair list, launch), ``plain_ms`` the plain version."""
    got, stats = nk.match_cls_grouped_gated(dp, live, acc, cls, words,
                                            want_stats=True)
    work: dict = {}
    torch.cuda.synchronize()
    exp, plain_ms = timed_call(
        torch, lambda: nk.match_cls_grouped_gated_plain(
            dp, live, acc, cls, words, work=work))
    err = int((got.int() - exp.int()).abs().max()) if len(got) else 0
    parts = k3_parts(torch, nk, dp, live, acc, cls, words, reps)
    wrapper_ms = cuda_ms(torch, lambda: nk.match_cls_grouped_gated(
        dp, live, acc, cls, words), reps)
    B, T = cls.shape
    G, C, S = dp.char_mask.shape
    GW = words.shape[1]
    cells = gate_cells(bits, nk, words, G)
    n_bytes = (B * T * 2 + B * GW * 4 + G * (S + C) * (S // 32) * 4 + B
               + 4 * cells["pairs"] + 4)
    return dict(rows=B, T=T, groups=G, max_abs_err=err, **parts,
                wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                matched=int(exp.sum()),
                candidate_lines=int(stats[0]), live_tiles=int(stats[1]),
                tiles=int(stats[2]), **cells,
                **step_bounds(n_bytes, S, C, cells["pairs"] * T,
                              work["active"]))


def sweep_phase(torch, np, sweep, bits, gpu, FilterStats, synthetic_line,
                dev, rows=131072, width=128) -> dict:
    """The K=1024 engine and its gate tables; the sweep on the card
    against the same function, on tables built for the CPU."""
    pats = make_patterns(1024)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    eng = gpu.GpuEngineFilter(pats, device=dev, stats=FilterStats())
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_bytes = torch.cuda.memory_allocated(dev) - mem0
    st = eng._sweep_tables
    if st is None:
        raise AssertionError("auto mode did not gate K=1024 on the card")
    batch, lens = k1024_rows(np, synthetic_line, rows, width, SEED + 4)
    batch_d = torch.from_numpy(batch).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    words = sweep.sweep_group_bits(st, batch_d, lens_d)
    ms = cuda_ms(torch, lambda: sweep.sweep_group_bits(st, batch_d, lens_d),
                 5)
    gm = bits.unpack_bits(words, st.n_groups).cpu()
    from klogs_tpu_torch.filters.compiler.groups import analyze, plan_groups
    from klogs_tpu_torch.filters.compiler.index import FactorIndex

    t0 = time.perf_counter()
    infos = analyze(pats)
    prog = FactorIndex(infos, plan_groups(infos)).sweep_program(
        group_of=np.asarray(eng._grouped.pattern_group, dtype=np.int32),
        n_groups=st.n_groups)
    host = sweep.sweep_group_candidates(
        sweep.device_sweep_tables(prog, device="cpu"),
        torch.from_numpy(batch), torch.from_numpy(lens))
    cpu_s = time.perf_counter() - t0
    bad = int((gm != host).sum())
    res = dict(rows=rows, width=width, groups=st.n_groups,
               words=int(st.always_mask.numel()),
               factors=int(st.fac_len.numel()), build_s=build_s,
               build_bytes=build_bytes, long_route=(
                   "grouped" if eng._long is not None else "union"), ms=ms,
               cpu_s=cpu_s, mismatched_cells=bad,
               candidate_line_share=float(gm.any(1).float().mean()),
               groups_per_line=float(gm.sum(1).float().mean()),
               groups_per_line_max=int(gm.sum(1).max()),
               narrow=[st.narrow.slot_key.numel(), st.narrow.max_probe,
                       st.narrow.max_bucket, st.narrow.n_words],
               wide=[st.wide.slot_key.numel(), st.wide.max_probe,
                     st.wide.max_bucket, st.wide.n_words])
    emit({"phase": "sweep", **res})
    if bad:
        raise AssertionError(f"sweep: card and CPU masks differ: {res}")
    return dict(res, eng=eng, batch=batch_d, lens=lens_d, words=words)


def k3_phase(torch, nfa, bits, nk, sw, small=8192, kept=0.03) -> dict:
    """K3 against its plain version (sweep gate, random gate) and against
    ungated K1 on the sweep phase's batch; K3 and K1 timed there. Then
    the sweep's gate kept on a seeded 3% of the lines only (the share of
    candidates the host sweep leaves on the repository's needle corpus):
    K3 must equal K1 on the kept lines and be false elsewhere. On every
    batch the card's pair list must equal its plain version."""
    eng = sw["eng"]
    dp, live, acc = eng._grouped, eng._g_live, eng._g_acc
    cls = nfa.classify_chunk(dp, sw["batch"], sw["lens"], True, True)
    words = sw["words"]
    G = int(dp.follow.shape[0])
    gen = torch.Generator(device=cls.device).manual_seed(SEED)
    rand = bits.pack_bits(torch.rand((small, G), generator=gen,
                                     device=cls.device) < 0.05)
    res = {"sweep_gate": k3_check(torch, bits, nk, dp, live, acc,
                                  cls[:small], words[:small], 5),
           "random_gate": k3_check(torch, bits, nk, dp, live, acc,
                                   cls[:small], rand, 5)}
    k3, _ = nk.match_cls_grouped_gated(dp, live, acc, cls, words)
    k1 = nk.match_cls_grouped(dp, live, acc, cls)
    # The plain version over the whole batch, in slices: K3 against it
    # everywhere, and the state bits its gated cells read (the bound).
    work: dict = {}
    plain_err = 0
    for i in range(0, cls.shape[0], small):
        exp = nk.match_cls_grouped_gated_plain(
            dp, live, acc, cls[i:i + small], words[i:i + small], work=work)
        plain_err = max(plain_err, int((k3[i:i + small].int()
                                        - exp.int()).abs().max()))
    B, T = cls.shape
    S, C, GW = dp.n_states, dp.n_classes, words.shape[1]
    n_bytes = B * T * 2 + B * GW * 4 + G * (S + C) * (S // 32) * 4 + B
    k1_ms = cuda_ms(torch, lambda: nk.match_cls_grouped(dp, live, acc, cls), 3)

    def timed(w, active: int) -> dict:
        cells = gate_cells(bits, nk, w, G)
        parts = k3_parts(torch, nk, dp, live, acc, cls, w, 10)
        return dict(
            k3_ms=parts["ms"], k3_pairs_ms=parts["pairs_ms"],
            pairs_mismatches=parts["pairs_mismatches"],
            k3_wrapper_ms=cuda_ms(torch, lambda: nk.match_cls_grouped_gated(
                dp, live, acc, cls, w), 10),
            k1_ms=k1_ms, **cells,
            **step_bounds(n_bytes + 4 * cells["pairs"] + 4, S, C,
                          cells["pairs"] * T, active))

    full = dict(rows=B, T=T, max_abs_err=plain_err,
                k3_vs_k1_mismatches=int((k3 != k1).sum()),
                matched=int(k1.sum()), **timed(words, work["active"]))
    keep = torch.rand(B, generator=gen, device=cls.device) < kept
    sparse = torch.where(keep[:, None], words, torch.zeros_like(words))
    k3s, _ = nk.match_cls_grouped_gated(dp, live, acc, cls, sparse)
    work = {}
    exp = nk.match_cls_grouped_gated_plain(dp, live, acc, cls[keep],
                                           sparse[keep], work=work)
    res["sparse_gate"] = dict(
        rows=B, kept_lines=int(keep.sum()),
        max_abs_err=int((k3s[keep].int() - exp.int()).abs().max()),
        k3_vs_k1_mismatches=int((k3s != (k1 & keep)).sum()),
        matched=int(k3s.sum()), **timed(sparse, work["active"]))
    res["full"] = full
    emit({"phase": nk.GATED, **res})
    if (any(r["max_abs_err"] or r["pairs_mismatches"] for r in res.values())
            or full["k3_vs_k1_mismatches"] or not full["matched"]
            or res["sparse_gate"]["k3_vs_k1_mismatches"]
            or not res["sparse_gate"]["matched"]
            or res["sparse_gate"]["live_tile_share"] > 0.5):
        raise AssertionError(f"{nk.GATED} disagrees: {res}")
    return res


def k4_phase(torch, nfa, nk, k1_batches, sw, small=8192) -> dict:
    """K4 against its plain version and K1 (verdicts equal), K4 and K1
    timed in turns: 8192 rows of K1's w128 mix (its plain version timed
    too), the whole 131072-row w128 batch, the 4096 bucket, the
    1280-state wide program, and at K = 1024 (156 groups, ungated) the
    sweep phase's 131072 x 131 batch. The K = 1024 256-byte bucket
    follows in ``k4_b256_check``, on the batch the engine launched."""
    dp, live, acc, cls = k1_batches["w128"]
    res = {"w128_8192": k4_check(torch, nk, dp, live, acc, cls[:small], 20,
                                 time_plain=True),
           "w128": k4_check(torch, nk, dp, live, acc, cls, 20),
           "w4096": k4_check(torch, nk, *k1_batches["w4096"], 5),
           "s1280": k4_check(torch, nk, *k1_batches["s1280"], 1)}
    eng = sw["eng"]
    dp, live, acc = eng._grouped, eng._g_live, eng._g_acc
    cls = nfa.classify_chunk(dp, sw["batch"], sw["lens"], True, True)
    res["k1024"] = k4_check(torch, nk, dp, live, acc, cls, 3, step=small)
    emit({"phase": nk.FUSED, **res})
    if (any(r["max_abs_err"] or r["k1_mismatches"] for r in res.values())
            or not res["s1280"]["matched"]):
        raise AssertionError(f"{nk.FUSED} disagrees: {res}")
    return res


def k4_b256_check(torch, nk, k4: dict, batch) -> None:
    """K4 against its plain version and K1 on the K = 1024 256-byte
    bucket that the K1-only engine of ``engine_k1024`` launched on its
    first 131072-line batch (captured there), added to ``k4``."""
    if batch is None:
        raise AssertionError("engine_k1024 launched no 256-byte bucket")
    r = k4_check(torch, nk, *batch, 3)
    k4["k1024_b256"] = r
    emit({"phase": nk.FUSED, "k1024_b256": r})
    if r["max_abs_err"] or r["k1_mismatches"] or not r["matched"]:
        raise AssertionError(f"{nk.FUSED} disagrees on the bucket: {r}")


def profile_gated_batch(torch, gpu, frame) -> dict:
    """profile_batch with the sweep and K3 wrapped in named ranges, for
    their shares of the batch's device time."""
    from torch.profiler import record_function

    wrapped = {}
    for mod, name, label in ((gpu.sweep, "sweep_group_bits", "klogs.sweep"),
                             (gpu.nfa_kernels, "match_cls_grouped_gated",
                              "klogs.k3")):
        fn = getattr(mod, name)
        wrapped[(mod, name)] = fn

        def ranged(*a, _fn=fn, _label=label, **kw):
            with record_function(_label):
                return _fn(*a, **kw)

        setattr(mod, name, ranged)
    try:
        prof = profile_batch(torch, *frame)
    finally:
        for (mod, name), fn in wrapped.items():
            setattr(mod, name, fn)
    return prof


def engine_k1024_phase(torch, np, nk, gpu, frame_lines, synthetic_line, eng,
                       dev, n_short=1 << 19,
                       n_long=256, batch=131072, checked=32768) -> dict:
    rng = np.random.default_rng(SEED + 5)
    pats = make_patterns(1024)
    short = [synthetic_line(f"pod-{i % 512:04d}", f"c{i % 2}", i, CLOCK + i)
             for i in range(n_short)]
    for i in range(0, n_short, 100):  # 1% needles: minted and the 32-set's
        nd = (minted_needle(int(rng.integers(0, 1200))) if i % 200
              else NEEDLES[(i // 200) % len(NEEDLES)])
        short[i] = short[i][:40] + nd + short[i][40:]
    long_lines = []
    for i in range(n_long):
        n = int(rng.integers(4097, 64 * 1024 + 1))
        body = bytearray(rng.integers(32, 127, size=n, dtype=np.uint8))
        if i % 2:
            nd = minted_needle(int(rng.integers(0, 992)))
            p = int(rng.integers(0, n - len(nd)))
            body[p:p + len(nd)] = nd
        long_lines.append(bytes(body) + b"\n")
    frames = [frame_lines(short[i:i + batch], strip_nl=False)[:2]
              for i in range(0, n_short, batch)]
    long_frame = frame_lines(long_lines, strip_nl=False)[:2]
    eng.fetch_framed(eng.dispatch_framed(*frames[0]))  # warm-up
    torch.cuda.synchronize()
    stats = eng._stats
    pf0 = (stats.pf_lines, stats.pf_candidates, stats.pf_tiles_total,
           stats.pf_tiles_live)
    nk.reset_launches()
    verdicts, t0 = [], time.perf_counter()
    for f in frames:
        verdicts.append(eng.fetch_framed(eng.dispatch_framed(*f)))
    t_short = time.perf_counter() - t0
    short_launches = dict(nk.LAUNCHES)
    pf_lines, pf_cand, pf_tiles, pf_live = (
        a - b for a, b in zip((stats.pf_lines, stats.pf_candidates,
                               stats.pf_tiles_total, stats.pf_tiles_live),
                              pf0))
    with recording_wrappers(nk, None, ["match_chunk_cls_grouped"]) as calls:
        t0 = time.perf_counter()
        long_v = eng.fetch_framed(eng.dispatch_framed(*long_frame))
        t_long = time.perf_counter() - t0
    launches = dict(nk.LAUNCHES)
    k2g_batches = held_k2g(torch, nk, calls)
    del calls
    got = np.concatenate(verdicts)
    # The same short lines through K1 alone (no gate). Its warm-up
    # captures the 256-byte bucket's K1 launch for k4_b256_check.
    with env_set("KLOGS_TPU_SWEEP", "0"):
        plain = gpu.GpuEngineFilter(pats, device=dev)
    grouped, b256 = nk.match_cls_grouped, []

    def recording(prog, live, acc, cls):
        if cls.shape[1] == 256 + 3:
            b256.append((prog, live, acc, cls))
        return grouped(prog, live, acc, cls)

    nk.match_cls_grouped = recording
    try:
        plain.fetch_framed(plain.dispatch_framed(*frames[0]))  # warm-up
    finally:
        nk.match_cls_grouped = grouped
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k1_only = np.concatenate([plain.fetch_framed(plain.dispatch_framed(*f))
                              for f in frames])
    t_k1 = time.perf_counter() - t0
    k1_prof = profile_batch(torch, plain, frames[0])
    bodies = [ln.rstrip(b"\n") for ln in short[:checked] + long_lines]
    exp = oracle_verdicts(pats, bodies)
    bad = int((got[:checked] != np.asarray(exp[:checked])).sum()
              + (long_v != np.asarray(exp[checked:])).sum())
    vs_k1 = int((got != k1_only).sum())
    prof = profile_gated_batch(torch, gpu, (eng, frames[0]))
    res = dict(short_lines=n_short, long_lines=n_long, batch_lines=batch,
               short_lines_per_s=n_short / t_short,
               long_lines_per_s=n_long / t_long,
               long_bytes_per_s=sum(map(len, long_lines)) / t_long,
               oracle_checked=len(bodies), mismatches=bad,
               k1_only_mismatches=vs_k1, matched_short=int(got.sum()),
               matched_long=int(long_v.sum()), short_launches=short_launches,
               launches=launches, gated_lines=pf_lines,
               candidate_share=pf_cand / max(pf_lines, 1),
               tiles_skipped=pf_tiles - pf_live, tiles=pf_tiles,
               profile=prof, k1_only_short_lines_per_s=n_short / t_k1,
               k1_only_profile=k1_prof,
               # One batch's device time, gated (sweep and K3) and K1 only.
               gated_device_ms=prof["device_ms"],
               k1_only_device_ms=k1_prof["device_ms"],
               k2g_batches=k2g_batches)
    emit({"phase": "engine_k1024", **res})
    if (bad or vs_k1 or short_launches[nk.GATED] == 0
            or short_launches[nk.PAIRS] == 0
            or short_launches[nk.PACK_CLS] == 0
            or short_launches[nk.GROUPED] != 0
            or launches[nk.GROUPED_CHUNK] == 0 or launches[nk.CHUNK] != 0
            or not k2g_batches or k2g_batches[0]["max_abs_err"]
            or not got.any() or not long_v.any()):
        raise AssertionError(f"engine_k1024 phase failed: {res}")
    return dict(res, b256=b256[0] if b256 else None)


def k1024_cluster(np, FakeCluster, n_pods=256, lines_per_pod=250,
                  n_long=8):
    """The cli_k1024 cell's FakeCluster (~1% minted needles, a long line
    of 5-60 KiB in each of the first ``n_long`` pods) and its lines by
    pod."""
    rng = np.random.default_rng(SEED + 6)
    fc = FakeCluster.synthetic(n_pods=n_pods, n_containers=1,
                               lines_per_container=lines_per_pod,
                               clock=lambda: CLOCK)
    pods = fc.namespaces["default"]
    for j, name in enumerate(sorted(pods)):
        lines = pods[name].containers["c0"].lines
        for k in range(j % 3, len(lines), 97):  # ~1% needles
            ts, ln = lines[k]
            lines[k] = (ts, ln[:40] + minted_needle(
                int(rng.integers(0, 1200))) + ln[40:])
        if j < n_long:
            n = int(rng.integers(5000, 60 * 1024))
            body = bytearray(rng.integers(32, 127, size=n, dtype=np.uint8))
            if j % 2:
                nd = minted_needle(int(rng.integers(0, 992)))
                body[n // 2:n // 2 + len(nd)] = nd
            lines.insert(50 + j, (CLOCK - 3000, bytes(body) + b"\n"))
    all_lines = {name: [ln for _, ln in pods[name].containers["c0"].lines]
                 for name in sorted(pods)}
    return fc, all_lines


def k1024_expected(pats: list, all_lines: dict) -> tuple:
    """(each pod's file as the ``re`` oracle selects it, kept lines)."""
    flat = [ln for name in sorted(all_lines) for ln in all_lines[name]]
    exp = oracle_verdicts(pats, [ln.rstrip(b"\n") for ln in flat])
    want, at = {}, 0
    for name in sorted(all_lines):
        n = len(all_lines[name])
        want[f"{name}__c0.log"] = b"".join(
            ln for ln, v in zip(all_lines[name], exp[at:at + n]) if v)
        at += n
    return want, int(sum(exp))


def cli_k1024_run(torch, np, nk, bits, app, cli, term, FakeCluster, dev,
                  pats: list, n_pods: int, lines_per_pod: int,
                  n_long: int) -> dict:
    """``app.run_async`` with ``--match`` for each of ``pats`` on the
    ``k1024_cluster`` cell (counts zeroed just before, read just after),
    its files against the ``re`` oracle; then K3 (and its pair list)
    held against its plain version on the run's most frequent batch and
    K2g on its most frequent chunk batch. Returns the run's figures and
    the oracle's files (``want``)."""
    fc, all_lines = k1024_cluster(np, FakeCluster, n_pods, lines_per_pod,
                                  n_long)
    pods = fc.namespaces["default"]
    flat = [ln for name in sorted(pods) for ln in all_lines[name]]
    argv = ["-n", "default", "-a", "--stats", "-p", ""]
    for p in pats:
        argv += ["--match", p]
    shapes: dict = {}
    gated = nk.match_cls_grouped_gated

    def recording(prog, live, acc, cls, words, want_stats=False):
        entry = shapes.setdefault(tuple(cls.shape),
                                  [0, (prog, live, acc, cls, words)])
        entry[0] += 1
        return gated(prog, live, acc, cls, words, want_stats=want_stats)

    with tempfile.TemporaryDirectory() as out_dir, \
            recording_wrappers(nk, None, ["match_chunk_cls_grouped"]) as calls:
        argv[5] = out_dir
        opts = cli.parse_args(argv)
        ui = io.StringIO()
        term.set_ui_stream(ui)
        nk.match_cls_grouped_gated = recording
        try:
            torch.cuda.synchronize()
            nk.reset_launches()
            t0 = time.perf_counter()
            rc = asyncio.run(app.run_async(opts, backend=fc, device=dev))
            seconds = time.perf_counter() - t0
            launches = dict(nk.LAUNCHES)
        finally:
            nk.match_cls_grouped_gated = gated
            term.set_ui_stream(None)
        want, kept = k1024_expected(pats, all_lines)
        bad = []
        for name, exp in want.items():
            with open(os.path.join(out_dir, name), "rb") as f:
                if f.read() != exp:
                    bad.append(name)
        files = len(os.listdir(out_dir))
    text = ui.getvalue()
    pf_line = next((ln.strip() for ln in text.splitlines()
                    if "prefilter:" in ln), None)
    k3_batches = []
    for n, args in sorted(shapes.values(), key=lambda e: -e[0])[:1]:
        k3_batches.append(dict(launches=n, **k3_check(torch, bits, nk,
                                                      *args, 20)))
    k2g_batches = held_k2g(torch, nk, calls)
    del calls
    return dict(rc=rc, pods=len(pods), files=files, lines=len(flat),
                kept_lines=kept, seconds=seconds,
                lines_per_s=len(flat) / seconds, mismatched_files=bad,
                launches=launches, prefilter_line=pf_line,
                k3_shapes={f"{B}x{T}": e[0] for (B, T), e in shapes.items()},
                k3_batches=k3_batches, k2g_batches=k2g_batches, want=want)


def cli_k1024_phase(torch, np, nk, bits, app, cli, term, FakeCluster, dev,
                    n_pods=256, lines_per_pod=250, n_long=8) -> dict:
    res = cli_k1024_run(torch, np, nk, bits, app, cli, term, FakeCluster,
                        dev, make_patterns(1024), n_pods, lines_per_pod,
                        n_long)
    want = res.pop("want")
    emit({"phase": "cli_k1024", **res})
    rc, bad, files, pods, kept = (res["rc"], res["mismatched_files"],
                                  res["files"], res["pods"],
                                  res["kept_lines"])
    launches, pf_line = res["launches"], res["prefilter_line"]
    k3_batches, k2g_batches = res["k3_batches"], res["k2g_batches"]
    if (rc != 0 or bad or files != pods or not kept
            or launches[nk.GATED] == 0 or launches[nk.PAIRS] == 0
            or launches[nk.PACK_CLS] == 0
            or launches[nk.GROUPED] != 0 or pf_line is None or not k3_batches
            or launches[nk.GROUPED_CHUNK] == 0 or launches[nk.CHUNK] != 0
            or not k2g_batches
            or any(b["max_abs_err"] or b.get("pairs_mismatches")
                   for b in k3_batches + k2g_batches)):
        raise AssertionError(f"cli_k1024 phase failed: {res}")
    res["want"] = want
    return res


# ---- the mesh: data x pattern shards over one card ------------------------

# Grids of the K = 32 part, over [cuda:0] x d*g (one card listed again).
MESH_GRIDS = ((1, 1), (4, 1), (2, 2), (1, 4))
# BASELINE config 5's shape: 4096 pods x 64 lines, 8 long lines.
CONFIG5_PODS, CONFIG5_LINES = 4096, 64


def with_lines(np, frame, lines: list) -> tuple:
    """A framed batch with ``lines`` appended (unstripped)."""
    payload, offsets = frame
    ends = offsets[-1] + np.cumsum([len(ln) for ln in lines])
    return (payload + b"".join(lines),
            np.concatenate([offsets, ends]).astype(np.int32))


def mesh_expected(f, frame) -> dict:
    """The launches one dispatch of ``frame`` makes through ``f``'s mesh
    engine: K1 (or K3) and ``pack_classify_rows`` once a shard whose rows
    hold a line, a width bucket; ``pack_classify_rows`` once more a chunk
    of the long lines (K2, on the first device)."""
    layout, _ = f._layout(*frame)
    d, g = f._engine.grid
    shards = chunks = 0
    for idx, width, rows, longest in layout:
        if width is None:
            chunks += -(-longest // f._chunk_bytes)
        else:
            shards += g * sum(di * (rows // d) < len(idx) for di in range(d))
    return dict(kernel=shards, pack=shards + chunks, chunk=chunks)


def timed_dispatches(torch, f, frame, reps: int) -> tuple:
    """(verdicts, seconds) of ``reps`` dispatch-and-fetch rounds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        got = f.fetch_framed(f.dispatch_framed(*frame))
    return got, time.perf_counter() - t0


def mesh_grids(torch, np, nk, pack, GpuEngineFilter, MeshEngine, frame0,
               dev, card: str, reps: int = 3) -> dict:
    """(a) The 32 patterns over each grid on the engine phase's first frame
    and 16 long lines: the single engine's verdicts, the launches a
    shard, K1 held on one shard's batch, lines/s beside the single
    engine's."""
    rng = np.random.default_rng(SEED + 8)
    longs = []
    for i in range(16):
        body = bytearray(rng.integers(32, 127, size=int(
            rng.integers(4097, 64 * 1024)), dtype=np.uint8))
        if i % 2:
            body[len(body) // 3:len(body) // 3 + 8] = b"code=503"
        longs.append(bytes(body) + b"\n")
    frame = with_lines(np, frame0, longs)
    n = len(frame[1]) - 1
    single = GpuEngineFilter(PATTERNS, device=dev)
    single.fetch_framed(single.dispatch_framed(*frame))  # warm-up
    want, secs = timed_dispatches(torch, single, frame, reps)
    ora = oracle_fn()
    bad_long = sum(bool(v) != ora(ln.rstrip(b"\n"))
                   for v, ln in zip(want[-16:], longs))
    rows, bad = [], []
    for d, g in MESH_GRIDS:
        f = GpuEngineFilter(PATTERNS, engine=MeshEngine(
            PATTERNS, devices=[dev] * (d * g), grid=(d, g)))
        f.fetch_framed(f.dispatch_framed(*frame))  # warm-up
        exp = mesh_expected(f, frame)
        nk.reset_launches()
        got, t = timed_dispatches(torch, f, frame, reps)
        launches = dict(nk.LAUNCHES)
        row = dict(grid=f"{d}x{g}", lines_per_s=n * reps / t,
                   vs_single=secs / t, mismatches=int((got != want).sum()),
                   launches=launches, expected={k: v * reps
                                                for k, v in exp.items()})
        if (row["mismatches"] or launches[nk.GROUPED] != exp["kernel"] * reps
                or launches[nk.PACK_CLS] != exp["pack"] * reps
                or launches[nk.CHUNK] != exp["chunk"] * reps):
            bad.append(row["grid"])
        if (d, g) == (2, 2):
            # One shard's batches, as the shard built them, held against
            # the plain versions: its K1 batch and its pack_classify_rows cut.
            with recording_wrappers(nk, pack, ["match_cls_grouped",
                                               "pack_classify_rows"]) as calls:
                f.fetch_framed(f.dispatch_framed(*frame))
            held = held_batches(torch, nk, pack, calls, 1)
            k1, cut = held["k1_batches"][0], held["pack_batches"][0]
            row.update(k1=k1, pack=cut)
            mesh_launches = launches
        rows.append(row)
    res = dict(part="a", card=card, lines=n, long_lines=len(longs),
               reps=reps, single_lines_per_s=n * reps / secs,
               long_oracle_mismatches=bad_long, grids=rows,
               failed_grids=bad)
    emit({"phase": "mesh", **res})
    if bad or bad_long or k1["max_abs_err"] or cut["mismatches"]:
        raise AssertionError(f"mesh (a) failed: {res}")
    return dict(res, k1=k1, pack=cut, launches=mesh_launches)


def k1024_lines(np, synthetic_line, n: int, seed: int) -> list:
    """``n`` FakeCluster lines, 1% with a minted-family needle."""
    rng = np.random.default_rng(seed)
    lines = [synthetic_line(f"pod-{i % 512:04d}", "c0", i, CLOCK + i)
             for i in range(n)]
    for i in range(3, n, 100):
        lines[i] = (lines[i][:40] + minted_needle(int(rng.integers(0, 1200)))
                    + lines[i][40:])
    return lines


def mesh_k1024(torch, np, nk, bits, pack, GpuEngineFilter, MeshEngine,
               frame_lines, synthetic_line, eng1024, dev, card: str,
               n_lines: int = 65536) -> dict:
    """(b) The 1024 patterns over a (2, 2) grid: each shard's sweep tables
    on the card, the single engine's verdicts, K3 and its pair list held
    on one shard's batch."""
    pats = make_patterns(1024)
    frame = frame_lines(k1024_lines(np, synthetic_line, n_lines, SEED + 9),
                        strip_nl=False)[:2]
    eng1024.fetch_framed(eng1024.dispatch_framed(*frame))  # warm-up
    want, secs = timed_dispatches(torch, eng1024, frame, 1)
    t0 = time.perf_counter()
    eng = MeshEngine(pats, devices=[dev] * 4, grid=(2, 2))
    f = GpuEngineFilter(pats, engine=eng)
    build_s = time.perf_counter() - t0
    on_card = eng.swept and all(sh._sweep_tables.device == dev
                                for sh in eng._shards.values())
    f.fetch_framed(f.dispatch_framed(*frame))  # warm-up
    exp = mesh_expected(f, frame)
    with recording_wrappers(nk, pack, ["match_cls_grouped_gated"]) as calls:
        nk.reset_launches()
        got, t = timed_dispatches(torch, f, frame, 1)
        launches = dict(nk.LAUNCHES)
    args = max(calls["match_cls_grouped_gated"].values(),
               key=lambda e: e[0])[1][0][0]
    k3 = k3_check(torch, bits, nk, *args[:5], 10)
    res = dict(part="b", card=card, lines=n_lines, build_s=build_s,
               sweep_on_card=on_card,
               shard_groups=[int(sh._grouped.follow.shape[0])
                             for sh in eng._shards.values()],
               lines_per_s=n_lines / t, single_lines_per_s=n_lines / secs,
               mismatches=int((got != want).sum()), matched=int(got.sum()),
               launches=launches, expected=exp,
               k3={k: v for k, v in k3.items() if not hasattr(v, "shape")})
    emit({"phase": "mesh", **res})
    if (res["mismatches"] or not on_card or not got.any()
            or launches[nk.GATED] != exp["kernel"]
            or launches[nk.PAIRS] != exp["kernel"]
            or launches[nk.GROUPED] != 0
            or launches[nk.PACK_CLS] != exp["pack"]
            or k3["max_abs_err"] or k3["pairs_mismatches"]):
        raise AssertionError(f"mesh (b) failed: {res}")
    return dict(res, k3=k3)


def mesh_cli_run(torch, nk, app, cli, term, mesh_mod, MeshEngine, fc,
                 pats: list, dev, stats: bool) -> dict:
    """``app.run_async`` with the engine factory's device list at
    [cuda:0] x 4: its files, lines/s, launches and engine."""
    argv = ["-n", "default", "-a", "-p", ""] + (["--stats"] if stats else [])
    for p in pats:
        argv += ["--match", p]
    real = mesh_mod.engine_devices
    with tempfile.TemporaryDirectory() as out_dir, \
            captured_pipeline() as made, \
            recording_wrappers(nk, None, ["match_chunk_cls_grouped"]) as calls:
        argv[4] = out_dir
        opts = cli.parse_args(argv)
        ui = io.StringIO()
        term.set_ui_stream(ui)
        mesh_mod.engine_devices = lambda device=None: [dev] * 4
        try:
            torch.cuda.synchronize()
            nk.reset_launches()
            t0 = time.perf_counter()
            rc = asyncio.run(app.run_async(opts, backend=fc, device=dev))
            seconds = time.perf_counter() - t0
            launches = dict(nk.LAUNCHES)
        finally:
            mesh_mod.engine_devices = real
            term.set_ui_stream(None)
        files = {}
        for name in os.listdir(out_dir):
            with open(os.path.join(out_dir, name), "rb") as fh:
                files[name] = fh.read()
    eng = made[0].log_filter._engine if made else None
    return dict(rc=rc, files=files, seconds=seconds, launches=launches,
                mesh=isinstance(eng, MeshEngine),
                grid=list(eng.grid) if eng is not None else None,
                swept=getattr(eng, "swept", None), ui=ui.getvalue(),
                k2g_batches=held_k2g(torch, nk, calls))


def config5_cluster(np, FakeCluster, n_pods: int):
    """BASELINE config 5's shape: ``n_pods`` pods x 64 lines (~1% minted
    needles), a long line in 8 of them."""
    return k1024_cluster(np, FakeCluster, n_pods=n_pods,
                         lines_per_pod=CONFIG5_LINES, n_long=8)


def mesh_cli(torch, np, nk, app, cli, term, FakeCluster, frame_lines,
             mesh_mod, MeshEngine, eng1024, dev, card: str,
             want1024: dict) -> dict:
    """(c) The user's entry point through the mesh: the cli_k1024 cell
    (files = its oracle's), then BASELINE config 5's shape (files = the
    single engine's verdicts, that engine held to ``re`` on the first
    4096 lines)."""
    import resource

    pats = make_patterns(1024)
    fc, all_lines = k1024_cluster(np, FakeCluster)
    a = mesh_cli_run(torch, nk, app, cli, term, mesh_mod, MeshEngine, fc,
                     pats, dev, stats=True)
    n_a = sum(map(len, all_lines.values()))
    bad_a = sorted(n for n, b in want1024.items() if a["files"].get(n) != b)
    # 4096 streams write 4096 files at once.
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < hard:
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    n_pods = min(CONFIG5_PODS, max(256, hard - 1024))
    fc5, lines5 = config5_cluster(np, FakeCluster, n_pods)
    flat = [ln for name in sorted(lines5) for ln in lines5[name]]
    verdicts = np.concatenate([
        eng1024.fetch_framed(eng1024.dispatch_framed(
            *frame_lines(flat[i:i + 131072], strip_nl=False)[:2]))
        for i in range(0, len(flat), 131072)])
    exp = oracle_verdicts(pats, [ln.rstrip(b"\n") for ln in flat[:4096]])
    oracle_bad = int((verdicts[:4096] != np.asarray(exp)).sum())
    want5, at = {}, 0
    for name in sorted(lines5):
        k = len(lines5[name])
        want5[f"{name}__c0.log"] = b"".join(
            ln for ln, v in zip(lines5[name], verdicts[at:at + k]) if v)
        at += k
    c5 = mesh_cli_run(torch, nk, app, cli, term, mesh_mod, MeshEngine, fc5,
                      pats, dev, stats=False)
    bad_5 = sorted(n for n, b in want5.items() if c5["files"].get(n) != b)
    cells = []
    for name, run, n, badf, want in (("cli_k1024", a, n_a, bad_a, want1024),
                                     ("config5", c5, len(flat), bad_5,
                                      want5)):
        cells.append(dict(
            cell=name, rc=run["rc"], mesh=run["mesh"], grid=run["grid"],
            swept=run["swept"], lines=n, files=len(run["files"]),
            want_files=len(want), seconds=run["seconds"],
            lines_per_s=n / run["seconds"], mismatched_files=badf[:8],
            n_mismatched=len(badf), launches=run["launches"],
            k2g_batches=run["k2g_batches"]))
    stats_line = next((ln.strip() for ln in a["ui"].splitlines()
                       if "Filter stats:" in ln), None)
    res = dict(part="c", card=card, cells=cells, config5_pods=n_pods,
               config5_cut=n_pods < CONFIG5_PODS, nofile=[soft, hard],
               single_oracle_checked=4096, single_oracle_mismatches=oracle_bad,
               stats_line=stats_line, kept_config5=int(verdicts.sum()))
    emit({"phase": "mesh", **res})
    if (oracle_bad or stats_line is None
            or any(c["rc"] or not c["mesh"] or c["n_mismatched"]
                   or c["files"] != c["want_files"]
                   or c["launches"][nk.GATED] == 0
                   or c["launches"][nk.PACK_CLS] == 0
                   or c["launches"][nk.GROUPED_CHUNK] == 0
                   or c["launches"][nk.CHUNK] != 0 or not c["k2g_batches"]
                   or c["k2g_batches"][0]["max_abs_err"] for c in cells)):
        raise AssertionError(f"mesh (c) failed: {res}")
    return dict(res, launches=cells[0]["launches"])


def mesh_rank_main(rank: int, world: int, port: int, backend: str,
                   device: str, frame_path: str, out_path: str) -> None:
    """One rank of (d), in a process of its own: the process group (over
    ``parallel/distributed.py`` for two ranks, directly for a world of
    one, which ``initialize`` leaves alone), a (1, 2) grid over the two
    devices of the world (``device`` each), one batch, the verdicts
    written to ``out_path``."""
    import datetime

    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from klogs_tpu_torch.filters.gpu import GpuEngineFilter
    from klogs_tpu_torch.ops import nfa_kernels as nk
    from klogs_tpu_torch.parallel import distributed
    from klogs_tpu_torch.parallel.mesh import MeshEngine

    if world > 1:
        distributed.initialize(f"127.0.0.1:{port}", world, rank,
                               backend=backend, timeout_s=180)
    else:
        torch.distributed.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", world_size=1,
            rank=0, timeout=datetime.timedelta(seconds=180))
    dev = torch.device(device)
    data = np.load(frame_path)
    payload, offsets = data["payload"].tobytes(), data["offsets"]
    f = GpuEngineFilter(PATTERNS, engine=MeshEngine(
        PATTERNS, devices=[dev] * (2 // world), grid=(1, 2)))
    f.fetch_framed(f.dispatch_framed(payload, offsets))  # warm-up
    nk.reset_launches()
    t0 = time.perf_counter()
    got = f.fetch_framed(f.dispatch_framed(payload, offsets))
    seconds = time.perf_counter() - t0
    with open(out_path, "w") as fh:
        json.dump({"rank": torch.distributed.get_rank(),
                   "world": torch.distributed.get_world_size(),
                   "backend": torch.distributed.get_backend(),
                   "local": [[di, gi] for di, gi, _ in f._engine._local],
                   "seconds": seconds, "launches": dict(nk.LAUNCHES),
                   "verdicts": np.packbits(got).tobytes().hex()}, fh)
    torch.distributed.destroy_process_group()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_ranks(repo: str, root: str, world: int, backend: str,
               device: str, frame_path: str) -> list:
    """The ``world`` rank processes of (d), started together and each
    awaited with a timeout; their JSON documents."""
    port = free_port()
    procs, outs = [], []
    for rank in range(world):
        out = os.path.join(root, f"{backend}-{world}-{rank}.json")
        outs.append(out)
        code = ("import chip_smoke; chip_smoke.mesh_rank_main("
                f"{rank}, {world}, {port}, {backend!r}, {device!r}, "
                f"{frame_path!r}, {out!r})")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=repo,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    fail = []
    for rank, p in enumerate(procs):
        try:
            text, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
        if p.returncode != 0:
            fail.append(f"rank {rank} of {world} ({backend}) rc "
                        f"{p.returncode}: {text.decode()[-1500:]}")
    if fail:
        raise AssertionError("\n".join(fail))
    docs = []
    for out in outs:
        with open(out) as fh:
            docs.append(json.load(fh))
    return docs


def mesh_dist(np, nk, GpuEngineFilter, frame0, dev, repo: str,
              card: str, n_lines: int = 8192) -> dict:
    """(d) Across processes: two ranks over gloo, both on cuda:0, a (1, 2)
    grid over the world's two devices; then a world of one over NCCL.
    Every rank's verdicts equal the single engine's."""
    payload, offsets = frame0
    offsets = offsets[:n_lines + 1]
    payload = payload[:int(offsets[-1])]
    single = GpuEngineFilter(PATTERNS, device=dev)
    want = single.fetch_framed(single.dispatch_framed(payload, offsets))
    with tempfile.TemporaryDirectory() as root:
        frame_path = os.path.join(root, "frame.npz")
        np.savez(frame_path, payload=np.frombuffer(payload, np.uint8),
                 offsets=offsets)
        docs = (mesh_ranks(repo, root, 2, "gloo", str(dev), frame_path)
                + mesh_ranks(repo, root, 1, "nccl", str(dev), frame_path))
    runs = []
    for doc in docs:
        got = np.unpackbits(np.frombuffer(bytes.fromhex(doc.pop("verdicts")),
                                          np.uint8))[:n_lines].astype(bool)
        runs.append(dict(doc, mismatches=int((got != want).sum())))
    res = dict(part="d", card=card, lines=n_lines, matched=int(want.sum()),
               runs=runs)
    emit({"phase": "mesh", **res})
    if (any(r["mismatches"] or r["launches"][nk.GROUPED] == 0 for r in runs)
            or [r["backend"] for r in runs] != ["gloo", "gloo", "nccl"]
            or [r["local"] for r in runs] != [[[0, 0]], [[0, 1]],
                                              [[0, 0], [0, 1]]]):
        raise AssertionError(f"mesh (d) failed: {res}")
    return res


def mesh_phase(torch, np, nk, bits, pack, app, cli, term, FakeCluster,
               GpuEngineFilter, frame_lines, synthetic_line, frame0, eng1024,
               dev, repo: str, card: str, want1024: dict) -> dict:
    """The mesh engine (``klogs_tpu_torch/parallel/``) on the one card
    listed several times: (a) grids at K = 32, (b) K = 1024 on a (2, 2)
    grid, (c) the CLI through the engine factory's mesh, (d) across
    processes. The launches of (a)'s (2, 2) grid (K1) and (c)'s
    cli_k1024 cell (K3, pack_classify_rows, K2g) go to the kernels line."""
    from klogs_tpu_torch.parallel import mesh as mesh_mod
    from klogs_tpu_torch.parallel.mesh import MeshEngine

    a = mesh_grids(torch, np, nk, pack, GpuEngineFilter, MeshEngine, frame0,
                   dev, card)
    b = mesh_k1024(torch, np, nk, bits, pack, GpuEngineFilter, MeshEngine,
                   frame_lines, synthetic_line, eng1024, dev, card)
    c = mesh_cli(torch, np, nk, app, cli, term, FakeCluster, frame_lines,
                 mesh_mod, MeshEngine, eng1024, dev, card, want1024)
    mesh_dist(np, nk, GpuEngineFilter, frame0, dev, repo, card)
    return {nk.GROUPED: a["launches"][nk.GROUPED],
            nk.GATED: c["launches"][nk.GATED],
            nk.PACK_CLS: c["launches"][nk.PACK_CLS],
            nk.GROUPED_CHUNK: c["launches"][nk.GROUPED_CHUNK],
            "k1": a["k1"], "k3": b["k3"], "pack": a["pack"],
            "k2g": [b for cell in c["cells"] for b in cell["k2g_batches"]]}


# ---- follow mode ---------------------------------------------------------


@contextlib.contextmanager
def recording_wrappers(nk, pack, names: list, sweep=None):
    """For the block, each wrapper named (``nfa_kernels`` ones,
    ``pack_classify_rows`` or ``pack_rows``, and ``sweep``'s
    ``sweep_group_bits``) records its
    calls: yields ``{name: {shapes: [count, [(args, kwargs), ...]]}}``,
    keeping the first 8 calls of each shape of its tensor arguments.
    The wrappers are restored after."""
    calls: dict = {n: {} for n in names}
    saved = {}
    for n in names:
        mod = {"pack_rows": pack, "pack_classify_rows": pack,
               "sweep_group_bits": sweep}.get(n, nk)
        real = getattr(mod, n)
        saved[n] = (mod, real)

        def hook(*a, _real=real, _n=n, **kw):
            key = tuple(tuple(x.shape) for x in a if hasattr(x, "shape"))
            entry = calls[_n].setdefault(key, [0, []])
            entry[0] += 1
            if len(entry[1]) < 8:
                entry[1].append((a, kw))
            return _real(*a, **kw)

        setattr(mod, n, hook)
    try:
        yield calls
    finally:
        for n, (mod, real) in saved.items():
            setattr(mod, n, real)


@contextlib.contextmanager
def captured_pipeline(built_at: "list | None" = None):
    """Yields a list that gets each FilterPipeline the app builds (its
    stats and service), make_pipeline restored after; ``built_at`` gets
    the perf_counter time each was built."""
    from klogs_tpu_torch.filters import sink as sink_mod

    made: list = []
    real = sink_mod.make_pipeline

    def hook(*a, **kw):
        made.append(real(*a, **kw))
        if built_at is not None:
            built_at.append(time.perf_counter())
        return made[-1]

    sink_mod.make_pipeline = hook
    try:
        yield made
    finally:
        sink_mod.make_pipeline = real


def pipeline_numbers(pipe) -> dict:
    """The --stats numbers of a run, from its FilterStats and service."""
    st, svc = pipe.stats, pipe.service
    return dict(
        lines_in=st.lines_in, lines_matched=st.lines_matched,
        sink_batches=st.batches, deadline_flushes=st.deadline_flushes,
        batch_p50_ms=st.percentile_latency_s(50) * 1e3,
        batch_p99_ms=st.percentile_latency_s(99) * 1e3,
        queue_p50_ms=st.percentile_queue_s(50) * 1e3,
        queue_p99_ms=st.percentile_queue_s(99) * 1e3,
        device_p50_ms=st.percentile_device_s(50) * 1e3,
        device_p99_ms=st.percentile_device_s(99) * 1e3,
        device_batches=svc.batches_dispatched,
        lines_per_device_batch=(st.lines_in / svc.batches_dispatched
                                if svc.batches_dispatched else 0.0))


def held_batches(torch, nk, pack, calls: dict, n_k1: int) -> dict:
    """Each kernel against its plain version on what the run gave it,
    timed: K1 on ``n_k1`` class batches (from its most frequent shapes
    down), K2 on a batch of its most frequent chunk shape,
    ``pack_classify_rows`` on a cut of its most frequent shape (beside
    the ``pack_rows`` + ``classify_chunk`` pair it replaced). ``launches``
    is the run's count of the batch's shape."""
    def top(name: str, n: int) -> list:
        out = []
        for count, seen in sorted(calls.get(name, {}).values(),
                                  key=lambda e: -e[0]):
            out += [(count, a, kw) for a, kw in seen]
        return out[:n]

    out = dict(k1_batches=[dict(launches=c, **k1_check(torch, nk, *a, 10))
                           for c, a, _ in top("match_cls_grouped", n_k1)])
    out["k2_batches"] = [
        dict(launches=c, **k2_check(torch, nk, *a[:4],
                                    kw.get("final", a[4] if len(a) > 4
                                           else True), 5))
        for c, a, kw in top("match_chunk_cls", 1)]
    out["pack_batches"] = [dict(launches=c, **pack_cls_check(
        torch, pack, *a, reps=10, **kw))
        for c, a, kw in top("pack_classify_rows", 1)]
    return out


def profiled_second(torch) -> "tuple":
    """(start, stop) of a torch.profiler window, and a reader of its
    device busy share: the CUDA time it recorded over its wall time."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    box: dict = {}

    def start():
        prof.start()
        box["t0"] = time.perf_counter()

    def stop():
        torch.cuda.synchronize()
        box["wall"] = time.perf_counter() - box["t0"]
        prof.stop()
        cuda = torch.autograd.DeviceType.CUDA
        ms = sum(e.self_device_time_total / 1e3 for e in prof.key_averages()
                 if e.device_type == cuda)
        box.update(device_ms=ms, busy=ms / (box["wall"] * 1e3))

    return start, stop, box


def follow_profile(app, cli, term, FakeCluster, argv, dev, n_pods: int,
                   lines_per_pod: int, interval: float,
                   seconds: float = 6.0) -> dict:
    """The follow run again, ``seconds`` long on a fresh cluster, under
    cProfile: what holds the event loop (the host's top functions)."""
    import cProfile

    fc = FakeCluster.synthetic(n_pods=n_pods, n_containers=1,
                               lines_per_container=lines_per_pod,
                               clock=lambda: CLOCK, follow_interval_s=interval)

    async def drive(out_dir: str) -> int:
        stop = asyncio.Event()
        asyncio.get_running_loop().call_later(seconds, stop.set)
        return await app.run_async(cli.parse_args(argv(out_dir)), backend=fc,
                                   stop=stop, device=dev)

    with tempfile.TemporaryDirectory() as out_dir:
        term.set_ui_stream(io.StringIO())
        cp = cProfile.Profile()
        try:
            cp.enable()
            asyncio.run(drive(out_dir))
            cp.disable()
        finally:
            term.set_ui_stream(None)
    lines = sum(c.next_seq for p in fc.namespaces["default"].values()
                for c in p.containers.values()) - n_pods * lines_per_pod
    return dict(seconds=seconds, live_lines=lines, host_top=host_top(cp, 14))


def follow_phase(torch, np, nk, pack, app, cli, term, FakeCluster,
                 synthetic_line, dev, card: str = "", n_pods=1000, lines_per_pod=50,
                 interval=0.01, seconds=12.0, n_long=8, n_tailed=8) -> dict:
    """BASELINE config 4 through ``app.run_async``: ``-a -f --match`` x32
    ``--stats`` over 1000 fixed-clock FakeCluster streams, each offering
    a line every 10 ms, stopped after ``seconds``. Every file must equal
    the oracle's selection of exactly the lines its stream sent
    (regenerated from ``next_seq``). A task tails ``n_tailed`` streams'
    files for each matching line's emission-to-file latency; one second
    is profiled for the device's busy share."""
    rng = np.random.default_rng(SEED + 8)
    fc = FakeCluster.synthetic(n_pods=n_pods, n_containers=1,
                               lines_per_container=lines_per_pod,
                               clock=lambda: CLOCK, follow_interval_s=interval)
    pods = fc.namespaces["default"]
    for j, name in enumerate(sorted(pods)[:n_long]):  # K2's lines
        n = int(rng.integers(5 * 1024, 180 * 1024))
        body = bytearray(rng.integers(32, 127, size=n, dtype=np.uint8))
        if j % 2:
            body[n // 2:n // 2 + 8] = b"code=504"
        pods[name].containers["c0"].lines.insert(
            10 + j, (CLOCK - 3000, bytes(body) + b"\n"))
    ora = oracle_fn()
    tailed = sorted(pods)[n_long:n_long + n_tailed]
    latencies: list = []
    prof_start, prof_stop, prof = profiled_second(torch)

    async def tail(name: str, out_dir: str, t_end: float) -> None:
        """Each matching line's time from its emission (next_seq passing
        it) to its appearance in the file, polled every 2 ms."""
        c = pods[name].containers["c0"]
        path = os.path.join(out_dir, f"{name}__c0.log")
        seq, waiting, buf = c.next_seq, {}, b""
        with open(path, "rb") as f:
            while time.perf_counter() < t_end or waiting:
                now = time.perf_counter()
                while c.next_seq > seq and now < t_end:
                    ln = synthetic_line(name, "c0", seq, CLOCK)
                    if ora(ln.rstrip(b"\n")):
                        waiting[ln] = now
                    seq += 1
                buf += f.read()
                *done, buf = buf.split(b"\n")
                for ln in done:
                    t_emit = waiting.pop(ln + b"\n", None)
                    if t_emit is not None:
                        latencies.append(now - t_emit)
                if time.perf_counter() > t_end + 5:
                    break
                await asyncio.sleep(0.002)

    async def drive(out_dir: str) -> int:
        opts = cli.parse_args(argv(out_dir))
        stop = asyncio.Event()

        async def conductor():
            t0 = time.perf_counter()
            while not all(os.path.exists(os.path.join(
                    out_dir, f"{n}__c0.log")) for n in tailed):
                await asyncio.sleep(0.01)
            tails = [asyncio.create_task(tail(n, out_dir, t0 + seconds - 5))
                     for n in tailed]
            await asyncio.sleep(max(0.0, t0 + seconds - 3 - time.perf_counter()))
            prof_start()
            await asyncio.sleep(1.0)
            prof_stop()
            await asyncio.gather(*tails)
            await asyncio.sleep(max(0.0, t0 + seconds - time.perf_counter()))
            stop.set()

        task = asyncio.create_task(conductor())
        try:
            return await app.run_async(opts, backend=fc, stop=stop, device=dev)
        finally:
            await task

    def argv(out_dir):
        a = ["-n", "default", "-a", "-f", "--stats", "-p", out_dir]
        for p in PATTERNS:
            a += ["--match", p]
        return a

    hist = {n: len(pods[n].containers["c0"].lines) for n in pods}
    first_seq = {n: pods[n].containers["c0"].next_seq for n in pods}
    with tempfile.TemporaryDirectory() as out_dir, \
            captured_pipeline() as made, \
            recording_wrappers(nk, pack, ["match_cls_grouped",
                                          "match_chunk_cls",
                                          "pack_classify_rows"]) as calls:
        term.set_ui_stream(io.StringIO())
        try:
            torch.cuda.synchronize()
            nk.reset_launches()
            t0 = time.perf_counter()
            rc = asyncio.run(drive(out_dir))
            wall = time.perf_counter() - t0
            launches = dict(nk.LAUNCHES)
        finally:
            term.set_ui_stream(None)
        sent = {n: [ln for _, ln in pods[n].containers["c0"].lines]
                + [synthetic_line(n, "c0", s, CLOCK) for s in
                   range(first_seq[n], pods[n].containers["c0"].next_seq)]
                for n in sorted(pods)}
        flat = [ln.rstrip(b"\n") for n in sorted(pods) for ln in sent[n]]
        verdicts = oracle_verdicts(PATTERNS, flat)
        bad, lost, doubled, at, kept = [], 0, 0, 0, 0
        for n in sorted(pods):
            want = [ln for ln, v in zip(sent[n], verdicts[at:at + len(sent[n])])
                    if v]
            at += len(sent[n])
            kept += len(want)
            with open(os.path.join(out_dir, f"{n}__c0.log"), "rb") as f:
                got = f.read().splitlines(keepends=True)
            if got != want:
                bad.append(n)
                lost += max(0, len(want) - len(got))
                doubled += max(0, len(got) - len(want))
        files = len(os.listdir(out_dir))
    n_sent = sum(len(v) for v in sent.values())
    offered = n_pods / interval
    lat = np.asarray(latencies) * 1e3
    res = dict(rc=rc, card=card, pods=n_pods, files=files, seconds=wall,
               lines_sent=n_sent, kept_lines=kept,
               offered_lines_per_s=offered,
               sustained_lines_per_s=(n_sent - sum(hist.values())) / seconds,
               mismatched_files=len(bad), first_mismatches=bad[:4],
               lost_lines=lost, doubled_lines=doubled,
               match_to_file_p50_ms=float(np.percentile(lat, 50)) if len(lat)
               else None,
               match_to_file_p99_ms=float(np.percentile(lat, 99)) if len(lat)
               else None,
               match_to_file_samples=len(lat), match_to_file_poll_ms=2.0,
               device_busy=prof.get("busy"), profiled_wall_s=prof.get("wall"),
               profiled_device_ms=prof.get("device_ms"),
               launches=launches, **pipeline_numbers(made[0]))
    res.update(held_batches(torch, nk, pack, calls, 8))
    res["profile"] = follow_profile(app, cli, term, FakeCluster, argv, dev,
                                    n_pods, lines_per_pod, interval)
    emit({"phase": "follow", **res})
    held = res["k1_batches"] + res["k2_batches"] + res["pack_batches"]
    if (rc != 0 or bad or files != n_pods or not kept or not len(lat)
            or launches[nk.GROUPED] == 0 or launches[nk.CHUNK] == 0
            or launches[nk.PACK_CLS] == 0 or len(res["k1_batches"]) < 8
            or not res["k2_batches"] or not res["pack_batches"]
            or any(b.get("max_abs_err", 0) or b.get("mismatches", 0)
                   for b in held)):
        raise AssertionError(f"follow phase failed: {res}")
    return res


# ---- the kube backend in follow mode ------------------------------------

KUBE_TOKEN = "chip-smoke-token"


def apiserver_main(port_q, record_dir: str, n_pods: int, backlog: int,
                   interval: float, live_for: float, drop: list,
                   drop_after: float, done) -> None:
    """A fake Kubernetes apiserver on aiohttp (run in a process of its
    own): namespace ``default`` with ``n_pods`` Ready pods of one
    container ``c0``. A log request sends ``backlog`` lines (or, with
    ``sinceSeconds``, the live lines of that window) in 4 KiB pieces,
    then with ``follow=true`` a new line every ``interval`` until
    ``live_for`` s after it starts serving, and nothing after; the pods
    in ``drop``
    close their first connection ``drop_after`` s into its live lines.
    Every request (path, query, Authorization) and every byte sent on
    each pod's connections is written under ``record_dir`` once
    ``done`` is set."""
    from aiohttp import web

    from klogs_tpu_torch.cluster.fake import synthetic_line

    names = [f"pod-{i:04d}" for i in range(n_pods)]
    requests: list = []
    sent = {n: bytearray() for n in names}
    live: dict = {n: [] for n in names}
    dropped: set = set()
    t_start = time.time()
    live_until = t_start + 3600.0  # set when the server is up

    def stamp(t: float, ln: bytes) -> bytes:
        frac = int((t % 1) * 1e9)
        return (time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(t))
                + f".{frac:09d}Z ").encode() + ln

    @web.middleware
    async def record(request, handler):
        requests.append([request.path, dict(request.query),
                         request.headers.get("Authorization")])
        if request.headers.get("Authorization") != f"Bearer {KUBE_TOKEN}":
            return web.Response(status=401, text="unauthorized")
        return await handler(request)

    async def namespace(request):
        if request.match_info["ns"] != "default":
            return web.Response(status=404)
        return web.json_response({"metadata": {"name": "default"}})

    async def namespaces(request):
        return web.json_response({"items": [{"metadata": {"name": "default"}}]})

    async def pods(request):
        return web.json_response({"items": [{
            "metadata": {"name": n, "labels": {"app": "smoke"}},
            "spec": {"containers": [{"name": "c0"}]},
            "status": {"conditions": [{"type": "Ready", "status": "True"}]},
        } for n in names]})

    async def log(request):
        pod, q = request.match_info["pod"], request.query
        ts = q.get("timestamps") == "true"
        if "sinceSeconds" in q:
            cut = time.time() - int(q["sinceSeconds"])
            lines = [(t, ln) for t, ln in live[pod] if t >= cut]
        else:
            lines = [(t_start - (backlog - i) * 0.01,
                      synthetic_line(pod, "c0", i, t_start - backlog + i))
                     for i in range(backlog)]
        data = b"".join(stamp(t, ln) if ts else ln for t, ln in lines)
        resp = web.StreamResponse()
        await resp.prepare(request)
        for i in range(0, len(data), 4096):
            await resp.write(data[i:i + 4096])
            sent[pod] += data[i:i + 4096]
        if q.get("follow") != "true":
            await resp.write_eof()
            return resp
        opened = time.time()
        while time.time() < live_until:
            await asyncio.sleep(interval)
            t = time.time()
            ln = synthetic_line(pod, "c0", backlog + len(live[pod]), t)
            live[pod].append((t, ln))
            piece = stamp(t, ln) if ts else ln
            await resp.write(piece)
            sent[pod] += piece
            if pod in drop and pod not in dropped and t - opened >= drop_after:
                dropped.add(pod)
                request.transport.close()  # flushes what was written
                return resp
        while request.transport is not None \
                and not request.transport.is_closing():
            await asyncio.sleep(0.05)
        return resp

    async def serve():
        app = web.Application(middlewares=[record])
        app.router.add_get("/api/v1/namespaces", namespaces)
        app.router.add_get("/api/v1/namespaces/{ns}", namespace)
        app.router.add_get("/api/v1/namespaces/{ns}/pods", pods)
        app.router.add_get("/api/v1/namespaces/{ns}/pods/{pod}/log", log)
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        nonlocal live_until
        live_until = time.time() + live_for
        port_q.put(site._server.sockets[0].getsockname()[1])
        await asyncio.get_running_loop().run_in_executor(None, done.wait)
        await runner.cleanup()

    asyncio.run(serve())
    for n in names:
        with open(os.path.join(record_dir, n), "wb") as f:
            f.write(bytes(sent[n]))
    with open(os.path.join(record_dir, "requests.json"), "w") as f:
        json.dump(requests, f)


def kube_follow_phase(torch, np, nk, pack, app, cli, term, dev,
                      card: str = "", n_pods=64,
                      backlog=4000, interval=0.01, seconds=10.0, n_drop=8,
                      drop_after=1.0) -> dict:
    """``app.run_async`` on the default ``--cluster kube`` with ``-a -f
    --timestamps --kubeconfig`` and ``--match`` x32 against the fake
    apiserver (a process of its own), stopped after ``seconds``; the
    server stops sending 1.5 s before, so every byte it sent is read.
    Each file must equal the oracle over the bytes the server sent on
    that pod's connections, in order; each dropped stream's reconnect
    must ask for ``follow`` and ``sinceSeconds`` and no ``tailLines``;
    every request must carry the token."""
    import yaml

    ctx = multiprocessing.get_context("spawn")
    port_q, done = ctx.Queue(), ctx.Event()
    drop = [f"pod-{i:04d}" for i in range(0, n_pods, n_pods // n_drop)]
    with tempfile.TemporaryDirectory() as tmp:
        rec, out_dir = os.path.join(tmp, "sent"), os.path.join(tmp, "out")
        os.makedirs(rec)
        server = ctx.Process(target=apiserver_main, args=(
            port_q, rec, n_pods, backlog, interval, seconds - 1.5, drop,
            drop_after, done))
        server.start()
        try:
            port = port_q.get(timeout=60)
            t_start = time.time()
            kubeconfig = os.path.join(tmp, "kubeconfig")
            with open(kubeconfig, "w") as f:
                yaml.safe_dump({
                    "current-context": "smoke",
                    "contexts": [{"name": "smoke", "context": {
                        "cluster": "fake", "user": "u",
                        "namespace": "default"}}],
                    "clusters": [{"name": "fake", "cluster": {
                        "server": f"http://127.0.0.1:{port}"}}],
                    "users": [{"name": "u", "user": {"token": KUBE_TOKEN}}],
                }, f)
            argv = ["-a", "-f", "--timestamps", "--kubeconfig", kubeconfig,
                    "-p", out_dir]
            for p in PATTERNS:
                argv += ["--match", p]

            async def drive() -> int:
                stop = asyncio.Event()
                asyncio.get_running_loop().call_later(
                    max(0.0, t_start + seconds - time.time()), stop.set)
                return await app.run_async(cli.parse_args(argv), stop=stop,
                                           device=dev)

            with captured_pipeline() as made, recording_wrappers(
                    nk, pack,
                    ["match_cls_grouped", "pack_classify_rows"]) as calls:
                term.set_ui_stream(io.StringIO())
                try:
                    torch.cuda.synchronize()
                    nk.reset_launches()
                    t0 = time.perf_counter()
                    rc = asyncio.run(drive())
                    wall = time.perf_counter() - t0
                    launches = dict(nk.LAUNCHES)
                finally:
                    term.set_ui_stream(None)
        finally:
            done.set()
            server.join(timeout=60)
            if server.is_alive():
                server.kill()
                server.join()
        with open(os.path.join(rec, "requests.json")) as f:
            requests = json.load(f)
        names = sorted(n for n in os.listdir(rec) if n.startswith("pod-"))
        sent = {}
        for n in names:
            with open(os.path.join(rec, n), "rb") as f:
                sent[n] = f.read().splitlines(keepends=True)
        flat = [ln.rstrip(b"\n") for n in names for ln in sent[n]]
        verdicts = oracle_verdicts(PATTERNS, flat)
        bad, at, kept = [], 0, 0
        for n in names:
            want = b"".join(ln for ln, v in zip(sent[n],
                                                verdicts[at:at + len(sent[n])])
                            if v)
            at += len(sent[n])
            kept += want.count(b"\n")
            with open(os.path.join(out_dir, f"{n}__c0.log"), "rb") as f:
                if f.read() != want:
                    bad.append(n)
        files = len(os.listdir(out_dir))
    logs = [(p.split("/")[-2], q) for p, q, _ in requests
            if p.endswith("/log")]
    per_pod: dict = {}
    for pod, q in logs:
        per_pod.setdefault(pod, []).append(q)
    reconnects = [qs[1:] for pod, qs in per_pod.items()]
    bad_reconnects = [q for qs in reconnects for q in qs
                      if q.get("follow") != "true" or "sinceSeconds" not in q
                      or "tailLines" in q or q.get("timestamps") != "true"]
    untokened = sum(auth != f"Bearer {KUBE_TOKEN}" for _, _, auth in requests)
    n_lines = sum(len(v) for v in sent.values())
    res = dict(rc=rc, card=card, pods=n_pods, files=files, seconds=wall,
               lines_sent=n_lines, kept_lines=kept,
               lines_per_s=n_lines / wall, mismatched_files=len(bad),
               first_mismatches=bad[:4], requests=len(requests),
               log_requests=len(logs),
               reconnected_pods=sorted(p for p, qs in per_pod.items()
                                       if len(qs) > 1),
               bad_reconnect_queries=bad_reconnects[:4],
               requests_without_token=untokened, launches=launches,
               **pipeline_numbers(made[0]))
    res.update(held_batches(torch, nk, pack, calls, 2))
    emit({"phase": "kube_follow", **res})
    held = res["k1_batches"] + res["pack_batches"]
    if (rc != 0 or bad or files != n_pods or not kept or untokened
            or bad_reconnects or res["reconnected_pods"] != drop
            or len(logs) != n_pods + n_drop
            or launches[nk.GROUPED] == 0 or launches[nk.PACK_CLS] == 0
            or len(res["k1_batches"]) < 2 or not res["pack_batches"]
            or any(b.get("max_abs_err", 0) or b.get("mismatches", 0)
                   for b in held)):
        raise AssertionError(f"kube_follow phase failed: {res}")
    return res


# ---- the log sources: --backfill, --source replay: and socket: ----------


def backfill_pool(synthetic_line, rng, n: int) -> list:
    """``n`` distinct ~126-byte log lines (FakeCluster's), 1% with a
    needle: half of the 32 patterns' (``NEEDLES``), half a minted
    family's (the 1024 set's, or a near miss past it)."""
    pool = []
    for j in range(n):
        ln = synthetic_line(f"pod-{j % 509:04d}", f"c{j % 3}",
                            j * 7919 % 1000003, CLOCK - j % 86400)
        if j % 200 == 3:
            ln = ln[:40] + NEEDLES[j // 200 % len(NEEDLES)] + b" " + ln[40:]
        elif j % 200 == 103:
            ln = ln[:40] + minted_needle(int(rng.integers(0, 1200))) + b" " \
                + ln[40:]
        pool.append(ln)
    return pool


def backfill_corpus(np, synthetic_line, root: str, n_lines: int,
                    n_sets: int = 8, pool_n: int = 16384,
                    long_kib=((4, 64), (128, 192))) -> dict:
    """``tools/bench_backfill.py``'s deployment: ``n_sets`` rotated sets,
    each ``app-NN.log.2.gz``, ``.1.gz`` (gzip level 1) and a plain live
    ``app-NN.log``, under ``root/gz``; the same sets uncompressed under
    ``root/plain``; each set's whole stream as one file under
    ``root/replay``. Lines come from a seeded pool of ``pool_n`` distinct
    bodies (larger than gzip's 32 KiB window), and each set holds two
    lines of 4-64 and 128-192 KiB (K2, and the path over 128 KiB).
    Returns the pool, the long lines and each set's lines in order."""
    import gzip

    rng = np.random.default_rng(SEED + 20)
    pool = backfill_pool(synthetic_line, rng, pool_n)
    idx = rng.integers(0, pool_n, size=n_lines)
    per = n_lines // n_sets
    sets, longs = [], []
    for s in range(n_sets):
        lines = [pool[i] for i in idx[s * per:(s + 1) * per].tolist()]
        for j, (lo, hi) in enumerate(long_kib):
            n = int(rng.integers(lo << 10, hi << 10))
            body = bytearray(rng.integers(32, 127, size=n, dtype=np.uint8))
            nd = (NEEDLES[s % len(NEEDLES)] if j == 0
                  else minted_needle(int(rng.integers(0, 992))))
            if (s + j) % 2:
                body[n // 2:n // 2 + len(nd)] = nd
            at = len(lines) // 2 if j == 0 else 5 * len(lines) // 6
            lines.insert(at, bytes(body) + b"\n")
            longs.append(lines[at])
        sets.append(lines)
    for sub in ("gz", "plain", "replay"):
        os.makedirs(os.path.join(root, sub))

    def write(s: int) -> None:
        lines = sets[s]
        third = len(lines) // 3
        gens = [b"".join(lines[:third]), b"".join(lines[third:2 * third]),
                b"".join(lines[2 * third:])]
        name = f"app-{s:02d}.log"
        for gen, data in zip((2, 1), gens[:2]):
            with open(os.path.join(root, "gz", f"{name}.{gen}.gz"), "wb") as f:
                f.write(gzip.compress(data, 1))
            with open(os.path.join(root, "plain", f"{name}.{gen}"), "wb") as f:
                f.write(data)
        for sub in ("gz", "plain"):
            with open(os.path.join(root, sub, name), "wb") as f:
                f.write(gens[2])
        with open(os.path.join(root, "replay", name), "wb") as f:
            f.writelines(gens)

    with concurrent.futures.ThreadPoolExecutor(n_sets) as ex:
        list(ex.map(write, range(n_sets)))
    return dict(pool=pool, longs=longs, sets=sets)


def expected_files(corpus: dict, verdict: dict, names: list) -> dict:
    """Each set's output file: its lines that ``verdict`` keeps, in
    order (oldest generation first)."""
    return {name: b"".join(ln for ln in lines if verdict[ln])
            for name, lines in zip(names, corpus["sets"])}


def corpus_verdicts(corpus: dict, patterns: list) -> dict:
    """The ``re`` oracle's verdict of every distinct line, computed once
    a pool body (and once a long line, a line a task)."""
    pool, longs = corpus["pool"], corpus["longs"]
    v = oracle_verdicts(patterns, [b.rstrip(b"\n") for b in pool])
    vl = oracle_verdicts(patterns, [b.rstrip(b"\n") for b in longs], step=1)
    return dict(zip(pool + longs, v + vl))


def source_capacity(paths: list) -> dict:
    """The archive source alone: every set drained through its
    ArchiveStream at once (the lines counted, nothing else done)."""
    from klogs_tpu_torch.cluster.types import LogOptions
    from klogs_tpu_torch.sources.archive import ArchiveSource

    async def drain() -> tuple:
        src = ArchiveSource(paths)
        refs = await src.discover()

        async def one(ref) -> int:
            n = 0
            async for slab in await src.open_stream(ref, LogOptions()):
                n += slab.count(b"\n")
            return n

        t0 = time.perf_counter()
        counts = await asyncio.gather(*(one(r) for r in refs))
        seconds = time.perf_counter() - t0
        await src.close()
        return sum(counts), seconds

    lines, seconds = asyncio.run(drain())
    return dict(lines=lines, seconds=seconds, lines_per_s=lines / seconds)


def held_gated(torch, bits, nk, calls: dict) -> list:
    """K3 against its plain version on the run's most frequent gated
    batch shape."""
    out = []
    for count, seen in sorted(calls.get("match_cls_grouped_gated", {})
                              .values(), key=lambda e: -e[0])[:1]:
        a, kw = seen[0]
        out.append(dict(launches=count,
                        **k3_check(torch, bits, nk, *a[:5], 10)))
    return out


def backfill_run(torch, nk, pack, bits, app, cli, term, dev, label: str,
                 paths: list, patterns: list, want: dict,
                 n_lines: int, profile_paths: list) -> dict:
    """``app.run_async`` with ``--backfill PATHS --match … --stats -p``
    on the card: the counts zeroed just before and read just after,
    every output file held against ``want``, the kernels held on the
    run's own batches; then a backfill of ``profile_paths`` under
    cProfile with a torch.profiler window of 1 s after the engine is
    built (the device's busy share)."""
    argv = ["--backfill", *paths, "--stats", "-p", ""]
    for p in patterns:
        argv += ["--match", p]
    names = ["match_cls_grouped", "match_chunk_cls", "pack_classify_rows",
             "match_cls_grouped_gated", "match_chunk_cls_grouped"]
    built_at: list = []
    with tempfile.TemporaryDirectory() as out_dir, \
            captured_pipeline(built_at) as made, \
            recording_wrappers(nk, pack, names) as calls:
        argv[len(paths) + 3] = out_dir
        ui = io.StringIO()
        term.set_ui_stream(ui)
        try:
            torch.cuda.synchronize()
            nk.reset_launches()
            t0 = time.perf_counter()
            rc = asyncio.run(app.run_async(cli.parse_args(argv), device=dev))
            t1 = time.perf_counter()
            launches = dict(nk.LAUNCHES)
        finally:
            term.set_ui_stream(None)
        got = {f: open(os.path.join(out_dir, f), "rb").read()
               for f in os.listdir(out_dir)}
    bad = sorted(f for f in want if got.get(f) != want[f])
    kept = sum(b.count(b"\n") for b in want.values())
    summary = [ln.strip() for ln in ui.getvalue().splitlines()
               if "Backfill complete" in ln]
    nums = pipeline_numbers(made[0])
    res = dict(label=label, rc=rc, files=len(got), mismatched_files=bad,
               kept_lines=kept, wall_s=t1 - t0, engine_build_s=built_at[0] - t0,
               lines_per_s=nums["lines_in"] / (t1 - built_at[0]),
               lines_per_s_wall=nums["lines_in"] / (t1 - t0),
               summary=summary[0] if summary else None,
               launches=launches, **nums)
    res.update(held_batches(torch, nk, pack, calls, 4))
    res["k3_batches"] = held_gated(torch, bits, nk, calls)
    res["k2g_batches"] = held_k2g(torch, nk, calls)
    del calls
    argv = ["--backfill", *profile_paths] + argv[len(paths) + 1:]
    res["profile"] = backfill_profile(torch, app, cli, term, dev, argv,
                                      len(profile_paths) + 3)
    res["counts_ok"] = (nums["lines_in"] == n_lines
                        and nums["lines_matched"] == kept)
    return res


def backfill_profile(torch, app, cli, term, dev, argv: list,
                     out_at: int) -> dict:
    """A backfill under cProfile (the top functions; since Python 3.12
    cProfile sees every thread, the fetch pool's and the producers'
    waits too), with a torch.profiler window of 1 s starting 0.3 s
    after the engine is built: the device's busy share there."""
    import cProfile

    built_at: list = []
    prof_start, prof_stop, prof = profiled_second(torch)

    async def drive(opts) -> int:
        async def window():
            while not built_at:
                await asyncio.sleep(0.005)
            await asyncio.sleep(0.3)
            prof_start()
            await asyncio.sleep(1.0)
            prof_stop()

        task = asyncio.create_task(window())
        try:
            return await app.run_async(opts, device=dev)
        finally:
            await task

    with tempfile.TemporaryDirectory() as out_dir, \
            captured_pipeline(built_at):
        argv = list(argv)
        argv[out_at] = out_dir
        term.set_ui_stream(io.StringIO())
        cp = cProfile.Profile()
        try:
            t0 = time.perf_counter()
            cp.enable()
            rc = asyncio.run(drive(cli.parse_args(argv)))
            cp.disable()
            wall = time.perf_counter() - t0
        finally:
            term.set_ui_stream(None)
    return dict(rc=rc, wall_s=wall, run_after_window_s=wall - (
        built_at[0] - t0) - 1.3, device_busy=prof.get("busy"),
        profiled_wall_s=prof.get("wall"),
        profiled_device_ms=prof.get("device_ms"), host_top=host_top(cp, 12))


def backfill_phase(torch, np, nk, pack, bits, app, cli, term,
                   synthetic_line, dev, root: str, card: str = "",
                   n_lines=4_000_000) -> dict:
    """The archive backfill (``tools/bench_backfill.py``'s deployment:
    8 rotated sets, gzip level 1, 1 MiB slabs) through ``app.run_async
    --backfill DIR --match … --stats -p``: (a) K = 32 over the gzip
    sets, (b) K = 32 over the same sets uncompressed, (c) K = 1024 over
    the gzip sets (the gated path). Every file must equal the ``re``
    oracle's selection in rotated order; K1, K2, pack_classify_rows and at K =
    1024 K3 are held against their plain versions on each run's own
    batches. Beside each, the source alone: the sets drained through
    ArchiveStream."""
    from klogs_tpu_torch.sources.base import safe_group_name
    from klogs_tpu_torch.utils.naming import log_file_name

    t0 = time.perf_counter()
    corpus = backfill_corpus(np, synthetic_line, root, n_lines)
    corpus_s = time.perf_counter() - t0
    k1024 = make_patterns(1024)
    t0 = time.perf_counter()
    v32 = corpus_verdicts(corpus, PATTERNS)
    v1024 = corpus_verdicts(corpus, k1024)
    oracle_s = time.perf_counter() - t0
    n_sets = len(corpus["sets"])

    def names(sub: str) -> list:
        return [log_file_name(safe_group_name(os.path.join(
            root, sub, f"app-{s:02d}.log")), "archive")
            for s in range(n_sets)]

    gz, plain = os.path.join(root, "gz"), os.path.join(root, "plain")
    total = sum(len(lines) for lines in corpus["sets"])
    # The profiled reruns read each set's oldest generation (a third of
    # the lines, no long line); (c)'s, at K = 1024, the first half of
    # the sets' only.
    oldest_gz = [os.path.join(gz, "app-*.log.2.gz")]
    want_c = expected_files(corpus, v1024, names("gz"))
    runs = dict(
        a=backfill_run(torch, nk, pack, bits, app, cli, term, dev,
                       "k32_gzip", [gz], PATTERNS,
                       expected_files(corpus, v32, names("gz")), total,
                       oldest_gz),
        b=backfill_run(torch, nk, pack, bits, app, cli, term, dev,
                       "k32_plain", [plain], PATTERNS,
                       expected_files(corpus, v32, names("plain")), total,
                       [os.path.join(plain, "app-*.log.2")]),
        c=backfill_run(torch, nk, pack, bits, app, cli, term, dev,
                       "k1024_gzip", [gz], k1024, want_c, total,
                       [os.path.join(gz, "app-%02d.log.2.gz" % s)
                        for s in range(n_sets // 2)]))
    capacity = dict(gzip=source_capacity([gz]),
                    plain=source_capacity([plain]))
    res = dict(card=card, lines=total, sets=n_sets,
               corpus_bytes=sum(len(b) for lines in corpus["sets"]
                                for b in lines),
               gz_bytes=sum(os.path.getsize(os.path.join(gz, f))
                            for f in os.listdir(gz)),
               corpus_s=corpus_s, oracle_s=oracle_s,
               switch_interval_s=sys.getswitchinterval(),
               source_capacity=capacity, runs=runs)
    emit({"phase": "backfill", **res})
    for key, r in runs.items():
        # K = 1024: the gate and K3 on short lines, K2g (never K2) on
        # long ones.
        k1024_run = key == "c"
        need = ([nk.GATED, nk.PAIRS, nk.GROUPED_CHUNK] if k1024_run
                else [nk.GROUPED, nk.CHUNK])
        held = r["k1_batches"] + r["k2_batches"] + r["pack_batches"] \
            + r["k3_batches"] + r["k2g_batches"]
        if (r["rc"] != 0 or r["mismatched_files"] or r["files"] != n_sets
                or not r["kept_lines"] or not r["counts_ok"]
                or r["summary"] is None or r["profile"]["rc"] != 0
                or any(r["launches"][k] == 0 for k in need + [nk.PACK_CLS])
                or (k1024_run and r["launches"][nk.CHUNK] != 0)
                or not r["k1_batches" if not k1024_run else "k3_batches"]
                or not r["k2_batches" if not k1024_run else "k2g_batches"]
                or not r["pack_batches"]
                or any(b.get("max_abs_err", 0) or b.get("mismatches", 0)
                       or b.get("pairs_mismatches", 0) for b in held)):
            raise AssertionError(f"backfill phase failed: run {key}: {r}")
    res["corpus"] = corpus
    res["want_plain_names"] = names("plain")
    res["v32"] = v32
    return res


def socket_peer_main(port: int, payload: bytes) -> None:
    """A peer of the socket phase, in a process of its own: connect,
    send ``payload``, hang up."""
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        s.sendall(payload)


@contextlib.contextmanager
def captured_source():
    """Yields a list that gets each Source the app builds, make_source
    restored after."""
    from klogs_tpu_torch import sources

    made: list = []
    real = sources.make_source

    def hook(opts):
        made.append(real(opts))
        return made[-1]

    sources.make_source = hook
    try:
        yield made
    finally:
        sources.make_source = real


async def wait_files(out_dir: str, want: dict, limit: float) -> bool:
    """Whether every file in ``want`` holds its bytes within ``limit``
    seconds (polled every 50 ms)."""
    end = time.perf_counter() + limit
    while time.perf_counter() < end:
        got = {}
        for f in os.listdir(out_dir):
            with open(os.path.join(out_dir, f), "rb") as fh:
                got[f] = fh.read()
        if sorted(got.values()) == sorted(want.values()):
            return True
        await asyncio.sleep(0.05)
    return False


def sources_phase(torch, np, nk, app, cli, term, dev, root: str, bf: dict,
                  card: str = "", n_peers=8, peer_lines=50_000,
                  rot_lines=200_000) -> dict:
    """``--source replay:`` over the backfill's sets, each set's stream
    as one file, without ``-f``: its files must equal backfill run (b)'s.
    Then ``-f --source socket:127.0.0.1:0`` with ``n_peers`` peer
    processes each sending ``peer_lines`` lines, stopped through
    ``stop`` once every peer's file holds its selection: no line lost or
    doubled. Then ``-f --source replay:FILE`` with one rename rotation
    mid-run (a straggler written first)."""
    from klogs_tpu_torch.sources.base import safe_group_name
    from klogs_tpu_torch.utils.naming import log_file_name

    corpus, v32 = bf["corpus"], bf["v32"]
    n_sets = len(corpus["sets"])
    matches = [a for p in PATTERNS for a in ("--match", p)]
    res: dict = dict(card=card)

    # (1) replay without -f: the sets' streams as files, = backfill (b).
    rdir = os.path.join(root, "replay")
    want = {log_file_name(safe_group_name(os.path.join(
        rdir, f"app-{s:02d}.log")), "log"): body
        for s, body in enumerate(expected_files(
            corpus, v32, bf["want_plain_names"]).values())}
    with tempfile.TemporaryDirectory() as out_dir, \
            captured_pipeline() as made:
        argv = ["--source", f"replay:{rdir}", "--stats", "-p", out_dir,
                *matches]
        term.set_ui_stream(io.StringIO())
        try:
            nk.reset_launches()
            t0 = time.perf_counter()
            rc = asyncio.run(app.run_async(cli.parse_args(argv), device=dev))
            seconds = time.perf_counter() - t0
            launches = dict(nk.LAUNCHES)
        finally:
            term.set_ui_stream(None)
        got = {f: open(os.path.join(out_dir, f), "rb").read()
               for f in os.listdir(out_dir)}
    res["replay"] = dict(rc=rc, files=len(got), seconds=seconds,
                         mismatched_files=sorted(f for f in want
                                                 if got.get(f) != want[f]),
                         lines_per_s=made[0].stats.lines_in / seconds,
                         launches=launches, **pipeline_numbers(made[0]))

    # (2) -f --source socket:127.0.0.1:0, n_peers peer processes.
    rng = np.random.default_rng(SEED + 21)
    pool = corpus["pool"]
    peers = [[b"peer=%d n=%06d " % (k, i) + pool[j] for i, j in enumerate(
        rng.integers(0, len(pool), size=peer_lines).tolist())]
        for k in range(n_peers)]
    flat = [ln.rstrip(b"\n") for lines in peers for ln in lines]
    verdicts = oracle_verdicts(PATTERNS, flat)
    want_peers = {}
    for k, lines in enumerate(peers):
        v = verdicts[k * peer_lines:(k + 1) * peer_lines]
        want_peers[k] = b"".join(ln for ln, keep in zip(lines, v) if keep)
    ctx = multiprocessing.get_context("spawn")
    procs: list = []
    box: dict = {}

    async def drive_socket(out_dir: str, made_src: list) -> int:
        stop = asyncio.Event()

        async def conductor():
            try:
                while not made_src or made_src[0]._server is None:
                    await asyncio.sleep(0.01)
                port = made_src[0].bound_port()
                box["t0"] = time.perf_counter()
                for k in range(n_peers):
                    procs.append(ctx.Process(
                        target=socket_peer_main,
                        args=(port, b"".join(peers[k]))))
                    procs[-1].start()
                await asyncio.to_thread(
                    lambda: [p.join(120) for p in procs])
                box["complete"] = await wait_files(
                    out_dir, {f"p{k}": b for k, b in want_peers.items()}, 60)
                box["seconds"] = time.perf_counter() - box["t0"]
            finally:
                stop.set()

        task = asyncio.create_task(conductor())
        try:
            return await app.run_async(
                cli.parse_args(["-f", "--source", "socket:127.0.0.1:0",
                                "--stats", "-p", out_dir, *matches]),
                stop=stop, device=dev)
        finally:
            await task

    with tempfile.TemporaryDirectory() as out_dir, \
            captured_pipeline() as made, captured_source() as made_src, \
            env_set("KLOGS_WATCH_INTERVAL_S", "0.2"):
        term.set_ui_stream(io.StringIO())
        try:
            nk.reset_launches()
            rc = asyncio.run(drive_socket(out_dir, made_src))
            launches = dict(nk.LAUNCHES)
        finally:
            term.set_ui_stream(None)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(5)
        got = [open(os.path.join(out_dir, f), "rb").read()
               for f in sorted(os.listdir(out_dir))]
    by_peer = {}
    for body in got:
        m = re.match(rb"peer=(\d+) ", body)
        if m:
            by_peer[int(m.group(1))] = body
    lost = doubled = 0
    for k, body in want_peers.items():
        have = by_peer.get(k, b"").count(b"\n")
        lost += max(0, body.count(b"\n") - have)
        doubled += max(0, have - body.count(b"\n"))
    res["socket"] = dict(
        rc=rc, peers=n_peers, files=len(got), complete=box.get("complete"),
        lines_sent=n_peers * peer_lines,
        kept_lines=sum(b.count(b"\n") for b in want_peers.values()),
        mismatched_peers=sorted(k for k in want_peers
                                if by_peer.get(k) != want_peers[k]),
        lost_lines=lost, doubled_lines=doubled,
        seconds=box.get("seconds"),
        lines_per_s=(n_peers * peer_lines / box["seconds"]
                     if box.get("seconds") else None),
        peer_exit_codes=[p.exitcode for p in procs],
        launches=launches, **pipeline_numbers(made[0]))

    # (3) -f --source replay:FILE with one rename rotation mid-run.
    idx = rng.integers(0, len(pool), size=2 * rot_lines).tolist()
    old = [b"rot=a n=%06d " % i + pool[j] for i, j in enumerate(
        idx[:rot_lines])]
    new = [b"rot=b n=%06d " % i + pool[j] for i, j in enumerate(
        idx[rot_lines:])]
    straggler = [b"rot=a straggler after the last read panic: x\n"]
    lines = old + straggler + new
    v = oracle_verdicts(PATTERNS, [ln.rstrip(b"\n") for ln in lines])
    keep = dict(zip(lines, v))
    want_a = b"".join(ln for ln in old if keep[ln])
    want_all = b"".join(ln for ln in lines if keep[ln])
    rot_dir = os.path.join(root, "rotate")
    os.makedirs(rot_dir)
    path = os.path.join(rot_dir, "app.log")
    with open(path, "wb") as f:
        f.writelines(old)
    name = log_file_name(safe_group_name(path), "log")
    rot: dict = {}

    async def drive_rotation(out_dir: str) -> int:
        stop = asyncio.Event()

        async def conductor():
            try:
                t0 = time.perf_counter()
                rot["first_part"] = await wait_files(out_dir, {name: want_a},
                                                     60)
                with open(path, "ab") as f:
                    f.writelines(straggler)
                os.rename(path, path + ".1")
                with open(path, "wb") as f:
                    f.writelines(new)
                rot["complete"] = await wait_files(out_dir,
                                                   {name: want_all}, 60)
                rot["seconds"] = time.perf_counter() - t0
            finally:
                stop.set()

        task = asyncio.create_task(conductor())
        try:
            return await app.run_async(
                cli.parse_args(["-f", "--source", f"replay:{path}",
                                "--stats", "-p", out_dir, *matches]),
                stop=stop, device=dev)
        finally:
            await task

    with tempfile.TemporaryDirectory() as out_dir, \
            env_set("KLOGS_WATCH_INTERVAL_S", "0.2"):
        term.set_ui_stream(io.StringIO())
        try:
            nk.reset_launches()
            rc = asyncio.run(drive_rotation(out_dir))
            launches = dict(nk.LAUNCHES)
        finally:
            term.set_ui_stream(None)
        got = open(os.path.join(out_dir, name), "rb").read()
    res["rotation"] = dict(rc=rc, lines=len(lines),
                           kept_lines=want_all.count(b"\n"), equal=got == want_all,
                           lost_lines=max(0, want_all.count(b"\n")
                                          - got.count(b"\n")),
                           doubled_lines=max(0, got.count(b"\n")
                                             - want_all.count(b"\n")),
                           launches=launches, **rot)
    emit({"phase": "sources", **res})
    r, s, t = res["replay"], res["socket"], res["rotation"]
    if (r["rc"] != 0 or r["mismatched_files"] or r["files"] != n_sets
            or r["launches"][nk.GROUPED] == 0
            or r["launches"][nk.PACK_CLS] == 0
            or s["rc"] != 0 or not s["complete"] or s["mismatched_peers"]
            or s["files"] != n_peers or s["lost_lines"] or s["doubled_lines"]
            or any(c != 0 for c in s["peer_exit_codes"])
            or s["launches"][nk.GROUPED] == 0
            or t["rc"] != 0 or not t["equal"] or not t.get("complete")):
        raise AssertionError(f"sources phase failed: {res}")
    return res


# ---- filterd: the remote filter service on the card -----------------------

FILTERD_CONCURRENCY = (1, 4, 16)


def scrape(port: int) -> dict:
    """filterd's /metrics as {sample name with its labels: value}."""
    return asyncio.run(scrape_async(port))


async def scrape_async(port: int) -> dict:
    status, body = await http_get(port, "/metrics")
    if status != 200:
        raise AssertionError(f"/metrics answered {status}")
    out = {}
    for ln in body.decode().splitlines():
        if ln and not ln.startswith("#"):
            name, _, value = ln.rpartition(" ")
            out[name] = float(value)
    return out


def metric_delta(before: dict, after: dict, name: str) -> float:
    return after.get(name, 0.0) - before.get(name, 0.0)


def device_batches(before: dict, after: dict) -> dict:
    """filterd's device batches (coalesced groups) between two scrapes,
    and the lines a batch."""
    groups = metric_delta(before, after, "klogs_coalescer_groups_total")
    lines = metric_delta(before, after, "klogs_coalescer_group_lines_sum")
    return dict(device_batches=groups,
                lines_per_device_batch=lines / groups if groups else 0.0)


def rpcs_by_method(before: dict, after: dict) -> dict:
    return {m: metric_delta(before, after,
                            f'klogs_rpc_requests_total{{method="{m}"}}')
            for m in ("Hello", "Match", "MatchFramed")}


def dump_value(doc: dict, name: str, **labels) -> float:
    """The samples of a --stats-json dump whose labels include
    ``labels``, summed (0 when there is none)."""
    return sum(s["value"] for s in doc["metrics"].get(name, {}).get(
        "samples", []) if labels.items() <= s.get("labels", {}).items())


def start_filterd(root: str, patterns: list, args: tuple = (),
                  env: "dict | None" = None, backend: str = "cuda") -> dict:
    """Start ``python -m klogs_tpu_torch.service --backend cuda --match
    ... --metrics-port 0`` (``--port 0`` unless ``args`` names one; a
    ``--metrics-port`` in ``args`` wins) in a process of its own, as it
    is deployed, with ``env`` added to this process's environment:
    {proc, lines, ...}; ``await_filterd`` waits for it, ``stop_filterd``
    ends it. ``backend="cpu"`` serves the host engines."""
    argv = [sys.executable, "-m", "klogs_tpu_torch.service", "--backend",
            backend, "--metrics-port", "0", *args]
    if "--port" not in args:
        argv += ["--port", "0"]
    for p in patterns:
        argv += ["--match", p]
    err = tempfile.NamedTemporaryFile(prefix="filterd-", suffix=".err",
                                      delete=False)
    proc = subprocess.Popen(argv, cwd=root, stdout=subprocess.PIPE,
                            stderr=err, text=True,
                            env=dict(os.environ, **(env or {})))
    lines: list = []

    def read_stdout() -> None:
        for ln in iter(proc.stdout.readline, ""):
            lines.append(ln)

    reader = threading.Thread(target=read_stdout, daemon=True)
    reader.start()
    return dict(proc=proc, err=err, lines=lines, reader=reader,
                t0=time.perf_counter(), backend=backend)


def filterd_died(box: dict, what: str) -> AssertionError:
    with open(box["err"].name, errors="replace") as f:
        text = f.read()[-8000:]
    print(f"filterd ({what}); its stderr:\n{text}", file=sys.stderr,
          flush=True)
    return AssertionError(f"filterd {what} (exit {box['proc'].poll()})")


def await_filterd(box: dict, limit: float = 240.0) -> dict:
    """Wait until the banner named both ports and /readyz answered 200
    (the warmup batch went through the card, or a registry-only server
    bound); sets port, metrics_port, banner and ready_s. Raises, with
    the stderr printed, if the process died or is not up in ``limit``
    seconds."""
    proc, lines, t0 = box["proc"], box["lines"], box["t0"]
    while True:
        text = "".join(lines)
        m = re.search(r"serving .*\[%s\] on 127\.0\.0\.1:(\d+)"
                      % box.get("backend", "cuda"), text)
        mm = re.search(r"metrics on http://127\.0\.0\.1:(\d+)/metrics",
                       text)
        if m and mm:
            box.update(port=int(m.group(1)), metrics_port=int(mm.group(1)),
                       banner=[ln.strip() for ln in lines])
            break
        if proc.poll() is not None:
            raise filterd_died(box, "exited before its banner")
        if time.perf_counter() - t0 > limit:
            raise filterd_died(box, "printed no banner in time")
        time.sleep(0.05)
    while True:
        try:
            status, _ = asyncio.run(http_get(box["metrics_port"], "/readyz"))
        except OSError:
            status = None
        if status == 200:
            break
        if proc.poll() is not None:
            raise filterd_died(box, "exited before /readyz")
        if time.perf_counter() - t0 > limit:
            raise filterd_died(box, "was not ready in time")
        time.sleep(0.05)
    box["ready_s"] = time.perf_counter() - t0
    return box


def stop_filterd(box: dict) -> None:
    proc = box["proc"]
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(20)
    box["reader"].join(5)
    box["err"].close()
    if os.path.exists(box["err"].name):
        os.unlink(box["err"].name)


@contextlib.contextmanager
def filterd_process(root: str, patterns: list, limit: float = 240.0):
    """One deployed filterd for the block (``start_filterd``,
    ``await_filterd``), terminated after it; it fails the block if it
    died during it (unless the block killed it: ``box["killed"]``)."""
    box = start_filterd(root, patterns)
    try:
        await_filterd(box, limit)
        yield box
        if box["proc"].poll() is not None and not box.get("killed"):
            raise filterd_died(box, "died during the phase")
    finally:
        stop_filterd(box)


async def remote_run(app, cli, fc, argv: list, port: int):
    """``app.run_async`` as a --remote collector (no device argument: a
    collector of a remote filterd builds no engine)."""
    opts = cli.parse_args(argv + ["--remote", f"127.0.0.1:{port}"])
    return await app.run_async(opts, backend=fc)


def filterd_cell(np, app, cli, term, FakeCluster, fd: dict) -> dict:
    """(a) the cli cell (256 pods x 4000 lines + 16 long lines, --match
    x32) as the collector of the deployed filterd: files against the
    oracle, lines/s, RPCs by method, lines a device batch and the fleet
    counters, from filterd's /metrics."""
    fc, n_lines = cli_cluster(np, FakeCluster)
    pods = fc.namespaces["default"]
    matches = [a for p in PATTERNS for a in ("--match", p)]
    before = scrape(fd["metrics_port"])
    with tempfile.TemporaryDirectory() as out_dir:
        term.set_ui_stream(io.StringIO())
        try:
            t0 = time.perf_counter()
            rc = asyncio.run(remote_run(
                app, cli, fc, ["-n", "default", "-a", "--stats", "-p",
                               out_dir, *matches], fd["port"]))
            seconds = time.perf_counter() - t0
        finally:
            term.set_ui_stream(None)
        want = oracle_files(pods)
        bad = files_equal(out_dir, want)
    after = scrape(fd["metrics_port"])
    return dict(rc=rc, lines=n_lines, seconds=seconds,
                lines_per_s=n_lines / seconds, mismatched_files=bad,
                kept_lines=sum(v.count(b"\n") for v in want.values()),
                rpcs=rpcs_by_method(before, after),
                fleet_offered_lines=after.get(
                    "klogs_fleet_offered_lines_total"),
                fleet_admitted_lines=after.get(
                    "klogs_fleet_admitted_lines_total"),
                **device_batches(before, after))


def filterd_coalescing(np, GpuEngineFilter, frame_lines, synthetic_line,
                       dev, fd: dict, n_lines=262_144, batch=8192,
                       seconds=1.5) -> dict:
    """(b) ``tools/bench_service.py``'s shape: n_lines FakeCluster lines
    (1% needles) in framed RPCs of ``batch`` lines, at each concurrency
    of FILTERD_CONCURRENCY on one channel, ``seconds`` each; every
    verdict against the in-process engine's on the same frame."""
    from klogs_tpu_torch.service.client import RemoteFilterClient

    lines = [synthetic_line(f"pod-{i % 512:04d}", "c0", i, CLOCK + i)
             for i in range(n_lines)]
    for i in range(0, n_lines, 97):
        nd = NEEDLES[i % len(NEEDLES)]
        lines[i] = lines[i][:40] + nd + lines[i][40:]
    frames = [frame_lines(lines[i:i + batch], strip_nl=False)[:2]
              for i in range(0, n_lines, batch)]
    eng = GpuEngineFilter(PATTERNS, device=dev)
    want = [eng.fetch_framed(eng.dispatch_framed(*f)) for f in frames]
    eng.close()

    async def drive(conc: int) -> dict:
        client = RemoteFilterClient(f"127.0.0.1:{fd['port']}")
        try:
            await client.verify_patterns(PATTERNS)
            await client.match_framed(*frames[0])
            before = await scrape_async(fd["metrics_port"])
            done = mismatches = 0
            stop_at = time.monotonic() + seconds

            async def worker(w: int) -> None:
                nonlocal done, mismatches
                k = w
                while time.monotonic() < stop_at:
                    got = await client.match_framed(*frames[k % len(frames)])
                    if not np.array_equal(got, want[k % len(frames)]):
                        mismatches += 1
                    done += batch
                    k += conc

            t0 = time.perf_counter()
            await asyncio.gather(*[worker(w) for w in range(conc)])
            lps = done / (time.perf_counter() - t0)
            after = await scrape_async(fd["metrics_port"])
            return dict(concurrency=conc, lines=done, lines_per_s=lps,
                        mismatched_batches=mismatches,
                        **device_batches(before, after))
        finally:
            await client.aclose()

    runs = [asyncio.run(drive(conc)) for conc in FILTERD_CONCURRENCY]
    return dict(lines=n_lines, batch_lines=batch, seconds_each=seconds,
                matched=int(sum(int(w.sum()) for w in want)), runs=runs)


async def inprocess_filterd(patterns: list, dev, fc, argv: list, app, cli,
                            hello: bool = False):
    """A FilterServer on the card in this process, and one collector of
    it over loopback in the same loop: (rc, Hello or None)."""
    from klogs_tpu_torch.service.client import RemoteFilterClient
    from klogs_tpu_torch.service.server import FilterServer

    server = FilterServer(patterns, port=0, device=dev)
    port = await server.start()
    try:
        info = None
        if hello:
            c = RemoteFilterClient(f"127.0.0.1:{port}")
            try:
                info = await c.hello()
            finally:
                await c.aclose()
        return await remote_run(app, cli, fc, argv, port), info
    finally:
        await server.stop()


def filterd_kernels(torch, np, nk, pack, bits, app, cli, term, FakeCluster,
                    dev) -> dict:
    """(c) K1, K2 and pack_classify_rows held against their plain versions
    on the batches an in-process filterd built for one collector (32 pods x
    4000 lines + 4 long lines); then the 1024 patterns: Hello says
    device_sweep, a collector of 64 pods x 250 lines gets the oracle's
    files, and K3 with its pair list is held on the server's most
    frequent batch."""
    out: dict = {}
    fc, n_lines = cli_cluster(np, FakeCluster, n_pods=32, n_long=4)
    pods = fc.namespaces["default"]
    matches = [a for p in PATTERNS for a in ("--match", p)]
    with tempfile.TemporaryDirectory() as out_dir, \
            recording_wrappers(nk, pack, ["match_cls_grouped",
                                          "match_chunk_cls",
                                          "pack_classify_rows"]) as calls:
        term.set_ui_stream(io.StringIO())
        try:
            torch.cuda.synchronize()
            nk.reset_launches()
            rc, _ = asyncio.run(inprocess_filterd(
                PATTERNS, dev, fc, ["-n", "default", "-a", "-p", out_dir,
                                    *matches], app, cli))
            launches = dict(nk.LAUNCHES)
        finally:
            term.set_ui_stream(None)
        bad = files_equal(out_dir, oracle_files(pods))
    out["k32"] = dict(rc=rc, lines=n_lines, mismatched_files=bad,
                      launches=launches,
                      **held_batches(torch, nk, pack, calls, 2))
    pats = make_patterns(1024)
    fc, all_lines = k1024_cluster(np, FakeCluster, n_pods=64, n_long=4)
    matches = [a for p in pats for a in ("--match", p)]
    shapes: dict = {}
    gated = nk.match_cls_grouped_gated

    def recording(prog, live, acc, cls, words, want_stats=False):
        entry = shapes.setdefault(tuple(cls.shape),
                                  [0, (prog, live, acc, cls, words)])
        entry[0] += 1
        return gated(prog, live, acc, cls, words, want_stats=want_stats)

    with tempfile.TemporaryDirectory() as out_dir, \
            env_set("KLOGS_MAX_PATTERN_POSITIONS", "65536"):
        term.set_ui_stream(io.StringIO())
        nk.match_cls_grouped_gated = recording
        try:
            torch.cuda.synchronize()
            nk.reset_launches()
            rc, info = asyncio.run(inprocess_filterd(
                pats, dev, fc, ["-n", "default", "-a", "-p", out_dir,
                                *matches], app, cli, hello=True))
            launches = dict(nk.LAUNCHES)
        finally:
            nk.match_cls_grouped_gated = gated
            term.set_ui_stream(None)
        want, kept = k1024_expected(pats, all_lines)
        bad = files_equal(out_dir, want)
    k3 = [dict(launches=n, **k3_check(torch, bits, nk, *args, 10))
          for n, args in sorted(shapes.values(), key=lambda e: -e[0])[:1]]
    out["k1024"] = dict(rc=rc, lines=sum(map(len, all_lines.values())),
                        kept_lines=kept, mismatched_files=bad,
                        device_sweep=info["device_sweep"], launches=launches,
                        k3_shapes={f"{B}x{T}": e[0]
                                   for (B, T), e in shapes.items()},
                        k3_batches=k3)
    return out


def filterd_faults(np, app, cli, term, FakeCluster, fd: dict) -> dict:
    """(d), first: a collector under ``KLOGS_FAULTS=rpc.match:error*2``
    against the deployed filterd: exact files, and its --stats-json
    counts 2 injected faults and 2 retries at the endpoint's site."""
    fc, n_lines = cli_cluster(np, FakeCluster, n_pods=32, lines_per_pod=1000,
                              n_long=2)
    pods = fc.namespaces["default"]
    matches = [a for p in PATTERNS for a in ("--match", p)]
    with tempfile.TemporaryDirectory() as out_dir, \
            env_set("KLOGS_FAULTS", "rpc.match:error*2"):
        dump = os.path.join(out_dir, "stats.json")
        files = os.path.join(out_dir, "files")
        term.set_ui_stream(io.StringIO())
        try:
            rc = asyncio.run(remote_run(
                app, cli, fc, ["-n", "default", "-a", "-p", files,
                               "--stats-json", dump, *matches], fd["port"]))
        finally:
            term.set_ui_stream(None)
            obs_reset()
        bad = files_equal(files, oracle_files(pods))
        with open(dump) as f:
            doc = json.load(f)
    site = f"rpc@127.0.0.1:{fd['port']}"
    return dict(rc=rc, lines=n_lines, mismatched_files=bad,
                faults_injected=dump_value(doc, "klogs_faults_injected_total",
                                           point="rpc.match"),
                retries=dump_value(doc, "klogs_retry_attempts_total",
                                   site=site))


def filterd_killed(root: str, fd: dict, action: str, n_pods=64,
                   lines_per_pod=5_000) -> dict:
    """(d), then: a collector process (``python -m klogs_tpu_torch.cli
    -a --cluster fake --remote ... --on-filter-error ACTION``, no card
    used) whose filterd ``fd`` (started, ready) is killed once its
    first lines reached it.
    ``abort``: exit 1 with one error line; ``pass``: exit 0, and every
    line after the kill written unfiltered and counted in
    ``klogs_filter_degraded_lines_total{action="pass"}``."""
    with tempfile.TemporaryDirectory() as out_dir:
        dump = os.path.join(out_dir, "stats.json")
        argv = [sys.executable, "-m", "klogs_tpu_torch.cli", "-a",
                "--cluster", "fake", "--remote", f"127.0.0.1:{fd['port']}",
                "--on-filter-error", action, "-p",
                os.path.join(out_dir, "files"), "--stats-json", dump]
        for p in PATTERNS:
            argv += ["--match", p]
        env = dict(os.environ, KLOGS_FAKE_PODS=str(n_pods),
                   KLOGS_FAKE_CONTAINERS="1",
                   KLOGS_FAKE_LINES=str(lines_per_pod), NO_COLOR="1")
        t0 = time.perf_counter()
        coll = subprocess.Popen(argv, cwd=root, env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        try:
            offered = 0.0
            while offered <= 0 and coll.poll() is None:
                offered = scrape(fd["metrics_port"]).get(
                    "klogs_fleet_offered_lines_total", 0.0)
                time.sleep(0.02)
            fd["killed"] = True
            fd["proc"].kill()
            fd["proc"].wait(20)
            t_kill = time.perf_counter() - t0
            out, _ = coll.communicate(timeout=300)
        finally:
            if coll.poll() is None:
                coll.kill()
                coll.wait(20)
        res = dict(action=action, rc=coll.returncode,
                   killed_after_s=t_kill, offered_at_kill=offered,
                   seconds=time.perf_counter() - t0,
                   error_lines=[ln for ln in out.splitlines()
                                if "ERROR" in ln],
                   lines=n_pods * lines_per_pod)
        if action == "pass" and os.path.exists(dump):
            with open(dump) as f:
                doc = json.load(f)
            fdir = os.path.join(out_dir, "files")
            written = 0
            for name in os.listdir(fdir):
                with open(os.path.join(fdir, name), "rb") as f:
                    written += f.read().count(b"\n")
            res.update(
                lines_in=doc["summary"]["lines_in"],
                lines_matched=doc["summary"]["lines_matched"],
                degraded_lines=dump_value(
                    doc, "klogs_filter_degraded_lines_total", action="pass"),
                degraded_batches=dump_value(
                    doc, "klogs_filter_degraded_batches_total",
                    action="pass"),
                written_lines=written)
        if res["rc"] not in (0, 1):
            print(out[-8000:], file=sys.stderr, flush=True)
    return res


def filterd_phase(torch, np, nk, pack, bits, app, cli, term, FakeCluster,
                  GpuEngineFilter, frame_lines, synthetic_line, dev,
                  root: str, card: str, cli_lps: float) -> dict:
    """filterd, the port's remote filter service, on the card: (a) the
    cli cell against a deployed filterd, (b) coalescing across
    concurrent RPCs, (c) the kernels on filterd's own batches, at 32 and
    1024 patterns, (d) faults and a filterd killed mid-run."""
    res: dict = dict(card=card)
    with filterd_process(root, PATTERNS) as fd:
        res["ready_s"] = fd["ready_s"]
        res["banner"] = fd["banner"]
        res["cell"] = filterd_cell(np, app, cli, term, FakeCluster, fd)
        res["cell"]["inprocess_lines_per_s"] = cli_lps
        res["cell"]["remote_over_inprocess"] = (
            res["cell"]["lines_per_s"] / cli_lps)
        res["coalescing"] = filterd_coalescing(
            np, GpuEngineFilter, frame_lines, synthetic_line, dev, fd)
        res["faults"] = filterd_faults(np, app, cli, term, FakeCluster, fd)
    res["kernels"] = filterd_kernels(torch, np, nk, pack, bits, app, cli,
                                     term, FakeCluster, dev)
    # One filterd to kill for each action, both started at once.
    boxes = {a: start_filterd(root, PATTERNS) for a in ("abort", "pass")}
    try:
        res["killed"] = {a: filterd_killed(root, await_filterd(box), a)
                         for a, box in boxes.items()}
    finally:
        for box in boxes.values():
            stop_filterd(box)
    emit({"phase": "filterd", **res})
    a, b, c, d = (res["cell"], res["coalescing"], res["kernels"],
                  res["faults"])
    k32, k1024 = c["k32"], c["k1024"]
    held = k32["k1_batches"] + k32["k2_batches"] + k32["pack_batches"]
    ab, ps = res["killed"]["abort"], res["killed"]["pass"]
    if (a["rc"] != 0 or a["mismatched_files"]
            or a["fleet_offered_lines"] != a["lines"]
            or a["fleet_admitted_lines"] != a["lines"]
            or a["rpcs"]["MatchFramed"] <= 0 or a["device_batches"] <= 0
            or any(r["mismatched_batches"] or r["lines"] <= 0
                   for r in b["runs"])
            or k32["rc"] != 0 or k32["mismatched_files"]
            or any(k32["launches"][k] == 0
                   for k in (nk.GROUPED, nk.CHUNK, nk.PACK_CLS))
            or len(k32["k1_batches"]) < 2 or not k32["k2_batches"]
            or not k32["pack_batches"]
            or any(h.get("max_abs_err", 0) or h.get("mismatches", 0)
                   for h in held)
            or k1024["rc"] != 0 or k1024["mismatched_files"]
            or not k1024["device_sweep"] or not k1024["kept_lines"]
            or k1024["launches"][nk.GATED] == 0
            or k1024["launches"][nk.PAIRS] == 0 or not k1024["k3_batches"]
            or any(h["max_abs_err"] or h["pairs_mismatches"]
                   for h in k1024["k3_batches"])
            or d["rc"] != 0 or d["mismatched_files"]
            or d["faults_injected"] != 2 or d["retries"] != 2
            or ab["rc"] != 1 or len(ab["error_lines"]) != 1
            or ps["rc"] != 0 or not ps.get("degraded_lines")
            or ps["written_lines"] != ps["lines_matched"] + ps["degraded_lines"]
            or ps["lines_in"] + ps["degraded_lines"] != ps["lines"]):
        raise AssertionError(f"filterd phase failed: {res}")
    return res


# ---- fleet: the sharded filterd tier and the multi-set registry ---------

# (a): each endpoint's KLOGS_FLEET_CAPACITY_LPS, so Hello's headroom
# weighs round-robin routing. Headroom is 1 - admitted lines/s over a
# filterd's last 30 s / this envelope; after the first pass (~340,000
# lines an endpoint, ~20 s after each filterd started) that leaves A
# full headroom, B about half and C none (its weight at the 0.05 floor).
FLEET_CAPACITY_LPS = (2_000_000, 40_000, 10_000)
# (b): each stream's delay between its 4 KiB chunks, and its lines, so
# the run outlasts a filterd's restart (~10 s), its breaker's reset
# (10 s) and the channel's reconnect backoff: the restarted B serves.
MEMBERSHIP_CHUNK_DELAY_S = 0.3
MEMBERSHIP_LINES_PER_POD = 2600
# (c): the quota of the deployed registry and of the one in this process,
# above what the cells keep pending (the default 65536 sheds a 32-pod
# collector when the card is slow to drain); (d): the small one that sheds.
TENANT_QUOTA_LINES = (1 << 22, 8192)


def served_framed(before: dict, after: dict) -> float:
    return metric_delta(before, after,
                        'klogs_rpc_requests_total{method="MatchFramed"}')


def oracle_files_for(pods: dict, patterns: list) -> dict:
    """Each pod's file as an alternation of ``patterns`` selects it."""
    union = _alternation(tuple(patterns))
    return {f"{name}__c0.log": b"".join(
        ln for _, ln in pods[name].containers["c0"].lines
        if union.search(ln.rstrip(b"\n"))) for name in sorted(pods)}


def fleet_routing(app, cli, term, fc, want: dict, n_lines: int,
                  fleet: list, one_lps: float) -> dict:
    """(a) the cli cell as one collector of three filterds
    (``--remote A,B,C``): round-robin on a fleet with no load behind it,
    round-robin again ("weighted": each endpoint's Hello now carries the
    headroom its first pass left it, against its FLEET_CAPACITY_LPS),
    then ``--shard-mode hash``. Files against the oracle, lines/s beside
    one filterd's, each endpoint's MatchFramed RPCs from its /metrics
    against the collector's ``klogs_shard_batches_total``, and the
    weights and headroom at the end of each run. KLOGS_HEDGE_S is 30 s
    here, so no hedge doubles an RPC; capacity is refreshed every
    0.25 s, so the weights follow the endpoints' headroom."""
    from klogs_tpu_torch.service.shard import (
        ShardedFilterClient,
        pattern_fingerprint,
    )

    targets = [f"127.0.0.1:{b['port']}" for b in fleet]
    owner = targets[ShardedFilterClient(
        targets, shard_mode="hash", hedge_s=None,
        fingerprint=pattern_fingerprint(PATTERNS, [], False),
        client_factory=lambda t: None)._hash_order[0]]
    matches = [a for p in PATTERNS for a in ("--match", p)]
    out: dict = dict(targets=targets, capacity_lps=list(FLEET_CAPACITY_LPS),
                     hash_owner=owner, one_endpoint_lines_per_s=one_lps)
    for run, mode in (("round-robin", "round-robin"),
                      ("weighted", "round-robin"), ("hash", "hash")):
        before = [scrape(b["metrics_port"]) for b in fleet]
        with tempfile.TemporaryDirectory() as d, \
                env_set("KLOGS_HEDGE_S", "30"), \
                env_set("KLOGS_FLEET_REFRESH_S", "0.25"):
            out_dir, dump = os.path.join(d, "files"), os.path.join(d, "s.json")
            argv = ["-n", "default", "-a", "-p", out_dir, *matches,
                    "--remote", ",".join(targets), "--shard-mode", mode,
                    "--stats-json", dump]
            term.set_ui_stream(io.StringIO())
            try:
                t0 = time.perf_counter()
                rc = asyncio.run(app.run_async(cli.parse_args(argv),
                                               backend=fc))
                seconds = time.perf_counter() - t0
            finally:
                term.set_ui_stream(None)
                obs_reset()
            bad = files_equal(out_dir, want)
            with open(dump) as f:
                doc = json.load(f)
        after = [scrape(b["metrics_port"]) for b in fleet]
        out[run] = dict(
            rc=rc, seconds=seconds, lines_per_s=n_lines / seconds,
            over_one_endpoint=n_lines / seconds / one_lps,
            mismatched_files=bad,
            served={t: served_framed(b0, b1)
                    for t, b0, b1 in zip(targets, before, after)},
            batches={t: dump_value(doc, "klogs_shard_batches_total",
                                   endpoint=t) for t in targets},
            hedges=dump_value(doc, "klogs_shard_hedges_total"),
            reroutes=dump_value(doc, "klogs_shard_reroutes_total"),
            weights={t: dump_value(doc, "klogs_shard_endpoint_weight",
                                   endpoint=t) for t in targets},
            headroom={t: dump_value(doc, "klogs_fleet_endpoint_headroom",
                                    endpoint=t) for t in targets})
    return out


def fleet_membership(np, app, cli, term, FakeCluster, root: str,
                     fleet: list) -> dict:
    """(b) ``--resolver file:PATH`` seeded with A and B under load (64
    pods x MEMBERSHIP_LINES_PER_POD lines, each stream pausing
    MEMBERSHIP_CHUNK_DELAY_S between 4 KiB chunks): once B has served, B
    is killed, C is written into the file and B is started again on its
    gRPC and metrics ports, as a redeployed pod comes back. Files
    against the oracle, what each endpoint served (the restarted B too),
    and the collector's membership events, reroutes, hedges and degraded
    lines from its --stats-json. Returns the restarted B as
    ``restarted`` (the caller stops it)."""
    a, b, c = fleet
    fc, n_lines = cli_cluster(np, FakeCluster, n_pods=64,
                              lines_per_pod=MEMBERSHIP_LINES_PER_POD,
                              n_long=0)
    pods = fc.namespaces["default"]
    for pod in pods.values():
        pod.containers["c0"].faults.chunk_delay_s = MEMBERSHIP_CHUNK_DELAY_S
    want = oracle_files(pods)
    matches = [a for p in PATTERNS for a in ("--match", p)]
    t_of = {name: f"127.0.0.1:{box['port']}"
            for name, box in (("a", a), ("b", b), ("c", c))}
    ev: dict = {}
    with tempfile.TemporaryDirectory() as d:
        fleet_file = os.path.join(d, "fleet")
        with open(fleet_file, "w") as f:
            f.write(f"{t_of['a']}\n{t_of['b']}\n")
        out_dir, dump = os.path.join(d, "files"), os.path.join(d, "s.json")
        base = [scrape(x["metrics_port"]) for x in (a, b, c)]

        async def scenario():
            opts = cli.parse_args(["-n", "default", "-a", "-p", out_dir,
                                   *matches, "--resolver",
                                   f"file:{fleet_file}",
                                   "--stats-json", dump])
            t0 = time.perf_counter()
            run = asyncio.ensure_future(app.run_async(opts, backend=fc))
            while True:
                now = await scrape_async(b["metrics_port"])
                if served_framed(base[1], now) > 0:
                    break
                if run.done():
                    raise AssertionError("the run ended before B served")
                await asyncio.sleep(0.05)
            b["killed"] = True
            b["proc"].kill()
            await asyncio.to_thread(b["proc"].wait, 20)
            ev["b_killed_s"] = time.perf_counter() - t0
            with open(fleet_file, "w") as f:
                f.write(f"{t_of['a']}\n{t_of['b']}\n{t_of['c']}\n")
            ev["c_written_s"] = time.perf_counter() - t0
            b2 = start_filterd(root, PATTERNS,
                               ("--port", str(b["port"]), "--metrics-port",
                                str(b["metrics_port"])),
                               {"KLOGS_FLEET_CAPACITY_LPS":
                                str(FLEET_CAPACITY_LPS[1])})
            try:
                await asyncio.to_thread(await_filterd, b2)
                ev["b_ready_again_s"] = time.perf_counter() - t0
                rc = await run
            except BaseException:
                stop_filterd(b2)
                raise
            ev["seconds"] = time.perf_counter() - t0
            return rc, b2

        term.set_ui_stream(io.StringIO())
        try:
            with env_set("KLOGS_RESOLVER_INTERVAL_S", "0.25"), \
                    env_set("KLOGS_READYZ_INTERVAL_S", "0.25"), \
                    env_set("KLOGS_HEDGE_S", "0.25"):
                rc, b2 = asyncio.run(scenario())
        finally:
            term.set_ui_stream(None)
            obs_reset()
        bad = files_equal(out_dir, want)
        with open(dump) as f:
            doc = json.load(f)
    after = [scrape(x["metrics_port"]) for x in (a, b2, c)]
    return dict(
        rc=rc, lines=n_lines, lines_per_s=n_lines / ev["seconds"],
        mismatched_files=bad, **ev,
        served=dict(a=served_framed(base[0], after[0]),
                    b_restarted=served_framed({}, after[1]),
                    c=served_framed(base[2], after[2])),
        membership_events={
            act: dump_value(doc, "klogs_fleet_membership_events_total",
                            action=act) for act in ("add", "remove", "error")},
        membership_size=dump_value(doc, "klogs_fleet_membership_size"),
        reroutes={r: dump_value(doc, "klogs_shard_reroutes_total", reason=r)
                  for r in ("breaker", "unready", "error")},
        hedges=dump_value(doc, "klogs_shard_hedges_total"),
        batches=dump_value(doc, "klogs_shard_batches_total"),
        degraded_lines=dump_value(doc, "klogs_filter_degraded_lines_total"),
        restarted=b2)


def fleet_tenants(app, cli, term, fc, want: dict, fc3, want3: dict,
                  multi: dict) -> dict:
    """(c) one deployed ``--multi-set`` filterd with no --match and three
    collectors at once: the cli cell's 32 patterns twice (one engine)
    and ``make_patterns(1024)`` on 64 pods x 250 lines. Every file
    against its oracle, Hello's multi_set, and the engine builds and
    live sets from its /metrics."""
    from klogs_tpu_torch.service.client import RemoteFilterClient

    pats3 = make_patterns(1024)
    before = scrape(multi["metrics_port"])
    port = multi["port"]
    with tempfile.TemporaryDirectory() as d:
        dirs = [os.path.join(d, str(i)) for i in range(3)]
        argvs = [["-n", "default", "-a", "-p", dirs[i],
                  *[a for p in pats for a in ("--match", p)]]
                 for i, pats in enumerate((PATTERNS, PATTERNS, pats3))]

        async def scenario():
            runs = await asyncio.gather(
                remote_run(app, cli, fc, argvs[0], port),
                remote_run(app, cli, fc, argvs[1], port),
                remote_run(app, cli, fc3, argvs[2], port))
            c = RemoteFilterClient(f"127.0.0.1:{port}")
            try:
                return runs, await c.hello()
            finally:
                await c.aclose()

        term.set_ui_stream(io.StringIO())
        try:
            t0 = time.perf_counter()
            rcs, hello = asyncio.run(scenario())
            seconds = time.perf_counter() - t0
        finally:
            term.set_ui_stream(None)
        bad = [files_equal(dirs[0], want), files_equal(dirs[1], want),
               files_equal(dirs[2], want3)]
    after = scrape(multi["metrics_port"])
    return dict(
        rcs=rcs, seconds=seconds, mismatched_files=bad,
        hello_multi_set=hello.get("multi_set"), hello_sets=hello.get("sets"),
        banner=multi["banner"],
        engine_builds=after.get("klogs_tenant_engine_builds_total"),
        live_sets=after.get("klogs_tenant_sets"),
        registrations={o: metric_delta(
            before, after,
            f'klogs_tenant_registrations_total{{outcome="{o}"}}')
            for o in ("new", "shared")},
        served=served_framed(before, after))


def sweep_held(torch, np, bits, sweep, pats: list, pattern_group,
               seen: list) -> dict:
    """The card's sweep on the batches it was given, against the same
    function on tables built for the CPU (as the ``sweep`` phase)."""
    from klogs_tpu_torch.filters.compiler.groups import analyze, plan_groups
    from klogs_tpu_torch.filters.compiler.index import FactorIndex

    st = seen[0][0]
    infos = analyze(pats)
    host_tables = sweep.device_sweep_tables(
        FactorIndex(infos, plan_groups(infos)).sweep_program(
            group_of=np.asarray(pattern_group, dtype=np.int32),
            n_groups=st.n_groups), device="cpu")
    out = []
    for tables, batch, lens in seen:
        words = sweep.sweep_group_bits(tables, batch, lens)
        gm = bits.unpack_bits(words, tables.n_groups).cpu()
        host = sweep.sweep_group_candidates(host_tables, batch.cpu(),
                                            lens.cpu())
        out.append(dict(
            shape=list(batch.shape), mismatched_cells=int((gm != host).sum()),
            ms=cuda_ms(torch, lambda: sweep.sweep_group_bits(
                tables, batch, lens), 5)))
    return dict(batches=out)


def fleet_registry(torch, np, nk, pack, bits, sweep, app, cli, term,
                   FakeCluster, dev, fc3, want3: dict) -> dict:
    """(c), then: a ``--multi-set`` FilterServer on the card in this
    process. A collector of the 32 patterns (32 pods x 4000 lines + 4
    long lines) under ``recording_wrappers``: K1, K2 and
    pack_classify_rows held against their plain versions on its batches.
    Then the 1024 patterns' collector (64 pods x 250 lines + 4 long
    lines): the sweep and K3 with its pair list, and K2g, held on the
    batches that set's engine built (``launches_1024``: its own counts).
    The card's
    allocated memory before that set registered, while it lives, and
    after its eviction. ``launches`` adds the two collectors' runs, each
    counted from 0 just before it and read just after it, before any
    kernel is held against its plain version. The registry's quota is
    the deployed one's, so no batch of these cells is shed."""
    from klogs_tpu_torch.service.server import FilterServer
    from klogs_tpu_torch.service.shard import pattern_fingerprint

    fc, n_lines = cli_cluster(np, FakeCluster, n_pods=32, n_long=4)
    want = oracle_files(fc.namespaces["default"])
    pats3 = make_patterns(1024)
    fp3 = pattern_fingerprint(pats3, [], False)
    out: dict = {}

    def memory() -> int:
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated(dev)

    async def collect(cluster, pats: list, name: str,
                      port: int) -> "tuple[int, dict]":
        """One collector's run into d/name: (rc, its launches)."""
        torch.cuda.synchronize()
        nk.reset_launches()
        rc = await remote_run(app, cli, cluster, [
            "-n", "default", "-a", "-p", os.path.join(d, name),
            *[a for p in pats for a in ("--match", p)]], port)
        torch.cuda.synchronize()
        return rc, dict(nk.LAUNCHES)

    async def scenario():
        server = FilterServer([], port=0, device=dev, multi_set=True)
        port = await server.start()
        try:
            with recording_wrappers(nk, pack, ["match_cls_grouped",
                                               "match_chunk_cls",
                                               "pack_classify_rows"]) as calls:
                out["rc32"], n32 = await collect(fc, PATTERNS, "32", port)
            out.update(held_batches(torch, nk, pack, calls, 2))
            calls.clear()
            out["memory_before"] = memory()
            with recording_wrappers(nk, pack, ["match_cls_grouped_gated",
                                               "sweep_group_bits",
                                               "match_chunk_cls_grouped"],
                                    sweep) as calls:
                out["rc1024"], n1024 = await collect(fc3, pats3, "1024",
                                                     port)
            out["launches"] = {k: n32[k] + n1024[k] for k in n32}
            out["launches_1024"] = n1024
            out["k2g_batches"] = held_k2g(torch, nk, calls)
            eng = server.tenants.get(fp3).service._filter
            out["sweep"] = sweep_held(
                torch, np, bits, sweep, pats3, eng._grouped.pattern_group,
                [a for _, seen in calls["sweep_group_bits"].values()
                 for a, _ in seen][:4])
            del eng
            gated = sorted(calls["match_cls_grouped_gated"].values(),
                           key=lambda e: -e[0])
            out["k3_shapes"] = {
                "x".join(map(str, seen[0][0][3].shape)): n
                for n, seen in gated}
            out["k3_batches"] = [
                dict(launches=n, **k3_check(torch, bits, nk, *seen[0][0], 10))
                for n, seen in gated[:1]]
            calls.clear()
            del gated
            out["memory_registered"] = memory()
            out["pending_lines"] = sum(e.lane.pending_lines
                                       for e in server.tenants.entries())
            out["sets_before_evict"] = server.tenants.count
            out["evicted"] = await server.tenants.evict(fp3, "idle")
            out["memory_after"] = memory()
            out["sets_after_evict"] = server.tenants.count
        finally:
            await server.stop()

    with tempfile.TemporaryDirectory() as d, \
            env_set("KLOGS_TENANT_QUOTA_LINES", str(TENANT_QUOTA_LINES[0])):
        term.set_ui_stream(io.StringIO())
        try:
            asyncio.run(scenario())
        finally:
            term.set_ui_stream(None)
        out["mismatched_files"] = [files_equal(os.path.join(d, "32"), want),
                                   files_equal(os.path.join(d, "1024"),
                                               want3)]
    out["lines"] = n_lines
    out["memory_after_over_before"] = (out["memory_after"]
                                       / max(out["memory_before"], 1))
    return out


def fleet_shedding(np, app, cli, term, FakeCluster, dev) -> dict:
    """(d) a ``--multi-set`` FilterServer on the card in this process
    with ``KLOGS_TENANT_QUOTA_LINES`` small, and two collectors at once:
    one of the 32 patterns over 64 pods x 4000 lines with
    ``--on-filter-error pass`` (over quota), and a sibling of another
    set (the first 16 patterns) over 8 pods x 500 lines. The server's
    ``klogs_tenant_shed_total`` by set, the first collector's degraded
    batches and lines, and the sibling's files against the oracle."""
    from klogs_tpu_torch.service.server import FilterServer
    from klogs_tpu_torch.service.shard import pattern_fingerprint

    fc, n_lines = cli_cluster(np, FakeCluster, n_pods=64, n_long=0)
    sib = PATTERNS[:16]
    fcs = FakeCluster.synthetic(n_pods=8, n_containers=1,
                                lines_per_container=500, clock=lambda: CLOCK)
    want_sib = oracle_files_for(fcs.namespaces["default"], sib)
    fp_a = pattern_fingerprint(PATTERNS, [], False)
    fp_s = pattern_fingerprint(sib, [], False)

    async def scenario(d: str):
        server = FilterServer([], port=0, device=dev, multi_set=True,
                              metrics_port=0)
        port = await server.start()
        try:
            rcs = await asyncio.gather(
                remote_run(app, cli, fc, ["-n", "default", "-a", "-p",
                                          os.path.join(d, "a"),
                                          "--on-filter-error", "pass",
                                          *[a for p in PATTERNS
                                            for a in ("--match", p)]], port),
                remote_run(app, cli, fcs, ["-n", "default", "-a", "-p",
                                           os.path.join(d, "s"),
                                           *[a for p in sib
                                             for a in ("--match", p)]],
                           port))
            shed = server.registry.family("klogs_tenant_shed_total")
            return rcs, {k[0]: c.value for k, c in shed.children()}
        finally:
            await server.stop()

    with tempfile.TemporaryDirectory() as d, \
            env_set("KLOGS_TENANT_QUOTA_LINES", str(TENANT_QUOTA_LINES[1])), \
            captured_pipeline() as made:
        term.set_ui_stream(io.StringIO())
        try:
            t0 = time.perf_counter()
            rcs, shed = asyncio.run(scenario(d))
            seconds = time.perf_counter() - t0
        finally:
            term.set_ui_stream(None)
        bad_sib = files_equal(os.path.join(d, "s"), want_sib)
        written = 0
        for name in os.listdir(os.path.join(d, "a")):
            with open(os.path.join(d, "a", name), "rb") as f:
                written += f.read().count(b"\n")
    st = next(p.stats for p in made if p.patterns == PATTERNS)
    return dict(
        rcs=rcs, seconds=seconds, quota_lines=TENANT_QUOTA_LINES[1],
        lines=n_lines, shed_batches=shed.get(fp_a, 0.0),
        sibling_shed_batches=shed.get(fp_s, 0.0),
        degraded_batches=sum(c.value for _, c in
                             st._degraded_batches.children()),
        degraded_lines=st.degraded_lines, lines_in=st.lines_in,
        lines_matched=st.lines_matched, written_lines=written,
        sibling_mismatched_files=bad_sib)


def compute_apps() -> list:
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def fleet_phase(torch, np, nk, pack, bits, sweep, app, cli, term,
                FakeCluster, dev, root: str, card: str,
                one_lps: float) -> dict:
    """The sharded filterd tier and the multi-set registry on the card:
    (a) routing, (b) membership under load, (c) tenants, deployed and
    in this process (kernels, memory), (d) shedding. Four filterd
    processes start at once: three of the 32 patterns (A, B, C) and one
    registry-only ``--multi-set``. One line a part, then the checks."""
    t0 = time.perf_counter()
    boxes = [start_filterd(root, PATTERNS,
                           env={"KLOGS_FLEET_CAPACITY_LPS": str(c)})
             for c in FLEET_CAPACITY_LPS]
    boxes.append(start_filterd(root, [], ("--multi-set",), {
        "KLOGS_TENANT_QUOTA_LINES": str(TENANT_QUOTA_LINES[0])}))
    res: dict = dict(card=card)
    try:
        # The cells and their oracles while the processes come up.
        fc, n_lines = cli_cluster(np, FakeCluster)
        want = oracle_files(fc.namespaces["default"])
        fc3, lines3 = k1024_cluster(np, FakeCluster, n_pods=64, n_long=4)
        want3, kept3 = k1024_expected(make_patterns(1024), lines3)
        for box in boxes:
            await_filterd(box)
        res["ready_s"] = [box["ready_s"] for box in boxes]
        res["setup_s"] = time.perf_counter() - t0
        fleet = boxes[:3]
        t = time.perf_counter()
        res["a"] = fleet_routing(app, cli, term, fc, want, n_lines, fleet,
                                 one_lps)
        emit({"phase": "fleet", "part": "a", "seconds":
              time.perf_counter() - t, **res["a"]})
        t = time.perf_counter()
        b = fleet_membership(np, app, cli, term, FakeCluster, root, fleet)
        boxes.append(b.pop("restarted"))
        res["b"] = b
        emit({"phase": "fleet", "part": "b", "seconds":
              time.perf_counter() - t, **b})
        t = time.perf_counter()
        res["c"] = fleet_tenants(app, cli, term, fc, want, fc3, want3,
                                 boxes[3])
        res["c"]["kept_1024"] = kept3
        res["compute_apps"] = compute_apps()
        emit({"phase": "fleet", "part": "c", "seconds":
              time.perf_counter() - t, **res["c"],
              "compute_apps": res["compute_apps"]})
        res["died"] = [i for i, box in enumerate(boxes)
                       if box["proc"].poll() is not None
                       and not box.get("killed")]
    finally:
        for box in boxes:
            stop_filterd(box)
    del fc
    t = time.perf_counter()
    res["registry"] = fleet_registry(torch, np, nk, pack, bits, sweep, app,
                                     cli, term, FakeCluster, dev, fc3, want3)
    emit({"phase": "fleet", "part": "c_registry", "seconds":
          time.perf_counter() - t, **res["registry"]})
    t = time.perf_counter()
    res["d"] = fleet_shedding(np, app, cli, term, FakeCluster, dev)
    emit({"phase": "fleet", "part": "d", "seconds":
          time.perf_counter() - t, **res["d"]})
    res["seconds"] = time.perf_counter() - t0
    a, b, c, r, d = (res["a"], res["b"], res["c"], res["registry"],
                     res["d"])
    rr, wr, hs = a["round-robin"], a["weighted"], a["hash"]
    # A, B, C in the order of their capacities, high to low.
    sa, sb, sc = (wr["served"][t] for t in a["targets"])
    held = r["k1_batches"] + r["k2_batches"] + r["pack_batches"]
    problems = [
        ("filterd died", res["died"]),
        ("(a) round-robin", rr["rc"] != 0 or rr["mismatched_files"]
         or sum(rr["served"].values()) != sum(rr["batches"].values())
         or min(rr["served"].values()) <= 0 or rr["hedges"] != 0),
        ("(a) weighted", wr["rc"] != 0 or wr["mismatched_files"]
         or sum(wr["served"].values()) != sum(wr["batches"].values())
         or wr["hedges"] != 0 or not sa > sb > sc),
        ("(a) hash", hs["rc"] != 0 or hs["mismatched_files"]
         or hs["served"][a["hash_owner"]] != sum(hs["batches"].values())
         or hs["batches"][a["hash_owner"]] != sum(hs["batches"].values())
         or sum(hs["served"].values()) != hs["served"][a["hash_owner"]]
         or hs["served"][a["hash_owner"]] <= 0),
        ("(b)", b["rc"] != 0 or b["mismatched_files"]
         or b["degraded_lines"] != 0
         or sum(b["membership_events"].values()) <= 0
         or b["membership_events"]["add"] < 1
         or sum(b["reroutes"].values()) <= 0 or b["served"]["c"] <= 0
         or b["served"]["b_restarted"] <= 0),
        ("(c) deployed", c["rcs"] != [0, 0, 0] or any(c["mismatched_files"])
         or c["hello_multi_set"] is not True or c["engine_builds"] != 2
         or c["live_sets"] != 2 or not c["kept_1024"]),
        ("(c) kernels", r["rc32"] != 0 or r["rc1024"] != 0
         or any(r["mismatched_files"])
         or any(r["launches"][k] == 0 for k in (
             nk.GROUPED, nk.CHUNK, nk.PACK_CLS, nk.GATED, nk.PAIRS,
             nk.GROUPED_CHUNK))
         or r["launches_1024"][nk.CHUNK] != 0 or not r["k2g_batches"]
         or r["k2g_batches"][0]["max_abs_err"]
         or len(r["k1_batches"]) < 2 or not r["k2_batches"]
         or not r["pack_batches"]
         or any(h.get("max_abs_err", 0) or h.get("mismatches", 0)
                for h in held)
         or not r["k3_batches"]
         or any(h["max_abs_err"] or h["pairs_mismatches"]
                for h in r["k3_batches"])
         or not r["sweep"]["batches"]
         or any(s["mismatched_cells"] for s in r["sweep"]["batches"])),
        ("(c) memory", not r["evicted"] or r["sets_after_evict"] != 1
         or r["pending_lines"] != 0
         or r["memory_after"] > 1.05 * r["memory_before"]),
        ("(d)", d["rcs"] != [0, 0] or d["sibling_mismatched_files"]
         or d["shed_batches"] <= 0 or d["sibling_shed_batches"] != 0
         or d["degraded_batches"] != d["shed_batches"]
         or d["written_lines"] != d["lines_matched"] + d["degraded_lines"]
         or d["lines_in"] + d["degraded_lines"] != d["lines"]),
    ]
    failed = [name for name, bad in problems if bad]
    if failed:
        raise AssertionError(f"fleet phase failed: {failed}")
    return res


# ---- the host engines (--backend cpu) ------------------------------------

def host_cpu() -> dict:
    """The host's CPU (its model name, vendor, family and model numbers,
    and which of the sweep's SIMD extensions it reports) and its thread
    count: the host engines' numbers are the host's, not the card's."""
    info: dict = {}
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                key, _, value = ln.partition(":")
                key = key.strip()
                if not ln.strip():
                    break
                if key in ("model name", "vendor_id", "cpu family", "model",
                           "flags"):
                    info[key] = value.strip()
    except OSError:
        pass
    flags = set(info.pop("flags", "").split())
    return dict(cpu=info, simd_flags=sorted(
        flags & {"ssse3", "avx2", "avx512f", "avx512bw"}),
        threads=os.cpu_count(), usable_threads=len(os.sched_getaffinity(0)))


def host_cli(app, cli, term, fc, pats: list, want: dict, n_lines: int):
    """One ``--backend cpu`` run of ``app.run_async`` (no device
    argument: the user's entry point) over ``fc``: its files against
    ``want``, lines/s and the engine it built; returns (numbers, the
    pipeline)."""
    from klogs_tpu_torch.filters.sink import _indexed_engine

    argv = ["-n", "default", "-a", "--backend", "cpu", "--stats", "-p", ""]
    for p in pats:
        argv += ["--match", p]
    with tempfile.TemporaryDirectory() as out_dir, captured_pipeline() as made:
        argv[7] = out_dir
        opts = cli.parse_args(argv)
        ui = io.StringIO()
        term.set_ui_stream(ui)
        try:
            t0 = time.perf_counter()
            rc = asyncio.run(app.run_async(opts, backend=fc))
            seconds = time.perf_counter() - t0
        finally:
            term.set_ui_stream(None)
        bad = files_equal(out_dir, want)
    pipe = made[0]
    res = dict(rc=rc, patterns=len(pats), lines=n_lines, seconds=seconds,
               lines_per_s=n_lines / seconds, mismatched_files=bad,
               kept_lines=sum(v.count(b"\n") for v in want.values()),
               engine=type(pipe.log_filter).__name__,
               sink_batches=pipe.stats.batches,
               index_line=next((ln.strip() for ln in ui.getvalue()
                                .splitlines() if "indexed engine:" in ln),
                               None))
    idx = _indexed_engine(pipe.log_filter)
    if idx is not None:
        res.update(engine_kinds=idx.engine_kinds, groups=len(idx.groups),
                   narrowing_ratio=idx.narrowing_ratio,
                   candidate_cells=idx.candidate_cells,
                   swept_cells=idx.swept_cells,
                   stage_s=dict(idx.stage_s), sweep_path=idx._sweep_path,
                   sweep_impl=idx.index.last_impl,
                   group_scan_impl=idx.group_scan_impl)
    return res, pipe


def short_frames(frame_lines, lines: list, size: int) -> list:
    """(payload, offsets) frames of ``size`` lines each, as a sink
    frames them (trailing newlines stripped)."""
    out = []
    for i in range(0, len(lines), size):
        payload, off, _ = frame_lines(lines[i:i + size])
        out.append((payload, off))
    return out


def host_device_sweep(torch, np, nk, frame_lines, dev, pats: list,
                      all_lines: dict, host_f) -> dict:
    """(b) ``IndexedFilter(sweep="device")`` on the card over the
    cli_k1024 cell's lines: its candidate matrix against its index's
    host sweep (the C ``sweep_candidates``) on every 16384-line slab,
    bit for bit; the sweep's ms a slab on the card (the H2D copy,
    ``pack_rows``, the torch sweep and the matrix's way back) and on
    the host; the filter's verdicts on every slab, and on a slab of
    the long lines (routed to the host by width), against the host
    sweep's filter ``host_f`` and, on the first slab's first 4096 lines
    and the long ones, the ``re`` oracle; ``pack_rows``' launches on this path (counts
    zeroed just before, read just after)."""
    from klogs_tpu_torch.filters.indexed import SWEEP_MAX_WIDTH, IndexedFilter

    flat = [ln for name in sorted(all_lines) for ln in all_lines[name]]
    short = [ln for ln in flat if len(ln.rstrip(b"\n")) <= SWEEP_MAX_WIDTH]
    long_ = [ln for ln in flat if len(ln.rstrip(b"\n")) > SWEEP_MAX_WIDTH]
    t0 = time.perf_counter()
    d = IndexedFilter(pats, sweep="device", device=dev)
    build_s = time.perf_counter() - t0
    frames = short_frames(frame_lines, short, 16384)
    d._device_candidates(*frames[0])  # warm-up: the first torch calls
    dev_ms, host_ms, bad_cells, cells = [], [], 0, 0
    for payload, off in frames:
        torch.cuda.synchronize()
        t = time.perf_counter()
        gm = d._device_candidates(payload, off)
        dev_ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        ref = d.index.group_candidates(payload, off)
        host_ms.append((time.perf_counter() - t) * 1e3)
        bad_cells += int(np.count_nonzero(gm != ref))
        cells += int(ref.size)
    frames.append(frame_lines(long_)[:2])
    torch.cuda.synchronize()
    nk.reset_launches()
    got = [d.fetch_framed(d.dispatch_framed(p, o)) for p, o in frames]
    torch.cuda.synchronize()
    launches = dict(nk.LAUNCHES)
    want = [host_f.fetch_framed(host_f.dispatch_framed(p, o))
            for p, o in frames]
    bad_verdicts = sum(int(np.count_nonzero(a != b))
                       for a, b in zip(got, want))
    bodies = [ln.rstrip(b"\n") for ln in short[:4096] + long_]
    ora = np.array(oracle_verdicts(pats, bodies))
    bad_oracle = int(np.count_nonzero(
        np.concatenate([got[0][:4096], got[-1]]) != ora))
    batches = {labels[0]: c.value for labels, c in d.registry.family(
        "klogs_sweep_batches_total").children()}
    return dict(build_s=build_s, slabs=len(frames) - 1, slab_lines=16384,
                lines=len(short) + len(long_), long_lines=len(long_),
                groups=len(d.groups), cells=cells,
                mismatched_cells=bad_cells,
                device_sweep_ms=dev_ms, host_sweep_ms=host_ms,
                device_sweep_ms_median=float(np.median(dev_ms)),
                host_sweep_ms_median=float(np.median(host_ms)),
                mismatched_verdicts=bad_verdicts,
                oracle_lines=len(bodies), mismatched_oracle=bad_oracle,
                kept=int(sum(int(g.sum()) for g in got)),
                sweep_batches=batches, launches=launches,
                pack_launches=launches[nk.PACK], sweep_path=d._sweep_path)


def host_filterd(np, app, cli, term, FakeCluster, root: str,
                 env: dict) -> dict:
    """(c) ``python -m klogs_tpu_torch.service --backend cpu`` --match
    x32 as its own process, with one collector of 64 pods x 4000 lines
    (+ 16 long lines) through ``--remote``: files exact, lines/s and its
    RPCs; then a ``--multi-set`` FilterServer ``backend="cpu"`` in this
    process (``KLOGS_TENANT_QUOTA_LINES`` set) and a collector of 96
    patterns (the indexed engine) over 32 pods x 250 lines: files
    exact; the set evicted and the same collector again: it registers
    again, its files exact, and its DFA tables load from the cache on
    disk (one ``hit`` a DFA group; the only new ``miss`` events are the
    group builds that overflow the state budget and are bisected, which
    are never cached, as in JAX)."""
    from klogs_tpu_torch.service.server import FilterServer
    from klogs_tpu_torch.service.shard import pattern_fingerprint

    fc, n_lines = cli_cluster(np, FakeCluster, n_pods=64)
    want = oracle_files(fc.namespaces["default"])
    out: dict = dict(lines=n_lines)
    box = start_filterd(root, PATTERNS, env=env, backend="cpu")
    try:
        await_filterd(box, 120)
        out["ready_s"] = box["ready_s"]
        out["banner"] = box["banner"]
        before = scrape(box["metrics_port"])
        with tempfile.TemporaryDirectory() as d:
            term.set_ui_stream(io.StringIO())
            try:
                t0 = time.perf_counter()
                out["rc"] = asyncio.run(remote_run(
                    app, cli, fc, ["-n", "default", "-a", "-p", d,
                                   *[a for p in PATTERNS
                                     for a in ("--match", p)]],
                    box["port"]))
                out["seconds"] = time.perf_counter() - t0
            finally:
                term.set_ui_stream(None)
            out["mismatched_files"] = files_equal(d, want)
        after = scrape(box["metrics_port"])
        out["lines_per_s"] = n_lines / out["seconds"]
        out["rpcs"] = rpcs_by_method(before, after)
        if box["proc"].poll() is not None:
            raise filterd_died(box, "died during the phase")
    finally:
        stop_filterd(box)

    pats = make_patterns(128)[32:]
    fp = pattern_fingerprint(pats, [], False)
    fc2, lines2 = k1024_cluster(np, FakeCluster, n_pods=32, n_long=2)
    # The oracle in this process: 96 patterns over 8,002 lines.
    want2 = {f"{name}__c0.log": b"".join(
        ln for ln, v in zip(lines2[name], _oracle_chunk(
            tuple(pats), [ln.rstrip(b"\n") for ln in lines2[name]])) if v)
        for name in sorted(lines2)}

    def events(server) -> dict:
        fam = server.registry.family(
            "klogs_prefilter_table_cache_events_total")
        return {labels[0]: c.value for labels, c in fam.children()}

    async def scenario(d: str) -> dict:
        server = FilterServer([], backend="cpu", port=0, multi_set=True,
                              metrics_port=0)
        port = await server.start()
        res: dict = {}
        try:
            argv = ["-n", "default", "-a", *[a for p in pats
                                             for a in ("--match", p)]]
            res["rc1"] = await remote_run(
                app, cli, fc2, argv + ["-p", os.path.join(d, "1")], port)
            res["events_built"] = events(server)
            res["evicted"] = await server.tenants.evict(fp, "idle")
            res["sets_after_evict"] = server.tenants.count
            t0 = time.perf_counter()
            res["rc2"] = await remote_run(
                app, cli, fc2, argv + ["-p", os.path.join(d, "2")], port)
            res["second_run_s"] = time.perf_counter() - t0
            res["events_after"] = events(server)
            res["engine_builds"] = server.tenants.engine_builds
            res["kinds"] = server.tenants.get(fp).service._filter.engine_kinds
            res["quota_lines"] = server.tenants.quota_lines
        finally:
            await server.stop()
        return res

    with tempfile.TemporaryDirectory() as d, \
            env_set("KLOGS_TENANT_QUOTA_LINES", str(TENANT_QUOTA_LINES[0])):
        term.set_ui_stream(io.StringIO())
        try:
            ms = asyncio.run(scenario(d))
        finally:
            term.set_ui_stream(None)
        ms["mismatched_files"] = [files_equal(os.path.join(d, k), want2)
                                  for k in ("1", "2")]
    ms["patterns"] = len(pats)
    out["multi_set"] = ms
    return out


def host_c_functions(np, frame_lines, idx, lines: list) -> dict:
    """(d) the three scans of ``native/_hostops.c``, built by the loader
    in this run, each held against its plain version, both timed:
    ``dfa_scan`` on the 32 patterns' tables against ``scan_python``
    over the first 20,000 lines; ``sweep_candidates`` on the K = 1024
    index at every stage-1 tier this CPU has, with 8 and 16 buckets,
    against the numpy sweep over a 16384-line slab (cells that differ);
    ``group_scan`` against the per-group loop on that slab's candidate
    matrix (verdicts that differ)."""
    from klogs_tpu_torch import native
    from klogs_tpu_torch.filters.compiler.dfa import (
        build_dfa_cached,
        scan_python,
    )

    host = native.hostops()
    out: dict = dict(library=os.path.basename(str(native.build_info.get(
        "path", ""))), compiled_here=native.build_info.get("compiled"),
        build_s=native.build_info.get("seconds"),
        simd_level=host.sweep_simd_level(-1))
    sample = lines[:20000]
    payload, off, _ = frame_lines(sample, strip_nl=False)
    t = build_dfa_cached(PATTERNS)
    t0 = time.perf_counter()
    mask = host.dfa_scan(payload, off, len(sample), t.table.tobytes(),
                         t.n_classes, t.accept.tobytes(),
                         t.byte_class.tobytes(), t.start, t.end_class,
                         1 if t.table.dtype == np.uint32 else 0)
    c_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    plain = scan_python(t, sample)
    out["dfa_scan"] = dict(
        lines=len(sample), c_ms=c_ms,
        plain_ms=(time.perf_counter() - t0) * 1e3,
        mismatches=int(np.count_nonzero(
            np.frombuffer(mask, dtype=np.uint8).astype(bool)
            != np.array(plain))))

    payload, off, _ = frame_lines(lines[:16384])
    B = len(off) - 1
    index = idx.index
    t0 = time.perf_counter()
    ref = index.group_candidates(payload, off, impl="numpy")
    numpy_ms = (time.perf_counter() - t0) * 1e3
    W = (index.n_groups + 31) // 32
    tiers = []
    for buckets in ("8", "16"):
        with env_set("KLOGS_SWEEP_BUCKETS", buckets):
            blob = index.native_sweep_blob()
        for level in range(out["simd_level"] + 1):
            stats = np.zeros(3 + 32 * W, dtype=np.uint64)
            t0 = time.perf_counter()
            raw = host.sweep_candidates(blob, payload, off, B, level, stats)
            ms = (time.perf_counter() - t0) * 1e3
            gm = np.unpackbits(
                np.frombuffer(raw, dtype=np.uint8).reshape(B, 4 * W),
                axis=1, bitorder="little", count=index.n_groups).view(bool)
            tiers.append(dict(buckets=int(buckets), level=level, c_ms=ms,
                              survivors=int(stats[0]),
                              mismatched_cells=int(np.count_nonzero(
                                  gm != ref))))
    out["sweep_candidates"] = dict(lines=B, groups=index.n_groups,
                                   plain_ms=numpy_ms, tiers=tiers)

    gm = np.ascontiguousarray(ref)
    arr = np.frombuffer(payload, dtype=np.uint8)
    lens = np.diff(off)
    dsum = gm.sum(axis=0, dtype=np.int64)[idx._dfa_cols_arr]
    c_out = np.zeros(B, dtype=bool)
    t0 = time.perf_counter()
    cells = idx._groupscan_native(payload, off, gm, dsum, c_out)
    c_ms = (time.perf_counter() - t0) * 1e3
    p_out = np.zeros(B, dtype=bool)
    t0 = time.perf_counter()
    for g in idx._dfa_cols:
        idx._scan_group(g, gm[:, g], p_out, payload, off, arr, lens)
    out["group_scan"] = dict(
        lines=B, dfa_groups=len(idx._dfa_cols), cells=cells, c_ms=c_ms,
        plain_ms=(time.perf_counter() - t0) * 1e3,
        mismatches=int(np.count_nonzero(c_out != p_out)),
        kept=int(c_out.sum()))
    return out


def host_engines_phase(torch, np, nk, app, cli, term, FakeCluster,
                       frame_lines, dev, repo: str, card: str,
                       cuda_lps: "float | None" = None,
                       cuda_lps_1024: "float | None" = None,
                       want1024: "dict | None" = None) -> dict:
    """``--backend cpu``, the host engines, in a temporary
    ``XDG_CACHE_HOME`` (the DFA table cache starts empty): (a) the CLI
    on the cli cell (the 32 patterns: the DFA engine) and on the
    cli_k1024 cell (the 1024: the indexed engine, host sweep as a plain
    ``--backend cpu`` run has it), files against the oracle, lines/s
    beside the ``cuda`` phases' on the same corpus; (b) the indexed
    engine's device sweep on the card (``host_device_sweep``); (c)
    filterd ``--backend cpu`` (``host_filterd``); (d) the three C
    scans against their plain versions (``host_c_functions``). Every
    figure of the host engines is the host CPU's."""
    from klogs_tpu_torch import native

    with tempfile.TemporaryDirectory() as xdg, \
            env_set("XDG_CACHE_HOME", xdg):
        fc, n_lines = cli_cluster(np, FakeCluster)
        a32, _ = host_cli(app, cli, term, fc, PATTERNS,
                          oracle_files(fc.namespaces["default"]), n_lines)
        del fc
        pats = make_patterns(1024)
        fc3, all_lines = k1024_cluster(np, FakeCluster)
        if want1024 is None:
            want1024, _ = k1024_expected(pats, all_lines)
        n3 = sum(map(len, all_lines.values()))
        with env_set("KLOGS_TPU_SWEEP", "0"):
            a1024, pipe = host_cli(app, cli, term, fc3, pats, want1024, n3)
        from klogs_tpu_torch.filters.sink import _indexed_engine

        idx = _indexed_engine(pipe.log_filter)
        del pipe, fc3
        b = host_device_sweep(torch, np, nk, frame_lines, dev, pats,
                              all_lines, idx)
        c = host_filterd(np, app, cli, term, FakeCluster, repo,
                         {"XDG_CACHE_HOME": xdg})
        flat = [ln for name in sorted(all_lines) for ln in all_lines[name]]
        d = host_c_functions(np, frame_lines, idx, flat)
    a32["cuda_lines_per_s"] = cuda_lps
    a1024["cuda_lines_per_s"] = cuda_lps_1024
    res = dict(card=card, host=host_cpu(), simd_level=d["simd_level"],
               native_library=native.build_info.get("path"),
               cli=a32, cli_k1024=a1024, device_sweep=b, filterd=c,
               native=d)
    emit({"phase": "host_engines", **res})
    ms = c["multi_set"]
    built, after = ms["events_built"], ms["events_after"]
    if (a32["rc"] or a32["mismatched_files"] or a32["engine"] != "DFAFilter"
            or a1024["rc"] or a1024["mismatched_files"]
            or a1024["engine"] != "IndexedFilter"
            or a1024["sweep_path"] != "host" or a1024["index_line"] is None
            or b["mismatched_cells"] or b["mismatched_verdicts"]
            or b["mismatched_oracle"] or b["pack_launches"] < b["slabs"]
            or b["sweep_batches"].get("device") != b["slabs"]
            or b["sweep_batches"].get("host") != 1
            or c["rc"] or c["mismatched_files"]
            or ms["rc1"] or ms["rc2"] or any(ms["mismatched_files"])
            or not ms["evicted"] or ms["engine_builds"] != 2
            or not built.get("miss") or built.get("hit")
            or after.get("hit") != ms["kinds"].get("dfa")
            or after["miss"] - built["miss"] != built["miss"] - after["hit"]
            or d["dfa_scan"]["mismatches"] or d["group_scan"]["mismatches"]
            or any(t["mismatched_cells"]
                   for t in d["sweep_candidates"]["tiers"])):
        raise AssertionError(f"host_engines phase failed: {res}")
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA device", file=sys.stderr)
        return 2
    repo = root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "klogs_tpu_torch")):
        print("chip_smoke: klogs_tpu_torch/ not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    import resource

    import numpy as np

    # The follow phase holds a thousand log files open at once.
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < 4096:
        resource.setrlimit(resource.RLIMIT_NOFILE, (min(hard, 4096), hard))

    from klogs_tpu_torch import app, cli
    from klogs_tpu_torch.cluster.fake import FakeCluster, synthetic_line
    from klogs_tpu_torch.filters import gpu
    from klogs_tpu_torch.filters.base import FilterStats, frame_lines
    from klogs_tpu_torch.filters.compiler.glushkov import compile_patterns
    from klogs_tpu_torch.filters.gpu import GpuEngineFilter
    from klogs_tpu_torch.ops import (_build, bits, nfa, pack, seqscan, sweep,
                                     tune)
    from klogs_tpu_torch.ops import nfa_kernels as nk
    from klogs_tpu_torch.ui import term

    dev = torch.device("cuda", 0)
    try:
        card = card_phase(torch)
        build_phase(nk, pack, _build)
        native_phase(np, FakeCluster)
        k1, k1_batches = k1_phase(torch, np, nfa, nk, synthetic_line, dev)
        k2 = k2_phase(torch, np, nfa, nk, compile_patterns, dev)
        eng = engine_phase(torch, np, nk, GpuEngineFilter, frame_lines,
                           synthetic_line, dev)
        pk = pack_phase(torch, nk, pack, GpuEngineFilter, eng, dev)
        run = cli_phase(torch, np, nk, app, cli, term, FakeCluster, dev)
        frame0 = eng["frames"][0]
        # The fused-groups path: K4 for K1 on short lines.
        with env_set("KLOGS_TPU_FUSED_GROUPS", "1"):
            engf = engine_fused_phase(torch, np, nk, GpuEngineFilter, eng,
                                      dev)
            run4 = cli_phase(torch, np, nk, app, cli, term, FakeCluster, dev,
                             fused=True)
        del eng
        tune_phase(torch, tune, engf.pop("batch"))
        # KLOGS_TUNE=auto: the operating-point controller.
        tune_auto_phase(torch, np, nk, pack, tune, app, cli, term,
                        FakeCluster, GpuEngineFilter, FilterStats,
                        frame_lines, dev, run["lines_per_s"], card)
        # The union program of the 1024 patterns (the long-line path's)
        # has 18878 positions, past the compiler's default cap of 4096.
        os.environ["KLOGS_MAX_PATTERN_POSITIONS"] = "65536"
        sw = sweep_phase(torch, np, sweep, bits, gpu, FilterStats,
                         synthetic_line, dev)
        k3 = k3_phase(torch, nfa, bits, nk, sw)
        k4 = k4_phase(torch, nfa, nk, k1_batches, sw)
        # Past 32 words: K1's, K2g's, K3's and K4's wide kernels, the
        # cli cell of the watch-list set, the thousand-pattern path with
        # the watch list and the fused path on the watch-list set.
        wd = wide_phase(torch, np, nfa, nk, bits, gpu, compile_patterns, app,
                        cli, term, FakeCluster, synthetic_line,
                        k1_batches["s1280"], dev)
        del k1_batches
        # Past 160 words: the shared-memory kernels.
        w160 = wide160_phase(torch, np, nfa, nk, bits, gpu, compile_patterns,
                             app, cli, term, FakeCluster, synthetic_line, dev)
        k2g = grouped_chunk_phase(torch, np, nfa, nk, compile_patterns,
                                  sw["eng"], dev)
        seqscan_phase(torch, np, nfa, seqscan, compile_patterns,
                      GpuEngineFilter, dev)
        ek = engine_k1024_phase(torch, np, nk, gpu, frame_lines,
                                synthetic_line, sw["eng"], dev)
        k4_b256_check(torch, nk, k4, ek.pop("b256"))
        run3 = cli_k1024_phase(torch, np, nk, bits, app, cli, term,
                               FakeCluster, dev)
        # The observability and fault layers on the K = 32 path, and
        # once on the K = 1024 one.
        want1024 = run3.pop("want")
        # The mesh engine: data x pattern shards on the card listed
        # several times, the CLI through it, and across processes.
        ms = mesh_phase(torch, np, nk, bits, pack, app, cli, term,
                        FakeCluster, GpuEngineFilter, frame_lines,
                        synthetic_line, frame0, sw["eng"], dev, repo, card,
                        want1024)
        obs_phase(torch, np, nk, app, cli, term, FakeCluster,
                  GpuEngineFilter, FilterStats, frame0, dev, card,
                  want1024)
        del frame0
        # Follow mode: many small deadline-driven batches.
        follow_phase(torch, np, nk, pack, app, cli, term, FakeCluster,
                     synthetic_line, dev, card)
        kube_follow_phase(torch, np, nk, pack, app, cli, term, dev, card)
        # The log sources: archive backfill, replay and the socket.
        root = tempfile.mkdtemp(prefix="klogs-sources-")
        try:
            bf = backfill_phase(torch, np, nk, pack, bits, app, cli, term,
                                synthetic_line, dev, root, card)
            sources_phase(torch, np, nk, app, cli, term, dev, root, bf, card)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        bfr = bf["runs"]
        # filterd: the remote filter service on the card, deployed as its
        # own process, and in this one for the kernels' batches.
        fd = filterd_phase(torch, np, nk, pack, bits, app, cli, term,
                           FakeCluster, GpuEngineFilter, frame_lines,
                           synthetic_line, dev, repo, card,
                           run["lines_per_s"])
        # The sharded tier and the multi-set registry: a fleet of
        # filterd processes, and a registry in this process.
        reg = fleet_phase(torch, np, nk, pack, bits, sweep, app, cli, term,
                          FakeCluster, dev, repo, card,
                          fd["cell"]["lines_per_s"])["registry"]
        fl, fl_k2g = reg["launches"], reg["k2g_batches"]
        del reg
        # --backend cpu: the host engines, and the indexed engine's
        # sweep on the card.
        he = host_engines_phase(torch, np, nk, app, cli, term, FakeCluster,
                                frame_lines, dev, repo, card,
                                run["lines_per_s"], run3["lines_per_s"],
                                want1024)["device_sweep"]["launches"]
        del want1024
    except Exception:
        traceback.print_exc()
        emit({"phase": "failed"})
        return 1
    w, c, g = k1["w128"], k2["s512"], run3["k3_batches"][0]
    f, cc = run4["k4_batches"][0], run["k2_batches"][0]
    vw, gc3 = k2g["vs_wide"], run3["k2g_batches"][0]
    ww, wv, wc = wd["watch_w128"], wd["k2g_vs_wide"], wd["cli"]
    k3w, c3w, f4w = wd["k1025"], wd["cli_k1025"], wd["cli_fused"]
    # Past 160 words: the shared-memory kernels (wide160).
    sw_, sv, sc = w160["watch_w128"], w160["k2g_vs_wide"], w160["cli"]
    s3, sc3, sf4 = w160["k64w"], w160["cli_k64w"], w160["cli_fused"]
    k2g_held = ([r for k, r in k2g.items() if k != "vs_wide"] + [vw]
                + run3["k2g_batches"] + ek["k2g_batches"]
                + bfr["c"]["k2g_batches"] + ms["k2g"] + fl_k2g)
    emit({"kernels": [
        {"name": nk.GROUPED, "route": "cuda", "source": SOURCE,
         "replaces": "klogs_tpu/ops/pallas_nfa.py:200",
         "launches": run["launches"][nk.GROUPED],
         "backfill_launches": bfr["a"]["launches"][nk.GROUPED],
         "fleet_launches": fl[nk.GROUPED],
         "mesh_launches": ms[nk.GROUPED],
         "max_abs_err": float(max(w["max_abs_err"],
                                  ms["k1"]["max_abs_err"])), "ms": w["ms"],
         "plain_ms": w["plain_ms"], "bound_ms": w["bound_ms"],
         "bound_by": w["bound_by"], "library_ms": None},
        {"name": nk.CHUNK, "route": "cuda", "source": SOURCE,
         "replaces": "klogs_tpu/ops/pallas_nfa.py:50",
         "launches": run["launches"][nk.CHUNK],
         "backfill_launches": bfr["a"]["launches"][nk.CHUNK],
         "fleet_launches": fl[nk.CHUNK],
         "max_abs_err": float(max(r["max_abs_err"] for r in
                                  list(k2.values()) + run["k2_batches"]
                                  + run4["k2_batches"])),
         "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
         "bound_by": c["bound_by"], "library_ms": None,
         "cli_ms": cc["ms"], "cli_shape": f"{cc['rows']}x{cc['T']}",
         "k1024_wide_ms": vw["wide_ms"]},
        {"name": nk.GROUPED_CHUNK, "route": "cuda", "source": SOURCE,
         "replaces": "klogs_tpu/ops/pallas_nfa.py:50",
         "launches": run3["launches"][nk.GROUPED_CHUNK],
         "engine_launches": ek["launches"][nk.GROUPED_CHUNK],
         "backfill_launches": bfr["c"]["launches"][nk.GROUPED_CHUNK],
         "fleet_launches": fl[nk.GROUPED_CHUNK],
         "mesh_launches": ms[nk.GROUPED_CHUNK],
         "max_abs_err": float(max(r["max_abs_err"] for r in k2g_held)),
         "ms": vw["ms"], "plain_ms": vw["plain_ms"],
         "bound_ms": vw["bound_ms"], "bound_by": vw["bound_by"],
         "library_ms": None, "us_per_step": vw["us_per_step"],
         "shape": f"{vw['lines']}x4096, {vw['groups']} groups",
         "wide_ms": vw["wide_ms"], "cli_ms": gc3["ms"],
         "cli_shape": f"{gc3['rows']}x{gc3['T']}"},
        {"name": nk.GROUPED_WIDE, "route": "cuda", "source": SOURCE,
         "replaces": "klogs_tpu/ops/pallas_nfa.py:200",
         "launches": wc["launches"][nk.GROUPED_WIDE],
         "main_path": "wide (c): the cli cell with --match x33",
         "max_abs_err": float(max(r["max_abs_err"] for r in
                                  [ww, wd["s1280"]] + wc["k1_batches"])),
         "ms": ww["held_ms"], "plain_ms": ww["plain_ms"],
         "bound_ms": ww["bound_ms"], "bound_by": ww["bound_by"],
         "library_ms": None, "bytes_ms": ww["bytes_ms"],
         "shape": f"{ww['plain_rows']}x{ww['T']}, {ww['groups']} groups of "
                  f"{ww['states']} states",
         "full_ms": ww["ms"], "kernel_ms": ww["kernel_ms"],
         "full_shape": f"{ww['rows']}x{ww['T']}",
         "k4_wide_ms": ww["k4_ms"], "register_ms": ww["register_ms"],
         "s1280_ms": wd["s1280"]["ms"],
         "s1280_bound_ms": wd["s1280"]["bound_ms"],
         "s1280_k4_wide_ms": wd["s1280"]["k4_ms"]},
        {"name": nk.GROUPED_CHUNK_WIDE, "route": "cuda", "source": SOURCE,
         "replaces": "klogs_tpu/ops/pallas_nfa.py:50",
         "launches": wc["launches"][nk.GROUPED_CHUNK_WIDE],
         "main_path": "wide (c): the cli cell with --match x33",
         "max_abs_err": float(max(r["max_abs_err"] for r in
                                  [wv] + wc["k2g_batches"])),
         "ms": wv["ms"], "plain_ms": wv["plain_ms"],
         "bound_ms": wv["bound_ms"], "bound_by": wv["bound_by"],
         "library_ms": None, "bytes_ms": wv["bytes_ms"],
         "us_per_step": wv["us_per_step"],
         "shape": f"{wv['lines']}x4096, {wv['groups']} groups",
         "wide_ms": wv["wide_ms"],
         "chunk_nfa_launches": wc["launches"][nk.CHUNK]},
        {"name": nk.GATED_WIDE, "route": "cuda", "source": SOURCE,
         "replaces": "klogs_tpu/ops/pallas_nfa.py:377",
         "launches": c3w["launches"][nk.GATED_WIDE],
         "main_path": "wide (e): the cli_k1024 cell with --match x1025",
         "max_abs_err": float(max(b["max_abs_err"] for b in
                                  [k3w] + c3w["k3_batches"])),
         "ms": k3w["held_ms"], "plain_ms": k3w["plain_ms"],
         "bound_ms": k3w["bound_ms"], "bound_by": k3w["bound_by"],
         "library_ms": None, "bytes_ms": k3w["bytes_ms"],
         "shape": f"{k3w['plain_rows']}x{k3w['T']}, {k3w['groups']} groups "
                  f"of {k3w['states']} states, {k3w['held_pairs']} pairs",
         "full_ms": k3w["ms"], "kernel_ms": k3w["kernel_ms"],
         "wrapper_ms": k3w["wrapper_ms"],
         "pairs_ms": k3w["pairs_ms"], "pairs": k3w["pairs"],
         "pairs_launches": c3w["launches"][nk.PAIRS],
         "full_shape": f"{k3w['rows']}x{k3w['T']}",
         "cli_ms": c3w["k3_batches"][0]["ms"],
         "cli_shape": "{rows}x{T}".format(**c3w["k3_batches"][0]),
         "register_launches": c3w["launches"][nk.GATED]},
        {"name": nk.FUSED_WIDE, "route": "cuda", "source": SOURCE,
         "replaces": "klogs_tpu/ops/pallas_nfa.py:334",
         "launches": f4w["launches"][nk.FUSED_WIDE],
         "main_path": "wide (f): the cli cell with --match x33 under "
                      "KLOGS_TPU_FUSED_GROUPS=1",
         "max_abs_err": float(max([ww["k4_max_abs_err"],
                                   wd["s1280"]["k4_max_abs_err"]]
                                  + [b["max_abs_err"]
                                     for b in f4w["k4_batches"]])),
         "ms": ww["held_k4_ms"], "plain_ms": ww["plain_ms"],
         "bound_ms": ww["bound_ms"], "bound_by": ww["bound_by"],
         "library_ms": None,
         "shape": f"{ww['plain_rows']}x{ww['T']}, {ww['groups']} groups of "
                  f"{ww['states']} states",
         "full_ms": ww["k4_ms"], "kernel_ms": ww["k4_kernel_ms"],
         "k1_ms": ww["ms"], "k1_kernel_ms": ww["kernel_ms"],
         "full_shape": f"{ww['rows']}x{ww['T']}",
         "s1280_ms": wd["s1280"]["k4_ms"],
         "s1280_kernel_ms": wd["s1280"]["k4_kernel_ms"],
         "s1280_bound_ms": wd["s1280"]["bound_ms"],
         "k1_launches": f4w["launches"][nk.GROUPED_WIDE]},
        {"name": nk.GROUPED_SMEM, "route": "cuda", "source": SOURCE,
         "replaces": "klogs_tpu/ops/pallas_nfa.py:200",
         "launches": sc["launches"][nk.GROUPED_SMEM],
         "main_path": "wide160 (c): the cli cell with --match x33 (700 pods)",
         "max_abs_err": float(max(r["max_abs_err"] for r in
                                  [sw_] + sc["k1_batches"])),
         "ms": sw_["held_ms"], "plain_ms": sw_["plain_ms"],
         "bound_ms": sw_["bound_ms"], "bound_by": sw_["bound_by"],
         "library_ms": None, "bytes_ms": sw_["bytes_ms"],
         "shape": f"{sw_['plain_rows']}x{sw_['T']}, {sw_['groups']} groups "
                  f"of {sw_['states']} states",
         "full_ms": sw_["ms"], "kernel_ms": sw_["kernel_ms"],
         "full_shape": f"{sw_['rows']}x{sw_['T']}",
         "cli_ms": sc["k1_batches"][0]["ms"],
         "cli_shape": "{rows}x{T}".format(**sc["k1_batches"][0])},
        {"name": nk.GROUPED_CHUNK_SMEM, "route": "cuda", "source": SOURCE,
         "replaces": "klogs_tpu/ops/pallas_nfa.py:50",
         "launches": sc["launches"][nk.GROUPED_CHUNK_SMEM],
         "main_path": "wide160 (c): the cli cell with --match x33 (700 pods)",
         "max_abs_err": float(max(r["max_abs_err"] for r in
                                  [sv] + sc["k2g_batches"])),
         "ms": sv["ms"], "plain_ms": sv["plain_ms"],
         "bound_ms": sv["bound_ms"], "bound_by": sv["bound_by"],
         "library_ms": None, "bytes_ms": sv["bytes_ms"],
         "us_per_step": sv["us_per_step"],
         "shape": f"{sv['lines']}x4096, {sv['groups']} groups",
         "wide_ms": sv["wide_ms"], "union_states": sv["union_states"],
         "chunk_nfa_launches": sc["launches"][nk.CHUNK]},
        {"name": nk.GATED_SMEM, "route": "cuda", "source": SOURCE,
         "replaces": "klogs_tpu/ops/pallas_nfa.py:377",
         "launches": sc3["launches"][nk.GATED_SMEM],
         "main_path": "wide160 (e): the cli_k1024 cell with --match x65 "
                      "(make_patterns(64) and the 700 pods)",
         "max_abs_err": float(max(b["max_abs_err"] for b in
                                  [s3] + sc3["k3_batches"])),
         "ms": s3["held_ms"], "plain_ms": s3["plain_ms"],
         "bound_ms": s3["bound_ms"], "bound_by": s3["bound_by"],
         "library_ms": None, "bytes_ms": s3["bytes_ms"],
         "shape": f"{s3['plain_rows']}x{s3['T']}, {s3['groups']} groups of "
                  f"{s3['states']} states, {s3['held_pairs']} pairs",
         "full_ms": s3["ms"], "kernel_ms": s3["kernel_ms"],
         "wrapper_ms": s3["wrapper_ms"],
         "pairs_ms": s3["pairs_ms"], "pairs": s3["pairs"],
         "full_shape": f"{s3['rows']}x{s3['T']}",
         "cli_ms": sc3["k3_batches"][0]["ms"],
         "cli_shape": "{rows}x{T}".format(**sc3["k3_batches"][0])},
        {"name": nk.FUSED_SMEM, "route": "cuda", "source": SOURCE,
         "replaces": "klogs_tpu/ops/pallas_nfa.py:334",
         "launches": sf4["launches"][nk.FUSED_SMEM],
         "main_path": "wide160 (f): the cli cell with --match x33 (700 "
                      "pods) under KLOGS_TPU_FUSED_GROUPS=1",
         "max_abs_err": float(max([sw_["k4_max_abs_err"]]
                                  + [b["max_abs_err"]
                                     for b in sf4["k4_batches"]])),
         "ms": sw_["held_k4_ms"], "plain_ms": sw_["plain_ms"],
         "bound_ms": sw_["bound_ms"], "bound_by": sw_["bound_by"],
         "library_ms": None,
         "shape": f"{sw_['plain_rows']}x{sw_['T']}, {sw_['groups']} groups "
                  f"of {sw_['states']} states",
         "full_ms": sw_["k4_ms"], "kernel_ms": sw_["k4_kernel_ms"],
         "k1_ms": sw_["ms"],
         "full_shape": f"{sw_['rows']}x{sw_['T']}",
         "cli_ms": sf4["k4_batches"][0]["ms"],
         "cli_shape": "{rows}x{T}".format(**sf4["k4_batches"][0]),
         "k1_launches": sf4["launches"][nk.GROUPED_SMEM]},
        {"name": nk.GATED, "route": "cuda", "source": SOURCE,
         "replaces": "klogs_tpu/ops/pallas_nfa.py:377",
         "launches": run3["launches"][nk.GATED],
         "backfill_launches": bfr["c"]["launches"][nk.GATED],
         "fleet_launches": fl[nk.GATED],
         "mesh_launches": ms[nk.GATED],
         "max_abs_err": float(max(b["max_abs_err"] for b in
                                  [g, k3["sweep_gate"], k3["random_gate"],
                                   k3["sparse_gate"], k3["full"],
                                   ms["k3"]])),
         "ms": g["ms"], "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
         "bound_by": g["bound_by"], "library_ms": None,
         "wrapper_ms": g["wrapper_ms"], "pairs_ms": g["pairs_ms"],
         "pairs": g["pairs"], "pairs_launches": run3["launches"][nk.PAIRS],
         "pairs_mismatches": max(b["pairs_mismatches"] for b in
                                 [g, k3["sweep_gate"], k3["random_gate"],
                                  k3["sparse_gate"], k3["full"],
                                  ms["k3"]])},
        {"name": nk.FUSED, "route": "cuda", "source": SOURCE,
         "replaces": "klogs_tpu/ops/pallas_nfa.py:334",
         "launches": run4["launches"][nk.FUSED],
         "fleet_launches": fl[nk.FUSED],
         "max_abs_err": float(max(b["max_abs_err"] for b in
                                  run4["k4_batches"] + list(k4.values()))),
         "ms": f["ms"], "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
         "bound_by": f["bound_by"], "library_ms": None, "k1_ms": f["k1_ms"]},
        {"name": nk.PACK_CLS, "route": "cuda", "source": pk["source"],
         "replaces": pk["replaces"], "launches": run["launches"][nk.PACK_CLS],
         "engine_launches": pk["launches"],
         "backfill_launches": bfr["a"]["launches"][nk.PACK_CLS],
         "fleet_launches": fl[nk.PACK_CLS],
         "mesh_launches": ms[nk.PACK_CLS],
         "max_abs_err": max(pk["max_abs_err"],
                            float(ms["pack"]["mismatches"])),
         "ms": pk["ms"], "plain_ms": pk["plain_ms"],
         "bound_ms": pk["bound_ms"], "bound_by": pk["bound_by"],
         "library_ms": None, "pair_ms": pk["pair_ms"],
         "kernel_ms": pk["kernel_ms"], "flat_kernel_ms": pk["flat_kernel_ms"],
         "shape": "{rows}x{T}".format(**max(pk["buckets"],
                                            key=lambda b: b["rows"]))},
        {"name": nk.PACK, "route": "cuda", "source": pk["source"],
         "replaces": pk["replaces"], "launches": he[nk.PACK],
         "main_path": "host_engines (b): the indexed engine's device sweep",
         "max_abs_err": pk["pack_rows"]["max_abs_err"],
         "ms": pk["pack_rows"]["ms"], "plain_ms": pk["pack_rows"]["plain_ms"],
         "bound_ms": pk["pack_rows"]["bound_ms"],
         "bound_by": pk["pack_rows"]["bound_by"], "library_ms": None},
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
