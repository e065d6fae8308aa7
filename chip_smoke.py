#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (klogs_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper
card and nvcc (``/usr/local/cuda`` or CUDA_HOME):

    python3 chip_smoke.py

It builds the CUDA kernels from ``klogs_tpu_torch/ops/csrc`` (one nvcc
per source, all at once) and runs these phases, each printing one JSON
line. Every phase that drives an entry point (engine, cli and their
fused and thousand-pattern variants) fails unless its short rows and
long-line chunks went through the ragged pack (``pack_rows``): the
payload crosses to the card once per batch and is cut into rows there.

1. card: the card's name and power limit (nvidia-smi), torch and CUDA.
2. grouped_nfa_kernel against its plain PyTorch version on the
   32-pattern program (4 groups x 128 states, 64 classes): 131072 rows
   at the 128-byte width bucket and 4096 rows at the 4096 bucket, plus a
   256-state group and a program wider than 1024 states. Exact equality.
3. chunk_nfa_kernel against its plain version on the 512-state union
   program: 1024 lines of 4 KiB to 128 KiB chained chunk by chunk (some
   ending exactly on a chunk edge), a 640-state union program (run
   padded to 1024 states) and one wider than 1024 states. Matched flags
   and carries must be equal; each case prints ms per launch and µs per
   step.
4. engine: GpuEngineFilter on 1M synthetic log lines and 2000 long
   lines (4 KiB to 192 KiB); verdicts equal a Python ``re`` oracle.
5. pack: pack_rows against its plain version, byte for byte, on what
   the engine stages for the engine phase's first frame (every width
   bucket) and for its long frame (every 4096-byte chunk), both timed,
   with the bound.
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
13. engine_k1024: GpuEngineFilter on 1M FakeCluster lines (1% needles)
   and 256 lines of 4-64 KiB; verdicts equal a K1-only engine's on the
   short lines (that engine timed too) and a Python ``re`` oracle (one
   alternation of the 1024 patterns) on the first 65536 lines and all
   long ones.
14. cli_k1024: ``app.run_async`` over 256 pods x 250 lines plus 8 long
   lines with ``--match`` x1024, ``--stats`` and ``-p`` a temporary
   directory: this path's main run (counts zeroed just before, read
   just after; K3 must launch), every file equal to the oracle's lines
   and the ``prefilter:`` stats line printed. Then K3 is held against
   its plain version and timed on the run's own most frequent batch
   (its pair list held against the plain one there too).

The observability and fault layers, after them:

15. obs: the cli cell (256 pods x 4000 lines, 16 long lines, --match
   x32) run four times, with ``--stats-json``, ``--trace-json``,
   ``--profile-json`` and ``--metrics-port`` off, on, on, off: every
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
   ``pack_rows_kernel``.

Follow mode (BASELINE config 4), after them:

16. follow: ``app.run_async`` with ``-a -f --match`` x32 ``--stats``
   over 1000 fixed-clock FakeCluster streams offering a line every 10
   ms each (100,000 lines/s in all; 8 backlogs hold a 5-180 KiB line),
   stopped after 20 s through ``stop``: every file equal to the
   oracle's selection of exactly the lines its stream sent (regenerated
   from ``next_seq``); offered and sustained lines/s, the --stats
   latencies, the deadline flushes, device batches and lines a batch,
   the device busy share of one profiled second, and each matching
   line's emission-to-file latency on 8 tailed streams. K1 is held
   against its plain version on 8 of the run's batches, K2 and
   ``pack_rows`` on one each (counts zeroed just before the run).
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
   patterns over the gzip sets (the gated path). Each run: every file
   equal to the ``re`` oracle's selection in rotated order, lines/s,
   device batches, K1 (or K3), K2 and ``pack_rows`` held against their
   plain versions on the run's own batches (counts zeroed just before
   the run), then a backfill of each set's oldest generation under
   cProfile with a 1 s torch.profiler window (the device's busy share).
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
   channel (``tools/bench_service.py``'s shape), 3 s each, every
   verdict equal to the in-process engine's: lines/s and lines a device
   batch; (c) an in-process filterd on the card with one collector (32
   pods x 4000 lines + 4 long lines): K1, K2 and ``pack_rows`` held
   against their plain versions on the batches it built, then at the
   1024 patterns Hello's ``device_sweep``, a collector of 64 pods x 250
   lines (files = oracle) and K3 with its pair list held on its most
   frequent batch; (d) a collector under
   ``KLOGS_FAULTS=rpc.match:error*2`` (exact files, 2 faults and 2
   retries in its --stats-json), then a collector process whose
   filterd is killed mid-run: ``--on-filter-error abort`` exits 1 with
   one error line, ``pass`` writes the lines after the kill unfiltered
   and counts them.

Then a ``kernels`` line (each kernel's time beside its bound and its
plain version's time, with its launches on its main path and on the
backfill: the four NFA kernels and ``pack_rows``), the card line, and
last ``{"ok": true,
"device": {...}}``. Any failed phase exits
non-zero without that line, as does a run with no CUDA device or
outside a checkout.
"""

import asyncio
import concurrent.futures
import contextlib
import functools
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


def emit(obj: dict) -> None:
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


def k1_check(torch, nk, dp, live, acc, cls, reps: int) -> dict:
    """Kernel vs plain on one cls batch, timed, with its bounds."""
    got = nk.match_cls_grouped(dp, live, acc, cls)
    work: dict = {}
    exp = nk.match_cls_grouped_plain(dp, live, acc, cls, work=work)
    torch.cuda.synchronize()
    err = int((got.int() - exp.int()).abs().max()) if len(got) else 0
    ms = cuda_ms(torch, lambda: nk.match_cls_grouped(dp, live, acc, cls), reps)
    plain_ms = cuda_ms(
        torch, lambda: nk.match_cls_grouped_plain(dp, live, acc, cls), 1)
    B, T = cls.shape
    G, C, S = dp.char_mask.shape
    n_bytes = B * T * 2 + G * (S + C) * (S // 32) * 4 + B
    return dict(rows=B, T=T, states=S, groups=G, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, matched=int(exp.sum()),
                active_per_step=work["active"] / (B * G * T),
                exc_per_step=work["exc"] / (B * G * T),
                **step_bounds(n_bytes, S, C, B * G * T, work["active"]))


def k4_check(torch, nk, dp, live, acc, cls, reps: int,
             time_plain: bool = False, step: "int | None" = None) -> dict:
    """K4 against its plain version (over slices of ``step`` rows) and
    against K1 on one cls batch; K1 and K4 timed in turns, each beside
    the bounds of K1's function (K4 computes it over the same bytes).
    ``plain_ms`` only with ``time_plain``."""
    got = nk.match_cls_grouped_fused(dp, live, acc, cls)
    k1 = nk.match_cls_grouped(dp, live, acc, cls)
    B, T = cls.shape
    step = step or B
    work: dict = {}
    err = 0
    for i in range(0, B, step):
        exp = nk.match_cls_grouped_fused_plain(dp, live, acc,
                                               cls[i:i + step], work=work)
        err = max(err, int((got[i:i + step].int() - exp.int()).abs().max()))
    torch.cuda.synchronize()
    k1_ms = cuda_ms(torch, lambda: nk.match_cls_grouped(dp, live, acc, cls),
                    reps)
    ms = cuda_ms(torch, lambda: nk.match_cls_grouped_fused(dp, live, acc,
                                                           cls), reps)
    G, C, S = dp.char_mask.shape
    n_bytes = B * T * 2 + G * (S + C) * (S // 32) * 4 + B * 4
    res = dict(rows=B, T=T, states=S, groups=G, max_abs_err=err,
               k1_mismatches=int((got != k1).sum()), ms=ms, k1_ms=k1_ms,
               matched=int(got.sum()), active_per_step=work["active"]
               / (B * G * T), exc_per_step=work["exc"] / (B * G * T),
               **step_bounds(n_bytes, S, C, B * G * T, work["active"]))
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
    # A 256-state group (register path, W=8) and a 1280-state group (the
    # shared-memory "wide" path).
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
    vp, mp = nk.match_chunk_cls_plain(prog, acc, cls, v0, work=work)
    if final and prog.match_all:
        mp = torch.ones_like(mp)
    torch.cuda.synchronize()
    err = max(int((v.int() - vp.int()).abs().max()),
              int((m.int() - mp.int()).abs().max()))
    ms = cuda_ms(torch, lambda: nk.match_chunk_cls(prog, acc, cls, v0, final),
                 reps)
    plain_ms = cuda_ms(
        torch, lambda: nk.match_chunk_cls_plain(prog, acc, cls, v0), 1)
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
        m = re.search(r"\w*(?:nfa|gate_pairs|pack_rows)\w*(?:<[^>]*>)?", k)
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
                 dev, n_short=1 << 20, n_long=2000, batch=131072) -> dict:
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
            or launches[nk.CHUNK] == 0 or launches[nk.PACK] == 0):
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


def pack_phase(torch, nk, pack, GpuEngineFilter, base, dev) -> dict:
    """The ragged pack against its plain version on what the engine phase
    staged: every width bucket of its first frame, and every chunk of its
    long frame, on the engine's own metadata and device payload. Any
    mismatch fails. ``launches`` are the engine phase's."""
    eng = GpuEngineFilter(PATTERNS, device=dev)
    L = eng._chunk_bytes
    buckets, chunks = [], []
    for frame in (base["frames"][0], base["long_frame"]):
        layout, meta = eng._layout(*frame)
        meta_d, payload_d = eng._stage(frame[0], meta)
        at = 0
        for idx, width, rows, longest in layout:
            starts, lens = meta_d[at:at + rows], meta_d[at + rows:at + 2 * rows]
            at += 2 * rows
            if width is not None:
                buckets.append(dict(lines=len(idx), **pack_check(
                    torch, pack, payload_d, starts, lens, width, rows, 0, 20)))
                continue
            for k in range(-(-longest // L)):
                chunks.append(pack_check(torch, pack, payload_d, starts, lens,
                                         L, rows, k * L, 5))
    long_sum = {key + "_sum": sum(c[key] for c in chunks)
                for key in ("mismatches", "ms", "plain_ms", "bound_ms")}
    main = max(buckets, key=lambda b: b["rows"])
    res = dict(name=nk.PACK, route="cuda",
               source="klogs_tpu_torch/ops/csrc/pack_kernels.cu",
               replaces="klogs_tpu/native/_hostops.c:593",
               launches=base["launches"][nk.PACK],
               max_abs_err=float(max(b["mismatches"] for b in buckets + chunks)),
               ms=main["ms"], plain_ms=main["plain_ms"],
               bound_ms=main["bound_ms"], bound_by=main["bound_by"],
               library_ms=None, buckets=buckets,
               long_chunks=dict(rows=chunks[0]["rows"], width=L,
                                chunks=len(chunks), **long_sum))
    emit({"phase": "pack", **res})
    if res["max_abs_err"] or not chunks:
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
            or launches[nk.PACK] == 0
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
            or launches[nk.CHUNK] == 0 or launches[nk.PACK] == 0
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
                       "pack_rows_kernel")}
    res = dict(rc=rc, lines=n_lines, trace_files=traces,
               kernel_events=sum(kernels.values()), named=named,
               mismatched_files=files_equal(os.path.join(out, "logs"), want))
    res["ok"] = (rc == 0 and bool(traces) and all(named.values())
                 and not res["mismatched_files"])
    return res


def obs_phase(torch, np, nk, app, cli, term, FakeCluster, GpuEngineFilter,
              FilterStats, frame, dev, card: str, want_k: dict) -> dict:
    """The observability and fault layers on the card: the cli cell run
    with the flags off, on, on, off (lines/s and the overhead); what the
    files of an "on" run hold, and a mid-run scrape; the K = 1024 cell
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
        for i, on in enumerate((False, True, True, False)):
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
        overhead = 100.0 * (1.0 - (sum(on_) / 2) / (sum(off) / 2))
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
            1.0 - no_file["lines_per_s"] / (sum(off) / 2))
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
    exp = nk.match_cls_grouped_gated_plain(dp, live, acc, cls, words,
                                           work=work)
    torch.cuda.synchronize()
    err = int((got.int() - exp.int()).abs().max()) if len(got) else 0
    parts = k3_parts(torch, nk, dp, live, acc, cls, words, reps)
    wrapper_ms = cuda_ms(torch, lambda: nk.match_cls_grouped_gated(
        dp, live, acc, cls, words), reps)
    plain_ms = cuda_ms(torch, lambda: nk.match_cls_grouped_gated_plain(
        dp, live, acc, cls, words), 1)
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
    t0 = time.perf_counter()
    eng = gpu.GpuEngineFilter(pats, device=dev, stats=FilterStats())
    build_s = time.perf_counter() - t0
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
               factors=int(st.fac_len.numel()), build_s=build_s, ms=ms,
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
                       dev, n_short=1 << 20,
                       n_long=256, batch=131072, checked=65536) -> dict:
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
    t0 = time.perf_counter()
    long_v = eng.fetch_framed(eng.dispatch_framed(*long_frame))
    t_long = time.perf_counter() - t0
    launches = dict(nk.LAUNCHES)
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
               k1_only_device_ms=k1_prof["device_ms"])
    emit({"phase": "engine_k1024", **res})
    if (bad or vs_k1 or short_launches[nk.GATED] == 0
            or short_launches[nk.PAIRS] == 0 or short_launches[nk.PACK] == 0
            or short_launches[nk.GROUPED] != 0 or launches[nk.CHUNK] == 0
            or not got.any()):
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


def cli_k1024_phase(torch, np, nk, bits, app, cli, term, FakeCluster, dev,
                    n_pods=256, lines_per_pod=250, n_long=8) -> dict:
    pats = make_patterns(1024)
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

    with tempfile.TemporaryDirectory() as out_dir:
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
    res = dict(rc=rc, pods=len(pods), files=files, lines=len(flat),
               kept_lines=kept, seconds=seconds,
               lines_per_s=len(flat) / seconds, mismatched_files=bad,
               launches=launches, prefilter_line=pf_line,
               k3_shapes={f"{B}x{T}": e[0] for (B, T), e in shapes.items()},
               k3_batches=k3_batches)
    emit({"phase": "cli_k1024", **res})
    res["want"] = want
    if (rc != 0 or bad or files != len(pods) or not kept
            or launches[nk.GATED] == 0 or launches[nk.PAIRS] == 0
            or launches[nk.PACK] == 0
            or launches[nk.GROUPED] != 0 or pf_line is None or not k3_batches
            or any(b["max_abs_err"] or b["pairs_mismatches"]
                   for b in k3_batches)):
        raise AssertionError(f"cli_k1024 phase failed: {res}")
    return res


# ---- follow mode ---------------------------------------------------------


@contextlib.contextmanager
def recording_wrappers(nk, pack, names: list):
    """For the block, each wrapper named (``nfa_kernels`` ones, and
    ``pack_rows``) records its calls: yields ``{name: {shapes: [count,
    [(args, kwargs), ...]]}}``, keeping the first 8 calls of each shape
    of its tensor arguments. The wrappers are restored after."""
    calls: dict = {n: {} for n in names}
    saved = {}
    for n in names:
        mod = pack if n == "pack_rows" else nk
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
    down), K2 on a batch of its most frequent chunk shape, ``pack_rows``
    on a cut of its most frequent shape. ``launches`` is the run's count
    of the batch's shape."""
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
    out["pack_batches"] = [
        dict(launches=c, **pack_check(
            torch, pack, *a[:5], a[5] if len(a) > 5 else kw.get("skip", 0),
            10))
        for c, a, kw in top("pack_rows", 1)]
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
                 interval=0.01, seconds=20.0, n_long=8, n_tailed=8) -> dict:
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
                                          "pack_rows"]) as calls:
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
            or launches[nk.PACK] == 0 or len(res["k1_batches"]) < 8
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
                    nk, pack, ["match_cls_grouped", "pack_rows"]) as calls:
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
            or launches[nk.GROUPED] == 0 or launches[nk.PACK] == 0
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
    names = ["match_cls_grouped", "match_chunk_cls", "pack_rows",
             "match_cls_grouped_gated"]
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
    oracle's selection in rotated order; K1, K2, pack_rows and at K =
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
    # the lines, no long line): at K = 1024 the 16 long lines alone take
    # about a minute of K2 (PERF.md).
    oldest_gz = [os.path.join(gz, "app-*.log.2.gz")]
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
                       "k1024_gzip", [gz], k1024,
                       expected_files(corpus, v1024, names("gz")), total,
                       oldest_gz))
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
        need = ([nk.GATED, nk.PAIRS] if key == "c" else [nk.GROUPED])
        held = r["k1_batches"] + r["k2_batches"] + r["pack_batches"] \
            + r["k3_batches"]
        if (r["rc"] != 0 or r["mismatched_files"] or r["files"] != n_sets
                or not r["kept_lines"] or not r["counts_ok"]
                or r["summary"] is None or r["profile"]["rc"] != 0
                or any(r["launches"][k] == 0
                       for k in need + [nk.CHUNK, nk.PACK])
                or (key != "c" and not r["k1_batches"])
                or (key == "c" and not r["k3_batches"])
                or not r["k2_batches"] or not r["pack_batches"]
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
            or r["launches"][nk.GROUPED] == 0 or r["launches"][nk.PACK] == 0
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
    """A sample of a --stats-json dump (0 when absent)."""
    for s in doc["metrics"].get(name, {}).get("samples", []):
        if s.get("labels", {}) == labels:
            return s["value"]
    return 0.0


@contextlib.contextmanager
def filterd_process(root: str, patterns: list, limit: float = 240.0):
    """``python -m klogs_tpu_torch.service --backend cuda --match ...
    --port 0 --metrics-port 0`` in a process of its own, as it is
    deployed: yields {proc, port, metrics_port, banner, stderr} once
    the banner named both ports and /readyz answered 200 (the warmup
    batch went through the card). The process is terminated after the
    block; if it died first, or does not come up, this raises with its
    stderr printed."""
    argv = [sys.executable, "-m", "klogs_tpu_torch.service", "--backend",
            "cuda", "--port", "0", "--metrics-port", "0"]
    for p in patterns:
        argv += ["--match", p]
    err = tempfile.NamedTemporaryFile(prefix="filterd-", suffix=".err",
                                      delete=False)
    proc = subprocess.Popen(argv, cwd=root, stdout=subprocess.PIPE,
                            stderr=err, text=True)
    lines: list = []

    def read_stdout() -> None:
        for ln in iter(proc.stdout.readline, ""):
            lines.append(ln)

    reader = threading.Thread(target=read_stdout, daemon=True)
    reader.start()
    box: dict = dict(proc=proc, stderr=err.name)

    def stderr_text() -> str:
        with open(err.name, errors="replace") as f:
            return f.read()[-8000:]

    def died(what: str) -> AssertionError:
        print(f"filterd ({what}); its stderr:\n{stderr_text()}",
              file=sys.stderr, flush=True)
        return AssertionError(f"filterd {what} (exit {proc.poll()})")

    try:
        t0 = time.perf_counter()
        while True:
            text = "".join(lines)
            m = re.search(r"serving \d+ pattern\(s\) \[cuda\] on "
                          r"127\.0\.0\.1:(\d+)", text)
            mm = re.search(r"metrics on http://127\.0\.0\.1:(\d+)/metrics",
                           text)
            if m and mm:
                box.update(port=int(m.group(1)), metrics_port=int(mm.group(1)),
                           banner=[ln.strip() for ln in lines])
                break
            if proc.poll() is not None:
                raise died("exited before its banner")
            if time.perf_counter() - t0 > limit:
                raise died("printed no banner in time")
            time.sleep(0.05)
        while True:
            try:
                status, _ = asyncio.run(http_get(box["metrics_port"],
                                                 "/readyz"))
            except OSError:
                status = None
            if status == 200:
                break
            if proc.poll() is not None:
                raise died("exited before /readyz")
            if time.perf_counter() - t0 > limit:
                raise died("was not ready in time")
            time.sleep(0.05)
        box["ready_s"] = time.perf_counter() - t0
        yield box
        if proc.poll() is not None and not box.get("killed"):
            raise died("died during the phase")
    finally:
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(20)
        reader.join(5)
        err.close()
        os.unlink(err.name)


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
                       seconds=3.0) -> dict:
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
    """(c) K1, K2 and pack_rows held against their plain versions on the
    batches an in-process filterd built for one collector (32 pods x
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
                                          "pack_rows"]) as calls:
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


def filterd_killed(root: str, action: str, n_pods=64,
                   lines_per_pod=20_000) -> dict:
    """(d), then: a collector process (``python -m klogs_tpu_torch.cli
    -a --cluster fake --remote ... --on-filter-error ACTION``, no card
    used) whose filterd is killed once its first lines reached it.
    ``abort``: exit 1 with one error line; ``pass``: exit 0, and every
    line after the kill written unfiltered and counted in
    ``klogs_filter_degraded_lines_total{action="pass"}``."""
    with filterd_process(root, PATTERNS) as fd, \
            tempfile.TemporaryDirectory() as out_dir:
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
    res["killed"] = {a: filterd_killed(root, a) for a in ("abort", "pass")}
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
                   for k in (nk.GROUPED, nk.CHUNK, nk.PACK))
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
    from klogs_tpu_torch.ops import _build, bits, nfa, pack, sweep, tune
    from klogs_tpu_torch.ops import nfa_kernels as nk
    from klogs_tpu_torch.ui import term

    dev = torch.device("cuda", 0)
    try:
        card = card_phase(torch)
        build_phase(nk, pack, _build)
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
        # The union program of the 1024 patterns (the long-line path's)
        # has 18878 positions, past the compiler's default cap of 4096.
        os.environ["KLOGS_MAX_PATTERN_POSITIONS"] = "65536"
        sw = sweep_phase(torch, np, sweep, bits, gpu, FilterStats,
                         synthetic_line, dev)
        k3 = k3_phase(torch, nfa, bits, nk, sw)
        k4 = k4_phase(torch, nfa, nk, k1_batches, sw)
        del k1_batches
        ek = engine_k1024_phase(torch, np, nk, gpu, frame_lines,
                                synthetic_line, sw["eng"], dev)
        k4_b256_check(torch, nk, k4, ek.pop("b256"))
        run3 = cli_k1024_phase(torch, np, nk, bits, app, cli, term,
                               FakeCluster, dev)
        # The observability and fault layers on the K = 32 path, and
        # once on the K = 1024 one.
        obs_phase(torch, np, nk, app, cli, term, FakeCluster,
                  GpuEngineFilter, FilterStats, frame0, dev, card,
                  run3.pop("want"))
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
        filterd_phase(torch, np, nk, pack, bits, app, cli, term,
                      FakeCluster, GpuEngineFilter, frame_lines,
                      synthetic_line, dev, repo, card, run["lines_per_s"])
    except Exception:
        traceback.print_exc()
        emit({"phase": "failed"})
        return 1
    w, c, g = k1["w128"], k2["s512"], run3["k3_batches"][0]
    f, cc = run4["k4_batches"][0], run["k2_batches"][0]
    emit({"kernels": [
        {"name": nk.GROUPED, "route": "cuda", "source": SOURCE,
         "replaces": "klogs_tpu/ops/pallas_nfa.py:200",
         "launches": run["launches"][nk.GROUPED],
         "backfill_launches": bfr["a"]["launches"][nk.GROUPED],
         "max_abs_err": float(w["max_abs_err"]), "ms": w["ms"],
         "plain_ms": w["plain_ms"], "bound_ms": w["bound_ms"],
         "bound_by": w["bound_by"], "library_ms": None},
        {"name": nk.CHUNK, "route": "cuda", "source": SOURCE,
         "replaces": "klogs_tpu/ops/pallas_nfa.py:50",
         "launches": run["launches"][nk.CHUNK],
         "backfill_launches": bfr["a"]["launches"][nk.CHUNK],
         "max_abs_err": float(max(r["max_abs_err"] for r in
                                  list(k2.values()) + run["k2_batches"]
                                  + run4["k2_batches"])),
         "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
         "bound_by": c["bound_by"], "library_ms": None,
         "cli_ms": cc["ms"], "cli_shape": f"{cc['rows']}x{cc['T']}"},
        {"name": nk.GATED, "route": "cuda", "source": SOURCE,
         "replaces": "klogs_tpu/ops/pallas_nfa.py:377",
         "launches": run3["launches"][nk.GATED],
         "backfill_launches": bfr["c"]["launches"][nk.GATED],
         "max_abs_err": float(max(b["max_abs_err"] for b in
                                  [g, k3["sweep_gate"], k3["random_gate"],
                                   k3["sparse_gate"], k3["full"]])),
         "ms": g["ms"], "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
         "bound_by": g["bound_by"], "library_ms": None,
         "wrapper_ms": g["wrapper_ms"], "pairs_ms": g["pairs_ms"],
         "pairs": g["pairs"], "pairs_launches": run3["launches"][nk.PAIRS],
         "pairs_mismatches": max(b["pairs_mismatches"] for b in
                                 [g, k3["sweep_gate"], k3["random_gate"],
                                  k3["sparse_gate"], k3["full"]])},
        {"name": nk.FUSED, "route": "cuda", "source": SOURCE,
         "replaces": "klogs_tpu/ops/pallas_nfa.py:334",
         "launches": run4["launches"][nk.FUSED],
         "max_abs_err": float(max(b["max_abs_err"] for b in
                                  run4["k4_batches"] + list(k4.values()))),
         "ms": f["ms"], "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
         "bound_by": f["bound_by"], "library_ms": None, "k1_ms": f["k1_ms"]},
        {"name": nk.PACK, "route": "cuda", "source": pk["source"],
         "replaces": pk["replaces"], "launches": run["launches"][nk.PACK],
         "backfill_launches": bfr["a"]["launches"][nk.PACK],
         "max_abs_err": pk["max_abs_err"], "ms": pk["ms"],
         "plain_ms": pk["plain_ms"], "bound_ms": pk["bound_ms"],
         "bound_by": pk["bound_by"], "library_ms": None},
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
