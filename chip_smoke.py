#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (klogs_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper
card and nvcc (``/usr/local/cuda`` or CUDA_HOME):

    python3 chip_smoke.py

It builds the CUDA kernels from ``klogs_tpu_torch/ops/csrc`` and runs
these phases, each printing one JSON line:

1. card: the card's name and power limit (nvidia-smi), torch and CUDA.
2. grouped_nfa_kernel against its plain PyTorch version on the
   32-pattern program (4 groups x 128 states, 64 classes): 131072 rows
   at the 128-byte width bucket and 4096 rows at the 4096 bucket, plus a
   256-state group and a program wider than 1024 states. Exact equality.
3. chunk_nfa_kernel against its plain version on the 512-state union
   program: 1024 lines of 4 KiB to 128 KiB chained chunk by chunk (some
   ending exactly on a chunk edge), a 640-state union program (run
   padded to 1024 states) and one wider than 1024 states. Matched flags
   and carries must be equal.
4. engine: GpuEngineFilter on 1M synthetic log lines and 2000 long
   lines (4 KiB to 192 KiB); verdicts equal a Python ``re`` oracle.
5. cli: the user's entry point, ``app.run_async`` over a 256-pod
   FakeCluster (4000 lines each, plus long lines) with ``--match`` on
   the 32 patterns and ``-p`` a temporary directory; every file must
   hold exactly the oracle's lines. This is the main path: the launch
   counts are zeroed just before it and read just after. After it,
   grouped_nfa_kernel is held against its plain version and timed on
   the run's own class batches, at its two most frequent shapes.

Then a ``kernels`` line (each kernel's time beside its bound and its
plain version's time, with its launches on the main path), the card
line, and last ``{"ok": true, "device": {...}}``. Any failed phase exits
non-zero without that line, as does a run with no CUDA device or
outside a checkout.
"""

import asyncio
import io
import json
import os
import re
import subprocess
import sys
import tempfile
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
SEED = 20261016
CLOCK = 1_753_800_000.0
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and dense int8 ops/s.
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1.979e15
SOURCE = "klogs_tpu_torch/ops/csrc/nfa_kernels.cu"


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


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


def build_phase(nk, build):
    t0 = time.perf_counter()
    nk._library()
    seconds = time.perf_counter() - t0
    regs = []
    for m in re.finditer(r"entry function '([^']+)'.*?Used (\d+) registers",
                         build.build_logs.get("nfa_kernels", ""), re.S):
        regs.append({"kernel": m.group(1), "registers": int(m.group(2))})
    emit({"phase": "build", "seconds": seconds, "ptxas": regs})


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
                **step_bounds(n_bytes, S, C, B * G * T, work["active"]))


def k1_phase(torch, np, nfa, nk, synthetic_line, dev, rows_128=131072,
             rows_4096=4096) -> dict:
    rng = np.random.default_rng(SEED)
    dp, live, acc = nfa.compile_grouped(PATTERNS, device=dev)
    results = {}
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
    # rows_4096 rows at the 4096 bucket.
    B, W = rows_4096, 4096
    rows, lens = rows_with_needles(np, rng, B, W, 2049, printable=False)
    cls = nfa.classify_chunk(dp, torch.from_numpy(rows).to(dev),
                             torch.from_numpy(lens).to(dev), True, True)
    results["w4096"] = k1_check(torch, nk, dp, live, acc, cls, 5)
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
    emit({"phase": "grouped_nfa_kernel", **results})
    worst = max(r["max_abs_err"] for r in results.values())
    if worst != 0 or results["s1280"]["matched"] == 0:
        raise AssertionError(f"grouped_nfa_kernel disagrees: {results}")
    return results


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
               plain_ms=p_ms / n, matched=int(m.sum()),
               active_per_step=work["active"] / steps,
               **step_bounds(n_bytes, S, C, steps, work["active"]))
    # Per launch, like ms.
    for k in ("bound_ms", "dense_bound_ms", "bytes_ms"):
        res[k] /= n
    return res


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


def profile_batch(torch, eng, frame) -> dict:
    """One batch under torch.profiler (device side: wall time, summed
    kernel and copy time, the largest of them) and under cProfile (host
    side: the functions with the most own time)."""
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.fetch_framed(eng.dispatch_framed(*frame))
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(ms for _, ms in rows)
    top = sorted(rows, key=lambda r: -r[1])[:6]
    cp = cProfile.Profile()
    cp.enable()
    eng.fetch_framed(eng.dispatch_framed(*frame))
    cp.disable()
    st = pstats.Stats(cp)
    host = sorted(((f"{os.path.basename(fn)}:{name}", v[2] * 1e3)
                   for (fn, _, name), v in st.stats.items()),
                  key=lambda r: -r[1])[:8]
    return dict(wall_ms=wall * 1e3, device_ms=device_ms,
                device_busy=device_ms / (wall * 1e3),
                device_top=[{"op": k[:60], "ms": ms} for k, ms in top],
                host_top=[{"fn": k[:60], "own_ms": ms} for k, ms in host])


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
    if bad or len(got) != len(exp) or min(launches.values()) == 0:
        raise AssertionError(f"engine phase failed: {res}")
    return res


def cli_phase(torch, np, nk, app, cli, term, FakeCluster, dev, n_pods=256,
              lines_per_pod=4000) -> dict:
    rng = np.random.default_rng(SEED + 3)
    ora = oracle_fn()
    fc = FakeCluster.synthetic(n_pods=n_pods, n_containers=1,
                               lines_per_container=lines_per_pod,
                               clock=lambda: CLOCK)
    pods = fc.namespaces["default"]
    for j, name in enumerate(sorted(pods)[:16]):  # long lines in 16 pods
        n = int(rng.integers(5000, 180 * 1024))
        body = bytearray(rng.integers(32, 127, size=n, dtype=np.uint8))
        if j % 2:
            body[n // 2:n // 2 + 8] = b"code=504"
        pods[name].containers["c0"].lines.insert(
            100 + j, (CLOCK - 3000, bytes(body) + b"\n"))
    n_lines = sum(len(c.lines) for p in pods.values()
                  for c in p.containers.values())
    argv = ["-n", "default", "-a", "-p", ""]
    for p in PATTERNS:
        argv += ["--match", p]
    # The [B, T] class batches the main path hands K1: per shape, its
    # launches and the first such batch, to time K1 on after the run.
    shapes: dict = {}
    grouped = nk.match_cls_grouped

    def recording(prog, live, acc, cls):
        entry = shapes.setdefault(tuple(cls.shape),
                                  [0, (prog, live, acc, cls)])
        entry[0] += 1
        return grouped(prog, live, acc, cls)

    with tempfile.TemporaryDirectory() as out_dir:
        argv[4] = out_dir
        opts = cli.parse_args(argv)
        ui = io.StringIO()
        term.set_ui_stream(ui)
        nk.match_cls_grouped = recording
        try:
            torch.cuda.synchronize()
            nk.reset_launches()
            t0 = time.perf_counter()
            rc = asyncio.run(app.run_async(opts, backend=fc, device=dev))
            seconds = time.perf_counter() - t0
            launches = dict(nk.LAUNCHES)
        finally:
            nk.match_cls_grouped = grouped
            term.set_ui_stream(None)
        files = sorted(os.listdir(out_dir))
        bad = []
        kept = 0
        for name in sorted(pods):
            exp = b"".join(ln for _, ln in pods[name].containers["c0"].lines
                           if ora(ln.rstrip(b"\n")))
            kept += exp.count(b"\n")
            with open(os.path.join(out_dir, f"{name}__c0.log"), "rb") as f:
                if f.read() != exp:
                    bad.append(name)
    # K1 timed (and held against its plain version) on the main path's
    # own batches, its two most frequent shapes.
    k1_batches = []
    for n, args in sorted(shapes.values(), key=lambda e: -e[0])[:2]:
        k1_batches.append(dict(launches=n,
                               **k1_check(torch, nk, *args, 20)))
    res = dict(rc=rc, pods=len(pods), files=len(files), lines=n_lines,
               kept_lines=kept, seconds=seconds, lines_per_s=n_lines / seconds,
               mismatched_files=bad, launches=launches,
               k1_shapes={f"{B}x{T}": e[0] for (B, T), e in shapes.items()},
               k1_batches=k1_batches)
    emit({"phase": "cli", **res})
    if (rc != 0 or bad or len(files) != len(pods)
            or min(launches.values()) == 0
            or any(b["max_abs_err"] for b in k1_batches)):
        raise AssertionError(f"cli phase failed: {res}")
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "klogs_tpu_torch")):
        print("chip_smoke: klogs_tpu_torch/ not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    import numpy as np

    from klogs_tpu_torch import app, cli
    from klogs_tpu_torch.cluster.fake import FakeCluster, synthetic_line
    from klogs_tpu_torch.filters.base import frame_lines
    from klogs_tpu_torch.filters.compiler.glushkov import compile_patterns
    from klogs_tpu_torch.filters.gpu import GpuEngineFilter
    from klogs_tpu_torch.ops import _build, nfa
    from klogs_tpu_torch.ops import nfa_kernels as nk
    from klogs_tpu_torch.ui import term

    dev = torch.device("cuda", 0)
    try:
        card = card_phase(torch)
        build_phase(nk, _build)
        k1 = k1_phase(torch, np, nfa, nk, synthetic_line, dev)
        k2 = k2_phase(torch, np, nfa, nk, compile_patterns, dev)
        engine_phase(torch, np, nk, GpuEngineFilter, frame_lines,
                     synthetic_line, dev)
        run = cli_phase(torch, np, nk, app, cli, term, FakeCluster, dev)
    except Exception:
        traceback.print_exc()
        emit({"phase": "failed"})
        return 1
    w, c = k1["w128"], k2["s512"]
    emit({"kernels": [
        {"name": nk.GROUPED, "route": "cuda", "source": SOURCE,
         "replaces": "klogs_tpu/ops/pallas_nfa.py:200",
         "launches": run["launches"][nk.GROUPED],
         "max_abs_err": float(w["max_abs_err"]), "ms": w["ms"],
         "plain_ms": w["plain_ms"], "bound_ms": w["bound_ms"],
         "bound_by": w["bound_by"], "library_ms": None},
        {"name": nk.CHUNK, "route": "cuda", "source": SOURCE,
         "replaces": "klogs_tpu/ops/pallas_nfa.py:50",
         "launches": run["launches"][nk.CHUNK],
         "max_abs_err": float(c["max_abs_err"]), "ms": c["ms"],
         "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
         "bound_by": c["bound_by"], "library_ms": None},
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
