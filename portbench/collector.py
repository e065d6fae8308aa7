"""One collector process of the load generator.

    python -m portbench.collector JOB_JSON

Started by ``portbench.run`` with pipes on stdin and stdout. It builds
its frame pool from ``(seed, collector)``, says ``pooled``; reads
``connect HOST:PORT``, opens one ``RemoteFilterClient`` (one channel, as
a collector has), checks the server's pattern set, sends every pool
frame once, ``flows_per_collector`` at a time (the warm-up), says
``ready``; reads ``go T0 T_END`` (``time.monotonic`` seconds, one clock
for every process of the host) and from T0 runs ``flows_per_collector``
closed loops: a flow sends one frame, waits for its verdicts, and sends
the next, until T_END. Every RPC in flight at T_END is awaited. It then
writes its records (``<out>/collector<c>.json``: send index, pool frame,
send and verdict times, whether the verdicts came;
``<out>/collector<c>.npy``: the verdicts, packed bits a send) and says
``done``.
"""

import asyncio
import itertools
import json
import os
import sys
import time

import numpy as np

from portbench import spec


def _say(word: str) -> None:
    sys.stdout.write(word + "\n")
    sys.stdout.flush()


async def _read_line() -> str:
    return (await asyncio.get_running_loop().run_in_executor(
        None, sys.stdin.readline)).strip()


async def run(job: dict, cell, pool, gen) -> None:
    from klogs_tpu_torch.service.client import RemoteFilterClient

    config, mix, c = cell.config, cell.mix, job["collector"]
    cmd = (await _read_line()).split()
    if not cmd or cmd[0] != "connect":
        raise SystemExit(f"collector {c}: expected connect, got {cmd}")
    client = RemoteFilterClient(cmd[1])
    await client.verify_patterns(config["patterns"],
                                 ignore_case=config.get("ignore_case", False))
    sends = itertools.count()
    records: "list[list]" = []
    verdicts: "list[np.ndarray]" = []
    n = mix["frame_lines"]
    empty = np.zeros(-(-n // 8), dtype=np.uint8)

    async def send(s: int) -> None:
        p = gen.pool_index(mix, s)
        frame = pool[p]
        payload = gen.stamp(frame, mix, c, s)
        t_send = time.monotonic()
        try:
            mask = await client.match_framed(payload, frame.offsets)
            ok = len(mask) == frame.n_lines
            err = "" if ok else f"{len(mask)} verdicts for {frame.n_lines}"
        except Exception as e:  # noqa: BLE001 - a lost batch is counted
            mask, ok, err = None, False, f"{type(e).__name__}: {e}"
        t_done = time.monotonic()
        records.append([s, p, t_send, t_done, ok, err[:200]])
        verdicts.append(np.packbits(mask) if ok else empty)

    try:
        flows = mix["flows_per_collector"]
        for _ in range(-(-len(pool) // flows)):
            await asyncio.gather(*(send(next(sends)) for _ in range(flows)))
        n_warm = len(records)
        _say("ready")
        cmd = (await _read_line()).split()
        if not cmd or cmd[0] != "go":
            raise SystemExit(f"collector {c}: expected go, got {cmd}")
        t0, t_end = float(cmd[1]), float(cmd[2])
        await asyncio.sleep(max(0.0, t0 - time.monotonic()))

        async def flow() -> None:
            while time.monotonic() < t_end:
                await send(next(sends))

        await asyncio.gather(*(flow()
                               for _ in range(mix["flows_per_collector"])))
    finally:
        await client.aclose()
    out = job["out_dir"]
    np.save(os.path.join(out, f"collector{c}.npy"),
            np.stack(verdicts) if verdicts else np.zeros((0, len(empty)),
                                                         np.uint8))
    with open(os.path.join(out, f"collector{c}.json"), "w") as f:
        json.dump({"records": records, "warm": n_warm}, f)
    _say("done")


def main() -> None:
    job = json.loads(sys.argv[1])
    if job.get("cpus"):
        os.sched_setaffinity(0, job["cpus"])
    cell = spec.load_cell(job["cell"], root=job["root"],
                          bench_dir=job["bench_dir"])
    gen = spec.generator(cell.bench_dir, cell.mix["kind"])
    pool = gen.build_pool(cell.config, cell.mix, job["seed"],
                          job["collector"])
    _say("pooled")
    asyncio.run(run(job, cell, pool, gen))


if __name__ == "__main__":
    main()
