"""The plain reference: each line's verdict under Python's ``re``.

A line is kept when some pattern of the configuration finds a match
anywhere in it, its trailing newlines stripped: the semantics the
program's engines promise (``rstrip(b"\\n")``, then a search). It
imports nothing of the program and takes nothing the program made.

The lines to judge are joined into one text, each ending in one newline,
and each pattern scans the whole text with ``finditer`` (MULTILINE, so
``^`` and ``$`` fall at line ends as they do on a stripped line); a match
marks the line it starts in. That is exact as long as no match crosses
a newline, since then every start position of every line is tried:
``judge`` raises on a match that holds a newline, and on the constructs
whose meaning changes in a joined text (``\\A``, ``\\Z``, lookarounds).

``judge_parallel`` splits the patterns among worker processes
(``python -m portbench.refworker``: plain subprocesses, no
multiprocessing primitives), each scanning the same text.

The control (``control_text_and_rules``) is the reference with one of
the configuration's guarantees broken, as the configuration's
``control`` says: ``truncate`` judges each line on its first ``bytes``
bytes; ``rules`` judges with another rule set.
"""

import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

_UNSUPPORTED = ("\\A", "\\Z", "(?=", "(?!", "(?<=", "(?<!")


def compile_rules(patterns: "list[str]", ignore_case: bool = False):
    flags = re.MULTILINE | (re.IGNORECASE if ignore_case else 0)
    for p in patterns:
        for tok in _UNSUPPORTED:
            if tok in p:
                raise ValueError(f"reference cannot judge {p!r} in a joined "
                                 f"text ({tok})")
    return [re.compile(p.encode(), flags) for p in patterns]


def joined(lines: "list[bytes]") -> "tuple[bytes, np.ndarray]":
    """(text, starts [n + 1]) of ``lines`` stripped of trailing newlines,
    each then ending in one newline."""
    bodies = [ln.rstrip(b"\n") + b"\n" for ln in lines]
    starts = np.zeros(len(bodies) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in bodies], out=starts[1:])
    return b"".join(bodies), starts


def judge(rules, text: bytes, starts: np.ndarray) -> np.ndarray:
    """[n] bool: whether some rule matches in each line of ``text``."""
    n = len(starts) - 1
    hit = np.zeros(n, dtype=bool)
    for rule in rules:
        at = []
        for m in rule.finditer(text):
            if b"\n" in m.group():
                raise ValueError(f"pattern {rule.pattern!r} matched across "
                                 "a line end: the joined text is not exact")
            at.append(m.start())
        if at:
            hit[np.searchsorted(starts, at, side="right") - 1] = True
    return hit


def lines_of(payload: bytes, offsets: np.ndarray,
             idx: np.ndarray) -> "list[bytes]":
    offs = np.asarray(offsets, dtype=np.int64)
    return [payload[offs[i]:offs[i + 1]] for i in idx.tolist()]


def control_text_and_rules(config: dict, lines: "list[bytes]"):
    """(lines, patterns) the control judges."""
    ctl = config["control"]
    if ctl["kind"] == "truncate":
        return [ln.rstrip(b"\n")[:ctl["bytes"]] for ln in lines], \
            config["patterns"]
    if ctl["kind"] == "rules":
        return lines, ctl["patterns"]
    raise ValueError(f"unknown control kind {ctl['kind']!r}")


def judge_parallel(patterns: "list[str]", ignore_case: bool,
                   lines: "list[bytes]", workers: int,
                   tmp_dir: "str | None" = None) -> np.ndarray:
    """``judge`` over ``lines`` with the patterns split among ``workers``
    processes; every process is waited for."""
    text, starts = joined(lines)
    workers = max(1, min(workers, len(patterns)))
    if workers == 1:
        return judge(compile_rules(patterns, ignore_case), text, starts)
    with tempfile.TemporaryDirectory(prefix="portbench-ref-",
                                     dir=tmp_dir) as d:
        text_path = os.path.join(d, "text.bin")
        with open(text_path, "wb") as f:
            f.write(text)
        np.save(os.path.join(d, "starts.npy"), starts)
        procs = []
        try:
            for w in range(workers):
                job = {"dir": d, "text": text_path, "out": f"hit{w}.npy",
                       "patterns": patterns[w::workers],
                       "ignore_case": ignore_case}
                job_path = os.path.join(d, f"job{w}.json")
                with open(job_path, "w") as f:
                    json.dump(job, f)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "portbench.refworker", job_path],
                    cwd=os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__)))))
            codes = [p.wait() for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(codes):
            raise RuntimeError(f"reference workers failed: exit codes {codes}")
        hit = np.zeros(len(starts) - 1, dtype=bool)
        for w in range(workers):
            hit |= np.load(os.path.join(d, f"hit{w}.npy"))
        return hit
