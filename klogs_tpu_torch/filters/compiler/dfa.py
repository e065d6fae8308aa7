"""Subset-construction DFA over the Glushkov class alphabet: the table
of the ``--backend cpu`` host engines.

A copy of ``klogs_tpu/filters/compiler/dfa.py`` (the port imports
nothing of the JAX package). It determinizes the union Glushkov NFA
(step semantics identical to ops/nfa.py: v' = (follow(v) | inject) &
char_mask[c], accept latched after every step including the BEGIN/END
sentinel steps) over the compressed class alphabet, then scans bytes
through a flat transition table: one table lookup per byte, early exit
on accept. The scan is ``dfa_scan`` in ``native/_hostops.c``
(filters/cpu.py ``DFAFilter``); ``scan_python`` here is its plain
version, which only the tests run.

Subset construction can blow up exponentially, so ``max_states`` caps
it; the callers (filters/cpu.py ``best_host_filter``, the indexed
engine's group builder) fall back to a combined-alternation `re` when
construction overflows or the pattern set uses syntax outside the
compiler's RE2 subset.

``build_dfa_cached`` keeps the tables in an LRU on disk under
``utils/cache.py``'s directory, keyed by the pattern set and a
fingerprint of this package's own ``parser.py``, ``glushkov.py`` and
``dfa.py``; ``KLOGS_DFA_CACHE_MB`` caps it.
"""

from collections import deque
from dataclasses import dataclass
from typing import Callable

import numpy as np

from klogs_tpu_torch.filters.compiler.glushkov import NFAProgram

# The 32-pattern north-star set determinizes to 8,544 states; 16k
# leaves headroom for comparable sets while bounding the table at a
# few MB (cache-resident scan) and construction at a couple of seconds.
DEFAULT_MAX_STATES = 16384


@dataclass
class DFATables:
    """Flat scan tables. ``table`` is [n_dfa, n_classes] uint32 state
    ids; ``accept`` a uint8 flag per DFA state; ``byte_class`` the
    int32[256] byte->class map shared with the NFA engine; ``start``
    the state AFTER consuming the BEGIN sentinel (checked for accept
    before any byte: patterns like "^" accept there)."""

    table: np.ndarray
    accept: np.ndarray
    byte_class: np.ndarray
    n_classes: int
    start: int
    end_class: int
    match_all: bool


def build_dfa(prog: NFAProgram,
              max_states: int = DEFAULT_MAX_STATES) -> "DFATables | None":
    """Determinize ``prog``. Returns None when the subset construction
    exceeds ``max_states`` (caller falls back to `re`)."""
    S = prog.n_states
    C = prog.n_classes
    follow = prog.follow.astype(bool)
    inject = prog.inject.astype(bool)
    char_mask = prog.char_mask.astype(bool)  # [C, S]
    accept = prog.accept.astype(bool)

    ids: dict[bytes, int] = {}
    members: list[np.ndarray] = []
    work: deque[int] = deque()

    def intern_key(key: bytes, vec: np.ndarray) -> "int | None":
        sid = ids.get(key)
        if sid is None:
            if len(members) >= max_states:
                return None
            sid = len(members)
            ids[key] = sid
            members.append(vec)
            work.append(sid)
        return sid

    start_vec = np.zeros(S, dtype=bool)
    intern_key(np.packbits(start_vec).tobytes(), start_vec)
    rows: list[np.ndarray] = []
    # Frontier-batched expansion: one bool matmul computes reachability
    # for a whole batch of pending subset-states, one packbits call
    # produces every candidate key — the per-transition Python cost is
    # a single dict lookup (construction is startup/bench-time, but a
    # 50k-state build at naive per-vector numpy cost would take
    # minutes).
    BATCH = 256
    while work:
        k = min(len(work), BATCH)
        sids = [work.popleft() for _ in range(k)]
        mat = np.stack([members[s] for s in sids])  # [k, S]
        # int32 accumulation: a uint8 matmul wraps mod 256, and a state
        # with an exact multiple of 256 active predecessors would
        # silently vanish from the subset.
        reach = (mat.astype(np.int32) @ follow.astype(np.int32)) > 0
        active = reach | inject[None, :]
        # [k, C, S] candidates; packbits over the state axis gives the
        # dict keys for all k*C transitions at once.
        nxt = active[:, None, :] & char_mask[None, :, :]
        keys = np.packbits(nxt.reshape(k * C, S), axis=1)
        klen = keys.shape[1]
        keys_b = keys.tobytes()
        for i in range(k):
            row = np.empty(C, dtype=np.int64)
            for c in range(C):
                j = i * C + c
                tid = intern_key(keys_b[j * klen:(j + 1) * klen],
                                 nxt[i, c])
                if tid is None:
                    return None
                row[c] = tid
            rows.append(row)

    # u16 ids when they fit: the C scan is latency-bound on the random
    # table walk, so halving the footprint matters more than width.
    dt = np.uint16 if len(members) < (1 << 16) else np.uint32
    table = np.vstack(rows).astype(dt)
    acc = np.fromiter(((m & accept).any() for m in members),
                      dtype=np.uint8, count=len(members))
    start = int(table[0, prog.begin_class])
    return DFATables(
        table=np.ascontiguousarray(table),
        accept=acc,
        byte_class=np.ascontiguousarray(prog.byte_class, dtype=np.int32),
        n_classes=C,
        start=start,
        end_class=prog.end_class,
        match_all=bool(prog.match_all),
    )


def _compiler_fingerprint() -> str:
    """Hash of the compiler sources that determine table SEMANTICS
    (parser, Glushkov construction, this module): a semantics bug-fix
    invalidates every cached table automatically — no manually-bumped
    version constant to forget."""
    import hashlib
    import os

    h = hashlib.sha256()
    here = os.path.dirname(os.path.abspath(__file__))
    for name in ("parser.py", "glushkov.py", "dfa.py"):
        try:
            with open(os.path.join(here, name), "rb") as f:
                h.update(f.read())
        except OSError:
            try:  # zipapp: no real files — read through the loader
                import importlib.resources

                h.update(importlib.resources.files(__package__)
                         .joinpath(name).read_bytes())
            except Exception:
                from klogs_tpu_torch.version import BUILD_VERSION

                h.update(BUILD_VERSION.encode())
    return h.hexdigest()[:16]


_FINGERPRINT = _compiler_fingerprint()


def _cache_path(patterns: "list[str]", ignore_case: bool,
                max_states: int) -> str:
    import hashlib
    import os

    from klogs_tpu_torch.utils.cache import cache_dir

    key = hashlib.sha256(repr(
        (tuple(patterns), bool(ignore_case), int(max_states),
         _FINGERPRINT)).encode()).hexdigest()[:20]
    return os.path.join(cache_dir(), f"dfa-{key}.npz")


# On-disk table-cache size cap (MiB): a 4k-pattern grouped set writes
# ~100 tables, and long-lived hosts cycling many tenant pattern sets
# would otherwise grow ~/.cache without bound. Exceeding the cap
# evicts least-recently-USED tables (mtime, refreshed on every cache
# hit), so the hot sets of a multi-set host stay resident.
DEFAULT_CACHE_MB = 512


def _cache_cap_bytes() -> int:
    import math

    from klogs_tpu_torch.utils.env import read as env_read

    try:
        mb = float(env_read("KLOGS_DFA_CACHE_MB",
                            str(DEFAULT_CACHE_MB)))
    except ValueError:
        return DEFAULT_CACHE_MB * 1048576
    if not math.isfinite(mb) or mb <= 0:
        # A negative/zero/nan cap would evict EVERY table on every
        # write (warm starts silently recompile the world); treat it
        # as the misconfiguration it is, like _env_positive_float.
        return DEFAULT_CACHE_MB * 1048576
    return int(mb * 1048576)


def _evict_lru(keep: str, cap_bytes: "int | None" = None) -> int:
    """Shrink the DFA table cache below the size cap, oldest-touched
    first; ``keep`` (the just-written table) is never evicted. Returns
    the number of files removed. All failures are silent — the cache
    is an optimization, never a correctness dependency."""
    import os

    from klogs_tpu_torch.utils.cache import cache_dir

    cap = _cache_cap_bytes() if cap_bytes is None else cap_bytes
    removed = 0
    try:
        d = cache_dir()
        entries = []
        total = 0
        for name in os.listdir(d):
            if not (name.startswith("dfa-") and name.endswith(".npz")):
                continue
            p = os.path.join(d, name)
            try:
                st = os.stat(p)
            except OSError:
                continue
            entries.append((st.st_mtime, st.st_size, p))
            total += st.st_size
        entries.sort()
        for _, size, p in entries:
            if total <= cap:
                break
            if os.path.abspath(p) == os.path.abspath(keep):
                continue
            try:
                os.remove(p)
                total -= size
                removed += 1
            except OSError:
                pass
    except OSError:
        pass
    return removed


def build_dfa_cached(patterns: list[str], ignore_case: bool = False,
                     max_states: int = DEFAULT_MAX_STATES,
                     on_event: "Callable[[str], None] | None" = None
                     ) -> "DFATables | None":
    """build_dfa with an LRU disk cache (~/.cache/klogs-tpu-torch) keyed by
    the pattern set: the 32-pattern north-star set determinizes in
    ~1.6s, which would otherwise be paid at every CLI start — and a
    grouped 4k-pattern set pays it ~100x, so warm starts matter even
    more there. Cache failures (no home, corrupt file, race) silently
    rebuild. A hit refreshes the file's mtime (the LRU clock); writes
    that push the cache past KLOGS_DFA_CACHE_MB evict least-recently-
    used tables. ``on_event`` (observability hook) receives "hit",
    "miss", and one "evict" per removed file."""
    import os

    import numpy as _np

    from klogs_tpu_torch.filters.compiler.glushkov import compile_patterns

    def event(kind: str) -> None:
        if on_event is not None:
            on_event(kind)

    path = _cache_path(patterns, ignore_case, max_states)
    try:
        with _np.load(path) as z:
            t = DFATables(
                table=z["table"], accept=z["accept"],
                byte_class=z["byte_class"], n_classes=int(z["n_classes"]),
                start=int(z["start"]), end_class=int(z["end_class"]),
                match_all=bool(z["match_all"]))
        try:
            os.utime(path)  # LRU touch
        except OSError:
            pass
        event("hit")
        return t
    except Exception:
        pass
    event("miss")
    prog = compile_patterns(patterns, ignore_case=ignore_case)
    t = build_dfa(prog, max_states)
    if t is None:
        return None
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            _np.savez(f, table=t.table, accept=t.accept,
                      byte_class=t.byte_class, n_classes=t.n_classes,
                      start=t.start, end_class=t.end_class,
                      match_all=t.match_all)
        os.replace(tmp, path)
        for _ in range(_evict_lru(keep=path)):
            event("evict")
    except Exception:
        pass
    return t


def scan_python(t: DFATables, lines: list[bytes]) -> list[bool]:
    """Pure-Python scan: the plain version of the C ``dfa_scan``."""
    out = []
    tab = t.table
    acc = t.accept
    bc = t.byte_class
    for line in lines:
        body = line.rstrip(b"\n")
        if t.match_all:
            out.append(True)
            continue
        s = t.start
        hit = bool(acc[s])
        if not hit:
            for b in body:
                s = int(tab[s, bc[b]])
                if acc[s]:
                    hit = True
                    break
            else:
                s = int(tab[s, t.end_class])
                hit = bool(acc[s])
        out.append(hit)
    return out
