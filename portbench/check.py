"""Whether what the timed path produced is correct.

Every verdict the collectors received, in the window and in the warm-up
before it, is held against the plain reference (``reference.py``) on a
sample of lines drawn from the seed. For each pool frame of each
collector the reference judges the frame as it was sent at one send
drawn from the seed (made again from ``(seed, collector, send index)``),
on the lines ``check_lines`` draws (``check_short_lines`` short and
``check_long_lines`` long lines a frame, and the longest line of each
collector's first pool frame). Every send of that pool frame differs
from it only in the counter field, which no pattern reads, so the
verdicts of every send on those lines are held to the same answers; the
frames of one collector differ, so verdicts handed to the wrong RPC
mismatch.

Numbers compared, each with its limit (an exact comparison: 0):
``mismatched_lines``, verdicts that differ from the reference's; and
``lost_lines``, lines of RPCs whose verdicts never came.
"""

import numpy as np

from portbench import reference


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**64, 0x636865636B])


def checked_frames(cell, gen, seed: int, sends: "dict[tuple, list]"):
    """[(collector, pool frame, line indices, lines)] the reference
    judges; ``sends`` maps (collector, pool frame) to its send indices."""
    rng = _rng(seed)
    out = []
    for (c, p) in sorted(sends):
        frame = gen.build_frame(cell.config, cell.mix, seed, c, p)
        s = int(rng.choice(sorted(sends[(c, p)])))
        payload = gen.stamp(frame, cell.mix, c, s)
        idx = gen.check_lines(frame, cell.mix, rng, with_longest=p == 0)
        out.append((c, p, idx, reference.lines_of(payload, frame.offsets,
                                                  idx)))
    return out


def judge_frames(patterns: "list[str]", ignore_case: bool, frames,
                 workers: int, tmp_dir: "str | None" = None,
                 lines_of=None) -> "dict[tuple, np.ndarray]":
    """(collector, pool frame) -> the verdicts on its checked lines, all
    frames judged in one pass; ``lines_of`` maps a frame's lines to the
    lines judged (the control's truncation)."""
    lines = []
    for _, _, _, ls in frames:
        lines += lines_of(ls) if lines_of is not None else ls
    hit = reference.judge_parallel(patterns, ignore_case, lines, workers,
                                   tmp_dir)
    out, at = {}, 0
    for c, p, idx, _ in frames:
        out[(c, p)] = hit[at:at + len(idx)]
        at += len(idx)
    return out


def compare(cell, gen, seed: int, results: "list[dict]", workers: int,
            tmp_dir: "str | None" = None) -> dict:
    """``results``: each collector's ``records`` and ``verdicts`` (packed
    bits a record). -> the numbers compared and what they covered."""
    n = cell.mix["frame_lines"]
    sends: "dict[tuple, list]" = {}
    lost = 0
    for c, res in enumerate(results):
        for s, p, _, _, ok, _ in res["records"]:
            if ok:
                sends.setdefault((c, p), []).append(s)
            else:
                lost += n
    frames = checked_frames(cell, gen, seed, sends)
    ref = judge_frames(cell.config["patterns"],
                       cell.config.get("ignore_case", False), frames,
                       workers, tmp_dir)
    idx_of = {(c, p): idx for c, p, idx, _ in frames}
    mismatched = checked = 0
    for c, res in enumerate(results):
        for (s, p, _, _, ok, _), bits in zip(res["records"],
                                             res["verdicts"]):
            if not ok:
                continue
            got = np.unpackbits(bits, count=n).astype(bool)[idx_of[(c, p)]]
            mismatched += int((got != ref[(c, p)]).sum())
            checked += len(got)
    return {"mismatched_lines": mismatched, "lost_lines": lost,
            "checked_lines": checked,
            "reference_kept": int(sum(int(v.sum()) for v in ref.values())),
            "reference_judged": int(sum(len(v) for v in ref.values()))}


def control(cell, gen, seed: int, workers: int,
            tmp_dir: "str | None" = None) -> dict:
    """The control in the program's place: the configuration's
    ``control`` (the reference with one guarantee broken) judges the
    frames a run would check, and its verdicts are held to the
    reference's. -> the mismatched lines over the frames a run checks,
    one send of each (a run with the control in the program's place
    reads that once per send)."""
    mix = cell.mix
    sends = {(c, p): [p] for c in range(mix["collectors"])
             for p in range(mix["pool_frames"])}
    frames = checked_frames(cell, gen, seed, sends)
    ref = judge_frames(cell.config["patterns"],
                       cell.config.get("ignore_case", False), frames,
                       workers, tmp_dir)
    _, ctl_patterns = reference.control_text_and_rules(cell.config, [])
    ctl = judge_frames(
        ctl_patterns, cell.config.get("ignore_case", False), frames, workers,
        tmp_dir,
        lines_of=lambda ls: reference.control_text_and_rules(cell.config,
                                                             ls)[0])
    return {"mismatched_lines": int(sum(int((ctl[k] != ref[k]).sum())
                                        for k in ref)),
            "reference_kept": int(sum(int(v.sum()) for v in ref.values())),
            "control_kept": int(sum(int(v.sum()) for v in ctl.values())),
            "reference_judged": int(sum(len(v) for v in ref.values()))}
