"""The frames generator: the same (seed, collector, send index) makes the
same bytes, sends differ, every frame holds the same long sizes in an
order of its own, and no pattern reads the counter field."""

import numpy as np
import pytest

from portbench import reference, spec

SMALL_LONG = {"name": "smalllong", "kind": "frames", "collectors": 4,
              "flows_per_collector": 4, "frame_lines": 512,
              "pool_frames": 2, "long_every": 32, "long_min_bytes": 4096,
              "long_max_bytes": 16384, "long_needle_share": 0.5,
              "check_short_lines": 64,
              "check_long_lines": 4}


def _cell(config: str, mix: dict):
    cell = spec.load_cell("ops32.long")
    cell.config = spec.load_json(f"{spec.BENCH_DIR}/configs/{config}.json")
    cell.mix = mix
    return cell, spec.generator(cell.bench_dir, mix["kind"])


def test_same_seed_collector_and_send_make_the_same_frame():
    cell, gen = _cell("ops32", SMALL_LONG)
    a = gen.frame_at(cell.config, cell.mix, 2**31 + 7, 1, 5)
    b = gen.frame_at(cell.config, cell.mix, 2**31 + 7, 1, 5)
    assert a[0] == b[0]
    assert np.array_equal(a[1], b[1])


def test_sends_and_collectors_and_seeds_differ():
    cell, gen = _cell("ops32", SMALL_LONG)
    base = gen.frame_at(cell.config, cell.mix, 11, 1, 5)[0]
    # The next send of the same pool frame: only the counters differ.
    again = gen.frame_at(cell.config, cell.mix, 11, 1, 7)[0]
    assert again != base and len(again) == len(base)
    assert gen.frame_at(cell.config, cell.mix, 11, 2, 5)[0] != base
    assert gen.frame_at(cell.config, cell.mix, 12, 1, 5)[0] != base


def test_every_line_carries_a_counter_no_other_line_of_the_run_has():
    cell, gen = _cell("ops32", SMALL_LONG)
    seen = set()
    for c in range(2):
        for s in range(4):
            payload, offs = gen.frame_at(cell.config, cell.mix, 3, c, s)
            for i in range(len(offs) - 1):
                line = payload[offs[i]:offs[i + 1]]
                assert line.endswith(b"\n")
                field = line[-1 - gen.CTR_DIGITS - len(gen.CTR_FIELD):-1]
                assert field.startswith(gen.CTR_FIELD)
                seen.add(field)
    assert len(seen) == 2 * 4 * 512


def test_every_frame_has_the_same_long_sizes_in_its_own_order():
    cell, gen = _cell("ops32", SMALL_LONG)
    sizes, orders = [], []
    for seed, c, p in ((1, 0, 0), (1, 0, 1), (1, 3, 0), (2**31 + 5, 0, 0)):
        f = gen.build_frame(cell.config, cell.mix, seed, c, p)
        lens = np.diff(f.offsets.astype(np.int64))[f.long_lines]
        assert np.all(lens > 4096) and np.all(lens <= 16384)
        sizes.append(np.sort(lens))
        orders.append(lens)
    assert all(np.array_equal(sizes[0], s) for s in sizes[1:])
    # Pool frames, collectors and seeds draw their own order.
    assert len({o.tobytes() for o in orders}) == len(orders)


@pytest.mark.parametrize("config", ["ops32", "alerts1024"])
def test_verdicts_do_not_depend_on_the_counter(config):
    mix = dict(SMALL_LONG, frame_lines=2048, long_max_bytes=8192)
    cell, gen = _cell(config, mix)
    patterns = cell.config["patterns"]
    if config == "alerts1024":
        patterns = patterns[:96] + patterns[-96:]
    rules = reference.compile_rules(patterns)
    got = []
    for send in (0, 2, 10**6 + 2):
        payload, offs = gen.frame_at(cell.config, mix, 9, 1, send)
        lines = reference.lines_of(payload, offs, np.arange(len(offs) - 1))
        got.append(reference.judge(rules, *reference.joined(lines)))
    assert got[0].any()
    assert np.array_equal(got[0], got[1]) and np.array_equal(got[0], got[2])
