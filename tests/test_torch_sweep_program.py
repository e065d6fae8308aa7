"""The port's copy of the index compiler (analyze, plan_groups,
FactorIndex.sweep_program) packs the same sweep tables as the JAX
package's, default and retargeted to compile_grouped's pattern_group
map: every leaf equal, exactly."""

import numpy as np
import pytest
import torch

import bench
from klogs_tpu.filters.compiler import index as jindex
from klogs_tpu.filters.compiler.groups import analyze as janalyze
from klogs_tpu.filters.compiler.groups import plan_groups as jplan_groups
from klogs_tpu.filters.compiler.index import FactorIndex as JFactorIndex
from klogs_tpu.ops import nfa as jnfa
from klogs_tpu_torch.filters.compiler import index
from klogs_tpu_torch.filters.compiler.groups import analyze, plan_groups
from klogs_tpu_torch.filters.compiler.index import FactorIndex


@pytest.fixture(autouse=True)
def one_thread():
    """The plain kernels' products on one thread: several test processes
    each spreading them over every core slow each other to a crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TIER_SET = ["ERR!", "panic: out of memory", "x!z", "FATAL|CRIT",
            r"[a-z]*\d?"]
OVERLONG = ["prefix-" + "q" * index.SWEEP_FACTOR_CAP + "-suffix",
            "other-lit"]
SETS = {
    "k64": bench.make_patterns(64),
    "k1024": bench.make_patterns(1024),
    "tiers": TIER_SET,
    "overlong": OVERLONG,
}


def program_leaves(prog) -> dict:
    out = {"n_groups": np.asarray(prog.n_groups)}
    for name in ("fac_len", "fac_words", "fac_wmask", "fac_groups",
                 "always_mask"):
        out[name] = np.asarray(getattr(prog, name))
    for tname in ("narrow", "wide"):
        t = getattr(prog, tname)
        for name in ("keys", "bucket_start", "fid", "anchor", "slot_key",
                     "slot_eid", "max_probe", "max_bucket", "n_words"):
            out[f"{tname}.{name}"] = np.asarray(getattr(t, name))
    return out


def assert_same_program(mine, ref):
    a, b = program_leaves(mine), program_leaves(ref)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert np.array_equal(a[k], b[k]), k


@pytest.fixture(scope="module", params=sorted(SETS))
def both(request):
    pats = SETS[request.param]
    infos, jinfos = analyze(pats), janalyze(pats)
    plan, jplan = plan_groups(infos), jplan_groups(jinfos)
    return (pats, infos, jinfos, plan, jplan, FactorIndex(infos, plan),
            JFactorIndex(jinfos, jplan))


def test_analyze_and_plan_equal_jax(both):
    _, infos, jinfos, plan, jplan, _, _ = both
    assert [tuple(vars(i).values()) for i in infos] == \
        [tuple(vars(i).values()) for i in jinfos]
    assert plan.groups == jplan.groups
    assert np.array_equal(plan.group_of, jplan.group_of)
    assert plan.always_groups == jplan.always_groups


def test_default_sweep_program_equals_jax(both):
    _, _, _, _, _, idx, jidx = both
    assert idx.factors == jidx.factors
    assert idx._probes == jidx._probes
    assert np.array_equal(idx.always_groups, jidx.always_groups)
    assert_same_program(idx.sweep_program(), jidx.sweep_program())
    assert idx.sweep_program() is idx.sweep_program()


def test_retargeted_sweep_program_equals_jax(both):
    pats, _, _, _, _, idx, jidx = both
    jdp, _, _ = jnfa.compile_grouped(pats)
    G = int(jdp.follow.shape[0])
    pg = np.asarray(jdp.pattern_group, dtype=np.int32)
    assert_same_program(idx.sweep_program(group_of=pg, n_groups=G),
                        jidx.sweep_program(group_of=pg, n_groups=G))


def test_k1024_shapes():
    """The thousand-pattern set's packed gate: 156 kernel groups in 5
    bitset words, no always-candidate group, two shallow tiers."""
    pats = bench.make_patterns(1024)
    from klogs_tpu_torch.ops import nfa

    dp, _, _ = nfa.compile_grouped(pats, device="cpu")
    infos = analyze(pats)
    prog = FactorIndex(infos, plan_groups(infos)).sweep_program(
        group_of=np.asarray(dp.pattern_group), n_groups=dp.follow.shape[0])
    assert prog.n_groups == 156 and prog.fac_groups.shape == (920, 5)
    assert not prog.always_mask.any()
    assert (len(prog.narrow.slot_key), prog.narrow.max_probe,
            prog.narrow.max_bucket, prog.narrow.n_words) == (128, 2, 1, 2)
    assert (len(prog.wide.slot_key), prog.wide.max_probe,
            prog.wide.max_bucket, prog.wide.n_words) == (4096, 5, 2, 6)


def test_code_freq_reanchors_like_jax():
    """Observed code counts move probe windows (and can demote a wide
    factor to the narrow tier) the same way in both packages."""
    pats = ["ms code=418", "errcode=00881", "latency=49"]
    freq = {index._code_at(b"ms code=418", 0): 50,
            index._code_at(b"errcode=00881", 3): 90}
    infos, jinfos = analyze(pats), janalyze(pats)
    idx = FactorIndex(infos, plan_groups(infos), code_freq=freq)
    jidx = JFactorIndex(jinfos, jplan_groups(jinfos), code_freq=freq)
    assert idx._probes == jidx._probes
    assert_same_program(idx.sweep_program(), jidx.sweep_program())


@pytest.mark.parametrize("f", [b"abc", b"errcode=00881", b"q" * 40,
                               b"tenant-0002"])
def test_helpers_equal_jax(f):
    assert index.sweep_factor(f) == jindex.sweep_factor(f)
    for width in (4, 8):
        assert index._anchor(f, width) == jindex._anchor(f, width)
    code = index._code_at(f, 0)
    assert code == jindex._code_at(f, 0)
    assert index._fold1(code) == jindex._fold1(code)


def test_pack_sweep_tier_equals_jax():
    entries = [(i * 2654435761 % (1 << 32), i, i % 3) for i in range(40)]
    for hs in (None, 1024):
        a = index.pack_sweep_tier(list(entries), hash_size=hs)
        b = jindex.pack_sweep_tier(list(entries), hash_size=hs)
        for name in ("keys", "bucket_start", "fid", "anchor", "slot_key",
                     "slot_eid"):
            assert np.array_equal(getattr(a, name), getattr(b, name))
        assert (a.max_probe, a.max_bucket) == (b.max_probe, b.max_bucket)
    with pytest.raises(ValueError, match="power of two"):
        index.pack_sweep_tier(entries, hash_size=48)


def test_group_of_validation():
    infos = analyze(["aaaa-lit", "bbbb-lit"])
    idx = FactorIndex(infos, plan_groups(infos))
    with pytest.raises(ValueError, match="maps 3 patterns"):
        idx.sweep_program(group_of=np.zeros(3, dtype=np.int32))
