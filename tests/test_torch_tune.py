"""The kernel half of ops/tune.py in the port: the tuner's plumbing with
an injected runner (no device timing), and the variable rules, held
against the JAX package's where the two agree."""

import pytest
import torch

from klogs_tpu.ops import tune as jtune
from klogs_tpu_torch.ops import nfa, tune


@pytest.fixture(autouse=True)
def one_thread():
    """The plain kernels' products on one thread: several test processes
    each spreading them over every core slow each other to a crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TPU_VARS = ("KLOGS_TPU_TILE", "KLOGS_TPU_INTERLEAVE", "KLOGS_TPU_MASK_BLOCK",
            "KLOGS_TPU_FUSED_GROUPS", "KLOGS_TPU_KERNEL")


@pytest.fixture
def clean_env(monkeypatch):
    for var in TPU_VARS:
        monkeypatch.delenv(var, raising=False)


@pytest.fixture
def prog():
    return nfa.compile_grouped(["ERROR", "WARN"], device="cpu")


def test_tune_picks_best_and_caches(prog, tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    dp, live, acc = prog
    cls = torch.zeros((4096, 131), dtype=torch.int16)
    calls = []

    def runner(**variant):
        calls.append(variant)
        return 2000.0 if variant.get("fused") else 1000.0

    best = tune.tune_grouped(dp, live, acc, cls, runner=runner, quiet=True)
    assert best == {"fused": True, "lines_per_s": 2000.0,
                    "results": [{"lines_per_s": 1000.0},
                                {"fused": True, "lines_per_s": 2000.0}]}
    assert calls == [{}, {"fused": True}]
    assert tune.load_cached(dp, cls.shape, "cpu") == best
    assert tune.load_cached(dp, (4096, 259), "cpu") is None
    assert (tmp_path / "klogs_tpu_torch" / "tune.json").is_file()


def test_tune_survives_failing_configs(prog, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    dp, live, acc = prog
    cls = torch.zeros((1024, 131), dtype=torch.int16)

    def runner(**variant):
        if variant.get("fused"):
            raise RuntimeError("too much shared memory")
        return 500.0

    best = tune.tune_grouped(dp, live, acc, cls, runner=runner)
    assert best == {"lines_per_s": 500.0, "results": [{"lines_per_s": 500.0}]}
    out = capsys.readouterr().out
    assert "tune: fused=True failed: too much shared memory" in out
    assert "tune: plain -> 500 lines/s" in out

    def broken(**variant):
        raise RuntimeError("no kernel")

    with pytest.raises(RuntimeError, match="every candidate"):
        tune.tune_grouped(dp, live, acc, cls, runner=broken, quiet=True)


def test_tune_times_only_on_the_card(prog):
    """The default runner times on a cuda device; a CPU batch raises
    instead of timing the plain versions."""
    dp, live, acc = prog
    with pytest.raises(RuntimeError, match="cuda"):
        tune.tune_grouped(dp, live, acc, torch.zeros((8, 5), dtype=torch.int16))


def test_candidates_are_plain_and_fused():
    assert tune.CANDIDATE_VARIANTS == ({}, {"fused": True})


def test_env_overrides_fused(clean_env, monkeypatch):
    assert tune.env_overrides() == {}
    monkeypatch.setenv("KLOGS_TPU_FUSED_GROUPS", "1")
    assert tune.env_overrides() == {"fused": True}
    monkeypatch.setenv("KLOGS_TPU_FUSED_GROUPS", "0")
    assert tune.env_overrides() == {}


@pytest.mark.parametrize("var,value", [
    ("KLOGS_TPU_TILE", "4096"), ("KLOGS_TPU_TILE", "1"),
    ("KLOGS_TPU_INTERLEAVE", "2"), ("KLOGS_TPU_MASK_BLOCK", "4"),
    ("KLOGS_TPU_MASK_BLOCK", "junk"), ("KLOGS_TPU_KERNEL", "jnp"),
    ("KLOGS_TPU_KERNEL", "interpret")])
def test_tpu_only_knobs_raise(clean_env, monkeypatch, var, value):
    monkeypatch.setenv(var, value)
    with pytest.raises(ValueError, match=f"{var}.*TPU-only"):
        tune.env_overrides()
    with pytest.raises(ValueError, match=var):
        tune.chain_selection()


@pytest.mark.parametrize("value", ["auto", "pallas"])
def test_kernel_knob_naming_the_kernels_is_accepted(clean_env, monkeypatch,
                                                    value):
    monkeypatch.setenv("KLOGS_TPU_KERNEL", value)
    assert tune.env_overrides() == {}
    monkeypatch.setenv("KLOGS_TPU_FUSED_GROUPS", "1")
    assert tune.chain_selection() == {"fused": True}


@pytest.mark.parametrize("var", ["KLOGS_TPU_INTERLEAVE",
                                 "KLOGS_TPU_MASK_BLOCK"])
def test_plain_chain_restated_is_accepted(clean_env, monkeypatch, var):
    monkeypatch.setenv(var, "1")
    monkeypatch.setenv("KLOGS_TPU_FUSED_GROUPS", "1")
    assert tune.env_overrides() == {"fused": True}


@pytest.mark.parametrize("env", [{}, {"KLOGS_TPU_FUSED_GROUPS": "1"},
                                 {"KLOGS_TPU_FUSED_GROUPS": "0"},
                                 {"KLOGS_TPU_FUSED_GROUPS": "1",
                                  "KLOGS_TPU_MASK_BLOCK": "1"},
                                 {"KLOGS_TPU_FUSED_GROUPS": "1",
                                  "KLOGS_TPU_INTERLEAVE": "1"},
                                 {"KLOGS_TPU_INTERLEAVE": "1"}])
def test_chain_selection_never_defaults(clean_env, monkeypatch, env):
    """No variant is defaulted: the engine runs what the operator set,
    and the fused choice is the JAX package's on its interpret path."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    fused = env.get("KLOGS_TPU_FUSED_GROUPS") == "1"
    kw = tune.chain_selection()
    jkw, jdefaulted, _ = jtune.chain_selection(False)
    assert kw == ({"fused": True} if fused else {})
    assert kw.get("fused") == jkw.get("fused") and not jdefaulted
