"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (``klogs_tpu_torch`` is the port, allowed;
``klogs_tpu`` is not), and the reference loads nothing of the port."""

import json
import os
import subprocess
import sys

from portbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "klogs_tpu"}


def _top_level_after(imports: "list[str]") -> "set[str]":
    code = ("import json, sys\n"
            + "".join(f"import {m}\n" for m in imports)
            + "print(json.dumps(sorted({m.split('.')[0] "
              "for m in sys.modules})))")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, env=env,
                         timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_collector_and_reference_load_no_jax():
    names = _top_level_after([
        "portbench.run", "portbench.collector", "portbench.reference",
        "portbench.refworker", "portbench.check", "portbench.tracing",
        "klogs_tpu_torch.service.server", "klogs_tpu_torch.service.client",
        "torch.profiler"])
    assert "klogs_tpu_torch" in names
    assert not names & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    names = _top_level_after(["portbench.reference", "portbench.refworker",
                              "portbench.check"])
    assert "klogs_tpu_torch" not in names
    assert not names & FORBIDDEN


def test_the_run_refuses_a_forbidden_module(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "klogs_tpu", sys.modules["json"])
    assert run.forbidden_modules() == ["klogs_tpu"]
    monkeypatch.delitem(sys.modules, "klogs_tpu")
    monkeypatch.setitem(sys.modules, "klogs_tpu_torch_x", sys.modules["json"])
    assert run.forbidden_modules() == []
