"""The port's two scheduler examples on the CPU, held to the reference's.

* ``examples/torch_preemption_demo.py --device cpu`` prints the reference
  demo's lines, line for line, with the topology-aware engine's label
  mapped (``imp_batched`` for the reference's ``imp``).
* ``examples/torch_colocated_serving.py --device cpu``: its A/B lines (the
  12-node day under ``imp_batched`` and ``godel``) are the reference's
  ``compare_day_cycle`` on the same config under host ``imp`` and
  ``godel`` (the reference's own ``imp_batched`` is off on jax 0.9.0,
  ROADMAP R1), and its two-level lines the reference's
  ``compare_two_level`` under host ``imp``.

Both examples import neither ``jax`` nor ``repro``.
"""
import importlib.util
import os
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
DEMO = ROOT / "examples" / "torch_preemption_demo.py"
COLOCATED = ROOT / "examples" / "torch_colocated_serving.py"


def _run(*args) -> str:
    proc = subprocess.run([sys.executable, *map(str, args)], cwd=ROOT,
                          env=ENV, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


@pytest.fixture(scope="module")
def reference_demo() -> str:
    return _run(ROOT / "examples" / "preemption_demo.py")


def test_demo_matches_reference(reference_demo):
    out = _run(DEMO, "--device", "cpu")
    mapped = re.sub(r"engine=imp_batched\b", "engine=imp", out)
    assert mapped.splitlines() == reference_demo.splitlines()
    assert "C-7" in out and "custom engine chose machine" in out


def test_examples_import_no_jax():
    code = ("import runpy, sys; sys.argv = ['demo', '--device', 'cpu']; "
            f"runpy.run_path({str(DEMO)!r}, run_name='__main__'); "
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro' "
            "or m.startswith(('jax.', 'repro.'))]; "
            "assert not bad, bad")
    _run("-c", code)
    for path in (DEMO, COLOCATED):
        src = path.read_text()
        assert not re.search(r"^\s*(from|import) (jax|repro)\b", src, re.M)


def _load_colocated():
    spec = importlib.util.spec_from_file_location("torch_colocated", COLOCATED)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_colocated_serving_matches_reference(capsys):
    from repro.core.colocation import ColocationConfig as RefConfig
    from repro.core.colocation import compare_day_cycle as ref_compare
    from repro.core.colocation import compare_two_level as ref_two_level

    mod = _load_colocated()
    got = mod.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()

    rcfg = RefConfig(num_nodes=12, seed=0, horizon_hours=24.0, engine="imp")
    ref = ref_compare(rcfg, engines=("imp", "godel"))
    ref = dict(ref, reports={("imp_batched" if k == "imp" else k): v
                             for k, v in ref["reports"].items()})
    want = mod.ab_lines(ref)
    start = out.index(want[0])
    assert out[start:start + len(want)] == want
    for name, rep in got["ab"]["reports"].items():
        metrics = dict(rep.key_metrics(), engine=None)
        assert metrics == dict(ref["reports"][name].key_metrics(),
                               engine=None), name

    want = mod.two_level_lines(ref_two_level(rcfg))
    start = out.index(want[0])
    assert out[start:start + len(want)] == want
    assert got["ab"]["uplift"] > 0
    tiers = [line for line in out if line.startswith("  tier ")]
    assert len(tiers) == 3 and got["raw_tok_per_s"] > 0
