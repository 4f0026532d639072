"""The port's gate runner (mimm_tpu_torch/tools/run_gates.py) and its gates.

* ``GATES`` names the three gates, each file exists, and each opt-in
  variable is the one its file reads: with it set the full-width case
  runs, without it that case skips, naming the variable, while the narrow
  case runs (tier-1 runs the narrow cases).
* ``run_gates --only <gate>`` runs the gate's file with its variable set
  and appends one record to ``--out``: passed, the wall seconds, the
  pytest tail and the JSON figures the tests printed (a tiny gate here).

The runner imports the port (torch), so it runs in a jax-free child
(tests/torch_port_child.py).
"""

import importlib
import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE_NAMES = ("mesh", "multihost", "prodshape")
OPT_IN = ("mesh", "prodshape")
TINY_GATE = '''import json
import os


def test_tiny():
    print(json.dumps({"var": os.environ.get("MIMM_TINY_GATE")}))
'''


@pytest.fixture(scope="module")
def child(tmp_path_factory):
    from tests.torch_port_child import remove_job, run_child

    job = str(tmp_path_factory.mktemp("run_gates"))
    _, meta = run_child(__file__, job, timeout=600)
    yield meta
    remove_job(job)


def test_gates_are_named(child):
    assert sorted(child["gates"]) == sorted(GATE_NAMES)


@pytest.mark.parametrize("name", GATE_NAMES)
def test_gate_file_exists(child, name):
    _, test_file = child["gates"][name]
    assert os.path.isfile(os.path.join(REPO, test_file)), test_file


@pytest.mark.parametrize("name", OPT_IN)
def test_gate_variable_is_the_one_its_file_reads(child, name, monkeypatch):
    var, test_file = child["gates"][name]
    module = importlib.import_module(
        test_file.removesuffix(".py").replace("/", "."))
    assert module.GATE_VAR == var
    monkeypatch.delenv(var, raising=False)
    assert module.skip_reason("narrow") is None
    assert f"set {var}=1" in module.skip_reason("bert_base")
    monkeypatch.setenv(var, "1")
    assert module.skip_reason("bert_base") is None


def test_multihost_gate_needs_no_variable(child):
    assert child["gates"]["multihost"][0] is None


def test_run_gates_appends_a_passing_record(child):
    rec = child["record"]
    assert child["rc"] == 0
    assert rec["gate"] == "tiny" and rec["passed"] is True, rec
    assert rec["returncode"] == 0 and rec["wall_seconds"] > 0
    assert rec["figures"] == [{"var": "1"}], rec
    assert "1 passed" in rec["pytest_tail"][-1], rec


# ---- the port side ----------------------------------------------------------

def _child(job):
    from mimm_tpu_torch.tools import run_gates

    meta = {"gates": {k: list(v) for k, v in run_gates.GATES.items()}}
    tiny = os.path.join(job, "tiny_gate_test.py")
    with open(tiny, "w") as f:
        f.write(TINY_GATE)
    run_gates.GATES = {"tiny": ("MIMM_TINY_GATE", tiny)}
    out = os.path.join(job, "gates.jsonl")
    meta["rc"] = run_gates.main(["--only", "tiny", "--out", out,
                                 "--timeout", "300"])
    with open(out) as f:
        records = [json.loads(line) for line in f]
    assert len(records) == 1, records
    meta["record"] = records[0]
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump(meta, f)
    import numpy as np

    np.savez(os.path.join(job, "out.npz"))


if __name__ == "__main__":
    _child(sys.argv[1])
