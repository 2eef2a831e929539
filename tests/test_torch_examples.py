"""The port's drivers (``repro_torch.examples``) against the reference's
``examples/`` on the CPU.

- ``quickstart`` and ``partition_plan`` (host only: the planner, the
  simulator, ``LLM.from_plan(kind="sim")``) print the reference
  examples' lines, both run in this process (the auto-assigned request
  uids counted from the first one's: each package's counter stands where
  the process's earlier requests left it); ``partition_plan`` with its
  defaults and three flag sets.  None of their lines carries a
  wall-clock time;
- ``serve_pipeline --device cpu`` passes its own check: every token of the
  planned stage pipeline equals the tensor backend's, and the streamed
  requests finish;
- ``train_tiny --device cpu`` for a few steps lowers its loss (its own
  assert), printing the reference's lines;
- without ``--device`` and without a GPU the model-running examples raise
  before any work.
"""
import importlib.util
import re
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import (partition_plan, quickstart,  # noqa: E402
                                  serve_pipeline, train_tiny)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _reference(name):
    """The reference's ``examples/<name>.py``, loaded as a module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_UID = re.compile(r"^  req (\d+):")


def _uids_from_first(text):
    """``text``'s lines, each ``req <uid>:`` line's uid replaced by its
    offset from the first one's: auto-assigned uids count on from wherever
    the process's counter stands (2**30 plus the requests made before)."""
    lines, first = [], None
    for line in text.splitlines():
        m = _UID.match(line)
        if m:
            first = int(m.group(1)) if first is None else first
            line = f"  req +{int(m.group(1)) - first}:" + line[m.end():]
        lines.append(line)
    return lines


def test_quickstart_prints_the_reference_lines(capsys):
    """Every line the reference's prints, the requests' uids counted from
    the first one's."""
    quickstart.main()
    got = capsys.readouterr().out
    _reference("quickstart").main()
    want = capsys.readouterr().out
    assert _uids_from_first(got) == _uids_from_first(want)
    assert sum(line.startswith("  req +") for line
               in _uids_from_first(got)) == 3
    assert "EdgeShard plan" in got and "simulated throughput" in got


@pytest.mark.parametrize("argv", [
    [], ["--objective", "throughput", "--cloud-bw", "10"], ["--int8"],
    ["--arch", "llama2-13b", "--objective", "throughput", "--cloud-bw",
     "10"]], ids=["defaults", "throughput-10", "int8", "13b"])
def test_partition_plan_prints_the_reference_lines(argv, capsys,
                                                   monkeypatch):
    partition_plan.main(argv)
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["partition_plan.py"] + argv)
    _reference("partition_plan").main()
    want = capsys.readouterr().out
    assert got.splitlines() == want.splitlines()
    assert got.startswith(("llama2", "INFEASIBLE"))


def test_serve_pipeline_passes_its_own_check(capsys):
    serve_pipeline.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "all pipeline tokens match the tensor backend — OK" in out
    assert out.startswith("stage layout (periods per stage): (")
    assert sum("<length>" in line for line in out.splitlines()) == 2


def test_train_tiny_lowers_its_loss(capsys):
    metrics = train_tiny.main(["--device", "cpu", "--steps", "10"])
    out = capsys.readouterr().out
    assert metrics["final_loss"] < metrics["first_loss"]
    assert out.startswith("model: 0.9M params (4L d=128)")
    assert "first loss" in out.splitlines()[-1]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
@pytest.mark.parametrize("example", [serve_pipeline, train_tiny],
                         ids=["serve_pipeline", "train_tiny"])
def test_the_card_is_the_default_device(example):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])
