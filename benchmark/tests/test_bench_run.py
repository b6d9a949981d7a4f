"""Whole runs on the CPU: the harness refuses to run without a card, and
with the card's look skipped it judges a sound program correct and a
broken one not; no forbidden module is loaded."""

import json
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from benchmark.control import Control
from benchmark.harness import core, judge

from .conftest import CELLS, ROOT, tiny_traffic


def test_no_card_no_result(tmp_path):
    """Without a card (this test's machine), run.py fails and prints no
    result; so does a checkout that holds only the benchmark."""
    cmd = [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
           "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"]
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    done = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    assert done.returncode != 0 and done.stdout.strip() == ""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    done = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True)
    assert done.returncode != 0 and done.stdout.strip() == ""


def run(cell, port=None, trace=False, seed=2 ** 31 + 21, mix=None):
    code, result = core.run_cell(cell, seed, 0.3, trace, t_start=time.perf_counter(),
                                 device="cpu", port=port, traffic=tiny_traffic(cell, mix))
    assert code == 0
    return result


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_program_is_correct(cell, trace):
    result = run(cell, trace=trace)
    assert result["correct"] and result["failed"] == 0
    assert list(result)[-1] == "checks"
    _, _, _, specs = core.cell_parts(cell)
    want = specs["per_layer" if trace else "end_to_end"]
    assert set(result["metrics"]) <= {m["name"] for m in want}
    if not trace:
        assert set(result["metrics"]) == {m["name"] for m in want}
    json.dumps(result)
    assert core.forbidden_modules() == []


class Broken:
    """The program with one fault where its answers are produced."""

    def __init__(self, fault):
        import globalign_tpu_torch as port

        self.port, self.fault, self.last = port, fault, None
        self.resolve_scheme = port.resolve_scheme

    def _alter(self, results):
        results = list(results)
        k = len(results) // 2
        if self.fault == "stale":  # the state of the last call, unchanged
            last, self.last = self.last, results
            return last if last is not None else results
        if self.fault == "half":  # half of the batch left out
            return results[: len(results) // 2]
        r = results[k]
        if self.fault == "cost":
            results[k] = type(r)(**{**vars(r), "cost": r.cost + 1}) if hasattr(r, "__dict__") \
                else r._replace(cost=r.cost + 1)
        elif self.fault == "letter":
            line = r.seq_1_aligned
            swap = "A" if line[0] != "A" else "C"
            new = swap + line[1:]
            results[k] = type(r)(**{**vars(r), "seq_1_aligned": new}) \
                if hasattr(r, "__dict__") else r._replace(seq_1_aligned=new)
        return results

    def align_pairs(self, pairs, flush=True, **options):
        out = self._alter(self.port.align_pairs(pairs, **options))
        return out if flush else SimpleNamespace(resolve=lambda: out)

    def find_global_alignment(self, **options):
        return self._alter([self.port.find_global_alignment(**options)])[0]


# (cell, mix run in its place or None, faults): the traceback mix of the
# batch path (traffic/protein_rv12_tb.json) keeps its lines judged.
FAULTS = [("protein.batch_cost", "protein_rv12_tb", ["stale", "half", "cost", "letter"]),
          ("protein.batch_cost", None, ["stale", "half", "cost"]),
          ("dna.pair_align", None, ["stale", "cost", "letter"])]


@pytest.mark.parametrize("cell,mix,fault",
                         [(c, m, f) for c, m, fs in FAULTS for f in fs])
def test_broken_program_is_not_correct(cell, mix, fault):
    result = run(cell, port=Broken(fault), mix=mix)
    assert not result["correct"]
    assert not judge.passed(result["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """At a size a test run holds; on the card, benchmark/control.py."""
    result = None
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        result = run(cell, port=Control(cell, device="cpu"), seed=seed)
        assert not result["correct"]
        assert result["checks"]["cost_mismatch"]["value"] > 0


def test_hygiene_after_a_dry_run():
    """A fresh process that runs every cell's generator, driver and
    reference on the CPU loads no JAX, no globalign_tpu, no globalign."""
    code = f"""
import sys, time
sys.path.insert(0, {str(ROOT)!r})
sys.path.insert(0, {str(ROOT / 'benchmark')!r})
from benchmark.harness import core
from tests.conftest import tiny_traffic
for cell in {CELLS!r}:
    core.run_cell(cell, 5, 0.2, False, t_start=time.perf_counter(), device="cpu",
                  traffic=tiny_traffic(cell))
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout.splitlines()[-1]
    loaded = set(eval(out))
    assert "globalign_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "globalign_tpu", "globalign"}


def test_on_card(card):
    """On a card: one short run of each cell is correct."""
    for cell in CELLS:
        done = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
             str(2 ** 31 + 77), "--seconds", "2", "--trace", "0"],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        assert done.returncode == 0, done.stderr[-2000:]
        assert json.loads(done.stdout.strip().splitlines()[-1])["correct"]


def test_sample_is_a_seeded_reservoir():
    """The sample keeps its size, the same answers for one seed, and draws
    from every call of the window, not only the first."""
    def kept(seed):
        sample = judge.Sample({"sample": {"reservoir": 16}}, seed)
        for k in range(200):
            calls = [(f"{k}.{i}", "") for i in range(10)]
            sample.offer(calls, lambda i, k=k: k)
        return sample.answers()

    a = kept(2 ** 31 + 5)
    assert len(a) == 16 and a == kept(2 ** 31 + 5) and a != kept(7)
    assert max(got for _, got in a) >= 100
