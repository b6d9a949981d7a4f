"""The plain reference: the tutorial's result, and agreement with the
program's CPU engine on seeded small pairs of both configurations."""

import json

import numpy as np
import pytest

from benchmark.harness import judge, traffic
from benchmark.reference import gotoh, scheme

CONFIGS = {
    "dna_wfa": {"pairs_per_call": 16, "pool_calls": 1, "length": {"fixed": 60},
                "edits": {"count": 6}},
    "protein_blosum62": {"pairs_per_call": 16, "pool_calls": 1,
                         "length": {"lognormal": {"median": 40, "sigma": 0.6,
                                                  "min": 5, "max": 120},
                                    "sizes_seed": 0},
                         "edits": {"rates": {"substitution": 0.68, "indel": 0.05}}},
}


def config(name):
    from benchmark.harness.core import ROOT

    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def pairs_of(name, seed):
    return traffic.generate(CONFIGS[name], config(name)["letters"], seed)[0]


def test_tutorial():
    costing = scheme.resolve({}, "ACGT")
    assert gotoh.align([("ACGT", "AGT")], costing) == [(7, 0, "ACGT", "| ||", "A-GT")]


def test_scheme_costs():
    dna = scheme.resolve(config("dna_wfa")["scheme"], "ACGT")
    assert dna.gap_open == 6 and dna.max_score == 2
    assert dna.cost[0, 0] == 0 and dna.cost[0, 1] == 4 and dna.cost[dna.gap, 0] == 2
    blosum = scheme.resolve(config("protein_blosum62")["scheme"], "ARND")
    assert blosum.max_score == 11 and blosum.gap_open == 4
    w = blosum.letters.index("W")
    assert blosum.cost[w, w] == 0  # 11 - 11
    assert blosum.cost[blosum.gap, w] == 9 and blosum.cost[w, blosum.gap] == 10


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5])
def test_agrees_with_cpu_engine(name, seed):
    import globalign_tpu_torch as port

    pairs = pairs_of(name, seed)
    expected = judge.reference(pairs, config(name), "cpu", True)
    got = port.align_pairs(pairs, device="cpu", **config(name)["scheme"])
    for pair, r in zip(pairs, got):
        assert (r.cost, r.score, r.seq_1_aligned, r.middle_part, r.seq_2_aligned) \
            == expected[pair]
    one = port.find_global_alignment(seq_1=pairs[0][0], seq_2=pairs[0][1],
                                     device="cpu", **config(name)["scheme"])
    assert (one.cost, one.score, one.seq_1_aligned, one.middle_part,
            one.seq_2_aligned) == expected[pairs[0]]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_groups_do_not_change_answers(name):
    pairs = pairs_of(name, 3)
    costing = scheme.resolve(config(name)["scheme"],
                             "".join(sorted(set("".join(a + b for a, b in pairs)))))
    whole = gotoh.align(pairs, costing)
    assert gotoh.align(pairs, costing, budget_bytes=20_000, max_pairs=3) == whole
    assert [x[:2] for x in gotoh.align(pairs, costing, traceback=False)] == \
        [x[:2] for x in whole]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_control_keeps_costs_and_breaks_ties(name):
    """The control (linear gaps) breaks costs, and the checks judge it not
    correct."""
    pairs = pairs_of(name, 4)
    expected = judge.reference(pairs, config(name), "cpu", True)
    control = judge.reference(pairs, config(name), "cpu", True, linear_gaps=True)
    checks = judge.compare([(p, control[p]) for p in pairs], expected, 0)
    assert checks["cost_mismatch"]["value"] > 0
    assert not judge.passed(checks)


def test_reference_imports_nothing_of_the_program():
    import subprocess
    import sys

    from benchmark.harness.core import ROOT

    code = ("import sys; sys.path.insert(0, '.'); import benchmark.reference.gotoh, "
            "benchmark.reference.scheme; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert "globalign_tpu_torch" not in out and "'jax'" not in out


def test_edit_distance_of_generated_pairs():
    """Unit costs make the reference an edit distance: WFA's K edits give at
    most K."""
    unit = scheme.resolve({"mismatch_cost": 1, "gap_open_cost": 0,
                           "gap_extension_cost": 1}, "ACGT")
    pairs = pairs_of("dna_wfa", 9)
    costs = np.array([c for c, *_ in gotoh.align(pairs, unit, traceback=False)])
    assert (costs <= 6).all() and costs.mean() > 3
