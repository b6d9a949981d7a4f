"""The traffic generator: deterministic per seed, and true to each traffic
file's lengths and edits."""

import json

import numpy as np
import pytest

from benchmark.harness import core, traffic

from .conftest import CELLS, tiny_traffic


def files():
    out = {}
    for cell in CELLS:
        c, config, tr, _ = core.cell_parts(cell)
        out[c["traffic"]] = (tr, config["letters"])
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_deterministic_per_seed(cell):
    _, config, _, _ = core.cell_parts(cell)
    tr = tiny_traffic(cell)
    a = traffic.generate(tr, config["letters"], 2 ** 31 + 11)
    assert a == traffic.generate(tr, config["letters"], 2 ** 31 + 11)
    assert a != traffic.generate(tr, config["letters"], 2 ** 31 + 12)
    assert len(a) == tr["pool_calls"] and all(len(c) == tr["pairs_per_call"] for c in a)
    letters = set(config["letters"])
    assert all(set(x) <= letters and set(y) <= letters for c in a for x, y in c)


def test_fixed_lengths_and_edit_counts():
    tr = {"pairs_per_call": 50, "pool_calls": 4, "length": {"fixed": 200},
          "edits": {"count": 10}}
    pool = traffic.generate(tr, "ACGT", 7)
    m = np.array([len(a) for c in pool for a, _ in c])
    n = np.array([len(b) for c in pool for _, b in c])
    assert (m == 200).all()
    assert (np.abs(n - 200) <= 10).all() and n.std() > 0


def test_lognormal_sizes_are_the_seeds_shuffle():
    tr = {"pairs_per_call": 64, "pool_calls": 8,
          "length": {"lognormal": {"median": 300, "sigma": 0.6, "min": 30, "max": 4000},
                     "sizes_seed": 0},
          "edits": {"rates": {"substitution": 0.68, "indel": 0.05}}}
    letters = "ARNDCQEGHILKMFPSTWYV"
    a = [len(x) for c in traffic.generate(tr, letters, 1) for x, _ in c]
    b = [len(x) for c in traffic.generate(tr, letters, 2) for x, _ in c]
    assert a != b and sorted(a) == sorted(b)
    assert min(a) >= 30 and max(a) <= 4000
    assert 250 < np.median(a) < 350


def test_rates_are_met():
    tr = {"pairs_per_call": 200, "pool_calls": 1, "length": {"fixed": 500},
          "edits": {"rates": {"substitution": 0.3, "indel": 0.05}}}
    pool = traffic.generate(tr, "ARNDCQEGHILKMFPSTWYV", 3)
    n = np.array([len(b) for _, b in pool[0]])
    assert abs(n.mean() - 500) < 5  # insertions and deletions balance
    subs = np.mean([sum(x != y for x, y in zip(a, b)) / len(a)
                    for a, b in pool[0] if len(a) == len(b)] or [0.3])
    assert subs > 0.25


def test_frequencies_are_met():
    freq = {"A": 0.5, "C": 0.3, "G": 0.15, "T": 0.05}
    tr = {"pairs_per_call": 100, "pool_calls": 1, "length": {"fixed": 1000},
          "edits": {"rates": {"substitution": 0.5, "indel": 0.0}}, "frequencies": freq}
    pool = traffic.generate(tr, "ACGT", 5)
    one = "".join(a for a, _ in pool[0])
    for letter, share in freq.items():
        assert abs(one.count(letter) / len(one) - share) < 0.01
    subs = [sum(x != y for x, y in zip(a, b)) / len(a) for a, b in pool[0]]
    assert abs(np.mean(subs) - 0.5) < 0.01  # a substitution always changes the letter


@pytest.mark.parametrize("name", sorted(files()))
def test_traffic_files_match_their_sources(name):
    tr, letters = files()[name]
    if tr["driver"] == "align_pairs":  # the runner's chunks, the proteins' sources
        assert tr["pairs_per_call"] == 1024 and tr["pool_calls"] == 64
        assert tr["edits"]["rates"]["substitution"] == 0.68
        assert sorted(tr["frequencies"]) == sorted(letters)
        assert abs(sum(tr["frequencies"].values()) - 1) < 1e-9
    else:  # WFA's 10K set
        assert tr["length"] == {"fixed": 10000} and tr["edits"] == {"count": 500}
        assert tr["pool_calls"] * tr["pairs_per_call"] >= 2048
    assert tr["source"] and json.dumps(tr)
