"""Which answers are kept from the window, and their comparison with the
plain reference (``benchmark/reference``).

Every number compared has a limit: counts of wrong or missing answers may
not pass 0 (the configurations state exact costs, scores and, with their
tie order, exact alignments), and at least one answer is compared.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

from ..reference import gotoh, scheme


class Sample:
    """The answers a run keeps: a reservoir of ``traffic['sample']['reservoir']``
    answers, uniform over every answer the window resolves, drawn from the
    seed (Algorithm R, one offer a pair in the order the answers come)."""

    def __init__(self, traffic: dict, seed: int):
        self.size = int(traffic["sample"]["reservoir"])
        self.rng = np.random.default_rng([seed, 1])
        self.seen = 0
        self.kept = {}  # slot -> (pair, answer)

    def offer(self, pairs, answer) -> None:
        """Offer a call's ``pairs``; ``answer(i)`` is pair i's answer, or
        None where it is missing, read only for the pairs kept."""
        t = self.seen + np.arange(len(pairs))
        slot = np.where(t < self.size, t,
                        (self.rng.random(len(pairs)) * (t + 1)).astype(np.int64))
        self.seen += len(pairs)
        for i in np.flatnonzero(slot < self.size).tolist():
            self.kept[int(slot[i])] = (pairs[i], answer(i))

    def answers(self) -> list:
        return [self.kept[s] for s in sorted(self.kept)]


def reference(pairs, config: dict, device: str, with_lines: bool,
              linear_gaps: bool = False) -> dict:
    """The reference's answer for each distinct pair; with ``linear_gaps``
    the control's, which prices a gap without its open cost and so breaks
    the configurations' affine costs."""
    distinct = list(dict.fromkeys(pairs))
    letters = "".join(sorted(set("".join(a + b for a, b in distinct))))
    costing = scheme.resolve(config["scheme"], letters)
    if linear_gaps:
        costing = dataclasses.replace(costing, gap_open=0)
    budget = 8 << 30 if device == "cuda" else 256 << 20
    out = gotoh.align(distinct, costing, traceback=with_lines, device=device,
                      budget_bytes=budget)
    return dict(zip(distinct, out))


def compare(answers, expected: dict, failed_pairs: int) -> dict:
    """The checks: each a value and its limit."""
    counts = dict(missing=0, cost_mismatch=0, score_mismatch=0, line_mismatch=0)
    first = None
    for pair, got in answers:
        want = expected[pair]
        if got is None:
            counts["missing"] += 1
            continue
        bad = [got[0] != want[0], got[1] != want[1], tuple(got[2:]) != tuple(want[2:])]
        for key, flag in zip(("cost_mismatch", "score_mismatch", "line_mismatch"), bad):
            counts[key] += int(flag)
        if any(bad) and first is None:
            first = (len(pair[0]), len(pair[1]), got[:2], want[:2])
    if first is not None:
        print(f"first mismatch: m={first[0]} n={first[1]} program (cost, score)"
              f" {first[2]} reference {first[3]}", file=sys.stderr)
    checks = {"compared": {"value": len(answers), "limit": 1, "rule": ">="}}
    for key, value in counts.items():
        checks[key] = {"value": value, "limit": 0, "rule": "<="}
    checks["failed"] = {"value": failed_pairs, "limit": 0, "rule": "<="}
    return checks


def judge(answers, records, config: dict, device: str, with_lines: bool) -> dict:
    expected = reference([pair for pair, _ in answers], config, device, with_lines)
    return compare(answers, expected, sum(r.pairs for r in records if not r.ok))


def passed(checks: dict) -> bool:
    return all(c["value"] >= c["limit"] if c["rule"] == ">=" else c["value"] <= c["limit"]
               for c in checks.values())


def report(checks: dict) -> str:
    """The checks as lines: name, value, rule, limit."""
    return "\n".join(f"check {name} {c['value']} {c['rule']} {c['limit']}"
                     for name, c in checks.items())
