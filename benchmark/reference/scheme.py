"""The costs of a configuration, worked out again from its own values.

globalign's documented model (its README and tutorial): an alignment is
priced in cost space, where every letter pair, every letter against a gap
and the gap-open step has a non-negative cost, and its score follows from
its cost by the scores transform of Akulov and Groot Koerkamp
(curiouscoding.nl, "alignment scores transform"): with ``b`` the largest
entry of the scoring matrix, ``delta_d = floor(b/2)`` and ``delta_i =
ceil(b/2)``,

    cost(x, y)   = -score(x, y) + delta_d + delta_i    (letters; gap/gap)
    cost('-', y) = -score('-', y) + delta_d            (gap in seq_1)
    cost(x, '-') = -score(x, '-') + delta_i            (gap in seq_2)
    score        = n * delta_d + m * delta_i - cost    (seq_1 of m letters)

and the gap-open cost is minus the gap-open score.  A scheme given in costs
(``mismatch_cost`` ...) is turned into scores with ``b`` the default match
score, 2, as globalign does.  Nothing here comes from the program.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

GAP = "-"
CONFIG_DIR = Path(__file__).resolve().parents[1] / "configs"

# globalign's defaults (README, "Scoring"): simple scores and simple costs.
DEFAULT_SCORES = {"match_score": 2, "mismatch_score": -3, "gap_open_score": -4,
                  "gap_extension_score": -2}
DEFAULT_COSTS = {"mismatch_cost": 5, "gap_open_cost": 4, "gap_extension_cost": 3}
COST_KEYS = ("mismatch_cost", "gap_open_cost", "gap_extension_cost")


@dataclass(frozen=True)
class Costing:
    """A scheme in cost space over ``letters`` (the gap last).

    ``cost[x, y]`` for letter indices; ``gap`` is the gap's index, so
    ``cost[gap, y]`` prices a letter of seq_2 against a gap and
    ``cost[x, gap]`` a letter of seq_1 against a gap.
    """

    letters: str
    cost: np.ndarray
    gap_open: int
    max_score: int

    @property
    def gap(self) -> int:
        return len(self.letters) - 1

    def lut(self) -> np.ndarray:
        """Byte value -> letter index (-1 for a letter outside the scheme)."""
        table = np.full(256, -1, np.int64)
        for k, letter in enumerate(self.letters[:-1]):
            table[ord(letter)] = k
        return table

    def score(self, cost: int, m: int, n: int) -> int:
        delta_d, delta_i = self.max_score // 2, -(-self.max_score // 2)
        return n * delta_d + m * delta_i - cost


def read_matrix(path: Path) -> tuple[str, np.ndarray]:
    """A whitespace scoring-matrix file: a header of letters, then one row a
    letter; lines starting with ``#`` are comments."""
    rows = [line.split() for line in path.read_text().splitlines()
            if line.strip() and not line.lstrip().startswith("#")]
    letters = [x.upper() for x in rows[0]]
    values = np.array([[int(v) for v in row[1:]] for row in rows[1:]], np.int64)
    if [row[0].upper() for row in rows[1:]] != letters or values.shape != (
            len(letters), len(letters)):
        raise ValueError(f"{path}: malformed scoring matrix")
    return "".join(letters), values


def _to_costs(letters: str, scores: np.ndarray, gap_open_score: int,
              b: int) -> Costing:
    """Scores over ``letters`` (gap included anywhere) to a cost scheme with
    the gap moved last; ``b`` sets the deltas."""
    order = [k for k, x in enumerate(letters) if x != GAP] + [letters.index(GAP)]
    scores = scores[np.ix_(order, order)]
    delta_d, delta_i = b // 2, -(-b // 2)
    add = np.full(scores.shape, delta_d + delta_i, np.int64)
    add[-1, :] = delta_d
    add[:, -1] = delta_i
    add[-1, -1] = delta_d + delta_i
    return Costing("".join(letters[k] for k in order), add - scores,
                   -int(gap_open_score), int(scores.max()))


def resolve(scheme: dict, letters: str) -> Costing:
    """The cost scheme of a configuration's ``scheme`` (the program's
    keyword options) over the sequences' ``letters``."""
    if "scoring_mat_name" in scheme:
        names, scores = read_matrix(CONFIG_DIR / f"{scheme['scoring_mat_name']}.mtx")
        missing = set(letters) - set(names)
        if missing:
            raise ValueError(f"letters outside the matrix: {sorted(missing)}")
        gap_open = scheme.get("gap_open_score", -scheme.get("gap_open_cost", 4))
        return _to_costs(names, scores, gap_open, int(scores.max()))
    alphabet = "".join(sorted(set(letters))) + GAP
    a = len(alphabet)
    if any(key in scheme for key in COST_KEYS):
        given = {**DEFAULT_COSTS, **scheme}
        cost = np.full((a, a), given["mismatch_cost"], np.int64)
        cost[-1, :] = cost[:, -1] = given["gap_extension_cost"]
        np.fill_diagonal(cost, 0)
        # The scores these costs stand for, with b the default match score.
        scores = np.full((a, a), 2, np.int64) - cost
        scores[-1, :] = scores[:, -1] = 1 - given["gap_extension_cost"]
        scores[-1, -1] = 2
        return Costing(alphabet, cost, int(given["gap_open_cost"]),
                       int(scores.max()))
    given = {**DEFAULT_SCORES, **scheme}
    scores = np.full((a, a), given["mismatch_score"], np.int64)
    scores[-1, :] = scores[:, -1] = given["gap_extension_score"]
    np.fill_diagonal(scores, given["match_score"])
    return _to_costs(alphabet, scores, given["gap_open_score"],
                     int(given["match_score"]))
