"""The one traffic generator: a pool of calls of pairs from a traffic
file's parameters and the run's seed, vectorised with numpy.

Parameters (``benchmark/traffic/<mix>.json``):

* ``pool_calls`` calls of ``pairs_per_call`` pairs each;
* ``length``: ``{"fixed": L}``, or ``{"lognormal": {"median", "sigma",
  "min", "max"}, "sizes_seed": s}``: seq_1's lengths, drawn from
  ``sizes_seed`` so that every run seed gets the same lengths, which the
  run seed only shuffles;
* ``edits``: ``{"count": K}``: K edits a pair, each a substitution, an
  insertion or a deletion with equal chance at a uniform position of
  seq_1 (WFA2-lib's ``generate_dataset``; edits that land on one position
  both apply), or ``{"rates": {"substitution": p, "indel": q}}``: each
  position of seq_1 substituted with chance p, deleted with chance q/2,
  and given an inserted letter before it with chance q/2.

Letters are drawn from the configuration's ``letters``, uniformly or, with
``frequencies`` (a letter's share, by letter), in those shares; a
substitution always changes the letter, to one drawn the same way.
"""

from __future__ import annotations

import numpy as np


def _lengths(spec: dict, count: int, rng) -> np.ndarray:
    if "fixed" in spec:
        return np.full(count, int(spec["fixed"]), np.int64)
    law = spec["lognormal"]
    sizes = np.random.default_rng(int(spec["sizes_seed"]))
    drawn = sizes.lognormal(np.log(law["median"]), law["sigma"], count)
    lengths = np.clip(np.rint(drawn), law["min"], law["max"]).astype(np.int64)
    return lengths[rng.permutation(count)]


def _edits(spec: dict, lengths: np.ndarray, starts: np.ndarray, rng):
    """Flat positions of substitutions and deletions in seq_1's letters,
    and of insertions (before that flat position), with each insertion's
    pair."""
    if "count" in spec:
        k = int(spec["count"])
        pair = np.repeat(np.arange(len(lengths)), k)
        kind = rng.integers(0, 3, pair.size)
        span = lengths[pair] + (kind == 1)  # an insertion may go last
        pos = starts[pair] + (rng.random(pair.size) * span).astype(np.int64)
        return pos[kind == 0], pos[kind == 2], pos[kind == 1], pair[kind == 1]
    rates = spec["rates"]
    total = int(lengths.sum())
    draw = rng.random(total)
    p_sub, half = rates["substitution"], rates["indel"] / 2
    sub = np.flatnonzero(draw < p_sub)
    dele = np.flatnonzero((draw >= p_sub) & (draw < p_sub + half))
    ins = np.flatnonzero(rng.random(total) < half)
    pair = np.searchsorted(starts, ins, side="right") - 1
    return sub, dele, ins, pair


def _letters(rng, count: int, size: int, p) -> np.ndarray:
    if p is None:
        return rng.integers(0, size, count, dtype=np.uint8)
    return rng.choice(size, count, p=p).astype(np.uint8)


def _substitute(rng, old: np.ndarray, size: int, p) -> np.ndarray:
    if p is None:
        return (old + rng.integers(1, size, old.size, dtype=np.uint8)) % size
    new = _letters(rng, old.size, size, p)
    while (clash := new == old).any():
        new[clash] = _letters(rng, int(clash.sum()), size, p)
    return new


def generate(traffic: dict, letters: str, seed: int) -> list[list[tuple[str, str]]]:
    """``traffic['pool_calls']`` lists of ``traffic['pairs_per_call']``
    (seq_1, seq_2) pairs."""
    rng = np.random.default_rng(seed)
    count = int(traffic["pool_calls"]) * int(traffic["pairs_per_call"])
    alphabet = np.frombuffer(letters.encode("ascii"), np.uint8)
    size = len(alphabet)
    p = None
    if "frequencies" in traffic:
        p = np.array([traffic["frequencies"][c] for c in letters], np.float64)
        p /= p.sum()
    lengths = _lengths(traffic["length"], count, rng)
    starts = np.concatenate(([0], np.cumsum(lengths)[:-1]))
    one = _letters(rng, int(lengths.sum()), size, p)

    sub, dele, ins, ins_pair = _edits(traffic["edits"], lengths, starts, rng)
    two = one.copy()
    two[sub] = _substitute(rng, two[sub], size, p)
    keep = np.ones(one.size, bool)
    keep[dele] = False
    # Insertions at the end of pair p share a flat position with those at
    # the start of pair p+1: pair p's go first.
    order = np.lexsort((ins_pair, ins))
    ins, ins_pair = ins[order], ins_pair[order]
    new = _letters(rng, ins.size, size, p)
    two = np.insert(two, ins, new)[np.insert(keep, ins, True)]
    deleted = np.add.reduceat((~keep).astype(np.int64), starts)
    lengths_2 = lengths - deleted + np.bincount(ins_pair, minlength=count)
    if (lengths_2 <= 0).any():
        raise ValueError("an edit left seq_2 empty")

    text_1 = alphabet[one].tobytes().decode("ascii")
    text_2 = alphabet[two].tobytes().decode("ascii")
    ends_1, ends_2 = np.cumsum(lengths).tolist(), np.cumsum(lengths_2).tolist()
    pairs = [(text_1[a:b], text_2[c:d]) for a, b, c, d in
             zip([0] + ends_1[:-1], ends_1, [0] + ends_2[:-1], ends_2)]
    per = int(traffic["pairs_per_call"])
    return [pairs[k:k + per] for k in range(0, count, per)]
