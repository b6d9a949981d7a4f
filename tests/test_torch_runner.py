"""The port's batch runner and CLI, on the CPU, against the JAX package's.

Mirrors ``tests/test_runner.py:40-320`` for
``globalign_tpu_torch.runner.BatchRunner(device="cpu")`` and
``python -m globalign_tpu_torch.batch_cli --device cpu``, and holds the
results TSV and the manifest fingerprint byte for byte to the JAX runner's
on the same input.  Not mirrored: ``--fuse_chunks`` (the JAX package's
opt-in chunk fusion, always on in the port, so the CLI has no such switch).
``--shard`` and ``--distributed`` are
held to the JAX runner in ``tests/test_torch_multihost.py``.
"""

import json

import numpy as np
import pytest
import torch

from globalign_tpu import runner as jax_runner
from globalign_tpu.batch_cli import main as jax_cli
from globalign_tpu_torch import find_global_alignment
from globalign_tpu_torch import runner as runner_mod
from globalign_tpu_torch.batch_cli import main as cli
from globalign_tpu_torch.parallel.multihost import owns_chunk, part_path
from globalign_tpu_torch.runner import (
    BatchRunner,
    RunStats,
    pairs_from_fasta,
    pairs_from_tsv,
)


def _random_pairs(n, seed=0, max_len=24):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m = int(rng.integers(1, max_len))
        k = int(rng.integers(1, max_len))
        out.append(
            (
                "".join(rng.choice(list("ACGT"), m)),
                "".join(rng.choice(list("ACGT"), k)),
            )
        )
    return out


def _read_results(path):
    rows = {}
    for line in path.read_text().splitlines():
        parts = line.split("\t")
        rows[int(parts[0])] = (int(parts[1]), int(parts[2]))
    return rows


def _runner(out, log, **kw):
    return BatchRunner(output=out, log=log, device="cpu", **kw)


def _fingerprints(manifest):
    return {json.loads(x)["fingerprint"] for x in manifest.read_text().splitlines()}


def test_runner_results_match_single_pair_api(tmp_path):
    pairs = _random_pairs(7, seed=1)
    out = tmp_path / "res.tsv"
    with open(tmp_path / "log", "w") as log:
        stats = _runner(out, log, chunk_pairs=3).run(pairs)
    assert stats.pairs == 7 and stats.chunks == 3
    rows = _read_results(out)
    assert len(rows) == 7
    for idx, (s1, s2) in enumerate(pairs):
        ref = find_global_alignment(seq_1=s1, seq_2=s2, device="cpu")
        assert rows[idx] == (ref.cost, ref.score), (idx, s1, s2)


@pytest.mark.parametrize("kw", [
    dict(chunk_pairs=3),
    dict(chunk_pairs=4, with_traceback=True),
    dict(chunk_pairs=5, with_traceback=True, emit_cigar=True),
    dict(chunk_pairs=8, scheme_kwargs={"mismatch_cost": 9}, bucket_quantum=8),
    dict(chunk_pairs=2, with_traceback=True,
         scheme_kwargs={"scoring_mat_name": "BLOSUM62"}),
])
def test_results_and_manifest_match_the_jax_runner(tmp_path, kw):
    """Same input, same options: the same results TSV, byte for byte, and
    the same fingerprint on every journal line."""
    rng = np.random.default_rng(len(str(kw)))
    letters = list("ARNDCQEGHILKMFPSTWYV" if "scheme_kwargs" in kw and
                   "scoring_mat_name" in kw["scheme_kwargs"] else "ACGT")
    pairs = [
        tuple("".join(rng.choice(letters, int(rng.integers(1, 40))))
              for _ in range(2))
        for _ in range(11)
    ]
    port_out, jax_out = tmp_path / "port.tsv", tmp_path / "jax.tsv"
    with open(tmp_path / "log", "w") as log:
        port = _runner(port_out, log, **kw)
        port.run(pairs)
        jax = jax_runner.BatchRunner(output=jax_out, log=log, **kw)
        jax.run(pairs)
    assert port_out.read_bytes() == jax_out.read_bytes()
    assert _fingerprints(port.manifest_path) == _fingerprints(jax.manifest_path) == {
        port._fingerprint()
    }


def test_runner_resumes_a_jax_run(tmp_path):
    """A manifest journaled by the JAX runner resumes under the port's."""
    pairs = _random_pairs(10, seed=2)
    out = tmp_path / "res.tsv"
    with open(tmp_path / "log", "w") as log:
        jax_runner.BatchRunner(output=out, chunk_pairs=4, log=log).run(pairs[:8])
        stats = _runner(out, log, chunk_pairs=4).run(pairs)
    assert stats.skipped_chunks == 2 and stats.chunks == 1
    assert len(_read_results(out)) == 10


def test_runner_resume_skips_journaled_chunks(tmp_path):
    pairs = _random_pairs(10, seed=2)
    out = tmp_path / "res.tsv"
    with open(tmp_path / "log", "w") as log:
        # First run: only the first 2 chunks (simulated preemption).
        _runner(out, log, chunk_pairs=4).run(pairs[:8])
        assert len(out.read_text().splitlines()) == 8
        # Rerun over the full input: chunks 0/1 skipped, chunk 2 done.
        stats = _runner(out, log, chunk_pairs=4).run(pairs)
    assert stats.skipped_chunks == 2
    assert stats.chunks == 1
    assert len(_read_results(out)) == 10  # no duplicates, all pairs present
    manifest = [
        json.loads(x)
        for x in (tmp_path / "res.tsv.manifest.jsonl").read_text().splitlines()
    ]
    assert sorted(m["chunk"] for m in manifest) == [0, 1, 2]


def test_runner_manifest_fingerprint_isolation(tmp_path):
    """Reusing an output produced under different options must error."""
    pairs = _random_pairs(4, seed=3)
    out = tmp_path / "res.tsv"
    with open(tmp_path / "log", "w") as log:
        _runner(out, log, chunk_pairs=4,
                scheme_kwargs={"mismatch_cost": 9}).run(pairs)
        with pytest.raises(RuntimeError, match="different\\s+options"):
            _runner(out, log, chunk_pairs=4).run(pairs)


def test_runner_traceback_mode(tmp_path):
    pairs = [("ACGT", "AGT"), ("AAAA", "AA")]
    out = tmp_path / "res.tsv"
    with open(tmp_path / "log", "w") as log:
        _runner(out, log, chunk_pairs=8, with_traceback=True).run(pairs)
    line0 = out.read_text().splitlines()[0].split("\t")
    assert line0[:3] == ["0", "7", "0"]
    assert line0[3:] == ["ACGT", "| ||", "A-GT"]


def test_pairs_from_tsv_and_fasta(tmp_path):
    tsv = tmp_path / "p.tsv"
    tsv.write_text("ACGT\tAGT\n\nAA\tA\n")
    assert list(pairs_from_tsv(tsv)) == [("ACGT", "AGT"), ("AA", "A")]
    bad = tmp_path / "bad.tsv"
    bad.write_text("onlyone\n")
    with pytest.raises(RuntimeError, match="expected 'seq1<TAB>seq2'"):
        list(pairs_from_tsv(bad))

    fa = tmp_path / "p.fasta"
    fa.write_text(">a\nACGT\n>b\nAGT\n>c\nAA\n>d\nA\n")
    assert list(pairs_from_fasta(fa)) == [("ACGT", "AGT"), ("AA", "A")]


def test_batch_cli_end_to_end(tmp_path):
    tsv = tmp_path / "p.tsv"
    tsv.write_text("ACGT\tAGT\nGATTACA\tGCATGCT\n")
    out = tmp_path / "out.tsv"
    argv = ["--pairs_tsv", str(tsv), "-o", str(out), "--chunk_pairs", "1",
            "--device", "cpu"]
    assert cli(argv) == 0
    assert _read_results(out)[0] == (7, 0)
    # rerun resumes: no duplicate lines
    assert cli(argv) == 0
    assert len(out.read_text().splitlines()) == 2
    # --fresh truncates output and manifest
    assert cli(argv + ["--fresh"]) == 0
    assert len(out.read_text().splitlines()) == 2
    assert len(out.with_name("out.tsv.manifest.jsonl").read_text().splitlines()) == 2


@pytest.mark.parametrize("extra", [[], ["--with_traceback"], ["--cigar"],
                                   ["--scoring_mat_name", "BLOSUM62", "--cigar"]])
def test_batch_cli_matches_the_jax_cli(tmp_path, extra):
    """The two CLIs over one FASTA file: byte-identical results TSVs."""
    fa = tmp_path / "p.fasta"
    fa.write_text(">a\nHEAGAWGHEE\n>b\nPAWHEAE\n>c\nMKVL\n>d\nMKV\n>e\nACDE\n>f\nWACD\n")
    port_out, jax_out = tmp_path / "port.tsv", tmp_path / "jax.tsv"
    assert cli(["--pairs_fasta", str(fa), "-o", str(port_out), "--device", "cpu",
                *extra]) == 0
    assert jax_cli(["--pairs_fasta", str(fa), "-o", str(jax_out), *extra]) == 0
    assert port_out.read_bytes() == jax_out.read_bytes()


def test_batch_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tsv = tmp_path / "p.tsv"
    tsv.write_text("ACGT\tAGT\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli(["--pairs_tsv", str(tsv), "-o", str(tmp_path / "o.tsv")])
    assert not (tmp_path / "o.tsv").exists()


def test_batch_cli_drops_the_xla_and_mesh_options(tmp_path, monkeypatch):
    """``--platform`` (XLA's) and ``--fuse_chunks`` (a switch with nothing
    to switch: both chunk fusions are always on) are refused; the mesh
    options are ported, and ``--distributed`` without a cluster to join
    refuses to guess one."""
    tsv = tmp_path / "p.tsv"
    tsv.write_text("ACGT\tAGT\n")
    for flag in ("--fuse_chunks", "--platform"):
        with pytest.raises(SystemExit):
            cli(["--pairs_tsv", str(tsv), "-o", str(tmp_path / "o.tsv"), flag])
    for key in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="no process group to join"):
        cli(["--pairs_tsv", str(tsv), "-o", str(tmp_path / "o.tsv"),
             "--device", "cpu", "--distributed"])
    assert not (tmp_path / "o.tsv").exists()


def test_batch_cli_profile_dir_writes_a_trace(tmp_path):
    tsv = tmp_path / "p.tsv"
    tsv.write_text("ACGT\tAGT\nGATTACA\tGCATGCT\n")
    prof = tmp_path / "prof"
    assert cli(["--pairs_tsv", str(tsv), "-o", str(tmp_path / "o.tsv"),
                "--device", "cpu", "--with_traceback", "--profile_dir",
                str(prof)]) == 0
    trace = json.loads((prof / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"globalign.fill", "globalign.fetch", "globalign.traceback"} <= names


def test_stats_dict_sane():
    s = RunStats(pairs=10, chunks=2, true_cells=1000, padded_cells=2000,
                 seconds=0.5)
    d = s.as_dict()
    assert d["pad_waste"] == 0.5 and d["pairs_per_s"] == 20.0
    assert d == jax_runner.RunStats(pairs=10, chunks=2, true_cells=1000,
                                    padded_cells=2000, seconds=0.5).as_dict()


def test_runner_tolerates_torn_manifest_line(tmp_path):
    pairs = _random_pairs(6, seed=5)
    out = tmp_path / "res.tsv"
    with open(tmp_path / "log", "w") as log:
        _runner(out, log, chunk_pairs=3).run(pairs[:3])  # chunk 0 complete
        manifest = tmp_path / "res.tsv.manifest.jsonl"
        with manifest.open("a") as f:
            f.write('{"fingerprint": "abc", "chu')  # torn write
        stats = _runner(out, log, chunk_pairs=3).run(pairs)
    assert stats.skipped_chunks == 1 and stats.chunks == 1
    assert len(_read_results(out)) == 6


def test_batch_cli_cigar_column(tmp_path):
    tsv = tmp_path / "p.tsv"
    tsv.write_text("ACGT\tAGT\n")
    out = tmp_path / "out.tsv"
    assert cli(["--pairs_tsv", str(tsv), "-o", str(out), "--cigar",
                "--device", "cpu"]) == 0
    cols = out.read_text().splitlines()[0].split("\t")
    assert cols[3:] == ["ACGT", "| ||", "A-GT", "1=1I2="]


def test_runner_late_chunk_new_character(tmp_path):
    """A letter first appearing in a late chunk must not crash the run."""
    out = tmp_path / "res.tsv"
    pairs = [("ACGT", "AGT"), ("ACGT", "ACG"), ("NACGT", "ACNGT")]
    with open(tmp_path / "log", "w") as log:
        stats = _runner(out, log, chunk_pairs=2).run(pairs)
    assert stats.pairs == 3
    ref = find_global_alignment(seq_1="NACGT", seq_2="ACNGT", device="cpu")
    assert _read_results(out)[2] == (ref.cost, ref.score)


def test_runner_lowercase_tsv_input(tmp_path):
    out = tmp_path / "res.tsv"
    with open(tmp_path / "log", "w") as log:
        _runner(out, log, chunk_pairs=4).run([("acgtacgt", "acgtcgt")])
    ref = find_global_alignment(seq_1="ACGTACGT", seq_2="ACGTCGT", device="cpu")
    assert _read_results(out)[0] == (ref.cost, ref.score)


def test_runner_rejects_different_input_on_resume(tmp_path):
    out = tmp_path / "res.tsv"
    with open(tmp_path / "log", "w") as log:
        _runner(out, log, chunk_pairs=4).run(_random_pairs(4, seed=11))
        with pytest.raises(RuntimeError, match="different input"):
            _runner(out, log, chunk_pairs=4).run(_random_pairs(4, seed=12))


def test_runner_unjournaled_rows_deduped_on_resume(tmp_path):
    """Rows appended by a run that died before journaling are dropped on
    resume instead of being duplicated."""
    pairs = _random_pairs(6, seed=13)
    out = tmp_path / "res.tsv"
    with open(tmp_path / "log", "w") as log:
        _runner(out, log, chunk_pairs=3).run(pairs[:3])  # chunk 0 journaled
        # A crash after appending chunk 1's rows but before journaling.
        with out.open("a") as f:
            f.write("3\t99\t99\n4\t99\t99\n5\t99\t99\n")
        stats = _runner(out, log, chunk_pairs=3).run(pairs)
    assert stats.chunks == 1 and stats.skipped_chunks == 1
    rows = _read_results(out)
    assert len(rows) == 6
    ref = find_global_alignment(seq_1=pairs[3][0], seq_2=pairs[3][1], device="cpu")
    assert rows[3] == (ref.cost, ref.score)  # recomputed, not the 99s
    assert len(out.read_text().splitlines()) == 6  # no duplicates


def test_runner_matrix_scheme_cached_resolution(tmp_path, monkeypatch):
    """Matrix-based schemes resolve ONCE and serve every later chunk."""
    rng = np.random.default_rng(11)
    letters = list("ARNDCQEGHILKMFPSTWYV")
    pairs = [
        tuple("".join(rng.choice(letters, int(rng.integers(3, 18))))
              for _ in range(2))
        for _ in range(6)
    ]
    calls = []
    real = runner_mod.resolve_scheme

    def counting(*a, **k):
        calls.append(k)
        return real(*a, **k)

    monkeypatch.setattr(runner_mod, "resolve_scheme", counting)
    out = tmp_path / "res.tsv"
    with open(tmp_path / "log", "w") as log:
        stats = _runner(out, log, chunk_pairs=2,
                        scheme_kwargs={"scoring_mat_name": "BLOSUM62"}).run(pairs)
    assert stats.pairs == 6 and stats.chunks == 3
    assert len(calls) == 1  # resolved once, cached across chunks
    rows = _read_results(out)
    for idx, (s1, s2) in enumerate(pairs):
        ref = find_global_alignment(seq_1=s1, seq_2=s2,
                                    scoring_mat_name="BLOSUM62", device="cpu")
        assert rows[idx] == (ref.cost, ref.score), (idx, s1, s2)


def test_runner_stats_lines(tmp_path):
    """One JSON line a chunk (with phase seconds) and a run summary."""
    out = tmp_path / "res.tsv"
    with open(tmp_path / "log", "w") as log:
        runner = _runner(out, log, chunk_pairs=2, with_traceback=True)
        runner.run(_random_pairs(5, seed=17))
    lines = [json.loads(x) for x in (tmp_path / "log").read_text().splitlines()]
    assert [x["chunk"] for x in lines[:-1]] == [0, 1, 2]
    assert {"fill", "fetch", "traceback"} <= set(lines[0]["phase_seconds"])
    assert lines[-1]["run"] == runner._fingerprint() and lines[-1]["pairs"] == 5


@pytest.mark.parametrize("chunk,process,count,owned", [
    (0, 0, 1, True), (5, 3, 1, True), (4, 0, 2, True), (5, 0, 2, False),
    (7, 3, 4, True), (8, 3, 4, False),
])
def test_chunk_dealing_and_part_paths(tmp_path, chunk, process, count, owned):
    from globalign_tpu.parallel import multihost as jax_multihost

    assert owns_chunk(chunk, process, count) is owned
    assert jax_multihost.owns_chunk(chunk, process, count) is owned
    assert part_path(tmp_path / "o.tsv", process, count) == (
        jax_multihost.part_path(tmp_path / "o.tsv", process, count)
    )


def test_runner_part_output_and_topology_fingerprint(tmp_path):
    """Process 1 of 2 aligns the odd chunks into ``<output>.part1``; the
    topology is part of the fingerprint, as in the JAX runner."""
    pairs = _random_pairs(6, seed=19)
    kw = dict(chunk_pairs=2, process_id=1, num_processes=2)
    with open(tmp_path / "log", "w") as log:
        port = _runner(tmp_path / "o.tsv", log, **kw)
        port.run(pairs)
        jax = jax_runner.BatchRunner(output=tmp_path / "j.tsv", log=log, **kw)
        jax.run(pairs)
    assert port.output == tmp_path / "o.tsv.part1"
    assert sorted(_read_results(port.output)) == [2, 3]
    assert port.output.read_bytes() == jax.output.read_bytes()
    assert port._fingerprint() == jax._fingerprint()
