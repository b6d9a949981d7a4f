"""The port's multi-process runs on the CPU (gloo), against the JAX runner.

``parallel.multihost.initialize`` (a world of one; it refuses to guess a
cluster), ``host_group``; ``BatchRunner(mesh=)`` on two lockstep ranks, of
which only the first writes; and the batch CLI as several processes —
``--distributed`` (chunks dealt over ranks), ``--distributed --shard`` as
2 hosts x 2 ranks (chunks dealt over hosts, each chunk sharded over its
host's ranks) and ``--shard`` alone (a world of one).  The output shards
merge into the JAX runner's results TSV byte for byte, and every manifest
carries the JAX runner's fingerprint for its host.  Ranks rendezvous through
a file store under the test's directory (no ports).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch.distributed as dist

from globalign_tpu import runner as jax_runner
from globalign_tpu_torch.batch_cli import main as cli
from globalign_tpu_torch.parallel import multihost
from tests.torch_dist_harness import REPO, run_ranks


def _pairs(count=14, seed=4):
    rng = np.random.default_rng(seed)
    return [("".join(rng.choice(list("ACGT"), int(rng.integers(1, 40)))),
             "".join(rng.choice(list("ACGT"), int(rng.integers(1, 40)))))
            for _ in range(count)]


def _jax_tsv(tmp_path, pairs, traceback, **kw):
    out = tmp_path / "jax.tsv"
    jax_runner.BatchRunner(
        output=out, chunk_pairs=4, with_traceback=traceback,
        emit_cigar=traceback, log=open(os.devnull, "w"), **kw,
    ).run(pairs)
    return out.read_bytes()


def _fingerprints(manifest):
    import json

    return {json.loads(x)["fingerprint"] for x in manifest.read_text().splitlines()}


def test_initialize_refuses_to_guess(monkeypatch):
    for key in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group to join"):
        multihost.initialize(backend="gloo")
    with pytest.raises(ValueError, match="num_processes and process_id"):
        multihost.initialize("localhost:1234", backend="gloo")
    assert not dist.is_initialized() and multihost.process_info() == (0, 1)


def test_world_of_one_is_idempotent_and_one_host(monkeypatch):
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert multihost.initialize(num_processes=1, backend="gloo") == (0, 1)
    try:
        assert multihost.initialize(num_processes=4) == (0, 1)  # already up
        assert multihost.process_info() == (0, 1)
        host, hosts, group = multihost.host_group()  # by host name
        assert (host, hosts, dist.get_world_size(group)) == (0, 1, 1)
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
        with pytest.raises(ValueError, match="do not split into hosts"):
            multihost.host_group()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("traceback", [False, True])
def test_runner_on_two_ranks_writes_once(tmp_path, traceback):
    """Two lockstep ranks of one host: rank 0 alone writes the output and
    the manifest, both the JAX runner's; the TSV is not split into parts."""
    pairs = _pairs()
    out = tmp_path / "out.tsv"
    answers = run_ranks(tmp_path, 2, [dict(
        kind="runner", pairs=pairs, output=str(out), chunk_pairs=4,
        traceback=traceback,
    )])
    assert [a[0] for a in answers] == [
        {"pairs": 14, "chunks": 4, "logged": True},
        {"pairs": 14, "chunks": 4, "logged": False},
    ]
    assert out.read_bytes() == _jax_tsv(tmp_path, pairs, traceback)
    assert _fingerprints(out.with_name("out.tsv.manifest.jsonl")) == _fingerprints(
        tmp_path / "jax.tsv.manifest.jsonl"
    )
    assert sorted(p.name for p in tmp_path.glob("out.tsv*")) == [
        "out.tsv", "out.tsv.manifest.jsonl"
    ]


def _cli_ranks(tmp_path, world, args, env=None, timeout=180):
    store = f"file://{tmp_path / 'cli-store'}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "globalign_tpu_torch.batch_cli", *args,
             "--device", "cpu", "--distributed", "--coordinator_address",
             store, "--num_processes", str(world), "--process_id", str(rank)],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO), **(env or {})),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for rank in range(world)
    ]
    try:
        errors = [p.communicate(timeout=timeout)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, err) in enumerate(zip(procs, errors)):
        assert p.returncode == 0, f"rank {rank}: {err[-3000:]}"
    return errors


def _merged(parts):
    lines = [ln for p in parts for ln in p.read_text().splitlines(keepends=True)]
    return "".join(sorted(lines, key=lambda ln: int(ln.split("\t", 1)[0]))).encode()


@pytest.mark.parametrize("shard", [False, True], ids=["ranks", "2hosts-x-2ranks"])
def test_cli_distributed_parts_merge_to_the_jax_tsv(tmp_path, shard):
    """``--distributed``: chunks dealt over 2 ranks; ``--distributed
    --shard`` with LOCAL_WORLD_SIZE=2: chunks dealt over 2 hosts of 2
    ranks, each chunk sharded over its host's ranks, the host's first rank
    writing its part."""
    pairs = _pairs(15)
    tsv = tmp_path / "p.tsv"
    tsv.write_text("".join(f"{a}\t{b}\n" for a, b in pairs))
    out = tmp_path / "out.tsv"
    args = ["--pairs_tsv", str(tsv), "-o", str(out), "--cigar",
            "--chunk_pairs", "4"]
    if shard:
        errors = _cli_ranks(tmp_path, 4, args + ["--shard"],
                            env={"LOCAL_WORLD_SIZE": "2"})
        # Only each host's first rank (0 and 2) logs its stats.
        assert ['"run"' in e for e in errors] == [True, False, True, False]
    else:
        _cli_ranks(tmp_path, 2, args)
    parts = [out.with_name(f"out.tsv.part{k}") for k in (0, 1)]
    assert sorted(p.name for p in tmp_path.glob("out.tsv*")) == sorted(
        [p.name for p in parts] + [p.name + ".manifest.jsonl" for p in parts]
    )
    assert _merged(parts) == _jax_tsv(tmp_path, pairs, True)
    for k, part in enumerate(parts):
        want = jax_runner.BatchRunner(
            output=tmp_path / "j.tsv", chunk_pairs=4, with_traceback=True,
            emit_cigar=True, process_id=k, num_processes=2,
        )._fingerprint()
        assert _fingerprints(part.with_name(part.name + ".manifest.jsonl")) == {want}


def test_cli_shard_alone_is_a_world_of_one(tmp_path):
    pairs = _pairs(9, seed=8)
    tsv = tmp_path / "p.tsv"
    tsv.write_text("".join(f"{a}\t{b}\n" for a, b in pairs))
    out = tmp_path / "out.tsv"
    args = ["--pairs_tsv", str(tsv), "-o", str(out), "--cigar",
            "--chunk_pairs", "4", "--device", "cpu", "--shard"]
    assert cli(args) == 0
    assert not dist.is_initialized()  # the CLI tears its group down
    assert out.read_bytes() == _jax_tsv(tmp_path, pairs, True)
    assert cli(args + ["--fresh"]) == 0  # --fresh truncates and reruns
    assert out.read_bytes() == _jax_tsv(tmp_path, pairs, True)


def test_cli_rejects_nccl_on_the_cpu(tmp_path):
    tsv = tmp_path / "p.tsv"
    tsv.write_text("ACGT\tAGT\n")
    with pytest.raises(SystemExit):
        cli(["--pairs_tsv", str(tsv), "-o", str(tmp_path / "o.tsv"),
             "--device", "cpu", "--backend", "nccl", "--shard"])
