"""The benchmark suite and the CLI, port against the JAX package on the CPU.

- ``BenchmarkSuite`` on one seed gives the same precision@10, recall@10 and
  NDCG@10 through both packages (the port's with ``device="cpu"``), for the
  dense, batched and eight fusion runs: the port's database searches exactly,
  as the JAX package's does on f32 storage, so the ids agree and the metrics
  within 1e-9 (3e-3 score ties at the k-th rank would move them; none occur
  at this seed).
- Each CLI subcommand, run with ``--device cpu``, prints JSON lines with the
  keys the JAX CLI prints for the same arguments.
"""

import json

import pytest
import torch

from grape_vector_db_tpu.bench import BenchmarkConfig as JaxConfig
from grape_vector_db_tpu.bench import BenchmarkSuite as JaxSuite
from grape_vector_db_tpu.cli import main as jax_main
from grape_vector_db_tpu_torch.bench import BenchmarkConfig, BenchmarkSuite, ndcg_at_k
from grape_vector_db_tpu_torch.cli import main as cli_main

torch.set_num_threads(2)

METRICS = ("precision_at_k", "recall_at_k", "ndcg_at_10", "success_rate", "queries")
SMALL = dict(num_queries=30, dataset_size=300, dimension=24, warmup_queries=5,
             num_clusters=10)


@pytest.fixture(scope="module")
def suites():
    ours = BenchmarkSuite(BenchmarkConfig(**SMALL), device="cpu")
    ours.build_dataset()
    ref = JaxSuite(JaxConfig(**SMALL))
    ref.build_dataset()
    return ours, ref


def _same_metrics(a, b):
    assert a.name == b.name
    for m in METRICS:
        assert getattr(a, m) == pytest.approx(getattr(b, m), abs=1e-9), (a.name, m)


def test_suite_builds_on_the_asked_device(suites):
    ours, _ = suites
    assert ours.device == "cpu" and ours.db.index.device.type == "cpu"
    assert len(ours.db.index) == SMALL["dataset_size"]
    assert ndcg_at_k(["a", "x"], {"a"}, 2) == 1.0


def test_suite_dense_metrics_match_jax(suites):
    ours, ref = suites
    r = ours.run_dense()
    _same_metrics(r, ref.run_dense())
    assert r.queries == 30 and r.precision_at_k > 0.8 and r.ndcg_at_10 > 0.8
    assert r.p95_latency_ms >= r.p50_latency_ms and r.qps > 0


def test_suite_batched_metrics_match_jax(suites):
    ours, ref = suites
    r = ours.run_batched_dense(batch=8)
    _same_metrics(r, ref.run_batched_dense(batch=8))
    assert r.extra["batch"] == 8.0


def test_suite_fusion_metrics_match_jax(suites):
    ours, ref = suites
    rows, want = ours.run_fusion_comparison(), ref.run_fusion_comparison()
    assert [r.name for r in rows] == [r.name for r in want] and len(rows) == 8
    for a, b in zip(rows, want):
        _same_metrics(a, b)


def _printed(main, argv, capsys):
    main(argv)
    return [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]


@pytest.mark.parametrize("argv", [
    ["benchmark", "--dim", "24"],
    ["performance-test", "--dim", "24"],
    ["simple-performance-test", "--dim", "16"],
    ["concurrent-insert-test", "--dim", "16"],
    ["storage-analysis", "--dim", "16"],
    ["fusion-benchmark", "--dim", "16", "--docs", "200", "--queries", "20"],
], ids=lambda a: a[0])
def test_cli_subcommand_prints_the_jax_keys(argv, capsys):
    ours = _printed(cli_main, argv + ["--device", "cpu"], capsys)
    ref = _printed(jax_main, argv, capsys)
    assert [sorted(d) for d in ours] == [sorted(d) for d in ref]
    if argv[0] == "fusion-benchmark":
        # the same seeded workload: the same quality figures, row by row
        for a, b in zip(ours, ref):
            assert a["name"] == b["name"]
            for key in ("precision@10", "recall@10", "ndcg@10"):
                assert a[key] == pytest.approx(b[key], abs=1e-3), (a["name"], key)
    if argv[0] == "benchmark":
        assert ours[0]["insert_docs"] == 1000 and ours[0]["search_qps"] > 0
    if argv[0] == "concurrent-insert-test":
        assert ours[0]["target_met"] is True
    if argv[0] == "storage-analysis":
        assert ours[0]["with_vectors_bytes"] > 0


def test_cli_tune(capsys, tmp_path):
    """``tune --device cpu`` reopens the data directory, runs
    ``VectorDatabase.tune`` and prints what the JAX CLI prints."""
    from grape_vector_db_tpu_torch import Document, VectorDatabase, VectorDbConfig

    cfg_file = tmp_path / "cfg.toml"
    cfg_file.write_text(
        "vector_dimension = 32\n"
        "[index]\nkind = \"binary\"\ninitial_capacity = 256\n"
        "[device]\nstorage_dtype = \"float32\"\n")
    cfg = VectorDbConfig(vector_dimension=32)
    cfg.index.kind = "binary"
    cfg.index.initial_capacity = 256
    cfg.device.storage_dtype = "float32"
    db = VectorDatabase(path=str(tmp_path / "data"), config=cfg, device="cpu")
    db.batch_add_documents([Document(id=f"d{i}", content=f"doc body {i} topic{i % 7}")
                            for i in range(150)])
    db.flush()
    db.close()
    argv = ["tune", "--data-dir", str(tmp_path / "data"), "--config", str(cfg_file),
            "--target-recall", "0.9", "--k", "5"]
    out = _printed(cli_main, argv + ["--device", "cpu"], capsys)[-1]
    assert out["kind"] == "binary" and out["rescore_budget"] >= 64
    assert out["documents"] == 150
    # the JAX CLI on the same directory (the packages read each other's stores)
    assert out == _printed(jax_main, argv, capsys)[-1]


def test_cli_device_defaults_to_the_card(monkeypatch):
    """Without --device every subcommand asks for ``cuda``; the argument
    reaches the database the command makes."""
    from grape_vector_db_tpu_torch import cli

    seen = []

    def fake_db(*args, **kw):
        seen.append(kw.get("device"))
        raise RuntimeError("stop")

    monkeypatch.setattr("grape_vector_db_tpu_torch.VectorDatabase", fake_db)
    for argv in (["benchmark"], ["tune"], ["serve", "--grpc-port", "0", "--rest-port", "0"],
                 ["benchmark", "--device", "cpu"]):
        with pytest.raises(RuntimeError, match="stop"):
            cli.main(argv)
    assert seen == ["cuda", "cuda", "cuda", "cpu"]
