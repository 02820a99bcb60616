"""ChaosEngine — fault-injection experiments against a live cluster.

Rebuilds the reference's chaos harness (test_framework/chaos.rs:12-160):
``ChaosExperiment`` {duration, node/network failure rates, recovery time,
NetworkChaos {packet loss, latency spikes, partition probability},
WorkloadConfig {read/write QPS}} with availability / performance / consistency
metric collectors — but running against the *real* in-process cluster
(the reference's chaos tests never compiled).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

import numpy as np

from grape_vector_db_tpu_torch.distributed.cluster_service import ClusterService
from grape_vector_db_tpu_torch.types import Document

__all__ = ["NetworkChaos", "WorkloadConfig", "ChaosExperiment", "ChaosReport",
           "ChaosEngine"]


@dataclass
class NetworkChaos:
    packet_loss: float = 0.0
    latency_spike_s: float = 0.0
    latency_spike_probability: float = 0.0
    partition_probability: float = 0.0


@dataclass
class WorkloadConfig:
    read_qps: float = 20.0
    write_qps: float = 5.0
    dimension: int = 16


@dataclass
class ChaosExperiment:
    duration_s: float = 5.0
    node_failure_rate: float = 0.1      # probability per tick
    recovery_time_s: float = 1.0
    tick_s: float = 0.25
    network: NetworkChaos = field(default_factory=NetworkChaos)
    workload: WorkloadConfig = field(default_factory=WorkloadConfig)
    seed: int = 0


@dataclass
class ChaosReport:
    reads_total: int = 0
    reads_ok: int = 0
    writes_total: int = 0
    writes_ok: int = 0
    read_availability: float = 1.0
    write_availability: float = 1.0
    avg_read_latency_ms: float = 0.0
    p95_read_latency_ms: float = 0.0
    failures_injected: int = 0
    partitions_injected: int = 0
    consistent_after_heal: bool = True
    docs_surviving: int = 0


class ChaosEngine:
    def __init__(self, service: ClusterService, experiment: Optional[ChaosExperiment] = None):
        self.svc = service
        self.exp = experiment or ChaosExperiment()
        self._rng = random.Random(self.exp.seed)
        self._np_rng = np.random.default_rng(self.exp.seed)

    def run(self) -> ChaosReport:
        exp = self.exp
        report = ChaosReport()
        read_lats: List[float] = []
        written_ids: List[str] = []
        lock = threading.Lock()
        stop = threading.Event()
        downed: Dict[str, float] = {}

        dim = exp.workload.dimension
        base_docs = [
            Document(id=f"seed-{i}", content=f"seed {i}",
                     vector=self._np_rng.standard_normal(dim).astype(np.float32).tolist())
            for i in range(20)
        ]
        self.svc.upsert(base_docs)
        with lock:
            written_ids.extend(d.id for d in base_docs)
        # Warm the search path BEFORE the chaos clock starts: the first query
        # through a mesh-sharded index jit-compiles the shard_map program,
        # and that one-time compile would otherwise be charged against the
        # availability window (production serving warms up the same way —
        # embedded.py's warmup phase).
        try:
            self.svc.search(base_docs[0].vector, k=3)
        except Exception:
            pass

        def reader() -> None:
            interval = 1.0 / max(exp.workload.read_qps, 0.1)
            while not stop.wait(interval):
                with lock:
                    if not written_ids:
                        continue
                    target = self._rng.choice(written_ids)
                doc_vec = None
                for n in self.svc.nodes.values():
                    rec = n.db.store.get(target)
                    if rec is not None and rec.embedding:
                        doc_vec = rec.embedding
                        break
                if doc_vec is None:
                    continue
                t0 = time.perf_counter()
                try:
                    hits = self.svc.search(doc_vec, k=3)
                    ok = bool(hits)
                except Exception:
                    ok = False
                with lock:
                    report.reads_total += 1
                    if ok:
                        report.reads_ok += 1
                        read_lats.append((time.perf_counter() - t0) * 1e3)

        def writer() -> None:
            interval = 1.0 / max(exp.workload.write_qps, 0.1)
            i = 0
            while not stop.wait(interval):
                i += 1
                doc = Document(
                    id=f"chaos-{i}", content=f"chaos doc {i}",
                    vector=self._np_rng.standard_normal(dim).astype(np.float32).tolist(),
                )
                try:
                    self.svc.upsert([doc])
                    ok = True
                except Exception:
                    ok = False
                with lock:
                    report.writes_total += 1
                    if ok:
                        report.writes_ok += 1
                        written_ids.append(doc.id)

        threads = [threading.Thread(target=reader, daemon=True),
                   threading.Thread(target=writer, daemon=True)]
        for t in threads:
            t.start()

        # chaos loop
        deadline = time.monotonic() + exp.duration_s
        node_ids = list(self.svc.nodes.keys())
        majority = len(node_ids) // 2 + 1
        while time.monotonic() < deadline:
            time.sleep(exp.tick_s)
            now = time.monotonic()
            # recover nodes whose downtime elapsed
            for nid, until in list(downed.items()):
                if now >= until:
                    self.svc.sim.recover_node(nid)
                    del downed[nid]
            # maybe fail a node (never break quorum)
            if (self._rng.random() < exp.node_failure_rate
                    and len(node_ids) - len(downed) - 1 >= majority):
                up = [n for n in node_ids if n not in downed]
                victim = self._rng.choice(up)
                self.svc.sim.fail_node(victim)
                downed[victim] = now + exp.recovery_time_s
                report.failures_injected += 1
            # maybe partition briefly
            if self._rng.random() < exp.network.partition_probability:
                cut = set(self._rng.sample(node_ids, 1))
                rest = set(node_ids) - cut
                self.svc.sim.create_partition(cut, rest)
                report.partitions_injected += 1
                time.sleep(min(exp.recovery_time_s, 0.5))
                self.svc.sim.heal_partition()
            if exp.network.packet_loss > 0:
                for nid in node_ids:
                    self.svc.sim.set_packet_loss(nid, exp.network.packet_loss)

        # heal everything and let the cluster settle
        stop.set()
        for t in threads:
            t.join(timeout=2.0)
        for nid in list(downed):
            self.svc.sim.recover_node(nid)
        self.svc.sim.heal_partition()
        for nid in node_ids:
            self.svc.sim.set_packet_loss(nid, 0.0)
        time.sleep(max(1.0, self.exp.recovery_time_s))

        # consistency: every written doc must be retrievable post-heal
        surviving = 0
        with lock:
            check = list(written_ids)
        for doc_id in check:
            found = any(n.db.store.get(doc_id) is not None
                        for n in self.svc.nodes.values())
            if found:
                surviving += 1
        report.docs_surviving = surviving
        report.consistent_after_heal = surviving >= int(0.99 * len(check))
        report.read_availability = (
            report.reads_ok / report.reads_total if report.reads_total else 1.0
        )
        report.write_availability = (
            report.writes_ok / report.writes_total if report.writes_total else 1.0
        )
        if read_lats:
            s = sorted(read_lats)
            report.avg_read_latency_ms = float(np.mean(s))
            report.p95_read_latency_ms = s[int(0.95 * len(s))]
        return report
