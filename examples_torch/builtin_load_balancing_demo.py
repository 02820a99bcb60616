"""Built-in load balancer demo on the PyTorch + CUDA port (reference
examples/builtin_load_balancing_demo.rs): the five routing strategies, the
response-time-driven weight feedback, and the balance report. The balancer
routes on the host, so this demo takes no device.

Run: python examples_torch/builtin_load_balancing_demo.py
"""

import random

from grape_vector_db_tpu_torch.distributed.load_balancer import (
    IntelligentLoadBalancer,
    LoadBalancerConfig,
)
from grape_vector_db_tpu_torch.distributed.types import NodeInfo


def demo(strategy: str, latencies: dict) -> dict:
    lb = IntelligentLoadBalancer(LoadBalancerConfig(strategy=strategy))
    for nid in latencies:
        lb.add_node(NodeInfo(node_id=nid, address=f"{nid}.local:6334"))
    counts = {nid: 0 for nid in latencies}
    rnd = random.Random(0)
    for _ in range(600):
        target = lb.route_request()[0]
        counts[target] += 1
        lb.on_request_start(target)
        # simulate the request; feed the measured latency back in
        ms = latencies[target] * (0.8 + 0.4 * rnd.random())
        lb.on_request_end(target, ms, success=True)
    total = sum(counts.values())
    dist = {n: f"{100 * c / total:.0f}%" for n, c in counts.items()}
    print(f"  {strategy:22s} -> {dist}")
    return counts


def main() -> dict:
    # fast / medium / slow backends
    lat = {"fast": 5.0, "medium": 25.0, "slow": 120.0}
    print("600 requests across 3 nodes (5ms / 25ms / 120ms):")
    out = {}
    for strategy in ("round_robin", "weighted_round_robin",
                     "least_connections", "load_based", "location_aware"):
        out[strategy] = demo(strategy, lat)

    # balance report
    lb = IntelligentLoadBalancer(LoadBalancerConfig(strategy="load_based"))
    for nid in lat:
        lb.add_node(NodeInfo(node_id=nid, address=f"{nid}.local:6334"))
    for _ in range(300):
        t = lb.route_request()[0]
        lb.on_request_start(t)
        lb.on_request_end(t, lat[t], success=True)
    report = lb.balance_report()
    print(f"balance report: balanced={report.balanced} "
          f"max_deviation={report.max_deviation:.2f}")
    print("builtin_load_balancing_demo OK")
    out["balanced"] = report.balanced
    return out


if __name__ == "__main__":
    main()
