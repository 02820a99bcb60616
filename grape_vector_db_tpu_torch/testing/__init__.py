"""In-process multi-node test framework (reference tests/test_framework.disabled/,
2361 LoC: TestCluster, NetworkSimulator, ChaosEngine).

All nodes are objects in one process; faults are injected through the
InProcessTransport's NetworkSimulator. This is how distributed behavior is
tested without real machines — and unlike the reference's (which never
compiled), this one runs.
"""

from grape_vector_db_tpu_torch.testing.cluster import RaftTestCluster
from grape_vector_db_tpu_torch.distributed.transport import NetworkSimulator

__all__ = ["RaftTestCluster", "NetworkSimulator"]
