"""Error taxonomy — mirrors the reference's ``VectorDbError`` enum (types.rs:858-932).

The reference defines 21 thiserror variants; here each becomes an exception class
under a single :class:`VectorDbError` root so callers can catch broadly or narrowly.
"""

from __future__ import annotations

__all__ = [
    "VectorDbError",
    "StorageError",
    "IndexError_",
    "SerializationError",
    "NetworkError",
    "ConfigError",
    "NotFoundError",
    "DimensionMismatchError",
    "InvalidArgumentError",
    "CapacityError",
    "ConcurrencyError",
    "TimeoutError_",
    "AuthenticationError",
    "AuthorizationError",
    "RateLimitError",
    "CircuitOpenError",
    "ConsensusError",
    "ShardError",
    "ReplicationError",
    "NotLeaderError",
    "UnavailableError",
    "NotImplementedError_",
    "BackupError",
    "StateError",
]


class VectorDbError(Exception):
    """Root error (reference types.rs:858)."""

    code = "internal"


class StorageError(VectorDbError):
    code = "storage"


class IndexError_(VectorDbError):
    code = "index"


class SerializationError(VectorDbError):
    code = "serialization"


class NetworkError(VectorDbError):
    code = "network"


class ConfigError(VectorDbError):
    code = "config"


class NotFoundError(VectorDbError):
    code = "not_found"


class DimensionMismatchError(VectorDbError):
    code = "dimension_mismatch"

    def __init__(self, expected: int, got: int):
        super().__init__(f"vector dimension mismatch: expected {expected}, got {got}")
        self.expected = expected
        self.got = got


class InvalidArgumentError(VectorDbError):
    code = "invalid_argument"


class CapacityError(VectorDbError):
    code = "capacity"


class ConcurrencyError(VectorDbError):
    code = "concurrency"


class TimeoutError_(VectorDbError):
    code = "timeout"


class AuthenticationError(VectorDbError):
    code = "authentication"


class AuthorizationError(VectorDbError):
    code = "authorization"


class RateLimitError(VectorDbError):
    code = "rate_limit"


class CircuitOpenError(VectorDbError):
    code = "circuit_open"


class ConsensusError(VectorDbError):
    code = "consensus"


class ShardError(VectorDbError):
    code = "shard"


class ReplicationError(VectorDbError):
    code = "replication"


class NotLeaderError(ConsensusError):
    code = "not_leader"

    def __init__(self, leader_hint: str | None = None):
        super().__init__(f"not the leader (leader hint: {leader_hint})")
        self.leader_hint = leader_hint


class UnavailableError(VectorDbError):
    code = "unavailable"


class NotImplementedError_(VectorDbError):
    code = "not_implemented"


class BackupError(StorageError):
    code = "backup"


class StateError(VectorDbError):
    """Operation attempted in the wrong lifecycle state (embedded.rs:461-473)."""

    code = "state"
