"""Resilience toolkit (reference src/resilience.rs).

- CircuitBreaker: Closed/Open/HalfOpen; opens at >=50% failure rate over a
  minimum of 20 requests, sleeps 30s, half-open admits limited probes
  (resilience.rs:43-242).
- TokenBucketRateLimiter (resilience.rs:276-347).
- RetryExecutor: fixed / exponential / linear backoff with a retryable-error
  predicate (resilience.rs:350-473).
- TimeoutWrapper (resilience.rs:476-511) — thread-based since arbitrary Python
  callables can't be interrupted in-place; the wrapped call keeps running but
  the caller gets TimeoutError_ on schedule.
- ResourcePool: bounded pool with RAII (context-manager) return
  (resilience.rs:514-607).
- ResilienceManager: composes breaker+limiter+retry+timeout around a callable
  (resilience.rs:619-751 execute_with_resilience).
"""

from __future__ import annotations

import concurrent.futures
import enum
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Generic, List, Optional, Tuple, Type, TypeVar

from grape_vector_db_tpu_torch.errors import (
    CircuitOpenError,
    RateLimitError,
    TimeoutError_,
    UnavailableError,
)

__all__ = [
    "CircuitState",
    "CircuitBreakerConfig",
    "CircuitBreaker",
    "TokenBucketRateLimiter",
    "BackoffPolicy",
    "RetryConfig",
    "RetryExecutor",
    "TimeoutWrapper",
    "ResourcePool",
    "ResilienceManager",
    "ResilienceStatus",
]

T = TypeVar("T")


class CircuitState(enum.Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


@dataclass
class CircuitBreakerConfig:
    failure_rate_threshold: float = 0.5
    minimum_requests: int = 20
    sleep_window_s: float = 30.0
    half_open_max_probes: int = 3
    window_size: int = 100


class CircuitBreaker:
    def __init__(self, config: Optional[CircuitBreakerConfig] = None):
        self.config = config or CircuitBreakerConfig()
        self._lock = threading.Lock()
        self._state = CircuitState.CLOSED
        self._results: Deque[bool] = deque(maxlen=self.config.window_size)
        self._opened_at = 0.0
        self._half_open_probes = 0
        self._half_open_successes = 0

    @property
    def state(self) -> CircuitState:
        with self._lock:
            self._maybe_transition()
            return self._state

    def _maybe_transition(self) -> None:
        if (
            self._state == CircuitState.OPEN
            and time.monotonic() - self._opened_at >= self.config.sleep_window_s
        ):
            self._state = CircuitState.HALF_OPEN
            self._half_open_probes = 0
            self._half_open_successes = 0

    def allow(self) -> bool:
        with self._lock:
            self._maybe_transition()
            if self._state == CircuitState.CLOSED:
                return True
            if self._state == CircuitState.HALF_OPEN:
                if self._half_open_probes < self.config.half_open_max_probes:
                    self._half_open_probes += 1
                    return True
                return False
            return False

    def record(self, success: bool) -> None:
        with self._lock:
            if self._state == CircuitState.HALF_OPEN:
                if success:
                    self._half_open_successes += 1
                    if self._half_open_successes >= self.config.half_open_max_probes:
                        self._state = CircuitState.CLOSED
                        self._results.clear()
                else:
                    self._state = CircuitState.OPEN
                    self._opened_at = time.monotonic()
                return
            self._results.append(success)
            n = len(self._results)
            if n >= self.config.minimum_requests:
                failure_rate = 1.0 - sum(self._results) / n
                if failure_rate >= self.config.failure_rate_threshold:
                    self._state = CircuitState.OPEN
                    self._opened_at = time.monotonic()

    def call(self, fn: Callable[[], T]) -> T:
        if not self.allow():
            raise CircuitOpenError("circuit breaker is open")
        try:
            out = fn()
        except Exception:
            self.record(False)
            raise
        self.record(True)
        return out


class TokenBucketRateLimiter:
    """resilience.rs:276-347."""

    def __init__(self, rate_per_s: float, burst: int):
        self.rate = float(rate_per_s)
        self.capacity = float(burst)
        self._tokens = float(burst)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def _refill(self) -> None:
        now = time.monotonic()
        self._tokens = min(self.capacity, self._tokens + (now - self._last) * self.rate)
        self._last = now

    def try_acquire(self, n: int = 1) -> bool:
        with self._lock:
            self._refill()
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def acquire(self, n: int = 1, timeout_s: Optional[float] = None) -> None:
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while not self.try_acquire(n):
            if deadline is not None and time.monotonic() > deadline:
                raise RateLimitError("rate limit acquire timed out")
            time.sleep(min(0.01, n / max(self.rate, 1e-9)))

    @property
    def available(self) -> float:
        with self._lock:
            self._refill()
            return self._tokens


class BackoffPolicy(str, enum.Enum):
    FIXED = "fixed"
    EXPONENTIAL = "exponential"
    LINEAR = "linear"


@dataclass
class RetryConfig:
    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 5.0
    policy: BackoffPolicy = BackoffPolicy.EXPONENTIAL
    jitter: float = 0.1
    retryable: Tuple[Type[BaseException], ...] = (UnavailableError, TimeoutError_, ConnectionError, OSError)


class RetryExecutor:
    def __init__(self, config: Optional[RetryConfig] = None):
        self.config = config or RetryConfig()

    def _delay(self, attempt: int) -> float:
        c = self.config
        if c.policy == BackoffPolicy.FIXED:
            d = c.base_delay_s
        elif c.policy == BackoffPolicy.LINEAR:
            d = c.base_delay_s * (attempt + 1)
        else:
            d = c.base_delay_s * (2 ** attempt)
        d = min(d, c.max_delay_s)
        return d * (1.0 + random.uniform(-c.jitter, c.jitter))

    def execute(self, fn: Callable[[], T]) -> T:
        last: Optional[BaseException] = None
        for attempt in range(self.config.max_attempts):
            try:
                return fn()
            except self.config.retryable as e:
                last = e
                if attempt + 1 < self.config.max_attempts:
                    time.sleep(self._delay(attempt))
        assert last is not None
        raise last


class TimeoutWrapper:
    def __init__(self, timeout_s: float, pool: Optional[concurrent.futures.ThreadPoolExecutor] = None):
        self.timeout_s = timeout_s
        self._pool = pool or concurrent.futures.ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="gvdb-timeout"
        )

    def execute(self, fn: Callable[[], T]) -> T:
        fut = self._pool.submit(fn)
        try:
            return fut.result(timeout=self.timeout_s)
        except concurrent.futures.TimeoutError as e:
            raise TimeoutError_(f"operation exceeded {self.timeout_s}s") from e


class ResourcePool(Generic[T]):
    """LIFO pool with RAII checkout (resilience.rs:514-607)."""

    def __init__(self, factory: Callable[[], T], size: int):
        self._factory = factory
        self._sem = threading.BoundedSemaphore(size)
        self._lock = threading.Lock()
        self._idle: List[T] = [factory() for _ in range(size)]
        self.size = size

    class _Lease(Generic[T]):
        def __init__(self, pool: "ResourcePool[T]", obj: T):
            self.pool = pool
            self.obj = obj

        def __enter__(self) -> T:
            return self.obj

        def __exit__(self, *exc) -> None:
            self.pool._release(self.obj)

    def acquire(self, timeout_s: Optional[float] = None) -> "ResourcePool._Lease[T]":
        if not self._sem.acquire(timeout=timeout_s):
            raise UnavailableError("resource pool exhausted")
        with self._lock:
            obj = self._idle.pop() if self._idle else self._factory()
        return ResourcePool._Lease(self, obj)

    def _release(self, obj: T) -> None:
        with self._lock:
            self._idle.append(obj)
        self._sem.release()

    @property
    def idle(self) -> int:
        with self._lock:
            return len(self._idle)


@dataclass
class ResilienceStatus:
    circuit_state: str = "closed"
    rate_tokens: float = 0.0
    pool_idle: int = 0


class ResilienceManager:
    """Composes breaker + limiter + retry + timeout (resilience.rs:619-751)."""

    def __init__(
        self,
        breaker: Optional[CircuitBreaker] = None,
        limiter: Optional[TokenBucketRateLimiter] = None,
        retry: Optional[RetryExecutor] = None,
        timeout: Optional[TimeoutWrapper] = None,
    ):
        self.breaker = breaker or CircuitBreaker()
        self.limiter = limiter
        self.retry = retry or RetryExecutor()
        self.timeout = timeout

    def execute(self, fn: Callable[[], T]) -> T:
        if self.limiter is not None and not self.limiter.try_acquire():
            raise RateLimitError("rate limited")

        def guarded() -> T:
            inner = (lambda: self.timeout.execute(fn)) if self.timeout else fn
            return self.breaker.call(inner)

        return self.retry.execute(guarded)

    def status(self) -> ResilienceStatus:
        return ResilienceStatus(
            circuit_state=self.breaker.state.value,
            rate_tokens=self.limiter.available if self.limiter else float("inf"),
        )
