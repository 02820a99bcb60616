"""Raft consensus — real election, log replication, commit/apply, persistence.

The reference ships a full Raft struct set (raft.rs:59-203) but its replication
RPC *sleeps 3-15ms and succeeds with 90% probability via fastrand*
(raft.rs:578-603) and elections are 80% random (raft.rs:740-765). This module
is the actual algorithm over the pluggable transport:

- randomized election timeouts (150-300ms default, raft.rs:647-813 intent)
- pre-vote (raft thesis §9.6, on by default): a majority probe at the
  prospective term before incrementing current_term, so isolated/rejoining
  nodes never inflate terms or depose a healthy leader
- RequestVote with the up-to-date-log rule
- AppendEntries with prev-log consistency check, conflict truncation
  (raft.rs:1240-1289 intent), and per-peer next/match index backtracking
- leader commit rule (majority match_index on a current-term entry)
- state persistence into the document store's KV namespace under
  ``raft_state_*`` / ``raft_log_*`` keys (raft.rs:979-1158 layout)
- log compaction via state-machine snapshot + InstallSnapshot for lagging
  followers (raft.rs:1311-1530 intent)

Threading model: one lock guards all state; a tick thread drives timers; peer
RPCs run on a small pool so a slow peer never blocks the tick loop.
"""

from __future__ import annotations

import concurrent.futures
import queue
import random
import threading
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Tuple

from grape_vector_db_tpu_torch.storage import msgpack_codec as msgpack

from grape_vector_db_tpu_torch.distributed.transport import Transport, TransportError
from grape_vector_db_tpu_torch.errors import ConsensusError, NotLeaderError, TimeoutError_

__all__ = ["RaftRole", "LogEntry", "RaftConfig", "RaftNode"]


class RaftRole(str, Enum):
    FOLLOWER = "follower"
    CANDIDATE = "candidate"
    LEADER = "leader"


@dataclass
class LogEntry:
    index: int
    term: int
    entry_type: str = "command"
    data: bytes = b""

    def to_wire(self) -> Dict[str, Any]:
        return {"index": self.index, "term": self.term,
                "entry_type": self.entry_type, "data": self.data}

    @staticmethod
    def from_wire(d: Dict[str, Any]) -> "LogEntry":
        return LogEntry(d["index"], d["term"], d.get("entry_type", "command"),
                        d.get("data", b""))


@dataclass
class RaftConfig:
    election_timeout_ms: Tuple[int, int] = (150, 300)
    heartbeat_ms: float = 50.0
    tick_ms: float = 10.0
    snapshot_threshold: int = 1000
    max_entries_per_append: int = 64
    rpc_timeout_s: float = 0.5
    # Pre-vote (raft thesis §9.6): probe for a majority with a prospective
    # term before incrementing current_term, so a partitioned/rejoining node
    # cannot inflate terms and depose a healthy leader.
    prevote: bool = True


class RaftNode:
    """One Raft participant. ``apply_fn(entry)`` applies committed commands to
    the state machine; ``snapshot_fn()``/``restore_fn(bytes)`` support
    compaction (optional)."""

    def __init__(
        self,
        node_id: str,
        peers: List[str],
        transport: Transport,
        apply_fn: Callable[[LogEntry], None],
        storage: Optional[Any] = None,  # DocumentStore-like (put_kv/get_kv)
        config: Optional[RaftConfig] = None,
        snapshot_fn: Optional[Callable[[], bytes]] = None,
        restore_fn: Optional[Callable[[bytes], None]] = None,
        persist_ns: Optional[str] = None,
    ):
        self.node_id = node_id
        # Persistence namespace: multi-raft nodes (one RaftNode per shard
        # group on the same host) share one KV store — keys must not collide.
        self._ns = persist_ns or node_id
        # Membership (raft thesis ch. 4, single-server changes): the voter
        # set is itself replicated state. A "config" log entry carries the
        # new full voter set and takes effect on APPEND (not commit); at most
        # one change may be in flight. _config_history tracks (index, voters)
        # adoptions so a truncated uncommitted config reverts correctly, and
        # _snapshot_voters records the config effective at the compaction
        # point for snapshot installs and restarts.
        self.voters: List[str] = sorted(set(peers) | {node_id})
        self._config_index = 0
        self._config_history: List[Tuple[int, List[str]]] = [(0, list(self.voters))]
        self._snapshot_voters: List[str] = list(self.voters)
        self._retiring: set = set()  # removed nodes still owed the config entry
        # set when a majority of probed peers reports this node removed from
        # the configuration; cleared on any valid leader contact (re-add)
        self._suppress_elections = False
        self.transport = transport
        self.apply_fn = apply_fn
        self.storage = storage
        self.config = config or RaftConfig()
        self.snapshot_fn = snapshot_fn
        self.restore_fn = restore_fn

        self._lock = threading.RLock()
        self._commit_cv = threading.Condition(self._lock)
        # persistent state
        self.current_term = 0
        self.voted_for: Optional[str] = None
        self.log: List[LogEntry] = []          # entries after snapshot
        self.snapshot_last_index = 0
        self.snapshot_last_term = 0
        # volatile
        self.role = RaftRole.FOLLOWER
        self.leader_id: Optional[str] = None
        self.commit_index = 0
        self.last_applied = 0
        self.next_index: Dict[str, int] = {}
        self.match_index: Dict[str, int] = {}
        # control
        self._stop = threading.Event()
        self._tick_thread: Optional[threading.Thread] = None
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(4, len(self.peers) + 1),
            thread_name_prefix=f"raft-{node_id}",
        )

        def _submit(fn, *args):
            # Detector/reconcile threads can race node shutdown; a submit to a
            # closed pool must be a no-op, not a crash.
            try:
                self._pool.submit(fn, *args)
            except RuntimeError:
                pass

        self._submit = _submit
        self._election_deadline = 0.0
        self._next_heartbeat = 0.0
        self._last_leader_contact = 0.0  # monotonic time of last valid append
        # ordered state-machine application
        self._apply_queue: "queue.Queue[Optional[LogEntry]]" = queue.Queue()
        self.applied_through = 0
        # propose() watch map: idx -> term actually applied at idx (recorded
        # by the apply worker), so a proposal's outcome stays decidable even
        # after snapshot compaction removes the entry from the log.
        self._watch_terms: Dict[int, Optional[int]] = {}
        self.apply_errors = 0
        self._apply_thread: Optional[threading.Thread] = None
        # stats
        self.elections_started = 0
        self.entries_applied = 0

        self._restore_persisted()
        transport.register(node_id, self._handle_rpc)

    # ------------------------------------------------------------------ utils

    @property
    def peers(self) -> List[str]:
        return [v for v in self.voters if v != self.node_id]

    def _majority(self) -> int:
        return len(self.voters) // 2 + 1

    def _adopt_config(self, entry: LogEntry) -> None:
        """Caller holds lock. Configs take effect when appended (thesis §4.1):
        the node immediately counts majorities against the new set."""
        cfg = msgpack.unpackb(entry.data, raw=False)
        old = set(self.voters)
        self.voters = sorted(set(cfg["voters"]))
        self._config_index = entry.index
        self._config_history.append((entry.index, list(self.voters)))
        if self.role == RaftRole.LEADER:
            nxt = self._last_log_index() + 1
            for p in self.peers:
                self.next_index.setdefault(p, nxt)
                self.match_index.setdefault(p, 0)
            # Keep replicating to a REMOVED node until it has received the
            # config entry that removes it — otherwise it never learns, times
            # out, and harasses the cluster with elections forever (pre-vote
            # blocks the term inflation, but quiescing it is cleaner).
            self._retiring |= old - set(self.voters) - {self.node_id}
        self._persist_state()

    def _truncate_config_from(self, index: int) -> None:
        """Caller holds lock: log entries >= index are being discarded —
        revert to the latest surviving configuration."""
        while self._config_history and self._config_history[-1][0] >= index:
            self._config_history.pop()
        if not self._config_history:
            self._config_history = [(self.snapshot_last_index,
                                     list(self._snapshot_voters))]
        self._config_index, voters = self._config_history[-1]
        self.voters = list(voters)

    def _config_at(self, index: int) -> List[str]:
        """Caller holds lock: the voter set effective at log index."""
        out = self._snapshot_voters
        for idx, voters in self._config_history:
            if idx <= index:
                out = voters
        return list(out)

    def _rand_election_timeout(self) -> float:
        lo, hi = self.config.election_timeout_ms
        return random.uniform(lo, hi) / 1e3

    def _reset_election_timer(self) -> None:
        self._election_deadline = time.monotonic() + self._rand_election_timeout()

    def _last_log_index(self) -> int:
        return self.log[-1].index if self.log else self.snapshot_last_index

    def _last_log_term(self) -> int:
        return self.log[-1].term if self.log else self.snapshot_last_term

    def _entry_at(self, index: int) -> Optional[LogEntry]:
        if index <= self.snapshot_last_index:
            return None
        pos = index - self.snapshot_last_index - 1
        if 0 <= pos < len(self.log):
            return self.log[pos]
        return None

    def _term_at(self, index: int) -> Optional[int]:
        if index == 0:
            return 0
        if index == self.snapshot_last_index:
            return self.snapshot_last_term
        e = self._entry_at(index)
        return e.term if e else None

    # ---------------------------------------------------------------- persist

    def _persist_state(self) -> None:
        if self.storage is None:
            return
        self.storage.put_kv(
            f"raft_state_{self._ns}",
            msgpack.packb({
                "term": self.current_term,
                "voted_for": self.voted_for,
                "snapshot_last_index": self.snapshot_last_index,
                "snapshot_last_term": self.snapshot_last_term,
                "snapshot_voters": list(self._snapshot_voters),
            }),
        )

    def _persist_entries(self, entries: List[LogEntry]) -> None:
        if self.storage is None:
            return
        for e in entries:
            self.storage.put_kv(
                f"raft_log_{self._ns}_{e.index:020d}", msgpack.packb(e.to_wire())
            )

    def _truncate_persisted_from(self, index: int) -> None:
        if self.storage is None:
            return
        for key, _ in list(self.storage.iter_kv_prefix(f"raft_log_{self._ns}_")):
            if int(key.rsplit("_", 1)[1]) >= index:
                self.storage.delete_kv(key)

    def _restore_persisted(self) -> None:
        if self.storage is None:
            return
        raw = self.storage.get_kv(f"raft_state_{self._ns}")
        if raw:
            st = msgpack.unpackb(raw, raw=False)
            self.current_term = st.get("term", 0)
            self.voted_for = st.get("voted_for")
            self.snapshot_last_index = st.get("snapshot_last_index", 0)
            self.snapshot_last_term = st.get("snapshot_last_term", 0)
            if st.get("snapshot_voters"):
                self._snapshot_voters = list(st["snapshot_voters"])
                self.voters = list(self._snapshot_voters)
                self._config_index = self.snapshot_last_index
                self._config_history = [(self.snapshot_last_index,
                                         list(self.voters))]
        snap = self.storage.get_kv(f"raft_snapshot_{self._ns}")
        if snap and self.restore_fn:
            self.restore_fn(snap)
            self.commit_index = self.last_applied = self.snapshot_last_index
            self.applied_through = self.snapshot_last_index
        entries = []
        for key, val in sorted(self.storage.iter_kv_prefix(f"raft_log_{self._ns}_")):
            e = LogEntry.from_wire(msgpack.unpackb(val, raw=False))
            if e.index > self.snapshot_last_index:
                entries.append(e)
        self.log = entries
        # re-adopt any config entries the log carries past the snapshot point
        for e in self.log:
            if e.entry_type == "config":
                cfg = msgpack.unpackb(e.data, raw=False)
                self.voters = sorted(set(cfg["voters"]))
                self._config_index = e.index
                self._config_history.append((e.index, list(self.voters)))

    # ------------------------------------------------------------------ start

    def start(self) -> None:
        self._reset_election_timer()
        self._apply_thread = threading.Thread(
            target=self._apply_worker, daemon=True,
            name=f"raft-apply-{self.node_id}",
        )
        self._apply_thread.start()
        self._tick_thread = threading.Thread(
            target=self._tick_loop, daemon=True, name=f"raft-tick-{self.node_id}"
        )
        self._tick_thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._tick_thread:
            self._tick_thread.join(timeout=1.0)
        self._apply_queue.put(None)
        if self._apply_thread:
            self._apply_thread.join(timeout=1.0)
        self._pool.shutdown(wait=False)
        self.transport.unregister(self.node_id)

    def _tick_loop(self) -> None:
        while not self._stop.wait(self.config.tick_ms / 1e3):
            now = time.monotonic()
            with self._lock:
                role = self.role
                election_due = now >= self._election_deadline
                heartbeat_due = now >= self._next_heartbeat
            if role == RaftRole.LEADER:
                if heartbeat_due:
                    self._broadcast_append()
            elif election_due:
                with self._lock:
                    # a removed node must not disrupt the cluster — by its
                    # own config, or by a majority of probed peers saying so
                    is_voter = (self.node_id in self.voters
                                and not self._suppress_elections)
                if is_voter:
                    self._start_election()

    # -------------------------------------------------------------- elections

    def _start_election(self) -> None:
        if self.config.prevote:
            self._start_prevote()
        else:
            self._start_real_election()

    def _start_prevote(self) -> None:
        """Pre-vote round (raft thesis §9.6): ask peers whether they WOULD
        vote for us at term+1 without anyone changing persistent state. Only
        a majority of pre-votes triggers the real (term-incrementing)
        election — a node on the losing side of a partition retries forever
        at its old term instead of inflating it."""
        with self._lock:
            if self.role == RaftRole.LEADER:
                return
            term_at_start = self.current_term
            prospective = self.current_term + 1
            last_idx, last_term = self._last_log_index(), self._last_log_term()
            self._reset_election_timer()
        needed = self._majority()
        if needed <= 1:
            self._start_real_election(expected_term=term_at_start)
            return

        vote_lock = threading.Lock()
        state = {"votes": 1, "removed": 0, "done": False}

        def ask(peer: str) -> None:
            try:
                resp = self.transport.call(
                    self.node_id, peer, "request_prevote",
                    {"term": prospective, "candidate_id": self.node_id,
                     "last_log_index": last_idx, "last_log_term": last_term},
                    timeout_s=self.config.rpc_timeout_s,
                )
            except TransportError:
                return
            with self._lock:
                if resp["term"] > self.current_term:
                    self._step_down(resp["term"])
                    return
            if resp.get("removed"):
                with vote_lock:
                    state["removed"] += 1
                    quiesce = state["removed"] >= needed
                if quiesce:
                    # A majority of the voters we would need says we are not
                    # in the configuration — we can never win; stop
                    # campaigning (the courtesy-append path covers the
                    # common case, but it is leader-local state and dies
                    # with a crashed leader). A later legitimate re-add
                    # clears this via AppendEntries leader contact.
                    with self._lock:
                        self._suppress_elections = True
                    return
            if resp.get("vote_granted"):
                with vote_lock:
                    state["votes"] += 1
                    if not state["done"] and state["votes"] >= needed:
                        state["done"] = True
                        self._start_real_election(expected_term=term_at_start)

        for p in self.peers:
            self._submit(ask, p)

    def _start_real_election(self, expected_term: Optional[int] = None) -> None:
        with self._lock:
            if self.role == RaftRole.LEADER:
                return
            if expected_term is not None and self.current_term != expected_term:
                return  # stale pre-vote round (term moved under us)
            self.role = RaftRole.CANDIDATE
            self.current_term += 1
            self.voted_for = self.node_id
            self.leader_id = None
            term = self.current_term
            self.elections_started += 1
            self._persist_state()
            self._reset_election_timer()
            last_idx, last_term = self._last_log_index(), self._last_log_term()
        votes = 1
        needed = self._majority()
        if votes >= needed:
            self._become_leader(term)
            return

        vote_lock = threading.Lock()
        state = {"votes": 1, "done": False}

        def ask(peer: str) -> None:
            try:
                resp = self.transport.call(
                    self.node_id, peer, "request_vote",
                    {"term": term, "candidate_id": self.node_id,
                     "last_log_index": last_idx, "last_log_term": last_term},
                    timeout_s=self.config.rpc_timeout_s,
                )
            except TransportError:
                return
            with self._lock:
                if resp["term"] > self.current_term:
                    self._step_down(resp["term"])
                    return
            if resp.get("vote_granted"):
                with vote_lock:
                    state["votes"] += 1
                    if not state["done"] and state["votes"] >= needed:
                        state["done"] = True
                        self._become_leader(term)

        for p in self.peers:
            self._submit(ask, p)

    def _become_leader(self, term: int) -> None:
        with self._lock:
            if self.role != RaftRole.CANDIDATE or self.current_term != term:
                return
            self.role = RaftRole.LEADER
            self.leader_id = self.node_id
            nxt = self._last_log_index() + 1
            self.next_index = {p: nxt for p in self.peers}
            self.match_index = {p: 0 for p in self.peers}
            self._next_heartbeat = 0.0  # send immediately
        self._broadcast_append()

    def _step_down(self, term: int) -> None:
        # caller holds lock
        if term > self.current_term:
            self.current_term = term
            self.voted_for = None
            self._persist_state()
        self.role = RaftRole.FOLLOWER
        self._reset_election_timer()

    # ------------------------------------------------------------ replication

    def _broadcast_append(self) -> None:
        with self._lock:
            if self.role != RaftRole.LEADER:
                return
            self._next_heartbeat = time.monotonic() + self.config.heartbeat_ms / 1e3
            targets = set(self.peers)
            # courtesy appends to removed nodes until the config entry that
            # removed them has landed there (see _adopt_config)
            for p in list(self._retiring):
                if self.match_index.get(p, 0) >= self._config_index:
                    self._retiring.discard(p)
                else:
                    targets.add(p)
        for p in targets:
            self._submit(self._append_to_peer, p)

    def _append_to_peer(self, peer: str) -> None:
        with self._lock:
            if self.role != RaftRole.LEADER:
                return
            term = self.current_term
            nxt = self.next_index.get(peer, self._last_log_index() + 1)
            if nxt <= self.snapshot_last_index:
                self._send_snapshot(peer)
                return
            prev_idx = nxt - 1
            prev_term = self._term_at(prev_idx)
            if prev_term is None:
                self._send_snapshot(peer)
                return
            entries = []
            e = self._entry_at(nxt)
            while e is not None and len(entries) < self.config.max_entries_per_append:
                entries.append(e.to_wire())
                e = self._entry_at(e.index + 1)
            commit = self.commit_index
        try:
            resp = self.transport.call(
                self.node_id, peer, "append_entries",
                {"term": term, "leader_id": self.node_id,
                 "prev_log_index": prev_idx, "prev_log_term": prev_term,
                 "entries": entries, "leader_commit": commit},
                timeout_s=self.config.rpc_timeout_s,
            )
        except TransportError:
            return
        with self._lock:
            if resp["term"] > self.current_term:
                self._step_down(resp["term"])
                return
            if self.role != RaftRole.LEADER or self.current_term != term:
                return
            if resp.get("success"):
                match = resp.get("match_index", prev_idx + len(entries))
                self.match_index[peer] = max(self.match_index.get(peer, 0), match)
                self.next_index[peer] = self.match_index[peer] + 1
                self._advance_commit()
            else:
                # conflict backtracking
                hint = resp.get("conflict_index")
                self.next_index[peer] = max(
                    1, hint if hint is not None else self.next_index.get(peer, 2) - 1
                )

    def _advance_commit(self) -> None:
        # caller holds lock; leader only
        for n in range(self._last_log_index(), self.commit_index, -1):
            t = self._term_at(n)
            if t != self.current_term:
                break
            count = (1 if self.node_id in self.voters else 0) + sum(
                1 for p in self.peers if self.match_index.get(p, 0) >= n)
            if count >= self._majority():
                self.commit_index = n
                self._commit_cv.notify_all()
                break
        if (self.node_id not in self.voters
                and self._config_index <= self.commit_index
                and self.role == RaftRole.LEADER):
            # thesis §4.2.2: a leader removed from the configuration keeps
            # leading until the config entry commits, then steps down
            self.role = RaftRole.FOLLOWER
            self._reset_election_timer()
        self._apply_committed()

    def _apply_committed(self) -> None:
        # caller holds lock. Entries go to a single ordered apply worker —
        # one-thread-per-batch application would let batches interleave and
        # make data commands apply out of order across nodes.
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            e = self._entry_at(self.last_applied)
            if e is not None:
                self._apply_queue.put(e)

    def _apply_worker(self) -> None:
        import logging

        log = logging.getLogger("grape_vector_db_tpu_torch.raft")
        while True:
            e = self._apply_queue.get()
            if e is None:
                return
            try:
                self.apply_fn(e)
            except Exception as exc:
                # A failed apply means this replica diverges — surface it.
                self.apply_errors += 1
                log.error("%s: apply of entry %d failed: %s",
                          self.node_id, e.index, exc)
            self.entries_applied += 1
            with self._lock:
                if e.index in self._watch_terms:
                    self._watch_terms[e.index] = e.term
                self.applied_through = max(self.applied_through, e.index)
                self._commit_cv.notify_all()
                # Compact from the worker: applied_through is exact here, so
                # the snapshot can never miss an entry that is still queued.
                self._maybe_compact()

    # ---------------------------------------------------------------- snapshot

    def _maybe_compact(self) -> None:
        # caller holds lock; invoked from the apply worker so applied_through
        # precisely reflects the state machine.
        if self.snapshot_fn is None or len(self.log) < self.config.snapshot_threshold:
            return
        bound = min(self.applied_through, self.commit_index)
        if bound <= self.snapshot_last_index:
            return
        snap = self.snapshot_fn()
        last_term = self._term_at(bound) or self.snapshot_last_term
        self.log = [e for e in self.log if e.index > bound]
        self.snapshot_last_index = bound
        self.snapshot_last_term = last_term
        # membership bookkeeping: the config effective at the compaction
        # point becomes the snapshot base; adoptions above it stay tracked
        self._snapshot_voters = self._config_at(bound)
        self._config_history = (
            [(bound, list(self._snapshot_voters))]
            + [(i, v) for i, v in self._config_history if i > bound]
        )
        if self.storage is not None:
            self.storage.put_kv(f"raft_snapshot_{self._ns}", snap)
            self._persist_state()
            for key, val in list(self.storage.iter_kv_prefix(f"raft_log_{self._ns}_")):
                if int(key.rsplit("_", 1)[1]) <= self.snapshot_last_index:
                    self.storage.delete_kv(key)

    def _send_snapshot(self, peer: str) -> None:
        # caller holds lock
        if self.snapshot_fn is None:
            return
        snap = self.storage.get_kv(f"raft_snapshot_{self._ns}") if self.storage else None
        if snap is None:
            snap = self.snapshot_fn()
        payload = {
            "term": self.current_term, "leader_id": self.node_id,
            "last_included_index": self.snapshot_last_index,
            "last_included_term": self.snapshot_last_term,
            # membership rides alongside the app snapshot: the receiver's log
            # below this index is discarded, configs included
            "voters": self._config_at(self.snapshot_last_index),
            "data": snap,
        }

        def send() -> None:
            try:
                resp = self.transport.call(
                    self.node_id, peer, "install_snapshot", payload,
                    timeout_s=self.config.rpc_timeout_s * 4,
                )
            except TransportError:
                return
            with self._lock:
                if resp["term"] > self.current_term:
                    self._step_down(resp["term"])
                elif resp.get("ok"):
                    self.next_index[peer] = payload["last_included_index"] + 1
                    self.match_index[peer] = payload["last_included_index"]

        self._submit(send)

    # ------------------------------------------------------------------- RPCs

    def _handle_rpc(self, method: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        if method == "request_prevote":
            return self.handle_request_prevote(payload)
        if method == "request_vote":
            return self.handle_request_vote(payload)
        if method == "append_entries":
            return self.handle_append_entries(payload)
        if method == "install_snapshot":
            return self.handle_install_snapshot(payload)
        if method == "client_command":
            data = payload["data"]
            idx = self.propose(data, timeout_s=payload.get("timeout_s", 2.0),
                               wait_applied=payload.get("wait_applied", False))
            return {"ok": True, "index": idx}
        if method == "change_membership":
            idx = self.change_membership(
                payload["voters"], timeout_s=payload.get("timeout_s", 5.0))
            return {"ok": True, "index": idx}
        raise ConsensusError(f"unknown raft method {method}")

    def handle_request_prevote(self, p: Dict[str, Any]) -> Dict[str, Any]:
        """Grant iff we would plausibly vote for this candidate in a real
        election: its prospective term is not behind ours, its log is at
        least as up-to-date, and we have not heard from a live leader within
        the minimum election timeout. Grants change NO persistent state."""
        with self._lock:
            granted = False
            if self.role != RaftRole.LEADER and p["term"] >= self.current_term:
                up_to_date = (
                    p["last_log_term"] > self._last_log_term()
                    or (p["last_log_term"] == self._last_log_term()
                        and p["last_log_index"] >= self._last_log_index())
                )
                quiet_s = self.config.election_timeout_ms[0] / 1e3
                leader_quiet = (
                    time.monotonic() - self._last_leader_contact
                ) >= quiet_s
                granted = up_to_date and leader_quiet
            return {"term": self.current_term, "vote_granted": granted,
                    # membership hint: a node removed while partitioned (its
                    # courtesy appends lost with the old leader) only learns
                    # of its removal through the peers it keeps probing
                    "removed": p["candidate_id"] not in self.voters}

    def handle_request_vote(self, p: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            if p["term"] > self.current_term:
                self._step_down(p["term"])
            granted = False
            if p["term"] == self.current_term and self.voted_for in (None, p["candidate_id"]):
                up_to_date = (
                    p["last_log_term"] > self._last_log_term()
                    or (p["last_log_term"] == self._last_log_term()
                        and p["last_log_index"] >= self._last_log_index())
                )
                if up_to_date:
                    granted = True
                    self.voted_for = p["candidate_id"]
                    self._persist_state()
                    self._reset_election_timer()
            return {"term": self.current_term, "vote_granted": granted}

    def handle_append_entries(self, p: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            if p["term"] < self.current_term:
                return {"term": self.current_term, "success": False}
            if p["term"] > self.current_term or self.role != RaftRole.FOLLOWER:
                self._step_down(p["term"])
            self.leader_id = p["leader_id"]
            self._reset_election_timer()
            self._last_leader_contact = time.monotonic()
            self._suppress_elections = False  # live leader: hint was stale

            prev_idx, prev_term = p["prev_log_index"], p["prev_log_term"]
            my_term = self._term_at(prev_idx)
            if my_term is None or my_term != prev_term:
                # conflict hint: first index of the conflicting term (or log end)
                conflict = min(prev_idx, self._last_log_index() + 1)
                if my_term is not None:
                    i = prev_idx
                    while i > self.snapshot_last_index + 1 and self._term_at(i - 1) == my_term:
                        i -= 1
                    conflict = i
                return {"term": self.current_term, "success": False,
                        "conflict_index": max(1, conflict)}

            entries = [LogEntry.from_wire(e) for e in p["entries"]]
            new_entries: List[LogEntry] = []
            for e in entries:
                mine = self._entry_at(e.index)
                if mine is not None and mine.term != e.term:
                    # conflict: truncate from here (raft.rs:1240-1289);
                    # a truncated config entry reverts the voter set
                    pos = e.index - self.snapshot_last_index - 1
                    self.log = self.log[:pos]
                    self._truncate_persisted_from(e.index)
                    self._truncate_config_from(e.index)
                    mine = None
                if mine is None and e.index == self._last_log_index() + 1:
                    self.log.append(e)
                    new_entries.append(e)
                    if e.entry_type == "config":
                        self._adopt_config(e)
            if new_entries:
                self._persist_entries(new_entries)
            # The highest index this RPC actually verified is
            # prev_log_index + len(entries); the local log may extend further
            # with stale uncommitted tail entries from an earlier term (e.g. a
            # follower longer than the new leader passing the prev check on an
            # empty heartbeat). Reporting _last_log_index() as match would let
            # the leader count this follower toward commit majorities for
            # entries it does not hold — a Raft safety violation.
            verified = prev_idx + len(entries)
            if p["leader_commit"] > self.commit_index:
                self.commit_index = max(
                    self.commit_index, min(p["leader_commit"], verified)
                )
                self._commit_cv.notify_all()
                self._apply_committed()
            return {"term": self.current_term, "success": True,
                    "match_index": verified}

    def handle_install_snapshot(self, p: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            if p["term"] < self.current_term:
                return {"term": self.current_term, "ok": False}
            self._step_down(p["term"])
            self.leader_id = p["leader_id"]
            if p["last_included_index"] <= self.snapshot_last_index:
                return {"term": self.current_term, "ok": True}
            if self.restore_fn is not None:
                self.restore_fn(p["data"])
            self.snapshot_last_index = p["last_included_index"]
            self.snapshot_last_term = p["last_included_term"]
            self.log = [e for e in self.log if e.index > self.snapshot_last_index]
            if p.get("voters"):
                # rebase membership on the snapshot's config, then re-adopt
                # any config entries the surviving log suffix still carries
                self._snapshot_voters = list(p["voters"])
                self.voters = list(self._snapshot_voters)
                self._config_index = self.snapshot_last_index
                self._config_history = [(self.snapshot_last_index,
                                         list(self.voters))]
                for e in self.log:
                    if e.entry_type == "config":
                        self._adopt_config(e)
            self.commit_index = max(self.commit_index, self.snapshot_last_index)
            self.last_applied = max(self.last_applied, self.snapshot_last_index)
            self.applied_through = max(self.applied_through, self.snapshot_last_index)
            # Wake propose()/wait_applied_through() waiters: the snapshot may
            # satisfy their commit/apply predicate, and a later heartbeat
            # won't re-notify (leader_commit is already <= commit_index).
            self._commit_cv.notify_all()
            if self.storage is not None:
                self.storage.put_kv(f"raft_snapshot_{self._ns}", p["data"])
                self._persist_state()
            return {"term": self.current_term, "ok": True}

    # ----------------------------------------------------------------- client

    def propose(self, data: bytes, entry_type: str = "command",
                timeout_s: float = 2.0, wait_applied: bool = False) -> int:
        """Append a command; block until committed (and, with wait_applied,
        until this node's state machine has applied it — read-your-writes on
        the proposer). Raises NotLeaderError with a leader hint when this node
        isn't the leader (raft.rs:490-535)."""
        with self._lock:
            if self.role != RaftRole.LEADER:
                raise NotLeaderError(self.leader_id)
            if entry_type == "config":
                if self._config_index > self.commit_index:
                    raise ConsensusError(
                        "a membership change is already in flight "
                        f"(config at index {self._config_index} not yet "
                        "committed)"
                    )
                # Authoritative single-server check under the SAME lock as
                # the append: change_membership's early check reads a voter
                # snapshot that a concurrent config commit can invalidate,
                # which would let a stale-based config change two servers at
                # once (disjoint-majority risk) or silently undo the
                # concurrent change.
                new = set(msgpack.unpackb(data, raw=False)["voters"])
                if len(set(self.voters) ^ new) > 1:
                    raise ConsensusError(
                        "membership may change by one server at a time: "
                        f"{sorted(self.voters)} -> {sorted(new)}"
                    )
            entry = LogEntry(
                index=self._last_log_index() + 1,
                term=self.current_term,
                entry_type=entry_type,
                data=data,
            )
            self.log.append(entry)
            self._persist_entries([entry])
            if entry_type == "config":
                self._adopt_config(entry)
            idx, term = entry.index, entry.term
            self._watch_terms[idx] = None
        self._broadcast_append()
        deadline = time.monotonic() + timeout_s
        try:
            with self._commit_cv:
                while self.commit_index < idx or (
                    wait_applied and self.applied_through < idx
                ):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError_(f"commit of index {idx} timed out")
                    self._commit_cv.wait(remaining)
                committed_term = self._term_at(idx)
                if committed_term is None:
                    # Compacted while we waited. Compaction proves SOME entry
                    # at idx committed and was applied — the watch map (filled
                    # by the apply worker) says whether it was ours. A None
                    # watch record means this node skipped per-entry apply
                    # (snapshot install from a new leader): the outcome is
                    # genuinely unknown, which must not be reported as success
                    # (the old code did, losing overwritten writes silently).
                    committed_term = self._watch_terms.get(idx)
                    if committed_term is None:
                        raise ConsensusError(
                            "proposal outcome unknown: log compacted by "
                            "snapshot install before local apply"
                        )
        finally:
            with self._lock:
                self._watch_terms.pop(idx, None)
        if committed_term != term:
            raise ConsensusError("entry was overwritten by a new leader")
        return idx

    def propose_on_leader(self, data: bytes, timeout_s: float = 2.0,
                          wait_applied: bool = False) -> int:
        """Propose locally or forward to the leader, following stale hints.

        Leadership can churn between resolving the hint and the forward
        landing; a production raft client retries along the new hint chain
        until the deadline instead of surfacing one stale NotLeaderError."""
        deadline = time.monotonic() + timeout_s
        last_exc: Exception = NotLeaderError(None)
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise last_exc
            try:
                return self.propose(data, timeout_s=remaining,
                                    wait_applied=wait_applied)
            except NotLeaderError as e:
                last_exc = e
                hint = e.leader_hint
            if not hint or hint == self.node_id:
                time.sleep(0.02)  # election in progress; wait for a hint
                continue
            try:
                resp = self.transport.call(
                    self.node_id, hint, "client_command",
                    {"data": data, "timeout_s": max(remaining, 0.05),
                     "wait_applied": wait_applied},
                    timeout_s=remaining + 0.5,
                )
                idx = resp["index"]
                if wait_applied:
                    # The leader committed (and applied locally); for
                    # read-your-writes the CALLER's state machine must also
                    # have applied it before local version reads are valid.
                    self.wait_applied_through(
                        idx, timeout_s=max(deadline - time.monotonic(), 0.05)
                    )
                return idx
            except (NotLeaderError, TimeoutError_, ConsensusError,
                    TransportError, OSError) as e:
                last_exc = e  # hint was stale or target unreachable; re-resolve
                time.sleep(0.02)

    # ------------------------------------------------------------- membership

    def change_membership(self, new_voters: List[str],
                          timeout_s: float = 5.0) -> int:
        """Replace the voter set via a replicated config entry (raft thesis
        ch. 4, single-server change). Must run on the leader; at most one
        change may be uncommitted at a time (propose enforces it). The new
        config takes effect on append; the call returns once it commits
        under the NEW majority. Single-server constraint: the new set must
        differ from the current one by at most one node — two simultaneous
        arbitrary changes can elect two leaders for disjoint majorities."""
        with self._lock:
            cur = set(self.voters)
        new = set(new_voters)
        if len(cur.symmetric_difference(new)) > 1:
            raise ConsensusError(
                f"membership may change by one server at a time: {sorted(cur)}"
                f" -> {sorted(new)}"
            )
        data = msgpack.packb({"voters": sorted(new)}, use_bin_type=True)
        return self.propose(data, entry_type="config", timeout_s=timeout_s)

    def membership_on_leader(self, new_voters: List[str],
                             timeout_s: float = 5.0) -> int:
        """change_membership locally or forwarded to the leader, following
        stale hints (same retry discipline as propose_on_leader)."""
        deadline = time.monotonic() + timeout_s
        last_exc: Exception = NotLeaderError(None)
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise last_exc
            try:
                return self.change_membership(new_voters, timeout_s=remaining)
            except NotLeaderError as e:
                last_exc = e
                hint = e.leader_hint
            except ConsensusError as e:
                # in-flight config or a conflicting concurrent change — both
                # resolve; retry locally (the forwarded path below already
                # retries the same errors, keep the two paths symmetric)
                last_exc = e
                time.sleep(0.02)
                continue
            if not hint or hint == self.node_id:
                time.sleep(0.02)
                continue
            try:
                resp = self.transport.call(
                    self.node_id, hint, "change_membership",
                    {"voters": list(new_voters),
                     "timeout_s": max(remaining, 0.05)},
                    timeout_s=remaining + 0.5,
                )
                return resp["index"]
            except (NotLeaderError, TimeoutError_, ConsensusError,
                    TransportError, OSError) as e:
                last_exc = e
                time.sleep(0.02)

    def add_voter(self, node_id: str, timeout_s: float = 5.0) -> int:
        """Add one node to the voter set (leader only). The new node catches
        up through normal backfill/InstallSnapshot once the leader starts
        heartbeating it."""
        with self._lock:
            voters = set(self.voters)
        voters.add(node_id)
        return self.change_membership(sorted(voters), timeout_s=timeout_s)

    def remove_voter(self, node_id: str, timeout_s: float = 5.0) -> int:
        """Remove one node from the voter set (leader only). A leader
        removing itself keeps leading until the config commits, then steps
        down (thesis §4.2.2)."""
        with self._lock:
            voters = set(self.voters)
        voters.discard(node_id)
        if not voters:
            raise ConsensusError("cannot remove the last voter")
        return self.change_membership(sorted(voters), timeout_s=timeout_s)

    def wait_applied_through(self, idx: int, timeout_s: float = 2.0) -> None:
        """Block until this node's state machine has applied log index idx
        (or it was compacted into a snapshot covering idx)."""
        deadline = time.monotonic() + timeout_s
        with self._commit_cv:
            while (self.applied_through < idx
                   and self.snapshot_last_index < idx):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError_(f"apply of index {idx} timed out")
                self._commit_cv.wait(remaining)

    # ------------------------------------------------------------------ intro

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "node_id": self.node_id,
                "role": self.role.value,
                "term": self.current_term,
                "leader_id": self.leader_id,
                "commit_index": self.commit_index,
                "last_applied": self.last_applied,
                "log_length": len(self.log),
                "snapshot_last_index": self.snapshot_last_index,
                "voters": list(self.voters),
            }
