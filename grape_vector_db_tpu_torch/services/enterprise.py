"""Enterprise auth / RBAC / audit (reference src/enterprise.rs).

- Roles x permissions (enterprise.rs:45-102): SuperAdmin, DatabaseAdmin,
  DataManager, ReadOnlyUser, SystemMonitor, Custom.
- Users with salted SHA-256 password hashes (enterprise.rs:346-355).
- API keys ``gvdb_<hex32>`` with expiry + last-used tracking
  (enterprise.rs:150-209).
- HMAC-signed session tokens — the reference's "simplified JWT"
  (enterprise.rs:212-259, 534-566), done properly with hmac/sha256.
- Audit log ring of 10k entries (enterprise.rs:602-633).
- Login lockout: 5 failures / 5 minutes (enterprise.rs:636-672).
"""

from __future__ import annotations

import base64
import enum
import hashlib
import hmac
import json
import secrets
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, FrozenSet, List, Optional, Set

from grape_vector_db_tpu_torch.errors import AuthenticationError, AuthorizationError

__all__ = [
    "Permission",
    "Role",
    "User",
    "ApiKey",
    "AuditEntry",
    "SecurityPolicy",
    "AuthenticationManager",
]


class Permission(str, enum.Enum):
    READ_DATA = "read_data"
    WRITE_DATA = "write_data"
    MANAGE_DATABASE = "manage_database"
    MANAGE_INDEXES = "manage_indexes"
    VIEW_METRICS = "view_metrics"
    MANAGE_USERS = "manage_users"
    SYSTEM_CONFIG = "system_config"


class Role(str, enum.Enum):
    SUPER_ADMIN = "super_admin"
    DATABASE_ADMIN = "database_admin"
    DATA_MANAGER = "data_manager"
    READ_ONLY_USER = "read_only_user"
    SYSTEM_MONITOR = "system_monitor"
    CUSTOM = "custom"


_ROLE_PERMS: Dict[Role, FrozenSet[Permission]] = {
    Role.SUPER_ADMIN: frozenset(Permission),
    Role.DATABASE_ADMIN: frozenset(
        {
            Permission.READ_DATA,
            Permission.WRITE_DATA,
            Permission.MANAGE_DATABASE,
            Permission.MANAGE_INDEXES,
            Permission.VIEW_METRICS,
        }
    ),
    Role.DATA_MANAGER: frozenset(
        {Permission.READ_DATA, Permission.WRITE_DATA, Permission.VIEW_METRICS}
    ),
    Role.READ_ONLY_USER: frozenset({Permission.READ_DATA}),
    Role.SYSTEM_MONITOR: frozenset({Permission.VIEW_METRICS}),
    Role.CUSTOM: frozenset(),
}


def _hash_password(password: str, salt: str) -> str:
    return hashlib.sha256(f"{salt}:{password}".encode()).hexdigest()


@dataclass
class User:
    username: str
    password_hash: str
    salt: str
    role: Role
    custom_permissions: Set[Permission] = field(default_factory=set)
    enabled: bool = True
    created_at: float = field(default_factory=time.time)

    def permissions(self) -> Set[Permission]:
        base = set(_ROLE_PERMS[self.role])
        base |= self.custom_permissions
        return base


@dataclass
class ApiKey:
    key: str
    name: str
    role: Role
    created_at: float = field(default_factory=time.time)
    expires_at: Optional[float] = None
    last_used_at: Optional[float] = None
    enabled: bool = True

    def is_valid(self) -> bool:
        return self.enabled and (self.expires_at is None or time.time() < self.expires_at)


@dataclass
class AuditEntry:
    timestamp: float
    actor: str
    action: str
    resource: str
    success: bool
    detail: str = ""


@dataclass
class SecurityPolicy:
    max_failed_logins: int = 5
    lockout_window_s: float = 300.0
    session_ttl_s: float = 3600.0
    min_password_len: int = 8
    audit_ring_size: int = 10_000


class AuthenticationManager:
    """enterprise.rs:325-772 AuthenticationManager."""

    def __init__(self, policy: Optional[SecurityPolicy] = None,
                 secret: Optional[bytes] = None):
        self.policy = policy or SecurityPolicy()
        self._secret = secret or secrets.token_bytes(32)
        self._lock = threading.RLock()
        self._users: Dict[str, User] = {}
        self._api_keys: Dict[str, ApiKey] = {}
        self._audit: Deque[AuditEntry] = deque(maxlen=self.policy.audit_ring_size)
        self._failed: Dict[str, List[float]] = {}

    # -- users ----------------------------------------------------------------

    def create_user(self, username: str, password: str, role: Role,
                    custom_permissions: Optional[Set[Permission]] = None) -> User:
        if len(password) < self.policy.min_password_len:
            raise AuthenticationError(
                f"password must be >= {self.policy.min_password_len} chars"
            )
        with self._lock:
            if username in self._users:
                raise AuthenticationError(f"user {username} already exists")
            salt = secrets.token_hex(16)
            user = User(
                username=username,
                password_hash=_hash_password(password, salt),
                salt=salt,
                role=role,
                custom_permissions=custom_permissions or set(),
            )
            self._users[username] = user
            self._log(username, "create_user", username, True)
            return user

    def delete_user(self, username: str) -> bool:
        with self._lock:
            existed = self._users.pop(username, None) is not None
            self._log("system", "delete_user", username, existed)
            return existed

    def set_enabled(self, username: str, enabled: bool) -> None:
        with self._lock:
            if username in self._users:
                self._users[username].enabled = enabled

    # -- login / lockout ----------------------------------------------------------

    def _locked_out(self, username: str) -> bool:
        now = time.time()
        fails = [t for t in self._failed.get(username, []) if now - t < self.policy.lockout_window_s]
        self._failed[username] = fails
        return len(fails) >= self.policy.max_failed_logins

    def login(self, username: str, password: str) -> str:
        """Returns a signed session token."""
        with self._lock:
            if self._locked_out(username):
                self._log(username, "login", "session", False, "locked out")
                raise AuthenticationError("account locked — too many failed attempts")
            user = self._users.get(username)
            ok = (
                user is not None
                and user.enabled
                and hmac.compare_digest(
                    user.password_hash, _hash_password(password, user.salt)
                )
            )
            if not ok:
                self._failed.setdefault(username, []).append(time.time())
                self._log(username, "login", "session", False, "bad credentials")
                raise AuthenticationError("invalid username or password")
            self._failed.pop(username, None)
            self._log(username, "login", "session", True)
            return self._sign_token(username, user.role)

    # -- session tokens ---------------------------------------------------------------

    def _sign_token(self, username: str, role: Role) -> str:
        payload = {
            "sub": username,
            "role": role.value,
            "exp": time.time() + self.policy.session_ttl_s,
            "nonce": secrets.token_hex(8),
        }
        body = base64.urlsafe_b64encode(json.dumps(payload).encode()).decode()
        sig = hmac.new(self._secret, body.encode(), hashlib.sha256).hexdigest()
        return f"{body}.{sig}"

    def verify_token(self, token: str) -> Dict:
        try:
            body, sig = token.rsplit(".", 1)
        except ValueError:
            raise AuthenticationError("malformed token")
        want = hmac.new(self._secret, body.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(sig, want):
            raise AuthenticationError("bad token signature")
        payload = json.loads(base64.urlsafe_b64decode(body))
        if time.time() > payload["exp"]:
            raise AuthenticationError("token expired")
        user = self._users.get(payload["sub"])
        if user is None or not user.enabled:
            raise AuthenticationError("unknown or disabled user")
        return payload

    # -- api keys ------------------------------------------------------------------------

    def create_api_key(self, name: str, role: Role,
                       ttl_s: Optional[float] = None) -> ApiKey:
        key = f"gvdb_{secrets.token_hex(16)}"  # gvdb_<hex32> (enterprise.rs:150)
        ak = ApiKey(
            key=key, name=name, role=role,
            expires_at=(time.time() + ttl_s) if ttl_s else None,
        )
        with self._lock:
            self._api_keys[key] = ak
            self._log("system", "create_api_key", name, True)
        return ak

    def verify_api_key(self, key: str) -> ApiKey:
        with self._lock:
            ak = self._api_keys.get(key)
            if ak is None or not ak.is_valid():
                self._log("unknown", "verify_api_key", key[:12], False)
                raise AuthenticationError("invalid or expired API key")
            ak.last_used_at = time.time()
            return ak

    def revoke_api_key(self, key: str) -> bool:
        with self._lock:
            ak = self._api_keys.get(key)
            if ak is None:
                return False
            ak.enabled = False
            self._log("system", "revoke_api_key", ak.name, True)
            return True

    # -- authorization ---------------------------------------------------------------------

    def authorize(self, token_or_key: str, perm: Permission) -> str:
        """Verify a session token or API key and check the permission. Returns
        the actor name."""
        if token_or_key.startswith("gvdb_"):
            ak = self.verify_api_key(token_or_key)
            perms = _ROLE_PERMS[ak.role]
            actor = f"key:{ak.name}"
        else:
            payload = self.verify_token(token_or_key)
            user = self._users[payload["sub"]]
            perms = user.permissions()
            actor = payload["sub"]
        if perm not in perms:
            self._log(actor, "authorize", perm.value, False)
            raise AuthorizationError(f"{actor} lacks permission {perm.value}")
        self._log(actor, "authorize", perm.value, True)
        return actor

    # -- audit ------------------------------------------------------------------------------

    def _log(self, actor: str, action: str, resource: str, success: bool,
             detail: str = "") -> None:
        self._audit.append(
            AuditEntry(time.time(), actor, action, resource, success, detail)
        )

    def audit_log(self, limit: int = 100) -> List[AuditEntry]:
        with self._lock:
            return list(self._audit)[-limit:]
