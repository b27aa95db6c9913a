"""Security manager.

Parity with reference wdbx/utils/security.py: PBKDF2-HMAC-SHA256
password hashing with 100k iterations (:88-113), constant-time verify
(:115-128), HMAC-signed JSON tokens ``base64(payload).base64(sig)`` with
expiry + jti and an in-memory active-token set (:130-232), revocation
(:234-274), role-based access policies with admin override (:276-331),
Fernet encryption keyed by SHA-256 of the secret (:333-429), field-level
metadata encryption with ``{"_encrypted": ...}`` wrappers (:431-498),
and an aiohttp bearer-auth middleware factory (the reference's is
FastAPI, :500-544). Standalone utility — not wired into the facade, same
as the reference.

Torch port: ``wdbx_tpu/utils/security.py`` with its imports repointed to
``wdbx_tpu_torch``; the behaviour is unchanged.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import time
import uuid
from typing import Any

PBKDF2_ITERATIONS = 100_000


class WDBXSecurity:
    def __init__(self, secret_key: str | None = None, token_expiry: int = 3600):
        self.secret_key = secret_key or base64.urlsafe_b64encode(
            os.urandom(32)
        ).decode()
        self.token_expiry = token_expiry
        #: jti -> expiry timestamp; pruned lazily so a long-running
        #: service does not accumulate one entry per login forever
        self._active_tokens: dict[str, float] = {}
        self._revoked_tokens: dict[str, float] = {}
        self._policies: dict[str, set[str]] = {}
        self._fernet = None

    # -- passwords ---------------------------------------------------------
    def hash_password(self, password: str, salt: bytes | None = None) -> str:
        salt = salt or os.urandom(16)
        digest = hashlib.pbkdf2_hmac(
            "sha256", password.encode(), salt, PBKDF2_ITERATIONS
        )
        return (
            base64.b64encode(salt).decode()
            + "$"
            + base64.b64encode(digest).decode()
        )

    def verify_password(self, password: str, hashed: str) -> bool:
        try:
            salt_b64, digest_b64 = hashed.split("$", 1)
            salt = base64.b64decode(salt_b64)
            expected = base64.b64decode(digest_b64)
        except (ValueError, TypeError):
            return False
        actual = hashlib.pbkdf2_hmac(
            "sha256", password.encode(), salt, PBKDF2_ITERATIONS
        )
        return hmac.compare_digest(actual, expected)

    # -- tokens ------------------------------------------------------------
    def _sign(self, payload_b64: str) -> str:
        sig = hmac.new(
            self.secret_key.encode(), payload_b64.encode(), hashlib.sha256
        ).digest()
        return base64.urlsafe_b64encode(sig).decode().rstrip("=")

    def _prune_tokens(self) -> None:
        """Drop expired jtis (active and revoked): expired tokens are
        rejected by timestamp anyway, so keeping their ids only leaks
        memory. Amortized: runs every 1024 mutations."""
        self._token_ops = getattr(self, "_token_ops", 0) + 1
        if self._token_ops % 1024:
            return
        now = time.time()
        for book in (self._active_tokens, self._revoked_tokens):
            dead = [j for j, exp in book.items() if exp < now]
            for j in dead:
                del book[j]

    def generate_token(
        self, user_id: str, roles: list[str] | None = None,
        expiry: int | None = None,
    ) -> str:
        payload = {
            "user_id": user_id,
            "roles": roles or [],
            "exp": time.time() + (expiry or self.token_expiry),
            "jti": str(uuid.uuid4()),
        }
        payload_b64 = (
            base64.urlsafe_b64encode(json.dumps(payload).encode())
            .decode()
            .rstrip("=")
        )
        token = f"{payload_b64}.{self._sign(payload_b64)}"
        self._active_tokens[payload["jti"]] = payload["exp"]
        self._prune_tokens()
        return token

    def verify_token(self, token: str) -> dict[str, Any] | None:
        """Returns the payload if valid, else None."""
        try:
            payload_b64, sig = token.split(".", 1)
        except ValueError:
            return None
        if not hmac.compare_digest(sig, self._sign(payload_b64)):
            return None
        try:
            padded = payload_b64 + "=" * (-len(payload_b64) % 4)
            payload = json.loads(base64.urlsafe_b64decode(padded))
        except (ValueError, TypeError):
            return None
        if payload.get("exp", 0) < time.time():
            return None
        jti = payload.get("jti")
        if jti in self._revoked_tokens or jti not in self._active_tokens:
            return None
        return payload

    def revoke_token(self, token: str) -> bool:
        try:
            payload_b64, _ = token.split(".", 1)
            padded = payload_b64 + "=" * (-len(payload_b64) % 4)
            payload = json.loads(base64.urlsafe_b64decode(padded))
        except (ValueError, TypeError):
            return False
        jti = payload.get("jti")
        if jti in self._active_tokens:
            exp = self._active_tokens.pop(jti)
            self._revoked_tokens[jti] = exp
            return True
        return False

    # -- access policies ---------------------------------------------------
    def set_policy(self, role: str, permissions: list[str]) -> None:
        self._policies[role] = set(permissions)

    def check_access(self, payload: dict[str, Any], permission: str) -> bool:
        """Admin role overrides everything (reference behavior)."""
        roles = payload.get("roles", [])
        if "admin" in roles:
            return True
        return any(permission in self._policies.get(r, ()) for r in roles)

    # -- encryption --------------------------------------------------------
    def _get_fernet(self):
        if self._fernet is None:
            from cryptography.fernet import Fernet

            key = base64.urlsafe_b64encode(
                hashlib.sha256(self.secret_key.encode()).digest()
            )
            self._fernet = Fernet(key)
        return self._fernet

    def encrypt(self, data: bytes | str) -> bytes:
        if isinstance(data, str):
            data = data.encode()
        return self._get_fernet().encrypt(data)

    def decrypt(self, token: bytes | str) -> bytes:
        if isinstance(token, str):
            token = token.encode()
        return self._get_fernet().decrypt(token)

    def encrypt_metadata(
        self, metadata: dict[str, Any], fields: list[str]
    ) -> dict[str, Any]:
        """Field-level encryption with ``{"_encrypted": ...}`` wrappers."""
        out = dict(metadata)
        for field in fields:
            if field in out:
                plaintext = json.dumps(out[field]).encode()
                out[field] = {
                    "_encrypted": self.encrypt(plaintext).decode()
                }
        return out

    def decrypt_metadata(self, metadata: dict[str, Any]) -> dict[str, Any]:
        out = {}
        for key, value in metadata.items():
            if isinstance(value, dict) and "_encrypted" in value:
                out[key] = json.loads(self.decrypt(value["_encrypted"]))
            else:
                out[key] = value
        return out

    # -- middleware --------------------------------------------------------
    def bearer_auth_middleware(self, required_permission: str | None = None):
        """aiohttp middleware enforcing ``Authorization: Bearer <token>``."""
        from aiohttp import web

        @web.middleware
        async def middleware(request, handler):
            auth = request.headers.get("Authorization", "")
            if not auth.startswith("Bearer "):
                return web.json_response(
                    {"detail": "Missing bearer token"}, status=401
                )
            payload = self.verify_token(auth[len("Bearer "):])
            if payload is None:
                return web.json_response(
                    {"detail": "Invalid or expired token"}, status=401
                )
            if required_permission and not self.check_access(
                payload, required_permission
            ):
                return web.json_response(
                    {"detail": "Forbidden"}, status=403
                )
            request["auth"] = payload
            return await handler(request)

        return middleware
