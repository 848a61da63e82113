"""RGW Swift dialect: the OpenStack object API over the same store.

src/rgw/rgw_rest_swift.cc role: one SAL store, two REST dialects.
Swift's shape -- TempAuth tokens, /v1/AUTH_<account>/<container>/<obj>
paths, JSON container listings, X-Object-Meta-* headers, marker
paging -- maps onto the exact bucket/object machinery S3 uses, so
objects PUT via S3 are GETtable via Swift and vice versa.

Supported: auth (/auth/v1.0 TempAuth: X-Auth-User/X-Auth-Key ->
X-Auth-Token), account GET (container listing), container
PUT/GET/DELETE/HEAD (object listing with prefix/marker/limit), object
PUT/GET/HEAD/DELETE with metadata headers.  Not supported (as in many
radosgw deployments): large-object manifests, ACL headers, versioning
via the Swift dialect.

Port of ``ceph_tpu/rgw/swift.py``; runs unchanged over the
port's librados.
"""

from __future__ import annotations

import json
import os
import time

from .store import RgwError, RgwStore

TOKEN_TTL = 3600.0


class SwiftFrontend:
    """Handles Swift-dialect requests inside the Gateway's HTTP
    server (path-routed: /auth/v1.0 and /v1/...)."""

    def __init__(self, store: RgwStore) -> None:
        self.store = store
        # token -> {user, expires}; TempAuth keeps tokens in memory
        # exactly like this (rgw_swift_auth.cc TempURL aside)
        self._tokens: dict[str, dict] = {}

    def routes(self, path: str) -> bool:
        # /swift/v1 keeps the dialect out of the S3 bucket namespace
        # (an S3 bucket named "v1" must stay reachable); radosgw
        # mounts swift under a distinct prefix for the same reason
        return path == "/auth/v1.0" or path.startswith("/swift/v1/")

    async def handle(self, req) -> tuple[int, dict, bytes]:
        try:
            if req.path == "/auth/v1.0":
                return await self._auth(req)
            return await self._api(req)
        except RgwError as e:
            return e.status, {"content-type": "text/plain"}, \
                f"{e.code}".encode()

    # -- TempAuth -------------------------------------------------------------
    async def _auth(self, req) -> tuple[int, dict, bytes]:
        user_hdr = req.headers.get("x-auth-user", "")
        key = req.headers.get("x-auth-key", "")
        # X-Auth-User is "<account>:<user>"; the access key doubles as
        # the account id the way radosgw's swift subusers do
        access = user_hdr.split(":", 1)[0]
        user = await self.store.get_user(access)
        if user is None or user["secret"] != key:
            raise RgwError("AccessDenied", 401, "bad credentials")
        token = "AUTH_tk" + os.urandom(16).hex()
        self._tokens[token] = {"user": user,
                               "expires": time.time() + TOKEN_TTL}
        return 200, {
            "x-auth-token": token,
            "x-storage-token": token,
            "x-storage-url": f"/swift/v1/AUTH_{user['uid']}"}, b""

    def _user_for(self, req) -> dict:
        tok = self._tokens.get(req.headers.get("x-auth-token", ""))
        if tok is None or tok["expires"] < time.time():
            raise RgwError("AccessDenied", 401, "bad or expired token")
        return tok["user"]

    # -- /v1/AUTH_<account>[/container[/object]] ------------------------------
    async def _api(self, req) -> tuple[int, dict, bytes]:
        user = self._user_for(req)
        parts = req.path[len("/swift/v1/"):].split("/", 2)
        account = parts[0]
        if account != f"AUTH_{user['uid']}":
            raise RgwError("AccessDenied", 403, account)
        container = parts[1] if len(parts) > 1 and parts[1] else ""
        obj = parts[2] if len(parts) > 2 else ""
        if not container:
            return await self._account(req, user)
        if not obj:
            return await self._container(req, user, container)
        return await self._object(req, user, container, obj)

    async def _account(self, req, user) -> tuple[int, dict, bytes]:
        if req.method not in ("GET", "HEAD"):
            raise RgwError("MethodNotAllowed", 405, req.method)
        buckets = await self.store.list_buckets(owner=user["uid"])
        out = [{"name": b["name"]} for b in buckets]
        return 200, {"content-type": "application/json",
                     "x-account-container-count": str(len(out))}, \
            json.dumps(out).encode()

    async def _container(self, req, user,
                         container: str) -> tuple[int, dict, bytes]:
        if req.method == "PUT":
            try:
                await self.store.create_bucket(container, user["uid"])
            except RgwError as e:
                if e.code != "BucketAlreadyExists":
                    raise
            return 201, {}, b""
        if req.method == "DELETE":
            try:
                await self.store.delete_bucket(container)
            except RgwError as e:
                if e.code == "BucketNotEmpty":
                    raise RgwError("Conflict", 409, container) from e
                raise
            return 204, {}, b""
        if req.method in ("GET", "HEAD"):
            listing = await self.store.list_objects(
                container,
                prefix=req.query.get("prefix", ""),
                marker=req.query.get("marker", ""),
                max_keys=int(req.query.get("limit", "10000")))
            rows = [{"name": k, "bytes": e["size"],
                     "hash": e["etag"],
                     "content_type": e.get("content_type", ""),
                     "last_modified": e["mtime"]}
                    for k, e in listing["entries"]]
            hdrs = {"content-type": "application/json",
                    "x-container-object-count": str(len(rows))}
            if req.method == "HEAD":
                return 204, hdrs, b""
            return 200, hdrs, json.dumps(rows).encode()
        raise RgwError("MethodNotAllowed", 405, req.method)

    async def _object(self, req, user, container: str,
                      obj: str) -> tuple[int, dict, bytes]:
        if req.method == "PUT":
            meta = {k[len("x-object-meta-"):]: v
                    for k, v in req.headers.items()
                    if k.startswith("x-object-meta-")}
            entry = await self.store.put_object(
                container, obj, req.body, owner=user["uid"],
                content_type=req.headers.get("content-type", ""),
                meta=meta)
            return 201, {"etag": entry["etag"]}, b""
        if req.method in ("GET", "HEAD"):
            entry = await self.store.get_entry(container, obj)
            hdrs = {"etag": entry["etag"],
                    "content-type": entry.get("content_type")
                    or "application/octet-stream",
                    "content-length": str(entry["size"]),
                    "last-modified": entry["mtime"]}
            for k, v in (entry.get("meta") or {}).items():
                hdrs[f"x-object-meta-{k}"] = v
            if req.method == "HEAD":
                return 200, hdrs, b""
            _entry, data = await self.store.get_object(container, obj)
            return 200, hdrs, data
        if req.method == "DELETE":
            await self.store.delete_object(container, obj)
            return 204, {}, b""
        raise RgwError("MethodNotAllowed", 405, req.method)
