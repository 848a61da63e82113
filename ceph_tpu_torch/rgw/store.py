"""RGW SAL layer: users, buckets, objects over RADOS.

The rados-driver schema (a compressed rendering of
src/rgw/driver/rados/rgw_rados.cc):

    rgw_users                 omap: access_key -> {secret, uid, display}
    rgw_buckets               omap: bucket -> {id, owner, created}
    bucket_index.<id>         per-bucket index (cls rgw_index omap)
    <id>__shadow_<key>        object data (striped when large)
    <id>__multipart_<key>.<uploadid>.<n>   multipart part data

Object data rides the client-side striper (one logical object -> many
RADOS objects) the way RGW manifests split heads from tails
(rgw_obj_manifest); the head's index entry carries size/etag/manifest.
Writes go through the cls_rgw-style prepare/complete dance so a
crashed gateway leaves a pending marker, not a half-linked entry.

Port of ``ceph_tpu/rgw/store.py``; runs unchanged over the
port's librados.
"""

from __future__ import annotations

import hashlib
import json
import os
import time

from ..client.rados import RadosError
from ..client.striper import Layout, RadosStriper

# version ids sort NEWEST-FIRST lexicographically (inverted ns stamp +
# entropy), so the index omap's name order is the S3 version order
def _new_version_id() -> str:
    inv = (1 << 64) - time.time_ns()
    return f"{inv:016x}{os.urandom(4).hex()}"

USERS_OID = "rgw_users"
BUCKETS_OID = "rgw_buckets"


class RgwError(Exception):
    """Carries the S3 error code (NoSuchBucket, NoSuchKey...)."""

    def __init__(self, code: str, status: int, detail: str = "") -> None:
        super().__init__(f"{code}: {detail}" if detail else code)
        self.code = code
        self.status = status


def _now_iso() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S.000Z", time.gmtime())


class RgwStore:
    def __init__(self, ioctx, stripe_unit: int = 1 << 22) -> None:
        from .notify import NotificationManager
        self.ioctx = ioctx
        self.striper = RadosStriper(
            ioctx, Layout(stripe_unit=stripe_unit,
                          object_size=stripe_unit))
        self.notify = NotificationManager(self)

    # -- users (RGWUserCtl / radosgw-admin user create) ---------------------
    async def create_user(self, uid: str, display_name: str,
                          access_key: str | None = None,
                          secret: str | None = None) -> dict:
        access_key = access_key or os.urandom(10).hex().upper()
        secret = secret or os.urandom(20).hex()
        user = {"uid": uid, "display_name": display_name,
                "access_key": access_key, "secret": secret}
        await self.ioctx.set_omap(USERS_OID,
                                  {access_key: json.dumps(user).encode()})
        return user

    async def get_user(self, access_key: str) -> dict | None:
        try:
            omap = await self.ioctx.get_omap(USERS_OID)
        except RadosError:
            return None
        raw = omap.get(access_key)
        return json.loads(raw) if raw else None

    # -- buckets ------------------------------------------------------------
    async def _buckets(self) -> dict[str, dict]:
        try:
            raw = await self.ioctx.exec(BUCKETS_OID, "rgw_index",
                                        "dir_list", b"")
        except RadosError:
            return {}
        return json.loads(raw)

    async def create_bucket(self, name: str, owner: str) -> dict:
        # the exists/owner check and the insert commit atomically in
        # the OSD (cls dir_link) -- two concurrent gateways racing the
        # same name must not both win with different bucket ids
        b = {"id": os.urandom(8).hex(), "owner": owner,
             "created": _now_iso(), "name": name}
        try:
            raw = await self.ioctx.exec(
                BUCKETS_OID, "rgw_index", "dir_link",
                json.dumps({"name": name, "meta": b}).encode())
        except RadosError as e:
            if e.errno_name == "EEXIST":
                raise RgwError("BucketAlreadyExists", 409, name) from e
            raise
        return json.loads(raw)     # existing meta on idempotent re-create

    async def get_bucket(self, name: str) -> dict:
        b = (await self._buckets()).get(name)
        if b is None:
            raise RgwError("NoSuchBucket", 404, name)
        return b

    async def delete_bucket(self, name: str) -> None:
        b = await self.get_bucket(name)
        listing = await self.list_objects(name, max_keys=1)
        if listing["entries"]:
            raise RgwError("BucketNotEmpty", 409, name)
        # versions and delete markers also block deletion (S3 returns
        # BucketNotEmpty until every version is purged) -- the plain
        # listing hides marker-topped keys
        versions = await self.list_object_versions(name, max_keys=1)
        if versions["versions"]:
            raise RgwError("BucketNotEmpty", 409, name)
        try:
            await self.ioctx.exec(BUCKETS_OID, "rgw_index", "dir_unlink",
                                  json.dumps({"name": name}).encode())
        except RadosError as e:
            if e.errno_name != "ENOENT":
                raise
        try:
            await self.ioctx.remove(self._index(b))
        except RadosError:
            pass

    async def list_buckets(self, owner: str | None = None) -> list[dict]:
        out = [b for b in (await self._buckets()).values()
               if owner is None or b["owner"] == owner]
        return sorted(out, key=lambda b: b["name"])

    # -- objects ------------------------------------------------------------
    def _index(self, bucket: dict) -> str:
        return f"bucket_index.{bucket['id']}"

    def _data_oid(self, bucket: dict, key: str,
                  tag: str = "") -> str:
        # tagged oids give overwrite PUTs a fresh generation: the old
        # generation stays readable until the index flips (rgw keeps
        # old head/tail objects alive until the index transaction
        # lands, then GCs them -- rgw_rados.cc write path)
        base = f"{bucket['id']}__shadow_{key}"
        return f"{base}.{tag}" if tag else base

    def _part_oid(self, bucket: dict, key: str, upload_id: str,
                  part: int) -> str:
        return f"{bucket['id']}__multipart_{key}.{upload_id}.{part}"

    async def _purge_data(self, bucket: dict, key: str,
                          entry: dict | None) -> None:
        """Remove an entry's backing data -- manifest parts for a
        completed multipart object, the shadow object otherwise.  An
        overwrite that skips this leaks the old parts forever (the
        index entry was their only reference)."""
        if entry and "manifest" in entry:
            for part in entry["manifest"]:
                await self.striper.remove(part["oid"])
        oid = (entry or {}).get("data_oid") or self._data_oid(bucket, key)
        await self.striper.remove(oid)

    # -- versioning ---------------------------------------------------------
    async def set_bucket_versioning(self, name: str,
                                    state: str) -> None:
        """state: "Enabled" | "Suspended" (PutBucketVersioning)."""
        if state not in ("Enabled", "Suspended"):
            raise RgwError("IllegalVersioningConfiguration", 400, state)
        await self.get_bucket(name)
        await self.ioctx.exec(BUCKETS_OID, "rgw_index", "dir_set",
                              json.dumps({"name": name, "patch": {
                                  "versioning": state}}).encode())

    async def get_bucket_versioning(self, name: str) -> str:
        return (await self.get_bucket(name)).get("versioning", "")

    async def _save_bucket(self, bucket: dict) -> None:
        """Patch mutable bucket metadata (notifications etc.)."""
        await self.ioctx.exec(
            BUCKETS_OID, "rgw_index", "dir_set",
            json.dumps({"name": bucket["name"], "patch": {
                k: bucket.get(k)
                for k in ("notifications",)}}).encode())

    async def list_object_versions(self, bucket_name: str,
                                   prefix: str = "", marker: str = "",
                                   max_keys: int = 1000) -> dict:
        bucket = await self.get_bucket(bucket_name)
        raw = json.loads(await self.ioctx.exec(
            self._index(bucket), "rgw_index", "version_list",
            json.dumps({"prefix": prefix, "marker": marker,
                        "max": max_keys}).encode()))
        return raw

    async def delete_version(self, bucket_name: str, key: str,
                             version_id: str) -> None:
        """Permanent removal of one version (DELETE ?versionId=)."""
        bucket = await self.get_bucket(bucket_name)
        try:
            raw = await self.ioctx.exec(
                self._index(bucket), "rgw_index", "version_rm",
                json.dumps({"key": key,
                            "version_id": version_id}).encode())
        except RadosError as e:
            if e.errno_name == "ENOENT":
                return                    # idempotent
            raise
        entry = json.loads(raw)
        if not entry.get("delete_marker"):
            await self._purge_data(bucket, key, entry)

    # -- lifecycle (rgw_lc.cc compressed) ------------------------------------
    async def set_bucket_lifecycle(self, name: str,
                                   rules: list[dict]) -> None:
        """rules: [{id, prefix, days, noncurrent_days, enabled}]."""
        await self.get_bucket(name)
        await self.ioctx.exec(BUCKETS_OID, "rgw_index", "dir_set",
                              json.dumps({"name": name, "patch": {
                                  "lifecycle": rules}}).encode())

    async def get_bucket_lifecycle(self, name: str) -> list[dict]:
        rules = (await self.get_bucket(name)).get("lifecycle")
        if not rules:
            raise RgwError("NoSuchLifecycleConfiguration", 404, name)
        return rules

    async def delete_bucket_lifecycle(self, name: str) -> None:
        await self.get_bucket(name)
        await self.ioctx.exec(BUCKETS_OID, "rgw_index", "dir_set",
                              json.dumps({"name": name, "patch": {
                                  "lifecycle": None}}).encode())

    @staticmethod
    def _mtime_age(mtime: str, now: float) -> float:
        import calendar
        t = calendar.timegm(time.strptime(mtime,
                                          "%Y-%m-%dT%H:%M:%S.000Z"))
        return now - t

    async def lc_process(self, bucket_name: str,
                         now: float | None = None) -> int:
        """Run this bucket's lifecycle rules once (RGWLC::process):
        expire current objects past Days (delete, or delete-marker on
        versioned buckets), reap noncurrent versions past
        NoncurrentDays, and drop expired delete markers that are the
        only thing left of a key.  Returns the action count."""
        bucket = await self.get_bucket(bucket_name)
        rules = [r for r in bucket.get("lifecycle") or []
                 if r.get("enabled", True)]
        if not rules:
            return 0
        now = time.time() if now is None else now
        versioned = bool(bucket.get("versioning"))
        actions = 0
        for rule in rules:
            prefix = rule.get("prefix", "")
            days = rule.get("days")
            if days is not None:
                listing = await self.list_objects(
                    bucket_name, prefix=prefix, max_keys=100000)
                for key, entry in listing["entries"]:
                    if self._mtime_age(entry["mtime"],
                                       now) >= days * 86400:
                        await self.delete_object(bucket_name, key,
                                                 notify=False)
                        await self.notify.emit(
                            bucket, "s3:ObjectLifecycle:Expiration:"
                            "Current", key)
                        actions += 1
            nc_days = rule.get("noncurrent_days")
            if versioned and nc_days is not None:
                vl = await self.list_object_versions(
                    bucket_name, prefix=prefix, max_keys=100000)
                for key, vid, entry, is_latest in vl["versions"]:
                    if is_latest:
                        continue
                    if self._mtime_age(entry["mtime"],
                                       now) >= nc_days * 86400:
                        await self.delete_version(bucket_name, key,
                                                  vid)
                        await self.notify.emit(
                            bucket, "s3:ObjectLifecycle:Expiration:"
                            "NoncurrentVersion", key, version_id=vid)
                        actions += 1
            if versioned and rule.get("expired_delete_marker"):
                vl = await self.list_object_versions(
                    bucket_name, prefix=prefix, max_keys=100000)
                per_key: dict[str, list] = {}
                for row in vl["versions"]:
                    per_key.setdefault(row[0], []).append(row)
                for key, rows in per_key.items():
                    if len(rows) == 1 and rows[0][2].get(
                            "delete_marker"):
                        await self.delete_version(bucket_name, key,
                                                  rows[0][1])
                        actions += 1
        return actions

    async def put_object(self, bucket_name: str, key: str, data: bytes,
                         owner: str = "", content_type: str = "",
                         meta: dict | None = None) -> dict:
        bucket = await self.get_bucket(bucket_name)
        versioning = bucket.get("versioning", "")
        if versioning:
            return await self._put_object_versioned(
                bucket, key, data, owner, content_type, meta,
                suspended=versioning == "Suspended")
        tag = os.urandom(8).hex()
        idx = self._index(bucket)
        await self.ioctx.exec(idx, "rgw_index", "prepare", json.dumps(
            {"tag": tag, "key": key, "op": "put"}).encode())
        # atomic replace: the new generation lands under a fresh tagged
        # oid while the old one stays live; the index 'complete' is the
        # commit point, RETURNS the entry it displaced (decided inside
        # the atomic op -- a client-side pre-read races a concurrent
        # PUT), and only then is that displaced data reclaimed.  A
        # crash mid-PUT leaves the old object intact (the orphan new
        # tag is garbage, never reachable).
        soid = self._data_oid(bucket, key, tag)
        try:
            if data:
                await self.striper.write(soid, data, 0)
            etag = hashlib.md5(data).hexdigest()
            entry = {"size": len(data), "etag": etag, "mtime": _now_iso(),
                     "owner": owner, "content_type": content_type,
                     "data_oid": soid, "meta": meta or {}}
            raw = await self.ioctx.exec(
                idx, "rgw_index", "complete",
                json.dumps({"tag": tag, "key": key,
                            "entry": entry}).encode())
        except Exception:
            try:                      # best-effort: the original error
                await self.striper.remove(soid)   # must survive
            except Exception:
                pass
            raise
        await self._purge_replaced(bucket, key, raw, soid)
        await self.notify.emit(bucket, "s3:ObjectCreated:Put", key,
                               size=len(data), etag=etag)
        return entry

    async def _put_object_versioned(self, bucket: dict, key: str,
                                    data: bytes, owner: str,
                                    content_type: str,
                                    meta: dict | None,
                                    suspended: bool) -> dict:
        """Versioned PUT: every write is a NEW generation under its
        own version id (rgw_rados versioned write path); Enabled keeps
        old versions readable, Suspended reuses the "null" id and
        reclaims only its previous occupant."""
        vid = "null" if suspended else _new_version_id()
        # the DATA oid is always a fresh generation, even for the
        # reused "null" id: overwriting the live null version's bytes
        # in place would corrupt it on a crash mid-PUT, and the error
        # path below must only ever remove bytes nothing references
        tag = vid if not suspended else f"null.{os.urandom(6).hex()}"
        soid = self._data_oid(bucket, key, tag)
        try:
            if data:
                await self.striper.write(soid, data, 0)
            entry = {"size": len(data),
                     "etag": hashlib.md5(data).hexdigest(),
                     "mtime": _now_iso(), "owner": owner,
                     "content_type": content_type, "data_oid": soid,
                     "version_id": vid, "meta": meta or {}}
            raw = await self.ioctx.exec(
                self._index(bucket), "rgw_index", "version_put",
                json.dumps({"key": key, "entry": entry,
                            "suspended": suspended}).encode())
        except Exception:
            try:
                await self.striper.remove(soid)
            except Exception:
                pass
            raise
        await self._purge_replaced(bucket, key, raw, soid)
        await self.notify.emit(bucket, "s3:ObjectCreated:Put", key,
                               size=len(data),
                               etag=entry["etag"], version_id=vid)
        return entry

    async def put_delete_marker(self, bucket: dict, key: str,
                                suspended: bool,
                                notify: bool = True) -> str:
        """S3 DELETE in a versioned bucket: a delete MARKER becomes
        the current version; data stays."""
        vid = "null" if suspended else _new_version_id()
        entry = {"size": 0, "etag": "", "mtime": _now_iso(),
                 "delete_marker": True, "version_id": vid, "meta": {}}
        raw = await self.ioctx.exec(
            self._index(bucket), "rgw_index", "version_put",
            json.dumps({"key": key, "entry": entry,
                        "suspended": suspended}).encode())
        await self._purge_replaced(bucket, key, raw, "")
        if notify:
            await self.notify.emit(
                bucket, "s3:ObjectRemoved:DeleteMarkerCreated", key,
                version_id=vid)
        return vid

    async def _purge_replaced(self, bucket: dict, key: str,
                              raw: bytes, new_oid: str) -> None:
        """Reclaim the entry the index swap displaced (never the one
        just linked: a same-oid no-op guard keeps a legacy undiffer-
        entiated overwrite from deleting its own data)."""
        if not raw:
            return
        old = json.loads(raw)
        old_oid = old.get("data_oid") or self._data_oid(bucket, key)
        if old_oid == new_oid:
            return
        await self._purge_data(bucket, key, old)

    async def put_object_manifest(self, bucket_name: str, key: str,
                                  parts: list[dict], owner: str,
                                  content_type: str, etag: str,
                                  meta: dict | None = None) -> dict:
        """Link a multipart manifest as the object (complete-upload)."""
        bucket = await self.get_bucket(bucket_name)
        size = sum(p["size"] for p in parts)
        entry = {"size": size, "etag": etag, "mtime": _now_iso(),
                 "owner": owner, "content_type": content_type,
                 "meta": meta or {},
                 "manifest": [{"oid": p["oid"], "size": p["size"]}
                              for p in parts]}
        # index flip first; the swap's displaced entry (returned by
        # the atomic op) is reclaimed only after commit
        raw = await self.ioctx.exec(
            self._index(bucket), "rgw_index", "complete",
            json.dumps({"key": key, "entry": entry}).encode())
        await self._purge_replaced(bucket, key, raw, "")
        await self.notify.emit(
            bucket, "s3:ObjectCreated:CompleteMultipartUpload", key,
            size=entry.get("size", 0), etag=entry.get("etag", ""))
        return entry

    async def get_entry(self, bucket_name: str, key: str,
                        version_id: str | None = None) -> dict:
        bucket = await self.get_bucket(bucket_name)
        try:
            if version_id:
                raw = await self.ioctx.exec(
                    self._index(bucket), "rgw_index", "get_version",
                    json.dumps({"key": key,
                                "version_id": version_id}).encode())
            else:
                raw = await self.ioctx.exec(
                    self._index(bucket), "rgw_index", "get",
                    json.dumps({"key": key}).encode())
        except RadosError as e:
            raise RgwError("NoSuchKey", 404, key) from e
        entry = json.loads(raw)
        if entry.get("delete_marker") and not version_id:
            raise RgwError("NoSuchKey", 404, key)
        return entry

    async def get_object(self, bucket_name: str, key: str,
                         off: int = 0,
                         length: int | None = None,
                         version_id: str | None = None
                         ) -> tuple[dict, bytes]:
        bucket = await self.get_bucket(bucket_name)
        entry = await self.get_entry(bucket_name, key, version_id)
        if length is None:
            length = entry["size"] - off
        length = max(0, min(length, entry["size"] - off))
        if "manifest" in entry:
            data = await self._read_manifest(entry["manifest"], off,
                                             length)
        else:
            oid = entry.get("data_oid") or self._data_oid(bucket, key)
            data = await self.striper.read(oid, length, off)
        return entry, data

    async def _read_manifest(self, manifest: list[dict], off: int,
                             length: int) -> bytes:
        out = []
        pos = 0
        for part in manifest:
            pend = pos + part["size"]
            if pend > off and pos < off + length:
                s = max(0, off - pos)
                n = min(part["size"], off + length - pos) - s
                out.append(await self.striper.read(part["oid"], n, s))
            pos = pend
            if pos >= off + length:
                break
        return b"".join(out)

    async def delete_object(self, bucket_name: str, key: str,
                            notify: bool = True) -> str | None:
        bucket = await self.get_bucket(bucket_name)
        versioning = bucket.get("versioning", "")
        if versioning:
            return await self.put_delete_marker(
                bucket, key, suspended=versioning == "Suspended",
                notify=notify)
        try:
            raw = await self.ioctx.exec(
                self._index(bucket), "rgw_index", "unlink",
                json.dumps({"key": key}).encode())
        except RadosError as e:
            if e.errno_name == "ENOENT":
                return                    # S3 DELETE is idempotent
            raise
        # purge exactly what the atomic unlink removed: two racing
        # deletes cannot double-free, and a racing PUT's fresh
        # generation is never touched
        await self._purge_replaced(bucket, key, raw, "")
        if notify:
            await self.notify.emit(bucket, "s3:ObjectRemoved:Delete",
                                   key)

    async def list_objects(self, bucket_name: str, prefix: str = "",
                           marker: str = "", max_keys: int = 1000,
                           delimiter: str = "") -> dict:
        bucket = await self.get_bucket(bucket_name)
        entries: list[list] = []
        prefixes: set[str] = set()
        truncated = False
        cursor = marker
        while True:
            raw = json.loads(await self.ioctx.exec(
                self._index(bucket), "rgw_index", "list",
                json.dumps({"prefix": prefix, "marker": cursor,
                            "max": max_keys + 1}).encode()))
            page = raw["entries"]
            if not page:
                truncated = False
                break
            full = False
            for i, (k, e) in enumerate(page):
                cursor = k
                if delimiter:
                    rest = k[len(prefix):]
                    if delimiter in rest:
                        prefixes.add(
                            prefix + rest.split(delimiter)[0] + delimiter)
                        continue
                entries.append([k, e])
                if len(entries) >= max_keys:
                    # more results iff the page has unconsumed items
                    # or the index said there are further pages
                    truncated = (i + 1 < len(page)
                                 or bool(raw["truncated"]))
                    full = True
                    break
            if full:
                break
            if not raw["truncated"]:
                truncated = False
                break
        return {"entries": entries, "truncated": truncated,
                "prefixes": sorted(prefixes),
                "next_marker": entries[-1][0] if entries else ""}

    # -- multipart ----------------------------------------------------------
    async def initiate_multipart(self, bucket_name: str, key: str,
                                 owner: str,
                                 content_type: str = "") -> str:
        bucket = await self.get_bucket(bucket_name)
        upload_id = os.urandom(12).hex()
        await self.ioctx.set_omap(
            f"rgw_uploads.{bucket['id']}",
            {upload_id: json.dumps({
                "key": key, "owner": owner,
                "content_type": content_type,
                "started": _now_iso()}).encode()})
        return upload_id

    async def _upload_meta(self, bucket: dict, upload_id: str) -> dict:
        try:
            omap = await self.ioctx.get_omap(
                f"rgw_uploads.{bucket['id']}")
        except RadosError:
            omap = {}
        raw = omap.get(upload_id)
        if raw is None:
            raise RgwError("NoSuchUpload", 404, upload_id)
        return json.loads(raw)

    async def put_part(self, bucket_name: str, key: str, upload_id: str,
                       part_number: int, data: bytes) -> dict:
        bucket = await self.get_bucket(bucket_name)
        await self._upload_meta(bucket, upload_id)
        oid = self._part_oid(bucket, key, upload_id, part_number)
        await self.striper.remove(oid)
        await self.striper.write(oid, data, 0)
        # record the part so abort can find EXACTLY the uploaded parts
        # (a dense 1..n probe loses parts after a gap)
        await self.ioctx.set_omap(
            f"rgw_uploads.{bucket['id']}",
            {f"{upload_id}.part.{part_number}":
             str(len(data)).encode()})
        return {"etag": hashlib.md5(data).hexdigest(),
                "size": len(data), "oid": oid}

    async def complete_multipart(self, bucket_name: str, key: str,
                                 upload_id: str,
                                 part_numbers: list[int]) -> dict:
        bucket = await self.get_bucket(bucket_name)
        up = await self._upload_meta(bucket, upload_id)
        parts = []
        md5s = []
        for n in part_numbers:
            oid = self._part_oid(bucket, key, upload_id, n)
            size = await self.striper.size(oid)
            if size == 0:
                raise RgwError("InvalidPart", 400, f"part {n}")
            buf = await self.striper.read(oid)
            md5s.append(hashlib.md5(buf).digest())
            parts.append({"oid": oid, "size": size})
        etag = (hashlib.md5(b"".join(md5s)).hexdigest()
                + f"-{len(parts)}")
        entry = await self.put_object_manifest(
            bucket_name, key, parts, up["owner"], up["content_type"],
            etag)
        uploaded = await self._uploaded_parts(bucket, upload_id)
        # parts uploaded but not referenced by the manifest (retries,
        # gaps, unused numbers) are garbage now
        for n in set(uploaded) - set(part_numbers):
            await self.striper.remove(
                self._part_oid(bucket, key, upload_id, n))
        await self.ioctx.rm_omap_keys(
            f"rgw_uploads.{bucket['id']}",
            [upload_id] + [f"{upload_id}.part.{n}" for n in uploaded])
        return entry

    async def _uploaded_parts(self, bucket: dict,
                              upload_id: str) -> list[int]:
        try:
            omap = await self.ioctx.get_omap(
                f"rgw_uploads.{bucket['id']}")
        except RadosError:
            return []
        pre = f"{upload_id}.part."
        return sorted(int(k[len(pre):]) for k in omap
                      if k.startswith(pre))

    async def abort_multipart(self, bucket_name: str, key: str,
                              upload_id: str) -> None:
        bucket = await self.get_bucket(bucket_name)
        await self._upload_meta(bucket, upload_id)
        parts = await self._uploaded_parts(bucket, upload_id)
        for n in parts:
            await self.striper.remove(
                self._part_oid(bucket, key, upload_id, n))
        await self.ioctx.rm_omap_keys(
            f"rgw_uploads.{bucket['id']}",
            [upload_id] + [f"{upload_id}.part.{n}" for n in parts])
