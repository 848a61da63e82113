"""RGW frontend: asyncio HTTP server speaking the S3 REST dialect.

The request pump mirrors src/rgw/rgw_process.cc:265 process_request:
parse -> authenticate (AWS SigV4, src/rgw/rgw_auth_s3.cc) -> resolve
op -> execute against the SAL store -> emit XML.  One handler task per
connection (the asio frontend's strand-per-connection analog).

Supported: bucket create/delete/list, ListObjectsV2 (prefix/delimiter/
continuation), object PUT/GET(ranged)/HEAD/DELETE, x-amz-copy-source
copies, multipart initiate/upload-part/complete/abort, SigV4 auth with
UNSIGNED-PAYLOAD or signed-payload hashes.

Port of ``ceph_tpu/rgw/gateway.py``; runs unchanged over the
port's librados.
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac
import re
import time
import urllib.parse
from xml.etree import ElementTree as ET
from xml.sax.saxutils import escape

from .store import RgwError, RgwStore

MAX_BODY = 1 << 30
XMLNS = "http://s3.amazonaws.com/doc/2006-03-01/"


def _sign(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sigv4_signature(secret: str, date_stamp: str, region: str,
                    service: str, string_to_sign: str) -> str:
    k = _sign(("AWS4" + secret).encode(), date_stamp)
    k = _sign(k, region)
    k = _sign(k, service)
    k = _sign(k, "aws4_request")
    return hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()


class HttpRequest:
    def __init__(self, method, path, query, headers, body):
        self.method = method
        self.raw_path = path
        self.path = urllib.parse.unquote(path)
        self.query = query                  # dict[str, str]
        self.headers = headers              # lowercased keys
        self.body = body


class Gateway:
    def __init__(self, store: RgwStore, region: str = "default") -> None:
        self.store = store
        self.region = region
        from .swift import SwiftFrontend
        self.swift = SwiftFrontend(store)
        self._server: asyncio.AbstractServer | None = None
        self.addr: tuple[str, int] | None = None

    async def start(self, host: str = "127.0.0.1",
                    port: int = 0) -> tuple[str, int]:
        self._server = await asyncio.start_server(self._serve_conn,
                                                  host, port)
        self.addr = self._server.sockets[0].getsockname()[:2]
        return self.addr

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    # -- connection handling -------------------------------------------------
    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                req = await self._read_request(reader)
                if req is None:
                    break
                status, headers, body = await self._handle(req)
                await self._respond(writer, req, status, headers, body)
                if req.headers.get("connection", "").lower() == "close":
                    break
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.TimeoutError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _read_request(self, reader) -> HttpRequest | None:
        try:
            line = await asyncio.wait_for(reader.readline(), 300)
        except asyncio.TimeoutError:
            return None
        if not line:
            return None
        try:
            method, target, _version = line.decode().split(" ", 2)
        except ValueError:
            return None
        headers: dict[str, str] = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode().partition(":")
            headers[k.strip().lower()] = v.strip()
        parsed = urllib.parse.urlsplit(target)
        query = dict(urllib.parse.parse_qsl(parsed.query,
                                            keep_blank_values=True))
        n = int(headers.get("content-length", "0") or "0")
        if n > MAX_BODY:
            return None
        body = await reader.readexactly(n) if n else b""
        return HttpRequest(method.upper(), parsed.path, query, headers,
                           body)

    async def _respond(self, writer, req, status, headers, body):
        reason = {200: "OK", 201: "Created", 204: "No Content",
                  206: "Partial Content", 400: "Bad Request",
                  401: "Unauthorized", 403: "Forbidden",
                  404: "Not Found", 405: "Method Not Allowed",
                  409: "Conflict", 416: "Range Not Satisfiable",
                  500: "Internal Server Error",
                  501: "Not Implemented"}.get(status, "Error")
        headers.setdefault("content-length", str(len(body)))
        headers.setdefault("x-amz-request-id", f"{time.time_ns():x}")
        lines = [f"HTTP/1.1 {status} {reason}"]
        lines += [f"{k}: {v}" for k, v in headers.items()]
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode())
        if req.method != "HEAD":
            writer.write(body)
        await writer.drain()

    # -- auth (AWS SigV4, src/rgw/rgw_auth_s3.cc) ---------------------------
    async def _authenticate(self, req: HttpRequest) -> dict:
        auth = req.headers.get("authorization", "")
        m = re.match(
            r"AWS4-HMAC-SHA256 Credential=([^/]+)/(\d+)/([^/]+)/([^/]+)"
            r"/aws4_request,\s*SignedHeaders=([^,]+),\s*Signature=(\w+)",
            auth)
        if not m:
            raise RgwError("AccessDenied", 403, "missing/bad auth header")
        access_key, date_stamp, region, service, signed_hdrs, sig = \
            m.groups()
        user = await self.store.get_user(access_key)
        if user is None:
            raise RgwError("InvalidAccessKeyId", 403, access_key)
        payload_hash = req.headers.get(
            "x-amz-content-sha256", "UNSIGNED-PAYLOAD")
        if payload_hash not in ("UNSIGNED-PAYLOAD",
                                "STREAMING-UNSIGNED-PAYLOAD-TRAILER"):
            if hashlib.sha256(req.body).hexdigest() != payload_hash:
                raise RgwError("XAmzContentSHA256Mismatch", 400)
        canonical_query = "&".join(
            f"{urllib.parse.quote(k, safe='-_.~')}="
            f"{urllib.parse.quote(v, safe='-_.~')}"
            for k, v in sorted(req.query.items()))
        names = signed_hdrs.split(";")
        canonical_headers = "".join(
            f"{h}:{' '.join(req.headers.get(h, '').split())}\n"
            for h in names)
        canonical = "\n".join([
            req.method, urllib.parse.quote(req.path, safe="/-_.~"),
            canonical_query, canonical_headers, signed_hdrs,
            payload_hash])
        amz_date = req.headers.get("x-amz-date", "")
        scope = f"{date_stamp}/{region}/{service}/aws4_request"
        string_to_sign = "\n".join([
            "AWS4-HMAC-SHA256", amz_date, scope,
            hashlib.sha256(canonical.encode()).hexdigest()])
        want = sigv4_signature(user["secret"], date_stamp, region,
                               service, string_to_sign)
        if not hmac.compare_digest(want, sig):
            raise RgwError("SignatureDoesNotMatch", 403)
        return user

    # -- dispatch ------------------------------------------------------------
    async def _handle(self, req: HttpRequest):
        if self.swift.routes(req.path):
            # the Swift dialect shares the store but not the auth or
            # the XML (rgw serves both APIs from one daemon); its
            # errors must also surface as HTTP, never a torn socket
            try:
                return await self.swift.handle(req)
            except (ValueError, KeyError) as e:
                return 400, {"content-type": "text/plain"}, \
                    f"BadRequest: {type(e).__name__}".encode()
            except Exception:                 # noqa: BLE001
                return 500, {"content-type": "text/plain"}, \
                    b"InternalError"
        try:
            user = await self._authenticate(req)
            parts = req.path.lstrip("/").split("/", 1)
            bucket = parts[0]
            key = parts[1] if len(parts) > 1 else ""
            if not bucket:
                return await self._list_buckets(user)
            if not key:
                return await self._bucket_op(req, user, bucket)
            return await self._object_op(req, user, bucket, key)
        except RgwError as e:
            return self._error_response(e)
        except (ValueError, KeyError, ET.ParseError) as e:
            # malformed request params/XML must yield an HTTP error,
            # not a torn-down connection with no status line
            return self._error_response(
                RgwError("InvalidRequest", 400,
                         f"{type(e).__name__}: {e}"))
        except Exception as e:              # noqa: BLE001 -- last resort
            return self._error_response(
                RgwError("InternalError", 500, type(e).__name__))

    @staticmethod
    def _error_response(e: RgwError):
        body = (f'<?xml version="1.0" encoding="UTF-8"?>'
                f"<Error><Code>{e.code}</Code>"
                f"<Message>{escape(str(e))}</Message></Error>"
                ).encode()
        return e.status, {"content-type": "application/xml"}, body

    async def _list_buckets(self, user):
        buckets = await self.store.list_buckets(owner=user["uid"])
        items = "".join(
            f"<Bucket><Name>{escape(b['name'])}</Name>"
            f"<CreationDate>{b['created']}</CreationDate></Bucket>"
            for b in buckets)
        body = (f'<?xml version="1.0" encoding="UTF-8"?>'
                f'<ListAllMyBucketsResult xmlns="{XMLNS}">'
                f"<Owner><ID>{escape(user['uid'])}</ID></Owner>"
                f"<Buckets>{items}</Buckets>"
                f"</ListAllMyBucketsResult>").encode()
        return 200, {"content-type": "application/xml"}, body

    async def _bucket_op(self, req, user, bucket):
        q = req.query
        if req.method == "PUT" and "versioning" in q:
            root = ET.fromstring(req.body)
            ns = root.tag.partition("}")[0] + "}" \
                if root.tag.startswith("{") else ""
            status = root.findtext(f"{ns}Status") or ""
            await self.store.set_bucket_versioning(bucket, status)
            return 200, {}, b""
        if req.method == "GET" and "versioning" in q:
            state = await self.store.get_bucket_versioning(bucket)
            inner = f"<Status>{state}</Status>" if state else ""
            return 200, {"content-type": "application/xml"}, (
                f'<?xml version="1.0"?>'
                f'<VersioningConfiguration xmlns="{XMLNS}">{inner}'
                f"</VersioningConfiguration>").encode()
        if req.method == "PUT" and "lifecycle" in q:
            await self.store.set_bucket_lifecycle(
                bucket, self._parse_lifecycle(req.body))
            return 200, {}, b""
        if req.method == "GET" and "lifecycle" in q:
            rules = await self.store.get_bucket_lifecycle(bucket)
            return 200, {"content-type": "application/xml"}, \
                self._lifecycle_xml(rules)
        if req.method == "DELETE" and "lifecycle" in q:
            await self.store.delete_bucket_lifecycle(bucket)
            return 204, {}, b""
        if req.method == "PUT" and "notification" in q:
            # S3 PutBucketNotificationConfiguration: Topic + Event
            # elements per TopicConfiguration (rgw_rest_pubsub)
            root = ET.fromstring(req.body)
            ns = root.tag.partition("}")[0] + "}" \
                if root.tag.startswith("{") else ""
            configs = []
            for tc in root.findall(f"{ns}TopicConfiguration"):
                cfg = {"id": tc.findtext(f"{ns}Id") or "",
                       "topic": (tc.findtext(f"{ns}Topic") or ""
                                 ).rsplit(":", 1)[-1],
                       "events": [e.text for e in
                                  tc.findall(f"{ns}Event")
                                  if e.text]}
                fr = tc.find(f"{ns}Filter")
                if fr is not None:
                    filt = {}
                    for rule in fr.iter(f"{ns}FilterRule"):
                        n = rule.findtext(f"{ns}Name") or ""
                        v = rule.findtext(f"{ns}Value") or ""
                        filt[n.lower()] = v
                    cfg["filter"] = filt
                configs.append(cfg)
            await self.store.notify.put_bucket_notification(
                bucket, configs)
            return 200, {}, b""
        if req.method == "GET" and "notification" in q:
            configs = await self.store.notify.get_bucket_notification(
                bucket)
            from xml.sax.saxutils import escape
            parts = []
            for c in configs:
                evs = "".join(f"<Event>{escape(e)}</Event>"
                              for e in c.get("events", []))
                filt = ""
                rules = "".join(
                    f"<FilterRule><Name>{escape(n)}</Name>"
                    f"<Value>{escape(v)}</Value></FilterRule>"
                    for n, v in (c.get("filter") or {}).items())
                if rules:
                    filt = (f"<Filter><S3Key>{rules}</S3Key>"
                            f"</Filter>")
                parts.append(
                    f"<TopicConfiguration>"
                    f"<Id>{escape(c.get('id', ''))}</Id>"
                    f"<Topic>{escape(c['topic'])}</Topic>{evs}{filt}"
                    f"</TopicConfiguration>")
            return 200, {"content-type": "application/xml"}, (
                f'<?xml version="1.0"?>'
                f'<NotificationConfiguration xmlns="{XMLNS}">'
                f"{''.join(parts)}</NotificationConfiguration>"
            ).encode()
        if req.method == "GET" and "versions" in q:
            return await self._list_versions(req, bucket)
        if req.method == "PUT":
            await self.store.create_bucket(bucket, user["uid"])
            return 200, {"location": f"/{bucket}"}, b""
        if req.method == "DELETE":
            await self.store.delete_bucket(bucket)
            return 204, {}, b""
        if req.method in ("GET", "HEAD"):
            if "uploads" in q:
                return 200, {"content-type": "application/xml"}, (
                    f'<?xml version="1.0"?><ListMultipartUploadsResult '
                    f'xmlns="{XMLNS}"></ListMultipartUploadsResult>'
                ).encode()
            return await self._list_objects_v2(req, bucket)
        raise RgwError("MethodNotAllowed", 400, req.method)

    @staticmethod
    def _parse_lifecycle(body: bytes) -> list[dict]:
        root = ET.fromstring(body)
        ns = root.tag.partition("}")[0] + "}" \
            if root.tag.startswith("{") else ""
        rules = []
        for r in root.findall(f"{ns}Rule"):
            rule = {"id": r.findtext(f"{ns}ID") or "",
                    "prefix": (r.findtext(f"{ns}Prefix")
                               or r.findtext(f"{ns}Filter/{ns}Prefix")
                               or ""),
                    "enabled": (r.findtext(f"{ns}Status") or
                                "Enabled") == "Enabled"}
            exp = r.find(f"{ns}Expiration")
            if exp is not None:
                days = exp.findtext(f"{ns}Days")
                if days:
                    rule["days"] = int(days)
                if (exp.findtext(f"{ns}ExpiredObjectDeleteMarker")
                        or "").lower() == "true":
                    rule["expired_delete_marker"] = True
            nce = r.find(f"{ns}NoncurrentVersionExpiration")
            if nce is not None:
                nd = nce.findtext(f"{ns}NoncurrentDays")
                if nd:
                    rule["noncurrent_days"] = int(nd)
            rules.append(rule)
        return rules

    @staticmethod
    def _lifecycle_xml(rules: list[dict]) -> bytes:
        items = []
        for r in rules:
            exp = ""
            if r.get("days") is not None:
                exp += f"<Days>{r['days']}</Days>"
            if r.get("expired_delete_marker"):
                exp += ("<ExpiredObjectDeleteMarker>true"
                        "</ExpiredObjectDeleteMarker>")
            nce = (f"<NoncurrentVersionExpiration><NoncurrentDays>"
                   f"{r['noncurrent_days']}</NoncurrentDays>"
                   f"</NoncurrentVersionExpiration>"
                   if r.get("noncurrent_days") is not None else "")
            items.append(
                f"<Rule><ID>{escape(r.get('id', ''))}</ID>"
                f"<Prefix>{escape(r.get('prefix', ''))}</Prefix>"
                f"<Status>"
                f"{'Enabled' if r.get('enabled', True) else 'Disabled'}"
                f"</Status>"
                + (f"<Expiration>{exp}</Expiration>" if exp else "")
                + nce + "</Rule>")
        return (f'<?xml version="1.0"?>'
                f'<LifecycleConfiguration xmlns="{XMLNS}">'
                + "".join(items)
                + "</LifecycleConfiguration>").encode()

    async def _list_versions(self, req, bucket):
        prefix = req.query.get("prefix", "")
        key_marker = req.query.get("key-marker", "")
        vid_marker = req.query.get("version-id-marker", "")
        # internal marker is "key\x00vid"; a bare key-marker resumes
        # AFTER every version of that key (\x01 sorts past them all)
        if key_marker and vid_marker:
            marker = f"{key_marker}\x00{vid_marker}"
        elif key_marker:
            marker = key_marker + "\x01"
        else:
            marker = ""
        max_keys = int(req.query.get("max-keys", "1000"))
        out = await self.store.list_object_versions(
            bucket, prefix=prefix, marker=marker, max_keys=max_keys)
        items = []
        for key, vid, e, is_latest in out["versions"]:
            latest = "true" if is_latest else "false"
            if e.get("delete_marker"):
                items.append(
                    f"<DeleteMarker><Key>{escape(key)}</Key>"
                    f"<VersionId>{vid}</VersionId>"
                    f"<IsLatest>{latest}</IsLatest>"
                    f"<LastModified>{e['mtime']}</LastModified>"
                    f"</DeleteMarker>")
            else:
                items.append(
                    f"<Version><Key>{escape(key)}</Key>"
                    f"<VersionId>{vid}</VersionId>"
                    f"<IsLatest>{latest}</IsLatest>"
                    f"<LastModified>{e['mtime']}</LastModified>"
                    f"<ETag>&quot;{e['etag']}&quot;</ETag>"
                    f"<Size>{e['size']}</Size></Version>")
        trunc = "true" if out["truncated"] else "false"
        nxt = ""
        if out["truncated"] and out.get("next_marker"):
            nk, _, nv = out["next_marker"].partition("\x00")
            nxt = (f"<NextKeyMarker>{escape(nk)}</NextKeyMarker>"
                   f"<NextVersionIdMarker>{escape(nv)}"
                   f"</NextVersionIdMarker>")
        return 200, {"content-type": "application/xml"}, (
            f'<?xml version="1.0"?>'
            f'<ListVersionsResult xmlns="{XMLNS}">'
            f"<Name>{escape(bucket)}</Name>"
            f"<Prefix>{escape(prefix)}</Prefix>"
            f"<IsTruncated>{trunc}</IsTruncated>{nxt}"
            + "".join(items) + "</ListVersionsResult>").encode()

    async def _list_objects_v2(self, req, bucket):
        prefix = req.query.get("prefix", "")
        delim = req.query.get("delimiter", "")
        max_keys = int(req.query.get("max-keys", "1000"))
        marker = req.query.get("continuation-token",
                               req.query.get("start-after",
                                             req.query.get("marker", "")))
        out = await self.store.list_objects(
            bucket, prefix=prefix, marker=marker, max_keys=max_keys,
            delimiter=delim)
        contents = "".join(
            f"<Contents><Key>{escape(k)}</Key>"
            f"<LastModified>{e['mtime']}</LastModified>"
            f"<ETag>&quot;{e['etag']}&quot;</ETag>"
            f"<Size>{e['size']}</Size>"
            f"<StorageClass>STANDARD</StorageClass></Contents>"
            for k, e in out["entries"])
        commons = "".join(
            f"<CommonPrefixes><Prefix>{escape(p)}</Prefix>"
            f"</CommonPrefixes>" for p in out["prefixes"])
        trunc = "true" if out["truncated"] else "false"
        nct = (f"<NextContinuationToken>{escape(out['next_marker'])}"
               f"</NextContinuationToken>" if out["truncated"] else "")
        body = (f'<?xml version="1.0" encoding="UTF-8"?>'
                f'<ListBucketResult xmlns="{XMLNS}">'
                f"<Name>{escape(bucket)}</Name>"
                f"<Prefix>{escape(prefix)}</Prefix>"
                f"<KeyCount>{len(out['entries'])}</KeyCount>"
                f"<MaxKeys>{max_keys}</MaxKeys>"
                f"<IsTruncated>{trunc}</IsTruncated>{nct}"
                f"{contents}{commons}</ListBucketResult>").encode()
        return 200, {"content-type": "application/xml"}, body

    async def _object_op(self, req, user, bucket, key):
        q = req.query
        if req.method == "POST" and "uploads" in q:
            uid = await self.store.initiate_multipart(
                bucket, key, user["uid"],
                req.headers.get("content-type", ""))
            body = (f'<?xml version="1.0"?>'
                    f'<InitiateMultipartUploadResult xmlns="{XMLNS}">'
                    f"<Bucket>{escape(bucket)}</Bucket>"
                    f"<Key>{escape(key)}</Key>"
                    f"<UploadId>{uid}</UploadId>"
                    f"</InitiateMultipartUploadResult>").encode()
            return 200, {"content-type": "application/xml"}, body
        if req.method == "PUT" and "uploadId" in q:
            part = await self.store.put_part(
                bucket, key, q["uploadId"], int(q["partNumber"]),
                req.body)
            return 200, {"etag": f'"{part["etag"]}"'}, b""
        if req.method == "POST" and "uploadId" in q:
            root = ET.fromstring(req.body)
            ns = root.tag.partition("}")[0] + "}" \
                if root.tag.startswith("{") else ""
            nums = sorted(int(p.findtext(f"{ns}PartNumber"))
                          for p in root.findall(f"{ns}Part"))
            entry = await self.store.complete_multipart(
                bucket, key, q["uploadId"], nums)
            body = (f'<?xml version="1.0"?>'
                    f'<CompleteMultipartUploadResult xmlns="{XMLNS}">'
                    f"<Bucket>{escape(bucket)}</Bucket>"
                    f"<Key>{escape(key)}</Key>"
                    f"<ETag>&quot;{entry['etag']}&quot;</ETag>"
                    f"</CompleteMultipartUploadResult>").encode()
            return 200, {"content-type": "application/xml"}, body
        if req.method == "DELETE" and "uploadId" in q:
            await self.store.abort_multipart(bucket, key, q["uploadId"])
            return 204, {}, b""
        if req.method == "PUT":
            src = req.headers.get("x-amz-copy-source")
            if src:
                sb, _, sk = urllib.parse.unquote(
                    src.lstrip("/")).partition("/")
                src_entry, data = await self.store.get_object(sb, sk)
                # S3 CopyObject defaults to the COPY metadata
                # directive: source content-type + x-amz-meta carry over
                replace = req.headers.get(
                    "x-amz-metadata-directive", "COPY") == "REPLACE"
                entry = await self.store.put_object(
                    bucket, key, data, owner=user["uid"],
                    content_type=(req.headers.get("content-type", "")
                                  if replace
                                  else src_entry.get("content_type", "")),
                    meta=({k[len("x-amz-meta-"):]: v
                           for k, v in req.headers.items()
                           if k.startswith("x-amz-meta-")}
                          if replace else src_entry.get("meta", {})))
                body = (f'<?xml version="1.0"?><CopyObjectResult>'
                        f"<ETag>&quot;{entry['etag']}&quot;</ETag>"
                        f"<LastModified>{entry['mtime']}</LastModified>"
                        f"</CopyObjectResult>").encode()
                return 200, {"content-type": "application/xml"}, body
            meta = {k[len("x-amz-meta-"):]: v
                    for k, v in req.headers.items()
                    if k.startswith("x-amz-meta-")}
            entry = await self.store.put_object(
                bucket, key, req.body, owner=user["uid"],
                content_type=req.headers.get("content-type", ""),
                meta=meta)
            hdrs = {"etag": f'"{entry["etag"]}"'}
            if entry.get("version_id"):
                hdrs["x-amz-version-id"] = entry["version_id"]
            return 200, hdrs, b""
        if req.method in ("GET", "HEAD"):
            off, length = 0, None
            status = 200
            vid = q.get("versionId")
            rng = req.headers.get("range")
            entry = await self.store.get_entry(bucket, key, vid)
            if entry.get("delete_marker"):
                raise RgwError("MethodNotAllowed", 405,
                               "the specified version is a delete "
                               "marker")
            if rng:
                m = re.match(r"bytes=(\d*)-(\d*)$", rng)
                if not m or (not m.group(1) and not m.group(2)):
                    raise RgwError("InvalidRange", 416, rng)
                if m.group(1):
                    off = int(m.group(1))
                    end = (int(m.group(2)) if m.group(2)
                           else entry["size"] - 1)
                else:                       # suffix range: last N bytes
                    off = max(0, entry["size"] - int(m.group(2)))
                    end = entry["size"] - 1
                if off >= entry["size"]:
                    raise RgwError("InvalidRange", 416, rng)
                end = min(end, entry["size"] - 1)
                length = end - off + 1
                status = 206
            if req.method == "HEAD":
                data = b""
            else:
                entry, data = await self.store.get_object(
                    bucket, key, off, length, version_id=vid)
            headers = {
                "content-type": entry.get("content_type")
                or "binary/octet-stream",
                "etag": f'"{entry["etag"]}"',
                "last-modified": entry["mtime"],
                "content-length": str(len(data) if req.method == "GET"
                                      else (length if length is not None
                                            else entry["size"])),
                "accept-ranges": "bytes",
            }
            for mk, mv in entry.get("meta", {}).items():
                headers[f"x-amz-meta-{mk}"] = mv
            if entry.get("version_id"):
                headers["x-amz-version-id"] = entry["version_id"]
            if status == 206:
                headers["content-range"] = (
                    f"bytes {off}-{off + length - 1}/{entry['size']}")
            return status, headers, data
        if req.method == "DELETE":
            if "versionId" in q:
                await self.store.delete_version(bucket, key,
                                                q["versionId"])
                return 204, {"x-amz-version-id": q["versionId"]}, b""
            marker_vid = await self.store.delete_object(bucket, key)
            hdrs = {}
            if marker_vid:
                hdrs = {"x-amz-delete-marker": "true",
                        "x-amz-version-id": marker_vid}
            return 204, hdrs, b""
        raise RgwError("MethodNotAllowed", 400, req.method)
