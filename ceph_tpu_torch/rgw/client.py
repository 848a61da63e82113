"""Minimal SigV4-signing S3 client (the s3cmd/boto smoke-test analog).

Signs exactly the canonical form gateway.py verifies; used by the test
suite to exercise the REAL HTTP path and usable as a library client.

Port of ``ceph_tpu/rgw/client.py``; runs unchanged over the
port's librados.
"""

from __future__ import annotations

import asyncio
import hashlib
import time
import urllib.parse
from xml.etree import ElementTree as ET

from .gateway import sigv4_signature


class S3Error(Exception):
    def __init__(self, status: int, code: str, body: bytes) -> None:
        super().__init__(f"{status} {code}")
        self.status = status
        self.code = code
        self.body = body


class S3Client:
    def __init__(self, addr: tuple[str, int], access_key: str,
                 secret: str, region: str = "default") -> None:
        self.addr = tuple(addr)
        self.access_key = access_key
        self.secret = secret
        self.region = region

    async def request(self, method: str, path: str,
                      query: dict | None = None, body: bytes = b"",
                      headers: dict | None = None,
                      sign_payload: bool = True):
        query = dict(query or {})
        headers = {k.lower(): v for k, v in (headers or {}).items()}
        now = time.gmtime()
        amz_date = time.strftime("%Y%m%dT%H%M%SZ", now)
        date_stamp = time.strftime("%Y%m%d", now)
        payload_hash = (hashlib.sha256(body).hexdigest()
                        if sign_payload else "UNSIGNED-PAYLOAD")
        headers.update({
            "host": f"{self.addr[0]}:{self.addr[1]}",
            "x-amz-date": amz_date,
            "x-amz-content-sha256": payload_hash,
            "content-length": str(len(body)),
        })
        signed = ";".join(sorted(
            h for h in headers
            if h in ("host", "content-type") or h.startswith("x-amz-")))
        canonical_query = "&".join(
            f"{urllib.parse.quote(k, safe='-_.~')}="
            f"{urllib.parse.quote(v, safe='-_.~')}"
            for k, v in sorted(query.items()))
        canonical_headers = "".join(
            f"{h}:{' '.join(headers[h].split())}\n"
            for h in signed.split(";"))
        canonical = "\n".join([
            method, urllib.parse.quote(path, safe="/-_.~"),
            canonical_query, canonical_headers, signed, payload_hash])
        scope = f"{date_stamp}/{self.region}/s3/aws4_request"
        sts = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                         hashlib.sha256(canonical.encode()).hexdigest()])
        sig = sigv4_signature(self.secret, date_stamp, self.region,
                              "s3", sts)
        headers["authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={signed}, Signature={sig}")

        qs = ("?" + urllib.parse.urlencode(query)) if query else ""
        reader, writer = await asyncio.open_connection(*self.addr)
        try:
            lines = [f"{method} {urllib.parse.quote(path, safe='/-_.~')}"
                     f"{qs} HTTP/1.1"]
            lines += [f"{k}: {v}" for k, v in headers.items()]
            writer.write(("\r\n".join(lines) + "\r\n\r\n").encode())
            writer.write(body)
            await writer.drain()
            status_line = await reader.readline()
            status = int(status_line.split()[1])
            rhead: dict[str, str] = {}
            while True:
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
                k, _, v = h.decode().partition(":")
                rhead[k.strip().lower()] = v.strip()
            n = int(rhead.get("content-length", "0") or "0")
            rbody = await reader.readexactly(n) if n and method != "HEAD" \
                else b""
            if status >= 400:
                code = ""
                try:
                    code = ET.fromstring(rbody).findtext("Code") or ""
                except ET.ParseError:
                    pass
                raise S3Error(status, code, rbody)
            return status, rhead, rbody
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    # -- convenience wrappers -----------------------------------------------
    async def create_bucket(self, bucket: str) -> None:
        await self.request("PUT", f"/{bucket}")

    async def delete_bucket(self, bucket: str) -> None:
        await self.request("DELETE", f"/{bucket}")

    async def list_buckets(self) -> list[str]:
        _, _, body = await self.request("GET", "/")
        root = ET.fromstring(body)
        ns = {"s3": root.tag[1:].partition("}")[0]}
        return [e.text for e in root.findall(
            ".//s3:Bucket/s3:Name", ns)]

    async def put_object(self, bucket: str, key: str, data: bytes,
                         **kw) -> str:
        _, h, _ = await self.request("PUT", f"/{bucket}/{key}",
                                     body=data, **kw)
        return h.get("etag", "").strip('"')

    async def get_object(self, bucket: str, key: str,
                         range_: str | None = None) -> bytes:
        headers = {"range": range_} if range_ else None
        _, _, body = await self.request("GET", f"/{bucket}/{key}",
                                        headers=headers)
        return body

    async def head_object(self, bucket: str, key: str) -> dict:
        _, h, _ = await self.request("HEAD", f"/{bucket}/{key}")
        return h

    async def delete_object(self, bucket: str, key: str,
                            version_id: str | None = None) -> dict:
        q = {"versionId": version_id} if version_id else None
        _, h, _ = await self.request("DELETE", f"/{bucket}/{key}",
                                     query=q)
        return {"delete_marker": h.get("x-amz-delete-marker") == "true",
                "version_id": h.get("x-amz-version-id")}

    # -- versioning ----------------------------------------------------------
    async def put_bucket_versioning(self, bucket: str,
                                    status: str) -> None:
        body = (f'<VersioningConfiguration>'
                f"<Status>{status}</Status>"
                f"</VersioningConfiguration>").encode()
        await self.request("PUT", f"/{bucket}",
                           query={"versioning": ""}, body=body)

    async def get_bucket_versioning(self, bucket: str) -> str:
        _, _, body = await self.request("GET", f"/{bucket}",
                                        query={"versioning": ""})
        root = ET.fromstring(body)
        ns = root.tag.partition("}")[0] + "}" \
            if root.tag.startswith("{") else ""
        return root.findtext(f"{ns}Status") or ""

    async def get_object_version(self, bucket: str, key: str,
                                 version_id: str) -> bytes:
        _, _, body = await self.request(
            "GET", f"/{bucket}/{key}", query={"versionId": version_id})
        return body

    async def list_object_versions(self, bucket: str,
                                   prefix: str = "") -> list[dict]:
        _, _, body = await self.request(
            "GET", f"/{bucket}", query={"versions": "",
                                        "prefix": prefix})
        root = ET.fromstring(body)
        ns = root.tag.partition("}")[0] + "}" \
            if root.tag.startswith("{") else ""
        out = []
        for tag, marker in (("Version", False), ("DeleteMarker", True)):
            for v in root.findall(f"{ns}{tag}"):
                out.append({
                    "key": v.findtext(f"{ns}Key"),
                    "version_id": v.findtext(f"{ns}VersionId"),
                    "is_latest": v.findtext(f"{ns}IsLatest") == "true",
                    "delete_marker": marker,
                    "size": int(v.findtext(f"{ns}Size") or 0)})
        out.sort(key=lambda r: (r["key"], r["version_id"] or ""))
        return out

    # -- lifecycle -----------------------------------------------------------
    async def put_bucket_lifecycle(self, bucket: str,
                                   rules_xml: bytes) -> None:
        await self.request("PUT", f"/{bucket}",
                           query={"lifecycle": ""}, body=rules_xml)

    async def get_bucket_lifecycle(self, bucket: str) -> bytes:
        _, _, body = await self.request("GET", f"/{bucket}",
                                        query={"lifecycle": ""})
        return body

    async def delete_bucket_lifecycle(self, bucket: str) -> None:
        await self.request("DELETE", f"/{bucket}",
                           query={"lifecycle": ""})

    async def copy_object(self, src_bucket: str, src_key: str,
                          bucket: str, key: str) -> None:
        await self.request(
            "PUT", f"/{bucket}/{key}",
            headers={"x-amz-copy-source": f"/{src_bucket}/{src_key}"})

    async def list_objects(self, bucket: str, prefix: str = "",
                           delimiter: str = "",
                           max_keys: int = 1000,
                           continuation: str = "") -> dict:
        q = {"list-type": "2", "max-keys": str(max_keys)}
        if prefix:
            q["prefix"] = prefix
        if delimiter:
            q["delimiter"] = delimiter
        if continuation:
            q["continuation-token"] = continuation
        _, _, body = await self.request("GET", f"/{bucket}", query=q)
        root = ET.fromstring(body)
        ns = {"s3": root.tag[1:].partition("}")[0]}
        return {
            "keys": [e.text for e in root.findall(
                ".//s3:Contents/s3:Key", ns)],
            "prefixes": [e.text for e in root.findall(
                ".//s3:CommonPrefixes/s3:Prefix", ns)],
            "truncated": root.findtext("s3:IsTruncated", "false",
                                       ns) == "true",
            "next": root.findtext("s3:NextContinuationToken", "", ns),
        }

    # -- multipart ----------------------------------------------------------
    async def initiate_multipart(self, bucket: str, key: str) -> str:
        _, _, body = await self.request("POST", f"/{bucket}/{key}",
                                        query={"uploads": ""})
        root = ET.fromstring(body)
        ns = {"s3": root.tag[1:].partition("}")[0]}
        return root.findtext("s3:UploadId", "", ns)

    async def upload_part(self, bucket: str, key: str, upload_id: str,
                          part: int, data: bytes) -> str:
        _, h, _ = await self.request(
            "PUT", f"/{bucket}/{key}",
            query={"partNumber": str(part), "uploadId": upload_id},
            body=data)
        return h.get("etag", "").strip('"')

    async def complete_multipart(self, bucket: str, key: str,
                                 upload_id: str,
                                 parts: list[int]) -> str:
        xml = ("<CompleteMultipartUpload>"
               + "".join(f"<Part><PartNumber>{n}</PartNumber></Part>"
                         for n in parts)
               + "</CompleteMultipartUpload>").encode()
        _, _, body = await self.request(
            "POST", f"/{bucket}/{key}", query={"uploadId": upload_id},
            body=xml)
        root = ET.fromstring(body)
        ns = {"s3": root.tag[1:].partition("}")[0]}
        return (root.findtext("s3:ETag", "", ns) or "").strip('"')

    async def abort_multipart(self, bucket: str, key: str,
                              upload_id: str) -> None:
        await self.request("DELETE", f"/{bucket}/{key}",
                           query={"uploadId": upload_id})
