"""Object-store FileSystem drivers: s3:// (SigV4 REST) and gs:// (JSON API).

The analogue of the reference's flink-filesystems plugin family
(flink-s3-fs-hadoop/presto, flink-gs-fs-hadoop, flink-azure-fs-hadoop...):
cloud object stores behind the same scheme-routed `FileSystem` SPI that
checkpoint storage, savepoints, file sources/sinks and HA stores consume.
No vendor SDK dependency: S3 speaks the REST API with AWS Signature V4
computed from stdlib hmac/hashlib; GCS speaks the JSON/upload API with a
bearer-token provider. Both route requests through an injectable
`transport(method, url, headers, body) -> (status, headers, body)`, so the
drivers run against real endpoints (default urllib transport), S3-compatible
stores (MinIO/GCS-interop via `endpoint`), and the in-process fakes the
tests use.

Checkpoint-storage semantics: `write` is an atomic full-object PUT — object
stores give atomic replace for free, which is exactly the property the
FsCheckpointStorage rename protocol emulates on POSIX.

Counterpart of `flink_tpu/fs/object_store.py`, copied: the same requests
and SigV4 signatures byte for byte, registered in the port's FileSystem
registry (`flink_tpu_torch/core/fs.py`).
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

from flink_tpu_torch.core.fs import FileSystem, register_file_system

Transport = Callable[[str, str, Dict[str, str], Optional[bytes]],
                     Tuple[int, Dict[str, str], bytes]]


def urllib_transport(method: str, url: str, headers: Dict[str, str],
                     body: Optional[bytes]):
    req = urllib.request.Request(url, data=body, method=method)
    for k, v in headers.items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _split(path: str) -> Tuple[str, str]:
    u = urllib.parse.urlparse(path)
    return u.netloc, u.path.lstrip("/")


class S3FileSystem(FileSystem):
    """s3:// driver speaking the S3 REST API with AWS Signature V4."""

    scheme = "s3"

    def __init__(self, access_key: str, secret_key: str,
                 region: str = "us-east-1",
                 endpoint: Optional[str] = None,
                 transport: Transport = urllib_transport,
                 clock=None):
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.endpoint = (endpoint or "https://s3.{region}.amazonaws.com").format(
            region=region)
        self.transport = transport
        self.clock = clock or (
            lambda: datetime.datetime.now(datetime.timezone.utc))

    # -- SigV4 ------------------------------------------------------------
    def _sign(self, method: str, bucket: str, key: str,
              query: Dict[str, str], body: bytes) -> Tuple[str, Dict[str, str]]:
        now = self.clock()
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        host = urllib.parse.urlparse(self.endpoint).netloc
        payload_hash = hashlib.sha256(body or b"").hexdigest()
        canonical_uri = "/" + urllib.parse.quote(f"{bucket}/{key}" if key else bucket)
        canonical_query = "&".join(
            f"{urllib.parse.quote(k, safe='')}={urllib.parse.quote(v, safe='')}"
            for k, v in sorted(query.items())
        )
        headers = {
            "host": host,
            "x-amz-content-sha256": payload_hash,
            "x-amz-date": amz_date,
        }
        signed = ";".join(sorted(headers))
        canonical_headers = "".join(f"{k}:{headers[k]}\n" for k in sorted(headers))
        canonical_request = "\n".join([
            method, canonical_uri, canonical_query, canonical_headers,
            signed, payload_hash,
        ])
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        to_sign = "\n".join([
            "AWS4-HMAC-SHA256", amz_date, scope,
            hashlib.sha256(canonical_request.encode()).hexdigest(),
        ])

        def h(key: bytes, msg: str) -> bytes:
            return hmac.new(key, msg.encode(), hashlib.sha256).digest()

        k = h(h(h(h(b"AWS4" + self.secret_key.encode(), datestamp),
                  self.region), "s3"), "aws4_request")
        sig = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
        headers["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={signed}, Signature={sig}"
        )
        url = self.endpoint + canonical_uri
        if canonical_query:
            url += "?" + canonical_query
        return url, headers

    def _req(self, method: str, bucket: str, key: str,
             query: Optional[Dict[str, str]] = None,
             body: Optional[bytes] = None) -> Tuple[int, Dict[str, str], bytes]:
        url, headers = self._sign(method, bucket, key, query or {}, body or b"")
        return self.transport(method, url, headers, body)

    # -- FileSystem SPI ---------------------------------------------------
    def read(self, path: str) -> bytes:
        bucket, key = _split(path)
        status, _h, body = self._req("GET", bucket, key)
        if status == 404:
            raise FileNotFoundError(path)
        if status != 200:
            raise OSError(f"s3 GET {path}: HTTP {status}: {body[:200]!r}")
        return body

    def write(self, path: str, data: bytes) -> None:
        bucket, key = _split(path)
        status, _h, body = self._req("PUT", bucket, key, body=data)
        if status not in (200, 201):
            raise OSError(f"s3 PUT {path}: HTTP {status}: {body[:200]!r}")

    def exists(self, path: str) -> bool:
        bucket, key = _split(path)
        status, _h, _b = self._req("HEAD", bucket, key)
        if status == 200:
            return True
        # a "directory" exists if any object lives under the prefix
        return bool(self._list_keys(bucket, key.rstrip("/") + "/", max_keys=1))

    page_size = 1000

    def _list_keys(self, bucket: str, prefix: str,
                   max_keys: Optional[int] = None) -> List[str]:
        import re

        keys: List[str] = []
        token: Optional[str] = None
        while True:
            query = {"list-type": "2", "prefix": prefix,
                     "max-keys": str(self.page_size)}
            if token:
                query["continuation-token"] = token
            status, _h, body = self._req("GET", bucket, "", query=query)
            if status != 200:
                raise OSError(f"s3 LIST {bucket}/{prefix}: HTTP {status}")
            text = body.decode()
            keys.extend(re.findall(r"<Key>([^<]+)</Key>", text))
            if max_keys is not None and len(keys) >= max_keys:
                return keys[:max_keys]
            m = re.search(r"<NextContinuationToken>([^<]+)"
                          r"</NextContinuationToken>", text)
            if not m:
                return keys
            token = m.group(1)

    def list(self, path: str) -> List[str]:
        bucket, key = _split(path)
        prefix = key.rstrip("/") + "/" if key else ""
        return sorted(
            f"s3://{bucket}/{k}" for k in self._list_keys(bucket, prefix)
        )

    def delete(self, path: str, recursive: bool = False) -> None:
        bucket, key = _split(path)
        keys = [key]
        if recursive:
            keys += self._list_keys(bucket, key.rstrip("/") + "/")
        for k in keys:
            status, _h, body = self._req("DELETE", bucket, k)
            if status not in (200, 204, 404):
                raise OSError(f"s3 DELETE {bucket}/{k}: HTTP {status}")

    def mkdirs(self, path: str) -> None:
        pass  # object stores have no directories


class GcsFileSystem(FileSystem):
    """gs:// driver over the GCS JSON API with a bearer-token provider."""

    scheme = "gs"

    def __init__(self, token_provider: Callable[[], str],
                 endpoint: str = "https://storage.googleapis.com",
                 transport: Transport = urllib_transport):
        self.token = token_provider
        self.endpoint = endpoint.rstrip("/")
        self.transport = transport

    def _headers(self) -> Dict[str, str]:
        return {"Authorization": f"Bearer {self.token()}"}

    def read(self, path: str) -> bytes:
        bucket, key = _split(path)
        url = (f"{self.endpoint}/storage/v1/b/{bucket}/o/"
               f"{urllib.parse.quote(key, safe='')}?alt=media")
        status, _h, body = self.transport("GET", url, self._headers(), None)
        if status == 404:
            raise FileNotFoundError(path)
        if status != 200:
            raise OSError(f"gcs GET {path}: HTTP {status}: {body[:200]!r}")
        return body

    def write(self, path: str, data: bytes) -> None:
        bucket, key = _split(path)
        url = (f"{self.endpoint}/upload/storage/v1/b/{bucket}/o"
               f"?uploadType=media&name={urllib.parse.quote(key, safe='')}")
        headers = {**self._headers(),
                   "Content-Type": "application/octet-stream"}
        status, _h, body = self.transport("POST", url, headers, data)
        if status not in (200, 201):
            raise OSError(f"gcs PUT {path}: HTTP {status}: {body[:200]!r}")

    def exists(self, path: str) -> bool:
        bucket, key = _split(path)
        url = (f"{self.endpoint}/storage/v1/b/{bucket}/o/"
               f"{urllib.parse.quote(key, safe='')}")
        status, _h, _b = self.transport("GET", url, self._headers(), None)
        if status == 200:
            return True
        return bool(self._list_keys(bucket, key.rstrip("/") + "/", max_results=1))

    page_size = 1000

    def _list_keys(self, bucket: str, prefix: str,
                   max_results: Optional[int] = None) -> List[str]:
        keys: List[str] = []
        token: Optional[str] = None
        while True:
            url = (f"{self.endpoint}/storage/v1/b/{bucket}/o"
                   f"?prefix={urllib.parse.quote(prefix, safe='')}"
                   f"&maxResults={self.page_size}")
            if token:
                url += f"&pageToken={urllib.parse.quote(token, safe='')}"
            status, _h, body = self.transport("GET", url, self._headers(), None)
            if status != 200:
                raise OSError(f"gcs LIST {bucket}/{prefix}: HTTP {status}")
            doc = json.loads(body or b"{}")
            keys.extend(o["name"] for o in doc.get("items", []))
            if max_results is not None and len(keys) >= max_results:
                return keys[:max_results]
            token = doc.get("nextPageToken")
            if not token:
                return keys

    def list(self, path: str) -> List[str]:
        bucket, key = _split(path)
        prefix = key.rstrip("/") + "/" if key else ""
        return sorted(
            f"gs://{bucket}/{k}" for k in self._list_keys(bucket, prefix)
        )

    def delete(self, path: str, recursive: bool = False) -> None:
        bucket, key = _split(path)
        keys = [key]
        if recursive:
            keys += self._list_keys(bucket, key.rstrip("/") + "/")
        for k in keys:
            url = (f"{self.endpoint}/storage/v1/b/{bucket}/o/"
                   f"{urllib.parse.quote(k, safe='')}")
            status, _h, _b = self.transport("DELETE", url, self._headers(), None)
            if status not in (200, 204, 404):
                raise OSError(f"gcs DELETE {bucket}/{k}: HTTP {status}")

    def mkdirs(self, path: str) -> None:
        pass


def register_s3(access_key: str, secret_key: str, *, region: str = "us-east-1",
                endpoint: Optional[str] = None,
                transport: Transport = urllib_transport) -> S3FileSystem:
    fs = S3FileSystem(access_key, secret_key, region=region,
                      endpoint=endpoint, transport=transport)
    register_file_system("s3", fs)
    return fs


def register_gcs(token_provider: Callable[[], str], *,
                 endpoint: str = "https://storage.googleapis.com",
                 transport: Transport = urllib_transport) -> GcsFileSystem:
    fs = GcsFileSystem(token_provider, endpoint=endpoint, transport=transport)
    register_file_system("gs", fs)
    return fs
