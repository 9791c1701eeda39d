"""The `s3://` fetcher of the port, on the standard library alone
(edgerunner_tpu/data/s3.py).

The reference streams datasets from S3 through megfile (reference:
core/provider.py:162, 248-249). This module gives data/fetch.py the same:

  * anonymous GETs of public buckets (no credentials in the environment)
  * AWS Signature V4 signed GETs when `AWS_ACCESS_KEY_ID` and
    `AWS_SECRET_ACCESS_KEY` (and optionally `AWS_SESSION_TOKEN`) are set
  * another endpoint from `EDGERUNNER_S3_ENDPOINT`, `AWS_ENDPOINT_URL_S3`,
    `AWS_ENDPOINT_URL` or `S3_ENDPOINT_URL` (MinIO, localstack, a test
    fake), addressed path-style; AWS itself virtual-host style
  * the region from `AWS_REGION` or `AWS_DEFAULT_REGION` (us-east-1 by
    default)

data/fetch.py registers the scheme, so `MeshFolderDataset` reads a
`s3://bucket/prefix` root: its manifest and each mesh object go through
`fetch_bytes` and `fetch_to_local` as http(s) sources do. A
`register_fetcher("s3", ...)` of the user's replaces it.

The signer follows AWS's "Signature Version 4 signing process" for the
subset a read-only loader needs: a GET with no body and no other signed
headers.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import os
import urllib.parse
import urllib.request
from typing import Optional

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


def _env(*names: str, default: Optional[str] = None) -> Optional[str]:
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return default


def parse_s3_url(url: str) -> tuple:
    """s3://bucket/key/with/slashes -> (bucket, key)."""
    p = urllib.parse.urlparse(url)
    if p.scheme.lower() != "s3" or not p.netloc:
        raise ValueError(f"not an s3 URL: {url!r}")
    return p.netloc, p.path.lstrip("/")


def _endpoint_for(bucket: str, region: str) -> tuple:
    """(base URL, host header, path-style addressing)."""
    custom = _env("EDGERUNNER_S3_ENDPOINT", "AWS_ENDPOINT_URL_S3",
                  "AWS_ENDPOINT_URL", "S3_ENDPOINT_URL")
    if custom:
        p = urllib.parse.urlparse(custom)
        if p.scheme not in ("http", "https") or not p.netloc:
            raise ValueError(f"an S3 endpoint is an http(s) URL, got {custom!r}")
        return custom.rstrip("/"), p.netloc, True
    host = f"{bucket}.s3.{region}.amazonaws.com"
    return f"https://{host}", host, False


def _sign_key(secret: str, date: str, region: str, service: str) -> bytes:
    k = hmac.new(("AWS4" + secret).encode(), date.encode(), hashlib.sha256).digest()
    for part in (region, service, "aws4_request"):
        k = hmac.new(k, part.encode(), hashlib.sha256).digest()
    return k


def _sigv4_headers(host: str, canonical_uri: str, region: str,
                   access_key: str, secret_key: str,
                   session_token: Optional[str],
                   now: Optional[datetime.datetime] = None,
                   extra_headers: Optional[dict] = None) -> dict:
    """The Authorization and x-amz-* headers of a GET without a body
    (SigV4). `extra_headers` (lowercase names) join the signed set, as
    AWS's published GetObject example signs a Range header."""
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    date = now.strftime("%Y%m%d")

    headers = {"host": host, "x-amz-content-sha256": _EMPTY_SHA256,
               "x-amz-date": amz_date, **(extra_headers or {})}
    if session_token:
        headers["x-amz-security-token"] = session_token
    signed = ";".join(sorted(headers))
    canonical = "\n".join(
        ["GET", canonical_uri, "",  # GetObject has no query string
         *(f"{k}:{headers[k]}" for k in sorted(headers)), "",
         signed, _EMPTY_SHA256])
    scope = f"{date}/{region}/s3/aws4_request"
    to_sign = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                         hashlib.sha256(canonical.encode()).hexdigest()])
    sig = hmac.new(_sign_key(secret_key, date, region, "s3"),
                   to_sign.encode(), hashlib.sha256).hexdigest()
    out = {k: v for k, v in headers.items() if k != "host"}
    out["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed}, Signature={sig}")
    return out


def s3_fetch(url: str, timeout: float = 60.0) -> bytes:
    """GET the object of s3://bucket/key: the 's3' fetcher of fetch_bytes."""
    bucket, key = parse_s3_url(url)
    region = _env("AWS_REGION", "AWS_DEFAULT_REGION", default="us-east-1")
    base, host, path_style = _endpoint_for(bucket, region)

    quoted_key = urllib.parse.quote(key, safe="/~")
    if path_style:
        canonical_uri = f"/{bucket}/{quoted_key}"
        target = f"{base}/{bucket}/{quoted_key}"
    else:
        canonical_uri = f"/{quoted_key}"
        target = f"{base}/{quoted_key}"

    req = urllib.request.Request(target)
    access = os.environ.get("AWS_ACCESS_KEY_ID")
    secret = os.environ.get("AWS_SECRET_ACCESS_KEY")
    if access and secret:
        for k, v in _sigv4_headers(host, canonical_uri, region, access, secret,
                                   os.environ.get("AWS_SESSION_TOKEN")).items():
            req.add_header(k, v)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()
