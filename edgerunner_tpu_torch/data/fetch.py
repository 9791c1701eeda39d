"""Fetchers of remote data, routed by URL scheme (edgerunner_tpu/data/fetch.py).

The reference streams its training data from S3 buckets through megfile
(reference: core/provider.py:162, 248-249). Here, with no dependency beyond
the standard library:

  * local paths             read directly (the default)
  * http:// and https://    urllib, each object cached on disk once
                            (presigned or HTTP-fronted buckets go this way)
  * s3://                   the SigV4 or anonymous GET of data/s3.py
  * other schemes           register_fetcher("scheme", fn)

`fetch_to_local(path)` returns a local path either way, which the file
parsers of mesh_io read. The cache lies under `EDGERUNNER_FETCH_CACHE`,
by default the repository's `.cache/fetch`.
"""

from __future__ import annotations

import hashlib
import os
import threading
import urllib.parse
import urllib.request
from typing import Callable, Dict

# scheme -> fetch(url) -> bytes
_FETCHERS: Dict[str, Callable[[str], bytes]] = {}
_CACHE_LOCK = threading.Lock()


def register_fetcher(scheme: str, fn: Callable[[str], bytes]) -> None:
    """Fetch URLs of `scheme` (e.g. 's3') with fn(url) -> bytes; replaces
    the fetcher the scheme had."""
    _FETCHERS[scheme.lower()] = fn


def _http_fetch(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read()


def _s3_fetch(url: str) -> bytes:
    from edgerunner_tpu_torch.data.s3 import s3_fetch

    return s3_fetch(url)


register_fetcher("http", _http_fetch)
register_fetcher("https", _http_fetch)
register_fetcher("s3", _s3_fetch)


def url_scheme(path: str) -> str:
    """The URL scheme of `path`; '' for a local path (a Windows drive
    letter included)."""
    scheme = urllib.parse.urlparse(path).scheme.lower()
    return scheme if len(scheme) > 1 else ""


def is_remote(path: str) -> bool:
    return url_scheme(path) in _FETCHERS


def fetch_bytes(path: str) -> bytes:
    scheme = url_scheme(path)
    if scheme in _FETCHERS:
        return _FETCHERS[scheme](path)
    with open(path, "rb") as f:
        return f.read()


def cache_dir() -> str:
    d = os.environ.get(
        "EDGERUNNER_FETCH_CACHE",
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".cache", "fetch"))
    os.makedirs(d, exist_ok=True)
    return d


def fetch_to_local(path: str) -> str:
    """A local path for `path`: itself when local, else the cached copy of
    the object, fetched on first use."""
    if not is_remote(path):
        return path
    ext = os.path.splitext(urllib.parse.urlparse(path).path)[1]
    name = hashlib.sha256(path.encode()).hexdigest()[:24] + ext
    local = os.path.join(cache_dir(), name)
    if os.path.exists(local):
        return local
    data = fetch_bytes(path)
    with _CACHE_LOCK:
        if not os.path.exists(local):
            tmp = local + f".tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, local)
    return local
