"""Checkpoint and vocabulary path resolution with a download cache (copy of
`xggm_tpu/utils/file_cache.py`, the same cache layout and keys, so both
packages share one cache directory).

The key is sha256(url)[.sha256(etag)], each entry with a `.json` sidecar of
its url and etag:

- http/https URLs: HEAD for the ETag, then stream the body to a temporary
  file and move it into the cache (urllib);
- s3:// URLs: through boto3 when it imports, otherwise cache-only;
- without network: a staged entry (`cache_put`, keyed by the url alone) is
  served instead; only when that misses too does the call raise, naming
  the key to stage.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tarfile
import tempfile
from typing import Optional
from urllib.parse import urlparse

DEFAULT_CACHE = os.path.expanduser(
    os.environ.get("XGGM_CACHE", "~/.cache/xggm_tpu"))


def url_to_filename(url: str, etag: Optional[str] = None) -> str:
    """sha256 cache key (same scheme as the reference, file_utils.py:45-58)."""
    key = hashlib.sha256(url.encode("utf-8")).hexdigest()
    if etag:
        key += "." + hashlib.sha256(etag.encode("utf-8")).hexdigest()
    return key


def cache_put(src_path: str, url: str,
              cache_dir: str = DEFAULT_CACHE) -> str:
    """Register a locally-obtained file under its url's (etag-less) cache
    key - the out-of-band staging path for zero-egress pods."""
    os.makedirs(cache_dir, exist_ok=True)
    fname = url_to_filename(url)
    dst = os.path.join(cache_dir, fname)
    shutil.copyfile(src_path, dst)
    with open(dst + ".json", "w") as f:
        json.dump({"url": url, "etag": None}, f)
    return dst


def _http_etag(url: str, timeout: float) -> Optional[str]:
    """HEAD request for the ETag (reference file_utils.py:189-194; non-200
    raises OSError like the reference's IOError)."""
    import urllib.request

    req = urllib.request.Request(url, method="HEAD")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if resp.status != 200:
            raise OSError(f"HEAD request failed for url {url} "
                          f"with status code {resp.status}")
        return resp.headers.get("ETag")


def _http_get(url: str, fileobj, timeout: float) -> None:
    """Stream the body to fileobj (reference http_get, chunked)."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        shutil.copyfileobj(resp, fileobj, length=1024 * 1024)


def _s3_etag_and_get(url: str):
    """(etag, download_fn) for an s3 URL via boto3, or None if boto3 is
    unavailable (the airgapped image has no boto3; reference
    file_utils.py:133-177)."""
    try:
        import boto3  # noqa: F401
    except ImportError:
        return None
    import boto3

    parsed = urlparse(url)
    bucket, path = parsed.netloc, parsed.path.lstrip("/")
    if not bucket or not path:
        raise ValueError(f"bad s3 path {url}")
    resource = boto3.resource("s3")
    obj = resource.Object(bucket, path)
    return obj.e_tag, lambda f: resource.Bucket(bucket).download_fileobj(
        path, f)


def get_from_cache(url: str, cache_dir: str = DEFAULT_CACHE,
                   timeout: float = 10.0) -> str:
    """Download url into the cache (keyed by url+etag) unless already
    present; on any network failure fall back to a pre-staged etag-less
    entry (reference get_from_cache, file_utils.py:180-232)."""
    os.makedirs(cache_dir, exist_ok=True)
    try:
        if url.startswith("s3://"):
            got = _s3_etag_and_get(url)
            if got is None:
                raise OSError("boto3 unavailable in this environment")
            etag, download = got
        else:
            etag = _http_etag(url, timeout)
            download = lambda f: _http_get(url, f, timeout)  # noqa: E731
    except (OSError, ValueError):
        # no egress / unreachable: serve the staged etag-less entry
        staged = os.path.join(cache_dir, url_to_filename(url))
        if os.path.exists(staged):
            return staged
        raise FileNotFoundError(
            f"remote resource {url!r} is unreachable and not in the local "
            f"cache ({staged}); on zero-egress pods stage the file with "
            f"xggm_tpu_torch.utils.file_cache.cache_put(local_path, url)")

    cache_path = os.path.join(cache_dir, url_to_filename(url, etag))
    if not os.path.exists(cache_path):
        # download to a temp file first so an interrupted transfer never
        # leaves a corrupt cache entry (same protocol as the reference)
        fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".download")
        try:
            with os.fdopen(fd, "wb") as f:
                download(f)
            os.replace(tmp, cache_path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        with open(cache_path + ".json", "w", encoding="utf-8") as f:
            json.dump({"url": url, "etag": etag}, f)
    return cache_path


def cached_path(url_or_filename: str,
                cache_dir: str = DEFAULT_CACHE) -> str:
    """Resolve a local path / file:// URL / remote URL to a local file,
    downloading remote URLs into the cache when the network allows
    (reference cached_path, file_utils.py:81-110)."""
    parsed = urlparse(url_or_filename)
    if parsed.scheme in ("http", "https", "s3"):
        return get_from_cache(url_or_filename, cache_dir)
    if os.path.exists(url_or_filename):
        return url_or_filename
    if parsed.scheme == "file":
        if os.path.exists(parsed.path):
            return parsed.path
        raise FileNotFoundError(parsed.path)
    raise FileNotFoundError(
        f"{url_or_filename!r} is neither a local path nor a cached URL")


def extract_archive(path: str, dest: Optional[str] = None) -> str:
    """Untar a pretrained-weights archive (the reference untars HF BERT
    archives on load, modeling.py:806-820)."""
    dest = dest or path + ".extracted"
    if not os.path.isdir(dest):
        os.makedirs(dest, exist_ok=True)
        with tarfile.open(path) as t:
            t.extractall(dest, filter="data")
    return dest
