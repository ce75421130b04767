"""Blob distribution: content-addressed artifact store + runner cache
(the JAX package's ``runtime/blob.py``; a digest, a store directory and
a cache directory of either package serve the other).

ref: runtime/blob/{BlobServer,BlobCacheService,BlobKey}.java — the
channel that ships job JARs and large payloads from the client to the
master and on to every worker. Here the artifact is Python job code
(the ``--py-file`` of a submission): the client PUTs it at the
coordinator, the submission references it by sha256 digest, and each
runner GETs-and-caches it before importing the job's entry point.
Content addressing makes the cache trivially coherent (a digest never
changes meaning) and re-uploads idempotent — the BlobKey role.

Transport rides the existing length-prefixed JSON RPC (base64 payload).
Fine for job-code-sized artifacts; a bulk side channel would slot in
behind the same digest contract.
"""
from __future__ import annotations

import base64
import hashlib
import os
import tempfile
from typing import List, Optional

__all__ = ["BlobStore", "BlobCache", "digest_of"]


def digest_of(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


class BlobStore:
    """Server-side store: one file per digest, atomic durable writes
    through the FileSystem seam (ref: BlobServer's storage layout —
    a job's code artifact must survive a power cut once the submission
    referencing its digest was acked)."""

    def __init__(self, directory: Optional[str] = None) -> None:
        from flink_tpu_torch.fs import get_filesystem

        self.dir = directory or tempfile.mkdtemp(prefix="flink_tpu_blobs_")
        self._fs = get_filesystem(self.dir)
        self._fs.mkdirs(self.dir)

    def _path(self, digest: str) -> str:
        if not digest.isalnum():
            raise ValueError(f"bad digest {digest!r}")
        return os.path.join(self.dir, digest)

    def put(self, data: bytes) -> str:
        from flink_tpu_torch.fs import write_atomic

        digest = digest_of(data)
        path = self._path(digest)
        if not self._fs.exists(path):
            write_atomic(self._fs, path, data)
        return digest

    def get(self, digest: str) -> Optional[bytes]:
        try:
            with self._fs.open_read(self._path(digest)) as f:
                data = f.read()
            return data if isinstance(data, bytes) else data.encode()
        except OSError:
            return None

    def has(self, digest: str) -> bool:
        return self._fs.exists(self._path(digest))

    def list(self) -> List[str]:
        return sorted(d for d in self._fs.listdir(self.dir)
                      if not d.endswith(".tmp"))


class BlobCache:
    """Runner-side cache: resolve a digest to a local file, fetching
    from the coordinator on miss (ref: BlobCacheService). Verifies the
    digest of fetched bytes — a corrupt transfer must not get cached."""

    def __init__(self, coord_client, cache_dir: Optional[str] = None) -> None:
        from flink_tpu_torch.fs import get_filesystem

        self._coord = coord_client
        self.dir = cache_dir or tempfile.mkdtemp(prefix="flink_tpu_blobcache_")
        self._fs = get_filesystem(self.dir)
        self._fs.mkdirs(self.dir)

    def rebind(self, coord_client) -> None:
        """Point the cache at a new coordinator (leader failover) —
        cached digests stay valid, only the fetch channel moves."""
        self._coord = coord_client

    def fetch(self, digest: str) -> str:
        """Return a local path holding the blob's bytes (stored by
        digest — never by filename, so two versions of "job.py" cannot
        shadow each other in the cache), downloading on miss."""
        path = os.path.join(self.dir, digest)
        if os.path.exists(path):
            return path
        resp = self._coord.call("get_blob", digest=digest)
        if not resp.get("found"):
            raise FileNotFoundError(f"blob {digest} not on coordinator")
        data = base64.b64decode(resp["data_b64"])
        if digest_of(data) != digest:
            raise IOError(f"blob {digest} digest mismatch after transfer")
        # pid-unique tmp (two runners on one cache dir must not
        # interleave), atomic durable publish through the seam
        tmp = path + f".{os.getpid()}.tmp"
        from flink_tpu_torch.fs import open_write_sync

        with open_write_sync(self._fs, tmp, sync=True) as f:
            f.write(data)
        self._fs.rename(tmp, path)
        return path

    def materialize(self, digest: str, directory: str, name: str) -> str:
        """Place the blob under ``directory/name`` (hardlink when
        possible) — the per-job import dir (ref: per-job classloader
        isolation: each job attempt stages its own view of the code)."""
        self._fs.mkdirs(directory)
        src = self.fetch(digest)
        dst = os.path.join(directory, name)
        if self._fs.exists(dst):
            self._fs.delete(dst)
        self._fs.link_or_copy(src, dst)
        return dst
