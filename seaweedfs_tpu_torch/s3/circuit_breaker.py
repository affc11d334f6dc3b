"""Per-action concurrency/size circuit breaker for the S3 gateway.

Reference: weed/s3api/s3api_circuit_breaker.go — limits simultaneous
requests and in-flight upload bytes, globally and per bucket, returning
503 SlowDown when tripped.  Configured with simple limits here (the
reference reads circuit-breaker JSON from the filer).

Counterpart of `seaweedfs_tpu/s3/circuit_breaker.py`, whole."""

from __future__ import annotations

import threading


class CircuitBreaker:
    def __init__(self, global_max_requests: int = 0,
                 global_max_upload_bytes: int = 0,
                 bucket_max_requests: int = 0):
        """0 = unlimited (breaker disabled for that dimension)."""
        self.global_max_requests = global_max_requests
        self.global_max_upload_bytes = global_max_upload_bytes
        self.bucket_max_requests = bucket_max_requests
        self._lock = threading.Lock()
        self._global_requests = 0
        self._global_upload_bytes = 0
        self._bucket_requests: dict[str, int] = {}

    @property
    def enabled(self) -> bool:
        return bool(self.global_max_requests or self.global_max_upload_bytes
                    or self.bucket_max_requests)

    def acquire(self, bucket: str, upload_bytes: int = 0) -> bool:
        """True if the request may proceed; False -> caller returns 503."""
        if not self.enabled:
            return True
        with self._lock:
            if self.global_max_requests and \
                    self._global_requests >= self.global_max_requests:
                return False
            if upload_bytes and self.global_max_upload_bytes and \
                    self._global_upload_bytes + upload_bytes > \
                    self.global_max_upload_bytes:
                return False
            if bucket and self.bucket_max_requests and \
                    self._bucket_requests.get(bucket, 0) >= \
                    self.bucket_max_requests:
                return False
            self._global_requests += 1
            self._global_upload_bytes += upload_bytes
            if bucket:
                self._bucket_requests[bucket] = \
                    self._bucket_requests.get(bucket, 0) + 1
            return True

    def release(self, bucket: str, upload_bytes: int = 0) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._global_requests = max(0, self._global_requests - 1)
            self._global_upload_bytes = max(
                0, self._global_upload_bytes - upload_bytes)
            if bucket and bucket in self._bucket_requests:
                self._bucket_requests[bucket] -= 1
                if self._bucket_requests[bucket] <= 0:
                    del self._bucket_requests[bucket]
