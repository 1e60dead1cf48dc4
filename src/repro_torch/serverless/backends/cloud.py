"""Real-platform backends (``repro.serverless.backends.cloud`` for the port):
AWS Lambda + S3 through a boto3-shaped client, and Alibaba FC + OSS (a stub).

:class:`S3ObjectStore` speaks the boto3 S3 client surface
(``put_object``/``get_object``/``delete_object``/``list_objects_v2``)
behind the blocking-visibility API of
:class:`~repro_torch.serverless.backends.local.LocalStore`, retrying
transient S3 error codes per :class:`CloudConfig`'s
:class:`~repro_torch.serverless.retry.RetryPolicy`.
:class:`AwsS3Backend` subclasses :class:`LocalBackend`: the stage workers
run as this host's threads while every object crosses S3, as host bytes
(:func:`~repro_torch.serverless.runtime.store.to_wire`).  ``boto3`` is not
a dependency: without it (or without credentials or a bucket) ``open()``
raises :class:`BackendUnavailableError` naming what is missing.  Tests drive
the adapter through an in-memory fake client.
"""
from __future__ import annotations

import importlib.util
import os
import pickle
import threading
import time
from dataclasses import dataclass
from typing import Any, Optional, Tuple

from repro_torch.serverless.backends.base import ExecutionBackend
from repro_torch.serverless.backends.local import (
    DEFAULT_GET_TIMEOUT,
    DEFAULT_LEASE_TIMEOUT,
    LocalBackend,
)
from repro_torch.serverless.retry import RetryPolicy
from repro_torch.serverless.runtime.store import (
    StoreAbortedError,
    StoreStats,
    check_lease,
    from_wire,
    producer_worker_of_key,
    timeout_message,
    to_wire,
)


@dataclass(frozen=True)
class CloudConfig:
    """What a real cloud adapter needs.  ``credential_env`` names the
    environment variables the adapter reads (never stores), so an ``open()``
    without credentials fails naming them."""

    bucket: str = ""
    region: Optional[str] = None
    endpoint: Optional[str] = None        # OSS/S3-compatible endpoint URL
    key_prefix: str = "funcpipe/"         # namespace within the bucket
    retry: RetryPolicy = RetryPolicy()    # transient-error backoff
    connect_timeout_s: float = 5.0
    read_timeout_s: float = 60.0
    invoke_timeout_s: float = 900.0       # function-lifetime cap (Lambda: 15 min)
    credential_env: Tuple[str, ...] = ()

    def missing_credentials(self) -> Tuple[str, ...]:
        """Which of the required credential variables are unset."""
        return tuple(v for v in self.credential_env if not os.environ.get(v))


AWS_CLOUD_CONFIG = CloudConfig(
    region="us-east-1",
    credential_env=("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY"),
)

OSS_CLOUD_CONFIG = CloudConfig(
    endpoint="https://oss-cn-hangzhou.aliyuncs.com",
    credential_env=("OSS_ACCESS_KEY_ID", "OSS_ACCESS_KEY_SECRET"),
)


class BackendUnavailableError(NotImplementedError):
    """A registered backend that cannot run here (missing client library,
    credentials or bucket, or a stub).  A NotImplementedError, so generic
    callers recognize it; callers can catch this type alone."""


#: S3 error codes that mean "retry me" (throttles and 5xx)
RETRYABLE_S3_CODES = frozenset({
    "SlowDown", "InternalError", "ServiceUnavailable", "RequestTimeout",
    "ThrottlingException", "Throttling", "503", "500",
})

#: codes that mean "not there (yet)": the visibility poll keeps waiting
_MISSING_CODES = frozenset({"NoSuchKey", "404", "NotFound"})


def _s3_error_code(exc: BaseException) -> str:
    """The S3 error code of a botocore ``ClientError`` (or anything shaped
    like one), without importing botocore."""
    response = getattr(exc, "response", None)
    if isinstance(response, dict):
        return str(response.get("Error", {}).get("Code", ""))
    return ""


class S3ObjectStore:
    """Blocking-visibility object store over a boto3-shaped S3 client, with
    :class:`~repro_torch.serverless.backends.local.LocalStore`'s surface
    (put/get/take/delete/keys, heartbeats and leases, abort/revive,
    ``stats``/``live_bytes``).  ``get`` polls ``get_object`` until the key
    exists (S3 reads after writes, so one hit is authoritative).  Worker
    liveness stays in this process: the workers are its threads.  Transient
    codes are retried with ``config.retry``'s backoff and counted in
    ``retried_ops``."""

    def __init__(self, client: Any, config: CloudConfig,
                 timeout: float = DEFAULT_GET_TIMEOUT,
                 lease_timeout: float = DEFAULT_LEASE_TIMEOUT):
        if not config.bucket:
            raise ValueError(
                "S3ObjectStore needs CloudConfig.bucket (the S3 bucket "
                "objects live in)")
        self.client = client
        self.config = config
        self.bucket = config.bucket
        self.prefix = config.key_prefix
        self.timeout = timeout
        self.lease_timeout = lease_timeout
        self.stats = StoreStats()
        self.retried_ops = 0
        self._lock = threading.Lock()
        self._live_bytes = 0.0
        self._sizes: dict = {}          # key -> charged nbytes (accounting)
        self._poison: Optional[BaseException] = None
        self._heartbeats: dict = {}
        self._dead: set = set()

    # ------------------------------------------------------------- transport
    def _s3(self, op: str, **kw):
        """One S3 call, retried on transient codes per the config's policy."""
        attempt = 1
        policy = self.config.retry
        while True:
            try:
                return getattr(self.client, op)(**kw)
            except Exception as e:      # noqa: BLE001 - classified by code
                code = _s3_error_code(e)
                if code in RETRYABLE_S3_CODES and attempt < policy.max_attempts:
                    with self._lock:
                        self.retried_ops += 1
                    time.sleep(policy.delay(attempt, kw.get("Key", op)))
                    attempt += 1
                    continue
                raise

    def _skey(self, key: str) -> str:
        return f"{self.prefix}{key}"

    def _get_blob(self, key: str) -> Optional[bytes]:
        try:
            resp = self._s3("get_object", Bucket=self.bucket, Key=self._skey(key))
        except Exception as e:          # noqa: BLE001 - classified by code
            if _s3_error_code(e) in _MISSING_CODES:
                return None
            raise
        return resp["Body"].read()

    # ------------------------------------------------------ liveness / leases
    def heartbeat(self, worker: Tuple[int, int]) -> None:
        with self._lock:
            self._heartbeats[worker] = time.monotonic()

    def mark_dead(self, worker: Tuple[int, int]) -> None:
        with self._lock:
            self._dead.add(worker)

    def heartbeat_age(self, worker: Tuple[int, int]) -> Optional[float]:
        with self._lock:
            beat = self._heartbeats.get(worker)
        return None if beat is None else time.monotonic() - beat

    def abort(self, reason: BaseException) -> None:
        with self._lock:
            if self._poison is None:
                self._poison = reason

    def revive(self) -> None:
        with self._lock:
            self._poison = None
            self._dead.clear()
            self._heartbeats.clear()

    # -------------------------------------------------------------- store API
    def put(self, key: str, nbytes: float, value: Any = None) -> float:
        """Publish ``value`` under ``key``; returns the bytes charged."""
        blob = pickle.dumps((float(nbytes), to_wire(value)),
                            protocol=pickle.HIGHEST_PROTOCOL)
        self._s3("put_object", Bucket=self.bucket, Key=self._skey(key), Body=blob)
        with self._lock:
            prev = self._sizes.pop(key, None)
            if prev is not None:
                # an overwrite frees the old object: count the implicit delete
                self._live_bytes -= prev
                self.stats.count_delete(key, prev)
            self._sizes[key] = float(nbytes)
            self._live_bytes += float(nbytes)
            self.stats.count_put(key, float(nbytes), self._live_bytes)
        return float(nbytes)

    def _check_liveness(self, key: str) -> None:
        producer = producer_worker_of_key(key)
        with self._lock:
            poison = self._poison
            dead = producer in self._dead
            beat = self._heartbeats.get(producer)
        if poison is not None:
            raise StoreAbortedError(
                f"store aborted while waiting for {key!r}: {poison}") from poison
        if producer is not None:
            check_lease(key, producer, dead,
                        None if beat is None else time.monotonic() - beat,
                        self.lease_timeout)

    def _fetch(self, key: str, consume: bool, return_nbytes: bool) -> Any:
        deadline = time.monotonic() + self.timeout
        while True:
            self._check_liveness(key)
            blob = self._get_blob(key)
            if blob is not None:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(self._diagnose_timeout(key))
            time.sleep(min(0.01, self.lease_timeout / 4.0))
        nbytes, value = pickle.loads(blob)
        with self._lock:
            self.stats.count_get(key, nbytes)
        if consume:
            self._s3("delete_object", Bucket=self.bucket, Key=self._skey(key))
            with self._lock:
                self._sizes.pop(key, None)
                self._live_bytes -= nbytes
                self.stats.count_delete(key, nbytes)
        value = from_wire(value)
        return (value, nbytes) if return_nbytes else value

    def _diagnose_timeout(self, key: str) -> str:
        producer = producer_worker_of_key(key)
        with self._lock:
            existing = list(self._sizes)
            dead = producer in self._dead
        return timeout_message(key, self.timeout, existing, dead,
                               None if producer is None else self.heartbeat_age(producer))

    def get(self, key: str, return_nbytes: bool = False) -> Any:
        return self._fetch(key, consume=False, return_nbytes=return_nbytes)

    def take(self, key: str, return_nbytes: bool = False) -> Any:
        return self._fetch(key, consume=True, return_nbytes=return_nbytes)

    def delete(self, key: str) -> None:
        with self._lock:
            nbytes = self._sizes.pop(key, None)
        if nbytes is None:
            return
        self._s3("delete_object", Bucket=self.bucket, Key=self._skey(key))
        with self._lock:
            self._live_bytes -= nbytes
            self.stats.count_delete(key, nbytes)

    def keys(self):
        out = []
        kw = dict(Bucket=self.bucket, Prefix=self.prefix)
        while True:
            resp = self._s3("list_objects_v2", **kw)
            for obj in resp.get("Contents", ()) or ():
                out.append(obj["Key"][len(self.prefix):])
            if not resp.get("IsTruncated"):
                return out
            kw["ContinuationToken"] = resp["NextContinuationToken"]

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._sizes

    def __len__(self) -> int:
        with self._lock:
            return len(self._sizes)

    @property
    def live_bytes(self) -> float:
        with self._lock:
            return self._live_bytes


class AwsS3Backend(LocalBackend):
    """AWS Lambda workers synchronising through S3 (paper §5.1): every object
    round-trips through the configured bucket; the stage workers run as this
    host's threads.  ``client`` injects a boto3-shaped client (tests)."""

    name = "aws"
    client_module = "boto3"
    platform_blurb = "AWS Lambda + S3"
    default_config = AWS_CLOUD_CONFIG

    def __init__(self, config: Optional[CloudConfig] = None, *,
                 client: Any = None,
                 get_timeout: float = DEFAULT_GET_TIMEOUT,
                 lease_timeout: float = DEFAULT_LEASE_TIMEOUT):
        super().__init__(get_timeout=get_timeout, lease_timeout=lease_timeout)
        self.config = config if config is not None else self.default_config
        self._client = client

    def _make_client(self) -> Any:
        if self._client is not None:
            return self._client
        if importlib.util.find_spec(self.client_module) is None:
            raise BackendUnavailableError(
                f"backend {self.name!r} ({self.platform_blurb}) requires the "
                f"{self.client_module!r} client (`pip install "
                f"{self.client_module}`).  Replay the plan on 'emulated', "
                "'local' or 'process' instead.")
        missing = self.config.missing_credentials()
        if missing:
            raise BackendUnavailableError(
                f"backend {self.name!r}: {self.client_module} is installed but "
                f"credentials are missing — set {', '.join(missing)} before "
                "opening this backend.")
        if not self.config.bucket:
            raise BackendUnavailableError(
                f"backend {self.name!r}: no S3 bucket configured — pass "
                "CloudConfig(bucket=...) to AwsS3Backend.")
        import boto3

        return boto3.client("s3", region_name=self.config.region,
                            endpoint_url=self.config.endpoint)

    def open(self, agg) -> None:
        # the client first: a missing boto3/credentials/bucket surfaces as
        # the actionable BackendUnavailableError
        self._client = self._make_client()
        super().open(agg)

    def _make_store(self) -> S3ObjectStore:
        return S3ObjectStore(self._make_client(), self.config,
                             timeout=self.get_timeout,
                             lease_timeout=self.lease_timeout)


class _CloudStub(ExecutionBackend):
    """A registered platform without adapters: ``open()`` names what is
    missing."""

    wall_clock = True
    client_module = "?"
    platform_blurb = "?"
    default_config: CloudConfig = CloudConfig()

    def __init__(self, config: Optional[CloudConfig] = None):
        self.config = config if config is not None else self.default_config

    def _unavailable(self) -> BackendUnavailableError:
        if importlib.util.find_spec(self.client_module) is not None:
            detail = (f"the {self.client_module!r} client is importable but the "
                      f"{self.name} backend's store/invoke adapters are not "
                      "implemented yet")
        else:
            detail = (f"requires the {self.client_module!r} client "
                      f"(`pip install {self.client_module}`)")
        missing = self.config.missing_credentials()
        cred = (f"  Credentials: set {', '.join(missing)} before opening this "
                "backend." if missing else "")
        return BackendUnavailableError(
            f"backend {self.name!r} ({self.platform_blurb}) is a stub: "
            f"{detail}.{cred}  Replay the plan on 'emulated', 'local' or "
            "'process' instead.")

    def open(self, agg) -> None:
        raise self._unavailable()

    def context(self, s: int, r: int):  # pragma: no cover - open() raises
        raise self._unavailable()

    def run_step(self, k, programs, *, pipelined_sync=True):  # pragma: no cover
        raise self._unavailable()

    @property
    def store_stats(self):  # pragma: no cover - open() raises first
        raise self._unavailable()

    def _store_for_verification(self):  # pragma: no cover
        raise self._unavailable()


class AliyunOssBackend(_CloudStub):
    """Alibaba Function Compute workers synchronising through OSS (§5.7)."""

    name = "oss"
    client_module = "oss2"
    platform_blurb = "Alibaba Function Compute + OSS"
    default_config = OSS_CLOUD_CONFIG
