"""Pluggable execution backends for the storage-backed engines
(``repro.serverless.backends`` for the port).

    emulated   virtual-clock object store + per-worker clocks (default)
    local      wall-clock: S x d concurrent worker threads over a blocking
               in-memory (or file-spilling) store
    process    wall-clock: S x d spawned worker processes over a file store
    aws / oss  real platforms: an S3 adapter on a boto3-shaped client (boto3
               is not a dependency), an OSS stub

Every backend trains a plan to bit-identical params.  Third-party backends
register with :func:`register_backend`.
"""
from __future__ import annotations

import importlib.util
import os
from typing import Callable, Dict, Optional, Union

from repro_torch.serverless.backends.base import (  # noqa: F401
    ExecutionBackend,
    StepTiming,
    WorkerContext,
)
from repro_torch.serverless.backends.cloud import (  # noqa: F401
    AliyunOssBackend,
    AwsS3Backend,
    BackendUnavailableError,
)
from repro_torch.serverless.backends.emulated import (  # noqa: F401
    EmulatedBackend,
    EmulatedWorkerContext,
)
from repro_torch.serverless.backends.local import (  # noqa: F401
    LocalBackend,
    LocalStore,
    LocalWorkerContext,
)
from repro_torch.serverless.backends.process import (  # noqa: F401
    ProcessBackend,
    ProcessWorkerHandle,
)

_REGISTRY: Dict[str, Callable[[], ExecutionBackend]] = {}


def register_backend(name: str, factory: Callable[[], ExecutionBackend]) -> None:
    """Register a backend factory under ``name`` (a real adapter may shadow
    a stub)."""
    _REGISTRY[name] = factory


def available_backends() -> tuple:
    """Registered backend names, sorted."""
    return tuple(sorted(_REGISTRY))


def _availability_of(name: str) -> Optional[str]:
    """None when backend ``name`` should open on this host, else a short
    reason it will fail."""
    if name == "process":
        if os.name != "posix":
            return "needs POSIX file locks + signals"
        return None
    client = {"aws": "boto3", "oss": "oss2"}.get(name)
    if client is not None and importlib.util.find_spec(client) is None:
        return f"{client} not installed"
    return None


def backend_availability() -> Dict[str, Optional[str]]:
    """Registered name -> None (available here) or why it is not."""
    return {name: _availability_of(name) for name in available_backends()}


def get_backend(spec: Union[str, ExecutionBackend]) -> ExecutionBackend:
    """An instance passes through unchanged (a pre-configured backend such
    as ``LocalBackend(fs_root=...)``); a name builds a fresh instance."""
    if isinstance(spec, ExecutionBackend):
        return spec
    try:
        factory = _REGISTRY[spec]
    except (KeyError, TypeError):
        described = ", ".join(name if why is None else f"{name} (unavailable: {why})"
                              for name, why in backend_availability().items())
        raise KeyError(f"unknown execution backend {spec!r}; available: "
                       f"{described}") from None
    return factory()


register_backend("emulated", EmulatedBackend)
register_backend("local", LocalBackend)
register_backend("process", ProcessBackend)
register_backend("aws", AwsS3Backend)
register_backend("oss", AliyunOssBackend)
