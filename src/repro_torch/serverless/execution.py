"""One typed surface for "how to execute a plan": :class:`ExecutionConfig`
(``repro_torch.serverless.execution`` for the port).

The execution knobs (backend, step count, span tracing, the process
backend's payload-true/throttle/bandwidth calibration axes, fault injection
and the retry/checkpoint recovery policy) live in one frozen,
JSON-round-trippable config; every entry point (``runtime.run_plan``,
``DeploymentPlan.emulate``, ``Session.emulate``, ``python -m repro_torch
emulate``) accepts either an ExecutionConfig or the legacy keywords
(shimmed through :meth:`ExecutionConfig.merge` with a
:class:`DeprecationWarning`), and all validation lives here.  A config's
JSON is the JAX package's, field for field.

Import discipline: the runtime engine imports this module at module scope,
and ``backends``/``faults`` import ``runtime.store`` — so this module must
import both of those only lazily (inside methods), mirroring the engine's
own rule.
"""
from __future__ import annotations

import dataclasses
import json
import warnings
from dataclasses import dataclass
from typing import Any, Dict, Optional, Union

EXEC_SCHEMA_VERSION = 1

#: legacy keyword -> ExecutionConfig field (identity today; kept explicit so
#: the shim errors out loudly if an entry point grows an unmapped knob)
LEGACY_EXECUTION_KWARGS = ("backend", "steps", "trace", "payload_true",
                           "throttle", "bandwidth", "faults", "tolerance",
                           "retries", "checkpoint_every")


@dataclass(frozen=True)
class ExecutionConfig:
    """How to run a plan through the storage-backed engine.

    ``backend`` is a registry name (``emulated`` / ``local`` / ``process`` /
    ``aws`` / ``oss`` / any ``register_backend``'ed name) or a pre-built
    :class:`~repro_torch.serverless.backends.ExecutionBackend` instance (instances
    execute fine but do not serialize).  ``payload_true`` / ``throttle`` /
    ``bandwidth`` are the process backend's calibrated byte/time axes;
    ``bandwidth`` implies ``throttle``.  ``faults`` is a
    :class:`~repro_torch.serverless.faults.FaultPlan` or a path to its JSON;
    ``tolerance`` a :class:`~repro_torch.serverless.faults.FaultTolerance`;
    ``retries`` / ``checkpoint_every`` are the CLI-style shorthands folded
    into the tolerance by :meth:`resolved_tolerance`.
    """

    backend: Union[str, Any] = "emulated"
    steps: int = 1
    trace: bool = False
    payload_true: bool = False
    throttle: bool = False
    bandwidth: Optional[float] = None     # bytes/s override for the throttle
    faults: Optional[Any] = None          # FaultPlan | path to its JSON
    tolerance: Optional[Any] = None       # FaultTolerance
    retries: Optional[int] = None         # -> tolerance.retry.max_attempts
    checkpoint_every: Optional[int] = None

    # ------------------------------------------------------------ validation
    def __post_init__(self):
        if not isinstance(self.steps, int) or self.steps < 1:
            raise ValueError(f"steps must be a positive int, got "
                             f"{self.steps!r}")
        if self.bandwidth is not None:
            if not self.bandwidth > 0:
                raise ValueError(f"bandwidth must be > 0 bytes/s, got "
                                 f"{self.bandwidth!r}")
            # an explicit bandwidth is only meaningful as a throttle rate
            object.__setattr__(self, "throttle", True)
        for name in ("retries", "checkpoint_every"):
            v = getattr(self, name)
            if v is not None and (not isinstance(v, int) or v < 1):
                raise ValueError(f"{name} must be a positive int, got {v!r}")

    @property
    def needs_process_backend(self) -> bool:
        return bool(self.payload_true or self.throttle
                    or self.bandwidth is not None)

    @staticmethod
    def _process_required_msg() -> str:
        return ("payload_true/throttle/bandwidth need the process backend "
                "(real payloads moving through a real store); pass "
                "backend='process'")

    # ------------------------------------------------------------ legacy shim
    @classmethod
    def merge(cls, exec_config: Optional["ExecutionConfig"],
              legacy: Dict[str, Any], *, where: str) -> "ExecutionConfig":
        """The deprecation shim every entry point routes through: either an
        ExecutionConfig or legacy keywords, never both.  ``legacy`` maps
        keyword name -> value with ``None`` meaning "not passed" (booleans
        included — entry points declare ``trace=None`` etc. so an explicit
        legacy value is distinguishable from the default)."""
        unknown = set(legacy) - set(LEGACY_EXECUTION_KWARGS)
        if unknown:
            raise TypeError(f"{where}: unmapped execution kwargs "
                            f"{sorted(unknown)}")
        passed = {k: v for k, v in legacy.items() if v is not None}
        if exec_config is not None:
            if not isinstance(exec_config, cls):
                raise TypeError(
                    f"{where}: expected an ExecutionConfig, got "
                    f"{type(exec_config).__name__}")
            if passed:
                raise ValueError(
                    f"{where}: pass execution settings either as an "
                    f"ExecutionConfig or as legacy keywords, not both "
                    f"(got ExecutionConfig plus {sorted(passed)})")
            return exec_config
        if passed:
            warnings.warn(
                f"{where}: execution keywords {sorted(passed)} are "
                "deprecated; pass ExecutionConfig(...) instead",
                DeprecationWarning, stacklevel=3)
        return cls(**passed)

    # -------------------------------------------------------------- resolving
    def resolve_backend(self):
        """Instantiate + configure the execution backend.  The single
        authoritative home of the "calibration flags need the process
        backend" rule (entry points used to each carry a copy)."""
        from repro_torch.serverless.backends import ProcessBackend, get_backend

        be = get_backend(self.backend)
        if self.needs_process_backend:
            if not isinstance(be, ProcessBackend):
                raise ValueError(self._process_required_msg())
            be.payload_true = bool(self.payload_true)
            be.throttle = bool(self.throttle)
            if self.bandwidth is not None:
                be.bandwidth = float(self.bandwidth)
        return be

    def resolved_faults(self):
        """The FaultPlan to inject (paths loaded), or None."""
        if self.faults is None:
            return None
        if isinstance(self.faults, str):
            from repro_torch.serverless.faults import FaultPlan

            return FaultPlan.load(self.faults)
        return self.faults

    def resolved_tolerance(self):
        """Fold the ``retries``/``checkpoint_every`` shorthands into a
        FaultTolerance (None when no recovery knob was set at all — the
        engine treats that as "recovery machinery off unless faults are
        injected")."""
        if (self.tolerance is None and self.retries is None
                and self.checkpoint_every is None):
            return None
        from repro_torch.serverless.faults import FaultTolerance

        tol = self.tolerance if self.tolerance is not None else FaultTolerance()
        if self.retries is not None:
            tol = dataclasses.replace(
                tol, retry=dataclasses.replace(tol.retry,
                                               max_attempts=self.retries))
        if self.checkpoint_every is not None:
            tol = dataclasses.replace(tol,
                                      checkpoint_every=self.checkpoint_every)
        return tol

    # --------------------------------------------------------- serialization
    def _as_dict(self) -> dict:
        if not isinstance(self.backend, str):
            raise TypeError(
                "ExecutionConfig with a backend *instance* does not "
                "serialize — construct it with the registry name instead "
                f"(got {type(self.backend).__name__})")
        d = dataclasses.asdict(self)
        if self.faults is not None and not isinstance(self.faults, str):
            # embed the fault plan's own JSON document (it is versioned)
            d["faults"] = {"fault_plan": json.loads(self.faults.to_json())}
        if self.tolerance is not None:
            d["tolerance"] = dataclasses.asdict(self.tolerance)
        d["version"] = EXEC_SCHEMA_VERSION
        return d

    def to_json(self, *, indent: Optional[int] = 2) -> str:
        return json.dumps(self._as_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, blob: str) -> "ExecutionConfig":
        d = json.loads(blob)
        version = d.pop("version", None)
        if version != EXEC_SCHEMA_VERSION:
            raise ValueError(f"execution config schema version {version!r} "
                             f"!= supported {EXEC_SCHEMA_VERSION}")
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"execution config JSON has unknown fields "
                             f"{sorted(unknown)}")
        if isinstance(d.get("faults"), dict):
            from repro_torch.serverless.faults import FaultPlan

            d["faults"] = FaultPlan.from_json(
                json.dumps(d["faults"]["fault_plan"]))
        if d.get("tolerance") is not None:
            from repro_torch.serverless.faults import FaultTolerance, RetryPolicy

            t = dict(d["tolerance"])
            t["retry"] = RetryPolicy(**t["retry"])
            d["tolerance"] = FaultTolerance(**t)
        return cls(**d)
