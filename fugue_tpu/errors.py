"""Typed error taxonomy for fugue-tpu.

Capability parity with the reference error layer (reference:
``src/error.rs:40-161`` — ``ErrorCode``, ``ErrorCategory``, ``ErrorContext``,
``FugueError``), re-designed for a Python/JAX host layer: errors are raised at
*staging time* (model construction, parameter validation, address conflicts)
so that nothing inside a jit-compiled kernel can fail dynamically.  Inside
compiled code, failures degrade to ``-inf`` log-weights (the analog of the
reference's "safe" handlers, ``src/runtime/interpreters.rs:514-589``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional


class ErrorCode(enum.IntEnum):
    """Stable numeric error codes (reference: src/error.rs:40-59)."""

    # 1xx — invalid distribution parameters
    INVALID_MEAN = 100
    INVALID_VARIANCE = 101
    INVALID_PROBABILITY = 102
    INVALID_RANGE = 103
    INVALID_SHAPE = 104
    INVALID_RATE = 105
    INVALID_COUNT = 106
    # 3xx — model-structure errors
    ADDRESS_CONFLICT = 301
    UNEXPECTED_MODEL_STRUCTURE = 302
    # 5xx — trace access errors
    TRACE_ADDRESS_NOT_FOUND = 500
    # 6xx — type errors
    TYPE_MISMATCH = 600
    # 7xx — staging/compilation errors (new in this build: the staging
    # architecture introduces a compile boundary the reference did not have)
    NOT_STAGEABLE = 700
    INVALID_SHARDING = 701


class ErrorCategory(enum.Enum):
    """Coarse grouping of error codes (reference: src/error.rs:100)."""

    VALIDATION = "validation"
    MODEL_STRUCTURE = "model_structure"
    TRACE_ACCESS = "trace_access"
    TYPE = "type"
    STAGING = "staging"

    @staticmethod
    def of(code: ErrorCode) -> "ErrorCategory":
        n = int(code)
        if n < 300:
            return ErrorCategory.VALIDATION
        if n < 500:
            return ErrorCategory.MODEL_STRUCTURE
        if n < 600:
            return ErrorCategory.TRACE_ACCESS
        if n < 700:
            return ErrorCategory.TYPE
        return ErrorCategory.STAGING


@dataclass
class ErrorContext:
    """Key-value context attached to an error (reference: src/error.rs:110-158)."""

    items: dict = field(default_factory=dict)
    note: Optional[str] = None

    def with_item(self, key: str, value: Any) -> "ErrorContext":
        self.items[key] = value
        return self

    def render(self) -> str:
        parts = [f"{k}={v!r}" for k, v in self.items.items()]
        if self.note:
            parts.append(self.note)
        return ", ".join(parts)


class FugueError(Exception):
    """Base error with a stable code + category + context.

    Reference: ``FugueError`` (src/error.rs:161).
    """

    def __init__(
        self,
        code: ErrorCode,
        message: str,
        context: Optional[Mapping[str, Any]] = None,
    ):
        self.code = code
        self.category = ErrorCategory.of(code)
        self.context = ErrorContext(dict(context or {}))
        super().__init__(self._render(message))

    def _render(self, message: str) -> str:
        ctx = self.context.render()
        tail = f" [{ctx}]" if ctx else ""
        return f"[{self.code.name}({int(self.code)})] {message}{tail}"


class ValidationError(FugueError):
    """Invalid distribution parameter (1xx codes)."""


class ModelStructureError(FugueError):
    """Address conflicts / unexpected structure (3xx codes)."""


class TraceAccessError(FugueError):
    """Missing address in a trace (5xx codes)."""


class TypeMismatchError(FugueError):
    """Wrong value type requested from a trace (600)."""


class StagingError(FugueError):
    """Model cannot be staged into a static XLA program (7xx codes)."""


def address_conflict(addr: str) -> ModelStructureError:
    """Duplicate sample address within one execution.

    Reference precedent: duplicate-address detection at every sample site
    (src/runtime/interpreters.rs:23-45, FG-47).
    """
    return ModelStructureError(
        ErrorCode.ADDRESS_CONFLICT,
        f"duplicate address {addr!r}: each sample/observe site must have a "
        "unique address within one model execution",
        {"address": addr},
    )


def unexpected_structure(msg: str, **ctx: Any) -> ModelStructureError:
    return ModelStructureError(ErrorCode.UNEXPECTED_MODEL_STRUCTURE, msg, ctx)


def trace_address_not_found(addr: str) -> TraceAccessError:
    return TraceAccessError(
        ErrorCode.TRACE_ADDRESS_NOT_FOUND,
        f"address {addr!r} not present in trace",
        {"address": addr},
    )


def type_mismatch(addr: str, expected: str, actual: str) -> TypeMismatchError:
    return TypeMismatchError(
        ErrorCode.TYPE_MISMATCH,
        f"value at {addr!r} has type {actual}, expected {expected}",
        {"address": addr, "expected": expected, "actual": actual},
    )


# ---------------------------------------------------------------------------
# Parameter validation helpers (reference: the `Validate` trait impls,
# src/error.rs:479+; constructors return FugueResult). Host-side: these run
# eagerly on *concrete* parameters at distribution construction. When a
# parameter is a traced JAX value (inside jit), validation is skipped here and
# the distribution's log_prob returns -inf / nan for invalid regions instead —
# the compiled-code analog of a typed error.
# ---------------------------------------------------------------------------



def _is_concrete(x: Any) -> bool:
    """True if x is a plain Python/numpy value we can validate eagerly."""
    if isinstance(x, (int, float)):
        return True
    try:  # numpy scalars / arrays / lists of scalars with concrete values
        import numpy as np
        import jax

        if isinstance(x, jax.core.Tracer):
            return False
        if isinstance(x, (np.ndarray, np.generic)):
            return True
        if isinstance(x, jax.Array):
            return True  # concrete device array
        if isinstance(x, (list, tuple)):
            arr = np.asarray(x)
            return arr.dtype != object
    except Exception:
        pass
    return False


def _is_python_static(x: Any) -> bool:
    """True only for Python/numpy values — NOT jax.Arrays. Used where a
    value must be a build-time constant (e.g. static support bounds): a
    concrete device array may be derived from another site's draw during
    eager staging discovery, so it cannot be trusted as static."""
    if isinstance(x, (bool, int, float)):
        return True
    try:
        import numpy as np

        if isinstance(x, (np.ndarray, np.generic)):
            return True
        if isinstance(x, (list, tuple)):
            return np.asarray(x).dtype != object
    except Exception:
        pass
    return False


def _all_finite(x: Any) -> bool:
    import numpy as np

    try:
        return bool(np.all(np.isfinite(np.asarray(x))))
    except Exception:
        return True


def check_finite(name: str, value: Any, code: ErrorCode) -> None:
    if _is_concrete(value) and not _all_finite(value):
        raise ValidationError(code, f"{name} must be finite", {name: value})


def check_positive(name: str, value: Any, code: ErrorCode) -> None:
    if not _is_concrete(value):
        return
    import numpy as np

    v = np.asarray(value)
    if not np.all(np.isfinite(v)) or not np.all(v > 0):
        raise ValidationError(
            code, f"{name} must be positive and finite", {name: value}
        )


def check_probability(name: str, value: Any) -> None:
    if not _is_concrete(value):
        return
    import numpy as np

    v = np.asarray(value)
    if not np.all(np.isfinite(v)) or np.any(v < 0) or np.any(v > 1):
        raise ValidationError(
            ErrorCode.INVALID_PROBABILITY,
            f"{name} must lie in [0, 1]",
            {name: value},
        )


def check_count(name: str, value: Any) -> None:
    if not _is_concrete(value):
        return
    import numpy as np

    v = np.asarray(value)
    if np.any(v < 0) or not np.all(np.equal(np.mod(v, 1), 0)):
        raise ValidationError(
            ErrorCode.INVALID_COUNT,
            f"{name} must be a non-negative integer",
            {name: value},
        )
