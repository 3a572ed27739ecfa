"""Trace-context propagation: one trace id across the store's processes.

Port of ``torchstore_tpu/observability/context.py``. A logical operation
fans out over processes (client span -> controller notify -> volume put);
this module keeps a W3C-traceparent-shaped context (``trace_id`` and
``parent_span_id``) in :mod:`contextvars`, so:

- ``span()`` (tracing.py) stamps every event with the active ``trace_id``,
  its own ``span_id`` and its ``parent_id``, and becomes the parent of what
  opens under it, across ``await`` (asyncio tasks copy the context);
- the actor runtime carries the current context in every request frame and
  re-activates it around the endpoint's dispatch, so a volume's span
  carries the client's trace id;
- ``merge_traces`` / ``collect_trace`` join the per-process files on it.

Ids are 16 hex characters (8 random bytes).
"""

from __future__ import annotations

import contextvars
import secrets
from typing import Optional

_trace_id: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "torchstore_tpu_torch_trace_id", default=None
)
_parent_span_id: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "torchstore_tpu_torch_parent_span_id", default=None
)


def new_id() -> str:
    return secrets.token_hex(8)


def trace_id() -> Optional[str]:
    """The active trace id, or None outside any traced operation."""
    return _trace_id.get()


def parent_span_id() -> Optional[str]:
    return _parent_span_id.get()


def current() -> Optional[dict]:
    """What rides an RPC frame: ``{"trace_id", "parent_span_id"}``, or None
    outside a trace."""
    tid = _trace_id.get()
    if tid is None:
        return None
    return {"trace_id": tid, "parent_span_id": _parent_span_id.get()}


def push_span(span_id: str) -> "contextvars.Token":
    """Make ``span_id`` the parent of what opens under it; the token's
    ``old_value`` is the span's own parent."""
    return _parent_span_id.set(span_id)


def pop_span(token: "contextvars.Token") -> None:
    _parent_span_id.reset(token)


def token_parent(token: "contextvars.Token") -> Optional[str]:
    """The parent id that was active before ``push_span`` made ``token``."""
    old = token.old_value
    return None if old is contextvars.Token.MISSING else old


class activate:
    """Adopt an incoming (RPC-carried) context for a block; ``activate(None)``
    does nothing, so dispatch wraps every call in it."""

    __slots__ = ("_ctx", "_tokens")

    def __init__(self, ctx: Optional[dict]) -> None:
        self._ctx = ctx if isinstance(ctx, dict) else None
        self._tokens = None

    def __enter__(self) -> "activate":
        if self._ctx is not None and self._ctx.get("trace_id"):
            self._tokens = (
                _trace_id.set(str(self._ctx["trace_id"])),
                _parent_span_id.set(self._ctx.get("parent_span_id")),
            )
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._tokens is not None:
            _trace_id.reset(self._tokens[0])
            _parent_span_id.reset(self._tokens[1])
            self._tokens = None


class ensure_root:
    """Start a new trace unless one is active: client ops wrap their body in
    it, so each put or get roots one trace and nested store calls (a channel
    publish, a state-dict put) join their caller's."""

    __slots__ = ("_token",)

    def __enter__(self) -> "ensure_root":
        self._token = None if _trace_id.get() is not None else _trace_id.set(new_id())
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._token is not None:
            _trace_id.reset(self._token)
            self._token = None
