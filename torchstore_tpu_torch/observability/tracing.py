"""Span tracing: Chrome-trace events of store operations.

Port of ``torchstore_tpu/observability/tracing.py``. With
``TORCHSTORE_TORCH_TRACE=/path/trace.json`` set, every ``span(...)`` (put
and get batches, volume fetches, transfers, channel publishes) and every
``LatencyTracker`` step lands as a Chrome-trace complete event; the file
loads in Perfetto or chrome://tracing, beside a ``torch.profiler`` trace.

    with span("put_batch", keys=3, nbytes=total) as sp:
        ...
        sp.set(volume=vid)

Off (no env var), a span costs one ``perf_counter`` call and an attribute
check. Events stream to disk in the JSON array format every
``FLUSH_EVERY`` events (the closing ``]`` is optional, so a crashed
process's file still loads). One file per process: the base path is
claimed through a ``<base>.owner`` file, and other processes of the run
write pid-suffixed siblings that ``collect_trace`` merges.
"""

from __future__ import annotations

import atexit
import glob as _glob
import json
import os
import re
import threading
import time
from typing import Optional

from torchstore_tpu_torch.observability import context as trace_context
from torchstore_tpu_torch.observability.metrics import _pid_alive

ENV_TRACE = "TORCHSTORE_TORCH_TRACE"
# One id per run (process tree): minted by the first process to claim a
# trace file and handed to every actor child with the other
# TORCHSTORE_TORCH_* settings. It tells a sibling of this run that already
# exited (its events belong in the merge) from a finished run's leftover
# file (cleared).
ENV_TRACE_RUN = "TORCHSTORE_TORCH_TRACE_RUN"


def _current_run_id() -> str:
    rid = os.environ.get(ENV_TRACE_RUN)
    if not rid:
        rid = f"{os.getpid()}.{trace_context.new_id()}"
        os.environ[ENV_TRACE_RUN] = rid
    return rid


# spawn_actors calls this before it hands the env to children.
ensure_run_id = _current_run_id


def process_label() -> str:
    """This process's track label in a merged trace: the actor's process
    name (``tst-<actor>-<rank>``), else the script's name."""
    import multiprocessing as mp
    import sys

    name = mp.current_process().name
    if name in ("MainProcess", None, ""):
        name = os.path.basename(sys.argv[0] or "") or "python"
    return f"{name}[{os.getpid()}]"


class TraceCollector:
    """The process's Chrome-trace event buffer (on when the env var is set)."""

    FLUSH_EVERY = 1000

    def __init__(self) -> None:
        self.path = os.environ.get(ENV_TRACE)
        self.events: list[dict] = []
        self._lock = threading.Lock()
        self._registered = False
        self._resolved_path: Optional[str] = None
        self._resolved_for: Optional[str] = None
        self._wrote_header = False

    @property
    def enabled(self) -> bool:
        return bool(self.path)

    def add_event(
        self, name: str, start_s: float, dur_s: float, args: Optional[dict] = None
    ) -> None:
        """One complete ('X') event; a ``bytes`` arg gets a derived GBps."""
        if not self.path:
            return
        event = {
            "name": name,
            "cat": "torchstore",
            "ph": "X",
            "ts": start_s * 1e6,
            "dur": dur_s * 1e6,
            "pid": os.getpid(),
            "tid": threading.get_ident() & 0xFFFF,
        }
        if args:
            args = dict(args)
            nbytes = args.get("bytes")
            if isinstance(nbytes, (int, float)) and "GBps" not in args:
                args["GBps"] = round(nbytes / dur_s / 1e9, 3) if dur_s > 0 else None
            event["args"] = args
        with self._lock:
            self.events.append(event)
            if not self._registered:
                self._registered = True
                atexit.register(self.flush)
            if len(self.events) >= self.FLUSH_EVERY:
                self._flush_locked()

    def add(
        self, name: str, phase: str, start_s: float, dur_s: float, nbytes: Optional[int]
    ) -> None:
        """A ``LatencyTracker`` step, named ``{name}/{phase}``."""
        args = {"bytes": nbytes} if nbytes is not None else None
        self.add_event(f"{name}/{phase}", start_s, dur_s, args)

    def _resolve_path(self) -> str:
        if self._resolved_path is None or self._resolved_for != self.path:
            base = self.path
            root, ext = os.path.splitext(base)
            pid_path = f"{root}.{os.getpid()}{ext or '.json'}"
            self._resolved_path = self._claim(base, pid_path)
            self._resolved_for = self.path
            self._wrote_header = False
        return self._resolved_path

    @staticmethod
    def _claim(base: str, pid_path: str) -> str:
        """The base path when this process may own it, else ``pid_path``;
        decided under an exclusive flock on the owner file, so two processes
        never both take over a stale claim (the kernel drops the lock of a
        killed claimant)."""
        import fcntl

        def truncate(path: str) -> None:
            os.close(os.open(path, os.O_CREAT | os.O_TRUNC | os.O_WRONLY, 0o644))

        pid = os.getpid()
        run_id = _current_run_id()
        try:
            fd = os.open(f"{base}.owner", os.O_CREAT | os.O_RDWR, 0o644)
        except OSError:
            try:
                truncate(pid_path)
            except OSError:
                pass
            return pid_path
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            lines = os.read(fd, 256).decode(errors="replace").splitlines()
            try:
                owner = int((lines[0] if lines else "").strip() or 0)
            except ValueError:
                owner = 0
            owner_run = lines[1].strip() if len(lines) > 1 else ""
            if owner and owner_run == run_id and owner != pid:
                claim_base = False  # a sibling of this run: its events stay
            elif owner and owner_run != run_id and _pid_alive(owner):
                claim_base = False  # a live owner of another run
            else:
                claim_base = True
            if claim_base:
                os.ftruncate(fd, 0)
                os.lseek(fd, 0, os.SEEK_SET)
                os.write(fd, f"{pid}\n{run_id}".encode())
                truncate(base)
                if owner and owner != pid and owner_run != run_id:
                    for stale in trace_files(base):  # a finished run's files
                        if stale != base:
                            try:
                                os.unlink(stale)
                            except OSError:
                                pass
                return base
        except OSError:
            pass
        finally:
            os.close(fd)
        try:
            truncate(pid_path)
        except OSError:
            pass
        return pid_path

    def _flush_locked(self) -> None:
        if not self.path or not self.events:
            return
        chunk = self.events
        self.events = []
        try:
            path = self._resolve_path()
            if not self._wrote_header:
                # A labeled track per process in the merged trace.
                chunk.insert(0, {"name": "process_name", "ph": "M", "pid": os.getpid(),
                                 "args": {"name": process_label()}})
            with open(path, "a") as f:
                for event in chunk:
                    f.write("[\n" if not self._wrote_header else ",\n")
                    self._wrote_header = True
                    json.dump(event, f)
        except OSError:
            pass

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def reinit_after_fork(self) -> None:
        """Re-read the env in a forked actor child: the forkserver imported
        this module under its own env, and the inherited buffer and claim are
        not this process's."""
        with self._lock:
            self.path = os.environ.get(ENV_TRACE)
            self.events = []
            self._resolved_path = None
            self._resolved_for = None
            self._wrote_header = False


_collector = TraceCollector()


def collector() -> TraceCollector:
    return _collector


def trace_enabled() -> bool:
    return _collector.enabled


def flush_trace() -> None:
    _collector.flush()


class span:
    """Records one named span with attributes (small values: key, nbytes,
    transport, volume, coordinates; ``nbytes`` becomes ``bytes`` with a
    derived GBps). With tracing on, each span mints a ``span_id``, records
    the active ``trace_id`` and its ``parent_id``, and is the parent of what
    opens (or what RPC is issued) inside it."""

    __slots__ = ("name", "attrs", "_t0", "_span_id", "_token")

    def __init__(self, name: str, **attrs) -> None:
        self.name = name
        self.attrs = attrs
        self._t0 = 0.0
        self._span_id = None
        self._token = None

    def set(self, **attrs) -> "span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "span":
        self._t0 = time.perf_counter()
        if _collector.enabled:
            self._span_id = trace_context.new_id()
            self._token = trace_context.push_span(self._span_id)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        parent = None
        if self._token is not None:
            parent = trace_context.token_parent(self._token)
            trace_context.pop_span(self._token)
            self._token = None
        if not _collector.enabled:
            return
        dur = time.perf_counter() - self._t0
        args = {
            k: (v if isinstance(v, (int, float, bool, type(None))) else str(v))
            for k, v in self.attrs.items()
        }
        if "nbytes" in args and "bytes" not in args:
            args["bytes"] = args.pop("nbytes")
        if exc_type is not None:
            args["error"] = exc_type.__name__
        tid = trace_context.trace_id()
        if tid is not None:
            args["trace_id"] = tid
        if self._span_id is not None:
            args["span_id"] = self._span_id
        if parent is not None:
            args["parent_id"] = parent
        _collector.add_event(self.name, self._t0, dur, args or None)


# ---- merging the per-process files -----------------------------------------


def load_trace_events(path: str) -> list[dict]:
    """The events of one per-process file (its missing ``]`` repaired)."""
    try:
        with open(path) as f:
            content = f.read().strip()
    except OSError:
        return []
    if not content:
        return []
    if not content.endswith("]"):
        content += "\n]"
    try:
        events = json.loads(content)
    except ValueError:
        return []
    return [e for e in events if isinstance(e, dict)]


def trace_files(base: str) -> list[str]:
    """The base file and its pid-suffixed siblings (``<root>.<pid><ext>``)."""
    root, ext = os.path.splitext(base)
    ext = ext or ".json"
    pid_re = re.compile(re.escape(root) + r"\.(\d+)" + re.escape(ext) + r"$")
    out = [base] if os.path.exists(base) else []
    out += [c for c in sorted(_glob.glob(f"{root}.*{ext}")) if pid_re.match(c)]
    return out


def merge_traces(paths: list[str], out_path: str) -> dict:
    """One Perfetto-loadable timeline from per-process files: metadata
    events first, the rest by timestamp, each on its process's track.
    Returns ``{"path", "files", "events", "trace_ids"}``."""
    events: list[dict] = []
    for path in paths:
        events.extend(load_trace_events(path))
    meta = [e for e in events if e.get("ph") == "M"]
    rest = [e for e in events if e.get("ph") != "M"]
    rest.sort(key=lambda e: e.get("ts", 0))
    tmp = f"{out_path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(meta + rest, f)
    os.replace(tmp, out_path)
    trace_ids = {
        e["args"]["trace_id"]
        for e in rest
        if isinstance(e.get("args"), dict) and "trace_id" in e["args"]
    }
    return {"path": out_path, "files": list(paths), "events": len(rest),
            "trace_ids": sorted(trace_ids)}


def collect_trace(out_path: Optional[str] = None) -> Optional[dict]:
    """Flush this process and merge every process's file of the configured
    base into ``out_path`` (default ``<root>.merged<ext>``); None when
    tracing is off. Call after ``shutdown`` so actor processes have flushed."""
    base = _collector.path or os.environ.get(ENV_TRACE)
    if not base:
        return None
    _collector.flush()
    files = trace_files(base)
    if not files:
        return None
    if out_path is None:
        root, ext = os.path.splitext(base)
        out_path = f"{root}.merged{ext or '.json'}"
    return merge_traces(files, out_path)
