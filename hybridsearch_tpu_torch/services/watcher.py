"""File watching -> automatic reindexing.

Counterpart of ``hybridsearch_tpu/services/watcher.py``, host code copied
with the port's imports; ``watchdog`` is imported when the watcher starts on it.

Parity with the reference watcher (reference watcher.py:18-186): watch a
directory for supported-extension changes, debounce 2 s per path, dispatch
created/modified/deleted events to a callback that reindexes.

The reference requires the `watchdog` package for inotify fidelity
(reference watcher.py:9-15). Backends here, best first:
  1. watchdog, transparently when importable (optional-dep convention);
  2. FIRST-PARTY inotify via ctypes on Linux — kernel-event latency with
     zero dependencies (recursive watches, new subdirectories picked up
     from IN_CREATE|IN_ISDIR events);
  3. portable polling fallback (mtime snapshots on a background thread).
"""

from __future__ import annotations

import importlib.util
import os
import threading
import time
from typing import Callable, Dict, Iterable, Optional, Set

from hybridsearch_tpu_torch.text.extractor import SUPPORTED_EXTENSIONS

# optional dependency (reference watcher.py:9-15), imported at first use
WATCHDOG_AVAILABLE = importlib.util.find_spec("watchdog") is not None

DEBOUNCE_SECONDS = 2.0  # reference watcher.py:37

# -- first-party inotify (Linux) ----------------------------------------------------

_IN_MODIFY = 0x002
_IN_CLOSE_WRITE = 0x008
_IN_MOVED_FROM = 0x040
_IN_MOVED_TO = 0x080
_IN_CREATE = 0x100
_IN_DELETE = 0x200
_IN_ISDIR = 0x40000000
_WATCH_MASK = (_IN_MODIFY | _IN_CLOSE_WRITE | _IN_MOVED_FROM | _IN_MOVED_TO
               | _IN_CREATE | _IN_DELETE)


def _inotify_syscalls():
    """(inotify_init1, inotify_add_watch) from libc, or None off-Linux."""
    import ctypes
    import sys

    if not sys.platform.startswith("linux"):
        return None
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        init1 = libc.inotify_init1
        init1.argtypes = [ctypes.c_int]
        init1.restype = ctypes.c_int
        add = libc.inotify_add_watch
        add.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_uint32]
        add.restype = ctypes.c_int
        return init1, add
    except (OSError, AttributeError):
        return None


INOTIFY_AVAILABLE = _inotify_syscalls() is not None


class FileWatcher:
    """Polling (or watchdog) directory watcher.

    callback(event: str, path: str) with event in
    {"created", "modified", "deleted"}."""

    def __init__(
        self,
        directory: str,
        callback: Callable[[str, str], None],
        extensions: Optional[Iterable[str]] = None,
        poll_interval: float = 1.0,
        debounce: float = DEBOUNCE_SECONDS,
    ) -> None:
        self.directory = os.path.abspath(directory)
        self.callback = callback
        self.extensions = tuple(extensions) if extensions else SUPPORTED_EXTENSIONS
        self.poll_interval = poll_interval
        self.debounce = debounce
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_fired: Dict[str, float] = {}
        self._pending: Dict[str, str] = {}  # path -> suppressed event
        self._pending_lock = threading.Lock()
        self._flusher: Optional[threading.Thread] = None
        self._observer = None
        self.is_running = False

    # -- lifecycle (reference watcher.py:113-137) ---------------------------------

    def start(self) -> None:
        if self.is_running:
            return
        self._stop.clear()
        if WATCHDOG_AVAILABLE:
            self._start_watchdog()
        elif INOTIFY_AVAILABLE and self._start_inotify():
            pass
        else:
            self._thread = threading.Thread(target=self._poll_loop, daemon=True)
            self._thread.start()
        self._flusher = threading.Thread(target=self._flush_loop, daemon=True)
        self._flusher.start()
        self.is_running = True

    def stop(self) -> None:
        self._stop.set()
        if self._observer is not None:
            self._observer.stop()
            self._observer.join(timeout=5)
            self._observer = None
        if self._thread is not None:
            self._thread.join(timeout=self.poll_interval * 3)
            self._thread = None
        if self._flusher is not None:
            self._flusher.join(timeout=3)
            self._flusher = None
        self._flush_pending()  # don't lose suppressed final states
        self.is_running = False

    # -- event plumbing -------------------------------------------------------------

    def _wanted(self, path: str) -> bool:
        return os.path.splitext(path)[1].lower() in self.extensions

    def _fire(self, event: str, path: str) -> None:
        """Debounced dispatch: at most one event per path per debounce window
        (reference watcher.py:34-58) — but trailing-edge safe: an event
        suppressed inside the window is re-fired once the window expires
        (the flusher thread), so the LAST state of a path is never lost.
        Without this, `create` (empty file) fires and the `close_write`
        carrying the real content lands inside the window and vanishes."""
        now = time.time()
        last = self._last_fired.get(path, 0.0)
        if now - last < self.debounce:
            with self._pending_lock:
                self._pending[path] = event
            return
        self._last_fired[path] = now
        try:
            self.callback(event, path)
        except Exception:
            pass  # watcher must survive callback failures

    def _flush_pending(self) -> None:
        """Re-fire suppressed events whose debounce window has expired."""
        now = time.time()
        with self._pending_lock:
            ready = [p for p in self._pending
                     if now - self._last_fired.get(p, 0.0) >= self.debounce]
            flush = [(p, self._pending.pop(p)) for p in ready]
        for path, event in flush:
            self._last_fired[path] = now
            try:
                self.callback(event, path)
            except Exception:
                pass

    def _flush_loop(self) -> None:
        step = min(self.poll_interval, self.debounce / 2.0, 0.5)
        while not self._stop.wait(timeout=max(step, 0.05)):
            self._flush_pending()

    # -- polling backend ---------------------------------------------------------------

    def _snapshot(self) -> Dict[str, float]:
        snap: Dict[str, float] = {}
        for root, _dirs, files in os.walk(self.directory):
            for name in files:
                path = os.path.join(root, name)
                if not self._wanted(path):
                    continue
                try:
                    snap[path] = os.stat(path).st_mtime
                except OSError:
                    continue
        return snap

    def _poll_loop(self) -> None:
        prev = self._snapshot()
        while not self._stop.wait(timeout=self.poll_interval):
            cur = self._snapshot()
            for path, mtime in cur.items():
                if path not in prev:
                    self._fire("created", path)
                elif mtime != prev[path]:
                    self._fire("modified", path)
            for path in prev:
                if path not in cur:
                    self._fire("deleted", path)
            prev = cur

    # -- first-party inotify backend ---------------------------------------------------

    def _start_inotify(self) -> bool:
        """Kernel-event watching via ctypes inotify; returns False (caller
        falls back to polling) if the fd or root watch cannot be set up."""
        import ctypes
        import struct

        calls = _inotify_syscalls()
        if calls is None:
            return False
        init1, add_watch = calls
        fd = init1(0)  # blocking fd; select() provides the timeout
        if fd < 0:
            return False
        wd_to_dir: Dict[int, str] = {}

        def watch_tree(root: str) -> None:
            for dirpath, dirnames, _files in os.walk(root):
                wd = add_watch(fd, dirpath.encode(), _WATCH_MASK)
                if wd >= 0:
                    wd_to_dir[wd] = dirpath

        watch_tree(self.directory)
        if not wd_to_dir:
            os.close(fd)
            return False

        def loop() -> None:
            import select

            hdr = struct.Struct("iIII")
            try:
                while not self._stop.is_set():
                    r, _w, _x = select.select([fd], [], [], 0.25)
                    if not r:
                        continue
                    data = os.read(fd, 65536)
                    off = 0
                    while off + hdr.size <= len(data):
                        wd, mask, _cookie, nlen = hdr.unpack_from(data, off)
                        name = data[off + hdr.size: off + hdr.size + nlen]
                        off += hdr.size + nlen
                        name = name.split(b"\0", 1)[0].decode(
                            "utf-8", "replace")
                        base = wd_to_dir.get(wd)
                        if base is None or not name:
                            continue
                        path = os.path.join(base, name)
                        if mask & _IN_ISDIR:
                            if mask & (_IN_CREATE | _IN_MOVED_TO):
                                watch_tree(path)  # new subtree
                            continue
                        if not self._wanted(path):
                            continue
                        if mask & (_IN_CREATE | _IN_MOVED_TO):
                            self._fire("created", path)
                        elif mask & (_IN_CLOSE_WRITE | _IN_MODIFY):
                            self._fire("modified", path)
                        elif mask & (_IN_DELETE | _IN_MOVED_FROM):
                            self._fire("deleted", path)
            finally:
                try:
                    os.close(fd)
                except OSError:
                    pass

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return True

    # -- watchdog backend ------------------------------------------------------------------

    def _start_watchdog(self) -> None:  # pragma: no cover - optional dep
        from watchdog.events import FileSystemEventHandler  # type: ignore
        from watchdog.observers import Observer  # type: ignore

        watcher = self

        class Handler(FileSystemEventHandler):
            def on_created(self, event):
                if not event.is_directory and watcher._wanted(event.src_path):
                    watcher._fire("created", event.src_path)

            def on_modified(self, event):
                if not event.is_directory and watcher._wanted(event.src_path):
                    watcher._fire("modified", event.src_path)

            def on_deleted(self, event):
                if not event.is_directory and watcher._wanted(event.src_path):
                    watcher._fire("deleted", event.src_path)

        self._observer = Observer()
        self._observer.schedule(Handler(), self.directory, recursive=True)
        self._observer.start()


def create_auto_indexer(indexer, directory: str, **kwargs) -> FileWatcher:
    """Watcher wired to reindex the directory on any change (reference
    watcher.py:157-186)."""
    from hybridsearch_tpu_torch.text.extractor import discover_documents

    def reindex(_event: str, _path: str) -> None:
        docs = discover_documents(directory)
        if docs:
            indexer.index_documents([c for _p, c in docs], [p for p, _c in docs])

    return FileWatcher(directory, reindex, **kwargs)
