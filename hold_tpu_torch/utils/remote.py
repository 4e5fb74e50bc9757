"""Remote experiment-streaming sinks for ``Tracker.remote`` (counterpart of
hold_tpu/utils/remote.py; the reference streams to comet.ml,
common/comet_utils.py:64-172: log_dict -> experiment.log_metrics, log_img
-> experiment.log_image).  Two self-contained transports:

- ``JsonlRemote``: appends every record to a spool file (what a shipping
  sidecar would tail), one JSON object a line, flushed a record at a time.
- ``HttpRemote``: POSTs JSON batches to an endpoint from a background flush
  thread (at most ``batch_size`` records a request, never the whole
  buffer); a failure never raises into the training loop: the records stay
  buffered and are sent again, as comet's offline mode does.  Image
  records carry the image's path; with ``inline_images=True`` (or the spec
  suffix ``#inline``) they carry its bytes in base64 too.

Chosen by the ``--remote_track`` flag or the HOLD_TPU_REMOTE variable:
  HOLD_TPU_REMOTE="jsonl:/tmp/spool.jsonl"
  HOLD_TPU_REMOTE="http://host:port/ingest"
"""

from __future__ import annotations

import json
import os
import time
from typing import Any


class JsonlRemote:
    """Spool-file remote: the local stand-in for a streaming backend."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a")

    def log_metrics(self, rec: dict[str, Any], step: int) -> None:
        self._f.write(json.dumps({"kind": "metrics", "step": int(step),
                                  "data": rec}) + "\n")
        self._f.flush()

    def log_image(self, name: str, path: str, step: int) -> None:
        self._f.write(json.dumps({"kind": "image", "step": int(step),
                                  "name": name, "path": path}) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class HttpRemote:
    """POST-JSON remote with an offline buffer; never raises into training.

    Network I/O happens on a daemon flush thread so a slow or hanging
    endpoint never stalls the training loop; records are shipped in
    incremental batches (<= batch_size per POST) rather than one growing
    request body.
    """

    def __init__(self, url: str, timeout: float = 2.0, max_buffer: int = 10000,
                 batch_size: int = 256, flush_interval: float = 1.0,
                 inline_images: bool = False):
        import threading

        self.url = url
        self.timeout = timeout
        self.max_buffer = max_buffer
        self.batch_size = batch_size
        self.inline_images = inline_images
        self._buf: list[dict] = []
        self._lock = threading.Lock()
        self._send_lock = threading.Lock()  # one in-flight POST at a time
        self._wake = threading.Event()
        self._stop = False
        self._thread = threading.Thread(
            target=self._flush_loop, args=(flush_interval,), daemon=True
        )
        self._thread.start()

    def _push(self, rec: dict) -> None:
        with self._lock:
            self._buf.append(rec)
            if len(self._buf) > self.max_buffer:
                self._buf = self._buf[-self.max_buffer:]
        self._wake.set()

    def _flush_loop(self, interval: float) -> None:
        while not self._stop:
            self._wake.wait(timeout=interval)
            self._wake.clear()
            self._flush_once()

    def _flush_once(self) -> None:
        """Ship at most one batch; requeue on failure. Runs off-thread."""
        import urllib.request

        with self._send_lock:
            with self._lock:
                batch = self._buf[: self.batch_size]
            if not batch:
                return
            body = json.dumps(batch).encode()
            req = urllib.request.Request(
                self.url, data=body,
                headers={"Content-Type": "application/json"},
            )
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                    ok = 200 <= resp.status < 300
            except Exception:
                ok = False
            if ok:
                with self._lock:
                    del self._buf[: len(batch)]
        if ok and self._buf:
            self._wake.set()  # more pending; drain without waiting

    def log_metrics(self, rec: dict[str, Any], step: int) -> None:
        self._push({"kind": "metrics", "step": int(step), "t": time.time(),
                    "data": rec})

    def log_image(self, name: str, path: str, step: int) -> None:
        rec = {"kind": "image", "step": int(step), "name": name, "path": path}
        if self.inline_images:
            import base64

            try:
                with open(path, "rb") as f:
                    rec["bytes_b64"] = base64.b64encode(f.read()).decode()
            except OSError:
                pass
        self._push(rec)

    def close(self) -> None:
        # best-effort final drain on the caller's thread
        self._stop = True
        self._wake.set()
        deadline = time.time() + 2 * self.timeout
        while time.time() < deadline:
            with self._lock:
                empty = not self._buf
            if empty:
                break
            self._flush_once()


def remote_from_spec(spec: str | None):
    """"jsonl:<path>" | "http(s)://..." | "" -> sink or None."""
    spec = spec or os.environ.get("HOLD_TPU_REMOTE", "")
    if not spec:
        return None
    if spec.startswith("jsonl:"):
        return JsonlRemote(spec[len("jsonl:"):])
    if spec.startswith(("http://", "https://")):
        inline = spec.endswith("#inline")
        return HttpRemote(spec[: -len("#inline")] if inline else spec,
                          inline_images=inline)
    raise ValueError(f"unknown remote tracker spec: {spec!r}")
