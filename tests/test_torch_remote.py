"""hold_tpu_torch.utils.remote and the tracker's remote sink against the JAX
package's: the JSONL spool (the same records, field for field, but the
wall-clock times), the HTTP sink against a local server (the same batches
arrive) with its offline buffer, ``remote_from_spec`` (the spec forms, the
HOLD_TPU_REMOTE variable, the refusal), and the inactive tracker of a rank
other than 0.  The server tests run under a deadline: past it the server
is shut down and the test fails.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

from hold_tpu.utils import logger as jlogger
from hold_tpu.utils import remote as jremote
from hold_tpu_torch.utils import logger, remote

DEADLINE_S = 30.0


def _strip_times(rec):
    rec = dict(rec)
    rec.pop("t", None)
    if "data" in rec:
        rec["data"] = {k: v for k, v in rec["data"].items() if k != "t"}
    return rec


def _drive(mod, log_root, spool):
    tr = mod.Tracker(str(log_root), exp_key="rem000001", remote=f"jsonl:{spool}")
    tr.log_dict({"loss": 1.5, "psnr": 20.0, "skip": "text"}, step=3, epoch=0)
    p = tr.log_image("val", np.zeros((4, 4, 3), np.float32), step=3)
    tr.close()
    with open(spool) as f:
        return [json.loads(line) for line in f], p


def test_jsonl_sink_writes_the_jax_records(tmp_path):
    got, gp = _drive(logger, tmp_path / "port", tmp_path / "port.jsonl")
    want, wp = _drive(jlogger, tmp_path / "jax", tmp_path / "jax.jsonl")
    assert [r["kind"] for r in got] == ["metrics", "image"]
    assert [_strip_times(r) for r in got] == [
        _strip_times({**r, "path": gp} if r["kind"] == "image" else r) for r in want]
    assert got[0]["data"]["loss"] == 1.5 and "skip" not in got[0]["data"]


def test_muted_tracker_streams_nothing(tmp_path):
    spool = tmp_path / "s.jsonl"
    tr = logger.Tracker(str(tmp_path), exp_key="m", remote=f"jsonl:{spool}", mute=True)
    tr.log_dict({"loss": 1.0}, step=0)
    tr.close()
    assert spool.read_text() == ""
    assert json.loads((tmp_path / "m" / "metrics.jsonl").read_text())["loss"] == 1.0


def test_inactive_tracker_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("HOLD_TPU_REMOTE", f"jsonl:{tmp_path / 'spool.jsonl'}")
    tr = logger.Tracker(str(tmp_path / "logs"), exp_key="r1", args={"a": 1}, active=False)
    tr.log_dict({"loss": 1.0}, step=0)
    p = tr.log_image("val", np.zeros((2, 2, 3)), step=0)
    tr.close()
    assert tr.remote is None and p.endswith("val_000000000.png")
    assert not (tmp_path / "logs").exists() and not (tmp_path / "spool.jsonl").exists()


def test_remote_track_argument_and_environment(tmp_path, monkeypatch):
    spool = tmp_path / "a.jsonl"
    tr = logger.Tracker(str(tmp_path), exp_key="k", args={"remote_track": f"jsonl:{spool}"})
    assert isinstance(tr.remote, remote.JsonlRemote)
    tr.close()
    monkeypatch.setenv("HOLD_TPU_REMOTE", f"jsonl:{tmp_path / 'env.jsonl'}")
    tr = logger.Tracker(str(tmp_path), exp_key="k2")
    tr.log_dict({"loss": 2.0}, step=1)
    tr.close()
    assert json.loads((tmp_path / "env.jsonl").read_text())["data"]["loss"] == 2.0


class _Server:
    """A local HTTP ingest endpoint collecting the batches it receives."""

    def __init__(self):
        self.batches = []
        batches = self.batches

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers["Content-Length"])
                batches.append(json.loads(self.rfile.read(n)))
                self.send_response(200)
                self.end_headers()

            def log_message(self, *a):
                pass

        self.srv = HTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}/ingest"
        self.thread = threading.Thread(target=self.srv.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *a):
        self.srv.shutdown()
        self.srv.server_close()
        return False


def _within(seconds, fn):
    """Run ``fn`` on a thread; fail if it is not done within ``seconds``."""
    out, err = [], []

    def run():
        try:
            out.append(fn())
        except BaseException as e:  # re-raised here
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        pytest.fail(f"not done within {seconds} s")
    if err:
        raise err[0]
    return out[0]


def _http_records(mod, url, image_path):
    sink = mod.HttpRemote(url, timeout=2.0, batch_size=2)
    with sink._send_lock:  # every record queued before the flush thread can POST
        for i in range(3):
            sink.log_metrics({"loss": float(i)}, step=i)
        sink.log_image("panel", image_path, step=3)
    sink.close()
    return sink


@pytest.mark.parametrize("inline", [False, True], ids=["path", "inline"])
def test_http_sink_round_trip_matches_jax(tmp_path, inline):
    img = tmp_path / "p.png"
    img.write_bytes(b"\x89PNG-bytes")

    def run():
        got = {}
        for name, mod in (("port", remote), ("jax", jremote)):
            with _Server() as srv:
                spec = srv.url + ("#inline" if inline else "")
                sink = mod.remote_from_spec(spec)
                assert isinstance(sink, mod.HttpRemote) and sink.inline_images == inline
                # both records queued before the flush thread can POST, so
                # both packages batch them the same way
                with sink._send_lock:
                    sink.log_metrics({"loss": 1.0}, step=1)
                    sink.log_image("panel", str(img), step=1)
                sink.close()
                _http_records(mod, srv.url, str(img))
                got[name] = [[_strip_times(r) for r in b] for b in srv.batches]
        return got

    got = _within(DEADLINE_S, run)
    assert got["port"] == got["jax"]
    recs = [r for b in got["port"] for r in b]
    assert [r["kind"] for r in recs] == ["metrics", "image", "metrics", "metrics", "metrics",
                                         "image"]
    assert ("bytes_b64" in recs[1]) == inline
    assert max(len(b) for b in got["port"]) <= 256


def test_http_sink_buffers_offline_and_never_raises():
    def run():
        dead = remote.HttpRemote("http://127.0.0.1:1/ingest", timeout=0.2, max_buffer=3)
        for i in range(5):
            dead.log_metrics({"loss": float(i)}, step=i)
        dead.close()
        return [r["step"] for r in dead._buf]

    # the oldest dropped past max_buffer, the rest kept for a later flush
    assert _within(DEADLINE_S, run) == [2, 3, 4]


def test_remote_from_spec_matches_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("HOLD_TPU_REMOTE", raising=False)
    for mod in (remote, jremote):
        assert mod.remote_from_spec("") is None
        assert mod.remote_from_spec(None) is None
        assert isinstance(mod.remote_from_spec(f"jsonl:{tmp_path}/x.jsonl"), mod.JsonlRemote)
        h = mod.remote_from_spec("https://127.0.0.1:1/i#inline")
        assert isinstance(h, mod.HttpRemote) and h.inline_images
        assert h.url == "https://127.0.0.1:1/i"
        h.close()
        with pytest.raises(ValueError):
            mod.remote_from_spec("ftp://nope")
    monkeypatch.setenv("HOLD_TPU_REMOTE", f"jsonl:{tmp_path}/env.jsonl")
    assert isinstance(remote.remote_from_spec(""), remote.JsonlRemote)
