"""The benchmark's own client of the port's apiserver: plain HTTP/1.1
and JSON, so that what the client sees does not move when the program's
client does.  The routes are the apiserver's
(``kwok_tpu_torch/cluster/apiserver.py``): ``/r/<plural>`` for objects,
``?watch=1&resourceVersion=N`` for a newline-delimited JSON watch,
``/stats`` for the resourceVersion, ``/metrics`` for samples.

``Watch`` and ``scrape`` are copied from ``chip_smoke.py``'s
``WatchCount`` and ``scrape`` (at the commit that added this benchmark)
onto this client, with each event stamped with the time the client
received it; its ``ClusterView`` became ``drivers/kwokctl_stream.View``.
"""

from __future__ import annotations

import http.client
import json
import socket
import threading
import time
from typing import Callable, Dict, Optional, Tuple
from urllib.parse import urlencode, urlsplit

from kwokbench.promtext import iter_samples


class ApiError(RuntimeError):
    def __init__(self, status: int, body: str):
        super().__init__(f"HTTP {status}: {body[:300]}")
        self.status = status


class Api:
    """One keep-alive connection per thread to one apiserver."""

    def __init__(self, url: str, timeout: float = 30.0):
        parts = urlsplit(url)
        self.host, self.port = parts.hostname, parts.port or 80
        self.timeout = timeout
        self._local = threading.local()

    def _connect(self, timeout: Optional[float]) -> http.client.HTTPConnection:
        conn = http.client.HTTPConnection(self.host, self.port, timeout=timeout)
        conn.connect()
        conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return conn

    def request(self, method: str, path: str, body=None) -> Tuple[int, dict]:
        data = None if body is None else json.dumps(body).encode()
        headers = {"Content-Type": "application/json"} if data is not None else {}
        for attempt in (0, 1):
            conn = getattr(self._local, "conn", None)
            if conn is None:
                conn = self._local.conn = self._connect(self.timeout)
            try:
                conn.request(method, path, body=data, headers=headers)
                resp = conn.getresponse()
                raw = resp.read()
                break
            except (OSError, http.client.HTTPException):
                conn.close()
                self._local.conn = None
                if attempt:
                    raise
        payload = json.loads(raw) if raw else {}
        if resp.status >= 400:
            raise ApiError(resp.status, raw.decode(errors="replace"))
        return resp.status, payload

    @staticmethod
    def path(plural: str, name: Optional[str] = None, **query) -> str:
        q = {k: v for k, v in query.items() if v is not None}
        return f"/r/{plural}" + (f"/{name}" if name else "") + (f"?{urlencode(q)}" if q else "")

    def resource_version(self) -> int:
        return int(self.request("GET", "/stats")[1]["resourceVersion"])

    def list(self, plural: str, namespace: Optional[str] = None) -> Tuple[list, int]:
        _, data = self.request("GET", self.path(plural, namespace=namespace))
        return data.get("items", []), int(data.get("resourceVersion", 0))

    def create(self, plural: str, obj: dict, namespace: Optional[str] = None) -> dict:
        return self.request("POST", self.path(plural, namespace=namespace), obj)[1]

    def delete(self, plural: str, name: str, namespace: Optional[str] = None) -> dict:
        return self.request("DELETE", self.path(plural, name, namespace=namespace))[1]


class Watch(threading.Thread):
    """A watch of ``plural`` from ``since_rv``: each event is handed to
    ``on_event(type, obj, t)`` on this thread, ``t`` the
    ``time.perf_counter()`` at which its line arrived.  ``ended`` is set
    when the stream ends before ``stop``."""

    def __init__(self, api: Api, plural: str, since_rv: int, on_event: Callable,
                 namespace: Optional[str] = None):
        super().__init__(daemon=True, name=f"kwokbench-watch-{plural}")
        self.conn = api._connect(None)
        self.conn.request("GET", api.path(plural, namespace=namespace, watch="1",
                                          resourceVersion=str(since_rv)))
        self.resp = self.conn.getresponse()
        if self.resp.status >= 400:
            raise ApiError(self.resp.status, self.resp.read().decode(errors="replace"))
        self.on_event = on_event
        self.stopping = False
        self.ended = False

    def run(self):
        try:
            while True:
                line = self.resp.readline()
                if not line:
                    break
                t = time.perf_counter()
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if ev.get("type") in ("ADDED", "MODIFIED", "DELETED"):
                    self.on_event(ev["type"], ev["object"], t)
        except (OSError, http.client.HTTPException, ValueError):
            pass
        self.ended = not self.stopping

    def stop(self):
        self.stopping = True
        try:
            self.conn.sock and self.conn.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.conn.close()
        self.join(timeout=10)


def scrape(url: str) -> Dict[tuple, float]:
    """A ``/metrics`` page: {(name, sorted labels): value}."""
    parts = urlsplit(url)
    conn = http.client.HTTPConnection(parts.hostname, parts.port or 80, timeout=30)
    try:
        conn.request("GET", parts.path or "/metrics")
        text = conn.getresponse().read().decode()
    finally:
        conn.close()
    return {(name, tuple(sorted(labels.items()))): v for name, labels, v in iter_samples(text)}


def family_sum(samples: dict, name: str) -> float:
    """The sum of every sample of ``name`` whatever its labels."""
    return sum(v for (n, _), v in samples.items() if n == name)
