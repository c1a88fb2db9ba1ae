"""Shared helpers for the REST parity tests: run a live program (one whose
``pw.run()`` a REST connector keeps open) on a thread, find its web
server's port, send it requests, and stop it — every wait bounded.

Both packages' programs stop the JAX way: ``c._stop.set(); c.close()`` on
each connector of the run. The port's web server then stops with its last
connector; the JAX package's keeps its serving thread (a daemon)."""

import json
import threading
import time
import urllib.error
import urllib.request

from tests.torch_engine import PW

START_TIMEOUT, REQUEST_TIMEOUT, JOIN_TIMEOUT = 30.0, 60.0, 30.0


def request(url: str, payload=None, method: str | None = None, timeout: float = REQUEST_TIMEOUT):
    """(status, body bytes, headers) of one request; a JSON ``payload`` is
    POSTed, none is a GET."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method=method or ("GET" if data is None
                                                                  else "POST"),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read(), dict(exc.headers)


def post_json(url: str, payload: dict, timeout: float = REQUEST_TIMEOUT):
    status, body, _ = request(url, payload, timeout=timeout)
    assert status == 200, (status, body)
    return json.loads(body)


class LiveRun:
    """``pw.run()`` of the current graph on a thread. ``webserver`` is the
    server the program's REST connectors share; ``stop()`` stops every
    connector of the run and joins the thread."""

    def __init__(self, pkg: str, webserver=None, run=None):
        pw = PW[pkg]
        self.pkg = pkg
        self.connectors = list(pw.G.connectors)
        rest_cls = _rest_connector_cls(pkg)
        rests = [c for c in self.connectors if isinstance(c, rest_cls)]
        self.webserver = webserver or rests[0].webserver
        self.error: BaseException | None = None

        def body():
            try:
                (run or pw.run)()
            except BaseException as exc:  # noqa: BLE001 - reported by stop()
                self.error = exc

        self.thread = threading.Thread(target=body, daemon=True, name=f"LiveRun:{pkg}")
        self.thread.start()
        deadline = time.monotonic() + START_TIMEOUT
        while not self._routes_up():
            assert time.monotonic() < deadline, "the REST routes never registered"
            assert self.thread.is_alive(), f"pw.run ended early: {self.error!r}"
            time.sleep(0.02)

    def _routes_up(self) -> bool:
        ws = self.webserver
        if not ws._started.is_set():
            return False
        want = {c.route for c in self.connectors if hasattr(c, "route")}
        return want <= {route for _m, route in ws._routes}

    @property
    def base(self) -> str:
        return f"http://127.0.0.1:{self.webserver.port}"

    def stop(self) -> None:
        for c in self.connectors:
            c._stop.set()
            c.close()
        self.thread.join(JOIN_TIMEOUT)
        assert not self.thread.is_alive(), "pw.run did not end after its connectors stopped"
        assert self.error is None, self.error


def _rest_connector_cls(pkg):
    if pkg == "torch":
        from pathway_tpu_torch.io.http import _RestConnector
    else:
        from pathway_tpu.io.http import _RestConnector
    return _RestConnector
