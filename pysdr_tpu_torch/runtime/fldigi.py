"""fldigi / pyKeyer XML-RPC integration: port discovery + counter sync.

Equivalent of the reference's `find_fldigi_port` client and the watchdog's
`sync_counters` pass (reference watchdog.py:27,382-414): multiple keyer/
fldigi instances each expose an XML-RPC server; the watchdog polls every
instance's QSO serial counter and pushes the maximum back to any instance
that has fallen behind, so all loggers stay in sync during a contest.

The port's own copy of pysdr_tpu/runtime/fldigi.py, with its imports
rewritten to pysdr_tpu_torch: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import socket
import xmlrpc.client


class FldigiClient:
    """Thin XML-RPC client for one fldigi/keyer instance.

    Method names are configurable because fldigi proper uses `main.*`
    while the reference's pyKeyer exposes bare `get_counter`/`set_counter`
    verbs."""

    def __init__(self, port: int, host: str = "127.0.0.1",
                 timeout: float = 2.0,
                 get_counter_method: str = "main.get_counter",
                 set_counter_method: str = "main.set_counter"):
        self.port = port
        self.host = host
        self._get_m = get_counter_method
        self._set_m = set_counter_method
        # timeout on THIS connection only: mutating the process-global
        # socket.setdefaulttimeout around calls raced every other
        # thread's socket creation
        class _TimeoutTransport(xmlrpc.client.Transport):
            def make_connection(self, h):
                conn = super().make_connection(h)
                conn.timeout = timeout
                return conn
        self._proxy = xmlrpc.client.ServerProxy(
            f"http://{host}:{port}/", transport=_TimeoutTransport(),
            allow_none=True)
        self._timeout = timeout

    def _call(self, dotted: str, *args):
        obj = self._proxy
        for part in dotted.split("."):
            obj = getattr(obj, part)
        return obj(*args)

    def get_counter(self) -> int:
        return int(self._call(self._get_m))

    def set_counter(self, n: int):
        self._call(self._set_m, int(n))

    # standard fldigi verbs used for frequency sync
    def get_frequency(self) -> float:
        return float(self._call("main.get_frequency"))

    def set_frequency(self, hz: float):
        self._call("main.set_frequency", float(hz))

    def alive(self) -> bool:
        try:
            self.get_counter()
            return True
        except Exception:  # noqa: BLE001 (connection/fault/protocol)
            return False


def find_fldigi_port(port_lo: int, port_hi: int, host: str = "127.0.0.1",
                     **kw) -> FldigiClient | None:
    """Probe a port range for a live XML-RPC instance (reference
    find_fldigi_port usage, watchdog.py:403)."""
    for port in range(port_lo, port_hi + 1):
        c = FldigiClient(port, host=host, **kw)
        if c.alive():
            return c
    return None


class CounterSync:
    """The watchdog sync_counters pass (reference watchdog.py:382-414):
    keep every instance's serial counter at the global maximum."""

    def __init__(self, ports, host: str = "127.0.0.1", **client_kw):
        self.ports = list(ports)
        self.host = host
        self.client_kw = client_kw
        self.clients: dict[int, FldigiClient | None] = {
            p: None for p in self.ports}
        self.counters: dict[int, int] = {p: 0 for p in self.ports}

    def sync_once(self) -> int:
        """Poll all instances, (re)connect missing ones, push the max
        counter to laggards. Returns the max counter seen."""
        max_cntr = 0
        for p in self.ports:
            c = self.clients[p]
            if c is None or not c.alive():
                c = FldigiClient(p, host=self.host, **self.client_kw)
                self.clients[p] = c if c.alive() else None
                c = self.clients[p]
            if c is None:
                continue
            try:
                cntr = c.get_counter()
            except Exception:  # noqa: BLE001
                self.clients[p] = None
                continue
            self.counters[p] = cntr
            max_cntr = max(max_cntr, cntr)
        for p in self.ports:
            c = self.clients[p]
            if c is not None and self.counters[p] < max_cntr:
                try:
                    c.set_counter(max_cntr)
                    self.counters[p] = max_cntr
                except Exception:  # noqa: BLE001
                    self.clients[p] = None
        return max_cntr
