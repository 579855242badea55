"""Show that a port this host's own client connections used moments ago
can refuse a listener.

A client that closes its end first (http.client's `read(); close()`)
leaves its local port in TIME_WAIT for a minute, and a server's bind to
that port fails with EADDRINUSE even with SO_REUSEADDR, since the client
socket never set it. A script that picks a free port, keeps polling
servers, and hands the port to a server process later can therefore see
that server exit at start-up; `chip_smoke.py` lets each server bind
port 0 and reads the port off its log instead.

    python scripts/time_wait_bind_probe.py [--requests 2000] [--tried 200]

Prints one JSON line: the requests made, the recently used client ports
tried, how many of them refused a listener, and the host's ephemeral
port range.
"""
from __future__ import annotations

import argparse
import http.client
import http.server
import json
import socket
import threading


class _Handler(http.server.BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 — http.server's name
        body = b'{"ok": true}'
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # noqa: ARG002
        pass


def probe(requests: int, tried: int) -> dict:
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    used = []
    try:
        for _ in range(requests):
            c = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                           timeout=10)
            c.request("GET", "/")
            used.append(c.sock.getsockname()[1])
            c.getresponse().read()
            c.close()
    finally:
        srv.shutdown()
        srv.server_close()
    refused = 0
    for port in used[-tried:]:
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("127.0.0.1", port))
            s.listen()
        except OSError:
            refused += 1
        finally:
            s.close()
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            port_range = [int(x) for x in f.read().split()]
    except OSError:
        port_range = None
    return {"requests": requests, "client_ports_tried": len(used[-tried:]),
            "refused_a_listener": refused, "ephemeral_range": port_range}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=2000)
    ap.add_argument("--tried", type=int, default=200)
    args = ap.parse_args(argv)
    print(json.dumps(probe(args.requests, args.tried)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
