"""The load generator: a child process of its own (stdlib only), so it
never holds the server process's interpreter lock, pinned to CPUs of its
own where the run gives it some.

Reads one job as JSON on stdin: the server's port, the model, the
monotonic instants t0 (the first due time's origin) and t_close (the
window's end), the sampling options, the requests (i, due, user, text,
max_tokens) and, optionally, the CPUs to run on. One thread and one
selector loop send each request at t0 + due, whether or not earlier
ones have finished (an open loop), as one streaming /api/chat with an
X-User-ID, and read every open stream as its bytes arrive. At t_close
every open connection is shut, which cancels its request in the server;
the job ends before t_close once every request sent has ended. Prints
one JSON object on stdout: per request the send instant, the HTTP
status, every frame's arrival instant and token count, the token ids,
whether it finished and why, and the prompt tokens the server counted;
how late the sends ran against their due times; and how many streams
were still open at the close. All instants are time.monotonic(), which
the parent process shares.
"""

from __future__ import annotations

import json
import os
import selectors
import socket
import sys
import time
from typing import List, Optional, Tuple


def split_cpus(cpus: List[int]) -> Tuple[List[int], List[int]]:
    """(the server's CPUs, the load generator's): the last CPU for the
    load generator and the rest for the server, or all to both where
    there is only one."""
    cpus = sorted(cpus)
    if len(cpus) < 2:
        return cpus, cpus
    return cpus[:-1], cpus[-1:]


class _Stream:
    """One request's connection: its bytes in, parsed as an HTTP/1.1
    response with a chunked body of newline-delimited JSON frames."""

    def __init__(self, job: dict, r: dict, rec: dict):
        self.rec = rec
        body = json.dumps({
            "model": job["model"], "stream": True,
            "messages": [{"role": "user", "content": r["text"]}],
            "options": dict(job["sampling"], num_predict=r["max_tokens"])}).encode()
        head = (f"POST /api/chat HTTP/1.1\r\nHost: 127.0.0.1:{job['port']}\r\n"
                f"Content-Type: application/json\r\nX-User-ID: {r['user']}\r\n"
                f"Content-Length: {len(body)}\r\n\r\n").encode()
        self.sock = socket.create_connection(("127.0.0.1", job["port"]), timeout=30)
        self.sock.sendall(head + body)
        self.sock.setblocking(False)
        self.buf = b""
        self.status: Optional[int] = None
        self.length = -1
        self.need: Optional[int] = None  # bytes left of the current chunk
        self.text = b""

    def feed(self, data: bytes, t: float) -> bool:
        """Take bytes that arrived at `t`; True once the request has ended."""
        self.buf += data
        if self.status is None:
            end = self.buf.find(b"\r\n\r\n")
            if end < 0:
                return False
            lines = self.buf[:end].decode("latin-1").split("\r\n")
            self.buf = self.buf[end + 4:]
            self.status = self.rec["status"] = int(lines[0].split()[1])
            headers = {k.strip().lower(): v.strip() for k, v in
                       (ln.split(":", 1) for ln in lines[1:] if ":" in ln)}
            self.length = int(headers.get("content-length", -1))
            if (self.status == 200
                    and "chunked" not in headers.get("transfer-encoding", "").lower()):
                self.rec["error"] = "a stream without chunked transfer encoding"
                return True
        if self.status != 200:
            if 0 <= self.length and len(self.buf) < self.length:
                return False
            self.rec["error"] = f"HTTP {self.status}: {self.buf[:300]!r}"
            return True
        while True:
            if self.need is None:
                nl = self.buf.find(b"\r\n")
                if nl < 0:
                    return False
                size = int(self.buf[:nl].split(b";")[0], 16)
                self.buf = self.buf[nl + 2:]
                if size == 0:
                    return True  # the body ended without a done frame
                self.need = size
            if len(self.buf) < self.need + 2:
                return False
            self.text += self.buf[:self.need]
            self.buf = self.buf[self.need + 2:]
            self.need = None
            while b"\n" in self.text:
                line, self.text = self.text.split(b"\n", 1)
                if line.strip() and self._frame(json.loads(line), t):
                    return True

    def _frame(self, obj: dict, t: float) -> bool:
        rec = self.rec
        got = obj.get("token_ids") or []
        if got:
            rec["frames"].append([t, len(got)])
            rec["ids"].extend(got)
        if not obj.get("done"):
            return False
        if obj.get("error"):
            rec["error"] = f"{obj.get('done_reason')}: {obj['error']}"
        else:
            rec["done"] = True
            rec["reason"] = obj.get("done_reason")
            rec["prompt_eval_count"] = obj.get("prompt_eval_count")
            rec["t_done"] = t
        return True

    def close(self, shut: bool = False) -> None:
        if shut:
            try:
                self.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self.sock.close()


def run(job: dict) -> dict:
    reqs = job["requests"]
    results = {r["i"]: {"i": r["i"], "sent": None, "status": None, "frames": [],
                        "ids": [], "done": False, "reason": None, "error": None,
                        "prompt_eval_count": None, "late_s": None}
               for r in reqs}
    order = sorted(reqs, key=lambda r: (r["due"], r["i"]))
    sel = selectors.DefaultSelector()
    nxt = 0
    t_close = job["t_close"]
    while True:
        now = time.monotonic()
        if now >= t_close:
            break
        while nxt < len(order) and job["t0"] + order[nxt]["due"] <= now:
            r = order[nxt]
            nxt += 1
            rec = results[r["i"]]
            rec["sent"] = time.monotonic()
            rec["late_s"] = rec["sent"] - (job["t0"] + r["due"])
            try:
                st = _Stream(job, r, rec)
            except OSError as e:
                rec["error"] = f"{type(e).__name__}: {e}"
                continue
            sel.register(st.sock, selectors.EVENT_READ, st)
        if nxt >= len(order) and not sel.get_map():
            break
        wait = t_close - now
        if nxt < len(order):
            wait = min(wait, job["t0"] + order[nxt]["due"] - now)
        for key, _ in sel.select(max(0.0, wait)):
            st = key.data
            try:
                data = st.sock.recv(1 << 16)
            except BlockingIOError:
                continue
            except OSError as e:
                st.rec["error"] = f"{type(e).__name__}: {e}"
                data, ended = b"", True
            else:
                try:
                    ended = not data or st.feed(data, time.monotonic())
                except ValueError as e:
                    st.rec["error"] = f"{type(e).__name__}: {e}"
                    ended = True
            if ended:
                sel.unregister(st.sock)
                st.close()
    still_open = [key.data for key in sel.get_map().values()]
    for st in still_open:
        sel.unregister(st.sock)
        st.close(shut=True)
    sel.close()
    late = sorted(r["late_s"] for r in results.values() if r["late_s"] is not None)
    return {"results": [results[r["i"]] for r in reqs],
            "late": {"sent": len(late), "max_s": late[-1] if late else None,
                     "p95_s": late[int(0.95 * (len(late) - 1))] if late else None,
                     "mean_s": sum(late) / len(late) if late else None},
            "open_at_close": len(still_open)}


def main() -> None:
    job = json.load(sys.stdin)
    if job.get("cpus"):
        os.sched_setaffinity(0, job["cpus"])
    out = run(job)
    sys.stdout.write(json.dumps(out))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
