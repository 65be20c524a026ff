"""The serving cell's client, a process of its own: an open loop of
`{"id": i, "cached": row}` requests to the server on one TCP connection.

    python -m satbench.drivers.client PORT SEED RATE SECONDS POOL WARM DRAIN

The schedule (`schedule`) holds RATE x SECONDS requests. Their gaps are
the exponential distribution's quantiles at (i + 1/2) / n, which sum to
about the window, shuffled by the seed, so that every seed sends the same
gaps (a Poisson process's, in a seeded order) and the same number of
requests; each request names a pool row drawn from the seed. The client
first sends WARM requests one at a time, waiting for each reply, then
prints "ready" and waits for a line on its standard input. It then sends
each request when it is due, whatever has been answered, reads the
replies on a second thread, and once every request is answered or DRAIN
seconds have passed since the last was due, prints one JSON line a
request: id, row, due, sent and answered times (seconds from the start,
answered null when no reply came) and the reply."""

from __future__ import annotations

import json
import math
import random
import socket
import sys
import threading
import time


def schedule(seed: int, rate: float, seconds: float, pool: int):
    """[(due seconds, pool row)] of the window, in order of due time."""
    n = max(1, round(rate * seconds))
    gaps = [-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]
    rng = random.Random(seed)
    rng.shuffle(gaps)
    out, t = [], 0.0
    for g in gaps:
        t += g
        out.append((t, rng.randrange(pool)))
    return out


class Connection:
    """One socket; replies by id, with the time each came."""

    def __init__(self, port: int):
        self.sock = socket.create_connection(("127.0.0.1", port))
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.replies = {}
        self.cond = threading.Condition()
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self) -> None:
        buf = b""
        while True:
            try:
                chunk = self.sock.recv(1 << 16)
            except OSError:
                return
            if not chunk:
                return
            buf += chunk
            now = time.perf_counter()
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                reply = json.loads(line)
                with self.cond:
                    self.replies[reply.get("id")] = (now, reply)
                    self.cond.notify_all()

    def send(self, rid, row: int) -> None:
        self.sock.sendall((json.dumps({"id": rid, "cached": row})
                           + "\n").encode())

    def wait(self, ids, until: float) -> None:
        with self.cond:
            while not all(i in self.replies for i in ids):
                left = until - time.perf_counter()
                if left <= 0:
                    return
                self.cond.wait(left)


def main(argv) -> int:
    port, seed = int(argv[0]), int(argv[1])
    rate, seconds = float(argv[2]), float(argv[3])
    pool, warm, drain = int(argv[4]), int(argv[5]), float(argv[6])
    conn = Connection(port)
    for i in range(warm):
        conn.send(f"w{i}", i % pool)
        conn.wait([f"w{i}"], time.perf_counter() + 120)
    print("ready", flush=True)
    sys.stdin.readline()
    plan = schedule(seed, rate, seconds, pool)
    sent = []
    t0 = time.perf_counter()
    for i, (due, row) in enumerate(plan):
        wait = t0 + due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        sent.append(time.perf_counter() - t0)
        conn.send(i, row)
    conn.wait(range(len(plan)), t0 + plan[-1][0] + drain)
    with conn.cond:
        replies = dict(conn.replies)
    for i, (due, row) in enumerate(plan):
        got = replies.get(i)
        print(json.dumps({"id": i, "row": row, "due": due, "sent": sent[i],
                          "answered": None if got is None else got[0] - t0,
                          "reply": None if got is None else got[1]}))
    conn.sock.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
