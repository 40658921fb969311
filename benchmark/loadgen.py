"""Open-loop HTTP load generator, run as its own process (stdlib only).

It reads phases from its standard input and answers each on its standard
output, both as pickles between this process and the harness that started
it. A phase is ``{"host", "port", "start", "requests": [(due_s, body)],
"timeout_s"}``: each body is POSTed to ``/classify`` on a new connection
when ``start + due_s`` comes (``time.monotonic``, the system-wide clock),
whether or not earlier requests were answered. The answer is one record
per request, ``(due, sent, done, status, body)`` in absolute monotonic
seconds (``status`` -1 and ``done`` None where no answer came within
``timeout_s`` of the last due time), and how late the sends ran.

    python3 benchmark/loadgen.py   # driven by benchmark/harness.py
"""

from __future__ import annotations

import asyncio
import pickle
import sys
import time


async def _one(host: str, port: int, due: float, body: bytes, deadline: float):
    delay = due - time.monotonic()
    if delay > 0:
        await asyncio.sleep(delay)
    sent = time.monotonic()
    head = (f"POST /classify HTTP/1.1\r\nHost: {host}:{port}\r\nContent-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n").encode()
    writer = None
    try:
        reader, writer = await asyncio.wait_for(asyncio.open_connection(host, port), deadline - sent)
        writer.write(head + body)
        await writer.drain()
        data = await asyncio.wait_for(reader.read(), max(0.001, deadline - time.monotonic()))
        done = time.monotonic()
        status_line, _, rest = data.partition(b"\r\n")
        status = int(status_line.split()[1])
        _, _, payload = rest.partition(b"\r\n\r\n")
        return due, sent, done, status, payload
    except (OSError, asyncio.TimeoutError, ValueError, IndexError):
        return due, sent, None, -1, b""
    finally:
        if writer is not None:
            writer.close()


async def _phase(p: dict):
    start = p["start"]
    last = start + max((d for d, _ in p["requests"]), default=0.0)
    deadline = last + p["timeout_s"]
    tasks = [asyncio.ensure_future(_one(p["host"], p["port"], start + d, b, deadline)) for d, b in p["requests"]]
    return await asyncio.gather(*tasks)


def main() -> int:
    inp, out = sys.stdin.buffer, sys.stdout.buffer
    while True:
        try:
            phase = pickle.load(inp)
        except EOFError:
            return 0
        records = asyncio.run(_phase(phase))
        late = sorted(s - d for d, s, _, _, _ in records)
        summary = {
            "late_max_s": late[-1] if late else 0.0,
            "late_p99_s": late[min(len(late) - 1, int(0.99 * len(late)))] if late else 0.0,
        }
        pickle.dump({"records": records, "late": summary}, out)
        out.flush()


if __name__ == "__main__":
    sys.exit(main())
