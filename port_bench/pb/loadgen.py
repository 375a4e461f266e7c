"""Open-loop HTTP load generator, in a process of its own (no GIL shared
with the server).

    python3 port_bench/pb/loadgen.py '<json settings>'

Settings: ``port``, ``seed``, ``spec`` (the traffic mix), ``rate``,
``window`` (the measured window's seconds), ``seconds`` (how long requests
are offered, the window and any traced span after it), ``wait_s`` (how long past the
last due time an answer is waited for), ``warmup`` (requests sent before
the window, in one burst of that many plus one lone request).

It makes the pool's WAV bodies from the seed, warms the server up, prints
``{"ready": ...}`` and waits for a line ``go <t0>`` on standard input
(``t0`` on the system's monotonic clock, which both processes share).
Request i is due at t0 + its scheduled time (`traffic.schedule`); a
thread sends it then, whatever is still in flight. It prints one JSON line
per request (due and end times, HTTP status, the body of a 200) and a
last ``{"done": ...}`` line, then exits.
"""

from __future__ import annotations

import concurrent.futures
import http.client
import json
import pathlib
import sys
import threading
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from pb import traffic  # noqa: E402

MAX_IN_FLIGHT = 256


def post(port: int, body: bytes, timeout: float):
    """(status, body bytes or error text)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/v1/transcribe", body=body, headers={"Content-Type": "audio/wav"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    except (OSError, http.client.HTTPException) as err:
        return -1, repr(err).encode()
    finally:
        conn.close()


def main(settings: dict) -> int:
    spec, seed, port = settings["spec"], int(settings["seed"]), int(settings["port"])
    sr = int(spec["sample_rate"])
    bodies = {p["index"]: traffic.wav_bytes(a, sr) for p, a in traffic.recordings(seed, spec)}
    timeout = float(settings["seconds"]) + float(settings["wait_s"])
    warm = list(bodies.values())[: int(settings["warmup"])]
    with concurrent.futures.ThreadPoolExecutor(len(warm) or 1) as pool:
        statuses = [f.result()[0] for f in [pool.submit(post, port, b, timeout) for b in warm]]
    statuses.append(post(port, warm[0], timeout)[0])
    print(json.dumps({"ready": True, "warmup_statuses": statuses, "pool_s": sum(len(b) - 44 for b in bodies.values()) / 2 / sr}), flush=True)

    line = sys.stdin.readline().split()
    if not line or line[0] != "go":
        return 2
    t0 = float(line[1])
    # the window's schedule, then (a traced run) its continuation, so that
    # the window offers the same arrivals traced or not
    rate, window, span = float(settings["rate"]), float(settings["window"]), float(settings["seconds"])
    plan = traffic.schedule(spec, rate, window)
    if span > window:
        plan += [(window + t, c) for t, c in traffic.schedule(spec, rate, span - window)]
    results = [None] * len(plan)
    lock = threading.Lock()

    def send(i: int, due: float, clip: int) -> None:
        sent = time.monotonic()
        status, data = post(port, bodies[clip], timeout)
        end = time.monotonic()
        with lock:
            results[i] = {"i": i, "clip": clip, "due": due, "sent": sent, "end": end, "status": status,
                          "body": data.decode() if status == 200 else data.decode(errors="replace")[:200]}

    with concurrent.futures.ThreadPoolExecutor(MAX_IN_FLIGHT) as pool:
        futures = []
        for i, (offset, clip) in enumerate(plan):
            due = t0 + offset
            delay = due - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            futures.append(pool.submit(send, i, due, clip))
        for f in futures:
            f.result()
    for row in results:
        print(json.dumps(row))
    print(json.dumps({"done": True, "requests": len(results)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(json.loads(sys.argv[1])))
