"""Time one large RPC frame against the same bytes in ranged frames, between
two processes over loopback, on the port's native runtime: the probe behind
``ParamClient.pull_blob``'s ranges.

    python3 tools/torch_frame_probe.py [GiB]        # default 3.5

A server process holds one buffer of GiB; this process fetches it whole in
one call (twice), then in ranges of 64 MiB x 1, 64 MiB x 4, 16 MiB x 8 and
256 MiB x 2 connections, then whole once more. Each line gives the wall
time, the rate, and the CPU seconds this process and the server spent.
Needs no card.
"""

import os
import resource
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from brpc_tpu_torch import runtime  # noqa: E402

GIB = 1 << 30
RANGES = ((64, 1), (64, 4), (16, 8), (256, 2))  # (MiB, connections)


def cpu_s() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def serve(n: int) -> None:
    """The server process: one buffer, whole or by range, and its CPU
    time; prints its port and serves until stdin closes."""
    blob = bytearray(n)
    view = memoryview(blob)
    srv = runtime.Server()
    srv.add_method("Probe", "all", lambda req: blob)
    srv.add_method("Probe", "range", lambda req: view[
        int.from_bytes(req[:8], "little"):
        int.from_bytes(req[:8], "little") + int.from_bytes(req[8:], "little")])
    srv.add_method("Probe", "cpu", lambda req: str(cpu_s()).encode())
    print(srv.start(0), flush=True)
    sys.stdin.read()
    srv.stop()
    srv.close()


def fetch_ranges(addr: str, n: int, size: int, conns: int) -> None:
    offsets = list(range(0, n, size))
    out = bytearray(n)

    def work(k: int) -> None:
        ch = runtime.Channel(addr, timeout_ms=600_000)
        try:
            for off in offsets[k::conns]:
                ln = min(size, n - off)
                buf = ch.call_view("Probe", "range", off.to_bytes(8, "little")
                                   + ln.to_bytes(8, "little"))
                out[off:off + ln] = buf.view
                buf.release()
        finally:
            ch.close()

    threads = [threading.Thread(target=work, args=(k,))
               for k in range(conns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def main() -> None:
    n = int(float(sys.argv[1] if len(sys.argv) > 1 else 3.5) * GIB)
    runtime.set_max_body_size(1 << 32)
    server = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--serve", str(n)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    addr = f"127.0.0.1:{int(server.stdout.readline())}"
    ch = runtime.Channel(addr, timeout_ms=600_000)

    def timed(label: str, fn) -> None:
        c0, s0, t0 = cpu_s(), float(ch.call("Probe", "cpu")), time.monotonic()
        fn()
        dt = time.monotonic() - t0
        s1 = float(ch.call("Probe", "cpu"))
        print(f"{label}: {dt:.2f} s, {n / dt / 1e9:.2f} GB/s; client cpu "
              f"{cpu_s() - c0:.2f} s, server cpu {s1 - s0:.2f} s",
              flush=True)

    def whole() -> None:
        ch.call_view("Probe", "all").release()

    try:
        for i in range(2):
            timed(f"one {n / GIB:g} GiB frame #{i}", whole)
        for mib, conns in RANGES:
            timed(f"{mib} MiB frames over {conns} connections",
                  lambda: fetch_ranges(addr, n, mib << 20, conns))
        timed(f"one {n / GIB:g} GiB frame again", whole)
    finally:
        ch.close()
        server.stdin.close()
        server.wait(timeout=60)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--serve":
        runtime.set_max_body_size(1 << 32)
        serve(int(sys.argv[2]))
    else:
        main()
