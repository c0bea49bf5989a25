#!/usr/bin/env python3
"""Which torch.distributed operations the gloo backend takes on CUDA
tensors, on this machine's torch: pairs of processes on card 0 try each
operation on device memory and on host memory and print one JSON line
per operation and device (``ok``: ran and gave the right answer; else
the error, or the signal that ended the pair).  Each operation on the
card runs in a pair of its own, since a refusal may abort the process.
``parallel/collective.py`` stages every gloo operation outside
``GLOO_DEVICE_OPS`` through pinned host memory; this script is how that
set was checked.  Run on the card:

    python3 tools/gloo_device_ops.py
"""

import json
import os
import socket
import subprocess
import sys

OPS = ("all_reduce", "broadcast", "all_gather", "all_to_all_single",
       "reduce_scatter", "reduce_scatter_tensor", "send_recv")


def child(rank: int, port: int, dev: str, ops) -> None:
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)

    def run(op):
        x = torch.arange(4.0, device=dev) + rank
        if op == "all_reduce":
            dist.all_reduce(x)
            return x.tolist() == [1.0, 3.0, 5.0, 7.0]
        if op == "broadcast":
            dist.broadcast(x, src=0)
            return x.tolist() == [0.0, 1.0, 2.0, 3.0]
        if op == "all_gather":
            parts = [torch.empty_like(x) for _ in range(2)]
            dist.all_gather(parts, x)
            return parts[1].tolist() == [1.0, 2.0, 3.0, 4.0]
        if op == "all_to_all_single":
            y = torch.empty_like(x)
            dist.all_to_all_single(y, x)
            return y.tolist() == ([0.0, 1.0, 1.0, 2.0] if rank == 0
                                  else [2.0, 3.0, 3.0, 4.0])
        if op in ("reduce_scatter", "reduce_scatter_tensor"):
            y = torch.empty(2, device=dev)
            if op == "reduce_scatter":
                dist.reduce_scatter(y, list(x.chunk(2)))
            else:
                dist.reduce_scatter_tensor(y, x)
            return y.tolist() == ([1.0, 3.0] if rank == 0 else [5.0, 7.0])
        y = torch.empty_like(x)  # send_recv
        for work in (dist.isend(x, 1 - rank), dist.irecv(y, 1 - rank)):
            work.wait()
        return y.tolist() == [float(i + 1 - rank) for i in range(4)]

    for op in ops:
        try:
            ok = bool(run(op))
        except Exception as e:  # a probe: record what refuses
            ok = f"{type(e).__name__}: {str(e)[:160]}"
        if rank == 0:
            print(json.dumps({"op": op, "device": dev, "ok": ok}),
                  flush=True)
    dist.destroy_process_group()


def pair(dev: str, ops) -> list:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    kids = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              str(r), str(port), dev, ",".join(ops)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True) for r in range(2)]
    outs = [k.communicate(timeout=300) for k in kids]
    rows = [json.loads(line) for line in outs[0][0].splitlines() if line]
    seen = {r["op"] for r in rows}
    for op in ops:
        if op not in seen:
            rows.append({"op": op, "device": dev,
                         "ok": f"the pair ended with {kids[0].returncode}, "
                               f"{kids[1].returncode}: "
                               f"{outs[0][1].strip()[-200:]}"})
    return rows


def main() -> int:
    if len(sys.argv) == 5:
        child(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
              sys.argv[4].split(","))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("gloo_device_ops: no CUDA device", file=sys.stderr)
        return 1
    rows = pair("cpu", OPS)
    for op in OPS:
        rows += pair("cuda", (op,))
    for row in rows:
        print(json.dumps(row))
    print(json.dumps({"torch": torch.__version__,
                      "gloo_takes_cuda": sorted(
                          r["op"] for r in rows
                          if r["device"] == "cuda" and r["ok"] is True)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
