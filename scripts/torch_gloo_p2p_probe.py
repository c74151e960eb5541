#!/usr/bin/env python3
"""Whether gloo moves CUDA tensors point to point and all to all.

    python3 scripts/torch_gloo_p2p_probe.py [--out DIR]

Two processes on ``cuda:0`` join a gloo group and try, one case per pair of
processes (a case that crashes or hangs takes only its own pair down):

- ``p2p``: ``batch_isend_irecv`` of a bf16 tensor each way (the ring hop of
  ``parallel/ring.py`` at two ranks);
- ``p2p_tagged``: two exchanges in one batch with tags 0 and 1 (the
  bidirectional hop);
- ``all_to_all``: ``all_to_all_single`` of a bf16 tensor (Ulysses);

each on CUDA tensors and, as a control, on CPU tensors.  A case passes when
the received values are the sender's, bit for bit.  It prints one line per
case and writes ``gloo_probe.json`` to ``--out`` (default
``chiprun_out/gloo_probe``).  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from dlbb_tpu_torch.utils.config import save_json  # noqa: E402

CASES = ("p2p", "p2p_tagged", "all_to_all")
TIMEOUT_S = 60


def _payload(rank: int, device: str) -> torch.Tensor:
    g = torch.Generator().manual_seed(rank)
    return torch.randn(4, 64, 128, generator=g).to(torch.bfloat16).to(device)


def _case(rank: int, case: str, device: str, init_file: str, out_dir: str) -> None:
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=Path(init_file).as_uri(), rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    peer = 1 - rank
    try:
        mine = _payload(rank, device)
        theirs = _payload(peer, "cpu")
        if case == "p2p":
            got = torch.empty_like(mine)
            for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, mine, peer),
                                               dist.P2POp(dist.irecv, got, peer)]):
                req.wait()
            ok = torch.equal(got.cpu(), theirs)
        elif case == "p2p_tagged":
            second = mine + 1
            got0, got1 = torch.empty_like(mine), torch.empty_like(mine)
            ops = [dist.P2POp(dist.isend, mine, peer, tag=0),
                   dist.P2POp(dist.irecv, got0, peer, tag=0),
                   dist.P2POp(dist.isend, second, peer, tag=1),
                   dist.P2POp(dist.irecv, got1, peer, tag=1)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            ok = torch.equal(got0.cpu(), theirs) and torch.equal(got1.cpu(), theirs + 1)
        else:
            src = torch.stack([mine, mine + 1])  # chunk j goes to rank j
            got = torch.empty_like(src)
            dist.all_to_all_single(got, src)
            want = torch.stack([_payload(0, "cpu") + rank, _payload(1, "cpu") + rank])
            ok = torch.equal(got.cpu(), want)
        if device == "cuda":
            torch.cuda.synchronize()
        verdict = "ok" if ok else "wrong values"
    except Exception as e:  # noqa: BLE001 - the probe records what gloo said
        verdict = f"{type(e).__name__}: {e}".splitlines()[0][:300]
    finally:
        dist.destroy_process_group()
    Path(out_dir, f"{rank}.txt").write_text(verdict)


def run_case(case: str, device: str) -> str:
    with tempfile.TemporaryDirectory(prefix="gloo_probe_") as tmp:
        ctx = mp.start_processes(_case, args=(case, device, os.path.join(tmp, "store"), tmp),
                                 nprocs=2, join=False, start_method="spawn")
        deadline = time.monotonic() + 2 * TIMEOUT_S
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    for p in ctx.processes:
                        p.kill()
                        p.join()
                    return f"hung for {2 * TIMEOUT_S} s, killed"
        except mp.ProcessExitedException as e:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
            return f"a rank died: {e}".splitlines()[0][:300]
        verdicts = {Path(tmp, f"{r}.txt").read_text() for r in range(2)}
        return verdicts.pop() if len(verdicts) == 1 else " / ".join(sorted(verdicts))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default="chiprun_out/gloo_probe")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_gloo_p2p_probe: no CUDA device", file=sys.stderr)
        return 1
    result = {"torch": torch.__version__, "device": torch.cuda.get_device_name(0),
              "cases": {}}
    for case in CASES:
        for device in ("cpu", "cuda"):
            verdict = run_case(case, device)
            result["cases"][f"{case}/{device}"] = verdict
            print(f"gloo {case} on {device} tensors: {verdict}", flush=True)
    save_json(result, Path(args.out) / "gloo_probe.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
