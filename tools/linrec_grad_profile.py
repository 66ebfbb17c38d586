"""Time ``linear_recurrence``'s backward on one CUDA card, kernel by kernel.

    python3 tools/linrec_grad_profile.py [--src DIR] [--label NAME]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
one call on the card can time two trees in turns: unpack the other one with
``git archive`` into a directory ``.gitignore`` lists and pass its ``src``.
It uses only what both trees have: ``core.primitives.linear_recurrence``
and ``kernels.ops.LinearRecurrence.backward``.

For each case of ``CASES`` (B, T, C, with h0, reverse, dh's dtype), float32
a and b, it prints one ``[linrec_grad]`` JSON line:

* ``ms`` -- one ``LinearRecurrence.backward`` call (the saved a, h and h0
  handed to it directly), mean of back-to-back calls between CUDA events,
  host included;
* ``device_ms`` and ``kernels`` -- torch.profiler's device time a call, in
  all and by kernel name (the first 70 characters), with each name's
  launches a call;
* ``autograd_ms`` -- ``torch.autograd.grad`` through the forward's graph
  (float32 dh only: autograd hands the backward h's own dtype);
* ``bound_ms`` -- a, h and dh read once, da and db written once (h0 read
  and dh0 written where given) at 3.35 TB/s.

The card's name and power limit come first, from nvidia-smi.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import types

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32, BF16 = torch.float32, torch.bfloat16
# recurrentgemma-2b's RG-LRU at 4,096 tokens with and without h0 and B = 3;
# T on each side of the short form's limit (64) and of the long-T path's
# (128, at B C <= 1,024); xlstm-1.3b's two chunk states at 1,024 tokens
# (16 chunks); the long-T path; reverse recurrences; a bfloat16 dh.
CASES = ((1, 4096, 2560, False, False, F32), (1, 4096, 2560, True, False, F32),
         (3, 4096, 2560, True, False, F32), (3, 63, 2560, True, False, F32),
         (3, 65, 2560, False, False, F32),
         (1, 16, 4 * 1024 * 1024, False, False, F32),
         (1, 16, 4096, False, False, F32), (2, 4096, 256, True, False, F32),
         (2, 127, 256, False, False, F32), (2, 128, 256, True, True, F32),
         (1, 4096, 2560, True, True, F32), (1, 16, 4096, True, True, F32),
         (1, 4096, 2560, False, False, BF16))


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, calls: int = 5) -> tuple[float, dict]:
    """Device ms a call, in all and by kernel name (ms and launches)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by[e.name[:70]][0] += e.time_range.elapsed_us() / 1e3 / calls
            by[e.name[:70]][1] += 1
    return sum(v[0] for v in by.values()), {
        k: {"ms": v[0], "launches": v[1] / calls} for k, v in by.items()}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip() if out.returncode == 0 else "nvidia-smi failed"


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    p.add_argument("--label", default="tree")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("linrec_grad_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.core import primitives as forge
    from repro_torch.core.layout import Batched
    from repro_torch.kernels import ops

    print(f"[linrec_grad] {args.label}: {card_line()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, T, C, with_h0, reverse, dh_dtype in CASES:
        a = torch.empty(B, T, C, device="cuda").uniform_(0.9, 0.999,
                                                         generator=gen)
        b = torch.randn(B, T, C, generator=gen, device="cuda")
        h0 = torch.randn(B, C, generator=gen, device="cuda") \
            if with_h0 else None
        dh = torch.randn(B, T, C, generator=gen, device="cuda").to(dh_dtype)
        with torch.no_grad():
            h = forge.linear_recurrence(a, b, h0, reverse=reverse,
                                        layout=Batched())
        ctx = types.SimpleNamespace(saved_tensors=(a, h, h0), reverse=reverse)

        def backward():
            return ops.LinearRecurrence.backward(ctx, dh)

        elems = B * T * C
        row = {"tree": args.label, "shape": [B, T, C], "h0": with_h0,
               "reverse": reverse, "dh": str(dh_dtype).split(".")[1],
               "bound_ms": ((4 * 4 + dh.element_size()) * elems
                            + 8 * B * C * with_h0) / HBM_BYTES_PER_S * 1e3}
        reps = 20 if elems >= 1 << 24 else 100
        row["ms"] = time_ms(backward, reps)
        row["device_ms"], row["kernels"] = kernel_ms(backward)
        if dh_dtype == F32:
            ins = [x.clone().requires_grad_() for x in (a, b, h0)
                   if x is not None]
            out = forge.linear_recurrence(*ins[:2], *ins[2:], reverse=reverse,
                                          layout=Batched())
            row["autograd_ms"] = time_ms(lambda: torch.autograd.grad(
                out, ins, dh, retain_graph=True), reps)
            del ins, out
        print("[linrec_grad] " + json.dumps(row), flush=True)
        del a, b, h0, dh, h, ctx
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
