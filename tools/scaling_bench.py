"""Distributed scaling measurement for the BA solver.

Measures `dist_local_ba_lines` at mesh sizes 1, 2, 4, 8 (as many as the
process has devices) and reports, per mesh size, one JSON row with:

  * wall-clock per solve on the devices the process runs on (virtual CPU
    devices give no wall efficiency; only real cards do);
  * per-device FLOPs from XLA's cost analysis of the compiled executable
    (the hardware-independent signal: sharding must halve per-device
    work at each doubling);
  * total all-reduce bytes from the compiled HLO (the line-sharded
    layout's contract: one (6C x 6C) camera-system psum + small scalars
    per LM iteration, independent of lines/observations).

Usage: python tools/scaling_bench.py [--obs 16384] [--cams 64]
       [--lines 512] [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_HLO_SIZES = {"f64": 8, "f32": 4, "u32": 4, "s32": 4, "pred": 1,
              "u8": 1, "f16": 2, "bf16": 2}


def allreduce_bytes_of(txt: str) -> int:
    """Total bytes of all all-reduce result shapes in optimized HLO
    (same parse as tests/test_distributed.py's collective-bytes guard)."""
    total = 0
    for line in txt.splitlines():
        if "all-reduce(" not in line and "all-reduce-start(" not in line:
            continue
        head = line.split("=", 1)[0] + "=" + \
            line.split("=", 1)[1].split("all-reduce")[0]
        for m in re.finditer(r"(\w+)\[([\d,]*)\]", head):
            dt, dims = m.group(1), m.group(2)
            if dt not in _HLO_SIZES:
                continue
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            total += n * _HLO_SIZES[dt]
    return total


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--obs", type=int, default=16384)
    ap.add_argument("--cams", type=int, default=64)
    ap.add_argument("--lines", type=int, default=512)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--platform", default=None)
    args = ap.parse_args()

    if args.platform:
        os.environ["JAX_PLATFORMS"] = args.platform
    if not os.environ.get("XLA_FLAGS"):
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import numpy as np
    from jax.sharding import Mesh

    import jax.numpy as jnp
    from __graft_entry__ import _example_ba_problem
    from slslam.parallel import dist_local_ba_lines, partition_by_line

    devices = jax.devices()
    print(json.dumps({"devices": len(devices),
                      "platform": devices[0].platform,
                      "problem": {"obs": args.obs, "cams": args.cams,
                                  "lines": args.lines,
                                  "lm_iters": args.iters}}))
    prob = _example_ba_problem(C=args.cams, L=args.lines, O=args.obs)
    (cam0, orth0, obs_a, oc_a, ol_a, ov_a, cf_a, lf_a, bl, hd) = prob

    results = {}
    rows = []
    n = 1
    while n <= len(devices):
        mesh = Mesh(np.array(devices[:n]), ("obs",))
        lo, lf, ob, oc, ol, ov, _ = partition_by_line(
            np.asarray(orth0), np.asarray(lf_a), np.asarray(obs_a),
            np.asarray(oc_a), np.asarray(ol_a), np.asarray(ov_a), n)
        sh = (jnp.asarray(lo), jnp.asarray(ob), jnp.asarray(oc),
              jnp.asarray(ol), jnp.asarray(ov), cf_a, jnp.asarray(lf))
        out = dist_local_ba_lines(mesh, cam0, *sh, bl, hd,
                                  robust=True, max_iters=args.iters)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        reps = 5
        for _ in range(reps):
            out = dist_local_ba_lines(mesh, cam0, *sh, bl, hd,
                                      robust=True, max_iters=args.iters)
            jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / reps
        results[n] = dt

        lowered = dist_local_ba_lines.lower(mesh, cam0, *sh, bl, hd,
                                            robust=True,
                                            max_iters=args.iters)
        compiled = lowered.compile()
        cost = compiled.cost_analysis()
        if isinstance(cost, list):
            cost = cost[0]
        flops = float((cost or {}).get("flops", float("nan")))
        ar_bytes = allreduce_bytes_of(compiled.as_text())

        row = {
            "mesh": n,
            "wall_ms_per_solve": round(dt * 1e3, 1),
            "wall_eff_vs_1dev": round(results[1] / (dt * n), 3),
            "per_device_gflop": round(flops / 1e9, 3),
            "allreduce_mb_per_solve": round(ar_bytes / 1e6, 3),
        }
        rows.append(row)
        print(json.dumps(row))
        n *= 2

    # summary: per-device FLOP halving check
    if len(rows) >= 2:
        halving = [round(rows[i]["per_device_gflop"]
                         / max(rows[i + 1]["per_device_gflop"], 1e-9), 2)
                   for i in range(len(rows) - 1)]
        print(json.dumps({
            "per_device_flop_ratio_at_each_doubling": halving}))


if __name__ == "__main__":
    main()
