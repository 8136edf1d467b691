#!/usr/bin/env python
"""K4 (the SHT's phase stage) and its inverse at the paths' shapes, for this
checkout and an earlier one in turns, on one GPU.

    python3 driftscan_tpu_torch/experiments/k4_turns.py [--parent ROOT] [--only NAME ...]

Each tree runs in a process of its own, in turns (parent, this, this,
parent; this tree alone without ``--parent``), and calls its own
``chip_smoke.k4_compare`` on seeded maps (``chip_smoke.phase_maps``) at

* ``[slice]`` chunk: B 64, nside 256, m 0..229, complex64;
* ``[pol]`` chunk: B 256, nside 128, m 0..120, complex64;
* ``[ns2 window]``: B 16, nside 512, m 270..314, complex64;
* ``[dish]`` chunk: B 16, nside 512, m 0..494, complex128;
* ns1b: B 64, nside 1024, m 0..32, complex64;

and its own ``chip_smoke.k4_inv_compare`` on the bench cylinder (K14's
timestream shape: B 8, nside 256, m 0..229, real and complex forms, both
types).  Each prints the kernel's and the plain version's times (median of
5 CUDA-event timings of one call, 3 at ``[dish]`` and ns1b), its error and
its bound; the last line of each turn is a JSON record {shape: kernel ms},
and the run ends with a table of each shape's times by turn.
``--only`` keeps the named shapes (slice, pol, ns2, dish, ns1b, inverse).
Prints the card's name and power limit and this tree's K4 ptxas lines
first.  Needs a CUDA card and nvcc; imports no JAX.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
# name: (nside, B, m0, nm, complex128, reps)
SHAPES = {
    "slice": (256, 64, 0, 230, False, 5),
    "pol": (128, 256, 0, 121, False, 5),
    "ns2": (512, 16, 270, 45, False, 5),
    "dish": (512, 16, 0, 495, True, 3),
    "ns1b": (1024, 64, 0, 33, False, 3),
}


def worker(root, names):
    """Run in ``root``'s own package: its chip_smoke's K4 comparisons."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.ops import sht
    from driftscan_tpu_torch.telescope import cylinder

    assert os.path.dirname(os.path.abspath(cs.__file__)) == root
    path = backend.build(sht.K4.source)
    with open(path + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("[ptxas]", line.strip(), flush=True)
    out = {}
    for i, name in enumerate(n for n in SHAPES if n in names):
        nside, B, m0, nm, c128, reps = SHAPES[name]
        maps = cs.phase_maps(B, nside, torch.complex128 if c128 else torch.complex64,
                             cs.SEED + 40 + i)
        rec = cs.k4_compare(maps, nside, nm, f"turns {name}", m0=m0, reps=reps)
        out[name] = rec["ms"]
        del maps
        torch.cuda.empty_cache()
    if "inverse" in names:
        tel = cylinder.UnpolarisedCylinderTelescope.from_config(cs.BENCH_PARAMS, device="cuda")
        out["inverse c128 real"] = cs.k4_inv_compare(tel, tag="turns")["ms"]
    print(json.dumps(out), flush=True)


def turn(root, names):
    cmd = [sys.executable, os.path.abspath(__file__), "--worker", root, "--only", *names]
    res = subprocess.run(cmd, capture_output=True, text=True)
    sys.stdout.write(res.stdout)
    sys.stderr.write(res.stderr[-4000:])
    if res.returncode != 0:
        raise SystemExit(f"turn in {root} failed ({res.returncode})")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main():
    args = sys.argv[1:]
    names = list(SHAPES) + ["inverse"]
    if "--only" in args:
        i = args.index("--only")
        names = args[i + 1:]
        args = args[:i]
    if args[:1] == ["--worker"]:
        return worker(args[1], names)
    parent = None
    if args[:1] == ["--parent"]:
        parent = os.path.abspath(args[1])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    order = [("this", ROOT)] if parent is None else [
        ("parent", parent), ("this", ROOT), ("this", ROOT), ("parent", parent)]
    runs = []
    for label, root in order:
        print(f"== turn {len(runs) + 1}: {label} ({root})", flush=True)
        runs.append({"tree": label, "ms": turn(root, names)})
    print("== kernel ms by turn")
    for name in runs[0]["ms"]:
        print(f"{name}: " + ", ".join(f"{r['tree']} {r['ms'][name]:.4f}" for r in runs))


if __name__ == "__main__":
    main()
