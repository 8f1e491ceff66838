"""Probe the card's 16-bit paths: can the extension DP run on packed int16
lanes, two DP cells per 32-bit register? (The counterpart of
tools/mosaic_probe.py, which asks the TPU compiler the same question.)

    python -m bwamem_tpu_torch.tools.int16_probe [--device cpu]

Runs each of the six int16 op classes (ops/kernels/int16_probe.py) on an
(8, 128) int16 block holding arange(1024) % 100 and prints one PASS/FAIL
line per case and a VERDICT line. On the card (the default) PASS means the
case's kernel built, launched and equals its plain version exactly; with
--device cpu the plain versions run. Either way the result must also equal
numpy. Exits 1 if any case fails.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

SHAPE = (8, 128)


def numpy_case(name: str, x: np.ndarray) -> np.ndarray:
    """Each case in numpy, as the Pallas probe's kernel bodies compute it."""
    if name == "compare":
        return np.where(x > 3, x, 0).astype(np.int16)
    if name == "reduce":
        return np.broadcast_to(x.max(axis=1, keepdims=True), x.shape).copy()
    if name == "iota":
        return (x + np.arange(x.shape[1], dtype=np.int16)).astype(np.int16)
    if name == "shift":
        return np.concatenate([np.zeros_like(x[:, :1]), x[:, :-1]], axis=1)
    if name == "roll":
        return np.roll(x, 1, axis=1)
    if name == "convert":
        return x.astype(np.int32).astype(np.int16)
    raise ValueError(name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bwamem_tpu_torch.tools.int16_probe",
        description="probe the 16-bit op classes a 16-bit DP needs")
    ap.add_argument("--device", default="cuda",
                    help="torch device [cuda]; cpu runs the plain versions")
    args = ap.parse_args(argv)

    import torch

    from ..ops.kernels import int16_probe as k4

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print(f"error: --device {args.device}: no CUDA device is available",
              file=sys.stderr)
        return 1
    dev = torch.device(args.device)
    print("device:", torch.cuda.get_device_name(dev)
          if dev.type == "cuda" else "cpu (plain versions)")
    x_np = (np.arange(np.prod(SHAPE), dtype=np.int16) % 100).reshape(SHAPE)
    x = torch.from_numpy(x_np).to(dev)
    ok = {}
    for name, label in k4.CASES:
        try:
            got = k4.run_case(name, x)
            plain = k4.PLAIN[name](x)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            got, plain = got.cpu().numpy(), plain.cpu().numpy()
            want = numpy_case(name, x_np)
            ok[name] = (np.array_equal(got, plain)
                        and np.array_equal(got, want))
            print(f"PASS {label}" if ok[name] else
                  f"FAIL {label}: differs from its plain version or numpy")
        except (RuntimeError, ValueError) as e:
            ok[name] = False
            print(f"FAIL {label}: {str(e).splitlines()[0][:120]}")
    blocked = [n for n in k4.NAMES if not ok[n]]
    if blocked:
        print(f"VERDICT: 16-bit DP blocked by: {', '.join(blocked)}")
        return 1
    if dev.type == "cuda":
        print("VERDICT: 16-bit DP viable on this card: a K1/K3 cell can "
              "run two lanes to a register with __vcmpgts2 (compare), "
              "__vmaxs2 and DPX __vimax3_s16x2 (max), __vadd2 (add), "
              "__byte_perm across __shfl_up_sync (the shifted neighbour) "
              "and sign-extending unpack (convert)")
    else:
        print("VERDICT: the plain versions agree with numpy; run on the "
              "card for the kernels' answer")
    return 0


if __name__ == "__main__":
    sys.exit(main())
