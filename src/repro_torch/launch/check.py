"""Static verification launcher — the CI gate over the ported configs.

Builds the default plan for each requested config (no weight, no launch),
runs :func:`repro_torch.analysis.verify_plan` over it, and prints one
summary line per config plus every diagnostic.  Exit status 1 when any
config produces an error-severity diagnostic, so CI can gate on it.

By default it verifies the plan the card would run: the hand kernels
resolved statically (``kernel_backend="cuda"``), so the K202 working sets
are the kernels' own shared bytes; this needs no card.  ``--device cpu``
verifies the CPU's plan (the ``auto`` policy there: the reference ops).

Usage:
  python -m repro_torch.launch.check --cfg lenet5
  python -m repro_torch.launch.check --all [--smoke] [--shape decode_32k]
  python -m repro_torch.launch.check --all --device cpu
  python -m repro_torch.launch.check --codes     # list the diagnostic codes
"""
import argparse
import dataclasses
import sys
from typing import List, Optional, Tuple

from repro_torch.analysis import DIAGNOSTIC_CODES, verify_plan
from repro_torch.configs import ARCHS, CNNS, SHAPES, get_config, get_smoke
from repro_torch.configs.base import FlowConfig, ShapeConfig


def default_shape(family: str) -> ShapeConfig:
    """A small CPU-checkable cell per family: CNNs get an image batch, LMs a
    short decode cell (the serving-relevant kind)."""
    if family == "cnn":
        return ShapeConfig("check", "prefill", 64, 8)
    return ShapeConfig("check", "decode", 128, 4)


def check_config(name: str, *, smoke: bool = False,
                 shape: Optional[ShapeConfig] = None,
                 flow: Optional[FlowConfig] = None,
                 device: str = "cuda") -> Tuple[str, List[str]]:
    """(summary_line, formatted diagnostics) for one config's default plan
    on ``device``: ``"cuda"`` resolves the ``auto`` policy to the hand
    kernels without asking for a card, ``"cpu"`` builds the CPU's plan."""
    from repro_torch.core.plan import _build_plan
    cfg = get_smoke(name) if smoke else get_config(name)
    shape = shape if shape is not None else default_shape(cfg.family)
    flow = flow if flow is not None else FlowConfig()
    if device == "cuda" and flow.kernel_backend == "auto":
        flow = dataclasses.replace(flow, kernel_backend="cuda")
    plan = _build_plan(cfg, flow, shape, platform=device)
    result = verify_plan(plan)
    return result.summary_line(), [d.format() for d in result.diagnostics]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.check",
        description="statically verify execution plans (no launch)")
    ap.add_argument("--cfg", "--arch", dest="cfg", default=None,
                    help="one config name (see repro_torch.configs)")
    ap.add_argument("--all", action="store_true",
                    help="verify every ported config")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke configs")
    ap.add_argument("--shape", default=None,
                    help="shape-cell name from repro_torch.configs.SHAPES "
                         "(default: a small per-family check cell)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="whose plan to verify: the card's (default; no "
                         "card needed) or the CPU's")
    ap.add_argument("--codes", action="store_true",
                    help="print the diagnostic code table and exit")
    args = ap.parse_args(argv)

    if args.codes:
        for code, meaning in DIAGNOSTIC_CODES.items():
            print(f"{code}  {meaning}")
        return 0

    if not args.cfg and not args.all:
        ap.error("pass --cfg NAME or --all")
    names = ARCHS + CNNS if args.all else [args.cfg]
    shape = SHAPES[args.shape] if args.shape else None

    failed = False
    for name in names:
        summary, diags = check_config(name, smoke=args.smoke, shape=shape,
                                      device=args.device)
        print(f"{name:24s} {summary}")
        for line in diags:
            print(f"    {line}")
        failed = failed or summary.startswith("FAIL")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
