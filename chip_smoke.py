"""Drive the PyTorch port on one CUDA card (an H100) and check it.

    python3 chip_smoke.py

Phases, each raising on failure:

1. device — the card's name and power limit (``nvidia-smi``);
2. build  — the hand-written kernels from ``src/repro_torch/csrc`` with
   ``nvcc`` for ``sm_90a`` (wall time printed as set-up);
3. kernels — every distinct ResNet-34 conv at batch 8 and 224 px, and the
   FC head, in bf16 (the opt flow) and fp32 (the base flow): each kernel
   against its plain PyTorch version (relerr < 2e-2 in bf16, < 1e-5 in
   fp32), and timed beside the plain version, the PyTorch library call for
   the same function, and the card's bound for the work;
4. path — full-width ResNet-34 (224 px, batch 8, random weights from seed 0)
   through ``repro_torch.flow.compile`` in the opt, base and folded flows:
   the plan dispatches conv2d and matmul to ``cuda``, one forward launches
   36 convs and 1 matmul, the logits are (8, 1000), finite, and agree with
   the same model on the ``reference`` backend; then ``measure("prefill")``.
   Then LeNet-5 and MobileNetV1 at full config, with the same checks.

TF32 is off for the whole run (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32``), so every fp32 reference is full
fp32.  The last line is ``{"ok": true, "device": {...}}``; the line with the
``"kernels"`` list and the ``nvidia-smi`` line come just before it.  Exits
non-zero, printing no result, without a CUDA card.  Details go to
``build/chip_smoke.json``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM data sheet, dense: bf16 tensor cores; fp32 outside the tensor
# cores (the kernels' fp32 path); HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}      # kernel vs plain
PATH_TOL = {"bf16": 5e-2, "fp32": 1e-4}                # model vs reference
SEED = 0
B = 8

# Every distinct ResNet-34 conv at 224 px: (name, H_in, CI, CO, k, stride,
# uses per forward, act in the opt flow).  All carry the BN fold in the opt
# flow; the base flow runs them bare (BN and ReLU are separate ops there).
RESNET_CONVS = [
    ("stem7x7s2", 224, 3, 64, 7, 2, 1, "relu"),
    ("3x3s1_64@56", 56, 64, 64, 3, 1, 6, "relu"),
    ("3x3s2_64to128", 56, 64, 128, 3, 2, 1, "relu"),
    ("3x3s1_128@28", 28, 128, 128, 3, 1, 7, "relu"),
    ("1x1s2_64to128", 56, 64, 128, 1, 2, 1, None),
    ("3x3s2_128to256", 28, 128, 256, 3, 2, 1, "relu"),
    ("3x3s1_256@14", 14, 256, 256, 3, 1, 11, "relu"),
    ("1x1s2_128to256", 28, 128, 256, 1, 2, 1, None),
    ("3x3s2_256to512", 14, 256, 512, 3, 2, 1, "relu"),
    ("3x3s1_512@7", 7, 512, 512, 3, 1, 5, "relu"),
    ("1x1s2_256to512", 14, 256, 512, 1, 2, 1, None),
]
FC = (512, 1000)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms of ``fn`` over ``iters`` back-to-back calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def relerr(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / (b.abs().max() + 1e-9)).item()


def bound_ms(flops: float, nbytes: float, dt: torch.dtype):
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    log(f"device: {name} capability={cap} count={torch.cuda.device_count()}"
        f" torch={torch.__version__} cuda={torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    return name, smi


def phase_build():
    from repro_torch.device import hopper_ok
    from repro_torch.kernels import _build
    if not hopper_ok():
        raise RuntimeError("the kernels target sm_90a; this card is "
                           f"{torch.cuda.get_device_capability(0)}")
    t0 = time.perf_counter()
    _build.LIBRARY.get()
    info = _build.LIBRARY.info
    log(f"build: {time.perf_counter() - t0:.2f}s (nvcc {info.seconds:.2f}s,"
        f" built={info.built}) -> {info.path}")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    return {"seconds": time.perf_counter() - t0, "built": info.built}


def _conv_case(spec, dt, gen):
    from repro_torch.kernels import conv2d as kc
    name, H, CI, CO, k, s, uses, act = spec
    dev = torch.device("cuda")
    x = torch.randn(B, H, H, CI, generator=gen, device=dev).to(dt)
    w = (torch.randn(k, k, CI, CO, generator=gen, device=dev)
         * (k * k * CI) ** -0.5).to(dt)
    opt = dt == torch.bfloat16
    bn = tuple(torch.rand(CO, generator=gen, device=dev) + 0.5
               for _ in range(4)) if opt else None
    act = act if opt else None

    def kern():
        return kc.conv2d_fused(x, w, stride=s, padding="SAME", bn=bn,
                               act=act)

    def plain():
        return kc.conv2d_fused_plain(x, w, stride=s, padding="SAME", bn=bn,
                                     act=act)

    (pt, pb), (pl, pr), ho, wo = kc.conv_geometry(H, H, k, k, s, "SAME")
    xn = x.permute(0, 3, 1, 2)                  # NCHW view, channels_last
    wn = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    def library():                              # cuDNN, the yardstick only
        y = F.conv2d(F.pad(xn, (pl, pr, pt, pb)), wn, stride=s)
        if bn is not None:
            sc, bi, mu, var = bn
            y = ((y.float() - mu[:, None, None])
                 * (torch.rsqrt(var + 1e-5) * sc)[:, None, None]
                 + bi[:, None, None])
        if act:
            y = F.relu(y)
        return y.to(dt)

    y = kern()
    torch.cuda.synchronize()
    p = plain()
    torch.cuda.synchronize()
    err, aerr = relerr(y, p), (y.float() - p.float()).abs().max().item()
    lib_err = relerr(library().permute(0, 2, 3, 1), p)
    if not (y.shape == p.shape and torch.isfinite(y.float()).all()
            and err < TOL[dt]):
        raise AssertionError(f"conv2d_fused {name} {dt}: relerr {err} "
                             f"(tol {TOL[dt]}), shape {tuple(y.shape)}")
    flops = 2.0 * B * ho * wo * k * k * CI * CO
    esz = x.element_size()
    nbytes = (x.numel() + w.numel() + B * ho * wo * CO) * esz \
        + (4 * CO * 4 if bn else 0)
    bms, by = bound_ms(flops, nbytes, dt)
    return {"shape": name, "dtype": str(dt).split(".")[-1], "uses": uses,
            "x": [B, H, H, CI], "w": [k, k, CI, CO], "stride": s,
            "bn": bn is not None, "act": act, "relerr": err,
            "max_abs_err": aerr, "tol": TOL[dt], "library_relerr": lib_err,
            "flops": flops, "bytes": nbytes, "bound_ms": bms,
            "bound_by": by, "ms": cuda_ms(kern), "plain_ms": cuda_ms(plain),
            "library_ms": cuda_ms(library)}


def _fc_case(dt, gen):
    from repro_torch.kernels import matmul_fused as km
    dev = torch.device("cuda")
    K, N = FC
    x = torch.randn(B, K, generator=gen, device=dev).to(dt)
    w = (torch.randn(K, N, generator=gen, device=dev) * K ** -0.5).to(dt)
    b = torch.randn(N, generator=gen, device=dev).to(dt)

    def kern():
        return km.matmul_fused(x, w, bias=b, out_dtype=dt)

    def plain():
        return km.matmul_fused_plain(x, w, bias=b, out_dtype=dt)

    def library():                              # cuBLAS, the yardstick only
        return (torch.matmul(x, w).float() + b.float()).to(dt)

    y = kern()
    torch.cuda.synchronize()
    p = plain()
    err, aerr = relerr(y, p), (y.float() - p.float()).abs().max().item()
    if not (y.shape == (B, N) and err < TOL[dt]):
        raise AssertionError(f"matmul_fused FC {dt}: relerr {err}")
    flops = 2.0 * B * K * N
    nbytes = (x.numel() + w.numel() + b.numel() + B * N) * x.element_size()
    bms, by = bound_ms(flops, nbytes, dt)
    return {"shape": f"fc_{B}x{K}x{N}", "dtype": str(dt).split(".")[-1],
            "uses": 1, "relerr": err, "max_abs_err": aerr, "tol": TOL[dt],
            "library_relerr": relerr(library(), p), "flops": flops,
            "bytes": nbytes, "bound_ms": bms, "bound_by": by,
            "ms": cuda_ms(kern, 100), "plain_ms": cuda_ms(plain, 100),
            "library_ms": cuda_ms(library, 100)}


def phase_kernels():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cases = {"conv2d_fused": [], "matmul_fused": []}
    for dt in (torch.bfloat16, torch.float32):
        for spec in RESNET_CONVS:
            c = _conv_case(spec, dt, gen)
            cases["conv2d_fused"].append(c)
            log(json.dumps({"kernel": "conv2d_fused", **c}))
        c = _fc_case(dt, gen)
        cases["matmul_fused"].append(c)
        log(json.dumps({"kernel": "matmul_fused", **c}))
    return cases


def _profile(fn, iters: int = 5):
    """Device busy share of ``iters`` forwards under torch.profiler: the
    summed device time of the device-side kernel events over the window's
    wall time (one stream, so kernels do not overlap), and the top kernels
    by device time.
    The profiler's own cost makes the window longer than an unprofiled one.
    Returns None for the share when the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    rows = sorted(((dev_us(e), e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                  reverse=True)
    busy = sum(us for us, _ in rows)
    return {"iters": iters, "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / wall_us if busy else None,
            "top": [{"kernel": k[:80], "ms_per_forward": us / 1e3 / iters}
                    for us, k in rows[:6]]}


def _check_logits(name, y, yr, vocab, prec):
    if tuple(y.shape) != (B, vocab) or not torch.isfinite(y.float()).all():
        raise AssertionError(f"{name}: logits {tuple(y.shape)} not finite "
                             f"(8, {vocab})")
    err = relerr(y, yr)
    if err >= PATH_TOL[prec]:
        raise AssertionError(f"{name}: logits relerr {err} vs the reference "
                             f"backend (tol {PATH_TOL[prec]})")
    return err


def _forward(arch, flow, want_conv, want_mm, smi, measure=True):
    """One forward through the port's entry point with the counters read
    just around it, held against the reference backend on the same
    weights and images."""
    from repro_torch import flow as tflow
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import conv2d as kc
    from repro_torch.kernels import matmul_fused as km
    serve = ShapeConfig("serve", "prefill", 64, B)
    cm = tflow.compile(get_config(arch), serve, flow)
    ks = cm.plan.kernels
    if ks["conv2d"] != "cuda" or ks["matmul"] != "cuda":
        raise AssertionError(f"{arch}: plan.kernels {ks}")
    params = cm.init_params(SEED)
    rng = np.random.RandomState(SEED)
    cfg = cm.cfg
    x = torch.from_numpy(rng.randn(B, cfg.image_size, cfg.image_size,
                                   cfg.image_channels).astype(np.float32))
    batch = {"images": x.cuda()}
    torch.cuda.synchronize()
    kc.conv2d_fused.launches = 0
    km.matmul_fused.launches = 0
    y, _, _ = cm.prefill(params, batch)
    torch.cuda.synchronize()
    launches = {"conv2d_fused": kc.conv2d_fused.launches,
                "matmul_fused": km.matmul_fused.launches}
    if launches != {"conv2d_fused": want_conv, "matmul_fused": want_mm}:
        raise AssertionError(f"{arch}: launches {launches}, want "
                             f"{want_conv} conv / {want_mm} matmul")
    ref = tflow.compile(get_config(arch), serve, flow, backend="reference")
    if any(b != "ref" for b in ref.plan.kernels.values()):
        raise AssertionError(f"reference plan {ref.plan.kernels}")
    yr, _, _ = ref.prefill(params, batch)
    err = _check_logits(arch, y, yr, cfg.vocab_size, flow.precision)
    rec = {"arch": arch, "flow": flow.precision, "mode": cm.plan.stream.mode,
           "units": cm.describe().splitlines()[2].strip(),
           "launches": launches, "logits_relerr_vs_reference": err,
           "logits_max_abs": y.float().abs().max().item()}
    if measure:
        m = cm.measure("prefill", iters=10, seed=SEED)
        mr = ref.measure("prefill", iters=10, seed=SEED)
        rec.update({"ms_per_forward": m["measured_step_s"] * 1e3,
                    "mean_ms_per_forward": m["mean_step_s"] * 1e3,
                    "images_per_s": m["images_per_s"],
                    "peak_bytes": m["peak_bytes"],
                    "reference_ms_per_forward": mr["measured_step_s"] * 1e3,
                    "device": m["device"], "nvidia_smi": smi,
                    "profile": _profile(lambda: cm.prefill(params, batch))})
    log(json.dumps({"path": rec}))
    return rec


def phase_path(smi):
    from repro_torch.configs.base import FlowConfig
    from repro_torch.kernels.registry import DISPATCH_REJECTIONS
    out = []
    flows = [("opt", FlowConfig(mode="auto")), ("base", FlowConfig().base()),
             ("folded", FlowConfig(mode="folded"))]
    for label, fl in flows:
        rec = _forward("resnet34", fl, 36, 1, smi)
        rec["flow_name"] = label
        out.append(rec)
    if "4 folded: 3x1, 3x1, 5x1, 2x1" not in out[2]["units"]:
        raise AssertionError(f"folded flow units: {out[2]['units']}")
    out.append(_forward("lenet5", FlowConfig(mode="auto"), 2, 3, smi,
                        measure=False))
    DISPATCH_REJECTIONS.clear()
    out.append(_forward("mobilenetv1", FlowConfig(mode="auto"), 14, 1, smi,
                        measure=False))
    dw = sum(n for (op, _), n in DISPATCH_REJECTIONS.items()
             if op == "conv2d")
    if dw != 13:
        raise AssertionError(f"mobilenetv1: {dw} depthwise convs took the "
                             "reference op, want 13")
    return out


def kernel_entries(cases, path):
    """One entry per kernel and dtype: times summed over the kernel's
    launches in one ResNet-34 forward (each shape times its uses)."""
    src = {"conv2d_fused": ("src/repro_torch/csrc/conv2d_fused.cu",
                            "src/repro/kernels/conv2d.py:64"),
           "matmul_fused": ("src/repro_torch/csrc/matmul_fused.cu",
                            "src/repro/kernels/matmul_fused.py:83")}
    launches = {"bfloat16": {}, "float32": {}}
    for r in path:
        if r["arch"] == "resnet34":
            d = launches["bfloat16" if r["flow"] == "bf16" else "float32"]
            for k, n in r["launches"].items():
                d[k] = d.get(k, 0) + n
    out = []
    for kname, rows in cases.items():
        for dt in ("bfloat16", "float32"):
            rs = [r for r in rows if r["dtype"] == dt]

            def tot(key):
                return sum(r[key] * r["uses"] for r in rs)
            by_ops = sum(r["bound_ms"] * r["uses"] for r in rs
                         if r["bound_by"] == "operations")
            out.append({
                "name": f"{kname}/{dt}", "route": "cuda",
                "source": src[kname][0], "replaces": src[kname][1],
                "launches": launches[dt].get(kname, 0),
                "max_abs_err": max(r["max_abs_err"] for r in rs),
                "ms": tot("ms"), "plain_ms": tot("plain_ms"),
                "bound_ms": tot("bound_ms"),
                "bound_by": ("operations" if by_ops >= tot("bound_ms") / 2
                             else "bytes"),
                "library_ms": tot("library_ms"), "ok": True,
                "per": "one ResNet-34 forward at batch 8, 224 px"})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script needs "
              "a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    name, smi = phase_device()
    build = phase_build()
    cases = phase_kernels()
    path = phase_path(smi)
    entries = kernel_entries(cases, path)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
        json.dump({"device": name, "nvidia_smi": smi, "build": build,
                   "kernels": cases, "path": path, "entries": entries,
                   "seconds": time.perf_counter() - t0}, f, indent=1)
    log(f"total: {time.perf_counter() - t0:.1f}s")
    log(json.dumps({"kernels": entries}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
