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
4. LM kernels — at full-width llama3.2-1b shapes, in bf16 and fp32:
   ``flash_attention`` at the prefill (B=8, 512 tokens, 32 heads over 8 KV
   heads of 64, causal), ``decode_attention`` over a 1024-slot cache half
   full, and ``matmul_fused`` at every projection of a layer, for the
   prefill's 4096 rows and a decode step's 8; each held against its plain
   version and timed beside it, the PyTorch call for the same function
   (``scaled_dot_product_attention``, ``torch.matmul``) and the bound;
5. path — full-width ResNet-34 (224 px, batch 8, random weights from seed 0)
   through ``repro_torch.flow.compile`` in the opt, base and folded flows:
   the plan dispatches conv2d and matmul to ``cuda``, one forward launches
   36 convs and 1 matmul, the logits are (8, 1000), finite, and agree with
   the same model on the ``reference`` backend; then ``measure("prefill")``.
   Then LeNet-5 and MobileNetV1 at full config, with the same checks;
6. LM path — full-width llama3.2-1b (16 layers, random weights from seed
   0), ``ShapeConfig("serve", "decode", 1024, 8)``, a 512-token prompt per
   row from ``RandomState(0)``: in bf16 the plan dispatches attention,
   decode attention and both matmuls to ``cuda``; ``generate`` runs 32
   steps; one prefill and each decode step launch the kernels the plan
   says (16 flash / 96 matmul, 16 decode / 96 matmul); the prefill's and
   every teacher-forced decode step's logits agree with the ``reference``
   backend.  In fp32 the greedy tokens of 32 steps are identical to the
   reference backend's.  Then ``measure("prefill")`` at 8 x 512 tokens,
   ``measure("decode")``, and a profile of each.

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

# llama3.2-1b at full width (configs/llama32_1b.py): the prefill batch of
# 8 rows x 512 tokens, the 1024-slot decode cache, and the projections of
# one layer as (name, K, N, GLU pair); each runs once per layer
LM_ARCH = "llama3.2-1b"
LM_S, LM_C, LM_H, LM_KV, LM_D, LM_LAYERS = 512, 1024, 32, 8, 64, 16
LM_STEPS = 32
LM_MATMULS = [("q", 2048, 2048, False), ("k", 2048, 512, False),
              ("v", 2048, 512, False), ("o", 2048, 2048, False),
              ("glu", 2048, 8192, True), ("down", 8192, 2048, False)]

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


def counters():
    """The launch counts of the four kernel wrappers."""
    from repro_torch.kernels import attention as ka
    from repro_torch.kernels import conv2d as kc
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import matmul_fused as km
    return {"conv2d_fused": kc.conv2d_fused, "matmul_fused": km.matmul_fused,
            "flash_attention": ka.flash_attention,
            "decode_attention": kd.decode_attention}


def reset_counts() -> None:
    torch.cuda.synchronize()
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    torch.cuda.synchronize()
    return {k: fn.launches for k, fn in counters().items()}


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


def _timed_case(kern, plain, library, dt, flops, nbytes, iters=20):
    """Kernel vs plain version (relerr, max |diff|), then the three times
    and the bound of one call."""
    y = kern()
    torch.cuda.synchronize()
    p = plain()
    torch.cuda.synchronize()
    err, aerr = relerr(y, p), (y.float() - p.float()).abs().max().item()
    if not (y.shape == p.shape and torch.isfinite(y.float()).all()
            and err < TOL[dt]):
        raise AssertionError(f"relerr {err} (tol {TOL[dt]}), shape "
                             f"{tuple(y.shape)}")
    bms, by = bound_ms(flops, nbytes, dt)
    warm = 1 if iters < 20 else 3
    return {"dtype": str(dt).split(".")[-1], "relerr": err,
            "max_abs_err": aerr, "tol": TOL[dt],
            "library_relerr": relerr(library(), p), "flops": flops,
            "bytes": nbytes, "bound_ms": bms, "bound_by": by,
            "ms": cuda_ms(kern, iters, warm),
            "plain_ms": cuda_ms(plain, iters, warm),
            "library_ms": cuda_ms(library, iters, warm)}


def _flash_case(dt, gen):
    from repro_torch.kernels import attention as ka
    dev = torch.device("cuda")
    S, H, KV, D = LM_S, LM_H, LM_KV, LM_D
    q = torch.randn(B, S, H, D, generator=gen, device=dev).to(dt)
    k = torch.randn(B, S, KV, D, generator=gen, device=dev).to(dt)
    v = torch.randn(B, S, KV, D, generator=gen, device=dev).to(dt)
    # the library call takes (B, H, S, D) with the KV heads repeated
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    flops = 4.0 * D * B * H * S * (S + 1) / 2        # causal pairs only
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    c = _timed_case(
        lambda: ka.flash_attention(q, k, v, causal=True),
        lambda: ka.flash_attention_plain(q, k, v, causal=True),
        lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                               is_causal=True).transpose(1, 2),
        dt, flops, nbytes)
    c.update(shape=f"prefill_B{B}_S{S}_H{H}_KV{KV}_D{D}_causal",
             uses_per_prefill=LM_LAYERS)
    return c


def _decode_case(dt, gen):
    from repro_torch.kernels import decode_attention as kd
    dev = torch.device("cuda")
    C, H, KV, D = LM_C, LM_H, LM_KV, LM_D
    fill = C // 2
    ar = torch.arange(C, dtype=torch.int32, device=dev)
    pos = torch.where(ar < fill, ar, torch.full_like(ar, -1))
    pos = pos.expand(B, C).contiguous()
    qpos = torch.full((B, 1), fill, dtype=torch.int32, device=dev)
    q = torch.randn(B, 1, H, D, generator=gen, device=dev).to(dt)
    kc = torch.randn(B, C, KV, D, generator=gen, device=dev).to(dt)
    vc = torch.randn(B, C, KV, D, generator=gen, device=dev).to(dt)
    qt = q.transpose(1, 2)
    kt = kc.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    vt = vc.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    mask = ((pos >= 0) & (pos <= qpos))[:, None, None, :]
    valid = fill
    flops = 4.0 * D * B * H * valid
    # the filled slots' K and V, every slot's position, q, qpos and out
    nbytes = (2 * B * valid * KV * D + 2 * q.numel()) * q.element_size() \
        + (pos.numel() + qpos.numel()) * 4
    c = _timed_case(
        lambda: kd.decode_attention(q, kc, vc, pos, qpos),
        lambda: kd.decode_attention_plain(q, kc, vc, pos, qpos),
        lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                               attn_mask=mask).transpose(1, 2),
        dt, flops, nbytes, iters=100)
    c.update(shape=f"decode_B{B}_C{C}_filled{fill}_H{H}_KV{KV}_D{D}",
             uses_per_step=LM_LAYERS)
    return c


def _lm_matmul_case(name, M, K, N, glu, dt, gen):
    from repro_torch.kernels import matmul_fused as km
    dev = torch.device("cuda")
    x = torch.randn(M, K, generator=gen, device=dev).to(dt)
    w = (torch.randn(K, N, generator=gen, device=dev) * K ** -0.5).to(dt)
    w2 = (torch.randn(K, N, generator=gen, device=dev)
          * K ** -0.5).to(dt) if glu else None
    act = "silu" if glu else None

    def library():                              # cuBLAS, the yardstick only
        if not glu:
            return torch.matmul(x, w)
        return (F.silu(torch.matmul(x, w).float())
                * torch.matmul(x, w2).float()).to(dt)

    n_w = 2 if glu else 1
    flops = 2.0 * M * K * N * n_w
    nbytes = (M * K + n_w * K * N + M * N) * x.element_size()
    c = _timed_case(
        lambda: km.matmul_fused(x, w, w2=w2, act=act, out_dtype=dt),
        lambda: km.matmul_fused_plain(x, w, w2=w2, act=act, out_dtype=dt),
        library, dt, flops, nbytes, iters=5 if M > 64 else 50)
    c.update(shape=f"{name}_{M}x{K}x{N}" + ("_glu" if glu else ""),
             rows=M, uses_per_forward=LM_LAYERS)
    return c


def phase_lm_kernels():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cases = {"flash_attention": [], "decode_attention": [],
             "matmul_fused": []}
    for dt in (torch.bfloat16, torch.float32):
        for kname, c in (("flash_attention", _flash_case(dt, gen)),
                         ("decode_attention", _decode_case(dt, gen))):
            cases[kname].append(c)
            log(json.dumps({"kernel": kname, **c}))
        for M in (B * LM_S, B):                     # prefill rows, one step
            for name, K, N, glu in LM_MATMULS:
                c = _lm_matmul_case(name, M, K, N, glu, dt, gen)
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
    reset_counts()
    y, _, _ = cm.prefill(params, batch)
    launches = read_counts()
    if launches != {"conv2d_fused": want_conv, "matmul_fused": want_mm,
                    "flash_attention": 0, "decode_attention": 0}:
        raise AssertionError(f"{arch}: launches {launches}, want "
                             f"{want_conv} conv / {want_mm} matmul")
    launches = {k: launches[k] for k in ("conv2d_fused", "matmul_fused")}
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


def _plan_launches(plan, mode):
    """Kernel launches one ``mode`` call of the model makes, derived from
    the plan: its live attention and matmul ops, times each unit's reps."""
    from repro_torch.core.lowering import live_ops
    want = {"flash_attention": 0, "decode_attention": 0, "matmul_fused": 0}
    for unit in plan.units:
        for j in range(unit.period):
            blk = plan.graph.blocks[unit.indices[j]]
            for op in live_ops(blk, mode):
                if op.op == "attention":
                    k = "flash_attention" if mode == "prefill" \
                        else "decode_attention"
                    want[k] += unit.reps
                elif op.op in ("matmul", "glu_matmul"):
                    want["matmul_fused"] += unit.reps
    return want


def _counted(got, want, what):
    got = {k: v for k, v in got.items() if k != "conv2d_fused" or v}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, want {want}")
    return got


def _lm_check_logits(what, y, yr, tol):
    V = yr.shape[-1]
    if tuple(y.shape) != (B, 1, V) or not torch.isfinite(y.float()).all():
        raise AssertionError(f"{what}: logits {tuple(y.shape)} not finite "
                             f"({B}, 1, {V})")
    err = relerr(y, yr)
    if err >= tol:
        raise AssertionError(f"{what}: logits relerr {err} vs the reference "
                             f"backend (tol {tol})")
    return err


def phase_lm_path(smi):
    """Full-width llama3.2-1b through the port's entry points."""
    from repro_torch import flow as tflow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    rec = {"arch": LM_ARCH, "nvidia_smi": smi}
    serve = ShapeConfig("serve", "decode", LM_C, B)
    cm = tflow.compile(LM_ARCH, serve, FlowConfig(mode="folded"))
    ks = cm.plan.kernels
    if any(ks[o] != "cuda" for o in ("attention", "decode_attention",
                                     "matmul", "glu_matmul")):
        raise AssertionError(f"{LM_ARCH}: plan.kernels {ks}")
    ref = tflow.compile(LM_ARCH, serve, FlowConfig(mode="folded"),
                        backend="reference")
    want_p = _plan_launches(cm.plan, "prefill")
    want_d = _plan_launches(cm.plan, "decode")
    n_mm = LM_LAYERS * len(LM_MATMULS)
    if want_p != {"flash_attention": LM_LAYERS, "decode_attention": 0,
                  "matmul_fused": n_mm} or \
            want_d != {"flash_attention": 0, "decode_attention": LM_LAYERS,
                       "matmul_fused": n_mm}:
        raise AssertionError(f"plan launches {want_p} / {want_d}")
    rec["units"] = cm.describe().splitlines()[2].strip()
    rec["kernels_line"] = cm.describe().splitlines()[-1].strip()
    t0 = time.perf_counter()
    params = cm.init_params(SEED)
    torch.cuda.synchronize()
    rec["init_params_s"] = time.perf_counter() - t0
    V = cm.cfg.vocab_size
    prompt = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, V, (B, LM_S)).astype(np.int64)).cuda()
    batch = {"tokens": prompt}

    # the main path: greedy generate, 32 tokens per row
    reset_counts()
    toks, _ = cm.generate(params, batch, steps=LM_STEPS)
    rec["launches"] = _counted(read_counts(), {
        k: want_p[k] + (LM_STEPS - 1) * want_d[k] for k in want_p},
        "generate")
    if tuple(toks.shape) != (B, LM_STEPS) or not ((toks >= 0)
                                                  & (toks < V)).all():
        raise AssertionError(f"generate: tokens {tuple(toks.shape)}")

    # teacher-forced on those tokens, beside the reference backend
    reset_counts()
    y, st, _ = cm.prefill(params, batch)
    _counted(read_counts(), want_p, "one prefill")
    yr, st_r, _ = ref.prefill(params, batch)
    errs = [_lm_check_logits("prefill", y, yr, PATH_TOL["bf16"])]
    agree = [(yr[:, -1].argmax(-1) == toks[:, 0]).float().mean().item()]
    same = torch.equal(y[:, -1].argmax(-1).to(torch.int32), toks[:, 0])
    for t in range(LM_STEPS - 1):
        tok = {"tokens": toks[:, t:t + 1].long()}
        reset_counts()
        y, st, _ = cm.decode(params, tok, st, LM_S + t)
        _counted(read_counts(), want_d, f"decode step {t}")
        yr, st_r, _ = ref.decode(params, tok, st_r, LM_S + t)
        errs.append(_lm_check_logits(f"decode step {t}", y, yr,
                                     PATH_TOL["bf16"]))
        agree.append((yr[:, -1].argmax(-1) == toks[:, t + 1])
                     .float().mean().item())
        same = same and torch.equal(y[:, -1].argmax(-1).to(torch.int32),
                                    toks[:, t + 1])
    rec["bf16"] = {"teacher_forced_repeats_generate": same,
                   "prefill_relerr": errs[0],
                   "decode_relerr_max": max(errs[1:]),
                   "decode_relerr": errs[1:],
                   "greedy_agreement_share": sum(agree) / len(agree),
                   "tokens_row0": toks[0].tolist()}
    log(f"llama bf16: prefill relerr {errs[0]:.3e}, decode relerr max "
        f"{max(errs[1:]):.3e}, greedy tokens agreeing with the reference "
        f"backend: {sum(agree) / len(agree):.3f}")

    # measurements: prefill at 8 x 512 tokens, decode steps
    pre = ShapeConfig("serve", "prefill", LM_S, B)
    cm_p = tflow.compile(LM_ARCH, pre, FlowConfig(mode="folded"))
    ref_p = tflow.compile(LM_ARCH, pre, FlowConfig(mode="folded"),
                          backend="reference")
    mp = cm_p.measure("prefill", iters=5, seed=SEED, params=params)
    mpr = ref_p.measure("prefill", iters=5, seed=SEED, params=params)
    md = cm.measure("decode", iters=20, seed=SEED, params=params)
    mdr = ref.measure("decode", iters=20, seed=SEED, params=params)
    dstate = cm.init_state(B)
    dtok = {"tokens": prompt[:, :1]}
    rec["measure"] = {
        "device": mp["device"],
        "prefill_ms": mp["measured_step_s"] * 1e3,
        "prefill_mean_ms": mp["mean_step_s"] * 1e3,
        "prefill_tokens_per_s": mp["tokens_per_s"],
        "prefill_peak_bytes": mp["peak_bytes"],
        "reference_prefill_ms": mpr["measured_step_s"] * 1e3,
        "decode_ms": md["measured_step_s"] * 1e3,
        "decode_mean_ms": md["mean_step_s"] * 1e3,
        "decode_tokens_per_s": md["tokens_per_s"],
        "reference_decode_ms": mdr["measured_step_s"] * 1e3,
        "prefill_profile": _profile(lambda: cm_p.prefill(params, batch), 2),
        "decode_profile": _profile(
            lambda: cm.decode(params, dtok, dstate, 100), 10)}
    log(json.dumps({"lm_measure": rec["measure"]}))
    del params, st, st_r, dstate

    # fp32: greedy tokens identical to the reference backend's
    f32 = FlowConfig(mode="folded", precision="fp32")
    cm32 = tflow.compile(LM_ARCH, serve, f32)
    ref32 = tflow.compile(LM_ARCH, serve, f32, backend="reference")
    if cm32.plan.kernels["attention"] != "cuda":
        raise AssertionError(f"fp32 plan.kernels {cm32.plan.kernels}")
    p32 = cm32.init_params(SEED)
    reset_counts()
    t32, _ = cm32.generate(p32, batch, steps=LM_STEPS)
    rec["launches_fp32"] = _counted(read_counts(), rec["launches"],
                                    "fp32 generate")
    t32r, _ = ref32.generate(p32, batch, steps=LM_STEPS)
    if not torch.equal(t32, t32r):
        diff = (t32 != t32r).float().mean().item()
        raise AssertionError(f"fp32 greedy tokens differ from the reference "
                             f"backend's ({diff:.3f} of them)")
    rec["fp32"] = {"greedy_identical_steps": LM_STEPS,
                   "tokens_row0": t32[0].tolist()}
    log(json.dumps({"lm_path": {k: v for k, v in rec.items()
                                if k != "measure"}}))
    return rec


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


def lm_kernel_entries(cases, lm):
    """One entry per LM kernel and dtype: times summed over the launches of
    the LM path's run, one ``generate`` of 32 tokens (a prefill of 8 x 512
    tokens, then 31 decode steps), each case's time times its uses there."""
    src = {"flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                               "src/repro/kernels/attention.py:93"),
           "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                "src/repro/kernels/decode_attention.py:61"),
           "matmul_fused": ("src/repro_torch/csrc/matmul_fused.cu",
                            "src/repro/kernels/matmul_fused.py:83")}
    launches = {"bfloat16": lm["launches"], "float32": lm["launches_fp32"]}
    steps = LM_STEPS - 1

    def uses(kname, r):
        if kname == "flash_attention":
            return LM_LAYERS
        if kname == "decode_attention":
            return LM_LAYERS * steps
        return LM_LAYERS * (1 if r["rows"] > B else steps)
    out = []
    for kname, rows in cases.items():
        for dt in ("bfloat16", "float32"):
            rs = [r for r in rows if r["dtype"] == dt]

            def tot(key):
                return sum(r[key] * uses(kname, r) for r in rs)
            by_ops = sum(r["bound_ms"] * uses(kname, r) for r in rs
                         if r["bound_by"] == "operations")
            out.append({
                "name": f"{kname}@{LM_ARCH}/{dt}", "route": "cuda",
                "source": src[kname][0], "replaces": src[kname][1],
                "launches": launches[dt][kname],
                "max_abs_err": max(r["max_abs_err"] for r in rs),
                "ms": tot("ms"), "plain_ms": tot("plain_ms"),
                "bound_ms": tot("bound_ms"),
                "bound_by": ("operations" if by_ops >= tot("bound_ms") / 2
                             else "bytes"),
                "library_ms": tot("library_ms"), "ok": True,
                "per": f"one {LM_ARCH} generate: prefill of {B}x{LM_S} "
                       f"tokens, then {steps} decode steps"})
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
    lm_cases = phase_lm_kernels()
    path = phase_path(smi)
    lm = phase_lm_path(smi)
    entries = kernel_entries(cases, path) + lm_kernel_entries(lm_cases, lm)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
        json.dump({"device": name, "nvidia_smi": smi, "build": build,
                   "kernels": cases, "lm_kernels": lm_cases, "path": path,
                   "lm_path": lm, "entries": entries,
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
