"""LF — loop-fusion pass (paper §IV-C) + CW epilogue placement.

Peephole-rewrites each block's micro-op list:

* ``matmul → bias_add``            ⇒ matmul(bias=True)
* ``matmul → act``                 ⇒ matmul(act=k)
* ``act(matmul_a(x)) * matmul_b(x)`` ⇒ ``glu_matmul`` (gated-linear pair)
* ``add(resid, matmul(...))``      ⇒ matmul(residual=True)
* ``conv2d → batchnorm [→ act]``   ⇒ conv2d(bn=True, act=k)   (inference only)

On the FPGA these fusions removed the temporary array between the convolution
and the activation loop (and its LSUs); here they decide the *epilogue* of the
fused Pallas kernel so activations never round-trip HBM, and shrink the HLO
the reference path emits.
"""
from __future__ import annotations

from typing import List

from repro_torch.core.graph import Block, Graph, MicroOp
from repro_torch.core.passmanager import Pass, PlanContext


def _fuse_block(b: Block, fold_bn: bool) -> None:
    changed = True
    while changed:
        changed = False
        ops = b.ops
        for i, op in enumerate(ops):
            nxt = ops[i + 1] if i + 1 < len(ops) else None
            # matmul/glu_matmul + bias_add
            if (nxt and op.op in ("matmul", "conv2d", "depthwise_conv2d")
                    and nxt.op == "bias_add" and nxt.ins == (op.out,)
                    and not op.attrs.get("bias")):
                if op.op == "matmul":
                    op.params = op.params + nxt.params
                    op.attrs["bias"] = True
                    op.out = nxt.out
                    del ops[i + 1]
                    changed = True
                    break
            # (fused-)matmul/conv + act
            if (nxt and op.op in ("matmul", "glu_matmul", "conv2d",
                                  "depthwise_conv2d")
                    and nxt.op == "act" and nxt.ins == (op.out,)
                    and not op.attrs.get("act")
                    and not op.attrs.get("residual")):
                op.attrs["act"] = nxt.attrs["kind"]
                op.out = nxt.out
                del ops[i + 1]
                changed = True
                break
            # GLU pair:  g=mm_a(x); ga=act(g) folded above; u=mm_b(x); mul(ga,u)
            if op.op == "mul" and i >= 2:
                a, bop = ops[i - 2], ops[i - 1]
                if (a.op == "matmul" and bop.op == "matmul"
                        and a.attrs.get("act") and not bop.attrs.get("act")
                        and a.ins == bop.ins
                        and set(op.ins) == {a.out, bop.out}
                        and not a.attrs.get("bias") and not bop.attrs.get("bias")):
                    fused = MicroOp(op.out, "glu_matmul", a.ins,
                                    a.params + bop.params,
                                    {"act": a.attrs["act"]})
                    ops[i - 2:i + 1] = [fused]
                    changed = True
                    break
            # residual add into the producing matmul
            if (op.op == "add" and i >= 1 and ops[i - 1].op in
                    ("matmul", "glu_matmul")
                    and ops[i - 1].out in op.ins
                    and not ops[i - 1].attrs.get("residual")):
                prod = ops[i - 1]
                other = op.ins[0] if op.ins[1] == prod.out else op.ins[1]
                prod.attrs["residual"] = True
                prod.ins = prod.ins + (other,)
                prod.out = op.out
                del ops[i]
                changed = True
                break
            # conv2d + batchnorm (+act): inference-time BN folding
            if (fold_bn and nxt and op.op in ("conv2d", "depthwise_conv2d")
                    and nxt.op == "batchnorm" and nxt.ins == (op.out,)
                    and not op.attrs.get("bn")):
                op.params = op.params + nxt.params
                op.attrs["bn"] = True
                op.out = nxt.out
                del ops[i + 1]
                changed = True
                break


def run(graph: Graph, *, fold_bn: bool) -> Graph:
    for b in graph.blocks:
        _fuse_block(b, fold_bn)
    return graph


class FusionPass(Pass):
    name = "fusion"
    paper = "LF §IV-C"
    reads = ("graph",)
    writes = ("graph",)

    def applies_to(self, cfg, flow, shape) -> bool:
        return flow.fuse_epilogues

    def run(self, ctx: PlanContext) -> None:
        before = sum(len(b.ops) for b in ctx.graph.blocks)
        run(ctx.graph, fold_bn=ctx.shape.kind != "train")
        after = sum(len(b.ops) for b in ctx.graph.blocks)
        epilogues = {"act": 0, "bias": 0, "residual": 0, "bn": 0, "glu": 0}
        for b in ctx.graph.blocks:
            for op in b.ops:
                for k in ("act", "bias", "residual", "bn"):
                    if op.attrs.get(k):
                        epilogues[k] += 1
                if op.op == "glu_matmul":
                    epilogues["glu"] += 1
        ctx.stats[self.name] = {"applied": True, "ops_before": before,
                                "ops_after": after,
                                "ops_removed": before - after,
                                "epilogues": epilogues}

    def tunable_space(self, cfg, flow, shape):
        return {"fuse_epilogues": (True, False)}
