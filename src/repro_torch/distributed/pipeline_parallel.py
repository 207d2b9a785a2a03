"""Cross-pod pipeline parallelism — the paper's channelization (CH) across
devices.

In pipelined execution the paper keeps every layer's kernel resident and
streams activations through OpenCL channels.  Across pods, the analogue is
GPipe: the folded layer stack is split over the ``pod`` axis (each stage
owns a contiguous run of layers), and microbatch activations go stage to
stage by ``send`` / ``recv`` on the pp axis's process group — the link is
the channel, the number of microbatches in flight is the channel depth.
The other axes (data, model) keep the runtime's layout
(:mod:`repro_torch.distributed.sharding`), so FSDP / TP compose with the
pipeline.

The sends and receives are autograd Functions: a receive's backward sends
the activation's gradient back to the stage it came from, a send's backward
receives it, so one ``backward()`` on every rank runs the pipeline's
backward, microbatches in reverse (autograd runs the later-made nodes
first, on every stage alike; each message is tagged with its microbatch).

Applies to plans whose layers fold into a single group with
``reps % n_stages == 0``.
"""
from __future__ import annotations

import copy
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import lowering
from repro_torch.core.ops_impl import OPS, Ctx
from repro_torch.core.plan import ExecutionPlan
from repro_torch.distributed import collectives as col
from repro_torch.distributed.meshspec import MeshSpec


def _single_fold_unit(plan: ExecutionPlan):
    folded = [u for u in plan.units if u.folded]
    assert len(folded) == 1, (
        "pipeline mode requires a single folded layer group; got "
        f"{len(folded)} (use folded execution instead)")
    return folded[0]


class _Send(torch.autograd.Function):
    """Send ``h`` to ``dst``; backward receives its gradient from there."""

    @staticmethod
    def forward(fctx, h, dst: int, tag: int, group):
        fctx.dst, fctx.tag, fctx.group = dst, tag, group
        fctx.shape, fctx.dtype, fctx.device = h.shape, h.dtype, h.device
        dist.send(h.detach().contiguous(), dst, group=group, tag=tag)
        return h.new_zeros(())

    @staticmethod
    def backward(fctx, _g):
        g = torch.empty(fctx.shape, dtype=fctx.dtype, device=fctx.device)
        dist.recv(g, fctx.dst, group=fctx.group, tag=fctx.tag)
        return g, None, None, None


class _Recv(torch.autograd.Function):
    """Receive an activation from ``src``; backward sends its gradient
    back.  ``anchor`` (a one-element view of a parameter the stage runs)
    puts the receive on every path autograd keeps, so a gradient taken for
    the parameters still runs its backward; the activation lands on the
    anchor's device."""

    @staticmethod
    def forward(fctx, anchor, shape, dtype, src: int, tag: int, group):
        fctx.src, fctx.tag, fctx.group = src, tag, group
        fctx.adt, fctx.adev = anchor.dtype, anchor.device
        h = torch.empty(shape, dtype=dtype, device=anchor.device)
        dist.recv(h, src, group=group, tag=tag)
        return h

    @staticmethod
    def backward(fctx, g):
        dist.send(g.contiguous(), fctx.src, group=fctx.group, tag=fctx.tag)
        return (torch.zeros(1, dtype=fctx.adt, device=fctx.adev),
                None, None, None, None, None)


def make_pipeline_loss(plan: ExecutionPlan, mesh, n_microbatches: int,
                       pp_axis: Optional[str] = None):
    """Returns loss(params, batch) running a GPipe schedule over ``pp_axis``.

    ``params`` uses the standard lowering layout (DTensors under the
    plan's rules, or the whole tensors on every rank); each stage runs its
    contiguous run of the folded group's layers.  The stage assignment
    comes from the plan's recorded ShardingPlan when present
    (``plan.sharding`` — the ShardingPass's decision); ``pp_axis`` and the
    stage count then must agree with the runtime mesh.  Stage 0 embeds,
    the last stage takes the chunked cross-entropy; the loss is the mean
    over the microbatches, the same value on every rank.  ``loss.
    reduce_grads(grads)`` sums the local gradients of ``params`` over the
    dp axes and the stages (each stage holds only its layers' part)."""
    graph = plan.graph
    unit = _single_fold_unit(plan)
    ukey = lowering.unit_key(graph, unit)
    sp = plan.sharding
    spec = MeshSpec.of(mesh)
    if pp_axis is None:
        pp_axis = sp.pp_axis if sp is not None and sp.pp_axis else "pod"
    n_stages = spec.axis_size(pp_axis)
    if sp is not None and sp.pp_axis == pp_axis and sp.n_stages > 1:
        assert sp.n_stages == n_stages, (
            f"plan assigned {sp.n_stages} pipeline stages but mesh axis "
            f"{pp_axis!r} has size {n_stages}")
        assert len(sp.stage_of_layer) == unit.reps, (sp.stage_of_layer,
                                                     unit.reps)
        # the stages below run contiguous equal runs of the stacked layer
        # dim — exactly the assignment the pass records
        per = unit.reps // n_stages
        assert sp.stage_of_layer == tuple(r // per for r in range(unit.reps))
    assert unit.reps % n_stages == 0, (unit.reps, n_stages)
    per = unit.reps // n_stages
    nmb = n_microbatches
    cfg = plan.cfg
    if plan.rules is None:
        from repro_torch.flow import _rules_for
        plan = copy.copy(plan)
        plan.rules = _rules_for(mesh, plan.flow)
    rules = plan.rules
    apply = lowering._make_apply(plan, head=False)
    protos = [graph.blocks[i] for i in unit.indices[:unit.period]]
    embed_block = graph.blocks[0]
    head_block = graph.blocks[-1]
    ppg = mesh.get_group(mesh_dim=pp_axis)
    stage = dist.get_rank(ppg)
    ranks = dist.get_process_group_ranks(ppg)
    dt = torch.bfloat16 if plan.flow.precision == "bf16" else torch.float32

    def ctx_():
        return Ctx(mode="train", plan=plan, constrain=rules.constrain_act)

    def run_stage_layers(gparams, gdims, h, pos):
        dims = {k: d - 1 for k, d in gdims.items()}

        def one(x, acc, r):
            c = ctx_()
            e = {"h": x, "positions": pos, "cross": None}
            step = {k: v[stage * per + r] for k, v in gparams.items()}
            for j, blk in enumerate(protos):
                e["h"] = lowering._run_block(c, blk, step, e, "train", j=j,
                                             bdims=dims)
            return e["h"], acc
        h, _ = lowering._run_folded_train(one, per, plan.flow.remat, h, ())
        return h

    def embed(pv, tokens, pos):
        ep, edims = pv.unit(embed_block.name)
        env = {"h": tokens, "positions": pos}
        return lowering._run_block(ctx_(), embed_block, ep, env, "train",
                                   bdims=edims)

    def head_parts(pv, h, labels):
        ctx = ctx_()
        hp, hdims = pv.unit(head_block.name)
        env = {"h": h}
        for op in head_block.ops:
            if op.op == "unembed":
                break
            env[op.out] = OPS[op.op](
                ctx, op, lowering._op_params(ctx, op, hp, None, hdims),
                *[env[i] for i in op.ins])
        un = head_block.ops[-1]
        hn = env[un.ins[0]]
        if un.attrs.get("tied"):
            tp_, td = pv.unit(embed_block.name)
            table, tdim = tp_["table"], td.get("table")
        else:
            table, tdim = hp["lm_head"], hdims.get("lm_head")
        nll, cnt, _ = lowering._chunked_ce_sums(
            ctx, hn, table, labels, cfg.vocab_size,
            plan.tiles.get("ce_chunk", 256), tp_dim=tdim)
        cnt = col.all_reduce_(cnt.detach().clone(), rules.dp_groups)
        return nll / torch.clamp(cnt, min=1.0)

    def loss_fn(params, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        B = tokens.shape[0]
        assert B % nmb == 0
        m = B // nmb
        pv = apply.params_view(params)
        gparams, gdims = pv.unit(ukey)
        anchor = next(iter(gparams.values())).reshape(-1)[:1]
        parts, sends = [], []
        for i in range(nmb):
            toks = rules.local_batch(tokens[i * m:(i + 1) * m])
            labs = rules.local_batch(labels[i * m:(i + 1) * m])
            S = toks.shape[1]
            pos = torch.arange(S, dtype=torch.int32,
                               device=toks.device).expand(toks.shape[0], S)
            if stage == 0:
                h = embed(pv, toks, pos).to(dt)
            else:
                h = _Recv.apply(anchor, (toks.shape[0], S, cfg.d_model), dt,
                                ranks[stage - 1], i, ppg)
            h = run_stage_layers(gparams, gdims, h, pos)
            if stage < n_stages - 1:
                sends.append(_Send.apply(h, ranks[stage + 1], i, ppg))
            else:
                parts.append(head_parts(pv, h, labs))
        part = (sum(parts) / nmb if parts else 0.0 * sum(sends))
        return col.reduce_over(part, [ppg] + rules.dp_groups)

    shardings = rules.params_shardings(plan)

    def reduce_grads(grads):
        grads = rules.reduce_grads(grads, shardings)
        return _tree_all_reduce(grads, ppg)

    loss_fn.reduce_grads = reduce_grads
    return loss_fn


def _tree_all_reduce(tree, group):
    """Sum every leaf of a tree of local tensors over ``group``, in place."""
    if isinstance(tree, dict):
        return {k: _tree_all_reduce(v, group)
                for k, v in tree.items()}
    return col.all_reduce_(tree.contiguous(), [group])
