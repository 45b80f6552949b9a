"""Token embedding, the language-model loss and greedy sampling over the
(tied) embedding table: ``repro.models.embedloss``.

Without a mesh each is a local computation. Under a mesh whose 'vocab'
axis divides the table, the table stays sharded over that axis on its
vocab dim and these branches (the reference's ``shard_map``s) keep it in
place:

- ``embed_in``: each shard embeds every token against its vocab slice
  (misses give zeros) and the partial activations reduce-scatter onto the
  sequence axis, so the output arrives sequence-sharded;
- ``lm_loss``: vocab-parallel cross-entropy, the activations gathered
  over the sequence axis once, each shard's logits in sequence chunks,
  log-sum-exp and gold logits combined by ``pmax`` / ``psum``, with the
  reference's hand-written backward (``_LMLossSharded``);
- ``greedy``: a local top-1 per shard and a global max combine.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import matmul_f32
from repro_torch.sharding import rules

_NEG = -1e30


def _vocab_axis(v: int):
    ctx = rules.current_ctx()
    axes = ctx.mesh_axes("vocab")
    if ctx.mesh is None or not axes or v % ctx.axes_size("vocab"):
        return None
    return axes[0]


def embed_in(table: torch.Tensor, tokens: torch.Tensor,
             compute_dtype: torch.dtype) -> torch.Tensor:
    """table (V, D); tokens (B, S) -> x (B, S, D). ``F.embedding`` gathers
    the same rows as ``table[tokens]``; its CUDA backward sums the rows'
    gradients by sorting the tokens, deterministically, where indexing's
    accumulates with fp32 atomics in an order that varies from run to
    run. Under a mesh: vocab-parallel, the output sequence-sharded when
    the sequence divides the vocab axis."""
    axis = _vocab_axis(table.shape[0])
    if axis is None:
        return F.embedding(tokens, table).to(compute_dtype)
    ctx = rules.current_ctx()
    mesh = ctx.mesh
    b, s = tokens.shape
    tp = rules.mesh_shape(mesh)[axis]
    bspec = ctx.spec(("batch",), (b,))[0]
    seq_ok = s % tp == 0

    def f(tbl, tok):
        lo = rules.axis_index(mesh, axis) * tbl.shape[0]
        ids = tok.long() - lo
        ok = (ids >= 0) & (ids < tbl.shape[0])
        rows = F.embedding(ids.clamp(0, tbl.shape[0] - 1), tbl)
        part = torch.where(ok[..., None], rows, 0).float()
        if seq_ok:   # arrive sequence-sharded: reduce-scatter over seq
            out = rules.psum_scatter(part, mesh, axis, 1)
        else:
            out = rules.psum(part, mesh, axis)
        return out.to(compute_dtype)

    return rules.shard_map(
        f, mesh=mesh, in_specs=((axis, None), (bspec, None)),
        out_specs=(bspec, axis if seq_ok else None, None))(table, tokens)


def lm_loss(x: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
            valid_vocab: int | None = None, seq_chunk: int = 1024
            ) -> torch.Tensor:
    """Mean cross-entropy over the tokens whose label is >= 0: x (B, S, D),
    table (Vp, D), labels (B, S). Columns at or past ``valid_vocab`` (the
    vocab padding) are masked out of the softmax. Under a mesh with a
    vocab axis: the vocab-parallel :class:`_LMLossSharded`."""
    valid = valid_vocab or table.shape[0]
    axis = _vocab_axis(table.shape[0])
    if axis is None:
        return _ce_chunked(x, table, labels, valid, seq_chunk)
    mesh, bspec, batch_axes, seq_sharded, xspec = _plan(x, axis)

    def f(xx, tbl, lab):
        return _LMLossSharded.apply(xx, tbl, lab, valid, seq_chunk, mesh,
                                    axis, batch_axes, seq_sharded)

    return rules.shard_map(
        f, mesh=mesh, in_specs=(xspec, (axis, None), (bspec, None)),
        out_specs=(), whole_grads=True)(x, table, labels)


def _plan(x, axis):
    """(mesh, batch spec, batch axes, whether x is sequence-sharded, x's
    spec) of the sharded loss."""
    ctx = rules.current_ctx()
    b, s, _ = x.shape
    bspec = ctx.spec(("batch",), (b,))[0]
    seq_sharded = s % rules.mesh_shape(ctx.mesh)[axis] == 0
    return (ctx.mesh, bspec, rules.spec_axes(bspec), seq_sharded,
            (bspec, axis if seq_sharded else None, None))


def _loss_chunks(xx, lab, seq_chunk):
    """The (B, cs, D) and (B, cs) chunks of the reference's ``_chunks``:
    ``n = S // min(seq_chunk, S)`` of ``S // n`` positions, which must
    tile S."""
    s = lab.shape[1]
    n_chunk = max(s // min(seq_chunk, s), 1)
    cs = s // n_chunk
    if n_chunk * cs != s:
        raise ValueError(f"sequence {s} does not split into {n_chunk} "
                         f"chunks of {cs}")
    return [(xx[:, i * cs:(i + 1) * cs], lab[:, i * cs:(i + 1) * cs])
            for i in range(n_chunk)]


class _LMLossSharded(torch.autograd.Function):
    """The reference's ``_lm_loss_sharded`` custom VJP on one rank's
    shards: x (B_l, S_l, D) (its sequence shard when ``seq_sharded``), the
    table's vocab slice (V_l, D) and the labels (B_l, S). The backward
    recomputes each chunk's softmax, d logits = (softmax - onehot) * mask
    * g / N; the x gradient reduce-scatters onto the sequence shards (or
    sums over the vocab axis) and the table's sums over the batch axes,
    so both come back whole for this rank's shards."""

    @staticmethod
    def forward(ctx, xx, tbl, lab, valid, seq_chunk, mesh, axis, batch_axes,
                seq_sharded):
        ctx.save_for_backward(xx, tbl, lab)
        ctx.args = (valid, seq_chunk, mesh, axis, batch_axes, seq_sharded)
        if seq_sharded:
            xx = rules.all_gather(xx, mesh, axis, 1)
        lo = rules.axis_index(mesh, axis) * tbl.shape[0]
        col_ok = (lo + torch.arange(tbl.shape[0], device=tbl.device)) < valid
        tbl32 = tbl.float()
        tot = xx.new_zeros((), dtype=torch.float32)
        n = xx.new_zeros((), dtype=torch.float32)
        for xc, lc in _loss_chunks(xx, lab, seq_chunk):
            logits = torch.where(col_ok, xc.float() @ tbl32.T, _NEG)
            gm = rules.pmax(logits.amax(-1), mesh, axis)
            se = torch.where(col_ok, torch.exp(logits - gm[..., None]),
                             0.0).sum(-1)
            se = rules.psum(se, mesh, axis)
            ids = lc.long() - lo
            ok = (ids >= 0) & (ids < tbl.shape[0])
            gold = logits.gather(
                -1, ids.clamp(0, tbl.shape[0] - 1)[..., None])[..., 0]
            gold = rules.psum(torch.where(ok, gold, 0.0), mesh, axis)
            nll = gm + torch.log(se) - gold
            mask = (lc >= 0).float()
            tot = tot + (nll * mask).sum()
            n = n + mask.sum()
        if batch_axes:   # the global token mean across the data shards
            tot = rules.psum(tot, mesh, batch_axes)
            n = rules.psum(n, mesh, batch_axes)
        return tot / n.clamp(min=1.0)

    @staticmethod
    def backward(ctx, g):
        xx, tbl, lab = ctx.saved_tensors
        valid, seq_chunk, mesh, axis, batch_axes, seq_sharded = ctx.args
        x_dtype = xx.dtype
        if seq_sharded:
            xx = rules.all_gather(xx, mesh, axis, 1)
        vl = tbl.shape[0]
        lo = rules.axis_index(mesh, axis) * vl
        col_ok = (lo + torch.arange(vl, device=tbl.device)) < valid
        tbl32 = tbl.float()
        n = (lab >= 0).float().sum()
        if batch_axes:
            n = rules.psum(n, mesh, batch_axes)
        scale = g.float() / n.clamp(min=1.0)
        gt = torch.zeros(tbl.shape, dtype=torch.float32, device=tbl.device)
        gx = []
        for xc, lc in _loss_chunks(xx, lab, seq_chunk):
            xc32 = xc.float()
            logits = torch.where(col_ok, xc32 @ tbl32.T, _NEG)
            gm = rules.pmax(logits.amax(-1), mesh, axis)
            e = torch.where(col_ok, torch.exp(logits - gm[..., None]), 0.0)
            se = rules.psum(e.sum(-1), mesh, axis)
            ids = lc.long() - lo
            ok = (ids >= 0) & (ids < vl)
            onehot = F.one_hot(torch.where(ok, ids, vl), vl + 1)[..., :vl]
            mask = (lc >= 0).float()[..., None]
            dlog = (e / se[..., None] - onehot.float()) * mask * scale
            gx.append(dlog @ tbl32)            # partial over the vocab
            gt = gt + torch.einsum("bcv,bcd->vd", dlog, xc32)
        gx = torch.cat(gx, dim=1)
        if seq_sharded:   # the transpose of the gather: reduce-scatter
            gx = rules.psum_scatter(gx, mesh, axis, 1)
        else:
            gx = rules.psum(gx, mesh, axis)
        if batch_axes:    # the table's gradient sums over the data shards
            gt = rules.psum(gt, mesh, batch_axes)
        return (gx.to(x_dtype), gt.to(tbl.dtype), None, None, None, None,
                None, None, None)


def _ce_chunked(x, table, labels, valid: int, seq_chunk: int):
    """Chunked CE, as the reference's: ``n = S // min(seq_chunk, S)``
    chunks of ``S // n`` positions plus the ragged remainder, each chunk's
    logits in fp32, so the (B, S, Vp) logits are never whole."""
    b, s, _ = x.shape
    v = table.shape[0]
    tbl32 = table.float()
    col_ok = torch.arange(v, device=x.device) < valid
    n_chunk = max(s // min(seq_chunk, s), 1)
    cs = s // n_chunk

    def chunk_nll(xc, lc):
        logits = (xc.float() @ tbl32.T).masked_fill(~col_ok, -torch.inf)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, lc.clamp(0, v - 1).long()[..., None])[..., 0]
        mask = (lc >= 0).float()
        return ((lse - gold) * mask).sum(), mask.sum()

    sums = [chunk_nll(x[:, i * cs:(i + 1) * cs],
                      labels[:, i * cs:(i + 1) * cs]) for i in range(n_chunk)]
    tot = torch.stack([t for t, _ in sums]).sum()
    n = torch.stack([c for _, c in sums]).sum()
    if s > n_chunk * cs:
        t, c = chunk_nll(x[:, n_chunk * cs:], labels[:, n_chunk * cs:])
        tot, n = tot + t, n + c
    return tot / n.clamp(min=1.0)


def greedy(x: torch.Tensor, table: torch.Tensor,
           valid_vocab: int | None = None) -> torch.Tensor:
    """Greedy next-token ids (int32). x (B, D); table (Vp, D). Columns at
    or past ``valid_vocab`` (the vocab padding) are never chosen. The fp32
    logits of a bf16 ``x`` and table on CUDA come from one product with
    fp32 output, without the widened (Vp, D) copy of the table. Under a
    mesh with a vocab axis: each shard's top-1, combined by ``pmax``."""
    v = table.shape[0]
    valid = valid_vocab or v
    axis = _vocab_axis(v)
    if axis is None:
        logits = matmul_f32(x, table.T)
        logits[:, valid:].fill_(-torch.inf)
        return logits.argmax(dim=-1).to(torch.int32)
    ctx = rules.current_ctx()
    mesh = ctx.mesh
    bspec = ctx.spec(("batch",), (x.shape[0],))[0]

    def f(xx, tbl):
        lo = rules.axis_index(mesh, axis) * tbl.shape[0]
        logits = matmul_f32(xx, tbl.T)
        col_ok = (lo + torch.arange(tbl.shape[0], device=tbl.device)) < valid
        logits = logits.masked_fill(~col_ok, -torch.inf)
        best = logits.argmax(dim=-1)
        val = logits.gather(-1, best[:, None])[:, 0]
        gbest = rules.pmax(val, mesh, axis)
        tok = torch.where(val >= gbest, best + lo, -1)
        return rules.pmax(tok, mesh, axis).to(torch.int32)

    return rules.shard_map(
        f, mesh=mesh, in_specs=((bspec, None), (axis, None)),
        out_specs=(bspec,))(x, table)
