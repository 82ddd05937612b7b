"""The model's layout hooks under a mesh (DTensor operands).

The JAX package leaves a sharded step's layouts to XLA's sharding
propagation.  DTensor propagates op by op, has no rule for some of the
model's ops (an index-add, the backward of a cumsum) and picks some
layouts that cost more than the step needs.  The model therefore calls
one hook of ``models.layers.LAYOUT`` at each site where a step under a
mesh must place its values; ``models.layers.Layout`` is the plain op at
every site.  :class:`MeshLayout` is the same hooks for DTensor operands
(plain tensors still take the plain op), and :func:`mesh_layout`
installs it for a traced step (``launch/dryrun.py``'s ``lower_cell``).

Where DTensor has no sharding rule, the operands are replicated
(:func:`on_replicas`): the collective that costs is recorded like any
other.
"""
from __future__ import annotations

import contextlib

import torch
import torch.utils._pytree as pytree
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models import layers as L


@contextlib.contextmanager
def mesh_layout():
    """Run the block with :class:`MeshLayout` as the model's hooks."""
    prev = L.LAYOUT
    L.LAYOUT = MeshLayout()
    try:
        yield L.LAYOUT
    finally:
        L.LAYOUT = prev


def replicate(x):
    """``x`` whole on every device: a DTensor is redistributed to
    ``Replicate()`` on every mesh dim (one recorded collective); any
    other tensor is returned as is."""
    if isinstance(x, DTensor) and any(not p.is_replicate()
                                      for p in x.placements):
        return x.redistribute(x.device_mesh,
                              [Replicate()] * x.device_mesh.ndim)
    return x


def on_replicas(fn, *args):
    """``fn(*args)`` for an op DTensor has no sharding rule for: every
    DTensor operand is replicated (a recorded collective), ``fn`` runs on
    the local replicas, and each tensor it returns is a replicated
    DTensor on the same mesh.  Without DTensor operands it is
    ``fn(*args)``."""
    mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)),
                None)
    if mesh is None:
        return fn(*args)
    local = [replicate(a).to_local() if isinstance(a, DTensor) else a
             for a in args]
    return pytree.tree_map_only(
        torch.Tensor, lambda t: DTensor.from_local(
            t, mesh, [Replicate()] * mesh.ndim, run_check=False),
        fn(*local))


class _Layout(torch.autograd.Function):
    """Redistribute a DTensor to ``placements``, and its gradient to the
    same placements on the way back (a layout the backward would
    otherwise choose on its own, and may choose badly)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x if tuple(x.placements) == placements else \
            x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def _batch_split(p) -> bool:
    return p.is_shard() and p.dim == 0


def _local_view(dst, src, src_placements):
    """(dst's local shard, src redistributed to ``src_placements`` and
    taken local, dst's global offset) for an in-place write into a
    DTensor ``dst``."""
    mesh = dst.device_mesh
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    src = src.redistribute(mesh, src_placements)
    # Shard(d) on successive mesh dims splits dim d's chunk again.
    size, offset = list(dst.shape), [0] * dst.dim()
    for coord, n, p in zip(mesh.get_coordinate(), mesh.shape,
                           dst.placements):
        if p.is_shard():
            chunk = -(-size[p.dim] // n)
            offset[p.dim] += coord * chunk
            size[p.dim] = chunk
    return dst.to_local(), src.to_local(), offset


def _heads_layout(t, n_heads: int):
    """``t`` (B, S, H, hd) split over the batch as it is and over the
    "model" mesh dim by heads when H divides it, else whole there."""
    mesh = t.device_mesh
    pl = []
    for name, size, p in zip(mesh.mesh_dim_names, mesh.shape, t.placements):
        if _batch_split(p):
            pl.append(p)
        elif name == "model" and n_heads % size == 0:
            pl.append(Shard(2))
        else:
            pl.append(Replicate())
    return t.redistribute(mesh, pl)


class MeshLayout(L.Layout):
    """:class:`models.layers.Layout` for DTensor operands."""

    def weight(self, w, x):
        """The FSDP all-gather: ``w`` whole over every mesh dim on which
        ``x`` splits its batch (dim 0)."""
        if not (isinstance(w, DTensor) and isinstance(x, DTensor)):
            return w
        pl = [Replicate() if (_batch_split(px) and pw.is_shard()) else pw
              for px, pw in zip(x.placements, w.placements)]
        return w if pl == list(w.placements) else \
            w.redistribute(w.device_mesh, pl)

    def residual(self, x, like=None):
        """Split over the batch where ``x`` (or ``like``) splits it, and
        whole over every other mesh dim (a partial sum is all-reduced, a
        split of another dim all-gathered); the gradient takes the same
        layout."""
        if not isinstance(x, DTensor):
            return x
        like = like.placements if isinstance(like, DTensor) \
            else x.placements
        pl = [Shard(0) if (_batch_split(p) or _batch_split(q))
              else Replicate() for p, q in zip(x.placements, like)]
        return _Layout.apply(x, tuple(pl))

    def pin(self, x):
        if not isinstance(x, DTensor):
            return x
        return _Layout.apply(x, tuple(x.placements))

    def embed(self, table, ids):
        """A table split by rows over "model" is looked up vocab-parallel:
        each shard gathers the ids it holds (zeros for the rest) and the
        partial rows are summed, one all-reduce of the (B, S, d)
        result."""
        table = self.weight(table, ids)
        if not (isinstance(table, DTensor) and isinstance(ids, DTensor)):
            return super().embed(table, ids)
        mesh = table.device_mesh
        split = [i for i, p in enumerate(table.placements)
                 if _batch_split(p)]
        if any(p.is_shard() and p.dim != 0 for p in table.placements) or \
                len(split) > 1:
            table = table.redistribute(mesh, [
                p if (_batch_split(p) and i in split[:1]) else Replicate()
                for i, p in enumerate(table.placements)])
            split = split[:1]
        ids = ids.redistribute(mesh, [p if _batch_split(p) else Replicate()
                                      for p in ids.placements])
        local, lids = table.to_local(), ids.to_local().long()
        if split:
            n = local.shape[0]
            lo = mesh.get_coordinate()[split[0]] * n
            hit = (lids >= lo) & (lids < lo + n)
            rows = local[torch.where(hit, lids - lo, 0)] * hit[..., None]
        else:
            rows = local[lids]
        return DTensor.from_local(
            rows, mesh, [Partial() if i in split else ids.placements[i]
                         for i in range(mesh.ndim)], run_check=False)

    def split_heads(self, t, n_heads: int):
        """A split of the last dim on a mesh dim that H does not divide
        is first made whole there (a split must fall between heads)."""
        if isinstance(t, DTensor):
            mesh = t.device_mesh
            pl = [Replicate() if (p.is_shard() and p.dim == t.dim() - 1
                                  and n_heads % size) else p
                  for size, p in zip(mesh.shape, t.placements)]
            if pl != list(t.placements):
                t = t.redistribute(mesh, pl)
        return super().split_heads(t, n_heads)

    def attention_heads(self, q, k, v):
        """Megatron's layout: heads split over "model" where they divide
        it.  When the query heads divide it and the kv heads do not
        (GQA), k and v are repeated to one head a query head first, so
        every shard holds its heads' keys."""
        if not isinstance(q, DTensor):
            return q, k, v
        hq, hkv = q.shape[2], k.shape[2]
        q = _heads_layout(q, hq)
        split_q = any(p.is_shard() and p.dim == 2 for p in q.placements)
        if split_q and hkv != hq and not any(
                p.is_shard() and p.dim == 2 for p in
                _heads_layout(k, hkv).placements):
            k = self.residual(k).repeat_interleave(hq // hkv, dim=2)
            v = self.residual(v).repeat_interleave(hq // hkv, dim=2)
            hkv = hq
        return q, _heads_layout(k, hkv), _heads_layout(v, hkv)

    def attend(self, fn, q, k, v, **kw):
        """Split over batch and heads only, attention is independent per
        shard: it runs on the local shards (as a shard_map would)."""
        if isinstance(q, DTensor) and isinstance(k, DTensor) and \
                k.placements == q.placements and not any(
                    p.is_shard() and p.dim == 1 for p in q.placements):
            out = fn(q.to_local(), k.to_local(), v.redistribute(
                q.device_mesh, q.placements).to_local(), **kw)
            return DTensor.from_local(out, q.device_mesh, q.placements,
                                      run_check=False)
        return fn(q, k, v, **kw)

    def cache_queries(self, q, k):
        """A cache split along its sequence stays where it lies: the
        queries come whole to every shard of the sequence."""
        if not (isinstance(k, DTensor) and isinstance(q, DTensor)):
            return q
        split = [i for i, p in enumerate(k.placements)
                 if p.is_shard() and p.dim == 1]
        if not split:
            return q
        pl = list(q.placements)
        for i in split:
            pl[i] = Replicate()
        return q.redistribute(q.device_mesh, pl)

    def write_rows_(self, cache, pos, x):
        """Each device writes the rows and positions it holds."""
        if not isinstance(cache, DTensor):
            return super().write_rows_(cache, pos, x)
        pos = torch.clamp(pos, 0, cache.shape[1] - 1).long()
        # x takes the cache's placements, its length-1 sequence dim whole.
        place = [Replicate() if (p.is_shard() and p.dim == 1) else p
                 for p in cache.placements]
        local, xl, (r0, s0, *_rest) = _local_view(cache, x.to(cache.dtype),
                                                  place)
        n, s_loc = local.shape[0], local.shape[1]
        if isinstance(pos, DTensor):
            pos = pos.full_tensor()
        at = pos[r0:r0 + n] - s0
        keep = (at >= 0) & (at < s_loc)
        at = torch.clamp(at, 0, s_loc - 1)
        rows = torch.arange(n, device=local.device)
        keep = keep.reshape(n, *([1] * (local.dim() - 2)))
        local[rows, at] = torch.where(keep, xl[:, 0], local[rows, at])

    def write_prefix_(self, cache, x):
        """Written shard by shard; the cache's sequence dim may be split
        only when x fills it."""
        if not isinstance(cache, DTensor):
            return super().write_prefix_(cache, x)
        seq_sharded = any(p.is_shard() and p.dim == 1
                          for p in cache.placements)
        if seq_sharded and x.shape[1] != cache.shape[1]:
            raise ValueError("a sequence-sharded cache takes a prefill of "
                             "its full length")
        local, xl, _offset = _local_view(cache, x.to(cache.dtype),
                                         cache.placements)
        local[:, :xl.shape[1]] = xl

    def nll_sum(self, logits, labels, mask):
        """Vocab-parallel cross-entropy: no op needs a whole vocab row on
        one device.  The max and the sum of exponentials reduce across
        the vocab shards, and each label's logit is picked by a one-hot
        product."""
        if not isinstance(logits, DTensor):
            return super().nll_sum(logits, labels, mask)
        lf = self.pin(logits.float())
        m = lf.amax(dim=-1, keepdim=True).detach()
        lse = m[..., 0] + torch.log(torch.exp(lf - m).sum(dim=-1))
        hot = torch.nn.functional.one_hot(labels.clamp_min(0),
                                          lf.shape[-1]).to(lf.dtype)
        return ((lse - (lf * hot).sum(dim=-1)) * mask).sum()

    def constrain(self, x, spec):
        """Lay ``x`` out as the pspec ``spec`` (the JAX package's one
        sharding constraint, on the MoE dispatch buffer)."""
        if spec is None or not isinstance(x, DTensor):
            return x
        from repro_torch.distribution.sharding import to_placements
        return x.redistribute(x.device_mesh,
                              to_placements(spec, x.device_mesh))

    def dispatch_buffer(self, xt, rows: int):
        """Whole on every device, its rows padded to a multiple of the
        device count so any layout of them is even (the padding rows
        stay unused)."""
        if not isinstance(xt, DTensor):
            return super().dispatch_buffer(xt, rows)
        mesh = xt.device_mesh
        n = mesh.size()
        local = torch.zeros((-(-rows // n) * n, xt.shape[1]),
                            dtype=xt.dtype, device=xt.to_local().device)
        return DTensor.from_local(local, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)

    def scatter_add(self, buf, idx, xt, spec=None):
        """DTensor has no sharding rule for index_add: the scatter runs
        on replicas, then the buffer takes ``spec``'s layout again."""
        if not isinstance(buf, DTensor):
            return super().scatter_add(buf, idx, xt, spec)
        return self.constrain(on_replicas(
            lambda bb, ii, xx: bb.index_add(0, ii, xx), buf, idx, xt), spec)

    def take_rows(self, out_e, out_flat, idx):
        """The experts stay split as they are: every device gathers the
        rows its experts hold for its tokens (zeros for the rest), and
        the partial rows are summed later, one all-reduce of the (N, d)
        result, never a gather of the whole expert output."""
        if not isinstance(out_e, DTensor):
            return super().take_rows(out_e, out_flat, idx)
        mesh = out_e.device_mesh
        split = [i for i, p in enumerate(out_e.placements)
                 if _batch_split(p)]
        out_e = out_e.redistribute(mesh, [Shard(0) if i in split[:1]
                                          else Replicate()
                                          for i in range(mesh.ndim)])
        idx = idx.redistribute(mesh, [p if _batch_split(p) else Replicate()
                                      for p in idx.placements])
        local, lidx = out_e.to_local(), idx.to_local().long()
        e_loc, cap = local.shape[0], local.shape[1]
        lo = mesh.get_coordinate()[split[0]] * e_loc * cap if split else 0
        hit = (lidx >= lo) & (lidx < lo + e_loc * cap)
        rows = local.reshape(e_loc * cap, -1)[torch.where(hit, lidx - lo,
                                                          0)]
        rows = rows * hit[:, None].to(rows.dtype)
        return DTensor.from_local(
            rows, mesh, [Partial() if i in split[:1] else idx.placements[i]
                         for i in range(mesh.ndim)], run_check=False)

    def cumsum(self, x, dim: int = -1):
        """Not split along ``dim``, each shard sums its local part, so
        the backward (a flip, which DTensor has no sharding rule for)
        runs on plain tensors."""
        if isinstance(x, DTensor) and not any(
                p.is_shard() and p.dim == dim % x.dim()
                for p in x.placements):
            return DTensor.from_local(torch.cumsum(x.to_local(), dim),
                                      x.device_mesh, x.placements,
                                      run_check=False)
        return super().cumsum(x, dim)

    def ssm_readout(self, c, state):
        """A product and a sum over the state dim (the einsum's batched
        matmul would flatten the split heads), then whole over the heads
        for the gated norm across them."""
        if not isinstance(state, DTensor):
            return super().ssm_readout(c, state)
        return self.residual((state * c.float()[:, None, None, :]).sum(-1))

    def per_shard(self, fn, x):
        """``fn`` maps each block of rows on its own (a split of ``x``'s
        rows is the same split of ``fn(x)``'s): each shard applies it to
        its own rows."""
        if not isinstance(x, DTensor):
            return fn(x)
        return DTensor.from_local(fn(x.to_local()), x.device_mesh,
                                  x.placements, run_check=False)
