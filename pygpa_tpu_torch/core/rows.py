"""Row-sharded planes: the neighbour rows and reductions of a plane (...,
n, m) whose rows are split in equal blocks over the ranks of a process
group, in rank order (the row context of the multigrid unwrap and the
row-sharded pipeline, parallel/unwrap.py).

Every helper takes the context `rows` (a :class:`RowBlock`) or None;
with None it is the single-device torch call, so one implementation of
the stencils serves both. A rank holds its block (..., n / D, m); the
global row count is the block's rows times D.
"""
import torch
import torch.distributed as dist


class RowBlock:
    """This rank's block of the rows: `group` (a process group), this
    rank's index `rank` in it and the group's size `world`. Blocks lie in
    rank order, so the global last row sits on the last rank."""

    def __init__(self, group, rank, world):
        self.group, self.rank, self.world = group, int(rank), int(world)
        # global ranks of the ranks before and after this one, cyclic
        self._prev = dist.get_global_rank(group, (self.rank - 1) % self.world)
        self._next = dist.get_global_rank(group, (self.rank + 1) % self.world)

    @property
    def last(self):
        """Whether this rank holds the global last row."""
        return self.rank == self.world - 1

    def halo(self, x, shift):
        """The row beside the block x (..., r, m) over the global rows,
        cyclic, as (..., 1, m): for shift = 1 the row before it (the
        previous rank's last), for shift = -1 the row after it (the next
        rank's first). One send and one receive a rank."""
        if self.world == 1:
            return (x[..., -1:, :] if shift == 1 else x[..., :1, :]).clone()
        if shift == 1:
            out, to, frm = x[..., -1:, :], self._next, self._prev
        else:
            out, to, frm = x[..., :1, :], self._prev, self._next
        send = out.contiguous()
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, to, self.group),
               dist.P2POp(dist.irecv, recv, frm, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv

    def sum_(self, t):
        """All-reduce t (SUM) over the group, in place; returns t."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def all(self, b):
        """The logical AND of the bool tensor b over the group."""
        t = b.to(torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.group)
        return t.bool()


def roll_rows(x, shift, rows=None):
    """torch.roll(x, shift, -2) over the global rows, shift = 1 or -1."""
    if rows is None:
        return torch.roll(x, shift, -2)
    if shift == 1:
        return torch.cat([rows.halo(x, 1), x[..., :-1, :]], dim=-2)
    return torch.cat([x[..., 1:, :], rows.halo(x, -1)], dim=-2)


def clamped_neighbours(x, rows=None):
    """(prev, next): x shifted one row down and one row up over the
    global rows with the edge rows repeated (the linear resize's taps)."""
    if rows is None or rows.world == 1:
        return (torch.cat([x[..., :1, :], x[..., :-1, :]], dim=-2),
                torch.cat([x[..., 1:, :], x[..., -1:, :]], dim=-2))
    before = rows.halo(x, 1)
    after = rows.halo(x, -1)
    if rows.rank == 0:
        before = x[..., :1, :]
    if rows.last:
        after = x[..., -1:, :]
    return (torch.cat([before, x[..., :-1, :]], dim=-2),
            torch.cat([x[..., 1:, :], after], dim=-2))


def plane_sum(t, rows=None):
    """t summed over its last two axes, kept as (..., 1, 1), over the
    global rows."""
    s = t.sum((-2, -1), keepdim=True)
    return s if rows is None else rows.sum_(s)


def is_last_row(n, device, rows=None):
    """(n, 1) bool: which of the block's n rows is the global last row."""
    r = torch.arange(n, device=device)[:, None]
    if rows is not None and not rows.last:
        return r < 0
    return r == (n - 1)
