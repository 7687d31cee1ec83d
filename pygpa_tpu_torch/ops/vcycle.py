"""Fused V-branch stencil passes of the multigrid unwrap.

Replaces the TPU kernels ``pygpa_tpu/ops/pallas_vcycle.py``
``_presmooth_kernel`` (entry ``presmooth``) and ``_applyq_kernel``
(entry ``applyq``). Both implement the aligned cyclic stencils of
solvers/unwrap.py entry for entry: every wrap-around term is killed by
a structural zero tail or the global-edge row mask, so the cyclic
neighbour IS the reference semantics.

- presmooth(phi, dxc, dyc, w, cr, omega) -> (r, d, Dinv, rrow):
  residual gradients of phi, min-neighbour weights, weighted residual
  rk, Dinv = omega / diag(Q) (|diag| <= 1e-8 gated to 0), d = Dinv rk,
  r = rk - Q d, and rrow = r with rows block-averaged by `cr` (the row
  half of the restriction; the caller finishes the columns).
- applyq(p, w) -> Q p with the weights rebuilt from w.

CUDA route (``csrc/vcycle.cu``): presmooth walks column strips down
the rows, a 128-thread block owning 124 output columns and a 2-column
halo on each side, two planes of one image in one block (w and the
weights, D and Dinv built once), one input row a step and output row k - 2 at
step k (the chain needs neighbours of neighbours); applyq marches the
same way over a one-pixel neighbourhood, a warp owning 128 columns (4 a
lane, 16-byte loads where the rows allow) and a strip of rows, the x
neighbours passed between lanes by warp shuffles, and writes row k - 1
at step k. Both are bound by device memory and use round-to-nearest
intrinsics without FMA contraction, so the kernel's arithmetic is the
twin's, operation for operation, and applyq's outputs are the twin's
bits.

phi, dxc, dyc and p carry batch axes (..., C, n, m): the displacement
components and, for a stack, the images. w (..., n, m) broadcasts
against them with its axes leading: (n, m) is one weight shared by
every plane, (B, 1, n, m) beside planes (B, C, n, m) is image b's own
weight for its C planes; Dinv comes back shaped like w. Each block
takes up to PRESMOOTH_PLANES planes of one image, its groups on one
grid axis, so a stack runs in one launch (two where C is odd and > 1).
The multigrid takes the
kernels where :func:`vcycle_kernel_ok` holds and the twins elsewhere,
as the reference routes by its ``_vcycle_kernel_ok``; a wrapper handed
a CUDA tensor outside the kernels' limits raises.
"""
import torch

from . import _build
from ..core.rows import is_last_row, roll_rows

PRESMOOTH_ROWS = 16   # the gate's row and column multiples
PRESMOOTH_COLS = 32
PRESMOOTH_THREADS = 128                     # csrc/vcycle.cu PT: staged columns
PRESMOOTH_TILE = PRESMOOTH_THREADS - 4      # output columns a block
PRESMOOTH_BLOCKS_PER_SM = 8                 # its launch bounds
PRESMOOTH_PLANES = 2                        # planes of an image a block (MAXB)
APPLYQ_COLS = 128                           # csrc/vcycle.cu QCOLS: columns a warp
APPLYQ_WARPS = 4                            # warps a block (QT / 32)
APPLYQ_BLOCKS_PER_SM = 4                    # its launch bounds
APPLYQ_MIN_ROWS = 16                        # fewest rows a strip
MAX_GROUPS = 65535                          # CUDA's gridDim.y/z limit


def supported(n, m, cr):
    """Shapes the presmooth kernel takes: n % PRESMOOTH_ROWS, m %
    PRESMOOTH_COLS, a coarse factor cr dividing PRESMOOTH_ROWS, n, m >=
    3 (the reference's pallas_vcycle.supported read for the card; the
    kernel itself masks partial column tiles and row strips)."""
    cr = int(cr)
    return (n % PRESMOOTH_ROWS == 0 and m % PRESMOOTH_COLS == 0
            and cr >= 1 and PRESMOOTH_ROWS % cr == 0 and n >= 3 and m >= 3)


def presmooth_tiling(n, m, sms):
    """(output rows a block, grid (column tiles, row strips)) of the
    presmooth kernel on a card with `sms` SMs: PRESMOOTH_TILE output
    columns a block; row strips of a multiple of PRESMOOTH_ROWS rows
    (so of every coarse factor), as few as fill the card in one wave of
    PRESMOOTH_BLOCKS_PER_SM blocks an SM, so each block's 4 halo rows
    are spread over as many output rows as that allows."""
    tiles = -(-m // PRESMOOTH_TILE)
    strips = max(1, sms * PRESMOOTH_BLOCKS_PER_SM // tiles)
    rows = -(-n // strips)
    rows = -(-rows // PRESMOOTH_ROWS) * PRESMOOTH_ROWS
    return rows, (tiles, -(-n // rows))


def _groups(B, images):
    """Block groups of B planes in `images` images: up to
    PRESMOOTH_PLANES planes of one image a group."""
    return images * -(-(B // images) // PRESMOOTH_PLANES)


def presmooth_traffic(B, n, m, cr, sms, images=1):
    """Bytes the presmooth kernel moves on a card with `sms` SMs for B
    planes in `images` images: every block reads its PRESMOOTH_THREADS
    columns of rows + 4 input rows (its image's w once a group of up to
    PRESMOOTH_PLANES planes, phi, dxc, dyc each plane) and writes r, d,
    rrow and each image's Dinv once."""
    rows, (tiles, strips) = presmooth_tiling(n, m, sms)
    rows_read = sum(min(rows, n - k * rows) + 4 for k in range(strips))
    reads = (3 * B + _groups(B, images)) * rows_read * tiles \
        * PRESMOOTH_THREADS
    writes = (2 * B + images) * n * m + B * (n // cr) * m
    return 4 * (reads + writes)


def applyq_tiling(n, m, sms):
    """(output rows a warp, (column tiles, row strips)) of the applyq
    kernel on a card with `sms` SMs: APPLYQ_COLS columns a warp; row
    strips as few as fill the card in one wave of APPLYQ_BLOCKS_PER_SM
    blocks of APPLYQ_WARPS warps an SM, and at least APPLYQ_MIN_ROWS
    rows (or n), so each strip's 2 halo rows are spread over as many
    output rows as that allows."""
    tiles = -(-m // APPLYQ_COLS)
    strips = max(1, sms * APPLYQ_BLOCKS_PER_SM * APPLYQ_WARPS // tiles)
    rows = max(min(APPLYQ_MIN_ROWS, n), -(-n // strips))
    return rows, (tiles, -(-n // rows))


def applyq_traffic(B, n, m, sms, images=1):
    """Bytes the applyq kernel moves on a card with `sms` SMs for B
    planes in `images` images: every warp reads its APPLYQ_COLS columns
    and 2 halo columns of rows + 2 input rows (its image's w once a
    group of up to PRESMOOTH_PLANES planes, p each plane) and writes its
    rows of q once."""
    rows, (tiles, strips) = applyq_tiling(n, m, sms)
    rows_read = sum(min(rows, n - k * rows) + 2 for k in range(strips))
    reads = (B + _groups(B, images)) * rows_read * tiles * (APPLYQ_COLS + 2)
    return 4 * (reads + B * n * m)


def vcycle_kernel_ok(phi, w, cr):
    """The reference's _vcycle_kernel_ok read for the card: the V-branch
    kernels take CUDA float32 planes phi (..., n, m) and w (..., n, m)
    whose shape and coarse factor cr the kernels support."""
    n, m = phi.shape[-2:]
    return (phi.device.type == "cuda" and phi.dtype == torch.float32
            and w.dtype == torch.float32 and supported(n, m, cr))


def _masks(n, m, device, rows=None):
    lane = torch.arange(m, device=device)[None, :] < (m - 1)
    return lane, ~is_last_row(n, device, rows)


def _weights(w, lane, row, rows=None):
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    WW = w * w
    WWx = torch.where(lane, torch.minimum(WW, torch.roll(WW, -1, -1)), zero)
    WWy = torch.where(row, torch.minimum(WW, roll_rows(WW, -1, rows)), zero)
    return WWx, WWy


def _q(p, WWx, WWy, rows=None):
    tx = WWx * (torch.roll(p, -1, -1) - p)
    ty = WWy * (roll_rows(p, -1, rows) - p)
    return tx - torch.roll(tx, 1, -1) + ty - roll_rows(ty, 1, rows)


def presmooth_plain(phi, dxc, dyc, w, cr, omega, rows=None):
    """Plain PyTorch twin of the presmooth kernel; `rows`, a
    core.rows.RowBlock, runs it on this rank's block of the rows (the
    row-sharded multigrid), its row neighbours from the adjacent ranks."""
    n, m = phi.shape[-2:]
    lane, row = _masks(n, m, phi.device, rows)
    zero = torch.zeros((), dtype=phi.dtype, device=phi.device)
    WWx, WWy = _weights(w, lane, row, rows)
    rdx = dxc - torch.where(lane, torch.roll(phi, -1, -1) - phi, zero)
    rdy = dyc - torch.where(row, roll_rows(phi, -1, rows) - phi, zero)
    WWdx = WWx * rdx
    WWdy = WWy * rdy
    rk = WWdx - torch.roll(WWdx, 1, -1) + WWdy - roll_rows(WWdy, 1, rows)
    D = -(WWx + torch.roll(WWx, 1, -1) + WWy + roll_rows(WWy, 1, rows))
    one = torch.ones((), dtype=phi.dtype, device=phi.device)
    dinv = torch.where(D.abs() > 1e-8,
                       float(omega) / torch.where(D != 0, D, one), zero)
    d = rk * dinv
    r = rk - _q(d, WWx, WWy, rows)
    # rows past the last whole block of cr (shapes the kernel refuses)
    # do not enter the restriction, as in the multigrid's block means
    rows = n // cr
    rrow = r[..., : rows * cr, :].reshape(r.shape[:-2] + (rows, cr, m)) \
        .mean(-2)
    return r, d, dinv, rrow


def applyq_plain(p, w, rows=None):
    """Plain PyTorch twin of the applyq kernel (`rows` as
    :func:`presmooth_plain` takes it)."""
    n, m = p.shape[-2:]
    lane, row = _masks(n, m, p.device, rows)
    WWx, WWy = _weights(w, lane, row, rows)
    return _q(p, WWx, WWy, rows)


def _batched(x, n, m):
    """(B, n, m) contiguous view of a (..., n, m) tensor."""
    return x.reshape((-1, n, m)).contiguous()


def image_axis(op, planes, w):
    """(I, C): the planes (..., n, m) as I images of C planes each, image
    i's weight w[i], for a weight w (..., n, m) that broadcasts against
    them with its axes leading (all its leading sizes 1: one image of
    every plane). Raises for any other weight."""
    n, m = planes.shape[-2:]
    lead = tuple(planes.shape[:-2])
    wl = tuple(w.shape[:-2])
    if tuple(w.shape[-2:]) != (n, m) or len(wl) > len(lead):
        raise ValueError(f"{op}: weight {tuple(w.shape)} does not match "
                         f"planes {tuple(planes.shape)}")
    wl = (1,) * (len(lead) - len(wl)) + wl
    k = max((j + 1 for j, s in enumerate(wl) if s != 1), default=0)
    if wl[:k] != lead[:k] or any(s != 1 for s in wl[k:]):
        raise ValueError(f"{op}: weight {tuple(w.shape)} must broadcast "
                         f"against planes {tuple(planes.shape)} with its "
                         "image axes leading")
    I = int(torch.Size(lead[:k]).numel())
    C = int(torch.Size(lead[k:]).numel())
    if I * -(-C // PRESMOOTH_PLANES) > MAX_GROUPS:
        raise ValueError(f"{op}: {I} images of {C} planes take more block "
                         f"groups than CUDA's grid limit of {MAX_GROUPS}")
    return I, C


def presmooth(phi, dxc, dyc, w, cr, omega):
    """Fused V-branch pre-smooth: (r, d, Dinv, rrow) with r, d shaped
    like phi, Dinv like w and rrow (..., n/cr, m); w (..., n, m) as
    :func:`image_axis` takes it."""
    if phi.device.type == "cpu":
        return presmooth_plain(phi, dxc, dyc, w, int(cr), omega)
    if phi.device.type != "cuda":
        raise ValueError(f"presmooth: unsupported device {phi.device}")
    n, m = phi.shape[-2:]
    cr = int(cr)
    if not supported(n, m, cr):
        raise ValueError(
            f"presmooth kernel needs n % {PRESMOOTH_ROWS} == 0, m % "
            f"{PRESMOOTH_COLS} == 0 and cr dividing {PRESMOOTH_ROWS} "
            f"(got n={n}, m={m}, cr={cr})")
    lead = phi.shape[:-2]
    I, C = image_axis("presmooth", phi, w)
    phi_b, dxc_b, dyc_b, w_b = (_batched(t, n, m)
                                for t in (phi, dxc, dyc, w))
    B = phi_b.shape[0]
    for name, t, shape in (("phi", phi_b, (B, n, m)), ("dxc", dxc_b,
                           (B, n, m)), ("dyc", dyc_b, (B, n, m)),
                           ("w", w_b, (I, n, m))):
        _build.check_tensor("presmooth", name, t, shape, torch.float32,
                            phi.device)
    r = torch.empty_like(phi_b)
    d = torch.empty_like(phi_b)
    dinv = torch.empty_like(w_b)
    rrow = torch.empty((B, n // cr, m), dtype=phi.dtype, device=phi.device)
    with torch.cuda.device(phi.device):
        props = torch.cuda.get_device_properties(phi.device)
        rows, _ = presmooth_tiling(n, m, props.multi_processor_count)
        fn = _build.bind("vcycle_presmooth", "ppppppppiiiiiifp")
        _build.check(fn(phi_b.data_ptr(), dxc_b.data_ptr(), dyc_b.data_ptr(),
                        w_b.data_ptr(), r.data_ptr(), d.data_ptr(),
                        dinv.data_ptr(), rrow.data_ptr(), I, C, n, m, rows,
                        cr, float(omega),
                        torch.cuda.current_stream(phi.device).cuda_stream),
                     "vcycle_presmooth")
    _build.launches["presmooth"] += 1
    return (r.reshape(lead + (n, m)), d.reshape(lead + (n, m)),
            dinv.reshape(w.shape), rrow.reshape(lead + (n // cr, m)))


def applyq(p, w):
    """Q p = A^T (W^T W) A p with the aligned min-neighbour weights of
    `w` (..., n, m) (as :func:`image_axis` takes it); p is (..., n,
    m)."""
    if p.device.type == "cpu":
        return applyq_plain(p, w)
    if p.device.type != "cuda":
        raise ValueError(f"applyq: unsupported device {p.device}")
    n, m = p.shape[-2:]
    I, C = image_axis("applyq", p, w)
    p_b, w_b = _batched(p, n, m), _batched(w, n, m)
    B = p_b.shape[0]
    _build.check_tensor("applyq", "p", p_b, (B, n, m), torch.float32,
                        p.device)
    _build.check_tensor("applyq", "w", w_b, (I, n, m), torch.float32,
                        p.device)
    q = torch.empty_like(p_b)
    with torch.cuda.device(p.device):
        props = torch.cuda.get_device_properties(p.device)
        rows, _ = applyq_tiling(n, m, props.multi_processor_count)
        fn = _build.bind("vcycle_applyq", "pppiiiiip")
        _build.check(fn(p_b.data_ptr(), w_b.data_ptr(), q.data_ptr(), I, C,
                        n, m, rows,
                        torch.cuda.current_stream(p.device).cuda_stream),
                     "vcycle_applyq")
    _build.launches["applyq"] += 1
    return q.reshape(p.shape)
