"""One normalized min-sum BP iteration of the LDPC decoder
(csrc/ldpc_minsum.cu) and its plain PyTorch version.

Replaces the JAX package's kernels/ldpc_minsum.py::bp_iteration_pallas.
Input and output are dense masked check-to-variable messages c2v
(B, m, n) float32 with channel LLRs llr (B, n) and the 0/1 parity-check
mask (m, n). Per packet:
  1. variable totals  llr + sum_i c2v[i, j] over the live rows i of j;
  2. extrinsic messages  c_in = total - c2v  on live entries;
  3. per check row: min1 of |c_in|, its first-occurrence position, min2
     excluding that position, and the parity of the negative c_in;
  4. out = +-(position == argmin ? min2 : min1) * normalize, negative iff
     the row parity and c_in's sign disagree; 0 where the mask is 0.

Only the sum of step 1 rounds in an order-dependent way. Both versions
here add each column's live messages one at a time in ascending row
order, so the kernel and the plain version agree bit for bit; the JAX
package's reduction order is XLA's, so the port agrees with it to f32
round-off, with identical hard decisions in the tests.

Bound on an H100: bytes. The dense output written once (0.84 MB per
packet), the 2,376 live messages, llr and the edge tables read once:
215 MB per iteration at B=256, 0.0651 ms at 3.35 TB/s. The kernel builds
the output in bands of check rows in shared memory and writes each band
with one bulk store; `plan` sizes the launch (lanes per row, rows per band,
shared bytes, store form). Design notes are in the source.

`bp_iteration` dispatches on the tensor's device: a CPU tensor goes to
`bp_iteration_plain`; a CUDA tensor launches the kernel or raises. Both
count their calls in COUNTS. The edge tables are built from the mask's
contents (`edge_tables`); a caller that runs many iterations with one
mask builds them once and passes them in.

    python -m score_based_channels_torch.kernels.ldpc_minsum

times B=100 packets x 25 iterations through the kernel and the plain
version on the card and prints both and the BER.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

COUNTS = {"launches": 0, "plain": 0}

BIG = 1e9  # |message| given to padding slots (the JAX body's masked value)
# must match csrc/ldpc_minsum.cu
MAX_N = 8192        # variable nodes; the tables must fit shared memory too
THREADS = 128       # a block, one per packet
MAX_SMEM = 232_448  # an H100 block's shared memory
SM_SMEM = 233_472   # an H100 SM's shared memory, 1 KB of it reserved a block
NUM_SMS = 132       # H100 SXM
COPIES = ("element", "bulk")  # the kernel's store codes 0, 1


@dataclasses.dataclass(frozen=True)
class EdgeTables:
    """The live entries ("edges") of a parity-check mask, on one device.

    Edges are numbered in row-major (CSR) order. The kernel reads
    `packed`: row_ptr, row_cols, col_ptr and col_edge (int32; those four
    fields are views of it) in one 16-byte padded array, for one bulk
    copy. The plain version reads the int64 gather tables, where index E
    names a padding slot."""

    m: int
    n: int
    packed: torch.Tensor     # int32 [row_ptr, row_cols, col_ptr, col_edge, 0..]
    row_ptr: torch.Tensor    # (m+1,) int32
    row_cols: torch.Tensor   # (E,) int32, ascending within a row
    col_ptr: torch.Tensor    # (n+1,) int32
    col_edge: torch.Tensor   # (E,) int32: edge ids by column, rows ascending
    col_rows: torch.Tensor   # (E,) int32, ascending within a column
    edge_flat: torch.Tensor  # (E,) int64: row * n + col
    edge_row: torch.Tensor   # (E,) int64
    edge_col: torch.Tensor   # (E,) int64
    edge_slot: torch.Tensor  # (E,) int64: row * dr + position in the row
    row_edges: torch.Tensor  # (m, dr) int64, padded with E
    col_edges: torch.Tensor  # (n, dc) int64, ascending rows, padded with E

    @property
    def num_edges(self) -> int:
        return self.row_cols.numel()

    @property
    def max_row_degree(self) -> int:
        return self.row_edges.shape[1]

    def nbytes(self) -> int:
        """Bytes of the kernel's packed tables."""
        return 4 * self.packed.numel()


def edge_tables(mask, device=None) -> EdgeTables:
    """Edge tables of a (m, n) 0/1 mask (tensor or array), built on the
    host from its contents and placed on `device` (default: the mask's)."""
    if device is None:
        device = mask.device if torch.is_tensor(mask) else "cpu"
    if torch.is_tensor(mask):
        mask = mask.detach().cpu().numpy()
    h = np.asarray(mask) != 0
    if h.ndim != 2 or not h.any():
        raise ValueError(f"edge_tables takes a (m, n) mask with ones, got "
                         f"shape {h.shape}")
    m, n = h.shape
    rows, cols = np.nonzero(h)  # row-major: ascending columns in a row
    E = rows.size
    row_ptr = np.concatenate([[0], np.cumsum(h.sum(1))])
    col_ptr = np.concatenate([[0], np.cumsum(h.sum(0))])
    by_col = np.lexsort((rows, cols))  # edge ids by column, then row
    dr, dc = int(h.sum(1).max()), int(h.sum(0).max())
    eid = np.arange(E)
    row_pos = eid - row_ptr[rows]
    row_edges = np.full((m, dr), E, np.int64)
    row_edges[rows, row_pos] = eid
    col_edges = np.full((n, dc), E, np.int64)
    col_edges[cols[by_col], eid - col_ptr[cols[by_col]]] = by_col

    def i64(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    parts = [row_ptr, cols, col_ptr, by_col]
    ends = np.cumsum([0] + [a.size for a in parts])
    flat = np.zeros(-(-ends[-1] // 4) * 4, np.int32)  # 16-byte multiple
    flat[:ends[-1]] = np.concatenate(parts)
    packed = torch.as_tensor(flat, device=device)
    views = [packed[a:b] for a, b in zip(ends[:-1], ends[1:])]
    return EdgeTables(
        m=m, n=n, packed=packed, row_ptr=views[0], row_cols=views[1],
        col_ptr=views[2], col_edge=views[3],
        col_rows=torch.as_tensor(rows[by_col], dtype=torch.int32,
                                 device=device),
        edge_flat=i64(rows * n + cols), edge_row=i64(rows),
        edge_col=i64(cols), edge_slot=i64(rows * dr + row_pos),
        row_edges=i64(row_edges), col_edges=i64(col_edges))


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: a block of `threads` per packet; `lanes_per_row` lanes
    take a check row (a power of two at least its degree, at most 32), so
    a warp takes 32 / lanes_per_row rows at once; the output is built in
    bands of `rows_per_band` rows, two buffers in shared memory, and leaves
    by bulk stores (`copy` "bulk", n a multiple of 4) or element stores
    ("element")."""

    threads: int
    lanes_per_row: int
    rows_per_band: int
    copy: str
    smem: int
    blocks: int


def smem_bytes(m: int, n: int, E: int, R: int) -> int:
    """Shared bytes of a block (csrc/ldpc_minsum.cu, Layout): two bands of
    R rows, the packed tables, the packet's E live messages, the n totals
    and the mbarrier."""
    r16 = lambda v: -(-v // 16) * 16
    return 2 * r16(R * n * 4) + 4 * -(-(m + n + 2 + 2 * E) // 4) * 4 \
        + r16(4 * E) + r16(4 * n) + 16


def _lanes(max_row_degree: int, R: int) -> int:
    """Lanes per row: a power of two at least the degree, widened while
    the block's warps would take twice the band's rows in one step."""
    seg = 1
    while seg < min(max_row_degree, 32):
        seg *= 2
    while seg < 32 and THREADS // seg >= 2 * R:
        seg *= 2
    return seg


@functools.lru_cache(maxsize=None)
def plan(B: int, m: int, n: int, E: int, max_row_degree: int) -> Plan:
    """The launch of one iteration on B packets of an (m, n) code with E
    edges; raises on a code the kernel does not take. A band is at most
    the rows the block's warps take in one step, cut until all B blocks
    fit on the card at once; bands leave by bulk stores where a row is
    whole 16-byte pieces."""
    if not 1 <= n <= MAX_N:
        raise ValueError(f"bp_iteration: n = {n} is not in 1..{MAX_N}")
    if smem_bytes(m, n, E, 1) > MAX_SMEM:
        raise ValueError(f"bp_iteration: the tables of a code with m={m}, "
                         f"n={n}, {E} edges exceed shared memory")
    seg = 1
    while seg < min(max_row_degree, 32):
        seg *= 2
    R = min(THREADS // seg, m)
    per_sm = -(-B // NUM_SMS)  # blocks an SM for one wave
    budget = lambda k: min(MAX_SMEM, SM_SMEM // k - 1024)
    while per_sm > 1 and smem_bytes(m, n, E, 1) > budget(per_sm):
        per_sm -= 1  # more than one wave
    while R > 1 and smem_bytes(m, n, E, R) > budget(per_sm):
        R -= 1
    return Plan(THREADS, _lanes(max_row_degree, R), R,
                "bulk" if n % 4 == 0 else "element",
                smem_bytes(m, n, E, R), B)


def _gather_padded(x: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """x (B, E) gathered at idx (...) with index E reading `fill`."""
    return torch.cat([x, x.new_full((x.shape[0], 1), fill)], dim=1)[:, idx]


def _column_sums(msg: torch.Tensor, t: EdgeTables) -> torch.Tensor:
    """(B, n): the live messages of each column, msg (B, E) in edge order,
    added one at a time in ascending row order from 0 (the kernel's
    order; padding adds an exact 0)."""
    g = _gather_padded(msg, t.col_edges, 0.0)  # (B, n, dc)
    s = torch.zeros_like(g[..., 0])
    for k in range(g.shape[-1]):
        s = s + g[..., k]
    return s


def column_sums(c2v: torch.Tensor, t: EdgeTables) -> torch.Tensor:
    """sum_i c2v[:, i, j] over the live rows of each column j, (B, n), in
    the kernel's order: the decoder's final `post = llr + column_sums`."""
    return _column_sums(c2v.reshape(c2v.shape[0], -1)[:, t.edge_flat], t)


def bp_iteration_plain(c2v: torch.Tensor, llr: torch.Tensor, mask,
                       normalize: float = 0.75,
                       tables: EdgeTables | None = None) -> torch.Tensor:
    """One min-sum iteration, the formula of the JAX package's
    comms/ldpc.py:231-249 over the live entries; (B, m, n) float32."""
    COUNTS["plain"] += 1
    t = tables if tables is not None else edge_tables(mask, c2v.device)
    B = c2v.shape[0]
    msg = c2v.reshape(B, -1)[:, t.edge_flat]            # (B, E)
    total = llr + _column_sums(msg, t)                  # (B, n)
    c_in = total[:, t.edge_col] - msg                   # (B, E)
    a = _gather_padded(c_in.abs(), t.row_edges, BIG)    # (B, m, dr)
    pos = torch.arange(a.shape[-1], device=a.device)
    min1 = a.min(dim=-1, keepdim=True).values
    first = torch.where(a <= min1, pos, a.shape[-1]).min(
        dim=-1, keepdim=True).values == pos             # first argmin
    min2 = torch.where(first, BIG, a).min(dim=-1, keepdim=True).values
    mag = torch.where(first, min2, min1) * normalize    # (B, m, dr)
    neg = c_in < 0
    odd = _gather_padded(neg.to(torch.int32), t.row_edges, 0).sum(-1) % 2
    mag = mag.reshape(B, -1)[:, t.edge_slot]            # (B, E)
    val = torch.where((odd[:, t.edge_row] == 1) != neg, -mag, mag)
    out = c2v.new_zeros(B, t.m * t.n)
    out[:, t.edge_flat] = val
    return out.reshape(B, t.m, t.n)


def _check_cuda(c2v, llr, t: EdgeTables) -> None:
    if c2v.dtype != torch.float32 or llr.dtype != torch.float32:
        raise TypeError(f"bp_iteration takes float32 c2v and llr, got "
                        f"{c2v.dtype} and {llr.dtype}")
    if (c2v.dim() != 3 or c2v.shape[1:] != (t.m, t.n)
            or llr.shape != (c2v.shape[0], t.n)):
        raise ValueError(f"bp_iteration takes c2v (B, {t.m}, {t.n}) and llr "
                         f"(B, {t.n}), got {tuple(c2v.shape)} and "
                         f"{tuple(llr.shape)}")
    if not (c2v.is_contiguous() and llr.is_contiguous()):
        raise ValueError("bp_iteration takes contiguous c2v and llr")
    if llr.device != c2v.device or t.row_ptr.device != c2v.device:
        raise ValueError("bp_iteration: c2v, llr and the edge tables must "
                         "lie on one device")


def _launch(c2v: torch.Tensor, llr: torch.Tensor, t: EdgeTables,
            normalize: float, p: Plan) -> torch.Tensor:
    """The kernel on checked card tensors, launched as `p` says."""
    from . import _build

    out = torch.empty_like(c2v)
    rc = _build.library().sbc_ldpc_minsum(
        c2v.data_ptr(), llr.data_ptr(), out.data_ptr(), t.packed.data_ptr(),
        c2v.shape[0], t.m, t.n, t.num_edges, t.max_row_degree,
        float(normalize), p.lanes_per_row, p.rows_per_band,
        COPIES.index(p.copy), p.smem,
        torch.cuda.current_stream(c2v.device).cuda_stream)
    _build.check("ldpc_minsum", rc)
    COUNTS["launches"] += 1
    return out


def bp_iteration(c2v: torch.Tensor, llr: torch.Tensor, mask,
                 normalize: float = 0.75,
                 tables: EdgeTables | None = None) -> torch.Tensor:
    """One min-sum iteration on c2v's device; returns the new c2v.

    mask: the (m, n) 0/1 parity-check mask, tensor or array. tables:
    `edge_tables(mask)` on c2v's device, when the caller already built
    them; both versions then read only the tables."""
    if c2v.device.type == "cpu":
        return bp_iteration_plain(c2v, llr, mask, normalize, tables)
    if c2v.device.type != "cuda":
        raise RuntimeError(f"bp_iteration: no kernel for {c2v.device}")
    t = tables if tables is not None else edge_tables(mask, c2v.device)
    _check_cuda(c2v, llr, t)
    return _launch(c2v, llr, t, normalize, plan(
        c2v.shape[0], t.m, t.n, t.num_edges, t.max_row_degree))


def _bench(argv=None) -> None:
    """Kernel against plain version on the card, the decoder's workload."""
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=100)
    p.add_argument("--iters", type=int, default=25)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    from .._device import resolve_device
    from ..comms.ldpc import make_wifi_ldpc

    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit("the kernel runs on the card; pass --device cuda")
    code = make_wifi_ldpc()
    rng = np.random.default_rng(0)
    cw = code.encode(rng.integers(0, 2, (args.batch, code.k), np.uint8))
    llr = torch.from_numpy((1 - 2 * cw.astype(np.float32)) * 4.0
                           + 1.5 * rng.standard_normal(cw.shape).astype(
                               np.float32)).to(dev)
    mask = torch.as_tensor(code.H, dtype=torch.float32, device=dev)
    t = edge_tables(mask)

    def decode(fn):
        c2v = torch.zeros(args.batch, code.m, code.n, device=dev)
        for _ in range(args.iters):
            c2v = fn(c2v, llr, mask, 0.75, t)
        return ((llr + column_sums(c2v, t)) < 0).to(torch.uint8)

    cw_t = torch.from_numpy(cw).to(dev)
    for name, fn in (("plain", bp_iteration_plain), ("kernel", bp_iteration)):
        bits = decode(fn)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(args.reps):
            bits = decode(fn)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / args.reps
        ber = (bits != cw_t).float().mean().item()
        print(f"{name}: {ms:.3f} ms per decode of {args.batch} packets x "
              f"{args.iters} iterations ({ms / args.iters:.4f} ms per "
              f"iteration), BER {ber:.4f} on {torch.cuda.get_device_name(0)}")


if __name__ == "__main__":
    _bench()
