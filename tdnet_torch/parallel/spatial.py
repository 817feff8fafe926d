"""Spatial partitioning: the image H axis over the ranks of a 2-D (data,
spatial) grid, the counterpart of ``tdnet/parallel/spatial.py``.

The reference shards the H axis of every NHWC activation over a
``spatial`` mesh axis and lets GSPMD insert the halo exchanges. The port
runs one process a card (``parallel/mesh.py`` :class:`Grid`): the S ranks
of a grid row hold the same pages, and each computes its band of rows of
every activation. The forward runs inside :func:`spatial_bands`, which
turns the band form of the same modules on (``models/layers.py``
``Conv2d``, ``models/resnet.py`` ``StemConv``, ``max_pool_same`` and the SE
mean, the VGG and DenseNet pools, ``resize_nearest_like``), so weights and
``.tdn`` bundles are those of the plain model.

- **One split rule at every level**, JAX's for uneven shards: a tensor of
  H rows gives each band ceil(H / S) rows, the last bands short or empty
  (:func:`band_rows`). At the 800x1344 bucket P7 has 7 rows, so S = 8
  leaves a band empty; at 64x64, P7 has 1 row over 4 bands.
- **Global geometry.** Padding and the stride phase come from the tensor's
  global height, never from the band. W is not sharded, and every layer
  maps (H, W) to (f(H), f(W)) by the same rule, so the context keeps the
  global height of each width it has seen (``_Bands.height``), filled from
  the image and from every layer's output; two heights at one width raise.
- **Halo fetch by row range.** A rank with output rows [a, b) of a k x k / s
  window needs input rows [a s - p0, (b - 1) s - p0 + k) of the global
  tensor; rows outside [0, H) are padding (zeros, or -inf for max-pool).
  Those rows may sit on any rank of the row, not only the neighbours: each
  rank computes every rank's request from the shared geometry and one
  ``all_to_all_single`` over the spatial group moves them
  (:class:`_RowFetch`). Its backward sends each fetched row's gradient
  back to its owner, which adds it.
- **The head gather** (:func:`gather_rows`): each level's band of head
  outputs is all-gathered in row order over the spatial group; its
  backward takes the rank's own rows of the gradient and sums nothing. The
  anchor-space tail (targets, losses) is then replicated over the group.
- **The SE gate's mean** sums over the group (:func:`_AllReduceSum`, whose
  backward sums the bands' partial gradients).

Every gradient is then a partial sum over bands: the train step sums it
over the spatial group and the data axis (``train/step.py``). An empty
band still runs every operation (on k rows of padding, sliced to none),
so each rank builds the same graph and meets every collective, forward
and backward, in the same order.

Under gloo a CUDA tensor crosses through host memory; NCCL moves it on the
card. The rows travel as bytes.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tdnet_torch.parallel.mesh import Grid, create_grid

__all__ = [
    "SPATIAL_AXIS",
    "create_spatial_mesh",
    "spatial_size",
    "band_rows",
    "image_band",
    "spatial_bands",
    "active",
    "gather_rows",
]

SPATIAL_AXIS = "spatial"


def create_spatial_mesh(n_spatial: int) -> Grid:
    """The (data, spatial) grid: ``n_spatial`` ranks a row, the rest along
    data; ``n_spatial`` must divide the ranks (else the reference's
    ValueError)."""
    return create_grid(n_spatial, SPATIAL_AXIS)


def spatial_size(grid: Optional[Grid]) -> int:
    """Size of the spatial axis (1 when the grid has none)."""
    return grid.size if grid is not None and grid.axis == SPATIAL_AXIS else 1


def band_rows(h: int, size: int, index: int) -> Tuple[int, int]:
    """Rows [lo, hi) of band ``index`` of ``size`` over ``h`` rows:
    ceil(h / size) a band, the last ones short or empty."""
    c = -(-h // size)
    return min(index * c, h), min((index + 1) * c, h)


def image_band(images: torch.Tensor, grid: Grid) -> torch.Tensor:
    """This rank's band of a batch whose axis 1 is H (NHWC images, packed
    (B, H, W*3) rows)."""
    lo, hi = band_rows(images.shape[1], grid.size, grid.index)
    return images[:, lo:hi]


def _comm(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as the gathers and exchanges move it: its bytes (every dtype
    bit for bit; gloo's all-to-all takes no bfloat16), on the host for
    gloo."""
    if t.is_cuda and dist.get_backend(group) != "nccl":
        t = t.cpu()
    return t.contiguous().view(torch.uint8)


def _back(t: torch.Tensor, dtype, device) -> torch.Tensor:
    return t.view(dtype).to(device)


def _exchange(buf: torch.Tensor, send: Sequence[int], recv: Sequence[int],
              group) -> torch.Tensor:
    """all_to_all_single of the flat ``buf``: ``send[q]`` elements to rank q
    of the group, ``recv[q]`` from it."""
    size = buf.element_size()
    src = _comm(buf, group)
    out = src.new_empty(sum(recv) * size)
    dist.all_to_all_single(out, src, [n * size for n in recv], [n * size for n in send],
                           group=group)
    return _back(out, buf.dtype, buf.device)


def _overlap(a: Tuple[int, int], b: Tuple[int, int]) -> Tuple[int, int]:
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if hi > lo else (lo, lo)


class _RowFetch(torch.autograd.Function):
    """Rows ``requests[me]`` of the global (B, C, H, W) tensor whose band
    ``x`` this rank holds; ``requests[q]`` is rank q's request (clipped to
    [0, H)), the same list on every rank."""

    @staticmethod
    def forward(ctx, x, h, requests, grid):
        owns = [band_rows(h, grid.size, q) for q in range(grid.size)]
        mine = owns[grid.index]
        send = [_overlap(mine, r) for r in requests]  # my rows a rank asked for
        recv = [_overlap(requests[grid.index], o) for o in owns]
        b, c, _, w = x.shape
        nhwc = x.permute(0, 2, 3, 1)
        parts = [nhwc[:, lo - mine[0]:hi - mine[0]].reshape(-1) for lo, hi in send]
        sizes = [b * (hi - lo) * w * c for lo, hi in recv]
        out = _exchange(torch.cat(parts), [p.numel() for p in parts], sizes, grid.group)
        ctx.geometry = (grid, mine, send, recv, x.shape)
        rows = [chunk.view(b, hi - lo, w, c)
                for chunk, (lo, hi) in zip(out.split(sizes), recv)]
        return torch.cat(rows, dim=1).permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, g):
        grid, mine, send, recv, shape = ctx.geometry
        b, c, n, w = shape
        g = g.permute(0, 2, 3, 1)
        parts, at = [], 0
        for lo, hi in recv:
            parts.append(g[:, at:at + hi - lo].reshape(-1))
            at += hi - lo
        back = _exchange(torch.cat(parts), [p.numel() for p in parts],
                         [b * (hi - lo) * w * c for lo, hi in send], grid.group)
        grad = g.new_zeros((b, n, w, c))
        at = 0
        for lo, hi in send:
            size = b * (hi - lo) * w * c
            grad[:, lo - mine[0]:hi - mine[0]] += back[at:at + size].view(b, hi - lo, w, c)
            at += size
        return grad.permute(0, 3, 1, 2), None, None, None


class _GatherRows(torch.autograd.Function):
    """All-gather of the bands of a height-``h`` tensor in row order over the
    spatial group; the backward takes this rank's own rows."""

    @staticmethod
    def forward(ctx, x, h, grid):
        b, c, n, w = x.shape
        chunk = -(-h // grid.size)
        padded = x.new_zeros((b, chunk, w, c))
        padded[:, :n] = x.permute(0, 2, 3, 1)
        src = _comm(padded, grid.group)
        parts = [torch.empty_like(src) for _ in range(grid.size)]
        dist.all_gather(parts, src, group=grid.group)
        rows = [_back(p, x.dtype, x.device)[:, :hi - lo]
                for p, (lo, hi) in zip(parts, (band_rows(h, grid.size, q)
                                               for q in range(grid.size)))]
        ctx.own = band_rows(h, grid.size, grid.index)
        return torch.cat(rows, dim=1).permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.own
        return g[:, :, lo:hi], None, None


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group, replicated; the backward sums the ranks'
    partial gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.group), None


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    src = t if not (t.is_cuda and dist.get_backend(group) != "nccl") else t.cpu()
    dist.all_reduce(src, group=group)
    return src.to(t.device)


class _Bands:
    """The active band context of one forward (see the module docstring)."""

    def __init__(self, grid: Grid, image_hw):
        self.grid = grid
        self._heights = {int(image_hw[1]): int(image_hw[0])}

    def height(self, x: torch.Tensor) -> int:
        """Global height of a band whose width is ``x.shape[3]``."""
        w = int(x.shape[3])
        if w not in self._heights:
            raise ValueError(f"no global height known for width {w}")
        return self._heights[w]

    def _register(self, h: int, w: int) -> None:
        if self._heights.setdefault(w, h) != h:
            raise ValueError(
                f"spatial bands: width {w} holds heights {self._heights[w]} and {h}; "
                "the band form needs one height a width")

    def own(self, h: int) -> Tuple[int, int]:
        return band_rows(h, self.grid.size, self.grid.index)

    def fetch(self, x: torch.Tensor, h: int, h_out: int,
              request: Callable[[int, int], Tuple[int, int]]) -> torch.Tensor:
        """Rows request(a, b) of the global height-``h`` tensor whose band
        ``x`` is, for band [a, b) of a height-``h_out`` output; every rank
        computes every rank's request."""
        reqs = []
        for q in range(self.grid.size):
            lo, hi = request(*band_rows(h_out, self.grid.size, q))
            lo, hi = min(max(lo, 0), h), min(max(hi, 0), h)
            reqs.append((lo, max(hi, lo)))
        return _RowFetch.apply(x, h, tuple(reqs), self.grid)

    def window(self, x: torch.Tensor, k: int, s: int, ph, pw,
               fill: float = 0.0) -> Tuple[torch.Tensor, bool]:
        """The input rows and padding a k x k / s window op with pads ph, pw
        reads for this rank's band of its output: (window, empty band).
        Run the op with no padding on the window; an empty band reads k
        rows of fill, and its one output row is to be dropped."""
        h, w = self.height(x), int(x.shape[3])
        h_out = (h + ph[0] + ph[1] - k) // s + 1
        self._register(h_out, (w + pw[0] + pw[1] - k) // s + 1)
        got = self.fetch(x, h, h_out, lambda a, b: (a * s - ph[0], (b - 1) * s - ph[0] + k)
                         if b > a else (0, 0))
        a, b = self.own(h_out)
        if b > a:
            lo_raw, hi_raw = a * s - ph[0], (b - 1) * s - ph[0] + k
            lo = min(max(lo_raw, 0), h)
            top, bottom = lo - lo_raw, hi_raw - max(min(hi_raw, h), lo)
        else:
            top, bottom = k, 0
        if top or bottom or pw[0] or pw[1]:
            got = F.pad(got, (pw[0], pw[1], top, bottom), value=fill)
        return got, b <= a

    def resize_rows(self, x: torch.Tensor, target_hw) -> torch.Tensor:
        """TF1 nearest resize of a band to the global size whose width is
        ``target_hw[1]``: source row floor(i * Hin / Hout) of the global
        index, fetched from whichever rank holds it."""
        h_in, w_in = self.height(x), int(x.shape[3])
        w_out = int(target_hw[1])
        h_out = self._heights[w_out]
        if (h_in, w_in) == (h_out, w_out):
            return x
        got = self.fetch(x, h_in, h_out, lambda a, b: (a * h_in // h_out, (b - 1) * h_in // h_out + 1)
                         if b > a else (0, 0))
        a, b = self.own(h_out)
        lo = a * h_in // h_out if b > a else 0
        rows = (torch.arange(a, b) * h_in) // h_out - lo
        cols = (torch.arange(w_out) * w_in) // w_out
        return got.index_select(2, rows.to(x.device)).index_select(3, cols.to(x.device))

    def mean_hw(self, y: torch.Tensor) -> torch.Tensor:
        """The global spatial mean (B, C) of a band: the bands' float32 sums
        added over the group, over H x W, in y's dtype."""
        total = _AllReduceSum.apply(y.float().sum(dim=(2, 3)), self.grid.group)
        return (total / (self.height(y) * y.shape[3])).to(y.dtype)


_ACTIVE: Optional[_Bands] = None


@contextlib.contextmanager
def spatial_bands(grid: Grid, image_hw):
    """Within the block the model's layers compute this rank's bands of a
    forward whose images are ``image_hw`` (H, W) globally; the model is fed
    ``image_band(images, grid)``."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, _Bands(grid, image_hw)
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev


def active() -> Optional[_Bands]:
    """The band context of the running forward, or None (the plain form)."""
    return _ACTIVE


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The whole (B, C, H, W) tensor from its bands: the head gather (the
    identity outside :func:`spatial_bands`)."""
    bands = _ACTIVE
    if bands is None:
        return x
    return _GatherRows.apply(x, bands.height(x), bands.grid)
