"""Space-to-depth stem: the port of resnet_tpu.ops.space_to_depth.

The reference stem (7x7/s2 over 3 channels, centred windows padded (3, 2)
at 224) is the same function as a 4x4/s1 conv over the image folded 2x2
into 12 channels, padded (2, 1): each original tap (di, dj) lands at s2d
tap (q, p) = ((di + 4) // 2, (dj + 4) // 2) in channel slot (r, s) =
((di + 4) % 2, (dj + 4) % 2), the 7x7 kernel zero-padded to 8x8 at its
leading edge. The two folds only move data, so they equal JAX's bit for
bit; the conv sums in another order than the 7x7's.

``models.resnet`` takes this route where JAX does (``ExecutionConfig(
space_to_depth=True)``, NHWC, a 7x7/s2 stem, even H and W). As JAX runs
it as an XLA conv whatever ``conv_kernels`` says, the port runs the plain
conv (``ops.conv.conv2d``: cuDNN on the card, at the config's precision),
and autograd of the fold carries the stem's gradient to the 7x7 weight.

Inside ``parallel.spatial.partition`` (a rank's rows of the images) the
fold is a 2x2/s2 window padded (0, 0) through the row plan, and the folded
conv a 4x4/s1 window padded ``S2D_PADDING`` on the rank's haloed tile
(halo 2 above, 1 below). Where a rank's rows start on an even row and are
even in number (ResNet-50 at 224 on 2 or 4 ranks) the fold takes no halo;
where they end on an odd row it takes the first row of the rank below, and
where they start on an odd row its first row is the rank above's (the
tile's padding -1 drops it), so no pair of rows straddles a seam. The
folded image has the 7x7/s2 stem's row plan.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .conv import conv2d

# the folded stem's (lo, hi) padding on both spatial axes: the reference's
# (3, 2) in the original pixels
S2D_PADDING = ((2, 1), (2, 1))


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/b, W/b, C*b*b), channel order (dr, dc, c)."""
    b, h, w, c = x.shape
    if h % block or w % block:
        raise ValueError(f"space_to_depth: H and W must be multiples of {block}, got "
                         f"{tuple(x.shape)}")
    x = x.reshape(b, h // block, block, w // block, block, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // block, w // block, c * block * block)


def s2d_stem_weights(w: torch.Tensor) -> torch.Tensor:
    """(7, 7, C, F) stem weights -> (4, 4, 4C, F): the kernel zero-padded to
    8x8 at the leading edge (tap -4 does not exist), (2q + r, 2p + s, c)
    regrouped as (q, p, (r, s, c))."""
    kh, kw, cin, f = w.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"s2d_stem_weights: the s2d stem folds a 7x7 kernel, got {kh}x{kw}")
    wp = F.pad(w, (0, 0, 0, 0, 1, 0, 1, 0))  # (8, 8, C, F)
    wr = wp.reshape(4, 2, 4, 2, cin, f).permute(0, 2, 1, 3, 4, 5)  # (q, p, r, s, c, f)
    return wr.reshape(4, 4, 4 * cin, f)


def _fold_tile(t: torch.Tensor, padding) -> torch.Tensor:
    """``space_to_depth`` of a rank's tile of rows with the tile's explicit
    (lo, hi) padding along H (-1 drops a first row that the rank above
    folds; W takes none)."""
    (lo, hi), _ = padding
    return space_to_depth(F.pad(t, (0, 0, 0, 0, lo, hi)))


def s2d_stem_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The reference stem conv (7x7, s2, pad (3, 2)) through s2d: a 4x4/s1
    conv padded (2, 1) over ``space_to_depth(x)``. x (B, H, W, C) NHWC, w
    the (7, 7, C, F) weight, cast with its fold to x's dtype -> (B, H/2,
    W/2, F). Inside a spatial partition x and the result are a rank's
    rows."""
    from ..parallel import spatial

    ws = s2d_stem_weights(w).to(x.dtype)
    if spatial.active() is None:
        return conv2d(space_to_depth(x), ws, stride=1, padding=S2D_PADDING)
    fold = ((0, 0), (0, 0))
    xs = spatial.conv(x, 2, 2, "NHWC", _fold_tile, padding=fold)
    return spatial.conv(xs, 4, 1, "NHWC",
                        lambda t, padding: conv2d(t, ws, stride=1, padding=padding),
                        padding=S2D_PADDING)
