"""Shape-stable interpolation ops for ViLT's visual path (port of
``vault_tpu/ops/interpolate.py``).

HF's ``ViltEmbeddings.visual_embed`` (modeling_vilt.py:94-180) interpolates
the pretrained 12x12 patch position-embedding grid to each image's own valid
patch extent (h_i, w_i) with ``F.interpolate(mode="bilinear",
align_corners=True)`` and zero-pads to the batch grid.  As in the JAX
package, the output here is always the full (H', W') grid, source
coordinates are computed from (h_i, w_i), and positions beyond the valid
extent are zero — one batched gather instead of a loop over images.
"""

from __future__ import annotations

import torch

from vault_tpu_torch.ops.nn import take


def interpolate_pos_grid(grid: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                         out_h: int, out_w: int) -> torch.Tensor:
    """Align-corners bilinear resize of a (G, G, C) grid to per-image
    (h_i, w_i) extents, zero-padded on an (out_h, out_w) canvas.

    Args:
      grid: (G, G, C) pretrained position-embedding grid.
      h, w: (B,) integer valid extents per image (1 <= h_i <= out_h).
    Returns:
      (B, out_h, out_w, C) in grid's dtype; zeros outside [0,h_i) x [0,w_i).
    """
    g = grid.shape[0]
    dev = grid.device
    hf = h.to(torch.float32)[:, None, None]
    wf = w.to(torch.float32)[:, None, None]
    r = torch.arange(out_h, dtype=torch.float32, device=dev)[None, :, None]
    c = torch.arange(out_w, dtype=torch.float32, device=dev)[None, None, :]
    r, c = torch.broadcast_tensors(r, c)

    # align_corners=True: src = dst * (src_size - 1) / (dst_size - 1)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    sy = torch.where(hf > 1, r * (g - 1) / torch.clamp(hf - 1, min=1), zero)
    sx = torch.where(wf > 1, c * (g - 1) / torch.clamp(wf - 1, min=1), zero)
    sy = torch.clamp(sy, 0.0, g - 1)
    sx = torch.clamp(sx, 0.0, g - 1)

    y0 = torch.floor(sy).to(torch.int64)
    x0 = torch.floor(sx).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=g - 1)
    x1 = torch.clamp(x0 + 1, max=g - 1)
    wy = (sy - y0.to(torch.float32))[..., None]
    wx = (sx - x0.to(torch.float32))[..., None]

    # (B, out_h, out_w, C) via advanced-index gathers, their gradients
    # summed in fp32 (ops/nn.py ``take``)
    v00 = take(grid, y0, x0)
    v01 = take(grid, y0, x1)
    v10 = take(grid, y1, x0)
    v11 = take(grid, y1, x1)

    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    out = top * (1 - wy) + bot * wy

    valid = ((r < hf) & (c < wf))[..., None]
    return torch.where(valid, out, torch.zeros_like(out)).to(grid.dtype)


def downsample_mask_nearest(mask: torch.Tensor, out_h: int,
                            out_w: int) -> torch.Tensor:
    """Torch ``F.interpolate(mode='nearest')`` downsample of a (B, H, W)
    {0,1} mask to (B, out_h, out_w), written out as the JAX package writes
    it: src_idx = floor(dst_idx * in/out), in fp32."""
    in_h, in_w = mask.shape[-2:]
    dev = mask.device
    ri = torch.floor(torch.arange(out_h, dtype=torch.float32, device=dev)
                     * (in_h / out_h)).to(torch.int64)
    ci = torch.floor(torch.arange(out_w, dtype=torch.float32, device=dev)
                     * (in_w / out_w)).to(torch.int64)
    return mask[:, ri][:, :, ci]
