"""The wgmma/TMA GEMM core of the MLP blocks (``csrc/gemm_sm90.cuh``) on its
own, through the entries of ``csrc/gemm_sm90.cu``, with plain versions
beside them: bf16 operands, fp32 products.  They exist to hold each operand
layout of the core against a plain product on the card; the main path
reaches the core only through the MLP block wrappers of ``ops/cuda_mlp.py``.

  * :func:`gemm_bf16`: ``a (M, K) @ b`` with ``b`` N-contiguous, (K, N)
    (W1 in ``y W1``, W2 in ``a W2``), or K-contiguous, (N, K), given
    transposed (W2 in ``gc W2^T``, W1 in ``dh1 W1^T``).
  * :func:`gemm_dual_bf16`: ``a1 @ b1`` and ``a2 @ b2^T`` in one tile walk,
    the backward's dual product.

Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from vault_tpu_torch.ops import _build
from vault_tpu_torch.ops._dispatch import check_operands
from vault_tpu_torch.ops.nn import matmul_fp32

TILE_WIDTHS = (128, 192)  # the MLP blocks' tile widths
K_MULTIPLE = 64           # the core walks K 64 at a time
_SIGNATURES = {
    "vt_gemm_bf16": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
                     ctypes.c_int),
    "vt_gemm_dual_bf16": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
                          ctypes.c_int),
}


def _shapes(what, a, b, k_contiguous):
    """(M, N, K) of ``a @ b`` (``b`` (N, K) when ``k_contiguous``)."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"{what}: a and b must be matrices")
    m, k = a.shape
    n = b.shape[0] if k_contiguous else b.shape[1]
    if k % K_MULTIPLE:
        raise ValueError(f"{what}: K = {k} must be a multiple of {K_MULTIPLE}")
    return m, n, k


def gemm_plain(a, b, k_contiguous: bool = False) -> torch.Tensor:
    """``a @ b`` (``a @ b^T`` when ``k_contiguous``) in fp32."""
    return matmul_fp32(a, b.t() if k_contiguous else b)


def gemm_bf16(a, b, k_contiguous: bool = False, tile_width: int = 192) -> torch.Tensor:
    """``a @ b`` in fp32 on the core; ``k_contiguous``: ``b`` is (N, K) and
    the product is ``a @ b^T``.  ``tile_width``: 128 or 192."""
    what = "gemm_bf16"
    if tile_width not in TILE_WIDTHS:
        raise ValueError(f"{what}: tile width {tile_width} not in {TILE_WIDTHS}")
    m, n, k = _shapes(what, a, b, k_contiguous)
    bf = torch.bfloat16
    check_operands(what, a, {"a": (a, (m, k), bf),
                             "b": (b, (n, k) if k_contiguous else (k, n), bf)})
    lib = _build.load("gemm_sm90", _SIGNATURES)
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = lib.vt_gemm_bf16(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                            int(k_contiguous), tile_width, stream)
    _build.check(lib, code, what)
    gemm_bf16.launches += 1
    return c


def gemm_dual_plain(a1, b1, a2, b2):
    """(``a1 @ b1``, ``a2 @ b2^T``) in fp32."""
    return gemm_plain(a1, b1), gemm_plain(a2, b2, k_contiguous=True)


def gemm_dual_bf16(a1, b1, a2, b2):
    """(``a1 @ b1``, ``a2 @ b2^T``) in fp32 on the core's dual form: b1 (K,
    N) N-contiguous, b2 (N, K) K-contiguous, a1 and a2 (M, K)."""
    what = "gemm_dual_bf16"
    m, n, k = _shapes(what, a1, b1, False)
    bf = torch.bfloat16
    check_operands(what, a1, {"a1": (a1, (m, k), bf), "b1": (b1, (k, n), bf),
                              "a2": (a2, (m, k), bf), "b2": (b2, (n, k), bf)})
    lib = _build.load("gemm_sm90", _SIGNATURES)
    c1, c2 = (torch.empty((m, n), dtype=torch.float32, device=a1.device) for _ in range(2))
    stream = torch.cuda.current_stream(a1.device).cuda_stream
    code = lib.vt_gemm_dual_bf16(a1.data_ptr(), b1.data_ptr(), a2.data_ptr(), b2.data_ptr(),
                                 c1.data_ptr(), c2.data_ptr(), m, n, k, stream)
    _build.check(lib, code, what)
    gemm_dual_bf16.launches += 1
    return c1, c2


gemm_bf16.launches = 0
gemm_dual_bf16.launches = 0
