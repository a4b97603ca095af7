"""The wgmma/TMA GEMM core of the MLP blocks (``csrc/gemm_sm90.cuh``) on its
own, through the entries of ``csrc/gemm_sm90.cu``, with plain versions
beside them: bf16 operands with fp32 products, and int8 operands with
int32 products.  They exist to hold each operand layout of the core
against a plain product on the card; the main path reaches the core only
through the block wrappers of ``ops/cuda_mlp.py``, ``ops/cuda_ln_qkv.py``
and ``ops/cuda_swiglu.py``.

  * :func:`gemm_bf16`: ``a (M, K) @ b`` with ``b`` N-contiguous, (K, N)
    (W1 in ``y W1``, W2 in ``a W2``), or K-contiguous, (N, K), given
    transposed (W2 in ``gc W2^T``, W1 in ``dh1 W1^T``).
  * :func:`gemm_dual_bf16`: ``a1 @ b1`` and ``a2 @ b2^T`` in one tile walk,
    the backward's dual product.
  * :func:`gemm_bf16_split_k`: ``a @ b`` with K cut into S splits, the fp32
    product of each split's K range in a slice of its own (the post-LN
    blocks' second products, whose slices a row pass adds in order);
    plain version :func:`gemm_split_k_plain`.
  * :func:`gemm_s8`: ``a (M, K) @ b^T`` for int8 ``a`` and ``b`` (N, K),
    K-contiguous (int8 ``wgmma`` has no transpose bit), exact int32; plain
    version :func:`gemm_s8_plain`.  :func:`gemm_s8_split_k_plain`: the
    same with K cut into S splits, each split's int32 product in a slice of
    its own, as the w8a8 post-LN block's second product stores them
    (``csrc/mlp_w8a8.cu``, whose row pass adds them exactly).
  * :func:`dequant_bf16`: ``bf16(float(q) * s)`` for int8 (K, N) codes
    ``q`` and fp32 per-column scales ``s``, the pass the w8 pre-LN block
    runs in front of its bf16 products; plain version
    :func:`dequant_plain`.

Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from vault_tpu_torch.ops import _build
from vault_tpu_torch.ops._dispatch import check_operands
from vault_tpu_torch.ops.nn import matmul_fp32

TILE_WIDTHS = (64, 128, 192)  # the core's tile widths
K_MULTIPLE = 64               # the core walks K 64 at a time
K_MULTIPLE_S8 = 128           # its int8 instance 128 at a time
_SIGNATURES = {
    "vt_gemm_bf16": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
                     ctypes.c_int),
    "vt_gemm_dual_bf16": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
                          ctypes.c_int),
    "vt_gemm_s8": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
                   ctypes.c_int),
    "vt_dequant_bf16": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
                        ctypes.c_int),
}
N_MULTIPLE_Q8 = 16  # the pass's N: sixteen codes a thread


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


def _launch(what, a, b, k_contiguous, tile_width, splits):
    """(splits, M, N) fp32: the core's product of each split's K range."""
    if tile_width not in TILE_WIDTHS:
        raise ValueError(f"{what}: tile width {tile_width} not in {TILE_WIDTHS}")
    m, n, k = _shapes(what, a, b, k_contiguous)
    if not 1 <= splits <= k // K_MULTIPLE:
        raise ValueError(f"{what}: {splits} splits of K = {k}: from 1 to "
                         f"K / {K_MULTIPLE} = {k // K_MULTIPLE}")
    bf = torch.bfloat16
    check_operands(what, a, {"a": (a, (m, k), bf),
                             "b": (b, (n, k) if k_contiguous else (k, n), bf)})
    lib = _build.load("gemm_sm90", _SIGNATURES)
    c = torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = lib.vt_gemm_bf16(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                            int(k_contiguous), tile_width, splits, stream)
    _build.check(lib, code, what)
    return c


def gemm_bf16(a, b, k_contiguous: bool = False, tile_width: int = 192) -> torch.Tensor:
    """``a @ b`` in fp32 on the core; ``k_contiguous``: ``b`` is (N, K) and
    the product is ``a @ b^T``.  ``tile_width``: 64, 128 or 192."""
    c = _launch("gemm_bf16", a, b, k_contiguous, tile_width, 1)[0]
    gemm_bf16.launches += 1
    return c


def split_bounds(k: int, splits: int, step: int = K_MULTIPLE):
    """The K range of each split, as the core cuts K: split s takes the
    steps [s kt / S, (s + 1) kt / S) of kt = K / step, ``step`` the depth of
    a stage (64 for bf16, :data:`K_MULTIPLE_S8` for int8)."""
    kt = k // step
    return [(s * kt // splits * step, (s + 1) * kt // splits * step) for s in range(splits)]


def gemm_split_k_plain(a, b, splits: int, k_contiguous: bool = False) -> torch.Tensor:
    """(splits, M, N): slice s is ``a @ b`` over split s's K range
    (:func:`split_bounds`) in fp32; the slices sum to ``a @ b``."""
    return torch.stack([
        gemm_plain(a[:, k0:k1], b[:, k0:k1] if k_contiguous else b[k0:k1], k_contiguous)
        for k0, k1 in split_bounds(a.shape[1], splits)])


def gemm_bf16_split_k(a, b, splits: int, k_contiguous: bool = False,
                      tile_width: int = 128) -> torch.Tensor:
    """(splits, M, N) fp32 on the core's split-K form: slice s is the
    product over split s's K range (:func:`split_bounds`)."""
    c = _launch("gemm_bf16_split_k", a, b, k_contiguous, tile_width, splits)
    gemm_bf16_split_k.launches += 1
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


def gemm_s8_plain(a, b) -> torch.Tensor:
    """``a @ b^T`` for int8 ``a`` (M, K) and ``b`` (N, K), exact int32 (the
    products summed in float64, exact below 2^53)."""
    return (a.double() @ b.double().t()).to(torch.int32)


def gemm_s8_split_k_plain(a, b, splits: int) -> torch.Tensor:
    """(splits, M, N) int32: slice s is ``a @ b^T`` over split s's K range
    (:func:`split_bounds` in 128-deep steps), exact; the slices sum to
    :func:`gemm_s8_plain` exactly."""
    return torch.stack([gemm_s8_plain(a[:, k0:k1], b[:, k0:k1])
                        for k0, k1 in split_bounds(a.shape[1], splits, K_MULTIPLE_S8)])


def gemm_s8(a, b, tile_width: int = 128, rows_first: bool = False) -> torch.Tensor:
    """``a @ b^T`` in int32 on the core's int8 instance: a (M, K) and b (N,
    K) int8, K a multiple of 128, N even; ``tile_width`` 64, 128 or 192;
    ``rows_first``: the work items walk the rows fastest (the SwiGLU
    block's order)."""
    what = "gemm_s8"
    if tile_width not in TILE_WIDTHS:
        raise ValueError(f"{what}: tile width {tile_width} not in {TILE_WIDTHS}")
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"{what}: a and b must be matrices")
    (m, k), n = a.shape, b.shape[0]
    if k % K_MULTIPLE_S8 or n % 2:
        raise ValueError(f"{what}: K = {k} must be a multiple of {K_MULTIPLE_S8} and "
                         f"N = {n} even")
    check_operands(what, a, {"a": (a, (m, k), torch.int8), "b": (b, (n, k), torch.int8)})
    lib = _build.load("gemm_sm90", _SIGNATURES)
    c = torch.empty((m, n), dtype=torch.int32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = lib.vt_gemm_s8(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, tile_width,
                          int(rows_first), stream)
    _build.check(lib, code, what)
    gemm_s8.launches += 1
    return c


def dequant_plain(q, s) -> torch.Tensor:
    """``bf16(float(q) * s)``: the w8 ``linear``'s weights in bf16."""
    return (q.float() * s.reshape(-1)).to(torch.bfloat16)


def dequant_bf16(q, s) -> torch.Tensor:
    """``bf16(float(q) * s)`` in one pass on the card: q (K, N) int8, s
    (N,) fp32, N a multiple of 16."""
    what = "dequant_bf16"
    if q.dim() != 2 or q.shape[1] % N_MULTIPLE_Q8:
        raise ValueError(f"{what}: q must be (K, N) with N a multiple of {N_MULTIPLE_Q8}")
    k, n = q.shape
    check_operands(what, q, {"q": (q, (k, n), torch.int8), "s": (s, (n,), torch.float32)})
    lib = _build.load("gemm_sm90", _SIGNATURES)
    out = torch.empty((k, n), dtype=torch.bfloat16, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.vt_dequant_bf16(q.data_ptr(), s.data_ptr(), out.data_ptr(), k, n, stream)
    _build.check(lib, code, what)
    dequant_bf16.launches += 1
    return out


gemm_bf16.launches = 0
gemm_bf16_split_k.launches = 0
gemm_dual_bf16.launches = 0
gemm_s8.launches = 0
dequant_bf16.launches = 0
