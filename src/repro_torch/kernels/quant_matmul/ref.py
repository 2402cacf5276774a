"""The plain PyTorch version of kernel K2 (`repro.kernels.quant_matmul.ref`)
and the layout of its packed 4-bit payloads.

The one layout of a packed 4-bit payload, read by every consumer (K2's
wrapper and kernel, `nn.layers`' dequantizers and row gathers, which
export these functions): a leaf of last axis N is stored as uint8 of last
axis ceil(N / 2); byte j holds element 2j in its low nibble and element
2j + 1 in its high nibble, each two's complement; when N is odd the last
high nibble is 0. Leading axes are the leaf's own, so stacked repeats,
`torch.unbind` and row gathers act on packed leaves as on unpacked ones.
"""
import torch


def packed_width(n: int) -> int:
    """Bytes of a packed row of ``n`` 4-bit values."""
    return (n + 1) // 2


def is_packed(q: torch.Tensor) -> bool:
    """A payload stored two 4-bit values a byte (uint8); int8 is 8-bit
    storage."""
    return q.dtype == torch.uint8


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Integers on [-8, 7] (any integer dtype), last axis N -> uint8 of last
    axis ceil(N / 2), two to a byte as laid out above."""
    q = q.to(torch.int8)
    if q.shape[-1] % 2:
        q = torch.cat((q, q.new_zeros(q.shape[:-1] + (1,))), dim=-1)
    u = q.view(torch.uint8) & 0x0F
    return u[..., 0::2] | (u[..., 1::2] << 4)


def unpack_int4(p: torch.Tensor, n: int) -> torch.Tensor:
    """A packed payload -> int8 of last axis ``n`` (the leaf's width)."""
    if p.dtype != torch.uint8 or p.shape[-1] != packed_width(n):
        raise ValueError(f"a packed payload of width {n} is uint8 of last "
                         f"axis {packed_width(n)}; got {p.dtype} "
                         f"{tuple(p.shape)}")
    # each nibble moved to the top of a byte and shifted back
    # arithmetically: its two's complement value, sign-extended
    lo = (p << 4).view(torch.int8) >> 4
    hi = p.view(torch.int8) >> 4
    v = torch.stack((lo, hi), dim=-1)
    return v.reshape(*p.shape[:-1], 2 * p.shape[-1])[..., :n]


def weights(w_q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """w_q's integer values as int8 (K, N): a packed payload unpacked, an
    int8 one as it is. N is ``scales``'s length."""
    return unpack_int4(w_q, scales.shape[0]) if is_packed(w_q) else w_q


def quant_matmul_ref(x: torch.Tensor, w_q: torch.Tensor,
                     scales: torch.Tensor) -> torch.Tensor:
    """x (M, K) float, w_q (K, N) int8 on a ``bits`` grid or (K, ceil(N/2))
    uint8 packed 4-bit, scales (N,) f32 -> (M, N) in x's dtype, dequantized
    and accumulated in float32."""
    w = weights(w_q, scales).float() * scales.float()[None, :]
    return (x.float() @ w).to(x.dtype)


def quant_matmul_tolerance(x: torch.Tensor, w_q: torch.Tensor,
                           scales: torch.Tensor,
                           ref: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on |kernel - plain version| for the same inputs
    (a packed ``w_q`` is unpacked first: both bodies compute on the same
    integer values).

    The plain version sums x_k fl(q_kn s_n) in float32; the kernel sums
    x_k q_kn (exact in float32 for bf16 x, one rounding for float32 x) and
    multiplies the sum by s_n once. With u = eps32 / 2 and
    S = sum_k |x_k w_kn|: the plain version's float32 sum of K terms lies
    within (K - 1) u S of its exact value, in any order; the kernel's within
    (K - 1) 2u S even if the tensor cores truncate where IEEE rounds; fl(q s)
    moves the plain version by at most u S, and the product by s_n and
    float32 x's product rounding move the kernel by at most u S each.
    Together at most 1.5 K eps32 S, inside 2 K eps32 S for every K >= 1.
    A bf16 output adds one rounding on each side, at most 2^-8 of the value
    each (1% slack for the rounding of ``ref`` itself)."""
    eps = torch.finfo(torch.float32).eps
    w = weights(w_q, scales)
    mag = x.float().abs() @ (w.float() * scales.float()[None, :]).abs()
    tol = 2 * x.shape[1] * eps * mag
    if x.dtype == torch.bfloat16:
        tol = tol + 1.01 * 2.0 ** -7 * ref.float().abs()
    return tol
