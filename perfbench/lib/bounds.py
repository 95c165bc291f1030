"""The card's published peaks and the least time a kernel could take.

The bounds are copied from ``chip_smoke.py`` (``bound_ms``,
``rbf_bound``, ``fused_bounds``) so that a change to the program cannot
move the yardstick: each input byte read once and each output byte
written once, against the HBM rate, and the operations the kernel needs
at these shapes, against their type's peak.
"""

# NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at 700 W): HBM bytes/s,
# fp32 FLOP/s on the CUDA cores, TF32 FLOP/s on the tensor cores
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
TF32_FLOP_S = 495e12
PEAKS = {"hbm_bytes_s": HBM_BYTES_S, "fp32": FP32_FLOP_S,
         "tf32": TF32_FLOP_S}


def bound_s(n_bytes, ops, flop_s):
    """The least time for ``n_bytes`` moved and ``ops`` operations at
    ``flop_s``: the larger of the two, in seconds."""
    return max(n_bytes / HBM_BYTES_S, ops / flop_s)


def rbf_bound(S, N, M, D, L):
    """K1 (``rbf_gram_kernel``) writing K (S, N, M) from X (S, N, D) and
    X2 (S, M, D) with L lengthscales and one variance a sample: each read
    once and K written once; fp32 operations on the CUDA cores, 2NMD for
    the cross term, 3(N + M)D for the scaling and the norms, 6NM for the
    epilogue."""
    n_bytes = 4 * S * (N * D + M * D + L + 1 + N * M)
    ops = S * (2 * N * M * D + 3 * (N + M) * D + 6 * N * M)
    return bound_s(n_bytes, ops, FP32_FLOP_S)


def fused_bounds(n_rows, n_cols, n_feat):
    """K2 and K3 at ``lower=True`` (the SVGP bound's call), whose L⁻¹
    input is its lower triangle. K2 reads it, Zs, Xs and the variance and
    writes G (M, N); its products run as 3-pass TF32: the G-product
    (M(M + 1)N) and the gram's cross term (2MND). K3 reads the same, dG
    and G, and writes dU (M, M), dZs, dXs and the variance's gradient;
    its products are 1-pass TF32 (Uᵀ·dG and tril(dG·Kᵀ), M(M + 1)N each;
    de·Xs and deᵀ·Zs, 2MND each) beside the gram's 3-pass cross term.
    Returns the two bounds in seconds."""
    Mr, N, Df = n_rows, n_cols, n_feat
    tri = Mr * (Mr + 1) // 2
    ins = tri + Mr * Df + N * Df + 1
    k2 = bound_s(4 * (ins + Mr * N),
                 3 * (Mr * (Mr + 1) * N + 2 * Mr * N * Df), TF32_FLOP_S)
    k3 = bound_s(4 * (ins + 2 * Mr * N + Mr * Mr + Mr * Df + N * Df + 1),
                 2 * Mr * (Mr + 1) * N + 4 * Mr * N * Df
                 + 3 * 2 * Mr * N * Df, TF32_FLOP_S)
    return k2, k3
