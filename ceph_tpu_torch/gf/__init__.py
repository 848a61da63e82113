"""GF(2^8) arithmetic for erasure coding (poly 0x11d, ISA-L's field)."""

from .gf8 import (  # noqa: F401
    GF_POLY,
    GF_EXP,
    GF_LOG,
    GF_INV,
    GF_MUL_TABLE,
    gf_mul,
    gf_div,
    gf_inv,
    gf_pow,
    gf_matmul,
    gf_invert_matrix,
    gf_solve_rows,
    coeff_to_bitmatrix,
    matrix_to_bitmatrix,
)
from .matrices import (  # noqa: F401
    gen_rs_matrix,
    gen_cauchy1_matrix,
    gen_jerasure_rs_vandermonde,
    build_decode_matrix,
    decode_index_for,
    erasure_signature,
)
