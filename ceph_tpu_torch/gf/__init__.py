from .tables import (GF_POLY, EXP_TABLE, LOG_TABLE, MUL_TABLE, gf_mul, gf_div,
                     gf_inv, gf_pow, gf_mul_vec, mul_bitmatrix, expand_bitmatrix)
from .matrix import (rs_vandermonde_isa, rs_vandermonde_jerasure, cauchy1,
                     generator_matrix, gf_matmul, gf_invert, decode_matrix)
from . import ref

__all__ = [
    "GF_POLY", "EXP_TABLE", "LOG_TABLE", "MUL_TABLE", "gf_mul", "gf_div",
    "gf_inv", "gf_pow", "gf_mul_vec", "mul_bitmatrix", "expand_bitmatrix",
    "rs_vandermonde_isa", "rs_vandermonde_jerasure", "cauchy1",
    "generator_matrix", "gf_matmul", "gf_invert", "decode_matrix", "ref",
]
