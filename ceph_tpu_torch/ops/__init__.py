from .rs_kernels import (gf_apply, gf_apply_stripes, gf_apply_plain,
                         gf_apply_stripes_plain, gf_apply_bitslice,
                         gf_apply_lookup, xor_reduce, xor_apply,
                         xor_apply_plain, crc32c_rows,
                         crc32c_rows_plain, gf_encode_with_crc)
from .codec import RSCodec, TECHNIQUES

__all__ = ["gf_apply", "gf_apply_stripes", "gf_apply_plain",
           "gf_apply_stripes_plain", "gf_apply_bitslice", "gf_apply_lookup",
           "xor_reduce", "xor_apply", "xor_apply_plain", "crc32c_rows",
           "crc32c_rows_plain", "gf_encode_with_crc",
           "RSCodec", "TECHNIQUES"]
