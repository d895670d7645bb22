from repro_torch.kernels.msa.msa_decode import msa_decode_cuda
from repro_torch.kernels.msa.msa_fused import (
    UNIT_FIELDS,
    WL_FIELDS,
    build_units,
    build_worklist,
    msa_fused_cuda,
    msa_fused_partial_cuda,
    pad_worklist,
    tile_ranges,
)
from repro_torch.kernels.msa.msa_prefill import msa_prefill_cuda
from repro_torch.kernels.msa.ops import (
    apply_page_copies,
    apply_swap_ins,
    msa_decode,
    msa_fused,
    msa_fused_partial,
    msa_prefill,
    write_kv_pages,
)

__all__ = ["apply_page_copies", "apply_swap_ins", "build_units",
           "build_worklist",
           "msa_decode", "msa_decode_cuda", "msa_fused", "msa_fused_cuda",
           "msa_fused_partial", "msa_fused_partial_cuda",
           "msa_prefill", "msa_prefill_cuda", "pad_worklist", "tile_ranges",
           "write_kv_pages", "UNIT_FIELDS", "WL_FIELDS"]
