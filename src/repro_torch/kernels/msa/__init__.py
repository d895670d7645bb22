from repro_torch.kernels.msa.msa_fused import (
    WL_FIELDS,
    build_worklist,
    msa_fused_cuda,
    pad_worklist,
    tile_ranges,
)
from repro_torch.kernels.msa.ops import (
    apply_page_copies,
    apply_swap_ins,
    msa_fused,
    write_kv_pages,
)

__all__ = ["apply_page_copies", "apply_swap_ins", "build_worklist",
           "msa_fused", "msa_fused_cuda", "pad_worklist", "tile_ranges",
           "write_kv_pages", "WL_FIELDS"]
