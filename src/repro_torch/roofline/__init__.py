from repro_torch.roofline.analysis import RooflineTerms, model_flops, roofline
from repro_torch.roofline.collectives import (collectives_of,
                                              total_wire_bytes, wire_bytes)

__all__ = [
    "RooflineTerms", "model_flops", "roofline", "collectives_of",
    "total_wire_bytes", "wire_bytes",
]
