"""Kernels, percent: the attention launches' share of their roofline in
the traced stretch.  The least time the chip could take for every
attention launch of the steps dispatched in the stretch (one a layer:
the larger of its operations over the bf16 peak and its bytes over the
HBM bandwidth, at the layer's window, ``bench/harness/flops.py``), over
the device time of the kernels named below."""
from bench.harness.flops import attn_bound_s

# the port's attention kernels on the fused path (csrc/msa_fused.cu),
# its merge pass included; the split path's for a cell that runs it
KERNELS = ("msa_fused_kernel", "msa_fused_merge_kernel",
           "msa_prefill_kernel", "msa_prefill_merge_kernel",
           "msa_decode_kernel", "msa_decode_merge_kernel")


def read(run):
    if run.trace is None:
        return None
    dev = 1e-6 * sum(b - a for n, a, b in run.trace["kernels"]
                     if any(k in n for k in KERNELS))
    if dev <= 0:
        return None
    page = run.deployment["block_size"]
    bound = sum(attn_bound_s(w, run.model, page, run.peaks, run.reference)
                for w in run.trace["steps"])
    return 100.0 * bound / dev
