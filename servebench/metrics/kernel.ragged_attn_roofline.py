"""kernel.ragged_attn_roofline: the ragged paged-attention calls of the
profiled slice (ops/cuda/ragged_attention.py ->
csrc/ragged_paged_attention.cu): the least time their work needs
(servebench/counts.py ragged_call, one call a layer a dispatch), over
the device time of the kernels launched inside them, in %."""

from servebench import counts, readings


def read(run):
    if not run.ragged_calls:
        return None
    a, L = run.arch, run.arch["L"]
    calls = [counts.ragged_call(a, spans, run.page_size) + (L,)
             for spans in run.ragged_calls]
    return readings.roofline(run, "ragged_attn", calls)
