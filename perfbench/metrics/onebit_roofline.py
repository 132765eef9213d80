"""The onebit kernels' share of their roofline on rank 0: the least time
the bytes they need take at the card's peak bandwidth (``flops/onebit``,
from the chunks the engine cut) over their device time in the profiled
steps.  Nothing to read where no chunk is compressed, or where the trace
shows another number of onebit launches than the engine's chain makes
(2 packs, 3 unpacks and 1 merge a chunk a step): the bytes would not be
the kernels'."""

from perfbench.flops import onebit
from perfbench.kernels import onebit_kind


def read(ctx):
    r0 = ctx["ranks"][0]
    prof, chunks = r0.get("profile", {}), r0.get("compressed_chunks") or []
    if not chunks or not prof.get("steps"):
        return None
    seconds, counts = 0.0, {k: 0 for k in onebit.PER_CHUNK}
    for name, (s, n) in prof["kernels"].items():
        kind = onebit_kind(name)
        if kind is not None:
            seconds += s
            counts[kind] += n
    want = {k: v * len(chunks) * prof["steps"]
            for k, v in onebit.PER_CHUNK.items()}
    if counts != want or seconds <= 0:
        return None
    bound = (prof["steps"] * onebit.step_bytes(chunks, r0["size"])
             / ctx["peaks"]["hbm_bytes_per_s"])
    return 100.0 * bound / seconds
