"""Device time a profiled step of NCCL's kernels (names starting
``nccl``) on rank 0."""

from perfbench.kernels import is_nccl, per_step_ms


def read(ctx):
    return per_step_ms(ctx["ranks"][0].get("profile", {}), is_nccl)
