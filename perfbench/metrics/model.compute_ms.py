"""Device time a profiled step, on rank 0, of every kernel that is
neither NCCL's nor onebit's: the forward, the backward and the inner
optimizer."""

from perfbench.kernels import is_nccl, onebit_kind, per_step_ms


def read(ctx):
    return per_step_ms(ctx["ranks"][0].get("profile", {}),
                       lambda n: not is_nccl(n) and onebit_kind(n) is None)
