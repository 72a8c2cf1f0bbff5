"""plain_torch_ms (ms, lower is better; layer: plain torch between the
kernels: ops/modmath.py add / sub mod q, the digit lift of ops/behz.py, the
stream's index_select and cat).

Device milliseconds a block of the kernels that are not the port's own CUDA
kernels (copies and sets left out), from ``torch.profiler``.  It moves
requests_per_s: these kernels share the card with the NTT and tail kernels.
"""

# the port's own kernels (csrc/ntt.cu, csrc/four_step.cu, csrc/tail.cu)
PORT_KERNELS = ("ntt_kernel", "four_step_kernel", "four_step_phase_kernel",
                "to_bsk_ext_kernel", "dyadic_kernel", "floor_sk_kernel",
                "relin_dot_kernel", "mod_down_kernel")


def read(obs):
    tr = obs.trace
    if tr is None or tr.blocks < 1:
        return None
    from bench_port.trace import short_name
    seconds = sum(o.seconds for o in tr.device_ops
                  if not o.name.startswith(("Memcpy", "Memset"))
                  and short_name(o.name).split("<")[0] not in PORT_KERNELS)
    if seconds <= 0:
        return None
    return 1e3 * seconds / tr.blocks
