"""device_idle_pct (%, lower is better; layer: device).

The share of the traced window in which no operation ran on the card: 1
minus the union of the device operations' intervals (kernels, copies, sets)
over the window's length, from ``torch.profiler``.  It moves requests_per_s:
an idle card is the host's issue, or the block's uploads, setting the pace.
"""


def read(obs):
    tr = obs.trace
    if tr is None or not tr.device_ops or tr.window_s <= 0:
        return None
    from bench_port.trace import busy_seconds
    return 100.0 * (1.0 - busy_seconds(tr) / tr.window_s)
