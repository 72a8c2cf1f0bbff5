"""host_issue_ms (ms, lower is better; layer: host issue in
parallel/stream.py and ops/engine.py).

The host's milliseconds a block spends outside its waits for the card: each
traced block's span on the issuing thread minus the time that thread spent
inside it in the CUDA runtime's waits (``trace.WAITS``: the stream's final
synchronize, and the synchronize of each copy from pageable host memory), as
a mean over the traced window's blocks (``torch.profiler``; its recording
adds a few microseconds to each host operation).  It moves requests_per_s
where the card waits for the host.
"""


def read(obs):
    tr = obs.trace
    if tr is None:
        return None
    from bench_port.trace import block_issue_seconds
    issue = block_issue_seconds(tr)
    if not issue:
        return None
    return 1e3 * sum(issue) / len(issue)
