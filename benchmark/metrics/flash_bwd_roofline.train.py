"""flash_bwd_roofline.train (%; layer: kernels K3 and K4,
csrc/flash_attention_bwd.cu; moves train_step_s): the least time the card
could take for every flash_bwd_dq_kernel and flash_bwd_dkv_kernel launch
of the trace, each with its own operations and bytes (benchmark/flops.py),
over the time they took. A launch's shape is read from its grid,
(ceil(S / 128), B * H), with S = 512 text tokens + the feed's image tokens."""

from benchmark import flops


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    t = run.config["transformer"]
    h, d = t["num_attention_heads"], t["attention_head_dim"]
    s = run.config["text_encoder"]["max_length"] + (run.traffic["px"] // 16) ** 2
    bound = spent = 0.0
    for name, count in (("flash_bwd_dq_kernel", flops.attention_bwd_dq),
                        ("flash_bwd_dkv_kernel", flops.attention_bwd_dkv)):
        for op in run.trace.kernels(name):
            if len(op.grid) < 2 or op.grid[0] != -(-s // 128) or op.grid[1] % h:
                continue
            bound += flops.roofline_s(*count(op.grid[1] // h, h, s, s, d), run.peaks)
            spent += op.dur
    return 100.0 * bound / spent if spent > 0 else None
