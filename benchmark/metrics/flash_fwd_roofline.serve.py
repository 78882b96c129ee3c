"""flash_fwd_roofline.serve (%; layer: kernel K1, ops/flash_attention.py ->
csrc/flash_attention.cu; moves images_per_s): the least time the card could
take for every flash_fwd_kernel launch of the trace (benchmark/flops.py:
4 B H Sq Sk D operations, q, k, v and o moved once, against the H100's
peaks), over the time those launches took.

A launch's shape is read from its grid, (ceil(Sq / 128), B * H): H is the
configuration's head count and Sq = Sk = 512 text tokens + the image tokens
of one of the traffic's sizes, the one whose row tiles match."""

from benchmark import flops


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    t = run.config["transformer"]
    h, d = t["num_attention_heads"], t["attention_head_dim"]
    s_txt = run.config["text_encoder"]["max_length"]
    by_tiles = {}
    for size in run.traffic["sizes"]:
        s = s_txt + (size["px"] // 16) ** 2
        by_tiles[-(-s // 128)] = s
    bound = spent = 0.0
    for op in run.trace.kernels("flash_fwd_kernel"):
        if len(op.grid) < 2 or op.grid[0] not in by_tiles or op.grid[1] % h:
            continue
        s = by_tiles[op.grid[0]]
        bound += flops.roofline_s(*flops.attention_fwd(op.grid[1] // h, h, s, s, d), run.peaks)
        spent += op.dur
    return 100.0 * bound / spent if spent > 0 else None
