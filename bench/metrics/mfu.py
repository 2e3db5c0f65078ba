"""Model FLOPs utilization over the traced slice: the operations of the
model calls (prefills and decode steps) in the slice, by the benchmark's
own formulas from each call's shapes (``bench/flops.py``), each call
counted by the share of its span inside the slice, over the slice's
seconds times the card's bf16 peak (989 TFLOP/s)."""

from bench import flops


def _dims(cfg):
    return {"d_model": cfg.d_model, "num_heads": cfg.num_heads,
            "num_kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
            "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size,
            "num_layers": cfg.num_layers,
            "block_pattern": tuple(cfg.block_pattern),
            "rwkv_head_size": cfg.rwkv_head_size}


def read(run):
    if run.spans is None or run.device is None:
        return None
    a, b = run.device.t0, run.device.t0 + run.device.window_s
    total = 0.0
    for s, share in run.spans.overlapping("prefill", a, b):
        total += share * flops.prefill_flops(_dims(s.info["cfg"]),
                                             s.info["S"])
    for s, share in run.spans.overlapping("decode", a, b):
        total += share * flops.decode_flops(_dims(s.info["cfg"]),
                                            s.info["contexts"])
    if total == 0.0:
        return None
    return 100.0 * total / (run.device.window_s * flops.PEAK_BF16_FLOPS)
