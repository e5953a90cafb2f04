"""Small CPU stand-ins for the cells, for the tests: the architecture's
toy widths (``arch.module(cfg).toy``), the traffic to a few sessions of
2,000-token prompts."""
import copy

from mars_bench import arch


def shrink(cfg, traffic):
    cfg, traffic = arch.module(cfg).toy(cfg), copy.deepcopy(traffic)
    cfg["max_position_embeddings"] = 2048
    cfg["serving"] = dict(pool_pages=160, host_tier_blocks=512,
                          token_budget=256, max_decode_batch=4, cpu_slots=2)
    cfg["check"] = dict(cfg["check"], sessions=2)
    traffic.update(max_context=2048, rounds_lo=2, rounds_hi=3,
                   decode_mean=24, tool_time_scale=0.002, arrival_rate=1.0,
                   lead_in_s=1.0, margin_s=2.0, profile_s=1.0)
    if traffic.get("n_families"):
        traffic["n_families"] = 2
    return cfg, traffic
