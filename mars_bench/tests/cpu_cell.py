"""Small CPU stand-ins for the cells, for the tests: every width cut to a
toy, the traffic to a few sessions of 2,000-token prompts."""
import copy


def shrink(cfg, traffic, *, seconds_scale=1.0):
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    cfg.update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
               num_key_value_heads=2, head_dim=16, intermediate_size=96,
               vocab_size=256, max_position_embeddings=2048)
    if cfg.get("num_experts"):
        cfg.update(num_experts=8, num_experts_per_tok=2,
                   moe_intermediate_size=32)
    cfg["serving"] = dict(pool_pages=160, host_tier_blocks=512,
                          token_budget=256, max_decode_batch=4, cpu_slots=2)
    cfg["check"] = dict(cfg["check"], sessions=2)
    traffic.update(max_context=2048, rounds_lo=2, rounds_hi=3,
                   decode_mean=24, tool_time_scale=0.002, arrival_rate=1.0,
                   lead_in_s=1.0, margin_s=2.0, profile_s=1.0)
    if traffic.get("n_families"):
        traffic["n_families"] = 2
    return cfg, traffic
