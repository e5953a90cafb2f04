"""The plain reference against the program's CPU path at toy sizes, on
the same weights (made by ``weights.py``, handed to both)."""
import json
import os

import pytest
import torch

from mars_bench import bench, reference, weights
from mars_bench.tests.cpu_cell import shrink

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def toy(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    return shrink(cfg, {})[0]


@pytest.mark.parametrize("name", ["qwen3-coder-30b-a3b", "internlm2-20b"])
def test_reference_matches_the_program(name, one_thread):
    from repro_torch.models.transformer import lm_forward
    cfg = toy(name)
    params = weights.make_params(cfg, 1234567890123, dtype=torch.float32,
                                 device="cpu")
    T = 96
    toks = torch.randint(0, cfg["vocab_size"], (1, T),
                         generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        prog = lm_forward(bench.model_config(cfg), params, toks)[0]
    rows = list(range(T))
    # the program routes all T rows in one MoE call of width T
    ref = reference.forward_logits(cfg, params, toks[0].tolist(), rows,
                                   moe_groups=[(0, T, T)])
    assert torch.allclose(ref, prog, atol=2e-5, rtol=2e-5), \
        (ref - prog).abs().max()
    assert max(reference.gaps_sd(ref, prog.argmax(-1).tolist())) == 0.0


def test_capacity_drops_follow_the_call(one_thread):
    """Width-64 calls of 8 experts, top 2: capacity 20 for a mean load
    of 16, so some entries overflow; the reference drops the same ones
    only when told the call's rows and width."""
    from repro_torch.models.transformer import lm_forward
    cfg = toy("qwen3-coder-30b-a3b")
    params = weights.make_params(cfg, 7, dtype=torch.float32, device="cpu")
    toks = torch.randint(0, cfg["vocab_size"], (1, 64),
                         generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        prog = lm_forward(bench.model_config(cfg), params, toks)[0]
    rows = list(range(64))
    same = reference.forward_logits(cfg, params, toks[0].tolist(), rows,
                                    moe_groups=[(0, 64, 64)])
    alone = reference.forward_logits(cfg, params, toks[0].tolist(), rows)
    assert torch.allclose(same, prog, atol=2e-5, rtol=2e-5)
    assert not torch.allclose(alone, prog, atol=1e-3, rtol=1e-3)


def test_fp8_control_departs_from_f32(one_thread):
    cfg = toy("internlm2-20b")
    params = weights.make_params(cfg, 11, dtype=torch.float32, device="cpu")
    toks = list(range(3, 131))
    rows = list(range(len(toks)))
    ref = reference.forward_logits(cfg, params, toks, rows)
    low = reference.forward_logits(cfg, params, toks, rows, precision="fp8")
    gaps = reference.control_gaps_sd(ref, low)
    assert max(gaps) > 0.0 and len(gaps) == len(rows)
    assert (ref - low).abs().max() > 1e-2
